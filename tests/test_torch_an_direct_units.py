"""K3's live lanes and the schedule of `an_direct_light_kernel`
(csrc/an_direct.cu), on the CPU at 48x64.

The frame hands each analytic direct-light call (K3 on the card) a mask
of the lanes whose radiance it keeps (models/pipeline.py:_shade_analytic,
ops/lighting.py): the primary call its diffuse hits, the GI bounce the
valid bounce hits among those, each mirror and glass secondary its valid
hits among the mirror and glass lanes.  The kernel does no work on the
other lanes and leaves them unwritten.  The first tests make that
contract bite on the CPU: the direct light is wrapped so that every lane
its mask marks dead comes back as NaN, and the frames rendered so must
equal the unwrapped frames bit for bit, for the analytic presets, with
the gradient sky and a cubemap, at 1 and 2 samples, with the mirror and
glass toggles off and on.  A NaN that reached a kept pixel would show.

The kernel runs persistent blocks whose warps take units of 32 lanes:
a unit's live lanes (a ballot of the mask bytes) join the warp's diffuse
or env queue by their material type; once a queue holds kDrainAt lanes
the warp shades a round of 32 of them (the diffuse queue first) and
takes units again, and after its last unit it shades what is left.  The
model below transcribes that bookkeeping with the source's constants,
read from its text, over the masks the frames hand K3 and over the
persistent loop of csrc/persistent.cuh: every live lane is shaded
exactly once, on its own output row and on its type's path, no dead
lane is, no round mixes the paths, and no queue outgrows its room.
"""

import os
import re

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import (camera_frame_inputs,
                                                 env_from_numpy)
from opengl_raytracing_tpu_torch.models import (RenderState, preset,
                                                render_frame)
from opengl_raytracing_tpu_torch.ops import an_cuda
from opengl_raytracing_tpu_torch.ops.materials import get_material
from opengl_raytracing_tpu_torch.utils import image as timage

torch.set_num_threads(2)

H, W = 48, 64
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
CSRC = os.path.join(ROOT, "opengl_raytracing_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "an_direct.cu")
CUBEMAP = os.path.join(ROOT, "cubemaps", "sky_day.png")
FRAMES = 2

# The source's constants (test_constants_are_the_sources reads them)
THREADS = 128          # kThreads: a block
UNIT = 32              # lanes a unit: make_units(n_lanes, 32)
DRAIN_AT = 32          # kDrainAt: a queue is shaded once it holds this
QUEUE_CAP = DRAIN_AT - 1 + 32  # kQueueCap
DIFFUSE, ENV = 0, 1    # the warp's two queues


def test_constants_are_the_sources():
    with open(SRC) as fh:
        src = fh.read()
    for line in ("constexpr int kThreads = 128;",
                 "constexpr int kWarps = kThreads / 32;",
                 "constexpr int kDrainAt = 32;",
                 "constexpr int kQueueCap = kDrainAt - 1 + 32;",
                 "__shared__ int64_t queue[kWarps][2][kQueueCap];",
                 "make_units(n_lanes, 32)",
                 "for (; j < u.n_units && n_diffuse < kDrainAt && "
                 "n_env < kDrainAt;",
                 "enqueue(diffuse, n_diffuse, type == 0, below, i);",
                 "enqueue(env, n_env, type == 1 || type == 2, below, i);",
                 "if (in) q[n + __popc(b & below)] = i;",
                 "const bool units_done = j >= u.n_units;",
                 "if (n_diffuse >= kDrainAt || (units_done && n_diffuse > 0))",
                 "else if (n_env > 0)",
                 "const int k = min(n, 32);",
                 "const int64_t e = (env_round ? env : diffuse)[n - k + lane];",
                 "store3(out, i, acc);", "store3(out, i, c);",
                 "return r.shared ? i - (int64_t)sample_of(r.grid, i) * "
                 "r.grid.n_px : i;"):
        assert line in src, line
    # the queues' bytes stated in the source, beside the constants
    m = re.search(r"(\d),(\d+) B a block",
                  src[src.index("an_direct_light_kernel's queues"):])
    assert int(m.group(1) + m.group(2)) == THREADS // 32 * 2 * QUEUE_CAP * 8


def _persistent_loop():
    """persistent.cuh's unit loop as Python, read from first() and
    stride(): (first, stride) of (threadIdx.x, blockIdx.x, blockDim.x,
    gridDim.x)."""
    with open(os.path.join(CSRC, "persistent.cuh")) as fh:
        src = fh.read()

    def expr(name):
        m = re.search(r"int64_t %s\(\) const \{\s*return ([^;]+);" % name,
                      src)
        assert m, name
        text = m.group(1).replace("(int64_t)", "")
        for c, py in (("threadIdx.x", "tx"), ("blockIdx.x", "bx"),
                      ("blockDim.x", "bd"), ("gridDim.x", "gd")):
            text = text.replace(c, py)
        return eval("lambda tx, bx, bd, gd: " + text)
    assert "blocks = (u.n_units + warps - 1) / warps;" in src
    return expr("first"), expr("stride")


def kernel_schedule(live, paths, n_lanes, n_px, shared, sms, per_sm):
    """The kernel's rounds over a call of `n_lanes` lanes: `live` and
    `paths` (DIFFUSE / ENV of each hit row) are read at a lane's hit row,
    i % n_px where the rows are `shared`, else i.  The grid is
    launch_persistent's for `sms` SMs holding `per_sm` blocks.

    Returns the rounds, each (path, [lanes]), warp by warp; raises where a
    queue outgrows its room."""
    first, stride = _persistent_loop()
    n_units = -(-n_lanes // UNIT)
    warps = THREADS // 32
    grid = min(sms * per_sm, -(-n_units // warps))
    rounds = []
    for b in range(grid):
        for w in range(warps):
            q = {DIFFUSE: [], ENV: []}
            j = first(32 * w, b, THREADS, grid)
            while True:
                # units until a queue holds DRAIN_AT lanes or they end
                while (j < n_units and len(q[DIFFUSE]) < DRAIN_AT
                       and len(q[ENV]) < DRAIN_AT):
                    lanes = [j * UNIT + ln for ln in range(UNIT)]
                    j += stride(32 * w, b, THREADS, grid)
                    row = [(i % n_px if shared else i) if i < n_lanes else 0
                           for i in lanes]
                    alive = [i < n_lanes and bool(live[r])
                             for i, r in zip(lanes, row)]
                    for path in (DIFFUSE, ENV):
                        # the ballot's ranks: the joining lanes in order
                        q[path] += [i for i, r, a in zip(lanes, row, alive)
                                    if a and paths[r] == path]
                        assert len(q[path]) <= QUEUE_CAP
                units_done = j >= n_units
                if (len(q[DIFFUSE]) >= DRAIN_AT
                        or (units_done and q[DIFFUSE])):
                    path = DIFFUSE
                elif q[ENV]:
                    path = ENV
                else:
                    break
                k = min(len(q[path]), 32)
                rounds.append((path, q[path][len(q[path]) - k:]))
                del q[path][len(q[path]) - k:]
    return rounds


# ---- the frames ----

def _camera():
    cam = Camera()
    cam.aspect = W / H
    return cam


@pytest.fixture(scope="module")
def day_sky():
    return env_from_numpy(timage.load_cubemap_cross(CUBEMAP), "cpu")


def _render(params, env, wrap=None, monkeypatch=None):
    """FRAMES chained analytic frames at 48x64 on the CPU: the last
    frame's image and the accumulation.  With `wrap`, the wrappers' direct
    light is replaced by wrap(real) for the run."""
    if wrap is not None:
        monkeypatch.setattr(an_cuda, "direct_light",
                            wrap(an_cuda.direct_light))
    state = RenderState.create(H, W, "cpu")
    cam = _camera()
    for k in range(FRAMES):
        fin = camera_frame_inputs(cam, "cpu", jitter=(0.1 * k, -0.2 * k),
                                  frame_index=k)
        state, out = render_frame(params, fin, state, env, height=H,
                                  width=W)
    if wrap is not None:
        monkeypatch.undo()
    return out.image.clone(), state.accum.clone()


def _dead_as_nan(calls):
    """A wrapper of the direct light that fills every lane its `active`
    marks dead with NaN, and notes each call's (scene, h, active, its
    radiance on every lane)."""
    def wrap(real):
        def fn(scene, h, rng_frame, frame_index, vdir, px, py, active=None,
               **kw):
            out = real(scene, h, rng_frame, frame_index, vdir, px, py,
                       active, **kw)
            calls.append((scene, h, active, out))
            if active is None:
                return out
            return torch.where(active.expand(h.t.shape)[..., None], out,
                               float("nan"))
        return fn
    return wrap


CASES = [(name, env, spp, toggles) for name in ("baseline", "full")
         for env in ("gradient", "cubemap") for spp in (1, 2)
         for toggles in ("off", "on")]


def _params(name, env, spp, toggles):
    on = int(toggles == "on")
    return preset(name).replace(spp_per_frame=spp,
                                enable_env_map=int(env == "cubemap"),
                                mat_mirror_enabled=on, mat_glass_enabled=on)


@pytest.mark.parametrize("name,env,spp,toggles", CASES)
def test_dead_lanes_reach_no_kept_pixel(name, env, spp, toggles, day_sky,
                                        monkeypatch):
    """With every lane that a direct-light call's mask marks dead set to
    NaN, the frames are the dense frames bit for bit: the masks cover
    every lane the frame keeps.  Every call of the frame gets a mask, and
    the masks leave lanes out."""
    params = _params(name, env, spp, toggles)
    table = day_sky if env == "cubemap" else None
    want = _render(params, table)
    calls = []
    got = _render(params, table, _dead_as_nan(calls), monkeypatch)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)
    n_calls = (1 + bool(params.enable_gi)
               + bool(params.mat_mirror_enabled) * (1 + bool(
                   params.enable_gi))
               + 3 * bool(params.mat_glass_enabled))
    assert len(calls) == FRAMES * n_calls
    for _, h, active, _ in calls:
        assert active is not None
        assert not bool(active.expand(h.t.shape).all())


def test_secondary_masks_are_sparse(day_sky, monkeypatch):
    """On the `full` frame the primary call keeps most lanes and each
    secondary call few, as the kernel's dead units then end at their
    ballot: the primary call's mask is its diffuse hits, each secondary's
    its valid hits among the lanes its caller keeps."""
    calls = []
    _render(_params("full", "cubemap", 1, "on"), day_sky,
            _dead_as_nan(calls), monkeypatch)
    last = calls[len(calls) // FRAMES:]
    shares = [float(a.float().mean()) for _, _, a, _ in last]
    assert len(shares) == 7
    assert shares[0] > 0.5
    assert max(shares[1:]) < 0.2
    scene, h, active, _ = last[0]
    kinds = get_material(h.mat, scene.params).mtype
    assert bool((kinds[active] == 0).all())
    assert bool(h.mat[active].ne(4).all())
    for _, h2, a, _ in last[1:]:
        assert bool(h2.valid[a].all())


# ---- the kernel's schedule on the frames' masks ----

@pytest.fixture(scope="module")
def frame_calls(day_sky):
    """Every direct-light call of the last `full` frame with the cubemap
    and the toggles on, at 1 and 2 samples: (case, rows' mask, rows'
    paths, pixels a sample, rows shared, radiance of every lane)."""
    out = []
    mp = pytest.MonkeyPatch()
    try:
        for spp in (1, 2):
            calls = []
            _render(_params("full", "cubemap", spp, "on"), day_sky,
                    _dead_as_nan(calls), mp)
            for k, (scene, h, active, plain) in enumerate(
                    calls[len(calls) // FRAMES:]):
                shape = h.t.shape
                act = active.expand(shape)
                shared = (spp > 1 and h.mat.stride(0) == 0
                          and act.stride(0) == 0)
                rows = (lambda x: x[0]) if shared else (lambda x: x)
                kinds = get_material(rows(h.mat), scene.params).mtype
                paths = np.where(kinds.reshape(-1).numpy() == 0, DIFFUSE,
                                 ENV)
                out.append((f"spp{spp}_call{k}", rows(act).reshape(-1)
                            .numpy(), paths, shape.numel() // spp, shared,
                            plain.reshape(-1, 3)))
    finally:
        mp.undo()
    return out


def test_the_primary_batch_call_reads_shared_rows(frame_calls):
    """At 2 samples the primary call's hit and mask are broadcast over the
    sample axis, so the kernel reads them once a pixel; the secondary
    calls' hits differ by sample."""
    shared = {case: s for case, _, _, _, s, _ in frame_calls}
    assert shared["spp2_call0"]
    assert not any(s for case, s in shared.items() if case != "spp2_call0")
    assert not any(s for case, s in shared.items()
                   if case.startswith("spp1"))


@pytest.mark.parametrize("sms,per_sm", [(132, 8), (4, 1), (1, 1)])
def test_schedule_shades_each_live_lane_once_on_its_row(frame_calls, sms,
                                                        per_sm):
    """Each live lane of every call shaded exactly once, by a round of
    its type's path alone, no dead lane; a round's radiance written to
    its lanes' own rows gives the plain version's on the live lanes and
    leaves the others unwritten.  Few SMs make a warp's queues carry
    lanes across many units."""
    for case, live, paths, n_px, shared, plain in frame_calls:
        n_lanes = plain.shape[0]
        rounds = kernel_schedule(live, paths, n_lanes, n_px, shared, sms,
                                 per_sm)
        lanes = [i for _, rnd in rounds for i in rnd]
        assert len(lanes) == len(set(lanes)), case
        rows = np.arange(n_lanes) % n_px if shared else np.arange(n_lanes)
        want = set(np.flatnonzero(live[rows]).tolist())
        assert set(lanes) == want, case
        for path, rnd in rounds:
            assert 0 < len(rnd) <= 32
            assert all(paths[rows[i]] == path for i in rnd), case
        out = torch.full_like(plain, float("nan"))
        for _, rnd in rounds:
            out[rnd] = plain[rnd]
        dead = torch.from_numpy(~live[rows])
        assert torch.equal(out[~dead], plain[~dead]), case
        assert bool(out[dead].isnan().all()), case


def test_schedule_rounds_are_full_but_the_last(frame_calls):
    """With the queues, a warp's rounds are full (32 lanes of one path)
    but the last of each path: on a dense call nearly every round is
    full."""
    case, live, paths, n_px, shared, plain = frame_calls[0]
    rounds = kernel_schedule(live, paths, plain.shape[0], n_px, shared, 132,
                             8)
    partial = [len(r) for _, r in rounds if len(r) < 32]
    warps = THREADS // 32 * min(132 * 8, -(-plain.shape[0] // UNIT // 4))
    assert len(partial) <= 2 * warps
    assert sum(len(r) for _, r in rounds) == int(live.sum())


@pytest.mark.parametrize("n_lanes", [1, 31, 33, 1000])
def test_schedule_on_synthetic_masks(n_lanes):
    """Odd call sizes (a partial last unit), every mix of paths and dead
    lanes, one warp or many: each live lane once, no dead one, no round
    over 32 or of two paths."""
    rng = np.random.RandomState(n_lanes)
    live = rng.rand(n_lanes) < 0.6
    paths = (rng.rand(n_lanes) < 0.3).astype(np.int64)
    for sms, per_sm in ((1, 1), (132, 8)):
        rounds = kernel_schedule(live, paths, n_lanes, n_lanes, False, sms,
                                 per_sm)
        lanes = sorted(i for _, r in rounds for i in r)
        assert lanes == np.flatnonzero(live).tolist()
        for path, r in rounds:
            assert 0 < len(r) <= 32 and all(paths[i] == path for i in r)
