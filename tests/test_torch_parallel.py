"""The port's row-band renderer (opengl_raytracing_tpu_torch/parallel/) on
the CPU: 2 and 4 gloo ranks, each in a process of its own, render 32x64
frames through `make_sharded_render_fn`, and rank 0 gathers the planes.

Cases (tests/torch_parallel_ranks.py runs them on every rank):
  * `bvh_full`: the BVH scene, `full` preset, 3 still frames;
  * `slim_full`: the analytic scene, JAX's `_slim` `full` preset (GI, AO,
    glass and mirror off; tests/test_shardmap.py), 3 still frames;
  * `realistic_moving`: `_slim` `realistic` (SVGF off) with a camera that
    turns and moves every frame (the gathered history), 3 frames;
  * `svgf_seams`: `_slim` `full` at SVGF strength 1, 2 frames (the halo
    rows; JAX's test_shardmap_svgf_seams_match);
  * `analytic`: the analytic `full` preset, 1 frame;
  * `still_thresh0`: `realistic`, still camera, `taa_still_thresh` 0 (TAA
    reprojects a still frame, so the history is gathered all the same);
  * `motion_view`: the motion debug view of a moving `full` pair.

Tolerances: the gathered image, accumulation and gbuffer equal the port's
single-device `render_frame` bit for bit (a band's pixels are computed by
the same elementwise ops on the same values; at 32x64 every band's
BH*W is a multiple of 64, so torch's vectorised CPU sqrt and pow see no
ragged tail the whole image does not).  Against the JAX package's
`make_shardmap_render_fn` on 4 of the conftest's virtual devices, JAX's
own tolerances (tests/test_shardmap.py): q99 < 1e-3 and max < 2e-2 still,
q99 < 2e-3 and max < 5e-2 moving.  `mean_lum` within 1e-4 of a host
reduction of the gathered image.

In-process, with no ranks: `resolve_taa(row_offset=...)` against JAX's on
a band (1e-6, tests/test_torch_temporal.py's tolerance) and against the
whole image's rows (bit for bit); the plain band present pass against
the whole image's on the band's rows (bit for bit); the bands run in turn
on one device (`render_bands_in_turn`, what chip_smoke.py drives on the
card) against `render_frame`.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import RenderState as JRenderState
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.ops import taa as jtaa
from opengl_raytracing_tpu.parallel import make_mesh as jmake_mesh
from opengl_raytracing_tpu.parallel import (
    shard_image_rows as jshard_image_rows)
from opengl_raytracing_tpu.parallel.shardmap import (
    make_shardmap_render_fn as jmake_shardmap_render_fn)

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import (frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import RenderState, preset
from opengl_raytracing_tpu_torch.models import render_frame
from opengl_raytracing_tpu_torch.ops import cuda_lib
from opengl_raytracing_tpu_torch.ops import svgf as tsvgf
from opengl_raytracing_tpu_torch.ops.taa import resolve_taa
from opengl_raytracing_tpu_torch.parallel import (make_mesh,
                                                  make_sharded_render_fn,
                                                  shard_image_rows)
from opengl_raytracing_tpu_torch.parallel.shardmap import (
    HALO, band_of, needs_history, render_bands_in_turn)
from opengl_raytracing_tpu_torch.parallel.sharding import spawn_ranks
from opengl_raytracing_tpu_torch.sampling import FrameValue, generate_jitter2d
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(2)

H, W = 32, 64
SPAWN_TIMEOUT = 300.0
FIELDS = ("cam_pos", "cam_right", "cam_up", "cam_fwd", "tan_half_fov",
          "aspect", "jitter", "curr_view_proj", "prev_view_proj",
          "camera_moved")


def _slim(jparams):
    """JAX's tests/test_shardmap.py `_slim`."""
    return jparams.replace(enable_gi=0, enable_ao=0, mat_glass_enabled=0,
                           mat_mirror_enabled=0)


def _frames(params, n, bvh=False, moving=False):
    """`n` frames of FrameInputs fields as numpy: a still camera with
    Halton jitter, or one that turns and moves every frame."""
    cam = Camera()
    cam.aspect = W / H
    if bvh:
        cam.fov = 12.0  # the bunny fills about a third of the frame
        cam.point_at(ranks.BUNNY_AT)
    prev, frames = cam.view_projection(), []
    for i in range(n):
        if moving:
            cam.yaw += 1.5
            cam.position = cam.position + np.float32([0.05, 0.0, -0.05])
        right, up, fwd, thf = cam.basis()
        vp = cam.view_projection()
        scale = params.jitter_moving_scale if moving \
            else params.jitter_still_scale
        frames.append(dict(
            cam_pos=np.float32(cam.position), cam_right=right, cam_up=up,
            cam_fwd=fwd, tan_half_fov=np.float32(thf),
            aspect=np.float32(cam.aspect),
            jitter=np.float32(generate_jitter2d(i) * scale),
            curr_view_proj=vp, prev_view_proj=prev,
            camera_moved=np.int32(moving)))
        prev = vp
    return frames


def _case(params, n, bvh=False, moving=False, show_motion=False, jax=None):
    return dict(params=params, bvh=bvh, show_motion=show_motion,
                frames=_frames(params, n, bvh, moving), jax=jax)


def _cases():
    slim_full = _slim(jpreset("full")).replace(enable_env_map=0)
    slim_real = _slim(jpreset("realistic")).replace(enable_env_map=0)
    seams = slim_full.replace(svgf_strength=1.0)
    full = preset("full").replace(enable_env_map=0)
    return dict(
        bvh_full=_case(full, 3, bvh=True),
        slim_full=_case(params_from(slim_full), 3,
                        jax=(slim_full, 1e-3, 2e-2)),
        realistic_moving=_case(params_from(slim_real), 3, moving=True,
                               jax=(slim_real, 2e-3, 5e-2)),
        svgf_seams=_case(params_from(seams), 2, jax=(seams, 1e-3, 2e-2)),
        analytic=_case(full, 1),
        still_thresh0=_case(preset("realistic").replace(
            enable_env_map=0, taa_still_thresh=0.0), 2),
        motion_view=_case(full, 2, moving=True, show_motion=True))


CASES = _cases()
RANK_CASES = {k: {f: v for f, v in c.items() if f != "jax"}
              for k, c in CASES.items()}


@functools.lru_cache(maxsize=None)
def _spawned(n):
    """Every case on n gloo ranks: each rank's results."""
    return spawn_ranks(ranks.render_cases, n, RANK_CASES, H, W, cpu=True,
                       timeout=SPAWN_TIMEOUT)


@functools.lru_cache(maxsize=None)
def _single(name):
    """The case through the port's single-device render_frame: the last
    frame's planes and every frame's image, as numpy."""
    case = CASES[name]
    bvh = ranks.bunny_bvh("cpu") if case["bvh"] else None
    state = RenderState.create(H, W, "cpu")
    images = []
    for f in case["frames"]:
        fin = frame_inputs_from_numpy(_ns(f), "cpu")
        state, out = render_frame(case["params"], fin, state, None, bvh,
                                  height=H, width=W, use_bvh=case["bvh"],
                                  show_motion=case["show_motion"])
        images.append(out.image.numpy())
    return dict(zip(ranks.PLANES, (out.image.numpy(), state.accum.numpy(),
                                   out.motion.numpy(), out.gpos.numpy(),
                                   out.gnrm.numpy())), images=images)


def _ns(d):
    return SimpleNamespace(**d)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def spawned(request):
    return request.param, _spawned(request.param)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bands_equal_single_device(spawned, name):
    n, results = spawned
    want = _single(name)
    got = results[0][name]
    for plane in ranks.PLANES:
        np.testing.assert_array_equal(got[plane], want[plane], plane)
    frames = len(CASES[name]["frames"])
    for rank, res in enumerate(results):
        r = res[name]
        assert r["band"] == (H // n, W, 3) and r["frame_index"] == frames
        assert r["lums"] == got["lums"]  # the all-reduce's, on every rank
        assert rank == 0 or r["image"] is None


def test_mean_lum_is_the_host_reduction(spawned):
    _, results = spawned
    for name in CASES:
        res = results[0][name]
        host = float((res["image"] @ np.float32([0.299, 0.587, 0.114]))
                     .mean())
        assert abs(res["lums"][-1] - host) < 1e-4, name
        for lum, img in zip(res["lums"], _single(name)["images"]):
            assert abs(lum - float((img @ np.float32(
                [0.299, 0.587, 0.114])).mean())) < 1e-4, name


def test_svgf_seams_match_single_device(spawned):
    """The rows around each band seam, where the halo rows are read, equal
    the whole image's bit for bit; the filter is on there (the image
    differs from the unfiltered tonemap by more than rounding)."""
    n, results = spawned
    got = results[0]["svgf_seams"]["image"]
    want = _single("svgf_seams")
    unfiltered = tsvgf.present_plain(torch.from_numpy(want["accum"]), None,
                                     None, None, CASES["svgf_seams"][
                                         "params"].replace(enable_svgf=0))
    bh = H // n
    for k in range(1, n):
        seam = slice(k * bh - HALO, k * bh + HALO)
        np.testing.assert_array_equal(got[seam], want["image"][seam])
        assert np.abs(got[seam] - unfiltered.numpy()[seam]).max() > 1e-3


@pytest.mark.parametrize("name", ["slim_full", "realistic_moving",
                                  "svgf_seams"])
def test_matches_jax_shardmap(name):
    """4 ranks against the JAX package's shard_map renderer on 4 virtual
    devices, same inputs, within JAX's own tolerances (and, for the
    seams, JAX's seam check: max < 2e-2 on the rows around each)."""
    jparams, q99_tol, max_tol = CASES[name]["jax"]
    mesh = jmake_mesh(jax.devices()[:4])
    fn = jmake_shardmap_render_fn(mesh, H, W, donate=False)
    st = jshard_image_rows(mesh, JRenderState.create(H, W))
    for f in CASES[name]["frames"]:
        jfin = JFrameInputs(**{k: jnp.asarray(f[k]) for k in FIELDS})
        st, out, jlum = fn(jparams, jfin, st, None, None)
    res = _spawned(4)[0][name]
    diff = np.abs(res["image"] - np.asarray(out.image))
    assert np.quantile(diff, 0.99) < q99_tol and diff.max() < max_tol
    assert abs(res["lums"][-1] - float(jlum)) < 1e-4
    bh = H // 4
    for k in range(1, 4):
        assert diff[k * bh - 2:k * bh + 2].max() < 2e-2


def test_a_failing_rank_stops_the_run():
    """A rank that raises while another waits for it in a collective: the
    launcher reports it at once and stops every rank."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(ranks.fail_on_rank_one, 2, cpu=True, timeout=120.0)


def test_mesh_and_band_state_in_process(tmp_path):
    """A one-rank gloo group in this process: make_mesh's view of it,
    shard_image_rows of its one band (a copy of the whole image), a frame
    through make_sharded_render_fn equal to render_frame and launching no
    kernel on CPU tensors; a state of the wrong shape is refused, and so
    is a CUDA mesh where there is no card."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(cpu=True)
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        case = CASES["bvh_full"]
        bvh = ranks.bunny_bvh("cpu")
        whole = RenderState.create(H, W, "cpu")
        band = shard_image_rows(mesh, whole)
        assert band.accum.data_ptr() != whole.accum.data_ptr()
        fn = make_sharded_render_fn(mesh, H, W, use_bvh=True)
        fin = frame_inputs_from_numpy(_ns(case["frames"][0]), "cpu")
        before = dict(cuda_lib.LAUNCHES)
        band, out, lum = fn(case["params"], fin, band, None, bvh)
        assert cuda_lib.LAUNCHES == before  # CPU tensors launch nothing
        _, ref = render_frame(case["params"], fin, whole, None, bvh,
                              height=H, width=W, use_bvh=True)
        assert torch.equal(out.image, ref.image)
        with pytest.raises(ValueError, match="band"):
            fn(case["params"], fin, RenderState.create(H // 2, W, "cpu"),
               None, bvh)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh()
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(cpu=True)


@pytest.mark.parametrize("height,n,rank,want", [
    (32, 4, 0, (0, 8)), (32, 4, 3, (24, 8)), (1080, 4, 2, (540, 270)),
    (32, 1, 0, (0, 32))])
def test_band_of(height, n, rank, want):
    assert band_of(height, n, rank) == want


@pytest.mark.parametrize("height,n,rank", [(30, 4, 0), (32, 4, 4),
                                           (32, 0, 0)])
def test_band_of_refuses(height, n, rank):
    with pytest.raises(ValueError):
        band_of(height, n, rank)


def test_needs_history():
    still = frame_inputs_from_numpy(_ns(_frames(preset("full"), 1)[0]), "cpu")
    moving = frame_inputs_from_numpy(
        _ns(_frames(preset("full"), 1, moving=True)[0]), "cpu")
    unknown = dataclasses.replace(still, moved=None)
    p = preset("full")
    # JAX's `moved or taa_still_thresh <= 0`: no frame index in it (frame
    # 0's passthrough is a device select, so frame 0 gathers as frame 1)
    assert not needs_history(p, still)
    assert needs_history(p, moving) and needs_history(p, unknown)
    assert not needs_history(p.replace(enable_taa=0), moving)
    assert needs_history(p.replace(taa_still_thresh=0.0), still)


# ---- in-process: TAA and the present pass of a band ----

def _taa_inputs(moving, seed=5):
    rng = np.random.RandomState(seed)
    curr = rng.rand(H, W, 3).astype(np.float32)
    hist = rng.rand(H, W, 4).astype(np.float32)
    motion = np.zeros((H, W, 2), np.float32)
    if moving:
        motion = (rng.randn(H, W, 2) * 0.05).astype(np.float32)
        motion[: H // 2, : W // 4] = 0.0  # still pixels beside moving ones
        motion[:, -4:, 1] = 2.5           # reprojected out of the image
    return curr, motion, hist


@pytest.mark.parametrize("moving", [False, True], ids=["still", "moving"])
@pytest.mark.parametrize("row0,bh", [(8, 8), (0, 16), (24, 8)])
def test_resolve_taa_band_matches_jax(moving, row0, bh):
    curr, motion, hist = _taa_inputs(moving)
    jparams = jpreset("full")
    params = params_from(jparams)
    rows = slice(row0, row0 + bh)
    moved = True if moving else False
    for index in (3, 10, 40):
        fi = FrameValue.of(index, "cpu")
        want = np.asarray(jtaa.resolve_taa(
            jnp.asarray(curr[rows]), jnp.asarray(motion[rows]),
            jnp.asarray(hist), jnp.int32(index), jparams, row_offset=row0,
            moved=moved))
        got = resolve_taa(torch.from_numpy(curr[rows]),
                          torch.from_numpy(motion[rows]),
                          torch.from_numpy(hist), fi, params,
                          row_offset=row0, moved=moved)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        # the band is the whole image's rows, bit for bit, both forms
        whole = resolve_taa(torch.from_numpy(curr), torch.from_numpy(motion),
                            torch.from_numpy(hist), fi, params, moved=moved)
        np.testing.assert_array_equal(got.numpy(), whole.numpy()[rows])
        free = resolve_taa(torch.from_numpy(curr[rows]),
                           torch.from_numpy(motion[rows]),
                           torch.from_numpy(hist), fi, params,
                           row_offset=row0, moved=None)
        np.testing.assert_array_equal(free.numpy(), got.numpy())
        # in place into the band's own buffer, never the history
        buf = torch.from_numpy(hist[rows].copy())
        out = resolve_taa(torch.from_numpy(curr[rows]),
                          torch.from_numpy(motion[rows]),
                          torch.from_numpy(hist), fi, params, out=buf,
                          row_offset=row0, moved=moved)
        assert out.data_ptr() == buf.data_ptr()
        np.testing.assert_array_equal(out.numpy(), got.numpy())


def _present_inputs(seed=3):
    rng = np.random.RandomState(seed)
    col = (0.9 + 0.5 * rng.randn(H, W, 3)).astype(np.float32)
    m2 = (col @ np.float32([0.299, 0.587, 0.114])) ** 2 \
        + rng.uniform(0.0, 0.08, (H, W)).astype(np.float32)
    accum = np.concatenate([col, m2[..., None]], -1).astype(np.float32)
    motion = (0.03 * rng.randn(H, W, 2)).astype(np.float32)
    gpos = (rng.randn(H, W, 3) * 0.3).astype(np.float32)
    gnrm = (rng.randn(H, W, 3) * 2.0).astype(np.float32)
    return [torch.from_numpy(x) for x in (accum, motion, gpos, gnrm)]


def _band_planes(planes, row0, bh, halo):
    """A band's planes with `halo` rows of the image above and below,
    zeros past the image's edge (what the ring shifts deliver)."""
    out = []
    for x in planes:
        pad = torch.zeros((halo,) + tuple(x.shape[1:]))
        ext = torch.cat([pad, x, pad], 0)
        out.append(ext[row0:row0 + bh + 2 * halo])
    return out


@pytest.mark.parametrize("svgf", [1, 0])
@pytest.mark.parametrize("row0,bh", [(0, 8), (8, 8), (24, 8), (8, 16)])
def test_plain_band_present_matches_whole(svgf, row0, bh):
    planes = _present_inputs()
    params = preset("full").replace(enable_svgf=svgf)
    whole = tsvgf.present_plain(*planes, params)
    ext = _band_planes(planes, row0, bh, HALO)
    got = tsvgf.present_plain(*ext, params, halo=HALO, row_offset=row0,
                              full_height=H)
    assert torch.equal(got, whole[row0:row0 + bh])
    if svgf:  # the filter entry too, and without the halo the seams move
        filt = tsvgf.svgf_filter(*ext, params, halo=HALO, row_offset=row0,
                                 full_height=H)
        assert torch.equal(filt, tsvgf.svgf_filter(*planes, params)[
            row0:row0 + bh])
        bare = tsvgf.present_plain(*(x[row0:row0 + bh] for x in planes),
                                   params)
        edge = [r for r in (0, bh - 1) if 0 < row0 + r < H - 1]
        assert float((bare[edge] - got[edge]).abs().max()) > 1e-4


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["bvh_full", "realistic_moving",
                                  "svgf_seams", "motion_view"])
def test_bands_in_turn_equal_single_device(n, name):
    """`render_bands_in_turn`, the band step with its collectives replaced
    by slices on one device, against render_frame: every frame's image
    bit for bit, and the last frame's accumulation."""
    case = CASES[name]
    bvh = ranks.bunny_bvh("cpu") if case["bvh"] else None
    states = [RenderState(torch.zeros(H // n, W, 4), 0) for _ in range(n)]
    want = _single(name)
    for f, img in zip(case["frames"], want["images"]):
        fin = frame_inputs_from_numpy(_ns(f), "cpu")
        states, outs, lum = render_bands_in_turn(
            case["params"], fin, states, None, bvh, height=H, width=W,
            use_bvh=case["bvh"], show_motion=case["show_motion"])
        got = torch.cat([o.image for o in outs]).numpy()
        np.testing.assert_array_equal(got, img)
        assert abs(float(lum) - float((img @ np.float32(
            [0.299, 0.587, 0.114])).mean())) < 1e-4
    np.testing.assert_array_equal(
        torch.cat([s.accum for s in states]).numpy(), want["accum"])
