"""The schedule of `bvh_direct_kernel` (csrc/an_direct.cu), modelled on
the CPU at 48x64 on the goldens' bunny scene.

The kernel runs persistent blocks over units of 32 rows.  A unit's warp
takes the live rows (__ballot_sync of the mask) and works a chunk at a
time: chunk k holds sample k's four disk windows of each live pixel and,
in chunk 0, its sun and point windows.  Each pixel's lane puts its open
windows in the warp's list, window by window (all lanes' disk window 0
first); the warp walks the list 32 entries a round, and each pixel's lane
reads its windows' bits from the rounds' ballot words.  The model below
transcribes that bookkeeping (the entries' indices from the ballot words,
the list's capacity, the round words, the owner's reads) with the
source's constants, and reads which windows are open from `lighting._bvh_shadow_queries`, as the
kernel builds the same queries.  The tests check that every open window
of a live row is walked exactly once and no closed one is, and that the
plain walk's bits reassembled in the owners' order give
`direct_light_bvh_plain`'s radiance bit for bit: one row a lane (dup 1,
also over a sampled batch), and a hit shared by dup 2 and 4 samples
(spp_dup: the sun and point windows walked once, in chunk 0).  The
persistent loop of csrc/persistent.cuh (units to warps, block-minor),
read from its text, is checked to visit every unit exactly once.
"""

import os
import re

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import camera_frame_inputs
from opengl_raytracing_tpu_torch.models import pipeline as tpipe
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.ops import lighting as lt
from opengl_raytracing_tpu_torch.ops.bvh_traverse import (trace_bvh,
                                                          trace_bvh_shadow)
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx, prepare_bvh
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.ops.vecmath import normalize
from opengl_raytracing_tpu_torch.params import bind
from opengl_raytracing_tpu_torch.sampling import FrameValue
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

torch.set_num_threads(2)

H, W = 48, 64
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "opengl_raytracing_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "an_direct.cu")

# The source's constants (test_constants_are_the_sources reads them)
THREADS = 128         # kThreads: a block of bvh_direct_kernel
UNIT = 32             # rows a unit: make_units(n_units, 32)
SAMPLES = 4           # kSamples, the disk windows of a sample
CHUNK_WINDOWS = SAMPLES + 2   # kChunkWindows
LIST_CAP = 32 * CHUNK_WINDOWS  # kListCap, entries of a warp's list
SUN, POINT = SAMPLES, SAMPLES + 1   # the windows after the disk ones


def test_constants_are_the_sources():
    with open(SRC) as fh:
        src = fh.read()
    for line in ("constexpr int kThreads = 128;",
                 "constexpr int kWarps = kThreads / 32;",
                 "constexpr int kSamples = 4;",
                 "constexpr int kChunkWindows = kSamples + 2;",
                 "constexpr int kListCap = 32 * kChunkWindows;",
                 "constexpr int kDirectBlocks = 7;",
                 "__launch_bounds__(kThreads, kDirectBlocks)",
                 "make_units(n_units, 32)"):
        assert line in src, line
    assert (THREADS, UNIT, LIST_CAP) == (128, 32, 192)
    # the list's bytes stated in the source: 28 B an entry, 4 warps
    m = re.search(r"(\d+),(\d+) B a block", src)
    assert int(m.group(1) + m.group(2)) == (
        THREADS // 32 * (LIST_CAP * 28 + LIST_CAP // 32 * 4))


def _persistent_source():
    """persistent.cuh's unit loop as Python: (first, stride) of
    (threadIdx.x, blockIdx.x, blockDim.x, gridDim.x), read from the
    source's first() and stride(); and its text."""
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
    return expr("first"), expr("stride"), src


@pytest.mark.parametrize("n_units", [1, 5, 96, 64800, 259200])
def test_persistent_loop_visits_every_unit_once(n_units):
    """csrc/persistent.cuh, read from its text: launch_persistent's grid
    is min(SMs x blocks an SM, the blocks the units need), and warp w of
    block b takes units first(), then every stride()-th: each unit of
    the call exactly once (132 SMs, one block an SM or seven, as K5's
    bound gives)."""
    first, stride, src = _persistent_source()
    for line in ("int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);",
                 "if (blocks > (u.n_units + warps - 1) / warps)",
                 "blocks = (u.n_units + warps - 1) / warps;"):
        assert line in src, line
    warps = THREADS // 32
    for per_sm in (1, 7):
        grid = min(132 * per_sm, -(-n_units // warps))
        seen = np.zeros(n_units, dtype=np.int64)
        for b in range(grid):
            for w in range(warps):
                j0 = first(32 * w, b, THREADS, grid)
                seen[j0::stride(32 * w, b, THREADS, grid)] += 1
        assert (seen == 1).all()


# ---- the bunny scene ----

@pytest.fixture(scope="module")
def bunny():
    """The goldens' bunny (make_bunny(2)) at fov 12: the sanitized primary
    hit, its hit mask, the pixel centres and view directions."""
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    bvh = prepare_bvh(tris, "cpu")
    cam = Camera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    params = bind(preset("full"), "cpu")
    fin = camera_frame_inputs(cam, "cpu")
    px, py, rd = tpipe.primary_rays(H, W, fin, params)
    ro = fin.cam_pos.expand(rd.shape)
    h_raw = trace_bvh(bvh.arrays, ro, rd)
    hit = h_raw.valid
    assert 0.2 < float(hit.float().mean()) < 0.9
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=True, bvh=bvh)
    return dict(scene=scene, h=tpipe._sanitize_hit(h_raw, ro, rd), hit=hit,
                px=px, py=py, vdir=-rd)


def _batch(x, spp):
    return x.expand((spp,) + x.shape)


# ---- the model ----

def _ballot(bits):
    return sum(1 << lane for lane, b in enumerate(bits) if b)


def _popc(x):
    return bin(x).count("1")


def kernel_schedule(wins, live, dup):
    """The kernel's walks over rows with windows `wins` (a dict: window ->
    [dup, n_rows] float windows of each sample; the sun's and point's
    are read at sample 0) and live rows `live` ([n_rows] bool).

    Returns (entries, reads): `entries` the walked windows (window,
    sample, row) in the order the warps' rounds walk them, unit by unit
    and chunk by chunk, with their list index; `reads` for each live
    (window, sample, row) the list index its lane reads its bit from (-1:
    none, not occluded)."""
    n_rows = live.shape[0]
    entries, reads = [], {}
    for base in range(0, n_rows, UNIT):
        rows = list(range(base, min(base + UNIT, n_rows)))
        lanes = [bool(live[r]) for r in rows] + [False] * (UNIT - len(rows))
        mask = _ballot(lanes)
        if mask == 0:
            continue
        for k in range(dup):
            chunk = [w for w in range(SAMPLES)] + (
                [w for w in (SUN, POINT) if w in wins] if k == 0 else [])
            n = 0
            listed = []
            for w in chunk:  # every lane, window by window
                ks = k if w < SAMPLES else 0
                opens = [lanes[ln] and wins[w][ks, rows[ln]] > 0.0
                         if ln < len(rows) else False for ln in range(UNIT)]
                b = _ballot(opens)
                index = [n + _popc(b & ((1 << ln) - 1)) if opens[ln] else -1
                         for ln in range(UNIT)]
                n += _popc(b)
                for ln, e in enumerate(index):
                    if e >= 0:
                        listed.append((e, (w, ks, rows[ln])))
                    if lanes[ln]:
                        reads[(w, ks, rows[ln])] = e
            assert n <= LIST_CAP
            listed.sort()
            assert [e for e, _ in listed] == list(range(n))
            # the rounds: lane e % 32 of round e // 32 walks entry e
            entries += [(key, base, k, e) for e, key in listed]
    return entries, reads


def _queries(f, spp, dup, mask):
    """The call's arguments (scene, hit, rng_frame, frame_index, vdir, px,
    py, active) over `spp` samples (1: none), and the plain version's
    shadow queries of it."""
    scene, h = f["scene"], f["h"]
    frame = FrameValue.of(5, "cpu")
    active = {"bunny": f["hit"], "dead": torch.zeros_like(f["hit"]),
              "live": None}[mask]
    if spp == 1:
        args = (scene, h, frame * 3 + 1, frame, f["vdir"], f["px"], f["py"],
                active)
    else:
        args = (scene, Hit(*(_batch(x, spp) for x in h)), frame.sampled(spp),
                frame, _batch(f["vdir"], spp), _batch(f["px"], spp),
                _batch(f["py"], spp),
                None if active is None else _batch(active, spp))
    h_b = args[1]
    offs = lt._disk_offsets(args[2], args[3], args[5], args[6])
    o, d, w = lt._bvh_shadow_queries(scene, h_b, normalize(h_b.n), offs,
                                     args[7])
    return args, offs, o, d, w


@pytest.mark.parametrize("mask", ["bunny", "dead", "live"])
@pytest.mark.parametrize("spp,dup", [(1, 1), (2, 1), (2, 2), (4, 4)])
def test_schedule_walks_each_open_window_once_and_gives_the_plain_bits(
        bunny, spp, dup, mask):
    """Every open window of a live row walked exactly once, no closed one;
    the plain walk's bits on the walked windows, read back in the owners'
    order, shade to direct_light_bvh_plain's radiance bit for bit.  spp 2
    with dup 1 is GI's call over a sampled batch (a row a lane); dup > 1
    the primary call's shared hit (a row a pixel)."""
    f = bunny
    scene = f["scene"]
    args, offs, o, d, w = _queries(f, spp, dup, mask)
    shape = args[1].t.shape
    names = list(range(SAMPLES)) + [x for x, on in (
        (SUN, scene.params.sun_enabled),
        (POINT, scene.params.point_light_enabled)) if on]
    assert len(names) == len(w) == CHUNK_WINDOWS
    rows_shape = (dup, shape.numel() // dup)
    wins = {x: w[j].expand(shape).reshape(rows_shape).numpy()
            for j, x in enumerate(names)}
    act = args[7]
    live = (np.ones(rows_shape[1], dtype=bool) if act is None
            else act.expand(shape).reshape(rows_shape)[0].numpy())
    entries, reads = kernel_schedule(wins, live, dup)

    # every open window of a live row exactly once, no closed window
    walked = [key for key, _, _, _ in entries]
    assert len(walked) == len(set(walked))
    want = {(x, k, r) for x in names for k in range(dup if x < SAMPLES
                                                    else 1)
            for r in np.flatnonzero(live & (wins[x][k] > 0.0))}
    assert set(walked) == want
    if mask == "dead":
        assert not walked and not reads
    else:
        assert walked

    # the plain walk of the list's entries, in the rounds' order
    def rays(x, k, r):
        j = names.index(x)
        lane = k * rows_shape[1] + r
        return (o[j].expand(shape + (3,)).reshape(-1, 3)[lane],
                d[j].expand(shape + (3,)).reshape(-1, 3)[lane],
                w[j].expand(shape).reshape(-1)[lane])
    # each round's ballot word (bit e % 32 of word e // 32 of the unit's
    # chunk), read by the owners
    words = {}
    if entries:
        ro, rd, tm = (torch.stack(c) for c in zip(
            *(rays(*key) for key, _, _, _ in entries)))
        bits = trace_bvh_shadow(scene.bvh.arrays, ro, rd, tm)
        for (key, base, k, e), b in zip(entries, bits.tolist()):
            words[(base, k, e >> 5)] = (words.get((base, k, e >> 5), 0)
                                        | int(b) << (e & 31))
    occ = torch.zeros((len(names),) + rows_shape, dtype=torch.bool)
    for (x, k, r), e in reads.items():
        base = r - r % UNIT
        bit = e >= 0 and bool((words.get((base, k, e >> 5), 0)
                               >> (e & 31)) & 1)
        j = names.index(x)
        if x < SAMPLES:
            occ[j, k, r] = bit
        else:  # the shared sun and point bits: every sample's
            occ[j, :, r] = bit
    got = lt.shade_bvh_brdf_plain(scene, args[1], normalize(args[1].n),
                                  normalize(args[4]), offs,
                                  occ.reshape((len(names),) + shape))
    want_rad = lt.direct_light_bvh_plain(*args, spp_dup=dup if dup > 1
                                         else 0)
    assert torch.equal(got, want_rad)


def test_a_chunk_fits_the_list_at_every_dup():
    """At dup 16 (66 windows a pixel) every chunk of a full unit still
    fits the list: chunk 0 holds 6 windows a pixel, the others 4."""
    live = np.ones(UNIT, dtype=bool)
    wins = {x: np.ones((16, UNIT), dtype=np.float32)
            for x in list(range(SAMPLES)) + [SUN, POINT]}
    entries, reads = kernel_schedule(wins, live, 16)
    assert len(entries) == UNIT * (4 * 16 + 2)
    assert max(e for _, _, _, e in entries) == LIST_CAP - 1
    assert len(reads) == UNIT * (4 * 16 + 2)
