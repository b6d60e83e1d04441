"""The scan of `live_lanes` (csrc/an_lanes.cuh), on the CPU, and the
cubemap's [6, F, F, 4] copy that its kernels read.

`sky_kernel` (csrc/an_trace.cu), `bvh_hit_mix_kernel` (csrc/hit_mix.cu),
glass's and the mirror's rays and mix kernels (csrc/an_shade.cu:
`an_glass_rays_kernel`, `an_mirror_ray_kernel`, `an_glass_mix_kernel`,
`an_mirror_mix_kernel`) run on persistent blocks over slices of their
mask: a warp loads
kBytes mask bytes a thread (kSliceBytes unless the kernel names another
width; 32 kBytes a slice: kBytes units of 32 bytes, unit g of slice j the
mask's unit j + g * slices), turns each thread's bytes into bits (a bit
trick on 32-bit words), joins 32 / kBytes threads' bits into the 32 bits
of a unit (__shfl_down_sync) and visits the units with a live byte
(__ballot_sync, __ffs), each worked where it lies, its live bytes a
lane a thread.  A pixel mask (a byte a pixel under a leading sample
axis) runs the lanes q + s * n_px of every sample s of its live pixel q;
a lane mask runs lane i of its live byte i, pixel i % n_px.

The model below transcribes that walk thread by thread with the source's
constants, read from its text, and the launch of csrc/persistent.cuh over
a few resident blocks, so that each warp takes several slices: every
live lane is worked exactly once with its own pixel, no dead lane is,
and every mask byte is read once.  It runs at the source's slice width
and at the others the probe tries (probe_live_scan.py), on drawn masks,
on sphere-sized disks, and on the masks a CPU analytic frame hands the
glass and mirror rays and mix kernels (a pixel mask under 4 samples on
`heavy`).  Each kernel's blocks an SM, its slice width and its walk are
read from its source.
"""

import inspect
import os
import re
import zlib

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import (camera_frame_inputs,
                                                 env_from_numpy)
from opengl_raytracing_tpu_torch.models import (RenderState, preset,
                                                render_frame)
from opengl_raytracing_tpu_torch.ops import (an_cuda, an_shade_cuda,
                                             an_trace_cuda)
from opengl_raytracing_tpu_torch.ops import cubemap as tcube
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "opengl_raytracing_tpu_torch", "csrc")


def _source(name="an_lanes.cuh"):
    with open(os.path.join(SRC, name)) as fh:
        return fh.read()


def _const(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1)


def test_the_model_reads_the_source_constants():
    text = _source()
    assert _const(text, "kLiveThreads") == "128"
    assert _const(text, "kLiveQueueCap") == "31 + 32"
    assert _const(text, "kSliceBytes") == "4"
    assert _const(text, "kSliceBlocks") == "12"
    assert "constexpr int64_t kMaxSliceLanes = INT32_MAX - 2 * 32 * 16;" \
        in text


# each live_lanes kernel: its source, and its blocks an SM
# (__launch_bounds__'s minimum, a constant the source declares); 65,536
# registers an SM over blocks of 128 threads: 16 blocks 32 registers a
# thread, 12 40, 10 48, 8 64
LIVE_LANES_KERNELS = {
    "sky_kernel": ("an_trace.cu", "kSliceBlocks", 12),
    "bvh_hit_mix_kernel": ("hit_mix.cu", "kSliceBlocks", 12),
    "an_glass_rays_kernel": ("an_shade.cu", "kGlassRaysBlocks", 8),
    "an_mirror_ray_kernel": ("an_shade.cu", "kMirrorRayBlocks", 8),
    "an_glass_mix_kernel": ("an_shade.cu", "kGlassMixBlocks", 8),
    "an_mirror_mix_kernel": ("an_shade.cu", "kMirrorMixBlocks", 12)}
# the kernels that read no sky, built once (no kCube)
MIXES = ("an_glass_mix_kernel", "an_mirror_mix_kernel")
# each kernel's C entry, and its mask bytes a thread a slice
ENTRIES = {"sky_kernel": "ort_sky", "bvh_hit_mix_kernel": "ort_bvh_hit_mix",
           "an_glass_rays_kernel": "ort_an_glass_rays",
           "an_mirror_ray_kernel": "ort_an_mirror_ray",
           "an_glass_mix_kernel": "ort_an_glass_mix",
           "an_mirror_mix_kernel": "ort_an_mirror_mix"}
WIDTHS = {"sky_kernel": 4, "bvh_hit_mix_kernel": 4,
          "an_glass_rays_kernel": 4, "an_mirror_ray_kernel": 16,
          "an_glass_mix_kernel": 4, "an_mirror_mix_kernel": 8}


def _kernel_text(text, kernel):
    """(its __launch_bounds__ arguments, its body) of __global__ `kernel`
    in source `text`."""
    m = re.search(r"__global__ void __launch_bounds__\(([^)]*)\)\n"
                  + kernel + r"\(", text)
    assert m, kernel
    body = text[m.end():text.index("\n}\n", m.end())]
    return [x.strip() for x in m.group(1).split(",")], body


def _entry_text(text, entry):
    at = text.index(f'extern "C" int {entry}(')
    return text[at:text.index("\n}\n", at)]


def _walk_of(kernel):
    """(the constant that names `kernel`'s mask bytes a thread a slice,
    their count): live_lanes' kBytes as its source passes it
    (kSliceBytes where it passes none)."""
    source = LIVE_LANES_KERNELS[kernel][0]
    text = _source(source)
    _, body = _kernel_text(text, kernel)
    m = re.search(r"live_lanes<[^,>]+(?:, (\w+))?>\(", body)
    assert m, kernel
    width = m.group(1) or "kSliceBytes"
    where = _source() if width == "kSliceBytes" else text
    return width, int(_const(where, width))


@pytest.mark.parametrize("kernel", list(LIVE_LANES_KERNELS))
def test_each_kernels_block_cap_is_the_one_its_source_declares(kernel):
    source, name, blocks = LIVE_LANES_KERNELS[kernel]
    text = _source(source)
    bounds, _ = _kernel_text(text, kernel)
    assert bounds == ["kLiveThreads", name]
    where = text if name != "kSliceBlocks" else _source()
    assert int(_const(where, name)) == blocks
    # the blocks fit an SM's 2,048 threads, with at least 32 registers
    assert blocks * 128 <= 2048
    assert 65536 // (blocks * 128) >= 32


@pytest.mark.parametrize("kernel", list(LIVE_LANES_KERNELS))
def test_each_kernel_walks_its_mask_with_live_lanes(kernel):
    """The kernel's body is live_lanes' (not live_rounds'), its rows read
    at the pixel live_lanes hands it (no division), and its C entry
    launches over the mask's slices and refuses a call over
    kMaxSliceLanes lanes."""
    source = LIVE_LANES_KERNELS[kernel][0]
    text = _source(source)
    _, body = _kernel_text(text, kernel)
    assert re.search(r"live_lanes<(!kCube|false|true)"
                     r"(, \w+)?>\(u, a\.active, a\.n_lanes,\s*a\.n_px,\s*"
                     r"\[&\]\(int64_t i,\s*int64_t q\)", body)
    assert "live_rounds" not in body
    assert not re.search(r"\bin(3|_i32|_f32)\(", body)
    launch = _entry_text(text, ENTRIES[kernel])
    assert "if (args->n_lanes > kMaxSliceLanes) return (int)" \
        "cudaErrorInvalidValue;" in launch
    # over slices of the kernel's own width
    units = re.search(r"slice_units\(args->active, args->n_lanes, "
                      r"args->n_px(?:,\s+(\w+))?\);", launch)
    assert units
    assert (units.group(1) or "kSliceBytes") == _walk_of(kernel)[0]
    # built with the cubemap and with the gradient, chosen by the table
    # (a mix, which reads no sky, once)
    for cube in ("true", "false"):
        assert (f"{kernel}<{cube}>" in launch) == (kernel not in MIXES)
    # glass's and the mirror's kernels: slices of their own width
    assert _walk_of(kernel)[1] == WIDTHS[kernel]


def test_the_rays_kernels_read_the_cubemap_as_whole_texels():
    """Every live_lanes kernel that looks a sky up, glass's and the
    mirror's rays kernels among them, looks it up through an_scene.cuh's
    one cube_or_gradient_sky (texel_sky: the table's [6, F, F, 4] copy, or
    the gradient), never through sky()'s three-float taps; the rays
    kernels' args structs carry the copy.  The mixes read the skies the
    rays kernels wrote and look none up."""
    assert "return kCube ? texel_sky(s, texels, d) : gradient_sky(s, d);" \
        in _source("an_scene.cuh")
    for kernel, (source, _, _) in LIVE_LANES_KERNELS.items():
        _, body = _kernel_text(_source(source), kernel)
        assert ("cube_or_gradient_sky<kCube>(s, a.texels," in body) == (
            kernel not in MIXES)
        assert not re.search(r"\b(texel_|gradient_)?sky\(s,", body)
    for args in (an_shade_cuda._GlassRaysArgs, an_shade_cuda._MirrorRayArgs):
        assert args._fields_[-1][0] == "texels"


SLICE_BYTES = int(_const(_source(), "kSliceBytes"))
WARPS = 128 // 32
LANE, PIXEL, ONE = an_trace_cuda.LANE, an_trace_cuda.PIXEL, an_trace_cuda.ONE


def live_bits(words):
    """an_lanes.cuh's live_bits on uint32 words [..., k]: bit b of the
    result is byte b of the words not 0 (uint32 arithmetic, as the
    kernel's)."""
    w = words.astype(np.uint32)
    hi = (((w & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | w) \
        & np.uint32(0x80808080)
    four = ((hi >> np.uint32(7)) * np.uint32(0x01020408)) >> np.uint32(24)
    bits = np.zeros(w.shape[:-1], np.uint32)
    for k in range(w.shape[-1]):
        bits |= four[..., k] << np.uint32(4 * k)
    return bits


def test_live_bits_is_a_bit_a_byte():
    """Every byte value at every place of a word, and random words."""
    v = np.arange(256, dtype=np.uint32)
    for place in range(4):
        got = live_bits((v << np.uint32(8 * place))[:, None])
        np.testing.assert_array_equal(got, (v != 0).astype(np.uint32)
                                      << np.uint32(place))
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (4096, 16), dtype=np.uint8)
    raw[rng.random(raw.shape) < 0.5] = 0
    words = raw.view("<u4")
    want = ((raw != 0) * (1 << np.arange(16))).sum(1).astype(np.uint32)
    np.testing.assert_array_equal(live_bits(words), want)


def slice_words(mask, first, n, slice_bytes, reads):
    """A thread's slice_words: its slice_bytes bytes from `first` as
    uint32 words, bytes at or past n read 0, a null mask 1 below n; the
    offsets it reads appended to `reads`."""
    raw = np.zeros(slice_bytes, np.uint8)
    for b in range(slice_bytes):
        if first + b < n:
            if mask is not None:
                reads.append(first + b)
            raw[b] = 1 if mask is None else mask[first + b]
    return raw.view("<u4")


def walk(mask, mode, n_lanes, n_px, resident, slice_bytes=SLICE_BYTES,
         stats=None):
    """(the (lane, pixel) pairs live_lanes hands `work`, in a warp's
    order, warp after warp; the mask's offsets read): `mask` the mask's
    bytes as the kernel reads them (a byte a lane, a pixel or one; None:
    every lane live), `resident` the blocks that fit the card.  `stats`
    (a dict) counts the live bytes of full units ("full") and of sparser
    ones ("partial"), each unit worked where it lies."""
    stats = {} if stats is None else stats
    stats.update(full=0, partial=0)
    reads = []
    if mask is not None and mode == ONE:
        reads.append(0)
        if mask[0] == 0:
            return [], reads
        mask = None
    pixel = mask is not None and mode == PIXEL
    n = n_px if pixel else n_lanes
    reps = n_lanes // n_px if pixel else 1
    stride = n_px if pixel else 0
    own_px = pixel or n_lanes == n_px
    slice_lanes = 32 * slice_bytes
    per = 32 // slice_bytes
    n_units = -(-n // slice_lanes)
    span = 32 * n_units  # bytes between a slice's units
    blocks = min(resident, -(-n_units // WARPS))
    calls = []

    def run(b):
        px = b if own_px else b % n_px
        calls.extend((b + s * stride, px) for s in range(reps))

    for block in range(blocks):
        for warp in range(WARPS):
            j = warp * blocks + block
            step = WARPS * blocks
            while j < n_units:
                bits = [int(live_bits(slice_words(
                    mask, 32 * j + lane // per * span
                    + lane % per * slice_bytes, n, slice_bytes,
                    reads)[None])[0])
                    for lane in range(32)]
                # __shfl_down_sync past lane 31 reads the lane's own value
                g = [bits[lane] | sum(
                    bits[min(lane + k, 31)] << (k * slice_bytes)
                    for k in range(1, per)) for lane in range(32)]
                for src in range(0, 32, per):      # __ffs order
                    live = g[src]
                    first = src // per * span + 32 * j
                    mine = [first + lane for lane in range(32)
                            if live >> lane & 1]
                    stats["full" if live == 0xFFFFFFFF else "partial"] += \
                        len(mine)
                    for b in mine:
                        run(b)
                j += step
    return calls, reads


def _mask_case(kind, shape, rng):
    """(bool mask over `shape`, or None) of each mask kind."""
    if kind == "none":
        return None
    if kind == "empty":
        return torch.zeros(shape, dtype=torch.bool)
    if kind == "full":
        return torch.ones(shape, dtype=torch.bool)
    if kind == "last":
        m = torch.zeros(shape, dtype=torch.bool)
        m.view(-1)[-1] = True
        return m
    if kind == "one_live":  # one byte for every lane
        return torch.ones((), dtype=torch.bool).expand(shape)
    if kind == "one_dead":
        return torch.zeros((), dtype=torch.bool).expand(shape)
    density = {"sparse": 0.01, "dense": 0.65}[kind]
    return torch.from_numpy(rng.random(shape) < density)


KINDS = ("none", "empty", "full", "last", "one_live", "one_dead", "sparse",
         "dense")
# (samples, rows, cols): n_px not a multiple of the slice, an odd n_px,
# slices beyond the resident warps' first pass
SHAPES = ((1, 37, 61), (1, 64, 96), (4, 23, 31), (4, 40, 64))


@pytest.mark.parametrize("slice_bytes", sorted({SLICE_BYTES, 16, 8, 4}))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("per_pixel", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_every_live_lane_is_worked_once(kind, per_pixel, shape, slice_bytes):
    spp, rows, cols = shape
    n_px = rows * cols
    call = (spp, rows, cols) if spp > 1 else (rows, cols)
    rng = np.random.default_rng(zlib.crc32(repr((kind, shape,
                                                      per_pixel)).encode()))
    m = _mask_case(kind, (rows, cols) if per_pixel else call, rng)
    live = torch.ones(call, dtype=torch.bool) if m is None \
        else m.expand(call)
    if m is None:
        bytes_, mode = None, LANE
    else:
        lane_in, rows_t = an_trace_cuda.lane_input(
            m, torch.Size(call), 0, torch.bool, torch.device("cpu"),
            "active")
        bytes_, mode = rows_t.numpy().astype(np.uint8), lane_in.mode
        # a pixel mask under the sample axis is read a byte a pixel
        assert mode == (ONE if kind.startswith("one") else
                        PIXEL if per_pixel and spp > 1 else LANE)
    n_lanes = live.numel()
    calls, reads = walk(bytes_, mode, n_lanes, n_px, resident=3,
                        slice_bytes=slice_bytes)
    # each mask byte read once: a pixel mask's n_px under the samples
    n_bytes = 0 if bytes_ is None else 1 if mode == ONE else len(bytes_)
    assert sorted(reads) == list(range(n_bytes))
    assert n_bytes == (n_px if mode == PIXEL else n_lanes if mode == LANE
                       and bytes_ is not None else n_bytes)
    lanes = np.array([i for i, _ in calls], dtype=np.int64)
    assert len(set(lanes.tolist())) == len(lanes), "a lane worked twice"
    want = np.flatnonzero(live.reshape(-1).numpy())
    np.testing.assert_array_equal(np.sort(lanes), want)
    for i, q in calls:
        assert q == i % n_px


# ---- the glass and mirror rays and mix kernels' masks ----

RAYS = ("glass_rays", "mirror_ray")
MIX_CALLS = ("glass_mix", "mirror_mix")
# the CPU analytic frames whose rays and mix calls are walked (96x128):
# an_full's and an_baseline's presets (a byte a lane), analytic `heavy`
# (4 samples, a byte a pixel)
RAY_FRAMES = {"an_full": "full", "an_baseline": "baseline", "heavy": "heavy"}
_RAY_CALLS = {}


def _call_shape(name, a):
    """The lanes of a recorded call of shade wrapper `name`."""
    if name == "glass_mix":
        return a["rays"].k.shape
    if name == "mirror_mix":
        return a["ray"].hit.t.shape
    return torch.broadcast_shapes(a["h"].t.shape, a["wo"].shape[:-1])


def _ray_calls(case):
    """{wrapper: (its call's mask bytes as the kernel reads them, their
    mode, n_lanes, n_px, the live lanes)} of the glass and mirror rays
    and mix calls of one eager CPU analytic frame of RAY_FRAMES[case]."""
    if case in _RAY_CALLS:
        return _RAY_CALLS[case]
    h, w = 96, 128
    real = {n: getattr(an_shade_cuda, n) for n in RAYS + MIX_CALLS}
    calls = {}

    def spy(name):
        def fn(*args, **kw):
            bound = inspect.signature(real[name]).bind(*args, **kw)
            bound.apply_defaults()
            calls[name] = dict(bound.arguments)
            return real[name](*args, **kw)
        return fn
    cam = Camera()
    cam.aspect = w / h
    fin = camera_frame_inputs(cam, "cpu", jitter=(0.2, -0.1), frame_index=5)
    try:
        for n in real:
            setattr(an_shade_cuda, n, spy(n))
        render_frame(preset(RAY_FRAMES[case]), fin,
                     RenderState.create(h, w, "cpu"), None, height=h,
                     width=w)
    finally:
        for n, fn in real.items():
            setattr(an_shade_cuda, n, fn)
    out = {}
    for name, a in calls.items():
        shape = _call_shape(name, a)
        lane_in, rows = an_trace_cuda.lane_input(
            a["active"], shape, 0, torch.bool, torch.device("cpu"), "active")
        out[name] = (rows.numpy().astype(np.uint8), lane_in.mode,
                     shape.numel(), an_trace_cuda.n_px_of(shape),
                     a["active"].expand(shape).reshape(-1).numpy())
    _RAY_CALLS[case] = out
    return out


def _check_once(calls, live, n_lanes, n_px, pixel_bytes=None):
    """Every live lane worked once, with its own pixel; with
    `pixel_bytes` (a pixel mask) every sample of a live pixel once."""
    lanes = np.array([i for i, _ in calls], dtype=np.int64)
    assert len(set(lanes.tolist())) == len(lanes), "a lane worked twice"
    np.testing.assert_array_equal(np.sort(lanes), np.flatnonzero(live))
    for i, q in calls:
        assert q == i % n_px
    if pixel_bytes is not None:
        pairs = {(q, i // n_px) for i, q in calls}
        assert len(pairs) == len(calls) == \
            (n_lanes // n_px) * int((pixel_bytes != 0).sum())


@pytest.mark.parametrize("kernel", RAYS)
@pytest.mark.parametrize("case", list(RAY_FRAMES))
def test_the_rays_calls_masks_are_worked_once(case, kernel):
    """The mask a CPU analytic frame hands glass's or the mirror's rays
    kernel, walked by the model at the slice width the kernel's source
    gives it: every mask byte read once, every
    live lane worked once, and under `heavy`'s 4 samples a byte a pixel
    with each sample of a live pixel worked once."""
    bytes_, mode, n_lanes, n_px, live = _ray_calls(case)[kernel]
    assert mode == (PIXEL if case == "heavy" else LANE)
    assert live.any() and not live.all()
    _, slice_bytes = _walk_of(f"an_{kernel}_kernel")
    calls, reads = walk(bytes_, mode, n_lanes, n_px, resident=3,
                        slice_bytes=slice_bytes)
    assert sorted(reads) == list(range(len(bytes_)))
    _check_once(calls, live, n_lanes, n_px,
                bytes_ if mode == PIXEL else None)


@pytest.mark.parametrize("kernel", MIX_CALLS)
@pytest.mark.parametrize("case", list(RAY_FRAMES))
def test_the_mix_calls_masks_are_worked_once(case, kernel):
    """The mask a CPU analytic frame hands glass's or the mirror's mix
    kernel (its material's lanes, as the rays call's), walked by the model
    at the slice width the kernel's source gives it: every mask byte read
    once, every live lane worked once with its own pixel, and under
    `heavy`'s 4 samples a byte a pixel with each sample of a live pixel
    worked once."""
    calls_of = _ray_calls(case)
    bytes_, mode, n_lanes, n_px, live = calls_of[kernel]
    assert mode == (PIXEL if case == "heavy" else LANE)
    assert live.any() and not live.all()
    # the mix's lanes are its rays call's
    ray = {"glass_mix": "glass_rays", "mirror_mix": "mirror_ray"}[kernel]
    np.testing.assert_array_equal(live, calls_of[ray][4])
    _, slice_bytes = _walk_of(f"an_{kernel}_kernel")
    calls, reads = walk(bytes_, mode, n_lanes, n_px, resident=3,
                        slice_bytes=slice_bytes)
    assert sorted(reads) == list(range(len(bytes_)))
    _check_once(calls, live, n_lanes, n_px,
                bytes_ if mode == PIXEL else None)


def _disks(rows, cols, rng, n=2):
    """A bool mask [rows, cols] of `n` disks of radius 20-40 pixels at
    drawn centres: the footprint of a glass or mirror sphere."""
    y, x = np.mgrid[:rows, :cols]
    m = np.zeros((rows, cols), bool)
    for _ in range(n):
        cy, cx = rng.uniform(0, rows), rng.uniform(0, cols)
        r = rng.uniform(20, 40)
        m |= (y - cy) ** 2 + (x - cx) ** 2 < r * r
    return m


@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("seed", range(3))
def test_sphere_disks_work_full_units_in_place_and_lanes_once(spp, seed):
    """Sphere-sized disks of live pixels: their full units of 32 and their
    rims' sparser units are each worked where they lie, each live lane
    once (a pixel mask under 4 samples: each sample of a live pixel
    once)."""
    rows, cols = 120, 256
    m = torch.from_numpy(_disks(rows, cols, np.random.default_rng(seed)))
    call = torch.Size((spp, rows, cols) if spp > 1 else (rows, cols))
    lane_in, rows_t = an_trace_cuda.lane_input(
        m, call, 0, torch.bool, torch.device("cpu"), "active")
    assert lane_in.mode == (PIXEL if spp > 1 else LANE)
    bytes_ = rows_t.numpy().astype(np.uint8)
    stats = {}
    calls, reads = walk(bytes_, lane_in.mode, call.numel(), rows * cols,
                        resident=3, stats=stats)
    assert sorted(reads) == list(range(rows * cols))
    assert stats["full"] > 0 and stats["partial"] > 0
    assert stats["full"] + stats["partial"] == int(m.sum())
    _check_once(calls, m.expand(call).reshape(-1).numpy(), call.numel(),
                rows * cols, bytes_ if spp > 1 else None)


# ---- the cubemap's [6, F, F, 4] copy ----

def _table(f=8, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (6, f, f, 3), dtype=np.uint8)


def test_texel4_table_holds_the_table_bits():
    env = env_from_numpy(_table(), "cpu")
    padded = tcube.texel4_table(env)
    assert padded.shape == (6, 8, 8, 4) and padded.dtype == torch.float32
    assert padded.is_contiguous()
    assert torch.equal(padded[..., :3].view(torch.int32),
                       env.view(torch.int32))
    assert (padded[..., 3] == 0).all()
    # the wrappers' copy: where the parameters enable the table
    params = preset("full")
    assert an_cuda.env_texels(params, env, torch.device("cpu")) is padded
    assert an_cuda.env_texels(params.replace(enable_env_map=0), env,
                              torch.device("cpu")) is None
    assert an_cuda.env_texels(params, None, torch.device("cpu")) is None


def test_the_copy_is_made_once_a_table_and_anew_when_it_changes():
    env = env_from_numpy(_table(), "cpu")
    # a frame's scene holds the table itself: its copy is made once for
    # every frame of one environment
    scenes = [SceneCtx.create(preset("full"), torch.zeros(3), env_map=env)
              for _ in range(2)]
    assert all(s.env_map is env for s in scenes)
    p = tcube.texel4_table(scenes[0].env_map)
    assert tcube.texel4_table(scenes[1].env_map) is p
    # another env map: its own copy
    other = env_from_numpy(_table(seed=4), "cpu")
    b = tcube.texel4_table(other)
    assert b is not p and torch.equal(b[..., :3], other)
    assert not torch.equal(b[..., :3], p[..., :3])
    # the same table changed in place: a copy of its new bits, the one
    # made before kept as it was
    env.mul_(0.5)
    q = tcube.texel4_table(env)
    assert q is not p
    assert torch.equal(q[..., :3], env)
    assert not torch.equal(p[..., :3], env)
    # a table's copies go with it
    key = id(env)
    assert key in tcube._TEXEL4
    del env, scenes, p, q
    assert key not in tcube._TEXEL4
