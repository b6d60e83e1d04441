"""The scan of `live_lanes` (csrc/an_lanes.cuh), on the CPU, and the
cubemap's [6, F, F, 4] copy that the sky kernel and the BVH hit mix read.

`sky_kernel` (csrc/an_trace.cu) and `bvh_hit_mix_kernel` (csrc/hit_mix.cu)
run on persistent blocks over slices of their mask: a warp loads
kSliceBytes mask bytes a thread (kSliceLanes a slice: kSliceBytes units
of 32 bytes, unit g of slice j the mask's unit j + g * slices), turns
each thread's bytes into bits (a bit trick on 32-bit words), joins
32 / kSliceBytes threads' bits into the 32 bits of a unit
(__shfl_down_sync) and visits the units with a live byte (__ballot_sync,
__ffs).  A unit whose 32 bytes are all live is worked where it lies; a
sparser unit's live bytes join the warp's queue, worked 32 a round, and
what is left after the warp's last slice is worked at the end.  A
pixel mask (a byte a pixel under a leading sample axis) runs the lanes
q + s * n_px of every sample s of its live pixel q; a lane mask runs lane
i of its live byte i, pixel i % n_px.

The model below transcribes that walk thread by thread with the source's
constants, read from its text, and the launch of csrc/persistent.cuh over
a few resident blocks, so that each warp takes several slices: every
live lane is worked exactly once with its own pixel, no dead lane is,
every mask byte is read once, and no queue outgrows its room.  It runs at
the source's slice width and at the others the probe tries
(probe_live_scan.py).
"""

import os
import re
import zlib

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu_torch.convert import env_from_numpy
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.ops import an_cuda, an_trace_cuda
from opengl_raytracing_tpu_torch.ops import cubemap as tcube
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "opengl_raytracing_tpu_torch", "csrc")


def _source():
    with open(os.path.join(SRC, "an_lanes.cuh")) as fh:
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
    assert _const(text, "kSliceLanes") == "32 * kSliceBytes"


SLICE_BYTES = int(_const(_source(), "kSliceBytes"))
QUEUE_CAP = 31 + 32
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


def walk(mask, mode, n_lanes, n_px, resident, slice_bytes=SLICE_BYTES):
    """(the (lane, pixel) pairs live_lanes hands `work`, in a warp's
    order, warp after warp; the mask's offsets read): `mask` the mask's
    bytes as the kernel reads them (a byte a lane, a pixel or one; None:
    every lane live), `resident` the blocks that fit the card.  Asserts
    the queue's room."""
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
            queue = []
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
                    if live == 0xFFFFFFFF:         # worked where it lies
                        for b in mine:
                            run(b)
                        continue
                    queue.extend(mine)
                    assert len(queue) <= QUEUE_CAP
                    if len(queue) >= 32:
                        for b in queue[-32:]:
                            run(b)
                        del queue[-32:]
                j += step
            for b in queue:
                run(b)
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
