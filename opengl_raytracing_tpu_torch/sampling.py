"""RNG, low-discrepancy sequences and sampling helpers (PyTorch).

Counterpart of `opengl_raytracing_tpu/sampling.py` (reference:
shaders/rt/rt_common.glsl:57-179, src/app/application.cpp:28-47).  The
integer hash must match bit for bit, because the noise pattern feeds the
soft shadows.  torch's uint32 support is partial, so the hash runs on
int64 tensors and masks with 0xFFFFFFFF after every multiply, add and
shift: the low 32 bits are then exactly the uint32 result.

A frame counter is a `FrameValue`, an int32 `index * a + b` of the frame
index held on the device, as the JAX package's traced int32 seeds are
(`frame * 1663` wraps at 32 bits every way), or an int tensor.  That
keeps every per-frame number out of the host arguments of the frame's
operations, so that one captured CUDA graph serves every frame
(models/graph.py).  The host ints of the frame index stay where the host
needs them: the record's ld2 (`record_words`) and the jitter.

A frame's samples a pixel shade as one batch over a leading sample axis
([spp, H, W], models/pipeline.py), so a seed may carry that axis too:
sample s of a FrameValue with a stride reads `index * a + b + s * c`
(`FrameValue.sampled`), and its value, its bits and its float32 are
[spp, 1, 1] tensors that broadcast over the batch's pixel grids, as the
JAX package's `frame_index * spp + arange(spp)` seeds do.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .constants import PI
from .ops.vecmath import const3, cross, normalize

_M32 = 0xFFFFFFFF


def _lcg(v):
    return (v * 1664525 + 1013904223) & _M32


def hash2(vx, vy):
    """LCG + xorshift mix of two uint32 lanes (int64 tensors holding
    values in [0, 2^32)) -> uint32 in an int64 tensor
    (reference: shaders/rt/rt_common.glsl:57-73)."""
    vx = _lcg(vx)
    vy = _lcg(vy)
    vx = vx ^ (vy >> 16)
    vy = vy ^ ((vx << 5) & _M32)
    return _lcg(vx) ^ _lcg(vy)


@dataclasses.dataclass(frozen=True)
class FrameValue:
    """int32(index * a + b + s * c) of sample s, where index is the frame
    index of `record`: an int32 [3] tensor on the frame's device holding
    the index and ld2(index) as float32 bits (`frame_record`; the first
    words of the frame's block, models/frame_block.py).  `a`, `b` and the
    per-sample stride `c` are host ints taken mod 2^32 and constant per
    configuration; `samples` is the length of the sample axis (1: none).
    A seed such as `frame * spp + s`, the batch's `frame.sampled(spp)`, or
    the mirror GI's `seed * 131 + 17` of either is a FrameValue too; the
    kernels read the record through a pointer and derive a lane's sample
    from its position (csrc/sampling.cuh)."""
    record: torch.Tensor
    a: int = 1
    b: int = 0
    c: int = 0
    samples: int = 1

    @staticmethod
    def of(index: int, device) -> "FrameValue":
        """Frame `index` itself, from a record of its own on `device` (one
        host-to-device copy; a frame takes its record from its block)."""
        return FrameValue(frame_record(index, device))

    @property
    def index(self) -> torch.Tensor:
        return self.record[0]

    def sampled(self, spp: int) -> "FrameValue":
        """The seeds `self * spp + s` of samples s = 0 .. spp-1 as one value
        with a sample axis of length spp (the JAX package's
        `frame_index * spp + arange(spp)`)."""
        if self.samples != 1:
            raise ValueError("the value has a sample axis already")
        v = self * spp
        return FrameValue(v.record, v.a, v.b, 1, int(spp))

    def __mul__(self, k: int) -> "FrameValue":
        return FrameValue(self.record, (self.a * k) & _M32,
                          (self.b * k) & _M32, (self.c * k) & _M32,
                          self.samples)

    def __add__(self, k: int) -> "FrameValue":
        return FrameValue(self.record, self.a, (self.b + k) & _M32, self.c,
                          self.samples)

    __rmul__ = __mul__
    __radd__ = __add__


Frame = Union[torch.Tensor, FrameValue]


def frame_record(index: int, device) -> torch.Tensor:
    """The int32 [3] record of frame `index` on `device`: the index, then
    ld2(index) as float32 bits (one host-to-device copy)."""
    return torch.from_numpy(record_words(index)).to(device)


def record_words(index: int) -> np.ndarray:
    """The three int32 words of frame `index`'s record."""
    ld = np.asarray(ld2(int(index)), np.float32)
    return np.concatenate([np.asarray([np.int64(index)]).astype(np.int32),
                           ld.view(np.int32)])


def affine(frame: Frame):
    """(index tensor, a, b) with frame == int32(index * a + b) at sample 0;
    an int tensor is (frame, 1, 0)."""
    if isinstance(frame, FrameValue):
        return frame.index, frame.a, frame.b
    if isinstance(frame, torch.Tensor):
        return frame, 1, 0
    raise TypeError(f"a frame is a sampling.FrameValue or an int tensor, "
                    f"not {type(frame).__name__}")


def samples_of(frame: Frame) -> int:
    """The length of the frame's sample axis: 1 for a value without one."""
    return frame.samples if isinstance(frame, FrameValue) else 1


def sample_seeds(frame: Frame, spp: int) -> Frame:
    """The seeds `frame * spp + s` of a frame's spp samples: `frame *
    spp` for one sample, else one value with a sample axis (an int tensor
    frame gives the [spp, 1, 1] tensor of them)."""
    if spp == 1:
        return frame * 1
    if isinstance(frame, FrameValue):
        return frame.sampled(spp)
    return (frame * spp + torch.arange(spp, dtype=frame.dtype,
                                       device=frame.device)).reshape(
        (spp, 1, 1))


def _frame_bits(frame: Frame, mult: int = 1) -> torch.Tensor:
    """uint32 bits of int32(frame * mult): an int64 tensor on the frame's
    device, 0-d, or [samples, 1, 1] for a value with a sample axis."""
    index, a, b = affine(frame)
    a, b = (a * mult) & _M32, (b * mult) & _M32
    bits = index.to(torch.int64)
    if a != 1:
        bits = bits * a
    if b:
        bits = bits + b
    n = samples_of(frame)
    if n > 1:
        c = (frame.c * mult) & _M32
        bits = bits + torch.arange(n, dtype=torch.int64,
                                   device=bits.device).reshape(n, 1, 1) * c
    return bits & _M32


def frame_value(frame: Frame) -> torch.Tensor:
    """int32(frame): an int32 tensor on the frame's device (0-d, or
    [samples, 1, 1] for a value with a sample axis)."""
    index, a, b = affine(frame)
    if ((a, b) == (1, 0) and samples_of(frame) == 1
            and index.dtype == torch.int32):
        return index  # the frame index itself
    bits = _frame_bits(frame)
    return torch.where(bits > 0x7FFFFFFF, bits - (1 << 32),
                       bits).to(torch.int32)


def frame_f32(frame: Frame) -> torch.Tensor:
    """float32(int32(frame)): the sample offsets' `f32(seed * 19)` of the
    JAX package's int32 seeds, a float32 tensor shaped as `frame_value`'s
    (a sampled seed's [samples, 1, 1] broadcasts over the batch)."""
    return frame_value(frame).to(torch.float32)


def rand(px, py, frame: Frame):
    """float RNG in [0,1): rand(vec2 p, int frame)
    (reference: shaders/rt/rt_common.glsl:75-77).

    px/py are float32 pixel coordinates; frame as `affine` takes it.  The
    float->uint conversion truncates after max(p, 0)."""
    ux = torch.clamp_min(px, 0.0).to(torch.int64) ^ _frame_bits(frame)
    uy = torch.clamp_min(py, 0.0).to(torch.int64) ^ _frame_bits(frame, 1663)
    return hash2(ux, uy).to(torch.float32) / 4294967296.0


def eps_for_dist(d):
    """Distance-scaled epsilon (reference: shaders/rt/rt_common.glsl:88-90)."""
    return torch.clamp_min(1e-3 * d, 1e-4)


def _halton_steps(b: int) -> int:
    """Digits of the largest int32 in base b: the device form's fixed
    number of steps (the JAX package takes 31 for every base; the steps
    past the last digit change nothing)."""
    k = 1
    while b ** k <= 0x7FFFFFFF:
        k += 1
    return k


def halton(i, b: int):
    """i-th sample of the 1D Halton sequence in base b, in float32 steps
    exactly as the device-side JAX variant computes it
    (reference: shaders/rt/rt_common.glsl:106-119).  A host int gives a
    host float.  A 0-d int32 tensor gives a 0-d float32 tensor on its
    device, computed as JAX's device form (sampling.py:69-82 of the JAX
    package): a fixed number of float32 steps under `where`, with a tensor
    divisor (a division by a host scalar may multiply by its reciprocal)."""
    if isinstance(i, torch.Tensor):
        dev = i.device
        base = torch.full((), float(b), device=dev)
        n = i.to(torch.int32)
        f = torch.ones((), device=dev)
        r = torch.zeros((), device=dev)
        for _ in range(_halton_steps(b)):
            active = n > 0
            f_next = f / base
            r = torch.where(active, r + f_next * (n % b).to(torch.float32),
                            r)
            f = torch.where(active, f_next, f)
            n = torch.where(active, n // b, n)
        return r
    f = np.float32(1.0)
    r = np.float32(0.0)
    n = int(i)
    while n > 0:
        f = np.float32(f / np.float32(b))
        r = np.float32(r + f * np.float32(n % b))
        n //= b
    return float(r)


def ld2(i):
    """2D low-discrepancy point: (halton(i+1,2), halton(i+1,3))
    (reference: shaders/rt/rt_common.glsl:127-129).  `i` a host int (the
    record's, `record_words`: two floats), or a frame as `affine` takes it
    (two 0-d tensors)."""
    # i + 1 in int32, as in JAX: frame 2^31 - 1 wraps to a negative index
    if isinstance(i, int):
        j = ((i + 1 + (1 << 31)) & _M32) - (1 << 31)
    else:
        j = frame_value(i) + 1
    return halton(j, 2), halton(j, 3)


def host_jitter_halton(index: int, base: int) -> float:
    """The host jitter generator's halton variant, which halves `f` each
    iteration whatever the base (reference: src/app/application.cpp:28-38)."""
    f, r = 1.0, 0.0
    n = int(index)
    while n > 0:
        f *= 0.5
        r += f * float(n % base)
        n //= base
    return r


def generate_jitter2d(frame_index: int) -> np.ndarray:
    """2D jitter in [-0.5,0.5]^2, sequence masked to 1024 entries
    (reference: src/app/application.cpp:41-47)."""
    idx = int(frame_index) & 1023
    return np.array([host_jitter_halton(idx + 1, 2) - 0.5,
                     host_jitter_halton(idx + 1, 3) - 0.5], np.float32)


def concentric_sample(ux, uy):
    """Concentric map [0,1]^2 -> unit disk
    (reference: shaders/rt/rt_common.glsl:144-159)."""
    a = 2.0 * ux - 1.0
    b = 2.0 * uy - 1.0
    a_dom = a.abs() > b.abs()
    safe_a = torch.where(a.abs() > 1e-20, a, 1.0)
    safe_b = torch.where(b.abs() > 1e-20, b, 1.0)
    r = torch.where(a_dom, a, b)
    phi = torch.where(a_dom,
                      (PI / 4.0) * (b / safe_a),
                      (PI / 2.0) - (PI / 4.0) * (a / safe_b))
    zero = (a == 0.0) & (b == 0.0)
    r = torch.where(zero, 0.0, r)
    phi = torch.where(zero, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def build_onb(n):
    """Orthonormal basis (T, B) around normal n [..., 3]
    (reference: shaders/rt/rt_lighting.glsl:227-231)."""
    up_is_y = n[..., 1].abs() < 0.99
    up = torch.where(up_is_y[..., None], const3((0.0, 1.0, 0.0), n.device),
                     const3((1.0, 0.0, 0.0), n.device))
    t = normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def sample_hemisphere_cosine(n, ux, uy):
    """Cosine-weighted hemisphere sample around n
    (reference: shaders/rt/rt_lighting.glsl:251-266).  The JAX
    version's `v / max(norm(v), 1e-12)` is the port's `normalize`."""
    phi = 2.0 * PI * ux
    r = torch.sqrt(uy)
    x = r * torch.cos(phi)
    z = r * torch.sin(phi)
    y = torch.sqrt(torch.clamp_min(1.0 - uy, 0.0))
    nn = normalize(n)
    t, b = build_onb(nn)
    d = x[..., None] * t + z[..., None] * b + y[..., None] * nn
    return normalize(d)


def cp_offset(px, py, frame: Frame):
    """Per-pixel rotation offset for disk-light sampling
    (reference: shaders/rt/rt_lighting.glsl:280-289)."""
    hx = rand(px, py, _frame_bits(frame, 911))
    hy = rand(py, px, _frame_bits(frame, 577))
    lx, ly = ld2(frame)
    # jnp.mod is a floor mod: torch.remainder, not torch.fmod
    return torch.remainder(hx + lx, 1.0), torch.remainder(hy + ly, 1.0)


def ndc_from_world(p, vp):
    """Project world positions [...,3] by VP [4,4] -> NDC xy [...,2].

    The JAX version asks for precision=HIGHEST: motion vectors are
    differences of two projections compared against 1e-5 thresholds.
    Here each row of VP is applied in full float32 by elementwise ops, x,
    y, z then the translation, and not by a matmul: on the card the GEMM's
    algorithm, and so its rounding, follows the grid's shape, and a row
    band of the image (parallel/) must get the whole image's motion bit
    for bit."""
    def row(k):
        m = vp[k]
        return p[..., 0] * m[0] + p[..., 1] * m[1] + p[..., 2] * m[2] + m[3]
    w = torch.clamp_min(row(3), 1e-6)
    return torch.stack([row(0) / w, row(1) / w], dim=-1)
