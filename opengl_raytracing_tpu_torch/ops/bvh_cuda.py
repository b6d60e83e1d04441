"""Wrappers of the CUDA BVH kernels in csrc/bvh_trace.cu.

  * `trace_closest` -- the closest hit of given rays (the primary call);
  * `trace_bounce` -- GI's bounce ray of each pixel, sampled in the kernel,
    and its closest hit (lighting.gi_bounce_plain);
  * `ambient_occlusion` -- compute_ao's BVH branch whole: the hemisphere
    samples, their any-hit walks and the AO value
    (lighting.ambient_occlusion_plain).

The first two replace the TPU kernel
`opengl_raytracing_tpu/ops/bvh_mxu.py:_closest_kernel`, the third
`bvh_mxu.py:_shadow_kernel` on its AO call.  Each takes a `BVHArrays` of
tensors and its inputs on one device:

  * CPU tensors run the plain version (bvh_traverse.trace_bvh and the two
    plain functions of ops/lighting.py);
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.

The kernels read the hit rows and the pixel-centre grids in place and
write finished results: each call is one launch.  `trace_bounce` takes a
frame's samples in that launch too: a leading sample axis with a sampled
seed (`sampling.FrameValue.sampled`), its rays sampled per lane.  Launches go through
ops/cuda_lib.py, which counts them (`LAUNCHES["closest"]`,
`LAUNCHES["bounce"]`, `LAUNCHES["ao"]`).  Importing this module needs
neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import EPS, PI
from ..params import f32
from ..sampling import Frame, samples_of
from ..scene.bvh import BVHArrays
from . import cuda_lib
from .bvh_traverse import trace_bvh
from .cuda_lib import LAUNCHES, check  # noqa: F401  (LAUNCHES re-exported)
from .scene_analytic import Hit

_Affine = cuda_lib.FrameAffine


class _BounceArgs(ctypes.Structure):
    """Host mirror of `BounceArgs` in csrc/bvh_trace.cu."""
    _fields_ = [("p", ctypes.c_void_p), ("n", ctypes.c_void_p),
                ("grid", cuda_lib.PixelGrid), ("frame", ctypes.c_void_p),
                ("rng", _Affine), ("seed", _Affine),
                ("two_pi", ctypes.c_float), ("eps", ctypes.c_float),
                ("shared", ctypes.c_int)]


class _AoArgs(ctypes.Structure):
    """Host mirror of `AoArgs` in csrc/bvh_trace.cu."""
    _fields_ = [("p", ctypes.c_void_p), ("n", ctypes.c_void_p),
                ("grid", cuda_lib.PixelGrid), ("frame", ctypes.c_void_p),
                ("prm", ctypes.c_void_p), ("fi", _Affine),
                ("samples", ctypes.c_int), ("two_pi", ctypes.c_float)]


_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
_TREE = [_P, _P, _P, _I32]
_SIGNATURES = {
    "ort_trace_closest": (_TREE + [_P, _I64, _P, _P, _I64, _F32]
                          + [_P] * 4, ctypes.c_int),
    "ort_trace_bounce": (_TREE + [ctypes.POINTER(_BounceArgs), _P, _I64, _F32]
                         + [_P] * 6, ctypes.c_int),
    "ort_ambient_occlusion": (_TREE + [ctypes.POINTER(_AoArgs), _P, _I64,
                                       _F32, _P, _P], ctypes.c_int),
    "ort_bounce_args_size": ([], ctypes.c_int),
    "ort_ao_args_size": ([], ctypes.c_int),
}


def _library():
    lib = cuda_lib.library("bvh_trace", _SIGNATURES)
    if (lib.ort_bounce_args_size() != ctypes.sizeof(_BounceArgs)
            or lib.ort_ao_args_size() != ctypes.sizeof(_AoArgs)):
        raise RuntimeError("BounceArgs or AoArgs layout differs between "
                           "csrc/bvh_trace.cu and ops/bvh_cuda.py")
    return lib


def check_bvh(bvh: BVHArrays, device):
    # node and triangle rows are read as 16-byte vectors (and the node
    # rows copied in bulk, which needs 16-byte alignment too)
    n_nodes, n_tris = bvh.bounds.shape[0], bvh.tris.shape[0]
    check("bvh.bounds", bvh.bounds, torch.float32, (n_nodes, 8), device, 16)
    check("bvh.meta", bvh.meta, torch.int32, (n_nodes, 4), device, 16)
    check("bvh.tris", bvh.tris, torch.float32, (n_tris, 12), device, 16)


def _tree(bvh: BVHArrays):
    return (bvh.bounds.data_ptr(), bvh.meta.data_ptr(), bvh.tris.data_ptr(),
            bvh.bounds.shape[0])


def _cuda_device(x):
    return cuda_lib.cuda_device(x, "BVH kernels")


def bounce_args(rng_frame: Frame, seed: Frame, device=None):
    """(the bounce kernel's constants for one call, the frame record they
    point to; the hit and grid pointers left null): the record and
    `rng_frame` and `seed` as (a, b) of its index (`cuda_lib.frame_args`:
    the kernel derives the RNG keys and the offsets float32(seed * 19) and
    float32(seed * 41) from them), float32(2 PI) and the origin's EPS,
    each rounded as the plain version rounds it.  The same bytes for every
    frame of one configuration; `device` as `cuda_lib.frame_args` takes
    it."""
    record, (rng, sd), _ = cuda_lib.frame_args(device, rng_frame, seed)
    return _BounceArgs(frame=record.data_ptr(), rng=rng, seed=sd,
                       two_pi=f32(2.0 * PI), eps=EPS), record


def ao_args(params, frame_index: Frame, device=None):
    """(the AO kernel's constants for one call, the frame record they
    point to; the hit and grid pointers left null): the record,
    `frame_index` as (a, b) of its index, `ao_samples` and a pointer to
    the parameter block, whose ao_bias, ao_radius, ao_min and ao_span the
    kernel reads (the float32 words lighting.ambient_occlusion_plain
    reads).  The same bytes for every frame and every value of the data
    parameters of one configuration."""
    record, (fi,), samples = cuda_lib.frame_args(device, frame_index)
    if samples > 1:
        raise ValueError("AO takes the frame index, not a sampled seed: it "
                         "is computed once for all samples")
    return _AoArgs(frame=record.data_ptr(),
                   prm=cuda_lib.param_block_ptr(params, device), fi=fi,
                   samples=int(params.ao_samples),
                   two_pi=f32(2.0 * PI)), record


def _hit_out(shape, device):
    n = shape.numel()
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty((n, 3), dtype=torch.float32, device=device),
            torch.empty((n, 3), dtype=torch.float32, device=device))


def _hit(shape, t, p, n) -> Hit:
    return Hit(t.reshape(shape), p.reshape(shape + (3,)),
               n.reshape(shape + (3,)),
               torch.ones(shape, dtype=torch.int32, device=t.device))


def _hit_rows(h, device):
    """The p and n rows [N, 3] of hits `h` that the sampling kernels read."""
    shape = h.t.shape
    p, n = cuda_lib.rows(h.p, shape), cuda_lib.rows(h.n, shape)
    check("h.p", p, torch.float32, (shape.numel(), 3), device)
    check("h.n", n, torch.float32, (shape.numel(), 3), device)
    return p, n


def trace_closest(bvh: BVHArrays, ro, rd, eps: float = EPS,
                  active=None) -> Hit:
    """Closest hit of rays ro/rd [...,3] (the contract of
    bvh_traverse.trace_bvh: t = 1e30 on a miss, p = ro + rd*t, unit
    normal on hit lanes and zero elsewhere, mat = 1).  Lanes where
    `active` (bool, the rays' shape) is False do not walk and read as
    misses.  A broadcast origin (one row for every ray) is read in place."""
    if ro.device.type == "cpu":
        return trace_bvh(bvh, ro, rd, eps, active)
    device = _cuda_device(ro)
    shape = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    n_rays = shape.numel()
    o = ro.expand(shape + (3,)).reshape(-1, 3)
    ro_step = 0 if o.stride() == (0, 1) else 3
    if ro_step:
        o = o.contiguous()
    check("ro", o[:1] if ro_step == 0 else o, torch.float32,
          (1 if ro_step == 0 else n_rays, 3), device)
    d = cuda_lib.rows(rd, shape)
    check("rd", d, torch.float32, (n_rays, 3), device)
    check_bvh(bvh, device)
    act, _keep = cuda_lib.mask_bytes(active, shape, device)
    t, p, n = _hit_out(shape, device)
    cuda_lib.launch(_library().ort_trace_closest, "closest", device,
                    *_tree(bvh), o.data_ptr(), ro_step, d.data_ptr(), act,
                    n_rays, eps, t.data_ptr(), p.data_ptr(), n.data_ptr())
    return _hit(shape, t, p, n)


def trace_bounce(bvh: BVHArrays, h0: Hit, rng_frame: Frame, seed: Frame,
                 px, py, active=None):
    """GI's bounce ray at each hit of `h0` and its closest hit: (Hit, wi,
    cos_theta), the contract of lighting.gi_bounce_plain.  The ray is
    sample_hemisphere_cosine around normalize(h0.n) from the rand pair at
    offsets seed*19 and seed*41 of pixel (px, py), from h0.p + n0*EPS.

    A sampled `seed` (`FrameValue.sampled`: a leading sample axis over
    which px and py are broadcast) is one launch over every sample's
    lanes, lane i sampling its ray from the seed of sample i // (pixels a
    sample).  Where the hit and `active` are broadcast over that axis (the
    frame's shared primary hit) the kernel reads their rows once a pixel,
    in place.

    Lanes where `active` (bool, h0.t's shape) is False trace nothing and
    read as misses (t = 1e30, valid False).  There wi and cos_theta are
    finite and otherwise unspecified (the kernel writes zeros, the plain
    version its own values), and so are p and n on the CPU; the kernel
    leaves p and n unwritten."""
    if h0.t.device.type == "cpu":
        from .lighting import gi_bounce_plain
        return gi_bounce_plain(bvh, h0, rng_frame, seed, px, py, active)
    device = _cuda_device(h0.t)
    shape = h0.t.shape
    args, _keep_record = bounce_args(rng_frame, seed, device)
    samples = max(samples_of(rng_frame), samples_of(seed))
    grid, _keep_grid = cuda_lib.pixel_grid(px, py, shape, device, samples)
    p0 = cuda_lib.sample_rows(h0.p, shape, samples)
    n0 = cuda_lib.sample_rows(h0.n, shape, samples)
    act_b = None if active is None else active.expand(shape)
    if (p0 is not None and n0 is not None
            and (act_b is None or act_b.stride(0) == 0)):
        # one row a pixel, read by every sample
        args.shared = 1
        rows_shape = shape[1:]
        act, _keep_act = cuda_lib.mask_bytes(
            None if act_b is None else act_b[0], rows_shape, device)
    else:
        rows_shape = shape
        p0, n0 = cuda_lib.rows(h0.p, shape), cuda_lib.rows(h0.n, shape)
        act, _keep_act = cuda_lib.mask_bytes(active, shape, device)
    for name, x in (("h.p", p0), ("h.n", n0)):
        check(name, x, torch.float32, (rows_shape.numel(), 3), device)
    check_bvh(bvh, device)
    args.p, args.n, args.grid = p0.data_ptr(), n0.data_ptr(), grid
    t, p, n = _hit_out(shape, device)
    wi = torch.empty((shape.numel(), 3), dtype=torch.float32, device=device)
    cos = torch.empty(shape.numel(), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_trace_bounce, "bounce", device,
                    *_tree(bvh), ctypes.byref(args), act, shape.numel(), EPS,
                    t.data_ptr(), p.data_ptr(), n.data_ptr(), wi.data_ptr(),
                    cos.data_ptr())
    return _hit(shape, t, p, n), wi.reshape(shape + (3,)), cos.reshape(shape)


def ambient_occlusion(bvh: BVHArrays, h: Hit, frame_index: Frame, px, py,
                      params, active=None):
    """Cosine-hemisphere ambient occlusion at hits `h` (the contract of
    lighting.ambient_occlusion_plain; `params` a RenderParams or a
    FrameParams on h's device): params.ao_samples any-hit walks in
    [EPS, ao_radius] from h.p + normalize(h.n)*ao_bias, remapped to
    [ao_min, 1].  Lanes where `active` (bool, h.t's shape) is False trace
    nothing; their values are unspecified (the kernel leaves them
    unwritten)."""
    if h.t.device.type == "cpu":
        from .lighting import ambient_occlusion_plain
        return ambient_occlusion_plain(bvh, h, frame_index, px, py, params,
                                       active)
    device = _cuda_device(h.t)
    if int(params.ao_samples) < 1:
        raise ValueError(f"ao_samples must be >= 1, got {params.ao_samples}")
    shape = h.t.shape
    p, n = _hit_rows(h, device)
    grid, _keep_grid = cuda_lib.pixel_grid(px, py, shape, device)
    act, _keep_act = cuda_lib.mask_bytes(active, shape, device)
    check_bvh(bvh, device)
    args, _keep_record = ao_args(params, frame_index, device)
    args.p, args.n, args.grid = p.data_ptr(), n.data_ptr(), grid
    ao = torch.empty(shape.numel(), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_ambient_occlusion, "ao", device,
                    *_tree(bvh), ctypes.byref(args), act, shape.numel(), EPS,
                    ao.data_ptr())
    return ao.reshape(shape)
