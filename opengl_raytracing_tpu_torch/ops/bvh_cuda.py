"""Wrappers of the CUDA BVH kernels in csrc/bvh_trace.cu.

`trace_closest` (closest hit; replaces the TPU kernel
`opengl_raytracing_tpu/ops/bvh_mxu.py:_closest_kernel`) and `trace_any`
(any-hit occlusion; replaces `bvh_mxu.py:_shadow_kernel`) take a
`BVHArrays` of tensors and rays on one device:

  * a CPU tensor runs the plain PyTorch walk (ops/bvh_traverse.py);
  * a CUDA tensor launches the kernel, or the call raises.  Nothing falls
    back to the plain walk on the card.

The kernels are built and launched through ops/cuda_lib.py, which also
holds the launch counters (`LAUNCHES["closest"]`, `LAUNCHES["any"]`).
Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import EPS
from ..scene.bvh import BVHArrays
from . import cuda_lib
from .bvh_traverse import _finalize, trace_bvh, trace_bvh_shadow
from .cuda_lib import LAUNCHES, check  # noqa: F401  (LAUNCHES re-exported)
from .scene_analytic import Hit

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
_SIGNATURES = {
    "ort_trace_closest": ([_P, _P, _P, _I32, _P, _P, _P, _I64, _F32, _P, _P,
                           _P], ctypes.c_int),
    "ort_trace_any": ([_P, _P, _P, _I32, _P, _P, _P, _I64, _F32, _P, _P],
                      ctypes.c_int),
}


def _library():
    return cuda_lib.library("bvh_trace", _SIGNATURES)


def check_bvh(bvh: BVHArrays, device):
    # node and triangle rows are read as 16-byte vectors
    n_nodes, n_tris = bvh.bounds.shape[0], bvh.tris.shape[0]
    check("bvh.bounds", bvh.bounds, torch.float32, (n_nodes, 8), device, 16)
    check("bvh.meta", bvh.meta, torch.int32, (n_nodes, 4), device, 16)
    check("bvh.tris", bvh.tris, torch.float32, (n_tris, 12), device, 16)


def _cuda_device(x):
    return cuda_lib.cuda_device(x, "BVH kernels")


def trace_closest(bvh: BVHArrays, ro, rd, eps: float = EPS,
                  active=None) -> Hit:
    """Closest hit of rays ro/rd [...,3] (the contract of
    bvh_traverse.trace_bvh: t = 1e30 on a miss, unit normal on hit lanes
    and zero elsewhere, mat = 1).  Lanes where `active` (bool, the rays'
    shape) is False do not walk and read as misses."""
    if ro.device.type == "cpu":
        return trace_bvh(bvh, ro, rd, eps, active)
    device = _cuda_device(ro)
    shape = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    o = ro.expand(shape + (3,)).reshape(-1, 3).contiguous()
    d = rd.expand(shape + (3,)).reshape(-1, 3).contiguous()
    check_bvh(bvh, device)
    n_rays = o.shape[0]
    check("ro", o, torch.float32, (n_rays, 3), device)
    check("rd", d, torch.float32, (n_rays, 3), device)
    act_ptr = None
    if active is not None:
        # the kernel reads one 0/1 byte per ray
        act = active.expand(shape).reshape(-1).contiguous()
        check("active", act, torch.bool, (n_rays,), device, align=1)
        act_ptr = act.data_ptr()
    t = torch.empty(n_rays, dtype=torch.float32, device=device)
    n = torch.empty((n_rays, 3), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_trace_closest, "closest", device,
                    bvh.bounds.data_ptr(), bvh.meta.data_ptr(),
                    bvh.tris.data_ptr(), bvh.bounds.shape[0], o.data_ptr(),
                    d.data_ptr(), act_ptr, n_rays, eps, t.data_ptr(),
                    n.data_ptr())
    return _finalize(shape, ro, rd.expand(shape + (3,)), t, n)


def trace_any(bvh: BVHArrays, ro, rd, t_max, eps: float = EPS,
              active=None):
    """Any occluder with t in [eps, t_max]; a window <= 0 finds nothing.

    ro/rd/t_max may be tuples of k batches of one shape: they are
    concatenated into one stream (one kernel launch) and the result is
    [k, ...].  `active` (per-batch shape) is ANDed in, so inactive lanes
    are guaranteed False; without it the result is the kernel's own
    buffer, [k, ...] contiguous bytes."""
    multi = isinstance(ro, (list, tuple))
    if not multi:
        ro, rd, t_max = (ro,), (rd,), (t_max,)
    shape = torch.broadcast_shapes(*(x.shape[:-1] for x in ro),
                                   *(x.shape[:-1] for x in rd),
                                   *(x.shape for x in t_max))
    o = torch.cat([x.expand(shape + (3,)).reshape(-1, 3) for x in ro])
    d = torch.cat([x.expand(shape + (3,)).reshape(-1, 3) for x in rd])
    tm = torch.cat([x.expand(shape).reshape(-1) for x in t_max])
    if o.device.type == "cpu":
        occ = trace_bvh_shadow(bvh, o, d, tm, eps)
    else:
        device = _cuda_device(o)
        check_bvh(bvh, device)
        n_rays = o.shape[0]
        check("ro", o, torch.float32, (n_rays, 3), device)
        check("rd", d, torch.float32, (n_rays, 3), device)
        check("t_max", tm, torch.float32, (n_rays,), device)
        occ_u8 = torch.empty(n_rays, dtype=torch.uint8, device=device)
        cuda_lib.launch(_library().ort_trace_any, "any", device,
                        bvh.bounds.data_ptr(), bvh.meta.data_ptr(),
                        bvh.tris.data_ptr(), bvh.bounds.shape[0],
                        o.data_ptr(), d.data_ptr(), tm.data_ptr(), n_rays,
                        eps, occ_u8.data_ptr())
        # the kernel writes 0/1 bytes: a bool view of them, no copy
        occ = occ_u8.view(torch.bool)
    occ = occ.reshape((len(ro),) + shape)
    if active is not None:
        occ = occ & active
    return occ if multi else occ[0]
