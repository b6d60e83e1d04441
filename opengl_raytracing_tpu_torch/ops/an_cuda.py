"""Wrappers of the CUDA direct-light kernels in csrc/an_direct.cu.

`direct_light` (the analytic scene's whole direct-light tree; replaces
the TPU kernel `opengl_raytracing_tpu/ops/an_pallas.py:_kernel`) and
`shade_bvh_brdf` (the BRDF tail of the BVH scene's direct light; replaces
`an_pallas.py:_kernel_bvh`) take the arguments of their plain versions
in ops/lighting.py:

  * CPU tensors run the plain version (`direct_light_plain`,
    `shade_bvh_brdf_plain`);
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.

The kernels read per-pixel rows ([N,3] p, n, v, ...), the unit-disk
offsets as [8, N] planes and the scene constants by value (`_AnScene`,
the mirror of the C struct `AnScene`).  They are built and launched
through ops/cuda_lib.py (`LAUNCHES["an_direct"]`, `LAUNCHES["bvh_brdf"]`).
Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import (EPS, FLOOR_NORMAL, FLOOR_D, SPHERE_LEFT_CENTER,
                         SPHERE_LEFT_RADIUS, GLASS_CENTER, GLASS_RADIUS,
                         MIRROR_CENTER, MIRROR_RADIUS,
                         POINT_LIGHT_MARKER_RADIUS, LIGHT_CENTER,
                         LIGHT_RADIUS, LIGHT_COLOR, SOFT_SHADOW_SAMPLES,
                         BVH_ALBEDO, BVH_SPEC_STRENGTH, BVH_GLOSS)
from . import cuda_lib
from . import lighting as lt
from .cuda_lib import check
from .materials import get_material
from .vecmath import normalize, reflect

_F3 = ctypes.c_float * 3


class _AnScene(ctypes.Structure):
    """Host mirror of `AnScene` in csrc/an_direct.cu (all 4-byte fields,
    no padding)."""
    _fields_ = [
        ("light_c", _F3), ("light_t", _F3), ("light_b", _F3),
        ("light_nneg", _F3), ("light_color", _F3),
        ("light_radius", ctypes.c_float),
        ("floor_n", _F3), ("floor_d", ctypes.c_float),
        ("sphere_c", _F3 * 3), ("sphere_r2", _F3),
        ("marker_r2", ctypes.c_float),
        ("point", _F3), ("sun_l", _F3), ("sky_up", _F3),
        ("sun_li", _F3), ("sky_li", _F3),
        ("point_color", _F3), ("point_intensity", ctypes.c_float),
        ("bvh_albedo", _F3), ("bvh_spec", ctypes.c_float),
        ("bvh_gloss", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("sun_e", ctypes.c_int), ("sky_e", ctypes.c_int),
        ("point_e", ctypes.c_int),
    ]


_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "ort_an_direct": ([ctypes.POINTER(_AnScene)] + [_P] * 9 + [_I64, _P, _P],
                      ctypes.c_int),
    "ort_bvh_brdf": ([ctypes.POINTER(_AnScene)] + [_P] * 5 + [_I64, _P, _P],
                     ctypes.c_int),
    "ort_an_scene_size": ([], ctypes.c_int),
}


def _library():
    lib = cuda_lib.library("an_direct", _SIGNATURES)
    if lib.ort_an_scene_size() != ctypes.sizeof(_AnScene):
        raise RuntimeError("AnScene layout differs between csrc/an_direct.cu "
                           "and ops/an_cuda.py")
    return lib


def _f32(x) -> float:
    return float(np.float32(x))


def _scene_args(scene) -> _AnScene:
    """The kernels' scene constants, each rounded to float32 as the plain
    version rounds it (products of two host floats are taken in float32,
    like a float32 tensor times a Python float; squared radii in double
    first, like `dot(oc, oc) - radius * radius`)."""
    p = scene.params
    hv = scene.host_vectors

    def li(color, intensity):
        return _F3(*(torch.tensor(color, dtype=torch.float32)
                     * intensity).tolist())

    def v3(x):
        return _F3(*(_f32(c) for c in x))

    return _AnScene(
        light_c=v3(LIGHT_CENTER), light_t=v3(lt.LIGHT_T),
        light_b=v3(lt.LIGHT_B), light_nneg=v3(-lt.LIGHT_N),
        light_color=v3(LIGHT_COLOR), light_radius=_f32(LIGHT_RADIUS),
        floor_n=v3(FLOOR_NORMAL), floor_d=_f32(FLOOR_D),
        sphere_c=(_F3 * 3)(v3(SPHERE_LEFT_CENTER), v3(GLASS_CENTER),
                           v3(MIRROR_CENTER)),
        sphere_r2=_F3(_f32(SPHERE_LEFT_RADIUS * SPHERE_LEFT_RADIUS),
                      _f32(GLASS_RADIUS * GLASS_RADIUS),
                      _f32(MIRROR_RADIUS * MIRROR_RADIUS)),
        marker_r2=_f32(POINT_LIGHT_MARKER_RADIUS * POINT_LIGHT_MARKER_RADIUS),
        point=v3(hv["point_light_pos"]),
        sun_l=v3(-np.float32(hv["sun_dir"])), sky_up=v3(hv["sky_up"]),
        sun_li=li(p.sun_color, p.sun_intensity),
        sky_li=li(p.sky_color, p.sky_intensity),
        point_color=v3(p.point_light_color),
        point_intensity=_f32(p.point_light_intensity),
        bvh_albedo=v3(BVH_ALBEDO), bvh_spec=_f32(BVH_SPEC_STRENGTH),
        bvh_gloss=_f32(BVH_GLOSS), eps=_f32(EPS),
        sun_e=int(bool(p.sun_enabled)), sky_e=int(bool(p.sky_enabled)),
        point_e=int(bool(p.point_light_enabled)))


def _rows(x, shape):
    """[..., 3] broadcast to shape + (3,) -> contiguous [N, 3]."""
    return x.expand(shape + (3,)).reshape(-1, 3).contiguous()


def _flat(x, shape):
    return x.expand(shape).reshape(-1).contiguous()


def _offset_planes(offs, shape):
    """[(dx, dy)] * S -> contiguous [2S, N] planes dx0, dy0, dx1, ..."""
    return torch.stack([_flat(c, shape) for dxy in offs for c in dxy])


def direct_light(scene, h, rng_frame: int, frame_index: int, vdir, px, py):
    """Direct light of the analytic scene at hits `h` [...] (the contract
    of lighting.direct_light_plain): rgb [..., 3]."""
    if h.t.device.type == "cpu":
        return lt.direct_light_plain(scene, h, rng_frame, frame_index, vdir,
                                     px, py)
    device = cuda_lib.cuda_device(h.t, "direct-light kernels")
    shape = h.t.shape
    n_px = h.t.numel()
    n = normalize(h.n)
    v = normalize(vdir)
    mat = get_material(h.mat, scene.params)
    sky_r = scene.sky(reflect(-v, n))
    offs = _offset_planes(
        lt._disk_offsets(rng_frame, frame_index, px, py), shape)
    args = dict(p=_rows(h.p, shape), n=_rows(n, shape), v=_rows(v, shape),
                albedo=_rows(mat.albedo, shape),
                spec=_flat(mat.spec_strength, shape),
                gloss=_flat(mat.gloss, shape), mtype=_flat(mat.mtype, shape),
                sky_r=_rows(sky_r, shape))
    for name in ("p", "n", "v", "albedo", "sky_r"):
        check(name, args[name], torch.float32, (n_px, 3), device)
    check("spec", args["spec"], torch.float32, (n_px,), device)
    check("gloss", args["gloss"], torch.float32, (n_px,), device)
    check("mtype", args["mtype"], torch.int32, (n_px,), device)
    check("offs", offs, torch.float32, (2 * SOFT_SHADOW_SAMPLES, n_px),
          device)
    out = torch.empty((n_px, 3), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_an_direct, "an_direct", device,
                    ctypes.byref(_scene_args(scene)),
                    *(a.data_ptr() for a in args.values()), offs.data_ptr(),
                    n_px, out.data_ptr())
    return out.reshape(shape + (3,))


def shade_bvh_brdf(scene, h, n, v, offs, occ):
    """The BRDF tail of lighting.direct_light_bvh (the contract of
    lighting.shade_bvh_brdf_plain): rgb [..., 3].  `occ` is the any-hit
    result [k, ...] as trace_any returns it; on the card its bytes are
    read in place."""
    if h.t.device.type == "cpu":
        return lt.shade_bvh_brdf_plain(scene, h, n, v, offs, occ)
    device = cuda_lib.cuda_device(h.t, "direct-light kernels")
    params = scene.params
    shape = h.t.shape
    n_px = h.t.numel()
    k = (SOFT_SHADOW_SAMPLES + int(bool(params.sun_enabled))
         + int(bool(params.point_light_enabled)))
    if occ.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"occ has dtype {occ.dtype}, expected bool or uint8")
    check("occ", occ, occ.dtype, (k,) + tuple(shape), device, align=1)
    occ_b = occ.view(k, n_px)
    p, n, v = _rows(h.p, shape), _rows(n, shape), _rows(v, shape)
    for name, x in (("p", p), ("n", n), ("v", v)):
        check(name, x, torch.float32, (n_px, 3), device)
    planes = _offset_planes(offs, shape)
    check("offs", planes, torch.float32, (2 * SOFT_SHADOW_SAMPLES, n_px),
          device)
    out = torch.empty((n_px, 3), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_bvh_brdf, "bvh_brdf", device,
                    ctypes.byref(_scene_args(scene)), p.data_ptr(),
                    n.data_ptr(), v.data_ptr(), planes.data_ptr(),
                    occ_b.data_ptr(), n_px, out.data_ptr())
    return out.reshape(shape + (3,))
