"""Wrappers of both scenes' shading-tail kernels in csrc/hit_mix.cu.

  * `bvh_hit_mix` -- the BVH scene's shading after its direct light: GI's
    tail with the sky of the bounce's misses, the GI sum and the AO
    product (lighting.bvh_hit_mix_plain);
  * `an_hit_mix` -- the analytic scene's after its direct light and GI's
    bounce: GI's tail, the GI sum and the AO product on the diffuse
    lanes, the point-light marker's emissive on its lanes
    (lighting.an_hit_mix_plain).

They replace no TPU kernel: in the JAX package this work is jnp code
behind its hit gates (`pipeline.py:shade_bvh_auto`, `shade_analytic_
auto`), which compact the tiles that hold a primary hit under a dense
fallback.  Each call takes `active`, a bool mask of the lanes whose
radiance the caller keeps (the primary hits; None: every lane), and the
frame's radiance, which it updates in place and returns:

  * CPU tensors run the plain version, which computes every lane, and
    write its result on the lanes the kernel writes;
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.  The kernel writes the live
    lanes alone (`an_hit_mix`: those of them that are diffuse or the
    marker; the mirror's and glass's are their mix kernels'), and leaves
    the others as they were (ROADMAP C, "Inactive lanes").

Inputs are read in place as in ops/an_trace_cuda.py (`lane_input`: the
hit, the mask and AO a row a pixel under a sample batch's leading axis,
the camera's position one row); the outputs of the calls before (the
bounce's hit, direction, cosine, light and sky) a row a lane.  The
scene's constants and the pointer to the parameter block go in K3's
`AnScene` (`an_cuda.scene_struct`): the same bytes for every frame and
every value of the data parameters, so a captured CUDA graph replays the
calls.  Launches go through ops/cuda_lib.py (`LAUNCHES["bvh_hit_mix"]`,
`["an_hit_mix"]`).  Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import GI_MAX_LUM, GI_MIN_COS_THETA, YCOEFF
from ..params import f32
from . import an_cuda, cuda_lib
from . import lighting as lt
from .an_shade_cuda import INV_PI, _lanes, _write
from .an_trace_cuda import _LaneIn, _mask, lane_input, n_px_of
from .cuda_lib import check
from .scene_analytic import Hit

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# gi_tail_bvh's clamp_min of the luminance
LUM_FLOOR = 1e-6


class _HitMixConsts(ctypes.Structure):
    """Host mirror of `HitMixConsts` in csrc/hit_mix.cu."""
    _fields_ = [("inv_pi", _F32), ("max_lum", _F32), ("lum_floor", _F32),
                ("min_cos", _F32), ("ycoeff", _F32 * 3)]


class _BvhHitMixArgs(ctypes.Structure):
    """Host mirror of `BvhHitMixArgs` in csrc/hit_mix.cu."""
    _fields_ = [("active", _LaneIn), ("ao", _LaneIn), ("c", _HitMixConsts),
                ("n_lanes", _I64), ("n_px", _I64), ("gi", _I32),
                ("gi_t", _P), ("gi_wi", _P), ("gi_cos", _P), ("gi_lit", _P),
                ("out", _P), ("texels", _P)]


class _AnHitMixArgs(ctypes.Structure):
    """Host mirror of `AnHitMixArgs` in csrc/hit_mix.cu."""
    _fields_ = [("p", _LaneIn), ("mat", _LaneIn), ("cam", _LaneIn),
                ("active", _LaneIn), ("ao", _LaneIn), ("c", _HitMixConsts),
                ("n_lanes", _I64), ("n_px", _I64), ("gi", _I32),
                ("gi_t", _P), ("gi_cos", _P), ("gi_lit", _P), ("gi_sky", _P),
                ("out", _P)]


_SCENE = ctypes.POINTER(an_cuda._AnScene)
_SIGNATURES = {
    "ort_bvh_hit_mix": ([_SCENE, ctypes.POINTER(_BvhHitMixArgs), _P], _I32),
    "ort_an_hit_mix": ([_SCENE, ctypes.POINTER(_AnHitMixArgs), _P], _I32),
    "ort_hit_mix_sizes": ([ctypes.POINTER(_I32), _I32], _I32),
}
_LAYOUTS = (an_cuda._AnScene, _LaneIn, _HitMixConsts, _BvhHitMixArgs,
            _AnHitMixArgs)


def _library():
    lib = cuda_lib.library("hit_mix", _SIGNATURES)
    sizes = (_I32 * len(_LAYOUTS))()
    n = lib.ort_hit_mix_sizes(sizes, len(_LAYOUTS))
    want = [ctypes.sizeof(s) for s in _LAYOUTS]
    if n != len(_LAYOUTS) or list(sizes) != want:
        raise RuntimeError(f"the argument structs' layout differs between "
                           f"csrc/hit_mix.cu ({list(sizes)[:n]}) and "
                           f"ops/hit_mix_cuda.py ({want})")
    return lib


def mix_consts() -> _HitMixConsts:
    """The kernels' constants: each Python scalar rounded to float32 as
    PyTorch rounds it, and the reciprocal of PI as PyTorch's CUDA division
    by a host scalar takes it (float32(1) / float32(PI)).  The same bytes
    for every call."""
    return _HitMixConsts(inv_pi=INV_PI, max_lum=f32(GI_MAX_LUM),
                         lum_floor=f32(LUM_FLOOR),
                         min_cos=f32(GI_MIN_COS_THETA),
                         ycoeff=(_F32 * 3)(*(f32(c) for c in YCOEFF)))


def _radiance(radiance, device):
    """The frame's radiance the kernel updates: contiguous float32 [..., 3]
    on `device`; (its lanes' shape, their count)."""
    shape = radiance.shape[:-1]
    check("radiance", radiance, torch.float32, tuple(shape) + (3,), device)
    return shape, shape.numel()


def _ao(ao, shape, device):
    """`lane_input` of AO (a float a lane or a pixel), or a null one."""
    if ao is None:
        return _LaneIn(None, 0), None
    return lane_input(ao, shape, 0, torch.float32, device, "ao")


def bvh_hit_mix(scene, radiance, gi: lt.GiLightBvh = None, ao=None,
                active=None):
    """The BVH scene's radiance after its direct light `radiance`: with GI
    (`gi`, lighting.gi_light_bvh's) its tail times gi_scale_bvh added,
    with AO (`ao`, a value a lane, or a pixel of a sample batch) times it
    (the contract of lighting.bvh_hit_mix_plain), written into `radiance`
    on the lanes of `active` (bool, radiance's shape but the last axis;
    None: every lane), which is returned; its other lanes keep their
    values."""
    if radiance.device.type == "cpu":
        return _write(radiance, lt.bvh_hit_mix_plain(scene, radiance, gi,
                                                     ao), active)
    device = cuda_lib.cuda_device(radiance, "hit-mix kernels")
    params = scene.params
    shape, n = _radiance(radiance, device)
    args = _BvhHitMixArgs(c=mix_consts(), n_lanes=n, n_px=n_px_of(shape),
                          gi=int(gi is not None), out=radiance.data_ptr())
    args.active, keep_a = _mask(active, shape, device)
    args.ao, keep_ao = _ao(ao, shape, device)
    if gi is not None:
        args.gi_t = _lanes(gi.hit.t, n, 0, torch.float32, device, "gi.t")
        args.gi_wi = _lanes(gi.wi, n, 3, torch.float32, device, "gi.wi")
        args.gi_cos = _lanes(gi.cos_theta, n, 0, torch.float32, device,
                             "gi.cos_theta")
        args.gi_lit = _lanes(gi.lit, n, 3, torch.float32, device, "gi.lit")
    env = an_cuda.env_table(params, scene.env_map, device)
    texels = an_cuda.env_texels(params, scene.env_map, device)
    if texels is not None:
        args.texels = texels.data_ptr()
    cuda_lib.launch(_library().ort_bvh_hit_mix, "bvh_hit_mix", device,
                    ctypes.byref(an_cuda.scene_struct(params, env, device)),
                    ctypes.byref(args))
    return radiance


def an_hit_mix(scene, h: Hit, radiance, gi: lt.GiLight = None, ao=None,
               active=None):
    """The analytic scene's radiance at hits `h` after the direct light
    `radiance`: with GI (`gi`, lighting.gi_light_analytic's) its tail
    times gi_scale_analytic added, with AO times it, and the marker's
    emissive (the contract of lighting.an_hit_mix_plain), written into
    `radiance` on the lanes of `active` whose material is diffuse or the
    marker (`lighting.an_mix_lanes`), which is returned; its other lanes
    keep their values."""
    if radiance.device.type == "cpu":
        lanes = lt.and_lanes(active, lt.an_mix_lanes(h.mat, scene.params))
        return _write(radiance, lt.an_hit_mix_plain(scene, h, radiance, gi,
                                                    ao), lanes)
    device = cuda_lib.cuda_device(radiance, "hit-mix kernels")
    params = scene.params
    shape, n = _radiance(radiance, device)
    args = _AnHitMixArgs(c=mix_consts(), n_lanes=n, n_px=n_px_of(shape),
                         gi=int(gi is not None), out=radiance.data_ptr())
    args.p, keep_p = lane_input(h.p, shape, 3, torch.float32, device, "h.p")
    args.mat, keep_m = lane_input(h.mat, shape, 0, torch.int32, device,
                                  "h.mat")
    args.cam, keep_c = lane_input(scene.cam_pos, shape, 3, torch.float32,
                                  device, "cam_pos")
    args.active, keep_a = _mask(active, shape, device)
    args.ao, keep_ao = _ao(ao, shape, device)
    if gi is not None:
        args.gi_t = _lanes(gi.hit.t, n, 0, torch.float32, device, "gi.t")
        args.gi_cos = _lanes(gi.cos_theta, n, 0, torch.float32, device,
                             "gi.cos_theta")
        args.gi_lit = _lanes(gi.lit, n, 3, torch.float32, device, "gi.lit")
        args.gi_sky = _lanes(gi.sky, n, 3, torch.float32, device, "gi.sky")
    cuda_lib.launch(_library().ort_an_hit_mix, "an_hit_mix", device,
                    ctypes.byref(an_cuda.scene_struct(params, None, device)),
                    ctypes.byref(args))
    return radiance
