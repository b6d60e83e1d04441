"""Wrappers of the glass and mirror kernels in csrc/an_shade.cu.

  * `glass_rays` -- shade_glass up to its direct light: the setup, the
    three secondaries traced without the glass sphere, their views and the
    skies (lighting.glass_rays_plain);
  * `glass_mix` -- shade_glass after it: the selects, the mixes, the
    albedo and the Fresnel term (lighting.glass_mix_plain);
  * `mirror_ray` -- shade_mirror up to its direct light: the reflected
    ray traced through the whole scene and its sky (lighting.mirror_ray_
    plain);
  * `mirror_mix` -- shade_mirror after it and GI's bounce: GI's tail at
    the reflected hit, the valid select, the albedo (lighting.mirror_mix_
    plain).

They replace no TPU kernel: in the JAX package this work is jnp code
behind its glass and mirror tile gate (`pipeline.py:_tile_gated_shade`),
which compacts the tiles that hold the material under a dense fallback.
Here each call takes `active`, a bool mask of the lanes whose result the
caller reads (None: every lane):

  * CPU tensors run the plain version, which computes every lane;
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.  The kernel computes the live
    lanes alone and leaves the others unwritten: their values are
    unspecified (ROADMAP C, "Inactive lanes"), and so is a sky the rays
    kernel does not look up (the straight ray's where it hit, the bent
    ray's where it hit or does not refract, the mirror's where it hit).

The rays kernels read the cubemap's taps from the table's [6, F, F, 4]
copy (`an_cuda.env_texels`, made once a table), as the sky kernel does.

The mix calls take `out`, the frame's radiance: they write the material's
radiance into it on the live lanes, in place (on the CPU by a select of
the plain result), and return it; without `out` they return a tensor of
their own.  The kernels read the material table by the hit's id, so `mat`
(get_material of it, or None) is read by the plain versions alone.

Inputs are read in place as in ops/an_trace_cuda.py (`lane_input`: a row
a lane, a row a pixel of a sample batch's shared hit, one row for the
camera's position); the outputs of the calls between a rays and a mix
call (K3's radiance, the bounce's hit, the skies) a row a lane.  The
scene's constants and the pointer to the parameter block go in K3's
`AnScene` (`an_cuda.scene_struct`): the same bytes for every frame and
every value of the data parameters, so a captured CUDA graph replays the
calls.  Launches go through ops/cuda_lib.py (`LAUNCHES["glass_rays"]`,
`["glass_mix"]`, `["mirror_ray"]`, `["mirror_mix"]`).  Importing this
module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import (EPS, PI, GLASS_DISTORTION_STRENGTH,
                         GLASS_LOCAL_REFL_WEIGHT)
from ..params import f32
from . import an_cuda, cuda_lib
from . import lighting as lt
from .an_trace_cuda import _LaneIn, _marker, _mask, lane_input, n_px_of
from .cuda_lib import check
from .scene_analytic import Hit

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# shade_glass's clamp_min of the ior
MIN_IOR = 1.0001
# the float32 that PyTorch's CUDA division by the host scalar PI multiplies
# by: float32(1) / float32(PI)
INV_PI = float(np.float32(1.0) / np.float32(PI))


class _ShadeConsts(ctypes.Structure):
    """Host mirror of `ShadeConsts` in csrc/an_shade.cu."""
    _fields_ = [("eps", _F32), ("distortion", _F32), ("local_refl", _F32),
                ("min_ior", _F32), ("inv_pi", _F32), ("marker", _I32)]


class _GlassRaysArgs(ctypes.Structure):
    """Host mirror of `GlassRaysArgs` in csrc/an_shade.cu."""
    _fields_ = [("p", _LaneIn), ("n", _LaneIn), ("wo", _LaneIn),
                ("mat", _LaneIn), ("cam", _LaneIn), ("active", _LaneIn),
                ("c", _ShadeConsts), ("n_lanes", _I64), ("n_px", _I64),
                ("t", _P), ("hp", _P), ("hn", _P), ("hmat", _P),
                ("view", _P), ("sky", _P), ("k", _P), ("cos", _P),
                ("texels", _P)]


class _GlassMixArgs(ctypes.Structure):
    """Host mirror of `GlassMixArgs` in csrc/an_shade.cu."""
    _fields_ = [("mat", _LaneIn), ("active", _LaneIn), ("c", _ShadeConsts),
                ("n_lanes", _I64), ("n_px", _I64), ("t", _P * 3),
                ("sky", _P * 3), ("lit", _P * 3), ("k", _P), ("cos", _P),
                ("out", _P)]


class _MirrorRayArgs(ctypes.Structure):
    """Host mirror of `MirrorRayArgs` in csrc/an_shade.cu."""
    _fields_ = [("p", _LaneIn), ("n", _LaneIn), ("wo", _LaneIn),
                ("active", _LaneIn), ("c", _ShadeConsts), ("n_lanes", _I64),
                ("n_px", _I64), ("t", _P), ("hp", _P), ("hn", _P),
                ("hmat", _P), ("view", _P), ("sky", _P), ("texels", _P)]


class _MirrorMixArgs(ctypes.Structure):
    """Host mirror of `MirrorMixArgs` in csrc/an_shade.cu."""
    _fields_ = [("mat", _LaneIn), ("active", _LaneIn), ("c", _ShadeConsts),
                ("n_lanes", _I64), ("n_px", _I64), ("gi", _I32),
                ("t", _P), ("hmat", _P), ("sky", _P), ("direct", _P),
                ("gi_t", _P), ("gi_cos", _P), ("gi_lit", _P), ("gi_sky", _P),
                ("out", _P)]


_SCENE = ctypes.POINTER(an_cuda._AnScene)
_SIGNATURES = {
    "ort_an_glass_rays": ([_SCENE, ctypes.POINTER(_GlassRaysArgs), _P], _I32),
    "ort_an_glass_mix": ([_SCENE, ctypes.POINTER(_GlassMixArgs), _P], _I32),
    "ort_an_mirror_ray": ([_SCENE, ctypes.POINTER(_MirrorRayArgs), _P], _I32),
    "ort_an_mirror_mix": ([_SCENE, ctypes.POINTER(_MirrorMixArgs), _P], _I32),
    "ort_an_shade_sizes": ([ctypes.POINTER(_I32), _I32], _I32),
}
_LAYOUTS = (an_cuda._AnScene, _LaneIn, _ShadeConsts, _GlassRaysArgs,
            _GlassMixArgs, _MirrorRayArgs, _MirrorMixArgs)


def _library():
    lib = cuda_lib.library("an_shade", _SIGNATURES)
    sizes = (_I32 * len(_LAYOUTS))()
    n = lib.ort_an_shade_sizes(sizes, len(_LAYOUTS))
    want = [ctypes.sizeof(s) for s in _LAYOUTS]
    if n != len(_LAYOUTS) or list(sizes) != want:
        raise RuntimeError(f"the argument structs' layout differs between "
                           f"csrc/an_shade.cu ({list(sizes)[:n]}) and "
                           f"ops/an_shade_cuda.py ({want})")
    return lib


def shade_consts(params) -> _ShadeConsts:
    """The kernels' constants: each Python scalar rounded to float32 as
    PyTorch rounds it, the reciprocal of PI as PyTorch's CUDA division by
    a host scalar takes it (float32(1) / float32(PI)), and whether the
    marker is traced.  The same bytes for every frame and every value of
    the data parameters of one configuration."""
    return _ShadeConsts(eps=f32(EPS),
                        distortion=f32(GLASS_DISTORTION_STRENGTH),
                        local_refl=f32(GLASS_LOCAL_REFL_WEIGHT),
                        min_ior=f32(MIN_IOR), inv_pi=INV_PI,
                        marker=_marker(params, True))


def _empty(shape, dtype, device):
    """An output of a kernel: its dead lanes keep whatever this holds."""
    return torch.empty(shape, dtype=dtype, device=device)


def _hit_inputs(h, wo, shape, device):
    """The kernels' `LaneIn`s of the hit's p, n, the view `wo` and the
    material id, with the tensors they point into."""
    ins, keep = {}, []
    for name, x, width, dtype in (("p", h.p, 3, torch.float32),
                                  ("n", h.n, 3, torch.float32),
                                  ("wo", wo, 3, torch.float32),
                                  ("mat", h.mat, 0, torch.int32)):
        if x is None:
            continue
        ins[name], rows = lane_input(x, shape, width, dtype, device, name)
        keep.append(rows)
    return ins, keep


def _lanes(x, n, width, dtype, device, name):
    """The pointer to `x` read a row a lane ([n] or [n, width]): an output
    of a call between the rays and the mix call, contiguous already."""
    want = (n, width) if width else (n,)
    if x.numel() != n * max(width, 1) or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with {n} lanes, got "
                         f"shape {tuple(x.shape)}")
    check(name, x.view(want), dtype, want, device)
    return x.data_ptr()


def _out(out, shape, device):
    """The radiance the mix kernel writes into: `out` (the frame's, [...,
    3] contiguous float32 of the call's shape) or a tensor of its own."""
    if out is None:
        return _empty(shape + (3,), torch.float32, device)
    check("out", out, torch.float32, tuple(shape) + (3,), device)
    return out


def _write(out, value, active):
    """The plain mix's `value` as the kernel leaves it: into `out` on the
    `active` lanes (all where None), or `value` itself without `out`."""
    if out is None:
        return value
    if active is not None:
        value = torch.where(active[..., None], value, out)
    return out.copy_(value)


def _skies(args, params, env_map, device):
    """(the cubemap table the scene struct points to, its [6, F, F, 4]
    copy, whose taps a rays kernel reads): both None for the gradient sky;
    the copy's pointer set in `args`."""
    env = an_cuda.env_table(params, env_map, device)
    texels = an_cuda.env_texels(params, env_map, device)
    if texels is not None:
        args.texels = texels.data_ptr()
    return env, texels


def _shape(h, wo):
    return torch.broadcast_shapes(h.t.shape, wo.shape[:-1])


def glass_rays(scene, h: Hit, wo, mat=None, active=None) -> lt.GlassRays:
    """Glass at hits `h` viewed along `wo` up to its direct light (the
    contract of lighting.glass_rays_plain).  Lanes where `active` (bool,
    h.t's shape) is False are unspecified; so are the straight sky where
    its ray hit and the bent sky where its ray hit or k <= 0."""
    if h.t.device.type == "cpu":
        return lt.glass_rays_plain(scene, h, wo, mat)
    device = cuda_lib.cuda_device(h.t, "glass and mirror kernels")
    params = scene.params
    shape = _shape(h, wo)
    n = shape.numel()
    args = _GlassRaysArgs(c=shade_consts(params), n_lanes=n,
                          n_px=n_px_of(shape))
    ins, keep = _hit_inputs(h, wo, shape, device)
    for name, x in ins.items():
        setattr(args, name, x)
    args.cam, keep_cam = lane_input(scene.cam_pos, shape, 3, torch.float32,
                                    device, "cam_pos")
    args.active, keep_a = _mask(active, shape, device)
    t = _empty((3, n), torch.float32, device)
    hp = _empty((3, n, 3), torch.float32, device)
    hn = _empty((3, n, 3), torch.float32, device)
    hmat = _empty((3, n), torch.int32, device)
    view = _empty((3, n, 3), torch.float32, device)
    sky = _empty((3, n, 3), torch.float32, device)
    k = _empty(n, torch.float32, device)
    cos = _empty(n, torch.float32, device)
    for name, x in (("t", t), ("hp", hp), ("hn", hn), ("hmat", hmat),
                    ("view", view), ("sky", sky), ("k", k), ("cos", cos)):
        setattr(args, name, x.data_ptr())
    env, texels = _skies(args, params, scene.env_map, device)
    cuda_lib.launch(_library().ort_an_glass_rays, "glass_rays", device,
                    ctypes.byref(an_cuda.scene_struct(params, env, device)),
                    ctypes.byref(args))
    v3 = shape + (3,)
    hits = tuple(Hit(t[j].reshape(shape), hp[j].reshape(v3),
                     hn[j].reshape(v3), hmat[j].reshape(shape))
                 for j in range(3))
    return lt.GlassRays(hits, tuple(view[j].reshape(v3) for j in range(3)),
                        tuple(sky[j].reshape(v3) for j in range(3)),
                        k.reshape(shape), cos.reshape(shape))


def glass_mix(scene, h: Hit, mat, rays: lt.GlassRays, lit, active=None,
              out=None):
    """Glass's radiance from its rays call's `rays` and the direct light
    `lit` at their three hits (the contract of lighting.glass_mix_plain),
    written into `out` on the live lanes (see the module's docstring).
    Lanes where `active` is False are unspecified without `out`, and keep
    `out`'s values with it."""
    if h.t.device.type == "cpu":
        return _write(out, lt.glass_mix_plain(scene, h, mat, rays, lit),
                      active)
    device = cuda_lib.cuda_device(h.t, "glass and mirror kernels")
    params = scene.params
    shape = rays.k.shape
    n = shape.numel()
    args = _GlassMixArgs(c=shade_consts(params), n_lanes=n,
                         n_px=n_px_of(shape))
    args.mat, keep_m = lane_input(h.mat, shape, 0, torch.int32, device,
                                  "mat")
    args.active, keep_a = _mask(active, shape, device)
    for j in range(3):
        args.t[j] = _lanes(rays.hits[j].t, n, 0, torch.float32, device,
                           f"t[{j}]")
        args.sky[j] = _lanes(rays.skies[j], n, 3, torch.float32, device,
                             f"sky[{j}]")
        args.lit[j] = _lanes(lit[j], n, 3, torch.float32, device,
                             f"lit[{j}]")
    args.k = _lanes(rays.k, n, 0, torch.float32, device, "k")
    args.cos = _lanes(rays.cos_theta, n, 0, torch.float32, device, "cos")
    dst = _out(out, shape, device)
    args.out = dst.data_ptr()
    cuda_lib.launch(_library().ort_an_glass_mix, "glass_mix", device,
                    ctypes.byref(an_cuda.scene_struct(params, None, device)),
                    ctypes.byref(args))
    return dst


def mirror_ray(scene, h: Hit, wo, active=None) -> lt.MirrorRay:
    """The mirror at hits `h` viewed along `wo` up to its direct light (the
    contract of lighting.mirror_ray_plain).  Lanes where `active` (bool,
    h.t's shape) is False are unspecified, and so is the sky where the
    reflected ray hit."""
    if h.t.device.type == "cpu":
        return lt.mirror_ray_plain(scene, h, wo)
    device = cuda_lib.cuda_device(h.t, "glass and mirror kernels")
    params = scene.params
    shape = _shape(h, wo)
    n = shape.numel()
    args = _MirrorRayArgs(c=shade_consts(params), n_lanes=n,
                          n_px=n_px_of(shape))
    ins, keep = _hit_inputs(h._replace(mat=None), wo, shape, device)
    for name, x in ins.items():
        setattr(args, name, x)
    args.active, keep_a = _mask(active, shape, device)
    t = _empty(n, torch.float32, device)
    hp = _empty((n, 3), torch.float32, device)
    hn = _empty((n, 3), torch.float32, device)
    hmat = _empty(n, torch.int32, device)
    view = _empty((n, 3), torch.float32, device)
    sky = _empty((n, 3), torch.float32, device)
    for name, x in (("t", t), ("hp", hp), ("hn", hn), ("hmat", hmat),
                    ("view", view), ("sky", sky)):
        setattr(args, name, x.data_ptr())
    env, texels = _skies(args, params, scene.env_map, device)
    cuda_lib.launch(_library().ort_an_mirror_ray, "mirror_ray", device,
                    ctypes.byref(an_cuda.scene_struct(params, env, device)),
                    ctypes.byref(args))
    v3 = shape + (3,)
    return lt.MirrorRay(Hit(t.reshape(shape), hp.reshape(v3),
                            hn.reshape(v3), hmat.reshape(shape)),
                        view.reshape(v3), sky.reshape(v3))


def mirror_mix(scene, h: Hit, mat, ray: lt.MirrorRay, direct,
               gi: lt.GiLight = None, active=None, out=None):
    """The mirror's radiance from its ray call's `ray`, the direct light
    `direct` at its hit and, with GI, GI's light `gi` there (the contract
    of lighting.mirror_mix_plain), written into `out` on the live lanes as
    `glass_mix` writes."""
    if h.t.device.type == "cpu":
        return _write(out, lt.mirror_mix_plain(scene, h, mat, ray, direct,
                                               gi), active)
    device = cuda_lib.cuda_device(h.t, "glass and mirror kernels")
    params = scene.params
    shape = ray.hit.t.shape
    n = shape.numel()
    args = _MirrorMixArgs(c=shade_consts(params), n_lanes=n,
                          n_px=n_px_of(shape), gi=int(gi is not None))
    args.mat, keep_m = lane_input(h.mat, shape, 0, torch.int32, device,
                                  "mat")
    args.active, keep_a = _mask(active, shape, device)
    args.t = _lanes(ray.hit.t, n, 0, torch.float32, device, "t")
    args.hmat = _lanes(ray.hit.mat, n, 0, torch.int32, device, "mat")
    args.sky = _lanes(ray.sky, n, 3, torch.float32, device, "sky")
    args.direct = _lanes(direct, n, 3, torch.float32, device, "direct")
    if gi is not None:
        args.gi_t = _lanes(gi.hit.t, n, 0, torch.float32, device, "gi.t")
        args.gi_cos = _lanes(gi.cos_theta, n, 0, torch.float32, device,
                             "gi.cos_theta")
        args.gi_lit = _lanes(gi.lit, n, 3, torch.float32, device, "gi.lit")
        args.gi_sky = _lanes(gi.sky, n, 3, torch.float32, device, "gi.sky")
    dst = _out(out, shape, device)
    args.out = dst.data_ptr()
    cuda_lib.launch(_library().ort_an_mirror_mix, "mirror_mix", device,
                    ctypes.byref(an_cuda.scene_struct(params, None, device)),
                    ctypes.byref(args))
    return dst
