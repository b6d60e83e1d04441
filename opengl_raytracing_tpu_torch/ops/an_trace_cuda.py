"""Wrappers of the analytic scene's CUDA kernels in csrc/an_trace.cu.

  * `trace` -- the closest hit of given rays against the analytic scene
    (scene_analytic.trace_analytic_core: with or without the glass sphere
    and the point-light marker);
  * `ambient_occlusion` -- compute_ao's analytic branch whole: the
    hemisphere samples, their traces and the AO value
    (lighting.ambient_occlusion_analytic_plain);
  * `bounce` -- GI's bounce ray of each hit, sampled in the kernel, and
    its closest hit (lighting.gi_bounce_analytic_plain);
  * `sky` -- the environment of each direction (scene_analytic.sky:
    the cubemap times its intensity, or the gradient sky), for both
    scenes (`SceneCtx.sky`).

They replace no TPU kernel: in the JAX package this work is jnp code
behind its occupancy gates (`pipeline.py:_tile_gated_shade`,
`shade_analytic_auto`, `SceneCtx.sky_gated`), which compact tiles under a
dense fallback.  Here each call takes `active`, a bool mask of the lanes
whose result the caller reads (None: every lane):

  * CPU tensors run the plain version, which computes every lane;
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.  The kernel computes the live
    lanes alone and leaves the others unwritten: their values are
    unspecified (ROADMAP C, "Inactive lanes").

An input is read in place where its strides allow (`lane_input`): one
row a lane; one row a pixel where it is broadcast over a leading sample
axis ([spp, H, W], the frame's shared hit and its masks: lane i reads row
i % n_px); or one row for every lane (the camera's origin).  The scene's
constants and the pointer to the parameter block go in K3's `AnScene`
(`an_cuda.scene_struct`), the frame's record by pointer: the same bytes
for every frame and every value of the data parameters, so a captured
CUDA graph replays the calls.  Launches go through ops/cuda_lib.py
(`LAUNCHES["an_trace"]`, `["an_ao"]`, `["an_bounce"]`, `["sky"]`).
Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import (EPS, PI, MAT_FLOOR, MAT_ALBEDO_SPHERE,
                         MAT_GLASS_SPHERE, MAT_MIRROR_SPHERE,
                         MAT_POINTLIGHT_SPHERE)
from ..params import bind, f32
from ..sampling import Frame, samples_of
from . import an_cuda, cuda_lib
from .cuda_lib import check
from . import scene_analytic as sa
from .scene_analytic import Hit

# The kernels write a hit's material id as the index of its primitive in
# trace_analytic_core's order: the floor, the three spheres, the marker.
assert (MAT_FLOOR, MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE, MAT_MIRROR_SPHERE,
        MAT_POINTLIGHT_SPHERE) == (0, 1, 2, 3, 4)

# how a kernel reads an input (csrc/an_trace.cu): a row a lane, a row a
# pixel (lane i: row i % n_px), one row for every lane
LANE, PIXEL, ONE = 0, 1, 2

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)


class _LaneIn(ctypes.Structure):
    """Host mirror of `LaneIn` in csrc/an_trace.cu."""
    _fields_ = [("p", _P), ("mode", _I32)]


class _TraceArgs(ctypes.Structure):
    """Host mirror of `AnTraceArgs` in csrc/an_trace.cu."""
    _fields_ = [("ro", _LaneIn), ("rd", _LaneIn), ("active", _LaneIn),
                ("n_lanes", _I64), ("n_px", _I64), ("eps", _F32),
                ("glass", _I32), ("marker", _I32),
                ("t", _P), ("p", _P), ("nrm", _P), ("mat", _P)]


class _AoArgs(ctypes.Structure):
    """Host mirror of `AnAoArgs` in csrc/an_trace.cu."""
    _fields_ = [("p", _LaneIn), ("n", _LaneIn), ("active", _LaneIn),
                ("grid", cuda_lib.PixelGrid), ("frame", _P),
                ("fi", cuda_lib.FrameAffine), ("samples", _I32),
                ("marker", _I32), ("two_pi", _F32),
                ("n_lanes", _I64), ("n_px", _I64), ("out", _P)]


class _BounceArgs(ctypes.Structure):
    """Host mirror of `AnBounceArgs` in csrc/an_trace.cu."""
    _fields_ = [("p", _LaneIn), ("n", _LaneIn), ("active", _LaneIn),
                ("grid", cuda_lib.PixelGrid), ("frame", _P),
                ("rng", cuda_lib.FrameAffine), ("seed", cuda_lib.FrameAffine),
                ("two_pi", _F32), ("marker", _I32),
                ("n_lanes", _I64), ("n_px", _I64),
                ("t", _P), ("p_out", _P), ("n_out", _P), ("mat", _P),
                ("wi", _P), ("cos", _P)]


class _SkyArgs(ctypes.Structure):
    """Host mirror of `SkyArgs` in csrc/an_trace.cu."""
    _fields_ = [("d", _LaneIn), ("active", _LaneIn), ("n_lanes", _I64),
                ("n_px", _I64), ("out", _P), ("texels", _P)]


_SCENE = ctypes.POINTER(an_cuda._AnScene)
_SIGNATURES = {
    "ort_an_trace": ([_SCENE, ctypes.POINTER(_TraceArgs), _P], _I32),
    "ort_an_ao": ([_SCENE, ctypes.POINTER(_AoArgs), _P], _I32),
    "ort_an_bounce": ([_SCENE, ctypes.POINTER(_BounceArgs), _P], _I32),
    "ort_sky": ([_SCENE, ctypes.POINTER(_SkyArgs), _P], _I32),
    "ort_an_trace_sizes": ([ctypes.POINTER(_I32), _I32], _I32),
}
_LAYOUTS = (an_cuda._AnScene, cuda_lib.PixelGrid, _LaneIn, _TraceArgs,
            _AoArgs, _BounceArgs, _SkyArgs)


def _library():
    lib = cuda_lib.library("an_trace", _SIGNATURES)
    sizes = (_I32 * len(_LAYOUTS))()
    n = lib.ort_an_trace_sizes(sizes, len(_LAYOUTS))
    want = [ctypes.sizeof(s) for s in _LAYOUTS]
    if n != len(_LAYOUTS) or list(sizes) != want:
        raise RuntimeError(f"the argument structs' layout differs between "
                           f"csrc/an_trace.cu ({list(sizes)[:n]}) and "
                           f"ops/an_trace_cuda.py ({want})")
    return lib


def n_px_of(shape) -> int:
    """The pixels of one sample of a call of `shape`: every lane but the
    leading axis's (a row a pixel is row i % n_px)."""
    shape = torch.Size(shape)
    return max(shape[1:].numel(), 1) if len(shape) > 1 else max(
        shape.numel(), 1)


def lane_input(x, shape, width, dtype, device, name):
    """(the kernels' `LaneIn` of `x` broadcast to `shape` (+ (width,) for
    vectors), the tensor it points into, which must outlive the launch):
    one row for every lane where `x` is broadcast over all of `shape`
    (the camera's origin), one row a pixel where it is broadcast over the
    leading axis of a `shape` of two axes or more (the samples' shared
    hit and masks), else one row a lane; each contiguous, a view where it
    already is."""
    shape = torch.Size(shape)
    tail = (width,) if width else ()
    x = x.expand(shape + tail)
    lanes = x[..., 0] if width else x
    if lanes.numel() > 0 and all(s == 0 for s in lanes.stride()):
        mode, rows = ONE, x.reshape((-1,) + tail)[:1]
    elif len(shape) > 1 and shape[0] > 1 and lanes.stride(0) == 0:
        mode, rows = PIXEL, x[0].reshape((-1,) + tail)
    else:
        mode, rows = LANE, x.reshape((-1,) + tail)
    rows = rows.contiguous()
    check(name, rows, dtype, (rows.shape[0],) + tail, device,
          align=4 if width else 1)
    return _LaneIn(rows.data_ptr(), mode), rows


def _mask(active, shape, device):
    """`lane_input` of the mask `active`, or a null one (every lane live)
    for None."""
    if active is None:
        return _LaneIn(None, LANE), None
    return lane_input(active, shape, 0, torch.bool, device, "active")


def _empty(shape, dtype, device):
    """An output of a kernel: its dead lanes keep whatever this holds."""
    return torch.empty(shape, dtype=dtype, device=device)


def _hit_out(shape, device):
    n = shape.numel()
    return (_empty(n, torch.float32, device),
            _empty((n, 3), torch.float32, device),
            _empty((n, 3), torch.float32, device),
            _empty(n, torch.int32, device))


def _hit(shape, t, p, n, mat) -> Hit:
    return Hit(t.reshape(shape), p.reshape(shape + (3,)),
               n.reshape(shape + (3,)), mat.reshape(shape))


def _marker(params, include_point_light: bool) -> int:
    return int(bool(include_point_light and params.point_light_enabled))


def trace(ro, rd, params, point_light_pos, include_glass: bool,
          include_point_light: bool, eps: float = EPS, active=None) -> Hit:
    """The closest hit of rays ro/rd [..., 3] against the analytic scene
    (the contract of scene_analytic.trace_analytic_core: t = 1e30 on a
    miss, p = ro + rd*t, the winner's unit normal, its material id).
    Lanes where `active` (bool, the rays' shape) is False are unspecified.
    On the card the marker's centre is the parameter block's
    `point_light_world`, which `point_light_pos` must be a view of."""
    if rd.device.type == "cpu":
        return sa.trace_analytic_core(ro, rd, params, point_light_pos,
                                      include_glass, include_point_light, eps)
    device = cuda_lib.cuda_device(rd, "analytic-scene kernels")
    p = bind(params, device)
    marker = _marker(p, include_point_light)
    if marker and (point_light_pos.data_ptr()
                   != p["point_light_world"].data_ptr()):
        raise ValueError("the marker's centre must be the parameter block's "
                         "point_light_world")
    shape = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    n_px = n_px_of(shape)
    o, keep_o = lane_input(ro, shape, 3, torch.float32, device, "ro")
    d, keep_d = lane_input(rd, shape, 3, torch.float32, device, "rd")
    act, keep_a = _mask(active, shape, device)
    t, hp, hn, mat = _hit_out(shape, device)
    args = _TraceArgs(o, d, act, shape.numel(), n_px, f32(eps),
                      int(bool(include_glass)), marker, t.data_ptr(),
                      hp.data_ptr(), hn.data_ptr(), mat.data_ptr())
    cuda_lib.launch(_library().ort_an_trace, "an_trace", device,
                    ctypes.byref(an_cuda.scene_struct(p, None, device)),
                    ctypes.byref(args))
    return _hit(shape, t, hp, hn, mat)


def ao_args(params, frame_index: Frame, device=None):
    """(the AO kernel's constants for one call, the frame record they point
    to; the rows, grid and output left null): the record, `frame_index`
    as (a, b) of its index, `ao_samples`, whether the marker is traced and
    float32(2 PI).  The same bytes for every frame and every value of the
    data parameters of one configuration."""
    record, (fi,), samples = cuda_lib.frame_args(device, frame_index)
    if samples > 1:
        raise ValueError("AO takes the frame index, not a sampled seed: it "
                         "is computed once for all samples")
    return _AoArgs(frame=record.data_ptr(), fi=fi,
                   samples=int(params.ao_samples),
                   marker=_marker(params, True),
                   two_pi=f32(2.0 * PI)), record


def ambient_occlusion(scene, h: Hit, frame_index: Frame, px, py,
                      active=None):
    """compute_ao's analytic branch at hits `h` (the contract of
    lighting.ambient_occlusion_analytic_plain): params.ao_samples
    cosine-hemisphere rays from h.p + normalize(h.n)*ao_bias, a sample
    occluded where its closest hit is within ao_radius, remapped to
    [ao_min, 1].  Lanes where `active` (bool, h.t's shape) is False are
    unspecified."""
    if h.t.device.type == "cpu":
        from .lighting import ambient_occlusion_analytic_plain
        return ambient_occlusion_analytic_plain(scene, h, frame_index, px, py)
    device = cuda_lib.cuda_device(h.t, "analytic-scene kernels")
    params = scene.params
    if int(params.ao_samples) < 1:
        raise ValueError(f"ao_samples must be >= 1, got {params.ao_samples}")
    shape = h.t.shape
    args, keep_record = ao_args(params, frame_index, device)
    args.p, keep_p = lane_input(h.p, shape, 3, torch.float32, device, "h.p")
    args.n, keep_n = lane_input(h.n, shape, 3, torch.float32, device, "h.n")
    args.active, keep_a = _mask(active, shape, device)
    args.grid, keep_grid = cuda_lib.pixel_grid(px, py, shape, device)
    args.n_lanes, args.n_px = shape.numel(), n_px_of(shape)
    out = _empty(shape.numel(), torch.float32, device)
    args.out = out.data_ptr()
    cuda_lib.launch(_library().ort_an_ao, "an_ao", device,
                    ctypes.byref(an_cuda.scene_struct(params, None, device)),
                    ctypes.byref(args))
    return out.reshape(shape)


def bounce_args(params, rng_frame: Frame, seed: Frame, device=None):
    """(the bounce kernel's constants for one call, the frame record they
    point to; the rows, grid and outputs left null): the record,
    `rng_frame` and `seed` as (a, b, c) of its index (the kernel derives
    the RNG keys and the offsets float32(seed * 13) and float32(seed * 37)
    at the lane's sample), float32(2 PI) and whether the marker is traced.
    The same bytes for every frame of one configuration."""
    record, (rng, sd), _ = cuda_lib.frame_args(device, rng_frame, seed)
    return _BounceArgs(frame=record.data_ptr(), rng=rng, seed=sd,
                       two_pi=f32(2.0 * PI),
                       marker=_marker(params, True)), record


def bounce(scene, h0: Hit, rng_frame: Frame, seed: Frame, px, py,
           active=None):
    """GI's bounce ray at each hit of `h0` and its closest hit against the
    whole analytic scene: (Hit, wi, cos_theta), the contract of
    lighting.gi_bounce_analytic_plain.  A sampled `seed` (a leading sample
    axis over which px and py are broadcast) is one launch over every
    sample's lanes; where the hit and `active` are broadcast over that
    axis, their rows are read once a pixel.  Lanes where `active` (bool,
    h0.t's shape) is False are unspecified."""
    if h0.t.device.type == "cpu":
        from .lighting import gi_bounce_analytic_plain
        return gi_bounce_analytic_plain(scene, h0, rng_frame, seed, px, py)
    device = cuda_lib.cuda_device(h0.t, "analytic-scene kernels")
    shape = h0.t.shape
    args, keep_record = bounce_args(scene.params, rng_frame, seed, device)
    samples = max(samples_of(rng_frame), samples_of(seed))
    args.grid, keep_grid = cuda_lib.pixel_grid(px, py, shape, device,
                                               samples)
    args.p, keep_p = lane_input(h0.p, shape, 3, torch.float32, device, "h.p")
    args.n, keep_n = lane_input(h0.n, shape, 3, torch.float32, device, "h.n")
    args.active, keep_a = _mask(active, shape, device)
    args.n_lanes, args.n_px = shape.numel(), n_px_of(shape)
    t, hp, hn, mat = _hit_out(shape, device)
    wi = _empty((shape.numel(), 3), torch.float32, device)
    cos = _empty(shape.numel(), torch.float32, device)
    args.t, args.p_out, args.n_out, args.mat = (
        t.data_ptr(), hp.data_ptr(), hn.data_ptr(), mat.data_ptr())
    args.wi, args.cos = wi.data_ptr(), cos.data_ptr()
    cuda_lib.launch(_library().ort_an_bounce, "an_bounce", device,
                    ctypes.byref(an_cuda.scene_struct(scene.params, None,
                                                      device)),
                    ctypes.byref(args))
    return (_hit(shape, t, hp, hn, mat), wi.reshape(shape + (3,)),
            cos.reshape(shape))


def sky(d, params, env_map=None, active=None):
    """The environment of directions d [..., 3] (the contract of
    scene_analytic.sky): the cubemap `env_map` (the float32 table of
    SceneCtx) times env_map_intensity where the parameters enable it, else
    the gradient sky.  Lanes where `active` (bool, d's shape but the last
    axis) is False are unspecified."""
    if d.device.type == "cpu":
        return sa.sky(d, params, env_map)
    device = cuda_lib.cuda_device(d, "analytic-scene kernels")
    p = bind(params, device)
    shape = d.shape[:-1]
    rows, keep_d = lane_input(d, shape, 3, torch.float32, device, "d")
    act, keep_a = _mask(active, shape, device)
    out = _empty((shape.numel(), 3), torch.float32, device)
    env = an_cuda.env_table(p, env_map, device)
    texels = an_cuda.env_texels(p, env_map, device)
    args = _SkyArgs(rows, act, shape.numel(), n_px_of(shape),
                    out.data_ptr(),
                    None if texels is None else texels.data_ptr())
    cuda_lib.launch(_library().ort_sky, "sky", device,
                    ctypes.byref(an_cuda.scene_struct(p, env, device)),
                    ctypes.byref(args))
    return out.reshape(shape + (3,))
