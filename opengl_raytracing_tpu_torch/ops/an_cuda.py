"""Wrappers of the CUDA direct-light kernels in csrc/an_direct.cu.

`direct_light` (the analytic scene's whole direct-light tree; replaces
the TPU kernel `opengl_raytracing_tpu/ops/an_pallas.py:_kernel`) and
`direct_light_bvh` (the BVH scene's direct light, its six shadow walks
included; replaces `an_pallas.py:_kernel_bvh` and the any-hit call that
fed it) take the arguments of lighting.direct_light and
lighting.direct_light_bvh:

  * CPU tensors run the plain version (`direct_light_plain`,
    `direct_light_bvh_plain`);
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.

Each call is one launch, a frame's samples included: a call over a
leading sample axis ([spp, H, W], its rng_frame a sampled
`sampling.FrameValue`) draws each lane's disk offsets at its own sample,
and `direct_light_bvh`'s primary call (`spp_dup`) walks the sun and point
rays once a pixel for all samples.  The kernels read the raw hit records
as rows
([N,3] p, n, v and [N] material id), the pixel-centre grids in place
through their strides (`cuda_lib.PixelGrid`), and compute the rest themselves:
normalisation, the material table, the environment of the reflected view
(the scene's cubemap, sampled in the kernel from the float32 table that
`_AnScene.env` points to, or the gradient sky when the scene has none)
and the disk-light offsets' hash chain.  The scene's fixed constants, the
material types and light toggles, a pointer to the frame's record, one to
the parameter block (models/param_block.py: the lights, the sky, the
material table, the environment's intensity) and the (a, b) of the call's
two frame values go by value in one struct (`_AnScene`, the mirror of the
C struct `AnScene`, filled by `scene_args`): it is the same for every
frame and every value of the data parameters of a configuration, so a
captured CUDA graph replays the call.  The wrapper
makes nothing but the contiguous copies of rows that are not contiguous
already.
Launches go through ops/cuda_lib.py (`LAUNCHES["an_direct"]`,
`LAUNCHES["bvh_direct"]`).  Importing this module needs neither nvcc nor
a card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..constants import (EPS, PI, FLOOR_NORMAL, FLOOR_D, SPHERE_LEFT_CENTER,
                         SPHERE_LEFT_RADIUS, GLASS_CENTER, GLASS_RADIUS,
                         MIRROR_CENTER, MIRROR_RADIUS,
                         POINT_LIGHT_MARKER_RADIUS, LIGHT_CENTER,
                         LIGHT_RADIUS, LIGHT_COLOR, SOFT_SHADOW_SAMPLES,
                         BVH_ALBEDO, BVH_SPEC_STRENGTH, BVH_GLOSS, MAT_FLOOR,
                         MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE,
                         MAT_MIRROR_SPHERE)
from ..sampling import Frame, samples_of
from . import bvh_cuda, cuda_lib
from . import lighting as lt
from .cuda_lib import check
from .cubemap import texel4_table
from .materials import MTYPE_DIFFUSE, MTYPE_GLASS, MTYPE_MIRROR

_F3 = ctypes.c_float * 3
# One material id per row of the kernels' table: the floor, the albedo,
# glass and mirror spheres (the kernel takes row = id), then an id that
# gets get_material's grey fallback, as the point-light marker does.
_TABLE_IDS = (MAT_FLOOR, MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE,
              MAT_MIRROR_SPHERE, -1)
assert _TABLE_IDS[:-1] == (0, 1, 2, 3)
MAT_ROWS = len(_TABLE_IDS)


class _AnScene(ctypes.Structure):
    """Host mirror of `AnScene` in csrc/an_scene.cuh (the table's device
    pointer first, then 4-byte fields; the layouts' sizes are compared
    when the library loads)."""
    _fields_ = [
        ("env", ctypes.c_void_p), ("frame", ctypes.c_void_p),
        ("prm", ctypes.c_void_p), ("env_f", ctypes.c_int),
        ("light_c", _F3), ("light_t", _F3), ("light_b", _F3),
        ("light_nneg", _F3), ("light_color", _F3),
        ("light_radius", ctypes.c_float),
        ("floor_n", _F3), ("floor_d", ctypes.c_float),
        ("sphere_c", _F3 * 3), ("sphere_r2", _F3),
        ("marker_r2", ctypes.c_float),
        ("mat_type", ctypes.c_int * MAT_ROWS),
        ("bvh_albedo", _F3), ("bvh_spec", ctypes.c_float),
        ("bvh_gloss", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("cp", cuda_lib.FrameAffine), ("smp", cuda_lib.FrameAffine),
        ("pi_4", ctypes.c_float), ("pi_2", ctypes.c_float),
        ("sun_e", ctypes.c_int), ("sky_e", ctypes.c_int),
        ("point_e", ctypes.c_int),
    ]


class _AnRows(ctypes.Structure):
    """Host mirror of `AnRows` in csrc/an_direct.cu: a K3 call's hit rows,
    its mask bytes and pixel grid, and whether the rows are one a pixel
    for every sample."""
    _fields_ = [("p", ctypes.c_void_p), ("n", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("mat", ctypes.c_void_p),
                ("active", ctypes.c_void_p), ("grid", cuda_lib.PixelGrid),
                ("shared", ctypes.c_int)]


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_GRID = ctypes.POINTER(cuda_lib.PixelGrid)
_SIGNATURES = {
    "ort_an_direct": ([ctypes.POINTER(_AnScene), ctypes.POINTER(_AnRows),
                       _I64, _P, _P, _P], ctypes.c_int),
    "ort_bvh_direct": ([ctypes.POINTER(_AnScene), _P, _P, _P, _I32]
                       + [_P] * 3 + [_GRID, _P, _I64, _I32, _P, _P, _P],
                       ctypes.c_int),
    "ort_an_scene_size": ([], ctypes.c_int),
    "ort_pixel_grid_size": ([], ctypes.c_int),
    "ort_an_rows_size": ([], ctypes.c_int),
}


def _library():
    lib = cuda_lib.library("an_direct", _SIGNATURES)
    if (lib.ort_an_scene_size() != ctypes.sizeof(_AnScene)
            or lib.ort_pixel_grid_size()
            != ctypes.sizeof(cuda_lib.PixelGrid)
            or lib.ort_an_rows_size() != ctypes.sizeof(_AnRows)):
        raise RuntimeError("AnScene, PixelGrid or AnRows layout differs "
                           "between csrc/an_direct.cu and ops/an_cuda.py")
    return lib


def _f32(x) -> float:
    return float(np.float32(x))


def _env_table(scene, device):
    """The scene's cubemap as the kernel reads it, or None for the
    gradient sky: the table `scene.sky` samples, checked."""
    return env_table(scene.params, scene.env_map, device)


def env_table(params, env, device):
    """The cubemap table `env` as the kernels read it where `params`
    enable it, else None (the gradient sky): float32 [6, F, F, 3],
    contiguous, on `device`."""
    if not params.enable_env_map or env is None:
        return None
    check("env_map", env, torch.float32, (6, env.shape[1], env.shape[1], 3),
          device)
    return env


def env_texels(params, env, device):
    """The cubemap table `env` as the kernels built with a cubemap and
    with the gradient read it (the sky kernel, the BVH hit mix, glass's
    and the mirror's rays: an_scene.cuh's cube_or_gradient_sky) where
    `params` enable it, else None: env_table's [6, F, F, 3] table as its
    [6, F, F, 4] copy (cubemap.texel4_table: made once per table, kept
    while the table lives)."""
    table = env_table(params, env, device)
    return None if table is None else texel4_table(table)


def scene_args(scene, rng_frame: Frame, frame_index: Frame, env=None,
               device=None):
    """(the kernels' constants for one call, the frame record they point
    to): the scene's (see `_scene_constants`), the pointer to its
    parameter block, the cubemap table `env` (`_env_table`; None leaves
    the pointer null) and the frame record with `frame_index` and
    `rng_frame` as (a, b) of its index (`cuda_lib.frame_args`; the kernel
    derives sampling.rand's xor keys of cp_offset's two frames,
    frame_index * 911 and * 577, and of `rng_frame`, and reads
    ld2(frame_index) from the record).  The same bytes for every frame and
    every value of the data parameters of one configuration.  `device` as
    `cuda_lib.frame_args` takes it."""
    s = scene_struct(scene.params, env, device)
    record, (cp, smp), _ = cuda_lib.frame_args(device, frame_index,
                                               rng_frame)
    if (cp.a, cp.b, cp.c) != (1, 0, 0):
        raise ValueError("frame_index must be the record's frame index: the "
                         "kernels read ld2 of it from the record")
    s.frame, s.cp, s.smp = record.data_ptr(), cp, smp
    return s, record


def scene_struct(params, env=None, device=None) -> "_AnScene":
    """The `AnScene` of a call without frame values (the frame pointer and
    RNG keys left zero): the constants of the static parameters of
    `params` (a FrameParams, or a RenderParams bound to its cached block
    on `device`), the pointer to its parameter block and the cubemap table
    `env` (None leaves the pointer null: the gradient sky).  K3's
    `scene_args` and the analytic scene's kernels (ops/an_trace_cuda.py)
    take it.  `device` as `cuda_lib.param_block_ptr` takes it."""
    s = _AnScene.from_buffer_copy(_scene_constants(
        *(int(bool(getattr(params, k))) for k in _SCENE_TOGGLES)))
    s.prm = cuda_lib.param_block_ptr(params, device)
    if env is not None:
        s.env = env.data_ptr()
        s.env_f = env.shape[1]
    return s


# the static parameters `_scene_constants` depends on
_SCENE_TOGGLES = ("sun_enabled", "sky_enabled", "point_light_enabled",
                  "mat_glass_enabled", "mat_mirror_enabled")


@functools.lru_cache(maxsize=None)
def _scene_constants(sun_e, sky_e, point_e, glass_e, mirror_e) -> bytes:
    """The `AnScene` bytes that depend on the static parameters alone (the
    pointers and RNG keys left zero), each value rounded to float32 as
    the plain version rounds it: squared radii in double first, like
    `dot(oc, oc) - radius * radius`; the material types are get_material's,
    the glass and mirror toggles resolved."""

    def v3(x):
        return _F3(*(_f32(c) for c in x))

    types = [MTYPE_DIFFUSE] * MAT_ROWS
    if glass_e:
        types[_TABLE_IDS.index(MAT_GLASS_SPHERE)] = MTYPE_GLASS
    if mirror_e:
        types[_TABLE_IDS.index(MAT_MIRROR_SPHERE)] = MTYPE_MIRROR
    return bytes(_AnScene(
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
        mat_type=(ctypes.c_int * MAT_ROWS)(*types),
        bvh_albedo=v3(BVH_ALBEDO), bvh_spec=_f32(BVH_SPEC_STRENGTH),
        bvh_gloss=_f32(BVH_GLOSS), eps=_f32(EPS),
        pi_4=_f32(PI / 4.0), pi_2=_f32(PI / 2.0),
        sun_e=sun_e, sky_e=sky_e, point_e=point_e))


def _pixel_rows(h, vdir, device):
    """The rows K5 reads a lane each: p, n, v [N,3]."""
    shape = h.t.shape
    rows = dict(p=cuda_lib.rows(h.p, shape), n=cuda_lib.rows(h.n, shape),
                v=cuda_lib.rows(vdir, shape))
    for name, x in rows.items():
        check(name, x, torch.float32, (h.t.numel(), 3), device)
    return rows


def _offsets_ptr(offsets_out, n_lanes, device):
    if offsets_out is None:
        return None
    check("offsets_out", offsets_out, torch.float32,
          (2 * SOFT_SHADOW_SAMPLES, n_lanes), device)
    return offsets_out.data_ptr()


def direct_rows(scene, h, rng_frame: Frame, frame_index: Frame, vdir, px,
                py, active, device):
    """(K3's `AnScene` and `AnRows` for one call, the tensors they point
    into, which must outlive the launch): the arguments of
    `direct_light` on `device`.  Where the samples of a sampled
    `rng_frame` share the hit and `active` (each broadcast over the
    leading sample axis: the frame's primary call), the rows and the mask
    are the pixels' own, read in place, one a pixel for every sample;
    else a row a lane, copied where not contiguous already."""
    shape = h.t.shape
    samples = samples_of(rng_frame)
    args, record = scene_args(scene, rng_frame, frame_index,
                              _env_table(scene, device), device)
    grid, grids = cuda_lib.pixel_grid(px, py, shape, device, samples)
    vecs = dict(p=h.p.expand(shape + (3,)), n=h.n.expand(shape + (3,)),
                v=vdir.expand(shape + (3,)))
    lanes = [h.mat.expand(shape)] + ([] if active is None
                                     else [active.expand(shape)])
    shared = samples > 1 and all(x.stride(0) == 0
                                 for x in [*vecs.values(), *lanes])
    if shared:
        vecs = {name: x[0] for name, x in vecs.items()}
        lanes = [x[0] for x in lanes]
    rows_shape = lanes[0].shape
    rows = {name: cuda_lib.rows(x, rows_shape) for name, x in vecs.items()}
    for name, x in rows.items():
        check(name, x, torch.float32, (rows_shape.numel(), 3), device)
    mat = cuda_lib.flat(lanes[0], rows_shape)
    check("mat", mat, torch.int32, (rows_shape.numel(),), device)
    act_ptr, act = cuda_lib.mask_bytes(
        None if active is None else lanes[1], rows_shape, device)
    r = _AnRows(rows["p"].data_ptr(), rows["n"].data_ptr(),
                rows["v"].data_ptr(), mat.data_ptr(), act_ptr, grid,
                int(shared))
    return args, r, [record, grids, rows, mat, act]


def direct_light(scene, h, rng_frame: Frame, frame_index: Frame, vdir, px,
                 py, active=None, offsets_out=None):
    """Direct light of the analytic scene at hits `h` [...] (the contract
    of lighting.direct_light_plain): rgb [..., 3].  With a cubemap in the
    scene the kernel samples it on its mirror and glass lanes.  Lanes
    where `active` (bool, h.t's shape) is False do no work; their values
    are unspecified (the kernel leaves them unwritten).

    A sampled `rng_frame` (`FrameValue.sampled`: a leading sample axis of
    the call, over which px and py are broadcast) is one launch: lane i
    draws its disk offsets at sample i // (pixels a sample).  Where the
    hit and `active` are broadcast over that axis the kernel reads their
    rows once a pixel, in place (`direct_rows`).  One launch either way:
    persistent blocks whose warps queue their live lanes by path and shade
    them 32 at a time (csrc/an_direct.cu).  On the card, `offsets_out`
    (float32 [8, N], optional) receives the kernel's disk offsets of the
    live lanes as planes dx0, dy0, dx1, ..."""
    if h.t.device.type == "cpu":
        return lt.direct_light_plain(scene, h, rng_frame, frame_index, vdir,
                                     px, py)
    device = cuda_lib.cuda_device(h.t, "direct-light kernels")
    shape = h.t.shape
    n_lanes = h.t.numel()
    args, rows, _keep = direct_rows(scene, h, rng_frame, frame_index, vdir,
                                    px, py, active, device)
    offs = _offsets_ptr(offsets_out, n_lanes, device)
    out = torch.empty((n_lanes, 3), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_an_direct, "an_direct", device,
                    ctypes.byref(args), ctypes.byref(rows), n_lanes,
                    out.data_ptr(), offs)
    return out.reshape(shape + (3,))


def _shared_rows(h, vdir, active, shape, dup, device):
    """The rows of sample 0 of a hit broadcast over the leading sample axis
    of `dup` samples (p, n, v [n_px, 3]) and its `active` mask bytes
    (pointer or None, the tensor to keep); raise where the hit, vdir or
    the mask is not broadcast over it."""
    if shape[0] != dup:
        raise ValueError(f"spp_dup={dup} needs a leading sample axis of that "
                         f"length, got shape {tuple(shape)}")
    n_px = shape.numel() // dup
    rows = {}
    for name, x in (("p", h.p), ("n", h.n), ("v", vdir)):
        rows[name] = cuda_lib.sample_rows(x, shape, dup)
        if rows[name] is None:
            raise ValueError(f"spp_dup={dup}: {name} must be broadcast over "
                             f"the sample axis (the samples' shared hit)")
        check(name, rows[name], torch.float32, (n_px, 3), device)
    if active is None:
        return rows, (None, None)
    act = active.expand(shape)
    if act.stride(0) != 0:
        raise ValueError(f"spp_dup={dup}: active must be broadcast over the "
                         f"sample axis")
    return rows, cuda_lib.mask_bytes(act[0], shape[1:], device)


def direct_light_bvh(scene, h, rng_frame: Frame, frame_index: Frame, vdir,
                     px, py, active=None, offsets_out=None, spp_dup=0):
    """Direct light of the BVH scene at hits `h` [...] (the contract of
    lighting.direct_light_bvh_plain): rgb [..., 3], with the six shadow
    walks in the same launch.  Lanes where `active` is False do no work;
    their values are unspecified (the kernel leaves them unwritten).

    With `spp_dup` > 1 the call is a leading sample axis of that length
    over a hit (and vdir, active, px, py) broadcast over it, the samples
    of one pixel: the kernel reads the hit's rows once a pixel, walks the
    sun and point rays once for all samples (the plain version traces
    them for sample 0 and broadcasts its bits) and takes the samples in
    turn, each with its own seed's disk offsets and walks.  Without it a
    row is a lane, its sample (for a sampled `rng_frame`) i // (pixels a
    sample).  One launch either way: persistent blocks whose warps walk
    their live pixels' open windows 32 at a time (csrc/an_direct.cu).
    `offsets_out` as for `direct_light`."""
    if h.t.device.type == "cpu":
        return lt.direct_light_bvh_plain(scene, h, rng_frame, frame_index,
                                         vdir, px, py, active, spp_dup)
    device = cuda_lib.cuda_device(h.t, "direct-light kernels")
    shape = h.t.shape
    n_lanes = h.t.numel()
    args, _keep_record = scene_args(scene, rng_frame, frame_index,
                                    device=device)
    dup = int(spp_dup) if spp_dup > 1 else 1
    samples = samples_of(rng_frame)
    if samples > 1 and dup > 1 and samples != dup:
        raise ValueError(f"rng_frame has {samples} samples, spp_dup is "
                         f"{dup}")
    if dup > 1:
        rows, (act, _keep_act) = _shared_rows(h, vdir, active, shape, dup,
                                              device)
    else:
        rows = _pixel_rows(h, vdir, device)
        act, _keep_act = cuda_lib.mask_bytes(active, shape, device)
    grid, _keep = cuda_lib.pixel_grid(px, py, shape, device,
                                      max(samples, dup))
    bvh = scene.bvh.arrays
    bvh_cuda.check_bvh(bvh, device)
    offs = _offsets_ptr(offsets_out, n_lanes, device)
    out = torch.empty((n_lanes, 3), dtype=torch.float32, device=device)
    cuda_lib.launch(_library().ort_bvh_direct, "bvh_direct", device,
                    ctypes.byref(args),
                    bvh.bounds.data_ptr(), bvh.meta.data_ptr(),
                    bvh.tris.data_ptr(), bvh.bounds.shape[0],
                    rows["p"].data_ptr(), rows["n"].data_ptr(),
                    rows["v"].data_ptr(), ctypes.byref(grid), act,
                    n_lanes // dup, dup, out.data_ptr(), offs)
    return out.reshape(shape + (3,))
