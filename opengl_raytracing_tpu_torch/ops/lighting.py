"""Direct lighting, the mirror/glass secondaries, one-bounce GI and
ambient occlusion, vectorized over pixel batches.

Counterpart of `opengl_raytracing_tpu/ops/lighting.py` for the analytic
scene and for BVH triangles (reference: shaders/rt/rt_lighting.glsl).
Per-fragment branches become masked selects; the RNG call sites hash the
same (pixel, frame, offset) values, so the soft-shadow, bounce and AO
noise matches the JAX package bit for bit.  The JAX package's opt-in
2-batch `direct_and_gi_analytic` is not ported; its default two-call form
is.

CUDA kernels take over on the card, each computing its whole call from
hit records in one launch: the analytic `direct_light` tree and
`direct_light_bvh`, its six shadow walks included (ops/an_cuda.py); each
scene's GI bounce ray, sampled and traced (`bvh_cuda.trace_bounce`,
`an_trace_cuda.bounce`), and its ambient occlusion, sampled, traced and
remapped (`bvh_cuda.ambient_occlusion`, `an_trace_cuda.ambient_
occlusion`).  Their plain versions are `direct_light_plain`,
`direct_light_bvh_plain`, `gi_bounce_plain`, `gi_bounce_analytic_plain`,
`ambient_occlusion_plain` and `ambient_occlusion_analytic_plain` here,
which the wrappers run for CPU tensors.  The analytic scene's traces and
sky lookups take the lanes their caller reads (`active`) down to the
kernels of ops/an_trace_cuda.py, and `shade_glass` and `shade_mirror`
run on their material's lanes as a rays kernel before their direct light
and a mix kernel after it (ops/an_shade_cuda.py; plain versions
`glass_rays_plain`, `glass_mix_plain`, `mirror_ray_plain`,
`mirror_mix_plain`), and each scene's shading tail after its direct
light and GI's bounce (GI's tail, the GI sum, AO's product, the marker)
runs on the hit lanes as one kernel (ops/hit_mix_cuda.py; plain
versions `bvh_hit_mix_plain`, `an_hit_mix_plain`): on the card every
other lane is unspecified, as behind the JAX package's occupancy
gates.

A frame's samples reach these functions as one batch over a leading
sample axis ([spp, H, W], models/pipeline.py), their seed one sampled
`FrameValue`; each kernel takes the axis inside its launch, and
`direct_light_bvh(..., spp_dup=spp)` traces the sun and point shadow rays
once for all samples of the shared primary hit, as the JAX package does.

Naming of the RNG arguments follows the GLSL call chain:
  * `rng_frame`  — the `frame` parameter of the GLSL function;
  * `frame_index` — the global uFrameIndex uniform (used by cpOffset).
Each is a `sampling.FrameValue` (an int32 `index * a + b` of the frame
index on the device, as the JAX package's traced seeds are); a
seed such as `seed * 131 + 17` stays one, and `frame_f32` gives the
sample offsets' float32 of it.
"""

from __future__ import annotations

import functools
import operator
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from ..params import bind
from ..constants import (EPS, PI, SOFT_SHADOW_SAMPLES, LIGHT_CENTER,
                         LIGHT_NORMAL_RAW, LIGHT_RADIUS, LIGHT_COLOR,
                         MAT_POINTLIGHT_SPHERE,
                         BVH_ALBEDO, BVH_SPEC_STRENGTH, BVH_GLOSS, GI_MAX_LUM,
                         GI_MIN_COS_THETA, GLASS_DISTORTION_STRENGTH,
                         GLASS_LOCAL_REFL_WEIGHT, YCOEFF)
from ..sampling import (Frame, rand, eps_for_dist, concentric_sample,
                        cp_offset, frame_f32, sample_hemisphere_cosine)
from . import bvh_cuda
from . import scene_analytic as sa
from .scene_analytic import Hit
from .bvh_traverse import trace_bvh, trace_bvh_shadow
from .materials import (get_material, material_type, MaterialProps,
                        MTYPE_DIFFUSE, MTYPE_MIRROR, MTYPE_GLASS)
from .vecmath import dot, normalize, reflect, refract, mix, const3, length

if TYPE_CHECKING:  # ops/scene.py imports the kernel wrappers, which import
    from .scene import SceneCtx  # this module

# Disk light frame, precomputed on host
# (reference: shaders/rt/rt_lighting.glsl:29-32, 355-357).
_KN = np.asarray(LIGHT_NORMAL_RAW, np.float64)
_KN = _KN / np.linalg.norm(_KN)
_LT = np.cross(_KN, [0.0, 1.0, 0.0]) if abs(_KN[1]) < 0.99 \
    else np.cross(_KN, [1.0, 0.0, 0.0])
_LT = _LT / np.linalg.norm(_LT)
_LB = np.cross(_KN, _LT)
LIGHT_N = _KN.astype(np.float32)
LIGHT_T = _LT.astype(np.float32)
LIGHT_B = _LB.astype(np.float32)


def _segment_shadow_query(p, q):
    """(origin, dir, window) for a p->q occlusion segment
    (reference: rt_lighting.glsl:49-55)."""
    delta = q - p
    max_t = length(delta)
    rd = delta / torch.clamp_min(max_t, 1e-12)[..., None]
    eps = eps_for_dist(max_t)
    return p + rd * eps[..., None], rd, max_t - eps


def occluded_toward(scene: SceneCtx, p, q):
    """Segment occlusion test against the analytic scene (reference:
    rt_lighting.glsl:49-60): a closest hit inside the window.  (The BVH
    scene asks any-hit walks instead: direct_light_bvh.)"""
    origin, rd, win = _segment_shadow_query(p, q)
    h = sa.trace_analytic(origin, rd, scene.params, scene.point_light_pos)
    return h.valid & (h.t < win)


def shade_lambert_phong(n, v, l, li, albedo, spec_strength, gloss):
    """Lambert + Phong BRDF for one light sample
    (reference: rt_lighting.glsl:78-98)."""
    ndl = torch.clamp_min(dot(n, l), 0.0)
    diffuse = albedo * (ndl / PI)[..., None]
    h = normalize(l + v)
    ndh = torch.clamp_min(dot(n, h), 0.0)
    phong = torch.pow(ndh, gloss)
    spec = torch.where(spec_strength > 0.0, spec_strength * phong, 0.0)
    out = (diffuse + spec[..., None]) * li
    return torch.where((ndl > 0.0)[..., None], out, 0.0)


def _sun_shadow_query(scene: SceneCtx, h, n):
    """(origin, dir, window) of the sun shadow ray
    (reference: rt_lighting.glsl:125-136).  epsForDist(1000) == 1.0."""
    max_t = 1000.0
    eps = max(1e-4, 1e-3 * max_t)
    origin = h.p + n * eps
    l = (-scene.sun_dir).expand(origin.shape)
    return origin, l, torch.full(h.t.shape, max_t - eps, dtype=torch.float32,
                                 device=h.t.device)


def sun_direct(scene: SceneCtx, h, mat, vdir, blocked=None):
    """Hard-shadowed directional sun (reference: rt_lighting.glsl:114-144).

    `blocked` is precomputed by the BVH scene's batched shadow walks
    (direct_light_bvh_plain); without it the analytic scene traces (its
    plain trace)."""
    if not scene.params.sun_enabled:
        return torch.zeros(h.t.shape + (3,), device=h.t.device)
    n = normalize(h.n)
    v = normalize(vdir)
    l = -scene.sun_dir
    ndl = torch.clamp_min(dot(n, l), 0.0)
    if blocked is None:
        origin, ldir, _ = _sun_shadow_query(scene, h, n)
        blocked = sa.trace_analytic(origin, ldir, scene.params,
                                    scene.point_light_pos).valid  # any hit
    li = scene.params["sun_li"]
    spec = torch.where(mat.mtype == MTYPE_DIFFUSE, mat.spec_strength, 0.0)
    out = shade_lambert_phong(n, v, l, li, mat.albedo, spec, mat.gloss)
    return torch.where(((ndl > 0.0) & ~blocked)[..., None], out, 0.0)


def sky_direct(scene: SceneCtx, h, mat):
    """Cosine sky dome, diffuse only, unshadowed
    (reference: rt_lighting.glsl:156-169)."""
    if not scene.params.sky_enabled:
        return torch.zeros(h.t.shape + (3,), device=h.t.device)
    n = normalize(h.n)
    ndl = torch.clamp_min(dot(n, scene.sky_up), 0.0)
    li = scene.params["sky_li"]
    return mat.albedo * (ndl / PI)[..., None] * li


def _point_shadow_query(scene: SceneCtx, h):
    """(origin, dir, window) of the point-light shadow ray
    (reference: rt_lighting.glsl:186-201)."""
    to_l = scene.point_light_pos - h.p
    dist = torch.sqrt(torch.clamp_min(dot(to_l, to_l), 1e-20))
    l = to_l / dist[..., None]
    eps = eps_for_dist(dist)
    return h.p + l * eps[..., None], l, dist - eps


def point_direct(scene: SceneCtx, h, mat, vdir, blocked=None):
    """Point light with inverse-square falloff and shadows
    (reference: rt_lighting.glsl:181-214).  `blocked` as for
    sun_direct."""
    if not scene.params.point_light_enabled:
        return torch.zeros(h.t.shape + (3,), device=h.t.device)
    n = normalize(h.n)
    v = normalize(vdir)
    to_l = scene.point_light_pos - h.p
    dist2 = dot(to_l, to_l)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    l = to_l / dist[..., None]
    ndl = torch.clamp_min(dot(n, l), 0.0)
    if blocked is None:
        origin, ldir, win = _point_shadow_query(scene, h)
        # the marker sphere must not shadow its own light
        tmp = sa.trace_analytic_ignore_point_light(
            origin, ldir, scene.params, scene.point_light_pos)
        blocked = tmp.valid & (tmp.t < win)
    # intensity / d2 as a host intensity divides: the reciprocal times it
    li = (scene.params["point_light_color"]
          * (torch.reciprocal(torch.clamp_min(dist2, 1e-4))
             * scene.params["point_light_intensity"])[..., None])
    spec = torch.where(mat.mtype == MTYPE_DIFFUSE, mat.spec_strength, 0.0)
    out = shade_lambert_phong(n, v, l, li, mat.albedo, spec, mat.gloss)
    ok = (dist2 > 1e-6) & (ndl > 0.0) & ~blocked
    return torch.where(ok[..., None], out, 0.0)


def _disk_offsets(rng_frame: Frame, frame_index: Frame, px, py):
    """The per-pixel unit-disk offsets (dx, dy) of the disk-light samples
    (reference: rt_lighting.glsl:359-371)."""
    rot_x, rot_y = cp_offset(px, py, frame_index)
    offs = []
    for i in range(SOFT_SHADOW_SAMPLES):
        ux = rand(px + float(i), py + float(i), rng_frame)
        off = float(31 * i + 7)
        uy = rand(py + off, px + off, rng_frame)
        ux = torch.remainder(ux + rot_x, 1.0)
        uy = torch.remainder(uy + rot_y, 1.0)
        offs.append(concentric_sample(ux, uy))
    return offs


def _disk_points(offs, device):
    """The world-space disk-light points of the unit-disk offsets
    (reference: rt_lighting.glsl:359-371)."""
    center = const3(LIGHT_CENTER, device)
    t_axis = const3(LIGHT_T, device)
    b_axis = const3(LIGHT_B, device)
    return [center + t_axis * (dx * LIGHT_RADIUS)[..., None]
            + b_axis * (dy * LIGHT_RADIUS)[..., None] for dx, dy in offs]


def _disk_light_sum(h, n, v, albedo, spec_strength, gloss, xls, occ_all):
    """Soft disk area light: SOFT_SHADOW_SAMPLES concentric samples with
    per-pixel CP rotation (reference: rt_lighting.glsl:355-387,414-445),
    given the sample points `xls` and their occlusion bits `occ_all`."""
    dev = h.t.device
    light_n = const3(-LIGHT_N, dev)
    light_c = const3(LIGHT_COLOR, dev)
    acc = torch.zeros(h.t.shape + (3,), device=dev)
    for i in range(SOFT_SHADOW_SAMPLES):
        delta = xls[i] - h.p
        l = normalize(delta)
        ndl = torch.clamp_min(dot(n, l), 0.0)
        cos_theta_l = torch.clamp_min(dot(light_n, l), 0.0)
        r2 = torch.clamp_min(dot(delta, delta), 1e-4)
        geom = ndl * cos_theta_l / r2
        vis = torch.where(occ_all[i], 0.0, 1.0)
        li = light_c * (geom * vis)[..., None]
        acc = acc + shade_lambert_phong(n, v, l, li, albedo, spec_strength,
                                        gloss)
    return acc / float(SOFT_SHADOW_SAMPLES)


def direct_light_plain(scene: SceneCtx, h, rng_frame: Frame,
                       frame_index: Frame, vdir, px, py):
    """Direct lighting, analytic scene (reference: rt_lighting.glsl:313-395):
    the plain version of the CUDA kernel behind `direct_light`, in plain
    PyTorch throughout (its traces and sky lookups too).

    Secondary-hit mirror/glass are approximated by environment
    reflections (no recursion), as in the reference."""
    params = scene.params
    n = normalize(h.n)
    mat = get_material(h.mat, params)
    v = normalize(vdir)

    # mirror-like secondary: tinted env reflection (rt_lighting.glsl:325-335)
    r = reflect(-v, n)
    env = sa.sky(r, params, scene.env_map)
    mirror_out = env * mat.albedo

    # glass-like secondary: env reflection + sky diffuse (.:337-350)
    glass_out = env * mat.albedo + sky_direct(scene, h, mat)

    # diffuse/phong: disk area light + hybrid lights (.:352-394); the four
    # disk occlusion queries trace as one batch
    xls = _disk_points(_disk_offsets(rng_frame, frame_index, px, py),
                       h.t.device)
    occ = occluded_toward(scene, h.p[None], torch.stack(xls))
    diff = _disk_light_sum(h, n, v, mat.albedo, mat.spec_strength,
                           mat.gloss, xls, occ)
    diff = diff + sun_direct(scene, h, mat, v)
    diff = diff + sky_direct(scene, h, mat)
    diff = diff + point_direct(scene, h, mat, v)

    return torch.where((mat.mtype == MTYPE_MIRROR)[..., None], mirror_out,
                       torch.where((mat.mtype == MTYPE_GLASS)[..., None],
                                   glass_out, diff))


def direct_light(scene: SceneCtx, h, rng_frame: Frame, frame_index: Frame,
                 vdir, px, py, active=None):
    """Direct lighting, analytic scene: the CUDA kernel for CUDA tensors,
    `direct_light_plain` for CPU tensors (ops/an_cuda.py).

    `active` (bool, shape of h.t) marks lanes whose radiance the caller
    keeps; values on the other lanes are unspecified (the kernel does no
    work there, the plain version computes every lane)."""
    from . import an_cuda
    return an_cuda.direct_light(scene, h, rng_frame, frame_index, vdir,
                                px, py, active)


def per_pixel(fn, *xs):
    """fn(*xs), `xs` broadcast to one shape.  Where every x is broadcast
    over a leading axis (the sample batch's shared hit), fn runs once a
    pixel, on the first sample's, and its result is broadcast over that
    axis in turn (a mask K3 then reads once a pixel)."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    xs = [x.expand(shape) for x in xs]
    if (len(shape) > 1 and shape[0] > 1
            and all(x.stride(0) == 0 for x in xs)):
        return fn(*(x[0] for x in xs)).expand(shape)
    return fn(*xs)


def and_lanes(*masks):
    """The lanes that every mask of `masks` (bool, None for every lane)
    keeps: None if all are None; once a pixel where they allow
    (`per_pixel`)."""
    masks = [m for m in masks if m is not None]
    if not masks:
        return None
    return per_pixel(lambda *ms: functools.reduce(operator.and_, ms),
                     *masks)


def direct_light_bvh(scene: SceneCtx, h, rng_frame: Frame, frame_index: Frame,
                     vdir, px, py, active=None, spp_dup: int = 0):
    """Direct lighting for BVH triangles: hard-coded white plastic
    (reference: rt_lighting.glsl:405-460).  The CUDA kernel for CUDA
    tensors (one launch, the shadow walks included), the plain
    `direct_light_bvh_plain` for CPU tensors (ops/an_cuda.py).

    `active` (bool, shape of h.t) marks lanes whose radiance the caller
    keeps; values on the other lanes are unspecified.

    `spp_dup` > 1 (the JAX package's argument): the inputs carry a leading
    sample axis of that length over which the hit, `vdir` and `active` are
    broadcast (the frame's shared primary hit).  The sun and point shadow
    rays depend on the hit alone, so they are traced once for all samples
    and their bits shared; the disk rays keep each sample's offsets.  The
    image is the same bits as six walks a sample."""
    from . import an_cuda
    return an_cuda.direct_light_bvh(scene, h, rng_frame, frame_index, vdir,
                                    px, py, active, spp_dup=spp_dup)


def _bvh_shadow_queries(scene: SceneCtx, h, n, offs, active=None):
    """(origins, dirs, windows) of the BVH direct light's shadow rays: the
    4 disk samples, then the sun and the point light where they are on.

    Inactive lanes get a collapsed window (-1), so they trace nothing and
    read "not occluded".  The ndl gate does the same for rays the
    reference never consumes (the surface faces away from the light:
    sunDirect and pointDirect return before the trace, and the disk loop
    multiplies vis by ndl*cosThetaL == 0), so it leaves the image
    unchanged and saves the rays."""
    params = scene.params
    light_n = const3(-LIGHT_N, h.t.device)
    origins, dirs, wins = [], [], []
    for xl in _disk_points(offs, h.t.device):
        o, d, w = _segment_shadow_query(h.p, xl)
        facing = (dot(n, d) > 0.0) & (dot(d, light_n) > 0.0)
        origins.append(o)
        dirs.append(d)
        wins.append(torch.where(facing, w, -1.0))
    if params.sun_enabled:
        o, d, w = _sun_shadow_query(scene, h, n)
        origins.append(o)
        dirs.append(d)
        wins.append(torch.where(dot(n, d) > 0.0, w, -1.0))
    if params.point_light_enabled:
        o, d, w = _point_shadow_query(scene, h)
        origins.append(o)
        dirs.append(d)
        wins.append(torch.where(dot(n, d) > 0.0, w, -1.0))
    if active is not None:
        wins = [torch.where(active, w, -1.0) for w in wins]
    return origins, dirs, wins


def direct_light_bvh_plain(scene: SceneCtx, h, rng_frame: Frame,
                           frame_index: Frame, vdir, px, py, active=None,
                           spp_dup: int = 0):
    """The plain version of the CUDA kernel behind `direct_light_bvh`:
    the shadow queries, traced as one stream by the plain any-hit walk
    (the wavefront form of the reference's six sequential shadow
    traces), then the BRDF sum over their occlusion bits.

    `spp_dup` > 1 as for `direct_light_bvh`, in the JAX package's form:
    the sun and point windows of samples 1.. collapse to -1 (those rays
    trace nothing), and sample 0's bits are broadcast to every sample."""
    n = normalize(h.n)
    v = normalize(vdir)
    offs = _disk_offsets(rng_frame, frame_index, px, py)
    origins, dirs, wins = _bvh_shadow_queries(scene, h, n, offs, active)
    shape = h.t.shape
    dup = spp_dup > 1
    if dup:
        if shape[0] != spp_dup:
            raise ValueError(f"spp_dup={spp_dup} needs a leading sample "
                             f"axis of that length, got shape "
                             f"{tuple(shape)}")
        first = (torch.arange(spp_dup, device=h.t.device) == 0).reshape(
            (spp_dup,) + (1,) * (len(shape) - 1))
        wins = (wins[:SOFT_SHADOW_SAMPLES]
                + [torch.where(first, w, -1.0)
                   for w in wins[SOFT_SHADOW_SAMPLES:]])
    occ = trace_bvh_shadow(
        scene.bvh.arrays,
        torch.cat([o.expand(shape + (3,)).reshape(-1, 3) for o in origins]),
        torch.cat([d.expand(shape + (3,)).reshape(-1, 3) for d in dirs]),
        torch.cat([w.expand(shape).reshape(-1) for w in wins]))
    occ = occ.reshape((len(wins),) + shape)
    if dup:
        # sample 0's sun and point bits are every sample's: the same rays
        occ = torch.cat([occ[:SOFT_SHADOW_SAMPLES],
                         occ[SOFT_SHADOW_SAMPLES:, :1].expand(
                             (len(wins) - SOFT_SHADOW_SAMPLES,) + shape)])
    return shade_bvh_brdf_plain(scene, h, n, v, offs, occ)


def shade_bvh_brdf_plain(scene: SceneCtx, h, n, v, offs, occ):
    """The BRDF tail of `direct_light_bvh` (reference:
    rt_lighting.glsl:414-460): the disk-light sum and the sun, sky and
    point terms of the white plastic, given the unit-disk offsets and the
    occlusion bits `occ` [k, ...] of the shadow wavefront (4 disk
    samples, then the sun and the point light where they are on)."""
    dev = h.t.device
    shape = h.t.shape
    params = scene.params
    albedo = const3(BVH_ALBEDO, dev).expand(shape + (3,))
    spec = torch.full(shape, BVH_SPEC_STRENGTH, device=dev)
    gloss = torch.full(shape, BVH_GLOSS, device=dev)
    k = SOFT_SHADOW_SAMPLES
    blocked_sun = blocked_point = None
    if params.sun_enabled:
        blocked_sun = occ[k]
        k += 1
    if params.point_light_enabled:
        blocked_point = occ[k]

    acc = _disk_light_sum(h, n, v, albedo, spec, gloss,
                          _disk_points(offs, dev), occ[:SOFT_SHADOW_SAMPLES])

    # "fake" analytic material for the hybrid lights (rt_lighting.glsl:448-453)
    fake = MaterialProps(albedo, spec, gloss,
                         torch.zeros(shape, dtype=torch.int32, device=dev),
                         torch.ones(shape, device=dev))
    acc = acc + sun_direct(scene, h, fake, v, blocked=blocked_sun)
    acc = acc + sky_direct(scene, h, fake)
    acc = acc + point_direct(scene, h, fake, v, blocked=blocked_point)
    return acc


class GlassRays(NamedTuple):
    """What glass's rays call gives its K3 calls and its mix: the
    reflected, straight and bent secondaries' hits (traced without the
    glass sphere) and views normalize(cam_pos - p2), the three skies (the
    reflected ray's, the straight ray's, the bent ray's), refract's k and
    cos_theta."""
    hits: tuple      # (Hit, Hit, Hit)
    views: tuple     # ([..., 3],) * 3
    skies: tuple     # ([..., 3],) * 3
    k: torch.Tensor
    cos_theta: torch.Tensor


class MirrorRay(NamedTuple):
    """What the mirror's ray call gives its K3 call and its mix: the
    reflected ray's hit against the whole scene, K3's view -r there, and
    the sky of r."""
    hit: Hit
    view: torch.Tensor
    sky: torch.Tensor


def _material(mat, h, params):
    """get_material of the hit's ids where the caller has none."""
    return get_material(h.mat, params) if mat is None else mat


def glass_rays_plain(scene: SceneCtx, h, wo, mat=None) -> GlassRays:
    """Thin glass up to its direct light (reference: rt_lighting.glsl:576-
    640): the setup, the three secondary rays traced without the glass
    sphere and the skies, on every lane; the plain version of the CUDA
    kernel behind `an_shade_cuda.glass_rays`.  `mat` is get_material of
    h.mat (None: looked up)."""
    params = scene.params
    mat = _material(mat, h, params)
    n = normalize(h.n)
    v = normalize(wo)
    i = -v
    ior = torch.clamp_min(mat.ior, 1.0001)
    eta = 1.0 / ior
    r = reflect(i, n)
    cos_theta = torch.clamp(dot(-i, n), 0.0, 1.0)
    t_phys, k = refract(i, n, eta)
    t_dir = normalize(mix(i, normalize(t_phys), GLASS_DISTORTION_STRENGTH))
    # misses are not sanitized: their p is ro + d * INF, and the garbage
    # lit there is dropped by the mix's valid selects
    hits = tuple(sa.trace_analytic_ignore_glass(h.p + d * EPS, d, params,
                                                scene.point_light_pos)
                 for d in (r, i, t_dir))
    views = tuple(normalize(scene.cam_pos - h2.p) for h2 in hits)
    skies = tuple(sa.sky(d, params, scene.env_map) for d in (r, i, t_dir))
    return GlassRays(hits, views, skies, k, cos_theta)


def glass_mix_plain(scene: SceneCtx, h, mat, rays: GlassRays, lit):
    """Thin glass after its direct light (reference: rt_lighting.glsl:641-
    663): the Fresnel mix of (env + local reflection) and (straight-through
    + softened bent refraction), given the rays call's `rays` and the
    direct light `lit` at its three hits; on every lane, the plain version
    of the CUDA kernel behind `an_shade_cuda.glass_mix`."""
    mat = _material(mat, h, scene.params)
    reflect_env, straight_sky, bent_sky = rays.skies
    refl_valid, str_valid, bent_valid = (h2.valid for h2 in rays.hits)
    refl_lit, straight_lit, bent_lit = lit
    k = rays.k

    # Reflection: env + local
    reflect_local = torch.where(refl_valid[..., None], refl_lit, reflect_env)
    reflect_col = mix(reflect_env, reflect_local, GLASS_LOCAL_REFL_WEIGHT)

    # Straight-through
    straight_col = torch.where(str_valid[..., None], straight_lit,
                               straight_sky)

    # Bent refraction, softened toward straight-through
    bent_col = torch.where(bent_valid[..., None], bent_lit, bent_sky)

    refr_col = torch.where((k > 0.0)[..., None],
                           mix(straight_col, bent_col,
                               GLASS_DISTORTION_STRENGTH),
                           straight_col)
    refr_col = refr_col * mat.albedo

    ior = torch.clamp_min(mat.ior, 1.0001)
    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * torch.pow(1.0 - rays.cos_theta, 5.0)
    return mix(refr_col, reflect_col, fresnel[..., None])


def shade_glass(scene: SceneCtx, h, wo, mat, seed: Frame, frame_index: Frame,
                px, py, active=None, out=None):
    """Thin-glass shading: Fresnel mix of (env + local reflection) and
    (straight-through + softened bent refraction)
    (reference: rt_lighting.glsl:576-663): the rays call (the setup, the
    three secondaries traced, the skies), the direct light at each
    secondary's valid hits, the mix call (an_shade_cuda).  `mat` is
    get_material of h.mat (None: looked up; the kernels read the table by
    h.mat).  `active` (bool, None: all) marks the lanes whose result the
    caller keeps: on the card the kernels and K3 compute those alone (the
    skies where the mix reads them), and the other lanes are unspecified.
    With `out` ([..., 3], the frame's radiance) the result is written into
    it on the `active` lanes, in place, and `out` is returned."""
    from . import an_shade_cuda
    rays = an_shade_cuda.glass_rays(scene, h, wo, mat, active)
    lit = [direct_light(scene, h2, seed, frame_index, v2, px, py,
                        and_lanes(h2.valid, active))
           for h2, v2 in zip(rays.hits, rays.views)]
    return an_shade_cuda.glass_mix(scene, h, mat, rays, lit,
                                   active=active, out=out)


def gi_bounce_analytic_plain(scene: SceneCtx, h0, rng_frame: Frame,
                             seed: Frame, px, py):
    """The analytic GI bounce ray at each hit of `h0` and its closest hit
    against the whole scene (reference: rt_lighting.glsl:473-490): (Hit,
    wi, cos_theta), the rand pair at offsets seed*13 and seed*37; the
    plain version of the CUDA kernel behind `an_trace_cuda.bounce`, on
    every lane.  A sampled `seed` draws each sample's ray over the
    batch's leading sample axis."""
    n0 = normalize(h0.n)
    so, so2 = frame_f32(seed * 13), frame_f32(seed * 37)
    ux = rand(px + so, py + so, rng_frame)
    uy = rand(py + so2, px + so2, rng_frame)
    wi = sample_hemisphere_cosine(n0, ux, uy)
    cos_theta = torch.clamp_min(dot(n0, wi), 0.0)
    h1 = sa.trace_analytic(h0.p + n0 * EPS, wi, scene.params,
                           scene.point_light_pos)
    return h1, wi, cos_theta


class GiLight(NamedTuple):
    """GI's bounce at hits h0 before its tail: the bounce's hit, its
    cos_theta, the direct light at its valid hits and the sky where it
    missed."""
    hit: Hit
    cos_theta: torch.Tensor
    lit: torch.Tensor
    sky: torch.Tensor


def gi_light_analytic(scene: SceneCtx, h0, rng_frame: Frame, seed: Frame,
                      frame_index: Frame, px, py, active=None) -> GiLight:
    """One cosine-weighted bounce and the light it brings back, untailed
    (reference: rt_lighting.glsl:473-500).  `active` (bool, None: all)
    marks the lanes the caller keeps: the bounce is sampled and traced on
    those alone (`an_trace_cuda.bounce`: the kernel on the card, its plain
    version on every lane on the CPU), the direct light computed on its
    valid hits among them and the sky looked up where it missed.  The
    bounce hits go to `direct_light` unsanitized (misses have p = o + wi *
    1e30); the tail's valid select drops whatever is lit there.  The other
    lanes are unspecified."""
    from . import an_trace_cuda
    h1, wi, cos_theta = an_trace_cuda.bounce(scene, h0, rng_frame, seed, px,
                                             py, active)
    li_hit = direct_light(scene, h1, rng_frame, frame_index, -wi, px, py,
                          and_lanes(h1.valid, active))
    sky = scene.sky(wi, and_lanes(active, ~h1.valid))
    return GiLight(h1, cos_theta, li_hit, sky)


def gi_tail_analytic(scene: SceneCtx, h0, gi: GiLight):
    """GI's tail at hits h0 (reference: rt_lighting.glsl:500-507): the
    bounce's valid select against its sky, albedo * cos / PI * li, and
    the cos > 0 select."""
    mat0 = get_material(h0.mat, scene.params)
    li = torch.where(gi.hit.valid[..., None], gi.lit, gi.sky)
    out = mat0.albedo * (gi.cos_theta / PI)[..., None] * li
    return torch.where((gi.cos_theta > 0.0)[..., None], out, 0.0)


def one_bounce_gi_analytic(scene: SceneCtx, h0, rng_frame: Frame, seed: Frame,
                           frame_index: Frame, px, py, active=None):
    """One cosine-weighted bounce + direct light at the secondary hit
    (reference: rt_lighting.glsl:473-507): `gi_light_analytic`, then its
    tail in PyTorch over every lane.  `active` as for
    `gi_light_analytic`; the other lanes are unspecified."""
    return gi_tail_analytic(scene, h0, gi_light_analytic(
        scene, h0, rng_frame, seed, frame_index, px, py, active))


def an_hit_mix_plain(scene: SceneCtx, h, radiance, gi: GiLight = None,
                     ao=None):
    """The rest of the analytic scene's shading after the direct light at
    hits `h`, dense over every lane (reference: rt.frag:119-148): with
    `gi`, GI's tail times gi_scale_analytic added to the direct light
    `radiance`; with `ao`, the product with it; the point-light marker's
    emissive where h.mat is the marker.  The plain version of the CUDA
    kernel behind `hit_mix_cuda.an_hit_mix`, in plain PyTorch."""
    params = scene.params
    if gi is not None:
        radiance = radiance + gi_tail_analytic(scene, h, gi) \
            * params["gi_scale_analytic"]
    if ao is not None:
        radiance = radiance * ao[..., None]
    # emissive point-light marker (reference: rt.frag:137-148)
    base_col = params["point_light_color"] * params["point_light_intensity"]
    d = length(h.p - scene.cam_pos)
    falloff = 1.0 / torch.clamp_min(d * d * 0.25 + 1.0, 1.0)
    emissive = base_col * falloff[..., None]
    is_marker = h.mat == MAT_POINTLIGHT_SPHERE
    return torch.where(is_marker[..., None], emissive, radiance)


def an_mix_lanes(mat_id, params):
    """The lanes `an_hit_mix` writes, of hits with material ids `mat_id`:
    the marker's and those of get_material's diffuse type (the mirror's and
    glass's are their mix kernels'); once a pixel where `mat_id` allows
    (`per_pixel`)."""
    return per_pixel(lambda m: (m == MAT_POINTLIGHT_SPHERE)
                     | (material_type(m, params) == MTYPE_DIFFUSE), mat_id)


def _bounce_ray(h0, rng_frame: Frame, seed: Frame, px, py):
    """(origin, wi, cos_theta) of the BVH GI bounce ray: a cosine-
    hemisphere sample around the hit normal from the rand pair at offsets
    seed*19 and seed*41 (reference: rt_lighting.glsl:515-527)."""
    so, so2 = frame_f32(seed * 19), frame_f32(seed * 41)
    ux = rand(px + so, py + so, rng_frame)
    uy = rand(py + so2, px + so2, rng_frame)
    n0 = normalize(h0.n)
    wi = sample_hemisphere_cosine(n0, ux, uy)
    return h0.p + n0 * EPS, wi, torch.clamp_min(dot(n0, wi), 0.0)


def gi_bounce_plain(bvh, h0, rng_frame: Frame, seed: Frame, px, py,
                    active=None):
    """GI's bounce ray at each hit of `h0` and its closest hit (reference:
    rt_lighting.glsl:515-530): (Hit, wi, cos_theta), the plain version of
    the CUDA kernel behind `bvh_cuda.trace_bounce`.  Lanes where `active`
    is False do not walk and read as misses.  A sampled `seed` draws each
    sample's ray over the batch's leading sample axis."""
    origin, wi, cos_theta = _bounce_ray(h0, rng_frame, seed, px, py)
    return trace_bvh(bvh, origin, wi, active=active), wi, cos_theta


class GiLightBvh(NamedTuple):
    """The BVH GI bounce at hits h0 before its tail: the bounce's hit, its
    direction and cos_theta, and the direct light at its valid hits (the
    sky where it missed is the tail's)."""
    hit: Hit
    wi: torch.Tensor
    cos_theta: torch.Tensor
    lit: torch.Tensor


def gi_light_bvh(scene: SceneCtx, h0, rng_frame: Frame, seed: Frame,
                 frame_index: Frame, px, py, active=None) -> GiLightBvh:
    """One cosine-weighted bounce and the direct light at its hits,
    untailed (reference: rt_lighting.glsl:515-530).  Inactive lanes (sky
    pixels) do not walk the bounce ray and read as misses, so their
    secondary lighting traces nothing.  The bounce hits reach
    `direct_light_bvh` unsanitized (misses have p = o + wi * 1e30): its
    windows are collapsed there, and the tail's valid select drops the
    radiance lit on them."""
    h1, wi, cos_theta = bvh_cuda.trace_bounce(scene.bvh.arrays, h0,
                                              rng_frame, seed, px, py,
                                              active)
    li_hit = direct_light_bvh(scene, h1, rng_frame, frame_index, -wi, px, py,
                              active=h1.valid)
    return GiLightBvh(h1, wi, cos_theta, li_hit)


def gi_tail_bvh(gi: GiLightBvh, sky):
    """GI's tail (reference: rt_lighting.glsl:530-561), given the sky `sky`
    of gi.wi where the bounce missed: the valid select, albedo * cos / PI
    * li, the firefly luminance clamp and the grazing-angle cut."""
    dev = gi.cos_theta.device
    li = torch.where(gi.hit.valid[..., None], gi.lit, sky)
    contrib = const3(BVH_ALBEDO, dev) * (gi.cos_theta / PI)[..., None] * li
    lum = dot(contrib, const3(YCOEFF, dev))
    scale = torch.where(lum > GI_MAX_LUM,
                        GI_MAX_LUM / torch.clamp_min(lum, 1e-6), 1.0)
    contrib = contrib * scale[..., None]
    return torch.where((gi.cos_theta > GI_MIN_COS_THETA)[..., None], contrib,
                       0.0)


def one_bounce_gi_bvh(scene: SceneCtx, h0, rng_frame: Frame, seed: Frame,
                      frame_index: Frame, px, py, active=None):
    """BVH GI with grazing-angle cut and firefly luminance clamp
    (reference: rt_lighting.glsl:515-561): `gi_light_bvh`, then its tail
    in PyTorch over every lane, the sky looked up on every lane.  Values
    on lanes where `active` is False are unspecified.  The frame runs the
    tail on its hit lanes alone (`bvh_hit_mix_plain`, the kernel behind
    ops/hit_mix_cuda.py)."""
    gi = gi_light_bvh(scene, h0, rng_frame, seed, frame_index, px, py,
                      active)
    return gi_tail_bvh(gi, scene.sky(gi.wi))


def bvh_hit_mix_plain(scene: SceneCtx, radiance, gi: GiLightBvh = None,
                      ao=None):
    """The rest of the BVH scene's shading after its direct light, dense
    over every lane (reference: rt.frag:105-117): with `gi`, GI's tail
    (the sky of its direction where the bounce missed) times gi_scale_bvh
    added to the direct light `radiance`; with `ao`, the product with it.
    The plain version of the CUDA kernel behind
    `hit_mix_cuda.bvh_hit_mix`, in plain PyTorch."""
    params = scene.params
    if gi is not None:
        sky = sa.sky(gi.wi, params, scene.env_map)
        radiance = radiance + gi_tail_bvh(gi, sky) * params["gi_scale_bvh"]
    if ao is not None:
        radiance = radiance * ao[..., None]
    return radiance


def mirror_ray_plain(scene: SceneCtx, h, wo) -> MirrorRay:
    """The perfect mirror up to its direct light (reference:
    rt_lighting.glsl:675-690): the reflected ray traced through the whole
    scene, K3's view -r at its hit and the sky of r, on every lane; the
    plain version of the CUDA kernel behind `an_shade_cuda.mirror_ray`."""
    n = normalize(h.n)
    i = -normalize(wo)
    r = reflect(i, n)
    h2 = sa.trace_analytic(h.p + r * EPS, r, scene.params,
                           scene.point_light_pos)
    return MirrorRay(h2, -r, sa.sky(r, scene.params, scene.env_map))


def mirror_mix_plain(scene: SceneCtx, h, mat, ray: MirrorRay, direct,
                     gi: GiLight = None):
    """The perfect mirror after its direct light (reference:
    rt_lighting.glsl:690-708): with `gi` (GI's light at the reflected
    hit), its tail times gi_scale_analytic added to the direct light
    `direct`; the valid select against the sky and the mirror's albedo.
    On every lane, the plain version of the CUDA kernel behind
    `an_shade_cuda.mirror_mix`."""
    mat = _material(mat, h, scene.params)
    col_hit = direct
    if gi is not None:
        col_hit = col_hit + gi_tail_analytic(scene, ray.hit, gi) \
            * scene.params["gi_scale_analytic"]
    col = torch.where(ray.hit.valid[..., None], col_hit, ray.sky)
    return col * mat.albedo


def shade_mirror(scene: SceneCtx, h, wo, mat, seed: Frame, frame_index: Frame,
                 px, py, active=None, out=None):
    """Perfect mirror: one reflected trace + direct light (+ GI when it is
    on) at the reflected hit (reference: rt_lighting.glsl:675-708): the ray
    call (the trace, the sky where it missed), the direct light at its
    valid hits, GI's light there, the mix call (an_shade_cuda).  `mat`,
    `active` and `out` as for `shade_glass`."""
    from . import an_shade_cuda
    ray = an_shade_cuda.mirror_ray(scene, h, wo, active)
    lanes = and_lanes(ray.hit.valid, active)
    direct = direct_light(scene, ray.hit, seed, frame_index, ray.view, px,
                          py, lanes)
    gi = None
    if scene.params.enable_gi:
        # the GLSL call passes the mirror's seed as the bounce's rng frame
        # and a derived seed for its sample offsets
        gi = gi_light_analytic(scene, ray.hit, seed, seed * 131 + 17,
                               frame_index, px, py, lanes)
    return an_shade_cuda.mirror_mix(scene, h, mat, ray, direct, gi,
                                    active=active, out=out)


def _ao_rays(h, frame_index: Frame, px, py, params):
    """(origin, [direction] * ao_samples) of the AO hemisphere rays
    (reference: rt_lighting.glsl:721-744)."""
    params = bind(params, h.t.device)
    n = normalize(h.n)
    dirs = []
    for i in range(params.ao_samples):
        o1, o2 = float(37 * i + 3), float(19 * i + 11)
        ux = rand(px + o1, py + o1, frame_index)
        uy = rand(py + o2, px + o2, frame_index)
        dirs.append(sample_hemisphere_cosine(n, ux, uy))
    return h.p + n * params["ao_bias"], dirs


def _ao_value(occ, params):
    """The occlusion bits [ao_samples, ...] remapped to [ao_min, 1]
    (reference: rt_lighting.glsl:745-757)."""
    params = bind(params, occ.device)
    occluded = occ.to(torch.float32).sum(0)
    ao_min = params["ao_min"]
    ao = 1.0 - occluded / float(params.ao_samples)
    return torch.clamp_max(torch.clamp_min(ao_min + params["ao_span"] * ao,
                                           ao_min), 1.0)


def ambient_occlusion_plain(bvh, h, frame_index: Frame, px, py, params,
                            active=None):
    """BVH ambient occlusion: the plain version of the CUDA kernel behind
    `bvh_cuda.ambient_occlusion`.  The `ao_samples` hemisphere batches
    share one origin and one `ao_radius` window and trace as one stream
    of the plain any-hit walk (boolean-identical to the reference's
    closest hit within the radius); lanes where `active` is False count
    no occluder."""
    params = bind(params, h.t.device)
    org, dirs = _ao_rays(h, frame_index, px, py, params)
    shape = h.t.shape
    win = params["ao_radius"].expand(shape)
    occ = trace_bvh_shadow(
        bvh, torch.cat([org.expand(shape + (3,)).reshape(-1, 3)] * len(dirs)),
        torch.cat([d.expand(shape + (3,)).reshape(-1, 3) for d in dirs]),
        torch.cat([win.reshape(-1)] * len(dirs)))
    occ = occ.reshape((len(dirs),) + shape)
    if active is not None:
        occ = occ & active
    return _ao_value(occ, params)


def ambient_occlusion_analytic_plain(scene: SceneCtx, h, frame_index: Frame,
                                     px, py):
    """Analytic ambient occlusion: the `ao_samples` hemisphere rays traced
    as one batched closest-hit trace, counting hits with t < ao_radius,
    remapped (reference: rt_lighting.glsl:721-757); the plain version of
    the CUDA kernel behind `an_trace_cuda.ambient_occlusion`, on every
    lane."""
    params = scene.params
    org, dirs = _ao_rays(h, frame_index, px, py, params)
    hits = sa.trace_analytic(org[None], torch.stack(dirs), params,
                             scene.point_light_pos)
    return _ao_value(hits.valid & (hits.t < params["ao_radius"]), params)


def compute_ao(scene: SceneCtx, h, frame_index: Frame, px, py, active=None):
    """Cosine-hemisphere ambient occlusion, radius-limited, remapped to
    [ao_min, 1] (reference: rt_lighting.glsl:721-757): the CUDA kernel on
    the card, the plain version on the CPU, for either scene
    (`bvh_cuda.ambient_occlusion`, `an_trace_cuda.ambient_occlusion`).
    Values on lanes where `active` is False are unspecified."""
    from . import an_trace_cuda
    if scene.use_bvh:
        return bvh_cuda.ambient_occlusion(scene.bvh.arrays, h, frame_index,
                                          px, py, scene.params, active)
    return an_trace_cuda.ambient_occlusion(scene, h, frame_index, px, py,
                                           active)
