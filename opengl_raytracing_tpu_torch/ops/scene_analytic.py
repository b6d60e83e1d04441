"""The analytic scene, the hit payload and the sky (PyTorch).

Counterpart of `opengl_raytracing_tpu/ops/scene_analytic.py` (reference:
shaders/rt/rt_common.glsl:39-44, rt_scene_analytic.glsl:132-223).  The
GLSL per-fragment if-chains become closest-hit where-selects over the
batch: every primitive is tested for every ray.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import (EPS, INF, FLOOR_NORMAL, FLOOR_D, SPHERE_LEFT_CENTER,
                         SPHERE_LEFT_RADIUS, GLASS_CENTER, GLASS_RADIUS,
                         MIRROR_CENTER, MIRROR_RADIUS,
                         POINT_LIGHT_MARKER_RADIUS, MAT_FLOOR,
                         MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE,
                         MAT_MIRROR_SPHERE, MAT_POINTLIGHT_SPHERE)
from ..params import RenderParams, bind
from .cubemap import sample_cubemap
from .intersect import intersect_plane, intersect_sphere
from .vecmath import const3, mix, normalize


class Hit(NamedTuple):
    """Hit payload (reference: shaders/rt/rt_common.glsl:39-44)."""
    t: torch.Tensor    # [...]; INF (1e30, finite) on a miss
    p: torch.Tensor    # [..., 3]
    n: torch.Tensor    # [..., 3]
    mat: torch.Tensor  # [...] int32

    @property
    def valid(self):
        return self.t < INF


def trace_analytic_core(ro, rd, params: RenderParams, point_light_pos,
                        include_glass: bool, include_point_light: bool,
                        eps: float = EPS) -> Hit:
    """Closest hit against the floor, the three spheres and, when the
    point light is on, its marker (reference:
    rt_scene_analytic.glsl:132-167).  On a miss t = INF and
    p = ro + rd * INF."""
    dev = rd.device
    shape = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    best = (torch.full(shape, INF, dtype=torch.float32, device=dev),
            torch.zeros(shape + (3,), dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev))

    def consider(t, valid, n, mat, best):
        bt, bn, bm = best
        closer = valid & (t < bt)
        return (torch.where(closer, t, bt),
                torch.where(closer[..., None], n, bn),
                torch.where(closer, mat, bm))

    floor_n = const3(FLOOR_NORMAL, dev)
    t, v = intersect_plane(ro, rd, floor_n, FLOOR_D, eps)
    best = consider(t, v, floor_n.expand(shape + (3,)), MAT_FLOOR, best)

    def sphere(c, radius, mat, best):
        t, v = intersect_sphere(ro, rd, c, radius, eps)
        n = normalize(ro + rd * t[..., None] - c)
        return consider(t, v, n, mat, best)

    best = sphere(const3(SPHERE_LEFT_CENTER, dev), SPHERE_LEFT_RADIUS,
                  MAT_ALBEDO_SPHERE, best)
    # The glass sphere is traced whenever include_glass, whatever the
    # material toggle: a disabled glass material shades as diffuse but
    # still occludes, as in traceAnalyticCore.
    if include_glass:
        best = sphere(const3(GLASS_CENTER, dev), GLASS_RADIUS,
                      MAT_GLASS_SPHERE, best)
    best = sphere(const3(MIRROR_CENTER, dev), MIRROR_RADIUS,
                  MAT_MIRROR_SPHERE, best)
    if include_point_light and params.point_light_enabled:
        best = sphere(point_light_pos, POINT_LIGHT_MARKER_RADIUS,
                      MAT_POINTLIGHT_SPHERE, best)
    bt, bn, bm = best
    return Hit(bt, ro + rd * bt[..., None], bn, bm)


def trace_analytic(ro, rd, params, point_light_pos, eps: float = EPS) -> Hit:
    """Full scene (reference: rt_scene_analytic.glsl:175-177)."""
    return trace_analytic_core(ro, rd, params, point_light_pos, True, True,
                               eps)


def trace_analytic_ignore_glass(ro, rd, params, point_light_pos,
                                eps: float = EPS) -> Hit:
    """Without the glass sphere, for refraction paths
    (reference: rt_scene_analytic.glsl:185-187)."""
    return trace_analytic_core(ro, rd, params, point_light_pos, False, True,
                               eps)


def trace_analytic_ignore_point_light(ro, rd, params, point_light_pos,
                                      eps: float = EPS) -> Hit:
    """Without the marker sphere, for shadow rays toward the bulb
    (reference: rt_scene_analytic.glsl:195-197)."""
    return trace_analytic_core(ro, rd, params, point_light_pos, True, False,
                               eps)


def sky(d, params, env_map=None):
    """Environment lookup: the cubemap if one is given and enabled, else
    the analytic gradient
    (reference: shaders/rt/rt_scene_analytic.glsl:211-223).  The
    intensity and the gradient's ends come from the parameter block."""
    p = bind(params, d.device)
    if p.enable_env_map and env_map is not None:
        return sample_cubemap(env_map, d) * p["env_map_intensity"]
    t = torch.clamp(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)
    return mix(p["sky_top"], p["sky_bottom"], (1.0 - t)[..., None])
