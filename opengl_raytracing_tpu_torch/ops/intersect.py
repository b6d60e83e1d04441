"""Ray vs plane, sphere, AABB and triangle, vectorized over ray batches.

Counterpart of `opengl_raytracing_tpu/ops/intersect.py` (reference:
shaders/rt/rt_scene_analytic.glsl:71-111, rt_bvh.glsl:124-170), written
exactly as there: the sphere's near/far root fallback, tmin clamped to
>= 0, |det| < 1e-8 rejected, the window `t >= eps & t <= t_max`, and the
raw cross(e1, e2) returned so callers normalise after the closest-hit
select.  csrc/bvh_trace.cu and csrc/an_direct.cu evaluate the same
expressions per thread.
"""

from __future__ import annotations

import torch

from ..constants import EPS
from .vecmath import cross, dot


def intersect_plane(ro, rd, n, d, eps: float = EPS):
    """Ray vs infinite plane dot(n,x)+d=0
    (reference: shaders/rt/rt_scene_analytic.glsl:71-81).

    Returns (t, valid); t is meaningless where ~valid."""
    denom = dot(rd, n)
    safe = torch.where(denom.abs() < 1e-6, 1.0, denom)
    t = -(dot(ro, n) + d) / safe
    valid = (denom.abs() >= 1e-6) & (t >= eps)
    return t, valid


def intersect_sphere(ro, rd, center, radius, eps: float = EPS):
    """Ray vs sphere, nearest positive root with the reference's
    front/back fallback (reference: rt_scene_analytic.glsl:96-111).

    Returns (t, valid)."""
    oc = ro - center
    b = dot(oc, rd)
    c2 = dot(oc, oc) - radius * radius
    disc = b * b - c2
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b - s
    t_far = -b + s
    t = torch.where(t_near < eps, t_far, t_near)
    valid = (disc >= 0.0) & (t >= eps)
    return t, valid


def intersect_aabb(ro, rd_inv, bmin, bmax):
    """Slab test (reference: shaders/rt/rt_bvh.glsl:124-134).

    Returns (tmin, tmax, hit) with tmin clamped to >= 0.
    """
    t0 = (bmin - ro) * rd_inv
    t1 = (bmax - ro) * rd_inv
    tsm = torch.minimum(t0, t1)
    tbg = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(tsm[..., 0], tsm[..., 1]),
                         torch.clamp_min(tsm[..., 2], 0.0))
    tmax = torch.minimum(torch.minimum(tbg[..., 0], tbg[..., 1]), tbg[..., 2])
    return tmin, tmax, tmax >= tmin


def intersect_triangle(ro, rd, v0, e1, e2, t_max, eps: float = EPS):
    """Moller-Trumbore with precomputed edges
    (reference: shaders/rt/rt_bvh.glsl:154-170).

    Returns (t, n_unnormalized_cross, valid).
    """
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    small = det.abs() < 1e-8
    inv_det = 1.0 / torch.where(small, 1.0, det)
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (~small
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t >= eps) & (t <= t_max))
    return t, cross(e1, e2), valid
