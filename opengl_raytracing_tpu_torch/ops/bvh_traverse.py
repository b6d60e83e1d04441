"""BVH traversal in plain PyTorch: the stackless skip-link walk per ray.

Counterpart of `opengl_raytracing_tpu/ops/bvh_traverse.py` and the plain
version of the two CUDA kernels in csrc/bvh_trace.cu (ops/bvh_cuda.py
launches those for CUDA tensors).  Nodes are in DFS preorder with skip
links (scene/bvh.py), so a ray's traversal state is one cursor:

    cur = (aabb_hit and inner) ? cur + 1 : skip[cur]

The batch advances one node per iteration of a Python `while` loop that
runs while any cursor is below n_nodes; leaf triangle tests run up to
LEAF_MAX with masks.  The hit rules are the JAX walker's, step for step:
slab test with tmin >= 0 and `tmin <= t_best` pruning, Moller-Trumbore
with the `t >= eps & t <= t_best` window (a later triangle wins an exact
tie), and `_safe_inv`.

Unlike the JAX walker, which carries finished lanes through every step,
this one drops a lane from the working set as soon as its cursor leaves
the tree.  Per-ray arithmetic is unchanged; only the wasted work goes.
"""

from __future__ import annotations

import torch

from ..constants import EPS, INF
from ..scene.bvh import BVHArrays, LEAF_MAX
from .intersect import intersect_aabb, intersect_triangle
from .scene_analytic import Hit
from .vecmath import normalize


def _safe_inv(rd):
    # GLSL computes 1.0/rd and relies on IEEE inf; keep that behavior but
    # avoid 0/0 NaNs by nudging exact zeros.
    return 1.0 / torch.where(rd == 0.0, 1e-30, rd)


def _flat_rays(ro, rd, *extra):
    shape = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1],
                                   *(e.shape for e in extra))
    flat = [ro.expand(shape + (3,)).reshape(-1, 3),
            rd.expand(shape + (3,)).reshape(-1, 3)]
    flat += [e.expand(shape).reshape(-1) for e in extra]
    return shape, flat


def _leaf_rows(tris, first, j):
    """(v0, e1, e2) of triangle first + j, clamped into the array like
    the JAX walker's gather (lanes past a leaf's count are masked)."""
    tri = tris[torch.clamp(first + j, max=tris.shape[0] - 1)]
    return tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]


def _finalize(shape, ro, rd, t_best, n_best) -> Hit:
    t_best = t_best.reshape(shape)
    n_best = n_best.reshape(shape + (3,))
    hit = t_best < INF
    n = torch.where(hit[..., None], normalize(n_best), 0.0)
    ro = ro.expand(shape + (3,))
    return Hit(t_best, ro + rd * t_best[..., None], n,
               torch.ones(shape, dtype=torch.int32, device=ro.device))


def _count(counts, lane, count, li):
    """Add one step's node visits and its leaf lanes' triangle tests to
    `counts`."""
    if counts is not None:
        counts["nodes"] += lane.numel()
        counts["tris"] += int(count[li].clamp(max=LEAF_MAX).sum())


def trace_bvh(bvh: BVHArrays, ro, rd, eps: float = EPS,
              active=None, counts=None) -> Hit:
    """Closest-hit traversal (reference: shaders/rt/rt_bvh.glsl:193-243).

    bvh: BVHArrays of tensors on the rays' device; ro/rd [...,3].
    Returns Hit with mat=1 (triangles shade as diffuse).  Lanes where
    `active` (bool, the rays' shape) is False do not walk and read as
    misses.  `counts` (a dict with "nodes" and "tris", optional) gets the
    walk's node visits and triangle tests added.
    """
    bounds, meta, tris = bvh.bounds, bvh.meta.long(), bvh.tris
    n_nodes = bounds.shape[0]
    shape, (o, d) = _flat_rays(ro, rd)
    dev = o.device
    n_rays = o.shape[0]
    t_out = torch.full((n_rays,), INF, dtype=torch.float32, device=dev)
    n_out = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)

    # working set: the lanes whose cursor is still inside the tree
    lane = torch.arange(n_rays, device=dev)
    if active is not None:
        lane = lane[active.expand(shape).reshape(-1)]
        o, d = o[lane], d[lane]
    inv = _safe_inv(d)
    cur = torch.zeros(lane.numel(), dtype=torch.int64, device=dev)
    t_best = torch.full_like(cur, INF, dtype=torch.float32)
    n_best = torch.zeros((lane.numel(), 3), dtype=torch.float32, device=dev)
    while lane.numel():  # == (cur < n_nodes).any() over all rays
        b = bounds[cur]
        m = meta[cur]
        count = m[:, 2]
        tmin, _, bhit = intersect_aabb(o, inv, b[:, 0:3], b[:, 3:6])
        bhit = bhit & (tmin <= t_best)      # t-pruning, rt_bvh.glsl:208
        li = (bhit & (count > 0)).nonzero().squeeze(1)
        _count(counts, lane, count, li)
        if li.numel():
            lo, ld, lt, ln = o[li], d[li], t_best[li], n_best[li]
            first, cnt = m[li, 1], count[li]
            for j in range(min(int(cnt.max()), LEAF_MAX)):
                v0, e1, e2 = _leaf_rows(tris, first, j)
                t, cr, v = intersect_triangle(lo, ld, v0, e1, e2, lt, eps)
                upd = (j < cnt) & v
                lt = torch.where(upd, t, lt)
                ln = torch.where(upd[:, None], cr, ln)
            t_best[li] = lt
            n_best[li] = ln
        cur = torch.where(bhit & (count == 0), cur + 1, m[:, 0])
        done = cur >= n_nodes
        if done.any():
            t_out[lane[done]] = t_best[done]
            n_out[lane[done]] = n_best[done]
            keep = ~done
            lane, o, d, inv, cur, t_best, n_best = (
                x[keep] for x in (lane, o, d, inv, cur, t_best, n_best))
    return _finalize(shape, ro, rd.expand(shape + (3,)), t_out, n_out)


def trace_bvh_shadow(bvh: BVHArrays, ro, rd, t_max, eps: float = EPS,
                     counts=None):
    """Any-hit traversal with early out
    (reference: shaders/rt/rt_bvh.glsl:260-304).  Returns a bool mask:
    an occluder with t in [eps, t_max].  A window <= 0 finds nothing.
    `counts` as for trace_bvh (a leaf that occludes counts all its
    triangles)."""
    bounds, meta, tris = bvh.bounds, bvh.meta.long(), bvh.tris
    n_nodes = bounds.shape[0]
    shape, (o, d, tm) = _flat_rays(ro, rd, t_max)
    dev = o.device
    n_rays = o.shape[0]
    occ_out = torch.zeros(n_rays, dtype=torch.bool, device=dev)

    lane = torch.arange(n_rays, device=dev)
    inv = _safe_inv(d)
    cur = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    while lane.numel():  # == ((cur < n_nodes) & ~occ).any() over all rays
        b = bounds[cur]
        m = meta[cur]
        count = m[:, 2]
        tmin, _, bhit = intersect_aabb(o, inv, b[:, 0:3], b[:, 3:6])
        bhit = bhit & (tmin <= tm)
        occ = torch.zeros_like(bhit)
        li = (bhit & (count > 0)).nonzero().squeeze(1)
        _count(counts, lane, count, li)
        if li.numel():
            lo, ld, lt = o[li], d[li], tm[li]
            first, cnt = m[li, 1], count[li]
            lo_occ = torch.zeros_like(lt, dtype=torch.bool)
            for j in range(min(int(cnt.max()), LEAF_MAX)):
                v0, e1, e2 = _leaf_rows(tris, first, j)
                _, _, v = intersect_triangle(lo, ld, v0, e1, e2, lt, eps)
                lo_occ = lo_occ | ((j < cnt) & v)
            occ[li] = lo_occ
        cur = torch.where(bhit & (count == 0), cur + 1, m[:, 0])
        done = occ | (cur >= n_nodes)
        if done.any():
            occ_out[lane[occ]] = True
            keep = ~done
            lane, o, d, inv, cur, tm = (
                x[keep] for x in (lane, o, d, inv, cur, tm))
    return occ_out.reshape(shape)


def trace_brute(tris, ro, rd, eps: float = EPS) -> Hit:
    """Brute-force closest hit over all triangles [T,>=9] — the oracle the
    BVH walk is checked against in tests."""
    shape, (o, d) = _flat_rays(ro, rd)
    t_best = torch.full((o.shape[0],), INF, dtype=torch.float32,
                        device=o.device)
    n_best = torch.zeros_like(o)
    for k in range(tris.shape[0]):
        v0, e1, e2 = tris[k, 0:3], tris[k, 3:6], tris[k, 6:9]
        t, cr, v = intersect_triangle(o, d, v0, e1, e2, t_best, eps)
        t_best = torch.where(v, t, t_best)
        n_best = torch.where(v[:, None], cr, n_best)
    return _finalize(shape, ro, rd.expand(shape + (3,)), t_best, n_best)
