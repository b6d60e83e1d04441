"""Median-split BVH builder producing a preorder skip-link layout (numpy).

A copy of the numpy builder in `opengl_raytracing_tpu/scene/bvh.py`
(algorithm parity with reference: src/scene/bvh.cpp:41-137): recursive
median split on the longest AABB axis by centroid, leaf_max=8, each leaf's
triangles packed contiguously.  Nodes are in DFS preorder and each stores
a skip link (the preorder index after its subtree), so a ray's whole
traversal state is one int32 cursor:

    next = hit_and_inner ? i + 1 : skip[i]

That cursor is what the CUDA kernels walk, one thread per ray
(ops/bvh_cuda.py).  The tests hold this copy to the original exactly.

`build_bvh_fast` builds with the g++ library (native/), as the JAX
package's does: that tree is the one both packages render.  The two
builders split alike but may leave centroid ties in another order, so
their trees differ in node bounds and triangle order (not in the
triangle multiset or the node count); the numpy builder stands in only
where no g++ is on PATH.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from .. import native

LEAF_MAX = 8


@dataclasses.dataclass
class BVH:
    """Host-side BVH: structured arrays in preorder."""
    bmin: np.ndarray    # [N,3] f32
    bmax: np.ndarray    # [N,3] f32
    left: np.ndarray    # [N] i32 (-1 for leaf)
    right: np.ndarray   # [N] i32 (-1 for leaf)
    first: np.ndarray   # [N] i32 (leaf: base into remapped tris, else -1)
    count: np.ndarray   # [N] i32 (leaf: tri count, else 0)
    skip: np.ndarray    # [N] i32 (preorder index after this subtree; N = done)
    tris: np.ndarray    # [T,9] f32 — (v0, e1, e2) remapped per leaf

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tris.shape[0]


class BVHArrays(NamedTuple):
    """Packed BVH, numpy on the host or tensors on a device.

    bounds: [N,8] f32 — bmin.xyz, bmax.xyz, pad, pad
    meta:   [N,4] i32 — skip, first, count, pad
    tris:   [T,12] f32 — v0.xyz, e1.xyz, e2.xyz, pad3
    """
    bounds: np.ndarray
    meta: np.ndarray
    tris: np.ndarray


def _tri_bounds(tris: np.ndarray):
    """AABB + centroid per triangle from (v0,e1,e2) rows
    (reference: src/scene/bvh.cpp:10-26)."""
    v0 = tris[:, 0:3]
    v1 = v0 + tris[:, 3:6]
    v2 = v0 + tris[:, 6:9]
    tmin = np.minimum(v0, np.minimum(v1, v2))
    tmax = np.maximum(v0, np.maximum(v1, v2))
    cent = (v0 + v1 + v2) / 3.0
    return tmin, tmax, cent


def build_bvh(tris: np.ndarray, leaf_max: int = LEAF_MAX) -> BVH:
    """Build the preorder skip-link BVH over tris [T,9] float32."""
    tris = np.ascontiguousarray(tris, np.float32)
    n_tris = tris.shape[0]
    if n_tris == 0:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        return BVH(z3, z3, zi, zi, zi, zi, zi, tris)

    tmin, tmax, cent = _tri_bounds(tris)
    order = np.arange(n_tris, dtype=np.int64)

    bmin_l, bmax_l = [], []
    left_l, right_l, first_l, count_l = [], [], [], []
    remapped: list[np.ndarray] = []
    remap_cursor = 0

    # Iterative preorder build: stack of (begin, end, parent_slot).
    # parent_slot: (+idx) fills left child of idx, (-idx-1) fills right.
    stack = [(0, n_tris, None)]
    while stack:
        begin, end, pslot = stack.pop()
        seg = order[begin:end]
        me = len(bmin_l)
        bmin_l.append(tmin[seg].min(axis=0))
        bmax_l.append(tmax[seg].max(axis=0))
        left_l.append(-1)
        right_l.append(-1)
        first_l.append(-1)
        count_l.append(0)
        if pslot is not None:
            if pslot >= 0:
                left_l[pslot] = me
            else:
                right_l[-pslot - 1] = me

        count = end - begin
        if count <= leaf_max:
            remapped.append(tris[seg])
            first_l[me] = remap_cursor
            count_l[me] = count
            remap_cursor += count
            continue

        # Longest axis; x wins only if strictly larger
        # (reference: src/scene/bvh.cpp:72).  argpartition == nth_element.
        ext = bmax_l[me] - bmin_l[me]
        if ext[0] > ext[1]:
            axis = 0 if ext[0] > ext[2] else 2
        else:
            axis = 1 if ext[1] > ext[2] else 2
        mid = count // 2
        part = np.argpartition(cent[seg, axis], mid)
        order[begin:end] = seg[part]
        # Push right first so left is processed next (preorder, left-first).
        stack.append((begin + mid, end, -me - 1))
        stack.append((begin, begin + mid, me))

    n_nodes = len(bmin_l)
    left = np.asarray(left_l, np.int32)
    right = np.asarray(right_l, np.int32)
    count = np.asarray(count_l, np.int32)

    # Skip links: skip[root] = N; for inner i: skip[left]=right,
    # skip[right]=skip[i].  Preorder guarantees left == i+1.
    skip = np.full(n_nodes, n_nodes, np.int32)
    for i in range(n_nodes):
        if count[i] == 0 and left[i] >= 0:
            skip[left[i]] = right[i]
            skip[right[i]] = skip[i]

    return BVH(np.asarray(bmin_l, np.float32).reshape(n_nodes, 3),
               np.asarray(bmax_l, np.float32).reshape(n_nodes, 3),
               left, right, np.asarray(first_l, np.int32), count, skip,
               np.concatenate(remapped, axis=0).astype(np.float32))


def bvh_to_arrays(bvh: BVH) -> BVHArrays:
    """Pack a host BVH into the device layout."""
    n, t = bvh.n_nodes, bvh.n_tris
    bounds = np.zeros((max(n, 1), 8), np.float32)
    meta = np.zeros((max(n, 1), 4), np.int32)
    if n:
        bounds[:n, 0:3] = bvh.bmin
        bounds[:n, 3:6] = bvh.bmax
        meta[:n, 0] = bvh.skip
        meta[:n, 1] = bvh.first
        meta[:n, 2] = bvh.count
    else:
        meta[0, 0] = 1  # empty tree: immediately done
    tris = np.zeros((max(t, 1), 12), np.float32)
    if t:
        tris[:t, 0:9] = bvh.tris
    return BVHArrays(bounds, meta, tris)


def build_bvh_fast(tris: np.ndarray, leaf_max: int = LEAF_MAX) -> BVH:
    """Build with the native C++ builder (native/bvh_native.cpp, the JAX
    package's tree), or with the numpy builder where no g++ is on PATH."""
    result = native.build_bvh(tris, leaf_max)
    return result if result is not None else build_bvh(tris, leaf_max)


def validate_bvh(bvh: BVH, tris_original: np.ndarray) -> None:
    """Structural invariants (used by tests and chip_smoke.py).

    - every triangle appears exactly once across leaves
    - every leaf's triangles are inside the leaf AABB
    - child AABBs are inside parents; preorder + skip links consistent
    - the multiset of triangles is the input's
    """
    n = bvh.n_nodes
    seen = np.zeros(bvh.n_tris, bool)
    for i in range(n):
        if bvh.count[i] > 0:
            f, c = int(bvh.first[i]), int(bvh.count[i])
            assert not seen[f:f + c].any()
            seen[f:f + c] = True
            tmin, tmax, _ = _tri_bounds(bvh.tris[f:f + c])
            assert (tmin >= bvh.bmin[i] - 1e-4).all()
            assert (tmax <= bvh.bmax[i] + 1e-4).all()
        else:
            l, r = int(bvh.left[i]), int(bvh.right[i])
            assert l == i + 1, "preorder: left child must follow parent"
            assert (bvh.bmin[l] >= bvh.bmin[i] - 1e-5).all()
            assert (bvh.bmax[r] <= bvh.bmax[i] + 1e-5).all()
            assert bvh.skip[l] == r and bvh.skip[r] == bvh.skip[i]
    assert seen.all(), "triangle lost in remap"
    # Multiset of triangles preserved (orderless compare via sorted bytes).
    a = np.sort(bvh.tris.round(5).view([('', np.float32)] * 9), axis=0)
    b = np.sort(np.ascontiguousarray(tris_original, np.float32).round(5)
                .view([('', np.float32)] * 9), axis=0)
    assert (a == b).all()
