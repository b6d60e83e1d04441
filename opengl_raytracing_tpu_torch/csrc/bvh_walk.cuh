// Shared device code of the hand-written kernels: float3 arithmetic and
// the skip-link BVH walk's pieces (the tree's pointers, slab test,
// triangle fetch, Moller-Trumbore, the any-hit and closest-hit walks).
// Included by bvh_trace.cu (K1, the AO kernel) and an_direct.cu (the
// fused BVH direct light), so that every walk in the port is one piece of
// code and rounds the same way.
//
// The arithmetic is the plain PyTorch version's (ops/vecmath.py,
// ops/intersect.py, ops/bvh_traverse.py) expression for expression: dot
// and cross summed left to right, normalize as x / max(sqrt(max(d, 0)),
// 1e-12), the slab test with tmin clamped to >= 0, |det| < 1e-8 rejected,
// the window t >= eps && t <= t_max, 1/rd with exact zeros nudged to
// 1e-30.  Build with --fmad=false and without --use_fast_math.
//
// Node rows (BVHArrays): bounds [n_nodes, 8] = bmin.xyz, bmax.xyz, pad2;
// meta [n_nodes, 4] int32 = skip, first triangle, count (0: inner), pad;
// tris [n_tris, 12] = v0.xyz, e1.xyz, e2.xyz, pad3.  All 16-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr float kInf = 1e30f;
constexpr int kLeafMax = 8;

// The tree as the kernels take it (BVHArrays' device pointers).
struct Tree {
  const float4* bounds;
  const int4* meta;
  const float4* tris;
  int n_nodes;
};

inline Tree make_tree(const void* bounds, const void* meta, const void* tris,
                      int n_nodes) {
  return {(const float4*)bounds, (const int4*)meta, (const float4*)tris,
          n_nodes};
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}

// three read-only floats, and row i of a read-only [N, 3] array
__device__ __forceinline__ V3 ldg3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ V3 row3(const float* __restrict__ p, int64_t i) {
  return ldg3(p + 3 * i);
}

__device__ __forceinline__ V3 add3(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 mul3(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}

__device__ __forceinline__ V3 scale3(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// vecmath.normalize: x / max(length(x), 1e-12)
__device__ __forceinline__ V3 norm3(V3 a) {
  const float ln = fmaxf(sqrtf(fmaxf(dot3(a, a), 0.0f)), 1e-12f);
  return {a.x / ln, a.y / ln, a.z / ln};
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// Slab test against node `cur`.
__device__ __forceinline__ bool hit_box(const float4* __restrict__ bounds,
                                        int cur, V3 o, V3 inv, float t_lim) {
  const float4 b0 = __ldg(&bounds[2 * cur]);
  const float4 b1 = __ldg(&bounds[2 * cur + 1]);
  const float t0x = (b0.x - o.x) * inv.x, t1x = (b0.w - o.x) * inv.x;
  const float t0y = (b0.y - o.y) * inv.y, t1y = (b1.x - o.y) * inv.y;
  const float t0z = (b0.z - o.z) * inv.z, t1z = (b1.y - o.z) * inv.z;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.0f));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
  return tmax >= tmin && tmin <= t_lim;
}

struct Tri {
  V3 v0, e1, e2;
};

// A triangle row: three float4 loads.
__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris,
                                        int k) {
  const float4 a = __ldg(&tris[3 * k]);
  const float4 b = __ldg(&tris[3 * k + 1]);
  const float4 c = __ldg(&tris[3 * k + 2]);
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}};
}

// Moller-Trumbore as ops/intersect.py:intersect_triangle writes it.
__device__ __forceinline__ bool hit_tri(const Tri& tr, V3 o, V3 d,
                                        float t_max, float eps, float* t_out) {
  const V3 pvec = cross3(d, tr.e2);
  const float det = dot3(tr.e1, pvec);
  const bool small = fabsf(det) < 1e-8f;
  const float inv_det = 1.0f / (small ? 1.0f : det);
  const V3 tvec = sub3(o, tr.v0);
  const float u = dot3(tvec, pvec) * inv_det;
  const V3 qvec = cross3(tvec, tr.e1);
  const float v = dot3(d, qvec) * inv_det;
  const float t = dot3(tr.e2, qvec) * inv_det;
  *t_out = t;
  return !small && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= eps && t <= t_max;
}

// The any-hit and closest-hit walks take the "while-while" form (Aila
// and Laine, Understanding the efficiency of ray traversal on GPUs,
// 2009): a lane steps through inner nodes and missed boxes until it
// stands at a leaf whose box it hits, and only then tests the leaf's
// triangles.  A lane visits the nodes and tests the triangles in the
// plain walk's order, so it returns the plain walk's bits; and a warp's
// lanes reach the leaf loop together, instead of running it once for
// every step in which any one lane stands at a leaf.

// Any occluder with t in [eps, tm] along o + t*d (bvh_traverse.
// trace_bvh_shadow for one ray); the first one ends the walk.  The
// callers skip windows <= 0 (and NaN), which can hold no t >= eps.  The
// inner loop is written out with its own exit, after which the warp's
// lanes meet at the leaf loop (the same walk through a helper that
// returned from inside the inner loop ran no faster on the card than a
// loop that tested one node a step).
__device__ __forceinline__ bool any_hit_ww(const float4* __restrict__ bounds,
                                           const int4* __restrict__ meta,
                                           const float4* __restrict__ tris,
                                           int n_nodes, V3 o, V3 d, float tm,
                                           float eps) {
  const V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  int cur = 0;
  while (cur < n_nodes) {
    int4 m;  // skip, first, count, pad
    bool leaf = false;
    while (cur < n_nodes) {  // to the next leaf whose box is hit
      m = __ldg(&meta[cur]);
      const bool bhit = hit_box(bounds, cur, o, inv, tm);
      if (bhit && m.z > 0) {
        leaf = true;
        break;
      }
      cur = bhit ? cur + 1 : m.x;
    }
    if (!leaf) break;
    const int cnt = m.z < kLeafMax ? m.z : kLeafMax;
    for (int j = 0; j < cnt; ++j) {
      float t;
      if (hit_tri(load_tri(tris, m.y + j), o, d, tm, eps, &t)) return true;
    }
    cur = m.x;
  }
  return false;
}

// The closest hit along o + t*d (bvh_traverse.trace_bvh for one ray), in
// the while-while form: t (kInf on a miss) and the winning triangle's
// cross(e1, e2), zero on a miss; a later triangle wins an exact tie.
__device__ __forceinline__ float closest_hit_ww(
    const float4* __restrict__ bounds, const int4* __restrict__ meta,
    const float4* __restrict__ tris, int n_nodes, V3 o, V3 d, float eps,
    V3* n_out) {
  const V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float t_best = kInf;
  V3 n_best = {0.0f, 0.0f, 0.0f};
  int cur = 0;
  while (cur < n_nodes) {
    int4 m;  // skip, first, count, pad
    bool leaf = false;
    while (cur < n_nodes) {  // to the next leaf whose box is hit
      m = __ldg(&meta[cur]);
      const bool bhit = hit_box(bounds, cur, o, inv, t_best);
      if (bhit && m.z > 0) {
        leaf = true;
        break;
      }
      cur = bhit ? cur + 1 : m.x;
    }
    if (!leaf) break;
    const int cnt = m.z < kLeafMax ? m.z : kLeafMax;
    for (int j = 0; j < cnt; ++j) {
      const Tri tr = load_tri(tris, m.y + j);
      float t;
      if (hit_tri(tr, o, d, t_best, eps, &t)) {
        t_best = t;
        n_best = cross3(tr.e1, tr.e2);
      }
    }
    cur = m.x;
  }
  *n_out = n_best;
  return t_best;
}
