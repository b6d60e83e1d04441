// Skip-link BVH walk for Hopper (sm_90a): closest hit and any hit.
//
// trace_closest_kernel replaces the TPU kernel K1,
//   opengl_raytracing_tpu/ops/bvh_mxu.py  _closest_kernel
//   (launched by _closest_page_rows through trace_bvh_mxu_paged);
// trace_any_kernel replaces the TPU kernel K2,
//   opengl_raytracing_tpu/ops/bvh_mxu.py  _shadow_kernel
//   (launched by _shadow_page_rows through trace_bvh_shadow_mxu_paged).
// They also cover the archived packet walks of
// opengl_raytracing_tpu/experiments/bvh_pallas.py, which compute the same
// results over the same BVHArrays.
//
// Design: one thread per ray walks the preorder skip-link tree with one
// cursor, cur = (aabb_hit && inner) ? cur + 1 : skip[cur], and tests a
// leaf's <= LEAF_MAX triangles in a loop.  This is the reference's own
// per-thread walk (rt_bvh.glsl:193-304) without its stack.  None of the
// TPU kernels' machinery carries over: the MXU matmul form of
// Moller-Trumbore, the tile culls, the VMEM pages, bf16_3x and the shared
// origin rows were all there to feed a 128-lane vector unit.
//
// The arithmetic is the plain PyTorch walker's (ops/bvh_traverse.py,
// ops/intersect.py) expression for expression: dot and cross summed left
// to right, the slab test with tmin clamped to >= 0, |det| < 1e-8 rejected,
// the window t >= eps && t <= t_max, 1/rd with exact zeros nudged to 1e-30.
// Build without --use_fast_math: the walk relies on IEEE division and
// exact comparisons.  The walk's pieces are in bvh_walk.cuh, which the
// fused BVH direct light (an_direct.cu) includes too, so every any-hit
// walk of the port is one piece of code.
//
// What bounds it on this card: the node and triangle fetches.  Each step
// of a walk is a dependent, data-driven load of a 32-byte node (and, at a
// leaf, 48-byte triangles) whose address diverges across the warp, so the
// kernel waits on L1/L2 latency, not on FLOPs.  The whole 5,120-triangle
// bunny (about 1,300 nodes, 290 KB) sits in L2; the loads go through the
// read-only path (__ldg) as 16-byte vectors.
//
// Left for later: a node layout that coalesces (two children side by
// side, or a wide BVH), a short stack in shared memory for near-first
// order, persistent threads that pull rays from a queue so that long
// walks do not idle a warp, and sorting rays by direction or origin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
trace_closest_kernel(const float4* __restrict__ bounds,
                     const int4* __restrict__ meta,
                     const float4* __restrict__ tris, int n_nodes,
                     const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const uint8_t* __restrict__ active, int64_t n_rays,
                     float eps, float* __restrict__ t_out,
                     float* __restrict__ n_out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const V3 o = load3(ro + 3 * i);
  const V3 d = load3(rd + 3 * i);
  const V3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  float t_best = kInf;
  V3 n_best = {0.0f, 0.0f, 0.0f};
  // an inactive lane (active may be null: all active) reads as a miss
  int cur = (active == nullptr || active[i]) ? 0 : n_nodes;
  while (cur < n_nodes) {
    const int4 m = __ldg(&meta[cur]);  // skip, first, count, pad
    const bool bhit = hit_box(bounds, cur, o, inv, t_best);
    if (bhit && m.z > 0) {
      const int cnt = m.z < kLeafMax ? m.z : kLeafMax;
      for (int j = 0; j < cnt; ++j) {
        const Tri tr = load_tri(tris, m.y + j);
        float t;
        if (hit_tri(tr, o, d, t_best, eps, &t)) {  // later triangle wins a tie
          t_best = t;
          n_best = cross3(tr.e1, tr.e2);
        }
      }
    }
    cur = (bhit && m.z == 0) ? cur + 1 : m.x;
  }
  t_out[i] = t_best;
  n_out[3 * i] = n_best.x;
  n_out[3 * i + 1] = n_best.y;
  n_out[3 * i + 2] = n_best.z;
}

__global__ void __launch_bounds__(kThreads)
trace_any_kernel(const float4* __restrict__ bounds,
                 const int4* __restrict__ meta,
                 const float4* __restrict__ tris, int n_nodes,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t_max, int64_t n_rays, float eps,
                 uint8_t* __restrict__ occ_out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float tm = t_max[i];
  // A window <= 0 (or NaN) can hold no t >= eps: nothing to walk.
  const bool occ = tm > 0.0f && any_hit(bounds, meta, tris, n_nodes,
                                         load3(ro + 3 * i), load3(rd + 3 * i),
                                         tm, eps);
  occ_out[i] = occ ? 1 : 0;
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers; the
// stream is a cudaStream_t.  Each returns cudaGetLastError() as an int.
// `active` is a device array of n_rays 0/1 bytes, or null (all active).
extern "C" int ort_trace_closest(const void* bounds, const void* meta,
                                 const void* tris, int n_nodes, const void* ro,
                                 const void* rd, const void* active,
                                 int64_t n_rays, float eps, void* t_out,
                                 void* n_out, void* stream) {
  if (n_rays > 0) {
    trace_closest_kernel<<<blocks_for(n_rays), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const float4*)bounds, (const int4*)meta, (const float4*)tris,
        n_nodes, (const float*)ro, (const float*)rd, (const uint8_t*)active,
        n_rays, eps, (float*)t_out, (float*)n_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int ort_trace_any(const void* bounds, const void* meta,
                             const void* tris, int n_nodes, const void* ro,
                             const void* rd, const void* t_max, int64_t n_rays,
                             float eps, void* occ_out, void* stream) {
  if (n_rays > 0) {
    trace_any_kernel<<<blocks_for(n_rays), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const float4*)bounds, (const int4*)meta, (const float4*)tris,
        n_nodes, (const float*)ro, (const float*)rd, (const float*)t_max,
        n_rays, eps, (uint8_t*)occ_out);
  }
  return (int)cudaGetLastError();
}
