// Skip-link BVH walks for Hopper (sm_90a): the closest hit (K1) and the
// ambient occlusion call (K2).
//
// trace_closest_kernel and trace_bounce_kernel replace the TPU kernel K1,
//   opengl_raytracing_tpu/ops/bvh_mxu.py  _closest_kernel
//   (launched by _closest_page_rows through trace_bvh_mxu_paged):
//   the first on given rays (the primary call), the second on GI's bounce
//   rays, which it samples itself (lighting.gi_bounce_plain per pixel);
// ambient_occlusion_kernel replaces the TPU kernel K2,
//   opengl_raytracing_tpu/ops/bvh_mxu.py  _shadow_kernel
//   (launched by _shadow_page_rows through trace_bvh_shadow_mxu_paged)
//   on its one call left, compute_ao's BVH branch, whole
//   (lighting.ambient_occlusion_plain per pixel).
// They also cover the archived packet walks of
// opengl_raytracing_tpu/experiments/bvh_pallas.py and the lane-packed
// shadow kernel (bvh_mxu.py _shadow_kernel_pack), which compute the same
// results over the same BVHArrays.
//
// The walk: one lane walks one ray down the preorder skip-link tree with
// one cursor, cur = (aabb_hit && inner) ? cur + 1 : skip[cur], testing a
// leaf's <= LEAF_MAX triangles in a loop: the reference's own per-thread
// walk (rt_bvh.glsl:193-304) without its stack.  None of the TPU kernels'
// machinery carries over (the MXU matmul form of Moller-Trumbore, tile
// culls, VMEM pages, bf16_3x), and the arithmetic is the plain PyTorch
// version's expression for expression (bvh_walk.cuh, sampling.cuh): the
// kernels return the plain versions' bits.
//
// What bounds them on this card: latency, not bytes or operations.  A
// walk is a chain of dependent, data-driven fetches -- node rows, and at
// each leaf up to 8 triangle rows of 48 B from L1/L2 -- with a slab test
// or a Moller-Trumbore test (an IEEE division) after each, and a warp
// waits on the longest chain among its lanes.  On the BVH frames only
// ~0.7% of the 1080p pixels are bunny hits, so the AO and bounce calls
// are a few thousand live walks spread over a mostly dead mask, and a
// call takes as long as the warp with the most live units in series.
// The design:
//
//   * Persistent blocks.  The grid is the SM count times the blocks that
//     fit an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor: one of
//     1,024 threads), and each warp loops over units of lanes, block-minor
//     (unit u to warp u mod (warps in the grid)), so neighbouring units
//     land on different SMs (persistent.cuh, shared with an_direct.cu).
//   * Node rows and triangles in device memory, read through __ldg: the
//     5,120 triangle bunny's 2,047 node rows (98 KB) and its triangles
//     (245 KB) are served from L1 and L2.  Staging the node rows in dynamic
//     shared memory (one 1-D bulk async copy per block on an mbarrier)
//     was timed on the card against this: 6-10% slower, the copy and its
//     wait paid by every block (PERF.md).  So the kernels read one copy
//     of the tree, of any size.
//   * Live-lane compaction per warp.  The warp reads a unit's mask bytes,
//     takes __ballot_sync and hands the live pixels to its first lanes; a
//     dead lane reads its mask byte and nothing else.  A closest-hit unit
//     is a run of 32 pixels.  An AO unit is 32 / S pixels, so its live
//     (pixel, sample) pairs are one round of 32 lanes, a pixel's samples
//     on neighbouring lanes, and the walks of a run of live pixels spread
//     over S warps instead of S rounds of one; the occlusion bits come
//     back by one __ballot_sync, and each pixel's own lane counts its bits
//     (__popc): one store per pixel.
//   * Lanes reach the leaves together.  A warp runs its lanes' leaf
//     loops once per leaf each lane reaches, not once per step in which
//     any lane stands at a leaf: the walks take bvh_walk.cuh's while-
//     while form (any_hit_ww, closest_hit_ww), the same tests in the same
//     order per lane.
//   * The call samples its own rays.  The AO kernel takes the raw hit
//     point and normal, the pixel grids (in place, through their strides)
//     and the frame's record and the parameter block (read through
//     pointers, with the RNG keys' (a, b) of the index by value: the
//     arguments are the same for every frame and every value of
//     ao_bias, ao_radius and ao_min, so one captured CUDA graph replays
//     it for any of them)
//     and computes the keys, the samples' rand pairs, the
//     cosine-hemisphere directions, the biased origin, the walks in
//     [eps, ao_radius] and the remapped AO value.  The bounce kernel
//     computes GI's rand pair, normal, hemisphere direction and origin,
//     walks the closest hit and writes the finished hit, the direction
//     and its cosine.  No ray tensor is made on the way in, and no
//     normalisation is left for the way out.
//
// The primary call has every lane live (or an optional mask), and takes
// the persistent loop only.
//
// The samples of a pixel (spp_per_frame > 1) make one bounce call over a
// leading sample axis, [spp, H, W]: its lanes are the units of one
// persistent launch, lane i the pixel i % n_px of sample i / n_px
// (sampling.cuh), sampling its ray from the seed of its sample (the seed's
// per-sample stride).  Where the samples share the primary hit, its rows
// and the mask are read once a pixel, in place (BounceArgs::shared).
//
// Left for later: a queue of live units shared by all warps (a frame's
// live pixels cluster, so the busiest warp still walks several units in
// series), a node layout that coalesces (two children side by side, or a
// wide BVH), and a short stack for near-first order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"
#include "param_block.cuh"
#include "persistent.cuh"
#include "sampling.cuh"

namespace {

// One block of 1,024 threads per SM: 32 warps (two blocks of 512 were no
// faster).
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

}  // namespace

// The GI bounce call's inputs (lighting.gi_bounce_plain), filled on the
// host (ops/bvh_cuda.py:bounce_args).
struct BounceArgs {
  // the primary hits' points and raw normals: [N, 3], or with `shared`
  // [n_px, 3], one row a pixel read by every sample (as is `active`)
  const float* p;
  const float* n;
  PixelGrid grid;   // lane i: pixel i % n_px of sample i / n_px
  const FrameRecord* frame;  // the frame index, read on the device
  FrameAffine rng;  // rng_frame of the index (sampling.rand's keys)
  FrameAffine seed; // seed of the index: offsets float32(seed * 19), * 41
  float two_pi;     // float32(2.0 * PI)
  float eps;        // the origin's offset along the normal (EPS)
  int shared;
};

// The AO call's inputs (lighting.ambient_occlusion_plain), filled on the
// host (ops/bvh_cuda.py:ao_args).
struct AoArgs {
  const float* p;   // the hits' points and raw normals, [N, 3]
  const float* n;
  PixelGrid grid;
  const FrameRecord* frame;  // the frame index, read on the device
  // ao_bias, ao_radius, ao_min and ao_span = float32(1.0 - ao_min)
  const ParamBlock* prm;
  FrameAffine fi;   // frame_index of the index (sampling.rand's keys)
  int samples;      // ao_samples
  float two_pi;     // float32(2.0 * PI)
};

// The AO call's parameters, read from the block once a thread.
struct AoParams {
  float bias, radius, ao_min, ao_span;
};

namespace {

__device__ __forceinline__ void store3(float* __restrict__ out, int64_t i,
                                       V3 c) {
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

// The closest hit of one ray as bvh_traverse._finalize returns it: t, the
// point o + d*t (also on a miss, t = 1e30) and the unit normal, zero on a
// miss.
__device__ __forceinline__ void closest_hit_out(const Tree& tree, V3 o, V3 d,
                                                float eps, int64_t k,
                                                float* __restrict__ t_out,
                                                float* __restrict__ p_out,
                                                float* __restrict__ n_out) {
  V3 nb;
  const float t = closest_hit_ww(tree.bounds, tree.meta, tree.tris,
                                 tree.n_nodes, o, d, eps, &nb);
  t_out[k] = t;
  store3(p_out, k, add3(o, scale3(d, t)));
  store3(n_out, k, t < kInf ? norm3(nb) : V3{0.0f, 0.0f, 0.0f});
}

// K1 on given rays: ro rows step `ro_step` floats (0: one shared origin,
// 3: one row per ray), rd rows 3.  A lane that `active` (null: all)
// marks off does not walk and reads as a miss, p = o + d*1e30.
__global__ void __launch_bounds__(kThreads, 1)
trace_closest_kernel(const Units u, const Tree tree,
                     const float* __restrict__ ro, int64_t ro_step,
                     const float* __restrict__ rd,
                     const uint8_t* __restrict__ active, int64_t n,
                     float eps, float* __restrict__ t_out,
                     float* __restrict__ p_out, float* __restrict__ n_out) {
  __shared__ uint8_t slot[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t j = u.first(); j < u.n_units; j += u.stride()) {
    const int64_t base = u.base(j), i = base + lane;
    const bool live = is_live(active, u, base, lane, n);
    const unsigned mask = __ballot_sync(kAll, live);
    if (live) slot[warp][__popc(mask & below)] = (uint8_t)lane;
    __syncwarp();
    if (lane < __popc(mask)) {
      const int64_t k = base + slot[warp][lane];
      closest_hit_out(tree, ldg3(ro + ro_step * k), row3(rd, k), eps, k,
                      t_out, p_out, n_out);
    }
    if (i < n && !live) {
      const V3 o = ldg3(ro + ro_step * i), d = row3(rd, i);
      t_out[i] = kInf;
      store3(p_out, i, add3(o, scale3(d, kInf)));
      store3(n_out, i, {0.0f, 0.0f, 0.0f});
    }
    __syncwarp();  // the next unit rewrites slot
  }
}

// K1 on GI's bounce rays (lighting.gi_bounce_plain per lane): the rand
// pair at offsets seed*19 and seed*41 of the lane's sample, n0 =
// normalize(n), the cosine-hemisphere direction wi around n0, the origin
// p + n0*EPS, and the closest hit along wi; also wi and cos = max(dot(n0,
// wi), 0).  The lanes of every sample are units of one persistent launch;
// a lane reads its pixel's hit row where the samples share the hit.  A
// lane that `active` marks off reads as a miss, t = 1e30, with wi and cos
// zero; its p and n are not written.
__global__ void __launch_bounds__(kThreads, 1)
trace_bounce_kernel(const Units u, const Tree tree,
                    const BounceArgs a, const uint8_t* __restrict__ active,
                    int64_t n, float eps, float* __restrict__ t_out,
                    float* __restrict__ p_out, float* __restrict__ n_out,
                    float* __restrict__ wi_out,
                    float* __restrict__ cos_out) {
  __shared__ uint8_t slot[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t f = frame_index(a.frame);
  for (int64_t j = u.first(); j < u.n_units; j += u.stride()) {
    const int64_t base = u.base(j), i = base + lane;
    // the lane's hit row: its pixel's where the samples share the hit
    const int64_t row = a.shared ? i - (int64_t)sample_of(a.grid, i) *
                                           a.grid.n_px
                                 : i;
    const bool live = lane < u.unit && i < n &&
                      (active == nullptr || __ldg(active + row));
    const unsigned mask = __ballot_sync(kAll, live);
    if (live) slot[warp][__popc(mask & below)] = (uint8_t)lane;
    __syncwarp();
    if (lane < __popc(mask)) {
      const int64_t k = base + slot[warp][lane];
      const uint32_t smp = sample_of(a.grid, k);
      const int64_t hr = a.shared ? k - (int64_t)smp * a.grid.n_px : k;
      const uint32_t kx = frame_value(f, a.rng, smp), ky = key_y(kx);
      const uint32_t seed = frame_value(f, a.seed, smp);
      const float so = frame_f32(seed * 19u), so2 = frame_f32(seed * 41u);
      float px, py;
      pixel_centre(a.grid, k, &px, &py);
      const float ux = rand01(px + so, py + so, kx, ky);
      const float uy = rand01(py + so2, px + so2, kx, ky);
      const V3 n0 = norm3(row3(a.n, hr));
      const V3 wi = hemisphere_cosine(n0, ux, uy, a.two_pi);
      store3(wi_out, k, wi);
      cos_out[k] = fmaxf(dot3(n0, wi), 0.0f);
      closest_hit_out(tree, add3(row3(a.p, hr), scale3(n0, a.eps)), wi, eps,
                      k, t_out, p_out, n_out);
    }
    if (i < n && !live) {
      t_out[i] = kInf;
      store3(wi_out, i, {0.0f, 0.0f, 0.0f});
      cos_out[i] = 0.0f;
    }
    __syncwarp();  // the next unit rewrites slot
  }
}

// Bits [lo, hi) of a 32-bit word, 0 <= lo < hi <= 32.
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  const unsigned upto = hi == 32 ? kAll : (1u << hi) - 1u;
  return upto & ~((1u << lo) - 1u);
}

// Sample s of the AO pixel k: occluded within [eps, radius]?
__device__ __forceinline__ bool ao_occluded(const Tree& tree,
                                            const AoArgs& a,
                                            const AoParams& prm, uint32_t kx,
                                            int64_t k, int s, float eps) {
  float px, py;
  pixel_centre(a.grid, k, &px, &py);
  const float o1 = (float)(37 * s + 3), o2 = (float)(19 * s + 11);
  const uint32_t ky = key_y(kx);
  const float ux = rand01(px + o1, py + o1, kx, ky);
  const float uy = rand01(py + o2, px + o2, kx, ky);
  const V3 nn = norm3(row3(a.n, k));
  const V3 d = hemisphere_cosine(nn, ux, uy, a.two_pi);
  const V3 o = add3(row3(a.p, k), scale3(nn, prm.bias));
  return prm.radius > 0.0f &&
         any_hit_ww(tree.bounds, tree.meta, tree.tris, tree.n_nodes, o, d,
                    prm.radius, eps);
}

// K2's AO call (lighting.ambient_occlusion_plain per pixel).  A unit is
// 32 / S pixels (one pixel where S > 32), so its live (pixel, sample)
// pairs fill at most one round of 32 lanes: sample j % S of the (j / S)-th
// live pixel on lane j.  A pixel's count, then clamp(ao_min + (1 -
// ao_min)*(1 - occ/S), ao_min, 1).  A lane that `active` marks off writes
// nothing: its value is unspecified.
__global__ void __launch_bounds__(kThreads, 1)
ambient_occlusion_kernel(const Units u, const Tree tree,
                         const AoArgs a, const uint8_t* __restrict__ active,
                         int64_t n, float eps, float* __restrict__ ao_out) {
  __shared__ uint8_t slot[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int S = a.samples;
  const uint32_t kx = frame_value(frame_index(a.frame), a.fi);
  const AoParams prm = {__ldg(a.prm->ao_bias), __ldg(a.prm->ao_radius),
                        __ldg(a.prm->ao_min), __ldg(a.prm->ao_span)};
  for (int64_t j = u.first(); j < u.n_units; j += u.stride()) {
    const int64_t base = u.base(j), i = base + lane;
    const bool live = is_live(active, u, base, lane, n);
    const unsigned mask = __ballot_sync(kAll, live);
    if (mask == 0) continue;
    const int rank = __popc(mask & below);
    if (live) slot[warp][rank] = (uint8_t)lane;
    __syncwarp();
    const int items = __popc(mask) * S;
    int occ = 0;
    for (int j0 = 0; j0 < items; j0 += 32) {  // one round unless S > 32
      const int item = j0 + lane;
      bool hit = false;
      if (item < items) {
        const int q = item / S;
        hit = ao_occluded(tree, a, prm, kx, base + slot[warp][q],
                          item - q * S, eps);
      }
      const unsigned bits = __ballot_sync(kAll, hit);
      const int lo = max(rank * S - j0, 0), hi = min(rank * S + S - j0, 32);
      if (live && lo < hi) occ += __popc(bits & bit_range(lo, hi));
    }
    if (live) {
      const float ao = 1.0f - (float)occ / (float)S;
      ao_out[i] =
          fminf(fmaxf(prm.ao_min + prm.ao_span * ao, prm.ao_min), 1.0f);
    }
    __syncwarp();  // the next unit rewrites slot
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers, but for
// the argument structs, which are host pointers (their own pointers are
// device pointers); `active` is a device array of n 0/1 bytes, or null
// (all live); the stream is a cudaStream_t.  Each returns a cudaError_t
// as an int: of the set-up calls, else cudaGetLastError().
extern "C" int ort_trace_closest(const void* bounds, const void* meta,
                                 const void* tris, int n_nodes, const void* ro,
                                 int64_t ro_step, const void* rd,
                                 const void* active, int64_t n_rays, float eps,
                                 void* t_out, void* p_out, void* n_out,
                                 void* stream) {
  return launch_persistent(trace_closest_kernel, kThreads,
                           make_units(n_rays, 32), (cudaStream_t)stream,
                           make_tree(bounds, meta, tris, n_nodes),
                           (const float*)ro, ro_step, (const float*)rd,
                           (const uint8_t*)active, n_rays, eps,
                           (float*)t_out, (float*)p_out, (float*)n_out);
}

extern "C" int ort_trace_bounce(const void* bounds, const void* meta,
                                const void* tris, int n_nodes,
                                const BounceArgs* args, const void* active,
                                int64_t n, float eps, void* t_out, void* p_out,
                                void* n_out, void* wi_out, void* cos_out,
                                void* stream) {
  return launch_persistent(trace_bounce_kernel, kThreads, make_units(n, 32),
                           (cudaStream_t)stream,
                           make_tree(bounds, meta, tris, n_nodes), *args,
                           (const uint8_t*)active, n, eps, (float*)t_out,
                           (float*)p_out, (float*)n_out, (float*)wi_out,
                           (float*)cos_out);
}

extern "C" int ort_ambient_occlusion(const void* bounds, const void* meta,
                                     const void* tris, int n_nodes,
                                     const AoArgs* args, const void* active,
                                     int64_t n, float eps, void* ao_out,
                                     void* stream) {
  const int unit = args->samples <= 32 ? 32 / args->samples : 1;
  return launch_persistent(ambient_occlusion_kernel, kThreads,
                           make_units(n, unit), (cudaStream_t)stream,
                           make_tree(bounds, meta, tris, n_nodes), *args,
                           (const uint8_t*)active, n, eps, (float*)ao_out);
}

// The argument structs' sizes, so the host can check its mirrors.
extern "C" int ort_bounce_args_size() { return (int)sizeof(BounceArgs); }
extern "C" int ort_ao_args_size() { return (int)sizeof(AoArgs); }
