// The live-lane kernels' shared pieces: how a call's inputs are read in
// place (LaneIn), the persistent loop that queues a warp's live lanes and
// works them 32 a round (live_rounds), and a trace's hit written as
// trace_analytic_core returns it (hit_out).  Included by an_trace.cu (the
// analytic scene's trace, AO, GI bounce and sky kernels), an_shade.cu
// (glass's and the mirror's rays and mixes) and hit_mix.cu (both scenes'
// shading tails).  Build with --fmad=false and without --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "an_scene.cuh"
#include "bvh_walk.cuh"
#include "persistent.cuh"
#include "sampling.cuh"

// Blocks of 128 threads; a warp's queue of live lanes is worked 32 a
// round once it holds 32, so it holds at most 31 + 32 (int64 lane
// indices: 504 B a warp, 2,016 B a block).
constexpr int kLiveThreads = 128;
constexpr int kLiveWarps = kLiveThreads / 32;
constexpr int kLiveQueueCap = 31 + 32;

// How a call's input is read: a row a lane, a row a pixel (row i % n_px,
// the samples of a leading axis sharing it), or one row for every lane.
enum { kLane = 0, kPixel = 1, kOne = 2 };

// An input of a call on the device, read in place.
struct LaneIn {
  const void* p;  // [rows, 3] float32, [rows] int32 or float32, or [rows]
                  // mask bytes
  int mode;       // kLane, kPixel or kOne
};

// the row of lane i that an input read `mode` holds
__device__ __forceinline__ int64_t in_row(int mode, int64_t i, int64_t n_px) {
  return mode == kLane ? i : mode == kPixel ? i - div_index(i, n_px) * n_px
                                            : 0;
}

__device__ __forceinline__ V3 in3(const LaneIn& x, int64_t i, int64_t n_px) {
  return row3((const float*)x.p, in_row(x.mode, i, n_px));
}

__device__ __forceinline__ int in_i32(const LaneIn& x, int64_t i,
                                      int64_t n_px) {
  return __ldg((const int32_t*)x.p + in_row(x.mode, i, n_px));
}

__device__ __forceinline__ float in_f32(const LaneIn& x, int64_t i,
                                        int64_t n_px) {
  return __ldg((const float*)x.p + in_row(x.mode, i, n_px));
}

__device__ __forceinline__ void put3(float* __restrict__ out, int64_t i,
                                     V3 c) {
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

// Run work(i) on every live lane i < n of `active` (null: every lane),
// as persistent blocks over units of 32 lanes: a warp takes its units in
// turn and queues their live lanes (__ballot_sync, each at its rank);
// once the queue holds 32 it works a round of 32, a lane each, and takes
// units again; after its last unit it works what is left.  A dead lane
// reads its mask byte and nothing else.
template <class Work>
__device__ __forceinline__ void live_rounds(const Units& u,
                                            const LaneIn& active, int64_t n,
                                            int64_t n_px, Work work) {
  __shared__ int64_t queue[kLiveWarps][kLiveQueueCap];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int64_t* q = queue[threadIdx.x >> 5];
  const uint8_t* act = (const uint8_t*)active.p;
  int n_q = 0;  // the same on every lane of the warp
  int64_t j = u.first();
  for (;;) {
    for (; j < u.n_units && n_q < 32; j += u.stride()) {
      const int64_t i = u.base(j) + lane;
      const bool live =
          i < n &&
          (act == nullptr || __ldg(act + in_row(active.mode, i, n_px)));
      const unsigned b = __ballot_sync(0xffffffffu, live);
      if (live) q[n_q + __popc(b & below)] = i;
      n_q += __popc(b);
    }
    if (n_q == 0) break;  // the units done and the queue empty
    const int k = min(n_q, 32);
    __syncwarp();  // the entries are written
    if (lane < k) work(q[n_q - k + lane]);
    n_q -= k;
    __syncwarp();  // the entries are read before the next enqueue
  }
}

// The closest hit of ray o + t*d written to lane i as trace_analytic_core
// returns it: t, p = o + d*t, the winner's unit normal (the floor's, or
// normalize(o + d*t - c) of the sphere's centre c) and its material id
// (the primitive's index: MAT_FLOOR 0, the albedo, glass and mirror
// spheres 1-3, the marker 4); on a miss t = 1e30, p = o + d*1e30, a zero
// normal and material 0.  Returns t.
__device__ __forceinline__ float hit_out(const AnScene& s, V3 o, V3 d,
                                         bool glass, bool marker, float eps,
                                         int64_t i, float* __restrict__ t_out,
                                         float* __restrict__ p_out,
                                         float* __restrict__ n_out,
                                         int32_t* __restrict__ mat_out) {
  const AnHit h = trace_closest(s, o, d, glass, marker, eps);
  const V3 p = add3(o, scale3(d, h.t));
  V3 nrm = {0.0f, 0.0f, 0.0f};
  if (h.k == kAnFloor) {
    nrm = c3(s.floor_n);
  } else if (h.k != kAnMiss) {
    // a select chain: no dynamic index into the by-value struct
    V3 c = c3(s.prm->point_light_world);
    if (h.k == 1) c = c3(s.sphere_c[0]);
    if (h.k == 2) c = c3(s.sphere_c[1]);
    if (h.k == 3) c = c3(s.sphere_c[2]);
    nrm = norm3(sub3(p, c));
  }
  t_out[i] = h.t;
  put3(p_out, i, p);
  put3(n_out, i, nrm);
  mat_out[i] = h.k == kAnMiss ? 0 : h.k;
  return h.t;
}
