// The live-lane kernels' shared pieces: how a call's inputs are read in
// place (LaneIn), the persistent loops over a mask's live lanes
// (live_rounds, a unit of 32 mask bytes at a time, its live lanes queued
// and worked 32 a round; live_lanes, a slice of 128 or more at a time,
// each unit worked where it lies), and a trace's hit written as
// trace_analytic_core returns it (hit_out).  Included by
// an_trace.cu (the analytic scene's trace, AO, GI bounce and sky
// kernels), an_shade.cu (glass's and the mirror's rays and mixes) and
// hit_mix.cu (both scenes' shading tails).  Build with --fmad=false and
// without --use_fast_math.

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

// The row of lane i, of pixel q, that an input read `mode` holds (the
// pixel known: no division)
__device__ __forceinline__ int64_t row_of(int mode, int64_t i, int64_t q) {
  return mode == kLane ? i : mode == kPixel ? q : 0;
}

__device__ __forceinline__ V3 at3(const LaneIn& x, int64_t i, int64_t q) {
  return row3((const float*)x.p, row_of(x.mode, i, q));
}

__device__ __forceinline__ float at_f32(const LaneIn& x, int64_t i,
                                        int64_t q) {
  return __ldg((const float*)x.p + row_of(x.mode, i, q));
}

__device__ __forceinline__ int at_i32(const LaneIn& x, int64_t i, int64_t q) {
  return __ldg((const int32_t*)x.p + row_of(x.mode, i, q));
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

// live_lanes' slices: a warp reads 32 * kBytes mask bytes at once, kBytes
// a thread in one aligned load (kSliceBytes = 4 unless a kernel asks for
// 8 or 16), so one round trip to memory serves 128 lanes where
// live_rounds' serves 32, and the next slice's load is in flight while
// this one's lanes are worked.  A slice is kBytes units of 32
// consecutive bytes, 32 / kBytes threads a unit, spread over the mask as
// live_rounds spreads its units over the warps: unit g of slice j is the
// mask's unit j + g * (slices), so a region of live lanes is worked by
// many warps, not by the one that owns its bytes.  Every unit with a
// live lane is worked where it lies, a lane each: the frames' masks are
// compact (the misses, the hits, a sphere's disk), and a queue of a
// sparse unit's lanes, worked 32 a round as in live_rounds, was slower or
// no faster on every call timed (PERF.md section 6).  The sky and the
// BVH hit mix are held to kSliceBlocks blocks an SM (40 registers) and
// read 4 bytes a thread; slices of 16 or 8 bytes a thread (one slice a
// warp at 1080p) were faster on their sparse calls and slower on the
// dense ones, on which the warps in flight decide (probe_live_scan.py).
// Glass's and the mirror's rays kernels, whose work is longer, take
// blocks and widths of their own (an_shade.cu).
constexpr int kSliceBytes = 4;
constexpr int kSliceBlocks = 12;
// live_lanes indexes lanes and mask bytes in 32 bits (a byte offset it
// loads is below n + 2 slices, each at most 512 bytes: 16 a thread): a
// call of more lanes is refused
constexpr int64_t kMaxSliceLanes = INT32_MAX - 2 * 32 * 16;

// A thread's kBytes mask bytes from `first` on, as words (bytes at or
// past n read 0; a null mask reads 1 for every byte below n).
template <int kBytes>
struct SliceWords {
  uint32_t w[kBytes / 4];
};

template <int kBytes>
__device__ __forceinline__ SliceWords<kBytes> slice_words(
    const uint8_t* __restrict__ act, bool aligned, int first, int n) {
  SliceWords<kBytes> m;
  if (first <= n - kBytes && (act == nullptr || aligned)) {
    if (act == nullptr) {
#pragma unroll
      for (int k = 0; k < kBytes / 4; ++k) m.w[k] = 0x01010101u;
    } else if constexpr (kBytes == 16) {
      const uint4 v = __ldg((const uint4*)(act + first));
      m.w[0] = v.x, m.w[1] = v.y, m.w[2] = v.z, m.w[3] = v.w;
    } else if constexpr (kBytes == 8) {
      const uint2 v = __ldg((const uint2*)(act + first));
      m.w[0] = v.x, m.w[1] = v.y;
    } else {
      m.w[0] = __ldg((const uint32_t*)(act + first));
    }
    return m;
  }
  // the mask's tail, or a mask not aligned to kBytes: a byte at a time
  // (unrolled, so the words stay in registers)
#pragma unroll
  for (int k = 0; k < kBytes / 4; ++k) m.w[k] = 0u;
#pragma unroll
  for (int b = 0; b < kBytes; ++b) {
    if (first < n - b) {
      const uint32_t live = act == nullptr || __ldg(act + first + b) != 0;
      m.w[b >> 2] |= live << (8 * (b & 3));
    }
  }
  return m;
}

// bit b: byte b of the words is not 0
template <int kBytes>
__device__ __forceinline__ unsigned live_bits(const SliceWords<kBytes>& m) {
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < kBytes / 4; ++k) {
    const uint32_t w = m.w[k];
    // the high bit of each byte that is not 0, then one bit a byte
    const uint32_t hi = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
    bits |= (((hi >> 7) * 0x01020408u) >> 24) << (4 * k);
  }
  return bits;
}

// The units of live_lanes: its slices of the mask's bytes (a byte a
// pixel for a pixel mask, else a byte a lane), 32 * `bytes` bytes each.
inline Units slice_units(const LaneIn& active, int64_t n_lanes,
                         int64_t n_px, int bytes = kSliceBytes) {
  const bool pixel = active.p != nullptr && active.mode == kPixel;
  return make_units(pixel ? n_px : n_lanes, 32 * bytes);
}

// Run work(i, q) on every live lane i < n_lanes of `active` (null: every
// lane), q its pixel, as persistent blocks over slices of the mask
// (slice_units; n_lanes at most kMaxSliceLanes).  A pixel mask (kPixel,
// under a leading sample axis) is walked a byte a pixel and its live
// pixel q runs the lanes q + s * n_px of every sample s in turn, so the
// mask is read once and no lane's row needs a division; a lane mask runs
// lane i = its byte (q = i % n_px).  A warp loads its next slice's words
// before it works this one's.  Each thread turns its bytes into bits; a
// unit's 32 bits are those of its 32 / kBytes threads; the warp visits
// its units with a live lane (__ballot_sync) and works each where it
// lies, its live lanes a lane a thread.  With kPairs, two full units in
// a row of a call without a sample axis are worked by one call site, a
// lane of each a thread, so the second's loads may go before the first's
// stores (the gradient sky's dense calls: 0.0217 -> 0.0188 ms; the
// cubemap's taps spill).
// A dead lane costs its mask byte, and a slice with no live lane one
// load and a ballot.
template <bool kPairs, int kBytes = kSliceBytes, class Work>
__device__ __forceinline__ void live_lanes(const Units& u,
                                           const LaneIn& active,
                                           int64_t n_lanes, int64_t n_px,
                                           Work work) {
  constexpr int kPer = 32 / kBytes;  // threads of a unit's bytes
  const int lane = threadIdx.x & 31;
  const uint8_t* act = (const uint8_t*)active.p;
  if (act != nullptr && active.mode == kOne) {
    if (__ldg(act) == 0) return;  // one byte for every lane, dead
    act = nullptr;
  }
  const bool pixel = act != nullptr && active.mode == kPixel;
  const int px_n = (int)n_px;
  const int n = pixel ? px_n : (int)n_lanes;
  const int reps = pixel ? (int)n_lanes / px_n : 1;
  const bool own_px = pixel || n_lanes == n_px;
  const bool aligned = (uintptr_t)act % kBytes == 0;
  auto px_of = [&](int b) { return own_px ? b : b % px_n; };
  // the lanes of live byte b: b + s * n_px of each sample s of a pixel
  // mask, else b alone
  auto run = [&](int b) {
    const int px = px_of(b);
    for (int s = 0; s < reps; ++s) work((int64_t)(b + s * px_n), px);
  };
  // byte 32 j + off of the mask is this thread's first in slice j: unit
  // lane / kPer of the slice, its (lane % kPer)-th kBytes
  const int n_slices = (int)u.n_units;
  const int span = 32 * n_slices;  // bytes between a slice's units
  const int off = (lane / kPer) * span + (lane % kPer) * kBytes;
  // slice jj's words; none past the last slice
  auto words = [&](int jj) {
    return jj < n_slices ? slice_words<kBytes>(act, aligned, 32 * jj + off,
                                               n)
                         : SliceWords<kBytes>{};
  };
  const int step = (int)u.stride();
  int j = (int)u.first();
  SliceWords<kBytes> w = words(j);
  for (; j < n_slices; j += step) {
    const SliceWords<kBytes> next = words(j + step);  // in flight
    const unsigned bits = live_bits(w);
    w = next;
    // on a unit's first thread: the unit's 32 bits, bit m its byte m
    unsigned g = bits;
#pragma unroll
    for (int k = 1; k < kPer; ++k)
      g |= __shfl_down_sync(0xffffffffu, bits, k) << (k * kBytes);
    unsigned units = __ballot_sync(0xffffffffu, lane % kPer == 0 && g);
    while (units != 0u) {
      const int src = __ffs(units) - 1;
      units &= units - 1u;
      const unsigned live = __shfl_sync(0xffffffffu, g, src);
      // this lane's byte of the unit
      const int b = (src / kPer) * span + 32 * j + lane;
      if constexpr (kPairs) {
        if (live == 0xffffffffu && units != 0u && reps == 1) {
          const int src2 = __ffs(units) - 1;
          if (__shfl_sync(0xffffffffu, g, src2) == 0xffffffffu) {
            units &= units - 1u;
            const int b2 = (src2 / kPer) * span + 32 * j + lane;
            const int p1 = px_of(b), p2 = px_of(b2);
            work((int64_t)b, p1);
            work((int64_t)b2, p2);
            continue;
          }
        }
      }
      if ((live >> lane) & 1u) run(b);
    }
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
