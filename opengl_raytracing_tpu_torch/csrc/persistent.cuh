// Persistent blocks over units of lanes, shared by the walk kernels of
// bvh_trace.cu (K1, the AO call) and both direct lights of an_direct.cu
// (K5's BVH direct light, K3's analytic one).
//
// A kernel launched by launch_persistent has as many blocks as fit the
// card at once (the SM count times the blocks an SM holds, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), and each of its warps
// loops over units of lanes, block-minor: warp w of block b takes unit
// w * gridDim.x + b, then every (warps in the grid)-th unit after, so
// neighbouring units land on different SMs.  A unit's warp reads the
// unit's mask bytes, takes __ballot_sync of its live lanes and works on
// those alone; a dead lane reads its mask byte and nothing else.  A
// kernel whose rows are shared by the samples (K3 on a sample batch's
// hit, whose mask is one a pixel) reads a lane's mask byte at its row,
// not at the lane, and so does not call is_live.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The units of a call: `unit` consecutive lanes each (a run of 32, or
// the AO call's 32 / S pixels).
struct Units {
  int64_t n_units;
  int unit;
  __device__ __forceinline__ int64_t first() const {
    return (int64_t)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  }
  __device__ __forceinline__ int64_t stride() const {
    return (int64_t)(blockDim.x >> 5) * gridDim.x;
  }
  __device__ __forceinline__ int64_t base(int64_t j) const {
    return j * unit;
  }
};

// Is lane `lane` of the unit at `base` a live lane of n?
__device__ __forceinline__ bool is_live(const uint8_t* __restrict__ active,
                                        const Units& u, int64_t base,
                                        int lane, int64_t n) {
  const int64_t i = base + lane;
  return lane < u.unit && i < n && (active == nullptr || __ldg(active + i));
}

inline Units make_units(int64_t n, int unit) {
  return {(n + unit - 1) / unit, unit};
}

// Launch kernel(u, args...) as persistent blocks of `threads` over the
// units of `u`.  Returns a cudaError_t as an int: of the set-up calls,
// else cudaGetLastError().
template <class Kernel, class... Args>
int launch_persistent(Kernel kernel, int threads, const Units& u,
                      cudaStream_t stream, Args... args) {
  if (u.n_units <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int warps = threads / 32;
  int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > (u.n_units + warps - 1) / warps)
    blocks = (u.n_units + warps - 1) / warps;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(u, args...);
  return (int)cudaGetLastError();
}
