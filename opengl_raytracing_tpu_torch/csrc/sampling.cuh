// The port's one device RNG and its samplers: the uint32 hash of
// sampling.rand, the pixel-centre grids read in place, and the cosine
// hemisphere sample with its orthonormal basis (hemisphere_dir: the
// sample in a basis built once).  Included by an_direct.cu
// (the disk-light offsets of K3 and the BVH direct light) and
// bvh_trace.cu (the AO rays and the GI bounce ray).
//
// The arithmetic is sampling.py's expression for expression, so a kernel
// draws the plain version's bits: the hash in native uint32; the
// coordinates truncated after max(x, 0); phi = float32(2 * PI) * ux, the
// Python scalar rounded to float32 on the host as PyTorch rounds it;
// IEEE sqrtf, cosf, sinf and division (build with --fmad=false and
// without --use_fast_math); d = (x*t + z*b) + y*nn, then normalize.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

// 32-bit division where both fit (a 64-bit one is a long subroutine)
__device__ __forceinline__ int64_t div_index(int64_t i, int64_t d) {
  return ((i | d) >> 32) ? i / d : (int64_t)((uint32_t)i / (uint32_t)d);
}

// The pixel-centre grids of a call, read in place: lane i is pixel
// q = i % n_px of sample i / n_px (n_px the pixels of one sample: the
// whole call where it has no sample axis), and pixel q is (r, c) =
// (q / cols, q % cols) of the grids' [rows, cols] view; its px is
// px[r * px_sr + c * px_sc] (a broadcast grid has a zero stride).
struct PixelGrid {
  const float* px;
  const float* py;
  int64_t cols, n_px, px_sr, px_sc, py_sr, py_sc;
};

// the sample of lane i (ops/cuda_lib.py:pixel_grid)
__device__ __forceinline__ uint32_t sample_of(const PixelGrid& g,
                                              int64_t i) {
  return (uint32_t)div_index(i, g.n_px);
}

__device__ __forceinline__ void pixel_centre(const PixelGrid& g, int64_t i,
                                             float* px, float* py) {
  const int64_t q = i - div_index(i, g.n_px) * g.n_px;
  const int64_t r = div_index(q, g.cols);
  const int64_t c = q - r * g.cols;
  *px = __ldg(g.px + r * g.px_sr + c * g.px_sc);
  *py = __ldg(g.py + r * g.py_sr + c * g.py_sc);
}

// The frame's record on the device (sampling.frame_record; the first
// words of the frame block, models/frame_block.py): the frame index and
// ld2(index) in float32.  A kernel reads it through a pointer, so its
// arguments are the same for every frame and a captured CUDA graph
// replays it for any frame.
struct FrameRecord {
  int32_t index;
  float ld[2];
};

// int32(index * a + b + s * c) of sample s as uint32 bits: a frame value
// of sampling.py (`FrameValue`), its (a, b, c) constant per configuration
// (c = 0: the same value for every sample).
struct FrameAffine {
  uint32_t a, b, c;
};

__device__ __forceinline__ uint32_t frame_index(const FrameRecord* f) {
  return (uint32_t)__ldg(&f->index);
}

__device__ __forceinline__ uint32_t frame_value(uint32_t index,
                                                FrameAffine v,
                                                uint32_t sample = 0) {
  return index * v.a + v.b + sample * v.c;
}

// float32 of the int32 value (sampling.frame_f32)
__device__ __forceinline__ float frame_f32(uint32_t bits) {
  return (float)(int32_t)bits;
}

__device__ __forceinline__ uint32_t lcg(uint32_t v) {
  return v * 1664525u + 1013904223u;
}

// sampling.hash2
__device__ __forceinline__ uint32_t hash2(uint32_t vx, uint32_t vy) {
  vx = lcg(vx);
  vy = lcg(vy);
  vx = vx ^ (vy >> 16);
  vy = vy ^ (vx << 5);
  return lcg(vx) ^ lcg(vy);
}

// sampling.rand's xor keys of a frame value: its bits and bits * 1663
__device__ __forceinline__ uint32_t key_y(uint32_t frame_bits) {
  return frame_bits * 1663u;
}

// sampling.rand with the frame's xor keys: the coordinates truncate after
// max(x, 0); a hash of 2^32 - 128 or more rounds to 2^32, so the result
// can be exactly 1.0, as in PyTorch.
__device__ __forceinline__ float rand01(float x, float y, uint32_t kx,
                                        uint32_t ky) {
  const uint32_t ux = (uint32_t)fmaxf(x, 0.0f) ^ kx;
  const uint32_t uy = (uint32_t)fmaxf(y, 0.0f) ^ ky;
  return __uint2float_rn(hash2(ux, uy)) / 4294967296.0f;
}

// sampling.build_onb: (t, b) around the unit normal n.  At n = (+0, 1, +0)
// exactly (the analytic floor's hits) the result is taken without the
// normalize, with the same bits: there up = (1, 0, 0) and the cross
// products' zeros are +0 - +0, so t = (+0, +0, 1) and b = (1, +0, +0).
__device__ __forceinline__ void build_onb(V3 n, V3* t, V3* b) {
  if (__float_as_uint(n.x) == 0u && n.y == 1.0f &&
      __float_as_uint(n.z) == 0u) {
    *t = {0.0f, 0.0f, 1.0f};
    *b = {1.0f, 0.0f, 0.0f};
    return;
  }
  const V3 up = fabsf(n.y) < 0.99f ? V3{0.0f, 1.0f, 0.0f}
                                   : V3{1.0f, 0.0f, 0.0f};
  *t = norm3(cross3(up, n));
  *b = cross3(n, *t);
}

// sampling.sample_hemisphere_cosine's direction in the basis (t, b, nn)
// that build_onb makes around nn = normalize(n); two_pi is
// float32(2.0 * PI).  A kernel that draws several samples around one
// normal builds the basis once.
__device__ __forceinline__ V3 hemisphere_dir(V3 t, V3 b, V3 nn, float ux,
                                             float uy, float two_pi) {
  const float phi = two_pi * ux;
  const float r = sqrtf(uy);
  const float x = r * cosf(phi);
  const float z = r * sinf(phi);
  const float y = sqrtf(fmaxf(1.0f - uy, 0.0f));
  return norm3(add3(add3(scale3(t, x), scale3(b, z)), scale3(nn, y)));
}

// sampling.sample_hemisphere_cosine; two_pi is float32(2.0 * PI)
__device__ __forceinline__ V3 hemisphere_cosine(V3 n, float ux, float uy,
                                                float two_pi) {
  const V3 nn = norm3(n);
  V3 t, b;
  build_onb(nn, &t, &b);
  return hemisphere_dir(t, b, nn, ux, uy, two_pi);
}
