// Cubemap environment lookup per lane: ops/cubemap.py's
// direction_to_face_uv and sample_cubemap for one direction.  Included
// (through an_scene.cuh) by an_direct.cu, whose analytic direct-light
// kernel samples the environment of the reflected view on its mirror and
// glass lanes, an_shade.cu, an_trace.cu's sky kernel and hit_mix.cu.
//
// The table is the float32 [6, F, F, 3] tensor of
// convert.env_from_numpy, read through a plain pointer: the four taps of
// a lane are neighbours, and a 64x64-face table (295 KB) stays in L2, so
// no texture object is used.  The sky kernel and the BVH hit mix, whose
// lanes look up scattered directions by the hundred thousand, read its
// [6, F, F, 4] copy instead (ops/an_cuda.py:env_texels, made once per
// table): each tap one aligned 16-byte load, where a 12-byte texel takes
// three loads and may straddle two 32-byte sectors.
//
// The arithmetic is the plain PyTorch version's expression for
// expression: the major axis by >= in the order x, y, z (a direction on
// a face diagonal picks the face the plain version picks), true division
// by max(ma, 1e-12), s * F - 0.5, floor and clamp to [0, F-1] in float,
// the fractions clamped to [0, 1], x1 = min(x0 + 1, F - 1) (CLAMP_TO_EDGE
// within a face, no seamless filtering), and the blend
// top + (bot - top) * fy per channel.  Build with --fmad=false and
// without --use_fast_math, so each operation rounds once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

struct FaceUV {
  int face;  // 0:+X 1:-X 2:+Y 3:-Y 4:+Z 5:-Z
  float s, t;
};

// cubemap.direction_to_face_uv
__device__ __forceinline__ FaceUV direction_to_face_uv(V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool x_major = ax >= ay && ax >= az;
  const bool y_major = !x_major && ay >= az;
  int face;
  float ma, sc, tc;
  if (x_major) {
    face = d.x >= 0.0f ? 0 : 1;
    ma = ax;
    sc = d.x >= 0.0f ? -d.z : d.z;
    tc = -d.y;
  } else if (y_major) {
    face = d.y >= 0.0f ? 2 : 3;
    ma = ay;
    sc = d.x;
    tc = d.y >= 0.0f ? d.z : -d.z;
  } else {
    face = d.z >= 0.0f ? 4 : 5;
    ma = az;
    sc = d.z >= 0.0f ? d.x : -d.x;
    tc = -d.y;
  }
  ma = fmaxf(ma, 1e-12f);
  return {face, 0.5f * (sc / ma + 1.0f), 0.5f * (tc / ma + 1.0f)};
}

// One axis of the bilinear fetch: the two texel indices and the fraction.
struct Taps {
  int i0, i1;
  float frac;
};

__device__ __forceinline__ Taps bilinear_taps(float u, int f) {
  const float ff = (float)f;
  const float xs = u * ff - 0.5f;
  const float x0 = fminf(fmaxf(floorf(xs), 0.0f), ff - 1.0f);
  const int i0 = (int)x0;
  return {i0, min(i0 + 1, f - 1), fminf(fmaxf(xs - x0, 0.0f), 1.0f)};
}

// The four taps of a direction's bilinear fetch: their texel indices
// (face, row, column flattened) and the two fractions.
struct CubeTaps {
  int k00, k01, k10, k11;
  float fx, fy;
};

__device__ __forceinline__ CubeTaps cube_taps(int f, V3 d) {
  const FaceUV uv = direction_to_face_uv(d);
  const Taps x = bilinear_taps(uv.s, f);
  const Taps y = bilinear_taps(uv.t, f);
  const int row0 = (uv.face * f + y.i0) * f;
  const int row1 = (uv.face * f + y.i1) * f;
  return {row0 + x.i0, row0 + x.i1, row1 + x.i0, row1 + x.i1, x.frac,
          y.frac};
}

// the blend top + (bot - top) * fy of the rows' lerps
__device__ __forceinline__ V3 cube_blend(const CubeTaps& k, V3 c00, V3 c01,
                                         V3 c10, V3 c11) {
  const V3 top = add3(c00, scale3(sub3(c01, c00), k.fx));
  const V3 bot = add3(c10, scale3(sub3(c11, c10), k.fx));
  return add3(top, scale3(sub3(bot, top), k.fy));
}

// cubemap.sample_cubemap: env [6, f, f, 3] float32, one direction.
__device__ __forceinline__ V3 sample_cubemap(const float* __restrict__ env,
                                             int f, V3 d) {
  const CubeTaps k = cube_taps(f, d);
  return cube_blend(k, ldg3(env + 3 * k.k00), ldg3(env + 3 * k.k01),
                    ldg3(env + 3 * k.k10), ldg3(env + 3 * k.k11));
}

__device__ __forceinline__ V3 texel4(const float4* __restrict__ env, int k) {
  const float4 c = __ldg(env + k);
  return {c.x, c.y, c.z};
}

// sample_cubemap on the table's [6, f, f, 4] copy: the same bits.
__device__ __forceinline__ V3 sample_cubemap4(const float4* __restrict__ env,
                                              int f, V3 d) {
  const CubeTaps k = cube_taps(f, d);
  return cube_blend(k, texel4(env, k.k00), texel4(env, k.k01),
                    texel4(env, k.k10), texel4(env, k.k11));
}
