// Cubemap environment lookup per lane: ops/cubemap.py's
// direction_to_face_uv and sample_cubemap for one direction.  Included by
// an_direct.cu, whose analytic direct-light kernel samples the
// environment of the reflected view on its mirror and glass lanes.
//
// The table is the float32 [6, F, F, 3] tensor of
// convert.env_from_numpy, read through a plain pointer: a few percent of
// a frame's lanes sample it, the four taps of a lane are neighbours, and
// a 64x64-face table (295 KB) stays in L2, so no texture object is used.
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

// cubemap.sample_cubemap: env [6, f, f, 3] float32, one direction.
__device__ __forceinline__ V3 sample_cubemap(const float* __restrict__ env,
                                             int f, V3 d) {
  const FaceUV uv = direction_to_face_uv(d);
  const Taps x = bilinear_taps(uv.s, f);
  const Taps y = bilinear_taps(uv.t, f);
  const int row0 = (uv.face * f + y.i0) * f;
  const int row1 = (uv.face * f + y.i1) * f;
  const V3 c00 = ldg3(env + 3 * (row0 + x.i0));
  const V3 c01 = ldg3(env + 3 * (row0 + x.i1));
  const V3 c10 = ldg3(env + 3 * (row1 + x.i0));
  const V3 c11 = ldg3(env + 3 * (row1 + x.i1));
  const V3 top = add3(c00, scale3(sub3(c01, c00), x.frac));
  const V3 bot = add3(c10, scale3(sub3(c11, c10), x.frac));
  return add3(top, scale3(sub3(bot, top), y.frac));
}
