// The analytic scene on the device: its constants (AnScene, filled on the
// host by ops/an_cuda.py:scene_struct), the closest hit against its five
// primitives and the sky.  Included by an_direct.cu (K3's shadow traces
// and the environment of its mirror and glass lanes) and an_trace.cu (the
// scene's closest-hit, AO, GI bounce and sky kernels), so that every
// analytic trace and every sky lookup of the port is one body.
//
// The material table is get_material's (ops/materials.py): the rows of
// the parameter block, the types resolved on the host; K3 and the glass
// and mirror kernels (an_shade.cu) read it with one body, and GI's tail
// (gi_tail_analytic) is one body for the mirror's mix (an_shade.cu) and
// the primary hit's (hit_mix.cu).
//
// The arithmetic is the plain PyTorch version's (ops/scene_analytic.py,
// ops/intersect.py) expression for expression: the floor's denominator
// guard |denom| < 1e-6, the sphere's near/far root fallback, each
// primitive taken where valid & t < best, in primitive order (the floor,
// the albedo, glass and mirror spheres, the marker); the sky is the
// cubemap times its intensity (cubemap.cuh) or the gradient.  Build with
// --fmad=false and without --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"
#include "cubemap.cuh"
#include "param_block.cuh"
#include "sampling.cuh"

constexpr int kMatRows = 5;   // material ids 0-3, then the grey fallback

// Scene constants and, for K3, the call's frame values, filled on the host
// (ops/an_cuda.py:scene_struct, scene_args).
struct AnScene {
  // the cubemap environment: the float32 [6, env_f, env_f, 3] table on the
  // device (null: the gradient sky); its intensity is the block's
  const float* env;
  const FrameRecord* frame;  // the frame index and ld2 of it (K3)
  // the parameters: point_light_world, sun_dir, sky_up, sun_li, sky_li,
  // point_light_color and _intensity, sky_top and sky_bottom, the
  // material table's mat_albedo, mat_spec and mat_gloss rows,
  // env_map_intensity, the AO constants
  const ParamBlock* prm;
  int env_f;
  float light_c[3], light_t[3], light_b[3];  // disk light center and frame
  float light_nneg[3];                       // -(disk light normal)
  float light_color[3];
  float light_radius;
  float floor_n[3];
  float floor_d;
  float sphere_c[3][3];   // albedo, glass, mirror sphere centers
  float sphere_r2[3];     // their radius * radius
  float marker_r2;        // point-light marker radius * radius
  // get_material's types: rows for ids 0-3 (floor, albedo, glass, mirror
  // sphere) with the toggles resolved, row 4 for every other id (the
  // marker); the rows' values are the block's
  int mat_type[kMatRows];  // 0 diffuse, 1 mirror, 2 glass
  float bvh_albedo[3];     // the BVH scene's white plastic
  float bvh_spec, bvh_gloss;
  float eps;
  // frame_index (the record's index itself) and rng_frame as frame values
  FrameAffine cp;
  FrameAffine smp;
  float pi_4, pi_2;        // PI / 4.0 and PI / 2.0 rounded to float32
  int sun_e, sky_e, point_e;
};

__device__ __forceinline__ V3 c3(const float* a) { return {a[0], a[1], a[2]}; }

// intersect.intersect_sphere folded into trace_analytic_core's closest-t
// rule (valid & t < best): whether the sphere's root is taken, `best`
// updated to it.
__device__ __forceinline__ bool sphere_closer(float& best, V3 o, V3 d, V3 c,
                                              float r2, float eps) {
  const V3 oc = sub3(o, c);
  const float b = dot3(oc, d);
  const float c2 = dot3(oc, oc) - r2;
  const float disc = b * b - c2;
  // a missed sphere (disc < 0, NaN included) is not taken whatever the
  // root: skip the sqrtf and what follows, the same bits
  if (!(disc >= 0.0f)) return false;
  const float s = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = -b - s;
  const float t_far = -b + s;
  const float t = t_near < eps ? t_far : t_near;
  if (!(disc >= 0.0f && t >= eps && t < best)) return false;
  best = t;
  return true;
}

// The closest hit along o + t*d: t (kInf on a miss) and the primitive
// taken, as the winner of the kAn* ids below (kAnMiss on a miss).
struct AnHit {
  float t;
  int k;
};

constexpr int kAnMiss = -1, kAnFloor = 0, kAnMarker = 4;  // spheres 1-3

// trace_analytic_core: the floor, the albedo sphere, the glass sphere (if
// `glass`), the mirror sphere and the point-light marker (if `marker`), in
// that order, each taken where valid & t < best.
__device__ __forceinline__ AnHit trace_closest(const AnScene& s, V3 o, V3 d,
                                               bool glass, bool marker,
                                               float eps) {
  const V3 fn = c3(s.floor_n);
  const float denom = dot3(d, fn);
  const float safe = fabsf(denom) < 1e-6f ? 1.0f : denom;
  const float tf = -(dot3(o, fn) + s.floor_d) / safe;
  AnHit h = {kInf, kAnMiss};
  if (fabsf(denom) >= 1e-6f && tf >= eps && tf < h.t) h = {tf, kAnFloor};
  // the spheres unrolled: no dynamic index into the by-value struct
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k == 1 && !glass) continue;
    if (sphere_closer(h.t, o, d, c3(s.sphere_c[k]), s.sphere_r2[k], eps))
      h.k = k + 1;
  }
  if (marker && sphere_closer(h.t, o, d, c3(s.prm->point_light_world),
                              s.marker_r2, eps))
    h.k = kAnMarker;
  return h;
}

// Closest-hit t (kInf on a miss) against the whole scene, the marker if
// `marker`: the shadow traces of K3 (occluded_toward and the sun's and
// point light's rays).
__device__ __forceinline__ float trace_t(const AnScene& s, V3 o, V3 d,
                                         bool marker) {
  return trace_closest(s, o, d, true, marker, s.eps).t;
}

// scene_analytic.sky's gradient, mix(top, bottom, 1 - t)
__device__ __forceinline__ V3 gradient_sky(const AnScene& s, V3 d) {
  const float t = fminf(fmaxf(0.5f * (d.y + 1.0f), 0.0f), 1.0f);
  const V3 top = c3(s.prm->sky_top);
  return add3(top, scale3(sub3(c3(s.prm->sky_bottom), top), 1.0f - t));
}

// scene_analytic.sky: the cubemap times its intensity when the scene has
// one, else the gradient
__device__ __forceinline__ V3 sky(const AnScene& s, V3 d) {
  if (s.env != nullptr)
    return scale3(sample_cubemap(s.env, s.env_f, d),
                  s.prm->env_map_intensity[0]);
  return gradient_sky(s, d);
}

// sky()'s cubemap read from its [6, F, F, 4] copy `texels`, the same
// bits
__device__ __forceinline__ V3 texel_sky(const AnScene& s,
                                        const float4* __restrict__ texels,
                                        V3 d) {
  return scale3(sample_cubemap4(texels, s.env_f, d),
                s.prm->env_map_intensity[0]);
}

// sky() in the kernels built once with a cubemap and once with the
// gradient (kCube: the sky kernel, the BVH hit mix, glass's and the
// mirror's rays), so that a gradient call does not carry the taps'
// registers: the cubemap's taps from its [6, F, F, 4] copy, else the
// gradient
template <bool kCube>
__device__ __forceinline__ V3 cube_or_gradient_sky(
    const AnScene& s, const float4* __restrict__ texels, V3 d) {
  return kCube ? texel_sky(s, texels, d) : gradient_sky(s, d);
}

// get_material's row of material id `id`.
struct Material {
  V3 albedo;
  float spec, gloss, ior;
  int type;
};

// the table's row of material id `id`: ids 0-3, else the last
__device__ __forceinline__ int material_row(int id) {
  return (id >= 0 && id < kMatRows - 1) ? id : kMatRows - 1;
}

// get_material's type of material id `id` (0 diffuse, 1 mirror, 2 glass)
__device__ __forceinline__ int material_type(const AnScene& s, int id) {
  const int row = material_row(id);
  int type = s.mat_type[0];
  // a select chain: no dynamic index into the by-value struct
#pragma unroll
  for (int r = 1; r < kMatRows; ++r) {
    if (r == row) type = s.mat_type[r];
  }
  return type;
}

__device__ __forceinline__ Material material(const AnScene& s, int id) {
  const int row = material_row(id);
  const ParamBlock* b = s.prm;
  return {c3(b->mat_albedo + 3 * row), b->mat_spec[row], b->mat_gloss[row],
          b->mat_ior[row], material_type(s, id)};
}

// one_bounce_gi_analytic's tail (lighting.gi_tail_analytic) on lane i of a
// hit of material id `id`: the bounce's light `lit` where it hit (its t <
// 1e30) against its sky, times albedo * (cos * inv_pi), 0 where cos <= 0.
// The bounce's outputs are read a row a lane; `inv_pi` is float32(1 /
// float32(PI)), as PyTorch's CUDA cos / PI multiplies by it.
__device__ __forceinline__ V3 gi_tail_analytic(const AnScene& s, int id,
                                               float inv_pi,
                                               const float* __restrict__ t,
                                               const float* __restrict__ cos,
                                               const float* __restrict__ lit,
                                               const float* __restrict__ sky,
                                               int64_t i) {
  const V3 li = __ldg(t + i) < kInf ? row3(lit, i) : row3(sky, i);
  const float cs = __ldg(cos + i);
  if (!(cs > 0.0f)) return {0.0f, 0.0f, 0.0f};
  return mul3(scale3(material(s, id).albedo, cs * inv_pi), li);
}
