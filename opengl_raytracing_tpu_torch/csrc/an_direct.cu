// Direct light per pixel for Hopper (sm_90a): the analytic scene's whole
// direct-light tree, and the BVH scene's BRDF tail.
//
// an_direct_light_kernel replaces the TPU kernel K3,
//   opengl_raytracing_tpu/ops/an_pallas.py  _kernel
//   (launched by direct_light_pallas);
// bvh_brdf_kernel replaces the TPU kernel K5,
//   opengl_raytracing_tpu/ops/an_pallas.py  _kernel_bvh
//   (launched by shade_bvh_brdf_pallas).
//
// Design: one thread per pixel.  A pixel's p, n, v (and, for the analytic
// scene, albedo, env reflection, spec, gloss and material type) are read
// as rows; the scene constants arrive by value in one struct; the unit
// disk offsets of the soft shadow samples stream in as [2S, N] planes,
// because their hash/sin chain stays in PyTorch, where the tests hold it
// bit-exact.  K3 traces its own shadow rays against the five analytic
// primitives (closest t only); K5 reads the occlusion bytes the any-hit
// BVH kernel wrote, [k, N] as they are.  Mirror and glass pixels of K3
// return their env reflection before any shadow work: the plain version
// computes the diffuse tree for them too and then throws it away.
//
// The arithmetic is the plain PyTorch version's (ops/lighting.py,
// ops/scene_analytic.py, ops/intersect.py) expression for expression:
// dot products summed left to right, normalize as x / max(sqrt(max(d, 0)),
// 1e-12), the disk points as (center + T*(dx*R)) + B*(dy*R), the point
// light's radiance as color * (I / max(d2, 1e-4)), the view direction
// normalised once more for the sun and point terms, pow as powf.  Built
// with --fmad=false and without --use_fast_math, so every operation rounds
// once, as in PyTorch; only the libraries' pow differs in the last bits.
//
// What bounds it on this card: the arithmetic.  K3 does six shadow traces
// against four or five primitives and six Lambert-Phong terms (with a
// powf each) per diffuse pixel for 128 bytes of input; K5 reads about 80
// bytes and does six BRDF terms.  Neither touches device memory beyond its
// inputs and its 12-byte output, so both run at the rate of the FP32
// pipes and the special-function units, with no shared memory.
//
// Left for later: the disk offsets in-kernel (the hash chain is integer
// arithmetic and two sincos), which would drop ten elementwise PyTorch
// passes and the 32 bytes/pixel stream; the glass/mirror secondary traces
// fused into K3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr float kPi = 3.1415926535f;
constexpr int kThreads = 128;
constexpr int kSamples = 4;  // SOFT_SHADOW_SAMPLES

}  // namespace

// Scene constants, filled on the host (ops/an_cuda.py:_scene_args).
struct AnScene {
  float light_c[3], light_t[3], light_b[3];  // disk light center and frame
  float light_nneg[3];                       // -(disk light normal)
  float light_color[3];
  float light_radius;
  float floor_n[3];
  float floor_d;
  float sphere_c[3][3];   // albedo, glass, mirror sphere centers
  float sphere_r2[3];     // their radius * radius
  float marker_r2;        // point-light marker radius * radius
  float point[3];         // point-light position (= marker center)
  float sun_l[3];         // -sun_dir
  float sky_up[3];
  float sun_li[3];        // sun color * intensity
  float sky_li[3];        // sky color * intensity
  float point_color[3];
  float point_intensity;
  float bvh_albedo[3];    // the BVH scene's white plastic
  float bvh_spec, bvh_gloss;
  float eps;
  int sun_e, sky_e, point_e;
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 c3(const float* a) { return {a[0], a[1], a[2]}; }

__device__ __forceinline__ V3 load3(const float* __restrict__ p,
                                    int64_t i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
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

// vecmath.normalize: x / max(length(x), 1e-12)
__device__ __forceinline__ V3 norm3(V3 a) {
  const float ln = fmaxf(sqrtf(fmaxf(dot3(a, a), 0.0f)), 1e-12f);
  return {a.x / ln, a.y / ln, a.z / ln};
}

// intersect.intersect_sphere: (t, valid) folded into the closest-t rule
// of scene_analytic.trace_analytic_core (valid & t < best).
__device__ __forceinline__ float sphere_t(float best, V3 o, V3 d, V3 c,
                                          float r2, float eps) {
  const V3 oc = sub3(o, c);
  const float b = dot3(oc, d);
  const float c2 = dot3(oc, oc) - r2;
  const float disc = b * b - c2;
  const float s = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = -b - s;
  const float t_far = -b + s;
  const float t = t_near < eps ? t_far : t_near;
  return (disc >= 0.0f && t >= eps && t < best) ? t : best;
}

// Closest-hit t (kInf on a miss) against the floor, the three spheres
// and, if `marker`, the point-light marker: trace_analytic_core without
// the normal and material bookkeeping.
__device__ float trace_t(const AnScene& s, V3 o, V3 d, bool marker) {
  const V3 fn = c3(s.floor_n);
  const float denom = dot3(d, fn);
  const float safe = fabsf(denom) < 1e-6f ? 1.0f : denom;
  const float tf = -(dot3(o, fn) + s.floor_d) / safe;
  float best = kInf;
  if (fabsf(denom) >= 1e-6f && tf >= s.eps && tf < best) best = tf;
  for (int k = 0; k < 3; ++k)
    best = sphere_t(best, o, d, c3(s.sphere_c[k]), s.sphere_r2[k], s.eps);
  if (marker) best = sphere_t(best, o, d, c3(s.point), s.marker_r2, s.eps);
  return best;
}

// lighting.shade_lambert_phong for one light sample.
__device__ __forceinline__ V3 lambert_phong(V3 n, V3 v, V3 l, V3 li,
                                            V3 albedo, float spec_strength,
                                            float gloss) {
  const float ndl = fmaxf(dot3(n, l), 0.0f);
  const float kd = ndl / kPi;
  const V3 h = norm3(add3(l, v));
  const float ndh = fmaxf(dot3(n, h), 0.0f);
  const float phong = powf(ndh, gloss);
  const float spec = spec_strength > 0.0f ? spec_strength * phong : 0.0f;
  if (!(ndl > 0.0f)) return {0.0f, 0.0f, 0.0f};
  return {(albedo.x * kd + spec) * li.x, (albedo.y * kd + spec) * li.y,
          (albedo.z * kd + spec) * li.z};
}

// Sample `k`'s point on the disk light (lighting._disk_points).
__device__ __forceinline__ V3 disk_point(const AnScene& s,
                                         const float* __restrict__ offs,
                                         int k, int64_t i, int64_t n_px) {
  const float dxr = __ldg(offs + (2 * k) * n_px + i) * s.light_radius;
  const float dyr = __ldg(offs + (2 * k + 1) * n_px + i) * s.light_radius;
  return add3(add3(c3(s.light_c), scale3(c3(s.light_t), dxr)),
              scale3(c3(s.light_b), dyr));
}

// One disk sample's term of lighting._disk_light_sum, given its point
// `xl` and whether it is occluded.
__device__ __forceinline__ V3 disk_term(const AnScene& s, V3 p, V3 n, V3 v,
                                        V3 xl, bool occ, V3 albedo,
                                        float spec, float gloss) {
  const V3 delta = sub3(xl, p);
  const V3 l = norm3(delta);
  const float ndl = fmaxf(dot3(n, l), 0.0f);
  const float ctl = fmaxf(dot3(c3(s.light_nneg), l), 0.0f);
  const float r2 = fmaxf(dot3(delta, delta), 1e-4f);
  const float geom = ndl * ctl / r2;
  const float gv = geom * (occ ? 0.0f : 1.0f);
  const V3 li = {s.light_color[0] * gv, s.light_color[1] * gv,
                 s.light_color[2] * gv};
  return lambert_phong(n, v, l, li, albedo, spec, gloss);
}

// lighting.sun_direct with the shadow already decided.
__device__ __forceinline__ V3 sun_term(const AnScene& s, V3 n, V3 vv,
                                       bool blocked, V3 albedo, float spec,
                                       float gloss) {
  const V3 l = c3(s.sun_l);
  const float ndl = fmaxf(dot3(n, l), 0.0f);
  const V3 out = lambert_phong(n, vv, l, c3(s.sun_li), albedo, spec, gloss);
  if (ndl > 0.0f && !blocked) return out;
  return {0.0f, 0.0f, 0.0f};
}

// lighting.sky_direct
__device__ __forceinline__ V3 sky_term(const AnScene& s, V3 n, V3 albedo) {
  const float ndl = fmaxf(dot3(n, c3(s.sky_up)), 0.0f);
  return mul3(scale3(albedo, ndl / kPi), c3(s.sky_li));
}

// lighting.point_direct; `blocked_in` < 0 asks for the analytic shadow
// trace (lighting._point_shadow_query, marker ignored), else it is the
// traced bit.
__device__ __forceinline__ V3 point_term(const AnScene& s, V3 p, V3 n,
                                         V3 vv, int blocked_in, V3 albedo,
                                         float spec, float gloss) {
  const V3 to_l = sub3(c3(s.point), p);
  const float dist2 = dot3(to_l, to_l);
  const float dist = sqrtf(fmaxf(dist2, 1e-20f));
  const V3 l = {to_l.x / dist, to_l.y / dist, to_l.z / dist};
  const float ndl = fmaxf(dot3(n, l), 0.0f);
  bool blocked = blocked_in > 0;
  if (blocked_in < 0) {
    const float peps = fmaxf(1e-3f * dist, 1e-4f);
    const float t = trace_t(s, add3(p, scale3(l, peps)), l, false);
    blocked = t < kInf && t < dist - peps;
  }
  const float fall = s.point_intensity / fmaxf(dist2, 1e-4f);
  const V3 li = {s.point_color[0] * fall, s.point_color[1] * fall,
                 s.point_color[2] * fall};
  const V3 out = lambert_phong(n, vv, l, li, albedo, spec, gloss);
  if (dist2 > 1e-6f && ndl > 0.0f && !blocked) return out;
  return {0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ void store3(float* __restrict__ out, int64_t i,
                                       V3 c) {
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

// K3: lighting.direct_light_plain per pixel.
__global__ void __launch_bounds__(kThreads)
an_direct_light_kernel(const AnScene s, const float* __restrict__ p_in,
                       const float* __restrict__ n_in,
                       const float* __restrict__ v_in,
                       const float* __restrict__ albedo_in,
                       const float* __restrict__ spec_in,
                       const float* __restrict__ gloss_in,
                       const int32_t* __restrict__ mtype_in,
                       const float* __restrict__ sky_r_in,
                       const float* __restrict__ offs, int64_t n_px,
                       float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_px) return;
  const V3 n = load3(n_in, i);
  const V3 albedo = load3(albedo_in, i);
  const int mt = __ldg(mtype_in + i);
  if (mt == 1 || mt == 2) {
    // mirror: tinted env reflection; glass: plus the sky's diffuse term
    V3 c = mul3(load3(sky_r_in, i), albedo);
    if (mt == 2 && s.sky_e) c = add3(c, sky_term(s, n, albedo));
    store3(out, i, c);
    return;
  }
  const V3 p = load3(p_in, i);
  const V3 v = load3(v_in, i);
  const float spec = __ldg(spec_in + i);
  const float gloss = __ldg(gloss_in + i);
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kSamples; ++k) {
    const V3 xl = disk_point(s, offs, k, i, n_px);
    // lighting.occluded_toward: _segment_shadow_query + the full trace
    const V3 delta = sub3(xl, p);
    const float max_t = sqrtf(fmaxf(dot3(delta, delta), 0.0f));
    const float ln = fmaxf(max_t, 1e-12f);
    const V3 rd = {delta.x / ln, delta.y / ln, delta.z / ln};
    const float seps = fmaxf(1e-3f * max_t, 1e-4f);
    const float t = trace_t(s, add3(p, scale3(rd, seps)), rd, s.point_e);
    const bool occ = t < kInf && t < max_t - seps;
    acc = add3(acc, disk_term(s, p, n, v, xl, occ, albedo, spec, gloss));
  }
  acc = {acc.x / (float)kSamples, acc.y / (float)kSamples,
         acc.z / (float)kSamples};
  const float spec_d = mt == 0 ? spec : 0.0f;
  const V3 vv = norm3(v);
  if (s.sun_e) {
    // any hit blocks the sun: no window (lighting.sun_direct)
    const bool blocked =
        trace_t(s, add3(p, scale3(n, 1.0f)), c3(s.sun_l), s.point_e) < kInf;
    acc = add3(acc, sun_term(s, n, vv, blocked, albedo, spec_d, gloss));
  }
  if (s.sky_e) acc = add3(acc, sky_term(s, n, albedo));
  if (s.point_e)
    acc = add3(acc, point_term(s, p, n, vv, -1, albedo, spec_d, gloss));
  store3(out, i, acc);
}

// K5: lighting.shade_bvh_brdf_plain per pixel; occ rows are the disk
// samples, then the sun (if on), then the point light (if on).
__global__ void __launch_bounds__(kThreads)
bvh_brdf_kernel(const AnScene s, const float* __restrict__ p_in,
                const float* __restrict__ n_in,
                const float* __restrict__ v_in,
                const float* __restrict__ offs,
                const uint8_t* __restrict__ occ, int64_t n_px,
                float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_px) return;
  const V3 p = load3(p_in, i);
  const V3 n = load3(n_in, i);
  const V3 v = load3(v_in, i);
  const V3 albedo = c3(s.bvh_albedo);
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kSamples; ++k) {
    const V3 xl = disk_point(s, offs, k, i, n_px);
    const bool o = __ldg(occ + k * n_px + i) != 0;
    acc = add3(acc, disk_term(s, p, n, v, xl, o, albedo, s.bvh_spec,
                              s.bvh_gloss));
  }
  acc = {acc.x / (float)kSamples, acc.y / (float)kSamples,
         acc.z / (float)kSamples};
  const V3 vv = norm3(v);
  int row = kSamples;
  if (s.sun_e) {
    const bool blocked = __ldg(occ + row * n_px + i) != 0;
    ++row;
    acc = add3(acc, sun_term(s, n, vv, blocked, albedo, s.bvh_spec,
                             s.bvh_gloss));
  }
  if (s.sky_e) acc = add3(acc, sky_term(s, n, albedo));
  if (s.point_e) {
    const int blocked = __ldg(occ + row * n_px + i) != 0 ? 1 : 0;
    acc = add3(acc, point_term(s, p, n, vv, blocked, albedo, s.bvh_spec,
                               s.bvh_gloss));
  }
  store3(out, i, acc);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes.  `scene` is a host pointer; the other
// pointers are device pointers; the stream is a cudaStream_t.  Each
// returns cudaGetLastError() as an int.
extern "C" int ort_an_direct(const AnScene* scene, const void* p,
                             const void* n, const void* v,
                             const void* albedo, const void* spec,
                             const void* gloss, const void* mtype,
                             const void* sky_r, const void* offs,
                             int64_t n_px, void* out, void* stream) {
  if (n_px > 0) {
    an_direct_light_kernel<<<blocks_for(n_px), kThreads, 0,
                             (cudaStream_t)stream>>>(
        *scene, (const float*)p, (const float*)n, (const float*)v,
        (const float*)albedo, (const float*)spec, (const float*)gloss,
        (const int32_t*)mtype, (const float*)sky_r, (const float*)offs, n_px,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int ort_bvh_brdf(const AnScene* scene, const void* p,
                            const void* n, const void* v, const void* offs,
                            const void* occ, int64_t n_px, void* out,
                            void* stream) {
  if (n_px > 0) {
    bvh_brdf_kernel<<<blocks_for(n_px), kThreads, 0, (cudaStream_t)stream>>>(
        *scene, (const float*)p, (const float*)n, (const float*)v,
        (const float*)offs, (const uint8_t*)occ, n_px, (float*)out);
  }
  return (int)cudaGetLastError();
}

// The struct's size, so the host can check its mirror of the layout.
extern "C" int ort_an_scene_size() { return (int)sizeof(AnScene); }
