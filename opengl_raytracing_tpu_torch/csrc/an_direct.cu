// Direct light per pixel for Hopper (sm_90a), from hit records to
// radiance in one launch: the analytic scene's whole direct-light tree,
// and the BVH scene's, shadow walks included.
//
// an_direct_light_kernel replaces the TPU kernel K3,
//   opengl_raytracing_tpu/ops/an_pallas.py  _kernel
//   (launched by direct_light_pallas);
// bvh_direct_kernel replaces the TPU kernel K5,
//   opengl_raytracing_tpu/ops/an_pallas.py  _kernel_bvh
//   (launched by shade_bvh_brdf_pallas),
// with the six shadow walks that the any-hit kernel (K2) traced for it
// folded in.
//
// Design: one thread per pixel, no shared memory.  A pixel's raw hit
// point, normal and view direction, its material id (K3) and its pixel
// centre are all it reads; the pixel-centre grids are read in place
// through their strides (a broadcast grid is a row or a column of
// floats), and only by lanes that need them.  The scene's fixed
// constants, the material types and light toggles (static parameters) and
// the (a, b) of the call's two frame values (rng_frame and frame_index =
// index * a + b) arrive by value in one struct, with a pointer to the
// frame's record (sampling.cuh: the frame index and ld2 of it, computed
// on the host with the JAX device Halton's float32 steps) and one to the
// parameter block (param_block.cuh: the lights, the sky, the material
// table with the glass/mirror toggles resolved on the host, the
// environment's intensity): the struct is the same for every frame and
// every value of the parameters, so a captured CUDA graph replays the
// call for any of them.  The RNG keys are derived here.  Everything else is
// computed here: normalize(n) and normalize(v), the material row, the
// environment of the reflected view (K3's mirror and glass: the cubemap
// when the scene has one, sampled per lane by cubemap.cuh from the table
// `AnScene::env` points to, else the gradient sky), and the
// unit-disk offsets of the four soft-shadow samples (lighting._disk_
// offsets: the uint32 hash of sampling.rand, cp_offset's rotation,
// remainder and concentric_sample).  K3 traces its shadow rays against
// the five analytic primitives (closest t only) and returns the env
// reflection for mirror and glass pixels before any shadow work.
// bvh_direct_kernel builds the four segment queries, the sun and the
// point query with their ndl gates (lighting._bvh_shadow_queries) and
// walks each open window with the any-hit walk of bvh_walk.cuh (node
// rows from device memory); a lane that `active` marks off (the caller's
// sky select drops it) does no work and writes nothing.  It reads the
// environment of no direction (its sky light is the constant-colour dome
// of sky_term), so a cubemap changes nothing in it.
//
// The arithmetic is the plain PyTorch version's (ops/lighting.py,
// ops/scene_analytic.py, ops/intersect.py, sampling.py) expression for
// expression: dot products summed left to right, normalize as
// x / max(sqrt(max(d, 0)), 1e-12), the disk points as
// (center + T*(dx*R)) + B*(dy*R), the point light's radiance as
// color * (I / max(d2, 1e-4)), the view direction normalised once more
// for the sun and point terms, pow as powf, IEEE cosf/sinf for the disk
// offsets.  Built with --fmad=false and without --use_fast_math, so
// every operation rounds once, as in PyTorch: the disk offsets equal the
// plain version's bit for bit, and only the libraries' pow differs in
// the last bits of the radiance.  An optional output (null on the main
// path) receives the offsets as [8, N] planes dx0, dy0, dx1, ... so a
// test can hold them to lighting._disk_offsets.
//
// What bounds it on this card.  A pixel reads 40 bytes (p, n, v and, for
// K3, the material id) and writes 12; a BVH lane that `active` marks off
// reads its mask byte and nothing else.  A diffuse pixel does the
// hash chain (ten rand draws), four concentric samples with a sincos
// each, six shadow traces (five analytic primitives each for K3, a BVH
// walk for each open window of the BVH scene) and six Lambert-Phong
// terms with a powf each.  K3 is bound by that arithmetic.  The BVH
// kernel's dead lanes leave at once, and its time is the latency of its
// longest live lane: one thread walks a pixel's windows one after
// another, each node fetch waiting on the last, and a frame has too few
// live warps per SM to hide that.  Spreading a pixel's walks over
// threads is the next step.
//
// The samples of a pixel (spp_per_frame > 1) arrive as one call over a
// leading sample axis, [spp, H, W] (models/pipeline.py:trace_and_shade,
// the JAX package's SPP batch).  Lane i of a call is pixel i % n_px of
// sample i / n_px (sampling.cuh: PixelGrid, sample_of), and draws its
// disk offsets from rng_frame at that sample (FrameAffine's per-sample
// stride c; 0 for a call without the axis, whose lanes all read sample
// 0).  K3 keeps a thread a lane.  The BVH kernel's primary call shares
// one hit among the samples (spp_dup), and there it takes a thread a
// pixel looping over the samples: the sun and point rays depend on the
// hit alone (the JAX package's spp_dup traces them for sample 0 and
// broadcasts its bits), so the thread reads the hit's rows, walks those
// two rays and computes their terms once, then walks each sample's four
// disk rays.  A thread a (sample, pixel) with the shared walks done once
// would need the samples of a pixel in one warp and a shuffle of the
// bits; the loop needs neither, and a sparse call's time is set by its
// longest live lane, which now walks 4 + 2 / spp windows a sample where
// it walked 6.  Its other calls (GI's, on hits that differ by sample)
// take a thread a lane, as without the axis.
//
// Left for later: the glass/mirror secondary traces fused into K3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"
#include "cubemap.cuh"
#include "param_block.cuh"
#include "sampling.cuh"

namespace {

constexpr float kPi = 3.1415926535f;
constexpr int kThreads = 128;
constexpr int kSamples = 4;   // SOFT_SHADOW_SAMPLES
constexpr int kMatRows = 5;   // material ids 0-3, then the grey fallback

}  // namespace

// Scene constants and the call's frame values, filled on the host
// (ops/an_cuda.py:scene_args).
struct AnScene {
  // the cubemap environment: the float32 [6, env_f, env_f, 3] table on the
  // device (null: the gradient sky); its intensity is the block's
  const float* env;
  const FrameRecord* frame;  // the frame index and ld2 of it
  // the parameters: point_light_world, sun_dir, sky_up, sun_li, sky_li,
  // point_light_color and _intensity, sky_top and sky_bottom, the
  // material table's mat_albedo, mat_spec and mat_gloss rows,
  // env_map_intensity
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

namespace {

__device__ __forceinline__ V3 c3(const float* a) { return {a[0], a[1], a[2]}; }

// ---- the disk offsets (lighting._disk_offsets), on sampling.cuh's hash ----

// torch.remainder(x, 1.0): fmod, then the sign fix for a negative rest
__device__ __forceinline__ float rem1(float x) {
  const float m = fmodf(x, 1.0f);
  return (m != 0.0f && m < 0.0f) ? m + 1.0f : m;
}

// sampling.concentric_sample
__device__ __forceinline__ void concentric(const AnScene& s, float ux,
                                           float uy, float* dx, float* dy) {
  const float a = 2.0f * ux - 1.0f;
  const float b = 2.0f * uy - 1.0f;
  const bool a_dom = fabsf(a) > fabsf(b);
  const float safe_a = fabsf(a) > 1e-20f ? a : 1.0f;
  const float safe_b = fabsf(b) > 1e-20f ? b : 1.0f;
  float r = a_dom ? a : b;
  float phi = a_dom ? s.pi_4 * (b / safe_a) : s.pi_2 - s.pi_4 * (a / safe_b);
  if (a == 0.0f && b == 0.0f) {
    r = 0.0f;
    phi = 0.0f;
  }
  *dx = r * cosf(phi);
  *dy = r * sinf(phi);
}

struct Rot {
  float x, y;
};

// sampling.cp_offset: the pixel's rotation of the sample pattern, from
// the frame index `f` (the keys of frame_index * 911 and * 577, and the
// record's ld2)
__device__ __forceinline__ Rot cp_rot(const AnScene& s, uint32_t f,
                                      float px, float py) {
  const uint32_t fi = frame_value(f, s.cp);
  const uint32_t kx = fi * 911u, kx2 = fi * 577u;
  const float hx = rand01(px, py, kx, key_y(kx));
  const float hy = rand01(py, px, kx2, key_y(kx2));
  return {rem1(hx + __ldg(&s.frame->ld[0])),
          rem1(hy + __ldg(&s.frame->ld[1]))};
}

// Sample k's unit-disk offset; `kx` is the key of the lane's rng_frame
// (frame_value of the index at the lane's sample).
__device__ __forceinline__ void disk_offset(const AnScene& s, uint32_t kx,
                                            float px, float py, Rot rot,
                                            int k, float* dx, float* dy) {
  const float fk = (float)k;
  const float off = (float)(31 * k + 7);
  const uint32_t ky = key_y(kx);
  const float ux = rand01(px + fk, py + fk, kx, ky);
  const float uy = rand01(py + off, px + off, kx, ky);
  concentric(s, rem1(ux + rot.x), rem1(uy + rot.y), dx, dy);
}

// The offsets of lane `lane` as [2S, n_lanes] planes, for the tests.
__device__ void write_offsets(const AnScene& s, uint32_t kx, float px,
                              float py, Rot rot, int64_t lane,
                              int64_t n_lanes, float* __restrict__ offs) {
  for (int k = 0; k < kSamples; ++k) {
    float dx, dy;
    disk_offset(s, kx, px, py, rot, k, &dx, &dy);
    offs[(2 * k) * n_lanes + lane] = dx;
    offs[(2 * k + 1) * n_lanes + lane] = dy;
  }
}

// lighting._disk_points for one offset
__device__ __forceinline__ V3 disk_point(const AnScene& s, float dx,
                                         float dy) {
  const float dxr = dx * s.light_radius;
  const float dyr = dy * s.light_radius;
  return add3(add3(c3(s.light_c), scale3(c3(s.light_t), dxr)),
              scale3(c3(s.light_b), dyr));
}

// ---- the analytic scene ----

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
  if (marker)
    best = sphere_t(best, o, d, c3(s.prm->point_light_world), s.marker_r2,
                    s.eps);
  return best;
}

// scene_analytic.sky: the cubemap times its intensity when the scene has
// one, else the gradient, mix(top, bottom, 1 - t)
__device__ __forceinline__ V3 sky(const AnScene& s, V3 d) {
  if (s.env != nullptr)
    return scale3(sample_cubemap(s.env, s.env_f, d),
                  s.prm->env_map_intensity[0]);
  const float t = fminf(fmaxf(0.5f * (d.y + 1.0f), 0.0f), 1.0f);
  const V3 top = c3(s.prm->sky_top);
  return add3(top, scale3(sub3(c3(s.prm->sky_bottom), top), 1.0f - t));
}

// vecmath.reflect(-v, n)
__device__ __forceinline__ V3 reflect_view(V3 v, V3 n) {
  const V3 i = {-v.x, -v.y, -v.z};
  return sub3(i, scale3(n, 2.0f * dot3(n, i)));
}

// ---- shading ----

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

// -sun_dir: the direction toward the sun
__device__ __forceinline__ V3 sun_l(const AnScene& s) {
  const float* d = s.prm->sun_dir;
  return {-d[0], -d[1], -d[2]};
}

// lighting.sun_direct with the shadow already decided.
__device__ __forceinline__ V3 sun_term(const AnScene& s, V3 n, V3 vv,
                                       bool blocked, V3 albedo, float spec,
                                       float gloss) {
  const V3 l = sun_l(s);
  const float ndl = fmaxf(dot3(n, l), 0.0f);
  const V3 out =
      lambert_phong(n, vv, l, c3(s.prm->sun_li), albedo, spec, gloss);
  if (ndl > 0.0f && !blocked) return out;
  return {0.0f, 0.0f, 0.0f};
}

// lighting.sky_direct
__device__ __forceinline__ V3 sky_term(const AnScene& s, V3 n, V3 albedo) {
  const float ndl = fmaxf(dot3(n, c3(s.prm->sky_up)), 0.0f);
  return mul3(scale3(albedo, ndl / kPi), c3(s.prm->sky_li));
}

// lighting.point_direct; `blocked_in` < 0 asks for the analytic shadow
// trace (lighting._point_shadow_query, marker ignored), else it is the
// traced bit.
__device__ __forceinline__ V3 point_term(const AnScene& s, V3 p, V3 n,
                                         V3 vv, int blocked_in, V3 albedo,
                                         float spec, float gloss) {
  const V3 to_l = sub3(c3(s.prm->point_light_world), p);
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
  const float fall = s.prm->point_light_intensity[0] / fmaxf(dist2, 1e-4f);
  const float* color = s.prm->point_light_color;
  const V3 li = {color[0] * fall, color[1] * fall, color[2] * fall};
  const V3 out = lambert_phong(n, vv, l, li, albedo, spec, gloss);
  if (dist2 > 1e-6f && ndl > 0.0f && !blocked) return out;
  return {0.0f, 0.0f, 0.0f};
}

// lighting._segment_shadow_query from p toward xl.
struct Query {
  V3 o, d;
  float win;
};

__device__ __forceinline__ Query segment_query(V3 p, V3 xl) {
  const V3 delta = sub3(xl, p);
  const float max_t = sqrtf(fmaxf(dot3(delta, delta), 0.0f));
  const float ln = fmaxf(max_t, 1e-12f);
  const V3 rd = {delta.x / ln, delta.y / ln, delta.z / ln};
  const float seps = fmaxf(1e-3f * max_t, 1e-4f);
  return {add3(p, scale3(rd, seps)), rd, max_t - seps};
}

__device__ __forceinline__ void store3(float* __restrict__ out, int64_t i,
                                       V3 c) {
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

// get_material's row of material id `id`.
struct Material {
  V3 albedo;
  float spec, gloss;
  int type;
};

__device__ __forceinline__ Material material(const AnScene& s, int id) {
  const int row = (id >= 0 && id < kMatRows - 1) ? id : kMatRows - 1;
  int type = s.mat_type[0];
  // a select chain: no dynamic index into the by-value struct
#pragma unroll
  for (int r = 1; r < kMatRows; ++r) {
    if (r == row) type = s.mat_type[r];
  }
  const ParamBlock* b = s.prm;
  return {c3(b->mat_albedo + 3 * row), b->mat_spec[row], b->mat_gloss[row],
          type};
}

// K3: lighting.direct_light_plain per lane.  Lane i is pixel i % n_px of
// sample i / n_px (the grid's; a call without a sample axis has one), and
// draws its disk offsets from rng_frame at that sample.
__global__ void __launch_bounds__(kThreads)
an_direct_light_kernel(const AnScene s, const float* __restrict__ p_in,
                       const float* __restrict__ n_in,
                       const float* __restrict__ v_in,
                       const int32_t* __restrict__ mat_in,
                       const PixelGrid g, int64_t n_lanes,
                       float* __restrict__ out,
                       float* __restrict__ offs_out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  if (offs_out != nullptr) {
    const uint32_t f = frame_index(s.frame);
    float px, py;
    pixel_centre(g, i, &px, &py);
    write_offsets(s, frame_value(f, s.smp, sample_of(g, i)), px, py,
                  cp_rot(s, f, px, py), i, n_lanes, offs_out);
  }
  const V3 n = norm3(row3(n_in, i));
  const V3 v = norm3(row3(v_in, i));
  const Material m = material(s, __ldg(mat_in + i));
  if (m.type == 1 || m.type == 2) {
    // mirror: tinted env reflection; glass: plus the sky's diffuse term
    V3 c = mul3(sky(s, reflect_view(v, n)), m.albedo);
    if (m.type == 2 && s.sky_e) c = add3(c, sky_term(s, n, m.albedo));
    store3(out, i, c);
    return;
  }
  const V3 p = row3(p_in, i);
  float px, py;
  pixel_centre(g, i, &px, &py);
  // the frame index, read by the lanes that draw samples only
  const uint32_t f = frame_index(s.frame);
  const Rot rot = cp_rot(s, f, px, py);
  const uint32_t kx = frame_value(f, s.smp, sample_of(g, i));
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kSamples; ++k) {
    float dx, dy;
    disk_offset(s, kx, px, py, rot, k, &dx, &dy);
    const V3 xl = disk_point(s, dx, dy);
    // lighting.occluded_toward: the segment query + the full trace
    const Query q = segment_query(p, xl);
    const float t = trace_t(s, q.o, q.d, s.point_e);
    const bool occ = t < kInf && t < q.win;
    acc = add3(acc, disk_term(s, p, n, v, xl, occ, m.albedo, m.spec,
                              m.gloss));
  }
  acc = {acc.x / (float)kSamples, acc.y / (float)kSamples,
         acc.z / (float)kSamples};
  const float spec_d = m.type == 0 ? m.spec : 0.0f;
  const V3 vv = norm3(v);
  if (s.sun_e) {
    // any hit blocks the sun: no window (lighting.sun_direct)
    const bool blocked =
        trace_t(s, add3(p, scale3(n, 1.0f)), sun_l(s), s.point_e) < kInf;
    acc = add3(acc, sun_term(s, n, vv, blocked, m.albedo, spec_d, m.gloss));
  }
  if (s.sky_e) acc = add3(acc, sky_term(s, n, m.albedo));
  if (s.point_e)
    acc = add3(acc, point_term(s, p, n, vv, -1, m.albedo, spec_d, m.gloss));
  store3(out, i, acc);
}

// K5 with its shadow walks: lighting.direct_light_bvh_plain for one unit,
// a thread a unit.  With `dup` = 1 a unit is one lane (pixel u % n_px of
// sample u / n_px, its own hit row).  With `dup` > 1 (spp_dup) a unit is
// one pixel of a hit shared by `dup` samples: its rows are read once, its
// sun and point walks and their terms are done once and shared, and the
// thread loops over the samples, each with its own disk offsets and four
// disk walks, writing lane k * n_units + u of sample k.  A window is
// walked only where the plain version leaves it open (its ndl gate passed
// and it is > 0); the walk is bvh_walk.cuh's any_hit.
__global__ void __launch_bounds__(kThreads)
bvh_direct_kernel(const AnScene s, const float4* __restrict__ bounds,
                  const int4* __restrict__ meta,
                  const float4* __restrict__ tris, int n_nodes,
                  const float* __restrict__ p_in,
                  const float* __restrict__ n_in,
                  const float* __restrict__ v_in, const PixelGrid g,
                  const uint8_t* __restrict__ active, int64_t n_units,
                  int dup, float* __restrict__ out,
                  float* __restrict__ offs_out) {
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= n_units) return;
  if (offs_out != nullptr) {
    const uint32_t s1 = sample_of(g, u);
    const uint32_t f = frame_index(s.frame);
    float px, py;
    pixel_centre(g, u, &px, &py);
    const Rot rot = cp_rot(s, f, px, py);
    for (int k = 0; k < dup; ++k)
      write_offsets(s, frame_value(f, s.smp, dup > 1 ? k : s1), px, py, rot,
                    dup > 1 ? k * n_units + u : u, n_units * dup, offs_out);
  }
  // an inactive lane's radiance is unspecified by contract: not written
  if (active != nullptr && !__ldg(active + u)) return;
  const uint32_t f = frame_index(s.frame);
  const uint32_t s1 = sample_of(g, u);  // the lane's sample where dup == 1
  float px, py;
  pixel_centre(g, u, &px, &py);
  const Rot rot = cp_rot(s, f, px, py);
  const V3 p = row3(p_in, u);
  const V3 n = norm3(row3(n_in, u));
  const V3 v = norm3(row3(v_in, u));
  const V3 albedo = c3(s.bvh_albedo);
  const V3 vv = norm3(v);
  // the sun, sky and point terms depend on the hit alone
  V3 sun_t = {0.0f, 0.0f, 0.0f}, sky_t = sun_t, point_t = sun_t;
  if (s.sun_e) {
    // lighting._sun_shadow_query: eps 1.0, window 999
    const V3 l = sun_l(s);
    const bool blocked =
        dot3(n, l) > 0.0f &&
        any_hit(bounds, meta, tris, n_nodes, add3(p, scale3(n, 1.0f)), l,
                999.0f, s.eps);
    sun_t = sun_term(s, n, vv, blocked, albedo, s.bvh_spec, s.bvh_gloss);
  }
  if (s.sky_e) sky_t = sky_term(s, n, albedo);
  if (s.point_e) {
    // lighting._point_shadow_query
    const V3 to_l = sub3(c3(s.prm->point_light_world), p);
    const float dist = sqrtf(fmaxf(dot3(to_l, to_l), 1e-20f));
    const V3 l = {to_l.x / dist, to_l.y / dist, to_l.z / dist};
    const float peps = fmaxf(1e-3f * dist, 1e-4f);
    const float win = dist - peps;
    const bool blocked =
        dot3(n, l) > 0.0f && win > 0.0f &&
        any_hit(bounds, meta, tris, n_nodes, add3(p, scale3(l, peps)), l,
                win, s.eps);
    point_t = point_term(s, p, n, vv, blocked ? 1 : 0, albedo, s.bvh_spec,
                         s.bvh_gloss);
  }
  for (int k = 0; k < dup; ++k) {
    const uint32_t kx = frame_value(f, s.smp, dup > 1 ? k : s1);
    V3 acc = {0.0f, 0.0f, 0.0f};
    for (int j = 0; j < kSamples; ++j) {
      float dx, dy;
      disk_offset(s, kx, px, py, rot, j, &dx, &dy);
      const V3 xl = disk_point(s, dx, dy);
      const Query q = segment_query(p, xl);
      const bool facing =
          dot3(n, q.d) > 0.0f && dot3(q.d, c3(s.light_nneg)) > 0.0f;
      const bool occ = facing && q.win > 0.0f &&
                       any_hit(bounds, meta, tris, n_nodes, q.o, q.d, q.win,
                               s.eps);
      acc = add3(acc, disk_term(s, p, n, v, xl, occ, albedo, s.bvh_spec,
                                s.bvh_gloss));
    }
    acc = {acc.x / (float)kSamples, acc.y / (float)kSamples,
           acc.z / (float)kSamples};
    if (s.sun_e) acc = add3(acc, sun_t);
    if (s.sky_e) acc = add3(acc, sky_t);
    if (s.point_e) acc = add3(acc, point_t);
    store3(out, dup > 1 ? k * n_units + u : u, acc);
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes.  `scene` and `grid` are host pointers
// (the grid's own pointers, `scene->env`, `scene->frame` and
// `scene->prm` are device pointers); the other pointers are
// device pointers (`active` and `offs` may be null); the stream is a
// cudaStream_t.  Each returns cudaGetLastError() as an int.
extern "C" int ort_an_direct(const AnScene* scene, const void* p,
                             const void* n, const void* v, const void* mat,
                             const PixelGrid* grid, int64_t n_lanes,
                             void* out, void* offs, void* stream) {
  if (n_lanes > 0) {
    an_direct_light_kernel<<<blocks_for(n_lanes), kThreads, 0,
                             (cudaStream_t)stream>>>(
        *scene, (const float*)p, (const float*)n, (const float*)v,
        (const int32_t*)mat, *grid, n_lanes, (float*)out, (float*)offs);
  }
  return (int)cudaGetLastError();
}

// `n_units` units of `dup` samples each (bvh_direct_kernel): the hit rows
// and `active` hold one row a unit, `out` and `offs` n_units * dup lanes.
extern "C" int ort_bvh_direct(const AnScene* scene, const void* bounds,
                              const void* meta, const void* tris, int n_nodes,
                              const void* p, const void* n, const void* v,
                              const PixelGrid* grid, const void* active,
                              int64_t n_units, int dup, void* out,
                              void* offs, void* stream) {
  if (n_units > 0 && dup > 0) {
    bvh_direct_kernel<<<blocks_for(n_units), kThreads, 0,
                        (cudaStream_t)stream>>>(
        *scene, (const float4*)bounds, (const int4*)meta,
        (const float4*)tris, n_nodes, (const float*)p, (const float*)n,
        (const float*)v, *grid, (const uint8_t*)active, n_units, dup,
        (float*)out, (float*)offs);
  }
  return (int)cudaGetLastError();
}

// The structs' sizes, so the host can check its mirrors of the layouts.
extern "C" int ort_an_scene_size() { return (int)sizeof(AnScene); }
extern "C" int ort_pixel_grid_size() { return (int)sizeof(PixelGrid); }
