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
// Inputs.  A pixel's raw hit point, normal and view direction, its
// material id (K3) and its pixel centre are all a lane reads; the
// pixel-centre grids are read in place
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
// the five analytic primitives (closest t only, an_scene.cuh's trace,
// the body an_trace.cu's kernels trace with) and shades its mirror
// and glass lanes (the env reflection, no shadow work) on a path of
// their own (below); a lane that `active` marks off (the caller's select
// drops it) reads its mask byte and nothing else, and writes nothing.
// bvh_direct_kernel (K5) builds the four segment queries, the sun and
// the point query with their ndl gates (lighting._bvh_shadow_queries) and
// walks the open windows with bvh_walk.cuh's any_hit_ww (node rows from
// device memory), spread over its warp's lanes (below); a lane that
// `active` marks off (the caller's sky select drops it) reads its mask
// byte and nothing else of its row, and writes nothing.  It reads the
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
// offsets.  Where a value is dropped by a select whatever it is, it may
// be skipped (a missed sphere's root); where two forms give the same
// float, the cheaper is taken (remainder by x - truncf(x) on [0, 2], the
// segment's direction as the term's normalize).  Built with --fmad=false
// and without --use_fast_math, so
// every operation rounds once, as in PyTorch: the disk offsets equal the
// plain version's bit for bit, and only the libraries' pow differs in
// the last bits of the radiance.  An optional output (null on the main
// path) receives the offsets as [8, N] planes dx0, dy0, dx1, ... so a
// test can hold them to lighting._disk_offsets.
//
// What bounds them on this card.  A pixel reads 40 bytes (p, n, v and,
// for K3, the material id) and writes 12.  A diffuse pixel does the hash
// chain (ten rand draws), four concentric samples with a sincos each, six
// shadow traces (five analytic primitives each for K3, a BVH walk for
// each open window of the BVH scene) and six Lambert-Phong terms with a
// powf each.  K3 is bound by that arithmetic, about 1,600 operations a
// diffuse lane against 52 bytes: 0.032 ms for the 1,330,104 live lanes
// of a 1080p an_full frame's primary call, whose six other calls keep
// 0.1-1.2% of their 2,073,600 lanes (PERF.md).  One thread a lane
// over every lane spent 0.31 ms on the primary call and 0.35-0.43 ms on
// each of the others, on lanes the frame then drops.  K5 is bound by
// latency:
// a walk is a chain of dependent node and triangle fetches, a frame's
// live pixels are few (0.74% of a 1080p bunny frame, 45.6% on cf_close)
// and clustered, and its GI call is a few hundred live lanes among 2M
// or 8.3M.  One thread a pixel would walk its 4 * dup + 2 windows in
// series, each a chain of fetches, and a warp would wait on its busiest
// lane's chains: 0.171 ms on the 1080p baseline frame against a 0.00095
// ms bound (H100 80GB HBM3, 700 W; PERF.md).  The walks take most of
// the baseline call and about half of the cf_close call, whose other half
// is its 946,092 live pixels' arithmetic (PERF.md).
//
// K3's design:
//   * Live lanes from the frame's own selects.  The caller hands each
//     call the lanes it keeps (models/pipeline.py:_shade_analytic: the
//     primary call its diffuse hits, each secondary its valid hits among
//     the lanes its caller keeps), the frame's form of the JAX package's
//     tile gates: a masked secondary call is a scan of 2M mask bytes and
//     a few rounds.
//   * Persistent blocks (persistent.cuh, as K5): each warp takes units
//     of 32 lanes, block-minor; a unit with no live lane ends at its
//     __ballot_sync.
//   * Live lanes compacted per warp, a queue a path.  A live lane joins
//     the warp's diffuse queue or its env queue (mirror, glass) in shared
//     memory (int64 lane indices, kQueueCap = 63 a queue: 4,032 B a
//     block); once a queue holds kDrainAt = 32 the warp shades a round of
//     32, a lane each, all on one path, so a warp never splits between
//     the env lookup and the diffuse tree, and the sparse calls' live
//     lanes fill whole rounds.  Each path has one call site, so the
//     kernel is one inlined body (with two call sites of the diffuse
//     path ptxas left a call, a 56 B stack frame and spills: 0.285
//     against 0.259 ms on the primary call).  A unit-at-a-time form
//     (kDrainAt 1: a unit's live lanes a round, no queue carried) timed
//     the same on the primary call and twice as slow on the GI call
//     (0.065 against 0.031 ms); a grid of a block a 4 units (no
//     persistent loop) was 6% faster on the primary call and 1.7x
//     slower on the GI call (PERF.md).
//   * The diffuse path's arithmetic, split by probe_an_direct.py on the
//     primary call (0.210 ms): the traces ~20%, the sincos ~7%, the hash
//     chain ~5%, powf within the noise.  Cut without changing a bit: a
//     missed sphere returns before its sqrtf (-10%), rem1 without fmodf
//     (-10%); one sincosf in place of cosf and sinf gave the same bits
//     and was 13% slower, so the pair stays.
//   * ptxas (sm_90a, --fmad=false): an_direct_light_kernel 61 registers,
//     no spill, a 32 B stack frame (the trig functions' slow path), 4,032
//     B of shared memory: eight blocks, 32 warps, an SM.
//
// K5's design (the AO kernel's, bvh_trace.cu):
//   * Persistent blocks (persistent.cuh): as many blocks of 128 threads
//     as fit the card, each warp looping over units of 32 rows,
//     block-minor; a dead unit costs its warp 32 mask bytes and a
//     __ballot_sync.
//   * Live pixels compacted per warp: a unit with no live row ends at its
//     __ballot_sync; a live pixel's own lane reads its hit row once,
//     computes its queries and, later, its terms, and its open windows
//     take consecutive entries of the warp's list (__ballot_sync and
//     __popc of the open windows).
//   * A pixel's windows spread over the warp's lanes.  A unit is done a
//     chunk at a time, chunk k being sample k's four disk windows of its
//     live pixels and, in chunk 0, their sun and point windows (at most
//     kChunkWindows = 6 a pixel, 192 a unit).  Each open window goes to
//     the warp's list in shared memory (origin and window as a float4,
//     the direction as three planes: 28 B an entry, 5,376 B a warp,
//     21,600 B a block with the round bits), window by window: all lanes'
//     disk window 0, then disk window 1, ..., the sun's, the point's.
//     The warp walks the list 32 windows a round, a lane a window, with
//     any_hit_ww; __ballot_sync of each round goes to the list's bits,
//     from which each pixel's lane reads its own.  A closed window (the
//     surface faces away, the window is <= 0) takes no lane, so a unit
//     walks sum(open windows) / 32 rounds where a thread a pixel walked
//     as many windows as its busiest pixel had open.
//   * The bits stay those of the plain walk: each window is the query
//     the plain version builds, walked by the same any-hit walk, and each
//     pixel's terms are computed by its own lane in the plain version's
//     order.  A chunk holds one sample, so the list never exceeds 192
//     entries whatever `dup` (up to 16, 66 windows a pixel), a pixel's
//     four disk offsets stay in registers from its queries to its terms,
//     and its chunk's bits are read from the list before the next chunk.
//   * Registers, not shared memory, set the warps an SM holds, and a walk
//     waits on its fetches: held to 72 registers (kDirectBlocks), the
//     kernel keeps seven blocks, 28 warps, on an SM.  ptxas (sm_90a,
//     --fmad=false): bvh_direct_kernel 72 registers, a 96 B stack frame,
//     108 B of spill stores and 72 B of spill loads, 21,600 B of shared
//     memory.
//
// The samples of a pixel (spp_per_frame > 1) arrive as one call over a
// leading sample axis, [spp, H, W] (models/pipeline.py:trace_and_shade,
// the JAX package's SPP batch).  Lane i of a call is pixel i % n_px of
// sample i / n_px (sampling.cuh: PixelGrid, sample_of), and draws its
// disk offsets from rng_frame at that sample (FrameAffine's per-sample
// stride c; 0 for a call without the axis, whose lanes all read sample
// 0).  K3's primary call shares one hit among the samples: where its
// rows and mask are broadcast over the axis (AnRows::shared) a lane reads
// its pixel's row, i % n_px, in place.  K5's primary call shares one hit
// among
// the samples (spp_dup): its rows are pixels, the sun and point rays
// depend on the hit alone (the JAX package's spp_dup traces them for
// sample 0 and broadcasts its bits), so a pixel's lane reads the hit's
// rows once, its sun and point windows go into chunk 0 alone and their
// terms are computed once, and each sample k's chunk holds its four disk
// windows.  Its other calls (GI's, on hits that differ by sample) take a
// row a lane, as without the axis.
//
// Left for later: the glass/mirror secondary traces fused into K3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "an_scene.cuh"
#include "bvh_walk.cuh"
#include "cubemap.cuh"
#include "param_block.cuh"
#include "persistent.cuh"
#include "sampling.cuh"

namespace {

constexpr float kPi = 3.1415926535f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSamples = 4;   // SOFT_SHADOW_SAMPLES
// bvh_direct_kernel's chunk: a sample's disk windows of a unit's live
// pixels and, in the first, their sun and point windows; its list holds a
// full chunk, 192 windows (5,376 B a warp, 21,600 B a block with the
// bits).  It holds the open windows alone (a fixed window a pixel, its
// closed ones included and not walked, timed slower: PERF.md).
constexpr int kChunkWindows = kSamples + 2;
constexpr int kListCap = 32 * kChunkWindows;
// bvh_direct_kernel's blocks an SM: seven hold it to 72 registers, 28
// warps an SM (80 registers and six blocks, or 64 and eight, timed
// slower: PERF.md)
constexpr int kDirectBlocks = 7;
// an_direct_light_kernel's queues of live lanes, one a path (diffuse,
// env) a warp: a queue is shaded 32 lanes a round once it holds
// kDrainAt, so it holds at most kDrainAt - 1 + 32 lanes (int64 lane
// indices: 1,008 B a warp, 4,032 B a block)
constexpr int kDrainAt = 32;
constexpr int kQueueCap = kDrainAt - 1 + 32;

}  // namespace

// The hit rows of a K3 call and its live lanes, filled on the host
// (ops/an_cuda.py:direct_rows).
struct AnRows {
  // p, n, v [N, 3] and the material id [N] of every lane, or with
  // `shared` one row a pixel, [n_px], read by every sample (as is
  // `active`)
  const float* p;
  const float* n;
  const float* v;
  const int32_t* mat;
  const uint8_t* active;  // a byte a row, 0: dead (null: every lane live)
  PixelGrid grid;         // lane i: pixel i % n_px of sample i / n_px
  int shared;
};

namespace {

// ---- the disk offsets (lighting._disk_offsets), on sampling.cuh's hash ----

// torch.remainder(x, 1.0) of a sum of two draws in [0, 1] (a rand draw
// and a rotation): x lies in [0, 2], where x - truncf(x) is exact (for x
// in [1, 2) by Sterbenz's lemma) and so equals fmodf(x, 1) and the
// remainder bit for bit, without fmodf's loop
__device__ __forceinline__ float rem1(float x) { return x - truncf(x); }

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
  // cosf and sinf apart: one sincosf gives the same bits, but timed
  // slower in K3 (PERF.md)
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

// One disk sample's term of lighting._disk_light_sum, given the unit
// direction `l` = normalize(xl - p) toward its point xl, d2 = |xl - p|^2,
// and whether it is occluded.
__device__ __forceinline__ V3 disk_term_l(const AnScene& s, V3 n, V3 v, V3 l,
                                          float d2, bool occ, V3 albedo,
                                          float spec, float gloss) {
  const float ndl = fmaxf(dot3(n, l), 0.0f);
  const float ctl = fmaxf(dot3(c3(s.light_nneg), l), 0.0f);
  const float r2 = fmaxf(d2, 1e-4f);
  const float geom = ndl * ctl / r2;
  const float gv = geom * (occ ? 0.0f : 1.0f);
  const V3 li = {s.light_color[0] * gv, s.light_color[1] * gv,
                 s.light_color[2] * gv};
  return lambert_phong(n, v, l, li, albedo, spec, gloss);
}

// disk_term_l of the sample whose point is `xl`
__device__ __forceinline__ V3 disk_term(const AnScene& s, V3 p, V3 n, V3 v,
                                        V3 xl, bool occ, V3 albedo,
                                        float spec, float gloss) {
  const V3 delta = sub3(xl, p);
  return disk_term_l(s, n, v, norm3(delta), dot3(delta, delta), occ, albedo,
                     spec, gloss);
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

// ---- K3 ----

// lane i's hit row
__device__ __forceinline__ int64_t hit_row(const AnRows& r, int64_t i) {
  return r.shared ? i - (int64_t)sample_of(r.grid, i) * r.grid.n_px : i;
}

// Lane i, a mirror or glass hit (lighting.direct_light_plain's mirror_out
// and glass_out): the tinted environment of the reflected view; glass
// adds the sky's diffuse term.
__device__ __forceinline__ void shade_env(const AnScene& s, const AnRows& r,
                                          int64_t i,
                                          float* __restrict__ out) {
  const int64_t row = hit_row(r, i);
  const V3 n = norm3(row3(r.n, row));
  const V3 v = norm3(row3(r.v, row));
  const Material m = material(s, __ldg(r.mat + row));
  V3 c = mul3(sky(s, reflect_view(v, n)), m.albedo);
  if (m.type == 2 && s.sky_e) c = add3(c, sky_term(s, n, m.albedo));
  store3(out, i, c);
}

// Lane i, a diffuse hit (direct_light_plain's diff): the four disk-light
// samples, each a segment query traced against the analytic primitives
// (occluded_toward) and its Lambert-Phong term, summed k = 0..3 and
// divided by 4; then the sun (any hit blocks it), the sky and the point
// light (the marker ignored), in that order.
__device__ __forceinline__ void shade_diffuse(const AnScene& s,
                                              const AnRows& r, int64_t i,
                                              float* __restrict__ out) {
  const int64_t row = hit_row(r, i);
  const V3 n = norm3(row3(r.n, row));
  const V3 v = norm3(row3(r.v, row));
  const Material m = material(s, __ldg(r.mat + row));
  const V3 p = row3(r.p, row);
  float px, py;
  pixel_centre(r.grid, i, &px, &py);
  const uint32_t f = frame_index(s.frame);
  const Rot rot = cp_rot(s, f, px, py);
  const uint32_t kx = frame_value(f, s.smp, sample_of(r.grid, i));
  V3 acc = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kSamples; ++k) {
    float dx, dy;
    disk_offset(s, kx, px, py, rot, k, &dx, &dy);
    // segment_query toward the disk point; its direction is also the
    // term's normalize(xl - p), the same expression
    const V3 delta = sub3(disk_point(s, dx, dy), p);
    const float d2 = dot3(delta, delta);
    const float max_t = sqrtf(fmaxf(d2, 0.0f));
    const float ln = fmaxf(max_t, 1e-12f);
    const V3 l = {delta.x / ln, delta.y / ln, delta.z / ln};
    const float seps = fmaxf(1e-3f * max_t, 1e-4f);
    const float t = trace_t(s, add3(p, scale3(l, seps)), l, s.point_e);
    const bool occ = t < kInf && t < max_t - seps;
    acc = add3(acc, disk_term_l(s, n, v, l, d2, occ, m.albedo, m.spec,
                                m.gloss));
  }
  acc = {acc.x / (float)kSamples, acc.y / (float)kSamples,
         acc.z / (float)kSamples};
  // a diffuse lane's type is 0: its sun and point terms take its spec
  const V3 vv = norm3(v);
  if (s.sun_e) {
    const bool blocked =
        trace_t(s, add3(p, scale3(n, 1.0f)), sun_l(s), s.point_e) < kInf;
    acc = add3(acc, sun_term(s, n, vv, blocked, m.albedo, m.spec, m.gloss));
  }
  if (s.sky_e) acc = add3(acc, sky_term(s, n, m.albedo));
  if (s.point_e)
    acc = add3(acc, point_term(s, p, n, vv, -1, m.albedo, m.spec, m.gloss));
  store3(out, i, acc);
}

// Put lane i in the warp's queue `q` (`n` entries) if `in`: the ballot of
// the lanes that join, each at its rank among them.
__device__ __forceinline__ void enqueue(int64_t* q, int& n, bool in,
                                        unsigned below, int64_t i) {
  const unsigned b = __ballot_sync(kAll, in);
  if (in) q[n + __popc(b & below)] = i;
  n += __popc(b);
}

// K3: lighting.direct_light_plain on the live lanes, as persistent blocks
// over units of 32 lanes.  Lane i is pixel i % n_px of sample i / n_px
// (the grid's; a call without a sample axis has one), and draws its disk
// offsets from rng_frame at that sample.
//
// A warp takes its units in turn: it reads a unit's mask bytes and takes
// __ballot_sync of the live lanes (a unit with none ends there); each
// live lane reads its material id and joins one of the warp's two queues
// in shared memory, the diffuse lanes' or the env lanes' (mirror and
// glass).  Once a queue holds kDrainAt lanes, the warp shades a round of
// 32 of them, a lane each, all on one path (the diffuse queue first),
// and takes units again; after its last unit it shades what is left, a
// round at a time.  Each path has one call site, so the kernel is one
// inlined body.  A lane that `active` marks off reads its mask byte and
// nothing else, and writes nothing (its radiance is unspecified by
// contract).  With `offs_out`, every live lane writes its disk offsets
// there as it joins its queue.
__global__ void __launch_bounds__(kThreads)
an_direct_light_kernel(const Units u, const AnScene s, const AnRows r,
                       int64_t n_lanes, float* __restrict__ out,
                       float* __restrict__ offs_out) {
  __shared__ int64_t queue[kWarps][2][kQueueCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int64_t* diffuse = queue[warp][0];
  int64_t* env = queue[warp][1];
  int n_diffuse = 0, n_env = 0;  // the same on every lane of the warp
  int64_t j = u.first();
  for (;;) {
    // units until a queue holds kDrainAt lanes or the warp's units end
    for (; j < u.n_units && n_diffuse < kDrainAt && n_env < kDrainAt;
         j += u.stride()) {
      const int64_t i = u.base(j) + lane;
      const int64_t row = i < n_lanes ? hit_row(r, i) : 0;
      const bool live =
          i < n_lanes && (r.active == nullptr || __ldg(r.active + row));
      if (__ballot_sync(kAll, live) == 0) continue;
      const int type = live ? material_type(s, __ldg(r.mat + row)) : -1;
      if (offs_out != nullptr && live) {
        const uint32_t f = frame_index(s.frame);
        float px, py;
        pixel_centre(r.grid, i, &px, &py);
        write_offsets(s, frame_value(f, s.smp, sample_of(r.grid, i)), px,
                      py, cp_rot(s, f, px, py), i, n_lanes, offs_out);
      }
      enqueue(diffuse, n_diffuse, type == 0, below, i);
      enqueue(env, n_env, type == 1 || type == 2, below, i);
    }
    // a round of the full queue, the diffuse one first; after the last
    // unit, of what is left
    const bool units_done = j >= u.n_units;
    bool env_round;
    if (n_diffuse >= kDrainAt || (units_done && n_diffuse > 0))
      env_round = false;
    else if (n_env > 0)
      env_round = true;
    else
      break;  // the units done and both queues empty
    const int n = env_round ? n_env : n_diffuse;
    const int k = min(n, 32);
    __syncwarp();  // the entries are written
    if (lane < k) {
      const int64_t e = (env_round ? env : diffuse)[n - k + lane];
      if (env_round)
        shade_env(s, r, e, out);
      else
        shade_diffuse(s, r, e, out);
    }
    if (env_round)
      n_env -= k;
    else
      n_diffuse -= k;
    __syncwarp();  // the entries are read before the next enqueue
  }
}

// ---- K5 with its shadow walks ----

// A warp's list of shadow windows: entry e's origin and window (ow), and
// its direction, as separate planes; and the occlusion bits of its walk
// rounds, bit e % 32 of word e / 32.
struct WindowList {
  float4 ow[kWarps][kListCap];
  float dx[kWarps][kListCap], dy[kWarps][kListCap], dz[kWarps][kListCap];
  unsigned hit[kWarps][kListCap / 32];
};

// Give a lane's window its entry in the warp's list if it is `open`, and
// put query q there; returns the entry, or -1 where the window is closed.
// `n` counts the list's entries.  Every lane of the warp calls it for one
// window of its pixel at a time, so all lanes' window w follow all lanes'
// window w - 1 (the rays toward one light walk in one round).
__device__ __forceinline__ int put_window(WindowList& wl, int warp,
                                          unsigned below, bool open, int& n,
                                          const Query& q) {
  const unsigned b = __ballot_sync(kAll, open);
  const int e = open ? n + __popc(b & below) : -1;
  n += __popc(b);
  if (e >= 0) {
    wl.ow[warp][e] = make_float4(q.o.x, q.o.y, q.o.z, q.win);
    wl.dx[warp][e] = q.d.x;
    wl.dy[warp][e] = q.d.y;
    wl.dz[warp][e] = q.d.z;
  }
  return e;
}

// Walk the warp's `n` entries (open windows all), 32 a round, a lane an
// entry, and keep each round's bits (__ballot_sync) in the list.
__device__ __forceinline__ void walk_list(WindowList& wl, int warp, int lane,
                                          int n, const Tree& tree,
                                          float eps) {
  __syncwarp();  // the entries are written
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int e = r0 + lane;
    bool hit = false;
    if (e < n) {
      const float4 ow = wl.ow[warp][e];
      hit = any_hit_ww(tree.bounds, tree.meta, tree.tris, tree.n_nodes,
                       {ow.x, ow.y, ow.z},
                       {wl.dx[warp][e], wl.dy[warp][e], wl.dz[warp][e]},
                       ow.w, eps);
    }
    const unsigned b = __ballot_sync(kAll, hit);
    if (lane == 0) wl.hit[warp][r0 >> 5] = b;
  }
  __syncwarp();  // the bits are written
}

// Is entry e (-1: none) occluded?
__device__ __forceinline__ bool occluded(const WindowList& wl, int warp,
                                         int e) {
  return e >= 0 && ((wl.hit[warp][e >> 5] >> (e & 31)) & 1u);
}

// K5 with its shadow walks: lighting.direct_light_bvh_plain over rows of
// hits, as persistent blocks over units of 32 rows.  With `dup` = 1 a
// row is one lane (pixel i % n_px of sample i / n_px).  With `dup` > 1
// (spp_dup) a row is one pixel of a hit shared by `dup` samples, and
// sample k's radiance goes to lane k * n_rows + i: the row is read once,
// and its sun and point windows are walked once for all samples.
//
// A unit's warp takes __ballot_sync of its live rows and works on those
// alone, a chunk at a time: chunk k is sample k's four disk windows of
// every live pixel, and, in chunk 0, their sun and point windows.  Each
// live pixel's own lane builds its chunk's queries and gates
// (lighting._bvh_shadow_queries: facing, ndl > 0, window > 0) and puts
// its open windows in the warp's list (put_window); the warp walks the
// list 32 windows a round with any_hit_ww (walk_list); each pixel's lane
// then reads its windows' bits and computes its terms in the plain
// version's order: the disk terms summed j = 0..3, divided by 4, then the
// sun, sky and point terms.  A lane that `active` marks off reads its mask
// byte and nothing else, and writes nothing (its radiance is unspecified
// by contract).
__global__ void __launch_bounds__(kThreads, kDirectBlocks)
bvh_direct_kernel(const Units u, const AnScene s, const Tree tree,
                  const float* __restrict__ p_in,
                  const float* __restrict__ n_in,
                  const float* __restrict__ v_in, const PixelGrid g,
                  const uint8_t* __restrict__ active, int64_t n_rows,
                  int dup, float* __restrict__ out,
                  float* __restrict__ offs_out) {
  __shared__ WindowList wl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const V3 albedo = c3(s.bvh_albedo);
  for (int64_t j = u.first(); j < u.n_units; j += u.stride()) {
    const int64_t base = u.base(j), i = base + lane;
    if (offs_out != nullptr && i < n_rows) {  // every row, live or not
      const uint32_t f = frame_index(s.frame);
      const uint32_t s1 = sample_of(g, i);
      float px, py;
      pixel_centre(g, i, &px, &py);
      const Rot rot = cp_rot(s, f, px, py);
      for (int k = 0; k < dup; ++k)
        write_offsets(s, frame_value(f, s.smp, dup > 1 ? k : s1), px, py,
                      rot, dup > 1 ? k * n_rows + i : i, n_rows * dup,
                      offs_out);
    }
    const bool live = is_live(active, u, base, lane, n_rows);
    const unsigned mask = __ballot_sync(kAll, live);
    if (mask == 0) continue;
    // the live row's hit, read once for all its samples
    uint32_t f = 0, s1 = 0;
    float px = 0.0f, py = 0.0f;
    Rot rot = {0.0f, 0.0f};
    V3 p = {0.0f, 0.0f, 0.0f}, n = p, v = p;
    if (live) {
      f = frame_index(s.frame);
      s1 = sample_of(g, i);
      pixel_centre(g, i, &px, &py);
      rot = cp_rot(s, f, px, py);
      p = row3(p_in, i);
      n = norm3(row3(n_in, i));
      v = norm3(row3(v_in, i));
    }
    // the sun, sky and point terms depend on the hit alone
    V3 sun_t = {0.0f, 0.0f, 0.0f}, sky_t = sun_t, point_t = sun_t;
    for (int k = 0; k < dup; ++k) {
      const uint32_t kx = frame_value(f, s.smp, dup > 1 ? k : s1);
      int n_ent = 0;
      int e_disk[kSamples];
      float dx[kSamples], dy[kSamples];
#pragma unroll
      for (int w = 0; w < kSamples; ++w) {
        Query q = {};
        bool open = false;
        if (live) {
          disk_offset(s, kx, px, py, rot, w, &dx[w], &dy[w]);
          q = segment_query(p, disk_point(s, dx[w], dy[w]));
          open = dot3(n, q.d) > 0.0f && dot3(q.d, c3(s.light_nneg)) > 0.0f &&
                 q.win > 0.0f;
        }
        e_disk[w] = put_window(wl, warp, below, open, n_ent, q);
      }
      int e_sun = -1, e_point = -1;
      if (k == 0 && s.sun_e) {
        // lighting._sun_shadow_query: eps 1.0, window 999
        Query q = {};
        bool open = false;
        if (live) {
          const V3 l = sun_l(s);
          q = {add3(p, scale3(n, 1.0f)), l, 999.0f};
          open = dot3(n, l) > 0.0f;
        }
        e_sun = put_window(wl, warp, below, open, n_ent, q);
      }
      if (k == 0 && s.point_e) {
        // lighting._point_shadow_query
        Query q = {};
        bool open = false;
        if (live) {
          const V3 to_l = sub3(c3(s.prm->point_light_world), p);
          const float dist = sqrtf(fmaxf(dot3(to_l, to_l), 1e-20f));
          const V3 l = {to_l.x / dist, to_l.y / dist, to_l.z / dist};
          const float peps = fmaxf(1e-3f * dist, 1e-4f);
          q = {add3(p, scale3(l, peps)), l, dist - peps};
          open = dot3(n, l) > 0.0f && q.win > 0.0f;
        }
        e_point = put_window(wl, warp, below, open, n_ent, q);
      }
      walk_list(wl, warp, lane, n_ent, tree, s.eps);
      if (live) {
        if (k == 0) {
          const V3 vv = norm3(v);
          if (s.sun_e)
            sun_t = sun_term(s, n, vv, occluded(wl, warp, e_sun), albedo,
                             s.bvh_spec, s.bvh_gloss);
          if (s.sky_e) sky_t = sky_term(s, n, albedo);
          if (s.point_e)
            point_t = point_term(s, p, n, vv,
                                 occluded(wl, warp, e_point) ? 1 : 0, albedo,
                                 s.bvh_spec, s.bvh_gloss);
        }
        V3 acc = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int w = 0; w < kSamples; ++w)
          acc = add3(acc, disk_term(s, p, n, v, disk_point(s, dx[w], dy[w]),
                                    occluded(wl, warp, e_disk[w]), albedo,
                                    s.bvh_spec, s.bvh_gloss));
        acc = {acc.x / (float)kSamples, acc.y / (float)kSamples,
               acc.z / (float)kSamples};
        if (s.sun_e) acc = add3(acc, sun_t);
        if (s.sky_e) acc = add3(acc, sky_t);
        if (s.point_e) acc = add3(acc, point_t);
        store3(out, dup > 1 ? k * n_rows + i : i, acc);
      }
      __syncwarp();  // the next chunk rewrites the list
    }
  }
}

}  // namespace

// Plain C entry points for ctypes.  `scene` and `grid` are host pointers
// (the grid's own pointers, `scene->env`, `scene->frame` and
// `scene->prm` are device pointers); the other pointers are
// device pointers (`active` and `offs` may be null); the stream is a
// cudaStream_t.  Each returns cudaGetLastError() as an int.
// Persistent blocks over units of 32 lanes (persistent.cuh).
extern "C" int ort_an_direct(const AnScene* scene, const AnRows* rows,
                             int64_t n_lanes, void* out, void* offs,
                             void* stream) {
  return launch_persistent(an_direct_light_kernel, kThreads,
                           make_units(n_lanes, 32), (cudaStream_t)stream,
                           *scene, *rows, n_lanes, (float*)out,
                           (float*)offs);
}

// `n_units` rows of `dup` samples each (bvh_direct_kernel): the hit rows
// and `active` hold one row a unit, `out` and `offs` n_units * dup lanes.
// Persistent blocks over units of 32 rows (persistent.cuh).
extern "C" int ort_bvh_direct(const AnScene* scene, const void* bounds,
                              const void* meta, const void* tris, int n_nodes,
                              const void* p, const void* n, const void* v,
                              const PixelGrid* grid, const void* active,
                              int64_t n_units, int dup, void* out,
                              void* offs, void* stream) {
  if (dup <= 0) return (int)cudaGetLastError();
  return launch_persistent(bvh_direct_kernel, kThreads,
                           make_units(n_units, 32), (cudaStream_t)stream,
                           *scene, make_tree(bounds, meta, tris, n_nodes),
                           (const float*)p, (const float*)n, (const float*)v,
                           *grid, (const uint8_t*)active, n_units, dup,
                           (float*)out, (float*)offs);
}

// The structs' sizes, so the host can check its mirrors of the layouts.
extern "C" int ort_an_scene_size() { return (int)sizeof(AnScene); }
extern "C" int ort_pixel_grid_size() { return (int)sizeof(PixelGrid); }
extern "C" int ort_an_rows_size() { return (int)sizeof(AnRows); }
