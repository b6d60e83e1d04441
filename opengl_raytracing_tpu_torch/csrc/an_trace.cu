// The analytic scene's closest hit, ambient occlusion, GI bounce and sky
// for Hopper (sm_90a), each computed on the live lanes of a mask alone.
//
// These four kernels replace no TPU kernel.  In the JAX package their
// work is jnp code that runs behind its occupancy gates: the analytic
// glass and mirror gate (opengl_raytracing_tpu/models/pipeline.py
// _tile_gated_shade, ORT_ANALYTIC_GATE_FRAC, on by default), the hit gate
// (shade_analytic_auto, ORT_AN_HIT_GATE) and the sky miss gate
// (ops/scene.py SceneCtx.sky_gated with ops/cubemap.py
// sample_cubemap_gated, ORT_SKY_MISS_GATE).  Those gates compact
// 128-lane tiles under a lax.cond with a dense fallback; a captured CUDA
// graph holds no data-dependent branch, so here the frame hands each call
// the lanes that read its result as a device mask (models/pipeline.py,
// ops/lighting.py) and the kernel skips the others:
//
//   * an_trace_kernel: scene_analytic.trace_analytic_core (the floor, the
//     three spheres, the marker; with or without the glass sphere and the
//     marker) on given rays: t, p, the unit normal and the material id;
//     the primary trace (every lane live);
//   * an_ao_kernel: lighting.compute_ao's analytic branch whole, the
//     hemisphere rays sampled in the kernel (offsets 37i+3 / 19i+11),
//     each an any-hit test within ao_radius, counted and remapped;
//   * an_bounce_kernel: one_bounce_gi_analytic's bounce ray sampled in the
//     kernel (offsets seed*13 / seed*37 at the lane's sample) and its
//     closest hit against the whole scene, with wi and cos_theta; the
//     analytic counterpart of bvh_trace.cu's trace_bounce_kernel;
//   * sky_kernel: scene_analytic.sky, the cubemap (cubemap.cuh, its
//     [6, F, F, 4] copy) times its intensity or the gradient, at each of
//     the frame's sky call sites (the BVH scene's too: its misses).
//
// A lane the mask marks off reads its mask byte and nothing else, and
// writes nothing: its outputs are unspecified (ROADMAP C, "Inactive
// lanes"), and the callers' selects drop them.  A missed live lane of a
// trace writes the plain version's miss: t = 1e30, p = o + d * 1e30, a
// zero normal and material 0.
//
// Inputs are read in place (LaneIn): a row a lane; a row a pixel, read by
// every sample of a leading sample axis ([spp, H, W], the frame's shared
// primary hit and its masks, lane i reading row i % n_px); or one row for
// every lane (the camera's origin).  The scene's constants and the
// pointer to the parameter block go by value in AnScene (an_scene.cuh,
// the struct K3 takes), the frame's record by pointer: the arguments are
// the same for every frame and every value of the data parameters, so a
// captured CUDA graph replays the calls.
//
// The arithmetic is the plain PyTorch version's expression for
// expression (an_scene.cuh's trace and sky, sampling.cuh's hash and
// hemisphere sample, the winner's normal normalize(o + d*t - c)), built
// with --fmad=false and without --use_fast_math: the kernels return the
// plain versions' bits on live lanes.
//
// What bounds them on this card.  The primary trace has every lane live
// and moves 12 B of direction in and 32 B of hit out a lane against some
// 150 operations: bytes (2,073,600 lanes: 0.027 ms at 3.35 TB/s).  The
// masked calls read a mask byte a lane and work on a few percent of the
// lanes (GI's sky at the mirror's bounce: under 1% of a 1080p an_full
// frame; the primary sky's misses about a third).  The design is K3's
// (an_direct.cu):
//
//   * Persistent blocks (persistent.cuh): as many blocks of 128 threads
//     as fit the card, each warp looping over units of 32 lanes,
//     block-minor; a unit with no live lane ends at its __ballot_sync.
//   * Live lanes queued per warp (an_lanes.cuh's live_rounds; the
//     analytic hit mix's too): a unit's live lanes join the warp's queue
//     in shared memory (int64 lane indices, kLiveQueueCap = 63: 2,016 B
//     a block); once it holds 32 the warp works a round of 32, a lane
//     each, so a sparse mask's live lanes fill whole rounds.  After its
//     last unit the warp works what is left.
//   * One trace body (an_scene.cuh's trace_closest, K3's too): the
//     winner's index is kept and its normal computed once, where the plain
//     version computes a normal for every primitive and selects one.
//
// AO (an_ao_kernel) needs one bit a ray, so each ray is an any-hit test in
// (eps, ao_radius) that stops at its first primitive with a valid root
// below the radius (ao_blocked): the plain rule's bit, each root its
// plain expression.  A lane's origin, its sphere terms oc and c2 and its
// basis are built once for all its samples; a primitive that cannot
// have a root below the radius on any direction the lane draws is culled
// for the lane (a sphere beyond kAoReach (R + r) + kAoSlack, the floor
// beyond R kAoReach or under a floor lane's hemisphere), and a lane with
// nothing left draws no sample: on a 1080p an_full frame ~95% of the
// live lanes (the floor away from the spheres' feet), so the call is the
// mask scan, the hits' rows and the culls, and bytes bound it (24 B in and
// 4 B out a live lane) but at a wide radius and many samples (PERF.md §6).
//
// The bounce (an_bounce_kernel) is bytes: 24 B in and 48 B out a live
// lane, near the card's rate with no arithmetic; its arithmetic (the
// hash, sincos, the basis, the trace) adds to that time, not under it.
// build_onb takes the floor's hits' basis (~60% of the lanes) without
// its normalize, with the same bits.  Rows read and written 16
// bytes at a time through shared memory, the mask bytes of 16 units
// loaded before their ballots, and the next round's rows read before
// this round's work were each slower here (PERF.md §6).
//
// The sky is bytes too, 12 B in and 12 B out a live lane and its texels,
// but its calls range from every lane live (the BVH scene's misses) to a
// few thousand of 2 M (the mirror's GI bounce), so it walks the mask a
// slice of 128 bytes at a time (an_lanes.cuh's live_lanes): one 4-byte
// load a thread, the next slice's in flight while this one's lanes are
// worked, every unit of 32 lanes with a live lane worked where it lies;
// and a tap is one 16-byte load.
//
// The mirror's and glass's secondaries are traced by an_shade.cu's rays
// kernels, with their setup.  Left for later: those traces fused with
// K3's call at their hits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "an_lanes.cuh"
#include "an_scene.cuh"
#include "bvh_walk.cuh"
#include "param_block.cuh"
#include "persistent.cuh"
#include "sampling.cuh"

// A trace's rays and outputs (ops/an_trace_cuda.py:trace).
struct AnTraceArgs {
  LaneIn ro, rd, active;  // active.p null: every lane live
  int64_t n_lanes, n_px;
  float eps;
  int glass, marker;      // trace the glass sphere, the marker
  float* t;               // [n_lanes]
  float* p;               // [n_lanes, 3]
  float* nrm;             // [n_lanes, 3]
  int32_t* mat;           // [n_lanes]
};

// The AO call (ops/an_trace_cuda.py:ambient_occlusion); ao_bias,
// ao_radius, ao_min and ao_span come from the scene's parameter block.
struct AnAoArgs {
  LaneIn p, n, active;    // the hits' points and raw normals
  PixelGrid grid;
  const FrameRecord* frame;
  FrameAffine fi;         // frame_index of the record's index
  int samples;            // ao_samples
  int marker;             // the marker is traced (the point light is on)
  float two_pi;           // float32(2.0 * PI)
  int64_t n_lanes, n_px;
  float* out;             // [n_lanes]
};

// The GI bounce call (ops/an_trace_cuda.py:bounce).
struct AnBounceArgs {
  LaneIn p, n, active;    // the hits' points and raw normals
  PixelGrid grid;         // lane i: pixel i % n_px of sample i / n_px
  const FrameRecord* frame;
  FrameAffine rng;        // rng_frame (sampling.rand's keys)
  FrameAffine seed;       // seed: offsets float32(seed * 13), * 37
  float two_pi;           // float32(2.0 * PI)
  int marker;
  int64_t n_lanes, n_px;
  float* t;
  float* p_out;
  float* n_out;
  int32_t* mat;
  float* wi;              // [n_lanes, 3]
  float* cos;             // [n_lanes]
};

// The sky call (ops/an_trace_cuda.py:sky).
struct SkyArgs {
  LaneIn d, active;
  int64_t n_lanes, n_px;
  float* out;             // [n_lanes, 3]
  const float4* texels;   // the cubemap's [6, F, F, 4] copy; null: gradient
};

namespace {

// trace_analytic_core on the live lanes of the call's rays.
__global__ void __launch_bounds__(kLiveThreads)
an_trace_kernel(const Units u, const AnScene s, const AnTraceArgs a) {
  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {
    hit_out(s, in3(a.ro, i, a.n_px), in3(a.rd, i, a.n_px), a.glass,
            a.marker, a.eps, i, a.t, a.p, a.nrm, a.mat);
  });
}

// AO's culls (an_ao_kernel): a primitive is skipped for every sample of
// a lane only where the plain trace cannot take a root of it below
// ao_radius on any direction the lane draws.  kAoReach and kAoSlack widen
// the reach by more than float32 rounding moves a root (a root's error is
// under 0.3% of the centre's distance); tests/test_torch_ao_anyhit.py
// reads them from this file.
constexpr float kAoReach = 1.01f;
constexpr float kAoSlack = 1e-3f;

// The AO kernel's view of the scene's four spheres (the albedo, glass and
// mirror spheres, the marker) for one lane: the plain sphere test's terms
// that do not depend on the ray, oc = o - c and c2 = dot(oc, oc) - r*r,
// and the spheres that can take a root below ao_radius.
struct AoLane {
  V3 oc[4];
  float c2[4];
  unsigned near;  // bit k: sphere k is tested
  bool floor;     // the floor is tested
  float num;      // the floor's numerator -(dot(o, n) + d)
};

// Whether ray o + t*d (o as `l` holds it) has a valid root t < 1e30 and
// t < radius on some primitive: the same bit as the plain closest hit's
// valid & t < radius, each primitive's root its plain expression (the
// floor's num / denom behind the |denom| guard; the sphere's near root,
// or the far one where the near is below eps), the primitives in any
// order, stopping at the first.  Exact skips (with eps > 0: `culls`):
// the floor where num and denom differ in sign (t <= 0); a sphere where
// disc < 0, or where 0 <= b < eps * 2^20 and c2 >= 0 (the origin outside
// it and the ray leaving: disc <= b*b, so both roots are below
// 2^-23 * b + 2^-75 < eps).
__device__ __forceinline__ bool ao_blocked(const AoLane& l, V3 fn, V3 d,
                                           float eps, float radius,
                                           bool culls) {
  if (l.floor) {
    const float denom = dot3(d, fn);
    if (fabsf(denom) >= 1e-6f &&
        (!culls || (l.num > 0.0f) == (denom > 0.0f))) {
      const float tf = l.num / denom;
      if (tf >= eps && tf < kInf && tf < radius) return true;
    }
  }
  const float away = eps * 0x1p20f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!((l.near >> k) & 1u)) continue;
    const float b = dot3(l.oc[k], d);
    const float disc = b * b - l.c2[k];
    if (!(disc >= 0.0f)) continue;
    if (b >= 0.0f && l.c2[k] >= 0.0f && b < away) continue;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t_near = -b - sq;
    const float t_far = -b + sq;
    const float t = t_near < eps ? t_far : t_near;
    if (t >= eps && t < kInf && t < radius) return true;
  }
  return false;
}

// compute_ao's analytic branch on the live lanes: from p + n*ao_bias
// (n = normalize(h.n)), `samples` cosine-hemisphere rays from the rand
// pairs at offsets 37k+3 and 19k+11 of frame_index, each occluded where
// the plain closest hit is valid and within ao_radius (ao_blocked); then
// _ao_value's remap, clamp(ao_min + ao_span * (1 - occ / samples), ao_min,
// 1).  A lane's origin, sphere terms and basis are built once for all its
// samples.  Lane culls, each sound for every direction the lane can draw
// (|d| <= 1 + 2^-20): a sphere whose centre is farther than
// kAoReach * (ao_radius + r) + kAoSlack (every root beyond ao_radius);
// the floor where |num| > ao_radius * |n| * kAoReach (every root beyond
// ao_radius), or where the floor normal and the lane's normal are both
// (0, y > 0, 0) and num <= 0 (the basis's t.y and b.y are 0, so d.y >= 0
// and denom >= 0 on every sample: the root is below eps or guarded).  A
// lane with nothing left to test draws no sample: occ = 0.
__global__ void __launch_bounds__(kLiveThreads)
an_ao_kernel(const Units u, const AnScene s, const AnAoArgs a) {
  const uint32_t kx = frame_value(frame_index(a.frame), a.fi);
  const uint32_t ky = key_y(kx);
  const float bias = __ldg(s.prm->ao_bias), radius = __ldg(s.prm->ao_radius);
  const float ao_min = __ldg(s.prm->ao_min), span = __ldg(s.prm->ao_span);
  const float eps = s.eps;
  // every cull rests on eps > 0 (a root at or below 0 is invalid)
  const bool culls = eps > 0.0f;
  const float inf = __int_as_float(0x7f800000);
  const V3 fn = c3(s.floor_n);
  const bool floor_up =
      culls && fn.x == 0.0f && fn.z == 0.0f && fn.y > 0.0f;
  const float floor_far =
      culls ? radius * sqrtf(dot3(fn, fn)) * kAoReach : inf;
  const V3 mc = ldg3(s.prm->point_light_world);
  float far2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r2 = k < 3 ? s.sphere_r2[k] : s.marker_r2;
    const float reach = (radius + sqrtf(r2)) * kAoReach + kAoSlack;
    far2[k] = culls ? reach * reach : inf;
  }
  const int n_spheres = a.marker ? 4 : 3;
  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {
    const V3 nn = norm3(in3(a.n, i, a.n_px));
    const V3 o = add3(in3(a.p, i, a.n_px), scale3(nn, bias));
    AoLane l;
    l.near = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const V3 c = m == 0 ? c3(s.sphere_c[0])
                   : m == 1 ? c3(s.sphere_c[1])
                   : m == 2 ? c3(s.sphere_c[2]) : mc;
      l.oc[m] = sub3(o, c);
      const float q = dot3(l.oc[m], l.oc[m]);
      l.c2[m] = q - (m < 3 ? s.sphere_r2[m] : s.marker_r2);
      if (m < n_spheres && !(q > far2[m])) l.near |= 1u << m;
    }
    l.num = -(dot3(o, fn) + s.floor_d);
    // the floor: beyond ao_radius, or under every direction of a floor
    // lane's hemisphere (nn = (0, y > 0, 0): the basis's t.y and b.y are
    // 0, so every direction has d.y >= 0 and denom >= 0)
    l.floor = !(fabsf(l.num) > floor_far) &&
              !(floor_up && nn.x == 0.0f && nn.z == 0.0f && nn.y > 0.0f &&
                !(l.num > 0.0f));
    int occ = 0;
    if (l.near != 0 || l.floor) {
      // hemisphere_cosine's basis around normalize(nn), once a lane
      const V3 n2 = norm3(nn);
      V3 t, b;
      build_onb(n2, &t, &b);
      float px, py;
      pixel_centre(a.grid, i, &px, &py);
      for (int m = 0; m < a.samples; ++m) {
        const float o1 = (float)(37 * m + 3), o2 = (float)(19 * m + 11);
        const float ux = rand01(px + o1, py + o1, kx, ky);
        const float uy = rand01(py + o2, px + o2, kx, ky);
        const V3 d = hemisphere_dir(t, b, n2, ux, uy, a.two_pi);
        occ += ao_blocked(l, fn, d, eps, radius, culls);
      }
    }
    const float ao = 1.0f - (float)occ / (float)a.samples;
    a.out[i] = fminf(fmaxf(ao_min + span * ao, ao_min), 1.0f);
  });
}

// one_bounce_gi_analytic's bounce on the live lanes: the rand pair at
// offsets seed*13 and seed*37 of the lane's sample, n0 = normalize(h.n),
// the cosine-hemisphere direction wi around n0, cos = max(dot(n0, wi), 0),
// and the closest hit of the whole scene from p + n0*EPS along wi.
__global__ void __launch_bounds__(kLiveThreads)
an_bounce_kernel(const Units u, const AnScene s, const AnBounceArgs a) {
  const uint32_t f = frame_index(a.frame);
  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {
    const uint32_t smp = sample_of(a.grid, i);
    const uint32_t kx = frame_value(f, a.rng, smp), ky = key_y(kx);
    const uint32_t seed = frame_value(f, a.seed, smp);
    const float so = frame_f32(seed * 13u), so2 = frame_f32(seed * 37u);
    float px, py;
    pixel_centre(a.grid, i, &px, &py);
    const float ux = rand01(px + so, py + so, kx, ky);
    const float uy = rand01(py + so2, px + so2, kx, ky);
    const V3 n0 = norm3(in3(a.n, i, a.n_px));
    const V3 wi = hemisphere_cosine(n0, ux, uy, a.two_pi);
    put3(a.wi, i, wi);
    a.cos[i] = fmaxf(dot3(n0, wi), 0.0f);
    hit_out(s, add3(in3(a.p, i, a.n_px), scale3(n0, s.eps)), wi, true,
            a.marker, s.eps, i, a.t, a.p_out, a.n_out, a.mat);
  });
}

// scene_analytic.sky on the live lanes, over slices of the mask
// (live_lanes): the cubemap's taps from its [6, F, F, 4] copy (kCube),
// else the gradient, whose full units are worked in pairs.
template <bool kCube>
__global__ void __launch_bounds__(kLiveThreads, kSliceBlocks)
sky_kernel(const Units u, const AnScene s, const SkyArgs a) {
  live_lanes<!kCube>(u, a.active, a.n_lanes, a.n_px, [&](int64_t i,
                                                         int64_t q) {
    const V3 d = at3(a.d, i, q);
    put3(a.out, i, cube_or_gradient_sky<kCube>(s, a.texels, d));
  });
}

}  // namespace

// Plain C entry points for ctypes.  `scene` and `args` are host pointers
// (their own pointers are device pointers; a null mask: every lane live);
// the stream is a cudaStream_t.  Each returns a cudaError_t as an int: of
// the set-up calls, else cudaGetLastError().  Persistent blocks over
// units of 32 lanes (persistent.cuh); the sky's over the mask's slices.
extern "C" int ort_an_trace(const AnScene* scene, const AnTraceArgs* args,
                            void* stream) {
  return launch_persistent(an_trace_kernel, kLiveThreads,
                           make_units(args->n_lanes, 32),
                           (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_an_ao(const AnScene* scene, const AnAoArgs* args,
                         void* stream) {
  return launch_persistent(an_ao_kernel, kLiveThreads,
                           make_units(args->n_lanes, 32),
                           (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_an_bounce(const AnScene* scene, const AnBounceArgs* args,
                             void* stream) {
  return launch_persistent(an_bounce_kernel, kLiveThreads,
                           make_units(args->n_lanes, 32),
                           (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_sky(const AnScene* scene, const SkyArgs* args,
                       void* stream) {
  if (args->n_lanes > kMaxSliceLanes) return (int)cudaErrorInvalidValue;
  const Units u = slice_units(args->active, args->n_lanes, args->n_px);
  return args->texels != nullptr
             ? launch_persistent(sky_kernel<true>, kLiveThreads, u,
                                 (cudaStream_t)stream, *scene, *args)
             : launch_persistent(sky_kernel<false>, kLiveThreads, u,
                                 (cudaStream_t)stream, *scene, *args);
}

// The structs' sizes, so the host can check its mirrors of the layouts:
// AnScene, PixelGrid, LaneIn, AnTraceArgs, AnAoArgs, AnBounceArgs, SkyArgs
// into `sizes` (room for `cap`); returns how many there are.
extern "C" int ort_an_trace_sizes(int* sizes, int cap) {
  const int all[] = {(int)sizeof(AnScene),     (int)sizeof(PixelGrid),
                     (int)sizeof(LaneIn),      (int)sizeof(AnTraceArgs),
                     (int)sizeof(AnAoArgs),    (int)sizeof(AnBounceArgs),
                     (int)sizeof(SkyArgs)};
  const int n = (int)(sizeof(all) / sizeof(all[0]));
  for (int k = 0; k < n && k < cap; ++k) sizes[k] = all[k];
  return n;
}
