// Both scenes' shading tails for Hopper (sm_90a), on the hit lanes alone:
// what follows the direct light and GI's bounce in models/pipeline.py's
// _shade_bvh and _shade_analytic, in one kernel each.
//
// These two kernels replace no TPU kernel.  In the JAX package this work
// is jnp code behind its hit gates (opengl_raytracing_tpu/models/
// pipeline.py: shade_bvh_auto's _tile_gated_shade_bvh, ORT_BVH_GATE_FRAC,
// and shade_analytic_auto, ORT_AN_HIT_GATE), which compact the whole
// shading call to the 128-lane tiles that hold a primary hit under a
// lax.cond with a dense fallback.  A captured CUDA graph holds no
// data-dependent branch, so here the frame hands each call its hit mask
// (a row a pixel under the sample axis) and the kernel skips the other
// lanes:
//
//   * bvh_hit_mix_kernel: the rest of _shade_bvh (lighting.bvh_hit_mix_
//     plain): with GI, the bounce's light where it hit, else the sky of
//     its direction looked up here (an_scene.cuh's texel_sky or
//     gradient_sky, as sky_kernel), BVH_ALBEDO * (cos * inv_pi) * li,
//     the firefly clamp of its luminance, the grazing-angle cut, times
//     gi_scale_bvh added to the direct light; with AO, the product with
//     it;
//   * an_hit_mix_kernel: the rest of _shade_analytic before the mirror
//     and glass mixes (lighting.an_hit_mix_plain): on a diffuse lane,
//     GI's tail (gi_tail_analytic, one body with an_mirror_mix_kernel's)
//     times gi_scale_analytic added to the direct light, then the product
//     with AO; on a marker lane the emissive, point_light_color *
//     point_light_intensity times 1 / max(d*d*0.25 + 1, 1) of the
//     distance d to the camera; on a mirror or glass lane nothing (their
//     mix kernels write there).
//
// Both write the frame's radiance in place on their live lanes.  A lane
// the mask marks off reads its mask byte and nothing else and writes
// nothing (ROADMAP C, "Inactive lanes"): the frame's sky select drops it.
//
// Inputs are read in place (an_lanes.cuh's LaneIn): the hit's point and
// material id, the mask and AO a row a pixel under a leading sample axis
// ([spp, H, W]; AO a row a lane where each sample has its own), the
// camera's position one row; the outputs of the calls before (the direct
// light, the bounce's hit t, direction and cosine, its light and sky) a
// row a lane.  The scene's constants and the parameter block's pointer go
// by value in AnScene: the same bytes for every frame and every value of
// the data parameters, so a captured CUDA graph replays the calls.
//
// The arithmetic is the plain PyTorch version's on the card expression
// for expression, built with --fmad=false and without --use_fast_math:
// cos / PI as cos times float32(1 / float32(PI)) (PyTorch's CUDA division
// by a host scalar), a scalar over a tensor as its reciprocal 1.0f / x
// times the scalar (torch.Tensor.__rdiv__), dot as (x*x' + y*y') + z*z',
// length as sqrtf(fmaxf(dot, 0)), products left to right.  A select whose
// other side is 0 or 1 is a branch here (x * 1 and x + 0 * s are x's
// bits), so the sky is looked up only where the cut keeps the lane.
//
// What bounds them on this card.  The live lanes are the primary hits:
// on the bunny frames 0.74% of a 1080p frame's pixels (15,368 of
// 2,073,600, times 4 samples on `heavy`), on an_full ~65%.  A lane reads
// ~40-60 B and writes 12, and the mask is a byte a pixel, so every call
// is bound by its bytes; the sparse BVH calls by the mask's 2 MB and the
// walk over it.  Both run on persistent blocks.  The BVH kernel walks
// the mask a slice of 128 bytes at a time (live_lanes: one 4-byte load a
// thread, the next slice's in flight, a unit with a live lane worked
// where it lies, a slice with no live lane a load and a ballot), and
// under a sample axis a byte a pixel with the samples' lanes run inside,
// so `heavy`'s mask is read once, not once a sample; its GI sky's taps
// come from the cubemap's [6, F, F, 4] copy.  The analytic kernel, whose
// mask is ~65% live, keeps an_trace.cu's live_rounds: units of 32, a
// warp's live lanes queued and worked 32 a round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "an_lanes.cuh"
#include "an_scene.cuh"
#include "bvh_walk.cuh"
#include "param_block.cuh"
#include "persistent.cuh"

// The constants both kernels take from the host, each the float32 that
// PyTorch rounds the Python scalar to.
struct HitMixConsts {
  float inv_pi;     // float32(1 / float32(PI)): PyTorch's CUDA cos / PI
  float max_lum;    // GI_MAX_LUM
  float lum_floor;  // the clamp_min of the luminance, 1e-6
  float min_cos;    // GI_MIN_COS_THETA
  float ycoeff[3];  // YCOEFF
};

// The BVH scene's call (ops/hit_mix_cuda.py:bvh_hit_mix); the GI rows are
// null without GI, `ao` without AO.
struct BvhHitMixArgs {
  LaneIn active, ao;
  HitMixConsts c;
  int64_t n_lanes, n_px;
  int gi;
  const float* gi_t;    // the bounce's hit t [n_lanes]
  const float* gi_wi;   // its direction [n_lanes, 3]
  const float* gi_cos;  // its cos_theta [n_lanes]
  const float* gi_lit;  // the direct light at its hit [n_lanes, 3]
  float* out;           // the frame's radiance [n_lanes, 3], in place
  const float4* texels;  // the cubemap's [6, F, F, 4] copy; null: gradient
};

// The analytic scene's call (ops/hit_mix_cuda.py:an_hit_mix).
struct AnHitMixArgs {
  LaneIn p, mat, cam, active, ao;  // the hit's point and id; cam_pos
  HitMixConsts c;
  int64_t n_lanes, n_px;
  int gi;
  const float* gi_t;    // the bounce's hit t [n_lanes]
  const float* gi_cos;  // its cos_theta [n_lanes]
  const float* gi_lit;  // K3 at its hit [n_lanes, 3]
  const float* gi_sky;  // its sky [n_lanes, 3]
  float* out;           // the frame's radiance [n_lanes, 3], in place
};

namespace {

// out's row i, read before this lane writes it (not through __ldg)
__device__ __forceinline__ V3 out_row(const float* out, int64_t i) {
  return load3(out + 3 * i);
}

// _shade_bvh after its direct light on the live lanes, into the radiance;
// GI's sky from the cubemap's [6, F, F, 4] copy (kCube), else the
// gradient.
template <bool kCube>
__global__ void __launch_bounds__(kLiveThreads, kSliceBlocks)
bvh_hit_mix_kernel(const Units u, const AnScene s, const BvhHitMixArgs a) {
  live_lanes<false>(u, a.active, a.n_lanes, a.n_px, [&](int64_t i,
                                                        int64_t q) {
    V3 r = out_row(a.out, i);
    if (a.gi) {
      // gi_tail_bvh: the cut's select, the clamp's scale of 1 elsewhere
      V3 g = {0.0f, 0.0f, 0.0f};
      const float cs = __ldg(a.gi_cos + i);
      if (cs > a.c.min_cos) {
        V3 li;
        if (__ldg(a.gi_t + i) < kInf) {
          li = row3(a.gi_lit, i);
        } else {
          const V3 wi = row3(a.gi_wi, i);
          li = cube_or_gradient_sky<kCube>(s, a.texels, wi);
        }
        g = mul3(scale3(c3(s.bvh_albedo), cs * a.c.inv_pi), li);
        const float lum = dot3(g, c3(a.c.ycoeff));
        if (lum > a.c.max_lum)
          g = scale3(g, (1.0f / fmaxf(lum, a.c.lum_floor)) * a.c.max_lum);
      }
      r = add3(r, scale3(g, __ldg(s.prm->gi_scale_bvh)));
    }
    if (a.ao.p != nullptr) r = scale3(r, at_f32(a.ao, i, q));
    put3(a.out, i, r);
  });
}

// _shade_analytic after its direct light and GI's bounce on the live
// lanes, into the radiance: the diffuse lanes' mix and the marker's
// emissive.
__global__ void __launch_bounds__(kLiveThreads)
an_hit_mix_kernel(const Units u, const AnScene s, const AnHitMixArgs a) {
  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {
    const int id = in_i32(a.mat, i, a.n_px);
    if (id == kAnMarker) {
      const V3 d3 = sub3(in3(a.p, i, a.n_px), in3(a.cam, i, a.n_px));
      const float d = sqrtf(fmaxf(dot3(d3, d3), 0.0f));
      const float falloff = 1.0f / fmaxf(d * d * 0.25f + 1.0f, 1.0f);
      const V3 base = scale3(ldg3(s.prm->point_light_color),
                             __ldg(s.prm->point_light_intensity));
      put3(a.out, i, scale3(base, falloff));
      return;
    }
    if (material_type(s, id) != 0) return;  // the mirror's or glass's
    V3 r = out_row(a.out, i);
    if (a.gi) {
      const V3 g = gi_tail_analytic(s, id, a.c.inv_pi, a.gi_t, a.gi_cos,
                                    a.gi_lit, a.gi_sky, i);
      r = add3(r, scale3(g, __ldg(s.prm->gi_scale_analytic)));
    }
    if (a.ao.p != nullptr) r = scale3(r, in_f32(a.ao, i, a.n_px));
    put3(a.out, i, r);
  });
}

}  // namespace

// Plain C entry points for ctypes.  `scene` and `args` are host pointers
// (their own pointers are device pointers; a null mask: every lane live);
// the stream is a cudaStream_t.  Each returns a cudaError_t as an int: of
// the set-up calls, else cudaGetLastError().  Persistent blocks over the
// mask's slices (BVH) or units of 32 lanes (analytic; persistent.cuh).
extern "C" int ort_bvh_hit_mix(const AnScene* scene,
                               const BvhHitMixArgs* args, void* stream) {
  if (args->n_lanes > kMaxSliceLanes) return (int)cudaErrorInvalidValue;
  const Units u = slice_units(args->active, args->n_lanes, args->n_px);
  return args->texels != nullptr
             ? launch_persistent(bvh_hit_mix_kernel<true>, kLiveThreads, u,
                                 (cudaStream_t)stream, *scene, *args)
             : launch_persistent(bvh_hit_mix_kernel<false>, kLiveThreads, u,
                                 (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_an_hit_mix(const AnScene* scene, const AnHitMixArgs* args,
                              void* stream) {
  return launch_persistent(an_hit_mix_kernel, kLiveThreads,
                           make_units(args->n_lanes, 32),
                           (cudaStream_t)stream, *scene, *args);
}

// The structs' sizes, so the host can check its mirrors of the layouts:
// AnScene, LaneIn, HitMixConsts, BvhHitMixArgs, AnHitMixArgs into `sizes`
// (room for `cap`); returns how many there are.
extern "C" int ort_hit_mix_sizes(int* sizes, int cap) {
  const int all[] = {(int)sizeof(AnScene), (int)sizeof(LaneIn),
                     (int)sizeof(HitMixConsts), (int)sizeof(BvhHitMixArgs),
                     (int)sizeof(AnHitMixArgs)};
  const int n = (int)(sizeof(all) / sizeof(all[0]));
  for (int k = 0; k < n && k < cap; ++k) sizes[k] = all[k];
  return n;
}
