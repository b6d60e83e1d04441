// Glass and mirror shading of the analytic scene for Hopper (sm_90a), on
// the live lanes of their material's mask alone: each material's ray
// setup, secondary traces and sky lookups in one kernel before its K3
// calls, its selects and mixes in one kernel after them.
//
// These four kernels replace no TPU kernel.  In the JAX package this work
// is jnp code behind its glass and mirror tile gate
// (opengl_raytracing_tpu/models/pipeline.py _tile_gated_shade, applied by
// _shade_analytic to the whole ops/lighting.py shade_glass and
// shade_mirror, ORT_ANALYTIC_GATE_FRAC, on by default), which compacts the
// 128-lane tiles that hold the material under a lax.cond with a dense
// fallback.  A captured CUDA graph holds no data-dependent branch, so here
// the frame hands each call the lanes of its material (models/pipeline.py
// _shade_analytic: the hit lanes of get_material's resolved type) as a
// device mask and the kernel skips the others:
//
//   * an_glass_rays_kernel: shade_glass up to its three K3 calls
//     (lighting.glass_rays_plain): normalize(n), normalize(wo), the
//     material's ior, eta, the reflected ray, refract's (t_phys, k), the
//     distorted t_dir and cos_theta; the reflected, straight and bent
//     secondaries traced without the glass sphere from p + d * EPS, each
//     hit and its view normalize(cam_pos - p2); the sky of the reflected
//     ray on every live lane, of the straight ray where it missed, of the
//     bent ray where it refracts (k > 0) and missed;
//   * an_glass_mix_kernel: shade_glass after them (glass_mix_plain): the
//     reflection's valid select and mix, the straight and bent selects,
//     the refraction mix, the albedo, f0 and the Fresnel term;
//   * an_mirror_ray_kernel: shade_mirror up to its K3 call
//     (mirror_ray_plain): the reflected ray traced through the whole
//     scene, its hit, the view -r, and the sky where it missed;
//   * an_mirror_mix_kernel: shade_mirror after K3 and, with GI, after its
//     bounce (mirror_mix_plain): GI's tail at the mirror's hit (the
//     bounce's valid select against its sky, albedo * cos / PI * li, the
//     cos > 0 select, times gi_scale_analytic, added to the direct light),
//     the valid select against the mirror's sky and the mirror's albedo.
//
// The mix kernels write the material's radiance into the frame's
// radiance tensor in place, on their live lanes: the frame's select by
// material type is their mask.  A lane the mask marks off reads its mask
// byte and nothing else and writes nothing (ROADMAP C, "Inactive
// lanes"); a rays kernel leaves a sky it does not look up unwritten.
//
// Inputs are read in place (an_lanes.cuh's LaneIn): the frame's hit, view
// and material id a row a pixel under a leading sample axis ([spp, H, W]),
// the camera's position one row; the outputs of the calls between the two
// kernels (K3's radiance, the bounce's hit and cosine, the skies) a row a
// lane.  The scene's constants and the parameter block's pointer go by
// value in AnScene, as for K3 and an_trace.cu: the same bytes for every
// frame and every value of the data parameters, so a captured CUDA graph
// replays the calls.
//
// The arithmetic is the plain PyTorch version's on the card expression for
// expression, built with --fmad=false and without --use_fast_math:
// normalize as x / max(length, 1e-12), eta = 1 / ior a division, refract's
// direction 0 where k < 0, mix as a + (b - a) * t, f0 as q * q (PyTorch
// squares a power of 2), the Fresnel term's pow as powf (PyTorch's CUDA
// pow of a float exponent), and GI's cos / PI as cos times the float32
// reciprocal of PI (PyTorch's CUDA division by a host scalar; the CPU
// divides, ROADMAP C).  The kernels give the plain versions' bits on live
// lanes on the card.
//
// What bounds them on this card.  A call's live lanes are the material's
// hit lanes, ~0.6% each of a 1080p an_full frame (11,000-12,000 of
// 2,073,600), so every call is bound by its bytes: the 2 MB mask (a byte a
// lane, or a pixel under a sample axis) and ~100-200 B a live lane in and
// out, a few microseconds at 3.35 TB/s; the glass rays kernel's three
// five-primitive traces and up to three cubemap lookups are ~700
// operations a live lane.  The mix kernels keep an_trace.cu's design:
// persistent blocks, a warp's live lanes queued 32 a round (live_rounds),
// a dead unit costing its warp 32 mask bytes and a __ballot_sync.
//
// The rays kernels walk the mask with an_lanes.cuh's live_lanes, as the
// sky kernel does: a warp takes a slice of the mask at a time, a load of
// kGlassSliceBytes (4) or kMirrorSliceBytes (16) bytes a thread, with the
// next slice's load in flight while this one's lanes are worked, and the
// slice's units of 32 lanes spread over the mask; every unit with a live
// lane is worked where it lies, a lane a thread (a sphere's disk of
// pixels is compact: queued 32 a round, its rims' lanes waited for
// rounds and were slower).  Indices are 32-bit.
// Under a sample axis the mask is a byte a pixel, read once, and a live
// pixel runs its samples' lanes in turn with the pixel's rows known (no
// division).  A cubemap tap is one 16-byte load of the table's [6, F, F,
// 4] copy (an_scene.cuh's texel_sky); each kernel is built once with the
// cubemap and once with the gradient (kCube, cube_or_gradient_sky), so
// that a gradient call carries no tap.  Each is held to the blocks an SM its registers allow without a
// spill (kGlassRaysBlocks, kMirrorRayBlocks: 8, 64 registers); at 10 or
// 12 the glass kernel spilled and the mirror kernel (48 registers) lost
// a third of its speed.  What is left of a call is the scan's wave over
// the mask (~0.002-0.004 ms) and one lane's chain of loads, traces and
// stores (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "an_lanes.cuh"
#include "an_scene.cuh"
#include "bvh_walk.cuh"
#include "param_block.cuh"
#include "persistent.cuh"
#include "sampling.cuh"

// The constants both materials' kernels take from the host, each the
// float32 that PyTorch rounds the Python scalar to.
struct ShadeConsts {
  float eps;         // EPS: the secondaries' origin offset and window
  float distortion;  // GLASS_DISTORTION_STRENGTH
  float local_refl;  // GLASS_LOCAL_REFL_WEIGHT
  float min_ior;     // shade_glass's clamp_min of the ior, 1.0001
  float inv_pi;      // float32(1 / float32(PI)): PyTorch's CUDA cos / PI
  int marker;        // the marker is traced (the point light is on)
};

// Glass's rays call (ops/an_shade_cuda.py:glass_rays).  The secondaries'
// outputs are [3, n_lanes] planes (the reflected, straight and bent ray),
// each plane a hit K3 reads in place.
struct GlassRaysArgs {
  LaneIn p, n, wo, mat, cam, active;  // the hit, the view, its id; cam_pos
  ShadeConsts c;
  int64_t n_lanes, n_px;
  float* t;       // [3, n_lanes]
  float* hp;      // [3, n_lanes, 3]
  float* hn;      // [3, n_lanes, 3]
  int32_t* hmat;  // [3, n_lanes]
  float* view;    // [3, n_lanes, 3]: normalize(cam_pos - p2)
  float* sky;     // [3, n_lanes, 3]: reflected, straight, bent
  float* k;       // [n_lanes]: refract's k
  float* cos;     // [n_lanes]: cos_theta
  const float4* texels;  // the cubemap's [6, F, F, 4] copy; null: gradient
};

// Glass's mix call (ops/an_shade_cuda.py:glass_mix).
struct GlassMixArgs {
  LaneIn mat, active;    // the hit's material id
  ShadeConsts c;
  int64_t n_lanes, n_px;
  // a row a lane each, the reflected, straight and bent ray's: the rays
  // call's hit t [n_lanes], its skies [n_lanes, 3], K3 at the hits
  const float* t[3];
  const float* sky[3];
  const float* lit[3];
  const float* k;        // the rays call's k, cos_theta [n_lanes]
  const float* cos;
  float* out;            // the frame's radiance [n_lanes, 3]
};

// The mirror's ray call (ops/an_shade_cuda.py:mirror_ray).
struct MirrorRayArgs {
  LaneIn p, n, wo, active;
  ShadeConsts c;
  int64_t n_lanes, n_px;
  float* t;       // [n_lanes]
  float* hp;      // [n_lanes, 3]
  float* hn;      // [n_lanes, 3]
  int32_t* hmat;  // [n_lanes]
  float* view;    // [n_lanes, 3]: -r, K3's view at the hit
  float* sky;     // [n_lanes, 3]: where the reflected ray missed
  const float4* texels;  // the cubemap's [6, F, F, 4] copy; null: gradient
};

// The mirror's mix call (ops/an_shade_cuda.py:mirror_mix); the GI rows
// are null without GI.
struct MirrorMixArgs {
  LaneIn mat, active;      // the mirror hit's material id
  ShadeConsts c;
  int64_t n_lanes, n_px;
  int gi;
  const float* t;          // the ray call's hit: t, material id
  const int32_t* hmat;
  const float* sky;        // [n_lanes, 3]
  const float* direct;     // K3 at the hit [n_lanes, 3]
  const float* gi_t;       // the bounce's hit t [n_lanes]
  const float* gi_cos;     // its cos_theta [n_lanes]
  const float* gi_lit;     // K3 at the bounce's hit [n_lanes, 3]
  const float* gi_sky;     // the bounce's sky [n_lanes, 3]
  float* out;              // the frame's radiance [n_lanes, 3]
};

// The rays kernels' blocks an SM (__launch_bounds__): as many as their
// registers allow without a spill (ptxas), and their mask bytes a thread
// a slice (live_lanes' kBytes): 16 on the mirror's call (a slice a warp
// at 1080p), 4 on glass's, whose longer lanes want more warps working
// (PERF.md section 6)
constexpr int kGlassRaysBlocks = 8;
constexpr int kMirrorRayBlocks = 8;
constexpr int kGlassSliceBytes = 4;
constexpr int kMirrorSliceBytes = 16;

namespace {

__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }

// vecmath.mix(a, b, t) = a + (b - a) * t
__device__ __forceinline__ V3 mix3(V3 a, V3 b, float t) {
  return add3(a, scale3(sub3(b, a), t));
}

// vecmath.reflect(i, n) = i - (2 * dot(n, i)) * n
__device__ __forceinline__ V3 reflect3(V3 i, V3 n) {
  return sub3(i, scale3(n, 2.0f * dot3(n, i)));
}

// shade_glass up to its K3 calls on the live lanes, over slices of the
// mask (live_lanes, every unit worked where it lies); lane i of pixel q.
template <bool kCube>
__global__ void __launch_bounds__(kLiveThreads, kGlassRaysBlocks)
an_glass_rays_kernel(const Units u, const AnScene s, const GlassRaysArgs a) {
  const int64_t N = a.n_lanes;
  live_lanes<false, kGlassSliceBytes>(u, a.active, a.n_lanes, a.n_px,
                                      [&](int64_t i, int64_t q) {
    const V3 n = norm3(at3(a.n, i, q));
    const V3 v = norm3(at3(a.wo, i, q));
    const V3 iv = neg3(v);
    const float ior = fmaxf(material(s, at_i32(a.mat, i, q)).ior,
                            a.c.min_ior);
    const float eta = 1.0f / ior;
    const V3 r = reflect3(iv, n);
    const float ct = dot3(neg3(iv), n);
    a.cos[i] = fminf(fmaxf(ct, 0.0f), 1.0f);
    // vecmath.refract(i, n, eta)
    const float cosi = dot3(n, iv);
    const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
    const float kk = eta * cosi + sqrtf(fmaxf(k, 0.0f));
    V3 t_phys = sub3(scale3(iv, eta), scale3(n, kk));
    if (k < 0.0f) t_phys = {0.0f, 0.0f, 0.0f};
    a.k[i] = k;
    const V3 t_dir = norm3(mix3(iv, norm3(t_phys), a.c.distortion));
    const V3 p = at3(a.p, i, q);
    const V3 cam = at3(a.cam, i, q);
    const V3 dirs[3] = {r, iv, t_dir};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const V3 o = add3(p, scale3(dirs[j], a.c.eps));
      const int64_t at = j * N + i;
      const float t = hit_out(s, o, dirs[j], false, a.c.marker, a.c.eps, at,
                              a.t, a.hp, a.hn, a.hmat);
      const V3 p2 = add3(o, scale3(dirs[j], t));
      put3(a.view, at, norm3(sub3(cam, p2)));
      // the reflected ray's sky on every live lane, the straight ray's
      // where it missed, the bent ray's where it refracts and missed
      if (j == 0 || (!(t < kInf) && (j == 1 || k > 0.0f)))
        put3(a.sky, at,
             cube_or_gradient_sky<kCube>(s, a.texels, dirs[j]));
    }
  });
}

// shade_glass after its K3 calls on the live lanes, into the radiance.
__global__ void __launch_bounds__(kLiveThreads)
an_glass_mix_kernel(const Units u, const AnScene s, const GlassMixArgs a) {
  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {
    const Material m = material(s, in_i32(a.mat, i, a.n_px));
    const V3 env = row3(a.sky[0], i);
    const V3 local = __ldg(a.t[0] + i) < kInf ? row3(a.lit[0], i) : env;
    const V3 reflect_col = mix3(env, local, a.c.local_refl);
    const V3 straight =
        __ldg(a.t[1] + i) < kInf ? row3(a.lit[1], i) : row3(a.sky[1], i);
    V3 refr = straight;
    if (__ldg(a.k + i) > 0.0f) {
      const V3 bent =
          __ldg(a.t[2] + i) < kInf ? row3(a.lit[2], i) : row3(a.sky[2], i);
      refr = mix3(straight, bent, a.c.distortion);
    }
    refr = mul3(refr, m.albedo);
    const float ior = fmaxf(m.ior, a.c.min_ior);
    const float q = (ior - 1.0f) / (ior + 1.0f);
    const float f0 = q * q;
    const float fresnel =
        f0 + (1.0f - f0) * powf(1.0f - __ldg(a.cos + i), 5.0f);
    put3(a.out, i, mix3(refr, reflect_col, fresnel));
  });
}

// shade_mirror up to its K3 call on the live lanes, over slices of the
// mask (live_lanes, every unit worked where it lies); lane i of pixel q.
template <bool kCube>
__global__ void __launch_bounds__(kLiveThreads, kMirrorRayBlocks)
an_mirror_ray_kernel(const Units u, const AnScene s, const MirrorRayArgs a) {
  live_lanes<false, kMirrorSliceBytes>(u, a.active, a.n_lanes, a.n_px,
                                       [&](int64_t i, int64_t q) {
    const V3 n = norm3(at3(a.n, i, q));
    const V3 iv = neg3(norm3(at3(a.wo, i, q)));
    const V3 r = reflect3(iv, n);
    const V3 o = add3(at3(a.p, i, q), scale3(r, a.c.eps));
    const float t = hit_out(s, o, r, true, a.c.marker, a.c.eps, i, a.t, a.hp,
                            a.hn, a.hmat);
    put3(a.view, i, neg3(r));
    if (!(t < kInf))
      put3(a.sky, i, cube_or_gradient_sky<kCube>(s, a.texels, r));
  });
}

// shade_mirror after K3 (and GI's bounce) on the live lanes, into the
// radiance.
__global__ void __launch_bounds__(kLiveThreads)
an_mirror_mix_kernel(const Units u, const AnScene s, const MirrorMixArgs a) {
  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {
    const Material m = material(s, in_i32(a.mat, i, a.n_px));
    V3 col;
    if (__ldg(a.t + i) < kInf) {
      col = row3(a.direct, i);
      if (a.gi) {
        // one_bounce_gi_analytic's tail at the mirror's hit
        const V3 g = gi_tail_analytic(s, __ldg(a.hmat + i), a.c.inv_pi,
                                      a.gi_t, a.gi_cos, a.gi_lit, a.gi_sky,
                                      i);
        col = add3(col, scale3(g, __ldg(s.prm->gi_scale_analytic)));
      }
    } else {
      col = row3(a.sky, i);
    }
    put3(a.out, i, mul3(col, m.albedo));
  });
}

}  // namespace

// Plain C entry points for ctypes.  `scene` and `args` are host pointers
// (their own pointers are device pointers; a null mask: every lane live);
// the stream is a cudaStream_t.  Each returns a cudaError_t as an int: of
// the set-up calls, else cudaGetLastError().  Persistent blocks over the
// mask's slices (the rays kernels; a call over kMaxSliceLanes lanes is
// refused) or units of 32 lanes (the mixes; persistent.cuh).
extern "C" int ort_an_glass_rays(const AnScene* scene,
                                 const GlassRaysArgs* args, void* stream) {
  if (args->n_lanes > kMaxSliceLanes) return (int)cudaErrorInvalidValue;
  const Units u = slice_units(args->active, args->n_lanes, args->n_px,
                              kGlassSliceBytes);
  return args->texels != nullptr
             ? launch_persistent(an_glass_rays_kernel<true>, kLiveThreads, u,
                                 (cudaStream_t)stream, *scene, *args)
             : launch_persistent(an_glass_rays_kernel<false>, kLiveThreads,
                                 u, (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_an_glass_mix(const AnScene* scene,
                                const GlassMixArgs* args, void* stream) {
  return launch_persistent(an_glass_mix_kernel, kLiveThreads,
                           make_units(args->n_lanes, 32),
                           (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_an_mirror_ray(const AnScene* scene,
                                 const MirrorRayArgs* args, void* stream) {
  if (args->n_lanes > kMaxSliceLanes) return (int)cudaErrorInvalidValue;
  const Units u = slice_units(args->active, args->n_lanes, args->n_px,
                              kMirrorSliceBytes);
  return args->texels != nullptr
             ? launch_persistent(an_mirror_ray_kernel<true>, kLiveThreads, u,
                                 (cudaStream_t)stream, *scene, *args)
             : launch_persistent(an_mirror_ray_kernel<false>, kLiveThreads,
                                 u, (cudaStream_t)stream, *scene, *args);
}

extern "C" int ort_an_mirror_mix(const AnScene* scene,
                                 const MirrorMixArgs* args, void* stream) {
  return launch_persistent(an_mirror_mix_kernel, kLiveThreads,
                           make_units(args->n_lanes, 32),
                           (cudaStream_t)stream, *scene, *args);
}

// The structs' sizes, so the host can check its mirrors of the layouts:
// AnScene, LaneIn, ShadeConsts, GlassRaysArgs, GlassMixArgs, MirrorRayArgs,
// MirrorMixArgs into `sizes` (room for `cap`); returns how many there are.
extern "C" int ort_an_shade_sizes(int* sizes, int cap) {
  const int all[] = {(int)sizeof(AnScene),       (int)sizeof(LaneIn),
                     (int)sizeof(ShadeConsts),   (int)sizeof(GlassRaysArgs),
                     (int)sizeof(GlassMixArgs),  (int)sizeof(MirrorRayArgs),
                     (int)sizeof(MirrorMixArgs)};
  const int n = (int)(sizeof(all) / sizeof(all[0]));
  for (int k = 0; k < n && k < cap; ++k) sizes[k] = all[k];
  return n;
}
