// The present pass for Hopper (sm_90a): SVGF-lite 7x7 variance-guided
// filter, strength blend, ACES and gamma, one launch.
//
// The filter replaces the TPU kernel K4,
//   opengl_raytracing_tpu/ops/svgf_pallas.py  _kernel
//   (launched by svgf_filter_pallas),
// and computes what the plain PyTorch version
// opengl_raytracing_tpu_torch/ops/svgf.py:svgf_filter computes
// (reference: shaders/rt/rt_present.frag:126-225): for each pixel, a
// weighted mean of its 7x7 neighbourhood, each tap weighted by
// exp(-(colour distance * k + position distance * 0.02 + normal distance
// * 2)) times a variance boost; taps outside the image weigh 0, and a pixel
// whose weights sum to 0 keeps its own colour.  The TPU side left the tail
// of the pass (ops/svgf.py:blend_tonemap: raw + (filtered - raw) * s,
// exposure, the ACES quotient, the clamps, pow(x, 1/2.2)) to its compiler's
// fusion; here it is the last thing a thread does to its pixel.
//
// Three kernels share the device functions below:
//   svgf_kernel          filtered rgb (held alone to the plain filter);
//   svgf_present_kernel  the same body ending in the tail: sRGB, and no
//                        filtered image in device memory;
//   tonemap_kernel       the tail alone over accum's rgb, SVGF off.
//
// Their parameters (the five svgf_* values, the blend strength clamped on
// the host, the exposure) are words of the parameter block
// (param_block.cuh), read through a pointer where a thread uses them (the
// filter's before its taps, the tail's after them, so that none is held
// in a register across the tap loop): the launch's arguments are the same
// for every value of them, so a captured CUDA graph replays the call
// whatever the sliders say.
//
// What bounds the filter on this card: instruction issue, not bytes.  A
// tap is 46 float instructions (three distances, the exponent, expf's 8,
// the weight, four sums; nothing contracts under --fmad=false), 49 taps a
// pixel, against 60 bytes of device memory a pixel.  An SM issues four
// warp instructions a cycle, so whatever is not one of those 46 costs time
// one for one.  The design spends as little as it can on the rest:
//
//   * A thread computes a run of kRun pixels along a row.  For each of its
//     7 tile rows it loads the run's kRun + 6 tile pixels once (two
//     16-byte shared loads and a 4-byte one each: r g b px | py pz nx ny
//     | nz) and uses those registers for every pixel of the run the tap
//     belongs to: 1.7 shared loads a tap at a run of 2 (one pixel a thread
//     took 9 scalar loads a tap).  Each pixel still sees its taps dy outer,
//     dx inner.  The loop over tile rows stays rolled; inside it the taps
//     of a row are straight-line code with no branch, so the compiler
//     interleaves the run's independent pixels.
//   * A tile row lies in shared memory with its columns run-strided
//     (column x at (x % kRun) * kStride + x / kRun): threads whose runs
//     start kRun columns apart read neighbouring 16 bytes, so the wide
//     loads have no bank conflicts.
//   * A block whose whole halo tile lies inside the image (all but the
//     image's rim) runs the body without any bounds test.  Rim blocks
//     test each tile row and tile pixel once (not each tap): outside the
//     image it weighs 0, so it is skipped.
//   * The two filter entries take a row band of the image as well as the
//     whole of it (a band per card, parallel/shardmap.py): planes of the
//     band's h rows with `halo` neighbour rows above and below, the
//     band's first row in the image and the image's height.  A tap's
//     weight tests its row in the image, its data comes from the planes
//     (zeros past them, as the plain version pads), and a block takes
//     the body without tests only where its output rows lie in the band,
//     its tile in the planes and its taps' rows in the image.  The whole
//     image is the band of h rows at row 0 with no halo: the same blocks
//     take the same body as before.
//   * The numbers (probe_svgf.py --sweep times others): a run of 2, a
//     32 x 16 output tile a block of 256 threads, 64 registers, so that an
//     SM holds 32 warps.  The 38 x 22 halo tile reads each input 1.63
//     times (the 32 x 8 tile it replaces: 2.08 times).  A run of 4 issues
//     1% fewer instructions but needs 110 registers, 16 warps an SM, and
//     is slower; wider and taller tiles read less twice but leave the SMs
//     fewer blocks to overlap one block's tile load with another's taps.
//     Each thread gathers whole tile pixels: the colour as one 16-byte
//     load, position and normal as 4-byte loads 12 bytes apart, which the
//     L1 serves from the lines a warp shares.
//
// Rounding: the plain version's expressions in its order (dot products
// x, y, z; the taps dy outer, dx inner; `normalize` once a tile pixel as
// x / max(sqrt(max(d, 0)), 1e-12)), IEEE expf, division and sqrtf, and
// --fmad=false, so no product is contracted into an FMA.  Two operations
// of the plain version that cannot change a value are left out:
// max(1 - nd, 0) after nd was clamped to [-1, 1], and gamma's max(x, 0)
// after the clamp to [0, 1].  The card's float32 peak counts an FMA as two
// operations, so a kernel that contracts nothing can reach half of it at
// most.

#include <cuda_runtime.h>
#include <stdint.h>

#include "param_block.cuh"

namespace {

constexpr int kRadius = 3, kTaps = 2 * kRadius + 1;
constexpr int kRun = 2;               // output pixels a thread, along a row
constexpr int kBX = 32, kBY = 16;     // output pixels of a block
constexpr int kBlocks = 4;            // blocks an SM the registers allow for
constexpr int kThreadsX = kBX / kRun;              // threads along a row
constexpr int kThreads = kThreadsX * kBY;
constexpr int kTX = kBX + 2 * kRadius;             // halo tile width
constexpr int kTY = kBY + 2 * kRadius;             // halo tile height
constexpr int kCols = kRun + 2 * kRadius;          // tile columns a run reads
// A tile row in shared memory holds its columns run-strided: column x at
// (x % kRun) * kStride + x / kRun, so that the threads of a row, whose
// runs start kRun columns apart, read neighbouring 16 bytes.  A warp spans
// 32 / kThreadsX thread rows: the pitch puts them on different banks.
constexpr int kStride = 24;
constexpr int kPitch = kStride * kRun;
constexpr int kTile = kPitch * kTY;
constexpr int kLoads = (kTX * kTY + kThreads - 1) / kThreads;  // a thread
constexpr size_t kSharedBytes = (size_t)kTile * (2 * sizeof(float4) + 4);
constexpr float kKPos = 0.02f, kKNrm = 2.0f;       // rt_present.frag:160-161
constexpr float kY0 = 0.299f, kY1 = 0.587f, kY2 = 0.114f;
constexpr float kInvGamma = (float)(1.0 / 2.2);
constexpr int kTonePixels = 4, kToneThreads = 256;
static_assert(kBX % kRun == 0 && (kThreadsX >= 32 || 32 % kThreadsX == 0),
              "a warp covers whole thread rows");
static_assert(kPitch >= kTX && (kThreadsX >= 32 || kPitch % 32 == kThreadsX),
              "a warp's thread rows read disjoint banks");

struct Params {
  float var_max, k_var, k_color, k_var_m, k_color_m;
};

struct Tone {
  float strength, exposure;
};

__device__ __forceinline__ Params params_of(const ParamBlock* __restrict__ b) {
  return {__ldg(b->svgf_var_max), __ldg(b->svgf_k_var), __ldg(b->svgf_k_color),
          __ldg(b->svgf_k_var_motion), __ldg(b->svgf_k_color_motion)};
}

__device__ __forceinline__ Tone tone_of(const ParamBlock* __restrict__ b) {
  return {__ldg(b->svgf_strength_clamped), __ldg(b->exposure)};
}

// Where the output rows lie: the planes hold `halo` rows above and below
// them (row -halo .. h + halo - 1 of the output's row numbering), and
// output row 0 is row `row0` of an image `full_h` rows high.
struct Band {
  int halo, row0, full_h;
};

// One channel of ops/svgf.py:blend_tonemap: the strength blend, exposure,
// the ACES quotient (ops/tonemap.py:aces_tonemap), the clamp, gamma.
__device__ __forceinline__ float tone_channel(float raw, float fil, Tone t) {
  const float lin = raw + (fil - raw) * t.strength;
  const float x = lin * t.exposure;
  float m = (x * (2.51f * x + 0.03f)) / (x * (2.43f * x + 0.59f) + 0.14f);
  m = m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
  return powf(m, kInvGamma);
}

// min(max(x, lo), hi) that keeps a NaN, as torch.clamp does: one
// instruction each (fminf and fmaxf would drop the NaN).
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;\n\tmin.NaN.f32 %0, %0, %3;"
      : "=&f"(y) : "f"(x), "f"(lo), "f"(hi));
  return y;
}

// Where tile pixel (row ty, column tx) lies in a shared plane.
__device__ __forceinline__ int tile_at(int ty, int tx) {
  return ty * kPitch + (tx % kRun) * kStride + tx / kRun;
}

// Stage the block's halo tile: plane a holds r g b px, plane b py pz nx ny,
// plane c nz, the normal normalised; zeros outside the planes (h rows and
// `halo` more above and below; the pointers at output row 0).  A thread
// takes kLoads tile pixels and issues all their device loads before it
// uses any, so that the block waits for device memory once.
template <bool kInterior>
__device__ __forceinline__ void load_tile(
    float4* __restrict__ a, float4* __restrict__ b, float* __restrict__ c,
    const float* __restrict__ accum, const float* __restrict__ gpos,
    const float* __restrict__ gnrm, int h, int w, int halo, int x0, int y0,
    int tid) {
  float4 col[kLoads];
  float pos[kLoads][3], nrm[kLoads][3];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int k = tid + n * kThreads;
    const int ty = k / kTX, tx = k - ty * kTX;
    const int gx = x0 + tx, gy = y0 + ty;
    col[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < 3; ++e) pos[n][e] = nrm[n][e] = 0.0f;
    if (k < kTX * kTY && (kInterior || (gx >= 0 && gx < w &&
                                        gy >= -halo && gy < h + halo))) {
      const int64_t i = (int64_t)gy * w + gx;
      col[n] = __ldg(reinterpret_cast<const float4*>(accum) + i);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        pos[n][e] = __ldg(gpos + 3 * i + e);
        nrm[n][e] = __ldg(gnrm + 3 * i + e);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int k = tid + n * kThreads;
    if (k >= kTX * kTY) break;
    const int ty = k / kTX, tx = k - ty * kTX;
    const float nx = nrm[n][0], ny = nrm[n][1], nz = nrm[n][2];
    float d = nx * nx + ny * ny + nz * nz;
    d = d < 0.0f ? 0.0f : d;
    float len = sqrtf(d);
    len = len < 1e-12f ? 1e-12f : len;  // a zero normal stays zero
    const int t = tile_at(ty, tx);
    a[t] = make_float4(col[n].x, col[n].y, col[n].z, pos[n][0]);
    b[t] = make_float4(pos[n][1], pos[n][2], nx / len, ny / len);
    c[t] = nz / len;
  }
}

// What a pixel's 49 weights share (rt_present.frag:139-166).
struct Centre {
  float r, g, b, px, py, pz, nx, ny, nz;
  float k_col, var_boost, w_off;
};

__device__ __forceinline__ Centre centre_of(float4 va, float4 vb, float vc,
                                            float m2, float mx, float my,
                                            Params prm) {
  Centre ce;
  ce.r = va.x, ce.g = va.y, ce.b = va.z;
  ce.px = va.w, ce.py = vb.x, ce.pz = vb.y;
  ce.nx = vb.z, ce.ny = vb.w, ce.nz = vc;
  const float l = ce.r * kY0 + ce.g * kY1 + ce.b * kY2;
  float var_c = m2 - l * l;
  var_c = var_c < 0.0f ? 0.0f : (var_c > prm.var_max ? prm.var_max : var_c);
  const float mot = sqrtf(mx * mx + my * my);
  float t = (mot - 0.005f) / (float)(0.05 - 0.005);  // smoothstep(.005, .05)
  t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
  t = t * t * (3.0f - 2.0f * t);
  const float k_var = prm.k_var + (prm.k_var_m - prm.k_var) * t;
  const float k_color = prm.k_color + (prm.k_color_m - prm.k_color) * t;
  ce.var_boost = 1.0f + var_c * (1.0f + k_var * 0.5f);
  ce.w_off = ce.var_boost * (1.0f + var_c * 4.0f);
  ce.k_col = k_color * 0.3f + 0.05f;
  return ce;
}

// The block's pixels out of its staged tile.  Thread (tx, ty) owns the
// pixels (bx0 + tx * kRun + j, by0 + ty), j < kRun, of the h output rows.
template <bool kInterior, bool kPresent>
__device__ __forceinline__ void filter_runs(
    const float4* __restrict__ a, const float4* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ accum,
    const float* __restrict__ motion, int h, int w, Band band, int bx0,
    int by0, const ParamBlock* __restrict__ pb, float* __restrict__ out) {
  const int xs = bx0 + threadIdx.x * kRun;
  const int y = by0 + threadIdx.y;
  if (!kInterior && (xs >= w || y >= h)) return;

  Centre ce[kRun];
  float ar[kRun], ag[kRun], ab[kRun], aw[kRun];
  // the run's tap (row 0, column col) is tile pixel t0 + tile_at(0, col):
  // its columns start a multiple of kRun into the tile row
  const int t0 = threadIdx.y * kPitch + threadIdx.x;
  const Params prm = params_of(pb);
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int t = t0 + tile_at(kRadius, j + kRadius);
    // a run that leaves the image on the right computes on the tile's
    // zeros there and stores nothing
    const bool in = kInterior || xs + j < w;
    const int64_t i = (int64_t)y * w + (in ? xs + j : xs);
    ce[j] = centre_of(a[t], b[t], c[t], __ldg(accum + 4 * i + 3),
                      __ldg(motion + 2 * i), __ldg(motion + 2 * i + 1), prm);
    ar[j] = ag[j] = ab[j] = aw[j] = 0.0f;
  }

#pragma unroll 1
  for (int r = 0; r < kTaps; ++r) {
    const int gy = band.row0 + y - kRadius + r;  // the tap row in the image
    if (!kInterior && (gy < 0 || gy >= band.full_h))
      continue;  // a tile row outside the image weighs 0
    const bool centre_row = r == kRadius;
#pragma unroll
    for (int col = 0; col < kCols; ++col) {
      if (!kInterior) {  // and so does a tile pixel left or right of it
        const int gx = xs - kRadius + col;
        if (gx < 0 || gx >= w) continue;
      }
      const int t = t0 + tile_at(r, col);
      const float4 va = a[t], vb = b[t];
      const float vc = c[t];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int dx = col - j;  // the tap's column among pixel j's 7
        if (dx < 0 || dx >= kTaps) continue;
        const Centre& p = ce[j];
        const float dr = va.x - p.r, dg = va.y - p.g, db = va.z - p.b;
        const float dc2 = dr * dr + dg * dg + db * db;
        const float qx = va.w - p.px, qy = vb.x - p.py, qz = vb.y - p.pz;
        const float dist2 = qx * qx + qy * qy + qz * qz;
        const float nd = p.nx * vb.z + p.ny * vb.w + p.nz * vc;
        const float ndist = 1.0f - clamp_nan(nd, -1.0f, 1.0f);
        const float expo = dc2 * p.k_col + dist2 * kKPos + ndist * kKNrm;
        const float wgt = (dx == kRadius && centre_row ? p.var_boost
                                                       : p.w_off) *
                          expf(-expo);
        ar[j] = ar[j] + va.x * wgt;
        ag[j] = ag[j] + va.y * wgt;
        ab[j] = ab[j] + va.z * wgt;
        aw[j] = aw[j] + wgt;
      }
    }
  }

  const Tone tone = kPresent ? tone_of(pb) : Tone{0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (!kInterior && xs + j >= w) break;
    float fr = ce[j].r, fg = ce[j].g, fb = ce[j].b;
    if (!(aw[j] <= 0.0f)) {
      const float den = aw[j] < 1e-20f ? 1e-20f : aw[j];
      fr = ar[j] / den;
      fg = ag[j] / den;
      fb = ab[j] / den;
    }
    float* o = out + 3 * ((int64_t)y * w + xs + j);
    if (kPresent) {
      o[0] = tone_channel(ce[j].r, fr, tone);
      o[1] = tone_channel(ce[j].g, fg, tone);
      o[2] = tone_channel(ce[j].b, fb, tone);
    } else {
      o[0] = fr;
      o[1] = fg;
      o[2] = fb;
    }
  }
}

template <bool kPresent>
__device__ __forceinline__ void svgf_block(
    const float* __restrict__ accum, const float* __restrict__ motion,
    const float* __restrict__ gpos, const float* __restrict__ gnrm, int h,
    int w, Band band, const ParamBlock* __restrict__ pb,
    float* __restrict__ out) {
  extern __shared__ float4 tile[];
  float4* a = tile;
  float4* b = a + kTile;
  float* c = reinterpret_cast<float*>(b + kTile);
  const int bx0 = blockIdx.x * kBX, by0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  // the same for the whole block: every output row in the band, the
  // whole halo tile in the planes' columns and rows, and in the image
  const bool interior =
      bx0 >= kRadius && bx0 + kBX + kRadius <= w && by0 + kBY <= h &&
      by0 - kRadius >= -band.halo && by0 + kBY + kRadius <= h + band.halo &&
      band.row0 + by0 - kRadius >= 0 &&
      band.row0 + by0 + kBY + kRadius <= band.full_h;
  if (interior) {
    load_tile<true>(a, b, c, accum, gpos, gnrm, h, w, band.halo,
                    bx0 - kRadius, by0 - kRadius, tid);
    __syncthreads();
    filter_runs<true, kPresent>(a, b, c, accum, motion, h, w, band, bx0, by0,
                                pb, out);
  } else {
    load_tile<false>(a, b, c, accum, gpos, gnrm, h, w, band.halo,
                     bx0 - kRadius, by0 - kRadius, tid);
    __syncthreads();
    filter_runs<false, kPresent>(a, b, c, accum, motion, h, w, band, bx0,
                                 by0, pb, out);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocks)
svgf_kernel(const float* __restrict__ accum, const float* __restrict__ motion,
            const float* __restrict__ gpos, const float* __restrict__ gnrm,
            int h, int w, Band band, const ParamBlock* __restrict__ pb,
            float* __restrict__ out) {
  svgf_block<false>(accum, motion, gpos, gnrm, h, w, band, pb, out);
}

__global__ void __launch_bounds__(kThreads, kBlocks)
svgf_present_kernel(const float* __restrict__ accum,
                    const float* __restrict__ motion,
                    const float* __restrict__ gpos,
                    const float* __restrict__ gnrm, int h, int w, Band band,
                    const ParamBlock* __restrict__ pb,
                    float* __restrict__ out) {
  svgf_block<true>(accum, motion, gpos, gnrm, h, w, band, pb, out);
}

// The tail alone, SVGF off: filtered == raw.  A thread takes kTonePixels
// neighbouring pixels: 16-byte loads, and where all are inside the image
// three 16-byte stores.
__global__ void __launch_bounds__(kToneThreads)
tonemap_kernel(const float* __restrict__ accum, int64_t n,
               const ParamBlock* __restrict__ pb, float* __restrict__ out) {
  const int64_t i0 =
      ((int64_t)blockIdx.x * kToneThreads + threadIdx.x) * kTonePixels;
  if (i0 >= n) return;
  const Tone tone = tone_of(pb);
  float v[3 * kTonePixels];
#pragma unroll
  for (int k = 0; k < kTonePixels; ++k) {
    // a pixel past the end repeats the last one and is not stored
    const int64_t i = i0 + k < n ? i0 + k : n - 1;
    const float4 col = __ldg(reinterpret_cast<const float4*>(accum) + i);
    v[3 * k] = tone_channel(col.x, col.x, tone);
    v[3 * k + 1] = tone_channel(col.y, col.y, tone);
    v[3 * k + 2] = tone_channel(col.z, col.z, tone);
  }
  if (i0 + kTonePixels <= n) {
    float4* o = reinterpret_cast<float4*>(out + 3 * i0);
#pragma unroll
    for (int k = 0; k < 3 * kTonePixels / 4; ++k)
      o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < 3 * kTonePixels; ++k)
      if (i0 + k / 3 < n) out[3 * i0 + k] = v[k];
  }
}

template <typename Kernel, typename... Args>
int launch_svgf(Kernel kernel, int h, int w, void* stream, Args... args) {
  if (h > 0 && w > 0) {
    // a block may ask for more than 48 KB only after this
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSharedBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
    kernel<<<grid, dim3(kThreadsX, kBY), kSharedBytes, (cudaStream_t)stream>>>(
        args...);
  }
  return (int)cudaGetLastError();
}

// Output row 0 of a band's planes, which start `halo` rows above it.
template <int kChannels>
const float* band_rows(const void* plane, int halo, int w) {
  return (const float*)plane + (int64_t)halo * w * kChannels;
}

}  // namespace

// Plain C entry points for ctypes.  accum [h + 2*halo, w, 4] (16-byte
// aligned), motion [h + 2*halo, w, 2], gpos and gnrm [h + 2*halo, w, 3],
// out [h, w, 3] (16-byte aligned for ort_tonemap, whose accum is
// [h, w, 4]): contiguous float32 device arrays.  The filter entries
// compute the h rows of a band that starts at row `row0` of an image
// `full_h` rows high, with `halo` rows of neighbour data above and below
// it in the planes; the whole image is halo 0, row0 0, full_h h.  `prm`
// is the parameter block on the device: the five svgf_* parameters, the
// blend strength (already clamped to [0, 1]) and the exposure.  Each
// returns cudaGetLastError() as an int.

// out = the filtered rgb.
extern "C" int ort_svgf(const void* accum, const void* motion,
                        const void* gpos, const void* gnrm, int h, int w,
                        int halo, int row0, int full_h, const void* prm,
                        void* out, void* stream) {
  return launch_svgf(svgf_kernel, h, w, stream, band_rows<4>(accum, halo, w),
                     band_rows<2>(motion, halo, w),
                     band_rows<3>(gpos, halo, w), band_rows<3>(gnrm, halo, w),
                     h, w, Band{halo, row0, full_h},
                     (const ParamBlock*)prm, (float*)out);
}

// out = sRGB of the filtered image blended with accum's rgb.
extern "C" int ort_svgf_present(const void* accum, const void* motion,
                                const void* gpos, const void* gnrm, int h,
                                int w, int halo, int row0, int full_h,
                                const void* prm, void* out, void* stream) {
  return launch_svgf(svgf_present_kernel, h, w, stream,
                     band_rows<4>(accum, halo, w),
                     band_rows<2>(motion, halo, w),
                     band_rows<3>(gpos, halo, w), band_rows<3>(gnrm, halo, w),
                     h, w, Band{halo, row0, full_h},
                     (const ParamBlock*)prm, (float*)out);
}

// out = sRGB of accum's rgb.
extern "C" int ort_tonemap(const void* accum, int h, int w, const void* prm,
                           void* out, void* stream) {
  const int64_t n = (int64_t)h * w;
  if (n > 0) {
    const int64_t per_block = (int64_t)kToneThreads * kTonePixels;
    tonemap_kernel<<<(unsigned)((n + per_block - 1) / per_block),
                     kToneThreads, 0, (cudaStream_t)stream>>>(
        (const float*)accum, n, (const ParamBlock*)prm, (float*)out);
  }
  return (int)cudaGetLastError();
}
