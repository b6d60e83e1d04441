// SVGF-lite 7x7 variance-guided filter for Hopper (sm_90a).
//
// svgf_kernel replaces the TPU kernel K4,
//   opengl_raytracing_tpu/ops/svgf_pallas.py  _kernel
//   (launched by svgf_filter_pallas),
// and computes what the plain PyTorch version
// opengl_raytracing_tpu_torch/ops/svgf.py:svgf_filter computes
// (reference: shaders/rt/rt_present.frag:126-225): for each pixel, a
// weighted mean of its 7x7 neighbourhood, each tap weighted by
// exp(-(colour distance * k + position distance * 0.02 + normal distance
// * 2)) times a variance boost; taps outside the image weigh 0, and a pixel
// whose weights sum to 0 keeps its own colour.
//
// Design: one thread per output pixel, a 32x8 block of pixels.  The block
// first stages its (8+6)x(32+6) halo tile of colour, position and normal
// in shared memory (zeros outside the image), normalising each normal once
// as it is loaded, then every thread runs its 49 taps out of shared memory.
// None of the TPU kernel's schedule carries over: its 8-row VMEM bands,
// 128-lane padding, 12-plane stack and DMA semaphores were for the TPU.
//
// Rounding: the plain version's expressions in its order (dot products
// x, y, z; the taps dy outer, dx inner; `normalize` as
// x / max(sqrt(max(d, 0)), 1e-12)), IEEE expf, division and sqrtf, and
// --fmad=false, so no product is contracted into an FMA.
//
// What bounds it on this card: 49 taps of ~25 FLOPs and one expf each per
// pixel, out of shared memory; device memory sees the four HWC inputs
// (48 bytes a pixel, each read about 1.6 times through the halo) and the
// 12-byte output.  At 1920x1080 that is ~2.6 GFLOP and ~0.2 GB.
// Left for later: TMA loads of the halo tile, several pixels per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kBX = 32, kBY = 8;                   // output pixels per block
constexpr int kTX = kBX + 2 * kRadius;             // halo tile width
constexpr int kTY = kBY + 2 * kRadius;             // halo tile height
constexpr float kKPos = 0.02f, kKNrm = 2.0f;       // rt_present.frag:160-161
constexpr float kY0 = 0.299f, kY1 = 0.587f, kY2 = 0.114f;

struct Params {
  float var_max, k_var, k_color, k_var_m, k_color_m;
};

__global__ void __launch_bounds__(kBX * kBY)
svgf_kernel(const float* __restrict__ accum, const float* __restrict__ motion,
            const float* __restrict__ gpos, const float* __restrict__ gnrm,
            int h, int w, Params prm, float* __restrict__ out) {
  // plane k of the tile: 0-2 colour, 3-5 position, 6-8 unit normal
  __shared__ float tile[9][kTY][kTX];
  const int x0 = blockIdx.x * kBX - kRadius, y0 = blockIdx.y * kBY - kRadius;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int k = tid; k < kTX * kTY; k += kBX * kBY) {
    const int ty = k / kTX, tx = k % kTX;
    const int gx = x0 + tx, gy = y0 + ty;
    float v[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (gx >= 0 && gx < w && gy >= 0 && gy < h) {
      const int64_t i = (int64_t)gy * w + gx;
      const float4 c = __ldg(reinterpret_cast<const float4*>(accum) + i);
      v[0] = c.x;
      v[1] = c.y;
      v[2] = c.z;
      v[3] = __ldg(gpos + 3 * i);
      v[4] = __ldg(gpos + 3 * i + 1);
      v[5] = __ldg(gpos + 3 * i + 2);
      const float nx = __ldg(gnrm + 3 * i), ny = __ldg(gnrm + 3 * i + 1),
                  nz = __ldg(gnrm + 3 * i + 2);
      float d = nx * nx + ny * ny + nz * nz;
      d = d < 0.0f ? 0.0f : d;
      float len = sqrtf(d);
      len = len < 1e-12f ? 1e-12f : len;
      v[6] = nx / len;
      v[7] = ny / len;
      v[8] = nz / len;
    }
    for (int p = 0; p < 9; ++p) tile[p][ty][tx] = v[p];
  }
  __syncthreads();

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int cx = threadIdx.x + kRadius, cy = threadIdx.y + kRadius;
  const int64_t i = (int64_t)y * w + x;

  const float cr = tile[0][cy][cx], cg = tile[1][cy][cx], cb = tile[2][cy][cx];
  const float m2 = __ldg(accum + 4 * i + 3);
  const float l = cr * kY0 + cg * kY1 + cb * kY2;
  float var_c = m2 - l * l;
  var_c = var_c < 0.0f ? 0.0f : (var_c > prm.var_max ? prm.var_max : var_c);
  const float mx = __ldg(motion + 2 * i), my = __ldg(motion + 2 * i + 1);
  const float mot = sqrtf(mx * mx + my * my);
  float t = (mot - 0.005f) / (float)(0.05 - 0.005);  // smoothstep(.005, .05)
  t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
  t = t * t * (3.0f - 2.0f * t);
  const float k_var = prm.k_var + (prm.k_var_m - prm.k_var) * t;
  const float k_color = prm.k_color + (prm.k_color_m - prm.k_color) * t;
  const float var_boost = 1.0f + var_c * (1.0f + k_var * 0.5f);
  const float w_off = var_boost * (1.0f + var_c * 4.0f);
  const float k_col = k_color * 0.3f + 0.05f;
  const float px = tile[3][cy][cx], py = tile[4][cy][cx], pz = tile[5][cy][cx];
  const float nx = tile[6][cy][cx], ny = tile[7][cy][cx], nz = tile[8][cy][cx];

  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aw = 0.0f;
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
    const int ty = cy + dy;
    const bool row_ok = y + dy >= 0 && y + dy < h;
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      if (!row_ok || x + dx < 0 || x + dx >= w) continue;  // weight 0
      const int tx = cx + dx;
      const float r = tile[0][ty][tx], g = tile[1][ty][tx],
                  b = tile[2][ty][tx];
      const float dr = r - cr, dg = g - cg, db = b - cb;
      const float dc2 = dr * dr + dg * dg + db * db;
      const float qx = tile[3][ty][tx] - px, qy = tile[4][ty][tx] - py,
                  qz = tile[5][ty][tx] - pz;
      const float dist2 = qx * qx + qy * qy + qz * qz;
      float nd = nx * tile[6][ty][tx] + ny * tile[7][ty][tx] +
                 nz * tile[8][ty][tx];
      nd = nd < -1.0f ? -1.0f : (nd > 1.0f ? 1.0f : nd);
      float ndist = 1.0f - nd;
      ndist = ndist < 0.0f ? 0.0f : ndist;
      const float expo = dc2 * k_col + dist2 * kKPos + ndist * kKNrm;
      const float wgt = (dx == 0 && dy == 0 ? var_boost : w_off) * expf(-expo);
      ar = ar + r * wgt;
      ag = ag + g * wgt;
      ab = ab + b * wgt;
      aw = aw + wgt;
    }
  }
  float* o = out + 3 * i;
  if (aw <= 0.0f) {
    o[0] = cr;
    o[1] = cg;
    o[2] = cb;
  } else {
    const float den = aw < 1e-20f ? 1e-20f : aw;
    o[0] = ar / den;
    o[1] = ag / den;
    o[2] = ab / den;
  }
}

}  // namespace

// Plain C entry point for ctypes.  accum [h,w,4] (16-byte aligned), motion
// [h,w,2], gpos and gnrm [h,w,3], out [h,w,3]: contiguous float32 device
// arrays.  The five svgf_* parameters come by value.  Returns
// cudaGetLastError() as an int.
extern "C" int ort_svgf(const void* accum, const void* motion,
                        const void* gpos, const void* gnrm, int h, int w,
                        float var_max, float k_var, float k_color,
                        float k_var_m, float k_color_m, void* out,
                        void* stream) {
  if (h > 0 && w > 0) {
    const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
    const dim3 block(kBX, kBY);
    svgf_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)accum, (const float*)motion, (const float*)gpos,
        (const float*)gnrm, h, w,
        Params{var_max, k_var, k_color, k_var_m, k_color_m}, (float*)out);
  }
  return (int)cudaGetLastError();
}
