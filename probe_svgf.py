#!/usr/bin/env python3
"""The present-pass kernels of csrc/svgf.cu alone, on one NVIDIA card.

    python3 probe_svgf.py            # the build as committed, then the
                                     # same source with contraction allowed
    python3 probe_svgf.py --sweep    # and variants of the source
    python3 probe_svgf.py --sass     # and the committed build's machine
                                     # code beside the library, as
                                     # _build/svgf.sass

A probe for work on csrc/svgf.cu, not part of the smoke run.  On the
present pass's arguments in the third frame of a 1080p `full` chain it
builds the source once per variant and prints one JSON line each: ptxas'
registers and spills per kernel and the filter kernels' dynamic shared
bytes; the filter entry's largest difference from the plain filter and the
fused entry's and the tonemap kernel's from the plain present pass; each
kernel's device time alone (profiler, the mean of 20 launches); and the
SM clock and power draw nvidia-smi reads while 2,000 launches of the
filter entry are in flight.  The first and the last line time the
committed build, so a drift of the card within the run shows.  Exits
non-zero without a card.

The committed source has no tunables.  A variant is a copy of it under
_build/ with text replaced (`variant_source`): `--fmad=true` in place of
`--fmad=false`; other pixel runs, output tiles and blocks an SM (`SWEEP`);
and `flat`, which stages an interior block's `gpos` and `gnrm` tile rows
as flat 16-byte `cp.async` runs into shared memory and packs the planes
from there in a second pass (`FLAT_LOAD`), in place of each thread
gathering whole tile pixels with 4-byte loads 12 bytes apart.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import chip_smoke as smoke

RUN, BX, BY, BLOCKS = 2, 32, 16, 4   # the committed source's numbers
SWEEP = (
    dict(flat=True),
    dict(flat=True, blocks=3),
    dict(run=4, by=32, blocks=2),
    dict(run=4, by=32, blocks=3),
    dict(run=1, by=8, blocks=4),
    dict(run=2, by=32, blocks=2),
    dict(run=2, by=8, blocks=8),
    dict(run=2, by=16, blocks=3),
    dict(run=2, bx=64, by=8, blocks=4),
    dict(run=2, bx=64, by=16, blocks=2),
)

# The `flat` variant's interior tile load.  A tile row of gpos or gnrm is
# 3 * kTX contiguous floats; rounded out to 16-byte chunks it is at most
# kRawRow floats, which cp.async copies to shared memory as they lie.
# The colour comes as one 16-byte load a tile pixel, as in the committed
# source, issued while the copies are in flight.
FLAT_CONSTANTS = """constexpr int kRawRow = (3 * kTX + 6 + 3) / 4 * 4;
constexpr int kChunks = kRawRow / 4;
"""
FLAT_LOAD = """
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool wide) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void load_tile_flat(
    float4* __restrict__ a, float4* __restrict__ b, float* __restrict__ c,
    const float* __restrict__ accum, const float* __restrict__ gpos,
    const float* __restrict__ gnrm, int h, int w, int /*halo*/, int x0,
    int y0, int tid) {
  float* raw[2] = {c + kTile, c + kTile + kTY * kRawRow};
  const int64_t total = (int64_t)3 * h * w;
  for (int k = tid; k < 2 * kTY * kChunks; k += kThreads) {
    const int plane = k / (kTY * kChunks), r = k % (kTY * kChunks);
    const int ty = r / kChunks, ch = r - ty * kChunks;
    const int64_t s = 3 * ((int64_t)(y0 + ty) * w + x0);
    const int64_t g = (s & ~(int64_t)3) + 4 * ch;
    const float* src = (plane ? gnrm : gpos) + g;
    float* dst = raw[plane] + ty * kRawRow + 4 * ch;
    if (g + 4 <= total) {
      cp_async(dst, src, true);
    } else {  // the image's last floats
      for (int e = 0; e < 4; ++e)
        if (g + e < total) cp_async(dst + e, src + e, false);
    }
  }
  float4 col[kLoads];
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int k = tid + n * kThreads;
    const int ty = k / kTX, tx = k - ty * kTX;
    if (k < kTX * kTY)
      col[n] = __ldg(reinterpret_cast<const float4*>(accum) +
                     (int64_t)(y0 + ty) * w + x0 + tx);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kLoads; ++n) {
    const int k = tid + n * kThreads;
    if (k >= kTX * kTY) break;
    const int ty = k / kTX, tx = k - ty * kTX;
    const int64_t s = 3 * ((int64_t)(y0 + ty) * w + x0);
    const int at = ty * kRawRow + (int)(s & 3) + 3 * tx;
    const float* p = raw[0] + at;
    const float nx = raw[1][at], ny = raw[1][at + 1], nz = raw[1][at + 2];
    float d = nx * nx + ny * ny + nz * nz;
    d = d < 0.0f ? 0.0f : d;
    float len = sqrtf(d);
    len = len < 1e-12f ? 1e-12f : len;
    const int t = tile_at(ty, tx);
    a[t] = make_float4(col[n].x, col[n].y, col[n].z, p[0]);
    b[t] = make_float4(p[1], p[2], nx / len, ny / len);
    c[t] = nz / len;
  }
}
"""


def run_stride(run, bx):
    """The least run stride that holds a tile row and puts the thread rows
    of a warp on disjoint banks (the source's static_assert)."""
    threads_x, tx = bx // run, bx + 6
    stride = (tx + run - 1) // run
    while threads_x < 32 and (stride * run) % 32 != threads_x:
        stride += 1
    return stride


def variant_source(variant):
    """Path of the source to build for `variant`: the committed one for
    {}, else a copy under _build/ with the variant's text replaced."""
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    committed = os.path.join(cuda_lib._CSRC, "svgf.cu")
    if not variant:
        return committed
    with open(committed) as fh:
        src = fh.read()

    def replace(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"svgf.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    run, bx, by, blocks = (variant.get(k, d) for k, d in (
        ("run", RUN), ("bx", BX), ("by", BY), ("blocks", BLOCKS)))
    replace(f"constexpr int kRun = {RUN};", f"constexpr int kRun = {run};")
    replace(f"constexpr int kBX = {BX}, kBY = {BY};",
            f"constexpr int kBX = {bx}, kBY = {by};")
    replace(f"constexpr int kBlocks = {BLOCKS};",
            f"constexpr int kBlocks = {blocks};")
    replace(f"constexpr int kStride = {run_stride(RUN, BX)};",
            f"constexpr int kStride = {run_stride(run, bx)};")
    if variant.get("flat"):
        shared = "constexpr size_t kSharedBytes ="
        replace(shared, FLAT_CONSTANTS + shared
                + " (size_t)2 * kTY * kRawRow * sizeof(float) +")
        mark = "// What a pixel's 49 weights share"
        replace(mark, FLAT_LOAD + "\n" + mark)
        replace("load_tile<true>(", "load_tile_flat(")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_lib.BUILD_DIR, "svgf_variant.cu")
    with open(path, "w") as fh:
        fh.write(src)
    return path


def build(base_flags, variant, fmad):
    """Build and load the svgf library of `variant` with `base_flags` and
    contraction on or off; returns ptxas' lines for each kernel."""
    from opengl_raytracing_tpu_torch.ops import cuda_lib, svgf_cuda
    flags = tuple(f for f in base_flags if not f.startswith("--fmad"))
    cuda_lib.NVCC_FLAGS = flags + (f"--fmad={'true' if fmad else 'false'}",)
    cuda_lib.SOURCES["svgf"] = variant_source(variant)
    cuda_lib._libs.pop("svgf", None)
    cuda_lib.library("svgf", svgf_cuda._SIGNATURES)
    with open(cuda_lib.library_path("svgf")[:-3] + ".log") as fh:
        lines = [ln.strip() for ln in fh]
    ptxas, name = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = next((k for k in ("svgf_present_kernel", "svgf_kernel",
                                     "tonemap_kernel") if k in ln), None)
        elif name and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(name, []).append(ln.replace("ptxas info    : ",
                                                         ""))
    return ptxas


def shared_bytes(variant):
    """The filter kernels' dynamic shared memory, by the source's own
    arithmetic (kSharedBytes) on the variant's numbers."""
    run, bx, by = (variant.get(k, d) for k, d in (("run", RUN), ("bx", BX),
                                                  ("by", BY)))
    n = run_stride(run, bx) * run * (by + 6) * 36
    if variant.get("flat"):
        n += 2 * (by + 6) * ((3 * (bx + 6) + 6 + 3) // 4 * 4) * 4
    return n


def dump_sass():
    """cuobjdump's disassembly of the loaded build, for counting what the
    hot loop issues."""
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    with open(os.path.join(cuda_lib.BUILD_DIR, "svgf.sass"), "w") as fh:
        subprocess.run([tool, "-sass", cuda_lib.library_path("svgf")],
                       stdout=fh, check=True, timeout=300)


def measure(args, want_filter, want_present, want_tone):
    import torch
    from opengl_raytracing_tpu_torch.ops import svgf_cuda
    tone_args = dict(accum=args["accum"], params=args["params"])
    calls = {"svgf_kernel": lambda: svgf_cuda.svgf_filter(**args),
             "svgf_present_kernel": lambda: svgf_cuda.svgf_present(**args),
             "tonemap_kernel": lambda: svgf_cuda.tonemap(**tone_args)}
    want = {"svgf_kernel": want_filter, "svgf_present_kernel": want_present,
            "tonemap_kernel": want_tone}
    out = {}
    for name, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        out[name] = dict(
            max_abs_err=float((got - want[name]).abs().max()),
            bitwise=bool(torch.equal(got, want[name])),
            finite=bool(torch.isfinite(got).all()),
            kernel_ms=smoke.kernel_ms(fn, name, reps=20))
    for _ in range(2000):  # ~0.4 s of queued work for nvidia-smi to see
        calls["svgf_kernel"]()
    out["under_load"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_svgf: needs an NVIDIA card", file=sys.stderr)
        return 1
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    from opengl_raytracing_tpu_torch.ops.svgf import (present_plain,
                                                      svgf_filter)
    base_flags = cuda_lib.NVCC_FLAGS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _, bvh = smoke.scene("cuda")
    args = smoke.record_kernel_inputs(bvh, smoke.HEIGHT, smoke.WIDTH, "cuda",
                                      ("svgf_present",), "full",
                                      smoke.PROFILE_FRAME)["svgf_present"][0]
    want_filter = svgf_filter(**args)
    want_present = present_plain(**args)
    want_tone = present_plain(**dict(
        args, params=args["params"].replace(enable_svgf=0)))
    variants = [(dict(), False), (dict(), True)]
    if "--sweep" in sys.argv[1:]:
        variants += [(v, False) for v in SWEEP]
    variants.append((dict(), False))
    for variant, fmad in variants:
        try:
            ptxas = build(base_flags, variant, fmad)
        except RuntimeError as e:  # a variant nvcc refuses: say so, go on
            print(json.dumps(dict(variant=variant, fmad=fmad,
                                  build_error=str(e)[-2000:])), flush=True)
            continue
        if "--sass" in sys.argv[1:] and not variant and not fmad:
            dump_sass()
        print(json.dumps(dict(
            card=smi, variant=variant, fmad=fmad, ptxas=ptxas,
            dynamic_shared_bytes=shared_bytes(variant),
            **measure(args, want_filter, want_present, want_tone))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
