#!/usr/bin/env python3
"""Where the analytic direct-light kernel's time goes, on one NVIDIA card.

    python3 probe_an_direct.py [--variants NAME,NAME,...] [--rounds N]

A probe for work on `an_direct_light_kernel` (K3, csrc/an_direct.cu), not
part of the smoke run.  It records the K3 calls of a 1080p an_full frame
(the `full` preset with the day-sky cubemap: the primary call and its six
masked secondaries) and of an 800x600 an_baseline frame (five calls), as
chip_smoke.py's kernels phase does, and builds a copy of the source and
its headers for each variant in VARIANTS (probe_variants.py: one nvcc
each, all started together, under _build/probe_an_direct/).  Each variant
drops or swaps one part of the diffuse path:

  no_hash    rand01 a cheap function of its coordinates: the hash chain's
             conversions, hash2 and scale gone;
  no_sincos  the disk offsets' sincosf gone;
  no_traces  every shadow trace reads "no hit": the closest-t traces over
             the floor and the spheres gone;
  no_powf    each Lambert-Phong term's powf a product;
  fmodf      rem1 by fmodf and its sign fix, as before the cut;
  no_sqrt_gate  the sphere test's sqrtf on every lane, as before the cut;
  sincosf    one sincosf for the disk offset's cosf and sinf;
  unit       kDrainAt 1: each unit's live lanes shaded on their own, in
             a round of each path, no queue carried from unit to unit;
  grid       a block a 4 units, no persistent loop (the card's block
             scheduler hands out the units);
  blocks9    the kernel held to nine blocks an SM (56 registers);
  pow_gate   powf only where its term is kept (ndl > 0, spec > 0);
  floor_gate the floor test divides only where t can come out positive;
  stage_prm  the parameter block copied to shared memory once a block;
  A+B        the patches of A and of B together.

The drop variants' radiance is wrong (a time without the part, for the
split); the others are the former forms of the cuts or candidate cuts
that leave every bit as it is, and must give the kernel's bits on every
call's live lanes.  Every library then runs on
each call, in turns (base, variants, variants reversed, base, `--rounds`
times, default 3), timed with CUDA events over REPS launches; the primary
call also with every lane live (`primary_dense`: the parent's whole call,
its mirror and glass lanes included).  One JSON line a variant (its
median ms a call, its ptxas registers and spill, its bits), then the
split of the primary call: base minus each drop variant.  Exits non-zero
without a card or where an exact variant's bits differ.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys

import chip_smoke as cs
import probe_variants as pv

REPS = 20
F, H = "an_direct.cu", "an_scene.cuh"  # K3's source; its scene's traces
# name -> [(file, a text of it, its replacement)] (probe_variants.py)
VARIANTS = {
    "no_hash": [(F, '#include "sampling.cuh"\n',
                 '#include "sampling.cuh"\n#define rand01(x, y, kx, ky) '
                 '((x) * 1e-3f + (y) * 1e-4f)\n')],
    "no_sincos": [(F, "  *dx = r * cosf(phi);\n  *dy = r * sinf(phi);\n",
                   "  *dx = r * phi;\n  *dy = r - phi;\n")],
    "no_traces": [(H, "                                         bool marker) "
                   "{\n",
                   "                                         bool marker) "
                   "{\n  if (s.eps > -1.0f) return kInf;\n")],
    "no_powf": [(F, "  const float phong = powf(ndh, gloss);\n",
                 "  const float phong = ndh * gloss;\n")],
    "fmodf": [(F, "__device__ __forceinline__ float rem1(float x) "
               "{ return x - truncf(x); }\n",
               "__device__ __forceinline__ float rem1(float x) {\n"
               "  const float m = fmodf(x, 1.0f);\n"
               "  return (m != 0.0f && m < 0.0f) ? m + 1.0f : m;\n}\n")],
    "sincosf": [(F, "  *dx = r * cosf(phi);\n  *dy = r * sinf(phi);\n",
                 "  float sn, cs;\n  sincosf(phi, &sn, &cs);\n"
                 "  *dx = r * cs;\n  *dy = r * sn;\n")],
    "no_sqrt_gate": [(H, "  if (!(disc >= 0.0f)) return false;\n", "")],
    "unit": [(F, "constexpr int kDrainAt = 32;",
              "constexpr int kDrainAt = 1;")],
    "pow_gate": [(F, "  const float phong = powf(ndh, gloss);\n"
                  "  const float spec = spec_strength > 0.0f ? "
                  "spec_strength * phong : 0.0f;\n"
                  "  if (!(ndl > 0.0f)) return {0.0f, 0.0f, 0.0f};\n",
                  "  if (!(ndl > 0.0f)) return {0.0f, 0.0f, 0.0f};\n"
                  "  const float spec = spec_strength > 0.0f ? "
                  "spec_strength * powf(ndh, gloss) : 0.0f;\n")],
    "floor_gate": [(H, "  const float tf = -(dot3(o, fn) + s.floor_d) / "
                    "safe;\n"
                    "  AnHit h = {kInf, kAnMiss};\n"
                    "  if (fabsf(denom) >= 1e-6f && tf >= eps && tf < h.t) "
                    "h = {tf, kAnFloor};\n",
                    "  const float num = -(dot3(o, fn) + s.floor_d);\n"
                    "  AnHit h = {kInf, kAnMiss};\n"
                    "  if (fabsf(denom) >= 1e-6f && num != 0.0f && "
                    "(num > 0.0f) == (safe > 0.0f)) {\n"
                    "    const float tf = num / safe;\n"
                    "    if (tf >= eps && tf < h.t) h = {tf, kAnFloor};\n"
                    "  }\n")],
    "grid": [(F, "  return launch_persistent(an_direct_light_kernel, "
              "kThreads,\n"
              "                           make_units(n_lanes, 32), "
              "(cudaStream_t)stream,\n",
              "  const Units u = make_units(n_lanes, 32);\n"
              "  if (u.n_units > 0)\n"
              "    an_direct_light_kernel<<<(unsigned)((u.n_units + kWarps "
              "- 1)"
              " / kWarps),\n"
              "                             kThreads, 0, "
              "(cudaStream_t)stream>>>"
              "(u,\n"),
             (F, "                           *scene, *rows, n_lanes, "
              "(float*)out,\n"
              "                           (float*)offs);\n",
              "        *scene, *rows, n_lanes, (float*)out, (float*)offs);\n"
              "  return (int)cudaGetLastError();\n")],
    "blocks9": [(F, "__launch_bounds__(kThreads)\nan_direct_light_kernel(",
                 "__launch_bounds__(kThreads, 9)\nan_direct_light_kernel(")],
    "stage_prm": [(F, "an_direct_light_kernel(const Units u, const AnScene s, "
                   "const AnRows r,",
                   "an_direct_light_kernel(const Units u, const AnScene s0, "
                   "const AnRows r,"),
                  (F, "  __shared__ int64_t queue[kWarps][2][kQueueCap];\n",
                   "  __shared__ int64_t queue[kWarps][2][kQueueCap];\n"
                   "  __shared__ ParamBlock prm;\n"
                   "  for (int k = threadIdx.x; k < (int)(sizeof(ParamBlock)"
                   " / 4); k += blockDim.x)\n"
                   "    ((float*)&prm)[k] = __ldg((const float*)s0.prm + k);\n"
                   "  __syncthreads();\n"
                   "  AnScene s = s0;\n"
                   "  s.prm = &prm;\n")],
}
EXACT = ("fmodf", "sincosf", "no_sqrt_gate", "unit", "pow_gate",
         "floor_gate", "grid", "blocks9", "stage_prm")
DROPS = ("no_hash", "no_sincos", "no_traces", "no_powf")


def calls_of(env):
    """[(name, the call's wrapper arguments)] of the K3 calls of a 1080p
    an_full and an 800x600 an_baseline frame, and the primary an_full
    call with every lane live."""
    out = []
    for label, preset_name, table, height, width in (
            ("an_full", "full", env, cs.HEIGHT, cs.WIDTH),
            ("an_baseline", "baseline", None, cs.AN_HEIGHT, cs.AN_WIDTH)):
        calls = cs.record_kernel_inputs(None, height, width, "cuda",
                                        ("an_direct",), preset_name,
                                        env=table)["an_direct"]
        labels = cs.an_call_labels(calls[0]["scene"].params)
        out += [(f"{label}_{name}", args) for name, args in zip(labels,
                                                                calls)]
    out.insert(1, ("an_full_primary_dense", dict(out[0][1], active=None)))
    return out


def launcher(args):
    """(fn(lib) launching the call through `lib`'s C entry into one output
    buffer, that buffer, its live lanes)."""
    import torch
    from opengl_raytracing_tpu_torch.ops import an_cuda
    h = args["h"]
    device = h.t.device
    scene_args, rows, keep = an_cuda.direct_rows(
        args["scene"], h, args["rng_frame"], args["frame_index"],
        args["vdir"], args["px"], args["py"], args["active"], device)
    n_lanes = h.t.numel()
    out = torch.full((n_lanes, 3), float("nan"), device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def fn(lib):
        _ = keep
        err = lib.ort_an_direct(ctypes.byref(scene_args), ctypes.byref(rows),
                                n_lanes, out.data_ptr(), None, stream)
        if err != 0:
            raise RuntimeError(f"ort_an_direct failed: cudaError {err}")
    return fn, out, cs.an_call_live(args).reshape(-1)


def events_ms(fn, reps=REPS):
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_an_direct: no CUDA card", file=sys.stderr)
        return 1
    from opengl_raytracing_tpu_torch.ops import an_cuda
    names, rounds = pv.options(VARIANTS, 3)
    smi = pv.card()
    print(smi, flush=True)
    libs = pv.build("probe_an_direct", "an_direct.cu",
                    {"ort_an_direct": an_cuda._SIGNATURES["ort_an_direct"]},
                    {"an_direct": "an_direct_light_kernel"}, VARIANTS, names)
    calls = calls_of(cs.sky_day("cuda"))
    runs = [(call, *launcher(args)) for call, args in calls]
    order = pv.turn_order(names)
    times = {name: {call: [] for call, *_ in runs} for name in libs}
    bits = {name: {} for name in libs}
    for _ in range(rounds):
        for name in order:
            lib = libs[name][0]
            for call, fn, out, live in runs:
                times[name][call].append(events_ms(lambda: fn(lib)))
                if call not in bits[name]:
                    bits[name][call] = out[live].clone()
    base_bits = bits["base"]
    failed = False
    result = {}
    for name in libs:
        same = {call: bool(torch.equal(
            bits[name][call].view(torch.int32),
            base_bits[call].view(torch.int32))) for call in base_bits}
        med = {call: statistics.median(v) for call, v in times[name].items()}
        result[name] = med
        line = dict(variant=name, ms=med, ptxas=libs[name][1])
        if name == "base" or all(p in EXACT for p in name.split("+")):
            line["bitwise_on_live_lanes"] = all(same.values())
            failed |= not all(same.values())
        print(json.dumps(line), flush=True)
    split = {name: result["base"]["an_full_primary"]
             - result[name]["an_full_primary"]
             for name in DROPS if name in result}
    split_dense = {name: result["base"]["an_full_primary_dense"]
                   - result[name]["an_full_primary_dense"]
                   for name in DROPS if name in result}
    print(json.dumps({"card": smi, "primary_ms": result["base"][
        "an_full_primary"], "split_ms": split,
        "primary_dense_ms": result["base"]["an_full_primary_dense"],
        "split_dense_ms": split_dense,
        "live_lanes": {call: int(live.sum()) for call, _, _, live in runs}}),
        flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
