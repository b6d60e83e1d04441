#!/usr/bin/env python3
"""Where the analytic AO and GI-bounce kernels' time goes, on one NVIDIA card.

    python3 probe_an_gates.py [--variants NAME,A+B,...] [--rounds N]

A probe for work on `an_ao_kernel` and `an_bounce_kernel`
(csrc/an_trace.cu), not part of the smoke run.  It records the AO call and
the two bounce calls (the primary hits' and the mirror's) of a 1080p
an_full frame (the `full` preset with the day-sky cubemap, the third of a
chain), as chip_smoke.py's phase an_gates does, and builds a copy of
csrc/an_trace.cu and its headers for each variant in VARIANTS
(probe_variants.py: one nvcc each, all started together, under
_build/probe_an_gates/).  A variant drops or swaps one part:

  no_trace   the AO rays' any-hit tests and the bounce ray's trace read
             "no hit";
  no_hash    rand01 a cheap function of its coordinates;
  no_sincos  the hemisphere sample's cosf and sinf gone;
  no_basis   the bounce's normalize and basis a fixed swizzle (AO builds
             its basis once a lane: the variant leaves it);
  no_norm    the hemisphere direction's final normalize gone;
  no_store   the bounce's outputs written only where t is 12345;
  no_work    the per-lane sampling and traces gone, the rows still read
             and written (the bounce) or the AO value still written;
  scan_only  each live lane writes one output and nothing else: the
             mask scan and the queue;
  ahead16    live_rounds' scan with the mask bytes of 16 units loaded
             together before their ballots (lane s keeps unit s's), where
             it loads one unit's at a time;
  onb_full   build_onb's floor case off: every basis normalized;
  ao_blocks8, ao_blocks10, bounce_blocks12
             the kernel held to 8 or 10 (AO), 12 (bounce) blocks an SM by
             __launch_bounds__ (64, 48, 40 registers);
  no_cull    AO's culls off (every primitive tested on every sample);
  closest    AO's rays traced to their closest hit (trace_closest), no
             cull: the per-sample trace before the any-hit test.

The drop variants' outputs are wrong (a time without the part, for the
split); ahead16, onb_full, *_blocks*, no_cull and closest leave every
bit as it is and must give the base's bits on every call's live lanes.
Every library then runs on each call in turns (base, variants, variants
reversed, base, `--rounds` times, default 2), timed by the profiler
(chip_smoke.kernel_ms, the device time of one launch).  One JSON line a
variant (its median ms a call, its ptxas registers and spill, its bits),
then the split: base minus each drop variant, a call.  Exits non-zero
without a card or where an exact variant's bits differ.
"""

from __future__ import annotations

import json
import statistics
import sys

import chip_smoke as cs
import probe_variants as pv

# name -> [(file, a text of it, its replacement)] (probe_variants.py)
_BOUNCE_WORK = "    const uint32_t smp = sample_of(a.grid, i);\n"
_AO_BODY = ("  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {\n"
            "    const V3 nn = norm3(in3(a.n, i, a.n_px));\n")
# live_rounds' scan, one unit at a time, and the same scan with the mask
# bytes of 16 units loaded before their ballots (ahead16)
_SCAN_ONE = """    for (; j < u.n_units && n_q < 32; j += u.stride()) {
      const int64_t i = u.base(j) + lane;
      const bool live =
          i < n &&
          (act == nullptr || __ldg(act + in_row(active.mode, i, n_px)));
      const unsigned b = __ballot_sync(0xffffffffu, live);
      if (live) q[n_q + __popc(b & below)] = i;
      n_q += __popc(b);
    }
"""
_SCAN_AHEAD = """    while (n_q < 32) {
      if (left == 0) {
        if (j >= u.n_units) break;
        uint8_t m[16];
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          const int64_t unit = j + s * u.stride();
          const int64_t i = u.base(unit) + lane;
          m[s] = unit < u.n_units && i < n
                     ? (act == nullptr
                            ? (uint8_t)1
                            : __ldg(act + in_row(active.mode, i, n_px)))
                     : (uint8_t)0;
        }
        left = 16;
        unsigned mine = 0;
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          const unsigned w = __ballot_sync(0xffffffffu, m[s] != 0);
          if (lane == s) mine = w;
        }
        bits = mine;
      }
      const unsigned w = __shfl_sync(0xffffffffu, bits, 16 - left);
      if ((w >> lane) & 1u) q[n_q + __popc(w & below)] = u.base(j) + lane;
      n_q += __popc(w);
      j += u.stride();
      --left;
    }
"""
VARIANTS = {
    "no_trace": [
        ("an_trace.cu",
         "        occ += ao_blocked(l, fn, d, eps, radius, culls);\n",
         "        occ += d.x > 2.0f;\n"),
        ("an_lanes.cuh",
         "  const AnHit h = trace_closest(s, o, d, glass, marker, eps);\n",
         "  const AnHit h = {d.x > 2.0f ? 0.0f : kInf, kAnMiss};\n")],
    "no_hash": [("an_trace.cu", '#include "sampling.cuh"\n',
                 '#include "sampling.cuh"\n#define rand01(x, y, kx, ky) '
                 '((x) * 1e-3f + (y) * 1e-4f)\n')],
    "no_sincos": [("sampling.cuh",
                   "  const float x = r * cosf(phi);\n"
                   "  const float z = r * sinf(phi);\n",
                   "  const float x = r * phi;\n"
                   "  const float z = r - phi;\n")],
    "no_basis": [("sampling.cuh",
                  "  const V3 nn = norm3(n);\n  V3 t, b;\n"
                  "  build_onb(nn, &t, &b);\n",
                  "  const V3 nn = n;\n  const V3 t = {n.y, n.z, n.x};\n"
                  "  const V3 b = {n.z, n.x, n.y};\n")],
    "no_norm": [("sampling.cuh",
                 "  return norm3(add3(add3(scale3(t, x), scale3(b, z)), "
                 "scale3(nn, y)));\n",
                 "  return add3(add3(scale3(t, x), scale3(b, z)), "
                 "scale3(nn, y));\n")],
    "no_store": [
        ("an_lanes.cuh",
         "  out[3 * i] = c.x;\n  out[3 * i + 1] = c.y;\n"
         "  out[3 * i + 2] = c.z;\n",
         "  if (c.x == 12345.0f) {\n  out[3 * i] = c.x;\n"
         "  out[3 * i + 1] = c.y;\n  out[3 * i + 2] = c.z;\n  }\n"),
        ("an_lanes.cuh", "  t_out[i] = h.t;\n",
         "  if (h.t == 12345.0f) t_out[i] = h.t;\n"),
        ("an_lanes.cuh", "  mat_out[i] = h.k == kAnMiss ? 0 : h.k;\n",
         "  if (h.t == 12345.0f) mat_out[i] = h.k == kAnMiss ? 0 : h.k;\n"),
        ("an_trace.cu", "    a.cos[i] = fmaxf(dot3(n0, wi), 0.0f);\n",
         "    if (wi.x == 12345.0f) a.cos[i] = fmaxf(dot3(n0, wi), 0.0f);\n")],
    "no_work": [
        ("an_trace.cu", "      for (int m = 0; m < a.samples; ++m) {\n",
         "      for (int m = 0; m < 0; ++m) {\n"),
        ("an_trace.cu", _BOUNCE_WORK,
         "    put3(a.wi, i, in3(a.n, i, a.n_px));\n"
         "    put3(a.p_out, i, in3(a.p, i, a.n_px));\n"
         "    put3(a.n_out, i, in3(a.n, i, a.n_px));\n"
         "    a.t[i] = 0.0f;\n    a.mat[i] = 0;\n    a.cos[i] = 0.0f;\n"
         "    if (a.n_lanes > 0) return;\n" + _BOUNCE_WORK)],
    "scan_only": [
        ("an_trace.cu", _AO_BODY, _AO_BODY.replace(
            "[&](int64_t i) {\n", "[&](int64_t i) {\n    a.out[i] = 1.0f;\n"
            "    if (a.n_lanes > 0) return;\n", 1)),
        ("an_trace.cu", _BOUNCE_WORK,
         "    a.cos[i] = 0.0f;\n    if (a.n_lanes > 0) return;\n"
         + _BOUNCE_WORK)],
    "ahead16": [("an_lanes.cuh",
                 "  int n_q = 0;  // the same on every lane of the warp\n"
                 "  int64_t j = u.first();\n",
                 "  int n_q = 0;  // the same on every lane of the warp\n"
                 "  int64_t j = u.first();\n  int left = 0;\n"
                 "  unsigned bits = 0;\n"),
                ("an_lanes.cuh", _SCAN_ONE, _SCAN_AHEAD)],
    "onb_full": [("sampling.cuh",
                  "  if (__float_as_uint(n.x) == 0u && n.y == 1.0f &&\n",
                  "  if (n.x != n.x &&\n")],
    "ao_blocks8": [("an_trace.cu", "__launch_bounds__(kLiveThreads)\n"
                    "an_ao_kernel(", "__launch_bounds__(kLiveThreads, 8)\n"
                    "an_ao_kernel(")],
    "ao_blocks10": [("an_trace.cu", "__launch_bounds__(kLiveThreads)\n"
                     "an_ao_kernel(", "__launch_bounds__(kLiveThreads, 10)"
                     "\nan_ao_kernel(")],
    "bounce_blocks12": [("an_trace.cu", "__launch_bounds__(kLiveThreads)\n"
                         "an_bounce_kernel(", "__launch_bounds__("
                         "kLiveThreads, 12)\nan_bounce_kernel(")],
    "no_cull": [("an_trace.cu", "  const bool culls = eps > 0.0f;\n",
                 "  const bool culls = eps > 0.0f && eps < 0.0f;\n")],
    "closest": [("an_trace.cu", "  const bool culls = eps > 0.0f;\n",
                 "  const bool culls = eps > 0.0f && eps < 0.0f;\n"),
                ("an_trace.cu",
                 "        occ += ao_blocked(l, fn, d, eps, radius, "
                 "culls);\n",
                 "        const float tc = trace_closest(s, o, d, true, "
                 "a.marker, s.eps).t;\n"
                 "        occ += tc < kInf && tc < radius;\n")],
}
EXACT = ("ahead16", "onb_full", "ao_blocks8", "ao_blocks10",
         "bounce_blocks12", "no_cull", "closest")
DROPS = ("no_trace", "no_hash", "no_sincos", "no_basis", "no_norm",
         "no_store", "no_work", "scan_only")
KERNELS = {"an_ao": "an_ao_kernel", "an_bounce": "an_bounce_kernel"}


def calls_of(env):
    """[(name, kernel key, the call's wrapper arguments)] of the AO call
    and the two bounce calls of a 1080p an_full frame."""
    calls = cs.record_kernel_inputs(None, cs.HEIGHT, cs.WIDTH, "cuda",
                                    ("an_ao", "an_bounce"), "full",
                                    cs.PROFILE_FRAME, env=env)
    return ([("an_full_ao", "an_ao", calls["an_ao"][0])]
            + [(f"an_full_bounce_{label}", "an_bounce", a) for label, a in
               zip(("primary", "mirror"), calls["an_bounce"])])


def outputs(key, a):
    """The call's outputs on its live lanes, one flat float32 tensor."""
    import torch
    out = cs.gate_call(key, a, a.get("active"))
    live = cs._live_of(cs.gate_shape(key, a), a.get("active"))
    return torch.cat([v[live].reshape(-1).float() if v.dtype.is_floating_point
                      else v[live].reshape(-1).view(torch.float32)
                      for _, v in sorted(out.items())])


def main() -> int:
    import torch
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    if not torch.cuda.is_available():
        print("probe_an_gates: no CUDA card", file=sys.stderr)
        return 1
    names, rounds = pv.options(VARIANTS, 2)
    smi = pv.card()
    print(smi, flush=True)
    libs = pv.build("probe_an_gates", "an_trace.cu",
                    an_trace_cuda._SIGNATURES, KERNELS, VARIANTS, names)
    calls = calls_of(cs.sky_day("cuda"))
    real = an_trace_cuda._library
    order = pv.turn_order(names)
    times = {name: {call: [] for call, *_ in calls} for name in libs}
    bits = {name: {} for name in libs}
    try:
        for _ in range(rounds):
            for name in order:
                an_trace_cuda._library = (lambda h=libs[name][0]: h)
                for call, key, a in calls:
                    times[name][call].append(cs.kernel_ms(
                        lambda: cs.gate_call(key, a, a.get("active")),
                        KERNELS[key]))
                    if call not in bits[name]:
                        bits[name][call] = outputs(key, a)
    finally:
        an_trace_cuda._library = real
    failed = False
    med = {}
    for name in libs:
        med[name] = {call: statistics.median(v) if None not in v else None
                     for call, v in times[name].items()}
        line = dict(variant=name, ms=med[name],
                    ptxas=libs[name][1])
        if name == "base" or all(p in EXACT for p in name.split("+")):
            same = {call: bool(torch.equal(
                bits[name][call].view(torch.int32),
                bits["base"][call].view(torch.int32)))
                for call in bits["base"]}
            line["bitwise_on_live_lanes"] = same
            failed |= not all(same.values())
        print(json.dumps(line), flush=True)
    split = {name: {call: (med["base"][call] - med[name][call]
                           if med["base"][call] and med[name][call]
                           else None) for call in med["base"]}
             for name in DROPS if name in med}
    print(json.dumps({"card": smi, "base_ms": med["base"],
                      "split_ms": split,
                      "live_lanes": {call: int(cs._live_of(
                          cs.gate_shape(key, a), a.get("active")).sum())
                          for call, key, a in calls}}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
