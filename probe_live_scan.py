#!/usr/bin/env python3
"""Where the sky and BVH hit-mix kernels' time goes, on one NVIDIA card.

    python3 probe_live_scan.py [--variants NAME,A+B,...] [--rounds N]

A probe for work on `sky_kernel` (csrc/an_trace.cu) and
`bvh_hit_mix_kernel` (csrc/hit_mix.cu), not part of the smoke run.  It
records, as chip_smoke.py's phases an_gates and hit_mix do, the three
sky calls of a 1080p an_full frame (the `full` preset with the day-sky
cubemap: the primary misses, the primary hits' GI bounce, the mirror's
GI bounce), the sky call (the misses, the gradient sky) and the hit mix
of a 1080p `full` frame, and the hit mix of a 1080p `heavy` frame (4
samples, the mask a byte a pixel), each the third of a chain.  It builds
a copy of both sources and every header for each variant in VARIANTS
(probe_variants.py: one nvcc each, all started together, under
_build/probe_live_scan/).  A variant drops or swaps one part:

  scan_only  each live lane writes one float and nothing else: the mask
             scan and the queue;
  no_rows    the sky's direction a hash of the lane index, not read (the
             taps as scattered as the bounce's);
  no_taps    the cubemap's four taps read as values of their indices;
  no_store   the outputs written only where a value is 12345;
  one_lane   a live byte runs its own lane alone, its pixel the lane
             (right for a call without a sample axis only);
  slice16, slice8
             live_lanes' slices of 16 or 8 mask bytes a thread (512 or
             256 lanes a slice) where the source reads 4 (128);
  no_ahead   each slice's mask words loaded when the warp comes to it, not
             while it works the slice before;
  direct_all every unit with a live lane worked where it lies, a lane
             each, none queued;
  no_pairs   the gradient sky's full units worked one at a time, not in
             pairs (kPairs off);
  pairs_all  every build's full units worked in pairs (kPairs on);
  blocks14, blocks16
             both kernels held to 14 or 16 blocks an SM (36 or 32
             registers);
  free       the kernels' registers left to the compiler, not held to
             kSliceBlocks blocks an SM;
  one_body   each kernel's cubemap and gradient skies chosen in its body
             by the table's pointer, where the source builds it once for
             each (kCube) so that a gradient call carries no tap;
  taps3      the cubemap's taps read as three floats from the [6, F, F, 3]
             table, as K3 reads them;
  rounds     live_rounds' scan (units of 32 lanes, a byte a lane, a pixel
             mask read once a sample) in both kernels:
             rounds+taps3+free+one_body is both kernels' form before
             live_lanes;
  A+B        the patches of A and of B together.

The drop variants' outputs are wrong (a time without the part, for the
split); the others leave every bit as it is and must give the base's
bits: the sky on every call's live lanes, the hit mix's whole radiance
(its dead lanes untouched).  Every library then runs on each call in
turns (base, variants, variants reversed, base, `--rounds` times,
default 3), timed by the profiler (chip_smoke.kernel_ms, the device time
of one launch).  One JSON line a variant (its median ms a call, its
ptxas registers and spill, its bits), then the split: base minus each
drop variant, a call.  Exits non-zero without a card or where an exact
variant's bits differ.
"""

from __future__ import annotations

import json
import statistics
import sys

import chip_smoke as cs
import probe_variants as pv

SKY, MIX = "an_trace.cu", "hit_mix.cu"
_SKY_BODY = ("    const V3 d = at3(a.d, i, q);\n    put3(a.out, i, kCube ? "
             "texel_sky(s, a.texels, d) : gradient_sky(s, d));\n")
_MIX_SKY = ("          li = kCube ? texel_sky(s, a.texels, wi) : "
            "gradient_sky(s, wi);\n")
_MIX_BODY = ("    V3 r = out_row(a.out, i);\n    if (a.gi) {\n"
             "      // gi_tail_bvh")
_LANES = {SKY: "  live_lanes<!kCube>(u, a.active, a.n_lanes, a.n_px, "
                "[&](int64_t i,\n" + " " * 57 + "int64_t q) {\n",
          MIX: "  live_lanes<false>(u, a.active, a.n_lanes, a.n_px, "
               "[&](int64_t i,\n" + " " * 56 + "int64_t q) {\n"}
_ROUNDS = ("  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {\n"
           "    const int64_t q =\n"
           "        a.n_lanes == a.n_px ? i : i - div_index(i, a.n_px) * "
           "a.n_px;\n")
_UNITS = ("  const Units u = slice_units(args->active, args->n_lanes, "
          "args->n_px);\n")
_TAPS4 = ("  return cube_blend(k, texel4(env, k.k00), texel4(env, k.k01),\n"
          "                    texel4(env, k.k10), texel4(env, k.k11));\n")
_TAPS3 = ("  return cube_blend(k, ldg3(env + 3 * k.k00), ldg3(env + 3 * "
          "k.k01),\n                    ldg3(env + 3 * k.k10), ldg3(env + "
          "3 * k.k11));\n")
_FAKE = ("  return cube_blend(k, {(float)k.k00, 0.0f, 0.0f}, {(float)k.k01, "
         "0.0f, 0.0f},\n                    {(float)k.k10, 0.0f, 0.0f}, "
         "{(float)k.k11, 0.0f, 0.0f});\n")
_HEAD = "an_lanes.cuh"
_SCAN_AHEAD = ("    const SliceWords next = words(j + step);  // in flight "
               "over this slice\n    const unsigned bits = live_bits(w);\n"
               "    w = next;\n")
_SCAN_HERE = "    const unsigned bits = live_bits(words(j));\n"


def _const(name, old, new):
    text = f"constexpr int {name} = "
    return (_HEAD, text + old + ";\n", text + new + ";\n")


# name -> [(file, a text of it, its replacement)] (probe_variants.py)
VARIANTS = {
    "scan_only": [
        (SKY, _SKY_BODY, "    a.out[3 * i] = 1.0f;\n"),
        (MIX, _MIX_BODY, "    a.out[3 * i] = 1.0f;\n"
                         "    if (a.n_lanes > 0) return;\n" + _MIX_BODY)],
    "no_rows": [
        (SKY, _SKY_BODY,
         "    const uint32_t hh = (uint32_t)i * 2654435761u;\n"
         "    const V3 d = {(float)(hh & 1023u) - 512.0f,\n"
         "                  (float)((hh >> 10) & 1023u) - 512.0f,\n"
         "                  (float)(hh >> 20) - 2048.0f};\n"
         "    put3(a.out, i, kCube ? texel_sky(s, a.texels, d) : "
         "gradient_sky(s, d));\n")],
    "no_taps": [("cubemap.cuh", _TAPS4, _FAKE), ("cubemap.cuh", _TAPS3, _FAKE)],
    "no_store": [
        (_HEAD,
         "  out[3 * i] = c.x;\n  out[3 * i + 1] = c.y;\n"
         "  out[3 * i + 2] = c.z;\n",
         "  if (c.x == 12345.0f) {\n  out[3 * i] = c.x;\n"
         "  out[3 * i + 1] = c.y;\n  out[3 * i + 2] = c.z;\n  }\n")],
    "one_lane": [(_HEAD, "  const int reps = pixel ? (int)n_lanes / px_n "
                         ": 1;\n", "  const int reps = 1;\n"),
                 (_HEAD, "  const bool own_px = pixel || n_lanes == n_px;\n",
                  "  const bool own_px = true;\n")],
    "slice16": [_const("kSliceBytes", "4", "16")],
    "slice8": [_const("kSliceBytes", "4", "8")],
    "no_ahead": [(_HEAD, _SCAN_AHEAD, _SCAN_HERE)],
    "direct_all": [(_HEAD, "      if (live != 0xffffffffu) {\n",
                    "      if (live != live) {\n")],
    "no_pairs": [(SKY, "live_lanes<!kCube>(", "live_lanes<false>(")],
    "pairs_all": [(SKY, "live_lanes<!kCube>(", "live_lanes<true>("),
                  (MIX, "live_lanes<false>(", "live_lanes<true>(")],
    **{f"blocks{k}": [
        (src, "__launch_bounds__(kLiveThreads, kSliceBlocks)\n" + kernel,
         f"__launch_bounds__(kLiveThreads, {k})\n" + kernel)
        for src, kernel in ((SKY, "sky_kernel("),
                            (MIX, "bvh_hit_mix_kernel("))]
       for k in (14, 16)},
    "free": [(src, "__launch_bounds__(kLiveThreads, kSliceBlocks)\n"
              + kernel, "__launch_bounds__(kLiveThreads)\n" + kernel)
             for src, kernel in ((SKY, "sky_kernel("),
                                 (MIX, "bvh_hit_mix_kernel("))],
    "taps3": [("an_scene.cuh",
               "  return scale3(sample_cubemap4(texels, s.env_f, d),",
               "  return scale3(sample_cubemap(s.env, s.env_f, d),")],
    "one_body": [(SKY, _SKY_BODY, _SKY_BODY.replace("kCube ?",
                                                    "a.texels ?")),
                 (MIX, _MIX_SKY, _MIX_SKY.replace("kCube ?", "a.texels ?"))],
    "rounds": [(SKY, _LANES[SKY], _ROUNDS), (MIX, _LANES[MIX], _ROUNDS),
               (SKY, _UNITS, "  const Units u = make_units(args->n_lanes, "
                             "32);\n"),
               (MIX, _UNITS, "  const Units u = make_units(args->n_lanes, "
                             "32);\n")],
}
DROPS = ("scan_only", "no_rows", "no_taps", "no_store", "one_lane")
EXACT = ("slice16", "slice8", "no_ahead", "direct_all", "no_pairs",
         "pairs_all", "blocks14", "blocks16", "free", "one_body", "taps3",
         "rounds")
KERNELS = {"sky": "sky_kernel", "bvh_hit_mix": "bvh_hit_mix_kernel"}
# each kernel's two builds (kCube true, false) in ptxas's mangled names
BUILDS = {"sky": {"sky_cube": "sky_kernelILb1", "sky_gradient":
                  "sky_kernelILb0"},
          "bvh_hit_mix": {"mix_cube": "bvh_hit_mix_kernelILb1",
                          "mix_gradient": "bvh_hit_mix_kernelILb0"}}
SOURCES = {"sky": SKY, "bvh_hit_mix": MIX}


def for_source(source):
    """VARIANTS with the patches of the other source left out."""
    return {name: [p for p in patches if p[0] in (source,) or
                   p[0].endswith(".cuh")]
            for name, patches in VARIANTS.items()}


def calls_of(env, bvh):
    """[(name, kernel key, the call's wrapper arguments)] of the recorded
    calls."""
    an = cs.record_kernel_inputs(None, cs.HEIGHT, cs.WIDTH, "cuda",
                                 ("sky",), "full", cs.PROFILE_FRAME, env=env)
    full = cs.record_kernel_inputs(bvh, cs.HEIGHT, cs.WIDTH, "cuda",
                                   ("sky", "bvh_hit_mix"), "full",
                                   cs.PROFILE_FRAME)
    heavy = cs.record_kernel_inputs(bvh, cs.HEIGHT, cs.WIDTH, "cuda",
                                    ("bvh_hit_mix",), "heavy",
                                    cs.PROFILE_FRAME)
    return ([(f"an_full_sky_{label}", "sky", a) for label, a in
             zip(("primary", "gi", "mirror_gi"), an["sky"])]
            + [("full_sky_misses", "sky", full["sky"][0]),
               ("full_hit_mix", "bvh_hit_mix", full["bvh_hit_mix"][0]),
               ("heavy_hit_mix", "bvh_hit_mix", heavy["bvh_hit_mix"][0])])


def caller(key, a):
    """A call of kernel `key`'s wrapper on the recorded arguments `a` with
    the frame's mask (the hit mix into a copy of the frame's radiance
    made once)."""
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    if key == "sky":
        return lambda: cs.gate_call(key, a, a.get("active"))
    args = {k: v for k, v in a.items() if k not in ("active", "radiance")}
    radiance = a["radiance"].clone()
    return lambda: hit_mix_cuda.bvh_hit_mix(**args, radiance=radiance,
                                            active=a.get("active"))


def shape_of(key, a):
    return a["d" if key == "sky" else "radiance"].shape[:-1]


def outputs(key, a):
    """What the call computes that must not change: the sky on the live
    lanes; the hit mix's whole radiance from a copy of the frame's (its
    dead lanes as they came)."""
    if key == "sky":
        live = cs._live_of(shape_of(key, a), a.get("active"))
        return cs.gate_call(key, a, a.get("active"))["sky"][live]
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    out = a["radiance"].clone()
    hit_mix_cuda.bvh_hit_mix(**{k: v for k, v in a.items()
                                if k not in ("active", "radiance")},
                             radiance=out, active=a.get("active"))
    return out


def main() -> int:
    import torch
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda, hit_mix_cuda
    if not torch.cuda.is_available():
        print("probe_live_scan: no CUDA card", file=sys.stderr)
        return 1
    names, rounds = pv.options(VARIANTS, 3)
    smi = pv.card()
    print(smi, flush=True)
    modules = {"sky": an_trace_cuda, "bvh_hit_mix": hit_mix_cuda}
    libs = {key: pv.build("probe_live_scan", SOURCES[key], m._SIGNATURES,
                          BUILDS[key], for_source(SOURCES[key]),
                          names)
            for key, m in modules.items()}
    calls = calls_of(cs.sky_day("cuda"), cs.scene("cuda")[1])
    real = {key: m._library for key, m in modules.items()}
    times = {name: {call: [] for call, *_ in calls} for name in libs["sky"]}
    bits = {name: {} for name in libs["sky"]}
    try:
        for _ in range(rounds):
            for name in pv.turn_order(names):
                for key, m in modules.items():
                    m._library = (lambda h=libs[key][name][0]: h)
                for call, key, a in calls:
                    times[name][call].append(cs.kernel_ms(caller(key, a),
                                                          KERNELS[key]))
                    if call not in bits[name]:
                        bits[name][call] = outputs(key, a)
    finally:
        for key, m in modules.items():
            m._library = real[key]
    failed = False
    med = {}
    for name in times:
        med[name] = {call: statistics.median(v) if None not in v else None
                     for call, v in times[name].items()}
        line = dict(variant=name, ms=med[name],
                    ptxas={k: libs[k][name][1] for k in libs})
        if name == "base" or all(p in EXACT for p in name.split("+")):
            same = {call: bool(torch.equal(
                bits[name][call].view(torch.int32),
                bits["base"][call].view(torch.int32)))
                for call in bits["base"]}
            line["bitwise"] = same
            failed |= not all(same.values())
        print(json.dumps(line), flush=True)
    split = {name: {call: (med["base"][call] - med[name][call]
                           if med["base"][call] and med[name][call]
                           else None) for call in med["base"]}
             for name in DROPS if name in med}
    print(json.dumps({"card": smi, "base_ms": med["base"],
                      "split_ms": split,
                      "live_lanes": {call: int(cs._live_of(
                          shape_of(key, a), a.get("active")).sum())
                          for call, key, a in calls}}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
