#!/usr/bin/env python3
"""Where the live_lanes kernels' time goes, on one NVIDIA card.

    python3 probe_live_scan.py [--variants NAME,A+B,...] [--rounds N]
        [--kernels sky,bvh_hit_mix,glass_rays,mirror_ray,glass_mix,
                   mirror_mix]

A probe for work on `sky_kernel` (csrc/an_trace.cu), `bvh_hit_mix_kernel`
(csrc/hit_mix.cu), `an_glass_rays_kernel`, `an_mirror_ray_kernel`,
`an_glass_mix_kernel` and `an_mirror_mix_kernel` (csrc/an_shade.cu), not
part of the smoke run.  It records, as
chip_smoke.py's phases an_gates, hit_mix and an_shade do, the three sky
calls of a 1080p an_full frame (the `full` preset with the day-sky
cubemap: the primary misses, the primary hits' GI bounce, the mirror's
GI bounce) and its glass and mirror rays and mix calls, the glass and
mirror rays and mix calls of an 800x600 an_baseline frame (the gradient
sky), the
sky call (the misses, the gradient sky) and the hit mix of a 1080p
`full` frame, and the hit mix of a 1080p `heavy` frame (4 samples, the
mask a byte a pixel), each the third of a chain; `--kernels` keeps the
calls of the kernels it names (all by default).  It builds a copy of
each source those kernels live in and of every header for each variant
in VARIANTS (probe_variants.py: one nvcc each, all started together,
under _build/probe_live_scan/).  A variant drops or swaps one part:

  scan_only  each live lane writes one float and nothing else: the mask
             scan (a mix: its radiance's first float);
  no_traces  the rays kernels' closest hit a stand-in (the floor where
             the ray points down, else a miss), not traced;
  no_rows    the sky's direction a hash of the lane index, not read (the
             taps as scattered as the bounce's);
  no_taps    the cubemap's four taps read as values of their indices;
  no_store   the outputs written only where a value is 12345 (the rays
             kernels' hits, views, skies, k and cos too, the mixes'
             radiance);
  one_lane   a live byte runs its own lane alone, its pixel the lane
             (right for a call without a sample axis only);
  slice16, slice8
             live_lanes' default slices (the sky's and the hit mix's) of
             16 or 8 mask bytes a thread (512 or 256 lanes a slice) where
             the source reads 4 (128);
  no_ahead   each slice's mask words loaded when the warp comes to it, not
             while it works the slice before;
  no_pairs   the gradient sky's full units worked one at a time, not in
             pairs (kPairs off);
  pairs_all  every build's full units worked in pairs (kPairs on);
  blocks14, blocks16
             the sky and the hit mix held to 14 or 16 blocks an SM (36
             or 32 registers);
  glass6, glass7, glass10, glass12, mirror5, mirror6, mirror7,
  mirror10, mirror12
             the glass or the mirror rays kernel held to that many blocks
             an SM (5: 96 registers, 6: 80, 7: 72, 8: 64, 10: 48, 12:
             40) where its source holds it to kGlassRaysBlocks or
             kMirrorRayBlocks;
  glass_slice8, glass_slice16, mirror_slice4, mirror_slice8
             the glass or the mirror rays kernel's slices of that many
             mask bytes a thread (kGlassSliceBytes 4, kMirrorSliceBytes 16
             in the source);
  glass_mix8 ... glass_mix16, mirror_mix8 ... mirror_mix16
             the glass or the mirror mix kernel held to that many blocks
             an SM (8, 10, 12, 14 or 16; 16: 32 registers) where its
             source holds it to kGlassMixBlocks or kMirrorMixBlocks (that
             number's variant is left out);
  glass_mix_slice4 ... 16, mirror_mix_slice4 ... 16
             the glass or the mirror mix kernel's slices of 4, 8 or 16
             mask bytes a thread where its source reads
             kGlassMixSliceBytes or kMirrorMixSliceBytes (that width's
             variant is left out);
  free       the kernels' registers left to the compiler, not held to
             their blocks an SM;
  one_body   each kernel's cubemap and gradient skies chosen by the
             table's pointer (cube_or_gradient_sky), where the source
             builds it once for each (kCube) so that a gradient call
             carries no tap;
  taps3      the cubemap's taps read as three floats from the [6, F, F, 3]
             table, as K3 reads them;
  rounds     live_rounds' scan (units of 32 lanes, a byte a lane, a pixel
             mask read once a sample) in every kernel:
             rounds+taps3+free+one_body is the sky's and the hit mix's
             form before live_lanes, rounds+taps3+free the rays
             kernels' (each still built twice, kCube), rounds+free the
             mixes';
  A+B        the patches of A and of B together.

The drop variants' outputs are wrong (a time without the part, for the
split); the others leave every bit as it is and must give the base's
bits: the sky on every call's live lanes, the hit mix's and the glass
and mirror mixes' whole radiance (their dead lanes untouched), the rays
kernels' outputs on the live lanes they write
(chip_smoke.shade_written).  Every library then runs on each
call in turns (base, variants, variants reversed, base, `--rounds` times,
default 3), timed by the profiler (chip_smoke.kernel_ms, the device time
of one launch).  One JSON line a variant (its median ms a call, its
ptxas registers and spill, its bits), then the split: base minus each
drop variant, a call.  Exits non-zero without a card or where an exact
variant's bits differ.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys

import chip_smoke as cs
import probe_variants as pv

SKY, MIX, SHADE = "an_trace.cu", "hit_mix.cu", "an_shade.cu"
_SKY_BODY = ("    const V3 d = at3(a.d, i, q);\n    put3(a.out, i, "
             "cube_or_gradient_sky<kCube>(s, a.texels, d));\n")
_ONE_SKY = ("  return kCube ? texel_sky(s, texels, d) : gradient_sky(s, d);"
            "\n")
_MIX_BODY = ("    V3 r = out_row(a.out, i);\n    if (a.gi) {\n"
             "      // gi_tail_bvh")
# the rays kernels' statements after their first (glass, mirror)
_GLASS_BODY = "    const V3 v = norm3("
_MIRROR_BODY = "    const V3 iv = neg3(norm3("
_LANES = {SKY: "  live_lanes<!kCube>(u, a.active, a.n_lanes, a.n_px, "
                "[&](int64_t i,\n" + " " * 57 + "int64_t q) {\n",
          MIX: "  live_lanes<false>(u, a.active, a.n_lanes, a.n_px, "
               "[&](int64_t i,\n" + " " * 56 + "int64_t q) {\n"}
_UNITS = ("  const Units u = slice_units(args->active, args->n_lanes, "
          "args->n_px);\n")
# the mixes' statements after their first (glass, mirror)
_GLASS_MIX_BODY = "    const V3 env = row3(a.sky[0], i);\n"
_MIRROR_MIX_BODY = "    V3 col;\n"


def _shade_const(name):
    """The value of `constexpr int name` in csrc/an_shade.cu."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "opengl_raytracing_tpu_torch", "csrc",
                           SHADE)) as fh:
        return re.search(rf"constexpr int {name} = (\d+);",
                         fh.read()).group(1)


# glass's and the mirror's rays and mix kernels' slice widths, walks and
# slice launches
_RAYS_WIDTHS = ("kGlassSliceBytes", "kMirrorSliceBytes",
                "kGlassMixSliceBytes", "kMirrorMixSliceBytes")
_RAYS_WALKS = tuple(
    f"  live_lanes<false, {w}>(u, a.active, a.n_lanes, a.n_px,\n"
    + " " * (22 + len(w)) + "[&](int64_t i, int64_t q) {\n"
    for w in _RAYS_WIDTHS)
_RAYS_UNITS = tuple("  const Units u = slice_units(args->active, "
                    f"args->n_lanes, args->n_px,\n{' ' * 30}{w});\n"
                    for w in _RAYS_WIDTHS)
# their blocks an SM
_RAYS_BLOCKS = {kernel: (name, _shade_const(name)) for kernel, name in (
    ("an_glass_rays_kernel", "kGlassRaysBlocks"),
    ("an_mirror_ray_kernel", "kMirrorRayBlocks"),
    ("an_glass_mix_kernel", "kGlassMixBlocks"),
    ("an_mirror_mix_kernel", "kMirrorMixBlocks"))}
# trace_closest's first lines and a stand-in hit of direction {}: the
# floor where it points down
_TRACE_HEAD = ("                                               float eps) "
               "{\n  const V3 fn = c3(s.floor_n);\n")
_FAKE_HIT = "({0}.y < 0.0f ? AnHit{{1.0f, kAnFloor}} : AnHit{{kInf, kAnMiss}})"


def _blocks(kernel, k):
    name, n = _RAYS_BLOCKS[kernel]
    return (SHADE, f"constexpr int {name} = {n};\n",
            f"constexpr int {name} = {k};\n")
_ROUNDS = ("  live_rounds(u, a.active, a.n_lanes, a.n_px, [&](int64_t i) {\n"
           "    const int64_t q =\n"
           "        a.n_lanes == a.n_px ? i : i - div_index(i, a.n_px) * "
           "a.n_px;\n")
_TAPS4 = ("  return cube_blend(k, texel4(env, k.k00), texel4(env, k.k01),\n"
          "                    texel4(env, k.k10), texel4(env, k.k11));\n")
_TAPS3 = ("  return cube_blend(k, ldg3(env + 3 * k.k00), ldg3(env + 3 * "
          "k.k01),\n                    ldg3(env + 3 * k.k10), ldg3(env + "
          "3 * k.k11));\n")
_FAKE = ("  return cube_blend(k, {(float)k.k00, 0.0f, 0.0f}, {(float)k.k01, "
         "0.0f, 0.0f},\n                    {(float)k.k10, 0.0f, 0.0f}, "
         "{(float)k.k11, 0.0f, 0.0f});\n")
_HEAD = "an_lanes.cuh"
_SCAN_AHEAD = ("    const SliceWords<kBytes> next = words(j + step);  // in "
               "flight\n    const unsigned bits = live_bits(w);\n"
               "    w = next;\n")
_SCAN_HERE = "    const unsigned bits = live_bits(words(j));\n"


def _const(name, old, new):
    text = f"constexpr int {name} = "
    return (_HEAD, text + old + ";\n", text + new + ";\n")


def _guard(file, store, value):
    """A patch that makes `store` (a statement of `file`) run only where
    `value` is 12345."""
    return (file, store, f"  if ({value} == 12345.0f) {{\n{store}  }}\n")


# name -> [(file, a text of it, its replacement)] (probe_variants.py)
VARIANTS = {
    "scan_only": [
        (SKY, _SKY_BODY, "    a.out[3 * i] = 1.0f;\n"),
        (MIX, _MIX_BODY, "    a.out[3 * i] = 1.0f;\n"
                         "    if (a.n_lanes > 0) return;\n" + _MIX_BODY),
        (SHADE, _GLASS_BODY, "    a.k[i] = 1.0f;\n"
                             "    if (a.n_lanes > 0) return;\n"
         + _GLASS_BODY),
        (SHADE, _MIRROR_BODY, "    a.t[i] = 1.0f;\n"
                              "    if (a.n_lanes > 0) return;\n"
         + _MIRROR_BODY)]
    + [(SHADE, body, "    a.out[3 * i] = 1.0f;\n"
                     "    if (a.n_lanes > 0) return;\n" + body)
       for body in (_GLASS_MIX_BODY, _MIRROR_MIX_BODY)],
    "no_traces": [
        ("an_scene.cuh", _TRACE_HEAD,
         _TRACE_HEAD + "  if (eps > -1.0f)\n    return " + _FAKE_HIT.format(
             "d") + ";\n")],
    **{f"{kernel}_slice{k}": [(SHADE, f"constexpr int {w} = {n};\n",
                               f"constexpr int {w} = {k};\n")]
       for kernel, w in (("glass", "kGlassSliceBytes"),
                         ("mirror", "kMirrorSliceBytes"),
                         ("glass_mix", "kGlassMixSliceBytes"),
                         ("mirror_mix", "kMirrorMixSliceBytes"))
       for n in [int(_shade_const(w))]
       for k in (4, 8, 16) if k != n},
    "no_rows": [
        (SKY, _SKY_BODY,
         "    const uint32_t hh = (uint32_t)i * 2654435761u;\n"
         "    const V3 d = {(float)(hh & 1023u) - 512.0f,\n"
         "                  (float)((hh >> 10) & 1023u) - 512.0f,\n"
         "                  (float)(hh >> 20) - 2048.0f};\n"
         "    put3(a.out, i, cube_or_gradient_sky<kCube>(s, a.texels, d));"
         "\n")],
    "no_taps": [("cubemap.cuh", _TAPS4, _FAKE),
                ("cubemap.cuh", _TAPS3, _FAKE)],
    "no_store": [
        (_HEAD,
         "  out[3 * i] = c.x;\n  out[3 * i + 1] = c.y;\n"
         "  out[3 * i + 2] = c.z;\n",
         "  if (c.x == 12345.0f) {\n  out[3 * i] = c.x;\n"
         "  out[3 * i + 1] = c.y;\n  out[3 * i + 2] = c.z;\n  }\n"),
        _guard(_HEAD, "  t_out[i] = h.t;\n", "h.t"),
        _guard(_HEAD, "  mat_out[i] = h.k == kAnMiss ? 0 : h.k;\n", "h.t"),
        _guard(SHADE, "    a.cos[i] = fminf(fmaxf(ct, 0.0f), 1.0f);\n",
               "ct"),
        _guard(SHADE, "    a.k[i] = k;\n", "k")],
    "one_lane": [(_HEAD, "  const int reps = pixel ? (int)n_lanes / px_n "
                         ": 1;\n", "  const int reps = 1;\n"),
                 (_HEAD, "  const bool own_px = pixel || n_lanes == n_px;\n",
                  "  const bool own_px = true;\n")],
    "slice16": [_const("kSliceBytes", "4", "16")],
    "slice8": [_const("kSliceBytes", "4", "8")],
    "no_ahead": [(_HEAD, _SCAN_AHEAD, _SCAN_HERE)],
    "no_pairs": [(SKY, "live_lanes<!kCube>(", "live_lanes<false>(")],
    "pairs_all": [(SKY, "live_lanes<!kCube>(", "live_lanes<true>("),
                  (MIX, "live_lanes<false>(", "live_lanes<true>(")],
    **{f"glass{k}": [_blocks("an_glass_rays_kernel", k)]
       for k in (6, 7, 10, 12)},
    **{f"mirror{k}": [_blocks("an_mirror_ray_kernel", k)]
       for k in (5, 6, 7, 10, 12)},
    **{f"{kernel[3:-7]}{k}": [_blocks(kernel, k)]
       for kernel in ("an_glass_mix_kernel", "an_mirror_mix_kernel")
       for k in (8, 10, 12, 14, 16) if str(k) != _RAYS_BLOCKS[kernel][1]},
    **{f"blocks{k}": [
        (src, "__launch_bounds__(kLiveThreads, kSliceBlocks)\n" + kernel,
         f"__launch_bounds__(kLiveThreads, {k})\n" + kernel)
        for src, kernel in ((SKY, "sky_kernel("),
                            (MIX, "bvh_hit_mix_kernel("))]
       for k in (14, 16)},
    "free": [(src, "__launch_bounds__(kLiveThreads, kSliceBlocks)\n"
              + kernel, "__launch_bounds__(kLiveThreads)\n" + kernel)
             for src, kernel in ((SKY, "sky_kernel("),
                                 (MIX, "bvh_hit_mix_kernel("))]
    + [(SHADE, f"__launch_bounds__(kLiveThreads, {name})\n",
        "__launch_bounds__(kLiveThreads)\n")
       for name, _ in _RAYS_BLOCKS.values()],
    "taps3": [("an_scene.cuh",
               "  return scale3(sample_cubemap4(texels, s.env_f, d),",
               "  return scale3(sample_cubemap(s.env, s.env_f, d),")],
    "one_body": [("an_scene.cuh", _ONE_SKY,
                  _ONE_SKY.replace("kCube ?", "texels ?"))],
    "rounds": [(SKY, _LANES[SKY], _ROUNDS), (MIX, _LANES[MIX], _ROUNDS),
               (SKY, _UNITS, "  const Units u = make_units(args->n_lanes, "
                             "32);\n"),
               (MIX, _UNITS, "  const Units u = make_units(args->n_lanes, "
                             "32);\n")]
    + [(SHADE, text, _ROUNDS) for text in _RAYS_WALKS]
    + [(SHADE, text, "  const Units u = make_units(args->n_lanes, 32);\n")
       for text in _RAYS_UNITS],
}
DROPS = ("scan_only", "no_traces", "no_rows", "no_taps", "no_store",
         "one_lane")
EXACT = tuple(name for name in VARIANTS if name not in DROPS)
KERNELS = {"sky": "sky_kernel", "bvh_hit_mix": "bvh_hit_mix_kernel",
           "glass_rays": "an_glass_rays_kernel",
           "mirror_ray": "an_mirror_ray_kernel",
           "glass_mix": "an_glass_mix_kernel",
           "mirror_mix": "an_mirror_mix_kernel"}
SOURCES = {"sky": SKY, "bvh_hit_mix": MIX, "glass_rays": SHADE,
           "mirror_ray": SHADE, "glass_mix": SHADE, "mirror_mix": SHADE}
# each source's builds in ptxas's mangled names (kCube true, false)
BUILDS = {SKY: {"sky_cube": "sky_kernelILb1", "sky_gradient":
                "sky_kernelILb0"},
          MIX: {"mix_cube": "bvh_hit_mix_kernelILb1",
                "mix_gradient": "bvh_hit_mix_kernelILb0"},
          SHADE: {"glass_cube": "an_glass_rays_kernelILb1",
                  "glass_gradient": "an_glass_rays_kernelILb0",
                  "mirror_cube": "an_mirror_ray_kernelILb1",
                  "mirror_gradient": "an_mirror_ray_kernelILb0",
                  "glass_mix": "an_glass_mix_kernel",
                  "mirror_mix": "an_mirror_mix_kernel"}}
# the wrappers' modules under opengl_raytracing_tpu_torch.ops
MODULES = {SKY: "an_trace_cuda", MIX: "hit_mix_cuda", SHADE: "an_shade_cuda"}
RAYS = ("glass_rays", "mirror_ray")
MIXES = ("glass_mix", "mirror_mix")


def for_source(source):
    """VARIANTS with the patches of the other sources left out."""
    return {name: [p for p in patches if p[0] in (source,) or
                   p[0].endswith(".cuh")]
            for name, patches in VARIANTS.items()}


def calls_of(env, bvh, keys):
    """[(name, kernel key, the call's wrapper arguments)] of the recorded
    calls of the kernels `keys`."""
    out = []
    an_keys = tuple(k for k in ("sky",) + RAYS + MIXES if k in keys)
    if an_keys:
        an = cs.record_kernel_inputs(None, cs.HEIGHT, cs.WIDTH, "cuda",
                                     an_keys, "full", cs.PROFILE_FRAME,
                                     env=env)
        if "sky" in keys:
            out += [(f"an_full_sky_{label}", "sky", a) for label, a in
                    zip(("primary", "gi", "mirror_gi"), an["sky"])]
        out += [(f"an_full_{k}", k, an[k][0]) for k in RAYS + MIXES
                if k in keys]
    rays = tuple(k for k in RAYS + MIXES if k in keys)
    if rays:
        base = cs.record_kernel_inputs(None, cs.AN_HEIGHT, cs.AN_WIDTH,
                                       "cuda", rays, "baseline",
                                       cs.PROFILE_FRAME)
        out += [(f"an_baseline_{k}", k, base[k][0]) for k in rays]
    if "sky" in keys or "bvh_hit_mix" in keys:
        full = cs.record_kernel_inputs(bvh, cs.HEIGHT, cs.WIDTH, "cuda",
                                       ("sky", "bvh_hit_mix"), "full",
                                       cs.PROFILE_FRAME)
        if "sky" in keys:
            out.append(("full_sky_misses", "sky", full["sky"][0]))
    if "bvh_hit_mix" in keys:
        heavy = cs.record_kernel_inputs(bvh, cs.HEIGHT, cs.WIDTH, "cuda",
                                        ("bvh_hit_mix",), "heavy",
                                        cs.PROFILE_FRAME)
        out += [("full_hit_mix", "bvh_hit_mix", full["bvh_hit_mix"][0]),
                ("heavy_hit_mix", "bvh_hit_mix", heavy["bvh_hit_mix"][0])]
    return out


def caller(key, a):
    """A call of kernel `key`'s wrapper on the recorded arguments `a` with
    the frame's mask (the hit mix into a copy of the frame's radiance
    made once)."""
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    if key == "sky":
        return lambda: cs.gate_call(key, a, a.get("active"))
    if key in RAYS:
        return lambda: cs.shade_call(key, a, a.get("active"))
    if key in MIXES:
        out = a["out"].clone()
        return lambda: cs.shade_call(key, a, a.get("active"), out)
    args = {k: v for k, v in a.items() if k not in ("active", "radiance")}
    radiance = a["radiance"].clone()
    return lambda: hit_mix_cuda.bvh_hit_mix(**args, radiance=radiance,
                                            active=a.get("active"))


def shape_of(key, a):
    if key in RAYS + MIXES:
        return cs.shade_shape(key, a)
    return a["d" if key == "sky" else "radiance"].shape[:-1]


def outputs(key, a, written):
    """What the call computes that must not change, as int32 bits: the sky
    on the live lanes; a hit mix's or a glass or mirror mix's whole
    radiance from a copy of the frame's (its dead lanes as they came); a
    rays kernel's outputs on the lanes `written` holds for each
    (chip_smoke.shade_written)."""
    import torch
    if key == "sky":
        live = cs._live_of(shape_of(key, a), a.get("active"))
        return cs.gate_call(key, a, a.get("active"))["sky"][live].view(
            torch.int32)
    if key in RAYS:
        got = cs.shade_call(key, a, a.get("active"))
        return torch.cat([got[f][lanes].reshape(-1).view(torch.int32)
                          for f, lanes in sorted(written.items())])
    if key in MIXES:
        out = a["out"].clone()
        cs.shade_call(key, a, a.get("active"), out)
        return out.view(torch.int32)
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    out = a["radiance"].clone()
    hit_mix_cuda.bvh_hit_mix(**{k: v for k, v in a.items()
                                if k not in ("active", "radiance")},
                             radiance=out, active=a.get("active"))
    return out.view(torch.int32)


def written_of(key, a):
    """{output: the lanes the kernel writes it on} of a rays call, from its
    dense plain version; None for the other kernels."""
    if key not in RAYS:
        return None
    live = cs._live_of(shape_of(key, a), a.get("active"))
    return cs.shade_written(key, cs.shade_plain(key, a), live)


def main() -> int:
    import importlib
    import torch
    if not torch.cuda.is_available():
        print("probe_live_scan: no CUDA card", file=sys.stderr)
        return 1
    names, rounds = pv.options(VARIANTS, 3)
    keys = list(KERNELS)
    if "--kernels" in sys.argv:
        keys = sys.argv[sys.argv.index("--kernels") + 1].split(",")
        if not set(keys) <= set(KERNELS):
            raise SystemExit(f"unknown kernels in {keys}")
    smi = pv.card()
    print(smi, flush=True)
    sources = sorted({SOURCES[k] for k in keys})
    modules = {src: importlib.import_module(
        f"opengl_raytracing_tpu_torch.ops.{MODULES[src]}") for src in sources}
    libs = {src: pv.build("probe_live_scan", src, m._SIGNATURES,
                          BUILDS[src], for_source(src), names)
            for src, m in modules.items()}
    calls = calls_of(cs.sky_day("cuda"), cs.scene("cuda")[1], set(keys))
    written = {call: written_of(key, a) for call, key, a in calls}
    real = {src: m._library for src, m in modules.items()}
    every = ["base"] + names
    times = {name: {call: [] for call, *_ in calls} for name in every}
    bits = {name: {} for name in every}
    try:
        for _ in range(rounds):
            for name in pv.turn_order(names):
                for src, m in modules.items():
                    m._library = (lambda h=libs[src][name][0]: h)
                for call, key, a in calls:
                    times[name][call].append(cs.kernel_ms(caller(key, a),
                                                          KERNELS[key]))
                    if call not in bits[name]:
                        bits[name][call] = outputs(key, a, written[call])
    finally:
        for src, m in modules.items():
            m._library = real[src]
    failed = False
    med = {}
    for name in times:
        med[name] = {call: statistics.median(v) if None not in v else None
                     for call, v in times[name].items()}
        line = dict(variant=name, ms=med[name],
                    ptxas={src: libs[src][name][1] for src in libs})
        if name == "base" or all(p in EXACT for p in name.split("+")):
            same = {call: bool(torch.equal(bits[name][call],
                                           bits["base"][call]))
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
