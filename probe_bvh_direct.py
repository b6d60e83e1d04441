#!/usr/bin/env python3
"""Where the BVH direct-light kernel's time goes, on one NVIDIA card.

    python3 probe_bvh_direct.py [--tree DIR]

A probe for work on the walk latency of `bvh_direct_kernel`, not part of
the smoke run.  On the arguments of the direct-light calls of five 1080p
frames -- baseline's, `full`'s bounce call (the third frame of a chain),
cf_close's (the 81,920-triangle mesh close up), and `heavy`'s primary
call (spp_dup 4) and GI call (4 x 2M lanes) -- it prints one JSON line
each with the kernel's device time (profiler) as the frame calls it,
with no lane live (what the dead lanes cost), and on the live lanes alone
packed into a call of their own (for the primary `heavy` call, the live
pixels packed and broadcast over the samples again; for its GI call, one
sample's seed for every packed lane).

From the node visits of each window the kernel walks (the plain walk's,
per ray), it also prints the longest chain of node visits a unit of 32
rows waits on in the two schedules: one thread a row walking its windows
in series (the unit waits on its slowest lane: `thread_chain_*`), and
the warp's list of open windows, walked 32 a round (the unit waits on the
longest walk of each round, chunk by chunk: `list_chain_*`), with the
rounds; the max over units and the mean over units with a live row.

`--tree DIR` runs another checkout's kernels and chip_smoke.py (say the
parent commit unpacked with `git archive`), so that two versions are
timed on the same calls; the chains are the schedules', whatever the
tree.  `--variant NAME` builds a copy of csrc/an_direct.cu under _build/
with the text of VARIANTS[NAME] replaced: `fixed`, the fixed-window form
(a live pixel's every window on consecutive entries, closed ones
included and not walked), `regs80`, the kernel free of its bound of
seven blocks an SM (ptxas gives it 80 registers, six blocks), `regs64`,
held to eight blocks (64 registers), or `no_walks`, every window left unwalked (its
radiance is wrong: a time without the walks, for the split).  Exits
non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

if __name__ == "__main__" and "--tree" in sys.argv:
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree")
                                                + 1]))

import chip_smoke as smoke  # noqa: E402

UNIT = 32          # rows a unit (csrc/an_direct.cu: make_units(n_units, 32))
ROUNDS = 6         # rounds of a chunk at most (kListCap / 32)
# The fixed-window form: a live pixel's every window on consecutive
# entries of the list, its closed ones included with a window of -1 and
# not walked.
FIXED_PUT = """// The fixed form: window `slot` of a live lane's `nw` windows at entry
// rank * nw + slot, closed ones included (window -1, not walked).
__device__ __forceinline__ int put_window_fixed(WindowList& wl, int warp,
                                                bool live, bool open,
                                                int rank, int n_live,
                                                int slot, int nw, int& n,
                                                const Query& q) {
  const int e = live ? rank * nw + slot : -1;
  n = n_live * nw;
  if (e >= 0) {
    wl.ow[warp][e] = make_float4(q.o.x, q.o.y, q.o.z, open ? q.win : -1.0f);
    wl.dx[warp][e] = q.d.x;
    wl.dy[warp][e] = q.d.y;
    wl.dz[warp][e] = q.d.z;
  }
  return e;
}

"""
# name -> [(text of csrc/an_direct.cu, its replacement, times it occurs)]
VARIANTS = {
    "fixed": [
        ("// Walk the warp's `n` entries", FIXED_PUT
         + "// Walk the warp's `n` entries", 1),
        ("      hit = any_hit_ww(", "      if (ow.w > 0.0f) hit = any_hit_ww(",
         1),
        ("    if (mask == 0) continue;\n",
         "    if (mask == 0) continue;\n"
         "    const int rank = __popc(mask & below), n_live = __popc(mask);\n",
         1),
        ("      int n_ent = 0;\n",
         "      int n_ent = 0, slot = 0;\n"
         "      const int nw = kSamples + (k == 0 ? s.sun_e + s.point_e : 0);\n",
         1),
        ("put_window(wl, warp, below, open, n_ent, q)",
         "put_window_fixed(wl, warp, live, open, rank, n_live, slot++, nw, "
         "n_ent, q)", 3)],
    "regs80": [("__launch_bounds__(kThreads, kDirectBlocks)\n"
                "bvh_direct_kernel(",
                "__launch_bounds__(kThreads)\nbvh_direct_kernel(", 1)],
    "regs64": [("constexpr int kDirectBlocks = 7;",
                "constexpr int kDirectBlocks = 8;", 1)],
    "no_walks": [("      hit = any_hit_ww(", "      hit = false && any_hit_ww(",
                  1)],
}


def use_variant(name):
    """Build the direct-light library from a copy of its source with
    VARIANTS[name]'s texts replaced (under _build/, the headers found in
    csrc/)."""
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    with open(cuda_lib.SOURCES["an_direct"]) as fh:
        src = fh.read()
    for old, new, times in VARIANTS[name]:
        if src.count(old) != times:
            raise RuntimeError(f"an_direct.cu no longer holds {old!r} "
                               f"{times} times")
        src = src.replace(old, new)
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_lib.BUILD_DIR, f"an_direct_{name}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    cuda_lib.SOURCES["an_direct"] = path
    cuda_lib.NVCC_FLAGS = cuda_lib.NVCC_FLAGS + ("-I", cuda_lib._CSRC)


def _dup(args):
    dup = int(args.get("spp_dup") or 0)
    return dup if dup > 1 else 1


def _pack(args, live):
    """A direct-light call's arguments cut to its `live` lanes, as one
    contiguous batch with every lane active."""
    from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
    h = args["h"]
    shape = h.t.shape
    idx = live.reshape(-1).nonzero().squeeze(1)

    def rows(x):
        return x.expand(shape + (3,)).reshape(-1, 3)[idx]

    def flat(x):
        return x.expand(shape).reshape(-1)[idx]
    return dict(args, h=Hit(flat(h.t), rows(h.p), rows(h.n), flat(h.mat)),
                vdir=rows(args["vdir"]), px=flat(args["px"]),
                py=flat(args["py"]), active=None)


def live_lanes_only(args, live):
    """The call on its live lanes alone: packed (_pack); with spp_dup, the
    live pixels packed and broadcast over the samples again; a sampled
    seed without spp_dup takes sample 0's value on every lane."""
    from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
    from opengl_raytracing_tpu_torch.sampling import FrameValue
    dup = _dup(args)
    rng = args["rng_frame"]
    if dup == 1:
        if rng.samples > 1:
            rng = FrameValue(rng.record, rng.a, rng.b)
        return dict(_pack(args, live), rng_frame=rng)
    shape = args["h"].t.shape
    one = dict(args, h=Hit(*(x[0] for x in args["h"])),
               vdir=args["vdir"].expand(shape + (3,))[0],
               px=args["px"].expand(shape)[0], py=args["py"].expand(shape)[0])
    packed = _pack(one, live.expand(shape)[0])

    def batch(x):  # [n, ...] as the [dup, n, 1, ...] batch of an image
        x = x.unsqueeze(1)
        return x.expand((dup,) + x.shape)
    return dict(packed, h=Hit(*(batch(x) for x in packed["h"])),
                vdir=batch(packed["vdir"]), px=batch(packed["px"]),
                py=batch(packed["py"]))


def window_visits(args):
    """([windows, dup, rows] node visits of each window the kernel walks,
    0 where it walks none; the walked mask of the same shape).  With
    spp_dup the sun and point windows are walked for sample 0 alone."""
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_traverse
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.vecmath import normalize
    h, scene = args["h"], args["scene"]
    shape, dup = h.t.shape, _dup(args)
    offs = lt._disk_offsets(args["rng_frame"], args["frame_index"],
                            args["px"], args["py"])
    o, d, w = lt._bvh_shadow_queries(scene, h, normalize(h.n), offs,
                                     args["active"])
    n_w = len(w)
    wins = torch.stack([x.expand(shape) for x in w]).reshape(n_w, dup, -1)
    wins[lt.SOFT_SHADOW_SAMPLES:, 1:] = -1.0
    walked = wins > 0.0
    origins = torch.stack([x.expand(shape + (3,)) for x in o]).reshape(
        n_w, dup, -1, 3)[walked]
    dirs = torch.stack([x.expand(shape + (3,)) for x in d]).reshape(
        n_w, dup, -1, 3)[walked]
    per_ray = torch.zeros(origins.shape[0], dtype=torch.int64,
                          device=h.t.device)
    count = bvh_traverse._count

    def count_per_ray(counts, lane, cnt, li):
        count(counts, lane, cnt, li)
        per_ray[lane] += 1
    bvh_traverse._count = count_per_ray
    try:
        bvh_traverse.trace_bvh_shadow(scene.bvh.arrays, origins, dirs,
                                      wins[walked], counts={"nodes": 0,
                                                            "tris": 0})
    finally:
        bvh_traverse._count = count
    visits = torch.zeros(wins.shape, dtype=torch.int64, device=h.t.device)
    visits[walked] = per_ray
    return visits, walked


def chains(visits, walked, live_rows):
    """The chains of node visits a unit waits on in the two schedules
    (module docstring), and the list's rounds."""
    import torch
    import torch.nn.functional as F
    n_w, dup, n_rows = visits.shape
    pad = (-n_rows) % UNIT
    v = F.pad(visits, (0, pad)).view(n_w, dup, -1, UNIT)
    o = F.pad(walked, (0, pad)).view(n_w, dup, -1, UNIT)
    n_units = v.shape[2]
    live = F.pad(live_rows, (0, pad)).view(-1, UNIT).any(-1)
    # one thread a row: its windows in series; the unit, its slowest lane
    thread = v.sum((0, 1)).max(-1).values
    # the list: window by window, lane by lane, 32 entries a round
    cnt = o.sum(-1)
    e = (cnt.cumsum(0) - cnt)[..., None] + o.cumsum(-1) - o.long()
    chunk = (torch.arange(n_units, device=v.device)[None, None, :, None]
             * dup + torch.arange(dup, device=v.device)[None, :, None, None])
    key = (chunk * ROUNDS + e // UNIT).expand(v.shape)
    rmax = torch.zeros(n_units * dup * ROUNDS, dtype=torch.int64,
                       device=v.device).scatter_reduce(0, key[o], v[o],
                                                       "amax")
    per_unit = rmax.view(n_units, -1).sum(-1)
    rounds = (cnt.sum(0) + UNIT - 1) // UNIT
    n_live = max(int(live.sum()), 1)
    return dict(
        live_units=int(live.sum()),
        thread_chain_max=int(thread.max()),
        thread_chain_mean=float(thread[live].sum()) / n_live,
        list_chain_max=int(per_unit.max()),
        list_chain_mean=float(per_unit[live].sum()) / n_live,
        list_rounds=int(rounds.sum()),
        list_rounds_max_per_unit=int(rounds.sum(0).max()),
        windows_walked=int(walked.sum()))


def probe(label, args):
    import torch
    from opengl_raytracing_tpu_torch.ops import an_cuda
    name = smoke.KERNELS["bvh_direct"]["kernel"]
    shape, dup = args["h"].t.shape, _dup(args)
    active = args["active"]
    live = (torch.ones(shape, dtype=torch.bool, device="cuda")
            if active is None else active.expand(shape))
    # no lane live (with spp_dup, a mask broadcast over the samples)
    dead = dict(args, active=torch.zeros_like(live[0]).expand(shape)
                if dup > 1 else torch.zeros_like(live))
    packed = live_lanes_only(args, live)
    visits, walked = window_visits(args)
    live_rows = live.reshape(dup, -1)[0]
    n_live = max(int(live.sum()), 1)

    def kernel_ms(a):
        return smoke.kernel_ms(lambda: an_cuda.direct_light_bvh(**a), name)
    return dict(call=label, lanes=live.numel(), spp_dup=dup,
                live_lanes=int(live.sum()),
                kernel_ms=kernel_ms(args),
                dead_lanes_kernel_ms=kernel_ms(dead),
                live_lanes_kernel_ms=kernel_ms(packed),
                node_visits_mean_per_live_lane=float(visits.sum()) / n_live,
                **chains(visits, walked, live_rows))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_bvh_direct: needs an NVIDIA card", file=sys.stderr)
        return 1
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    variant = (sys.argv[sys.argv.index("--variant") + 1]
               if "--variant" in sys.argv else None)
    if variant:
        use_variant(variant)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    libs = cuda_lib.build_all()
    with open(libs["an_direct"][:-3] + ".log") as fh:
        ptxas = [ln.strip() for ln in fh if "registers" in ln
                 or "spill" in ln]
    print(json.dumps({"tree": os.path.dirname(smoke.__file__),
                      "variant": variant, "ptxas": ptxas}), flush=True)
    _, bvh = smoke.scene("cuda")
    _, bvh6 = smoke.scene("cuda", smoke.HEAVY_SUBDIV)

    def calls(mesh, preset_name="baseline", frames=1, camera="still"):
        return smoke.record_kernel_inputs(
            mesh, smoke.HEIGHT, smoke.WIDTH, "cuda", ("bvh_direct",),
            preset_name, frames, camera=camera)["bvh_direct"]
    cases = (("baseline", lambda: calls(bvh)[0]),
             ("full_bounce", lambda: calls(bvh, "full",
                                           smoke.PROFILE_FRAME)[1]),
             ("cf_close", lambda: calls(bvh6, camera="cf_close")[0]),
             ("heavy_primary", lambda: calls(bvh, "heavy",
                                             smoke.PROFILE_FRAME)[0]),
             ("heavy_gi", lambda: calls(bvh, "heavy",
                                        smoke.PROFILE_FRAME)[1]))
    for label, args in cases:
        print(json.dumps(probe(label, args())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
