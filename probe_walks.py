#!/usr/bin/env python3
"""Where the BVH walk kernels' time goes, on one NVIDIA card.

    python3 probe_walks.py

A probe for work on the walk kernels of csrc/bvh_trace.cu, not part of
the smoke run.  On the arguments of the third frame of a 1080p `full`
chain -- the primary closest-hit call, GI's bounce call and the AO call
-- it prints one JSON line each with the kernel's device time (profiler)
as the frame calls it and with no lane live (what the dead lanes cost);
the walks' node visits and triangle tests per ray as the plain walk
makes them, over the live rays: the mean and the longest; and how the
kernel's units (runs of 32 lanes, AO's 32 / S pixels) with a live lane
fall on its warps (unit u to warp u mod the warps in the grid): how
many such units there are, how many warps get one, and the most one
warp gets.  Exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys

import chip_smoke as smoke

# one block of 1,024 threads an SM (kThreads in csrc/bvh_trace.cu)
WARPS_PER_SM = 32


@contextlib.contextmanager
def per_ray_counts(n_rays, device):
    """Count each ray's node visits and triangle tests in the plain walks
    run inside the context: yields (nodes, tris) [n_rays] int64."""
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_traverse
    from opengl_raytracing_tpu_torch.scene.bvh import LEAF_MAX
    nodes = torch.zeros(n_rays, dtype=torch.int64, device=device)
    tris = torch.zeros(n_rays, dtype=torch.int64, device=device)
    count = bvh_traverse._count

    def count_per_ray(counts, lane, cnt, li):
        count(counts, lane, cnt, li)
        nodes[lane] += 1
        tris[lane[li]] += cnt[li].clamp(max=LEAF_MAX)
    bvh_traverse._count = count_per_ray
    try:
        yield nodes, tris
    finally:
        bvh_traverse._count = count


def walks(kind, args):
    """(nodes, tris) per live ray of one call, from the plain walks."""
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_traverse as plain
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.params import bind
    arrays = args["bvh"]
    if kind == "closest":
        o = args["ro"].expand(args["rd"].shape).reshape(-1, 3)
        d = args["rd"].reshape(-1, 3)
        with per_ray_counts(o.shape[0], o.device) as c:
            plain.trace_bvh(arrays, o, d, args["eps"],
                            counts=dict(nodes=0, tris=0))
        return c
    h = args["h0" if kind == "bounce" else "h"]
    live = smoke._live(h, args["active"]).reshape(-1)
    if kind == "bounce":
        o, d, _ = lt._bounce_ray(h, args["rng_frame"], args["seed"],
                                 args["px"], args["py"])
        o, d = o.reshape(-1, 3)[live], d.reshape(-1, 3)[live]
        with per_ray_counts(o.shape[0], o.device) as c:
            plain.trace_bvh(arrays, o, d, counts=dict(nodes=0, tris=0))
        return c
    params = args["params"]
    org, dirs = lt._ao_rays(h, args["frame_index"], args["px"], args["py"],
                            params)
    shape = h.t.shape
    o = org.expand(shape + (3,)).reshape(-1, 3)[live]
    n = o.shape[0] * len(dirs)
    with per_ray_counts(n, o.device) as c:
        plain.trace_bvh_shadow(
            arrays, torch.cat([o] * len(dirs)),
            torch.cat([x.reshape(-1, 3)[live] for x in dirs]),
            bind(params, o.device)["ao_radius"].expand(n),
            counts=dict(nodes=0, tris=0))
    return c


def live_units(kind, args, live):
    """(live units, warps with one, the most on one warp) of a call."""
    import torch
    unit = 32
    if kind == "ao":
        s = int(args["params"].ao_samples)
        unit = 32 // s if s <= 32 else 1
    n = live.numel()
    pad = torch.zeros((n + unit - 1) // unit * unit, dtype=torch.bool,
                      device=live.device)
    pad[:n] = live.reshape(-1)
    units = pad.reshape(-1, unit).any(1).nonzero().squeeze(1)
    warps = torch.cuda.get_device_properties(0).multi_processor_count \
        * WARPS_PER_SM
    per_warp = torch.bincount(units % warps, minlength=warps)
    return int(units.numel()), int((per_warp > 0).sum()), int(per_warp.max())


def probe(kind, args):
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_cuda
    fn = {"closest": bvh_cuda.trace_closest, "bounce": bvh_cuda.trace_bounce,
          "ao": bvh_cuda.ambient_occlusion}[kind]
    name = smoke.KERNELS[kind]["kernel"]
    h = args["rd"][..., 0] if kind == "closest" else \
        args["h0" if kind == "bounce" else "h"].t
    live = torch.ones_like(h, dtype=torch.bool) if args["active"] is None \
        else args["active"].expand(h.shape)
    dead = dict(args, active=torch.zeros(h.shape, dtype=torch.bool,
                                         device=h.device))
    nodes, tris = walks(kind, args)

    def stats(x):
        return (float(x.float().mean()) if x.numel() else 0.0,
                int(x.max()) if x.numel() else 0)
    return dict(call=kind, lanes=h.numel(), walks=nodes.numel(),
                kernel_ms=smoke.kernel_ms(lambda: fn(**args), name),
                dead_lanes_kernel_ms=smoke.kernel_ms(lambda: fn(**dead),
                                                     name),
                node_visits_mean_max=stats(nodes),
                tri_tests_mean_max=stats(tris),
                live_units_busy_warps_most_per_warp=live_units(kind, args,
                                                               live))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_walks: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    _, bvh = smoke.scene("cuda")
    calls = smoke.record_kernel_inputs(
        bvh, smoke.HEIGHT, smoke.WIDTH, "cuda", ("closest", "bounce", "ao"),
        "full", smoke.PROFILE_FRAME)
    for kind in ("closest", "bounce", "ao"):
        print(json.dumps(probe(kind, calls[kind][0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
