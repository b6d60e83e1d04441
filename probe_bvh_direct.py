#!/usr/bin/env python3
"""Where the BVH direct-light kernel's time goes, on one NVIDIA card.

    python3 probe_bvh_direct.py

A probe for work on the walk latency of `bvh_direct_kernel`, not part
of the smoke run.  On the arguments of the baseline frame's
direct-light call and of the `full` frame's bounce call (third frame of
a 1080p chain), it prints one JSON line each with the kernel's device
time (profiler) as the frame calls it, with no lane live (what the dead
lanes cost), and on the live lanes alone packed into a grid of their
own; and the node visits of each pixel's six walks as the plain walk
makes them, in the order the pixel's thread makes them: the mean over
the live lanes and the longest chain.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import chip_smoke as smoke


def live_lanes_only(args, live):
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


def node_visits_per_pixel(args):
    """Node visits of each pixel's open windows, summed over its walks."""
    import torch
    from opengl_raytracing_tpu_torch.ops import bvh_traverse
    from opengl_raytracing_tpu_torch.ops import lighting as lt
    from opengl_raytracing_tpu_torch.ops.vecmath import normalize
    h, scene = args["h"], args["scene"]
    shape, n_px = h.t.shape, h.t.numel()
    offs = lt._disk_offsets(args["rng_frame"], args["frame_index"],
                            args["px"], args["py"])
    o, d, w = lt._bvh_shadow_queries(scene, h, normalize(h.n), offs,
                                     args["active"])
    w = torch.cat([x.expand(shape).reshape(-1) for x in w])
    walked = w > 0.0
    per_ray = torch.zeros(int(walked.sum()), dtype=torch.int64,
                          device=h.t.device)
    count = bvh_traverse._count

    def count_per_ray(counts, lane, cnt, li):
        count(counts, lane, cnt, li)
        per_ray[lane] += 1
    bvh_traverse._count = count_per_ray
    try:
        bvh_traverse.trace_bvh_shadow(
            scene.bvh.arrays,
            torch.cat([x.expand(shape + (3,)).reshape(-1, 3)
                       for x in o])[walked],
            torch.cat([x.expand(shape + (3,)).reshape(-1, 3)
                       for x in d])[walked],
            w[walked])
    finally:
        bvh_traverse._count = count
    per_px = torch.zeros(n_px, dtype=torch.int64, device=h.t.device)
    per_px.index_add_(0, walked.nonzero().squeeze(1) % n_px, per_ray)
    return per_px


def probe(label, args):
    import torch
    from opengl_raytracing_tpu_torch.ops import an_cuda
    name = smoke.KERNELS["bvh_direct"]["kernel"]
    active = args["active"]
    live = torch.ones_like(args["h"].t, dtype=torch.bool) if active is None \
        else active
    dead = dict(args, active=torch.zeros_like(live))
    packed = live_lanes_only(args, live)
    per_px = node_visits_per_pixel(args)[live.reshape(-1)]

    def kernel_ms(a):
        return smoke.kernel_ms(lambda: an_cuda.direct_light_bvh(**a), name)
    return dict(call=label, pixels=live.numel(), live_lanes=int(live.sum()),
                kernel_ms=kernel_ms(args),
                dead_lanes_kernel_ms=kernel_ms(dead),
                live_lanes_kernel_ms=kernel_ms(packed),
                node_visits_mean_per_live_lane=(
                    float(per_px.float().mean()) if per_px.numel() else 0.0),
                node_visits_max_per_lane=(
                    int(per_px.max()) if per_px.numel() else 0))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_bvh_direct: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    _, bvh = smoke.scene("cuda")
    base = smoke.record_kernel_inputs(bvh, smoke.HEIGHT, smoke.WIDTH, "cuda",
                                      ("bvh_direct",))["bvh_direct"][0]
    bounce = smoke.record_kernel_inputs(
        bvh, smoke.HEIGHT, smoke.WIDTH, "cuda", ("bvh_direct",), "full",
        smoke.PROFILE_FRAME)["bvh_direct"][1]
    for label, args in (("baseline", base), ("full_bounce", bounce)):
        print(json.dumps(probe(label, args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
