#!/usr/bin/env python3
"""The row-band renderer (opengl_raytracing_tpu_torch/parallel/) over the
cards of one host.

    python3 probe_sharded.py [--frames N]

For n = 1, 2 and 4 ranks (as many as the machine has cards), one NCCL
rank a card, each in a process of its own (`sharding.spawn_ranks`): the
bench's `full` (still camera) and `moving` chains of N frames (default
32) at 1920x1080 through `make_sharded_render_fn`, on each rank's band of
1080 / n rows, as chip_smoke.py's multi-card phase runs them
(`chip_smoke.sharded_rank`: a warm frame, then the chain with the launch
counters zeroed).  Then every rank renders one more `moving` and one more
`still` frame under torch.profiler.

Before the ranks, the same chains through the single-card
`render_frame` on card 0, timed the same way.  One JSON line for the
single card and one for each n: each chain's ms/frame on every rank
(host clock, ending in torch.cuda.synchronize), launches, mean
luminance; whether rank 0's gathered last frame and accumulation equal
the single card's bit for bit (required: it exits 1 otherwise); and
rank 0's profiled frames: device busy ms and the kernels by device time,
with the collectives' own (NCCL all-gather, the ring's send/recv,
all-reduce).  The card's name and power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import chip_smoke as smoke

PROFILE_TOP = 12  # kernel rows a profiled frame reports, and every NCCL row


def _profile(fn):
    """Device busy ms and kernel rows of one call of fn, by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    keep = [r for i, r in enumerate(rows)
            if i < PROFILE_TOP or "nccl" in r[2].lower()]
    return dict(device_busy_ms=sum(r[0] for r in rows),
                launches=sum(r[1] for r in rows),
                kernels=[dict(kernel=k[:90], calls=c, device_ms=ms)
                         for ms, c, k in keep])


def rank_chains(mesh, frames):
    """One rank: chip_smoke's multi-card chains, then one profiled
    `moving` and one `still` frame (every rank runs them: their
    collectives pair up)."""
    from opengl_raytracing_tpu_torch.models import RenderState, preset
    from opengl_raytracing_tpu_torch.parallel import (make_sharded_render_fn,
                                                      shard_image_rows)
    out = smoke.sharded_rank(mesh, frames)
    _, bvh = smoke.scene(mesh.device)
    params = preset("full").replace(enable_env_map=0)
    fn = make_sharded_render_fn(mesh, smoke.HEIGHT, smoke.WIDTH, use_bvh=True)
    for camera in ("moving", "still"):
        fin = list(smoke.frame_inputs(smoke.HEIGHT, smoke.WIDTH, 2,
                                      mesh.device, "full", camera))[-1]
        band = shard_image_rows(mesh, RenderState.create(
            smoke.HEIGHT, smoke.WIDTH, mesh.device))
        state = RenderState(band.accum, 5)  # a history to reproject
        fn(params, fin, state, None, bvh)   # warm
        out[camera]["profiled_frame"] = _profile(
            lambda: fn(params, fin, state, None, bvh))
    return out


def single_card(frames):
    """The chains through render_frame on card 0: ms/frame (one warm
    frame first), the last image and accumulation as numpy."""
    import torch
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn, preset)
    _, bvh = smoke.scene("cuda")
    params = preset("full").replace(enable_env_map=0)
    fn = make_render_fn(smoke.HEIGHT, smoke.WIDTH, "cuda", use_bvh=True)
    out = {}
    for camera in ("still", "moving"):
        fins = list(smoke.frame_inputs(smoke.HEIGHT, smoke.WIDTH, frames,
                                       "cuda", "full", camera))
        fn(params, fins[0], RenderState.create(smoke.HEIGHT, smoke.WIDTH,
                                               "cuda"), None, bvh)
        state = RenderState.create(smoke.HEIGHT, smoke.WIDTH, "cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        for fin in fins:
            state, o = fn(params, fin, state, None, bvh)
        torch.cuda.synchronize()
        out[camera] = dict(ms_per_frame=(time.time() - t0) / frames * 1e3,
                           image=o.image.cpu().numpy(),
                           accum=state.accum.cpu().numpy())
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_sharded: needs an NVIDIA card", file=sys.stderr)
        return 1
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    from opengl_raytracing_tpu_torch.parallel.sharding import spawn_ranks
    frames = smoke.FRAMES
    if "--frames" in sys.argv[1:]:
        frames = int(sys.argv[sys.argv.index("--frames") + 1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cuda_lib.build_all()
    cards = torch.cuda.device_count()
    ref = single_card(frames)
    print(json.dumps(dict(ranks=0, what="render_frame on card 0", card=smi,
                          frames=frames, ms_per_frame={
                              c: r["ms_per_frame"] for c, r in ref.items()})),
          flush=True)
    ok = True
    for n in (1, 2, 4):
        if n > cards:
            print(json.dumps(dict(ranks=n, skipped=f"{cards} cards")),
                  flush=True)
            continue
        t0 = time.time()
        results = spawn_ranks(rank_chains, n, frames, timeout=300.0)
        rec = dict(ranks=n, card=smi, frames=frames,
                   seconds=time.time() - t0)
        for camera, want in ref.items():
            got = results[0][camera]
            bitwise = bool(np.array_equal(got["image"], want["image"])
                           and np.array_equal(got["accum"], want["accum"]))
            ok = ok and bitwise
            rec[camera] = dict(
                bitwise=bitwise,
                ms_per_frame=[r[camera]["ms_per_frame"] for r in results],
                launches_rank0=got["launches"],
                mean_lum=got["mean_lum"][-1],
                profiled_frame_rank0=got["profiled_frame"])
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
