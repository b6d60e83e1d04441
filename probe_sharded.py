#!/usr/bin/env python3
"""The row-band renderer (opengl_raytracing_tpu_torch/parallel/) over the
cards of one host, its compiled step beside its eager one.

    python3 probe_sharded.py [--frames N]

For n = 1, 2 and 4 ranks (as many as the machine has cards; with fewer
a line says which were left out), one NCCL rank a card, each in a process
of its own (`sharding.spawn_ranks`): the bench's `full` (still camera)
and `moving` chains of N frames (default 32) at 1920x1080 through
`make_sharded_render_fn`, on each rank's band of 1080 / n rows, as
chip_smoke.py runs them (`chip_smoke.sharded_frames`: a warm frame, then
the chain with the launch counters zeroed), four chains a camera in
turns: eager (`jit=False`), replayed (the compiled step, one CUDA graph a
rank with its collectives, parallel/graph.py), replayed, eager.  Then
every rank renders one more `moving` and one more `still` frame each way
under torch.profiler.

Before the ranks, the same chains through the single-card
`render_frame` (replayed) on card 0, timed the same way.  One JSON line
for the single card and one for each n: each chain's ms/frame on every
rank (host clock, ending in torch.cuda.synchronize), launches, mean
luminance; whether rank 0's gathered last frame and accumulation, eager
and replayed, equal the single card's bit for bit (required: it exits 1
otherwise); and rank 0's profiled frames both ways: device busy ms and
the kernels by device time, with the collectives' own rows (NCCL
all-gather, the ring's send/recv, all-reduce).  The card's name and
power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import chip_smoke as smoke

PROFILE_TOP = 12  # kernel rows a profiled frame reports, and every NCCL row
TURNS = (False, True, True, False)  # eager, replayed, replayed, eager


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
    """One rank: for each camera the chains of chip_smoke's multi-card
    phase in TURNS, then one profiled `moving` and one `still` frame each
    way (every rank runs them: their collectives pair up).  The last
    frame's gathered image and accumulation (rank 0) of the first eager
    and the first replayed chain."""
    from opengl_raytracing_tpu_torch.models import RenderState, graph, preset
    from opengl_raytracing_tpu_torch.parallel import (make_sharded_render_fn,
                                                      shard_image_rows)
    _, bvh = smoke.scene(mesh.device)
    params = preset("full").replace(enable_env_map=0)
    out = {}
    for camera in ("still", "moving"):
        runs = {False: [], True: []}
        for jit in TURNS:
            rec, image, accum = smoke.sharded_frames(mesh, bvh, "full",
                                                     camera, frames, jit=jit)
            runs[jit].append(dict(rec, image=image, accum=accum))
        out[camera] = {}
        for jit, name in ((False, "eager"), (True, "replayed")):
            first = runs[jit][0]
            out[camera][name] = dict(
                ms_per_frame=[r["ms_per_frame"] for r in runs[jit]],
                checksum=first["checksum"], launches=first["launches"],
                mean_lum=first["mean_lum"][-1],
                captures=sum(r["captures"] for r in runs[jit]),
                image=None if first["image"] is None
                else first["image"].cpu().numpy(),
                accum=None if first["accum"] is None
                else first["accum"].cpu().numpy())
    for camera in ("moving", "still"):
        fin = list(smoke.frame_inputs(smoke.HEIGHT, smoke.WIDTH, 2,
                                      mesh.device, "full", camera))[-1]
        for jit, name in ((False, "eager"), (True, "replayed")):
            fn = make_sharded_render_fn(mesh, smoke.HEIGHT, smoke.WIDTH,
                                        use_bvh=True, jit=jit)
            band = shard_image_rows(mesh, RenderState.create(
                smoke.HEIGHT, smoke.WIDTH, mesh.device))
            state = RenderState(band.accum, 5)  # a history to reproject
            fn(params, fin, state, None, bvh)   # warm (and the capture)
            out[camera][name]["profiled_frame"] = _profile(
                lambda: fn(params, fin, state, None, bvh))
    graph.clear()  # before the group, whose collectives the graphs hold
    return out


def single_card(frames):
    """The chains through render_frame (replayed) on card 0: ms/frame (one
    warm frame first), the last image and accumulation as numpy."""
    import torch
    from opengl_raytracing_tpu_torch.models import (RenderState, graph,
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
    graph.clear()
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
    if cards < 4:
        print(f"probe_sharded: the machine has {cards} card(s): n = "
              f"{[n for n in (1, 2, 4) if n > cards]} left out", flush=True)
    ref = single_card(frames)
    print(json.dumps(dict(ranks=0, what="render_frame replayed on card 0",
                          card=smi, frames=frames, ms_per_frame={
                              c: r["ms_per_frame"] for c, r in ref.items()})),
          flush=True)
    ok = True
    for n in (1, 2, 4):
        if n > cards:
            print(json.dumps(dict(ranks=n, skipped=f"{cards} cards")),
                  flush=True)
            continue
        t0 = time.time()
        results = spawn_ranks(rank_chains, n, frames, timeout=600.0)
        rec = dict(ranks=n, card=smi, frames=frames, turns="eager, replayed, "
                   "replayed, eager", seconds=time.time() - t0)
        for camera, want in ref.items():
            rec[camera] = {}
            for name in ("eager", "replayed"):
                got = results[0][camera][name]
                bitwise = bool(np.array_equal(got["image"], want["image"])
                               and np.array_equal(got["accum"],
                                                  want["accum"]))
                host = float((got["image"] @ np.float32(
                    [0.299, 0.587, 0.114])).mean())
                lum_ok = all(abs(r[camera][name]["mean_lum"] - host) < 1e-4
                             for r in results)
                ok = ok and bitwise and lum_ok
                rec[camera][name] = dict(
                    bitwise=bitwise, mean_lum_within_1e_4=lum_ok,
                    ms_per_frame=[r[camera][name]["ms_per_frame"]
                                  for r in results],
                    captures=[r[camera][name]["captures"] for r in results],
                    launches_rank0=got["launches"],
                    mean_lum=got["mean_lum"],
                    profiled_frame_rank0=got["profiled_frame"])
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
