#!/usr/bin/env python3
"""What a torch.profiler window does to the run it measures (card only).

    python3 probe_profiler.py tax [case ...]   # default: baseline full
    python3 probe_profiler.py loss

`tax`: does a profiler window slow the frames that come after it in the
same process?  For each bench case (bench_torch.py's scenes, cameras and
chains), in a process of its own: a warm chain, five timed chains (A1),
five more (A2: the control, no profiler yet), one profiled window of 4
frames (CPU and CUDA activity, as bench_torch.py's), and five timed
chains after it (B).  One JSON line a case: the groups' ms/frame a chain,
their medians, and B's median over A2's.

`loss`: does a window see every launch made inside it?  WINDOWS windows
of REPS calls each, of two calls that launch one kernel each (the tonemap
kernel on a 1080p accumulation, and a PyTorch `add_`), in four variants
taken in turn: the bare window (as chip_smoke.py's device_rows takes it),
PAD_S of host sleep after the window opens, after the last call's
synchronize, or both.  One JSON line a call and variant: how many windows
saw how many device launches (REPS is a whole window).
"""

import collections
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FRAMES = 32
CHAINS = 5
WINDOWS = 40
REPS = 5
PAD_S = 0.005


def tax_case(case: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    import bench_torch as b
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.models import make_render_fn, preset
    device = b._device()
    params = preset(case)
    _, bvh = b._scene(device)
    cam = Camera()
    cam.aspect = b.W / b.H
    fins = b._still_fins(cam, params, FRAMES, device)
    # eager frames: the tax was measured on the frame's host launches
    render = make_render_fn(b.H, b.W, device, use_bvh=True, jit=False)
    args = (render, params, fins, None, bvh, b.H, b.W, device)

    def chains():
        return [b._chain(*args)[0] / FRAMES * 1e3 for _ in range(CHAINS)]

    b._chain(*args)  # warm
    a1, a2 = chains(), chains()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]):
        b._chain(render, params, fins[:4], None, bvh, b.H, b.W, device)
    after = chains()
    med = {k: statistics.median(v) for k, v in
           (("a1", a1), ("a2", a2), ("b", after))}
    return dict(case=case, a1=a1, a2=a2, b=after, median=med,
                b_over_a2=med["b"] / med["a2"],
                device=b._device_record(device))


def loss():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    import bench_torch as b
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.ops.svgf_cuda import tonemap
    device = b._device()
    gen = torch.Generator(device="cpu").manual_seed(0)
    accum = torch.rand((b.H, b.W, 4), generator=gen).to(device)
    x = torch.zeros(1024, device=device)
    params = preset("baseline")
    calls = {"tonemap": lambda: tonemap(accum, params),
             "add": lambda: x.add_(1.0)}
    variants = {"bare": (0, 0), "pad_open": (PAD_S, 0),
                "pad_close": (0, PAD_S), "pad_both": (PAD_S, PAD_S)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        seen = {v: collections.Counter() for v in variants}
        for _ in range(WINDOWS):
            for variant, (pre, post) in variants.items():
                with torch.profiler.profile(
                        activities=[ProfilerActivity.CUDA]) as prof:
                    time.sleep(pre)
                    for _ in range(REPS):
                        fn()
                    torch.cuda.synchronize()
                    time.sleep(post)
                n = sum(ev.count for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA)
                seen[variant][n] += 1
        for variant in variants:
            print(json.dumps(dict(call=name, variant=variant, reps=REPS,
                                  windows_by_launches=dict(seen[variant]),
                                  device=b._device_record(device))),
                  flush=True)


def main() -> int:
    if "--one" in sys.argv:
        print(json.dumps(tax_case(sys.argv[sys.argv.index("--one") + 1])),
              flush=True)
        return 0
    mode = sys.argv[1] if len(sys.argv) > 1 else "tax"
    if mode == "loss":
        loss()
        return 0
    rc = 0
    for case in sys.argv[2:] or ["baseline", "full"]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", case], stdout=subprocess.PIPE,
                              text=True)
        sys.stdout.write(proc.stdout)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
