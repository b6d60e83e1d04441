#!/usr/bin/env python3
"""What a torch.profiler window does to the run it measures (card only).

    python3 probe_profiler.py tax [case ...]   # default: baseline full
    python3 probe_profiler.py loss
    python3 probe_profiler.py scale [--windows N] [--seconds S] [--log F]

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

`scale`: when a window reads a kernel's launches at a time unlike the
other windows', did the card run them faster or slower, or does the
window misread its clock?  Five recorded calls, as chip_smoke.py's phases
record them (the third frame of a chain): the BVH `full` frame's bounce
(trace_bounce_kernel, bound by its walks, not by memory) and hit mix,
an_full's primary sky and mirror mix (1080p, the day-sky cubemap) and
an_baseline's hit mix (800x600).  Each window is chip_smoke.kernel_ms's
(PROFILE_LEAD throwaway launches and a synchronize, then REPS calls and a
synchronize), with two yardsticks (spin_timed: a spin of YARD_CYCLES
cycles between two CUDA events), one after the throwaway launches and
one after the calls, and the calls themselves between two CUDA events.
Per window: the kernel's launches counted, its time a launch (the rows'
self time, their total, and each launch's own span), each yardstick as
the profiler reads it and as its events read it, the calls' span as the
profiler reads it (first device start to last device end) and as their
events read it, and the card's SM and memory clocks and power after the
window (nvidia-smi).  The calls go round in turns, WINDOWS_SCALE windows
each or until `--seconds` pass.  Every window goes to `--log` (default
out/probe_profiler_scale.jsonl), a JSON line each; stdout gets one a
call: its windows, how many counted the launches they timed, the median
time a launch of those, the range of the yardsticks' profiler / event
ratio over them, how many windows read their last yardstick off its
events by more than YARD_TOL, how many of the windows whose time a
launch is off that median by more than OFF do and do not, and each such
window with its yardsticks', its span's and its clocks' readings.
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
OFF = 0.25             # scale: a window this far off its call's median
YARD_CYCLES = 100_000  # scale: a yardstick spins this many (~50 us)
YARD_TOL = 1.1         # scale: a yardstick read within this of its events
WINDOWS_SCALE = 150    # scale's windows a call


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


def scale_calls():
    """{name: (kernel, fn)}: the recorded calls `scale` times."""
    import chip_smoke as cs
    import probe_kernel_turns as pkt
    from opengl_raytracing_tpu_torch.ops import bvh_cuda
    bvh = cs.scene("cuda")[1]
    env = cs.sky_day("cuda")
    full = cs.record_kernel_inputs(bvh, cs.HEIGHT, cs.WIDTH, "cuda",
                                   ("bounce", "bvh_hit_mix"), "full",
                                   cs.PROFILE_FRAME)
    an_full = cs.record_kernel_inputs(None, cs.HEIGHT, cs.WIDTH, "cuda",
                                      ("sky", "mirror_mix"), "full",
                                      cs.PROFILE_FRAME, env=env)
    an_base = cs.record_kernel_inputs(None, cs.AN_HEIGHT, cs.AN_WIDTH,
                                      "cuda", ("an_hit_mix",), "baseline",
                                      cs.PROFILE_FRAME)
    bounce = full["bounce"][0]
    return {
        "full_bounce": (cs.KERNELS["bounce"]["kernel"],
                        lambda: bvh_cuda.trace_bounce(**bounce)),
        "full_bvh_hit_mix": (
            cs.KERNELS["bvh_hit_mix"]["kernel"],
            pkt.gate_caller(cs, "bvh_hit_mix", full["bvh_hit_mix"][0])),
        "an_full_sky_0": (cs.KERNELS["sky"]["kernel"],
                          pkt.gate_caller(cs, "sky", an_full["sky"][0])),
        "an_full_mirror_mix": (
            cs.KERNELS["mirror_mix"]["kernel"],
            pkt.gate_caller(cs, "mirror_mix", an_full["mirror_mix"][0])),
        "an_baseline_an_hit_mix": (
            cs.KERNELS["an_hit_mix"]["kernel"],
            pkt.gate_caller(cs, "an_hit_mix", an_base["an_hit_mix"][0])),
    }


def clocks():
    """The card's SM and memory clocks (MHz) and power draw (W) now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                          "power.draw", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def spin_timed(cycles):
    """A spin of `cycles` cycles on the card (chip_smoke.LEAD_KERNEL)
    between two CUDA events, behind a spin of a fifth as many.  Returns a
    function that gives the events' time in us once the card has
    synchronized.  The events' time holds the host's time to queue the
    events and the spin wherever it outlasts the first spin (~10 us at
    YARD_CYCLES): PERF.md section 6 reads it so."""
    import torch
    torch.cuda._sleep(cycles // 5)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    return lambda: start.elapsed_time(end) * 1e3


def scale_window(kernel, fn):
    """One of chip_smoke.kernel_ms's windows of REPS calls of `fn` (its
    throwaway launches, the calls), with a yardstick after the throwaway
    launches and one after the calls, and the calls between two CUDA
    events; returns its record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    import chip_smoke as cs
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.throwaway_launches(cs.PROFILE_LEAD)
        torch.cuda.synchronize()
        first = spin_timed(YARD_CYCLES)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(REPS):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        last = spin_timed(YARD_CYCLES)
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA and cs.is_kernel(r.key,
                                                                 kernel)]
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    # the yardsticks: the long spins, not the throwaway launches or the
    # short spins that keep the card busy before them
    every = [e for e in dev if cs.is_kernel(e.name, cs.LEAD_KERNEL)]
    longest = max((e.time_range.elapsed_us() for e in every), default=0.0)
    spins = [e for e in every if e.time_range.elapsed_us() > 0.5 * longest]
    mine = [e for e in dev if cs.is_kernel(e.name, kernel)]
    n = sum(r.count for r in rows)
    rec = dict(launches=n, want=REPS,
               self_us=sum(r.self_device_time_total for r in rows) / n
               if n else None,
               total_us=sum(r.device_time_total for r in rows) / n
               if n else None,
               each_us=[e.time_range.elapsed_us() for e in mine],
               spin_prof_us=[e.time_range.elapsed_us() for e in spins],
               spin_event_us=[first(), last()],
               calls_event_us=ev[0].elapsed_time(ev[1]) * 1e3,
               spins_seen=len(every))
    if len(spins) == 2:
        lo, hi = spins[0].time_range.end, spins[1].time_range.start
        calls = [e for e in dev if e.time_range.start >= lo
                 and e.time_range.end <= hi
                 and not cs.is_kernel(e.name, cs.LEAD_KERNEL)]
        if calls:
            rec["calls_prof_us"] = (calls[-1].time_range.end
                                    - calls[0].time_range.start)
    else:
        rec["device_names"] = sorted({e.name[:80] for e in dev})
    return rec


def scale(windows, seconds, log):
    import torch
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    calls = scale_calls()
    for _, fn in calls.values():
        fn()
    torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(log)), exist_ok=True)
    taken = {name: [] for name in calls}
    t0 = time.time()
    with open(log, "w") as fh:
        for w in range(windows):
            if time.time() - t0 > seconds:
                break
            for name, (kernel, fn) in calls.items():
                rec = dict(call=name, window=w, **scale_window(kernel, fn),
                           clocks=clocks())
                taken[name].append(rec)
                fh.write(json.dumps(rec) + "\n")
    for name, recs in taken.items():
        exact = [r for r in recs if r["launches"] == REPS]
        med = statistics.median(r["self_us"] for r in exact)
        ratios = [p / e for r in exact
                  for p, e in zip(r["spin_prof_us"], r["spin_event_us"])
                  if len(r["spin_prof_us"]) == 2]
        off = [dict(window=r["window"], ratio=r["self_us"] / med,
                    total_over_self=r["total_us"] / r["self_us"],
                    each_us=r["each_us"],
                    spin_ratio=[p / e for p, e in zip(r["spin_prof_us"],
                                                      r["spin_event_us"])],
                    calls_ratio=(r.get("calls_prof_us", 0.0)
                                 / r["calls_event_us"]),
                    clocks=r["clocks"])
               for r in exact if abs(r["self_us"] / med - 1.0) > OFF]
        # a test of a window's clock: its last yardstick
        clock_ok = {r["window"]: len(r["spin_prof_us"]) == 2
                    and 1 / YARD_TOL
                    <= r["spin_prof_us"][1] / r["spin_event_us"][1]
                    <= YARD_TOL for r in exact}
        off_at = {o["window"] for o in off}
        print(json.dumps(dict(
            call=name, kernel=calls[name][0], windows=len(recs),
            exact=len(exact), short=sum(r["launches"] < REPS for r in recs),
            extra=sum(r["launches"] > REPS for r in recs),
            median_us=med, spin_ratio_range=[min(ratios), max(ratios)]
            if ratios else None,
            clock_off=sum(not ok for ok in clock_ok.values()),
            off_clock_off=sum(not clock_ok[w] for w in off_at),
            off_clock_ok=sum(clock_ok[w] for w in off_at),
            off=off, device=smi)), flush=True)
    print(f"scale: {sum(map(len, taken.values()))} windows in "
          f"{time.time() - t0:.1f} s; every window in {log}", flush=True)


def main() -> int:
    if "--one" in sys.argv:
        print(json.dumps(tax_case(sys.argv[sys.argv.index("--one") + 1])),
              flush=True)
        return 0
    mode = sys.argv[1] if len(sys.argv) > 1 else "tax"
    if mode == "scale":
        import argparse
        ap = argparse.ArgumentParser(prog="probe_profiler.py scale")
        ap.add_argument("--windows", type=int, default=WINDOWS_SCALE)
        ap.add_argument("--seconds", type=float, default=360.0)
        ap.add_argument("--log", default=os.path.join(
            ROOT, "out", "probe_profiler_scale.jsonl"))
        args = ap.parse_args(sys.argv[2:])
        import torch
        if not torch.cuda.is_available():
            print("probe_profiler: no card", file=sys.stderr)
            return 1
        scale(args.windows, args.seconds, args.log)
        return 0
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
