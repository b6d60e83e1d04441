#!/usr/bin/env python3
"""Benchmark matrix of the PyTorch/CUDA port on one NVIDIA card.

    python3 bench_torch.py                          # the nine cases
    BENCH_CASES=realistic python3 bench_torch.py    # one case alone

The counterpart of bench.py, function by function under the same names:
every preset the reference reports (baseline/realistic/full/heavy,
OpenGL_RTGP_RayTracing.pdf p.16 Tables 1-2), the analytic scene's
an_baseline (800x600) and an_full (day-sky cubemap), the BVH-heavy
close/far camera pair (81,920 triangles) and the moving camera, each
printed as one JSON line as it lands.  The LAST line is the headline
record (the baseline preset) with the whole matrix embedded:

  {"metric": "...", "value": N, "unit": "Mrays/s", "vs_baseline": N,
   "presets": {...}, "close_far": {...}}

Each case renders through the port's frame function (`make_render_fn`)
in a host loop, its headline the compiled frame (`jit`: on the card the
frame's CUDA graph, captured once and replayed, the counterpart of
bench.py's jitted chain; on the CPU the eager frame): one warm chain of
BENCH_FRAMES frames (the capture), one warm eager chain, then five timed
chains of the compiled frame and EAGER_CHAINS of the eager one in turns,
each from a fresh RenderState with its frames' inputs built before the
clock, timed by the host clock from the first call to
`torch.cuda.synchronize()`.  `ms_per_frame` is the median of the five
(`ms_per_frame_runs`, `spread` = max / min beside it),
`ms_per_frame_eager` the eager chains' median (`ms_per_frame_eager_runs`);
the checksum is the sum of every frame's `image.sum()`, as bench.py and
chip_smoke.py form it, and every chain, eager or not, must give the same
bits.  After the timed chains, and never part of them, a case line adds
the card (`device`), `jit`, the captures the case made (`captures`) and
the device memory its graphs hold (`graph_pool_mb`), the hand-written
kernels' launches a frame over one timed chain (`kernel_launches`, from
ops/cuda_lib.py's counters, which a replay adds to), the peak of
allocated device memory over that chain (`peak_mem_mb`) and a
torch.profiler window over the last PROFILE_FRAMES frames of one more
compiled chain: device ms and launches (kernels and copies on the card)
a frame, the host's `cudaLaunchKernel` and `cudaGraphLaunch` calls a
frame, the idle share of the median frame time and the TOP_OPS device
operations by time.  Where the profiler sees no device time those are
null, with a `profile_note`.
A profiler window can leave the launches after it in its process slower
(probe_profiler.py tax), so a child times every case of its group
before it profiles any.

Each family of cases runs in a child process of its own under a timeout
(BENCH_TIMEOUT a case); the child's stderr is passed through and its
last informative line goes into the error of each case it left without
a line.  The parent checks for the card and builds the kernels and the
g++ host library before it starts any child.  A case that fails is an
error, and the run then exits non-zero after its last line.

Env knobs (bench.py's): BENCH_FRAMES (32), BENCH_HEIGHT / BENCH_WIDTH
(1080 / 1920), BENCH_PRESET (headline, baseline), BENCH_CASES (comma
list), BENCH_TIMEOUT (seconds a case, 480), BENCH_BUDGET (seconds of
the whole run, 900), BENCH_FORCE_CPU=1 (run on the CPU, for the tests:
every line then says "platform": "cpu"), BENCH_AN_ENV=0 (an_full under
the gradient sky), BENCH_MOVING_MODE (full / yaw / dolly / still),
BENCH_MOVING_PRESET, BENCH_MOVING_TAA=0.  Without a card and without
BENCH_FORCE_CPU=1 the run prints an error line and exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_MRAYS = 300.0  # reference RTX 5090 derived primary throughput

H = int(os.environ.get("BENCH_HEIGHT", "1080"))
W = int(os.environ.get("BENCH_WIDTH", "1920"))
FRAMES = int(os.environ.get("BENCH_FRAMES", "32"))
PRESET = os.environ.get("BENCH_PRESET", "baseline")
TIMEOUT_S = int(os.environ.get("BENCH_TIMEOUT", "480"))
BUDGET_S = int(os.environ.get("BENCH_BUDGET", "900"))

TIMED_CHAINS = 5      # timed chains a case, after one warm chain
EAGER_CHAINS = 3      # timed chains of the eager frame, in turns
PROFILE_FRAMES = 4    # the profiled window: the last frames of a chain
PROFILE_ATTEMPTS = 3  # profiled chains before the profile reads null
TOP_OPS = 8           # device operations listed by time
# a group whose children hit their timeout twice in a row shortens the
# timeout of the groups after it to this many seconds
SHORT_TIMEOUT_S = 180

PRESET_CASES = ["baseline", "realistic", "full", "heavy"]
CASES = PRESET_CASES + ["an_baseline", "an_full",
                        # the cheap far camera before the close one
                        "cf_far", "cf_close", "moving"]

# BVH-heavy stress scene: 81,920-tri displaced icosphere (the reference's
# "BVH-heavy" rows are high-poly meshes at 1080p, pdf p.16).
HEAVY_SUBDIV = 6
CLOSE_POS = (-2.0, 1.6, 1.2)
FAR_POS = (0.0, 2.0, 8.0)
LOOK_AT = (-2.0, 1.5, 0.0)
# JAX's ordered_primary auto resolves to 0 on every camera
# (ORDERED_AUTO_FACTOR = 0.0); the port has one walk and reads none
ORDERED_PRIMARY = 0


def _device():
    """The device the cases run on: the CPU under BENCH_FORCE_CPU=1, else
    the card; without one this raises: the bench never falls back."""
    import torch
    if os.environ.get("BENCH_FORCE_CPU") == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "false) and BENCH_FORCE_CPU is not 1")
    return torch.device("cuda", torch.cuda.current_device())


def _device_record(device) -> dict:
    """The `device` key of a case line."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None,
                "count": torch.cuda.device_count()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "power_limit": smi.splitlines()[0].rsplit(",", 1)[-1].strip(),
            "count": torch.cuda.device_count()}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scene(device, subdiv: int = 4):
    from opengl_raytracing_tpu_torch.constants import (DEFAULT_BVH_SCALE,
                                                       DEFAULT_BVH_TRANSLATE)
    from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
    from opengl_raytracing_tpu_torch.scene import (gather_triangles,
                                                   make_bunny,
                                                   model_transform)
    tris = gather_triangles(make_bunny(subdiv),
                            model_transform(DEFAULT_BVH_TRANSLATE,
                                            DEFAULT_BVH_SCALE))
    return tris, prepare_bvh(tris, device)


def _fin(cam, device, frame_index, jitter=(0.0, 0.0), prev_view_proj=None,
         moved=0):
    """FrameInputs of the camera's pose for frame `frame_index` (its
    block staged with that index: a chain's frame makes no copy of its
    own); `moved` fills the device flag and the host one, so a still
    camera (0) runs TAA's still path."""
    from opengl_raytracing_tpu_torch.convert import camera_frame_inputs
    return camera_frame_inputs(cam, device, jitter=jitter,
                               prev_view_proj=prev_view_proj, moved=moved,
                               frame_index=frame_index)


def _still_fins(cam, params, frames, device):
    """`frames` FrameInputs of a still camera with the Halton jitter
    scaled by jitter_still_scale (bench.py:_run_frames)."""
    from opengl_raytracing_tpu_torch.sampling import generate_jitter2d
    return [_fin(cam, device, i,
                 jitter=generate_jitter2d(i) * params.jitter_still_scale)
            for i in range(frames)]


def _chain(render, params, fins, env_map, bvh, height, width, device):
    """One chain from a fresh state: (seconds from the first call to the
    card's synchronize, checksum)."""
    import torch
    from opengl_raytracing_tpu_torch.models import RenderState
    state = RenderState.create(height, width, device)
    sums = []
    _sync(device)
    t0 = time.perf_counter()
    for fin in fins:
        state, out = render(params, fin, state, env_map, bvh)
        sums.append(out.image.sum())
    _sync(device)
    sec = time.perf_counter() - t0
    return sec, float(torch.stack(sums).sum())


def _run_frames(params, bvh, fins, height, width, device, *, use_bvh=True,
                env_map=None):
    """Warm chain and five timed chains of the frames `fins`; returns
    (seconds a frame, the median chain's, checksum, the keys a case line
    adds to bench.py's).  The profiled window is deferred: `_finish` takes
    it into the record."""
    import torch
    from opengl_raytracing_tpu_torch.models import graph, make_render_fn
    from opengl_raytracing_tpu_torch.ops.cuda_lib import LAUNCHES
    frames = len(fins)
    render = make_render_fn(height, width, device, use_bvh=use_bvh)
    eager = make_render_fn(height, width, device, use_bvh=use_bvh,
                           jit=False)
    args = (render, params, fins, env_map, bvh, height, width, device)
    eager_args = (eager,) + args[1:]
    graph.clear()
    captures = graph.STATS["captures"]
    _chain(*args)  # warm: the capture
    pool_mb = graph.stats()["pool_bytes"] / 2**20
    _chain(*eager_args)  # warm
    # the launch counters and the memory peak over the first timed chain
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timed = [_chain(*args)]
    launches = {k: v / frames for k, v in LAUNCHES.items()}
    peak_mb = (torch.cuda.max_memory_allocated(device) / 2**20
               if device.type == "cuda" else None)
    # the rest in turns: eager, compiled, eager, compiled, ...
    timed_eager = []
    while len(timed) < TIMED_CHAINS or len(timed_eager) < EAGER_CHAINS:
        if len(timed_eager) < EAGER_CHAINS:
            timed_eager.append(_chain(*eager_args))
        if len(timed) < TIMED_CHAINS:
            timed.append(_chain(*args))
    runs = [sec / frames for sec, _ in timed]
    eager_runs = [sec / frames for sec, _ in timed_eager]
    checksums = [checksum for _, checksum in timed + timed_eager]
    if len(set(checksums)) != 1 or not math.isfinite(checksums[0]):
        raise RuntimeError(f"the timed chains' checksums differ or are not "
                           f"finite (the compiled chains first): "
                           f"{checksums}")
    sec = statistics.median(runs)
    extra = dict(
        ms_per_frame_runs=[round(r * 1e3, 4) for r in runs],
        spread=round(max(runs) / min(runs), 4),
        ms_per_frame_eager=round(statistics.median(eager_runs) * 1e3, 4),
        ms_per_frame_eager_runs=[round(r * 1e3, 4) for r in eager_runs],
        device=_device_record(device),
        jit=device.type == "cuda",
        captures=graph.STATS["captures"] - captures,
        graph_pool_mb=round(pool_mb, 1),
        kernel_launches={k: int(v) if v == int(v) else v
                         for k, v in launches.items()},
        peak_mem_mb=None if peak_mb is None else round(peak_mb, 1),
        _profile=lambda: _profile(args, sec * 1e3))
    return sec, checksums[0], extra


def _finish(rec: dict) -> dict:
    """Take a record's profiled window (deferred by _run_frames) into it."""
    window = rec.pop("_profile", None)
    if window is not None:
        rec.update(window())
    return rec


def _profile(args, frame_ms) -> dict:
    """torch.profiler over the last PROFILE_FRAMES frames of one more chain
    (replayed frames on the card): device ms and launches a frame, the
    host's kernel launch and graph launch calls a frame, the idle share of
    the unprofiled median frame time `frame_ms`, and the TOP_OPS device
    operations.  A window with no device time is taken again, up to
    PROFILE_ATTEMPTS times, then reads null."""
    import torch
    from torch.profiler import ProfilerActivity
    from opengl_raytracing_tpu_torch.models import RenderState
    from opengl_raytracing_tpu_torch.utils.profiling import device_activity
    render, params, fins, env_map, bvh, height, width, device = args
    null = dict(device_ms=None, launches=None, idle=None, top_ops=None,
                profile_window_ms=None, host_kernel_launches=None,
                host_graph_launches=None)
    if device.type != "cuda":
        return dict(null, profile_note="not measured: no card")
    window = fins[-PROFILE_FRAMES:]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        state = RenderState.create(height, width, device)
        for fin in fins[:-len(window)]:
            state, _ = render(params, fin, state, env_map, bvh)
        _sync(device)
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for fin in window:
                state, _ = render(params, fin, state, env_map, bvh)
            _sync(device)
            window_ms = (time.perf_counter() - t0) * 1e3 / len(window)
        act = device_activity(prof, len(window), TOP_OPS)
        if act is not None:
            calls = {ev.key: ev.count / len(window)
                     for ev in prof.key_averages()}
            return dict(device_ms=round(act["device_ms"], 4),
                        launches=act["launches"],
                        host_kernel_launches=calls.get("cudaLaunchKernel",
                                                       0.0),
                        host_graph_launches=calls.get("cudaGraphLaunch",
                                                      0.0),
                        idle=round(1.0 - act["device_ms"] / frame_ms, 4),
                        top_ops=act["top_ops"],
                        profile_window_ms=round(window_ms, 4),
                        profile_attempts=attempt)
    return dict(null, profile_attempts=PROFILE_ATTEMPTS,
                profile_note=f"not measured: the profiler saw no device "
                             f"time in {PROFILE_ATTEMPTS} windows")


def measure_preset(height, width, frames, preset_name) -> dict:
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.utils.profiling import RayCounter

    device = _device()
    params = preset(preset_name)
    spp = params.spp_per_frame
    _, bvh = _scene(device)
    cam = Camera()
    cam.aspect = width / height

    sec, checksum, extra = _run_frames(
        params, bvh, _still_fins(cam, params, frames, device), height,
        width, device)
    # PRIMARY rays are traced once per pixel regardless of spp; per-sample
    # work shows up in total_mrays_per_s (bench.py:181-185)
    mrays = height * width / sec / 1e6
    total = RayCounter(height, width).rays_per_frame(params)["total"]
    return {
        "metric": (f"primary Mrays/s/chip, bunny BVH scene, "
                   f"{width}x{height} {spp}spp, preset={preset_name}"),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "ms_per_frame": round(sec * 1e3, 2),
        "fps": round(1.0 / sec, 1),
        "total_mrays_per_s": round(total / sec / 1e6, 1),
        "frames": frames,
        "checksum": checksum,
        **extra,
    }


def measure_closefar(height, width, frames, case) -> dict:
    """BVH-heavy scene (81,920 tris), baseline preset, close/far camera."""
    import numpy as np
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.models import preset

    device = _device()
    params = preset("baseline")
    tris, bvh = _scene(device, HEAVY_SUBDIV)
    pos = CLOSE_POS if case == "close" else FAR_POS

    cam = Camera(position=np.asarray(pos, np.float32))
    cam.aspect = width / height
    cam.point_at(LOOK_AT)

    sec, checksum, extra = _run_frames(
        params, bvh, _still_fins(cam, params, frames, device), height,
        width, device)
    return {
        "metric": (f"BVH-heavy ({tris.shape[0]} tris) camera-{case}, "
                   f"{width}x{height} 1spp, preset=baseline"),
        "ms_per_frame": round(sec * 1e3, 2),
        "fps": round(1.0 / sec, 1),
        "mrays": round(height * width / sec / 1e6, 2),
        "ordered_primary": ORDERED_PRIMARY,
        "frames": frames,
        "checksum": checksum,
        **extra,
    }


def measure_analytic(height, width, frames, case) -> dict:
    """an_baseline = analytic scene, BVH off, 800x600, baseline preset;
    an_full = the full preset under the day-sky cubemap (the uint8 table
    bench.py builds) at the requested size; BENCH_AN_ENV=0 drops the
    cubemap for the gradient sky."""
    import numpy as np
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.utils.image import load_cubemap_cross

    device = _device()
    if case == "an_baseline":
        params, env, h, w = preset("baseline"), None, 600, 800
    else:
        params = preset("full")
        h, w = height, width
        env = None
        cross = os.path.join(ROOT, "cubemaps", "sky_day.png")
        if (os.path.exists(cross)
                and os.environ.get("BENCH_AN_ENV", "1") == "1"):
            faces = load_cubemap_cross(cross)
            env = env_from_numpy(np.clip(np.round(faces * 255.0), 0.0,
                                         255.0).astype(np.uint8), device)
    cam = Camera()
    cam.aspect = w / h
    sec, checksum, extra = _run_frames(
        params, None, _still_fins(cam, params, frames, device), h, w,
        device, use_bvh=False, env_map=env)
    spp = params.spp_per_frame
    return {
        "metric": (f"analytic scene ({'full+env' if env is not None else 'baseline'}), "
                   f"{w}x{h} {spp}spp"),
        "ms_per_frame": round(sec * 1e3, 2),
        "fps": round(1.0 / sec, 1),
        "mrays": round(h * w / sec / 1e6, 2),  # primary (spp-invariant)
        "frames": frames,
        "checksum": checksum,
        **extra,
    }


def measure_moving(height, width, frames) -> dict:
    """The full preset with a moving camera: every frame has a fresh
    view-projection and camera_moved = 1, so TAA takes its reprojection
    path and SVGF its motion-aware weights.  BENCH_MOVING_MODE: "full"
    (yaw + dolly-in), "yaw", "dolly", or "still" (a frozen camera that
    still says it moved: TAA's reprojection path without the geometry's
    change).  BENCH_MOVING_PRESET and BENCH_MOVING_TAA=0 attribute the
    cost by stage."""
    import numpy as np
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.sampling import generate_jitter2d

    mode = os.environ.get("BENCH_MOVING_MODE", "full")
    if mode not in ("full", "yaw", "dolly", "still"):
        raise SystemExit(f"unknown BENCH_MOVING_MODE {mode!r}")
    device = _device()
    params = preset(os.environ.get("BENCH_MOVING_PRESET", "full"))
    if os.environ.get("BENCH_MOVING_TAA") == "0":
        params = params.replace(enable_taa=0)
    _, bvh = _scene(device)
    cam = Camera()
    cam.aspect = width / height
    fins = []
    prev_vp = cam.view_projection()
    for f in range(frames):
        if mode in ("full", "yaw"):
            cam.yaw += 0.4                  # slow look sweep
        if mode in ("full", "dolly"):
            cam.position = (cam.position
                            + np.asarray([0.0, 0.0, -0.05], np.float32))
        # moved=1 in every mode, "still" too: the host flag must send TAA
        # down its reprojection path, as the device flag does
        fins.append(_fin(cam, device, f, prev_view_proj=prev_vp, moved=1,
                         jitter=generate_jitter2d(f)
                         * params.jitter_moving_scale))
        prev_vp = cam.view_projection()

    sec, checksum, extra = _run_frames(params, bvh, fins, height, width,
                                       device)
    return {
        "metric": (f"moving-camera full pipeline (TAA reproj + SVGF), "
                   f"{width}x{height} 1spp, bunny BVH"
                   + ("" if mode == "full" else f", mode={mode}")),
        "ms_per_frame": round(sec * 1e3, 2),
        "fps": round(1.0 / sec, 1),
        "mrays": round(height * width / sec / 1e6, 2),
        "frames": frames,
        "checksum": checksum,
        **extra,
    }


def _measure_one(case: str) -> dict:
    if case in PRESET_CASES:
        return measure_preset(H, W, FRAMES, case)
    if case in ("an_baseline", "an_full"):
        return measure_analytic(H, W, FRAMES, case)
    if case == "moving":
        return measure_moving(H, W, FRAMES)
    if case in ("cf_close", "cf_far"):
        return measure_closefar(H, W, FRAMES, case.replace("cf_", ""))
    raise SystemExit(f"unknown bench case {case!r}")


def child(cases: str) -> None:
    """Run a comma-joined group of cases in this process: every case's
    timed chains, then every case's profiled window, each case's JSON
    line flushed when its window is done.  A torch.profiler window can
    leave the launches after it in its process slower (probe_profiler.py
    tax), so no timed chain comes after one.  A case that raises gets an
    error line (its traceback on stderr) and the group goes on."""
    import traceback
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def attempt(fn, *args):
        try:
            return fn(*args)
        except Exception as exc:
            traceback.print_exc()
            return {"error": f"{type(exc).__name__}: {exc}"[:300]}
    timed = [(case, attempt(_measure_one, case))
             for case in cases.split(",")]
    for case, rec in timed:
        rec = attempt(_finish, rec)
        rec["case"] = case
        print(json.dumps(rec), flush=True)


def _informative_line(stderr_lines) -> str:
    """The last line of a child's stderr that names an error, else its
    last line."""
    lines = [ln.strip() for ln in stderr_lines if ln.strip()]
    for ln in reversed(lines):
        if any(p in ln for p in ("Error", "error", "Exception", "unknown",
                                 "failed", "Killed")):
            return ln[-300:]
    return lines[-1][-300:] if lines else ""


def _run_group(cases, timeout_s: float, on_line):
    """Run one child for a case group, passing its stderr through and
    calling on_line(case, rec) as each case line lands.  Returns
    ({case: rec} for every case of the group, whether the child hit its
    timeout).  A case the child left without a line gets an error: the
    timeout, or the child's exit code and its last informative stderr
    line."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         ",".join(cases)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    err_lines, timed_out = [], threading.Event()

    def drain():
        for line in proc.stderr:
            err_lines.append(line)
            sys.stderr.write(line)
        sys.stderr.flush()

    def kill():
        timed_out.set()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    timer = threading.Timer(max(timeout_s, 1.0), kill)
    timer.start()
    out = {}
    try:
        for line in proc.stdout:
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            case = rec.get("case")
            if case in cases and case not in out:
                out[case] = rec
                on_line(case, rec)
        proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            kill()
            proc.wait()
        reader.join(timeout=10)
    if timed_out.is_set():
        err = f"timeout after {timeout_s:.0f}s"
    else:
        err = f"child exited with code {proc.returncode}"
    why = _informative_line(err_lines)
    for case in cases:
        if case not in out:
            out[case] = {"error": f"{err}: {why}" if why else err,
                         "case": case}
    return out, timed_out.is_set()


def _groups_of(cases):
    """Partition the case list into child groups (order-preserving):
    consecutive cases of one family (the presets on the bunny scene, the
    analytic scene, the 81,920-triangle scene) share a child; moving and
    any other case run alone."""
    fam = {"baseline": "p", "realistic": "p", "full": "p", "heavy": "p",
           "an_baseline": "a", "an_full": "a",
           "cf_far": "c", "cf_close": "c"}
    groups = []
    for case in cases:
        f = fam.get(case, case)
        if groups and groups[-1][0] == f:
            groups[-1][1].append(case)
        else:
            groups.append((f, [case]))
    return [g for _, g in groups]


def _timeouts_after(consecutive: int, timed_out: bool, recs) -> int:
    """Consecutive timeouts after one group: a group whose child hit its
    timeout counts one, however many of its cases it left without a
    line; a group with a case measured starts the count again."""
    if timed_out:
        return consecutive + 1
    if any("error" not in r for r in recs.values()):
        return 0
    return consecutive


def _prepare() -> None:
    """Check for the card and build the CUDA kernels (one nvcc a source)
    and the g++ host library before any child starts, so that a child
    only loads them."""
    import torch
    from opengl_raytracing_tpu_torch import native
    if os.environ.get("BENCH_FORCE_CPU") != "1":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                               "false) and BENCH_FORCE_CPU is not 1")
        from opengl_raytracing_tpu_torch.ops import cuda_lib
        cuda_lib.build_all()
    native.build_library()


def main() -> int:
    if "--child" in sys.argv:
        child(sys.argv[sys.argv.index("--child") + 1])
        return 0

    t_start = time.time()
    cases = (os.environ["BENCH_CASES"].split(",")
             if "BENCH_CASES" in os.environ else list(CASES))
    try:
        _prepare()
    except RuntimeError as exc:
        print(json.dumps({"error": f"bench_torch: {exc}"}), flush=True)
        return 1

    timeout_s = TIMEOUT_S
    presets, close_far, banked = {}, {}, {}
    headline = None
    consecutive_timeouts = 0

    def cumulative():
        """Headline + everything measured so far, final-record format."""
        head = headline
        if head is None or "error" in head:
            if PRESET not in cases:
                why = "headline case not in BENCH_CASES"
            else:
                why = (head or {}).get("error", "headline case not run yet")
            head = {
                "metric": (f"primary Mrays/s/chip, bunny BVH scene, "
                           f"{W}x{H} 1spp, preset={PRESET}"),
                "value": 0.0, "unit": "Mrays/s", "vs_baseline": 0.0,
                "error": why}
        final = dict(head)
        final.pop("case", None)
        final["presets"] = {k: {kk: v[kk] for kk in
                                ("ms_per_frame", "fps", "value", "spread",
                                 "checksum", "error")
                                if kk in v} for k, v in presets.items()}
        final["close_far"] = {k: {kk: v[kk] for kk in
                                  ("ms_per_frame", "fps", "mrays",
                                   "ordered_primary", "spread", "checksum",
                                   "error") if kk in v}
                              for k, v in close_far.items()}
        return final

    def bank(case, rec):
        nonlocal headline
        line = dict(rec)
        line.setdefault("case", case)
        print(json.dumps(line), flush=True)
        banked[case] = rec
        if case.startswith("cf_"):
            close_far[case[3:]] = rec
        else:
            presets[case] = rec
            if case == PRESET:
                headline = rec

    for group in _groups_of(cases):
        remaining = BUDGET_S - (time.time() - t_start)
        if remaining < 60:
            for case in group:
                bank(case, {"error": "skipped (bench budget exhausted)"})
            continue
        recs, timed_out = _run_group(
            group, min(timeout_s * len(group), remaining - 20), bank)
        for case in group:
            if case not in banked:
                bank(case, recs[case])
        consecutive_timeouts = _timeouts_after(consecutive_timeouts,
                                               timed_out, recs)
        if consecutive_timeouts >= 2:
            timeout_s = min(timeout_s, SHORT_TIMEOUT_S)
        print(json.dumps(cumulative()), flush=True)

    print(json.dumps(cumulative()), flush=True)
    return 1 if any("error" in r for r in banked.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
