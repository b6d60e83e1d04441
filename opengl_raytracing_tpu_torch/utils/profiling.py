"""Profiling & metrics: frame timers, ray counters, and profiler traces.

Counterpart of `opengl_raytracing_tpu/utils/profiling.py`.  The
reference's only instrumentation is the ImGui FPS meter
(reference: src/ui/gui.cpp:206-207); here are per-pass wall-clock,
Mrays/s accounting, and `torch.profiler` traces.  PyTorch returns before
the card finishes, so `FrameTimer` forces completion: it synchronises the
card and reads a scalar back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .log import log


def _tensors(tree):
    """The tensors in a nest of tensors, lists, tuples, dicts and
    dataclasses (FrameOutputs, RenderState)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force_complete(tree) -> float:
    """Wait for the card (torch.cuda.synchronize on each CUDA device in
    `tree`), then read back the sum of every tensor as one scalar."""
    leaves = list(_tensors(tree))
    if not leaves:
        return 0.0
    for dev in {x.device for x in leaves if x.is_cuda}:
        torch.cuda.synchronize(dev)
    return float(sum(x.to(torch.float32).sum().cpu() for x in leaves))


class FrameTimer:
    """Rolling per-pass wall-clock stats (forced completion)."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str, result_ref: Optional[list] = None):
        t0 = time.monotonic()
        yield
        if result_ref:
            force_complete(result_ref[0])
        dt = (time.monotonic() - t0) * 1e3
        buf = self.samples.setdefault(name, [])
        buf.append(dt)
        if len(buf) > self.window:
            buf.pop(0)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, buf in self.samples.items():
            a = np.asarray(buf)
            out[name] = {"mean_ms": float(a.mean()),
                         "p50_ms": float(np.percentile(a, 50)),
                         "p95_ms": float(np.percentile(a, 95)),
                         "n": len(buf)}
        return out

    def report(self) -> None:
        for name, s in self.stats().items():
            log("BENCH", "%s: %.2f ms (p95 %.2f, n=%d)", name, s["mean_ms"],
                s["p95_ms"], s["n"])


class RayCounter:
    """Ray accounting per frame: primary / shadow / gi / ao rays.

    Counts are analytic (derived from resolution + preset), matching how
    the reference's report derives throughput (pixels x FPS, SURVEY.md §6).
    """

    def __init__(self, height: int, width: int):
        self.pixels = height * width

    def rays_per_frame(self, params, use_bvh: bool = False) -> Dict[str, int]:
        spp = max(int(params.spp_per_frame), 1)
        px = self.pixels
        shadow_per_hit = 4  # disk samples
        shadow_per_hit += 1 if params.sun_enabled else 0
        shadow_per_hit += 1 if params.point_light_enabled else 0
        out = {"primary": px,
               "shadow": px * spp * shadow_per_hit}
        if params.enable_gi:
            # one bounce + direct light at the secondary hit
            out["gi"] = px * spp * (1 + shadow_per_hit)
        if params.enable_ao:
            out["ao"] = px * spp * int(params.ao_samples)
        out["total"] = sum(out.values())
        return out

    def mrays(self, params, frame_ms: float, use_bvh: bool = False,
              kind: str = "total") -> float:
        rays = self.rays_per_frame(params, use_bvh)[kind]
        return rays / (frame_ms * 1e-3) / 1e6


def device_activity(prof, frames: int, top: int = 8) -> Optional[dict]:
    """The device side of a torch.profiler window over `frames` frames:
    busy ms a frame, device operations (kernels, copies, fills) a frame,
    and the `top` operations by device time under the profiler's own
    names, each with its ms and calls a frame.  None where the profiler
    saw no device time."""
    from torch.autograd import DeviceType
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    if not busy_ms:
        return None
    return dict(device_ms=busy_ms / frames,
                launches=sum(n for _, n, _ in rows) / frames,
                top_ops=[dict(op=key, ms=ms / frames, calls=n / frames)
                         for ms, n, key in rows[:top]])


@contextlib.contextmanager
def torch_profiler_trace(outdir: str):
    """torch.profiler trace of the block (host and, where there is a card,
    device activity), written as a Chrome trace to
    `outdir/trace.json`; view it in chrome://tracing or Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    log("BENCH", "torch.profiler trace written to %s", path)
