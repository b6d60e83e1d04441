#!/usr/bin/env python3
"""Kernel alone-times of two checkouts on one card, in turns.

    python3 probe_kernel_turns.py OTHER_DIR [ROUNDS] [--frames | --k5]

OTHER_DIR is another checkout of the repository, say the parent commit
unpacked with `git archive`.  Each run is a child process in one
checkout's directory that builds its kernels and runs chip_smoke.py's
kernel checks there (phase `kernels`: every kernel on one frame's inputs,
held to its plain version, and the profiler's time of one launch,
`kernel_ms`).  The runs go other, this, this, other, ROUNDS times over
(default 2), so that drift on the card falls on both sides alike.  One
JSON line a run ({"tree", "kernel_ms": {kernel: ms}}), then one with each
kernel's median on each side and their ratio (this / other), and the
card's name and power limit.

With `--frames` a run times the replayed frame instead: for chip_smoke.py's
FRAME_CASES of phase graph (baseline, an_baseline, full), after a chain
that captures, three 32-frame chains through `make_render_fn` with its
captured graph (host clock to a synchronize), their least ms/frame a case.

With `--k5` a run times the BVH direct light (`bvh_direct_kernel`) alone
on the calls of K5_CASES' 1080p frames (baseline's one call, `full`'s and `heavy`'s primary and GI calls on a
chain's third frame, the 81,920-triangle mesh under the cf_close and
cf_far cameras) and saves
each call's radiance on its live lanes under the checkout's ignored
build directory (K5_OUTPUTS, removed from both checkouts before the first
run); after the runs the two checkouts' outputs are compared bit for bit,
one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def child() -> None:
    """In a checkout's directory: its kernels' alone-times, one JSON line."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    _, bvh = cs.scene("cuda")
    records = cs.check_kernels(bvh)
    records.update(cs.check_an_kernel())
    records.update(cs.check_an_kernel(cs.HEIGHT, cs.WIDTH,
                                      preset_name="full",
                                      env=cs.sky_day("cuda")))
    records.update(cs.check_full_kernels(bvh))
    print(json.dumps({k: r["kernel_ms"] for k, r in records.items()}),
          flush=True)


FRAME_CASES = ("baseline", "an_baseline", "full")
# (label, preset, camera, frames of the chain, 81,920-triangle mesh) of
# each K5 frame, as chip_smoke.py's phases record them
K5_CASES = (("baseline", "baseline", "still", 1, False),
            ("full", "full", "still", 3, False),
            ("heavy", "heavy", "still", 3, False),
            ("cf_close", "baseline", "cf_close", 1, True),
            ("cf_far", "baseline", "cf_far", 1, True))
K5_OUTPUTS = os.path.join("opengl_raytracing_tpu_torch", "_build",
                          "k5_outputs.pt")


def child_k5() -> None:
    """In a checkout's directory: the BVH direct light's alone-time on
    each call of K5_CASES' frames, one JSON line; each call's radiance on
    its live lanes saved to K5_OUTPUTS."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.ops import an_cuda, cuda_lib
    cuda_lib.build_all()
    meshes = {False: cs.scene("cuda")[1],
              True: cs.scene("cuda", cs.HEAVY_SUBDIV)[1]}
    name = cs.KERNELS["bvh_direct"]["kernel"]
    ms, outputs = {}, {}
    for label, preset_name, camera, frames, heavy_mesh in K5_CASES:
        calls = cs.record_kernel_inputs(
            meshes[heavy_mesh], cs.HEIGHT, cs.WIDTH, "cuda",
            ("bvh_direct",), preset_name, frames, camera=camera)
        for k, args in enumerate(calls["bvh_direct"]):
            key = label if len(calls["bvh_direct"]) == 1 else \
                f"{label}_{('primary', 'gi')[k]}"
            shape = args["h"].t.shape
            live = (torch.ones(shape, dtype=torch.bool, device="cuda")
                    if args["active"] is None
                    else args["active"].expand(shape))
            got = an_cuda.direct_light_bvh(**args)
            outputs[key] = got[live].cpu()
            ms[key] = cs.kernel_ms(lambda: an_cuda.direct_light_bvh(**args),
                                   name)
        del calls
    torch.save(outputs, K5_OUTPUTS)
    print(json.dumps(ms), flush=True)


def compare_k5(other: str) -> dict:
    """The two checkouts' saved K5 outputs: for each call, whether they are
    equal bit for bit, and on how many values they differ."""
    import torch
    a = torch.load(os.path.join(other, K5_OUTPUTS))
    b = torch.load(os.path.join(ROOT, K5_OUTPUTS))
    if sorted(a) != sorted(b):
        raise AssertionError(f"the checkouts saved other calls: {sorted(a)} "
                             f"against {sorted(b)}")
    out = {}
    for key in a:
        same = a[key].shape == b[key].shape
        out[key] = dict(bitwise=bool(same and torch.equal(
            a[key].view(torch.int32), b[key].view(torch.int32))),
            values=a[key].numel(),
            differ=int((a[key] != b[key]).sum()) if same else None)
    return out


def child_frames() -> None:
    """In a checkout's directory: replayed ms/frame of FRAME_CASES, one
    JSON line."""
    sys.path.insert(0, os.getcwd())
    import time
    import torch
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn, preset)
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    _, bvh = cs.scene("cuda")
    out = {}
    for name in FRAME_CASES:
        scene_key, preset_name, (h, w), how = cs.GRAPH_CASES[name]
        scene = bvh if scene_key else None
        fins = list(cs.frame_inputs(h, w, cs.FRAMES, "cuda", preset_name,
                                    how.get("camera", "still")))
        fn = make_render_fn(h, w, "cuda", use_bvh=scene is not None)
        params = preset(preset_name)
        runs = []
        for _ in range(4):  # the first captures
            state = RenderState.create(h, w, "cuda")
            torch.cuda.synchronize()
            t0 = time.time()
            for fin in fins:
                state, _ = fn(params, fin, state, None, scene)
            torch.cuda.synchronize()
            runs.append((time.time() - t0) / len(fins) * 1e3)
        out[name] = min(runs[1:])
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        (child_frames if "--frames" in sys.argv
         else child_k5 if "--k5" in sys.argv else child)()
        return 0
    frames = "--frames" in sys.argv
    mode = [a for a in sys.argv[1:] if a in ("--frames", "--k5")]
    argv = [a for a in sys.argv[1:] if a not in ("--frames", "--k5")]
    other = os.path.abspath(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if "--k5" in mode:  # no earlier run's outputs are compared
        for tree in (other, ROOT):
            if os.path.exists(os.path.join(tree, K5_OUTPUTS)):
                os.remove(os.path.join(tree, K5_OUTPUTS))
    times = {"other": [], "this": []}
    for side in ["other", "this", "this", "other"] * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"] + mode,
            cwd=other if side == "other" else ROOT, stdout=subprocess.PIPE,
            text=True, timeout=600)
        if proc.returncode != 0:
            print(json.dumps({"tree": side, "error": proc.returncode}))
            return 1
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        times[side].append(ms)
        print(json.dumps({"tree": side, ("ms_per_frame" if frames
                                         else "kernel_ms"): ms}), flush=True)
    medians = {}
    for k in times["this"][0]:
        got = {side: [t[k] for t in runs if t.get(k) is not None]
               for side, runs in times.items()}
        if got["this"] and got["other"]:
            med = {side: statistics.median(v) for side, v in got.items()}
            medians[k] = dict(med, ratio=med["this"] / med["other"],
                              this_runs=got["this"],
                              other_runs=got["other"])
    print(json.dumps({"card": smi, "medians": medians}), flush=True)
    if "--k5" in mode:
        bits = compare_k5(other)
        print(json.dumps({"card": smi, "k5_bitwise": bits}), flush=True)
        if not all(r["bitwise"] for r in bits.values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
