#!/usr/bin/env python3
"""Kernel alone-times of two checkouts on one card, in turns.

    python3 probe_kernel_turns.py OTHER_DIR [ROUNDS]
        [--frames | --k5 | --k3 | --gates]

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

With `--frames` a run times the replayed frame instead: for every case of
chip_smoke.py's phase graph (GRAPH_CASES: baseline, an_baseline, full,
an_full with the day-sky cubemap, heavy, moving, cf_close, cf_far), after
a chain that captures, three 32-frame chains through `make_render_fn`
with its captured graph (host clock to a synchronize), their least
ms/frame a case.

With `--k5` a run times the BVH direct light (`bvh_direct_kernel`) alone
on the calls of K5_CASES' 1080p frames (baseline's one call, `full`'s
and `heavy`'s primary and GI calls on a chain's third frame, the
81,920-triangle mesh under the cf_close and cf_far cameras) and saves
each call's radiance on its live lanes to the file that `--out` names:
one a side in a temporary directory of this script's own, removed at
the end, so that no output lands in either checkout; after the runs the
two sides' last outputs are compared bit for bit, one JSON line.

With `--k3` a run times the analytic direct light (`an_direct_light_kernel`)
alone on every call of K3_CASES' frames (an_full's seven at 1080p with
the day-sky cubemap, an_baseline's five at 800x600), each as the frame
calls it (a checkout whose frame hands K3 a mask of live lanes times the
masked call), and saves each call's radiance and mask the same way;
after the runs each call's radiance is compared bit for bit on this
checkout's live lanes, and its live lanes and bound
(chip_smoke.an_call_bound) are printed beside the medians, one JSON line.

With `--gates` a run times every call of the live-lane kernels (the
analytic trace, AO, GI bounce and sky kernels, glass's and the mirror's
rays and mixes, both hit mixes: chip_smoke's GATE_KERNELS, SHADE_KERNELS
and HIT_MIX_KERNELS) alone on GATE_FRAMES' frames (a 1080p an_full with
the day-sky cubemap, an 800x600 an_baseline, a 1080p `baseline`, and a
1080p `full` and `heavy` chain's third frame), each as the frame calls
it, and saves the AO, bounce and sky calls' outputs on their live lanes,
glass's and the mirror's rays calls' on the live lanes where each is
written (chip_smoke.shade_written) and the BVH hit mix's whole radiance
(its dead lanes as they came); after the runs those are compared bit
for bit, one JSON line with each call's live lanes and each gate call's
bound (chip_smoke.gate_bound).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

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


# (label, preset, camera, frames of the chain, 81,920-triangle mesh) of
# each K5 frame, as chip_smoke.py's phases record them
K5_CASES = (("baseline", "baseline", "still", 1, False),
            ("full", "full", "still", 3, False),
            ("heavy", "heavy", "still", 3, False),
            ("cf_close", "baseline", "cf_close", 1, True),
            ("cf_far", "baseline", "cf_far", 1, True))


def child_k5(saved: str) -> None:
    """In a checkout's directory: the BVH direct light's alone-time on
    each call of K5_CASES' frames, one JSON line; each call's radiance on
    its live lanes saved to `saved`."""
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
    torch.save(outputs, saved)
    print(json.dumps(ms), flush=True)


# (label, preset, cubemap, height, width) of each K3 frame, as chip_smoke.py's
# kernels phase records them
K3_CASES = (("an_full", "full", True, 1080, 1920),
            ("an_baseline", "baseline", False, 600, 800))


def k3_labels(params):
    """The names of an analytic frame's K3 calls in its order (the
    primary hits, their GI bounce, the mirror's hit and its GI bounce, the
    glass's three secondaries; as chip_smoke.an_call_labels, written out
    here so that a checkout without it names them alike)."""
    gi = bool(params.enable_gi)
    return (["primary"] + ["gi"] * gi
            + (["mirror"] + ["mirror_gi"] * gi) * bool(
                params.mat_mirror_enabled)
            + ["glass_reflect", "glass_straight", "glass_bent"] * bool(
                params.mat_glass_enabled))


def child_k3(saved: str) -> None:
    """In a checkout's directory: K3's alone-time on each call of
    K3_CASES' frames, one JSON line; each call's radiance, its mask (where
    the checkout's frame hands one) and, where chip_smoke has it, its
    live lanes and bound saved to `saved`."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.ops import an_cuda, cuda_lib
    cuda_lib.build_all()
    env = cs.sky_day("cuda")
    name = cs.KERNELS["an_direct"]["kernel"]
    ms, outputs, info = {}, {}, {}
    for label, preset_name, with_env, height, width in K3_CASES:
        calls = cs.record_kernel_inputs(None, height, width, "cuda",
                                        ("an_direct",), preset_name,
                                        env=env if with_env else None)
        labels = k3_labels(calls["an_direct"][0]["scene"].params)
        if len(labels) != len(calls["an_direct"]):
            raise AssertionError(f"{label}: {len(calls['an_direct'])} K3 "
                                 f"calls, expected {labels}")
        for call, args in zip(labels, calls["an_direct"]):
            key = f"{label}_{call}"
            outputs[key] = an_cuda.direct_light(**args).reshape(-1, 3).cpu()
            if args.get("active") is not None:
                outputs[key + "/live"] = args["active"].expand(
                    args["h"].t.shape).reshape(-1).cpu()
            if hasattr(cs, "an_call_bound"):
                info[key] = cs.an_call_bound(args)
            ms[key] = cs.kernel_ms(lambda: an_cuda.direct_light(**args),
                                   name)
        del calls
    outputs["info"] = info
    torch.save(outputs, saved)
    print(json.dumps(ms), flush=True)


def compare_k3(other: str, this: str) -> dict:
    """The two sides' saved K3 outputs (files `other`, `this`): for each
    call, whether they are equal bit for bit on this checkout's live
    lanes, on how many values they differ there, and this checkout's live
    lanes and bound."""
    import torch
    a = torch.load(other)
    b = torch.load(this)
    info = b.pop("info")
    a.pop("info")
    out = {}
    for key in (k for k in b if not k.endswith("/live")):
        live = b.get(key + "/live")
        got, want = b[key], a[key]
        if live is not None:
            got, want = got[live], want[live]
        same = got.shape == want.shape
        out[key] = dict(bitwise=bool(same and torch.equal(
            got.view(torch.int32), want.view(torch.int32))),
            values=got.numel(),
            differ=int((got != want).sum()) if same else None,
            **info.get(key, {}))
    return out


def compare_k5(other: str, this: str) -> dict:
    """The two sides' saved K5 outputs (files `other`, `this`): for each
    call, whether they are equal bit for bit, and on how many values they
    differ."""
    import torch
    a = torch.load(other)
    b = torch.load(this)
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


# (label, BVH scene, preset, size, cubemap) of each frame --gates times
GATE_FRAMES = (("an_full", False, "full", (1080, 1920), True),
               ("an_baseline", False, "baseline", (600, 800), False),
               ("baseline", True, "baseline", (1080, 1920), False),
               ("full", True, "full", (1080, 1920), False),
               ("heavy", True, "heavy", (1080, 1920), False))


def gate_caller(cs, key, a):
    """A call of live-lane kernel `key`'s wrapper on the recorded
    arguments `a`, with the frame's own mask (a mix into a copy of the
    frame's radiance)."""
    if key in cs.GATE_KERNELS:
        return lambda: cs.gate_call(key, a, a.get("active"))
    if key in cs.SHADE_KERNELS:
        out = a["out"].clone() if key in ("glass_mix", "mirror_mix") \
            else None
        return lambda: cs.shade_call(key, a, a.get("active"), out)
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    fn = getattr(hit_mix_cuda, cs.KERNELS[key]["wrapper"])
    args = {k: v for k, v in a.items() if k not in ("active", "radiance")}
    radiance = a["radiance"].clone()
    return lambda: fn(**args, radiance=radiance, active=a.get("active"))


def hit_mix_radiance(a):
    """The BVH hit mix's radiance on the recorded arguments `a`, written
    into a copy of the frame's: its live lanes mixed, the others as they
    came."""
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    out = a["radiance"].clone()
    hit_mix_cuda.bvh_hit_mix(**{k: v for k, v in a.items()
                                if k not in ("active", "radiance")},
                             radiance=out, active=a.get("active"))
    return out


def child_gates(saved: str) -> None:
    """In a checkout's directory: the live-lane kernels' alone-times on
    every call of GATE_FRAMES' frames, one JSON line; the AO, bounce, sky
    and rays calls' outputs on their live lanes (a rays call's where they
    are written) and the BVH hit mix's whole radiance, their live lanes,
    and each call of the four gate kernels' live lanes and bound
    (chip_smoke.gate_bound) saved to `saved`."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    env = cs.sky_day("cuda")
    bvh = cs.scene("cuda")[1]
    keys = cs.GATE_KERNELS + cs.SHADE_KERNELS + cs.HIT_MIX_KERNELS
    ms, outputs, info = {}, {}, {}
    for label, on_bvh, preset_name, (h, w), cube in GATE_FRAMES:
        calls = cs.record_kernel_inputs(bvh if on_bvh else None, h, w,
                                        "cuda", keys, preset_name,
                                        cs.PROFILE_FRAME,
                                        env=env if cube else None)
        for key in keys:
            for n, a in enumerate(calls[key]):
                name = f"{label}_{key}_{n}"
                ms[name] = cs.kernel_ms(gate_caller(cs, key, a),
                                        cs.KERNELS[key]["kernel"])
                if key in cs.GATE_KERNELS:
                    live = cs._live_of(cs.gate_shape(key, a),
                                       a.get("active"))
                    info[name] = {f: v for f, v in cs.gate_bound(
                        key, a, live).items() if f in BOUND_FIELDS}
                if key in ("an_ao", "an_bounce", "sky"):
                    out = cs.gate_call(key, a, a.get("active"))
                    outputs[name] = {f: v[live].cpu()
                                     for f, v in out.items()}
                    outputs[name + "/live"] = int(live.sum())
                if key in ("glass_rays", "mirror_ray"):
                    live = cs._live_of(cs.shade_shape(key, a),
                                       a.get("active"))
                    got = cs.shade_call(key, a, a.get("active"))
                    lanes = cs.shade_written(key, cs.shade_plain(key, a),
                                             live)
                    outputs[name] = {f: got[f][w].cpu()
                                     for f, w in lanes.items()}
                    outputs[name + "/live"] = int(live.sum())
                if key == "bvh_hit_mix":
                    outputs[name] = {"radiance": hit_mix_radiance(a).cpu()}
                    outputs[name + "/live"] = int(cs._live_of(
                        a["radiance"].shape[:-1], a.get("active")).sum())
        del calls
    outputs["info"] = info
    torch.save(outputs, saved)
    print(json.dumps(ms), flush=True)


def compare_gates(other: str, this: str) -> dict:
    """The two sides' saved AO, bounce, sky, rays and BVH hit-mix outputs
    (files `other`, `this`): for each call, whether every output is equal
    bit for bit (on its live lanes; the hit mix's radiance whole), and
    its live lanes."""
    import torch
    a = torch.load(other)
    b = torch.load(this)
    a.pop("info")
    out = {"info": b.pop("info")}
    for key in (k for k in b if not k.endswith("/live")):
        same = {f: bool(f in a[key] and a[key][f].shape == x.shape
                        and torch.equal(a[key][f].view(torch.int32),
                                        x.view(torch.int32)))
                for f, x in b[key].items()}
        out[key] = dict(bitwise=all(same.values()), fields=same,
                        live_lanes=b[key + "/live"])
    return out


# the bound's fields of a gate call that --gates prints
BOUND_FIELDS = ("lanes", "live_lanes", "bound_ms", "bound_by", "bound_bytes",
                "bound_ops", "texels", "samples")


def child_frames() -> None:
    """In a checkout's directory: replayed ms/frame of chip_smoke.py's
    GRAPH_CASES, one JSON line."""
    sys.path.insert(0, os.getcwd())
    import time
    import torch
    import chip_smoke as cs
    from opengl_raytracing_tpu_torch.models import (RenderState, graph,
                                                    make_render_fn, preset)
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    scenes = {"bvh": cs.scene("cuda")[1],
              "bvh6": cs.scene("cuda", cs.HEAVY_SUBDIV)[1], None: None}
    sky = cs.sky_day("cuda")
    out = {}
    for name, (scene_key, preset_name, (h, w), how) in \
            cs.GRAPH_CASES.items():
        scene = scenes[scene_key]
        env = sky if how.get("env") else None
        fins = list(cs.frame_inputs(h, w, cs.FRAMES, "cuda", preset_name,
                                    how.get("camera", "still")))
        fn = make_render_fn(h, w, "cuda", use_bvh=scene is not None)
        params = preset(preset_name).replace(
            enable_env_map=int(env is not None))
        runs = []
        for _ in range(4):  # the first captures
            state = RenderState.create(h, w, "cuda")
            torch.cuda.synchronize()
            t0 = time.time()
            for fin in fins:
                state, _ = fn(params, fin, state, env, scene)
            torch.cuda.synchronize()
            runs.append((time.time() - t0) / len(fins) * 1e3)
        out[name] = min(runs[1:])
        graph.clear()  # the case's graph memory back
    print(json.dumps(out), flush=True)


def main() -> int:
    modes = ("--frames", "--k5", "--k3", "--gates")
    if sys.argv[1:2] == ["--child"]:
        saving = {"--k5": child_k5, "--k3": child_k3, "--gates": child_gates}
        flag = next((f for f in saving if f in sys.argv), None)
        if flag:
            saved = sys.argv[sys.argv.index("--out") + 1]
            saving[flag](saved)
        else:
            (child_frames if "--frames" in sys.argv else child)()
        return 0
    mode = [a for a in sys.argv[1:] if a in modes]
    argv = [a for a in sys.argv[1:] if a not in modes]
    other = os.path.abspath(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    # the --k5 / --k3 / --gates children's outputs, a file a side, outside
    # both checkouts and made anew each run
    outputs = tempfile.mkdtemp(prefix="probe_kernel_turns_")
    try:
        return turns(other, rounds, mode, smi, outputs)
    finally:
        shutil.rmtree(outputs, ignore_errors=True)


def turns(other: str, rounds: int, mode: list, smi: str,
          outputs: str) -> int:
    """The runs in turns, their medians and, with --k5, --k3 or --gates,
    the comparison of the two sides' outputs (files under `outputs`)."""
    frames = "--frames" in mode
    saved = {side: os.path.join(outputs, side + ".pt")
             for side in ("other", "this")}
    times = {"other": [], "this": []}
    for side in ["other", "this", "this", "other"] * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"] + mode
            + ["--out", saved[side]],
            cwd=other if side == "other" else ROOT, stdout=subprocess.PIPE,
            text=True, timeout=900)
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
    for flag, compare in (("--k5", compare_k5), ("--k3", compare_k3),
                          ("--gates", compare_gates)):
        if flag in mode:
            bits = compare(saved["other"], saved["this"])
            print(json.dumps({"card": smi, f"{flag[2:]}_bitwise": bits}),
                  flush=True)
            if not all(r["bitwise"] for k, r in bits.items()
                       if k != "info"):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
