"""Headless CLI: render frames, param sweeps, frame dumps, checkpoints.

Counterpart of `opengl_raytracing_tpu/app/headless.py`, with the same
flags: `--jit` (the default) replays each frame as a captured CUDA graph
on the card, `--no-jit` runs it eagerly.  Drives the Application loop
without a display and writes tonemapped PNGs + structured logs.  Frames
run on the CUDA card; `--cpu` runs them on the CPU, and without it a
machine with no card raises.

Examples:
  python -m opengl_raytracing_tpu_torch.app.headless --preset full --frames 16
  python -m opengl_raytracing_tpu_torch.app.headless --scene bvh \\
      --size 1920x1080 --frames 32 --out out/
  python -m opengl_raytracing_tpu_torch.app.headless --raster --out out/
  python -m opengl_raytracing_tpu_torch.app.headless --sweep exposure=0.5,1,2
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..constants import DEFAULT_BVH_SCALE, DEFAULT_BVH_TRANSLATE
from ..models.presets import PRESETS, preset
from ..scene.geometry import (gather_triangles_fast, make_bunny,
                              model_transform)
from ..utils.checkpoint import (load_preset, load_snapshot, save_preset,
                                save_snapshot)
from ..utils.image import write_png
from ..utils.log import log
from .application import Application
from .state import AppState


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opengl_raytracing_tpu_torch.app.headless", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=PRESETS, default="full")
    p.add_argument("--preset-file", help="JSON param preset to load")
    p.add_argument("--scene", choices=("analytic", "bvh"), default="analytic")
    p.add_argument("--model", help="model path for the BVH scene, any "
                                   "importer format (default: procedural "
                                   "bunny)")
    p.add_argument("--env", help="4x3-cross environment map (png, jpg, hdr, "
                                 "exr)")
    p.add_argument("--size", default="800x600", help="WxH")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--dump-every", type=int, default=0,
                   help="write a PNG every N frames (0 = last only)")
    p.add_argument("--out", default="out")
    p.add_argument("--raster", action="store_true",
                   help="raster-preview parity mode (F2 equivalent)")
    p.add_argument("--motion-debug", action="store_true",
                   help="motion vector debug view (F6 equivalent)")
    p.add_argument("--orbit", action="store_true",
                   help="animate the point light orbit")
    p.add_argument("--camera-anim", choices=("none", "dolly", "pan"),
                   default="none",
                   help="move the camera each frame (exercises TAA "
                        "reprojection; BASELINE config 5)")
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="override a RenderParams field, e.g. exposure=2")
    p.add_argument("--sweep", metavar="FIELD=V1,V2,...",
                   help="render one image per value of FIELD")
    p.add_argument("--resume", help="snapshot .npz to resume from")
    p.add_argument("--snapshot", help="write a snapshot .npz at the end")
    p.add_argument("--save-preset", help="write current params as JSON")
    p.add_argument("--jit", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="replay each frame as its captured CUDA graph on "
                        "the card (--no-jit runs it eagerly, for debug "
                        "tracebacks; the CPU always runs it eagerly)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the CUDA card)")
    p.add_argument("--turbo", type=int, default=None,
                   help="frames chained per step: N while idle (camera "
                        "still, orbit off), min(N,6) while the camera "
                        "moves (the move frame + settling frames); 1 "
                        "disables.  Default: 8 in the viewer, 1 headless "
                        "(--frames counts step() calls)")
    return p


def _apply_overrides(params, pairs):
    for pair in pairs:
        field, value = pair.split("=", 1)
        cur = getattr(params, field)
        if isinstance(cur, tuple):
            vals = tuple(float(x) for x in value.split(","))
            params = params.replace(**{field: vals})
        elif isinstance(cur, int) and not isinstance(cur, bool):
            params = params.replace(**{field: int(value)})
        else:
            params = params.replace(**{field: float(value)})
    return params


def make_app(args) -> Application:
    """The Application the flags describe, on the CPU with --cpu and on the
    CUDA card otherwise (raising when there is none)."""
    device = "cpu" if getattr(args, "cpu", False) else "cuda"
    w, h = (int(x) for x in args.size.lower().split("x"))
    params = (load_preset(args.preset_file) if args.preset_file
              else preset(args.preset))
    params = _apply_overrides(params, args.set)
    if args.orbit:
        params = params.replace(point_light_orbit_enabled=1)
    state = AppState(height=h, width=w, params=params, device=device)
    application = Application(state=state, jit=getattr(args, "jit", True))
    turbo = getattr(args, "turbo", None)
    if turbo is None:
        # viewer defaults to 8 (the reference loop free-runs); headless
        # keeps 1 so --frames still counts rendered frames exactly
        turbo = 8 if getattr(args, "_viewer", False) else 1
    application.turbo = max(1, int(turbo))

    if args.resume:
        p, cam, frame, rs = load_snapshot(args.resume, state.device)
        # CLI overrides win over the snapshot: re-apply --set/--sweep on
        # the restored params (otherwise a sweep over a resumed run
        # would silently render identical images)
        p = _apply_overrides(p, args.set)
        state.params = state.prev_params = p
        state.camera = cam
        state.frame = frame
        state.restore_render_state(rs)
        # keep the hotkey mirrors in sync with the restored params (the
        # viewer's /set maintains the same invariant)
        application.input.exposure = float(p.exposure)
        application.input.spp_per_frame = int(p.spp_per_frame)
        log("CKPT", "resumed from %s at frame %d", args.resume,
            rs.frame_index)

    if args.scene == "bvh":
        state.use_bvh = True
        if args.model:
            state.load_bvh_model(args.model)
        else:
            tris = gather_triangles_fast(
                make_bunny(4), model_transform(DEFAULT_BVH_TRANSLATE,
                                               DEFAULT_BVH_SCALE))
            state.set_bvh_from_tris(tris)
            log("BVH", "procedural bunny: %d tris, %d nodes",
                state.bvh_tri_count, state.bvh_node_count)
    if args.env:
        state.load_env_map(args.env)
    if args.raster:
        state.ray_mode = False
    if args.motion_debug:
        state.show_motion = True
    return application


def camera_action(args):
    """The action `--camera-anim` applies before each frame, or None."""
    return {"dolly": "move_w", "pan": "look 8 0"}.get(args.camera_anim)


def _dump(img: torch.Tensor, path):
    arr = img.cpu().numpy()
    write_png(path, arr[::-1])  # GL bottom-up rows -> PNG top-down
    log("INIT", "wrote %s (mean %.3f)", path, arr.mean())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.sweep:
        field, values = args.sweep.split("=", 1)
        base_set = list(args.set)
        for v in values.split(","):
            # fresh Namespace per value: aliasing args would accumulate
            # every previous sweep override into later iterations
            sweep_args = argparse.Namespace(**vars(args))
            sweep_args.set = base_set + [f"{field}={v}"]
            application = make_app(sweep_args)
            img = application.run(args.frames)
            _dump(img, os.path.join(args.out, f"sweep_{field}_{v}.png"))
        return 0

    application = make_app(args)
    action = camera_action(args)
    t0 = time.time()
    img = None
    for f in range(args.frames):
        if action is not None:
            application.act(action)
        img = application.step()
        if args.dump_every and (f + 1) % args.dump_every == 0:
            _dump(img, os.path.join(args.out, f"frame_{f:04d}.png"))
    if img is not None and img.is_cuda:
        # PyTorch returns before the card finishes: without the wait the
        # BENCH line would time the queueing, not the rendering
        torch.cuda.synchronize(img.device)
    wall = time.time() - t0
    if img is not None:
        _dump(img, os.path.join(args.out, "frame_last.png"))
    app = application.app
    log("BENCH", "%d frames in %.2fs (%.1f ms/frame avg, loop fps %.1f)",
        args.frames, wall, wall / max(args.frames, 1) * 1e3, app.fps)

    if args.snapshot:
        save_snapshot(args.snapshot, app.params, app.camera, app.frame,
                      app.render_state)
        log("CKPT", "snapshot -> %s", args.snapshot)
    if args.save_preset:
        save_preset(args.save_preset, app.params)
        log("CKPT", "preset -> %s", args.save_preset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
