"""Checkpoint / resume: renderer state snapshots and param presets.

Counterpart of `opengl_raytracing_tpu/utils/checkpoint.py`, in the same
file format: a snapshot is one .npz of the camera, the frame state, the
[H,W,4] accumulation (rgb + M2), the frame index and the params as JSON,
so a snapshot of either package resumes in the other.  The reference
persists nothing (SURVEY.md §5); this enables resumable offline
accumulation, and param presets round-trip through JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from ..camera import Camera
from ..frame_state import FrameState
from ..models.pipeline import RenderState
from ..params import RenderParams


def save_snapshot(path: str, params: RenderParams, camera: Camera,
                  frame: FrameState, render_state: RenderState) -> None:
    """Write a resumable snapshot (.npz + embedded params JSON)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # np.savez auto-appends .npz, but np.load does NOT — normalize here so
    # save_snapshot(p) / load_snapshot(p) round-trip with any p
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(
        path,
        params_json=np.frombuffer(
            json.dumps(params_to_dict(params)).encode(), np.uint8),
        cam_position=np.asarray(camera.position, np.float32),
        cam_yaw=np.float32(camera.yaw), cam_pitch=np.float32(camera.pitch),
        cam_fov=np.float32(camera.fov), cam_aspect=np.float32(camera.aspect),
        curr_vp=np.asarray(frame.curr_view_proj, np.float32),
        prev_vp=np.asarray(frame.prev_view_proj, np.float32),
        curr_cam=np.asarray(frame.curr_cam_pos, np.float32),
        prev_cam=np.asarray(frame.prev_cam_pos, np.float32),
        jitter=np.asarray(frame.jitter, np.float32),
        accum=render_state.accum.detach().to("cpu", torch.float32).numpy(),
        frame_index=np.asarray(render_state.frame_index, np.int32),
    )


def load_snapshot(path: str, device="cuda") -> Tuple[
        RenderParams, Camera, FrameState, RenderState]:
    """(params, camera, frame state, render state); the accumulation is
    placed on `device`."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    with np.load(path) as z:
        params = params_from_dict(json.loads(bytes(z["params_json"])
                                             .decode()))
        cam = Camera(position=z["cam_position"].copy(),
                     yaw=float(z["cam_yaw"]), pitch=float(z["cam_pitch"]),
                     fov=float(z["cam_fov"]), aspect=float(z["cam_aspect"]))
        frame = FrameState(z["curr_vp"], z["prev_vp"], z["curr_cam"],
                           z["prev_cam"], z["jitter"])
        accum = torch.from_numpy(np.array(z["accum"], np.float32))
        frame_index = int(z["frame_index"])
    return params, cam, frame, RenderState(accum.to(device), frame_index)


def params_to_dict(params: RenderParams) -> dict:
    out = {}
    for f in dataclasses.fields(RenderParams):
        v = getattr(params, f.name)
        if isinstance(v, tuple):
            out[f.name] = [float(x) for x in v]
        elif f.type == "int":
            out[f.name] = int(v)
        else:
            out[f.name] = float(np.asarray(v))
    return out


def params_from_dict(d: dict) -> RenderParams:
    kw = {}
    for f in dataclasses.fields(RenderParams):
        if f.name not in d:
            continue
        v = d[f.name]
        kw[f.name] = tuple(v) if isinstance(v, list) else v
    return RenderParams(**kw)


def save_preset(path: str, params: RenderParams) -> None:
    """Param preset on disk (human-editable JSON)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(params_to_dict(params), fh, indent=2, sort_keys=True)


def load_preset(path: str) -> RenderParams:
    with open(path, "r", encoding="utf-8") as fh:
        return params_from_dict(json.load(fh))
