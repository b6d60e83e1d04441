"""Carry host and JAX-side state into the port's tensors.

`env_from_numpy` places a cubemap environment (the loader's float faces,
or the uint8 table a bench builds from an 8-bit source) on the device as
the float32 table the samplers read.

The parity tests build a scene, a parameter set and frame inputs once and
feed both packages the same values: the JAX BVH arrays (converted to
numpy) go through `bvh_from_numpy`, so both sides walk one tree (the
port's `prepare_bvh` builds that same tree itself, with the same g++
builder).  Nothing here imports JAX: a JAX array is read through
`np.asarray`, like any array.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from .camera import Camera
from .models import frame_block
from .models.pipeline import FrameInputs
from .ops.scene import BVHDevice
from .params import RenderParams
from .scene.bvh import BVHArrays

def bvh_from_numpy(arrays: BVHArrays, device) -> BVHDevice:
    """BVHArrays of host arrays -> BVHDevice of contiguous tensors on
    `device` (bounds and tris float32, meta int32)."""
    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
    return BVHDevice(BVHArrays(put(arrays.bounds, np.float32),
                               put(arrays.meta, np.int32),
                               put(arrays.tris, np.float32)))


def env_from_numpy(faces, device) -> torch.Tensor:
    """Cubemap faces [6,F,F,3] on the host -> the contiguous float32 table
    on `device` that `ops.cubemap.sample_cubemap` and the analytic
    direct-light kernel read.  A uint8 table becomes k / 255 by true
    division on the host (the loader's own values); a float table is
    carried as is."""
    faces = np.asarray(faces)
    if faces.ndim != 4 or faces.shape[0] != 6 or faces.shape[3] != 3 \
            or faces.shape[1] != faces.shape[2]:
        raise ValueError(f"cubemap faces must be [6,F,F,3], got "
                         f"{faces.shape}")
    if faces.dtype == np.uint8:
        faces = faces.astype(np.float32) / np.float32(255.0)
    return torch.from_numpy(np.array(faces, dtype=np.float32)).to(device)


def params_from(src) -> RenderParams:
    """RenderParams of the port from any dataclass with the same field
    names (the JAX package's RenderParams).  Raises on a field either side
    lacks, so the two definitions cannot drift apart unnoticed."""
    ours = {f.name: f for f in dataclasses.fields(RenderParams)}
    theirs = [f.name for f in dataclasses.fields(src)]
    unknown = sorted(set(theirs) - set(ours))
    missing = sorted(set(ours) - set(theirs))
    if unknown or missing:
        raise ValueError(f"RenderParams fields differ: unknown {unknown}, "
                         f"missing {missing}")
    kw = {}
    for name in theirs:
        v = getattr(src, name)
        if ours[name].type == "int":
            kw[name] = int(v)
        elif np.ndim(v):
            kw[name] = tuple(float(x) for x in np.asarray(v).reshape(-1))
        else:
            kw[name] = float(v)
    return RenderParams(**kw)


def frame_inputs_from_numpy(src, device, frame_index: int = 0
                            ) -> FrameInputs:
    """FrameInputs on `device` from any object with the same attributes
    (the JAX package's FrameInputs, or a namespace of numpy arrays), as
    views of one device block made by one host-to-device copy that also
    holds `frame_index`'s record (models/frame_block.py; a frame of
    another index restages it).  The source's `camera_moved` is read on
    the host and kept there too, as the `moved` flag."""
    return FrameInputs.stage(frame_block.pack(src, frame_index), device,
                             moved=bool(int(np.asarray(src.camera_moved))))


def camera_frame_inputs(cam: Camera, device, jitter=(0.0, 0.0),
                        prev_view_proj=None, moved: int = 0,
                        frame_index: int = 0) -> FrameInputs:
    """FrameInputs of a camera pose (reference: render.cpp:73-167): the
    previous view-projection defaults to the current one (a still
    camera); `jitter` is in pixels, already scaled; `moved` fills both the
    device `camera_moved` and the host `moved` flag; `frame_index` as for
    `frame_inputs_from_numpy`."""
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return frame_inputs_from_numpy(SimpleNamespace(
        cam_pos=cam.position, cam_right=right, cam_up=up, cam_fwd=fwd,
        tan_half_fov=thf, aspect=cam.aspect, jitter=jitter,
        curr_view_proj=vp,
        prev_view_proj=vp if prev_view_proj is None else prev_view_proj,
        camera_moved=moved), device, frame_index)
