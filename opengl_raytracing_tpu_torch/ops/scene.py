"""Scene context: trace/shadow/sky dispatch for both scene modes (PyTorch).

Counterpart of `opengl_raytracing_tpu/ops/scene.py` (reference:
shaders/rt/rt_uniforms.glsl, rt_scene_analytic.glsl:132-197,
rt_bvh.glsl:193-304).  BVH traces go to ops/bvh_cuda.py, which walks the
tree with the CUDA kernel for CUDA tensors and with the plain PyTorch
walk for CPU tensors (the AO and GI bounce calls go there from
ops/lighting.py).  Analytic traces and both scenes' sky go to
ops/an_trace_cuda.py, which computes the lanes a caller reads (`active`)
with the kernels of csrc/an_trace.cu for CUDA tensors and every lane
with the plain forms of ops/scene_analytic.py for CPU tensors.  With a
cubemap environment `sky` samples it (ops/cubemap.py); the analytic
direct-light kernel samples the same table itself (ops/an_cuda.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..constants import EPS
from ..params import FrameParams, RenderParams, bind
from ..scene.bvh import BVHArrays, build_bvh_fast, bvh_to_arrays
from . import an_trace_cuda, bvh_cuda
from . import scene_analytic as sa
from .cubemap import texel_table
from .vecmath import normalize, v3


@dataclasses.dataclass(frozen=True)
class BVHDevice:
    """Skip-link BVH arrays as tensors on one device.  (The JAX package
    also carries MXU chunk pages here; the CUDA kernels walk the arrays
    themselves.)"""
    arrays: BVHArrays


def prepare_bvh(tris: np.ndarray, device) -> BVHDevice:
    """Build the skip-link BVH of world-space tris [T,9] as the JAX
    package's `prepare_bvh` does (`build_bvh_fast`: the g++ builder's
    tree) and place it on `device`."""
    from ..convert import bvh_from_numpy
    return bvh_from_numpy(bvh_to_arrays(build_bvh_fast(tris)), device)


def _deg2rad(x):
    return x * (math.pi / 180.0)


def dir_from_yaw_pitch(yaw_deg, pitch_deg):
    """Direction from yaw/pitch degrees, on the host
    (reference: src/render/render.cpp:35-51)."""
    yaw = _deg2rad(torch.tensor(yaw_deg, dtype=torch.float32))
    pitch = _deg2rad(torch.tensor(pitch_deg, dtype=torch.float32))
    d = v3(torch.cos(pitch) * torch.cos(yaw), torch.sin(pitch),
           torch.cos(pitch) * torch.sin(yaw))
    small = (d * d).sum() < 1e-6
    fallback = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32)
    return torch.where(small, fallback, normalize(d))


def compute_point_light_world_pos(params: RenderParams):
    """Base position + optional orbit offset, on the host
    (reference: src/render/render.cpp:8-31).  Orbit yaw/pitch use the
    camera-style basis (sy, sp, cy), distinct from dir_from_yaw_pitch."""
    base = torch.tensor(params.point_light_pos, dtype=torch.float32)
    if not params.point_light_orbit_enabled:
        return base
    yaw = _deg2rad(torch.tensor(params.point_light_yaw, dtype=torch.float32))
    pitch = _deg2rad(torch.tensor(params.point_light_pitch,
                                  dtype=torch.float32))
    d = v3(torch.cos(pitch) * torch.sin(yaw), torch.sin(pitch),
           torch.cos(pitch) * torch.cos(yaw))
    return base + d * max(float(np.float32(params.point_light_orbit_radius)),
                          0.0)


@dataclasses.dataclass(frozen=True)
class SceneCtx:
    """Per-frame scene inputs and the scene mode.  `params` reads its data
    fields from the frame's parameter block; the light vectors are views
    of that block."""
    params: FrameParams
    cam_pos: torch.Tensor          # [3]
    point_light_pos: torch.Tensor  # [3]
    sun_dir: torch.Tensor          # [3]
    sky_up: torch.Tensor           # [3]
    use_bvh: bool = False
    bvh: Optional[BVHDevice] = None
    env_map: Optional[torch.Tensor] = None  # [6,F,F,3] float32 or None

    @staticmethod
    def create(params, cam_pos: torch.Tensor, env_map=None,
               use_bvh: bool = False, bvh: Optional[BVHDevice] = None
               ) -> "SceneCtx":
        """The JAX signature.  `env_map` is the float32 [6,F,F,3] table of
        `convert.env_from_numpy` on the frame's device (a uint8 table is
        converted here, k / 255 by true division).  `params` is a
        RenderParams (bound to its cached parameter block on the frame's
        device) or a FrameParams on that device.

        The light vectors depend on the parameters alone: the host
        computes them into the parameter block (models/param_block.py),
        and the scene holds its views, so a warm frame makes no copy for
        them and the kernels read them by pointer."""
        if env_map is not None:
            f = env_map.shape[1] if env_map.dim() == 4 else 0
            if tuple(env_map.shape) != (6, f, f, 3):
                raise ValueError(f"env_map must be [6,F,F,3], got "
                                 f"{tuple(env_map.shape)}")
            env_map = texel_table(env_map).contiguous()
        if use_bvh and bvh is None:
            raise ValueError("use_bvh needs a BVHDevice")
        p = bind(params, cam_pos.device)
        return SceneCtx(
            params=p, cam_pos=cam_pos.to(torch.float32),
            point_light_pos=p["point_light_world"], sun_dir=p["sun_dir"],
            sky_up=p["sky_up"], use_bvh=use_bvh, bvh=bvh, env_map=env_map)

    def trace(self, ro, rd, eps: float = EPS, active=None) -> sa.Hit:
        """Closest hit against the BVH or the analytic scene.  `active`
        (bool, the rays' shape) marks the lanes whose hit the caller
        keeps; in BVH mode the others do not walk and read as misses, in
        the analytic scene they are unspecified on the card (the trace
        kernel leaves them unwritten; the CPU traces every lane), as in
        the JAX package's gates."""
        if self.use_bvh:
            return bvh_cuda.trace_closest(self.bvh.arrays, ro, rd, eps,
                                          active)
        return an_trace_cuda.trace(ro, rd, self.params, self.point_light_pos,
                                   True, True, eps, active)

    def trace_ignore_glass(self, ro, rd, eps: float = EPS,
                           active=None) -> sa.Hit:
        """The analytic scene without the glass sphere, for refraction
        paths; `active` as for `trace`."""
        return an_trace_cuda.trace(ro, rd, self.params, self.point_light_pos,
                                   False, True, eps, active)

    def sky(self, d, active=None):
        """The environment of directions `d`, sampled on the lanes
        `active` marks (bool, d's shape but the last axis; None: every
        lane; the others are unspecified on the card: the sky kernel,
        ops/an_trace_cuda.py)."""
        return an_trace_cuda.sky(d, self.params, self.env_map, active)
