"""User-tunable render parameters.

PyTorch-side counterpart of `opengl_raytracing_tpu.params.RenderParams`
(reference: include/render/RenderParams.h:14-239): the same fields with the
same defaults, as a plain frozen dataclass, and the JAX package's split of
them:

  * `STATIC_FIELDS` (JAX's pytree metadata: the int toggles and counts)
    change the frame's operations, so a captured frame (models/graph.py)
    is keyed on them (`static_key`);
  * `DATA_FIELDS` (JAX's traced data: every float and colour) reach the
    frame only through its device parameter block
    (models/param_block.py), so moving a slider replays the captured
    frame.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Color = Tuple[float, float, float]


def f32(x) -> float:
    """A host value rounded to float32, as the JAX package traces its
    float fields (and products of them) under jit."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class RenderParams:
    # -- Core render settings (reference: RenderParams.h:19-23) --
    spp_per_frame: int = 1
    exposure: float = 1.0

    # -- Materials (reference: RenderParams.h:29-57) --
    mat_albedo_color: Color = (0.85, 0.25, 0.25)
    mat_albedo_spec_strength: float = 0.35
    mat_albedo_gloss: float = 48.0
    mat_glass_enabled: int = 1
    mat_glass_color: Color = (0.95, 0.98, 1.0)
    mat_glass_ior: float = 1.5
    mat_glass_distortion: float = 0.05
    mat_mirror_enabled: int = 1
    mat_mirror_color: Color = (1.0, 1.0, 1.0)
    mat_mirror_gloss: float = 256.0

    # -- Jitter / AA (reference: RenderParams.h:64-70) --
    enable_jitter: int = 1
    jitter_still_scale: float = 0.25
    jitter_moving_scale: float = 0.5

    # -- Global illumination (reference: RenderParams.h:77-83) --
    enable_gi: int = 1
    gi_scale_analytic: float = 0.35
    gi_scale_bvh: float = 0.20

    # -- Environment map (reference: RenderParams.h:89-93) --
    enable_env_map: int = 1
    env_map_intensity: float = 1.0

    # -- Sun / sky / point lights (reference: RenderParams.h:100-154) --
    sun_enabled: int = 1
    sun_color: Color = (1.0, 0.95, 0.85)
    sun_intensity: float = 0.45
    sun_yaw: float = 45.0
    sun_pitch: float = -35.0
    sky_enabled: int = 1
    sky_color: Color = (0.4, 0.5, 1.0)
    sky_intensity: float = 1.0
    sky_yaw: float = 0.0
    sky_pitch: float = 90.0
    point_light_enabled: int = 1
    point_light_color: Color = (1.0, 0.9, 0.7)
    point_light_intensity: float = 20.0
    point_light_pos: Color = (0.0, 2.5, -3.0)
    point_light_orbit_enabled: int = 0
    # Traversal schedule of the JAX package's TPU kernels (0/1/2=auto).
    # Kept so parameter sets convert field for field; it never changes
    # radiance, and the port's per-ray walk has no schedule to pick.
    ordered_primary: int = 2
    point_light_orbit_radius: float = 3.5
    point_light_orbit_speed: float = 20.0
    point_light_yaw: float = 0.0
    point_light_pitch: float = 0.0

    # -- Ambient occlusion (reference: RenderParams.h:161-173) --
    enable_ao: int = 1
    ao_samples: int = 4
    ao_radius: float = 0.8
    ao_bias: float = 2e-3
    ao_min: float = 0.5

    # -- TAA (reference: RenderParams.h:180-198) --
    enable_taa: int = 1
    taa_still_thresh: float = 1e-5
    taa_hard_moving_thresh: float = 0.35
    taa_history_min_weight: float = 0.85
    taa_history_avg_weight: float = 0.92
    taa_history_max_weight: float = 0.96
    taa_history_box_size: float = 0.06

    # -- SVGF (reference: RenderParams.h:205-223) --
    enable_svgf: int = 1
    svgf_var_max: float = 0.05
    svgf_k_var: float = 1.0
    svgf_k_color: float = 1.2
    svgf_k_var_motion: float = 0.8
    svgf_k_color_motion: float = 1.5
    svgf_strength: float = 0.7

    # -- Debug (reference: RenderParams.h:238) --
    motion_scale: float = 4.0

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)


STATIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(RenderParams) if f.type == "int"
)
DATA_FIELDS = tuple(
    f.name for f in dataclasses.fields(RenderParams) if f.type != "int"
)


def static_key(params: RenderParams) -> tuple:
    """The static fields' values, in field order: what a captured frame is
    valid for (its data fields come from the parameter block)."""
    return tuple(int(getattr(params, name)) for name in STATIC_FIELDS)


def host_branches(params: RenderParams) -> tuple:
    """The outcomes of the host branches on data fields: the frame's
    operations depend on these, not on the values.  TAA skips its moving
    path on a still camera only at `taa_still_thresh > 0`, as the JAX
    package guards (ops/taa.py, parallel/shardmap.py).  `params` a
    RenderParams or a FrameParams."""
    if isinstance(params, FrameParams):
        params = params.host
    return (("taa_still_thresh > 0", f32(params.taa_still_thresh) > 0.0),)


def _as_floats(x):
    if isinstance(x, tuple):
        return tuple(float(v) for v in x)
    return float(x)


def params_changed(a: RenderParams, b: RenderParams, tol: float = 1e-5) -> bool:
    """Field-by-field diff; True triggers accumulation reset.

    Mirrors `app_detail::paramsChanged`
    (reference: src/app/application.cpp:51-145): int fields compare exactly,
    float fields compare with |x - y| > 1e-5.  `ordered_primary` (a
    traversal schedule), `exposure` and `motion_scale` (tonemap and debug
    view only) are left out, as the reference leaves out the last two.
    """
    for f in dataclasses.fields(RenderParams):
        if f.name in ("ordered_primary", "exposure", "motion_scale"):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in STATIC_FIELDS:
            if int(va) != int(vb):
                return True
        else:
            va, vb = _as_floats(va), _as_floats(vb)
            if isinstance(va, tuple):
                if any(abs(x - y) > tol for x, y in zip(va, vb)):
                    return True
            elif abs(va - vb) > tol:
                return True
    return False


# The static fields the parameter block's derived words depend on: a
# FrameParams cannot replace them without a new block.
_BLOCK_STATIC = ("point_light_orbit_enabled", "mat_glass_enabled",
                 "mat_mirror_enabled")


class FrameParams:
    """The parameters as a frame reads them (models/param_block.py): the
    static fields as host values (`p.enable_gi`), every data field and
    derived value as a float32 view of the device block (`p["sun_li"]`).
    A data field read as an attribute raises, so no value of one can reach
    a frame as a host number.  `host` is the RenderParams itself, for
    `host_branches` and the graph key."""

    __slots__ = ("host", "block", "views")

    def __init__(self, host: RenderParams, block, views: dict):
        self.host, self.block, self.views = host, block, views

    def __getattr__(self, name):
        if name in STATIC_FIELDS:
            return getattr(self.host, name)
        if name in DATA_FIELDS:
            raise AttributeError(f"{name} is data: a frame reads it from "
                                 f"the parameter block, p[{name!r}]")
        raise AttributeError(name)

    def __getitem__(self, name):
        return self.views[name]

    @property
    def device(self):
        return self.block.device

    def replace(self, **static) -> "FrameParams":
        """These parameters with other values of static fields that the
        block does not depend on; the same block."""
        bad = [k for k in static
               if k not in STATIC_FIELDS or k in _BLOCK_STATIC]
        if bad:
            raise ValueError(f"a FrameParams replaces only the static fields "
                             f"its block does not depend on, not {bad}")
        return FrameParams(self.host.replace(**static), self.block,
                           self.views)


def bind(params, device, block=None) -> FrameParams:
    """`params` (RenderParams or FrameParams) as a frame on `device` reads
    them.  A FrameParams is returned as it is (it must lie on `device`).  A
    RenderParams reads `block` when given (a block holding its words, as a
    captured frame's static block does), else its cached block there
    (models/param_block.py)."""
    device = _device(device)
    if isinstance(params, FrameParams):
        if block is not None:
            raise ValueError("a FrameParams already has its block")
        if params.block.device != device:
            raise ValueError(f"the parameter block is on "
                             f"{params.block.device}, the frame on {device}")
        return params
    from .models import param_block
    if block is None:
        block = param_block.block(params, device)
    return FrameParams(params, block, param_block.views(block))


def _device(device):
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
