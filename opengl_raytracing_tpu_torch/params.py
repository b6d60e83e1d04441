"""User-tunable render parameters.

PyTorch-side counterpart of `opengl_raytracing_tpu.params.RenderParams`
(reference: include/render/RenderParams.h:14-239): the same fields with the
same defaults, as a plain frozen dataclass.  Nothing is traced here, so
there is no data/metadata split: every field is a host value that the
frame function reads directly.
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


_META_FIELDS = tuple(
    f.name for f in dataclasses.fields(RenderParams) if f.type == "int"
)


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
        if f.name in _META_FIELDS:
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
