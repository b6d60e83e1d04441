"""Helpers of the tests of the parameter block (models/param_block.py).

* `block_at`: what a kernel reads through its parameter-block pointer.
  The kernels' argument structs carry a device pointer to the block; in
  the CPU tests that pointer is a host address, and `block_at` reads the
  block's words there as the kernel reads them, viewed by field.
* `seeded_values`: a value for every data field of RenderParams, drawn
  from a seed inside the ranges a user sets them to (none of them moves a
  host branch: `taa_still_thresh` stays > 0)."""

import ctypes

import numpy as np
import torch

from opengl_raytracing_tpu_torch.models import param_block
from opengl_raytracing_tpu_torch.params import DATA_FIELDS, RenderParams


def block_at(ptr: int) -> dict:
    """{field: float32 numpy array} of the block at host address `ptr`."""
    words = np.ctypeslib.as_array(
        (ctypes.c_int32 * param_block.WORDS).from_address(ptr)).copy()
    return {k: v.numpy() for k, v in
            param_block.views(torch.from_numpy(words)).items()}


# field -> (low, high) of the uniform draw; a colour draws each channel
RANGES = dict(
    exposure=(0.6, 1.8), mat_albedo_color=(0.1, 0.95),
    mat_albedo_spec_strength=(0.1, 0.6), mat_albedo_gloss=(8.0, 96.0),
    mat_glass_color=(0.6, 1.0), mat_glass_ior=(1.2, 1.8),
    mat_glass_distortion=(0.0, 0.2), mat_mirror_color=(0.6, 1.0),
    mat_mirror_gloss=(64.0, 512.0), jitter_still_scale=(0.1, 0.4),
    jitter_moving_scale=(0.3, 0.7), gi_scale_analytic=(0.1, 0.6),
    gi_scale_bvh=(0.1, 0.5), env_map_intensity=(0.5, 1.5),
    sun_color=(0.5, 1.0), sun_intensity=(0.2, 0.8), sun_yaw=(0.0, 360.0),
    sun_pitch=(-70.0, -15.0), sky_color=(0.3, 1.0),
    sky_intensity=(0.5, 1.5), sky_yaw=(0.0, 360.0), sky_pitch=(60.0, 90.0),
    point_light_color=(0.5, 1.0), point_light_intensity=(5.0, 30.0),
    point_light_pos=(-0.5, 0.5),  # an offset from the default position
    point_light_orbit_radius=(2.0, 4.0), point_light_orbit_speed=(5.0, 40.0),
    point_light_yaw=(-180.0, 180.0), point_light_pitch=(-20.0, 30.0),
    ao_radius=(0.4, 1.5), ao_bias=(1e-3, 5e-3), ao_min=(0.2, 0.8),
    taa_still_thresh=(5e-6, 5e-5), taa_hard_moving_thresh=(0.2, 0.5),
    taa_history_min_weight=(0.7, 0.9), taa_history_avg_weight=(0.85, 0.95),
    taa_history_max_weight=(0.9, 0.98), taa_history_box_size=(0.03, 0.1),
    svgf_var_max=(0.02, 0.1), svgf_k_var=(0.5, 2.0),
    svgf_k_color=(0.6, 2.0), svgf_k_var_motion=(0.4, 1.2),
    svgf_k_color_motion=(0.8, 2.5), svgf_strength=(0.3, 1.0),
    motion_scale=(2.0, 8.0))
assert set(RANGES) == set(DATA_FIELDS)


def seeded_values(seed: int) -> dict:
    """{data field: value}, every one drawn from `seed`."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in DATA_FIELDS:
        lo, hi = RANGES[name]
        default = getattr(RenderParams(), name)
        if isinstance(default, tuple):
            v = rng.uniform(lo, hi, 3)
            if name == "point_light_pos":
                v = np.asarray(default) + v
            out[name] = tuple(float(x) for x in v)
        else:
            out[name] = float(rng.uniform(lo, hi))
    return out
