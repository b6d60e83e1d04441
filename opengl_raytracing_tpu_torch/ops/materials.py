"""Material table (reference: shaders/rt/rt_materials.glsl:20-133).

Counterpart of `opengl_raytracing_tpu/ops/materials.py`.
`get_material(mat_id, params)` evaluates the 5-entry table of the
analytic scene for a batch of material ids with a where-select chain; the
glass/mirror "disabled -> diffuse fallback" branches are resolved from the
RenderParams toggles on the host.  The BVH scene shades every triangle as
one hard-coded white plastic and reads only the property bundle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import (MAT_FLOOR, MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE,
                         MAT_MIRROR_SPHERE)
from ..params import RenderParams
from .vecmath import const3

MTYPE_DIFFUSE = 0
MTYPE_MIRROR = 1
MTYPE_GLASS = 2


class MaterialProps(NamedTuple):
    albedo: torch.Tensor         # [..., 3]
    spec_strength: torch.Tensor  # [...]
    gloss: torch.Tensor          # [...]
    mtype: torch.Tensor          # [...] int32
    ior: torch.Tensor            # [...]


def get_material(mat_id, params: RenderParams) -> MaterialProps:
    """Material properties of int32 ids [...]."""
    shape = mat_id.shape
    dev = mat_id.device

    def full3(v):
        return const3(v, dev).expand(shape + (3,))

    def full(v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    def sel(cond, a, b):
        return torch.where(cond, a, b)

    def sel3(cond, a, b):
        return torch.where(cond[..., None], a, b)

    # Fallback (point-light marker / unknown): grey diffuse
    # (reference: rt_materials.glsl:118-124).
    albedo = full3((0.8, 0.8, 0.8))
    spec = full(0.2)
    gloss = full(16.0)
    mtype = full(MTYPE_DIFFUSE, torch.int32)
    ior = full(1.0)

    # GUI-driven albedo sphere values (also the disabled-glass/mirror
    # fallback).
    ui_albedo = full3(params.mat_albedo_color)
    ui_spec = full(params.mat_albedo_spec_strength)
    ui_gloss = full(params.mat_albedo_gloss)

    is_floor = mat_id == MAT_FLOOR
    albedo = sel3(is_floor, full3((0.7, 0.7, 0.7)), albedo)
    spec = sel(is_floor, 0.1, spec)
    gloss = sel(is_floor, 16.0, gloss)

    is_albedo = mat_id == MAT_ALBEDO_SPHERE
    albedo = sel3(is_albedo, ui_albedo, albedo)
    spec = sel(is_albedo, ui_spec, spec)
    gloss = sel(is_albedo, ui_gloss, gloss)

    is_glass = mat_id == MAT_GLASS_SPHERE
    if params.mat_glass_enabled:
        # spec_strength carries the distortion knob for shadeGlass
        # (reference: rt_materials.glsl:91).
        albedo = sel3(is_glass, full3(params.mat_glass_color), albedo)
        spec = sel(is_glass, full(params.mat_glass_distortion), spec)
        gloss = sel(is_glass, 1.0, gloss)
        mtype = sel(is_glass, MTYPE_GLASS, mtype)
        ior = sel(is_glass, full(params.mat_glass_ior), ior)
    else:
        albedo = sel3(is_glass, ui_albedo, albedo)
        spec = sel(is_glass, ui_spec, spec)
        gloss = sel(is_glass, ui_gloss, gloss)

    is_mirror = mat_id == MAT_MIRROR_SPHERE
    if params.mat_mirror_enabled:
        albedo = sel3(is_mirror, full3(params.mat_mirror_color), albedo)
        spec = sel(is_mirror, 0.0, spec)
        gloss = sel(is_mirror, full(params.mat_mirror_gloss), gloss)
        mtype = sel(is_mirror, MTYPE_MIRROR, mtype)
    else:
        albedo = sel3(is_mirror, ui_albedo, albedo)
        spec = sel(is_mirror, ui_spec, spec)
        gloss = sel(is_mirror, ui_gloss, gloss)

    return MaterialProps(albedo, spec, gloss, mtype, ior)
