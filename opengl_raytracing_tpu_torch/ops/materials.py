"""Material table (reference: shaders/rt/rt_materials.glsl:20-133).

Counterpart of `opengl_raytracing_tpu/ops/materials.py`.
`get_material(mat_id, params)` looks the 5-row table of the analytic
scene up for a batch of material ids: its rows are the parameter block's
(models/param_block.py: `material_rows`, the glass/mirror "disabled ->
diffuse fallback" resolved on the host), the material type a where-select
chain on the static toggles.  The BVH scene shades every triangle as one
hard-coded white plastic and reads only the property bundle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import MAT_GLASS_SPHERE, MAT_MIRROR_SPHERE
from ..params import bind

MTYPE_DIFFUSE = 0
MTYPE_MIRROR = 1
MTYPE_GLASS = 2


class MaterialProps(NamedTuple):
    albedo: torch.Tensor         # [..., 3]
    spec_strength: torch.Tensor  # [...]
    gloss: torch.Tensor          # [...]
    mtype: torch.Tensor          # [...] int32
    ior: torch.Tensor            # [...]


def material_type(mat_id, params):
    """get_material's resolved type of int32 ids [...] (int32: diffuse,
    mirror or glass), a select chain on the static toggles alone, without
    the table's gathers (the frame's masks, models/pipeline.py)."""
    mtype = torch.full(mat_id.shape, MTYPE_DIFFUSE, dtype=torch.int32,
                       device=mat_id.device)
    if params.mat_glass_enabled:
        mtype = torch.where(mat_id == MAT_GLASS_SPHERE, MTYPE_GLASS, mtype)
    if params.mat_mirror_enabled:
        mtype = torch.where(mat_id == MAT_MIRROR_SPHERE, MTYPE_MIRROR, mtype)
    return mtype


def get_material(mat_id, params) -> MaterialProps:
    """Material properties of int32 ids [...]: rows 0-3 for ids 0-3 (floor,
    albedo, glass and mirror sphere), the last row (grey diffuse) for any
    other id, as the marker (reference: rt_materials.glsl:118-124)."""
    p = bind(params, mat_id.device)
    row = torch.where((mat_id >= 0) & (mat_id < 4), mat_id, 4).long()
    return MaterialProps(p["mat_albedo"][row], p["mat_spec"][row],
                         p["mat_gloss"][row], material_type(mat_id, p),
                         p["mat_ior"][row])
