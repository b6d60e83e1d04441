"""The parameter block: every data field of a `RenderParams`, and every
value the host derives from them, in one small device tensor.

The JAX package traces `RenderParams`' float and colour fields (its pytree
data), so one compiled frame serves every slider value.  Here a frame
reads them, and the values derived from them on the host, from one int32
[WORDS] block on its device, viewed as float32 (`views`), so that

  * a captured CUDA graph of the frame (models/graph.py) is keyed on the
    static fields alone and replays for any value of the others: the point
    light's orbit and every slider of the viewer replay one graph;
  * the kernels read the same block by pointer (csrc/param_block.cuh, the
    C mirror of `FIELDS`), as they read the frame's record.

The derived words are computed on the host exactly as the frame computed
them before it read a block, so their bits do not move: the point light's
world position (its orbit offset included), the sun's direction and the
sky's up vector, the float32 products of a colour and its intensity, the
gradient sky's ends, `get_material`'s table with the glass and mirror
toggles resolved, and the float32 constants of TAA, AO and SVGF.

A block is made once per (parameters, device) and cached (`block`); on a
card it is filled by one `non_blocking` copy from a pinned staging slot
(`frame_block.stage`).  A warm frame with unchanged parameters makes no
copy for it.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..constants import (MAT_FLOOR, MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE,
                         MAT_MIRROR_SPHERE)
from ..params import DATA_FIELDS, RenderParams, f32
from ..ops.svgf import tone_params
from ..ops.taa import TAA_SOFT_MOTION
from . import frame_block

# Values of the derived words that are not parameters: the gradient sky's
# colours (ops/scene_analytic.sky) and get_material's fixed rows.
SKY_TOP, SKY_BOTTOM, SKY_SCALE = (0.6, 0.7, 0.9), (0.1, 0.15, 0.3), 0.3
MAT_ROWS = 5  # material ids 0-3 (floor, albedo, glass, mirror), then the rest


def _layout(fields):
    out, at = {}, 0
    for name, shape in fields:
        out[name] = (at, shape)
        at += int(np.prod(shape, dtype=np.int64))
    return out, at


_DEFAULTS = RenderParams()
# name -> (first word, shape): the data fields in field order, then the
# derived values; every word is float32
FIELDS, USED = _layout(
    [(name, (3,) if isinstance(getattr(_DEFAULTS, name), tuple) else ())
     for name in DATA_FIELDS]
    + [("point_light_world", (3,)),  # point_light_pos with the orbit
       ("sun_dir", (3,)), ("sky_up", (3,)),
       ("sun_li", (3,)), ("sky_li", (3,)),  # colour * intensity
       ("sky_top", (3,)), ("sky_bottom", (3,)),
       ("mat_albedo", (MAT_ROWS, 3)), ("mat_spec", (MAT_ROWS,)),
       ("mat_gloss", (MAT_ROWS,)), ("mat_ior", (MAT_ROWS,)),
       ("ao_span", ()),                     # 1 - ao_min
       ("taa_w_curr", (3,)),                # 1 - the min/avg/max weights
       ("taa_hard_span", ()),               # hard threshold - 0.02
       ("taa_hard_span_inv", ()),           # 1 / that, in float32
       ("svgf_strength_clamped", ()),       # svgf_strength in [0, 1]
       ("svgf_dk_var", ()), ("svgf_dk_color", ())])  # motion - still
WORDS = 128  # a 512-byte block
assert USED <= WORDS
DERIVED = tuple(FIELDS)[len(DATA_FIELDS):]


def material_rows(params: RenderParams):
    """get_material's table (reference: rt_materials.glsl:20-133) as host
    float32 rows for ids 0-3 and a last row for every other id: (albedo
    [5,3], spec [5], gloss [5], ior [5]), the glass and mirror toggles
    resolved.  A disabled glass or mirror sphere shades as the albedo
    sphere; the glass row's spec carries the distortion knob."""
    p = params
    ui = (p.mat_albedo_color, p.mat_albedo_spec_strength, p.mat_albedo_gloss,
          1.0)
    rows = {MAT_FLOOR: ((0.7, 0.7, 0.7), 0.1, 16.0, 1.0),
            MAT_ALBEDO_SPHERE: ui,
            MAT_GLASS_SPHERE: ((p.mat_glass_color, p.mat_glass_distortion,
                                1.0, p.mat_glass_ior)
                               if p.mat_glass_enabled else ui),
            MAT_MIRROR_SPHERE: ((p.mat_mirror_color, 0.0,
                                 p.mat_mirror_gloss, 1.0)
                                if p.mat_mirror_enabled else ui)}
    table = [rows[i] for i in range(MAT_ROWS - 1)] \
        + [((0.8, 0.8, 0.8), 0.2, 16.0, 1.0)]
    albedo = np.float32([r[0] for r in table])
    return (albedo,) + tuple(np.float32([r[k] for r in table])
                             for k in (1, 2, 3))


def _product(color, scale) -> np.ndarray:
    # a float32 tensor times a host float: the float rounded to float32
    return (torch.tensor(color, dtype=torch.float32) * scale).numpy()


def derived(params: RenderParams) -> dict:
    """{derived word: host float32 value} of `params` (module docstring)."""
    from ..ops.scene import compute_point_light_world_pos, dir_from_yaw_pitch
    p = params
    albedo, spec, gloss, ior = material_rows(p)
    weights = [f32(getattr(p, f"taa_history_{k}_weight"))
               for k in ("min", "avg", "max")]
    span = f32(f32(p.taa_hard_moving_thresh) - TAA_SOFT_MOTION)
    k_var, k_col = f32(p.svgf_k_var), f32(p.svgf_k_color)
    return dict(
        point_light_world=compute_point_light_world_pos(p).numpy(),
        sun_dir=dir_from_yaw_pitch(p.sun_yaw, p.sun_pitch).numpy(),
        sky_up=dir_from_yaw_pitch(p.sky_yaw, p.sky_pitch).numpy(),
        sun_li=_product(p.sun_color, p.sun_intensity),
        sky_li=_product(p.sky_color, p.sky_intensity),
        sky_top=_product(SKY_TOP, SKY_SCALE),
        sky_bottom=_product(SKY_BOTTOM, SKY_SCALE),
        mat_albedo=albedo, mat_spec=spec, mat_gloss=gloss, mat_ior=ior,
        ao_span=f32(1.0 - f32(p.ao_min)),
        taa_w_curr=np.float32([f32(1.0 - w) for w in weights]),
        taa_hard_span=span,
        # as PyTorch's CUDA `x / host_float` takes it (ops/vecmath.py)
        taa_hard_span_inv=np.float32(1.0) / np.float32(span),
        svgf_strength_clamped=tone_params(p)[0],
        svgf_dk_var=f32(f32(p.svgf_k_var_motion) - k_var),
        svgf_dk_color=f32(f32(p.svgf_k_color_motion) - k_col))


def pack(params: RenderParams) -> np.ndarray:
    """The host words of `params`' block: its data fields and derived
    values as float32, the unused words zero."""
    words = np.zeros(WORDS, np.int32)
    floats = words.view(np.float32)
    values = {name: getattr(params, name) for name in DATA_FIELDS}
    values.update(derived(params))
    for name, (at, shape) in FIELDS.items():
        n = int(np.prod(shape, dtype=np.int64))
        floats[at:at + n] = np.asarray(values[name], np.float32).reshape(-1)
    return words


def views(block: torch.Tensor) -> dict:
    """{field: float32 tensor view of `block`} for every field."""
    floats = block.view(torch.float32)
    return {name: floats[at:at + int(np.prod(shape, dtype=np.int64))]
            .view(shape) for name, (at, shape) in FIELDS.items()}


MAX_BLOCKS = 64  # the orbit makes new parameters every step
_BLOCKS: "collections.OrderedDict" = collections.OrderedDict()


def block(params: RenderParams, device) -> torch.Tensor:
    """`params`' block on `device`, made once (one host-to-device copy on a
    card) and shared; read-only by contract."""
    key = (params, torch.device(device))
    got = _BLOCKS.get(key)
    if got is None:
        got = _BLOCKS[key] = frame_block.stage(pack(params), device)
        while len(_BLOCKS) > MAX_BLOCKS:
            _BLOCKS.popitem(last=False)
    else:
        _BLOCKS.move_to_end(key)
    return got
