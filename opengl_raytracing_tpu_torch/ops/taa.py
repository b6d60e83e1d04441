"""TAA resolve with history variance tracking
(reference: shaders/rt/rt_taa.glsl:47-180).

Counterpart of `opengl_raytracing_tpu/ops/taa.py`.  Operates on the whole
[H,W] image, or on a row band of it against the whole history
(`row_offset`, parallel/shardmap.py); history fetches are NEAREST +
CLAMP_TO_EDGE texel gathers, matching the accum texture parameters
(reference: src/render/accum.cpp:11-14).  Rows follow GL's bottom-up y,
so UV math carries over 1:1.

The frame index is the device frame (`sampling.FrameValue`): the still
weights and the first frame's passthrough are selects on the device, as
in the JAX package's branch-free form, which pick the same float32
constants as its branches do, and the frame's operations are the same for
every frame index.

Whether the camera moved is known on the host (`FrameInputs.moved`), so
the JAX package's `lax.cond` skip is a Python branch here and costs no
device read: with `moved=False` only the still weights are computed, no
reprojection gather and none of the moving path's ops.  With a static
camera the caller zeroes the motion, every pixel of the branch-free form
takes the still branch of its per-pixel select and reads its own texel,
so the skip returns the same bits.  `moved=None` (unknown) keeps the
branch-free form.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constants import YCOEFF
from ..params import RenderParams, bind, host_branches
from ..sampling import Frame, frame_value
from .vecmath import div_host_scalar, luminance, smoothstep

TAA_SOFT_MOTION = 0.02  # the motion where history starts to fade


def _sample_nearest(tex, u, v):
    """NEAREST + CLAMP_TO_EDGE fetch of tex [H,W,C] at uv in [0,1]: one
    row gather of the flat [H*W, C] texture."""
    h, w = tex.shape[0], tex.shape[1]
    x = torch.clamp(torch.floor(u * w), 0, w - 1).to(torch.int64)
    y = torch.clamp(torch.floor(v * h), 0, h - 1).to(torch.int64)
    return tex.reshape(h * w, -1)[y * w + x]


def still_skips(params) -> bool:
    """Whether a frame the host knows to be still skips the moving path:
    only at `taa_still_thresh > 0` (at a threshold <= 0 zero motion is not
    "still"), a host branch whose outcome the graph key holds."""
    return dict(host_branches(params))["taa_still_thresh > 0"]


def _store(col, m2, out):
    if out is None:
        return torch.cat([col, m2[..., None]], dim=-1)
    out[..., :3] = col
    out[..., 3] = m2
    return out


def _still_weights(frame_index: Frame, params):
    """(history weight, current weight, first frame) of the still path
    (rt_taa.glsl:66-68,86-105): 0-d tensors on the frame's device, the
    weights the parameter block's float32 words."""
    fi = frame_value(frame_index)
    p = bind(params, fi.device)
    early, mid = fi < 8, fi < 32
    w_curr = p["taa_w_curr"]

    def select(a, b, c):
        return torch.where(early, a, torch.where(mid, b, c))
    return (select(p["taa_history_min_weight"], p["taa_history_avg_weight"],
                   p["taa_history_max_weight"]),
            select(w_curr[0], w_curr[1], w_curr[2]), fi == 0)


def resolve_taa(curr, motion, prev_accum, frame_index: Frame,
                params: RenderParams, out=None,
                moved: Optional[bool] = None, row_offset: int = 0):
    """Blend the current frame with its (reprojected) history.

    curr [BH,W,3] linear colour; motion [BH,W,2] NDC motion, already
    zeroed by the caller when the camera is static (reference:
    rt.frag:188); prev_accum [H,W,4] rgb + M2, the whole history:
    reprojection may read anywhere; frame_index the device frame
    (`sampling.FrameValue`).  When curr is
    a row band of the image, `row_offset` is its first row in prev_accum
    (the still path reads rows row_offset .. row_offset + BH of it).
    Returns [BH,W,4] (colour, M2).  Without TAA the frame is stored with
    its luminance squared as M2, which SVGF reads as variance
    (rt_taa.glsl:58-61).

    `moved` is the host's knowledge of the camera: False (with
    `taa_still_thresh > 0`, the JAX package's guard: at a threshold <= 0
    zero motion is not "still") skips the moving path, which then equals
    the branch-free form bit for bit given the zeroed motion; True or None
    run the branch-free form.

    `out` may be the [BH,W,4] buffer to write into, `prev_accum` itself
    included when it holds only the band (row_offset 0): every value of
    the result is computed before the first write, so the moving path's
    gather never reads an updated pixel (the still path reads only a
    pixel's own texel).  It must not alias a history with more rows than
    the band: another band's pixels would be overwritten."""
    params = bind(params, curr.device)
    l_curr = luminance(curr, YCOEFF)
    l_curr2 = l_curr * l_curr
    if not params.enable_taa:
        # no TAA: no history (rt_taa.glsl:58-61)
        return _store(curr, l_curr2, out)
    w_still, w_curr_still, first = _still_weights(frame_index, params)

    def store(col, m2):
        # the first frame's passthrough (no history, rt_taa.glsl:66-68),
        # selected as the result is stored (no pass of its own)
        if out is None:
            return torch.cat([torch.where(first, curr, col),
                              torch.where(first, l_curr2, m2)[..., None]],
                             dim=-1)
        torch.where(first, curr, col, out=out[..., :3])
        torch.where(first, l_curr2, m2, out=out[..., 3])
        return out

    bh, w = curr.shape[0], curr.shape[1]
    if moved is False and still_skips(params):
        # the camera is still: every pixel blends with its own texel
        prev = prev_accum[row_offset:row_offset + bh]
        return store(prev[..., :3] * w_still + curr * w_curr_still,
                     prev[..., 3] * w_still + l_curr2 * w_curr_still)

    dev = curr.device
    uvx = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5)
           / w)[None, :].expand(bh, w)
    # the band's global rows: the pixel centres are exact in float32
    uvy = ((torch.arange(row_offset, row_offset + bh, dtype=torch.float32,
                         device=dev) + 0.5)
           / prev_accum.shape[0])[:, None].expand(bh, w)
    mot_mag = torch.sqrt(motion[..., 0] * motion[..., 0]
                         + motion[..., 1] * motion[..., 1])
    box = params["taa_history_box_size"]

    # moving: reproject (rt_taa.glsl:116-179).  One history fetch for both
    # per-pixel cases: still pixels read their own texel.
    uv_prev_x = uvx - motion[..., 0] * 0.5
    uv_prev_y = uvy - motion[..., 1] * 0.5
    oob = ((uv_prev_x < 0.0) | (uv_prev_x > 1.0)
           | (uv_prev_y < 0.0) | (uv_prev_y > 1.0))
    still_px = mot_mag < params["taa_still_thresh"]
    prev = _sample_nearest(prev_accum, torch.where(still_px, uvx, uv_prev_x),
                           torch.where(still_px, uvy, uv_prev_y))
    prev_col, prev_m2 = prev[..., :3], prev[..., 3]
    col_still = prev_col * w_still + curr * w_curr_still
    m2_still = prev_m2 * w_still + l_curr2 * w_curr_still

    hard = params["taa_hard_moving_thresh"]
    # smoothstep(0.02, hard, mot_mag), its span from the block
    t = torch.clamp(div_host_scalar(mot_mag - TAA_SOFT_MOTION,
                                    params["taa_hard_span"],
                                    params["taa_hard_span_inv"]), 0.0, 1.0)
    w_hist = 1.0 - t * t * (3.0 - 2.0 * t)
    w_hist = torch.where(mot_mag > hard, 0.0, w_hist)
    l_prev = luminance(prev_col, YCOEFF)
    max_l = torch.clamp_min(torch.maximum(l_curr, l_prev), 1e-3)
    rel_diff = (l_curr - l_prev).abs() / max_l
    w_hist = w_hist * (1.0 - smoothstep(0.03, 0.25, rel_diff))
    w_hist = torch.where((mot_mag > 0.02) & (rel_diff > 0.30), 0.0, w_hist)
    w_hist = torch.clamp_max(torch.clamp_min(w_hist, 0.0),
                             params["taa_history_max_weight"])
    w_cur = 1.0 - w_hist
    hist_col = torch.minimum(torch.maximum(prev_col, curr - box), curr + box)
    taa_col = w_hist[..., None] * hist_col + w_cur[..., None] * curr
    m2_new = w_hist * prev_m2 + w_cur * l_curr2
    # out-of-bounds reprojection: passthrough (rt_taa.glsl:124-127)
    col_mov = torch.where(oob[..., None], curr, taa_col)
    m2_mov = torch.where(oob, l_curr2, m2_new)

    col = torch.where(still_px[..., None], col_still, col_mov)
    m2 = torch.where(still_px, m2_still, m2_mov)
    return store(col, m2)
