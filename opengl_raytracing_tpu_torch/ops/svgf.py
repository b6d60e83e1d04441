"""SVGF-lite variance-guided spatial filter + present pass
(reference: shaders/rt/rt_present.frag:126-266).

Counterpart of `opengl_raytracing_tpu/ops/svgf.py`.  `svgf_filter` is the
plain PyTorch version of the 7x7 filter: 49 shifted slices of the
zero-padded planes, out-of-image taps weighted 0 like the GLSL
`continue`; `present_plain` composes it with `blend_tonemap`.  On the card
`present` is one launch of a CUDA kernel instead (ops/svgf_cuda.py: the
filter, replacing the TPU kernel svgf_pallas.py:_kernel, ending in the
blend, ACES and gamma; or those alone when SVGF is off).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..constants import YCOEFF
from ..params import RenderParams, bind, f32
from .tonemap import aces_tonemap, gamma_encode, visualize_motion
from .vecmath import dot, luminance, normalize, smoothstep

RADIUS = 3     # 7x7 kernel (rt_present.frag:169)
K_NRM = 2.0    # rt_present.frag:160
K_POS = 0.02   # rt_present.frag:161


def tone_params(params: RenderParams):
    """(blend strength clamped to [0, 1], exposure) as host float32 values:
    the parameter block's words that the present kernels read
    (csrc/svgf.cu `Tone`; models/param_block.py); the clamp is the
    host's."""
    return (f32(min(max(float(params.svgf_strength), 0.0), 1.0)),
            f32(params.exposure))


def svgf_filter(accum, motion, gpos, gnrm, params: RenderParams, *,
                halo: int = 0, row_offset: int = 0, full_height=None):
    """Variance/motion/GBuffer-aware 7x7 filter
    (reference: rt_present.frag:126-225).  accum [BH+2*halo,W,4] rgb+M2,
    motion/gpos/gnrm with the same rows; returns the filtered rgb of the
    BH centre rows [BH,W,3].

    `halo` rows at top and bottom are real neighbour data (a row band of
    a sharded image); tap validity is taken against the full image
    (`row_offset` is the band's first global row, `full_height` the
    image's height), so band seams filter like the whole image.

    The sums run in the kernel's order: dot products x, y, z; the taps
    dy outer, dx inner; normals normalised once."""
    rows, w = accum.shape[0], accum.shape[1]
    bh = rows - 2 * halo
    if full_height is None:
        full_height = bh
    p = bind(params, accum.device)

    def center(a):
        return a[halo:halo + bh]

    def padded(a):
        # pad once; each tap is then a slice of the padded plane
        return F.pad(a, (0, 0, RADIUS, RADIUS, RADIUS, RADIUS))

    def shift(ap, dy, dx):
        r0, c0 = RADIUS + halo + dy, RADIUS + dx
        return ap[r0:r0 + bh, c0:c0 + w]

    c_center = center(accum)[..., :3]
    m2_center = center(accum)[..., 3]
    mot = center(motion)
    gpos_c = center(gpos)
    l_center = luminance(c_center, YCOEFF)
    var_center = torch.clamp_max(
        torch.clamp_min(m2_center - l_center * l_center, 0.0),
        p["svgf_var_max"])
    mot_mag = torch.sqrt(mot[..., 0] * mot[..., 0] + mot[..., 1] * mot[..., 1])
    t = smoothstep(0.005, 0.05, mot_mag)
    # the parameter differences in float32, as the kernel takes them
    k_var = p["svgf_k_var"] + p["svgf_dk_var"] * t
    k_color = p["svgf_k_color"] + p["svgf_dk_color"] * t
    var_boost = 1.0 + var_center * (1.0 + k_var * 0.5)
    w_off_center = var_boost * (1.0 + var_center * 4.0)
    k_col_scale = k_color * 0.3 + 0.05

    gnrm_n = normalize(gnrm)
    n_center = center(gnrm_n)
    accum_p, gpos_p, gnrm_p = padded(accum), padded(gpos), padded(gnrm_n)
    dev = accum.device
    ix = torch.arange(w, device=dev)[None, :]
    iy = torch.arange(bh, device=dev)[:, None] + row_offset

    acc_col = torch.zeros_like(c_center)
    acc_w = torch.zeros((bh, w), dtype=torch.float32, device=dev)
    for j in range(-RADIUS, RADIUS + 1):
        for i in range(-RADIUS, RADIUS + 1):
            valid = ((ix + i >= 0) & (ix + i < w)
                     & (iy + j >= 0) & (iy + j < full_height))
            c = shift(accum_p, j, i)[..., :3]
            dc = c - c_center
            dp = shift(gpos_p, j, i) - gpos_c
            ndot = torch.clamp(dot(n_center, shift(gnrm_p, j, i)), -1.0, 1.0)
            expo = (dot(dc, dc) * k_col_scale + dot(dp, dp) * K_POS
                    + torch.clamp_min(1.0 - ndot, 0.0) * K_NRM)
            base = var_boost if (i == 0 and j == 0) else w_off_center
            wgt = torch.where(valid, base * torch.exp(-expo), 0.0)
            acc_col = acc_col + c * wgt[..., None]
            acc_w = acc_w + wgt

    out = acc_col / torch.clamp_min(acc_w, 1e-20)[..., None]
    return torch.where((acc_w <= 0.0)[..., None], c_center, out)


def _half_texel(a):
    """Every texel read from (x+1, y+1), clamped at the edges."""
    a = torch.cat([a[1:], a[-1:]], dim=0)
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def present(accum, motion, gpos, gnrm, params: RenderParams,
            show_motion: bool = False):
    """Present pass: motion debug | SVGF blend -> ACES -> gamma
    (reference: rt_present.frag:231-266).  Returns sRGB [H,W,3]; `accum`
    is only read.  `show_motion` returns the HSV wheel of `motion`
    (`tonemap.visualize_motion`, plain PyTorch on either device) in place
    of the image, after the texel shift below.

    ORT_PRESENT_HALF_TEXEL=1 reproduces the reference's one-texel quirk
    as the JAX package does: rt_present.frag:232 samples at
    (gl_FragCoord.xy + 0.5)/sz, so every fetch of the pass reads texel
    (x+1, y+1), clamped at the edges; shifting all pass inputs by one
    texel covers the whole stencil.  The default is texel-exact.

    CUDA tensors take one kernel launch, with SVGF on or off
    (ops/svgf_cuda.py: `svgf_present`, `tonemap`); CPU tensors run
    `present_plain`."""
    from . import svgf_cuda
    params = bind(params, accum.device)
    half_texel = os.environ.get("ORT_PRESENT_HALF_TEXEL", "0") == "1"
    if show_motion:
        return visualize_motion(_half_texel(motion) if half_texel else motion,
                                params["motion_scale"])
    if not params.enable_svgf:
        return svgf_cuda.tonemap(_half_texel(accum) if half_texel else accum,
                                 params)
    if half_texel:
        accum, motion, gpos, gnrm = (_half_texel(x)
                                     for x in (accum, motion, gpos, gnrm))
    return svgf_cuda.svgf_present(accum, motion, gpos, gnrm, params)


def present_plain(accum, motion, gpos, gnrm, params: RenderParams, *,
                  halo: int = 0, row_offset: int = 0, full_height=None):
    """The plain PyTorch version of the present pass on the inputs as
    given (no texel shift): `svgf_filter` when SVGF is on, then
    `blend_tonemap`.  With SVGF off only `accum` is read.  A row band's
    planes carry `halo` neighbour rows at top and bottom (as for
    `svgf_filter`); the pass presents the band's own rows."""
    raw = accum[halo:accum.shape[0] - halo, :, :3]
    if not params.enable_svgf:
        return blend_tonemap(raw, raw, params)
    return blend_tonemap(raw, svgf_filter(accum, motion, gpos, gnrm, params,
                                          halo=halo, row_offset=row_offset,
                                          full_height=full_height),
                         params)


def blend_tonemap(raw, filtered, params: RenderParams):
    """Shared present tail: SVGF strength blend -> ACES -> gamma
    (reference: rt_present.frag:244-266), the clamped strength and the
    exposure from the parameter block.  `filtered == raw` degrades to
    plain tonemapping."""
    p = bind(params, raw.device)
    linear = raw + (filtered - raw) * p["svgf_strength_clamped"]
    mapped = aces_tonemap(linear, p["exposure"])
    return gamma_encode(mapped)
