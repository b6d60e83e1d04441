"""Wrappers of the CUDA present-pass kernels in csrc/svgf.cu.

Each takes the arguments of its plain version in ops/svgf.py: the whole
image or, for the two filter entries, a row band with its halo rows:

  * `svgf_filter`: the 7x7 variance-guided filter alone (replaces the TPU
    kernel `opengl_raytracing_tpu/ops/svgf_pallas.py:_kernel`), plain
    version `svgf.svgf_filter`;
  * `svgf_present`: the same kernel body ending in the strength blend,
    ACES and gamma, one launch and no filtered image in device memory;
    plain version `svgf.present_plain` with SVGF on;
  * `tonemap`: ACES and gamma of accum's rgb, the present pass with SVGF
    off, one launch; plain version `svgf.present_plain` with SVGF off.

CPU tensors run the plain version.  CUDA tensors launch the kernel, or
the call raises: nothing falls back to the plain version on the card.

The kernels read the HWC planes as they are (accum [H,W,4], motion
[H,W,2], gpos and gnrm [H,W,3]; a band's [BH + 2*halo, W, C] with its
halo rows, its first row and the image's height) and a pointer to the
parameter block (models/param_block.py), whose five `svgf_*` words, the
clamped blend strength and the exposure they read: the arguments are the
same for every value of them, so a captured frame replays the call.  They are built and launched through ops/cuda_lib.py, each counted
under its own name (`LAUNCHES["svgf"]`, `LAUNCHES["svgf_present"]`,
`LAUNCHES["tonemap"]`).
Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import RenderParams
from . import cuda_lib
from .cuda_lib import check
from .svgf import present_plain, svgf_filter as svgf_filter_plain

_P, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ort_svgf": ([_P, _P, _P, _P] + [_I32] * 5 + [_P, _P, _P], ctypes.c_int),
    "ort_svgf_present": ([_P, _P, _P, _P] + [_I32] * 5 + [_P, _P, _P],
                         ctypes.c_int),
    "ort_tonemap": ([_P, _I32, _I32, _P, _P, _P], ctypes.c_int),
}


def _band(rows, halo, row_offset, full_height):
    """(band rows, full height) of planes with `rows` rows; raise on a
    band that does not fit them or the image."""
    bh = rows - 2 * halo
    full_height = bh if full_height is None else full_height
    if halo < 0 or bh < 0 or row_offset < 0 \
            or row_offset + bh > full_height:
        raise ValueError(f"a band of {bh} rows with halo {halo} at row "
                         f"{row_offset} does not fit planes of {rows} rows "
                         f"and an image of {full_height}")
    return bh, full_height


def _filter_launch(kernel, accum, motion, gpos, gnrm, halo, row_offset,
                   full_height, params):
    """Check the four planes, launch C entry `ort_<kernel>` of the filter
    body on their band with the parameter block of `params`, counted
    under `kernel`, and return its [BH,W,3] output."""
    device = cuda_lib.cuda_device(accum, "the SVGF kernels")
    rows, w = accum.shape[0], accum.shape[1]
    bh, full_height = _band(rows, halo, row_offset, full_height)
    check("accum", accum, torch.float32, (rows, w, 4), device, align=16)
    check("motion", motion, torch.float32, (rows, w, 2), device)
    check("gpos", gpos, torch.float32, (rows, w, 3), device)
    check("gnrm", gnrm, torch.float32, (rows, w, 3), device)
    prm = cuda_lib.param_block_ptr(params, device)
    out = torch.empty((bh, w, 3), dtype=torch.float32, device=device)
    lib = cuda_lib.library("svgf", _SIGNATURES)
    cuda_lib.launch(getattr(lib, f"ort_{kernel}"), kernel, device,
                    accum.data_ptr(), motion.data_ptr(), gpos.data_ptr(),
                    gnrm.data_ptr(), bh, w, halo, row_offset, full_height,
                    prm, out.data_ptr())
    return out


def svgf_filter(accum, motion, gpos, gnrm, params: RenderParams, *,
                halo: int = 0, row_offset: int = 0, full_height=None):
    """Filtered rgb [BH,W,3] of the whole image, or of a row band whose
    planes carry `halo` neighbour rows at top and bottom, its first row
    at `row_offset` of an image `full_height` rows high (the contract of
    ops/svgf.py:svgf_filter)."""
    if accum.device.type == "cpu":
        return svgf_filter_plain(accum, motion, gpos, gnrm, params,
                                 halo=halo, row_offset=row_offset,
                                 full_height=full_height)
    return _filter_launch("svgf", accum, motion, gpos, gnrm, halo,
                          row_offset, full_height, params)


def svgf_present(accum, motion, gpos, gnrm, params: RenderParams, *,
                 halo: int = 0, row_offset: int = 0, full_height=None):
    """sRGB [BH,W,3]: the filtered image blended with accum's rgb by
    `svgf_strength`, ACES, gamma; a band as for `svgf_filter`.  `accum`
    is only read."""
    if accum.device.type == "cpu":
        return present_plain(accum, motion, gpos, gnrm,
                             params.replace(enable_svgf=1), halo=halo,
                             row_offset=row_offset, full_height=full_height)
    return _filter_launch("svgf_present", accum, motion, gpos, gnrm, halo,
                          row_offset, full_height, params)


def tonemap(accum, params: RenderParams):
    """sRGB [H,W,3] of accum's rgb: ACES and gamma, SVGF off.  `accum` is
    only read."""
    if accum.device.type == "cpu":
        return present_plain(accum, None, None, None,
                             params.replace(enable_svgf=0))
    device = cuda_lib.cuda_device(accum, "the tonemap kernel")
    h, w = accum.shape[0], accum.shape[1]
    check("accum", accum, torch.float32, (h, w, 4), device, align=16)
    prm = cuda_lib.param_block_ptr(params, device)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=device)
    lib = cuda_lib.library("svgf", _SIGNATURES)
    cuda_lib.launch(lib.ort_tonemap, "tonemap", device, accum.data_ptr(), h,
                    w, prm, out.data_ptr())
    return out
