"""Wrapper of the CUDA SVGF kernel in csrc/svgf.cu.

`svgf_filter` (the 7x7 variance-guided filter; replaces the TPU kernel
`opengl_raytracing_tpu/ops/svgf_pallas.py:_kernel`) takes the arguments
of the plain version, ops/svgf.py:svgf_filter, for a whole image:

  * CPU tensors run the plain version;
  * CUDA tensors launch the kernel, or the call raises.  Nothing falls
    back to the plain version on the card.

The kernel reads the four HWC planes as they are (accum [H,W,4], motion
[H,W,2], gpos and gnrm [H,W,3]) and takes the five `svgf_*` parameters by
value.  It is built and launched through ops/cuda_lib.py
(`LAUNCHES["svgf"]`).  Importing this module needs neither nvcc nor a
card.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import RenderParams
from . import cuda_lib
from .cuda_lib import check
from .svgf import svgf_filter as svgf_filter_plain, svgf_params

_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ort_svgf": ([_P, _P, _P, _P, _I32, _I32] + [_F32] * 5 + [_P, _P],
                 ctypes.c_int),
}


def svgf_filter(accum, motion, gpos, gnrm, params: RenderParams):
    """Filtered rgb [H,W,3] of the whole image (the contract of
    ops/svgf.py:svgf_filter with no halo)."""
    if accum.device.type == "cpu":
        return svgf_filter_plain(accum, motion, gpos, gnrm, params)
    device = cuda_lib.cuda_device(accum, "the SVGF kernel")
    h, w = accum.shape[0], accum.shape[1]
    check("accum", accum, torch.float32, (h, w, 4), device, align=16)
    check("motion", motion, torch.float32, (h, w, 2), device)
    check("gpos", gpos, torch.float32, (h, w, 3), device)
    check("gnrm", gnrm, torch.float32, (h, w, 3), device)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=device)
    lib = cuda_lib.library("svgf", _SIGNATURES)
    cuda_lib.launch(lib.ort_svgf, "svgf", device, accum.data_ptr(),
                    motion.data_ptr(), gpos.data_ptr(), gnrm.data_ptr(), h, w,
                    *svgf_params(params), out.data_ptr())
    return out
