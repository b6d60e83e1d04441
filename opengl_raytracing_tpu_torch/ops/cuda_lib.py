"""Build, load and launch the hand-written CUDA kernels of csrc/.

Each source in `SOURCES` is compiled at first use with nvcc for sm_90a
into a shared library with a plain C interface, under `_build/` in the
package, keyed by a hash of the flags, the source and every header in
csrc/ (a source may include any of them), and loaded with ctypes.
`build_all()` starts one nvcc per source at once and waits for all of
them.  A missing nvcc or a failed build raises with the
compiler's output.  Importing this module needs neither nvcc nor a card.

`LAUNCHES` counts each wrapper's launches, so a run can show that a frame
went through the kernels; `launch` adds to it, after the kernel was
accepted, and `add_launches` for a replayed CUDA graph (the launches its
capture enqueued: models/graph.py takes a capture's own counts back).
The host mirrors of the kernels' `PixelGrid` and `FrameAffine`
(csrc/sampling.cuh), the frame record the kernels read (`frame_args`),
the pointer to the parameter block they read (`param_block_ptr`; every
library's layout of it, csrc/param_block.cuh, is held to
models/param_block.py's when it loads) and the row helpers the wrappers
share are here too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = {name: os.path.join(_CSRC, f"{name}.cu")
           for name in ("bvh_trace", "an_direct", "an_trace", "an_shade",
                        "hit_mix", "svgf")}
BUILD_DIR = os.path.join(_PKG, "_build")
# No --use_fast_math: the kernels rely on IEEE division, sqrt and exact
# comparisons.  --fmad=false keeps nvcc from contracting a*b+c into FMAs,
# so the kernels round like their plain PyTorch versions (one rounding
# per operation).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# one count per kernel: "svgf" is the filter entry alone, "svgf_present"
# the fused present pass, "tonemap" the present pass without SVGF; the
# analytic scene's trace, AO and GI bounce kernels and both scenes' sky
# kernel (csrc/an_trace.cu) "an_trace", "an_ao", "an_bounce" and "sky";
# glass's and the mirror's rays and mix kernels (csrc/an_shade.cu)
# "glass_rays", "glass_mix", "mirror_ray" and "mirror_mix"; both scenes'
# shading tails (csrc/hit_mix.cu) "bvh_hit_mix" and "an_hit_mix"
LAUNCHES = {"closest": 0, "bounce": 0, "ao": 0, "an_direct": 0,
            "bvh_direct": 0, "svgf": 0, "svgf_present": 0, "tonemap": 0,
            "an_trace": 0, "an_ao": 0, "an_bounce": 0, "sky": 0,
            "glass_rays": 0, "glass_mix": 0, "mirror_ray": 0,
            "mirror_mix": 0, "bvh_hit_mix": 0, "an_hit_mix": 0}

_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           f"{cuda_home}/bin): the CUDA kernels cannot be "
                           "built")
    return path


def library_path(name: str) -> str:
    """Where the build of source `name` with the current flags goes.  The
    key covers the headers too, so an edited header is rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [SOURCES[name]] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every named source (all by default) whose exact build is
    missing, one nvcc process per source, all started together; return
    {name: library path}.  The compiler's output (ptxas register counts)
    is kept beside each library as `.log`."""
    names = list(SOURCES) if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}: "
                          f"{' '.join(cmd)}\n{out}")
            continue
        with open(paths[name][:-3] + ".log", "w") as fh:
            fh.write(out)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str, signatures: dict):
    """The loaded library of source `name`, built if needed, with each C
    entry's (argtypes, restype) from `signatures` declared."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _check_param_layout(lib, name)
        _libs[name] = lib
    return lib


def _check_param_layout(lib, name: str) -> None:
    """Raise unless library `name` lays the parameter block out as
    models/param_block.py does: each field's first word in FIELDS' order,
    then the words used."""
    from ..models import param_block
    want = ([at for at, _ in param_block.FIELDS.values()]
            + [param_block.USED])
    fn = lib.ort_param_block_layout
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_int
    got = (ctypes.c_int * len(want))()
    if fn(got, len(want)) != len(want) - 1 or list(got) != want:
        raise RuntimeError(f"the parameter block's layout differs between "
                           f"csrc/param_block.cuh (library {name}: "
                           f"{list(got)}) and models/param_block.py "
                           f"({want})")


def check(name, x, dtype, shape, device, align=4):
    """Raise unless `x` is a contiguous, aligned tensor of `dtype` and
    `shape` (a tuple of ints) on `device`."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def cuda_device(x, what: str):
    """The CUDA device of `x`; raise for any other device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} take CPU or CUDA tensors, got {x.device}")
    return x.device


def launch(fn, kernel: str, device, *args):
    """Call C entry `fn` on the current stream of `device`; raise on a
    CUDA error, count the launch otherwise."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


def add_launches(counts: dict) -> None:
    """Add a replayed CUDA graph's launches (models/graph.py: what its
    capture enqueued) to `LAUNCHES`."""
    for kernel, n in counts.items():
        LAUNCHES[kernel] += n


class FrameAffine(ctypes.Structure):
    """Host mirror of `FrameAffine` in csrc/sampling.cuh: a frame value
    int32(index * a + b + s * c) of the record's frame index at sample
    s."""
    _fields_ = [("a", ctypes.c_uint32), ("b", ctypes.c_uint32),
                ("c", ctypes.c_uint32)]


def frame_args(device, *frames):
    """(the frame record the kernels read, [FrameAffine of each frame], the
    call's sample count).

    Frames are `sampling.FrameValue`s sharing one record, which must lie
    on `device` (None: wherever it lies; the tests read the arguments on
    the CPU).  Those with a sample axis must share its length, the call's
    sample count (1 where none has one)."""
    from ..sampling import FrameValue
    for f in frames:
        if not isinstance(f, FrameValue):
            raise TypeError(f"a kernel takes a frame as a "
                            f"sampling.FrameValue, not {type(f).__name__}")
    record = frames[0].record
    if any((f.record.data_ptr(), f.record.device)
           != (record.data_ptr(), record.device) for f in frames):
        raise ValueError("frame values of one call must share one frame "
                         "record")
    counts = {f.samples for f in frames if f.samples > 1}
    if len(counts) > 1:
        raise ValueError(f"frame values of one call must share one sample "
                         f"count, got {sorted(counts)}")
    check("frame record", record, torch.int32, (3,),
          record.device if device is None else device)
    # a value without a sample axis reads sample 0 on every lane
    return (record, [FrameAffine(f.a, f.b, f.c if f.samples > 1 else 0)
                     for f in frames], counts.pop() if counts else 1)


def param_block_ptr(params, device=None) -> int:
    """The device pointer to the parameter block of `params` (a FrameParams,
    or a RenderParams bound to its cached block on `device`), checked: an
    int32 [WORDS] block, 16-byte aligned, on `device` (None: wherever it
    lies; the tests read the arguments on the CPU)."""
    from ..models import param_block
    from ..params import FrameParams, bind
    if device is None and isinstance(params, FrameParams):
        device = params.device
    p = bind(params, "cpu" if device is None else device)
    check("parameter block", p.block, torch.int32, (param_block.WORDS,),
          p.block.device, align=16)
    return p.block.data_ptr()


class PixelGrid(ctypes.Structure):
    """Host mirror of `PixelGrid` in csrc/sampling.cuh: the px and py
    grids' device pointers, the columns and the pixels of one sample, and
    each grid's row and column strides in elements."""
    _fields_ = [("px", ctypes.c_void_p), ("py", ctypes.c_void_p),
                ("cols", ctypes.c_int64), ("n_px", ctypes.c_int64),
                ("px_sr", ctypes.c_int64), ("px_sc", ctypes.c_int64),
                ("py_sr", ctypes.c_int64), ("py_sc", ctypes.c_int64)]


def pixel_grid(px, py, shape, device, samples=1):
    """(the kernels' `PixelGrid`, the tensors it points into): px and py
    broadcast to `shape` and viewed as [rows, shape[-1]] without a copy
    where their strides allow (a broadcast grid is one row or column of
    floats); the tensors must outlive the launch.

    A leading axis over which both grids are broadcast (a batch of
    samples of one pixel grid, [S, H, W]) is left out of the view: lane i
    is then pixel i % n_px of sample i // n_px, n_px = H * W.  With
    `samples` > 1 (the call's sample count, `frame_args`) that axis must
    be there and be the samples'."""
    shape = torch.Size(shape)
    grids = []
    for name, x in (("px", px), ("py", py)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected "
                            f"torch.float32")
        grids.append(x.expand(shape))
    if (len(shape) > 1 and shape[0] > 1
            and all(g.stride(0) == 0 for g in grids)):
        grids = [g[0] for g in grids]
    n_px = grids[0].numel()
    if samples > 1 and n_px * samples != shape.numel():
        raise ValueError(f"a call of {samples} samples takes pixel grids "
                         f"broadcast over a leading sample axis of that "
                         f"length; got shape {tuple(shape)} with "
                         f"{n_px} pixels a sample")
    cols = max(shape[-1], 1) if len(shape) else 1
    views = []
    for x in grids:
        try:
            x = x.view(-1, cols)
        except RuntimeError:  # strides that do not fold into two
            x = x.reshape(-1, cols).contiguous()
        views.append(x)
    gx, gy = views
    return PixelGrid(gx.data_ptr(), gy.data_ptr(), cols, max(n_px, 1),
                     *gx.stride(), *gy.stride()), views


def sample_rows(x, shape, samples):
    """The [n_px, 3] rows of `x` [..., 3] broadcast to `shape` + (3,) that
    a sampled call reads once a pixel: sample 0's, contiguous, when `x` is
    broadcast over the leading sample axis of `samples` (> 1), else
    None."""
    x = x.expand(shape + (3,))
    if samples <= 1 or x.stride(0) != 0:
        return None
    return x[0].reshape(-1, 3).contiguous()


def rows(x, shape):
    """[..., 3] broadcast to shape + (3,) -> contiguous [N, 3] (a view
    where it already is)."""
    return x.expand(shape + (3,)).reshape(-1, 3).contiguous()


def flat(x, shape):
    """[...] broadcast to shape -> contiguous [N] (a view where it already
    is)."""
    return x.expand(shape).reshape(-1).contiguous()


def mask_bytes(active, shape, device):
    """The kernels' `active` argument: None (every lane live), or the
    bool mask broadcast to `shape` as n contiguous 0/1 bytes; returns
    (pointer or None, the tensor to keep alive)."""
    if active is None:
        return None, None
    act = flat(active, shape)
    check("active", act, torch.bool, (shape.numel(),), device, align=1)
    return act.data_ptr(), act
