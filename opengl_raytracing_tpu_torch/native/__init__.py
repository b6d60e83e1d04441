"""ctypes bindings for the port's g++ runtime library.

A copy of `opengl_raytracing_tpu/native/`: `bvh_native.cpp` and
`image_native.cpp` (this directory) are compiled at first use with
g++ (`CXX_FLAGS`, the JAX package's flags) into one shared library under
`_build/` in the package, named by a hash of the flags, the CPU they
target and the sources (as ops/cuda_lib.py names its kernels).  The
compile writes a temporary file and renames it into place, so processes
that build at once leave one whole library.  The entries have the JAX
package's names, arguments and contracts: `build_bvh`, `load_obj`,
`gather_triangles`, `slice_cubemap_cross`, `png_unfilter`, `hdr_unrle`,
`jpeg_entropy_scan` and `jpeg_entropy_encode`.  Two inputs the C++ would
read past are refused first: a PNG stream shorter than h*(1+w*c) bytes
and a cubemap cross of fewer than 3 channels.

Each entry returns None where no g++ is on PATH (a warning is logged
once); the caller then runs the numpy or Python form in scene/ and
utils/, which gives the same arrays and bytes.  That is the only
fallback: where g++ is there and the compile fails, `build_library`
raises with the compiler's output.  `CALLS` counts the calls each entry
answered from the library, so a run can show which route each loader
took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, "bvh_native.cpp"),
           os.path.join(_DIR, "image_native.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

# the encoder's output buffer a block: a 27-bit DC and 63 26-bit AC codes
# are ~209 bytes, doubled by 0xFF byte-stuffing -> ~420 (the C++ side
# returns -1 on overflow)
ENCODE_BYTES_PER_BLOCK = 430

# one count per entry: calls whose answer came from the library
CALLS = {"build_bvh": 0, "load_obj": 0, "gather_triangles": 0,
         "slice_cubemap_cross": 0, "png_unfilter": 0, "hdr_unrle": 0,
         "jpeg_entropy_scan": 0, "jpeg_entropy_encode": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_warned = False


@functools.lru_cache(maxsize=1)
def _cpu_key() -> bytes:
    """The host CPU's model and feature flags: `-march=native` builds for
    them, so a checkout copied to another machine builds anew."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = [ln for ln in fh if ln.startswith((b"model name",
                                                       b"flags"))]
        return b"".join(sorted(set(lines)))
    except OSError:
        return platform.processor().encode()


def library_path() -> str:
    """Where the build of the current sources with `CXX_FLAGS` for this
    CPU goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_key())
    for path in SOURCES:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libortnative_{h.hexdigest()[:16]}.so")


def build_library(force: bool = False) -> Optional[str]:
    """Compile the shared library if its exact build is missing (or
    `force`); return its path, or None where no g++ is on PATH.  A failed
    compile raises RuntimeError with the compiler's output."""
    global _warned
    with _lock:
        path = library_path()
        if os.path.exists(path) and not force:
            return path
        cxx = shutil.which("g++")
        if cxx is None:
            if not _warned:
                from ..utils.log import log
                log("INIT", "native: no g++ on PATH; the numpy and Python "
                    "forms run in place of the g++ library")
                _warned = True
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [cxx, *CXX_FLAGS, *SOURCES, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed with code {proc.returncode}: "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
        return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int32)
    c_up = ctypes.POINTER(ctypes.c_uint8)
    c_u32p = ctypes.POINTER(ctypes.c_uint32)
    i64 = ctypes.c_int64

    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [c_fp, ctypes.c_int, ctypes.c_int]
    lib.bvh_num_nodes.restype = ctypes.c_int
    lib.bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.bvh_num_tris.restype = ctypes.c_int
    lib.bvh_num_tris.argtypes = [ctypes.c_void_p]
    lib.bvh_copy.argtypes = [ctypes.c_void_p, c_fp, c_fp, c_ip, c_ip, c_ip,
                             c_ip, c_ip, c_fp]
    lib.bvh_free.argtypes = [ctypes.c_void_p]

    lib.obj_load.restype = ctypes.c_void_p
    lib.obj_load.argtypes = [ctypes.c_char_p]
    lib.obj_num_verts.restype = ctypes.c_int
    lib.obj_num_verts.argtypes = [ctypes.c_void_p]
    lib.obj_num_faces.restype = ctypes.c_int
    lib.obj_num_faces.argtypes = [ctypes.c_void_p]
    lib.obj_copy.argtypes = [ctypes.c_void_p, c_fp, c_ip]
    lib.obj_free.argtypes = [ctypes.c_void_p]

    lib.gather_triangles.argtypes = [c_fp, ctypes.c_int, c_ip, ctypes.c_int,
                                     c_fp, c_fp]
    lib.cubemap_slice.restype = ctypes.c_int
    lib.cubemap_slice.argtypes = [c_up, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, c_fp]

    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [c_up, i64, i64, i64, c_up]
    lib.hdr_unrle.restype = i64
    lib.hdr_unrle.argtypes = [c_up, i64, i64, i64, i64, c_up]
    lib.jpeg_entropy_scan.restype = i64
    lib.jpeg_entropy_scan.argtypes = [
        c_up, i64, i64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        c_ip, c_ip, c_up, c_up, c_up, c_up, c_fp, ctypes.c_int32, c_fp]
    lib.jpeg_entropy_encode.restype = i64
    lib.jpeg_entropy_encode.argtypes = [
        c_ip, c_up, i64, c_u32p, c_up, c_u32p, c_up, c_up, i64]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is loaded (built first if needed); False only
    where no g++ is on PATH."""
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def build_bvh(tris: np.ndarray, leaf_max: int = 8):
    """Native median-split builder -> scene.bvh.BVH (the JAX package's
    native tree: the numpy builder's layout, its ties in
    std::nth_element's order), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    from ..scene.bvh import BVH

    tris = np.ascontiguousarray(tris, np.float32)
    n = tris.shape[0]
    h = lib.bvh_build(_fp(tris), n, leaf_max)
    nn = lib.bvh_num_nodes(h)
    nt = lib.bvh_num_tris(h)
    bmin = np.zeros((nn, 3), np.float32)
    bmax = np.zeros((nn, 3), np.float32)
    left = np.zeros(nn, np.int32)
    right = np.zeros(nn, np.int32)
    first = np.zeros(nn, np.int32)
    count = np.zeros(nn, np.int32)
    skip = np.zeros(nn, np.int32)
    out_tris = np.zeros((nt, 9), np.float32)
    if nn:
        lib.bvh_copy(h, _fp(bmin), _fp(bmax), _ip(left), _ip(right),
                     _ip(first), _ip(count), _ip(skip), _fp(out_tris))
    lib.bvh_free(h)
    CALLS["build_bvh"] += 1
    return BVH(bmin, bmax, left, right, first, count, skip, out_tris)


def load_obj(path: str):
    """Native OBJ parse -> (verts [V,3] f32, faces [F,3] i32), or None
    without the library, for a file it cannot open, or on a malformed
    vertex line (the Python reader then raises)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.obj_load(path.encode())
    if not h:
        return None
    nv, nf = lib.obj_num_verts(h), lib.obj_num_faces(h)
    verts = np.zeros((nv, 3), np.float32)
    faces = np.zeros((nf, 3), np.int32)
    lib.obj_copy(h, _fp(verts), _ip(faces))
    lib.obj_free(h)
    CALLS["load_obj"] += 1
    return verts, faces


def gather_triangles(mesh, transform: np.ndarray):
    """Native world-space triangle gather -> [T,9] f32, or None without
    the library.  No index check: the caller validates the faces."""
    lib = _load()
    if lib is None:
        return None
    verts, faces = mesh
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    m = np.ascontiguousarray(transform, np.float32)
    out = np.zeros((faces.shape[0], 9), np.float32)
    lib.gather_triangles(_fp(verts), verts.shape[0], _ip(faces),
                         faces.shape[0], _fp(m), _fp(out))
    CALLS["gather_triangles"] += 1
    return out


def slice_cubemap_cross(img: np.ndarray):
    """Native 4x3-cross slicer -> [6,F,F,3] f32, or None without the
    library; raises ValueError on a cross whose tiles are not square."""
    lib = _load()
    if lib is None:
        return None
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float64) * 255.0 + 0.5,
                      0, 255).astype(np.uint8)
    if img.ndim != 3 or img.shape[2] < 3:  # the C++ reads three channels
        raise ValueError(f"a cubemap cross needs 3 or 4 channels, got an "
                         f"array of shape {img.shape}")
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    f = h // 3
    out = np.zeros((6, f, f, 3), np.float32)
    r = lib.cubemap_slice(_up(img), h, w, c, _fp(out))
    if r < 0:
        raise ValueError(f"invalid cubemap cross dimensions {w}x{h}")
    CALLS["slice_cubemap_cross"] += 1
    return out


def png_unfilter(raw: np.ndarray, h: int, w: int, c: int):
    """Native PNG scanline defilter -> [H,W,C] uint8, or None without the
    library.  `raw` is the zlib-inflated stream of h*(1+w*c) bytes;
    raises on a shorter one, and on a bad filter byte like
    utils.image._unfilter_numpy."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.shape[0] < h * (1 + w * c):  # the C++ trusts h, w and c
        raise ValueError(f"PNG data too short: {raw.shape[0]} bytes for "
                         f"{h}x{w}x{c} (+filter bytes)")
    out = np.zeros(h * w * c, np.uint8)
    r = lib.png_unfilter(_up(raw), h, w, c, _up(out))
    if r < 0:
        raise ValueError(f"bad filter {-r}")
    CALLS["png_unfilter"] += 1
    return out.reshape(h, w, c)


def jpeg_entropy_scan(data: np.ndarray, pos: int, mcux: int, mcuy: int,
                      hs: np.ndarray, vs: np.ndarray, dc_val, dc_len,
                      ac_val, ac_len, qts: np.ndarray,
                      restart_interval: int):
    """Native baseline-JPEG entropy decode -> dequantized natural-order
    coefficient blocks [n_blocks, 64] f32 in utils.image._scan_blocks's
    order, or None without the library.  LUT args are [nc, 65536] u8;
    qts is [nc, 64] f32 in zigzag order.  Raises ValueError on a
    malformed stream like utils.image._decode_block."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    hs = np.ascontiguousarray(hs, np.int32)
    vs = np.ascontiguousarray(vs, np.int32)
    nc = hs.shape[0]
    nblocks = mcux * mcuy * int(np.sum(hs * vs))
    coefs = np.zeros((nblocks, 64), np.float32)
    # contiguous copies stay alive across the call (ctypes pointers hold
    # no references)
    dcv = np.ascontiguousarray(dc_val, np.uint8)
    dcl = np.ascontiguousarray(dc_len, np.uint8)
    acv = np.ascontiguousarray(ac_val, np.uint8)
    acl = np.ascontiguousarray(ac_len, np.uint8)
    qts = np.ascontiguousarray(qts, np.float32)
    r = lib.jpeg_entropy_scan(
        _up(data), data.shape[0], pos, mcux, mcuy, nc, _ip(hs), _ip(vs),
        _up(dcv), _up(dcl), _up(acv), _up(acl), _fp(qts),
        restart_interval, _fp(coefs))
    if r < 0:
        raise ValueError({-1: "bad DC huffman code",
                          -2: "bad AC huffman code",
                          -3: "AC index overflow"}.get(int(r),
                                                       f"jpeg error {r}"))
    CALLS["jpeg_entropy_scan"] += 1
    return coefs


def jpeg_entropy_encode(blocks: np.ndarray, comp_ids: np.ndarray,
                        dc_codes: np.ndarray, dc_lens: np.ndarray,
                        ac_codes: np.ndarray, ac_lens: np.ndarray):
    """Native baseline-JPEG huffman encode -> the byte-stuffed entropy
    segment (bytes), or None without the library or when the output
    overflows its buffer.  blocks [N,64] int32 zigzag-quantized in
    MCU-interleaved scan order; comp_ids [N] u8 (0 = luma tables); code
    tables symbol-indexed [2,256] (u32 codes / u8 lengths).  Oracle:
    utils.image._jenc_entropy_python."""
    lib = _load()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, np.int32)
    comp_ids = np.ascontiguousarray(comp_ids, np.uint8)
    dcc = np.ascontiguousarray(dc_codes, np.uint32)
    dcl = np.ascontiguousarray(dc_lens, np.uint8)
    acc = np.ascontiguousarray(ac_codes, np.uint32)
    acl = np.ascontiguousarray(ac_lens, np.uint8)
    n = blocks.shape[0]
    cap = n * ENCODE_BYTES_PER_BLOCK + 1024
    out = np.zeros(cap, np.uint8)
    c_u32p = ctypes.POINTER(ctypes.c_uint32)
    r = lib.jpeg_entropy_encode(
        _ip(blocks), _up(comp_ids), n,
        dcc.ctypes.data_as(c_u32p), _up(dcl),
        acc.ctypes.data_as(c_u32p), _up(acl), _up(out), cap)
    if r < 0:
        return None
    CALLS["jpeg_entropy_encode"] += 1
    return out[:int(r)].tobytes()


def hdr_unrle(data: np.ndarray, pos: int, h: int, w: int):
    """Native Radiance RLE scanline decode -> [H,W,4] uint8 RGBE, or None
    without the library; raises on malformed input like the Python
    decoder."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    out = np.zeros(h * w * 4, np.uint8)
    r = lib.hdr_unrle(_up(data), data.shape[0], pos, h, w, _up(out))
    if r < 0:
        raise ValueError(f"malformed HDR RLE stream (code {r})")
    CALLS["hdr_unrle"] += 1
    return out.reshape(h, w, 4)
