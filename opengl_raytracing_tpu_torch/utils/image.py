"""PNG codec and cubemap-cross slicing without external dependencies.

Copies of `opengl_raytracing_tpu/utils/image.py`'s `encode_png`, so a
frame rendered on the card can be dumped for inspection, and of its
`read_png`, `slice_cubemap_cross` and `load_cubemap_cross` (numpy and
zlib only; the defilter is the numpy one), so an environment cross can be
loaded where there is no JAX package.  The JPEG, Radiance HDR and OpenEXR
readers are not ported: such a file raises NotImplementedError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """In-memory PNG encode.

    img: [H,W,3|4] uint8 or float in [0,1] (row 0 = TOP of image)."""
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float64) * 255.0 + 0.5,
                      0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"unsupported channel count {c}")
    color_type = 2 if c == 3 else 6
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H,W,3|4] uint8 or float in [0,1] (row 0 = TOP of image)."""
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """PNG scanline defilter (None, Sub, Up, Average, Paeth)."""
    if raw.shape[0] < h * (1 + w * c):
        raise ValueError(
            f"PNG data too short: {raw.shape[0]} bytes for "
            f"{h}x{w}x{c} (+filter bytes)")
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[pos]
        row = raw[pos + 1:pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            cur = row.copy()
            for x in range(c, stride):
                cur[x] = (cur[x] + cur[x - c]) & 0xFF
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for x in range(stride):
                left = cur[x - c] if x >= c else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = row.copy()
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                cc = prev[x - c] if x >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else cc)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    """8-bit RGB or RGBA PNG, not interlaced -> [H,W,C] uint8
    (row 0 = top)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = ctype = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitd, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if bitd != 8 or interlace != 0:
                raise ValueError("unsupported PNG variant")
            if ctype not in (2, 6):
                raise ValueError("only RGB/RGBA supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    c = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return _unfilter(raw, h, w, c)


# Cross layout tile positions (col, row) per face, GL order
# +X,-X,+Y,-Y,+Z,-Z (reference: src/render/cubemap.cpp:86-91).
CROSS_LAYOUT = ((2, 1), (0, 1), (1, 0), (1, 2), (1, 1), (3, 1))


def slice_cubemap_cross(img: np.ndarray) -> np.ndarray:
    """4x3-cross image [H,W,C] -> [6,F,F,3] float32 in [0,1] (uint8
    texels as k / 255 by true division).

    Validates the tile grid like the reference
    (reference: src/render/cubemap.cpp:47-53)."""
    h, w = img.shape[:2]
    if h % 3 != 0 or w % 4 != 0 or (w // 4) != (h // 3):
        raise ValueError(f"invalid cubemap cross dimensions {w}x{h}")
    f = h // 3
    faces = np.zeros((6, f, f, 3), np.float32)
    rgb = img[..., :3]
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float32) / 255.0
    for i, (cx, cy) in enumerate(CROSS_LAYOUT):
        faces[i] = rgb[cy * f:(cy + 1) * f, cx * f:(cx + 1) * f, :3]
    return faces


def load_cubemap_cross(path: str) -> np.ndarray:
    """PNG cross -> [6,F,F,3] float32 (GL t axis = image rows, top-first,
    matching the reference's upload without vertical flip; reference:
    src/render/cubemap.cpp:35-106).  Any other format raises
    NotImplementedError: the JPEG, HDR and EXR readers come with the app
    layer's host utilities (ROADMAP A7)."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic != _PNG_SIG:
        raise NotImplementedError(
            f"{path}: only PNG crosses are read; the JPEG, Radiance HDR and "
            "OpenEXR readers are not ported yet (ROADMAP A7)")
    return slice_cubemap_cross(read_png(path))
