"""Image IO without external dependencies: PNG codec, JPEG decoder
(sequential and progressive) and baseline encoder, Radiance HDR and
OpenEXR readers and writers, and the cubemap-cross slicer.

Copies of `opengl_raytracing_tpu/utils/image.py` (numpy and zlib), so
frames and environment crosses can be read and written where there is no
JAX package.  The PNG defilter, the HDR run-length decode and the JPEG
entropy decode and encode go to the port's g++ library (native/), as the
JAX package's go to its own; their numpy and Python forms
(`_unfilter_numpy`, `_hdr_unrle_numpy`, `_scan_blocks`,
`_jenc_entropy_python`) are the oracles and run where no g++ is on PATH.
Both routes give the same bytes and arrays.  Formats cover the reference
env-picker surface `*.{png,jpg,jpeg,hdr,exr}`
(reference: src/ui/gui.cpp:806-838, src/render/cubemap.cpp:35-106).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

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
    """PNG scanline defilter (None, Sub, Up, Average, Paeth): the native
    C++ route, else `_unfilter_numpy`.  A truncated or corrupt IDAT
    stream raises the same ValueError on both routes."""
    if raw.shape[0] < h * (1 + w * c):
        raise ValueError(
            f"PNG data too short: {raw.shape[0]} bytes for "
            f"{h}x{w}x{c} (+filter bytes)")
    out = native.png_unfilter(raw, h, w, c)
    return out if out is not None else _unfilter_numpy(raw, h, w, c)


def _unfilter_numpy(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
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


# -----------------------------------------------------------------------------
# Radiance HDR (.hdr) — RGBE with new-style RLE
# (stb_image's stbi__hdr_load equivalent; reference loads .hdr via stb,
# src/ui/gui.cpp:806-838, src/render/cubemap.cpp:35-106)
# -----------------------------------------------------------------------------

def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[...,4] uint8 RGBE -> [...,3] float32 linear radiance."""
    r = rgbe.astype(np.float32)
    scale = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)  # 2^(e-128-8)
    out = r[..., :3] * scale[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out.astype(np.float32)


def read_hdr(path: str) -> np.ndarray:
    """Radiance .hdr -> [H,W,3] float32 linear (row 0 = top)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n") + 1
    # header: key=value lines until blank line
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and b"32-bit_rle_rgbe" not in line:
            raise ValueError(f"unsupported HDR format {line!r}")
    end = data.index(b"\n", pos)
    dims = data[pos:end].split()
    pos = end + 1
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims!r}")
    h, w = int(dims[1]), int(dims[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = native.hdr_unrle(buf, 0, h, w)
    if rgbe is None:
        rgbe = _hdr_unrle_numpy(buf, h, w)
    return _rgbe_to_float(rgbe)


def _hdr_unrle_numpy(buf: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if (w < 8 or w > 0x7FFF or buf[p] != 2 or buf[p + 1] != 2
                or (int(buf[p + 2]) << 8 | int(buf[p + 3])) != w):
            # flat (non-RLE) scanline: w RGBE quads back to back
            out[y] = buf[p:p + 4 * w].reshape(w, 4)
            p += 4 * w
            continue
        p += 4
        for c in range(4):  # each channel RLE'd independently
            x = 0
            while x < w:
                count = int(buf[p])
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[p + 1]
                    x += count - 128
                    p += 2
                else:            # literal
                    out[y, x:x + count, c] = buf[p + 1:p + 1 + count]
                    x += count
                    p += 1 + count
    return out


def write_hdr(path: str, img: np.ndarray) -> None:
    """[H,W,3] float32 linear -> flat (non-RLE) Radiance .hdr."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = np.max(img, axis=-1)
    e = np.zeros((h, w), np.int32)
    nz = m >= 1e-32
    _, ex = np.frexp(np.where(nz, m, 1.0))
    e[nz] = ex[nz]
    scale = np.ldexp(1.0, -e + 8)  # mantissa in [128, 256)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5,
                            0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())


# -----------------------------------------------------------------------------
# Baseline JPEG decoder (SOF0, huffman, 4:4:4 / 4:2:2 / 4:2:0, DRI)
# (stb_image's stbi__jpeg equivalent)
# -----------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# 8-point type-III DCT basis (orthonormal)
_IDCT_M = np.zeros((8, 8), np.float32)
for _k in range(8):
    for _n in range(8):
        c = np.sqrt(0.125) if _k == 0 else 0.5
        _IDCT_M[_k, _n] = c * np.cos((2 * _n + 1) * _k * np.pi / 16)


class _BitReader:
    """Entropy-coded segment reader with 0xFF00 unstuffing and RST skip."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker = None

    def _fill(self):
        while self.nbits <= 24:
            if self.marker is not None:
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos]
                if nxt == 0x00:
                    self.pos += 1
                else:
                    self.marker = nxt
                    self.pos -= 1
                    b = 0
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.nbits += 8

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def drop(self, n: int):
        self.nbits -= n

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        return v

    def reset_at_rst(self):
        """Consume an RSTn marker and restart the bitstream."""
        # realign: discard partial bits, expect FF Dn at self.pos
        self.acc = 0
        self.nbits = 0
        self.marker = None
        while self.data[self.pos] == 0xFF and \
                self.data[self.pos + 1] == 0xFF:
            self.pos += 1
        if self.data[self.pos] == 0xFF and \
                0xD0 <= self.data[self.pos + 1] <= 0xD7:
            self.pos += 2


def _build_huff(bits, vals):
    """JPEG huffman table -> dict mapping (code << 5 | length) via a
    16-bit peek lookup: returns (lookup_value, lookup_len) arrays where
    lookup is indexed by the next 16 bits."""
    # canonical codes
    codes = []
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes.append((code, length, vals[k]))
            code += 1
            k += 1
        code <<= 1
    lut_val = np.zeros(1 << 16, np.uint8)
    lut_len = np.zeros(1 << 16, np.uint8)
    for code, length, val in codes:
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        lut_val[lo:hi] = val
        lut_len[lo:hi] = length
    return lut_val, lut_len


def _decode_block(br: _BitReader, lut_dc, lut_ac, qt, pred):
    """One 8x8 block -> (coef zigzag->natural f32 [8,8], new DC pred)."""
    v = br.peek16()
    s = int(lut_dc[0][v])
    ln = int(lut_dc[1][v])
    if ln == 0:
        raise ValueError("bad DC huffman code")
    br.drop(ln)
    diff = br.receive(s)
    if s and diff < (1 << (s - 1)):
        diff -= (1 << s) - 1
    pred += diff
    coef = np.zeros(64, np.float32)
    coef[0] = pred * qt[0]
    k = 1
    while k < 64:
        v = br.peek16()
        rs = int(lut_ac[0][v])
        ln = int(lut_ac[1][v])
        if ln == 0:
            raise ValueError("bad AC huffman code")
        br.drop(ln)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r == 15:
                k += 16
                continue
            break  # EOB
        k += r
        if k > 63:
            raise ValueError("AC index overflow")
        val = br.receive(s)
        if val < (1 << (s - 1)):
            val -= (1 << s) - 1
        coef[k] = val * qt[k]
        k += 1
    out = np.zeros(64, np.float32)
    out[_ZIGZAG] = coef
    return out.reshape(8, 8), pred


def _extend(v: int, s: int) -> int:
    """JPEG sign extension (T.81 F.2.2.1 EXTEND)."""
    if s and v < (1 << (s - 1)):
        return v - ((1 << s) - 1)
    return v


def _huff_decode(br: _BitReader, lut) -> int:
    v = br.peek16()
    ln = int(lut[1][v])
    if ln == 0:
        raise ValueError("bad huffman code")
    br.drop(ln)
    return int(lut[0][v])


# -----------------------------------------------------------------------------
# Progressive JPEG (SOF2): spectral selection + successive approximation.
# Coefficients accumulate across scans in zigzag order as int32; the
# batched dequant+IDCT runs once at EOI.  Algorithms follow ITU T.81
# G.1.2 (the parity target is stb_image's stbi__jpeg progressive paths,
# reference: include/stb_image.h).
# -----------------------------------------------------------------------------


def _prog_dc_scan(br, scan, units_x, units_y, interleaved, ah, al, ri):
    """One DC scan (Ss=0).  First pass (Ah=0) decodes full DC diffs into
    bit-plane Al; refinements append one bit per block."""
    preds = [0] * len(scan)
    n = 0
    for my in range(units_y):
        for mx in range(units_x):
            if ri and n and n % ri == 0:
                br.reset_at_rst()
                preds = [0] * len(scan)
            n += 1
            for ci, c in enumerate(scan):
                vs, hs = (c["vs"], c["hs"]) if interleaved else (1, 1)
                coef = c["coef"]
                for by in range(vs):
                    for bx in range(hs):
                        y, x = my * vs + by, mx * hs + bx
                        if ah == 0:
                            s = _huff_decode(br, c["dc"])
                            preds[ci] += _extend(br.receive(s), s)
                            coef[y, x, 0] = preds[ci] << al
                        elif br.receive(1):
                            coef[y, x, 0] |= (1 << al)


def _prog_ac_first(br, coef, wb, hb, ss, se, al, ac, ri):
    """First AC scan of a band: EOB-run skipping + coefficients placed
    at bit-plane Al (T.81 G.1.2.2)."""
    eobrun = 0
    n = 0
    for y in range(hb):
        for x in range(wb):
            if ri and n and n % ri == 0:
                br.reset_at_rst()
                eobrun = 0
            n += 1
            if eobrun:
                eobrun -= 1
                continue
            blk = coef[y, x]
            k = ss
            while k <= se:
                rs = _huff_decode(br, ac)
                r, s = rs >> 4, rs & 15
                if s == 0:
                    if r < 15:
                        eobrun = (1 << r) - 1
                        if r:
                            eobrun += br.receive(r)
                        break
                    k += 16  # ZRL
                else:
                    k += r
                    if k > se:
                        raise ValueError("AC index overflow")
                    blk[k] = _extend(br.receive(s), s) << al
                    k += 1


def _prog_ac_refine(br, coef, wb, hb, ss, se, al, ac, ri):
    """AC refinement scan: correction bits for already-nonzero
    coefficients, newly-nonzero ones at +-2^Al (T.81 G.1.2.3)."""
    bit = 1 << al
    eobrun = 0
    n = 0
    for y in range(hb):
        for x in range(wb):
            if ri and n and n % ri == 0:
                br.reset_at_rst()
                eobrun = 0
            n += 1
            blk = coef[y, x]
            k = ss
            if eobrun == 0:
                while k <= se:
                    rs = _huff_decode(br, ac)
                    r, s = rs >> 4, rs & 15
                    newval = 0
                    if s == 0:
                        if r < 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += br.receive(r)
                            break
                        # ZRL: pass over 16 zero-history coefficients
                    else:
                        if s != 1:
                            raise ValueError("bad AC refinement size")
                        newval = bit if br.receive(1) else -bit
                    # advance past r zero-history coefficients, applying
                    # correction bits to nonzero-history ones en route
                    while k <= se:
                        c = int(blk[k])
                        if c != 0:
                            if br.receive(1) and (c & bit) == 0:
                                blk[k] = c + (bit if c > 0 else -bit)
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if newval and k <= se:
                        blk[k] = newval
                    k += 1
            if eobrun > 0:
                # rest of this block: correction bits only
                while k <= se:
                    c = int(blk[k])
                    if c != 0:
                        if br.receive(1) and (c & bit) == 0:
                            blk[k] = c + (bit if c > 0 else -bit)
                    k += 1
                eobrun -= 1


def _progressive_scan(data, pos, scan, ss, se, ah, al, ri, mcux, mcuy):
    """Decode one progressive SOS; returns the offset of the next marker."""
    br = _BitReader(data + b"\xff\xd9", pos)
    if ss == 0:
        if se != 0:
            raise ValueError("DC progressive scan with Se != 0")
        if len(scan) > 1:
            _prog_dc_scan(br, scan, mcux, mcuy, True, ah, al, ri)
        else:
            c = scan[0]
            _prog_dc_scan(br, scan, c["wb"], c["hb"], False, ah, al, ri)
    else:
        if len(scan) != 1:
            raise ValueError("interleaved AC progressive scan")
        c = scan[0]
        args = (br, c["coef"], c["wb"], c["hb"], ss, se, al, c["ac"], ri)
        if ah == 0:
            _prog_ac_first(*args)
        else:
            _prog_ac_refine(*args)
    # skip any padding bits / RST markers up to the next real marker
    p = br.pos
    n = len(data)
    while p < n - 1:
        if (data[p] == 0xFF and data[p + 1] != 0x00
                and not (0xD0 <= data[p + 1] <= 0xD7)):
            break
        p += 1
    return p


def _finish_progressive(comps, qts, w, h, hmax, vmax):
    """Dequantize + batched-GEMM IDCT of the accumulated coefficient
    planes, then the shared plane assembly."""
    for c in comps:
        qt = qts[c["tq"]]
        hb, wb = c["coef"].shape[:2]
        nb = hb * wb
        zz = c["coef"].reshape(nb, 64).astype(np.float32) * qt
        nat = np.zeros((nb, 64), np.float32)
        nat[:, _ZIGZAG] = zz
        y_ = (nat.reshape(nb * 8, 8) @ _IDCT_M).reshape(nb, 8, 8)
        blks = (np.ascontiguousarray(y_.transpose(0, 2, 1))
                .reshape(nb * 8, 8) @ _IDCT_M).reshape(nb, 8, 8
                                                       ).transpose(0, 2, 1)
        c["plane"] = (blks.reshape(hb, wb, 8, 8)
                      .transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8))
    return _finish_planes(comps, w, h, hmax, vmax)


def read_jpeg(path: str) -> np.ndarray:
    """Sequential (SOF0/1) or progressive (SOF2) JPEG -> [H,W,3] uint8
    (row 0 = top).

    Supports 8-bit, 1 or 3 components, 4:4:4/4:2:2/4:2:0 sampling,
    restart intervals, and progressive spectral-selection/successive-
    approximation scans (stb_image decodes both; reference:
    include/stb_image.h stbi__jpeg).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qts = {}
    huff_dc, huff_ac = {}, {}
    comps = None
    h = w = 0
    restart_interval = 0
    progressive = False
    hmax = vmax = mcux = mcuy = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:   # legal fill byte(s) before a marker
            pos += 1
            continue
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            if progressive and comps is not None:
                return _finish_progressive(comps, qts, w, h, hmax, vmax)
            break
        ln = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + ln]
        if marker == 0xDB:  # DQT
            s = 0
            while s < len(seg):
                pq, tq = seg[s] >> 4, seg[s] & 15
                if pq:
                    qts[tq] = np.frombuffer(
                        seg, ">u2", 64, s + 1).astype(np.float32)
                    s += 129
                else:
                    qts[tq] = np.frombuffer(
                        seg, np.uint8, 64, s + 1).astype(np.float32)
                    s += 65
        elif marker == 0xC4:  # DHT
            s = 0
            while s < len(seg):
                tc, th = seg[s] >> 4, seg[s] & 15
                bits = list(seg[s + 1:s + 17])
                n = sum(bits)
                vals = list(seg[s + 17:s + 17 + n])
                (huff_dc if tc == 0 else huff_ac)[th] = _build_huff(bits,
                                                                    vals)
                s += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 sequential, SOF2 prog.
            progressive = marker == 0xC2
            h, w = struct.unpack(">HH", seg[1:5])
            nc = seg[5]
            comps = []
            for i in range(nc):
                cid, sf, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "hs": sf >> 4, "vs": sf & 15,
                              "tq": tq})
            if progressive:
                # coefficient planes persist across scans (int32,
                # zigzag order), allocated at MCU-padded block dims;
                # non-interleaved scans cover only wb x hb (T.81 A.2.2)
                hmax = max(c["hs"] for c in comps)
                vmax = max(c["vs"] for c in comps)
                mcux = -(-w // (8 * hmax))
                mcuy = -(-h // (8 * vmax))
                for c in comps:
                    cw = -(-(w * c["hs"]) // hmax)   # samples, ceil
                    ch = -(-(h * c["vs"]) // vmax)
                    c["wb"] = -(-cw // 8)            # blocks, ceil
                    c["hb"] = -(-ch // 8)
                    c["coef"] = np.zeros((mcuy * c["vs"], mcux * c["hs"],
                                          64), np.int32)
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"unsupported JPEG SOF{marker - 0xC0}")
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, td_ta = seg[1 + 2 * i:3 + 2 * i]
                comp = next(c for c in comps if c["id"] == cs)
                comp["dc"] = huff_dc.get(td_ta >> 4)
                comp["ac"] = huff_ac.get(td_ta & 15)
                scan.append(comp)
            if not progressive:
                pos += ln
                return _decode_scan(data, pos, w, h, scan, qts,
                                    restart_interval)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah_al = seg[3 + 2 * ns]
            pos = _progressive_scan(data, pos + ln, scan, ss, se,
                                    ah_al >> 4, ah_al & 15,
                                    restart_interval, mcux, mcuy)
            continue
        pos += ln
    raise ValueError("no SOS marker found" if not progressive
                     else "progressive JPEG missing EOI")


def _scan_blocks(data, pos, mcux, mcuy, comps, restart_interval):
    """Entropy-decode a sequential scan: the dequantized natural-order
    coefficients of every block [nb,8,8] float32, in the stream's order
    (MCU by MCU, then component, then block row and column) -- the
    array native.jpeg_entropy_scan returns as [nb,64]."""
    for c in comps:
        c["pred"] = 0
    br = _BitReader(data + b"\xff\xd9", pos)
    blocks = []
    n_mcu = 0
    for _my in range(mcuy):
        for _mx in range(mcux):
            if restart_interval and n_mcu and \
                    n_mcu % restart_interval == 0:
                br.reset_at_rst()
                for c in comps:
                    c["pred"] = 0
            for c in comps:
                for _ in range(c["vs"] * c["hs"]):
                    coef, c["pred"] = _decode_block(
                        br, c["dc"], c["ac"], c["qt"], c["pred"])
                    blocks.append(coef)
            n_mcu += 1
    return np.stack(blocks)


def _scan_planes(data, pos, mcux, mcuy, comps, restart_interval) -> None:
    """Decode a sequential scan into each component's sample plane
    c["plane"]: the entropy decode (native/, else `_scan_blocks`), then
    the JAX package's batched IDCT and block assembly, so the planes are
    its bits."""
    hs = np.array([c["hs"] for c in comps], np.int32)
    vs = np.array([c["vs"] for c in comps], np.int32)
    coefs = native.jpeg_entropy_scan(
        np.frombuffer(data, np.uint8), pos, mcux, mcuy, hs, vs,
        np.stack([c["dc"][0] for c in comps]),
        np.stack([c["dc"][1] for c in comps]),
        np.stack([c["ac"][0] for c in comps]),
        np.stack([c["ac"][1] for c in comps]),
        np.stack([c["qt"] for c in comps]), restart_interval)
    if coefs is None:
        coefs = _scan_blocks(data, pos, mcux, mcuy, comps, restart_interval)
    # batched IDCT over every block at once as two LARGE flat GEMMs —
    # a broadcast (8,8) @ (b,8,8) matmul dispatches b tiny BLAS calls
    # (~ms each in overhead); R = M^T C M computed as
    # Y = C M (flat), R = (Y^T M)^T (flat).  Then block order
    # (my, mx, comp, by, bx) -> per-component planes by pure reshapes.
    nb = coefs.shape[0]
    y_ = (coefs.reshape(nb * 8, 8) @ _IDCT_M).reshape(nb, 8, 8)
    blks = (np.ascontiguousarray(y_.transpose(0, 2, 1))
            .reshape(nb * 8, 8) @ _IDCT_M).reshape(nb, 8, 8
                                                   ).transpose(0, 2, 1)
    per_mcu = int(np.sum(hs * vs))
    n_mcu = mcux * mcuy
    off = 0
    for c, h_, v_ in zip(comps, hs, vs):
        cnt = int(h_ * v_)
        idx = (np.arange(n_mcu, dtype=np.int64)[:, None] * per_mcu
               + off + np.arange(cnt, dtype=np.int64)[None, :]).ravel()
        c["plane"] = (blks[idx]
                      .reshape(mcuy, mcux, v_, h_, 8, 8)
                      .transpose(0, 2, 4, 1, 3, 5)
                      .reshape(c["h"], c["w"]))
        off += cnt


def _upsample2(p: np.ndarray, axis: int, times: int) -> np.ndarray:
    """libjpeg-style "fancy" (triangle filter) 2x chroma upsampling:
    each output sample = (3*nearer + farther) / 4, edges clamped.  Only
    2x is triangle-filtered (the 4:2:0/4:2:2 cases); other factors fall
    back to replication."""
    if times == 1:
        return p
    if times != 2:
        return np.repeat(p, times, axis=axis)
    if axis == 1:
        p = p.T
    lo = np.concatenate([p[:1], p[:-1]], axis=0)      # row above
    hi = np.concatenate([p[1:], p[-1:]], axis=0)      # row below
    out = np.empty((p.shape[0] * 2, p.shape[1]), np.float32)
    out[0::2] = (3.0 * p + lo) * 0.25
    out[1::2] = (3.0 * p + hi) * 0.25
    return out.T if axis == 1 else out


def _decode_scan(data, pos, w, h, comps, qts, restart_interval):
    hmax = max(c["hs"] for c in comps)
    vmax = max(c["vs"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    for c in comps:
        c["w"] = mcux * 8 * c["hs"]
        c["h"] = mcuy * 8 * c["vs"]
        c["qt"] = qts[c["tq"]]
    _scan_planes(data, pos, mcux, mcuy, comps, restart_interval)
    return _finish_planes(comps, w, h, hmax, vmax)


def _finish_planes(comps, w, h, hmax, vmax):
    """Per-component sample planes -> [h,w,3] uint8 (level shift, chroma
    upsample, YCbCr->RGB) — shared by the sequential and progressive
    paths."""
    planes = []
    for c in comps:
        p = c["plane"] + 128.0
        if c["vs"] != vmax:
            p = _upsample2(p, axis=0, times=vmax // c["vs"])
        if c["hs"] != hmax:
            p = _upsample2(p, axis=1, times=hmax // c["hs"])
        planes.append(p[:h, :w])
    if len(planes) == 1:
        g = np.clip(planes[0], 0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5,
                   0, 255).astype(np.uint8)


# -----------------------------------------------------------------------------
# Baseline JPEG ENCODER (SOF0, Annex-K tables, 4:4:4 / 4:2:0) — the
# stb_image_write counterpart; used by the viewer's JPEG stream.  DCT +
# quantization are batched numpy GEMMs, the huffman pass is Python.
# -----------------------------------------------------------------------------

# ITU T.81 Annex K.1/K.2 reference quantization tables (natural order).
_JQT_Y = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.float64)
_JQT_C = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.float64)

# Annex K.3-K.6 huffman specs: (BITS[16], HUFFVAL).
_JH_DC_Y = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_JH_DC_C = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
            list(range(12)))
_JH_AC_Y = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_JH_AC_C = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _jenc_codes(spec):
    """(BITS, HUFFVAL) -> (codes u32[256], lens u8[256]) symbol-indexed."""
    bits, vals = spec
    codes = np.zeros(256, np.uint32)
    lens = np.zeros(256, np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            lens[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


def _jenc_quality_tables(quality: int):
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    def mk(base):
        return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)
    return mk(_JQT_Y), mk(_JQT_C)


def _jenc_blocks(plane: np.ndarray, qt_nat: np.ndarray):
    """[H8,W8] f32 (level-shifted) -> zigzag-quantized int32 [nby,nbx,64]
    via two batched GEMMs (coef = M blk M^T, M = the orthonormal DCT-II
    basis shared with the decoder)."""
    h8, w8 = plane.shape
    nby, nbx = h8 // 8, w8 // 8
    blk = np.ascontiguousarray(
        plane.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
    ).reshape(nby * nbx, 8, 8)
    a = (blk.reshape(-1, 8) @ _IDCT_M.T).reshape(-1, 8, 8)   # blk @ M^T
    coef = (np.ascontiguousarray(a.transpose(0, 2, 1)).reshape(-1, 8)
            @ _IDCT_M.T).reshape(-1, 8, 8).transpose(0, 2, 1)  # M blk M^T
    qc = np.rint(coef.reshape(-1, 64)
                 / qt_nat[None, :].astype(np.float32)).astype(np.int32)
    return qc[:, _ZIGZAG].reshape(nby, nbx, 64)


def _jenc_entropy_python(blocks: np.ndarray, comp_ids: np.ndarray,
                         dc_codes, dc_lens, ac_codes, ac_lens) -> bytes:
    """The huffman pass: blocks [N,64] zigzag-quantized, comp_ids [N]
    (0=luma)."""
    out = bytearray()
    acc = 0
    nbits = 0

    def put(code, ln):
        nonlocal acc, nbits
        ln = int(ln)  # numpy scalars coerce the shift to uint8 otherwise
        acc = (acc << ln) | int(code)
        nbits += ln
        while nbits >= 8:
            b = (acc >> (nbits - 8)) & 0xFF
            out.append(b)
            if b == 0xFF:
                out.append(0)
            nbits -= 8
        acc &= (1 << nbits) - 1

    def csize(v):
        s = 0
        v = abs(v)
        while v:
            s += 1
            v >>= 1
        return s

    pred = [0, 0, 0]
    for blk, ci in zip(blocks, comp_ids):
        t = 0 if ci == 0 else 1
        diff = int(blk[0]) - pred[ci]
        pred[ci] = int(blk[0])
        s = csize(diff)
        put(dc_codes[t][s], dc_lens[t][s])
        if s:
            put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(ac_codes[t][0xF0], ac_lens[t][0xF0])  # ZRL
                run -= 16
            s = csize(v)
            put(ac_codes[t][(run << 4) | s], ac_lens[t][(run << 4) | s])
            put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
        if run:
            put(ac_codes[t][0x00], ac_lens[t][0x00])  # EOB
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)  # 1-fill to byte boundary
    return bytes(out)


def encode_jpeg(img: np.ndarray, quality: int = 85,
                subsampling: str = "420") -> bytes:
    """[H,W,3] (uint8 or [0,1] float) -> baseline JFIF bytes
    (stb_image_write's stbi_write_jpg counterpart; decodes with this
    file's read_jpeg and any standard decoder)."""
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float64) * 255.0 + 0.5,
                      0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    rgb = img.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yy = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b

    sub = 2 if subsampling == "420" else 1
    mcu = 8 * sub
    h8, w8 = h + (-h) % mcu, w + (-w) % mcu

    def pad(p):
        # edge-replicate into the MCU-aligned grid (np.pad is ~100x
        # slower than this two-assignment copy on the dev box)
        if (h8, w8) == (h, w):
            return p
        o = np.empty((h8, w8), np.float32)
        o[:h, :w] = p
        if h8 > h:
            o[h:, :w] = p[h - 1:h, :]
        if w8 > w:
            o[:, w:] = o[:, w - 1:w]
        return o
    yy, cb, cr = pad(yy), pad(cb), pad(cr)
    if sub == 2:
        cb = (cb[0::2, 0::2] + cb[0::2, 1::2]
              + cb[1::2, 0::2] + cb[1::2, 1::2]) * 0.25
        cr = (cr[0::2, 0::2] + cr[0::2, 1::2]
              + cr[1::2, 0::2] + cr[1::2, 1::2]) * 0.25

    qt_y, qt_c = _jenc_quality_tables(quality)
    by = _jenc_blocks(yy, qt_y.astype(np.float64))
    bcb = _jenc_blocks(cb, qt_c.astype(np.float64))
    bcr = _jenc_blocks(cr, qt_c.astype(np.float64))

    # MCU-interleaved block stream + per-block component ids
    if sub == 2:
        mcy, mcx = by.shape[0] // 2, by.shape[1] // 2
        y4 = (by.reshape(mcy, 2, mcx, 2, 64).transpose(0, 2, 1, 3, 4)
              .reshape(mcy * mcx, 4, 64))
        blocks = np.concatenate(
            [y4, bcb.reshape(-1, 1, 64), bcr.reshape(-1, 1, 64)],
            axis=1).reshape(-1, 64)
        comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8),
                           mcy * mcx)
    else:
        blocks = np.stack([by.reshape(-1, 64), bcb.reshape(-1, 64),
                           bcr.reshape(-1, 64)], axis=1).reshape(-1, 64)
        comp_ids = np.tile(np.array([0, 1, 2], np.uint8),
                           by.shape[0] * by.shape[1])

    dc_codes = [_jenc_codes(_JH_DC_Y), _jenc_codes(_JH_DC_C)]
    ac_codes = [_jenc_codes(_JH_AC_Y), _jenc_codes(_JH_AC_C)]
    data = native.jpeg_entropy_encode(
        blocks, comp_ids,
        np.stack([dc_codes[0][0], dc_codes[1][0]]),
        np.stack([dc_codes[0][1], dc_codes[1][1]]),
        np.stack([ac_codes[0][0], ac_codes[1][0]]),
        np.stack([ac_codes[0][1], ac_codes[1][1]]))
    if data is None:  # no g++, or the buffer overflowed
        data = _jenc_entropy_python(
            blocks, comp_ids,
            [dc_codes[0][0], dc_codes[1][0]],
            [dc_codes[0][1], dc_codes[1][1]],
            [ac_codes[0][0], ac_codes[1][0]],
            [ac_codes[0][1], ac_codes[1][1]])

    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    def dht(tc, th, spec):
        bits, vals = spec
        return seg(0xFFC4, bytes([tc << 4 | th]) + bytes(bits)
                   + bytes(vals))

    zz = _ZIGZAG
    out = b"\xff\xd8"
    out += seg(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xFFDB, b"\x00" + bytes(qt_y[zz].astype(np.uint8)))
    out += seg(0xFFDB, b"\x01" + bytes(qt_c[zz].astype(np.uint8)))
    sf = 0x22 if sub == 2 else 0x11
    out += seg(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
               + bytes([1, sf, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += dht(0, 0, _JH_DC_Y) + dht(1, 0, _JH_AC_Y)
    out += dht(0, 1, _JH_DC_C) + dht(1, 1, _JH_AC_C)
    out += seg(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out += data + b"\xff\xd9"
    return out


def write_jpeg(path: str, img: np.ndarray, quality: int = 85) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(img, quality))


# -----------------------------------------------------------------------------
# OpenEXR (single-part scanline; NONE / ZIPS / ZIP compression;
# HALF / FLOAT / UINT channels)
# -----------------------------------------------------------------------------

_EXR_MAGIC = b"\x76\x2f\x31\x01"
_EXR_PIXTYPE = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
# block heights per compression id (NONE=1, RLE=1, ZIPS=1, ZIP=16)
_EXR_BLOCK_LINES = {0: 1, 2: 1, 3: 16}


def _exr_read_cstr(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("ascii", "replace"), end + 1


def _exr_unpredict(data: bytes) -> bytes:
    """OpenEXR ZIP post-decompress reconstruction: undo the delta
    predictor, then de-interleave the two halves."""
    t = np.frombuffer(data, np.uint8).astype(np.int32)
    t = np.cumsum(np.concatenate([t[:1], t[1:] - 128]) % 256) % 256
    t = t.astype(np.uint8)
    out = np.zeros_like(t)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR scanline decoder -> [H,W,3] float32 linear.

    Covers the files stb-adjacent tooling writes most often: single-part
    scanline images, NONE/ZIPS/ZIP compression, HALF or FLOAT R/G/B
    channels (extra channels like A are skipped), increasing line order.
    The reference lists *.exr in its env picker (gui.cpp:806-838) via
    stb, which actually fails on EXR too — we go one better and decode.
    """
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != _EXR_MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    version = struct.unpack_from("<I", buf, 4)[0]
    if version & 0x200:  # multi-part bit
        raise ValueError(f"multi-part EXR not supported: {path}")
    if version & 0x800:
        raise ValueError(f"deep-data EXR not supported: {path}")

    pos = 8
    channels = []  # (name, dtype)
    compression = None
    data_window = None
    tiled = bool(version & 0x400)
    while True:
        if buf[pos:pos + 1] == b"\0":
            pos += 1
            break
        name, pos = _exr_read_cstr(buf, pos)
        atype, pos = _exr_read_cstr(buf, pos)
        size = struct.unpack_from("<i", buf, pos)[0]
        if size < 0 or pos + 4 + size > len(buf):
            # a negative size would move pos BACKWARDS and spin this
            # loop forever on a corrupt file; decode-or-raise, never hang
            raise ValueError(f"corrupt EXR attribute size {size}: {path}")
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels" and atype == "chlist":
            p = 0
            while payload[p:p + 1] != b"\0":
                cname, p = _exr_read_cstr(payload, p)
                ptype = struct.unpack_from("<i", payload, p)[0]
                p += 16  # pixel type + pLinear/reserved + x/y sampling
                channels.append((cname, _EXR_PIXTYPE[ptype]))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)
    if tiled:
        raise ValueError(f"tiled EXR not supported: {path}")
    if compression not in _EXR_BLOCK_LINES:
        raise ValueError(
            f"EXR compression id {compression} not supported: {path}")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    block_lines = _EXR_BLOCK_LINES[compression]
    n_blocks = -(-h // block_lines)
    # channels are stored sorted by name within each scanline
    chans = sorted(channels, key=lambda c: c[0])
    line_bytes = sum(w * dt.itemsize for _, dt in chans)

    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)
    planes = {name: np.zeros((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        y = struct.unpack_from("<i", buf, off)[0] - y0
        size = struct.unpack_from("<i", buf, off + 4)[0]
        raw = buf[off + 8:off + 8 + size]
        lines = min(block_lines, h - y)
        expect = lines * line_bytes
        if compression in (2, 3) and size < expect:  # ZIPS / ZIP
            raw = zlib.decompress(raw)
            if len(raw) < expect:
                raise ValueError(f"short EXR block at y={y}: {path}")
            raw = _exr_unpredict(raw)
        # else: block stored raw (spec: raw wins when zlib doesn't shrink)
        p = 0
        for ly in range(lines):
            for cname, dt in chans:
                n = w * dt.itemsize
                row = np.frombuffer(raw, dt, w, p)
                planes[cname][y + ly] = row.astype(np.float32)
                p += n
    rgb = np.zeros((h, w, 3), np.float32)
    for k, key in enumerate("RGB"):
        if key in planes:
            rgb[..., k] = planes[key]
        elif "Y" in planes:  # luminance-only
            rgb[..., k] = planes["Y"]
    return rgb


def write_exr(path: str, img: np.ndarray, half: bool = True,
              compression: int = 3) -> None:
    """Minimal EXR writer (fixtures/export): single-part scanline RGB,
    ZIP (16-line) or NONE compression, HALF or FLOAT pixels."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    dt = np.dtype("<f2") if half else np.dtype("<f4")
    ptype = 1 if half else 2
    block_lines = _EXR_BLOCK_LINES[compression]

    def attr(name, atype, payload):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chl = b""
    for cname in ("B", "G", "R"):
        chl += (cname.encode() + b"\0" + struct.pack("<i", ptype)
                + struct.pack("<i", 0) + struct.pack("<2i", 1, 1))
    chl += b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", chl)
              + attr("compression", "compression",
                     struct.pack("<B", compression))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    blocks = []
    for y in range(0, h, block_lines):
        lines = min(block_lines, h - y)
        raw = b""
        for ly in range(lines):
            for k in (2, 1, 0):  # B, G, R sorted order
                raw += img[y + ly, :, k].astype(dt).tobytes()
        if compression in (2, 3):
            t = np.frombuffer(raw, np.uint8)
            half_n = (len(t) + 1) // 2
            inter = np.concatenate([t[0::2], t[1::2]])
            d = inter.astype(np.int32)
            d = np.concatenate([d[:1], (d[1:] - d[:-1] + 128) % 256])
            payload = zlib.compress(d.astype(np.uint8).tobytes())
            if len(payload) >= len(raw):
                payload = raw  # EXR stores raw when compression loses
        else:
            payload = raw
        blocks.append(struct.pack("<2i", y, len(payload)) + payload)

    n_blocks = len(blocks)
    base = 8 + len(header) + 8 * n_blocks
    offsets, acc = [], base
    for b in blocks:
        offsets.append(acc)
        acc += len(b)
    with open(path, "wb") as fh:
        fh.write(_EXR_MAGIC + struct.pack("<I", 2))
        fh.write(header)
        fh.write(struct.pack(f"<{n_blocks}q", *offsets))
        for b in blocks:
            fh.write(b)


# -----------------------------------------------------------------------------
# Unified loader + cubemap slicing
# -----------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """Decode by magic bytes: PNG/JPEG -> [H,W,C] uint8, HDR/EXR ->
    [H,W,3] float32 linear.  The stb_image dispatch equivalent."""
    with open(path, "rb") as fh:
        magic = fh.read(11)
    if magic[:8] == _PNG_SIG:
        return read_png(path)
    if magic[:2] == b"\xff\xd8":
        return read_jpeg(path)
    if magic[:2] == b"#?":  # Radiance (#?RADIANCE / #?RGBE)
        return read_hdr(path)
    if magic[:4] == _EXR_MAGIC:
        return read_exr(path)
    raise ValueError(f"unrecognized image format: {path}")


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
    """Image cross (png/jpg/jpeg/hdr/exr) -> [6,F,F,3] float32 (GL t axis =
    image rows, top-first, matching the reference's stb upload without
    vertical flip; reference: src/render/cubemap.cpp:35-106).  HDR and
    EXR input stays linear radiance (values may exceed 1)."""
    return slice_cubemap_cross(read_image(path))
