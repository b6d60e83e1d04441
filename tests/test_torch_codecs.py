"""The port's image codecs against the JAX package's.

`opengl_raytracing_tpu_torch/utils/image.py` carries numpy copies of the
JAX package's readers and writers.  Where the JAX package hands a step to
its g++ library (PNG defilter, HDR run-length decode, JPEG entropy decode
and encode) the port hands it to its own copy of that library
(tests/test_torch_native.py holds each entry to JAX's and to the Python
form).  Both are exact integer or float32 pipelines over the same arrays,
so every comparison here is exact: decoded arrays equal value for value and
dtype for dtype, encoded files equal byte for byte.  Pillow writes the
JPEG variants the assets do not cover (progressive, restart markers,
grayscale, 4:2:2), as tests/test_image_codecs.py does.
"""

import glob
import os

import numpy as np
import pytest

from opengl_raytracing_tpu.utils import image as jimage

from opengl_raytracing_tpu_torch.utils import image as timage

PIL = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBEMAPS = sorted(os.path.relpath(p, REPO) for p in
                  glob.glob(os.path.join(REPO, "cubemaps", "*")))
GOLDENS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "tests", "golden", "*.png")))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rgb(h, w, seed=0):
    rng = np.random.RandomState(seed)
    # smooth content with noise: the entropy coder sees long runs and
    # large coefficients both
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x / max(w - 1, 1), y / max(h - 1, 1),
                     0.5 + 0.5 * np.sin(x * 0.3 + y * 0.2)], -1) * 200
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def test_asset_lists():
    assert [os.path.basename(p) for p in CUBEMAPS] == [
        "sky_day.jpg", "sky_day.png", "sky_dusk.png", "sky_noon.hdr",
        "sky_storm.exr"]
    assert len(GOLDENS) >= 12


@pytest.mark.parametrize("rel", CUBEMAPS + GOLDENS)
def test_read_image_equals_jax(rel):
    path = os.path.join(REPO, rel)
    got = timage.read_image(path)
    _same(got, jimage.read_image(path))
    assert got.dtype == (np.float32 if rel.endswith((".hdr", ".exr"))
                         else np.uint8)


@pytest.mark.parametrize("rel", CUBEMAPS)
def test_load_cubemap_cross_equals_jax(rel):
    path = os.path.join(REPO, rel)
    faces = timage.load_cubemap_cross(path)
    _same(faces, jimage.load_cubemap_cross(path))
    assert faces.shape == (6, 64, 64, 3) and np.isfinite(faces).all()


@pytest.mark.parametrize("kind", [
    "q92-420", "q75-444", "q90-422", "gray", "restart", "odd-size",
    "progressive-420", "progressive-444", "progressive-gray",
    "progressive-restart"])
def test_jpeg_decode_equals_jax(tmp_path, kind):
    size = (37, 53) if kind == "odd-size" else (48, 64)
    img = _rgb(*size, seed=len(kind))
    save = dict(quality=90)
    if kind.startswith("q"):
        q, sub = kind[1:].split("-")
        save = dict(quality=int(q),
                    subsampling={"420": 2, "422": 1, "444": 0}[sub])
    elif kind.endswith("gray"):
        img = img[..., 1]
    if kind.startswith("progressive"):
        save["progressive"] = True
        if kind.endswith("444"):
            save["subsampling"] = 0
    path = str(tmp_path / "a.jpg")
    pil = PIL.fromarray(img)
    if kind.endswith("restart"):
        save["restart_marker_blocks"] = 2
    pil.save(path, **save)
    with open(path, "rb") as fh:
        assert (b"\xff\xdd" in fh.read()) == kind.endswith("restart")  # DRI
    got = timage.read_jpeg(path)
    _same(got, jimage.read_jpeg(path))
    assert got.shape == size + (3,)
    # and it is a decode of the picture: within JPEG's loss of Pillow's
    want = np.asarray(PIL.open(path).convert("RGB"))
    assert np.abs(got.astype(int) - want.astype(int)).mean() < 3.0


@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("subsampling", ["420", "444"])
def test_encode_jpeg_bytes_equal_jax_and_roundtrip(tmp_path, quality,
                                                   subsampling):
    img = _rgb(41, 59, seed=quality)
    data = timage.encode_jpeg(img, quality, subsampling)
    assert data == jimage.encode_jpeg(img, quality, subsampling)
    path = tmp_path / "e.jpg"
    path.write_bytes(data)
    back = timage.read_jpeg(str(path))
    assert back.shape == img.shape
    # a standard JFIF stream: Pillow decodes it to the port's pixels
    # within its own IDCT's rounding (2 levels), and it is the picture
    # within the loss of the noisy test image's chroma (subsampled)
    pil = np.asarray(PIL.open(str(path)).convert("RGB")).astype(int)
    assert np.abs(back.astype(int) - pil).max() <= 2
    assert np.abs(back.astype(int) - img.astype(int)).mean() < 20.0
    timage.write_jpeg(str(tmp_path / "w.jpg"), img, quality)
    assert (tmp_path / "w.jpg").read_bytes() == timage.encode_jpeg(img,
                                                                   quality)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_encode_png_bytes_equal_jax_and_roundtrip(tmp_path, level):
    img = _rgb(17, 23, seed=level)
    data = timage.encode_png(img, level)
    assert data == jimage.encode_png(img, level)
    path = tmp_path / "e.png"
    path.write_bytes(data)
    _same(timage.read_png(str(path)), img)
    rgba = np.concatenate([img, img[..., :1]], -1)
    path.write_bytes(timage.encode_png(rgba, level))
    _same(timage.read_png(str(path)), rgba)
    floats = img.astype(np.float32) / 255.0
    assert timage.encode_png(floats, level) == jimage.encode_png(floats,
                                                                 level)


def test_png_filters_equal_jax(tmp_path):
    """Every PNG filter type (Pillow picks them adaptively) decodes to the
    same bytes in both packages."""
    img = _rgb(40, 50, seed=7)
    path = str(tmp_path / "f.png")
    PIL.fromarray(img).save(path, optimize=True)
    _same(timage.read_png(path), jimage.read_png(path))
    _same(timage.read_png(path), img)


def test_hdr_bytes_equal_jax_and_roundtrip(tmp_path):
    rng = np.random.RandomState(3)
    img = (rng.rand(13, 19, 3) * 6.0).astype(np.float32)
    img[0, 0] = 0.0
    ours, theirs = tmp_path / "a.hdr", tmp_path / "b.hdr"
    timage.write_hdr(str(ours), img)
    jimage.write_hdr(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    back = timage.read_hdr(str(ours))
    _same(back, jimage.read_hdr(str(ours)))
    # RGBE: an 8-bit mantissa per channel under the pixel's largest
    # channel's exponent
    err = np.abs(back - img) / np.maximum(img.max(-1, keepdims=True), 1e-30)
    assert err.max() <= 1.0 / 128


def _rle_channel(values):
    """New-style Radiance run-length coding of one channel of a scanline:
    runs of 3 or more equal bytes as (128 + n, byte), the rest literal."""
    out, i, n = bytearray(), 0, len(values)
    while i < n:
        j = i
        while j < n and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, values[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and values[j] == values[j + 1] == values[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(values[i:j])
        i = j
    return bytes(out)


def test_hdr_rle_scanlines_equal_jax(tmp_path):
    """A run-length encoded Radiance file decodes through the port's numpy
    run-length path to the JAX package's bits (its g++ path here), and to
    the RGBE values written."""
    h, w = 6, 40
    rng = np.random.RandomState(5)
    rgbe = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, 10:30] = rgbe[:, 10:11]  # runs
    rgbe[..., 3] = 130
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            body += _rle_channel(rgbe[y, :, c].tolist())
    path = tmp_path / "rle.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                     + f"-Y {h} +X {w}\n".encode() + bytes(body))
    got = timage.read_hdr(str(path))
    _same(got, jimage.read_hdr(str(path)))
    _same(got, timage._rgbe_to_float(rgbe))


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("compression", [0, 2, 3])
def test_exr_bytes_equal_jax_and_roundtrip(tmp_path, half, compression):
    rng = np.random.RandomState(compression)
    img = (rng.rand(21, 18, 3) * 3.0).astype(np.float32)
    ours, theirs = tmp_path / "a.exr", tmp_path / "b.exr"
    timage.write_exr(str(ours), img, half, compression)
    jimage.write_exr(str(theirs), img, half, compression)
    assert ours.read_bytes() == theirs.read_bytes()
    back = timage.read_exr(str(ours))
    _same(back, jimage.read_exr(str(ours)))
    if half:
        np.testing.assert_allclose(back, img, rtol=1e-3)
    else:
        _same(back, img)


def test_read_image_dispatch_and_errors(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="unrecognized"):
        timage.read_image(str(junk))
    png = tmp_path / "bad.png"
    png.write_bytes(timage.encode_png(_rgb(8, 8))[:40])
    with pytest.raises(Exception):
        timage.read_png(str(png))
    with pytest.raises(ValueError, match="cross"):
        timage.slice_cubemap_cross(np.zeros((10, 10, 3), np.uint8))
