"""The port's g++ library (`opengl_raytracing_tpu_torch/native/`) against
the JAX package's and against the port's numpy and Python forms.

Both libraries are built from the same C++ with the same flags on this
machine, so every entry must return the JAX entry's arrays and bytes
exactly, and raise the same ValueError on malformed input.  The numpy and
Python forms (`scene.bvh.build_bvh`, `scene.geometry.load_obj` /
`gather_triangles`, `utils.image._unfilter_numpy` / `_hdr_unrle_numpy` /
`_scan_blocks` / `_jenc_entropy_python`, `slice_cubemap_cross`) give the
same arrays and bytes too, but for the BVH builder: it splits alike and
may order centroid ties apart, so its tree holds the same triangles in
the same number of nodes.  The port's `prepare_bvh` must give the JAX
`prepare_bvh`'s tree exactly (it built with the numpy builder before).
The entry inputs are tests/test_native.py's, every cubemap and every
OBJ model, and frames encoded by `encode_jpeg`.
"""

import ctypes
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from opengl_raytracing_tpu import native as jnative
from opengl_raytracing_tpu.constants import (DEFAULT_BVH_SCALE,
                                             DEFAULT_BVH_TRANSLATE)
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.utils import image as jimage

from opengl_raytracing_tpu_torch import native as tnative
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.scene import (build_bvh, build_bvh_fast,
                                               gather_triangles,
                                               gather_triangles_fast,
                                               load_obj, load_obj_fast,
                                               make_bunny, make_icosphere,
                                               model_transform, save_obj,
                                               validate_bvh)
from opengl_raytracing_tpu_torch.utils import image as timage
from opengl_raytracing_tpu_torch.utils.log import default_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBEMAPS = sorted(glob.glob(os.path.join(REPO, "cubemaps", "*")))
OBJS = sorted(glob.glob(os.path.join(REPO, "models", "*.obj")))
U8_CUBEMAPS = [p for p in CUBEMAPS if p.endswith((".png", ".jpg"))]


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, bytes):
        assert a == b
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def spy(monkeypatch):
    """spy(name) -> list of (args, kwargs, result) of every call of the
    port's native entry `name` from here on (the entry still runs)."""
    def install(name):
        calls, real = [], getattr(tnative, name)

        def fn(*args, **kw):
            out = real(*args, **kw)
            calls.append((args, kw, out))
            return out
        monkeypatch.setattr(tnative, name, fn)
        return calls
    return install


def test_library_builds_from_the_port_sources():
    assert tnative.available()
    path = tnative.build_library()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.basename(path).startswith("libortnative_")
    assert [os.path.basename(s) for s in tnative.SOURCES] == [
        "bvh_native.cpp", "image_native.cpp"]
    assert all(os.path.dirname(s) == os.path.dirname(tnative.__file__)
               for s in tnative.SOURCES)
    assert tnative.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC",
                                 "-std=c++17")


@pytest.mark.parametrize("subdiv", [4, 6])
def test_prepare_bvh_is_jax_tree(subdiv):
    """Fails on the numpy builder: at 81,920 triangles its bounds differ
    on ~11,000 of 32,767 nodes and its triangle rows on ~53,000."""
    tris = gather_triangles(make_bunny(subdiv),
                            model_transform(DEFAULT_BVH_TRANSLATE,
                                            DEFAULT_BVH_SCALE))
    ours = prepare_bvh(tris, "cpu").arrays
    theirs = jprepare_bvh(tris).arrays
    for name, a, b in zip(("bounds", "meta", "tris"), ours, theirs):
        got, want = a.numpy(), np.asarray(b)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mesh", ["bunny3", "icosphere2"])
def test_build_bvh_equals_jax_and_validates(mesh):
    if mesh == "bunny3":
        tris = gather_triangles(make_bunny(3),
                                model_transform((-2, 1.5, 0), 0.5))
    else:
        tris = gather_triangles(make_icosphere(1.0, 2),
                                model_transform((0, 1, -3), 1.0))
    before = tnative.CALLS["build_bvh"]
    ours = tnative.build_bvh(tris)
    assert tnative.CALLS["build_bvh"] == before + 1
    theirs = jnative.build_bvh(tris)
    for f in ("bmin", "bmax", "left", "right", "first", "count", "skip",
              "tris"):
        _same(getattr(ours, f), getattr(theirs, f))
    validate_bvh(ours, tris)
    numpy_tree = build_bvh(tris)
    validate_bvh(numpy_tree, tris)
    assert ours.n_nodes == numpy_tree.n_nodes
    np.testing.assert_array_equal(ours.count, numpy_tree.count)
    _same(build_bvh_fast(tris).tris, ours.tris)


def _obj_inputs(tmp_path):
    ico = str(tmp_path / "ico.obj")
    save_obj(ico, make_icosphere(1.0, 1))
    return OBJS + [ico]


def test_load_obj_and_gather_equal_jax_and_numpy(tmp_path):
    m = model_transform((1, 2, 3), 0.7)
    for path in _obj_inputs(tmp_path):
        ours = tnative.load_obj(path)
        for a, b, c in zip(ours, jnative.load_obj(path), load_obj(path)):
            _same(a, b)
            _same(a, c)
        for a, b in zip(load_obj_fast(path), ours):
            _same(a, b)
        tris = tnative.gather_triangles(ours, m)
        _same(tris, jnative.gather_triangles(ours, m))
        _same(tris, gather_triangles(ours, m))
        _same(gather_triangles_fast(ours, m), tris)
    verts, faces = ours
    bad = faces.copy()
    bad[0, 0] = len(verts) + 7
    with pytest.raises(IndexError, match="face index out of range"):
        gather_triangles_fast((verts, bad), m)


def test_malformed_obj_gives_none(tmp_path):
    p = str(tmp_path / "bad.obj")
    with open(p, "w") as fh:
        fh.write("v 0 0 0\nv 1 2 abc\nv 0 1 0\nf 1 2 3\n")
    assert tnative.load_obj(p) is None
    assert jnative.load_obj(p) is None
    with pytest.raises(ValueError):
        load_obj_fast(p)
    assert tnative.load_obj(str(tmp_path / "missing.obj")) is None


@pytest.mark.parametrize("path", U8_CUBEMAPS + [None],
                         ids=lambda p: "random" if p is None
                         else os.path.basename(p))
def test_slice_cubemap_equals_jax_and_numpy(path):
    if path is None:  # tests/test_native.py's input
        img = np.random.RandomState(0).randint(0, 255, (24, 32, 3),
                                               dtype=np.uint8)
    else:
        img = timage.read_image(path)
    got = tnative.slice_cubemap_cross(img)
    _same(got, jnative.slice_cubemap_cross(img))
    _same(got, timage.slice_cubemap_cross(img))


def test_bad_cross_dimensions_raise_like_jax():
    img = np.zeros((10, 13, 3), np.uint8)
    msgs = []
    for fn in (tnative.slice_cubemap_cross, jnative.slice_cubemap_cross,
               timage.slice_cubemap_cross):
        with pytest.raises(ValueError) as err:
            fn(img)
        msgs.append(str(err.value))
    assert msgs == ["invalid cubemap cross dimensions 13x10"] * 3
    with pytest.raises(ValueError, match="3 or 4 channels"):
        tnative.slice_cubemap_cross(np.zeros((30, 40), np.uint8))


def _filter_cycle():
    """tests/test_native.py's stream: all five filters on random bytes."""
    rng = np.random.RandomState(7)
    h, w, c = 23, 17, 3
    raw = rng.randint(0, 256, h * (1 + w * c), dtype=np.uint8)
    for y in range(h):
        raw[y * (1 + w * c)] = y % 5
    return raw, h, w, c


def test_png_unfilter_equals_jax_and_numpy(spy, tmp_path):
    calls = spy("png_unfilter")
    raw, h, w, c = _filter_cycle()
    got = tnative.png_unfilter(raw, h, w, c)
    _same(got, jnative.png_unfilter(raw, h, w, c))
    _same(got, timage._unfilter_numpy(raw, h, w, c))
    p = str(tmp_path / "t.png")
    timage.write_png(p, np.random.RandomState(3).randint(
        0, 255, (20, 33, 4), dtype=np.uint8))
    for path in [p] + [q for q in CUBEMAPS if q.endswith(".png")]:
        _same(timage.read_png(path), jimage.read_png(path))
    assert len(calls) == 2 + sum(q.endswith(".png") for q in CUBEMAPS)
    for args, _, out in calls:
        _same(out, jnative.png_unfilter(*args))
        _same(out, timage._unfilter_numpy(*args))


def test_bad_filter_byte_raises_like_jax():
    raw, h, w, c = _filter_cycle()
    raw[0] = 9
    msgs = []
    for fn in (tnative.png_unfilter, jnative.png_unfilter,
               timage._unfilter_numpy, timage._unfilter):
        with pytest.raises(ValueError) as err:
            fn(raw, h, w, c)
        msgs.append(str(err.value))
    assert msgs == ["bad filter 9"] * 4
    for fn in (timage._unfilter, tnative.png_unfilter):
        with pytest.raises(ValueError, match="PNG data too short"):
            fn(raw[:-1], h, w, c)


def _rle_stream():
    """tests/test_native.py's stream: runs, literals and a flat line."""
    rng = np.random.RandomState(11)
    w = 16
    parts = []
    for _ in range(2):
        parts.append(bytes([2, 2, w >> 8, w & 0xFF]))
        for _c in range(4):
            parts.append(bytes([128 + 10, int(rng.randint(256))]))
            parts.append(bytes([6]) + rng.randint(
                0, 256, 6, dtype=np.uint8).tobytes())
    flat = rng.randint(0, 256, w * 4, dtype=np.uint8)
    flat[0] = 1
    parts.append(flat.tobytes())
    return np.frombuffer(b"".join(parts), np.uint8), 3, w


def test_hdr_unrle_equals_jax_and_numpy(spy, tmp_path):
    calls = spy("hdr_unrle")
    buf, h, w = _rle_stream()
    got = tnative.hdr_unrle(buf, 0, h, w)
    _same(got, jnative.hdr_unrle(buf, 0, h, w))
    _same(got, timage._hdr_unrle_numpy(buf, h, w))
    p = str(tmp_path / "t.hdr")
    timage.write_hdr(p, (np.random.RandomState(5).rand(9, 16, 3)
                         * 4.0).astype(np.float32))
    hdrs = [p] + [q for q in CUBEMAPS if q.endswith(".hdr")]
    for path in hdrs:
        _same(timage.read_hdr(path), jimage.read_hdr(path))
    assert len(calls) == 1 + len(hdrs)
    for (data, pos, h_, w_), _, out in calls:
        _same(out, jnative.hdr_unrle(data, pos, h_, w_))
        _same(out, timage._hdr_unrle_numpy(data[pos:], h_, w_))


@pytest.mark.parametrize("cut,code", [("run_past_width", -3),
                                      ("stream_ends_at_a_count", -2),
                                      ("literal_past_the_end", -4)])
def test_bad_rle_raises_like_jax(cut, code):
    buf, h, w = _rle_stream()
    if cut == "run_past_width":
        buf = buf.copy()
        buf[4] = 128 + 40  # a run of 40 in a 16-wide scanline
    else:
        # a scanline: its 4-byte header, then 9 bytes a channel (a run of
        # 2 bytes, a literal of 7)
        buf = buf[:22 if cut == "stream_ends_at_a_count" else 30]
    msgs = []
    for fn in (tnative.hdr_unrle, jnative.hdr_unrle):
        with pytest.raises(ValueError) as err:
            fn(buf, 0, h, w)
        msgs.append(str(err.value))
    assert msgs == [f"malformed HDR RLE stream (code {code})"] * 2


def _jpegs(tmp_path):
    """sky_day.jpg, and this codec's 4:2:0 and 4:4:4 encodes of a frame
    with smooth areas and noise."""
    rng = np.random.RandomState(1)
    y, x = np.mgrid[0:72, 0:100]
    img = np.clip(np.stack([x * 2.5, y * 3.0, 128 + 100 * np.sin(x * 0.2)],
                           -1) + rng.randn(72, 100, 3) * 25,
                  0, 255).astype(np.uint8)
    out = [p for p in CUBEMAPS if p.endswith(".jpg")]
    for sub in ("420", "444"):
        p = str(tmp_path / f"frame_{sub}.jpg")
        with open(p, "wb") as fh:
            fh.write(jimage.encode_jpeg(img, 85, sub))
        out.append(p)
    return out


def test_jpeg_entropy_scan_equals_jax_and_python(spy, monkeypatch, tmp_path):
    calls = spy("jpeg_entropy_scan")
    paths = _jpegs(tmp_path)
    images = [timage.read_jpeg(p) for p in paths]
    for p, img in zip(paths, images):
        _same(img, jimage.read_jpeg(p))
    assert len(calls) == len(paths)
    for args, _, out in calls:
        _same(out, jnative.jpeg_entropy_scan(*args))
    # the Python decoder's blocks on the same scans
    blocks = []
    real_blocks = timage._scan_blocks

    def python_blocks(*args):
        blocks.append(real_blocks(*args))
        return blocks[-1]
    monkeypatch.setattr(tnative, "jpeg_entropy_scan",
                        lambda *args: None)
    monkeypatch.setattr(timage, "_scan_blocks", python_blocks)
    for p, img in zip(paths, images):
        _same(timage.read_jpeg(p), img)
    for (_, _, out), b in zip(calls, blocks):
        _same(out, b.reshape(-1, 64))


@pytest.mark.parametrize("which", ["dc", "ac"])
def test_bad_huffman_code_raises_like_jax(spy, monkeypatch, tmp_path, which):
    """A scan whose bits run into all ones (0xFF00 is a stuffed 0xFF): no
    code of 16 ones exists, so the first DC code fails ("dc"), or, after
    the stream's own first bytes, an AC code ("ac")."""
    calls = spy("jpeg_entropy_scan")
    src = _jpegs(tmp_path)[1]
    timage.read_jpeg(src)
    pos = calls[0][0][1]
    with open(src, "rb") as fh:
        data = bytearray(fh.read())
    start = pos + (0 if which == "dc" else 1)
    data[start:start + 64] = b"\xff\x00" * 32
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as fh:
        fh.write(bytes(data))
    msgs = []
    for read in (timage.read_jpeg, jimage.read_jpeg):
        with pytest.raises(ValueError) as err:
            read(bad)
        msgs.append(str(err.value))
    monkeypatch.setattr(tnative, "jpeg_entropy_scan", lambda *args: None)
    with pytest.raises(ValueError) as err:
        timage.read_jpeg(bad)  # the Python decoder
    msgs.append(str(err.value))
    assert msgs == [f"bad {which.upper()} huffman code"] * 3


def test_jpeg_entropy_encode_equals_jax_and_python(spy, monkeypatch):
    calls = spy("jpeg_entropy_encode")
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (45, 61, 3), dtype=np.uint8),
              timage.read_image(os.path.join(REPO, "cubemaps",
                                             "sky_dusk.png"))]
    encoded = []
    for img in frames:
        for sub in ("420", "444"):
            for q in (50, 95):
                data = timage.encode_jpeg(img, q, sub)
                _same(data, jimage.encode_jpeg(img, q, sub))
                encoded.append((img, q, sub, data))
    assert len(calls) == len(encoded)
    for args, _, out in calls:
        _same(out, jnative.jpeg_entropy_encode(*args))
        _same(out, timage._jenc_entropy_python(*args))
    # the whole file with the Python coder: the same bytes
    monkeypatch.setattr(tnative, "jpeg_entropy_encode", lambda *a: None)
    for img, q, sub, data in encoded:
        _same(timage.encode_jpeg(img, q, sub), data)


def test_jpeg_encode_overflow_gives_none(monkeypatch):
    """A buffer too small for the segment: the entry returns None (the
    caller then runs the Python coder), as the JAX entry does."""
    blocks = np.random.RandomState(4).randint(-900, 900, (60, 64)).astype(
        np.int32)
    comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), 10)
    dc = [timage._jenc_codes(timage._JH_DC_Y),
          timage._jenc_codes(timage._JH_DC_C)]
    ac = [timage._jenc_codes(timage._JH_AC_Y),
          timage._jenc_codes(timage._JH_AC_C)]
    args = (blocks, comp_ids, np.stack([dc[0][0], dc[1][0]]),
            np.stack([dc[0][1], dc[1][1]]), np.stack([ac[0][0], ac[1][0]]),
            np.stack([ac[0][1], ac[1][1]]))
    want = timage._jenc_entropy_python(*args)
    assert len(want) > 1024
    assert tnative.jpeg_entropy_encode(*args) == want
    # a buffer of 1,024 bytes
    monkeypatch.setattr(tnative, "ENCODE_BYTES_PER_BLOCK", 0)
    assert tnative.jpeg_entropy_encode(*args) is None


def test_app_env_map_uses_native_slicer():
    from opengl_raytracing_tpu_torch.app import AppState
    st = AppState(8, 8, device="cpu")
    before = dict(tnative.CALLS)
    assert st.load_env_map(os.path.join(REPO, "cubemaps", "sky_day.png"))
    assert tnative.CALLS["slice_cubemap_cross"] == \
        before["slice_cubemap_cross"] + 1
    assert tnative.CALLS["png_unfilter"] == before["png_unfilter"] + 1
    assert st.load_env_map(os.path.join(REPO, "cubemaps", "sky_noon.hdr"))
    # a float cross is sliced by numpy, as the JAX app slices it
    assert tnative.CALLS["slice_cubemap_cross"] == \
        before["slice_cubemap_cross"] + 1
    assert tnative.CALLS["hdr_unrle"] == before["hdr_unrle"] + 1


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    code = ("import sys\n"
            "from opengl_raytracing_tpu_torch import native as n\n"
            "n.BUILD_DIR = sys.argv[1]\n"
            "print(n.build_library())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]
    lib = ctypes.CDLL(str(tmp_path / os.listdir(tmp_path)[0]))
    lib.cubemap_slice.restype = ctypes.c_int
    img = np.zeros((10, 13, 3), np.uint8)
    out = np.zeros(3, np.float32)
    assert lib.cubemap_slice(img.ctypes.data_as(ctypes.c_void_p), 10, 13, 3,
                             out.ctypes.data_as(ctypes.c_void_p)) == -1


def test_failed_compile_raises_with_stderr(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(tnative, "SOURCES", [str(bad)])
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnative.available()
    assert "undeclared_name" in str(err.value)
    assert os.listdir(tmp_path / "build") == []


def test_without_gpp_the_numpy_forms_run(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_warned", False)
    logger = default_logger()
    start = len(logger.lines)
    tris = gather_triangles(make_bunny(2), model_transform((0, 0, 0), 1.0))
    before = dict(tnative.CALLS)
    assert not tnative.available()
    assert tnative.build_bvh(tris) is None
    tree, want = build_bvh_fast(tris), build_bvh(tris)
    for f in ("bmin", "skip", "tris"):
        _same(getattr(tree, f), getattr(want, f))
    raw, h, w, c = _filter_cycle()
    _same(timage._unfilter(raw, h, w, c), timage._unfilter_numpy(raw, h, w,
                                                                 c))
    img = timage.read_image(os.path.join(REPO, "cubemaps", "sky_day.jpg"))
    _same(img, jimage.read_image(os.path.join(REPO, "cubemaps",
                                              "sky_day.jpg")))
    assert tnative.CALLS == before
    warned = [ln for ln in logger.lines[start:] if "no g++" in ln]
    assert len(warned) == 1 and warned[0].startswith("[INIT]")
    assert os.listdir(tmp_path) == []
