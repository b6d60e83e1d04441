"""The port's cubemap environment against the JAX package's, on the same
inputs (numpy, from a seed), and what the analytic direct-light kernel
computes of it.

* the host loaders (`read_png`, `slice_cubemap_cross`,
  `load_cubemap_cross`) are copies: array equality against the originals
  on the two PNG crosses of cubemaps/, and on its JPEG, HDR and EXR
  crosses; a file of no known format is refused;
* `direction_to_face_uv` and `sample_cubemap` against JAX on random,
  axis, face-diagonal and face-edge directions, float and uint8 tables:
  the face ids are equal, s, t and the colour agree within rtol 1e-6
  (atol 1e-6 for s and t at 0: the same expressions, XLA may fuse a
  multiply and an add);
* `env_from_numpy` and `dummy_cubemap`: exact;
* csrc/cubemap.cuh cannot run here, so its per-lane arithmetic is
  transcribed to numpy and held to the plain `sample_cubemap` bit for
  bit, and the `AnScene` fields the wrapper fills are read back;
* `sky`, `direct_light` (also against JAX's K3 in interpret mode),
  `shade_mirror`, `shade_glass` and both GI functions with an env map
  against JAX, at the tolerances tests/test_torch_analytic.py and
  tests/test_torch_gi_ao.py hold them to without one.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models.pipeline import primary_rays
from opengl_raytracing_tpu.models.pipeline import _sanitize_hit as jsanitize
from opengl_raytracing_tpu.ops import an_pallas
from opengl_raytracing_tpu.ops import cubemap as jcube
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import materials as jmat
from opengl_raytracing_tpu.ops import scene_analytic as jsa
from opengl_raytracing_tpu.ops.bvh_traverse import trace_bvh as jtrace_bvh
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.utils import image as jimage

from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 env_from_numpy, params_from)
from opengl_raytracing_tpu_torch.ops import an_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import cubemap as tcube
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import materials as tmat
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.sampling import FrameValue
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)
from opengl_raytracing_tpu_torch.utils import image as timage

from torch_param_block import block_at

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBEMAPS = os.path.join(ROOT, "cubemaps")
H, W = 48, 64
F32 = np.float32
TOL_K3 = dict(rtol=2e-5, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- host loaders ----

@pytest.mark.parametrize("name", ["sky_day.png", "sky_dusk.png"])
def test_loader_copies_are_exact(name):
    path = os.path.join(CUBEMAPS, name)
    img = timage.read_png(path)
    np.testing.assert_array_equal(img, jimage.read_png(path))
    assert img.dtype == np.uint8 and img.shape == (192, 256, 3)
    np.testing.assert_array_equal(timage.slice_cubemap_cross(img),
                                  jimage.slice_cubemap_cross(img))
    faces = timage.load_cubemap_cross(path)
    assert faces.shape == (6, 64, 64, 3) and faces.dtype == np.float32
    np.testing.assert_array_equal(faces, jimage.load_cubemap_cross(path))
    assert timage.CROSS_LAYOUT == jimage.CROSS_LAYOUT
    assert faces.std() > 0.05  # a picture, not a constant


def test_png_reader_defilters_every_filter_type(tmp_path):
    """The numpy defilter of the copy against the original's reader, on a
    file whose rows use each PNG filter (the crosses in cubemaps/ may use
    only some)."""
    import struct
    import zlib
    rng = np.random.RandomState(3)
    h, w = 10, 7
    rows = b"".join(bytes([y % 5]) + rng.randint(0, 256, w * 3,
                                                 dtype=np.uint8).tobytes()
                    for y in range(h))
    png = (timage._PNG_SIG
           + timage._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                                0))
           + timage._chunk(b"IDAT", zlib.compress(rows))
           + timage._chunk(b"IEND", b""))
    path = tmp_path / "filters.png"
    path.write_bytes(png)
    np.testing.assert_array_equal(timage.read_png(str(path)),
                                  jimage.read_png(str(path)))


@pytest.mark.parametrize("name", ["sky_day.jpg", "sky_noon.hdr",
                                  "sky_storm.exr"])
def test_other_formats_are_refused(name, tmp_path):
    """The JPEG, Radiance HDR and OpenEXR crosses load since the port has
    the JAX package's readers, to the JAX package's arrays; a file of any
    other format is refused with ValueError, as in the JAX package."""
    path = os.path.join(CUBEMAPS, name)
    faces = timage.load_cubemap_cross(path)
    np.testing.assert_array_equal(faces, jimage.load_cubemap_cross(path))
    assert faces.shape == (6, 64, 64, 3)
    other = tmp_path / f"cross.{name.split('.')[1]}"
    with open(path, "rb") as fh:
        other.write_bytes(b"GIF89a" + fh.read()[6:])
    with pytest.raises(ValueError, match="unrecognized image format"):
        timage.load_cubemap_cross(str(other))


def test_bad_cross_dimensions_raise():
    with pytest.raises(ValueError, match="invalid cubemap cross"):
        timage.slice_cubemap_cross(np.zeros((9, 13, 3), np.uint8))


# ---- directions ----

def _directions(kind, n=512):
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "random":
        d = rng.randn(n, 3)
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)
    if kind == "axis":
        eye = np.eye(3, dtype=F32)
        return np.concatenate([eye, -eye, 3.0 * eye, -1e-3 * eye,
                               np.zeros((1, 3), F32)])
    if kind == "diagonal":
        # two or three equal magnitudes: the face is decided by the order
        # of the >= tests alone
        signs = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                          for c in (-1, 1)], F32)
        mags = np.array([[1, 1, 1], [1, 1, 0.3], [1, 0.3, 1], [0.3, 1, 1],
                         [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
                         [0.3, 0.3, 1]], F32)
        return (signs[:, None] * mags[None]).reshape(-1, 3)
    assert kind == "edge"
    # s or t at or next to 0 and 1, and at the texel boundaries of an
    # 8-texel face: floor and the clamps decide
    u = np.concatenate([np.linspace(-1, 1, 17, dtype=F32),
                        np.nextafter(F32(1), F32(0)) * np.ones(1, F32),
                        -np.nextafter(F32(1), F32(0)) * np.ones(1, F32)])
    uu, vv = np.meshgrid(u, u)
    one = np.ones_like(uu)
    faces = [np.stack(c, -1).reshape(-1, 3) for c in (
        (one, uu, vv), (-one, uu, vv), (uu, one, vv), (uu, -one, vv),
        (uu, vv, one), (uu, vv, -one))]
    return np.concatenate(faces).astype(F32)


KINDS = ["random", "axis", "diagonal", "edge"]


@pytest.mark.parametrize("kind", KINDS)
def test_direction_to_face_uv_matches_jax(kind):
    d = _directions(kind)
    face, s, t = tcube.direction_to_face_uv(_t(d))
    jface, js, jt = jcube.direction_to_face_uv(jnp.asarray(d))
    assert face.dtype == torch.int32
    np.testing.assert_array_equal(face.numpy(), np.asarray(jface))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-6)
    if kind != "axis":
        assert len(np.unique(face.numpy())) == 6


def _env(f, seed=0, dtype=F32):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (6, f, f, 3)).astype(np.uint8)
    return (rng.rand(6, f, f, 3) * 2.0).astype(F32)  # HDR: above 1 too


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("table", ["float8", "float1", "uint8"])
def test_sample_cubemap_matches_jax(kind, table, monkeypatch):
    env = _env(1 if table == "float1" else 8,
               dtype=np.uint8 if table == "uint8" else F32)
    d = _directions(kind)
    got = tcube.sample_cubemap(_t(env), _t(d)).numpy()
    assert got.shape == d.shape and got.dtype == np.float32
    # JAX's default lowering for this table, and its 'flat' form: the
    # form ported (they bit-match each other)
    for mode in ("auto", "flat"):
        monkeypatch.setenv("ORT_ENV_GATHER", mode)
        want = np.asarray(jcube.sample_cubemap(jnp.asarray(env),
                                               jnp.asarray(d)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if table != "float1":
        assert got.std() > 0.05
    # a batch shape other than [N]
    grid = tcube.sample_cubemap(_t(env), _t(d[:12].reshape(3, 4, 3)))
    np.testing.assert_array_equal(grid.numpy().reshape(-1, 3), got[:12])


def test_env_from_numpy_and_dummy_cubemap():
    faces = jimage.load_cubemap_cross(os.path.join(CUBEMAPS, "sky_day.png"))
    env = env_from_numpy(faces, "cpu")
    assert env.dtype == torch.float32 and env.is_contiguous()
    np.testing.assert_array_equal(env.numpy(), faces)
    # the uint8 table a bench builds from the PNG's faces comes back to
    # the loader's own values (k / 255 by true division)
    u8 = np.clip(np.round(faces * 255.0), 0.0, 255.0).astype(np.uint8)
    np.testing.assert_array_equal(env_from_numpy(u8, "cpu").numpy(), faces)
    np.testing.assert_array_equal(tcube.texel_table(_t(u8)).numpy(), faces)
    np.testing.assert_array_equal(
        env_from_numpy(jnp.asarray(u8), "cpu").numpy(), faces)
    with pytest.raises(ValueError, match=r"\[6,F,F,3\]"):
        env_from_numpy(faces[:5], "cpu")
    for size in (1, 4):
        np.testing.assert_array_equal(
            tcube.dummy_cubemap(size, "cpu").numpy(),
            np.asarray(jcube.dummy_cubemap(size)))


# ---- the kernel's arithmetic (csrc/cubemap.cuh), transcribed ----

def kernel_sample_cubemap(env, f, d):
    """csrc/cubemap.cuh's sample_cubemap for rows d [N,3] over the flat
    float32 table env [6*f*f*3], one float32 operation a step."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    x_major = (ax >= ay) & (ax >= az)
    y_major = ~x_major & (ay >= az)
    face = np.where(x_major, np.where(x >= 0, 0, 1),
                    np.where(y_major, np.where(y >= 0, 2, 3),
                             np.where(z >= 0, 4, 5)))
    ma = np.maximum(np.where(x_major, ax, np.where(y_major, ay, az)),
                    F32(1e-12))
    sc = np.where(x_major, np.where(x >= 0, -z, z),
                  np.where(y_major, x, np.where(z >= 0, x, -x)))
    tc = np.where(x_major, -y,
                  np.where(y_major, np.where(y >= 0, z, -z), -y))
    s = F32(0.5) * (sc / ma + F32(1.0))
    t = F32(0.5) * (tc / ma + F32(1.0))

    def taps(u):
        ff = F32(f)
        xs = u * ff - F32(0.5)
        x0 = np.minimum(np.maximum(np.floor(xs), F32(0.0)), ff - F32(1.0))
        i0 = x0.astype(np.int32)
        return (i0, np.minimum(i0 + 1, f - 1),
                np.minimum(np.maximum(xs - x0, F32(0.0)), F32(1.0)))
    x0, x1, fx = taps(s)
    y0, y1, fy = taps(t)
    row0, row1 = (face * f + y0) * f, (face * f + y1) * f

    def tap(i):
        return np.stack([env[3 * i + c] for c in range(3)], -1)
    c00, c01, c10, c11 = (tap(row0 + x0), tap(row0 + x1), tap(row1 + x0),
                          tap(row1 + x1))
    top = c00 + (c01 - c00) * fx[:, None]
    bot = c10 + (c11 - c10) * fx[:, None]
    out = top + (bot - top) * fy[:, None]
    assert out.dtype == F32
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f", [1, 8, 64])
def test_kernel_cubemap_arithmetic_is_bitwise(kind, f):
    env = _env(f, seed=f)
    d = _directions(kind)
    got = kernel_sample_cubemap(env.reshape(-1), f, d)
    want = tcube.sample_cubemap(_t(env), _t(d)).numpy()
    np.testing.assert_array_equal(got, want)


def _an_scenes(jparams, cam_pos, env):
    jscene = JSceneCtx.create(jparams, jnp.asarray(cam_pos),
                              env_map=jnp.asarray(env), use_bvh=False)
    scene = SceneCtx.create(params_from(jparams), _t(cam_pos),
                            env_map=env_from_numpy(env, "cpu"),
                            use_bvh=False)
    return jscene, scene


def test_scene_args_carry_the_env_table():
    """The wrapper hands the kernel the table `scene.sky` samples: its
    pointer, face size and the parameter block that holds the intensity;
    none when the map is disabled or absent.  And the kernel's sky of a
    direction, from those fields, equals `scene.sky` bit for bit."""
    env = _env(8, seed=5)
    jparams = jpreset("baseline").replace(env_map_intensity=0.7)
    _, scene = _an_scenes(jparams, [0.0, 1.0, 4.0], env)
    table = an_cuda._env_table(scene, torch.device("cpu"))
    assert table is scene.env_map
    three = FrameValue.of(3, "cpu")
    s, _ = an_cuda.scene_args(scene, three, three, table)
    assert (s.env, s.env_f) == (table.data_ptr(), 8)
    intensity = block_at(s.prm)["env_map_intensity"]
    assert intensity == np.float32(0.7)
    d = _directions("random")
    got = kernel_sample_cubemap(table.numpy().reshape(-1), s.env_f, d) \
        * F32(intensity)
    np.testing.assert_array_equal(got, scene.sky(_t(d)).numpy())
    assert not an_cuda.scene_args(scene, three, three)[0].env
    off = SceneCtx.create(scene.params.replace(enable_env_map=0),
                          scene.cam_pos, env_map=scene.env_map)
    assert an_cuda._env_table(off, torch.device("cpu")) is None
    none = SceneCtx.create(scene.params, scene.cam_pos)
    assert an_cuda._env_table(none, torch.device("cpu")) is None
    with pytest.raises(ValueError, match=r"\[6,F,F,3\]"):
        SceneCtx.create(scene.params, scene.cam_pos,
                        env_map=torch.zeros(6, 4, 5, 3))


# ---- shading with an environment ----

@pytest.mark.parametrize("table", ["float", "uint8"])
@pytest.mark.parametrize("intensity", [1.0, 0.6])
def test_sky_with_env_matches_jax(table, intensity):
    env = _env(8, seed=2, dtype=np.uint8 if table == "uint8" else F32)
    d = _directions("random")
    jparams = jpreset("baseline").replace(env_map_intensity=intensity)
    params = params_from(jparams)
    got = tsa.sky(_t(d), params, _t(env)).numpy()
    want = np.asarray(jsa.sky(jnp.asarray(d), jparams, jnp.asarray(env)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # disabled: the gradient
    off = params.replace(enable_env_map=0)
    np.testing.assert_array_equal(tsa.sky(_t(d), off, _t(env)).numpy(),
                                  tsa.sky(_t(d), off).numpy())
    assert np.abs(got - tsa.sky(_t(d), off).numpy()).max() > 0.1


def _jfin(cam):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.zeros(2, jnp.float32), curr_view_proj=jnp.asarray(vp),
        prev_view_proj=jnp.asarray(vp), camera_moved=jnp.int32(0))


@pytest.fixture(scope="module")
def frame():
    """Sanitized primary hits of the default camera on the analytic scene
    (JAX trace), the pixel centres and view directions, and an 8x8
    environment."""
    cam = JCamera()
    cam.aspect = W / H
    jparams = jpreset("baseline")
    jscene = JSceneCtx.create(jparams, jnp.asarray(cam.position))
    px, py, rd = primary_rays(H, W, _jfin(cam), jparams)
    ro = jnp.broadcast_to(jnp.asarray(cam.position), rd.shape)
    jh = jsanitize(jscene.trace(ro, rd), ro, rd)
    return dict(cam_pos=np.asarray(cam.position), jh=jh,
                h=tsa.Hit(*(_t(x) for x in jh)), px=np.asarray(px),
                py=np.asarray(py), vdir=-np.asarray(rd), env=_env(8, seed=7))


@pytest.mark.parametrize("case", [
    dict(preset="baseline", frame_index=0),
    dict(preset="full", frame_index=3, change=dict(env_map_intensity=0.5)),
    dict(preset="baseline", frame_index=2, change=dict(sky_enabled=0))])
def test_direct_light_with_env_matches_jax_and_k3(frame, case):
    jparams = jpreset(case["preset"]).replace(**case.get("change", {}))
    jscene, scene = _an_scenes(jparams, frame["cam_pos"], frame["env"])
    h, jh, fi = frame["h"], frame["jh"], case["frame_index"]
    fv = FrameValue.of(fi, "cpu")
    px, py, vdir = frame["px"], frame["py"], frame["vdir"]
    before = dict(cuda_lib.LAUNCHES)
    got = tlt.direct_light(scene, h, fv, fv, _t(vdir), _t(px),
                           _t(py)).numpy()
    assert cuda_lib.LAUNCHES == before  # CPU tensors: the plain version
    args = (jscene, jh, jnp.int32(fi), jnp.int32(fi), jnp.asarray(vdir),
            jnp.asarray(px), jnp.asarray(py))
    want = np.asarray(jlt.direct_light(*args))
    k3 = np.asarray(an_pallas.direct_light_pallas(*args))
    np.testing.assert_allclose(got, want, **TOL_K3)
    np.testing.assert_allclose(got, k3, **TOL_K3)
    # the map shows on the mirror and glass lanes and nowhere else
    plain_scene = SceneCtx.create(scene.params, scene.cam_pos)
    grad = tlt.direct_light(plain_scene, h, fv, fv, _t(vdir), _t(px),
                            _t(py)).numpy()
    env_lanes = tmat.get_material(h.mat, scene.params).mtype.numpy() != 0
    assert env_lanes.sum() > 30
    assert np.abs(got - grad)[env_lanes].max() > 0.05
    np.testing.assert_array_equal(got[~env_lanes], grad[~env_lanes])


@pytest.mark.parametrize("which", ["mirror", "glass"])
def test_shade_mirror_and_glass_with_env_match_jax(frame, which):
    jparams = jpreset("baseline")
    jscene, scene = _an_scenes(jparams, frame["cam_pos"], frame["env"])
    h, jh = frame["h"], frame["jh"]
    px, py, vdir = frame["px"], frame["py"], frame["vdir"]
    mat = tmat.get_material(h.mat, scene.params)
    jm = jmat.get_material(jh.mat, jparams)
    fn = tlt.shade_mirror if which == "mirror" else tlt.shade_glass
    jfn = jlt.shade_mirror if which == "mirror" else jlt.shade_glass
    four = FrameValue.of(4, "cpu")
    got = fn(scene, h, _t(vdir), mat, four, four, _t(px), _t(py)).numpy()
    want = np.asarray(jfn(jscene, jh, jnp.asarray(vdir), jm, jnp.int32(4),
                          jnp.int32(4), jnp.asarray(px), jnp.asarray(py)))
    lanes = mat.mtype.numpy() == (tmat.MTYPE_MIRROR if which == "mirror"
                                  else tmat.MTYPE_GLASS)
    assert lanes.sum() > 15 and np.isfinite(got[lanes]).all()
    np.testing.assert_allclose(got[lanes], want[lanes], rtol=1e-5,
                               atol=1e-5)
    grad = fn(SceneCtx.create(scene.params, scene.cam_pos), h, _t(vdir), mat,
              four, four, _t(px), _t(py)).numpy()
    assert np.abs(got - grad)[lanes].max() > 0.05


def test_gi_analytic_with_env_matches_jax(frame):
    jparams = jpreset("full")
    jscene, scene = _an_scenes(jparams, frame["cam_pos"], frame["env"])
    h, jh = frame["h"], frame["jh"]
    px, py = frame["px"], frame["py"]
    three = FrameValue.of(3, "cpu")
    got = tlt.one_bounce_gi_analytic(scene, h, three, three, three, _t(px),
                                     _t(py)).numpy()
    want = np.asarray(jlt.one_bounce_gi_analytic(
        jscene, jh, jnp.int32(3), jnp.int32(3), jnp.int32(3),
        jnp.asarray(px), jnp.asarray(py)))
    valid = np.asarray(jh.t) < 1e29
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4, atol=1e-5)
    grad = tlt.one_bounce_gi_analytic(
        SceneCtx.create(scene.params, scene.cam_pos), h, three, three,
        three, _t(px), _t(py)).numpy()
    assert np.abs(got - grad)[valid].max() > 0.02  # bounce rays see the map


def test_gi_bvh_with_env_matches_jax():
    """The BVH scene's GI tail reads the environment of the bounce rays
    that miss."""
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    jbvh = jprepare_bvh(tris)
    bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x) for x in jbvh.arrays)),
                         "cpu")
    cam = JCamera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    jparams = jpreset("full")
    env = _env(8, seed=9)
    px, py, rd = primary_rays(H, W, _jfin(cam), jparams)
    ro = jnp.broadcast_to(jnp.asarray(cam.position), rd.shape)
    jraw = jtrace_bvh(jbvh.arrays, ro, rd)
    hit = np.asarray(jraw.valid)
    jh = jsanitize(jraw, ro, rd)
    h = tsa.Hit(*(_t(x) for x in jh))
    jscene = JSceneCtx.create(jparams, jnp.asarray(cam.position),
                              env_map=jnp.asarray(env), use_bvh=True,
                              bvh=jbvh)
    scene = SceneCtx.create(params_from(jparams), _t(cam.position),
                            env_map=env_from_numpy(env, "cpu"), use_bvh=True,
                            bvh=bvh)
    two = FrameValue.of(2, "cpu")
    got = tlt.one_bounce_gi_bvh(scene, h, two, two, two, _t(px), _t(py),
                                active=_t(hit)).numpy()
    want = np.asarray(jlt.one_bounce_gi_bvh(
        jscene, jh, jnp.int32(2), jnp.int32(2), jnp.int32(2), px, py,
        active=jnp.asarray(hit)))
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-4, atol=1e-5)
    grad = tlt.one_bounce_gi_bvh(
        SceneCtx.create(scene.params, scene.cam_pos, use_bvh=True, bvh=bvh),
        h, two, two, two, _t(px), _t(py), active=_t(hit)).numpy()
    assert np.abs(got - grad)[hit].max() > 0.02


def test_no_jax_in_the_new_modules():
    """The modules this environment path added import neither JAX nor the
    JAX package."""
    import re
    pkg = os.path.join(ROOT, "opengl_raytracing_tpu_torch")
    for rel in ("ops/cubemap.py", "ops/tonemap.py", "models/raster.py",
                "utils/image.py", "convert.py", "csrc/cubemap.cuh"):
        with open(os.path.join(pkg, rel)) as fh:
            src = fh.read()
        assert not re.search(r"^\s*(import|from)\s+(jax|opengl_raytracing_tpu"
                             r")(\s|\.|$)", src, re.M), rel
