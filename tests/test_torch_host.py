"""The port's host code against the JAX package's, and its import rules.

The port carries numpy copies of the JAX package's host modules
(constants, params, camera, geometry, BVH build, jitter), because the JAX
package cannot be imported where there is no JAX.  Host code runs the same
numpy operations on the same inputs, so every comparison here is exact.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import opengl_raytracing_tpu.constants as jc
from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.params import RenderParams as JRenderParams
from opengl_raytracing_tpu.sampling import generate_jitter2d as jjitter
from opengl_raytracing_tpu.scene import bvh as jbvh
from opengl_raytracing_tpu.scene import geometry as jgeo
from opengl_raytracing_tpu.utils.image import encode_png as jencode_png

import opengl_raytracing_tpu_torch.constants as tc
from opengl_raytracing_tpu_torch import convert
from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.models import PRESETS, make_render_fn, preset
from opengl_raytracing_tpu_torch.params import RenderParams
from opengl_raytracing_tpu_torch.sampling import generate_jitter2d
from opengl_raytracing_tpu_torch.scene import bvh as tbvh
from opengl_raytracing_tpu_torch.scene import geometry as tgeo
from opengl_raytracing_tpu_torch.utils.image import encode_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "opengl_raytracing_tpu_torch")


def _port_modules():
    names = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                names.append(rel.replace(os.sep, ".")
                             .removesuffix(".__init__"))
    return sorted(names)


def test_constants_equal():
    names = [n for n in dir(jc) if n.isupper()]
    assert names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n


def test_render_params_fields_and_defaults():
    ours = [(f.name, f.type) for f in dataclasses.fields(RenderParams)]
    theirs = [(f.name, f.type) for f in dataclasses.fields(JRenderParams)]
    assert ours == theirs
    assert dataclasses.asdict(RenderParams()) == dataclasses.asdict(
        JRenderParams())


@pytest.mark.parametrize("name", PRESETS)
def test_presets_and_params_from(name):
    assert convert.params_from(jpreset(name)) == preset(name)
    changed = jpreset(name).replace(exposure=1.5, sun_color=(0.5, 0.25, 1.0),
                                    enable_jitter=0)
    assert convert.params_from(changed) == preset(name).replace(
        exposure=1.5, sun_color=(0.5, 0.25, 1.0), enable_jitter=0)


def test_params_from_rejects_unknown_fields():
    extra = dataclasses.make_dataclass(
        "Extra", [("novel_knob", int, dataclasses.field(default=1))],
        bases=(JRenderParams,), frozen=True)
    with pytest.raises(ValueError, match="novel_knob"):
        convert.params_from(extra())


@pytest.mark.parametrize("pose", [
    dict(), dict(position=(-2.0, 1.6, 1.2), look=(-2.0, 1.5, 0.0)),
    dict(position=(0.0, 2.0, 8.0), look=(-2.0, 1.5, 0.0), fov=40.0,
         aspect=480 / 270)])
def test_camera_basis_and_view_projection(pose):
    cams = []
    for cls in (Camera, JCamera):
        cam = cls()
        if "position" in pose:
            cam.position = np.asarray(pose["position"], np.float32)
            cam.point_at(pose["look"])
        cam.fov = pose.get("fov", cam.fov)
        cam.aspect = pose.get("aspect", cam.aspect)
        cam.move(forward=0.3, strafe=-0.2)
        cam.look(5.0, -3.0)
        cams.append(cam)
    a, b = cams
    np.testing.assert_array_equal(a.position, b.position)
    for x, y in zip(a.basis(), b.basis()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.view_projection(), b.view_projection())


@pytest.mark.parametrize("subdiv", [2, 4])
def test_geometry_exact(subdiv):
    for ours, theirs in ((tgeo.make_bunny(subdiv), jgeo.make_bunny(subdiv)),
                         (tgeo.make_icosphere(0.7, subdiv),
                          jgeo.make_icosphere(0.7, subdiv))):
        for x, y in zip(ours, theirs):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    xf = tgeo.model_transform((-2.0, 1.5, 0.0), 0.5)
    np.testing.assert_array_equal(xf, jgeo.model_transform((-2.0, 1.5, 0.0),
                                                           0.5))
    tris = tgeo.gather_triangles(tgeo.make_bunny(subdiv), xf)
    np.testing.assert_array_equal(
        tris, jgeo.gather_triangles(jgeo.make_bunny(subdiv), xf))
    assert tris.shape == (20 * 4 ** subdiv, 9)


@pytest.mark.parametrize("subdiv", [2, 4])
def test_build_bvh_exact(subdiv):
    tris = tgeo.gather_triangles(tgeo.make_bunny(subdiv),
                                 tgeo.model_transform((-2.0, 1.5, 0.0), 0.5))
    ours, theirs = tbvh.build_bvh(tris), jbvh.build_bvh(tris)
    for f in dataclasses.fields(tbvh.BVH):
        np.testing.assert_array_equal(getattr(ours, f.name),
                                      getattr(theirs, f.name), f.name)
    jbvh.validate_bvh(theirs, tris)
    for x, y in zip(tbvh.bvh_to_arrays(ours), jbvh.bvh_to_arrays(theirs)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_generate_jitter2d_exact():
    for i in list(range(0, 70)) + [1023, 1024, 1025, 4097, 2 ** 31 - 1]:
        np.testing.assert_array_equal(generate_jitter2d(i), jjitter(i))


def test_convert_bvh_from_jax_arrays():
    tris = jgeo.gather_triangles(jgeo.make_bunny(2),
                                 jgeo.model_transform((-2.0, 1.5, 0.0), 0.5))
    arrays = [np.asarray(x) for x in jprepare_bvh(tris).arrays]
    dev = convert.bvh_from_numpy(tbvh.BVHArrays(*arrays), "cpu")
    for x, want, dtype in zip(dev.arrays, arrays,
                              (torch.float32, torch.int32, torch.float32)):
        assert x.dtype == dtype and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), want)


def test_convert_frame_inputs():
    jcam, cam = JCamera(), Camera()
    jcam.aspect = cam.aspect = 64 / 48
    right, up, fwd, thf = jcam.basis()
    vp = jcam.view_projection()
    jfin = JFrameInputs(
        cam_pos=jnp.asarray(jcam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(jcam.aspect),
        jitter=jnp.asarray([0.125, -0.25], jnp.float32),
        curr_view_proj=jnp.asarray(vp), prev_view_proj=jnp.asarray(vp * 2),
        camera_moved=jnp.int32(1))
    fin = convert.frame_inputs_from_numpy(jfin, "cpu")
    for f in dataclasses.fields(JFrameInputs):
        got = getattr(fin, f.name)
        want = np.asarray(getattr(jfin, f.name))
        assert got.dtype == (torch.int32 if f.name == "camera_moved"
                             else torch.float32), f.name
        np.testing.assert_array_equal(got.numpy(), want, f.name)
    fin2 = convert.camera_frame_inputs(cam, "cpu", jitter=(0.125, -0.25),
                                       prev_view_proj=vp * 2, moved=1)
    for f in dataclasses.fields(JFrameInputs):
        assert torch.equal(getattr(fin2, f.name), getattr(fin, f.name))


def test_encode_png_matches():
    rng = np.random.RandomState(0)
    img = rng.rand(5, 7, 3).astype(np.float32)
    assert encode_png(img) == jencode_png(img)


def test_port_never_imports_jax():
    mods = _port_modules()
    assert "opengl_raytracing_tpu_torch.ops.bvh_cuda" in mods
    assert "opengl_raytracing_tpu_torch.ops.an_cuda" in mods
    for new in ("ops.cubemap", "ops.tonemap", "models.raster", "utils.image",
                "frame_state", "utils.log", "utils.paths",
                "utils.checkpoint", "utils.profiling", "scene.importers",
                "app", "app.input", "app.state", "app.application",
                "app.headless", "app.viewer", "parallel",
                "parallel.sharding", "parallel.shardmap", "native"):
        assert f"opengl_raytracing_tpu_torch.{new}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'opengl_raytracing_tpu', 'triton')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    for m in mods:
        path = os.path.join(REPO, *m.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else os.path.join(
            path, "__init__.py")
        with open(path) as fh:
            src = fh.read()
        assert "import jax" not in src and "from jax" not in src, m
    # the card-side scripts at the repo root import neither
    for name in sorted(os.listdir(REPO)):
        if name == "chip_smoke.py" or (name.startswith("probe_")
                                       and name.endswith(".py")):
            with open(os.path.join(REPO, name)) as fh:
                src = fh.read()
            assert not re.search(r"^\s*(import|from)\s+(jax|"
                                 r"opengl_raytracing_tpu)(\s|\.|$)", src,
                                 re.M), name


def test_kernel_module_imports_without_nvcc_and_build_raises():
    """The kernel modules import with neither nvcc nor triton, and building
    without nvcc raises with a message instead of falling back."""
    code = ("import sys\n"
            "import opengl_raytracing_tpu_torch.ops.bvh_cuda\n"
            "import opengl_raytracing_tpu_torch.ops.an_cuda\n"
            "import opengl_raytracing_tpu_torch.ops.cuda_lib as k\n"
            "assert 'triton' not in sys.modules\n"
            "try:\n    k.build_all()\nexcept RuntimeError as e:\n"
            "    assert 'nvcc' in str(e), e\n"
            "else:\n    raise SystemExit('build did not raise')\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_render_fn(48, 64, "cuda")


def test_frame_state_equals_jax():
    from opengl_raytracing_tpu.frame_state import FrameState as JFrameState
    from opengl_raytracing_tpu_torch import FrameState
    cam = Camera()
    vp, pos = cam.view_projection(), cam.position
    for cls in (FrameState, JFrameState):
        assert [f.name for f in dataclasses.fields(cls)] == [
            "curr_view_proj", "prev_view_proj", "curr_cam_pos",
            "prev_cam_pos", "jitter"]
    ours, theirs = FrameState.initial(vp, pos), JFrameState.initial(vp, pos)
    for _ in range(2):
        for f in dataclasses.fields(FrameState):
            x, y = getattr(ours, f.name), np.asarray(getattr(theirs, f.name))
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y, f.name)
        assert ours.camera_moved() == theirs.camera_moved()
        cam.move(forward=1.0)
        ours = ours.begin_frame(cam.view_projection(), cam.position,
                                (0.25, -0.125))
        theirs = theirs.begin_frame(cam.view_projection(), cam.position,
                                    (0.25, -0.125))
        assert ours.camera_moved() and theirs.camera_moved()
        assert ours.camera_moved(tol=10.0) == theirs.camera_moved(tol=10.0)
        ours, theirs = ours.end_frame(), theirs.end_frame()
        assert not ours.camera_moved() and not theirs.camera_moved()
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.jitter = None


def test_params_changed_equals_jax():
    """Every field changed alone, by more and by less than the 1e-5
    tolerance, gives JAX's decision; the exclusions (exposure,
    motion_scale, ordered_primary) are the same."""
    from opengl_raytracing_tpu.params import params_changed as jchanged
    from opengl_raytracing_tpu_torch import params_changed
    from opengl_raytracing_tpu_torch.params import _as_floats
    assert _as_floats((1, 2)) == (1.0, 2.0) and _as_floats(3) == 3.0
    base, jbase = RenderParams(), JRenderParams()
    decisions = []
    for f in dataclasses.fields(RenderParams):
        v = getattr(base, f.name)
        if f.type == "int":
            deltas = [dict(value=v + 1)]
        elif isinstance(v, tuple):
            deltas = [dict(value=(v[0], v[1] + d, v[2]))
                      for d in (2e-5, 5e-6)]
        else:
            deltas = [dict(value=v + d) for d in (2e-5, 5e-6, -1.0)]
        for d in deltas:
            ours = params_changed(base, base.replace(**{f.name: d["value"]}))
            theirs = jchanged(jbase, jbase.replace(**{f.name: d["value"]}))
            assert ours == theirs, (f.name, d)
            decisions.append(ours)
    assert any(decisions) and not all(decisions)
    for name in ("exposure", "motion_scale", "ordered_primary"):
        v = getattr(base, name)
        assert not params_changed(base, base.replace(**{name: v * 3 + 1}))
    assert not params_changed(base, base)


def test_log_and_paths_equal_jax(tmp_path, monkeypatch):
    import importlib
    jlog, jpaths, tlog, tpaths = (
        importlib.import_module(f"{pkg}.utils.{m}")
        for pkg in ("opengl_raytracing_tpu", "opengl_raytracing_tpu_torch")
        for m in ("log", "paths"))
    assert tlog.KNOWN_TAGS == jlog.KNOWN_TAGS
    ours, theirs = tlog.Logger(echo=False), jlog.Logger(echo=False)
    got = []
    ours.sinks.append(got.append)
    for lg in (ours, theirs):
        lg.log("BVH", "loaded %s: %d tris", "m.obj", 12)
        lg.log("ACCUM", "reset (manual)")
        lg.log("GUI", "100%% plain")
    assert ours.lines == theirs.lines == got
    assert ours.filtered("ACCUM") == theirs.filtered("ACCUM") == [
        "[ACCUM] reset (manual)"]
    assert ours.filtered(None) == ours.lines
    ours.clear()
    assert ours.lines == []
    assert isinstance(tlog.default_logger(), tlog.Logger)
    # the repo is found from inside it and from the package's own file
    assert tpaths.repo_root() == jpaths.repo_root() == REPO
    assert tpaths.repo_root(os.path.join(PKG, "app")) == REPO
    for rel in ("models", "cubemaps", "models/bunny_lp.obj"):
        assert tpaths.resolve_path(rel) == jpaths.resolve_path(rel)
        assert os.path.exists(tpaths.resolve_path(rel))
    monkeypatch.chdir(tmp_path)  # away from the repo: the package's file
    assert tpaths.repo_root() == REPO
    assert tpaths.resolve_dir("cubemaps") == os.path.join(REPO, "cubemaps")
    made = tpaths.resolve_dir("fresh", create=True)
    assert os.path.isdir(made)


def test_profiling_helpers():
    from opengl_raytracing_tpu.utils.profiling import RayCounter as JRays
    from opengl_raytracing_tpu_torch.models import FrameOutputs
    from opengl_raytracing_tpu_torch.utils.profiling import (
        FrameTimer, RayCounter, force_complete, torch_profiler_trace)
    for name in PRESETS:
        assert RayCounter(48, 64).rays_per_frame(preset(name)) == \
            JRays(48, 64).rays_per_frame(jpreset(name))
        assert RayCounter(48, 64).mrays(preset(name), 2.0) == \
            JRays(48, 64).mrays(jpreset(name), 2.0)
    out = FrameOutputs(*(torch.full((2, 3), float(i)) for i in range(4)))
    assert force_complete(out) == 36.0
    assert force_complete({"a": [torch.ones(3)], "b": None}) == 3.0
    assert force_complete([]) == 0.0
    timer = FrameTimer(window=2)
    for _ in range(3):
        with timer.section("frame", [out]):
            pass
    assert timer.stats()["frame"]["n"] == 2
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        with torch_profiler_trace(d):
            torch.ones(4).sum()
        assert os.path.getsize(os.path.join(d, "trace.json")) > 0


def test_package_exports_match_jax():
    import opengl_raytracing_tpu as jpkg
    import opengl_raytracing_tpu_torch as tpkg
    from opengl_raytracing_tpu import app as japp
    from opengl_raytracing_tpu_torch import app as tapp
    for name in ("EPS", "PI", "INF", "RenderParams", "params_changed",
                 "Camera", "FrameState"):
        assert hasattr(tpkg, name) and hasattr(jpkg, name), name
    for name in ("AppState", "InputState", "ACTIONS", "Application"):
        assert hasattr(tapp, name) and hasattr(japp, name), name
