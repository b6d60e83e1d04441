"""The port's application layer against the JAX package's.

`opengl_raytracing_tpu_torch/app/` drives the port's `render_frame` the
way `opengl_raytracing_tpu/app/` drives the JAX one.  The same scripted
session of hotkey actions goes through both `Application`s (the JAX one
eager, `jit=False`, as tests/test_app.py runs it) and must give the same
host state after every step, exactly: frame index, jitter, camera, params
and the accumulation resets logged with their reasons.  Images and
accumulations are held within the port's CPU tolerance against JAX (1e-4,
tests/test_torch_pipeline.py; float32 rounding of the same math in
another order); the raster preview and the motion view frames hold
exactly.  Snapshots cross between the packages, `headless.main` writes
the files JAX's does, and the rest of tests/test_app.py and
tests/test_viewer.py is ported for the port's app and viewer on the CPU.
"""

import argparse
import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu.app import Application as JApplication
from opengl_raytracing_tpu.app import AppState as JAppState
from opengl_raytracing_tpu.app.headless import build_parser as jbuild_parser
from opengl_raytracing_tpu.app.headless import main as jmain
from opengl_raytracing_tpu.models.presets import preset as jpreset
from opengl_raytracing_tpu.utils.checkpoint import (
    load_snapshot as jload_snapshot, save_snapshot as jsave_snapshot)
from opengl_raytracing_tpu.utils.log import default_logger as jlogger

from opengl_raytracing_tpu_torch.app import Application, AppState
from opengl_raytracing_tpu_torch.app.headless import (build_parser, main,
                                                      make_app)
from opengl_raytracing_tpu_torch.app.input import (ACTIONS, SPP_PRESETS,
                                                   InputState, apply_action)
from opengl_raytracing_tpu_torch.app.viewer import (_PAGE, PANEL_SCHEMA,
                                                    ViewerState,
                                                    make_handler)
from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 env_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.frame_state import FrameState
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.models.raster import CLEAR_COLOR
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform,
                                               save_obj)
from opengl_raytracing_tpu_torch.utils.checkpoint import (load_preset,
                                                          load_snapshot,
                                                          save_preset,
                                                          save_snapshot)
from opengl_raytracing_tpu_torch.utils.image import (load_cubemap_cross,
                                                     read_jpeg, read_png)
from opengl_raytracing_tpu_torch.utils.log import default_logger, log

torch.set_num_threads(2)

H, W = 24, 32
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one step per entry: the actions applied before it ("orbit on"/"orbit
# off" set point_light_orbit_enabled, as the viewer's /set does)
SESSION = [(), ("move_w", "look 6 -3"),
           ("exposure_down", "exposure_up", "exposure_up"), ("spp_cycle",),
           ("toggle_motion_debug",), ("toggle_motion_debug",
                                      "toggle_ray_mode"),
           ("toggle_ray_mode", "orbit on"), ("orbit off", "reset", "zoom 2"),
           ()]
BVH_SESSION = [(), ("move_d", "toggle_ray_mode"), ("toggle_ray_mode",
                                                   "zoom -1")]


def small_app(name="baseline", **kw):
    return Application(state=AppState(H, W, preset(name).replace(**kw),
                                      device="cpu"))


def _apps(name):
    return (JApplication(state=JAppState(H, W, jpreset(name)), jit=False),
            small_app(name))


def _share_bvh(ja, ta, share=True):
    """Both apps on the BVH scene with the JAX package's tree; with
    share=False the port's app builds its own tree from the same
    triangles (`set_bvh_from_tris`), which must be JAX's exactly."""
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    ja.app.set_bvh_from_tris(tris)
    if share:
        ta.app.bvh = bvh_from_numpy(
            BVHArrays(*(np.asarray(x) for x in ja.app.bvh.arrays)), "cpu")
    else:
        ta.app.set_bvh_from_tris(tris)
        for got, want in zip(ta.app.bvh.arrays, ja.app.bvh.arrays):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a in (ja, ta):
        a.app.use_bvh = True
        a.app.camera.fov = 20.0  # the bunny fills a fifth of the frame
        a.app.camera.point_at((-2.0, 1.5, 0.0))
    ja.app.frame = type(ja.app.frame).initial(ja.app.camera.view_projection(),
                                              ja.app.camera.position)
    ta.app.frame = FrameState.initial(ta.app.camera.view_projection(),
                                      ta.app.camera.position)


def _act(a, actions):
    for act in actions:
        if act.startswith("orbit "):
            a.app.params = a.app.params.replace(
                point_light_orbit_enabled=int(act == "orbit on"))
        else:
            a.act(act)


def _accum_lines(logger, start):
    return [ln for ln in logger.lines[start:] if ln.startswith("[ACCUM]")]


def _assert_same_host_state(ja, ta):
    j, t = ja.app, ta.app
    assert t.host_frame_index == j.host_frame_index
    assert t.render_state.frame_index == int(j.render_state.frame_index)
    for f in ("curr_view_proj", "prev_view_proj", "curr_cam_pos",
              "prev_cam_pos", "jitter"):
        np.testing.assert_array_equal(getattr(t.frame, f),
                                      np.asarray(getattr(j.frame, f)), f)
    np.testing.assert_array_equal(t.camera.position, j.camera.position)
    assert (t.camera.yaw, t.camera.pitch, t.camera.fov) == (
        j.camera.yaw, j.camera.pitch, j.camera.fov)
    assert t.params == params_from(j.params)
    assert t.prev_params == params_from(j.prev_params)
    assert (t.ray_mode, t.use_bvh, t.show_motion) == (j.ray_mode, j.use_bvh,
                                                      j.show_motion)
    assert (ta.input.spp_per_frame, ta.input.exposure) == (
        ja.input.spp_per_frame, ja.input.exposure)


@pytest.mark.parametrize("scene,name", [("analytic", "baseline"),
                                        ("bvh", "baseline"),
                                        ("bvh_own_tree", "baseline")])
def test_scripted_session_matches_jax(scene, name):
    ja, ta = _apps(name)
    script = SESSION
    if scene != "analytic":
        _share_bvh(ja, ta, share=scene == "bvh")
        script = BVH_SESSION
    nj, nt = len(jlogger().lines), len(default_logger().lines)
    for step, actions in enumerate(script):
        _act(ja, actions)
        _act(ta, actions)
        want = np.asarray(ja.step())
        got = ta.step().numpy()
        what = f"step {step} after {actions}"
        _assert_same_host_state(ja, ta)
        assert _accum_lines(default_logger(), nt) == \
            _accum_lines(jlogger(), nj), what
        if not ta.app.ray_mode or ta.app.show_motion:
            np.testing.assert_array_equal(got, want, what)
        else:
            np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        np.testing.assert_allclose(ta.app.render_state.accum.numpy(),
                                   np.asarray(ja.app.render_state.accum),
                                   err_msg=what, **TOL)
    resets = _accum_lines(default_logger(), nt)
    if scene == "analytic":
        # every reset reason of the session, in order
        assert [ln.split("(")[1][:-1] for ln in resets] == [
            "spp change", "params changed", "motion debug", "mode toggle",
            "motion debug", "mode toggle", "params changed", "manual",
            "params changed"]
    else:
        assert [ln.split("(")[1][:-1] for ln in resets] == [
            "mode toggle", "mode toggle", "fov zoom"]


def test_turbo_still_chain_equals_sequential_steps():
    """turbo=k (k still frames chained per step) reproduces k sequential
    step() calls bit for bit: jitter sequence, accumulation, image."""
    a, b = small_app("full"), small_app("full")
    b.turbo = 3
    for _ in range(3):
        img_a = a.step()
    img_b = b.step()
    assert b.app.render_state.frame_index == b.app.host_frame_index == 3
    assert torch.equal(b.app.render_state.accum, a.app.render_state.accum)
    assert torch.equal(img_b, img_a)


def test_turbo_moving_chain_equals_sequential_steps():
    """Moving turbo: one step = the camera-move frame plus k-1 settling
    frames, bit for bit the same k frames stepped one by one."""
    a, b = small_app("full"), small_app("full")
    b.turbo = 4
    b.act("look 5 0")
    img_b = b.step()
    assert b.app.render_state.frame_index == 4
    a.act("look 5 0")
    for _ in range(4):
        img_a = a.step()
    assert torch.equal(b.app.render_state.accum, a.app.render_state.accum)
    assert torch.equal(img_b, img_a)


def test_turbo_caps_moving_chains_and_stops_while_orbiting():
    a = small_app()
    a.turbo = 9
    a.act("move_w")
    a.step()
    assert a.app.host_frame_index == 6  # moving chains cap at 6
    a.step()
    assert a.app.host_frame_index == 15  # still: all 9
    o = small_app(point_light_orbit_enabled=1)
    o.turbo = 4
    o.step()
    # one frame, then the orbit's yaw diff resets the accumulation
    assert o.app.host_frame_index == 0
    assert len(o.app.frame_times_ms) == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_crosses_packages(tmp_path, writer):
    """A snapshot written by either package resumes in the other: the
    resumed frames match the writer's own continued frames (JAX's within
    the CPU tolerance, the port's own exactly)."""
    ja, ta = _apps("baseline")
    src = ja if writer == "jax" else ta
    for _ in range(2):
        src.act("look 2 1")
        src.step()
    path = str(tmp_path / "snap.npz")
    s = src.app
    (jsave_snapshot if writer == "jax" else save_snapshot)(
        path, s.params, s.camera, s.frame, s.render_state)
    if writer == "jax":
        p, cam, frame, rs = load_snapshot(path, "cpu")
        dst = ta
        assert p == params_from(s.params)
    else:
        p, cam, frame, rs = jload_snapshot(path)
        dst = ja
        assert params_from(p) == s.params
    dst.app.params = dst.app.prev_params = p
    dst.app.camera, dst.app.frame = cam, frame
    dst.app.restore_render_state(rs)
    assert dst.app.host_frame_index == 2
    for _ in range(2):
        want = np.asarray(src.step())
        got = np.asarray(dst.step())
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.asarray(dst.app.render_state.accum),
                               np.asarray(src.app.render_state.accum), **TOL)
    assert int(dst.app.render_state.frame_index) == 4


def test_snapshot_resume_is_bit_exact_in_the_port(tmp_path):
    a = small_app("full")
    for _ in range(2):
        a.step()
    s = a.app
    save_snapshot(str(tmp_path / "s"), s.params, s.camera, s.frame,
                  s.render_state)
    b = small_app("full")
    p, cam, frame, rs = load_snapshot(str(tmp_path / "s"), "cpu")
    b.app.params = b.app.prev_params = p
    b.app.camera, b.app.frame = cam, frame
    b.app.restore_render_state(rs)
    for _ in range(2):
        assert torch.equal(b.step(), a.step())
    assert torch.equal(b.app.render_state.accum, a.app.render_state.accum)


def test_headless_main_writes_jax_files(tmp_path):
    """`headless.main` at 32x24 writes the files JAX's writes (frame
    dumps, the last frame, snapshot, preset), with images within 1/255
    and equal snapshot keys, params and frame index."""
    args = ["--preset", "baseline", "--size", "32x24", "--frames", "2",
            "--dump-every", "1", "--camera-anim", "pan", "--cpu",
            "--set", "sun_intensity=0.9"]
    outs = {}
    for who, run, extra in (("jax", jmain, ["--no-jit"]),
                            ("port", main, [])):
        out = tmp_path / who
        assert run(args + extra + [
            "--out", str(out), "--snapshot", str(out / "snap.npz"),
            "--save-preset", str(out / "p.json")]) == 0
        outs[who] = out
    assert sorted(os.listdir(outs["port"])) == \
        sorted(os.listdir(outs["jax"])) == [
        "frame_0000.png", "frame_0001.png", "frame_last.png", "p.json",
        "snap.npz"]
    for name in ("frame_0000.png", "frame_0001.png", "frame_last.png"):
        got, want = (read_png(str(outs[w] / name)).astype(int)
                     for w in ("port", "jax"))
        assert got.shape == (24, 32, 3)
        assert np.abs(got - want).max() <= 1, name
    assert (outs["port"] / "p.json").read_text() == \
        (outs["jax"] / "p.json").read_text()
    with np.load(outs["port"] / "snap.npz") as zp, \
            np.load(outs["jax"] / "snap.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype and zp[k].shape == zj[k].shape
            if k == "accum":
                np.testing.assert_allclose(zp[k], zj[k], **TOL)
            else:
                np.testing.assert_array_equal(zp[k], zj[k], k)


def test_resume_reapplies_cli_overrides(tmp_path):
    """--set overrides win over a resumed snapshot's params, and the
    hotkey mirrors track the restored values."""
    base = build_parser().parse_args(
        ["--cpu", "--size", "32x24", "--frames", "1"])
    app1 = make_app(base)
    a = app1.app
    a.params = a.params.replace(exposure=2.0)
    p = str(tmp_path / "snap.npz")
    save_snapshot(p, a.params, a.camera, a.frame, a.render_state)
    resumed = argparse.Namespace(**vars(base))
    resumed.resume = p
    resumed.set = ["sun_intensity=0.9"]
    app2 = make_app(resumed)
    assert app2.app.params.exposure == 2.0  # snapshot
    assert abs(app2.app.params.sun_intensity - 0.9) < 1e-6  # CLI wins
    assert app2.input.exposure == 2.0  # mirror synced
    assert main(["--cpu", "--size", "32x24", "--frames", "1", "--resume", p,
                 "--set", "sun_intensity=0.9",
                 "--out", str(tmp_path / "o")]) == 0


def test_headless_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    args = build_parser().parse_args(["--size", "32x24"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_app(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(height=8, width=8)
    # the two CLIs take the same flags, --jit/--no-jit (the default on)
    # included
    assert build_parser().parse_args([]).jit is True
    assert build_parser().parse_args(["--no-jit"]).jit is False
    assert build_parser().parse_args(["--jit"]).jit is True

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    assert flags(build_parser()) == flags(jbuild_parser())


@pytest.mark.parametrize("scene", ["analytic", "bvh"])
def test_cpu_app_jit_renders_as_no_jit(scene, tmp_path):
    """On the CPU `--jit` has nothing to capture and runs the eager frame:
    the same images as `--no-jit`, a turbo chain and the camera moving
    included."""
    images = []
    for jit in ("--jit", "--no-jit"):
        args = build_parser().parse_args(
            ["--cpu", "--size", f"{W}x{H}", "--scene", scene, "--turbo",
             "3", jit])
        app = make_app(args)
        assert app.jit is (jit == "--jit")
        got = []
        for step in range(3):
            if step == 1:
                app.act("look 4 0")
            got.append(app.step())
        assert app.app.render_state.frame_index == 9
        assert app.eager_frames == 0
        images.append(torch.stack(got))
    assert torch.equal(images[0], images[1])


def test_sweep_writes_one_image_per_value(tmp_path):
    assert main(["--cpu", "--preset", "baseline", "--size", "16x12",
                 "--frames", "1", "--sweep", "exposure=0.5,2",
                 "--out", str(tmp_path)]) == 0
    a, b = (read_png(str(tmp_path / f"sweep_exposure_{v}.png")).astype(int)
            for v in ("0.5", "2"))
    assert a.shape == (12, 16, 3) and b.mean() > a.mean()


def test_env_map_is_the_bench_table():
    """load_env_map keeps an 8-bit cross as uint8 texels, as the JAX
    package does, and places k / 255 on the device: the table
    chip_smoke.py's sky_day builds.  Float crosses are carried as read."""
    ja, ta = _apps("baseline")
    for name in ("sky_day.png", "sky_day.jpg", "sky_noon.hdr",
                 "sky_storm.exr"):
        path = os.path.join(REPO, "cubemaps", name)
        assert ja.app.load_env_map(path) and ta.app.load_env_map(path)
        jenv = np.asarray(ja.app.env_map)
        if jenv.dtype == np.uint8:
            jenv = jenv.astype(np.float32) / np.float32(255.0)
            faces = load_cubemap_cross(path)
            bench = env_from_numpy(np.clip(np.round(faces * 255.0), 0.0,
                                           255.0).astype(np.uint8), "cpu")
            assert torch.equal(ta.app.env_map, bench), name
        assert ta.app.env_map.dtype == torch.float32
        np.testing.assert_array_equal(ta.app.env_map.numpy(), jenv, name)
    before = ta.app.env_map
    assert not ta.app.load_env_map(os.path.join(REPO, "cubemaps", "no.png"))
    assert ta.app.env_map is before


def test_env_map_frames_match_jax():
    ja, ta = _apps("baseline")
    for a in (ja, ta):
        a.app.load_env_map(os.path.join(REPO, "cubemaps", "sky_noon.hdr"))
    for _ in range(2):
        np.testing.assert_allclose(ta.step().numpy(), np.asarray(ja.step()),
                                   **TOL)


# -- tests/test_app.py, for the port's app --

def test_step_produces_image_and_advances_accum():
    a = small_app()
    img = a.step()
    assert img.shape == (H, W, 3) and img.device.type == "cpu"
    assert a.app.render_state.frame_index == 1
    a.step()
    assert a.app.render_state.frame_index == 2


def test_param_change_resets_and_exposure_does_not():
    a = small_app()
    a.step()
    a.step()
    a.act("exposure_up")
    a.step()
    assert a.app.render_state.frame_index == 3
    a.app.params = a.app.params.replace(motion_scale=8.0)
    a.step()
    assert a.app.render_state.frame_index == 4
    a.app.params = a.app.params.replace(sun_intensity=0.9)
    a.step()  # detected at end of frame -> reset
    assert a.app.render_state.frame_index == a.app.host_frame_index == 0
    a.act("move_w")
    a.step()  # moving does not reset: TAA reprojects
    assert a.app.render_state.frame_index == 1


def test_spp_and_exposure_hotkeys():
    a = small_app()
    seen = []
    for _ in range(6):
        a.act("spp_cycle")
        a.step()
        seen.append(a.app.params.spp_per_frame)
    assert seen == [2, 4, 8, 16, 1, 2]
    a.act("spp_preset_3")
    a.step()
    assert a.app.params.spp_per_frame == SPP_PRESETS[3] == 8
    for _ in range(300):
        a.act("exposure_up")
    a.step()
    assert a.app.params.exposure == 8.0
    for _ in range(800):
        a.act("exposure_down")
    a.step()
    assert a.app.params.exposure == 0.05


def test_input_actions_match_jax():
    from opengl_raytracing_tpu.app import input as jinput
    assert ACTIONS == jinput.ACTIONS
    assert SPP_PRESETS == jinput.SPP_PRESETS
    for spp in (1, 2, 3, 6, 8, 16):
        for act in ("spp_cycle", "spp_up", "spp_down", "spp_preset_0",
                    "spp_preset_4", "exposure_up", "exposure_down", "reset",
                    "toggle_bvh", "quit"):
            ours = apply_action(InputState(spp_per_frame=spp), act)
            theirs = jinput.apply_action(
                jinput.InputState(spp_per_frame=spp), act)
            assert vars(ours) == vars(theirs), (spp, act)
    with pytest.raises(ValueError, match="requires an app"):
        apply_action(InputState(), "move_w")
    with pytest.raises(ValueError, match="unknown action"):
        apply_action(InputState(), "fly")


def test_raster_mode_and_last_u8():
    a = small_app()
    a.want_u8 = True
    img = a.step()
    want = np.clip(img.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(a.last_u8.numpy(), want)
    a.act("toggle_ray_mode")
    img = a.step()
    assert a.last_u8 is None and a.last_output is None
    np.testing.assert_allclose(img[-1, 0].numpy(), CLEAR_COLOR, atol=1e-6)


def test_motion_debug_and_orbit():
    a = small_app()
    a.act("toggle_motion_debug")
    assert torch.isfinite(a.step()).all()
    o = small_app(point_light_orbit_enabled=1)
    o.step(dt=0.5)
    o.step(dt=0.5)
    assert o.app.params.point_light_yaw == 20.0
    assert o.app.render_state.frame_index == 0  # continuous reset
    o.app.params = o.app.params.replace(point_light_yaw=355.0)
    o.step(dt=1.0)
    assert o.app.params.point_light_yaw == 15.0  # wrapped


def test_model_picker_reload_and_failure_keeps_previous(tmp_path):
    save_obj(str(tmp_path / "blob.obj"), make_bunny(1))
    a = small_app()
    a.app.model_picker.directory = str(tmp_path)
    a.app.model_picker.scan()
    a.app.use_bvh = True
    a.app.set_bvh_from_tris(gather_triangles(make_bunny(0),
                                             model_transform()))
    assert a.app.bvh_tri_count == 20
    a.app.model_picker.request(0)
    a.step()
    assert a.app.bvh_tri_count == 80
    assert not a.app.model_picker.reload_requested
    before = a.app.bvh
    assert not a.app.load_bvh_model("/nonexistent/file.obj")
    assert a.app.bvh is before and a.app.bvh_tri_count == 80


def test_env_picker_reload():
    a = small_app()
    names = [os.path.basename(p) for p in a.app.env_picker.entries]
    assert names == ["sky_day.jpg", "sky_day.png", "sky_dusk.png",
                     "sky_noon.hdr", "sky_storm.exr"]
    a.step()
    a.app.env_picker.request(names.index("sky_storm.exr"))
    a.step()
    assert a.app.env_map is not None and a.app.env_map.shape == (6, 64, 64, 3)
    assert a.app.host_frame_index == 0  # "env reload" reset


def test_resize_recreates_buffers():
    a = small_app()
    a.step()
    a.app.resize(20, 40)
    assert a.app.render_state.frame_index == 0
    assert a.step().shape == (20, 40, 3)


def test_preset_roundtrip(tmp_path):
    p = preset("heavy").replace(exposure=1.5,
                                mat_albedo_color=(0.1, 0.2, 0.3))
    save_preset(str(tmp_path / "p.json"), p)
    assert load_preset(str(tmp_path / "p.json")) == p


# -- tests/test_viewer.py, for the port's viewer --

@pytest.fixture
def served():
    """A viewer on a 24x32 CPU app with its render loop and server
    running; yields (viewer state, get(path) -> bytes, app)."""
    app = small_app()
    vs = ViewerState(app)
    loop = threading.Thread(target=vs.loop, args=(60.0,), daemon=True)
    loop.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(vs))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def get(path):
        return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=10).read()
    try:
        deadline = time.time() + 60
        while not vs.png and time.time() < deadline:
            time.sleep(0.05)
        assert vs.png, "no frame rendered"
        yield vs, get, app
    finally:
        vs.running = False
        server.shutdown()
        server.server_close()
        loop.join(timeout=30)
        assert not loop.is_alive()


def test_viewer_serves_frames_and_actions(served, tmp_path):
    vs, get, app = served
    p = tmp_path / "f.png"
    p.write_bytes(get("/frame.png"))
    assert read_png(str(p)).shape == (H, W, 3)
    state = json.loads(get("/state"))
    assert state["ray_mode"] is True and state["device"] == "cpu"
    assert state["failed_frames"] == 0 and state["frames_encoded"] >= 1
    x0 = state["camera"]
    assert json.loads(get("/act?name=move_w"))["ok"]
    assert json.loads(get("/act?name=toggle_ray_mode"))["ok"]
    get("/set?exposure=2.0")
    deadline = time.time() + 30
    while json.loads(get("/state"))["ray_mode"] and time.time() < deadline:
        time.sleep(0.05)
    state = json.loads(get("/state"))
    assert state["ray_mode"] is False and state["exposure"] == 2.0
    assert state["camera"] != x0


def test_viewer_panel_endpoints(served):
    vs, get, app = served
    page = get("/").decode()
    for marker in ("pick_model", "pick_env", "conlog", "requestPointerLock",
                   "wheel", "keymap"):
        assert marker in page, marker
    schema = json.loads(get("/schema"))
    assert [s[0] for s in schema] == [s[0] for s in PANEL_SCHEMA]
    for _, fields in schema:
        for name, *_ in fields:
            assert hasattr(app.app.params, name), name
    state = json.loads(get("/state"))
    assert "spp_per_frame" in state["params"]
    assert len(state["model_entries"]) == 10
    yaw0, fov0 = app.app.camera.yaw, app.app.camera.fov
    assert json.loads(get("/act?name=look%2012%200"))["ok"]
    assert json.loads(get("/act?name=zoom%201"))["ok"]
    assert app.app.camera.yaw != yaw0 and app.app.camera.fov != fov0
    assert not json.loads(get("/act?name=fly"))["ok"]
    get("/set?exposure=99")
    assert app.app.params.exposure == 8.0
    get("/set?exposure=0.001")
    assert app.app.params.exposure == 0.05
    get("/set?sun_color=2,-1,0.5")
    assert app.app.params.sun_color == (1.0, 0.0, 0.5)
    get("/set?exposure=4.0")
    assert app.input.exposure == 4.0
    get("/set?spp_per_frame=8")
    assert app.input.spp_per_frame == 8
    assert not json.loads(get("/set?notafield=1"))["ok"]
    r = json.loads(get("/resize?size=40x20"))
    assert r["ok"] and (app.app.height, app.app.width) == (20, 40)
    assert not json.loads(get("/resize?size=junk"))["ok"]
    r = json.loads(get("/pick?kind=model&index=0"))
    assert r["ok"] and r["requested"] == 0
    assert not json.loads(get("/pick?kind=nope&index=0"))["ok"]
    log("GUI", "port viewer marker %d", 42)
    out = json.loads(get("/log?n=50&filter=port%20viewer%20marker"))
    assert out["lines"] == ["[GUI] port viewer marker 42"]


def test_viewer_counts_failed_frames(served):
    """A step that raises is counted, logged and shown in /state; the last
    good frame keeps serving and the loop goes on."""
    vs, get, app = served
    real, calls = app.step, []

    def failing_once():
        if not calls:
            calls.append(1)
            raise RuntimeError("injected frame failure")
        return real()
    with vs.lock:
        app.step = failing_once
    deadline = time.time() + 30
    while json.loads(get("/state"))["failed_frames"] < 1 \
            and time.time() < deadline:
        time.sleep(0.05)
    n = vs.frames_encoded
    while vs.frames_encoded < n + 2 and time.time() < deadline:
        time.sleep(0.05)
    state = json.loads(get("/state"))
    assert state["failed_frames"] == 1 and vs.frames_encoded >= n + 2
    lines = json.loads(get("/log?n=400&filter=injected"))["lines"]
    assert lines and "frame failed (1 so far)" in lines[-1]


def test_viewer_quit_and_jpeg_stream(tmp_path):
    app = small_app()
    vs = ViewerState(app, stream_format="jpeg", jpeg_quality=90)
    assert app.want_u8
    loop = threading.Thread(target=vs.loop, args=(60.0,), daemon=True)
    loop.start()
    deadline = time.time() + 60
    while not vs.png and time.time() < deadline:
        time.sleep(0.05)
    p = tmp_path / "f.jpg"
    p.write_bytes(vs.png)
    assert read_jpeg(str(p)).shape == (H, W, 3)
    app.act("quit")
    loop.join(timeout=30)
    assert not loop.is_alive() and not vs.running
    assert vs.failed_frames == 0


def test_page_keymap_covers_hotkey_surface():
    import re
    m = re.search(r"const keymap=\{(.*?)\};", _PAGE, re.S)
    mapped = set(re.findall(r":'([a-z_0-9]+)'", m.group(1)))
    assert {a for a in ACTIONS.values() if a != "quit"} <= mapped
    from opengl_raytracing_tpu.app import viewer as jviewer
    assert _PAGE == jviewer._PAGE and PANEL_SCHEMA == jviewer.PANEL_SCHEMA
