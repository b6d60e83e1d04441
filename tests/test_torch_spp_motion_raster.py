"""The rest of the port's `render_frame` against the JAX package: more
than one sample a pixel, the motion debug view, the raster preview, and
the goldens that need them or a cubemap environment.

* `heavy` (4 SPP, GI, AO, TAA, SVGF) on the analytic scene, three chained
  frames against JAX `render_frame`: image and motion 1e-4, accumulation
  1e-3 relative (the tolerance of tests/test_torch_full.py's analytic
  chain; JAX sums its samples with `jnp.sum`, the port adds them left to
  right on the host, so the mean may round apart in the last bit).  The
  samples' seeds and the AO hoist are checked on the calls themselves;
* `hsv2rgb`, `visualize_motion` and `present(show_motion=True)` against
  JAX: 1e-5 (atan2 and the wrapped hue; both texel conventions);
* `render_raster` against JAX `render_raster`: equal but on lanes where
  two surfaces tie within 1e-4 of t (flat colours: a tie flips a pixel
  whole), with and without the mesh;
* the goldens `env_cubemap`, `heavy_4spp_frame3`, `motion_debug` and
  `raster_parity` at the thresholds of tests/test_golden.py.
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import RenderState as JRenderState
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models import render_frame as jrender_frame
from opengl_raytracing_tpu.models.raster import render_raster as jraster
from opengl_raytracing_tpu.ops import svgf as jsvgf
from opengl_raytracing_tpu.ops import tonemap as jtone
from opengl_raytracing_tpu.ops.cubemap import dummy_cubemap as jdummy
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.sampling import generate_jitter2d
from opengl_raytracing_tpu.utils.image import read_png

from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 env_from_numpy,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (RenderState, make_render_fn,
                                                preset, render_raster)
from opengl_raytracing_tpu_torch.models import pipeline as tpipe
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import svgf as tsvgf
from opengl_raytracing_tpu_torch.ops import tonemap as ttone
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.sampling import frame_value
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

torch.set_num_threads(2)

H, W = 48, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _jfin(cam, jitter=(0.0, 0.0), prev_vp=None, moved=0):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.asarray(jitter, jnp.float32),
        curr_view_proj=jnp.asarray(vp),
        prev_view_proj=jnp.asarray(vp if prev_vp is None else prev_vp),
        camera_moved=jnp.int32(moved))


@pytest.fixture(scope="module")
def tris():
    return gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))


# ---- SPP > 1 ----

@pytest.fixture(scope="module")
def heavy_chain():
    """Three chained `heavy` frames of the analytic scene on both sides,
    the second after a camera move."""
    jparams = jpreset("heavy").replace(enable_env_map=0)
    params = params_from(jparams)
    cam = JCamera()
    cam.aspect = W / H
    jrender = jax.jit(functools.partial(jrender_frame, height=H, width=W,
                                        use_bvh=False))
    render = make_render_fn(H, W, "cpu")
    jstate, state = JRenderState.create(H, W), RenderState.create(H, W, "cpu")
    scale = float(jparams.jitter_still_scale)
    prev_vp = cam.view_projection()
    frames = []
    for i in range(3):
        if i == 1:
            cam.position = cam.position + np.float32([0.05, 0.02, 0.0])
        jfin = _jfin(cam, generate_jitter2d(i) * scale, prev_vp, int(i == 1))
        prev_vp = cam.view_projection()
        jstate, jout = jrender(jparams, jfin, jstate, None, None)
        state, out = render(params, frame_inputs_from_numpy(jfin, "cpu"),
                            state)
        frames.append(dict(jout=jax.device_get(jout), out=out,
                           jaccum=np.asarray(jstate.accum),
                           accum=state.accum.clone()))
    return frames


@pytest.mark.parametrize("i", [0, 1, 2])
def test_heavy_chain_matches_jax(heavy_chain, i):
    f = heavy_chain[i]
    for name in ("image", "motion"):
        np.testing.assert_allclose(getattr(f["out"], name).numpy(),
                                   np.asarray(getattr(f["jout"], name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(f["accum"].numpy(), f["jaccum"], rtol=1e-3,
                               atol=1e-4)
    img = f["out"].image.numpy()
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    assert img.std() > 0.02


@pytest.mark.parametrize("use_bvh", [False, True])
@pytest.mark.parametrize("show_motion", [False, True])
def test_samples_seeds_and_ao_hoist(tris, monkeypatch, use_bvh, show_motion):
    """With 3 samples a pixel at frame 5, the samples shade as one batch:
    the direct light of the primary hits runs once over [3, H, W] with the
    seeds 15, 16, 17 (one sampled value) and the frame index 5, AO once
    for all of them, and the frame is the samples' mean; the motion view
    shades one sample with seed 5."""
    params = preset("full").replace(spp_per_frame=3, enable_env_map=0)
    h, w = 12, 16
    bvh = prepare_bvh(tris, "cpu") if use_bvh else None
    cam = JCamera()
    cam.aspect = w / h
    if use_bvh:
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))
    fin = frame_inputs_from_numpy(_jfin(cam), "cpu")
    seeds, ao_calls, shaded = [], [], []
    name = "direct_light_bvh" if use_bvh else "direct_light"
    real_direct, real_ao = getattr(tlt, name), tlt.compute_ao

    def direct(scene, hit, rng_frame, frame_index, *a, **kw):
        # the frame's seeds are device frame values: their int32 values
        seeds.append((frame_value(rng_frame).reshape(-1).tolist(),
                      int(frame_value(frame_index)), tuple(hit.t.shape)))
        return real_direct(scene, hit, rng_frame, frame_index, *a, **kw)

    def ao(*a, **kw):
        ao_calls.append(1)
        return real_ao(*a, **kw)
    monkeypatch.setattr(tlt, name, direct)
    monkeypatch.setattr(tlt, "compute_ao", ao)
    shade_name = "_shade_bvh" if use_bvh else "_shade_analytic"
    real_shade = getattr(tpipe, shade_name)

    def shade(*a, **kw):
        shaded.append(real_shade(*a, **kw))
        return shaded[-1]
    monkeypatch.setattr(tpipe, shade_name, shade)
    state = RenderState(torch.zeros(h, w, 4), 5)
    state, out = tpipe.render_frame(params, fin, state, None, bvh, height=h,
                                    width=w, use_bvh=use_bvh,
                                    show_motion=show_motion)
    spp = 1 if show_motion else 3
    # the primary hits' call comes first; GI, the mirror and the glass make
    # their own calls after it, each over the whole batch
    batch = (spp, h, w) if spp > 1 else (h, w)
    assert seeds[0] == ([5 * spp + k for k in range(spp)], 5, batch)
    assert all(shape == batch for _, _, shape in seeds)
    assert len(ao_calls) == 1 and len(shaded) == 1
    assert state.frame_index == 6
    if show_motion:
        np.testing.assert_array_equal(out.image.numpy(), 0.0)  # no motion
        return
    shaded = shaded[0]
    assert shaded.shape == (spp, h, w, 3)
    hit = out.gnrm.abs().sum(-1) > 0
    mean = (shaded[0] + shaded[1] + shaded[2]) / 3.0
    # frame 5 blends the mean with an empty history by TAA's still weight
    want = mean * (1.0 - float(np.float32(params.taa_history_min_weight)))
    np.testing.assert_allclose(state.accum[..., :3][hit].numpy(),
                               want[hit].numpy(), rtol=1e-5, atol=1e-6)
    assert float((shaded[0] - shaded[1]).abs().max()) > 1e-3  # other noise


# ---- the motion view ----

def test_hsv2rgb_and_visualize_motion_match_jax():
    rng = np.random.RandomState(0)
    hue = rng.uniform(-2.0, 2.0, (40, 30)).astype(np.float32)
    sat = rng.rand(40, 30).astype(np.float32)
    val = rng.rand(40, 30).astype(np.float32)
    np.testing.assert_allclose(
        ttone.hsv2rgb(_t(hue), _t(sat), _t(val)).numpy(),
        np.asarray(jtone.hsv2rgb(jnp.asarray(hue), jnp.asarray(sat),
                                 jnp.asarray(val))), rtol=0, atol=1e-5)
    motion = (rng.randn(40, 30, 2) * 0.1).astype(np.float32)
    motion[:5] = 0.0           # the deadband
    motion[5:8] = 1e-5         # inside it after the scale
    motion[8:10, :, 1] = 0.0   # atan2 on the axis, both signs of x
    motion[10:12] = 4.0        # the sky sentinel of a moved camera
    got = ttone.visualize_motion(_t(motion), 4.0).numpy()
    want = np.asarray(jtone.visualize_motion(jnp.asarray(motion),
                                             jnp.float32(4.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:8], 0.0)
    assert got[8:].std() > 0.1 and got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("half_texel", ["0", "1"])
@pytest.mark.parametrize("svgf", [0, 1])
def test_present_motion_view_matches_jax(monkeypatch, half_texel, svgf):
    """The motion wheel replaces the image whatever SVGF is, after the
    texel shift."""
    monkeypatch.setenv("ORT_PRESENT_HALF_TEXEL", half_texel)
    rng = np.random.RandomState(1)
    accum = rng.rand(24, 32, 4).astype(np.float32)
    motion = (rng.randn(24, 32, 2) * 0.05).astype(np.float32)
    g = rng.randn(24, 32, 3).astype(np.float32)
    jparams = jpreset("full").replace(enable_svgf=svgf, motion_scale=6.0)
    got = tsvgf.present(_t(accum), _t(motion), _t(g), _t(g),
                        params_from(jparams), show_motion=True).numpy()
    want = np.asarray(jsvgf.present(jnp.asarray(accum), jnp.asarray(motion),
                                    jnp.asarray(g), jnp.asarray(g), jparams,
                                    show_motion=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = ttone.visualize_motion(_t(motion), 6.0).numpy()
    if half_texel == "1":
        np.testing.assert_array_equal(got[:-1, :-1], plain[1:, 1:])
    else:
        np.testing.assert_array_equal(got, plain)


# ---- the raster preview ----

@pytest.mark.parametrize("mesh", [True, False])
@pytest.mark.parametrize("point_light", [1, 0])
def test_render_raster_matches_jax(tris, mesh, point_light):
    jparams = jpreset("baseline").replace(
        point_light_enabled=point_light, point_light_orbit_enabled=1,
        point_light_orbit_radius=1.2, point_light_yaw=30.0,
        point_light_color=(0.2, 0.3, 0.1))
    params = params_from(jparams)
    h, w = 72, 96
    cam = JCamera()
    cam.aspect = w / h
    jfin = _jfin(cam, jitter=(0.3, -0.2))  # ignored: the pass is unjittered
    jbvh = jprepare_bvh(tris) if mesh else None
    bvh = None if jbvh is None else bvh_from_numpy(
        BVHArrays(*(np.asarray(x) for x in jbvh.arrays)), "cpu")
    want = np.asarray(jraster(jparams, jfin, jbvh, height=h, width=w))
    got = render_raster(params, frame_inputs_from_numpy(jfin, "cpu"), bvh,
                        height=h, width=w).numpy()
    assert got.shape == (h, w, 3)
    differ = (got != want).any(-1)
    assert differ.mean() <= 2e-3  # tie lanes at a silhouette, if any
    colours = {tuple(c) for c in np.unique(got.reshape(-1, 3), axis=0)}
    assert len(colours) == 3 + int(mesh) + point_light
    if point_light:  # pointLightColor * 3, clipped to [0, 1]
        assert tuple(np.float32([0.2, 0.3, 0.1]) * np.float32(3.0)) in colours
    unjittered = render_raster(
        params, frame_inputs_from_numpy(_jfin(cam), "cpu"), bvh, height=h,
        width=w).numpy()
    np.testing.assert_array_equal(got, unjittered)


# ---- goldens ----

def _golden_tools():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from scripts.make_goldens import _moving_camera_inputs, golden_configs
    from tests.test_pipeline import make_inputs
    return golden_configs(), _moving_camera_inputs, make_inputs


@pytest.mark.parametrize("name", ["env_cubemap", "heavy_4spp_frame3",
                                  "motion_debug", "raster_parity"])
def test_rest_goldens(name):
    configs, moving_inputs, make_inputs = _golden_tools()
    cfg = dict(configs[name])
    height, width = cfg.pop("height", H), cfg.pop("width", W)
    n_frames = cfg.pop("frames", 1)
    show_motion = cfg.pop("show_motion", False)
    fins = (moving_inputs(width, height, n_frames) if cfg.pop("motion", False)
            else [make_inputs()] * n_frames)
    env = None
    if cfg.pop("env", False):
        # make_goldens' procedural environment
        rng = np.random.RandomState(0)
        env = env_from_numpy(np.asarray(jdummy(8)) * (
            0.5 + 0.5 * rng.rand(6, 8, 8, 3).astype(np.float32)), "cpu")
    raster = cfg.pop("raster", False)
    params = preset(cfg.pop("preset"))
    assert not cfg
    if raster:
        img = render_raster(params, frame_inputs_from_numpy(fins[0], "cpu"),
                            None, height=height, width=width)
    else:
        render = make_render_fn(height, width, "cpu",
                                show_motion=show_motion)
        state = RenderState.create(height, width, "cpu")
        for fin in fins:
            state, out = render(params, frame_inputs_from_numpy(fin, "cpu"),
                                state, env)
        img = out.image
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))[::-1].astype(
        np.float32) / 255.0
    diff = np.abs(img.numpy() - want)
    assert diff.max() < 0.05, f"max diff {diff.max():.4f}"
    assert np.quantile(diff, 0.999) < 0.02
