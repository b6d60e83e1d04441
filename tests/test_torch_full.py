"""The port's `full` preset (GI, AO, TAA, SVGF at 1 SPP) against the JAX
package's `render_frame`, on both scenes.

Each JAX chain is rendered once per module.  Both sides get the same
parameters, frame inputs and tree (`convert` carries them over); the JAX
side runs its CPU path (the jnp walker, the jnp SVGF stencil), the port
its plain walks and plain versions.  Each chain has three frames: a
still one, one after a camera move (TAA reprojects), and one whose camera
did not move but whose previous view-projection is stale, so its traced
motion is not zero and TAA must zero it (a repair of the port).

Tolerances: the BVH chain's image, accumulation and gbuffer within 1e-4;
the analytic chain as tests/test_torch_analytic.py holds the baseline
frame (image 1e-4; gbuffer 1e-4, 2e-3 on the marker sphere and grazing
lanes; accumulation 1e-3 relative).  The goldens `bvh_full`,
`analytic_full`, `analytic_no_env_gradient_sky`, `analytic_full_large`
and `taa_motion_seq` at the thresholds of tests/test_golden.py.
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
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.sampling import generate_jitter2d
from opengl_raytracing_tpu.utils.image import read_png

from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (PRESETS, RenderState,
                                                make_render_fn, preset)
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

torch.set_num_threads(2)

H, W = 48, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _jfin(cam, jitter, prev_vp, moved):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.asarray(jitter, jnp.float32),
        curr_view_proj=jnp.asarray(vp), prev_view_proj=jnp.asarray(prev_vp),
        camera_moved=jnp.int32(moved))


def _chain(use_bvh):
    """Three chained `full` frames of both packages: the JAX frames and
    the port's (its FrameOutputs and accumulation after each frame)."""
    jparams = jpreset("full").replace(enable_env_map=0)
    params = params_from(jparams)
    cam = JCamera()
    cam.aspect = W / H
    jbvh = bvh = None
    if use_bvh:
        tris = gather_triangles(make_bunny(2),
                                model_transform((-2.0, 1.5, 0.0), 0.5))
        jbvh = jprepare_bvh(tris)
        bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x)
                                         for x in jbvh.arrays)), "cpu")
        cam.fov = 12.0  # the bunny fills about a third of the frame
        cam.point_at((-2.0, 1.5, 0.0))
    jrender = jax.jit(functools.partial(jrender_frame, height=H, width=W,
                                        use_bvh=use_bvh))
    render = make_render_fn(H, W, "cpu", use_bvh=use_bvh)
    jstate = JRenderState.create(H, W)
    state = RenderState.create(H, W, "cpu")
    scale = float(jparams.jitter_still_scale)
    frames = []
    vp0 = cam.view_projection()
    for i in range(3):
        if i == 1:  # the camera moves
            cam.position = cam.position + np.float32([0.05, 0.02, 0.0])
        # frame 1 reprojects from vp0; frame 2 keeps vp0 as a stale
        # previous view-projection while its camera stands still
        jfin = _jfin(cam, generate_jitter2d(i) * scale,
                     vp0, int(i == 1))
        jstate, jout = jrender(jparams, jfin, jstate, None, jbvh)
        state, out = render(params, frame_inputs_from_numpy(jfin, "cpu"),
                            state, None, bvh)
        assert state.frame_index == int(jstate.frame_index) == i + 1
        frames.append(dict(jfin=jfin, jout=jax.device_get(jout),
                           jaccum=np.asarray(jstate.accum), out=out,
                           accum=state.accum.clone()))
    return dict(frames=frames, jparams=jparams)


@pytest.fixture(scope="module")
def bvh_chain():
    return _chain(True)


@pytest.fixture(scope="module")
def an_chain():
    return _chain(False)


def _check_frame(f, hit):
    """The image is finite, in [0,1], and the frame shows sky and surface;
    the accumulation is finite."""
    img = f["out"].image.numpy()
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    assert np.isfinite(f["accum"].numpy()).all()
    assert 0.05 < hit.mean() < 0.95  # sky in view


@pytest.mark.parametrize("i", [0, 1, 2])
def test_bvh_full_chain_matches_jax(bvh_chain, i):
    f = bvh_chain["frames"][i]
    out, jout = f["out"], f["jout"]
    hit = np.abs(np.asarray(jout.gnrm)).sum(-1) > 0
    np.testing.assert_array_equal(out.gnrm.abs().sum(-1).numpy() > 0, hit)
    _check_frame(f, hit)
    for name in ("image", "motion", "gpos", "gnrm"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(f["accum"].numpy(), f["jaccum"], rtol=1e-4,
                               atol=1e-4)
    motion = out.motion.numpy()
    if i == 2:  # traced motion not zero, though TAA saw none
        assert np.abs(motion[hit]).max() > 1e-3


def _loose_lanes(f, jparams):
    """The analytic gbuffer lanes held to 2e-3 (see
    tests/test_torch_analytic.py): the marker sphere and grazing lanes."""
    jpos, jnrm = np.asarray(f["jout"].gpos), np.asarray(f["jout"].gnrm)
    view = jpos - np.asarray(f["jfin"].cam_pos)
    view /= np.linalg.norm(view, axis=-1, keepdims=True) + 1e-30
    hit = np.abs(jnrm).sum(-1) > 0
    loose = hit & ((np.abs((view * jnrm).sum(-1)) < 0.1)
                   | (np.linalg.norm(jpos - np.float32(
                       jparams.point_light_pos), axis=-1) < 0.16))
    assert loose.mean() < 0.15
    return hit, loose


@pytest.mark.parametrize("i", [0, 1, 2])
def test_analytic_full_chain_matches_jax(an_chain, i):
    f = an_chain["frames"][i]
    out, jout = f["out"], f["jout"]
    hit, loose = _loose_lanes(f, an_chain["jparams"])
    _check_frame(f, hit)
    for name in ("image", "motion"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name in ("gpos", "gnrm"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(jout,
                                                                   name))
        np.testing.assert_allclose(got[~loose], want[~loose], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got[loose], want[loose], rtol=0,
                                   atol=2e-3, err_msg=name)
    np.testing.assert_allclose(f["accum"].numpy(), f["jaccum"], rtol=1e-3,
                               atol=1e-4)
    assert out.image.numpy().std() > 0.02


def _golden_tools():
    """make_goldens' configs and camera sequences, and test_pipeline's
    still-camera inputs (the JAX FrameInputs the goldens were made from)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from scripts.make_goldens import _moving_camera_inputs, golden_configs
    from tests.test_pipeline import make_inputs
    return golden_configs(), _moving_camera_inputs, make_inputs


@pytest.mark.parametrize("name", ["bvh_full", "analytic_full",
                                  "analytic_no_env_gradient_sky",
                                  "analytic_full_large", "taa_motion_seq"])
def test_full_goldens(name):
    configs, moving_inputs, make_inputs = _golden_tools()
    cfg = dict(configs[name])
    height, width = cfg.pop("height", H), cfg.pop("width", W)
    n_frames = cfg.pop("frames", 1)
    use_bvh = cfg.pop("scene", None) == "bvh"
    fins = (moving_inputs(width, height, n_frames) if cfg.pop("motion", False)
            else [make_inputs()] * n_frames)
    params = preset(cfg.pop("preset"))
    if cfg:
        params = params.replace(**cfg)
    bvh = None
    if use_bvh:
        from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
        bvh = prepare_bvh(gather_triangles(
            make_bunny(2), model_transform((-2, 1.5, 0), 0.5)), "cpu")
    render = make_render_fn(height, width, "cpu", use_bvh=use_bvh)
    state = RenderState.create(height, width, "cpu")
    for fin in fins:
        state, out = render(params, frame_inputs_from_numpy(fin, "cpu"),
                            state, None, bvh)
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))[::-1].astype(
        np.float32) / 255.0
    diff = np.abs(out.image.numpy() - want)
    assert diff.max() < 0.05, f"max diff {diff.max():.4f}"
    assert np.quantile(diff, 0.999) < 0.02


def test_presets_convert_equal():
    """Every preset of both packages gives equal parameters through
    convert.params_from, `full` included."""
    assert "full" in PRESETS
    for name in PRESETS:
        assert params_from(jpreset(name)) == preset(name), name
    full = preset("full")
    assert (full.enable_gi, full.enable_ao, full.enable_taa,
            full.enable_svgf, full.spp_per_frame) == (1, 1, 1, 1, 1)
