"""The port's frame function against the JAX package's `render_frame`.

Both render the bunny BVH scene with the `baseline` preset from the same
parameters, frame inputs and tree (`convert` carries them over).  The
JAX side runs its CPU path (the jnp walker), the port its plain walks.

Tolerances: image, accumulation, motion, gpos and gnrm agree within 1e-4
over a 3-frame chain with jitter and one moved-camera frame (float32
rounding of pow/cos/sin and of sums in another order; the hit masks are
equal).  The port's frame also meets the goldens `bvh_baseline` and
`bvh_baseline_large` at the thresholds of tests/test_golden.py.  The
parameter sets `render_frame` once refused (SPP > 1, a cubemap
environment, the motion view) are held to JAX in
tests/test_torch_stages.py.
"""

import functools
import os

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

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 camera_frame_inputs,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (RenderState, make_render_fn,
                                                preset, render_frame)
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

torch.set_num_threads(2)

H, W = 48, 64
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def tris():
    return gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))


def _jfin(cam, jitter, prev_vp=None, moved=0):
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


def test_render_frame_matches_jax(tris):
    jbvh = jprepare_bvh(tris)
    bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x) for x in jbvh.arrays)),
                         "cpu")
    jparams = jpreset("baseline")
    params = params_from(jparams)
    cam = JCamera()
    cam.aspect = W / H
    cam.fov = 12.0  # the bunny fills about a third of the frame
    cam.point_at((-2.0, 1.5, 0.0))
    scale = float(jparams.jitter_still_scale)
    prev_vp = cam.view_projection()
    jrender = jax.jit(functools.partial(jrender_frame, height=H, width=W,
                                        use_bvh=True))
    jstate = JRenderState.create(H, W)
    state = RenderState.create(H, W, "cpu")
    for i in range(3):
        moved = int(i == 1)
        if moved:
            cam.position = cam.position + np.float32([0.05, 0.02, 0.0])
        jfin = _jfin(cam, generate_jitter2d(i) * scale, prev_vp, moved)
        prev_vp = cam.view_projection()
        jstate, jout = jrender(jparams, jfin, jstate, None, jbvh)
        state, out = render_frame(params, frame_inputs_from_numpy(jfin, "cpu"),
                                  state, None, bvh, height=H, width=W,
                                  use_bvh=True)
        assert state.frame_index == int(jstate.frame_index) == i + 1
        hit = np.abs(np.asarray(jout.gnrm)).sum(-1) > 0
        assert 0.2 < hit.mean() < 0.9
        np.testing.assert_array_equal(out.gnrm.abs().sum(-1).numpy() > 0, hit)
        for name in ("image", "motion", "gpos", "gnrm"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(state.accum.numpy(),
                                   np.asarray(jstate.accum), rtol=1e-4,
                                   atol=1e-4)
        sky = ~hit
        if moved:
            np.testing.assert_array_equal(out.motion.numpy()[sky], 4.0)
            assert np.abs(out.motion.numpy()[hit]).max() > 1e-4
        else:
            np.testing.assert_array_equal(out.motion.numpy()[sky], 0.0)


@pytest.mark.parametrize("name", ["bvh_baseline", "bvh_baseline_large"])
def test_goldens(tris, name):
    height, width = (H, W) if name == "bvh_baseline" else (144, 192)
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))[::-1].astype(
        np.float32) / 255.0
    cam = Camera()
    cam.aspect = width / height
    render = make_render_fn(height, width, "cpu", use_bvh=True)
    state = RenderState.create(height, width, "cpu")
    _, out = render(preset("baseline"), camera_frame_inputs(cam, "cpu"),
                    state, None, prepare_bvh(tris, "cpu"))
    diff = np.abs(out.image.numpy() - want)
    assert diff.max() < 0.05, f"max diff {diff.max():.4f}"
    assert np.quantile(diff, 0.999) < 0.02


def test_accumulation_is_updated_in_place(tris):
    state = RenderState.create(H, W, "cpu")
    ptr = state.accum.data_ptr()
    fin = camera_frame_inputs(Camera(aspect=W / H), "cpu")
    st, out = render_frame(preset("baseline"), fin, state, None,
                           prepare_bvh(tris, "cpu"), height=H, width=W,
                           use_bvh=True)
    assert st.accum.data_ptr() == ptr and st.frame_index == 1
    assert st.accum.shape == (H, W, 4)
    img = out.image.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    reset = st.reset()
    assert reset.frame_index == 0 and not reset.accum.any()
