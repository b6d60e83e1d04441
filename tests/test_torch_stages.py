"""What the port's `render_frame` once refused, against the JAX package's
`render_frame`: SPP > 1, the cubemap environment and the motion view, on
both scenes and under every preset.

Eight parameter sets render two chained frames each, the second after a
camera move, on both sides from the same parameters, frame inputs, tree
and environment (`convert` carries them over; the JAX side runs its CPU
path).  Tolerances: image and motion 1e-4; the accumulation 1e-4 on the
BVH scene and 1e-3 relative on the analytic scene (its HDR highlights and
M2 channel, as tests/test_torch_analytic.py holds it).
"""

import functools

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

from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 env_from_numpy,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import RenderState, make_render_fn
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tris():
    return gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))


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


@pytest.mark.parametrize("change", [
    dict(use_bvh=False, spp_per_frame=2), dict(preset="heavy"),
    dict(preset="full", env_map=True), dict(preset="full", show_motion=True),
    dict(use_bvh=False, env_map=True), dict(spp_per_frame=2),
    dict(env_map=True), dict(show_motion=True)])
def test_every_stage_renders_and_matches_jax(tris, change):
    """One parameter set: two chained frames on both sides."""
    change = dict(change)
    use_bvh = change.pop("use_bvh", True)
    show_motion = change.pop("show_motion", False)
    env = None
    if change.pop("env_map", False):
        env = (np.random.RandomState(4).rand(6, 4, 4, 3) * 1.5).astype(
            np.float32)
    jparams = jpreset(change.pop("preset", "baseline")).replace(**change)
    params = params_from(jparams)
    h, w = 24, 32
    cam = JCamera()
    cam.aspect = w / h
    jbvh = bvh = None
    if use_bvh:
        jbvh = jprepare_bvh(tris)
        bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x)
                                         for x in jbvh.arrays)), "cpu")
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))
    jrender = jax.jit(functools.partial(jrender_frame, height=h, width=w,
                                        use_bvh=use_bvh,
                                        show_motion=show_motion))
    render = make_render_fn(h, w, "cpu", use_bvh=use_bvh,
                            show_motion=show_motion)
    jstate, state = JRenderState.create(h, w), RenderState.create(h, w, "cpu")
    jenv = None if env is None else jnp.asarray(env)
    tenv = None if env is None else env_from_numpy(env, "cpu")
    prev_vp = cam.view_projection()
    for i in range(2):
        if i:
            cam.position = cam.position + np.float32([0.05, 0.02, 0.0])
        jfin = _jfin(cam, generate_jitter2d(i) * 0.25, prev_vp, i)
        jstate, jout = jrender(jparams, jfin, jstate, jenv, jbvh)
        state, out = render(params, frame_inputs_from_numpy(jfin, "cpu"),
                            state, tenv, bvh)
        img = out.image.numpy()
        assert img.shape == (h, w, 3) and np.isfinite(img).all()
        np.testing.assert_allclose(img, np.asarray(jout.image), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(out.motion.numpy(),
                                   np.asarray(jout.motion), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(state.accum.numpy(),
                                   np.asarray(jstate.accum),
                                   rtol=1e-4 if use_bvh else 1e-3, atol=1e-4)
    assert img.std() > 0.02
