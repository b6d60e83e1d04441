"""The BVH-heavy scene (bench.py's `measure_closefar`) through the port's
`render_frame` against the JAX package's, at test size.

`make_bunny(6)`: 81,920 triangles and 32,767 nodes, placed by the
default `model_transform`; the `baseline` preset; the close camera at
(-2.0, 1.6, 1.2) and the far one at (0.0, 2.0, 8.0), both looking at
(-2.0, 1.5, 0.0) (`bench.py:67-75`); two chained still frames with the
bench's jittered camera, at 48x64.  Each package builds its own tree
(`prepare_bvh`: the g++ builder in both), so this also holds that the
trees agree.  The JAX side runs its CPU path (the jnp walker), the port
its plain walks.

Tolerance: image, accumulation, motion, gpos and gnrm within rtol 1e-4 /
atol 1e-4 (tests/test_torch_pipeline.py's: float32 rounding of pow, cos
and sin and of sums in another order); the hit masks equal.
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

from opengl_raytracing_tpu_torch.constants import (DEFAULT_BVH_SCALE,
                                                   DEFAULT_BVH_TRANSLATE)
from opengl_raytracing_tpu_torch.convert import (frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import RenderState, render_frame
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

torch.set_num_threads(2)

H, W = 48, 64
FRAMES = 2
TOL = dict(rtol=1e-4, atol=1e-4)
HEAVY_SUBDIV = 6
CAMERAS = {"close": (-2.0, 1.6, 1.2), "far": (0.0, 2.0, 8.0)}
LOOK_AT = (-2.0, 1.5, 0.0)


@pytest.fixture(scope="module")
def scene():
    tris = gather_triangles(make_bunny(HEAVY_SUBDIV),
                            model_transform(DEFAULT_BVH_TRANSLATE,
                                            DEFAULT_BVH_SCALE))
    jrender = jax.jit(functools.partial(jrender_frame, height=H, width=W,
                                        use_bvh=True))
    return tris, jprepare_bvh(tris), prepare_bvh(tris, "cpu"), jrender


def _jfin(cam, jitter):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.asarray(jitter, jnp.float32),
        curr_view_proj=jnp.asarray(vp), prev_view_proj=jnp.asarray(vp),
        camera_moved=jnp.int32(0))


def test_scene_size(scene):
    tris, jbvh, bvh, _ = scene
    assert tris.shape == (81920, 9)
    assert bvh.arrays.bounds.shape == (32767, 8)
    for got, want in zip(bvh.arrays, jbvh.arrays):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_closefar_frames_match_jax(scene, camera):
    tris, jbvh, bvh, jrender = scene
    jparams = jpreset("baseline")
    params = params_from(jparams)
    cam = JCamera(position=np.asarray(CAMERAS[camera], np.float32))
    cam.aspect = W / H
    cam.point_at(LOOK_AT)
    scale = float(jparams.jitter_still_scale)
    jstate = JRenderState.create(H, W)
    state = RenderState.create(H, W, "cpu")
    for i in range(FRAMES):
        jfin = _jfin(cam, generate_jitter2d(i) * scale)
        jstate, jout = jrender(jparams, jfin, jstate, None, jbvh)
        state, out = render_frame(params, frame_inputs_from_numpy(jfin, "cpu"),
                                  state, None, bvh, height=H, width=W,
                                  use_bvh=True)
        hit = np.abs(np.asarray(jout.gnrm)).sum(-1) > 0
        np.testing.assert_array_equal(out.gnrm.abs().sum(-1).numpy() > 0, hit)
        # the close camera fills most of the frame with the mesh, the far
        # one a few pixels (bench.py's two ends of the walk's length)
        if camera == "close":
            assert hit.mean() > 0.3
        else:
            assert 0 < hit.sum() < 0.05 * H * W
        for name in ("image", "motion", "gpos", "gnrm"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       err_msg=f"frame {i} {name}", **TOL)
        np.testing.assert_allclose(state.accum.numpy(),
                                   np.asarray(jstate.accum),
                                   err_msg=f"frame {i} accum", **TOL)
