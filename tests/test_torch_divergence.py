"""The analytic baseline frame at 300x400, the size and camera at which
the card's frame and the port's CPU frame were seen to differ on a few
values (up to 4.45e-3): the port against the JAX package on the CPU.

The port runs one float32 operation a step.  JAX evaluated the same way
(op by op, `jax.disable_jit`) agrees with it on every value within 1e-4.
The jitted JAX frame does not agree with either: XLA fuses the sphere
root's `b*b - c2` (a cancellation that keeps few bits on the far spheres),
which moves a hit by ~1e-4; on a mirror lane seen at a grazing angle the
reflected ray then lands elsewhere and the pixel changes whole.  So the
lanes that move are sphere lanes, the side that moves is the fused
evaluation, and the port follows the unfused one: no fault of the port.
Tolerances: 1e-4 on every value against the unfused frame; against the
jitted frame at most 1e-3 of the values over 1e-4, all of them on sphere
lanes, and the unfused JAX frame differs from the jitted one wherever the
port clearly does (over 2e-4).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import RenderState as JRenderState
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models import render_frame as jrender_frame
from opengl_raytracing_tpu.sampling import generate_jitter2d

from opengl_raytracing_tpu_torch.constants import (MAT_ALBEDO_SPHERE,
                                                   MAT_GLASS_SPHERE,
                                                   MAT_MIRROR_SPHERE,
                                                   MAT_POINTLIGHT_SPHERE)
from opengl_raytracing_tpu_torch.convert import (frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import RenderState, render_frame
from opengl_raytracing_tpu_torch.models.pipeline import primary_rays
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx

torch.set_num_threads(2)

H, W = 300, 400


def test_analytic_300x400_follows_unfused_jax():
    jparams = jpreset("baseline").replace(enable_env_map=0)
    params = params_from(jparams)
    cam = JCamera()
    cam.aspect = W / H
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    jitter = generate_jitter2d(0) * float(jparams.jitter_still_scale)
    jfin = JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.asarray(jitter, jnp.float32),
        curr_view_proj=jnp.asarray(vp), prev_view_proj=jnp.asarray(vp),
        camera_moved=jnp.int32(0))
    fin = frame_inputs_from_numpy(jfin, "cpu")
    _, out = render_frame(params, fin, RenderState.create(H, W, "cpu"),
                          height=H, width=W, use_bvh=False)
    img = out.image.numpy()
    with jax.disable_jit():
        _, unfused = jrender_frame(jparams, jfin, JRenderState.create(H, W),
                                   None, None, height=H, width=W,
                                   use_bvh=False)
    np.testing.assert_allclose(img, np.asarray(unfused.image), rtol=0,
                               atol=1e-4)
    _, fused = jax.jit(functools.partial(
        jrender_frame, height=H, width=W, use_bvh=False))(
            jparams, jfin, JRenderState.create(H, W), None, None)
    diff = np.abs(img - np.asarray(fused.image))
    over = diff > 1e-4
    assert over.mean() <= 1e-3
    # the lanes that moved are sphere lanes (the cancelling root)
    _, _, rd = primary_rays(H, W, fin, params)
    mat = SceneCtx.create(params, fin.cam_pos).trace(
        fin.cam_pos.expand(rd.shape), rd).mat.numpy()
    spheres = np.isin(mat, (MAT_ALBEDO_SPHERE, MAT_GLASS_SPHERE,
                            MAT_MIRROR_SPHERE, MAT_POINTLIGHT_SPHERE))
    assert spheres[over.any(-1)].all()
    # and the unfused JAX frame moved away from the fused one with the port
    jdiff = np.abs(np.asarray(unfused.image) - np.asarray(fused.image))
    clear = diff > 2e-4
    assert clear.any() and (jdiff > 1e-4)[clear].all()
    print(f"port vs unfused JAX: max abs "
          f"{np.abs(img - np.asarray(unfused.image)).max():.3e}; port vs "
          f"jitted JAX: max abs {diff.max():.3e}, {int(over.sum())} values "
          f"over 1e-4")


def test_lane_180_169_cpu_t_is_the_correctly_rounded_one():
    """The pixel whose card and CPU values differ: the port's CPU primary
    hit there equals a numpy float32 transcription of the ray and of the
    sphere root (numpy's sqrt and division round correctly), t =
    10.668944.  The root cancels (b*b = 134.56 against c2 = 133.69), so
    the card's ray, an ulp away after its division by the image width as
    a multiplication by the reciprocal, lands 17 ulp of t further on."""
    from opengl_raytracing_tpu_torch.camera import Camera
    from opengl_raytracing_tpu_torch.constants import (SPHERE_LEFT_CENTER,
                                                       SPHERE_LEFT_RADIUS)
    from opengl_raytracing_tpu_torch.convert import camera_frame_inputs
    from opengl_raytracing_tpu_torch.models import preset
    F = np.float32
    params = preset("baseline").replace(enable_env_map=0)
    cam = Camera()
    cam.aspect = W / H
    fin = camera_frame_inputs(
        cam, "cpu", jitter=generate_jitter2d(0) * params.jitter_still_scale)
    _, _, rd = primary_rays(H, W, fin, params)
    h = SceneCtx.create(params, fin.cam_pos).trace(
        fin.cam_pos.expand(rd.shape), rd)
    y, x = 180, 169
    jx, jy = fin.jitter.numpy()
    nx = (F(x + 0.5) + jx) / F(W) * F(2) - F(1)
    ny = (F(y + 0.5) + jy) / F(H) * F(2) - F(1)
    thf, asp = fin.tan_half_fov.numpy(), fin.aspect.numpy()
    d = (fin.cam_fwd.numpy() + nx * fin.cam_right.numpy() * (thf * asp)
         + ny * fin.cam_up.numpy() * thf)
    d = d / np.sqrt(F(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    np.testing.assert_array_equal(rd[y, x].numpy(), d)
    oc = fin.cam_pos.numpy() - F(SPHERE_LEFT_CENTER)
    b = F(oc[0] * d[0] + oc[1] * d[1]) + oc[2] * d[2]
    c2 = (F(oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]
          - F(SPHERE_LEFT_RADIUS * SPHERE_LEFT_RADIUS))
    t = -b - np.sqrt(b * b - c2)
    assert t.dtype == F and float(h.t[y, x]) == float(t)
    assert abs(float(t) - 10.668944) < 1e-6 and int(h.mat[y, x]) == 1
    assert b * b > 134.0 and b * b - c2 < 1.0  # the cancellation
