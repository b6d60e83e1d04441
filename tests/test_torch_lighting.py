"""The port's shading against the JAX package's, on the same inputs.

`direct_light_bvh` is fed the same Hit (the JAX walker's primary hit of a
camera grid, converted) and the same pixel coordinates on both sides.
Both trace the six shadow batches through their plain walks, so the
occlusion bits agree; the remaining differences are float32 rounding of
pow/cos/sin and of sums taken in another order.  Tolerance: 1e-5 abs and
1e-4 rel, on the lanes whose radiance is kept (the hit lanes).  The
elementwise helpers (sky, tonemap, present, the accumulation store) are
held to 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import scene_analytic as jsa
from opengl_raytracing_tpu.ops import svgf as jsvgf
from opengl_raytracing_tpu.ops import taa as jtaa
from opengl_raytracing_tpu.ops.bvh_traverse import trace_bvh as jtrace_bvh
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import bvh_from_numpy, params_from
from opengl_raytracing_tpu_torch.models.pipeline import _sanitize_hit
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops import svgf as tsvgf
from opengl_raytracing_tpu_torch.ops import taa as ttaa
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.sampling import FrameValue
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

torch.set_num_threads(2)

H, W = 48, 64


@pytest.fixture(scope="module")
def frame():
    """Primary hits of a camera grid on the bunny (JAX walker), with the
    pixel centers and view directions both sides shade with."""
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    jbvh = jprepare_bvh(tris)
    bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x) for x in jbvh.arrays)),
                         "cpu")
    cam = Camera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    right, up, fwd, thf = cam.basis()
    px, py = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                         np.arange(H, dtype=np.float32) + 0.5)
    x = (px / W * 2 - 1) * thf * cam.aspect
    y = (py / H * 2 - 1) * thf
    rd = fwd + x[..., None] * right + y[..., None] * up
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    ro = np.broadcast_to(cam.position, rd.shape).astype(np.float32)
    jh = jtrace_bvh(jbvh.arrays, jnp.asarray(ro), jnp.asarray(rd))
    hit = np.array(jh.valid)
    assert 0.2 < hit.mean() < 0.9
    h = tsa.Hit(*(torch.from_numpy(np.array(x)) for x in jh))
    h = _sanitize_hit(h, torch.from_numpy(ro), torch.from_numpy(rd))
    return dict(jbvh=jbvh, bvh=bvh, cam_pos=cam.position, h=h, hit=hit,
                px=px, py=py, rd=rd)


def _jhit(h):
    return jsa.Hit(*(jnp.asarray(x.numpy()) for x in h))


@pytest.mark.parametrize("variant", [
    dict(), dict(sun_enabled=0), dict(point_light_enabled=0, sky_enabled=0),
    dict(point_light_orbit_enabled=1, point_light_yaw=40.0,
         point_light_pitch=20.0, sun_yaw=120.0, sun_pitch=-60.0)])
@pytest.mark.parametrize("frame_index", [0, 5])
def test_direct_light_bvh_matches_jax(frame, variant, frame_index):
    jparams = jpreset("baseline").replace(**variant)
    params = params_from(jparams)
    jscene = JSceneCtx.create(jparams, jnp.asarray(frame["cam_pos"]),
                              use_bvh=True, bvh=frame["jbvh"])
    scene = SceneCtx.create(params, torch.from_numpy(frame["cam_pos"]),
                            use_bvh=True, bvh=frame["bvh"])
    for a, b in ((scene.sun_dir, jscene.sun_dir),
                 (scene.sky_up, jscene.sky_up),
                 (scene.point_light_pos, jscene.point_light_pos)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    h, hit = frame["h"], frame["hit"]
    px, py, rd = frame["px"], frame["py"], frame["rd"]
    fv = FrameValue.of(frame_index, "cpu")
    got = tlt.direct_light_bvh(scene, h, fv, fv,
                               torch.from_numpy(-rd), torch.from_numpy(px),
                               torch.from_numpy(py),
                               active=torch.from_numpy(hit)).numpy()
    want = np.asarray(jlt.direct_light_bvh(
        jscene, _jhit(h), jnp.int32(frame_index), jnp.int32(frame_index),
        jnp.asarray(-rd), jnp.asarray(px), jnp.asarray(py),
        active=jnp.asarray(hit)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-4, atol=1e-5)
    assert got[hit].std() > 0.01


def test_disk_offsets_and_light_frame(frame):
    np.testing.assert_array_equal(tlt.LIGHT_N, jlt.LIGHT_N)
    np.testing.assert_array_equal(tlt.LIGHT_T, jlt.LIGHT_T)
    np.testing.assert_array_equal(tlt.LIGHT_B, jlt.LIGHT_B)
    px, py = frame["px"], frame["py"]
    seven = FrameValue.of(7, "cpu")
    got = tlt._disk_offsets(seven, seven, torch.from_numpy(px),
                            torch.from_numpy(py))
    want = jlt._disk_offsets(jnp.int32(7), jnp.int32(7), jnp.asarray(px),
                             jnp.asarray(py))
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=2.5e-7)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=2.5e-7)


def test_shadow_queries_match_jax(frame):
    jparams = jpreset("baseline")
    scene = SceneCtx.create(params_from(jparams),
                            torch.from_numpy(frame["cam_pos"]), use_bvh=True,
                            bvh=frame["bvh"])
    jscene = JSceneCtx.create(jparams, jnp.asarray(frame["cam_pos"]),
                              use_bvh=True, bvh=frame["jbvh"])
    h = frame["h"]
    jh = _jhit(h)
    q = torch.tensor([-0.5, 4.0, -2.0])
    pairs = [(tlt._segment_shadow_query(h.p, q),
              jlt._segment_shadow_query(jh.p, jnp.asarray(q.numpy()))),
             (tlt._sun_shadow_query(scene, h, h.n),
              jlt._sun_shadow_query(jscene, jh, jh.n)),
             (tlt._point_shadow_query(scene, h),
              jlt._point_shadow_query(jscene, jh))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_sky_gradient_matches_jax():
    rng = np.random.RandomState(0)
    d = rng.randn(32, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:2] = [[0, 1, 0], [0, -1, 0]]
    p = jpreset("baseline")
    np.testing.assert_allclose(
        tsa.sky(torch.from_numpy(d), params_from(p)).numpy(),
        np.asarray(jsa.sky(jnp.asarray(d), p, None)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("exposure", [1.0, 0.6])
def test_store_and_present_match_jax(exposure):
    rng = np.random.RandomState(1)
    curr = (rng.rand(H, W, 3) * 3).astype(np.float32)
    motion = np.zeros((H, W, 2), np.float32)
    jparams = jpreset("baseline").replace(exposure=exposure)
    params = params_from(jparams)
    want = np.asarray(jtaa.resolve_taa(
        jnp.asarray(curr), jnp.asarray(motion), jnp.zeros((H, W, 4)),
        jnp.int32(0), jparams))
    buf = torch.full((H, W, 4), 7.0)
    got = ttaa.resolve_taa(torch.from_numpy(curr), torch.from_numpy(motion),
                           buf, FrameValue.of(0, "cpu"), params, out=buf)
    assert got.data_ptr() == buf.data_ptr()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    img = tsvgf.present(got, torch.from_numpy(motion), None, None, params)
    jimg = jsvgf.present(jnp.asarray(want), jnp.asarray(motion),
                         jnp.zeros((H, W, 3)), jnp.zeros((H, W, 3)), jparams)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=1e-6)
    assert img.shape == (H, W, 3)


@pytest.mark.parametrize("field", ["enable_taa", "enable_svgf"])
def test_motion_view_replaces_the_image(field):
    """The motion debug view of the present pass, whichever of TAA and
    SVGF is on: the HSV wheel of the motion, as JAX `present` returns it
    (1e-5: atan2 and the wrapped hue)."""
    jparams = jpreset("baseline").replace(**{field: 1})
    params = params_from(jparams)
    rng = np.random.RandomState(2)
    x = rng.rand(6, 8, 3).astype(np.float32)
    motion = (rng.randn(6, 8, 2) * 0.05).astype(np.float32)
    accum = ttaa.resolve_taa(torch.from_numpy(x), torch.from_numpy(motion),
                             torch.zeros(6, 8, 4), FrameValue.of(3, "cpu"),
                             params)
    got = tsvgf.present(accum, torch.from_numpy(motion), torch.from_numpy(x),
                        torch.from_numpy(x), params, show_motion=True)
    want = jsvgf.present(jnp.asarray(accum.numpy()), jnp.asarray(motion),
                         jnp.asarray(x), jnp.asarray(x), jparams,
                         show_motion=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert got.numpy().std() > 0.05


def test_params_are_frozen():
    params = params_from(jpreset("baseline"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        params.exposure = 2.0
