"""The port's analytic scene against the JAX package's, on the same inputs.

Inputs come from a numpy seed or from the JAX package's own primary trace
of the default camera, and go through the JAX function and the port's
counterpart.  The JAX side runs its CPU path (jnp), and the Pallas kernels
K3 (`an_pallas.direct_light_pallas`) and K5 (`shade_bvh_brdf_pallas`) in
interpret mode.  Tolerances:

* intersections and traces: the same expressions, so `valid` and `mat`
  are equal and t and normals agree within 1e-5;
* `get_material`: exact;
* direct light against the jnp path and against K3/K5: the JAX package's
  own K3 tolerance, rtol 2e-5 / atol 2e-6 (tests/test_an_pallas.py), as
  only pow, sin and cos round differently;
* mirror and glass shading, on the lanes of that material: rtol/atol 1e-5
  (a secondary trace and a direct-light evaluation further on);
* the frame: 1e-4 over a 3-frame chain as tests/test_torch_pipeline.py
  (the gbuffer's marker and grazing lanes 2e-3, the HDR accumulation
  1e-3 relative, see the test), and the
  `analytic_baseline` golden at the tests/test_golden.py thresholds.
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
from opengl_raytracing_tpu.models.pipeline import primary_rays
from opengl_raytracing_tpu.models.pipeline import _sanitize_hit as jsanitize
from opengl_raytracing_tpu.ops import an_pallas
from opengl_raytracing_tpu.ops import intersect as jint
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import materials as jmat
from opengl_raytracing_tpu.ops import scene_analytic as jsa
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.sampling import generate_jitter2d
from opengl_raytracing_tpu.utils.image import read_png

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.constants import MAT_POINTLIGHT_SPHERE
from opengl_raytracing_tpu_torch.convert import (camera_frame_inputs,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (RenderState, make_render_fn,
                                                preset, render_frame)
from opengl_raytracing_tpu_torch.ops import an_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import intersect as tint
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import materials as tmat
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.sampling import FrameValue

torch.set_num_threads(2)

H, W = 48, 112   # the direct-light frame; wide enough for a 13x97 slice
FH, FW = 48, 64  # the rendered frames, at the golden's size
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
TOL_K3 = dict(rtol=2e-5, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


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


def _scenes(jparams, cam_pos):
    return (JSceneCtx.create(jparams, jnp.asarray(cam_pos), use_bvh=False),
            SceneCtx.create(params_from(jparams), _t(cam_pos),
                            use_bvh=False))


def _rays(seed, n=512):
    """Rays from around the camera toward the spheres, the floor and the
    marker, and some in any direction."""
    rng = np.random.RandomState(seed)
    ro = rng.uniform((-3.0, 0.2, -1.0), (3.0, 4.0, 4.0), (n, 3))
    aim = rng.uniform((-2.2, 0.0, -6.0), (2.0, 2.7, -1.8), (n, 3))
    rd = np.where(np.arange(n)[:, None] < 3 * n // 4, aim - ro,
                  rng.randn(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.fixture(scope="module")
def frame():
    """Sanitized primary hits of the default camera (JAX trace) with the
    pixel centers and view directions both sides shade with."""
    cam = JCamera()
    cam.aspect = W / H
    jparams = jpreset("baseline")
    jscene, _ = _scenes(jparams, cam.position)
    px, py, rd = primary_rays(H, W, _jfin(cam), jparams)
    ro = jnp.broadcast_to(jnp.asarray(cam.position), rd.shape)
    jh = jsanitize(jscene.trace(ro, rd), ro, rd)
    return dict(cam_pos=np.asarray(cam.position), jh=jh,
                h=tsa.Hit(*(_t(x) for x in jh)), px=np.asarray(px),
                py=np.asarray(py), vdir=-np.asarray(rd))


def test_intersect_plane_and_sphere_match_jax():
    ro, rd = _rays(0)
    n = np.float32([0.0, 1.0, 0.0])
    got = tint.intersect_plane(_t(ro), _t(rd), _t(n), 0.0)
    want = jint.intersect_plane(jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(n), 0.0)
    assert got[1].numpy().mean() > 0.2
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    c = np.float32([-1.2, 1.0, -3.5])
    got = tint.intersect_sphere(_t(ro), _t(rd), _t(c), 1.0)
    want = jint.intersect_sphere(jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.asarray(c), 1.0)
    v = got[1].numpy()
    assert 0.05 < v.mean() < 0.95
    np.testing.assert_array_equal(v, np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy()[v], np.asarray(want[0])[v],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["trace_analytic",
                                     "trace_analytic_ignore_glass",
                                     "trace_analytic_ignore_point_light"])
@pytest.mark.parametrize("point_light", [1, 0])
def test_trace_variants_match_jax(variant, point_light):
    jparams = jpreset("baseline").replace(point_light_enabled=point_light)
    params = params_from(jparams)
    plp = np.float32([0.0, 2.5, -3.0])
    ro, rd = _rays(1)
    ro[:64] = plp + np.float32([0.3, 0.1, 2.0])  # toward the marker
    rd[:64] = plp - ro[:64]
    rd[:64] /= np.linalg.norm(rd[:64], axis=1, keepdims=True)
    got = getattr(tsa, variant)(_t(ro), _t(rd), params, _t(plp))
    want = getattr(jsa, variant)(jnp.asarray(ro), jnp.asarray(rd), jparams,
                                 jnp.asarray(plp))
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    assert len(np.unique(got.mat.numpy()[valid])) >= 3
    marker = got.mat.numpy() == MAT_POINTLIGHT_SPHERE
    assert marker.any() == (variant != "trace_analytic_ignore_point_light"
                            and point_light == 1)
    for name in ("t", "p", "n"):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid],
                                   np.asarray(getattr(want, name))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("glass,mirror", [(1, 1), (0, 1), (1, 0), (0, 0)])
def test_get_material_matches_jax(glass, mirror):
    jparams = jpreset("baseline").replace(
        mat_glass_enabled=glass, mat_mirror_enabled=mirror,
        mat_albedo_color=(0.3, 0.6, 0.2), mat_glass_ior=1.33,
        mat_mirror_gloss=64.0)
    ids = np.arange(-1, 7, dtype=np.int32).reshape(2, 4)
    got = tmat.get_material(_t(ids), params_from(jparams))
    want = jmat.get_material(jnp.asarray(ids), jparams)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32
                           else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _direct_light_inputs(frame, sl=(slice(None), slice(None))):
    h = tsa.Hit(*(x[sl] for x in frame["h"]))
    jh = jsa.Hit(*(jnp.asarray(x.numpy()) for x in h))
    return (h, jh, frame["px"][sl], frame["py"][sl],
            frame["vdir"][sl])


@pytest.mark.parametrize("case", [
    dict(preset="baseline", frame_index=0),
    dict(preset="full", frame_index=3),
    dict(preset="baseline", frame_index=5, change=dict(sun_enabled=0)),
    dict(preset="baseline", frame_index=2,
         change=dict(point_light_enabled=0, sky_enabled=0)),
    dict(preset="baseline", frame_index=1, ragged=True)])
def test_direct_light_matches_jax_and_k3(frame, case):
    jparams = jpreset(case["preset"]).replace(**case.get("change", {}))
    jscene, scene = _scenes(jparams, frame["cam_pos"])
    sl = ((slice(0, 13), slice(0, 97)) if case.get("ragged")
          else (slice(None), slice(None)))
    h, jh, px, py, vdir = _direct_light_inputs(frame, sl)
    fi = case["frame_index"]
    fv = FrameValue.of(fi, "cpu")
    before = dict(cuda_lib.LAUNCHES)
    got = tlt.direct_light(scene, h, fv, fv, _t(vdir), _t(px),
                           _t(py)).numpy()
    assert cuda_lib.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(
        got, tlt.direct_light_plain(scene, h, fv, fv, _t(vdir), _t(px),
                                    _t(py)).numpy())
    args = (jscene, jh, jnp.int32(fi), jnp.int32(fi), jnp.asarray(vdir),
            jnp.asarray(px), jnp.asarray(py))
    want = np.asarray(jlt.direct_light(*args))
    k3 = np.asarray(an_pallas.direct_light_pallas(*args))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.std() > 0.01
    np.testing.assert_allclose(got, want, **TOL_K3)
    np.testing.assert_allclose(got, k3, **TOL_K3)


@pytest.mark.parametrize("which", ["mirror", "glass"])
def test_shade_mirror_and_glass_match_jax(frame, which):
    jparams = jpreset("baseline").replace(mat_glass_ior=1.45)
    jscene, scene = _scenes(jparams, frame["cam_pos"])
    h, jh, px, py, vdir = _direct_light_inputs(frame)
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
    assert lanes.sum() > 15
    assert np.isfinite(got[lanes]).all()
    np.testing.assert_allclose(got[lanes], want[lanes], rtol=1e-5,
                               atol=1e-5)


def test_shade_mirror_gi_raises(frame):
    """The mirror's GI term renders now (tests/test_torch_gi_ao.py holds it
    to JAX); on tensors that are neither on the CPU nor on a CUDA card it
    raises rather than running anything in its place."""
    scene = SceneCtx.create(params_from(jpreset("full")),
                            _t(frame["cam_pos"]).to("meta"), use_bvh=False)
    h = tsa.Hit(*(x.to("meta") for x in frame["h"]))
    mat = tmat.get_material(h.mat, scene.params)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tlt.shade_mirror(scene, h, h.p, mat, 0, 0, h.t, h.t)


@pytest.mark.parametrize("change", [dict(), dict(sun_enabled=0),
                                    dict(point_light_enabled=0,
                                         sky_enabled=0)])
def test_bvh_brdf_tail_matches_k5(frame, change):
    """The plain BRDF tail of direct_light_bvh_plain (K5's part of the
    fused BVH direct-light kernel) against K5 in interpret mode, both fed
    the same occlusion bits (from a numpy seed) and unit-disk offsets.
    Any surface will do: the analytic frame's hits."""
    jparams = jpreset("baseline").replace(**change)
    jscene, scene = _scenes(jparams, frame["cam_pos"])
    h, jh, px, py, vdir = _direct_light_inputs(frame)
    n, v = tlt.normalize(h.n), tlt.normalize(_t(vdir))
    six = FrameValue.of(6, "cpu")
    offs = tlt._disk_offsets(six, six, _t(px), _t(py))
    k = 4 + int(bool(jparams.sun_enabled)) + int(
        bool(jparams.point_light_enabled))
    occ = np.random.RandomState(3).rand(k, H, W) < 0.3
    got = tlt.shade_bvh_brdf_plain(scene, h, n, v, offs, _t(occ)).numpy()
    jocc = [jnp.asarray(o) for o in occ]
    want = np.asarray(an_pallas.shade_bvh_brdf_pallas(
        jscene, jh, jnp.asarray(n.numpy()), jnp.asarray(v.numpy()),
        [(jnp.asarray(dx.numpy()), jnp.asarray(dy.numpy()))
         for dx, dy in offs], jocc[:4],
        jocc[4] if jparams.sun_enabled else None,
        jocc[-1] if jparams.point_light_enabled else None))
    assert np.isfinite(got).all() and got.std() > 0.01
    np.testing.assert_allclose(got, want, **TOL_K3)


def test_render_frame_matches_jax_chain():
    """Three chained frames with jitter, the second one after a camera
    move, against JAX render_frame: image, accumulation and gbuffers."""
    jparams = jpreset("baseline")
    params = params_from(jparams)
    cam = JCamera()
    cam.aspect = FW / FH
    scale = float(jparams.jitter_still_scale)
    prev_vp = cam.view_projection()
    jrender = jax.jit(functools.partial(jrender_frame, height=FH, width=FW,
                                        use_bvh=False))
    jstate = JRenderState.create(FH, FW)
    render = make_render_fn(FH, FW, "cpu")
    state = RenderState.create(FH, FW, "cpu")
    for i in range(3):
        moved = int(i == 1)
        if moved:
            cam.position = cam.position + np.float32([0.05, 0.02, 0.0])
        jfin = _jfin(cam, generate_jitter2d(i) * scale, prev_vp, moved)
        prev_vp = cam.view_projection()
        jstate, jout = jrender(jparams, jfin, jstate, None, None)
        state, out = render(params, frame_inputs_from_numpy(jfin, "cpu"),
                            state)
        assert state.frame_index == int(jstate.frame_index) == i + 1
        for name in ("image", "motion"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        # The gbuffer holds hit points and normals.  On the marker sphere
        # (r = 0.15, ~11 units away) the root's disc = b*b - c2 cancels:
        # b*b ~ 134 has an ulp of 1.5e-5 against disc ~ 0.02, so one
        # rounding step more or less (XLA may contract b*b - c2 into an
        # FMA) moves t by ~1e-4 and the normal by ~1e-3; grazing lanes
        # amplify t the same way.  Those lanes are held to 2e-3, the
        # others to 1e-4; the image above is held to 1e-4 everywhere.
        jpos, jnrm = np.asarray(jout.gpos), np.asarray(jout.gnrm)
        view = jpos - np.asarray(jfin.cam_pos)
        view /= np.linalg.norm(view, axis=-1, keepdims=True) + 1e-30
        hit = np.abs(jnrm).sum(-1) > 0
        loose = hit & ((np.abs((view * jnrm).sum(-1)) < 0.1)
                       | (np.linalg.norm(jpos - np.float32(
                           jparams.point_light_pos), axis=-1) < 0.16))
        assert loose.mean() < 0.15  # the far floor grazes, too
        for name, want in (("gpos", jpos), ("gnrm", jnrm)):
            got = getattr(out, name).numpy()
            np.testing.assert_allclose(got[~loose], want[~loose], rtol=1e-4,
                                       atol=1e-4, err_msg=name)
            np.testing.assert_allclose(got[loose], want[loose], rtol=0,
                                       atol=2e-3, err_msg=name)
        # The accumulation is linear radiance before the tonemap (5.0 in
        # the albedo sphere's highlight) and its M2 channel, lum^2, doubles
        # the relative error; a mirror lane's reflected ray magnifies the
        # normal's last bits.  Held to 1e-3 relative; the worst lanes reach
        # 4e-4.
        np.testing.assert_allclose(state.accum.numpy(),
                                   np.asarray(jstate.accum), rtol=1e-3,
                                   atol=1e-4)
        img = out.image.numpy()
        assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
        assert img.std() > 0.02


def test_converted_analytic_params_render_the_same_frame():
    """A JAX RenderParams with non-default analytic fields, carried over
    by convert.params_from, renders the same frame on both sides."""
    jparams = jpreset("baseline").replace(
        mat_albedo_color=(0.2, 0.5, 0.8), mat_albedo_spec_strength=0.6,
        mat_albedo_gloss=12.0, mat_glass_color=(0.9, 0.8, 0.6),
        mat_glass_ior=1.33, mat_glass_distortion=0.2,
        mat_mirror_color=(0.9, 0.95, 0.7), mat_mirror_gloss=64.0,
        point_light_orbit_enabled=1, point_light_orbit_radius=1.5,
        point_light_yaw=60.0, point_light_pitch=25.0)
    params = params_from(jparams)
    for name in ("mat_albedo_color", "mat_glass_ior", "mat_glass_distortion",
                 "mat_mirror_gloss", "point_light_orbit_enabled",
                 "point_light_yaw"):
        assert getattr(params, name) == pytest.approx(getattr(jparams, name))
    cam = JCamera()
    cam.aspect = FW / FH
    jfin = _jfin(cam)
    _, jout = jrender_frame(jparams, jfin, JRenderState.create(FH, FW),
                            height=FH, width=FW, use_bvh=False)
    _, out = render_frame(params, frame_inputs_from_numpy(jfin, "cpu"),
                          RenderState.create(FH, FW, "cpu"), height=FH,
                          width=FW, use_bvh=False)
    want = np.asarray(jout.image)
    np.testing.assert_allclose(out.image.numpy(), want, rtol=1e-4, atol=1e-4)
    _, base = render_frame(preset("baseline"),
                           frame_inputs_from_numpy(jfin, "cpu"),
                           RenderState.create(FH, FW, "cpu"), height=FH,
                           width=FW, use_bvh=False)
    assert np.abs(base.image.numpy() - want).max() > 0.05


def test_analytic_baseline_golden():
    want = read_png(os.path.join(GOLDEN_DIR, "analytic_baseline.png"))[
        ::-1].astype(np.float32) / 255.0
    cam = Camera()
    cam.aspect = FW / FH
    render = make_render_fn(FH, FW, "cpu", use_bvh=False)
    _, out = render(preset("baseline"), camera_frame_inputs(cam, "cpu"),
                    RenderState.create(FH, FW, "cpu"))
    diff = np.abs(out.image.numpy() - want)
    assert diff.max() < 0.05, f"max diff {diff.max():.4f}"
    assert np.quantile(diff, 0.999) < 0.02


def test_an_kernel_wrappers_reject_other_devices(frame):
    _, scene = _scenes(jpreset("baseline"), frame["cam_pos"])
    h = tsa.Hit(*(x.to("meta") for x in frame["h"]))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        an_cuda.direct_light(scene, h, 0, 0, h.p, h.t, h.t)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        an_cuda.direct_light_bvh(scene, h, 0, 0, h.p, h.t, h.t)
