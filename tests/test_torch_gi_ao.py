"""The port's GI and AO against the JAX package's, on the same inputs.

Hits come from the JAX package's primary trace (the jnp walker on the
bunny BVH, the analytic scene's trace), sanitized as the frame does, and
go through the JAX function and its port with the same pixel centres and
frame numbers.  Tolerances:

* `build_onb`, `sample_hemisphere_cosine`: 1e-6 (cos, sin and sqrt round
  differently in XLA's and PyTorch's CPU kernels in the last bit);
* `compute_ao`: the occlusion counts are equal except on tie lanes, where
  a hemisphere ray meets an edge or the radius so closely that a one-ulp
  direction decides (at most 0.5% of lanes, and one sample each);
* `one_bounce_gi_bvh`, `one_bounce_gi_analytic` and `shade_mirror` with GI:
  1e-4 on the lanes whose radiance the frame keeps (a bounce ray and a
  direct-light evaluation further on), except bounce rays that meet an
  edge within that rounding (at most 0.5% of lanes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu import sampling as js
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models.pipeline import primary_rays
from opengl_raytracing_tpu.models.pipeline import _sanitize_hit as jsanitize
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import materials as jmat
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh

from opengl_raytracing_tpu_torch import sampling as ts
from opengl_raytracing_tpu_torch.convert import bvh_from_numpy, params_from
from opengl_raytracing_tpu_torch.ops import bvh_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import materials as tmat
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.sampling import FrameValue
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

torch.set_num_threads(2)

H, W = 48, 64
EDGE_FRAC = 5e-3   # lanes a one-ulp bounce direction may flip


def _t(x):
    return torch.from_numpy(np.array(x))


def _jfin(cam):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.zeros(2, jnp.float32), curr_view_proj=jnp.asarray(vp),
        prev_view_proj=jnp.asarray(vp), camera_moved=jnp.int32(0))


def _frame(use_bvh):
    """Sanitized primary hits of a camera grid (JAX trace), both scene
    contexts of the `full` preset, pixel centres and view directions."""
    cam = JCamera()
    cam.aspect = W / H
    jbvh = bvh = None
    if use_bvh:
        tris = gather_triangles(make_bunny(2),
                                model_transform((-2.0, 1.5, 0.0), 0.5))
        jbvh = jprepare_bvh(tris)
        bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x)
                                         for x in jbvh.arrays)), "cpu")
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))
    jparams = jpreset("full")
    jscene = JSceneCtx.create(jparams, jnp.asarray(cam.position),
                              use_bvh=use_bvh, bvh=jbvh)
    scene = SceneCtx.create(params_from(jparams), _t(cam.position),
                            use_bvh=use_bvh, bvh=bvh)
    px, py, rd = primary_rays(H, W, _jfin(cam), jparams)
    ro = jnp.broadcast_to(jnp.asarray(cam.position), rd.shape)
    jh_raw = jscene.trace(ro, rd)
    hit = np.asarray(jh_raw.valid)
    assert 0.2 < hit.mean() < 0.95
    jh = jsanitize(jh_raw, ro, rd)
    return dict(jscene=jscene, scene=scene, jh=jh,
                h=tsa.Hit(*(_t(x) for x in jh)), hit=hit, px=np.asarray(px),
                py=np.asarray(py), vdir=-np.asarray(rd))


@pytest.fixture(scope="module")
def bvh_frame():
    return _frame(True)


@pytest.fixture(scope="module")
def an_frame():
    return _frame(False)


def _pix(f):
    return _t(f["px"]), _t(f["py"]), jnp.asarray(f["px"]), jnp.asarray(f["py"])


def _normals(seed, n=4096):
    rng = np.random.RandomState(seed)
    nrm = rng.randn(n, 3).astype(np.float32) * 3.0  # not unit length
    nrm[:64] = [0.0, 1.0, 0.0]                       # the up-is-x branch
    nrm[64:128] = [0.05, -0.999, 0.0]
    nrm[128:136] = 0.0                               # a zero normal
    return nrm, rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)


def test_build_onb_matches_jax():
    nrm, _, _ = _normals(0)
    unit = nrm[136:] / np.linalg.norm(nrm[136:], axis=-1, keepdims=True)
    for n in (unit, nrm[:136]):
        got = ts.build_onb(_t(n))
        want = js.build_onb(jnp.asarray(n))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_sample_hemisphere_cosine_matches_jax():
    nrm, ux, uy = _normals(1)
    ux[:4] = [0.0, 0.25, 0.5, 0.999999]
    uy[:4] = [0.0, 1.0, 0.5, 0.999999]
    got = ts.sample_hemisphere_cosine(_t(nrm), _t(ux), _t(uy)).numpy()
    want = np.asarray(js.sample_hemisphere_cosine(
        jnp.asarray(nrm), jnp.asarray(ux), jnp.asarray(uy)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ok = np.abs(nrm).sum(-1) > 0
    np.testing.assert_allclose(np.linalg.norm(got[ok], axis=-1), 1.0,
                               atol=1e-6)
    assert ((got[ok] * nrm[ok]).sum(-1) >= -1e-6).all()  # upper hemisphere


def _ao_counts(ao, params):
    """Occluded samples per lane from an AO value."""
    return np.rint((1.0 - (ao - params.ao_min) / (1.0 - params.ao_min))
                   * params.ao_samples).astype(int)


@pytest.mark.parametrize("scene_kind", ["bvh", "analytic"])
@pytest.mark.parametrize("frame_index", [0, 7])
def test_compute_ao_matches_jax(bvh_frame, an_frame, scene_kind,
                                frame_index):
    f = bvh_frame if scene_kind == "bvh" else an_frame
    scene, jscene, hit = f["scene"], f["jscene"], f["hit"]
    px, py, jpx, jpy = _pix(f)
    active = _t(hit) if scene_kind == "bvh" else None
    before = dict(cuda_lib.LAUNCHES)
    got = tlt.compute_ao(scene, f["h"], FrameValue.of(frame_index, "cpu"),
                         px, py, active=active).numpy()
    assert cuda_lib.LAUNCHES == before
    want = np.asarray(jlt.compute_ao(
        jscene, f["jh"], jnp.int32(frame_index), jpx, jpy,
        active=None if active is None else jnp.asarray(hit)))
    params = scene.params.host  # the RenderParams of the scene's block
    assert got[hit].min() >= params.ao_min and got[hit].max() <= 1.0
    cg, cw = _ao_counts(got[hit], params), _ao_counts(want[hit], params)
    np.testing.assert_allclose(got[hit], params.ao_min + (1 - params.ao_min)
                               * (1 - cg / params.ao_samples), atol=1e-6)
    tie = cg != cw
    assert tie.mean() <= EDGE_FRAC and (np.abs(cg - cw)[tie] == 1).all()
    # AO darkens some lanes (on the bunny, its creases: ~1% of them)
    assert (cg > 0).sum() >= 5 and (cg > 0).mean() < 0.95


def _gi_bad_lanes(got, want, lanes):
    err = np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)
    return err.any(-1) & lanes


@pytest.mark.parametrize("frame_index", [0, 5])
def test_one_bounce_gi_bvh_matches_jax(bvh_frame, frame_index):
    f = bvh_frame
    px, py, jpx, jpy = _pix(f)
    hit = f["hit"]
    fi = frame_index
    before = dict(cuda_lib.LAUNCHES)
    fv = FrameValue.of(fi, "cpu")
    got = tlt.one_bounce_gi_bvh(f["scene"], f["h"], fv, fv, fv, px, py,
                                active=_t(hit)).numpy()
    assert cuda_lib.LAUNCHES == before
    want = np.asarray(jlt.one_bounce_gi_bvh(
        f["jscene"], f["jh"], jnp.int32(fi), jnp.int32(fi), jnp.int32(fi),
        jpx, jpy, active=jnp.asarray(hit)))
    assert np.isfinite(got[hit]).all()
    bad = _gi_bad_lanes(got, want, hit)
    assert bad.sum() <= EDGE_FRAC * hit.sum(), bad.sum()
    assert (got[hit] > 1e-3).any(-1).mean() > 0.2  # light bounces in
    lum = got[hit] @ np.float32([0.299, 0.587, 0.114])
    assert lum.max() <= 8.0 + 1e-5                 # the firefly clamp


@pytest.mark.parametrize("frame_index", [0, 5])
def test_one_bounce_gi_analytic_matches_jax(an_frame, frame_index):
    f = an_frame
    px, py, jpx, jpy = _pix(f)
    hit = f["hit"]
    fi = frame_index
    fv = FrameValue.of(fi, "cpu")
    got = tlt.one_bounce_gi_analytic(f["scene"], f["h"], fv, fv, fv, px,
                                     py).numpy()
    want = np.asarray(jlt.one_bounce_gi_analytic(
        f["jscene"], f["jh"], jnp.int32(fi), jnp.int32(fi), jnp.int32(fi),
        jpx, jpy))
    assert np.isfinite(got[hit]).all() and got[hit].std() > 0.01
    bad = _gi_bad_lanes(got, want, hit)
    assert bad.sum() <= EDGE_FRAC * hit.sum(), bad.sum()


def test_shade_mirror_with_gi_matches_jax(an_frame):
    f = an_frame
    px, py, jpx, jpy = _pix(f)
    mat = tmat.get_material(f["h"].mat, f["scene"].params)
    jm = jmat.get_material(f["jh"].mat, f["jscene"].params)
    four = FrameValue.of(4, "cpu")
    got = tlt.shade_mirror(f["scene"], f["h"], _t(f["vdir"]), mat, four,
                           four, px, py).numpy()
    want = np.asarray(jlt.shade_mirror(f["jscene"], f["jh"],
                                       jnp.asarray(f["vdir"]), jm,
                                       jnp.int32(4), jnp.int32(4), jpx, jpy))
    lanes = mat.mtype.numpy() == tmat.MTYPE_MIRROR
    assert lanes.sum() > 15 and np.isfinite(got[lanes]).all()
    bad = _gi_bad_lanes(got, want, lanes)
    assert bad.sum() <= max(1, EDGE_FRAC * lanes.sum()), bad.sum()
    # the GI term is there: the mirror without GI is darker
    no_gi = f["scene"].__class__.create(
        f["scene"].params.replace(enable_gi=0), f["scene"].cam_pos)
    plain = tlt.shade_mirror(no_gi, f["h"], _t(f["vdir"]), mat, four, four,
                             px, py).numpy()
    assert (got[lanes] - plain[lanes]).mean() > 1e-3


def test_trace_closest_active_lanes(bvh_frame):
    """`active` on the closest-hit walk: active lanes get the full walk's
    hit, inactive lanes read as misses (the GI bounce of sky pixels)."""
    f = bvh_frame
    arrays = f["scene"].bvh.arrays
    rng = np.random.RandomState(4)
    ro = f["h"].p + f["h"].n * 1e-3
    rd = torch.from_numpy(rng.randn(H, W, 3).astype(np.float32))
    rd = rd / rd.norm(dim=-1, keepdim=True)
    active = torch.from_numpy(rng.rand(H, W) < 0.6)
    full = bvh_cuda.trace_closest(arrays, ro, rd)
    part = bvh_cuda.trace_closest(arrays, ro, rd, active=active)
    assert 0.05 < full.valid[active].float().mean() < 0.95
    assert torch.equal(part.valid, full.valid & active)
    for name in ("t", "n", "p"):
        assert torch.equal(getattr(part, name)[active],
                           getattr(full, name)[active])
    assert (part.t[~active] == 1e30).all() and (part.n[~active] == 0).all()
