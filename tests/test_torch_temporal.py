"""The port's TAA resolve, SVGF filter and present pass against the JAX
package's, on the same inputs (numpy, from a seed).

Tolerances:

* `resolve_taa`: 1e-6 (elementwise float32; the smoothstep divisor may
  round one ulp apart);
* `svgf_filter` (K4's plain version) against JAX `svgf_filter` and against
  K4 itself (`svgf_filter_pallas`, interpret mode): atol 2e-5 / rtol 1e-4,
  the JAX package's own K4 tolerance (tests/test_svgf_pallas.py), as the
  49 exps and the weight sums round in another order;
* `present` (SVGF blend, ACES, gamma): 1e-5.

`resolve_taa`'s host flag `moved` (the still-camera skip) is held bit for
bit to the branch-free form and to JAX `resolve_taa(moved=...)`.

It also holds the two repairs of the port against the JAX package: the
`ORT_PRESENT_HALF_TEXEL=1` knob of `present`, and `render_frame` zeroing
TAA's motion when the camera did not move.
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
from opengl_raytracing_tpu.ops import svgf as jsvgf
from opengl_raytracing_tpu.ops import taa as jtaa
from opengl_raytracing_tpu.ops.svgf_pallas import svgf_filter_pallas

from opengl_raytracing_tpu_torch.convert import (frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import RenderState, render_frame
from opengl_raytracing_tpu_torch.ops import cuda_lib, svgf_cuda
from opengl_raytracing_tpu_torch.ops import svgf as tsvgf
from opengl_raytracing_tpu_torch.ops import taa as ttaa
from opengl_raytracing_tpu_torch.sampling import FrameValue

torch.set_num_threads(2)

H, W = 24, 64
TOL_K4 = dict(atol=2e-5, rtol=1e-4)
# jitted once for every case (the params' float fields are traced)
jsvgf_filter = jax.jit(jsvgf.svgf_filter)
jsvgf_pallas = jax.jit(svgf_filter_pallas)
YC = np.float32([0.299, 0.587, 0.114])


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _hist(rng, h=H, w=W, scale=1.0):
    col = (rng.rand(h, w, 3) * scale).astype(np.float32)
    return np.concatenate([col, (col @ YC)[..., None] ** 2], -1)


def _taa_case(case):
    """(curr, motion, history, frame_index) of one resolve_taa case (the
    cases of tests/test_temporal.py, on random fields)."""
    rng = np.random.RandomState(sum(map(ord, case)))
    curr = rng.rand(H, W, 3).astype(np.float32)
    hist = _hist(rng)
    motion = np.zeros((H, W, 2), np.float32)
    if case == "frame0":
        return curr, rng.rand(H, W, 2).astype(np.float32), hist * 9, 0
    if case.startswith("still"):
        return curr, motion, hist, int(case[5:])
    if case == "moving_oob":
        # a band of pixels reprojects out of the image, the rest within
        motion[..., 0] = np.linspace(-2.5, 0.3, W, dtype=np.float32)
        motion[..., 1] = 0.05
        return curr, motion, hist, 10
    if case == "hard_motion":
        motion[:] = 0.4
        motion[:, : W // 2] = 0.2   # between 0.02 and the hard cut 0.35
        return curr, motion, hist, 10
    if case == "box_clamp":
        motion[:] = 1e-4            # moving, below 0.02: w_hist = max_w
        near = curr + rng.uniform(-0.2, 0.2, curr.shape).astype(np.float32)
        hist[..., :3] = near        # clamped to curr +- 0.06, colour-weighted
        return curr, motion, hist, 50
    assert case == "mixed"
    motion = (rng.randn(H, W, 2) * 0.05).astype(np.float32)
    motion[: H // 3] = 0.0         # still rows
    motion[:, :8] *= 1e-3          # below the still threshold in part
    return curr, motion, hist, 20


@pytest.mark.parametrize("case", ["frame0", "still3", "still8", "still40",
                                  "moving_oob", "hard_motion", "box_clamp",
                                  "mixed"])
def test_resolve_taa_matches_jax(case):
    curr, motion, hist, fi = _taa_case(case)
    tfi = FrameValue.of(fi, "cpu")
    jparams = jpreset("full")
    params = params_from(jparams)
    want = np.asarray(jtaa.resolve_taa(jnp.asarray(curr), jnp.asarray(motion),
                                       jnp.asarray(hist), jnp.int32(fi),
                                       jparams))
    got = ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi, params)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # in place into the history itself: the gather reads no updated pixel
    buf = _t(hist)
    inplace = ttaa.resolve_taa(_t(curr), _t(motion), buf, tfi, params,
                               out=buf)
    assert inplace.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(inplace.numpy(), got.numpy())
    if case == "frame0":
        np.testing.assert_array_equal(got.numpy()[..., :3], curr)
    if case in ("moving_oob", "hard_motion", "box_clamp", "mixed"):
        # the case reaches the moving path: it differs from the still blend
        still = ttaa.resolve_taa(_t(curr), torch.zeros(H, W, 2), _t(hist),
                                 tfi, params)
        assert np.abs(got.numpy() - still.numpy()).max() > 1e-3


@pytest.mark.parametrize("moved", [False, True, None])
@pytest.mark.parametrize("case", ["frame0", "still3", "still8", "still40",
                                  "mixed", "thresh0", "taa_off"])
def test_resolve_taa_moved_flag(case, moved):
    """The host flag: False skips the moving path (on the zeroed motion a
    still camera's frame hands TAA), True and None run the branch-free
    form; all three equal it bit for bit, in place too, and JAX
    `resolve_taa(moved=...)` within 1e-6.  At taa_still_thresh <= 0 the
    skip is not taken (the JAX package's guard: zero motion is not below
    the threshold, so the pixels take the moving branch)."""
    jparams = jpreset("full")
    if case == "thresh0":
        jparams = jparams.replace(taa_still_thresh=0.0)
    if case == "taa_off":
        jparams = jparams.replace(enable_taa=0)
    curr, motion, hist, fi = _taa_case(
        "still8" if case in ("thresh0", "taa_off") else case)
    tfi = FrameValue.of(fi, "cpu")
    if moved is False:
        motion = np.zeros_like(motion)  # the caller's contract
    params = params_from(jparams)
    base = ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi, params)
    got = ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi, params,
                           moved=moved)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    buf = _t(hist)
    inplace = ttaa.resolve_taa(_t(curr), _t(motion), buf, tfi, params,
                               out=buf, moved=moved)
    assert inplace.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(inplace.numpy(), base.numpy())
    want = np.asarray(jtaa.resolve_taa(
        jnp.asarray(curr), jnp.asarray(motion), jnp.asarray(hist),
        jnp.int32(fi), jparams,
        moved=None if moved is None else jnp.asarray(moved)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_resolve_taa_skip_runs_no_gather(monkeypatch):
    """With moved=False the history is not gathered and no moving-path op
    runs; with the threshold at 0, or moved unknown, it is."""
    calls = []
    real = ttaa._sample_nearest
    monkeypatch.setattr(ttaa, "_sample_nearest",
                        lambda *a: calls.append(1) or real(*a))
    curr, motion, hist, fi = _taa_case("still8")
    tfi = FrameValue.of(fi, "cpu")
    params = params_from(jpreset("full"))
    ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi, params, moved=False)
    assert not calls
    ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi, params, moved=None)
    ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi, params, moved=True)
    ttaa.resolve_taa(_t(curr), _t(motion), _t(hist), tfi,
                     params.replace(taa_still_thresh=0.0), moved=False)
    assert len(calls) == 3


def _svgf_inputs(h, w, seed, sky_rows=0):
    """accum, motion, gpos, gnrm (numpy); the first `sky_rows` rows are
    sky: zero position and normal, as the frame writes them."""
    rng = np.random.RandomState(seed)
    col = (0.5 + 0.2 * rng.randn(h, w, 3)).astype(np.float32)
    m2 = (col @ YC) ** 2 + rng.uniform(0.0, 0.08, (h, w)).astype(np.float32)
    accum = np.concatenate([col, m2[..., None]], -1)
    motion = (0.03 * rng.randn(h, w, 2)).astype(np.float32)
    gpos = rng.randn(h, w, 3).astype(np.float32) * 0.3
    gnrm = rng.randn(h, w, 3).astype(np.float32) * 2.0  # not unit length
    gpos[:sky_rows] = 0.0
    gnrm[:sky_rows] = 0.0
    return accum, motion, gpos, gnrm


@pytest.mark.parametrize("case", ["random", "sky_rows", "all_sky",
                                  "params"])
def test_svgf_filter_matches_jax_and_k4(case):
    sky = {"random": 0, "sky_rows": 9, "all_sky": H, "params": 4}[case]
    inputs = _svgf_inputs(H, W, seed=sky + 1, sky_rows=sky)
    jparams = jpreset("full")
    if case == "params":
        jparams = jparams.replace(svgf_var_max=0.02, svgf_k_var=1.7,
                                  svgf_k_color=0.6, svgf_k_var_motion=0.3,
                                  svgf_k_color_motion=2.5)
    params = params_from(jparams)
    before = dict(cuda_lib.LAUNCHES)
    got = svgf_cuda.svgf_filter(*(_t(x) for x in inputs), params).numpy()
    assert cuda_lib.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(
        got, tsvgf.svgf_filter(*(_t(x) for x in inputs), params).numpy())
    jin = [jnp.asarray(x) for x in inputs]
    want = np.asarray(jsvgf_filter(*jin, jparams))
    k4 = np.asarray(jsvgf_pallas(*jin, jparams))
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL_K4)
    np.testing.assert_allclose(got, k4, **TOL_K4)
    # the filter smooths: less spread than its input
    assert got.std() < inputs[0][..., :3].std()


def test_svgf_filter_row_band_matches_whole_image():
    """One row band with a 3-row halo, tap validity against the full image
    (the sharded path's call): the band's rows of the whole-image filter,
    and JAX's band call."""
    accum, motion, gpos, gnrm = _svgf_inputs(H, W, seed=5, sky_rows=3)
    params = params_from(jpreset("full"))
    whole = tsvgf.svgf_filter(_t(accum), _t(motion), _t(gpos), _t(gnrm),
                              params).numpy()
    r0, bh, halo = 8, 8, 3
    sl = slice(r0 - halo, r0 + bh + halo)
    band = tsvgf.svgf_filter(_t(accum[sl]), _t(motion[sl]), _t(gpos[sl]),
                             _t(gnrm[sl]), params, halo=halo, row_offset=r0,
                             full_height=H).numpy()
    np.testing.assert_array_equal(band, whole[r0:r0 + bh])
    jband = np.asarray(jsvgf.svgf_filter(
        jnp.asarray(accum[sl]), jnp.asarray(motion[sl]), jnp.asarray(gpos[sl]),
        jnp.asarray(gnrm[sl]), jpreset("full"), halo=halo, row_offset=r0,
        full_height=H))
    np.testing.assert_allclose(band, jband, **TOL_K4)


def _present_inputs():
    accum, motion, gpos, gnrm = _svgf_inputs(H, W, seed=11, sky_rows=5)
    accum[..., :3] *= 2.0   # HDR, so ACES matters
    return accum, motion, gpos, gnrm


@pytest.mark.parametrize("svgf", [1, 0])
@pytest.mark.parametrize("half_texel", ["0", "1"])
def test_present_matches_jax(monkeypatch, svgf, half_texel):
    """present with the filter on and off, in the default texel-exact
    convention and with ORT_PRESENT_HALF_TEXEL=1 (one of the repairs: the
    knob shifts every input of the pass by one texel)."""
    monkeypatch.setenv("ORT_PRESENT_HALF_TEXEL", half_texel)
    inputs = _present_inputs()
    jparams = jpreset("full").replace(enable_svgf=svgf, exposure=0.8)
    params = params_from(jparams)
    got = tsvgf.present(*(_t(x) for x in inputs), params).numpy()
    want = np.asarray(jsvgf.present(*(jnp.asarray(x) for x in inputs),
                                    jparams, allow_pallas=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.shape == (H, W, 3) and 0 <= got.min() and got.max() <= 1
    if half_texel == "1":
        monkeypatch.setenv("ORT_PRESENT_HALF_TEXEL", "0")
        exact = tsvgf.present(*(_t(x) for x in inputs), params).numpy()
        assert np.abs(exact - got).max() > 1e-2
        # the shift: pixel (y, x) shows what texel (y+1, x+1) shows
        # exactly where the filter reads no neighbour
        if not svgf:
            np.testing.assert_array_equal(got[:-1, :-1], exact[1:, 1:])


def _jfin(cam, prev_vp, moved):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.zeros(2, jnp.float32), curr_view_proj=jnp.asarray(vp),
        prev_view_proj=jnp.asarray(prev_vp), camera_moved=jnp.int32(moved))


def test_static_camera_zeroes_taa_motion():
    """The other repair: a frame whose camera_moved is 0 while its previous
    view-projection differs (so the traced motion is not zero) resolves
    TAA with zero motion, as JAX render_frame does; the returned motion
    (SVGF's input) stays as traced."""
    fh, fw = 24, 32
    jparams = jpreset("baseline").replace(enable_taa=1)
    params = params_from(jparams)
    cam = JCamera()
    cam.aspect = fw / fh
    stale_vp = cam.view_projection()
    cam.position = cam.position + np.float32([0.3, 0.1, 0.0])
    jrender = jax.jit(functools.partial(jrender_frame, height=fh, width=fw,
                                        use_bvh=False))
    jstate = JRenderState.create(fh, fw)
    state = RenderState.create(fh, fw, "cpu")
    for i in range(2):
        jfin = _jfin(cam, stale_vp if i else cam.view_projection(), 0)
        jstate, jout = jrender(jparams, jfin, jstate, None, None)
        state, out = render_frame(params, frame_inputs_from_numpy(jfin, "cpu"),
                                  state, height=fh, width=fw, use_bvh=False)
        np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(state.accum.numpy(),
                                   np.asarray(jstate.accum), rtol=1e-3,
                                   atol=1e-4)
    motion = out.motion.numpy()
    np.testing.assert_allclose(motion, np.asarray(jout.motion), atol=1e-5)
    assert np.abs(motion).max() > 0.02  # reprojection would move pixels


@pytest.mark.parametrize("use_moved", [False, None])
def test_frame_with_skip_equals_branch_free_frame(use_moved):
    """A still-camera TAA chain rendered with the host flag (the skip) and
    with the flag unknown (the branch-free form) gives the same frames bit
    for bit; the flag rides in FrameInputs.moved."""
    import dataclasses
    fh, fw = 24, 32
    params = params_from(jpreset("realistic"))
    cam = JCamera()
    cam.aspect = fw / fh
    states = [RenderState.create(fh, fw, "cpu") for _ in range(2)]
    for i in range(3):
        fin = frame_inputs_from_numpy(_jfin(cam, cam.view_projection(), 0),
                                      "cpu")
        assert fin.moved is False and int(fin.camera_moved) == 0
        fins = (fin, dataclasses.replace(fin, moved=use_moved))
        outs = []
        for k in range(2):
            states[k], out = render_frame(params, fins[k], states[k],
                                          height=fh, width=fw, use_bvh=False)
            outs.append(out)
        np.testing.assert_array_equal(outs[0].image.numpy(),
                                      outs[1].image.numpy())
        np.testing.assert_array_equal(states[0].accum.numpy(),
                                      states[1].accum.numpy())
