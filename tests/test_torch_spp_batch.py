"""The frame's samples as one batch over a leading sample axis ([spp, H,
W]), against the JAX package's SPP batch (`models/pipeline.py:
trace_and_shade`, `lighting.direct_light_bvh(..., spp_dup=spp)`,
`lighting.one_bounce_gi_bvh`), at 48x64 on the goldens' bunny scene (the
port building its own tree) and on the analytic scene:

* `FrameValue` with a sample stride against a numpy uint32 transcription
  (spp 1, 2, 4; the mirror GI's `seed * 131 + 17`, the bounce's
  `seed * 19`; indices near 2^31, where the products wrap);
* `direct_light_bvh_plain` on the broadcast batch with `spp_dup` against
  JAX's `direct_light_bvh(..., spp_dup=spp)`, also with JAX's
  `ORT_SPP_SHADOW_DEDUP=0` (the same port result): the K3 rounding class
  of tests/test_torch_direct_kernels.py (rtol 2e-5, atol 2e-6) on the kept
  lanes;
* GI's bounce on the batch against JAX's `one_bounce_gi_bvh`, under
  tests/test_torch_walk_sampling.py's gate (1e-4 abs + rel, but on at
  most EDGE_FRAC of the kept lanes, where a one-ulp ray flips a hit);
* `trace_and_shade` with spp 2 and 4, BVH and analytic, against JAX's:
  1e-4 on the image, the `heavy` tolerance of
  tests/test_torch_spp_motion_raster.py;
* the batched plain forms against spp single-sample calls summed in
  sample order: bit for bit (the BVH direct light, its bounce, the
  analytic direct light, and the whole `trace_and_shade`);
* a numpy transcription of the kernels' lane layout (lane i is pixel
  i % n_px of sample i // n_px, csrc/sampling.cuh; bvh_direct_kernel's
  units of `dup` samples) and of the shared sun and point walks, held to
  the plain versions bit for bit, as tests/test_torch_direct_kernels.py
  and tests/test_torch_walk_sampling.py hold the kernels' hash chains.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import pipeline as jpipe
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import scene_analytic as jsa
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.sampling import generate_jitter2d

from opengl_raytracing_tpu_torch.convert import (frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import pipeline as tpipe
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.ops import an_cuda, bvh_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops.bvh_traverse import trace_bvh
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx, prepare_bvh
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.params import bind
from opengl_raytracing_tpu_torch.sampling import (FrameValue, _frame_bits,
                                                  frame_f32, frame_record,
                                                  frame_value, rand,
                                                  sample_seeds)
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

import test_torch_direct_kernels as tdk
import test_torch_walk_sampling as tws
from torch_param_block import block_at

torch.set_num_threads(2)

H, W = 48, 64
TOL_K3 = dict(rtol=2e-5, atol=2e-6)
EDGE_FRAC = tws.EDGE_FRAC
F32 = np.float32
M32 = 0xFFFFFFFF
NEAR_WRAP = (2 ** 31 - 3, 2 ** 31 - 1, 2 ** 30 + 7)


# ---- the sampled frame value ----

def _int32(v):
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def numpy_value(index, a, b, c, spp):
    """int32(index * a + b + s * c) of s = 0 .. spp-1 in numpy uint32."""
    s = np.arange(spp, dtype=np.uint32)
    with np.errstate(over="ignore"):
        bits = (np.uint32(index & M32) * np.uint32(a & M32)
                + np.uint32(b & M32) + s * np.uint32(c & M32))
    return bits.astype(np.uint32)


@pytest.mark.parametrize("index", [0, 5, 1023] + list(NEAR_WRAP))
@pytest.mark.parametrize("spp", [1, 2, 4])
def test_sampled_frame_value_is_uint32_arithmetic(index, spp):
    """The batch's seeds `frame * spp + s` and the seeds derived from them
    (the mirror GI's `* 131 + 17`, the bounce's `* 19` and `* 41`, rand's
    `* 1663`) as a numpy uint32 transcription gives them, and their
    float32; rand over the batch is rand of each sample's host int."""
    frame = FrameValue(frame_record(index, "cpu"))
    seeds = sample_seeds(frame, spp)
    assert seeds.samples == spp
    px, py = tpipe.pixel_centers(6, 8, "cpu")
    for v, (a, b, c) in (
            (seeds, (spp, 0, 1)),
            (seeds * 131 + 17, (spp * 131, 17, 131)),
            ((seeds * 131 + 17) * 13, (spp * 131 * 13, 17 * 13, 131 * 13)),
            (seeds * 19, (spp * 19, 0, 19)), (seeds * 41, (spp * 41, 0, 41))):
        want = numpy_value(index, a, b, c if spp > 1 else 0, spp)
        got = frame_value(v)
        assert got.shape == ((spp, 1, 1) if spp > 1 else ())
        np.testing.assert_array_equal(got.reshape(-1).numpy().view(np.uint32),
                                      want)
        np.testing.assert_array_equal(
            _frame_bits(v, 1663).reshape(-1).numpy(),
            numpy_value(index, a * 1663, b * 1663,
                        c * 1663 if spp > 1 else 0, spp))
        np.testing.assert_array_equal(frame_f32(v).reshape(-1).numpy(),
                                      want.view(np.int32).astype(F32))
        got_rand = rand(px, py, v)
        assert got_rand.shape == ((spp, 6, 8) if spp > 1 else (6, 8))
        for s in range(spp):
            one = torch.tensor(_int32(int(want[s])), dtype=torch.int32)
            assert torch.equal(got_rand.reshape(-1, 6, 8)[s],
                               rand(px, py, one))


def test_kernel_frame_affine_carries_the_stride():
    """The kernels' FrameAffine (a, b, c): a value without a sample axis
    reads c = 0; the frames of one call share one sample count; a frame
    index with a sample axis is refused."""
    frame = FrameValue(frame_record(9, "cpu"))
    seeds = frame.sampled(4)
    record, (fi, sd, mirror), count = cuda_lib.frame_args(
        None, frame, seeds, seeds * 131 + 17)
    assert record is frame.record and count == 4
    assert [(x.a, x.b, x.c) for x in (fi, sd, mirror)] == [
        (1, 0, 0), (4, 0, 1), (4 * 131, 17, 131)]
    assert cuda_lib.frame_args(None, frame, frame * 4 + 3)[2] == 1
    with pytest.raises(ValueError, match="sample count"):
        cuda_lib.frame_args(None, seeds, frame.sampled(2))
    with pytest.raises(ValueError, match="sample axis already"):
        seeds.sampled(2)
    scene = SceneCtx.create(preset("full"), torch.zeros(3))
    with pytest.raises(ValueError, match="record's frame index"):
        an_cuda.scene_args(scene, seeds, seeds)
    with pytest.raises(ValueError, match="sampled seed"):
        bvh_cuda.ao_args(preset("full"), seeds)


# ---- the bunny scene, the port's own tree ----

def _camera(cam_aspect, bvh_scene):
    cam = JCamera()
    cam.aspect = cam_aspect
    if bvh_scene:
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))
    return cam


def _jfin(cam, jitter=(0.0, 0.0)):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.asarray(jitter, jnp.float32),
        curr_view_proj=jnp.asarray(vp), prev_view_proj=jnp.asarray(vp),
        camera_moved=jnp.int32(0))


@pytest.fixture(scope="module")
def bunny():
    """The goldens' bunny (make_bunny(2)) under the camera at fov 12: the
    port's primary hit from its own tree (prepare_bvh), the JAX package's
    scene on the JAX tree, the pixel centres and view directions."""
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    bvh = prepare_bvh(tris, "cpu")
    jbvh = jprepare_bvh(tris)
    cam = _camera(W / H, True)
    params = bind(preset("full"), "cpu")
    fin = frame_inputs_from_numpy(_jfin(cam), "cpu")
    px, py, rd = tpipe.primary_rays(H, W, fin, params)
    ro = fin.cam_pos.expand(rd.shape)
    h_raw = trace_bvh(bvh.arrays, ro, rd)
    hit = h_raw.valid
    assert 0.2 < float(hit.float().mean()) < 0.9
    h = tpipe._sanitize_hit(h_raw, ro, rd)
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=True, bvh=bvh)
    jscene = JSceneCtx.create(jpreset("full"), jnp.asarray(cam.position),
                              use_bvh=True, bvh=jbvh)
    return dict(scene=scene, jscene=jscene, h=h, hit=hit, px=px, py=py,
                vdir=-rd)


def _batch(x, spp):
    return x.expand((spp,) + x.shape)


def _hit_batch(h, spp):
    return Hit(*(_batch(x, spp) for x in h))


def _jhit_batch(h, spp):
    return jsa.Hit(*(jnp.asarray(_batch(x, spp).numpy()) for x in h))


def _jseeds(index, spp):
    return (jnp.int32(index) * spp
            + jnp.arange(spp, dtype=jnp.int32)).reshape(spp, 1, 1)


def _j(x, spp):
    return jnp.asarray(_batch(x, spp).numpy())


@pytest.mark.parametrize("spp,index,dedup", [(2, 0, "1"), (4, 7, "1"),
                                             (4, 7, "0"), (4, 2 ** 31 - 3,
                                                           "1")])
def test_direct_light_bvh_batch_matches_jax(bunny, monkeypatch, spp, index,
                                            dedup):
    """The primary call's batch: the port's plain form with spp_dup (the
    sun and point rays traced for sample 0 and broadcast) against JAX's
    with spp_dup, its dedup on (the default) or off."""
    monkeypatch.setenv("ORT_SPP_SHADOW_DEDUP", dedup)
    f = bunny
    fv = FrameValue.of(index, "cpu")
    args = (f["scene"], _hit_batch(f["h"], spp), fv.sampled(spp), fv,
            _batch(f["vdir"], spp), _batch(f["px"], spp),
            _batch(f["py"], spp), _batch(f["hit"], spp))
    before = dict(cuda_lib.LAUNCHES)
    got = tlt.direct_light_bvh(*args, spp_dup=spp)
    assert cuda_lib.LAUNCHES == before  # CPU tensors: the plain version
    assert torch.equal(got, tlt.direct_light_bvh_plain(*args, spp_dup=spp))
    # traced six walks a sample, the same bits
    assert torch.equal(got, tlt.direct_light_bvh_plain(*args))
    want = np.asarray(jlt.direct_light_bvh(
        f["jscene"], _jhit_batch(f["h"], spp), _jseeds(index, spp),
        jnp.int32(index), _j(f["vdir"], spp), _j(f["px"], spp),
        _j(f["py"], spp), active=_j(f["hit"], spp), spp_dup=spp))
    keep = _batch(f["hit"], spp).numpy()
    got = got.numpy()
    assert got.shape == (spp, H, W, 3) and np.isfinite(got[keep]).all()
    np.testing.assert_allclose(got[keep], want[keep], **TOL_K3)
    assert np.abs(got[0] - got[1])[keep[0]].max() > 1e-3  # other noise


@pytest.mark.parametrize("spp,index", [(2, 3), (4, 2 ** 30 + 7)])
def test_bounce_batch_matches_jax(bunny, spp, index):
    f = bunny
    fv = FrameValue.of(index, "cpu")
    keep = _batch(f["hit"], spp)
    got = tlt.one_bounce_gi_bvh(f["scene"], _hit_batch(f["h"], spp), fv,
                                fv.sampled(spp), fv, _batch(f["px"], spp),
                                _batch(f["py"], spp), active=keep).numpy()
    want = np.asarray(jlt.one_bounce_gi_bvh(
        f["jscene"], _jhit_batch(f["h"], spp), jnp.int32(index),
        _jseeds(index, spp), jnp.int32(index), _j(f["px"], spp),
        _j(f["py"], spp), active=_j(f["hit"], spp)))
    keep = keep.numpy()
    assert got.shape == (spp, H, W, 3) and np.isfinite(got).all()
    bad = (np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)).any(-1) & keep
    assert bad.sum() <= EDGE_FRAC * keep.sum(), bad.sum()
    assert (got[keep] > 1e-3).any(-1).mean() > 0.2  # light bounces in


@pytest.mark.parametrize("spp", [2, 4])
def test_batched_calls_equal_the_samples_one_by_one(bunny, spp):
    """Each call of the batch, bit for bit the spp single-sample calls it
    replaces (sample s with the seed frame * spp + s): the BVH direct light
    with its shared walks, the bounce through trace_bounce, the analytic
    direct light (K3's plain version)."""
    f = bunny
    fv = FrameValue.of(11, "cpu")
    scene, h, hit = f["scene"], f["h"], f["hit"]
    px, py, vdir = f["px"], f["py"], f["vdir"]
    seeds = fv.sampled(spp)
    batch = tlt.direct_light_bvh(scene, _hit_batch(h, spp), seeds, fv,
                                 _batch(vdir, spp), _batch(px, spp),
                                 _batch(py, spp), _batch(hit, spp),
                                 spp_dup=spp)
    h1, wi, cos = bvh_cuda.trace_bounce(scene.bvh.arrays,
                                        _hit_batch(h, spp), fv, seeds,
                                        _batch(px, spp), _batch(py, spp),
                                        _batch(hit, spp))
    an_scene = SceneCtx.create(bind(preset("full"), "cpu"),
                               torch.tensor([0.0, 1.0, 4.0]))
    an_h = Hit(h.t, h.p, h.n, (torch.arange(H * W) % 5).reshape(H, W).to(
        torch.int32))
    an = tlt.direct_light(an_scene, _hit_batch(an_h, spp), seeds, fv,
                          _batch(vdir, spp), _batch(px, spp),
                          _batch(py, spp))
    for s in range(spp):
        seed = fv * spp + s
        assert torch.equal(batch[s], tlt.direct_light_bvh(
            scene, h, seed, fv, vdir, px, py, hit)), s
        one = bvh_cuda.trace_bounce(scene.bvh.arrays, h, fv, seed, px, py,
                                    hit)
        for got, want in zip((h1.t, h1.p, h1.n, wi, cos),
                             (one[0].t, one[0].p, one[0].n, one[1],
                              one[2])):
            assert torch.equal(got[s], want), s
        assert torch.equal(an[s], tlt.direct_light(an_scene, an_h, seed, fv,
                                                   vdir, px, py)), s


# ---- trace_and_shade ----

@pytest.mark.parametrize("spp", [2, 3, 4, 16])
def test_sum_samples_is_jnp_sum_on_the_cpu(spp):
    """`sum_samples` (left to right, sample 0 first) is the JAX package's
    `jnp.sum(..., axis=0)` on its CPU path bit for bit, eager and jitted,
    on values spread over many binades."""
    rng = np.random.RandomState(spp)
    x = rng.lognormal(0.0, 3.0, (spp, H, W, 3)).astype(F32)
    got = tpipe.sum_samples(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.sum(jnp.asarray(x),
                                                          axis=0)))
    jitted = jax.jit(lambda a: jnp.sum(a, axis=0))
    np.testing.assert_array_equal(got, np.asarray(jitted(jnp.asarray(x))))
    if spp > 2:  # another order rounds apart: the check is not vacuous
        other = (torch.from_numpy(x[0::2]).sum(0)
                 + torch.from_numpy(x[1::2]).sum(0))
        assert not np.array_equal(got, other.numpy())


def _frame(use_bvh, spp, index):
    """Both packages' inputs of one frame: (port args, JAX args)."""
    jparams = jpreset("full").replace(spp_per_frame=spp, enable_env_map=0)
    cam = _camera(W / H, use_bvh)
    jitter = generate_jitter2d(index) * float(jparams.jitter_still_scale)
    jfin = _jfin(cam, jitter)
    fin = frame_inputs_from_numpy(jfin, "cpu", frame_index=index)
    params = bind(params_from(jparams), "cpu")
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    bvh = prepare_bvh(tris, "cpu") if use_bvh else None
    jbvh = jprepare_bvh(tris) if use_bvh else None
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=use_bvh, bvh=bvh)
    jscene = JSceneCtx.create(jparams, jfin.cam_pos, use_bvh=use_bvh,
                              bvh=jbvh)
    px, py, rd = tpipe.primary_rays(H, W, fin, params)
    jpx, jpy, jrd = jpipe.primary_rays(H, W, jfin, jparams)
    return ((scene, params, fin, px, py, rd, fin.frame),
            (jscene, jparams, jfin, jpx, jpy, jrd, jnp.int32(index)))


@pytest.mark.parametrize("use_bvh", [True, False])
@pytest.mark.parametrize("spp", [2, 4])
def test_trace_and_shade_matches_jax(use_bvh, spp):
    index = 5
    args, jargs = _frame(use_bvh, spp, index)
    curr, motion, gpos, gnrm = tpipe.trace_and_shade(*args, use_bvh=use_bvh)
    want = jpipe.trace_and_shade(*jargs, use_bvh=use_bvh, show_motion=False)
    assert curr.shape == (H, W, 3) and bool(torch.isfinite(curr).all())
    for name, got, w in zip(("curr", "motion", "gpos", "gnrm"),
                            (curr, motion, gpos, gnrm), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    hit = gnrm.abs().sum(-1) > 0
    assert float(curr[hit].std()) > 0.01


@pytest.mark.parametrize("use_bvh", [True, False])
@pytest.mark.parametrize("spp", [2, 4])
def test_trace_and_shade_is_the_samples_summed_in_order(use_bvh, spp,
                                                       monkeypatch):
    """One pass over the batch, bit for bit the shading of each sample on
    its own (its seed frame * spp + s), the sky select, the samples added
    left to right and divided by spp; the shading runs once."""
    args, _ = _frame(use_bvh, spp, 9)
    scene, params, fin, px, py, rd, frame = args
    calls = []
    name = "_shade_bvh" if use_bvh else "_shade_analytic"
    real = getattr(tpipe, name)

    def shade(*a, **kw):
        calls.append(a[1].t.shape)
        return real(*a, **kw)
    monkeypatch.setattr(tpipe, name, shade)
    curr = tpipe.trace_and_shade(*args, use_bvh=use_bvh)[0]
    monkeypatch.setattr(tpipe, name, real)
    assert calls == [(spp, H, W)]

    ro = fin.cam_pos.expand(rd.shape)
    h_raw = scene.trace(ro, rd)
    h = tpipe._sanitize_hit(h_raw, ro, rd)
    ao = tlt.compute_ao(scene, h, frame, px, py,
                        active=h_raw.valid if use_bvh else None)
    total = None
    for s in range(spp):
        seed = frame * spp + s
        if use_bvh:
            one = real(scene, h, seed, frame, -rd, px, py,
                       active=h_raw.valid, ao=ao)
        else:
            one = real(scene, h, seed, frame, -rd, px, py, ao=ao)
        one = torch.where(h_raw.valid[..., None], one, scene.sky(rd))
        total = one if total is None else total + one
    assert torch.equal(curr, total / torch.full((), float(spp)))


# ---- the kernels' lane layout and shared walks, transcribed ----

def lane_keys(s, record, grid, n_lanes):
    """Each lane's (sample, pixel) and rng key as csrc/sampling.cuh derives
    them (sample_of, pixel_centre) from the struct's FrameAffine."""
    i = np.arange(n_lanes)
    sample, q = i // grid.n_px, i % grid.n_px
    index = int(record[0]) & M32
    with np.errstate(over="ignore"):
        key = (np.uint32(index) * np.uint32(s.smp.a) + np.uint32(s.smp.b)
               + sample.astype(np.uint32) * np.uint32(s.smp.c))
    return sample, q, key


def grid_values(grid, keep, q):
    """px, py of pixels q through the grid's pointers and strides."""
    out = []
    for ptr, sr, sc in ((grid.px, grid.px_sr, grid.px_sc),
                        (grid.py, grid.py_sr, grid.py_sc)):
        held = [k for k in keep if k.data_ptr() == ptr][0]
        storage = torch.tensor([], dtype=torch.float32).set_(
            held.untyped_storage()).numpy()
        base = (ptr - held.untyped_storage().data_ptr()) // 4
        r, c = q // grid.cols, q % grid.cols
        out.append(storage[base + r * sr + c * sc])
    return out


def lane_offsets(s, record, px, py, key):
    """The kernels' disk_offset per lane with its own rng key."""
    cp_key, _, ld = tdk.kernel_keys(s, record)
    rx = tdk._rem1(tdk._rand(px, py, cp_key[0], cp_key[1]) + ld[0])
    ry = tdk._rem1(tdk._rand(py, px, cp_key[2], cp_key[3]) + ld[1])
    with np.errstate(over="ignore"):
        key_y = key * np.uint32(1663)
    out = []
    for k in range(4):
        fk, off = F32(k), F32(31 * k + 7)
        ux = tdk._rand(px + fk, py + fk, key, key_y)
        uy = tdk._rand(py + off, px + off, key, key_y)
        r, phi = tdk._concentric(s, tdk._rem1(ux + rx), tdk._rem1(uy + ry))
        phi = torch.from_numpy(phi)
        out.append((r * torch.cos(phi).numpy(), r * torch.sin(phi).numpy()))
    return out


@pytest.mark.parametrize("spp,index", [(2, 0), (4, 33), (4, 2 ** 31 - 1)])
@pytest.mark.parametrize("dup", [False, True])
def test_kernel_lanes_draw_each_samples_offsets(spp, index, dup):
    """Lane i of a sampled direct-light call draws the disk offsets of
    pixel i % n_px at sample i // n_px; with spp_dup, bvh_direct_kernel's
    unit u writes lane k * n_units + u of sample k: either way the lanes'
    offsets are the plain version's on the [spp, H, W] batch, bit for
    bit."""
    frame = FrameValue(frame_record(index, "cpu"))
    seeds = frame.sampled(spp)
    scene = SceneCtx.create(preset("full"), torch.zeros(3))
    s, record = an_cuda.scene_args(scene, seeds, frame)
    px, py = tpipe.pixel_centers(H, W, "cpu")
    shape = torch.Size((spp, H, W))
    grid, keep = cuda_lib.pixel_grid(_batch(px, spp), _batch(py, spp), shape,
                                     torch.device("cpu"), spp)
    assert grid.n_px == H * W
    # the broadcast grids are read in place, not copied
    assert (grid.px, grid.py) == (px.data_ptr(), py.data_ptr())
    n_lanes = spp * H * W
    if dup:
        # thread u, sample k -> lane k * n_units + u
        units = np.arange(H * W)
        lanes = np.concatenate([k * H * W + units for k in range(spp)])
        order = np.argsort(lanes)
        sample = np.repeat(np.arange(spp), H * W)[order]
        q = np.tile(units, spp)[order]
        np.testing.assert_array_equal(
            sample, lane_keys(s, record, grid, n_lanes)[0])
        np.testing.assert_array_equal(
            q, lane_keys(s, record, grid, n_lanes)[1])
    sample, q, key = lane_keys(s, record, grid, n_lanes)
    gx, gy = grid_values(grid, keep, q)
    got = lane_offsets(s, record, gx, gy, key)
    want = tlt._disk_offsets(seeds, frame, _batch(px, spp), _batch(py, spp))
    for (dx, dy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(dx, wx.reshape(-1).numpy())
        np.testing.assert_array_equal(dy, wy.reshape(-1).numpy())
    assert np.abs(got[0][0][:H * W] - got[0][0][H * W:2 * H * W]).max() > 0.1


def kernel_shared_queries(s, p, n):
    """bvh_direct_kernel's sun and point queries of one unit's hit row:
    (origin, dir, window), the window -1 where the ndl gate shuts it."""
    block = block_at(s.prm)
    nn = tws._norm(n)
    sun_l = -block["sun_dir"].astype(F32)
    sun_o = p + nn * F32(1.0)
    sun_w = np.where(tws._dot(nn, sun_l) > 0, F32(999.0), F32(-1.0))
    to_l = block["point_light_world"].astype(F32) - p
    dist = tws._lib("sqrt", np.maximum(tws._dot(to_l, to_l), F32(1e-20)))
    pl = to_l / dist[..., None]
    peps = np.maximum(F32(1e-3) * dist, F32(1e-4))
    pt_o = p + pl * peps[..., None]
    pt_w = np.where(tws._dot(nn, pl) > 0, dist - peps, F32(-1.0))
    return ((sun_o, np.broadcast_to(sun_l, sun_o.shape), sun_w),
            (pt_o, pl, pt_w))


@pytest.mark.parametrize("spp", [2, 4])
def test_kernel_shares_the_sun_and_point_walks(bunny, spp):
    """The shared-walk rule: the sun and point rays of every sample of a
    pixel are the rays the kernel builds once from the pixel's hit row, bit
    for bit; the plain version's bits with spp_dup (sample 0's, broadcast)
    are those of six walks a sample; the disk rays differ by sample."""
    f = bunny
    scene, h, hit = f["scene"], f["h"], f["hit"]
    fv = FrameValue.of(4, "cpu")
    s, _ = an_cuda.scene_args(scene, fv.sampled(spp), fv)
    h_b = _hit_batch(h, spp)
    n_b = tlt.normalize(h_b.n)
    offs = tlt._disk_offsets(fv.sampled(spp), fv, _batch(f["px"], spp),
                             _batch(f["py"], spp))
    origins, dirs, wins = tlt._bvh_shadow_queries(scene, h_b, n_b, offs,
                                                  _batch(hit, spp))
    assert len(wins) == 6
    unit = kernel_shared_queries(s, h.p.numpy(), h.n.numpy())
    live = hit.numpy()
    for (o, d, w), (ko, kd, kw) in zip(zip(origins[4:], dirs[4:], wins[4:]),
                                       unit):
        for k in range(spp):
            np.testing.assert_array_equal(
                o.expand(h_b.p.shape)[k].numpy()[live], ko[live])
            np.testing.assert_array_equal(
                d.expand(h_b.p.shape)[k].numpy()[live], kd[live])
            np.testing.assert_array_equal(w[k].numpy()[live], kw[live])
    assert (unit[0][2][live] > 0).any() and (unit[1][2][live] > 0).any()
    assert not torch.equal(dirs[0][0], dirs[0][1])  # the disk rays differ
