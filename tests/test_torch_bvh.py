"""The port's BVH walks against the JAX package's.

Both sides walk the same tree: the JAX `prepare_bvh(...).arrays` go to
the port through `convert.bvh_from_numpy`.  Tolerances:

* plain walker vs the JAX jnp walker: the same rule step for step, so
  `valid` and occlusion are equal, and t and normals agree within 1e-5
  (dot products are summed in another order);
* plain walker vs the Pallas kernels K1/K2 (interpret mode), which do
  Moller-Trumbore as bf16_3x matmuls: rtol/atol 1e-4 on t and 1e-3 on
  normals as in tests/test_bvh_mxu.py, occlusion equal;
* plain any-hit walk vs K6, the lane-packed shadow kernel
  (`bvh_mxu.SHADOW_PACK`), in interpret mode: occlusion equal;
* plain walks vs K7a/K7b, the scalar packet walks of
  experiments/bvh_pallas.py, in interpret mode: the same float32 scalar
  arithmetic, so `valid` and occlusion are equal and t agrees within
  1e-5; a normal may differ only where another triangle ties in t.

The port's CUDA kernels are held to these plain walks on the card, so
they stand for K1, K2, K6, K7a and K7b alike.

tests/test_torch_cuda.py holds the kernels' own tests, which need a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu.ops import bvh_traverse as jbt
from opengl_raytracing_tpu.ops.bvh_mxu import (build_mxu_arrays,
                                               trace_bvh_mxu,
                                               trace_bvh_shadow_mxu)
from opengl_raytracing_tpu.ops.intersect import (intersect_aabb as
                                                 j_intersect_aabb,
                                                 intersect_triangle as
                                                 j_intersect_triangle)
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.scene import build_bvh as jbuild_bvh
from opengl_raytracing_tpu.scene import bvh_to_arrays as jbvh_to_arrays

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import bvh_from_numpy
from opengl_raytracing_tpu_torch.ops import bvh_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import bvh_traverse as tbt
from opengl_raytracing_tpu_torch.ops.intersect import (intersect_aabb,
                                                       intersect_triangle)
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, make_icosphere,
                                               model_transform)

torch.set_num_threads(2)

N_RAYS = 4096  # one Pallas grid step in interpret mode


@pytest.fixture(scope="module")
def scene():
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    jarrays = jprepare_bvh(tris).arrays
    dev = bvh_from_numpy(BVHArrays(*(np.asarray(x) for x in jarrays)), "cpu")
    return tris, jarrays, dev.arrays


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rays(seed, n=N_RAYS):
    """Half the rays aim at the bunny, half go anywhere; a few directions
    have exact zero components (the _safe_inv path)."""
    rng = np.random.RandomState(seed)
    ro = rng.uniform((-5.0, -1.0, -3.0), (1.0, 4.0, 3.0), (n, 3))
    aim = rng.uniform((-2.6, 0.9, -0.7), (-1.4, 2.1, 0.7), (n, 3))
    rd = np.where(np.arange(n)[:, None] < n // 2, aim - ro,
                  rng.randn(n, 3))
    rd[:8, 0] = 0.0
    rd[8:16, 1:] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _camera_rays(h=48, w=64):
    cam = Camera()
    cam.aspect = w / h
    cam.fov = 12.0  # the bunny fills about a third of the frame
    cam.point_at((-2.0, 1.5, 0.0))
    right, up, fwd, thf = cam.basis()
    x = ((np.arange(w) + 0.5) / w * 2 - 1) * thf * cam.aspect
    y = ((np.arange(h) + 0.5) / h * 2 - 1) * thf
    rd = (fwd + x[None, :, None] * right + y[:, None, None] * up)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(cam.position, rd.shape).copy(), rd


def test_intersect_primitives_match_jax():
    rng = np.random.RandomState(5)
    ro, rd = _rays(5, 512)
    bmin = rng.uniform(-3, 0, (512, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 2, (512, 3)).astype(np.float32)
    inv = 1.0 / np.where(rd == 0, np.float32(1e-30), rd)
    got = intersect_aabb(_t(ro), _t(inv), _t(bmin), _t(bmax))
    want = j_intersect_aabb(jnp.asarray(ro), jnp.asarray(inv),
                            jnp.asarray(bmin), jnp.asarray(bmax))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v0 = rng.uniform(-3, 1, (512, 3)).astype(np.float32)
    e1 = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    tmax = rng.uniform(-1, 8, 512).astype(np.float32)
    bary = rng.uniform(-0.1, 0.7, (512, 2, 1))
    rd = (v0 + bary[:, 0] * e1 + bary[:, 1] * e2 - ro).astype(np.float32)
    t, cr, v = intersect_triangle(_t(ro), _t(rd), _t(v0), _t(e1), _t(e2),
                                  _t(tmax))
    jt, jcr, jv = j_intersect_triangle(*(jnp.asarray(x) for x in
                                         (ro, rd, v0, e1, e2, tmax)))
    v = v.numpy()
    np.testing.assert_array_equal(v, np.asarray(jv))
    assert v.sum() > 20
    np.testing.assert_allclose(t.numpy()[v], np.asarray(jt)[v], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cr.numpy(), np.asarray(jcr), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("rays", ["random", "camera"])
def test_walker_matches_jax_walker(scene, rays):
    _, jarrays, arrays = scene
    ro, rd = _rays(0) if rays == "random" else _camera_rays()
    h = tbt.trace_bvh(arrays, _t(ro), _t(rd))
    jh = jbt.trace_bvh(jarrays, jnp.asarray(ro), jnp.asarray(rd))
    valid = h.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jh.valid))
    assert valid.mean() > 0.1
    np.testing.assert_allclose(h.t.numpy()[valid], np.asarray(jh.t)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.n.numpy()[valid], np.asarray(jh.n)[valid],
                               atol=1e-5)
    np.testing.assert_array_equal(h.n.numpy()[~valid], 0.0)
    assert (h.t.numpy()[~valid] == 1e30).all()
    np.testing.assert_array_equal(h.mat.numpy(), 1)


def test_shadow_walker_matches_jax_walker(scene):
    _, jarrays, arrays = scene
    ro, rd = _rays(1)
    t_max = np.random.RandomState(1).uniform(-1, 4, N_RAYS).astype(np.float32)
    occ = tbt.trace_bvh_shadow(arrays, _t(ro), _t(rd), _t(t_max)).numpy()
    want = np.asarray(jbt.trace_bvh_shadow(jarrays, jnp.asarray(ro),
                                           jnp.asarray(rd),
                                           jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, want)
    assert 0.05 < occ.mean() < 0.95
    assert not occ[t_max <= 0].any()


def test_walker_matches_brute_force(scene):
    tris, _, arrays = scene
    ro, rd = _rays(2, 1024)
    h = tbt.trace_bvh(arrays, _t(ro), _t(rd))
    hb = tbt.trace_brute(_t(tris), _t(ro), _t(rd))
    np.testing.assert_array_equal(h.valid.numpy(), hb.valid.numpy())
    np.testing.assert_array_equal(h.t.numpy(), hb.t.numpy())


def _tied_normals(tris, ro, rd, t_best, rtol, atol):
    """[R,T] mask of triangles a closest hit could pick at the MXU's
    precision: valid, and within the t tolerance of the walker's t."""
    tr = _t(tris)
    t, cr, v = intersect_triangle(_t(ro)[:, None], _t(rd)[:, None],
                                  tr[None, :, 0:3], tr[None, :, 3:6],
                                  tr[None, :, 6:9], torch.tensor(1e30))
    near = v & ((t - t_best[:, None]).abs() <= atol + rtol * t_best[:, None])
    n = cr / cr.norm(dim=-1, keepdim=True)
    return near, n


@pytest.mark.parametrize("case", ["icosphere", "bunny_camera"])
def test_walker_matches_pallas_kernels(case):
    """K1 (closest) and K2 (any hit) in interpret mode, over the same
    host tree, against the plain walks.  `icosphere` is the scene and
    rays of tests/test_bvh_mxu.py; `bunny_camera` shoots primary-like
    rays from the default camera at the bunny.  A normal may differ only
    on a lane where another triangle lies within the t tolerance (a
    shared edge): it must then be that triangle's normal."""
    rng = np.random.RandomState(0)
    if case == "icosphere":
        tris = gather_triangles(make_icosphere(1.0, 2),
                                model_transform((0.0, 1.0, -3.0), 1.0))
        ro = rng.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
        rd = rng.randn(N_RAYS, 3).astype(np.float32)
        t_max = np.full(N_RAYS, 4.0, np.float32)
    else:
        tris = gather_triangles(make_bunny(2),
                                model_transform((-2.0, 1.5, 0.0), 0.5))
        cam = Camera()
        cam.point_at((-2.0, 1.5, 0.0))
        ro = np.broadcast_to(cam.position, (N_RAYS, 3)).astype(np.float32)
        rd = rng.uniform((-2.6, 0.9, -0.7), (-1.4, 2.1, 0.7),
                         (N_RAYS, 3)).astype(np.float32) - ro
        t_max = rng.uniform(-1.0, 12.0, N_RAYS).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    host = jbuild_bvh(tris)
    mxu = build_mxu_arrays(host)
    arrays = bvh_from_numpy(BVHArrays(*jbvh_to_arrays(host)), "cpu").arrays

    h = tbt.trace_bvh(arrays, _t(ro), _t(rd))
    jh = trace_bvh_mxu(mxu, jnp.asarray(ro), jnp.asarray(rd))
    valid = h.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jh.valid))
    assert valid.mean() > (0.02 if case == "icosphere" else 0.5)
    np.testing.assert_allclose(h.t.numpy()[valid], np.asarray(jh.t)[valid],
                               rtol=1e-4, atol=1e-4)
    near, tri_n = _tied_normals(tris, ro, rd, h.t, 1e-4, 1e-4)
    jn = torch.from_numpy(np.array(jh.n))
    ok = ((tri_n - jn[:, None]).abs().amax(-1) <= 1e-3) & near
    flip = (h.n - jn).abs().amax(-1) > 1e-3
    assert bool(ok[torch.from_numpy(valid)].any(-1).all())
    assert bool((near.sum(-1)[flip] >= 2).all())

    occ = tbt.trace_bvh_shadow(arrays, _t(ro), _t(rd), _t(t_max)).numpy()
    want = np.asarray(trace_bvh_shadow_mxu(mxu, jnp.asarray(ro),
                                           jnp.asarray(rd),
                                           jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, want.astype(bool))
    assert occ.any()


def test_wrappers_on_cpu_use_plain_walks(scene):
    """The wrappers on CPU tensors are the plain versions: trace_closest
    the plain walk (with and without `active`), trace_bounce and
    ambient_occlusion lighting's gi_bounce_plain and
    ambient_occlusion_plain; no kernel launch is counted."""
    from opengl_raytracing_tpu_torch.models import preset
    from opengl_raytracing_tpu_torch.ops import lighting as tlt
    from opengl_raytracing_tpu_torch.sampling import FrameValue
    _, _, arrays = scene
    before = dict(bvh_cuda.LAUNCHES)
    ro, rd = _rays(4, 3 * 512)
    active = torch.from_numpy(np.random.RandomState(5).rand(3 * 512) < 0.7)
    for act in (None, active):
        h = bvh_cuda.trace_closest(arrays, _t(ro), _t(rd), active=act)
        hp = tbt.trace_bvh(arrays, _t(ro), _t(rd), active=act)
        for a, b in zip(h, hp):
            assert torch.equal(a, b)
    assert 0.1 < h.valid.float().mean() < 0.9
    px, py = (torch.arange(3 * 512, dtype=torch.float32) + 0.5,
              torch.full((3 * 512,), 7.5))
    params = preset("full")
    three = FrameValue.of(3, "cpu")
    got = bvh_cuda.trace_bounce(arrays, h, three, three, px, py, h.valid)
    want = tlt.gi_bounce_plain(arrays, h, three, three, px, py, h.valid)
    for a, b in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert torch.equal(a, b)
    ao = bvh_cuda.ambient_occlusion(arrays, h, three, px, py, params,
                                    h.valid)
    assert torch.equal(ao, tlt.ambient_occlusion_plain(arrays, h, three, px,
                                                       py, params, h.valid))
    assert bvh_cuda.LAUNCHES == before


def test_wrapper_checks_reject_bad_tensors():
    x = torch.zeros(8, 3)
    check = cuda_lib.check
    check("x", x, torch.float32, (8, 3), x.device)
    with pytest.raises(TypeError):
        check("x", x.double(), torch.float32, (8, 3), x.device)
    with pytest.raises(ValueError, match="shape"):
        check("x", torch.zeros(8, 4), torch.float32, (8, 3), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        check("x", torch.zeros(3, 8).T, torch.float32, (8, 3), x.device)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bvh_cuda.trace_closest(None, torch.zeros(1, 3, device="meta"),
                               torch.zeros(1, 3, device="meta"))


def _any_batches(arrays, oris, dirs, wins, active=None):
    """The plain any-hit walk over k same-shape batches traced as one
    stream, [k, ...]; inactive lanes (per-batch shape) read False."""
    occ = tbt.trace_bvh_shadow(arrays, torch.cat(oris), torch.cat(dirs),
                               torch.cat(wins)).reshape(len(oris), -1)
    return occ if active is None else occ & active


@pytest.mark.parametrize("case", ["per_batch", "shared", "active"])
def test_any_walk_matches_packed_shadow_kernel(case, monkeypatch):
    """K6 (`_shadow_kernel_pack`, the k batches packed on lanes) against
    the port's plain any-hit walk on the CPU, the walk the AO and BVH
    direct-light kernels run: four disk-light-like batches with their own
    origins, four hemisphere-like batches sharing one origin, and
    per-batch origins under an `active` mask."""
    from opengl_raytracing_tpu.ops import bvh_mxu as bm
    tris = gather_triangles(make_icosphere(1.0, 2),
                            model_transform((0.0, 1.0, -3.0), 1.0))
    host = jbuild_bvh(tris)
    pages = bm.build_mxu_paged(host)
    arrays = bvh_from_numpy(BVHArrays(*jbvh_to_arrays(host)), "cpu").arrays
    rng = np.random.RandomState(7)
    n = 512
    hp = (rng.uniform(-1.5, 1.5, (n, 3))
          + np.float32([0, 1, -3])).astype(np.float32)
    light = np.float32([0.5, 5.0, -1.0])
    oris, dirs, wins = [], [], []
    for _ in range(4):
        d = (light + rng.randn(3) * 0.4)[None] - hp
        if case == "shared":
            d = rng.randn(n, 3)
        w = np.linalg.norm(d, axis=1)
        d = (d / w[:, None]).astype(np.float32)
        oris.append(hp if case == "shared" else (hp + d * 1e-3))
        dirs.append(d)
        wins.append((w - 1e-3 if case != "shared"
                     else np.full(n, 1.2)).astype(np.float32))
    act = rng.rand(n) > 0.35 if case == "active" else None
    monkeypatch.setenv("ORT_FORCE_MXU", "1")
    monkeypatch.setattr(bm, "SHADOW_PACK", True)
    packed = []
    real = bm._trace_shadow_packed
    monkeypatch.setattr(bm, "_trace_shadow_packed",
                        lambda *a: packed.append(1) or real(*a))
    jo = [jnp.asarray(o) for o in oris]
    if case == "shared":
        jo = [jo[0]] * 4
    want = np.asarray(bm.trace_bvh_shadow_mxu_paged(
        pages, tuple(jo), tuple(jnp.asarray(d) for d in dirs),
        tuple(jnp.asarray(w) for w in wins),
        active=None if act is None else jnp.asarray(act))).astype(bool)
    jax.clear_caches()
    assert packed  # the lane-packed kernel ran
    got = _any_batches(arrays, [_t(o) for o in oris], [_t(d) for d in dirs],
                       [_t(w) for w in wins],
                       active=None if act is None else _t(act))
    if act is not None:
        want = want & act[None]
    assert got.shape == (4, n) and 0.05 < got.float().mean() < 0.95
    np.testing.assert_array_equal(got.numpy(), want)


def test_walks_match_packet_kernels(scene):
    """K7a/K7b (`trace_bvh_packet`, `trace_bvh_shadow_packet`, scalar
    packet walks over the same BVHArrays) in interpret mode against the
    port's trace_closest and plain any-hit walk on the CPU."""
    from opengl_raytracing_tpu.experiments import bvh_pallas
    tris, jarrays, arrays = scene
    ro, rd = _rays(9, 512)
    h = bvh_cuda.trace_closest(arrays, _t(ro), _t(rd))
    jh = bvh_pallas.trace_bvh_packet(jarrays, jnp.asarray(ro),
                                     jnp.asarray(rd))
    valid = h.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jh.valid))
    assert 0.1 < valid.mean() < 0.9
    np.testing.assert_allclose(h.t.numpy()[valid], np.asarray(jh.t)[valid],
                               rtol=1e-5, atol=1e-5)
    near, tri_n = _tied_normals(tris, ro, rd, h.t, 1e-5, 1e-5)
    jn = torch.from_numpy(np.array(jh.n))
    flip = (h.n - jn).abs().amax(-1) > 1e-5
    ok = ((tri_n - jn[:, None]).abs().amax(-1) <= 1e-5) & near
    assert bool((near.sum(-1)[flip] >= 2).all())
    assert bool(ok[flip].any(-1).all())

    t_max = np.random.RandomState(9).uniform(-1, 4, 512).astype(np.float32)
    occ = tbt.trace_bvh_shadow(arrays, _t(ro), _t(rd), _t(t_max)).numpy()
    want = np.asarray(bvh_pallas.trace_bvh_shadow_packet(
        jarrays, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, want)
    assert 0.05 < occ.mean() < 0.95
