"""What the BVH walk kernels of csrc/bvh_trace.cu compute for themselves,
held on the CPU to the plain versions they replace, and those plain
versions to the JAX package.

The kernels cannot run here, so their per-pixel arithmetic is transcribed
to numpy, reading every constant from the argument structs that
ops/bvh_cuda.py builds for the launch (`ao_args`, `bounce_args`) and from
the parameter block `ao_args` points to (tests/torch_param_block.py):

* the AO kernel's samples (ambient_occlusion_kernel): the rand pair at
  offsets 37i+3 and 19i+11, the cosine-hemisphere direction around the
  normalised normal and the biased origin, against lighting._ao_rays; the
  remap of a pixel's count against lighting._ao_value;
* the bounce kernel's ray (trace_bounce_kernel): the rand pair at offsets
  float32(seed*19) and float32(seed*41), the direction, its cosine and the
  origin, against lighting._bounce_ray;
* the closest-hit kernels' finished hit (t, p = o + d*t, the unit normal)
  against bvh_traverse._finalize.

All bit for bit.  cos, sin and sqrt come from the library the plain
version calls: numpy's float32 cos and sin round an ulp apart from
torch's, and torch's vectorised CPU sqrt is not always correctly rounded
(numpy's is).  On the card the kernels' IEEE sqrtf and cosf/sinf are
held to torch's by tests/test_torch_cuda.py.

The plain versions `ambient_occlusion_plain` and `gi_bounce_plain` equal
the composition they replaced exactly, and the wrappers' CPU route (those
plain versions) meets the JAX package's compute_ao and one_bounce_gi_bvh
at 48x64 on the goldens' bunny, frames 0 and 7, with no mask, a partial
one and one with no live lane, to tests/test_torch_gi_ao.py's tolerances:
AO occlusion counts equal but on tie lanes (at most 0.5% of them, one
sample each), GI within 1e-4 on the lanes the frame keeps but on tie
lanes (at most 0.5%).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models.pipeline import primary_rays
from opengl_raytracing_tpu.models.pipeline import _sanitize_hit as jsanitize
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh

from opengl_raytracing_tpu_torch.constants import (BVH_ALBEDO, EPS,
                                                   GI_MAX_LUM,
                                                   GI_MIN_COS_THETA, PI,
                                                   YCOEFF)
from opengl_raytracing_tpu_torch.convert import bvh_from_numpy, params_from
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.models.pipeline import pixel_centers
from opengl_raytracing_tpu_torch.ops import bvh_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.bvh_traverse import (_finalize,
                                                          trace_bvh,
                                                          trace_bvh_shadow)
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.sampling import (FrameValue, frame_record,
                                                  rand,
                                                  sample_hemisphere_cosine)
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

from torch_param_block import block_at

torch.set_num_threads(2)

H, W = 48, 64
F32 = np.float32
M32 = 0xFFFFFFFF
WRAP = 2 ** 31 // 1663 + 5  # frame * 1663 wraps int32 here
EDGE_FRAC = 5e-3            # lanes a one-ulp ray direction may flip


# ---- numpy transcription of the kernels' per-pixel arithmetic ----

def _lcg(v):
    return v * np.uint32(1664525) + np.uint32(1013904223)


def _hash2(vx, vy):
    vx, vy = _lcg(vx), _lcg(vy)
    vx = vx ^ (vy >> np.uint32(16))
    vy = vy ^ (vx << np.uint32(5))
    return _lcg(vx) ^ _lcg(vy)


def _rand(x, y, key):
    """sampling.cuh rand01 with the xor keys (kx, ky)."""
    ux = np.maximum(x, F32(0.0)).astype(np.uint32) ^ np.uint32(key[0])
    uy = np.maximum(y, F32(0.0)).astype(np.uint32) ^ np.uint32(key[1])
    return _hash2(ux, uy).astype(F32) / F32(4294967296.0)


def _value(record, affine):
    """sampling.cuh frame_value: the uint32 bits of int32(index * a + b)
    of the frame record's index."""
    return ((int(record[0]) & M32) * affine.a + affine.b) & M32


def _keys(bits):
    """sampling.rand's xor keys of a frame value (key_y)."""
    return bits, (bits * 1663) & M32


def _f32(bits):
    """sampling.cuh frame_f32: float32 of the int32 of `bits`."""
    return F32(bits - (1 << 32) if bits >> 31 else bits)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(a):
    ln = np.maximum(_lib("sqrt", np.maximum(_dot(a, a), F32(0.0))),
                    F32(1e-12))
    return a / ln[..., None]


def _lib(fn, x):
    """cos, sin or sqrt as the plain version computes them (torch,
    float32)."""
    return getattr(torch, fn)(
        torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _hemisphere(n, ux, uy, two_pi):
    """sampling.cuh hemisphere_cosine, with build_onb (its basis taken as
    (+0, +0, 1) and (1, +0, +0) where nn is (+0, 1, +0) exactly)."""
    phi = F32(two_pi) * ux
    r = _lib("sqrt", uy)
    x, z = r * _lib("cos", phi), r * _lib("sin", phi)
    y = _lib("sqrt", np.maximum(F32(1.0) - uy, F32(0.0)))
    nn = _norm(n)
    up = np.where((np.abs(nn[..., 1]) < F32(0.99))[..., None],
                  F32([0.0, 1.0, 0.0]), F32([1.0, 0.0, 0.0]))
    t = _norm(_cross(up, nn))
    b = _cross(nn, t)
    bits = nn.view(np.uint32)
    floor = ((bits[..., 0] == 0) & (nn[..., 1] == F32(1.0))
             & (bits[..., 2] == 0))[..., None]
    t = np.where(floor, F32([0.0, 0.0, 1.0]), t)
    b = np.where(floor, F32([1.0, 0.0, 0.0]), b)
    return _norm((t * x[..., None] + b * z[..., None]) + nn * y[..., None])


def kernel_ao_samples(a, record, p, n, px, py):
    """ambient_occlusion_kernel's origin and its [(ux, uy, direction)] per
    sample, for every pixel."""
    nn = _norm(n)
    key = _keys(_value(record, a.fi))
    out = []
    for s in range(a.samples):
        o1, o2 = F32(37 * s + 3), F32(19 * s + 11)
        ux = _rand(px + o1, py + o1, key)
        uy = _rand(py + o2, px + o2, key)
        out.append((ux, uy, _hemisphere(nn, ux, uy, a.two_pi)))
    return p + nn * F32(block_at(a.prm)["ao_bias"]), out


def kernel_ao_value(a, count):
    block = block_at(a.prm)
    ao = F32(1.0) - F32(count) / F32(a.samples)
    return np.minimum(np.maximum(F32(block["ao_min"]) + F32(block["ao_span"])
                                 * ao, F32(block["ao_min"])), F32(1.0))


def kernel_bounce_ray(b, record, p, n, px, py):
    """trace_bounce_kernel's (ux, uy, origin, wi, cos) for every pixel."""
    key = _keys(_value(record, b.rng))
    seed = _value(record, b.seed)
    so, so2 = _f32((seed * 19) & M32), _f32((seed * 41) & M32)
    ux = _rand(px + so, py + so, key)
    uy = _rand(py + so2, px + so2, key)
    n0 = _norm(n)
    wi = _hemisphere(n0, ux, uy, b.two_pi)
    cos = np.maximum(_dot(n0, wi), F32(0.0))
    return ux, uy, p + n0 * F32(b.eps), wi, cos


def kernel_hit(o, d, t, n_best):
    """closest_hit_out: t, p = o + d*t, the unit normal (zero on a miss)."""
    hit = t < F32(1e30)
    n = np.where(hit[..., None], _norm(n_best), F32(0.0))
    return t, o + d * t[..., None], n


def _hits(seed):
    """Points anywhere and raw normals of any length and direction (the
    ONB's up-is-x branch and a zero normal included), on an H x W grid."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(-3.0, 3.0, (H, W, 3)).astype(F32)
    n = (rng.randn(H, W, 3) * 3.0).astype(F32)
    n[0, :8] = [0.0, 2.0, 0.0]
    n[1, :8] = [0.05, -0.999, 0.0]
    n[2, :4] = 0.0
    h = tsa.Hit(torch.ones(H, W), torch.from_numpy(p), torch.from_numpy(n),
                torch.ones(H, W, dtype=torch.int32))
    return h, p, n


def _grids(row_offset):
    px, py = pixel_centers(H, W, "cpu", row_offset)
    return px, py, np.ascontiguousarray(px.numpy()), \
        np.ascontiguousarray(py.numpy())


@pytest.mark.parametrize("frame_index,row_offset,samples", [
    (0, 0, 4), (7, 0, 4), (1024, 517, 7), (WRAP, 0, 1)])
def test_kernel_ao_samples_match_plain(frame_index, row_offset, samples):
    params = preset("full").replace(ao_samples=samples)
    fv = FrameValue.of(frame_index, "cpu")
    a, record = bvh_cuda.ao_args(params, fv)
    h, p, n = _hits(frame_index % 97)
    px, py, npx, npy = _grids(row_offset)
    org, smp = kernel_ao_samples(a, record, p, n, npx, npy)
    want_org, want_dirs = tlt._ao_rays(h, fv, px, py, params)
    np.testing.assert_array_equal(org, want_org.numpy())
    assert len(smp) == len(want_dirs) == samples
    for s, ((ux, uy, d), wd) in enumerate(zip(smp, want_dirs)):
        o1, o2 = float(37 * s + 3), float(19 * s + 11)
        np.testing.assert_array_equal(
            ux, rand(px + o1, py + o1, fv).numpy())
        np.testing.assert_array_equal(
            uy, rand(py + o2, px + o2, fv).numpy())
        np.testing.assert_array_equal(d, wd.numpy())
    assert np.abs(smp[0][2]).max() > 0.5


@pytest.mark.parametrize("index,spp,s", [(0, 1, 0), (9, 4, 2), (WRAP, 1, 0)])
def test_kernels_sample_the_device_frame(index, spp, s):
    """The frame's own form: the AO and bounce kernels' rays from
    FrameValues of one record (frame_index the record's index, the seed
    index * spp + s) against the plain rays of the same device frame and
    of the host ints, each in a record of its own, bit for bit."""
    record = frame_record(index, "cpu")
    frame = FrameValue(record)
    seed = frame * spp + s
    params = preset("full")
    h, p, n = _hits(index % 83)
    px, py, npx, npy = _grids(0)
    a, got = bvh_cuda.ao_args(params, frame)
    assert got is record
    org, smp = kernel_ao_samples(a, record, p, n, npx, npy)
    for fi in (frame, FrameValue.of(index, "cpu")):
        want_org, want_dirs = tlt._ao_rays(h, fi, px, py, params)
        np.testing.assert_array_equal(org, want_org.numpy())
        for (_, _, d), wd in zip(smp, want_dirs):
            np.testing.assert_array_equal(d, wd.numpy())
    b, got = bvh_cuda.bounce_args(frame, seed)
    assert got is record
    ux, uy, org, wi, cos = kernel_bounce_ray(b, record, p, n, npx, npy)
    for rng, sd in ((frame, seed), (FrameValue.of(index, "cpu"),
                                    FrameValue.of(index * spp + s, "cpu"))):
        want_org, want_wi, want_cos = tlt._bounce_ray(h, rng, sd, px, py)
        np.testing.assert_array_equal(org, want_org.numpy())
        np.testing.assert_array_equal(wi, want_wi.numpy())
        np.testing.assert_array_equal(cos, want_cos.numpy())


@pytest.mark.parametrize("samples", [1, 4, 7])
def test_kernel_ao_value_matches_plain(samples):
    """A pixel's count c of S samples, remapped, for every c and two
    ao_min values."""
    for ao_min in (0.5, 0.13):
        params = preset("full").replace(ao_samples=samples, ao_min=ao_min)
        a, _ = bvh_cuda.ao_args(params, FrameValue.of(0, "cpu"))
        occ = torch.arange(samples)[:, None] < torch.arange(samples + 1)
        want = tlt._ao_value(occ, params).numpy()
        got = np.array([kernel_ao_value(a, c) for c in range(samples + 1)])
        np.testing.assert_array_equal(got, want)
        assert got[0] == 1.0 and got[-1] == np.float32(ao_min)


@pytest.mark.parametrize("rng_frame,seed,row_offset", [
    (0, 0, 0), (5, 5, 0), (1023, 1023, 517), (WRAP, 3 * 131 + 17, 0)])
def test_kernel_bounce_ray_matches_plain(rng_frame, seed, row_offset):
    rng = FrameValue.of(rng_frame, "cpu")
    seed_v = rng * 0 + seed  # a constant of the record: (0, seed)
    b, record = bvh_cuda.bounce_args(rng, seed_v)
    h, p, n = _hits(seed % 89)
    px, py, npx, npy = _grids(row_offset)
    ux, uy, org, wi, cos = kernel_bounce_ray(b, record, p, n, npx, npy)
    so, so2 = float(np.float32(seed * 19)), float(np.float32(seed * 41))
    np.testing.assert_array_equal(ux,
                                  rand(px + so, py + so, rng).numpy())
    np.testing.assert_array_equal(uy,
                                  rand(py + so2, px + so2, rng).numpy())
    want_org, want_wi, want_cos = tlt._bounce_ray(h, rng, seed_v, px, py)
    np.testing.assert_array_equal(org, want_org.numpy())
    np.testing.assert_array_equal(wi, want_wi.numpy())
    np.testing.assert_array_equal(cos, want_cos.numpy())
    assert (cos > 0.0).mean() > 0.9
    # the plain direction is sample_hemisphere_cosine's own
    np.testing.assert_array_equal(
        wi, sample_hemisphere_cosine(tlt.normalize(h.n), torch.from_numpy(ux),
                                     torch.from_numpy(uy)).numpy())


def test_kernel_hit_matches_finalize():
    """The closest-hit kernels write _finalize's hit: misses keep
    p = o + d*1e30 and a zero normal, hits the unit normal."""
    rng = np.random.RandomState(3)
    o = rng.randn(512, 3).astype(F32)
    d = rng.randn(512, 3).astype(F32)
    t = rng.uniform(0.0, 9.0, 512).astype(F32)
    t[::3] = F32(1e30)
    nb = (rng.randn(512, 3) * 0.01).astype(F32)
    want = _finalize(torch.Size([512]), torch.from_numpy(o),
                     torch.from_numpy(d), torch.from_numpy(t),
                     torch.from_numpy(nb))
    for got, w in zip(kernel_hit(o, d, t, nb), (want.t, want.p, want.n)):
        np.testing.assert_array_equal(got, w.numpy())
    assert (want.n[::3] == 0).all() and (want.p[::3].abs() > 1e20).any()


# ---- the plain versions and the wrappers' CPU route ----

def _jfin(cam):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.zeros(2, jnp.float32), curr_view_proj=jnp.asarray(vp),
        prev_view_proj=jnp.asarray(vp), camera_moved=jnp.int32(0))


@pytest.fixture(scope="module")
def bunny():
    """The goldens' bunny (make_bunny(2), the camera at fov 12 on it):
    sanitized primary hits from the JAX walker, both scene contexts of
    the `full` preset, the pixel centres."""
    cam = JCamera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    jbvh = jprepare_bvh(tris)
    bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x) for x in jbvh.arrays)),
                         "cpu")
    jparams = jpreset("full")
    jscene = JSceneCtx.create(jparams, jnp.asarray(cam.position),
                              use_bvh=True, bvh=jbvh)
    scene = SceneCtx.create(params_from(jparams),
                            torch.from_numpy(np.asarray(cam.position)),
                            use_bvh=True, bvh=bvh)
    px, py, rd = primary_rays(H, W, _jfin(cam), jparams)
    ro = jnp.broadcast_to(jnp.asarray(cam.position), rd.shape)
    jh_raw = jscene.trace(ro, rd)
    hit = np.asarray(jh_raw.valid)
    assert 0.2 < hit.mean() < 0.95
    jh = jsanitize(jh_raw, ro, rd)
    return dict(jscene=jscene, scene=scene, jh=jh, hit=hit,
                h=tsa.Hit(*(torch.from_numpy(np.array(x)) for x in jh)),
                px=np.array(px), py=np.array(py))


def _mask(f, kind):
    """(the torch mask or None, the JAX mask or None, the lanes compared)."""
    hit = f["hit"]
    if kind == "none":
        return None, None, np.ones_like(hit)
    m = hit & (np.random.RandomState(2).rand(*hit.shape) < 0.6) \
        if kind == "partial" else np.zeros_like(hit)
    return torch.from_numpy(m), jnp.asarray(m), m


def _pr4_ao(scene, h, frame_index, px, py, active):
    """compute_ao's BVH branch as it was before its kernel: the four
    hemisphere batches as one any-hit stream of the plain walk."""
    params = scene.params.host  # the RenderParams of the scene's block
    n = tlt.normalize(h.n)
    dirs = []
    for i in range(params.ao_samples):
        o1, o2 = float(37 * i + 3), float(19 * i + 11)
        ux = rand(px + o1, py + o1, frame_index)
        uy = rand(py + o2, px + o2, frame_index)
        dirs.append(sample_hemisphere_cosine(n, ux, uy))
    org = h.p + n * float(np.float32(params.ao_bias))
    radius = float(np.float32(params.ao_radius))
    shape = h.t.shape
    occ = trace_bvh_shadow(
        scene.bvh.arrays,
        torch.cat([org.reshape(-1, 3)] * len(dirs)),
        torch.cat([d.reshape(-1, 3) for d in dirs]),
        torch.full((len(dirs) * shape.numel(),), radius))
    occ = occ.reshape((len(dirs),) + shape)
    if active is not None:
        occ = occ & active
    occluded = occ.to(torch.float32).sum(0)
    ao_min = float(np.float32(params.ao_min))
    ao = 1.0 - occluded / float(params.ao_samples)
    return torch.clamp(ao_min + float(np.float32(1.0 - ao_min)) * ao, ao_min,
                       1.0)


def _pr4_gi(scene, h0, rng_frame, seed, frame_index, px, py, active):
    """one_bounce_gi_bvh as it was before its kernel: the bounce ray in
    PyTorch, the closest-hit walk with `active`, the same tail (`seed` the
    host int of the sample offsets)."""
    so, so2 = float(np.float32(seed * 19)), float(np.float32(seed * 41))
    ux = rand(px + so, py + so, rng_frame)
    uy = rand(py + so2, px + so2, rng_frame)
    n0 = tlt.normalize(h0.n)
    wi = sample_hemisphere_cosine(n0, ux, uy)
    cos_theta = torch.clamp_min(tlt.dot(n0, wi), 0.0)
    h1 = trace_bvh(scene.bvh.arrays, h0.p + n0 * EPS, wi, active=active)
    act1 = h1.valid if active is None else (active & h1.valid)
    li_hit = tlt.direct_light_bvh_plain(scene, h1, rng_frame, frame_index,
                                        -wi, px, py, active=act1)
    li = torch.where(h1.valid[..., None], li_hit, scene.sky(wi))
    contrib = torch.tensor(BVH_ALBEDO) * (cos_theta / PI)[..., None] * li
    lum = tlt.dot(contrib, torch.tensor(YCOEFF))
    scale = torch.where(lum > GI_MAX_LUM,
                        GI_MAX_LUM / torch.clamp_min(lum, 1e-6), 1.0)
    contrib = contrib * scale[..., None]
    return torch.where((cos_theta > GI_MIN_COS_THETA)[..., None], contrib,
                       0.0)


@pytest.mark.parametrize("mask", ["none", "partial", "none_live"])
def test_plain_versions_equal_the_composition_they_replace(bunny, mask):
    """ambient_occlusion_plain and gi_bounce_plain (through compute_ao and
    one_bounce_gi_bvh on CPU tensors) equal the PyTorch composition they
    replaced, on every lane; no kernel launch is counted."""
    f = bunny
    scene, h = f["scene"], f["h"]
    px, py = torch.from_numpy(f["px"]), torch.from_numpy(f["py"])
    active, _, _ = _mask(f, mask)
    before = dict(cuda_lib.LAUNCHES)
    three = FrameValue.of(3, "cpu")
    ao = tlt.compute_ao(scene, h, three, px, py, active=active)
    gi = tlt.one_bounce_gi_bvh(scene, h, three, three, three, px, py,
                               active=active)
    assert cuda_lib.LAUNCHES == before
    assert torch.equal(ao, _pr4_ao(scene, h, three, px, py, active))
    assert torch.equal(gi, _pr4_gi(scene, h, three, 3, three, px, py,
                                   active))
    assert bool(torch.isfinite(gi).all()) and bool(torch.isfinite(ao).all())


def _ao_counts(ao, params):
    return np.rint((1.0 - (ao - params.ao_min) / (1.0 - params.ao_min))
                   * params.ao_samples).astype(int)


@pytest.mark.parametrize("mask", ["none", "partial", "none_live"])
@pytest.mark.parametrize("frame_index", [0, 7])
def test_ambient_occlusion_wrapper_matches_jax(bunny, frame_index, mask):
    f = bunny
    scene, params = f["scene"], f["scene"].params.host
    active, jactive, lanes = _mask(f, mask)
    px, py = torch.from_numpy(f["px"]), torch.from_numpy(f["py"])
    got = bvh_cuda.ambient_occlusion(scene.bvh.arrays, f["h"],
                                     FrameValue.of(frame_index, "cpu"), px,
                                     py, params, active).numpy()
    assert np.isfinite(got).all() and got.shape == (H, W)
    if not lanes.any():
        return
    want = np.asarray(jlt.compute_ao(f["jscene"], f["jh"],
                                     jnp.int32(frame_index),
                                     jnp.asarray(f["px"]),
                                     jnp.asarray(f["py"]), active=jactive))
    cg, cw = _ao_counts(got[lanes], params), _ao_counts(want[lanes], params)
    np.testing.assert_allclose(got[lanes], params.ao_min + (1 - params.ao_min)
                               * (1 - cg / params.ao_samples), atol=1e-6)
    tie = cg != cw
    assert tie.mean() <= EDGE_FRAC and (np.abs(cg - cw)[tie] == 1).all()
    hit = lanes & f["hit"]
    assert (_ao_counts(got[hit], params) > 0).sum() >= 3


@pytest.mark.parametrize("mask", ["none", "partial", "none_live"])
@pytest.mark.parametrize("frame_index", [0, 7])
def test_gi_bounce_wrapper_matches_jax(bunny, frame_index, mask):
    """one_bounce_gi_bvh through trace_bounce on CPU tensors against the
    JAX package's, on the kept lanes (the mask's, or every hit)."""
    f = bunny
    fi = frame_index
    active, jactive, lanes = _mask(f, mask)
    px, py = torch.from_numpy(f["px"]), torch.from_numpy(f["py"])
    fv = FrameValue.of(fi, "cpu")
    got = tlt.one_bounce_gi_bvh(f["scene"], f["h"], fv, fv, fv, px, py,
                                active=active).numpy()
    assert np.isfinite(got).all()
    kept = lanes & f["hit"]
    if not kept.any():
        return
    want = np.asarray(jlt.one_bounce_gi_bvh(
        f["jscene"], f["jh"], jnp.int32(fi), jnp.int32(fi), jnp.int32(fi),
        jnp.asarray(f["px"]), jnp.asarray(f["py"]), active=jactive))
    bad = (np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)).any(-1) & kept
    assert bad.sum() <= EDGE_FRAC * kept.sum(), bad.sum()
    assert (got[kept] > 1e-3).any(-1).mean() > 0.2  # light bounces in
