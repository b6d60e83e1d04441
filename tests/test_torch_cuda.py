"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where no card is present.  The
file imports no JAX, so it also runs where JAX is not installed; on the
card machine run it without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernels are built with --fmad=false and evaluate the plain versions'
expressions in the same order.  The BVH walks then give equal hit masks
and occlusion, and t within 1e-6.  The direct-light kernels differ from
PyTorch only in the library's pow: radiance is held to rtol 1e-4 /
atol 1e-5 on the lanes whose hit is valid (the value of a miss lane is
garbage that the callers' select drops; the kernels must still finish on
it).  The SVGF kernel sums its 49 taps in the plain filter's order with
the same expf: rtol 1e-5 / atol 1e-5 on every pixel.
"""

import numpy as np
import pytest
import torch

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.constants import EPS
from opengl_raytracing_tpu_torch.convert import camera_frame_inputs
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.models.pipeline import (_sanitize_hit,
                                                         primary_rays)
from opengl_raytracing_tpu_torch.ops import (an_cuda, bvh_cuda, cuda_lib,
                                             svgf_cuda)
from opengl_raytracing_tpu_torch.ops import bvh_traverse as plain
from opengl_raytracing_tpu_torch.ops import lighting as lt
from opengl_raytracing_tpu_torch.ops.svgf import svgf_filter
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx, prepare_bvh
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.ops.vecmath import normalize, reflect
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

pytestmark = pytest.mark.cuda

N = 1 << 16


@pytest.fixture(scope="module")
def bvh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tris = gather_triangles(make_bunny(3),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    return prepare_bvh(tris, "cuda").arrays


def _rays(seed):
    rng = np.random.RandomState(seed)
    ro = rng.uniform((-5.0, -1.0, -3.0), (1.0, 4.0, 3.0), (N, 3))
    aim = rng.uniform((-2.6, 0.9, -0.7), (-1.4, 2.1, 0.7), (N, 3))
    rd = np.where(np.arange(N)[:, None] < N // 2, aim - ro, rng.randn(N, 3))
    rd[:64, 0] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.from_numpy(x.astype(np.float32)).cuda() for x in (ro, rd))


def test_closest_kernel_matches_plain(bvh):
    ro, rd = _rays(0)
    before = bvh_cuda.LAUNCHES["closest"]
    h = bvh_cuda.trace_closest(bvh, ro, rd)
    assert bvh_cuda.LAUNCHES["closest"] == before + 1
    hp = plain.trace_bvh(bvh, ro, rd)
    assert torch.equal(h.valid, hp.valid) and h.valid.float().mean() > 0.2
    v = hp.valid
    torch.testing.assert_close(h.t[v], hp.t[v], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h.n, hp.n, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h.p[v], hp.p[v], rtol=1e-5, atol=1e-5)


def test_any_kernel_matches_plain_with_batches_and_active(bvh):
    ro, rd = _rays(1)
    t_max = torch.rand(N, device="cuda") * 5 - 1
    k = 4
    batches = [x.reshape(k, N // k, *x.shape[1:]) for x in (ro, rd, t_max)]
    active = torch.rand(N // k, device="cuda") < 0.8
    before = bvh_cuda.LAUNCHES["any"]
    occ = bvh_cuda.trace_any(bvh, tuple(batches[0]), tuple(batches[1]),
                             tuple(batches[2]), active=active)
    assert bvh_cuda.LAUNCHES["any"] == before + 1
    want = plain.trace_bvh_shadow(bvh, ro, rd, t_max).reshape(k, N // k)
    assert torch.equal(occ, want & active)
    assert 0.05 < want.float().mean() < 0.95


def test_wrappers_reject_bad_inputs(bvh):
    ro, rd = _rays(2)
    with pytest.raises(TypeError):
        bvh_cuda.trace_closest(bvh, ro.double(), rd.double())
    with pytest.raises(ValueError):
        bvh_cuda.trace_closest(bvh, ro, rd.cpu())


TOL = dict(rtol=1e-4, atol=1e-5)


def _analytic(params, height=96, width=128):
    """The analytic scene's primary hits of the default camera on the card,
    with the pixel centers and view directions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cam = Camera()
    cam.aspect = width / height
    fin = camera_frame_inputs(cam, "cuda")
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=False)
    px, py, rd = primary_rays(height, width, fin, params)
    ro = fin.cam_pos.expand(rd.shape)
    h = scene.trace(ro, rd)
    return scene, h, _sanitize_hit(h, ro, rd), px, py, -rd


def _random_hits(n, seed):
    """Hits anywhere in the scene box with any normal and material id."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, 3, generator=g) * torch.tensor([6.0, 4.0, 8.0]) \
        - torch.tensor([3.0, 0.0, 7.0])
    nrm = torch.randn(n, 3, generator=g)
    mat = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)
    v = torch.randn(n, 3, generator=g)
    px = torch.rand(n, generator=g) * 800
    py = torch.rand(n, generator=g) * 600
    return (Hit(torch.ones(n).cuda(), p.cuda(), nrm.cuda(), mat.cuda()),
            v.cuda(), px.cuda(), py.cuda())


@pytest.mark.parametrize("change", [dict(), dict(sun_enabled=0),
                                    dict(point_light_enabled=0,
                                         sky_enabled=0)])
def test_an_direct_kernel_matches_plain(change):
    params = preset("baseline").replace(**change)
    scene, _, h, px, py, vdir = _analytic(params)
    before = cuda_lib.LAUNCHES["an_direct"]
    got = an_cuda.direct_light(scene, h, 3, 3, vdir, px, py)
    assert cuda_lib.LAUNCHES["an_direct"] == before + 1
    want = lt.direct_light_plain(scene, h, 3, 3, vdir, px, py)
    torch.testing.assert_close(got, want, **TOL)
    assert want.std() > 0.01
    hr, v, rpx, rpy = _random_hits(1 << 14, 0)
    torch.testing.assert_close(
        an_cuda.direct_light(scene, hr, 7, 7, v, rpx, rpy),
        lt.direct_light_plain(scene, hr, 7, 7, v, rpx, rpy), **TOL)


def test_an_direct_kernel_on_unsanitized_secondary_hits():
    """The mirror's reflected rays, misses included (p = ro + rd * 1e30):
    the kernel finishes, and agrees with the plain version on hits."""
    scene, _, h, px, py, vdir = _analytic(preset("baseline"))
    r = reflect(-normalize(vdir), normalize(h.n))
    h2 = scene.trace(h.p + r * EPS, r)
    assert 0.05 < h2.valid.float().mean() < 0.95
    got = an_cuda.direct_light(scene, h2, 1, 1, -r, px, py)
    torch.cuda.synchronize()
    want = lt.direct_light_plain(scene, h2, 1, 1, -r, px, py)
    torch.testing.assert_close(got[h2.valid], want[h2.valid], **TOL)


@pytest.mark.parametrize("change", [dict(), dict(sun_enabled=0),
                                    dict(point_light_enabled=0)])
def test_bvh_brdf_kernel_matches_plain(change):
    params = preset("baseline").replace(**change)
    scene, _, h, px, py, vdir = _analytic(params)
    n, v = normalize(h.n), normalize(vdir)
    offs = lt._disk_offsets(2, 2, px, py)
    k = 4 + int(bool(params.sun_enabled)) + int(
        bool(params.point_light_enabled))
    occ = torch.rand((k,) + h.t.shape, device="cuda") < 0.3
    before = cuda_lib.LAUNCHES["bvh_brdf"]
    got = an_cuda.shade_bvh_brdf(scene, h, n, v, offs, occ)
    got_u8 = an_cuda.shade_bvh_brdf(scene, h, n, v, offs,
                                    occ.to(torch.uint8))
    assert cuda_lib.LAUNCHES["bvh_brdf"] == before + 2
    want = lt.shade_bvh_brdf_plain(scene, h, n, v, offs, occ)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, got_u8)


def test_direct_light_bvh_uses_both_kernels(bvh):
    """The BVH frame's direct light on the card (the any-hit kernel, then
    the BRDF kernel on its bytes) against the same call on the CPU (the
    plain walk and the plain tail), on the hit lanes."""
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    from opengl_raytracing_tpu_torch.scene.bvh import BVHArrays
    params = preset("baseline")
    cam = Camera()
    cam.aspect = 128 / 96
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    out = {}
    for dev in ("cuda", "cpu"):
        fin = camera_frame_inputs(cam, dev)
        arrays = BVHArrays(*(x.to(dev) for x in bvh))
        scene = SceneCtx.create(params, fin.cam_pos, use_bvh=True,
                                bvh=BVHDevice(arrays))
        px, py, rd = primary_rays(96, 128, fin, params)
        ro = fin.cam_pos.expand(rd.shape)
        h_raw = scene.trace(ro, rd)
        before = dict(cuda_lib.LAUNCHES)
        out[dev] = (lt.direct_light_bvh(scene, _sanitize_hit(h_raw, ro, rd),
                                        0, 0, -rd, px, py,
                                        active=h_raw.valid).cpu(),
                    h_raw.valid.cpu())
        grew = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
        assert grew["any"] == grew["bvh_brdf"] == (dev == "cuda")
    (got, hit), (want, hit_cpu) = out["cuda"], out["cpu"]
    assert torch.equal(hit, hit_cpu) and 0.2 < hit.float().mean() < 0.9
    torch.testing.assert_close(got[hit], want[hit], **TOL)


def test_an_wrappers_reject_bad_inputs():
    scene, _, h, px, py, vdir = _analytic(preset("baseline"), 8, 8)
    with pytest.raises(TypeError):
        an_cuda.direct_light(scene, Hit(h.t, h.p.double(), h.n, h.mat), 0,
                             0, vdir, px, py)
    with pytest.raises(ValueError):
        an_cuda.direct_light(scene, h, 0, 0, vdir, px.cpu(), py.cpu())
    n, v = normalize(h.n), normalize(vdir)
    offs = lt._disk_offsets(0, 0, px, py)
    occ = torch.zeros((6,) + h.t.shape, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        an_cuda.shade_bvh_brdf(scene, h, n, v, offs, occ[:5])
    with pytest.raises(TypeError):
        an_cuda.shade_bvh_brdf(scene, h, n, v, offs, occ.float())
    with pytest.raises(ValueError):
        an_cuda.shade_bvh_brdf(scene, h, n, v.cpu(), offs, occ)


def test_closest_kernel_active_lanes(bvh):
    """Inactive lanes do not walk and read as misses; active lanes get the
    plain walk's hit."""
    ro, rd = _rays(3)
    active = torch.rand(N, device="cuda") < 0.5
    before = bvh_cuda.LAUNCHES["closest"]
    h = bvh_cuda.trace_closest(bvh, ro, rd, active=active)
    assert bvh_cuda.LAUNCHES["closest"] == before + 1
    hp = plain.trace_bvh(bvh, ro, rd, active=active)
    assert torch.equal(h.valid, hp.valid) and not h.valid[~active].any()
    v = hp.valid
    torch.testing.assert_close(h.t[v], hp.t[v], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h.n, hp.n, rtol=1e-5, atol=1e-5)


SVGF_TOL = dict(rtol=1e-5, atol=1e-5)


def _svgf_inputs(h, w, seed, sky=0.0):
    """accum, motion, gpos, gnrm on the card; a `sky` share of the pixels
    have zero position and normal, as the frame writes them."""
    g = torch.Generator().manual_seed(seed)
    col = 0.5 + 0.3 * torch.randn(h, w, 3, generator=g)
    lum = col @ torch.tensor([0.299, 0.587, 0.114])
    m2 = lum * lum + 0.08 * torch.rand(h, w, generator=g)
    accum = torch.cat([col, m2[..., None]], -1)
    motion = 0.04 * torch.randn(h, w, 2, generator=g)
    gpos = torch.randn(h, w, 3, generator=g)
    gnrm = 2.0 * torch.randn(h, w, 3, generator=g)
    is_sky = torch.rand(h, w, generator=g) < sky
    gpos[is_sky] = 0.0
    gnrm[is_sky] = 0.0
    return tuple(x.cuda() for x in (accum, motion, gpos, gnrm))


@pytest.mark.parametrize("size", [(37, 131), (1080, 1920)])
@pytest.mark.parametrize("sky", [0.0, 0.3, 1.0])
def test_svgf_kernel_matches_plain(size, sky):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = preset("full")
    inputs = _svgf_inputs(*size, seed=int(sky * 10), sky=sky)
    before = cuda_lib.LAUNCHES["svgf"]
    got = svgf_cuda.svgf_filter(*inputs, params)
    assert cuda_lib.LAUNCHES["svgf"] == before + 1
    want = svgf_filter(*inputs, params)
    assert got.shape == size + (3,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **SVGF_TOL)


@pytest.mark.parametrize("change", [
    dict(svgf_var_max=0.01), dict(svgf_k_var=2.5), dict(svgf_k_color=0.4),
    dict(svgf_k_var_motion=0.2), dict(svgf_k_color_motion=3.0)])
def test_svgf_kernel_parameters(change):
    """Each svgf_* parameter moved away from its default reaches the
    kernel by value: the kernel still matches the plain filter, and where
    the parameter can change the image it does.  (The k_var pair only
    scales the variance boost, which multiplies every tap's weight alike
    and cancels in the normalised sum.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _svgf_inputs(61, 97, seed=5, sky=0.2)
    params = preset("full").replace(**change)
    got = svgf_cuda.svgf_filter(*inputs, params)
    torch.testing.assert_close(got, svgf_filter(*inputs, params), **SVGF_TOL)
    base = svgf_cuda.svgf_filter(*inputs, preset("full"))
    if "k_var" not in next(iter(change)):
        assert float((got - base).abs().max()) > 1e-4


def test_svgf_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    accum, motion, gpos, gnrm = _svgf_inputs(8, 8, seed=0)
    params = preset("full")
    with pytest.raises(ValueError, match="shape"):
        svgf_cuda.svgf_filter(accum[..., :3].contiguous(), motion, gpos,
                              gnrm, params)
    with pytest.raises(ValueError):
        svgf_cuda.svgf_filter(accum, motion, gpos.cpu(), gnrm, params)
    with pytest.raises(TypeError):
        svgf_cuda.svgf_filter(accum, motion.double(), gpos, gnrm, params)
