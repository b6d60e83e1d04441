"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where no card is present.  The
file imports no JAX, so it also runs where JAX is not installed; on the
card machine run it without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernels are built with --fmad=false and evaluate the plain versions'
expressions in the same order.  The closest-hit kernel then returns the
plain walk's hits bit for bit (its GI bounce call also the sampled
direction), and the AO kernel the plain AO on live lanes, but for a
grazing walk that may flip one sample (at most 1e-3 of live lanes, by one
sample step).  The direct-light kernels compute
their disk offsets in the kernel, held bit for bit to
lighting._disk_offsets through the wrappers' `offsets_out`, and differ
from PyTorch only in the library's pow: radiance is held to max abs 2e-6
(K3) and 1e-6 (the BVH direct light) on frames, and to rtol 1e-4 /
atol 1e-5 everywhere, on the lanes whose radiance the caller keeps (the
value of a miss or inactive lane is dropped by the callers' select; the
kernels must still finish on it).  The SVGF kernel sums its 49 taps in
the plain filter's order with the same expf: rtol 1e-5 / atol 1e-5 on
every pixel, and bit for bit along the seams of its blocks; on the row
bands of an image with their halo rows, bit for bit against the plain
band filter and, stitched, against its own whole-image output.  Its fused
entry (the whole present pass) and the tonemap kernel repeat the plain
present pass's tail; only their powf may round the last bits of the gamma
curve apart from PyTorch's pow: max abs 2e-6 on every pixel.
"""

import ctypes

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
from opengl_raytracing_tpu_torch.ops.svgf import (_half_texel, present,
                                                  present_plain, svgf_filter)
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx, prepare_bvh
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.ops.vecmath import normalize, reflect
from opengl_raytracing_tpu_torch.sampling import FrameValue
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

from torch_param_block import seeded_values

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


def _assert_same_hit(h, hp):
    for name in ("t", "p", "n", "mat"):
        assert torch.equal(getattr(h, name), getattr(hp, name)), name


def test_closest_kernel_matches_plain(bvh):
    """K1's primary call returns the plain walk's hit bit for bit: t, the
    point and the unit normal it finishes itself."""
    ro, rd = _rays(0)
    before = bvh_cuda.LAUNCHES["closest"]
    h = bvh_cuda.trace_closest(bvh, ro, rd)
    assert bvh_cuda.LAUNCHES["closest"] == before + 1
    hp = plain.trace_bvh(bvh, ro, rd)
    assert h.valid.float().mean() > 0.2
    _assert_same_hit(h, hp)


def test_closest_kernel_reads_a_broadcast_origin(bvh):
    """One origin for every ray (the primary call's camera) is read in
    place, as row step 0, with the same hits."""
    ro = torch.tensor([-2.2, 1.6, 3.0], device="cuda")
    aim = torch.rand(N, 3, device="cuda") * torch.tensor(
        [1.2, 1.2, 1.4], device="cuda") + torch.tensor([-2.6, 0.9, -0.7],
                                                       device="cuda")
    rd = normalize(aim - ro)
    h = bvh_cuda.trace_closest(bvh, ro.expand(rd.shape), rd)
    _assert_same_hit(h, plain.trace_bvh(bvh, ro.expand(rd.shape), rd))
    assert 0.05 < h.valid.float().mean() < 0.95


def test_wrappers_reject_bad_inputs(bvh):
    ro, rd = _rays(2)
    with pytest.raises(TypeError):
        bvh_cuda.trace_closest(bvh, ro.double(), rd.double())
    with pytest.raises(ValueError):
        bvh_cuda.trace_closest(bvh, ro, rd.cpu())


TOL = dict(rtol=1e-4, atol=1e-5)
K3_MAX_ABS = 2e-6        # K3 vs direct_light_plain: the libraries' powf
BVH_DIRECT_MAX_ABS = 1e-6  # bvh_direct vs direct_light_bvh_plain, live lanes
WRAP = 2 ** 31 // 1663 + 5  # frame * 1663 wraps int32 here
FRAMES = [(0, 0), (1, 1), (7, 7), (1023, 1023), (1024, 1024), (WRAP, WRAP)]
SIZES = [(37, 131), (1080, 1920)]


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


def _bvh_frame(bvh, params, height=96, width=128):
    """The BVH scene's primary hits with the camera on the bunny (it fills
    about a third of the frame): scene, raw hit, sanitized hit, px, py,
    vdir."""
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    cam = Camera()
    cam.aspect = width / height
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    fin = camera_frame_inputs(cam, "cuda")
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=True,
                            bvh=BVHDevice(bvh))
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


def _grew(before):
    return {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}


def _fv(rng_frame, frame_index, device="cuda"):
    """Host frame numbers as the frame hands them to the kernels: (rng
    frame, frame index) as FrameValues of one record on `device`, the
    frame index its own and the rng frame a constant of it."""
    frame = FrameValue.of(frame_index, device)
    return frame * 0 + rng_frame, frame


def _want_offsets(rng_frame, frame_index, px, py, shape):
    return torch.stack([c.expand(shape).reshape(-1) for dxy in
                        lt._disk_offsets(rng_frame, frame_index, px, py)
                        for c in dxy])


def _an_direct(scene, h, rng_frame, frame_index, vdir, px, py,
               live=None, max_abs=K3_MAX_ABS):
    """K3 against direct_light_plain: one launch, the in-kernel disk
    offsets bit for bit, radiance within `max_abs` on `live` lanes (all
    by default) and within TOL; returns the kernel's radiance."""
    rng_frame, frame_index = _fv(rng_frame, frame_index)
    offs = torch.full((8, h.t.numel()), float("nan"), device="cuda")
    before = dict(cuda_lib.LAUNCHES)
    got = an_cuda.direct_light(scene, h, rng_frame, frame_index, vdir, px,
                               py, offsets_out=offs)
    assert _grew(before) == {**{k: 0 for k in before}, "an_direct": 1}
    torch.cuda.synchronize()
    assert torch.equal(offs, _want_offsets(rng_frame, frame_index, px, py,
                                           h.t.shape))
    want = lt.direct_light_plain(scene, h, rng_frame, frame_index, vdir, px,
                                 py)
    live = torch.ones_like(h.t, dtype=torch.bool) if live is None else live
    torch.testing.assert_close(got[live], want[live], **TOL)
    if max_abs is not None:
        err = (got - want)[live].abs()
        assert float(err.max()) <= max_abs, float(err.max())
    return got


def _bvh_direct(scene, h, rng_frame, frame_index, vdir, px, py, active,
                live=None):
    """bvh_direct against direct_light_bvh_plain: one launch, the disk
    offsets bit for bit, radiance within BVH_DIRECT_MAX_ABS on the live
    lanes (`live`, else `active`, else all; the others are unspecified);
    returns the kernel's radiance."""
    rng_frame, frame_index = _fv(rng_frame, frame_index)
    offs = torch.full((8, h.t.numel()), float("nan"), device="cuda")
    before = dict(cuda_lib.LAUNCHES)
    got = an_cuda.direct_light_bvh(scene, h, rng_frame, frame_index, vdir,
                                   px, py, active, offsets_out=offs)
    assert _grew(before) == {**{k: 0 for k in before}, "bvh_direct": 1}
    torch.cuda.synchronize()
    assert torch.equal(offs, _want_offsets(rng_frame, frame_index, px, py,
                                           h.t.shape))
    want = lt.direct_light_bvh_plain(scene, h, rng_frame, frame_index, vdir,
                                     px, py, active)
    if live is None:
        live = (torch.ones_like(h.t, dtype=torch.bool) if active is None
                else active)
    if bool(live.any()):
        err = (got - want)[live].abs()
        assert float(err.max()) <= BVH_DIRECT_MAX_ABS, float(err.max())
    return got


@pytest.mark.parametrize("change", [dict(), dict(sun_enabled=0),
                                    dict(point_light_enabled=0,
                                         sky_enabled=0)])
def test_an_direct_kernel_matches_plain(change):
    params = preset("baseline").replace(**change)
    scene, _, h, px, py, vdir = _analytic(params)
    got = _an_direct(scene, h, 3, 3, vdir, px, py)
    assert got.std() > 0.01
    # anywhere in the scene box, up to the point light's hot spot: the
    # relative tolerance alone
    hr, v, rpx, rpy = _random_hits(1 << 14, 0)
    _an_direct(scene, hr, 7, 7, v, rpx, rpy, max_abs=None)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("rng_frame,frame_index", FRAMES)
def test_an_direct_kernel_frames(size, rng_frame, frame_index):
    """K3 on a whole frame's primary hits at each frame counter, the
    in-kernel disk offsets bit for bit."""
    scene, _, h, px, py, vdir = _analytic(preset("baseline"), *size)
    _an_direct(scene, h, rng_frame, frame_index, vdir, px, py)


@pytest.mark.parametrize("change", [
    dict(mat_glass_enabled=0), dict(mat_mirror_enabled=0),
    dict(mat_glass_enabled=0, mat_mirror_enabled=0),
    dict(point_light_enabled=0), dict(sun_enabled=0, sky_enabled=0),
    dict(mat_albedo_color=(0.3, 0.6, 0.2), mat_mirror_color=(0.9, 0.8, 0.6),
         mat_glass_color=(0.7, 0.9, 0.8))])
@pytest.mark.parametrize("size", SIZES)
def test_an_direct_kernel_materials_and_lights(change, size):
    """Mirror and glass pixels (and the toggles that shade them as
    diffuse), each light switched off."""
    scene, _, h, px, py, vdir = _analytic(
        preset("baseline").replace(**change), *size)
    mats = set(h.mat.unique().tolist())
    assert {0, 1, 2, 3} <= mats
    _an_direct(scene, h, 5, 5, vdir, px, py)


def test_an_direct_kernel_on_unsanitized_secondary_hits():
    """The mirror's reflected rays, misses included (p = ro + rd * 1e30):
    the kernel finishes, and agrees with the plain version on hits."""
    scene, _, h, px, py, vdir = _analytic(preset("baseline"))
    r = reflect(-normalize(vdir), normalize(h.n))
    h2 = scene.trace(h.p + r * EPS, r)
    assert 0.05 < h2.valid.float().mean() < 0.95
    _an_direct(scene, h2, 1, 1, -r, px, py, live=h2.valid)


def _env_table(f, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(6, f, f, 3, generator=g) * 2.0).cuda()  # HDR too


@pytest.mark.parametrize("f", [1, 8, 64])
@pytest.mark.parametrize("size", SIZES)
def test_an_direct_kernel_samples_the_cubemap(f, size):
    """K3 with an environment map: the kernel samples the cubemap on its
    mirror and glass lanes (csrc/cubemap.cuh), within K3's gate of the plain
    version, whose sky is `sample_cubemap`; the map shows on those lanes and
    on no other."""
    params = preset("baseline").replace(env_map_intensity=0.8)
    scene, _, h, px, py, vdir = _analytic(params, *size)
    env = _env_table(f, seed=f)
    with_env = SceneCtx.create(params, scene.cam_pos, env_map=env)
    got = _an_direct(with_env, h, 3, 3, vdir, px, py)
    grad = an_cuda.direct_light(scene, h, *_fv(3, 3), vdir, px, py)
    env_lanes = h.mat.eq(2) | h.mat.eq(3)
    assert int(env_lanes.sum()) > 20
    assert float((got - grad)[env_lanes].abs().max()) > 0.05
    assert torch.equal(got[~env_lanes], grad[~env_lanes])


def test_an_direct_kernel_cubemap_directions():
    """Mirror lanes whose reflected view lies on a face diagonal, a face
    edge or an axis: the kernel picks the plain version's face and taps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = preset("baseline")
    n = 1 << 12
    g = torch.Generator().manual_seed(1)
    signs = torch.randint(0, 2, (n, 3), generator=g) * 2.0 - 1.0
    mags = torch.tensor([[1, 1, 1], [1, 1, 0.3], [1, 0.3, 1], [0.3, 1, 1],
                         [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5],
                         [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0.875, 0.25],
                         [0.125, 1, 1]])[torch.arange(n) % 12]
    r = normalize(signs * mags)
    # a mirror lane looking along its normal reflects straight back: r = n
    h = Hit(torch.ones(n).cuda(), torch.zeros(n, 3).cuda(), r.cuda(),
            torch.full((n,), 3, dtype=torch.int32).cuda())
    px = (torch.arange(n) % 64 + 0.5).cuda()
    py = (torch.arange(n) // 64 + 0.5).cuda()
    for f in (1, 8):
        scene = SceneCtx.create(params, torch.zeros(3).cuda(),
                                env_map=_env_table(f, seed=2))
        got = _an_direct(scene, h, 2, 2, r.cuda(), px, py)
        assert got.std() > 0.05


def test_an_direct_kernel_null_map_is_the_gradient_bit_for_bit():
    """Without a map, with the map disabled, and on the BVH direct light
    (which reads no sky of a direction) the result is what it was before
    the kernel learned the cubemap: equal bits."""
    params = preset("baseline")
    scene, _, h, px, py, vdir = _analytic(params)
    base = an_cuda.direct_light(scene, h, *_fv(4, 4), vdir, px, py)
    off = SceneCtx.create(params.replace(enable_env_map=0), scene.cam_pos,
                          env_map=_env_table(8))
    assert torch.equal(an_cuda.direct_light(off, h, *_fv(4, 4), vdir, px,
                                            py), base)
    # the in-kernel gradient against the plain gradient sky on env lanes
    mirror = h.mat.eq(3)
    want = lt.direct_light_plain(scene, h, *_fv(4, 4), vdir, px, py)
    assert float((base - want)[mirror].abs().max()) <= K3_MAX_ABS


def test_a_card_tensor_with_a_map_never_reaches_the_plain_version(
        monkeypatch):
    """With a map given, a CUDA tensor goes through the kernel, which
    samples the map: neither the plain version, nor the plain sampler, nor
    the gradient stands in."""
    params = preset("baseline")
    scene, _, h, px, py, vdir = _analytic(params)
    env = _env_table(8, seed=3)
    with_env = SceneCtx.create(params, scene.cam_pos, env_map=env)
    want = lt.direct_light_plain(with_env, h, *_fv(6, 6), vdir, px, py)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")
    from opengl_raytracing_tpu_torch.ops import cubemap, scene_analytic
    monkeypatch.setattr(lt, "direct_light_plain", refuse)
    monkeypatch.setattr(cubemap, "sample_cubemap", refuse)
    monkeypatch.setattr(scene_analytic, "sample_cubemap", refuse)
    before = dict(cuda_lib.LAUNCHES)
    got = lt.direct_light(with_env, h, *_fv(6, 6), vdir, px, py)
    assert _grew(before)["an_direct"] == 1
    assert float((got - want).abs().max()) <= K3_MAX_ABS
    # a table the kernel cannot read raises; nothing falls back
    bad = SceneCtx.create(params, scene.cam_pos, env_map=env)
    object.__setattr__(bad, "env_map", env.double())
    with pytest.raises(TypeError, match="env_map"):
        an_cuda.direct_light(bad, h, *_fv(6, 6), vdir, px, py)
    object.__setattr__(bad, "env_map", env.cpu())
    with pytest.raises(ValueError, match="env_map"):
        an_cuda.direct_light(bad, h, *_fv(6, 6), vdir, px, py)


def _grid_layout(x, layout):
    """The [H, W] pixel grid `x` (a broadcast row or column) in another
    memory layout, with the same values."""
    if layout == "contiguous":
        return x.contiguous()
    if layout == "transposed":  # column-major storage
        return x.t().contiguous().t()
    # [2, H, W] from a [H, 2, W] storage: the leading dims do not fold
    return torch.stack([x, x], 1).permute(1, 0, 2)


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "unfoldable"])
def test_direct_light_kernels_pixel_grid_layouts(bvh, layout):
    """The kernels read the pixel grids in place through their strides
    (a broadcast grid, as the frame passes it, everywhere else); other
    layouts give the same offsets and radiance."""
    params = preset("baseline")
    for kind in ("analytic", "bvh"):
        scene, h_raw, h, px, py, vdir = (
            _analytic(params, 37, 131) if kind == "analytic"
            else _bvh_frame(bvh, params, 37, 131))
        gx, gy = _grid_layout(px, layout), _grid_layout(py, layout)
        if layout == "unfoldable":
            h, h_raw = (Hit(*(x.expand((2,) + x.shape) for x in hit))
                        for hit in (h, h_raw))
            vdir = vdir.expand((2,) + vdir.shape)
        if kind == "analytic":
            _an_direct(scene, h, 4, 4, vdir, gx, gy)
        else:
            _bvh_direct(scene, h, 4, 4, vdir, gx, gy, h_raw.valid)


@pytest.mark.parametrize("change", [dict(), dict(sun_enabled=0),
                                    dict(point_light_enabled=0)])
def test_bvh_brdf_kernel_matches_plain(bvh, change):
    """The BVH direct light (K5 with its shadow walks) against the plain
    version on the bunny frame's hits, with each light switched off."""
    params = preset("baseline").replace(**change)
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, params)
    hit = h_raw.valid
    got = _bvh_direct(scene, h, 2, 2, vdir, px, py, hit)
    want = lt.direct_light_bvh_plain(scene, h, *_fv(2, 2), vdir, px, py, hit)
    torch.testing.assert_close(got[hit], want[hit], **TOL)
    assert got[hit].std() > 0.01


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("rng_frame,frame_index", FRAMES)
def test_bvh_direct_kernel_frames(bvh, size, rng_frame, frame_index):
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, preset("baseline"),
                                               *size)
    _bvh_direct(scene, h, rng_frame, frame_index, vdir, px, py, h_raw.valid)


@pytest.mark.parametrize("mask", ["none", "partial", "none_live"])
@pytest.mark.parametrize("change", [dict(), dict(sun_enabled=0,
                                                 point_light_enabled=0)])
def test_bvh_direct_kernel_active(bvh, mask, change):
    """`active` None (every lane walks, sky lanes included), a random part
    of the hit lanes, or no lane at all."""
    scene, h_raw, h, px, py, vdir = _bvh_frame(
        bvh, preset("baseline").replace(**change), 1080, 1920)
    g = torch.Generator(device="cuda").manual_seed(4)
    active = {"none": None,
              "partial": h_raw.valid & (torch.rand(h.t.shape, device="cuda",
                                                   generator=g) < 0.5),
              "none_live": torch.zeros_like(h_raw.valid)}[mask]
    _bvh_direct(scene, h, 6, 6, vdir, px, py, active)


@pytest.mark.parametrize("size", SIZES)
def test_bvh_direct_kernel_on_unsanitized_bounce_hits(bvh, size):
    """GI's bounce hits as one_bounce_gi_bvh hands them over: misses keep
    p = o + wi * 1e30 and are inactive; with `active` None every lane is
    walked and the kernel still finishes.  Few bounces hit the bunny
    again (about 0.1% of the frame), so few lanes are live."""
    from opengl_raytracing_tpu_torch.sampling import (rand,
                                                      sample_hemisphere_cosine)
    params = preset("full")
    scene, h_raw, h, px, py, _ = _bvh_frame(bvh, params, *size)
    n0 = normalize(h.n)
    three = FrameValue.of(3, "cuda")
    wi = sample_hemisphere_cosine(n0, rand(px + 19.0, py + 19.0, three),
                                  rand(py + 41.0, px + 41.0, three))
    h1 = scene.trace(h.p + n0 * EPS, wi, active=h_raw.valid)
    act1 = h_raw.valid & h1.valid
    assert 0 < int(act1.sum()) < int(h_raw.valid.sum())
    _bvh_direct(scene, h1, 3, 3, -wi, px, py, act1)
    _bvh_direct(scene, h1, 3, 3, -wi, px, py, None, live=act1)


def test_direct_light_bvh_uses_both_kernels(bvh):
    """lighting.direct_light_bvh on the card is one bvh_direct launch and
    no other (the walks are inside it); against the same call on the CPU
    (the plain walk and the plain tail), on the hit lanes."""
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
                                        *_fv(0, 0, dev), -rd, px, py,
                                        active=h_raw.valid).cpu(),
                    h_raw.valid.cpu())
        grew = _grew(before)
        assert grew == {**{k: 0 for k in grew},
                        "bvh_direct": int(dev == "cuda")}
    (got, hit), (want, hit_cpu) = out["cuda"], out["cpu"]
    assert torch.equal(hit, hit_cpu) and 0.2 < hit.float().mean() < 0.9
    torch.testing.assert_close(got[hit], want[hit], **TOL)


def test_an_wrappers_reject_bad_inputs(bvh):
    scene, _, h, px, py, vdir = _analytic(preset("baseline"), 8, 8)
    with pytest.raises(TypeError):
        an_cuda.direct_light(scene, Hit(h.t, h.p.double(), h.n, h.mat),
                             *_fv(0, 0), vdir, px, py)
    with pytest.raises(ValueError):
        an_cuda.direct_light(scene, h, *_fv(0, 0), vdir, px.cpu(), py.cpu())
    with pytest.raises(TypeError):
        an_cuda.direct_light(scene, Hit(h.t, h.p, h.n, h.mat.long()),
                             *_fv(0, 0), vdir, px, py)
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, preset("baseline"), 8, 8)
    with pytest.raises(ValueError, match="shape"):
        an_cuda.direct_light_bvh(scene, h, *_fv(0, 0), vdir, px, py,
                                 offsets_out=torch.empty(7, 64,
                                                         device="cuda"))
    with pytest.raises(TypeError):
        an_cuda.direct_light_bvh(scene, h, *_fv(0, 0), vdir, px, py,
                                 active=h_raw.valid.float())
    with pytest.raises(ValueError):
        an_cuda.direct_light_bvh(scene, h, *_fv(0, 0), vdir.cpu(), px, py)


def test_closest_kernel_active_lanes(bvh):
    """Inactive lanes do not walk and read as misses; active lanes get the
    plain walk's hit, bit for bit."""
    ro, rd = _rays(3)
    active = torch.rand(N, device="cuda") < 0.5
    before = bvh_cuda.LAUNCHES["closest"]
    h = bvh_cuda.trace_closest(bvh, ro, rd, active=active)
    assert bvh_cuda.LAUNCHES["closest"] == before + 1
    hp = plain.trace_bvh(bvh, ro, rd, active=active)
    _assert_same_hit(h, hp)
    assert not h.valid[~active].any()


AO_SAMPLES = [1, 4, 7]
MASKS = ["none", "partial", "none_live"]
FLIP_FRAC = 1e-3  # live AO lanes that may differ, by one sample step


def _mask(kind, hit):
    g = torch.Generator(device="cuda").manual_seed(4)
    return {"none": None,
            "partial": hit & (torch.rand(hit.shape, device="cuda",
                                         generator=g) < 0.5),
            "none_live": torch.zeros_like(hit)}[kind]


def _ao_check(bvh, scene, h, px, py, params, active, frame_index=3):
    """The AO kernel against ambient_occlusion_plain: one launch, AO equal
    on the live lanes but for at most FLIP_FRAC of them, which differ by
    exactly one sample step (a grazing walk that flips); NaN fails."""
    frame_index = FrameValue.of(frame_index, "cuda")
    before = dict(cuda_lib.LAUNCHES)
    got = bvh_cuda.ambient_occlusion(bvh, h, frame_index, px, py, params,
                                     active)
    assert _grew(before) == {**{k: 0 for k in before}, "ao": 1}
    want = lt.ambient_occlusion_plain(bvh, h, frame_index, px, py, params,
                                      active)
    live = torch.ones_like(h.t, dtype=torch.bool) if active is None \
        else active
    g, w = got[live], want[live]
    host = getattr(params, "host", params)
    step = (1.0 - host.ao_min) / host.ao_samples
    off = ~(g == w)
    assert int(off.sum()) <= FLIP_FRAC * max(int(live.sum()), 1)
    assert bool(((g[off] - w[off]).abs() - step).abs().le(1e-6).all())
    return got, want, live


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("samples", AO_SAMPLES)
@pytest.mark.parametrize("size", SIZES)
def test_ao_kernel_matches_plain(bvh, size, samples, mask):
    params = preset("full").replace(ao_samples=samples)
    scene, h_raw, h, px, py, _ = _bvh_frame(bvh, params, *size)
    got, want, live = _ao_check(bvh, scene, h, px, py, params,
                                _mask(mask, h_raw.valid))
    if bool(live.any()):
        assert float(want[live].min()) < 1.0  # some lanes are occluded


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("size", SIZES)
def test_bounce_kernel_matches_plain(bvh, size, mask):
    """K1's GI bounce call against gi_bounce_plain: wi and its cosine bit
    for bit on live lanes, `valid` equal on every lane (dead lanes are
    misses, with wi and cos zero), t, p and n bit for bit where both
    hit."""
    params = preset("full")
    scene, h_raw, h, px, py, _ = _bvh_frame(bvh, params, *size)
    active = _mask(mask, h_raw.valid)
    before = dict(cuda_lib.LAUNCHES)
    five = _fv(5, 5)
    h1, wi, cos = bvh_cuda.trace_bounce(bvh, h, *five, px, py, active)
    assert _grew(before) == {**{k: 0 for k in before}, "bounce": 1}
    hp, wip, cosp = lt.gi_bounce_plain(bvh, h, *five, px, py, active)
    live = torch.ones_like(h.t, dtype=torch.bool) if active is None \
        else active
    assert torch.equal(wi[live], wip[live]) and torch.equal(cos[live],
                                                            cosp[live])
    assert torch.equal(h1.valid, hp.valid)
    both = h1.valid & hp.valid
    for name in ("t", "p", "n"):
        assert torch.equal(getattr(h1, name)[both], getattr(hp, name)[both])
    for x in (h1.t, wi, cos):  # dead lanes too; their p, n are unwritten
        assert bool(torch.isfinite(x).all())
    assert bool(torch.isfinite(h1.p[live]).all())
    if mask != "none_live":
        assert 0 < int(both.sum()) < int(live.sum())


def test_walks_a_large_tree():
    """make_bunny(6): 81,920 triangles, 32,767 nodes, the size of the
    larger scenes the roadmap names.  K1's primary call and the AO kernel
    still match the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tris = gather_triangles(make_bunny(6),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    big = prepare_bvh(tris, "cuda").arrays
    assert big.bounds.shape[0] > 2048
    ro, rd = _rays(6)
    h = bvh_cuda.trace_closest(big, ro, rd)
    _assert_same_hit(h, plain.trace_bvh(big, ro, rd))
    assert h.valid.float().mean() > 0.2
    params = preset("full")
    scene, h_raw, hs, px, py, _ = _bvh_frame(big, params, 96, 128)
    _ao_check(big, scene, hs, px, py, params, h_raw.valid)


def test_gi_and_ao_calls_are_one_launch_each(bvh):
    """compute_ao (BVH) is one AO launch; one_bounce_gi_bvh is one bounce
    launch, one BVH direct-light launch at the bounce hits and one sky
    launch for the bounce's misses."""
    params = preset("full")
    scene, h_raw, h, px, py, _ = _bvh_frame(bvh, params)
    before = dict(cuda_lib.LAUNCHES)
    two = FrameValue.of(2, "cuda")
    ao = lt.compute_ao(scene, h, two, px, py, active=h_raw.valid)
    assert _grew(before) == {**{k: 0 for k in before}, "ao": 1}
    before = dict(cuda_lib.LAUNCHES)
    gi = lt.one_bounce_gi_bvh(scene, h, two, two, two, px, py,
                              active=h_raw.valid)
    assert _grew(before) == {**{k: 0 for k in before}, "bounce": 1,
                             "bvh_direct": 1, "sky": 1}
    hit = h_raw.valid
    assert bool(torch.isfinite(gi).all())
    assert bool(torch.isfinite(ao[hit]).all())


SPP = [2, 4]


def _batch(x, spp):
    return x.expand((spp,) + x.shape)


def _hit_batch(h, spp):
    return Hit(*(_batch(x, spp) for x in h))


@pytest.mark.parametrize("spp", SPP)
@pytest.mark.parametrize("size", SIZES)
def test_bvh_direct_kernel_on_a_sample_batch(bvh, size, spp):
    """The primary call of a frame's sample batch (spp_dup: one hit for
    every sample, the sun and point walks once a pixel): one launch, each
    sample's disk offsets bit for bit, radiance within BVH_DIRECT_MAX_ABS
    of the plain version (its dedup form) on live lanes, and each sample
    bit for bit the kernel's single-sample call with the seed
    frame * spp + s."""
    _sample_batch_check(bvh, size, spp)


def _sample_batch_check(bvh, size, spp):
    """test_bvh_direct_kernel_on_a_sample_batch's checks at `size` and
    `spp` samples."""
    params = preset("heavy").replace(spp_per_frame=spp)
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, params, *size)
    frame = FrameValue.of(7, "cuda")
    seeds = frame.sampled(spp)
    live = h_raw.valid
    args = (scene, _hit_batch(h, spp), seeds, frame, _batch(vdir, spp),
            _batch(px, spp), _batch(py, spp), _batch(live, spp))
    offs = torch.full((8, spp * h.t.numel()), float("nan"), device="cuda")
    before = dict(cuda_lib.LAUNCHES)
    got = an_cuda.direct_light_bvh(*args, offsets_out=offs, spp_dup=spp)
    assert _grew(before) == {**{k: 0 for k in before}, "bvh_direct": 1}
    torch.cuda.synchronize()
    assert torch.equal(offs, _want_offsets(seeds, frame, args[5], args[6],
                                           args[1].t.shape))
    want = lt.direct_light_bvh_plain(*args, spp_dup=spp)
    err = (got - want)[_batch(live, spp)].abs()
    assert float(err.max()) <= BVH_DIRECT_MAX_ABS, float(err.max())
    for s in range(spp):
        one = an_cuda.direct_light_bvh(scene, h, frame * spp + s, frame,
                                       vdir, px, py, live)
        assert torch.equal(got[s][live], one[live]), s
    assert float((got[0] - got[1])[live].abs().max()) > 1e-3



@pytest.mark.parametrize("spp", [8, 16])
def test_bvh_direct_kernel_at_8_and_16_samples(bvh, spp):
    """The primary call of an 8 and a 16 SPP batch (the app's F3 cycle
    reaches both): 34 and 66 windows a pixel, the kernel's list taking one
    sample a chunk; the checks of test_bvh_direct_kernel_on_a_sample_batch
    at 96x128."""
    _sample_batch_check(bvh, (96, 128), spp)


SENTINEL = -7.0  # what a test puts in `out` before the kernel runs


def _bvh_direct_into(scene, h, rng, frame, vdir, px, py, active, dup=1):
    """bvh_direct_kernel's launch as an_cuda.direct_light_bvh makes it,
    through the C entry, into a buffer of SENTINEL: returns it [N, 3], so
    a test sees which lanes the kernel wrote."""
    device = h.t.device
    shape = h.t.shape
    args, _keep_record = an_cuda.scene_args(scene, rng, frame,
                                            device=device)
    if dup > 1:
        rows, (act, _keep_act) = an_cuda._shared_rows(h, vdir, active, shape,
                                                      dup, device)
    else:
        rows = an_cuda._pixel_rows(h, vdir, device)
        act, _keep_act = cuda_lib.mask_bytes(active, shape, device)
    grid, _keep = cuda_lib.pixel_grid(px, py, shape, device,
                                      max(an_cuda.samples_of(rng), dup))
    tree = scene.bvh.arrays
    out = torch.full((h.t.numel(), 3), SENTINEL, device=device)
    cuda_lib.launch(an_cuda._library().ort_bvh_direct, "bvh_direct", device,
                    ctypes.byref(args), tree.bounds.data_ptr(),
                    tree.meta.data_ptr(), tree.tris.data_ptr(),
                    tree.bounds.shape[0], rows["p"].data_ptr(),
                    rows["n"].data_ptr(), rows["v"].data_ptr(),
                    ctypes.byref(grid), act, h.t.numel() // dup, dup,
                    out.data_ptr(), None)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("spp", [1, 4])
def test_bvh_direct_kernel_writes_no_dead_lane(bvh, spp):
    """An all-dead mask, at 1080p, one row a lane and with spp_dup: the
    kernel writes no lane, and `out` keeps its sentinel."""
    params = preset("heavy").replace(spp_per_frame=spp)
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, params, 1080, 1920)
    dead = torch.zeros_like(h_raw.valid)
    rng, frame = _fv(3, 3)
    if spp > 1:
        h, vdir, px, py, dead = (_hit_batch(h, spp), _batch(vdir, spp),
                                 _batch(px, spp), _batch(py, spp),
                                 _batch(dead, spp))
        rng = frame.sampled(spp)
    out = _bvh_direct_into(scene, h, rng, frame, vdir, px, py, dead, spp)
    assert bool((out == SENTINEL).all())


@pytest.mark.parametrize("size", SIZES)
def test_bvh_direct_kernel_one_live_pixel_in_the_last_lane(bvh, size):
    """One live row, the call's last: the last lane of the last unit (a
    partial unit at 37x131, lane 31 at 1080p).  Its radiance within
    BVH_DIRECT_MAX_ABS of the plain version; every other lane of `out`
    keeps its sentinel."""
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, preset("baseline"),
                                               *size)
    one = torch.zeros_like(h_raw.valid)
    one.view(-1)[-1] = True
    rng, frame = _fv(4, 4)
    out = _bvh_direct_into(scene, h, rng, frame, vdir, px, py, one)
    want = lt.direct_light_bvh_plain(scene, h, rng, frame, vdir, px, py, one)
    err = float((out.view(want.shape)[one] - want[one]).abs().max())
    assert err <= BVH_DIRECT_MAX_ABS, err
    got = an_cuda.direct_light_bvh(scene, h, rng, frame, vdir, px, py, one)
    assert torch.equal(got[one], out.view(want.shape)[one])
    assert bool((out[:-1] == SENTINEL).all())
    assert not bool((out[-1] == SENTINEL).any())


@pytest.mark.parametrize("fold", [False, True])
def test_bvh_direct_kernel_with_the_sun_below_the_horizon(bvh, fold):
    """The sun below the horizon (sun_pitch 90: its light travels up) and
    the point light off, against the plain version.  With `fold` every
    normal is turned up, so every sun window is gated shut and the list
    holds disk windows alone; without it the bunny's underside still
    faces the sun."""
    params = preset("baseline").replace(sun_pitch=90.0,
                                        point_light_enabled=0)
    scene, h_raw, h, px, py, vdir = _bvh_frame(bvh, params)
    if fold:
        n = h.n
        h = Hit(h.t, h.p, torch.stack([n[..., 0], n[..., 1].abs() + 1.0,
                                       n[..., 2]], -1), h.mat)
    offs = lt._disk_offsets(*_fv(2, 2), px, py)
    _, _, wins = lt._bvh_shadow_queries(scene, h, normalize(h.n), offs,
                                        h_raw.valid)
    assert len(wins) == 5  # four disk windows and the sun's
    sun_open = int((wins[4] > 0).sum())
    assert (sun_open == 0) if fold else (sun_open > 0)
    assert int((torch.stack(wins[:4]) > 0).sum()) > 0
    _bvh_direct(scene, h, 2, 2, vdir, px, py, h_raw.valid)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("spp", SPP)
def test_bounce_kernel_on_a_sample_batch(bvh, spp, shared):
    """GI's bounce call over every sample's rays in one launch, the hit
    rows read once a pixel (`shared`: the frame's broadcast hit) or a lane
    each: wi and cos bit for bit, valid equal, t, p and n bit for bit
    where both hit, against the plain version; each sample bit for bit the
    single-sample call."""
    params = preset("heavy").replace(spp_per_frame=spp)
    scene, h_raw, h, px, py, _ = _bvh_frame(bvh, params, 96, 128)
    frame = FrameValue.of(5, "cuda")
    seeds = frame.sampled(spp)
    h_b, act = _hit_batch(h, spp), _batch(h_raw.valid, spp)
    if not shared:
        h_b = Hit(*(x.contiguous() for x in h_b))
        act = act.contiguous()
    before = dict(cuda_lib.LAUNCHES)
    h1, wi, cos = bvh_cuda.trace_bounce(bvh, h_b, frame, seeds,
                                        _batch(px, spp), _batch(py, spp),
                                        act)
    assert _grew(before) == {**{k: 0 for k in before}, "bounce": 1}
    hp, wip, cosp = lt.gi_bounce_plain(bvh, h_b, frame, seeds,
                                       _batch(px, spp), _batch(py, spp), act)
    assert torch.equal(wi[act], wip[act]) and torch.equal(cos[act],
                                                          cosp[act])
    assert torch.equal(h1.valid, hp.valid)
    both = h1.valid & hp.valid
    for name in ("t", "p", "n"):
        assert torch.equal(getattr(h1, name)[both], getattr(hp, name)[both])
    for s in range(spp):
        one = bvh_cuda.trace_bounce(bvh, h, frame, frame * spp + s, px, py,
                                    h_raw.valid)
        assert torch.equal(h1.t[s], one[0].t), s
        assert torch.equal(wi[s], one[1]) and torch.equal(cos[s], one[2])
    assert not torch.equal(wi[0], wi[1])


@pytest.mark.parametrize("spp", SPP)
def test_an_direct_kernel_on_a_sample_batch(spp):
    """K3 on the analytic frame's sample batch: one launch, lane i's disk
    offsets those of sample i // (pixels a sample) bit for bit, K3's gate
    against the plain version, each sample bit for bit the single-sample
    call."""
    scene, _, h, px, py, vdir = _analytic(preset("baseline"))
    frame = FrameValue.of(6, "cuda")
    seeds = frame.sampled(spp)
    h_b = _hit_batch(h, spp)
    offs = torch.full((8, h_b.t.numel()), float("nan"), device="cuda")
    before = dict(cuda_lib.LAUNCHES)
    got = an_cuda.direct_light(scene, h_b, seeds, frame, _batch(vdir, spp),
                               _batch(px, spp), _batch(py, spp),
                               offsets_out=offs)
    assert _grew(before) == {**{k: 0 for k in before}, "an_direct": 1}
    torch.cuda.synchronize()
    assert torch.equal(offs, _want_offsets(seeds, frame, _batch(px, spp),
                                           _batch(py, spp), h_b.t.shape))
    want = lt.direct_light_plain(scene, h_b, seeds, frame,
                                 _batch(vdir, spp), _batch(px, spp),
                                 _batch(py, spp))
    assert float((got - want).abs().max()) <= K3_MAX_ABS
    for s in range(spp):
        one = an_cuda.direct_light(scene, h, frame * spp + s, frame, vdir,
                                   px, py)
        assert torch.equal(got[s], one), s


def _an_direct_into(scene, h, rng, frame, vdir, px, py, active):
    """an_direct_light_kernel's launch as an_cuda.direct_light makes it,
    through the C entry, into a buffer of SENTINEL: returns it [N, 3], so
    a test sees which lanes the kernel wrote."""
    device = h.t.device
    args, rows, _keep = an_cuda.direct_rows(scene, h, rng, frame, vdir, px,
                                            py, active, device)
    out = torch.full((h.t.numel(), 3), SENTINEL, device=device)
    cuda_lib.launch(an_cuda._library().ort_an_direct, "an_direct", device,
                    ctypes.byref(args), ctypes.byref(rows), h.t.numel(),
                    out.data_ptr(), None)
    torch.cuda.synchronize()
    return out


def _an_frame_mask(scene, h_raw, h):
    """The primary call's mask as the frame makes it: the hits, minus the
    marker, minus the mirror and glass lanes."""
    from opengl_raytracing_tpu_torch.models.pipeline import _material_lanes
    return h_raw.valid & _material_lanes(h.mat, scene.params)[0]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mask", ["frame", "half", "mirror_glass"])
def test_an_direct_kernel_masked_is_the_dense_call_on_live_lanes(size,
                                                                  mask):
    """K3 with a mask of live lanes: one launch, the dense call's
    (active=None) radiance bit for bit on the live lanes and K3's gate
    against the plain version there, the in-kernel offsets bit for bit on
    them; no other lane written.  Masks: the frame's primary one, every
    other lane, and the mirror and glass lanes alone (the env path)."""
    scene, h_raw, h, px, py, vdir = _analytic(preset("baseline"), *size)
    live = {"frame": _an_frame_mask(scene, h_raw, h),
            "half": (torch.arange(h.t.numel(), device="cuda")
                     % 2 == 0).reshape(h.t.shape),
            "mirror_glass": h.mat.eq(2) | h.mat.eq(3)}[mask]
    assert 0 < int(live.sum()) < h.t.numel()
    rng, frame = _fv(3, 3)
    dense = an_cuda.direct_light(scene, h, rng, frame, vdir, px, py)
    offs = torch.full((8, h.t.numel()), float("nan"), device="cuda")
    before = dict(cuda_lib.LAUNCHES)
    got = an_cuda.direct_light(scene, h, rng, frame, vdir, px, py, live,
                               offsets_out=offs)
    assert _grew(before) == {**{k: 0 for k in before}, "an_direct": 1}
    assert torch.equal(got[live], dense[live])
    want = lt.direct_light_plain(scene, h, rng, frame, vdir, px, py)
    assert float((got - want)[live].abs().max()) <= K3_MAX_ABS
    flat = live.reshape(-1)
    assert torch.equal(offs[:, flat], _want_offsets(
        rng, frame, px, py, h.t.shape)[:, flat])
    assert bool(offs[:, ~flat].isnan().all())
    out = _an_direct_into(scene, h, rng, frame, vdir, px, py, live)
    assert torch.equal(out[flat], dense.reshape(-1, 3)[flat])
    assert bool((out[~flat] == SENTINEL).all())


@pytest.mark.parametrize("spp", [1, 4])
def test_an_direct_kernel_writes_no_dead_lane(spp):
    """An all-dead mask at 1080p, a lane each and with the rows shared by
    the samples: the kernel writes no lane, and `out` keeps its
    sentinel."""
    scene, h_raw, h, px, py, vdir = _analytic(preset("full"), 1080, 1920)
    dead = torch.zeros_like(h_raw.valid)
    rng, frame = _fv(3, 3)
    if spp > 1:
        h, vdir, px, py, dead = (_hit_batch(h, spp), _batch(vdir, spp),
                                 _batch(px, spp), _batch(py, spp),
                                 _batch(dead, spp))
        rng = frame.sampled(spp)
    out = _an_direct_into(scene, h, rng, frame, vdir, px, py, dead)
    assert bool((out == SENTINEL).all())


@pytest.mark.parametrize("size", SIZES)
def test_an_direct_kernel_one_live_lane_in_the_last_unit(size):
    """One live lane, the call's last: the last lane of the last unit (a
    partial unit at 37x131, lane 31 at 1080p; a sanitized sky lane, shaded
    as the grey fallback's diffuse hit).  Its radiance within K3_MAX_ABS
    of the plain version and the dense call's bit for bit; every other
    lane of `out` keeps its sentinel."""
    scene, h_raw, h, px, py, vdir = _analytic(preset("baseline"), *size)
    one = torch.zeros_like(h_raw.valid)
    one.view(-1)[-1] = True
    rng, frame = _fv(4, 4)
    out = _an_direct_into(scene, h, rng, frame, vdir, px, py, one)
    want = lt.direct_light_plain(scene, h, rng, frame, vdir, px, py)
    err = float((out.view(want.shape)[one] - want[one]).abs().max())
    assert err <= K3_MAX_ABS, err
    dense = an_cuda.direct_light(scene, h, rng, frame, vdir, px, py)
    assert torch.equal(out[-1], dense.reshape(-1, 3)[-1])
    assert bool((out[:-1] == SENTINEL).all())


def test_an_direct_kernel_mirror_beside_diffuse_lanes_in_one_unit():
    """A unit whose live lanes are a mirror hit, a glass hit and diffuse
    hits around them (the env path and the diffuse path of one unit, each
    in its own round): each lane the dense call's bits and within
    K3_MAX_ABS of the plain version; the dead lanes of the unit keep the
    sentinel."""
    scene, h_raw, h, px, py, vdir = _analytic(preset("baseline"))
    mat = h.mat.reshape(-1)
    units = mat.reshape(-1, 32)
    mixed = ((units == 3).any(1) & (units == 0).any(1)).nonzero()
    assert mixed.numel() > 0
    u = int(mixed[0])
    lanes = torch.arange(32 * u, 32 * u + 32, device="cuda")
    keep = torch.zeros(h.t.numel(), dtype=torch.bool, device="cuda")
    keep[lanes[::3]] = True
    keep[lanes[mat[lanes] == 3][:1]] = True
    keep[lanes[mat[lanes] == 2][:1]] = True
    keep = keep.reshape(h.t.shape)
    flat = keep.reshape(-1)
    assert bool((mat[flat] == 3).any() & (mat[flat] == 0).any())
    rng, frame = _fv(5, 5)
    out = _an_direct_into(scene, h, rng, frame, vdir, px, py, keep)
    dense = an_cuda.direct_light(scene, h, rng, frame, vdir, px, py)
    want = lt.direct_light_plain(scene, h, rng, frame, vdir, px, py)
    assert torch.equal(out[flat], dense.reshape(-1, 3)[flat])
    assert float((out[flat] - want.reshape(-1, 3)[flat]).abs().max()) \
        <= K3_MAX_ABS
    assert bool((out[~flat] == SENTINEL).all())


@pytest.mark.parametrize("spp", SPP)
def test_an_direct_kernel_reads_a_broadcast_hit_once_a_pixel(spp):
    """The frame's primary call at spp samples: the hit, vdir and the mask
    broadcast over the sample axis are read once a pixel in place
    (direct_rows: shared rows); bit for bit the same call on contiguous
    copies (a row a lane), and each sample the single-sample call on its
    live lanes; K3's gate against the plain version there."""
    scene, h_raw, h, px, py, vdir = _analytic(preset("baseline"))
    frame = FrameValue.of(6, "cuda")
    seeds = frame.sampled(spp)
    live = _an_frame_mask(scene, h_raw, h)
    h_b, v_b, px_b, py_b, live_b = (_hit_batch(h, spp), _batch(vdir, spp),
                                    _batch(px, spp), _batch(py, spp),
                                    _batch(live, spp))
    _, rows, _keep = an_cuda.direct_rows(scene, h_b, seeds, frame, v_b,
                                         px_b, py_b, live_b, h.t.device)
    assert rows.shared == 1
    got = an_cuda.direct_light(scene, h_b, seeds, frame, v_b, px_b, py_b,
                               live_b)
    copies = [x.contiguous() for x in (*h_b, v_b, live_b)]
    _, rows_c, _keep_c = an_cuda.direct_rows(
        scene, Hit(*copies[:4]), seeds, frame, copies[4], px_b, py_b,
        copies[5], h.t.device)
    assert rows_c.shared == 0
    dense = an_cuda.direct_light(scene, Hit(*copies[:4]), seeds, frame,
                                 copies[4], px_b, py_b, copies[5])
    assert torch.equal(got[live_b], dense[live_b])
    want = lt.direct_light_plain(scene, h_b, seeds, frame, v_b, px_b, py_b)
    assert float((got - want)[live_b].abs().max()) <= K3_MAX_ABS
    for s in range(spp):
        one = an_cuda.direct_light(scene, h, frame * spp + s, frame, vdir,
                                   px, py, live)
        assert torch.equal(got[s][live], one[live]), s


@pytest.mark.parametrize("use_bvh", [True, False])
def test_batched_frame_is_its_samples_one_by_one(bvh, use_bvh):
    """trace_and_shade of a 4-sample frame on the card: bit for bit the
    four single-sample shadings of the same kernels summed in sample order
    and divided by 4; the BVH batch launches bvh_direct twice and the
    bounce once (the one-by-one form: 8 and 4)."""
    from opengl_raytracing_tpu_torch.models import pipeline
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    from opengl_raytracing_tpu_torch.params import bind
    params = bind(preset("heavy"), "cuda")
    cam = Camera()
    cam.aspect = 128 / 96
    if use_bvh:
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))
    fin = camera_frame_inputs(cam, "cuda", frame_index=3)
    scene = SceneCtx.create(params, fin.cam_pos, use_bvh=use_bvh,
                            bvh=BVHDevice(bvh) if use_bvh else None)
    px, py, rd = primary_rays(96, 128, fin, params)
    frame = fin.frame
    before = dict(cuda_lib.LAUNCHES)
    got = pipeline.trace_and_shade(scene, params, fin, px, py, rd, frame,
                                   use_bvh=use_bvh)[0]
    grew = _grew(before)
    if use_bvh:
        assert (grew["bvh_direct"], grew["bounce"], grew["ao"]) == (2, 1, 1)
    ro = fin.cam_pos.expand(rd.shape)
    h_raw = scene.trace(ro, rd)
    h = _sanitize_hit(h_raw, ro, rd)
    ao = lt.compute_ao(scene, h, frame, px, py,
                       active=h_raw.valid if use_bvh else None)
    total = None
    for s in range(4):
        seed = frame * 4 + s
        if use_bvh:
            one = pipeline._shade_bvh(scene, h, seed, frame, -rd, px, py,
                                      active=h_raw.valid, ao=ao)
        else:
            one = pipeline._shade_analytic(scene, h, seed, frame, -rd, px,
                                           py, ao=ao)
        one = torch.where(h_raw.valid[..., None], one, scene.sky(rd))
        total = one if total is None else total + one
    assert torch.equal(got, total / torch.full((), 4.0, device="cuda"))


def test_walk_wrappers_reject_bad_inputs(bvh):
    params = preset("full")
    scene, h_raw, h, px, py, _ = _bvh_frame(bvh, params, 8, 8)
    zero = FrameValue.of(0, "cuda")
    with pytest.raises(ValueError):
        bvh_cuda.trace_bounce(bvh, h, *_fv(0, 0), px.cpu(), py.cpu())
    with pytest.raises(TypeError):
        bvh_cuda.ambient_occlusion(bvh, Hit(h.t, h.p.double(), h.n, h.mat),
                                   zero, px, py, params)
    with pytest.raises(TypeError):
        bvh_cuda.ambient_occlusion(bvh, h, zero, px, py, params,
                                   active=h_raw.valid.float())
    with pytest.raises(ValueError, match="ao_samples"):
        bvh_cuda.ambient_occlusion(bvh, h, zero, px, py,
                                   params.replace(ao_samples=0))


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


PRESENT_SIZES = [(37, 131), (1, 1), (3, 300), (1080, 1920)]
# the kernels' powf against PyTorch's pow, at the end of the gamma curve
PRESENT_MAX_ABS = 2e-6


@pytest.mark.parametrize("size", PRESENT_SIZES)
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


def _assert_present(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= PRESENT_MAX_ABS, err
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("size", PRESENT_SIZES)
@pytest.mark.parametrize("sky", [0.0, 0.3, 1.0])
def test_present_kernels_match_plain(size, sky):
    """The fused entry (SVGF on) and the tonemap kernel (SVGF off) against
    the plain present pass, one launch each, the accumulation only read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _svgf_inputs(*size, seed=1 + int(sky * 10), sky=sky)
    inputs[0][..., :3] *= 2.0   # HDR, so ACES matters
    kept = inputs[0].clone()
    for params, key in ((preset("full"), "svgf_present"),
                        (preset("baseline"), "tonemap")):
        before = dict(cuda_lib.LAUNCHES)
        got = present(*inputs, params)
        after = dict(cuda_lib.LAUNCHES)
        assert after.pop(key) == before.pop(key) + 1 and after == before
        _assert_present(got, present_plain(*inputs, params))
        assert torch.equal(inputs[0], kept)


@pytest.mark.parametrize("change", [
    dict(svgf_var_max=0.01), dict(svgf_k_var=2.5), dict(svgf_k_color=0.4),
    dict(svgf_k_var_motion=0.2), dict(svgf_k_color_motion=3.0),
    dict(svgf_strength=0.0), dict(svgf_strength=1.0),
    dict(svgf_strength=1.7), dict(exposure=0.5), dict(exposure=2.0)])
def test_present_kernel_parameters(change):
    """Each parameter of the pass reaches the fused entry by value (the
    strength clamped to [0, 1] on the host); exposure the tonemap kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _svgf_inputs(61, 97, seed=5, sky=0.2)
    params = preset("full").replace(**change)
    got = svgf_cuda.svgf_present(*inputs, params)
    _assert_present(got, present_plain(*inputs, params))
    base = svgf_cuda.svgf_present(*inputs, preset("full"))
    if "k_var" not in next(iter(change)) and change != dict(svgf_strength=1.7):
        assert float((got - base).abs().max()) > 1e-4
    if change == dict(svgf_strength=1.7):
        assert torch.equal(got, svgf_cuda.svgf_present(
            *inputs, preset("full").replace(svgf_strength=1.0)))
    if change == dict(svgf_strength=0.0):  # the raw image, tonemapped
        _assert_present(got, svgf_cuda.tonemap(inputs[0], params))
    if "exposure" in change:
        off = params.replace(enable_svgf=0)
        _assert_present(svgf_cuda.tonemap(inputs[0], off),
                        present_plain(*inputs, off))


@pytest.mark.parametrize("svgf", [1, 0])
def test_present_half_texel_knob_on_the_card(monkeypatch, svgf):
    """ORT_PRESENT_HALF_TEXEL=1 shifts the pass's inputs in PyTorch before
    the one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _svgf_inputs(45, 70, seed=9, sky=0.2)
    params = preset("full").replace(enable_svgf=svgf)
    exact = present(*inputs, params)
    monkeypatch.setenv("ORT_PRESENT_HALF_TEXEL", "1")
    before = dict(cuda_lib.LAUNCHES)
    got = present(*inputs, params)
    key = "svgf_present" if svgf else "tonemap"
    after = dict(cuda_lib.LAUNCHES)
    assert after.pop(key) == before.pop(key) + 1 and after == before
    _assert_present(got, present_plain(*(_half_texel(x) for x in inputs),
                                       params))
    assert float((got - exact).abs().max()) > 1e-2
    if not svgf:
        assert torch.equal(got[:-1, :-1], exact[1:, 1:])


def test_svgf_block_seams_equal_plain_exactly():
    """Pixels on both sides of every seam between two blocks' output tiles
    (32 x 16 pixels; the interior body left and right, above and below, and
    the rim body against it), and the last pixels of a width that ends
    inside a run: the filter entry equals the plain filter bit for bit
    there, and the fused entry the plain present pass to its tolerance.

    The motion is still on the left half and fast on the right, so that
    its smoothstep is exactly 0 or 1: between them the kernel divides by
    0.045 where PyTorch on the card multiplies by its reciprocal (a
    division by a host scalar), an ulp apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, w = 115, 203
    inputs = _svgf_inputs(h, w, seed=21, sky=0.1)
    inputs[1][:, :w // 2] = 0.0
    inputs[1][:, w // 2:] = 0.2
    params = preset("full")
    got = svgf_cuda.svgf_filter(*inputs, params)
    want = svgf_filter(*inputs, params)
    rows = [y for y0 in range(16, h, 16) for y in (y0 - 1, y0)]
    cols = [x for x0 in range(32, w, 32) for x in (x0 - 1, x0)] + [w - 1]
    assert torch.equal(got[rows], want[rows])
    assert torch.equal(got[:, cols], want[:, cols])
    fused = svgf_cuda.svgf_present(*inputs, params)
    plain = present_plain(*inputs, params)
    assert float((fused[rows] - plain[rows]).abs().max()) <= PRESENT_MAX_ABS
    assert float((fused[:, cols] - plain[:, cols]).abs().max()) \
        <= PRESENT_MAX_ABS


def _bands(inputs, n, halo=3):
    """The n row bands of whole-image planes, each with `halo` rows of
    its neighbours above and below (zeros past the image's edge): the
    planes ring_halos hands K4."""
    h = inputs[0].shape[0]
    bh = h // n
    out = []
    for k in range(n):
        planes = []
        for x in inputs:
            pad = torch.zeros((halo,) + tuple(x.shape[1:]), device=x.device)
            ext = torch.cat([pad, x, pad], 0)
            planes.append(ext[k * bh:(k + 1) * bh + 2 * halo].contiguous())
        out.append((k * bh, planes))
    return out


@pytest.mark.parametrize("size", [(1080, 1920), (1080, 203), (64, 96)])
def test_svgf_band_entries_match_plain_and_stitch_to_the_whole(size):
    """K4's two entries on the 4 bands of an image (1080 rows: 270 a band,
    a partial last block row) with 3 halo rows: the filter entry equals
    the plain band filter bit for bit, the fused entry the plain band
    present pass to its tolerance, and the stitched bands equal the
    whole-image kernel's output bit for bit.  The motion's smoothstep is
    0 or 1 (see test_svgf_block_seams_equal_plain_exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, w = size
    inputs = _svgf_inputs(h, w, seed=31, sky=0.1)
    inputs[1][:, :w // 2] = 0.0
    inputs[1][:, w // 2:] = 0.2
    params = preset("full")
    whole = svgf_cuda.svgf_filter(*inputs, params)
    whole_present = svgf_cuda.svgf_present(*inputs, params)
    got, got_present = [], []
    for row0, planes in _bands(inputs, 4):
        kw = dict(halo=3, row_offset=row0, full_height=h)
        before = dict(cuda_lib.LAUNCHES)
        f = svgf_cuda.svgf_filter(*planes, params, **kw)
        p = svgf_cuda.svgf_present(*planes, params, **kw)
        after = dict(cuda_lib.LAUNCHES)
        assert after.pop("svgf") == before.pop("svgf") + 1
        assert after.pop("svgf_present") == before.pop("svgf_present") + 1
        assert after == before
        assert f.shape == (h // 4, w, 3) and p.shape == (h // 4, w, 3)
        assert torch.equal(f, svgf_filter(*planes, params, **kw))
        _assert_present(p, present_plain(*planes, params, **kw))
        got.append(f)
        got_present.append(p)
    assert torch.equal(torch.cat(got), whole)
    assert torch.equal(torch.cat(got_present), whole_present)


def test_svgf_band_wrappers_reject_bad_bands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _svgf_inputs(14, 32, seed=0)
    params = preset("full")
    for kw in (dict(halo=8), dict(halo=3, row_offset=4, full_height=10),
               dict(halo=-1), dict(row_offset=-1)):
        with pytest.raises(ValueError, match="band"):
            svgf_cuda.svgf_present(*inputs, params, **kw)
        with pytest.raises(ValueError, match="band"):
            svgf_cuda.svgf_filter(*inputs, params, **kw)


def test_one_rank_nccl_frames_match_render_frame(bvh, tmp_path):
    """A one-rank NCCL group through make_sharded_render_fn: three `full`
    frames, still and then moving (the all-gathered history, the halo
    exchange with no neighbour, the all-reduce), equal render_frame's on
    the card bit for bit, through the same kernels."""
    import torch.distributed as dist
    from opengl_raytracing_tpu_torch.models import RenderState, render_frame
    from opengl_raytracing_tpu_torch.parallel import (make_mesh,
                                                      make_sharded_render_fn,
                                                      shard_image_rows)
    from opengl_raytracing_tpu_torch.parallel.shardmap import gather_rows
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    h, w = 96, 128
    scene = BVHDevice(bvh)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.device == torch.device("cuda", 0)
        fn = make_sharded_render_fn(mesh, h, w, use_bvh=True)
        params = preset("full")
        cam = Camera()
        cam.aspect = w / h
        cam.point_at((-2.0, 1.5, 0.0))
        state = RenderState.create(h, w, "cuda")
        band = shard_image_rows(mesh, RenderState.create(h, w, "cuda"))
        prev = cam.view_projection()
        for i in range(3):
            moved = int(i > 0)
            if moved:
                cam.yaw += 1.0
            fin = camera_frame_inputs(cam, "cuda", prev_view_proj=prev,
                                      moved=moved)
            prev = cam.view_projection()
            state, out = render_frame(params, fin, state, None, scene,
                                      height=h, width=w, use_bvh=True)
            before = dict(cuda_lib.LAUNCHES)
            band, bout, lum = fn(params, fin, band, None, scene)
            for k in ("closest", "bounce", "ao", "bvh_direct",
                      "svgf_present"):
                assert cuda_lib.LAUNCHES[k] > before[k], k
            assert torch.equal(bout.image, out.image)
            assert torch.equal(band.accum, state.accum)
            assert torch.equal(gather_rows(mesh, bout.image), out.image)
            host = float((out.image.cpu() @ torch.tensor(
                [0.299, 0.587, 0.114])).mean())
            assert abs(float(lum) - host) < 1e-4
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("moving", [False, True], ids=["still", "moving"])
def test_bands_in_turn_on_card_match_render_frame(bvh, moving):
    """Four row bands a frame on the card, one after another
    (render_bands_in_turn: the band step with its collectives done by
    slicing), three `full` frames: every plane of every frame, and the
    accumulation, equal render_frame's bit for bit.  The bands' grids are
    a quarter of the image's: nothing on the path may round by the
    shape (a GEMM's algorithm does; the motion's projection is
    elementwise for this)."""
    from opengl_raytracing_tpu_torch.models import RenderState, render_frame
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    from opengl_raytracing_tpu_torch.parallel.shardmap import (
        render_bands_in_turn)
    h, w, n = 96, 128, 4
    scene = BVHDevice(bvh)
    params = preset("full")
    cam = Camera()
    cam.aspect = w / h
    cam.point_at((-2.0, 1.5, 0.0))
    state = RenderState.create(h, w, "cuda")
    bands = [RenderState(torch.zeros((h // n, w, 4), device="cuda"), 0)
             for _ in range(n)]
    prev = cam.view_projection()
    for i in range(3):
        if moving:
            cam.yaw += 1.0
        fin = camera_frame_inputs(cam, "cuda", prev_view_proj=prev,
                                  moved=int(moving))
        prev = cam.view_projection()
        state, out = render_frame(params, fin, state, None, scene,
                                  height=h, width=w, use_bvh=True)
        bands, outs, _ = render_bands_in_turn(params, fin, bands, None,
                                              scene, height=h, width=w,
                                              use_bvh=True)
        for name, got in zip(out._fields, zip(*outs)):
            assert torch.equal(torch.cat(got), getattr(out, name)), name
    assert torch.equal(torch.cat([b.accum for b in bands]), state.accum)


def test_present_wrappers_reject_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    accum, motion, gpos, gnrm = _svgf_inputs(8, 8, seed=0)
    params = preset("full")
    with pytest.raises(ValueError, match="shape"):
        svgf_cuda.svgf_present(accum[..., :3].contiguous(), motion, gpos,
                               gnrm, params)
    with pytest.raises(ValueError, match="shape"):
        svgf_cuda.svgf_present(accum, motion, gpos[:4], gnrm, params)
    with pytest.raises(ValueError):
        svgf_cuda.svgf_present(accum, motion, gpos.cpu(), gnrm, params)
    with pytest.raises(TypeError):
        svgf_cuda.svgf_present(accum, motion.double(), gpos, gnrm, params)
    with pytest.raises(ValueError, match="contiguous"):
        svgf_cuda.svgf_present(accum, motion, gpos.transpose(0, 1), gnrm,
                               params)
    with pytest.raises(ValueError, match="shape"):
        svgf_cuda.tonemap(accum[..., :3].contiguous(), params)
    with pytest.raises(TypeError):
        svgf_cuda.tonemap(accum.double(), params)
    with pytest.raises(ValueError, match="contiguous"):
        svgf_cuda.tonemap(accum.transpose(0, 1), params)
    # the motion view launches no kernel: plain PyTorch on the card, the
    # CPU's wheel within rounding
    before = dict(cuda_lib.LAUNCHES)
    wheel = present(accum, motion, gpos, gnrm, params, show_motion=True)
    assert cuda_lib.LAUNCHES == before and wheel.is_cuda
    want = present(accum.cpu(), motion.cpu(), gpos.cpu(), gnrm.cpu(), params,
                   show_motion=True)
    torch.testing.assert_close(wheel.cpu(), want, rtol=0, atol=1e-5)


# -- the app layer on the card --

def _app_gate(got, want):
    """chip_smoke.py's frame gate: max abs <= 2/255, q99.9 <= 1e-3."""
    diff = (got.cpu() - want).abs()
    assert float(diff.max()) <= 2.0 / 255.0
    assert float(torch.quantile(diff.flatten(), 0.999)) <= 1e-3


@pytest.mark.parametrize("argv", [
    ("--scene", "bvh", "--preset", "full", "--camera-anim", "dolly"),
    ("--scene", "analytic", "--preset", "full", "--env",
     "cubemaps/sky_day.png"),
    ("--scene", "bvh", "--preset", "heavy", "--model", "models/orb.glb",
     "--env", "cubemaps/sky_storm.exr", "--camera-anim", "pan")])
def test_app_steps_on_card_match_cpu(argv):
    """The app's steps on the card against the same steps on the CPU:
    every frame within the frame gate, the same host state, the card's
    kernels launched and the frames left on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    from opengl_raytracing_tpu_torch.app import headless
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = tuple(os.path.join(root, a) if "/" in a else a for a in argv)
    apps = {}
    for device in ("cpu", "cuda"):
        args = headless.build_parser().parse_args(
            ["--size", "128x96", *argv] + (["--cpu"] if device == "cpu"
                                           else []))
        apps[device] = headless.make_app(args)
    action = headless.camera_action(args)
    before = dict(cuda_lib.LAUNCHES)
    for _ in range(3):
        imgs = {}
        for device, app in apps.items():
            if action is not None:
                app.act(action)
            imgs[device] = app.step()
        assert imgs["cuda"].is_cuda and imgs["cpu"].device.type == "cpu"
        _app_gate(imgs["cuda"], imgs["cpu"])
        c, g = apps["cpu"].app, apps["cuda"].app
        assert c.host_frame_index == g.host_frame_index
        np.testing.assert_array_equal(c.frame.jitter, g.frame.jitter)
        np.testing.assert_array_equal(c.camera.position, g.camera.position)
    assert cuda_lib.LAUNCHES["svgf_present"] >= before["svgf_present"] + 3


def test_viewer_frames_come_from_the_card():
    """The viewer's render thread runs the card app: each frame's uint8
    image is a CUDA tensor copied through pinned memory, and the served
    PNG is that image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import tempfile
    import threading
    import time
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.app.viewer import ViewerState
    from opengl_raytracing_tpu_torch.utils.image import read_png
    args = headless.build_parser().parse_args(
        ["--size", "64x48", "--scene", "bvh", "--preset", "full"])
    app = headless.make_app(args)
    vs = ViewerState(app)
    loop = threading.Thread(target=vs.loop, args=(120.0,), daemon=True)
    loop.start()
    try:
        deadline = time.time() + 120
        while vs.frames_encoded < 3 and time.time() < deadline:
            time.sleep(0.05)
        with vs.lock:
            u8 = app.last_u8
            assert u8 is not None and u8.is_cuda
            assert u8.device == app.app.device
    finally:
        app.act("quit")
        loop.join(timeout=60)
    assert not loop.is_alive() and vs.failed_frames == 0
    with tempfile.NamedTemporaryFile(suffix=".png") as fh:
        fh.write(vs.png)
        fh.flush()
        served = read_png(fh.name)
    assert served.shape == (48, 64, 3) and served.dtype == np.uint8
    assert 0 < served.mean() < 255


# ---- the captured frame (models/graph.py) ----

def _graph_chain(jit, params, frames, env=None, bvh=None, moving=False,
                 h=96, w=128):
    """`frames` chained frames through make_render_fn: [(image, accum)]
    copied off the graph's static tensors, and the launches a frame."""
    from opengl_raytracing_tpu_torch.models import (RenderState,
                                                    make_render_fn)
    fn = make_render_fn(h, w, "cuda", use_bvh=bvh is not None, jit=jit)
    state = RenderState.create(h, w, "cuda")
    cam = Camera()
    cam.aspect = w / h
    cam.point_at((-2.0, 1.5, 0.0))
    prev = cam.view_projection()
    out, launches = [], []
    for i in range(frames):
        if moving:
            cam.yaw += 0.7
        fin = camera_frame_inputs(
            cam, "cuda", jitter=(0.1 * (i % 3), -0.05 * (i % 2)),
            prev_view_proj=prev if moving else None, moved=int(moving),
            frame_index=i)
        prev = cam.view_projection()
        before = dict(cuda_lib.LAUNCHES)
        state, o = fn(params, fin, state, env, bvh)
        launches.append({k: cuda_lib.LAUNCHES[k] - before[k]
                         for k in before})
        out.append((o.image.clone(), state.accum.clone()))
    return out, launches


@pytest.mark.parametrize("case", ["baseline", "full", "heavy", "moving",
                                  "an_baseline", "an_full", "an_heavy"])
def test_replayed_frames_equal_eager_frames(bvh, case):
    """A chain replayed from its CUDA graph gives the eager chain's frames
    and accumulations bit for bit and launches the same kernels a frame;
    it captures once (its first frame runs eagerly) and replays the
    rest."""
    from opengl_raytracing_tpu_torch.models import graph
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    name = {"moving": "full", "an_baseline": "baseline",
            "an_full": "full", "an_heavy": "heavy"}.get(case, case)
    params = preset(name)
    env = None
    if case == "an_full":
        faces = np.random.RandomState(0).randint(0, 256, (6, 16, 16, 3))
        from opengl_raytracing_tpu_torch.convert import env_from_numpy
        env = env_from_numpy(faces.astype(np.uint8), "cuda")
        params = params.replace(enable_env_map=1)
    scene = None if case.startswith("an_") else BVHDevice(bvh)
    graph.clear()
    eager, eager_launches = _graph_chain(False, params, 6, env, scene,
                                         case == "moving")
    stats = dict(graph.STATS)
    replayed, replay_launches = _graph_chain(True, params, 6, env, scene,
                                             case == "moving")
    assert graph.STATS["captures"] == stats["captures"] + 1
    assert graph.STATS["replays"] == stats["replays"] + 5
    for i, ((ei, ea), (ri, ra)) in enumerate(zip(eager, replayed)):
        assert torch.equal(ri, ei), f"image of frame {i}"
        assert torch.equal(ra, ea), f"accumulation of frame {i}"
    assert replay_launches == eager_launches
    assert sum(replay_launches[-1].values()) > 0
    graph.clear()


def test_two_live_states_in_turns_keep_their_histories(bvh):
    """Two live states of one size, two cameras, rendered in turns through
    the captured frame: each keeps its own history (a static
    accumulation each, and so a capture each), frame by frame bit for bit
    the eager chain of its own."""
    from opengl_raytracing_tpu_torch.models import (RenderState, graph,
                                                    make_render_fn)
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    params, scene = preset("full"), BVHDevice(bvh)
    cams = []
    for yaw in (0.0, 25.0):
        cam = Camera()
        cam.aspect = 128 / 96
        cam.point_at((-2.0, 1.5, 0.0))
        cam.yaw += yaw
        cams.append(cam)

    def fin(k, i):
        return camera_frame_inputs(cams[k], "cuda",
                                   jitter=(0.1 * (i % 3), -0.05 * (i % 2)),
                                   frame_index=i)
    graph.clear()
    want = {}
    eager = make_render_fn(96, 128, "cuda", use_bvh=True, jit=False)
    for k in (0, 1):
        state, want[k] = RenderState.create(96, 128, "cuda"), []
        for i in range(4):
            state, out = eager(params, fin(k, i), state, None, scene)
            want[k].append((out.image.clone(), state.accum.clone()))
    assert not torch.equal(want[0][-1][1], want[1][-1][1])
    fn = make_render_fn(96, 128, "cuda", use_bvh=True)
    captures = graph.STATS["captures"]
    states = {k: RenderState.create(96, 128, "cuda") for k in (0, 1)}
    for i in range(4):
        for k in (0, 1):
            states[k], out = fn(params, fin(k, i), states[k], None, scene)
            assert torch.equal(out.image, want[k][i][0]), (k, i)
            assert torch.equal(states[k].accum, want[k][i][1]), (k, i)
    assert states[0].accum.data_ptr() != states[1].accum.data_ptr()
    assert graph.STATS["captures"] == captures + 2
    graph.clear()


def test_app_turbo_step_replays_the_eager_frames(bvh):
    """The app's turbo chain on the card, replayed (the moving key, then
    the still key) against --no-jit, bit for bit; the u8 image from the
    graph equals the eager quantization."""
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.models import graph
    graph.clear()
    runs = {}
    for jit in ("--jit", "--no-jit"):
        args = headless.build_parser().parse_args(
            ["--size", "128x96", "--scene", "bvh", "--preset", "full",
             "--turbo", "4", jit])
        app = headless.make_app(args)
        app.want_u8 = True
        imgs = []
        for step in range(3):
            if step == 1:
                app.act("look 5 0")
            imgs.append(app.step().clone())
            imgs.append(app.last_u8.clone())
        assert app.eager_frames == 0
        runs[jit] = (imgs, app.app.render_state.accum.clone())
    for a, b in zip(runs["--jit"][0], runs["--no-jit"][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs["--jit"][1], runs["--no-jit"][1])
    assert graph.STATS["captures"] >= 2  # the still and the moving key
    graph.clear()


def test_orbit_frames_run_eagerly_and_are_counted(bvh):
    """The point-light orbit's steps, whose parameters change every step,
    replay one captured frame (the orbit's yaw reaches it through the
    parameter block): no frame runs eagerly, and the steps equal
    --no-jit's bit for bit."""
    from opengl_raytracing_tpu_torch.app import headless
    from opengl_raytracing_tpu_torch.models import graph
    graph.clear()
    captures, runs = graph.STATS["captures"], {}
    for jit in ("--jit", "--no-jit"):
        args = headless.build_parser().parse_args(
            ["--size", "64x48", "--preset", "full", "--orbit", jit])
        app = headless.make_app(args)
        runs[jit] = [app.step().clone() for _ in range(4)]
        assert app.eager_frames == 0
        assert app.app.params.point_light_yaw != 0.0
    assert graph.STATS["captures"] == captures + 1
    for a, b in zip(runs["--jit"], runs["--no-jit"]):
        assert torch.equal(a, b)
    assert not torch.equal(runs["--jit"][0], runs["--jit"][-1])
    graph.clear()


@pytest.mark.parametrize("case", ["full", "an_full"])
def test_replayed_frames_follow_every_parameter_change(bvh, case):
    """A chain whose every frame sets the data fields to other seeded
    values (and moves the orbit's yaw) replays one capture, frame by frame
    bit for bit the eager chain of the same parameters."""
    from opengl_raytracing_tpu_torch.models import (RenderState, graph,
                                                    make_render_fn)
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    env, scene = None, BVHDevice(bvh)
    base = preset("full").replace(point_light_orbit_enabled=1)
    if case == "an_full":
        faces = np.random.RandomState(0).randint(0, 256, (6, 16, 16, 3))
        from opengl_raytracing_tpu_torch.convert import env_from_numpy
        env = env_from_numpy(faces.astype(np.uint8), "cuda")
        base, scene = base.replace(enable_env_map=1), None
    params = [base.replace(**seeded_values(seed)) for seed in range(1, 7)]
    cam = Camera()
    cam.aspect = 128 / 96
    cam.point_at((-2.0, 1.5, 0.0))
    graph.clear()
    stats, runs = dict(graph.STATS), {}
    for jit in (False, True):
        fn = make_render_fn(96, 128, "cuda", use_bvh=scene is not None,
                            jit=jit)
        state, runs[jit] = RenderState.create(96, 128, "cuda"), []
        for i, p in enumerate(params):
            fin = camera_frame_inputs(cam, "cuda", jitter=(0.1 * (i % 3), 0.0),
                                      frame_index=i)
            state, out = fn(p, fin, state, env, scene)
            runs[jit].append((out.image.clone(), state.accum.clone()))
    assert graph.STATS["captures"] == stats["captures"] + 1
    assert graph.STATS["replays"] == stats["replays"] + len(params) - 1
    for i, ((ei, ea), (ri, ra)) in enumerate(zip(runs[False], runs[True])):
        assert torch.equal(ri, ei), f"image of frame {i}"
        assert torch.equal(ra, ea), f"accumulation of frame {i}"
    graph.clear()


def test_kernels_read_the_parameter_block_through_its_pointer(bvh):
    """Each kernel that reads the parameter block (K3, the BVH direct
    light, K2's AO call, K4's three entries) against its plain version on
    one block at seeded values A, then again after B's words are copied
    into the same block (as a replay copies them into the captured
    frame's static block): the same argument structs, the results B's,
    each within its kernel's stated tolerance."""
    from opengl_raytracing_tpu_torch.models import param_block
    from opengl_raytracing_tpu_torch.params import bind
    a, b = (preset("full").replace(**seeded_values(seed)) for seed in (1, 2))
    blk = param_block.block(a, "cuda").clone()
    p = bind(a, "cuda", blk)
    env = _env_table(8, seed=3)
    an = _analytic(p)
    an_env = SceneCtx.create(p.replace(enable_env_map=1), an[0].cam_pos,
                             env_map=env, use_bvh=False)
    bv = _bvh_frame(bvh, p)
    inputs = _svgf_inputs(61, 97, seed=5, sky=0.2)

    def run():
        scene, h_raw, h, px, py, vdir = an
        rng, fi = 5, 5
        outs = [_an_direct(scene, h, rng, fi, vdir, px, py),
                _an_direct(an_env, h, rng, fi, vdir, px, py)]
        scene, h_raw, h, px, py, vdir = bv
        outs.append(_bvh_direct(scene, h, rng, fi, vdir, px, py,
                                h_raw.valid))
        got, want, live = _ao_check(bvh, scene, h, px, py, p, h_raw.valid)
        outs.append(got[live])
        filtered = svgf_cuda.svgf_filter(*inputs, p)
        torch.testing.assert_close(filtered, svgf_filter(*inputs, p),
                                   **SVGF_TOL)
        outs.append(filtered)
        for q in (p, p.replace(enable_svgf=0)):
            got = present(*inputs, q)
            _assert_present(got, present_plain(*inputs, q))
            outs.append(got)
        return outs
    three = FrameValue.of(3, "cuda")
    structs = lambda: (bytes(an_cuda.scene_args(an[0], three, three)[0]),
                       bytes(bvh_cuda.ao_args(p, three)[0]))
    first, before = run(), structs()
    blk.copy_(param_block.block(b, "cuda"))
    second = run()
    assert structs() == before
    for x, y in zip(first, second):
        assert not torch.equal(x, y)
    # B's words through the pointer are B's own parameters
    want = svgf_filter(*inputs, bind(b, "cuda"))
    torch.testing.assert_close(second[4], want, **SVGF_TOL)


def test_a_host_copy_in_the_frame_makes_the_capture_raise(bvh, monkeypatch):
    """A frame that copies from pageable host memory cannot be captured:
    the capture raises, and nothing runs the eager frame in its place."""
    from opengl_raytracing_tpu_torch.models import RenderState, graph
    from opengl_raytracing_tpu_torch.models import pipeline
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    graph.clear()
    real = pipeline.present

    def present_with_a_copy(accum, *args, **kw):
        bump = torch.tensor([0.0], device=accum.device)  # host -> device
        return real(accum + bump, *args, **kw)
    monkeypatch.setattr(pipeline, "present", present_with_a_copy)
    fn = pipeline.make_render_fn(48, 64, "cuda", use_bvh=True)
    params = preset("baseline").replace(exposure=1.2345)
    cam = Camera()
    cam.aspect = 64 / 48
    state = RenderState.create(48, 64, "cuda")
    captures = graph.STATS["captures"]
    with pytest.raises(RuntimeError):
        fn(params, camera_frame_inputs(cam, "cuda"), state, None,
           BVHDevice(bvh))
    torch.cuda.synchronize()
    assert graph.STATS["captures"] == captures
    assert not graph._GRAPHS
    monkeypatch.undo()
    graph.clear()
    # the card still renders
    fn = pipeline.make_render_fn(48, 64, "cuda", use_bvh=True)
    _, out = fn(params, camera_frame_inputs(cam, "cuda"),
                RenderState.create(48, 64, "cuda"), None, BVHDevice(bvh))
    assert torch.isfinite(out.image).all()
    graph.clear()


# ---- the captured band step and raster preview (parallel/graph.py,
# models/graph.py:render_raster) ----

def _band_chain(fn, states, params_at, cam_at, scene, env, h, w):
    """Six chained band frames through `fn`: frames 0-2 still, 3-5 with
    the camera turning; the parameters `params_at(i)`.  [(image, accum,
    mean_lum)] copied off the graph's static tensors."""
    state, out = states, []
    prev = None
    for i in range(6):
        cam = cam_at(i)
        moved = i >= 3
        fin = camera_frame_inputs(
            cam, "cuda", jitter=(0.1 * (i % 3), -0.05 * (i % 2)),
            prev_view_proj=prev if moved else None, moved=int(moved),
            frame_index=i)
        prev = cam.view_projection()
        state, o, lum = fn(params_at(i), fin, state, env, scene)
        out.append((o.image.clone(), state.accum.clone(), lum.clone()))
    return out


@pytest.mark.parametrize("scene_kind", ["bvh", "analytic"])
def test_replayed_band_frames_equal_eager_ones(bvh, scene_kind, tmp_path):
    """A one-rank NCCL group through make_sharded_render_fn at 144x192,
    `full` on the BVH and on the analytic scene: the replayed step
    (jit=True: one CUDA graph, the history gather and the all-reduce
    inside) against the eager step, frame by frame bit for bit, across a
    slider change (frame 2) and a camera that starts to move (frame 3):
    one capture a key (the still and the moving), the rest replays, the
    same launches a frame."""
    import torch.distributed as dist
    from opengl_raytracing_tpu_torch.models import RenderState, graph
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    from opengl_raytracing_tpu_torch.parallel import (make_mesh,
                                                      make_sharded_render_fn,
                                                      shard_image_rows)
    h, w = 144, 192
    scene = BVHDevice(bvh) if scene_kind == "bvh" else None
    base = preset("full").replace(enable_env_map=0)
    moved = base.replace(**seeded_values(1))

    def cam_at(i):
        cam = Camera()
        cam.aspect = w / h
        cam.point_at((-2.0, 1.5, 0.0))
        cam.yaw += 0.8 * max(i - 2, 0)
        return cam
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        graph.clear()
        runs, launches = {}, {}
        for jit in (False, True):
            fn = make_sharded_render_fn(mesh, h, w, use_bvh=scene is not None,
                                        jit=jit)
            band = shard_image_rows(mesh, RenderState.create(h, w, "cuda"))
            stats, before = dict(graph.STATS), dict(cuda_lib.LAUNCHES)
            runs[jit] = _band_chain(fn, band, lambda i: base if i < 2
                                    else moved, cam_at, scene, None, h, w)
            launches[jit] = {k: cuda_lib.LAUNCHES[k] - before[k]
                             for k in before}
        assert graph.STATS["captures"] == stats["captures"] + 2
        assert graph.STATS["replays"] == stats["replays"] + 4
        for i, (e, r) in enumerate(zip(runs[False], runs[True])):
            for name, x, y in zip(("image", "accum", "mean_lum"), e, r):
                assert torch.equal(x, y), f"{name} of frame {i}"
        assert not torch.equal(runs[True][1][0], runs[True][2][0])
        assert launches[True] == launches[False]
        assert launches[True]["svgf_present"] == 6
    finally:
        graph.clear()
        dist.destroy_process_group()


def test_replayed_raster_preview_equals_eager(bvh):
    """The raster preview replayed (one capture) against render_raster,
    bit for bit, with the camera and the point light's orbit and colour
    changing every frame."""
    from opengl_raytracing_tpu_torch.models import graph, render_raster
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    scene = BVHDevice(bvh)
    graph.clear()
    stats = dict(graph.STATS)
    base = preset("full").replace(point_light_orbit_enabled=1)
    for i in range(5):
        params = base.replace(point_light_yaw=30.0 * i,
                              point_light_color=(1.0, 0.2 * i, 0.5))
        cam = Camera()
        cam.aspect = 192 / 144
        cam.point_at((0.0, 1.0, 0.0))
        cam.yaw += 2.0 * i
        fin = camera_frame_inputs(cam, "cuda", frame_index=i)
        got = graph.render_raster(params, fin, scene, height=144, width=192)
        want = render_raster(params, fin, scene, height=144, width=192)
        assert torch.equal(got, want), i
    assert graph.STATS["captures"] == stats["captures"] + 1
    assert graph.STATS["replays"] == stats["replays"] + 4
    graph.clear()


def test_a_failed_band_capture_raises(bvh, tmp_path, monkeypatch):
    """A band step that copies from pageable host memory cannot be
    captured: make_sharded_render_fn raises, stores no graph and runs no
    eager step in its place; the card renders afterwards."""
    import torch.distributed as dist
    from opengl_raytracing_tpu_torch.models import RenderState, graph
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    from opengl_raytracing_tpu_torch.parallel import (make_mesh,
                                                      make_sharded_render_fn,
                                                      shard_image_rows)
    from opengl_raytracing_tpu_torch.parallel import shardmap
    real = shardmap.band_shade

    def band_shade_with_a_copy(params, fin, state, *args, **kw):
        state.accum.add_(torch.tensor([0.0], device=state.accum.device))
        return real(params, fin, state, *args, **kw)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        graph.clear()
        cam = Camera()
        cam.aspect = 64 / 48
        params = preset("full").replace(exposure=1.2345)
        # still: the copy comes before any collective of the step
        monkeypatch.setattr(shardmap, "band_shade", band_shade_with_a_copy)
        fn = make_sharded_render_fn(mesh, 48, 64, use_bvh=True)
        captures = graph.STATS["captures"]
        with pytest.raises(RuntimeError):
            fn(params, camera_frame_inputs(cam, "cuda"),
               shard_image_rows(mesh, RenderState.create(48, 64, "cuda")),
               None, BVHDevice(bvh))
        torch.cuda.synchronize()
        assert graph.STATS["captures"] == captures and not graph._GRAPHS \
            and not graph._KEPT
        monkeypatch.undo()
        graph.clear()
        _, out, lum = fn(params, camera_frame_inputs(cam, "cuda"),
                         shard_image_rows(mesh, RenderState.create(48, 64,
                                                                   "cuda")),
                         None, BVHDevice(bvh))
        assert torch.isfinite(out.image).all() and torch.isfinite(lum)
    finally:
        graph.clear()
        dist.destroy_process_group()


# ---- the analytic scene's live-lane kernels (csrc/an_trace.cu) ----

# a `full` frame's calls: the mirror's and glass's traces and skies are
# their rays kernels' since those kernels (csrc/an_shade.cu; before: 5
# traces, 7 skies)
GATE_CALLS = dict(trace=1, ambient_occlusion=1, bounce=2, sky=3)
GATE_COUNTERS = dict(trace="an_trace", ambient_occlusion="an_ao",
                     bounce="an_bounce", sky="sky")


def _an_gate_calls(params, size, env):
    """The calls one eager analytic frame on the card makes to the four
    wrappers of ops/an_trace_cuda.py: [(name, arguments, active)]."""
    from opengl_raytracing_tpu_torch.models import RenderState, render_frame
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    h, w = size
    calls, real = [], {n: getattr(an_trace_cuda, n) for n in GATE_CALLS}

    def spy(name):
        def fn(*args, **kw):
            import inspect
            bound = inspect.signature(real[name]).bind(*args, **kw)
            bound.apply_defaults()
            a = dict(bound.arguments)
            calls.append((name, a, a.pop("active")))
            return real[name](*args, **kw)
        return fn
    cam = Camera()
    cam.aspect = w / h
    fin = camera_frame_inputs(cam, "cuda", jitter=(0.2, -0.1), frame_index=5)
    try:
        for n in GATE_CALLS:
            setattr(an_trace_cuda, n, spy(n))
        render_frame(params, fin, RenderState.create(h, w, "cuda"), env,
                     height=h, width=w)
    finally:
        for n, fn in real.items():
            setattr(an_trace_cuda, n, fn)
    return calls


def _gate_plain(name, a, active):
    """The dense plain version of a wrapper call, on the card, on inputs
    whose lanes the frame's mask `active` marks dead are set to a valid
    value (_unread): the frame leaves them unspecified, and the plain
    version computes every lane."""
    from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
    a = _unread(name, a, active)
    if name == "trace":
        h = tsa.trace_analytic_core(a["ro"], a["rd"], a["params"],
                                    a["point_light_pos"], a["include_glass"],
                                    a["include_point_light"], a["eps"])
        return dict(zip(Hit._fields, h))
    if name == "ambient_occlusion":
        return dict(ao=lt.ambient_occlusion_analytic_plain(
            a["scene"], a["h"], a["frame_index"], a["px"], a["py"]))
    if name == "bounce":
        h, wi, cos = lt.gi_bounce_analytic_plain(
            a["scene"], a["h0"], a["rng_frame"], a["seed"], a["px"],
            a["py"])
        return dict(zip(Hit._fields, h), wi=wi, cos=cos)
    return dict(sky=tsa.sky(a["d"], a["params"], a["env_map"]))


def _unread(name, a, active):
    """The arguments `a` of a wrapper call with every lane that `active`
    marks dead set to one valid value in its per-lane inputs (the rays,
    the hits, the directions); the live lanes unchanged."""
    if active is None:
        return a

    def fill(x, value):
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
        return torch.where(active[..., None] if value.dim() else active, x,
                           value)

    def hit(h):
        return Hit(fill(h.t, 1.0), fill(h.p, (0.0, 0.5, 0.0)),
                   fill(h.n, (0.0, 1.0, 0.0)), fill(h.mat, 0))
    up = (0.0, 1.0, 0.0)
    if name == "trace":
        return dict(a, ro=fill(a["ro"], (0.0, 0.5, 0.0)), rd=fill(a["rd"], up))
    if name == "sky":
        return dict(a, d=fill(a["d"], up))
    key = "h" if name == "ambient_occlusion" else "h0"
    return dict(a, **{key: hit(a[key])})


def _gate_out(name, out):
    if name == "trace":
        return dict(zip(Hit._fields, out))
    if name == "bounce":
        return dict(zip(Hit._fields, out[0]), wi=out[1], cos=out[2])
    return {"ao" if name == "ambient_occlusion" else "sky": out}


def _gate_shape(name, a):
    if name == "trace":
        return torch.broadcast_shapes(a["ro"].shape[:-1], a["rd"].shape[:-1])
    if name == "sky":
        return a["d"].shape[:-1]
    return (a["h"] if name == "ambient_occlusion" else a["h0"]).t.shape


def _gate_sentinel(monkeypatch):
    """Kernel outputs filled with SENTINEL (-7 for the material id) before
    the launch, so a test sees the lanes a kernel wrote."""
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    monkeypatch.setattr(an_trace_cuda, "_empty",
                        lambda shape, dtype, device: torch.full(
                            shape if isinstance(shape, tuple) else (shape,),
                            SENTINEL, dtype=dtype, device=device))


@pytest.mark.parametrize("env", [True, False], ids=["cubemap", "gradient"])
@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("size", SIZES)
def test_an_gate_kernels_match_plain(size, spp, env, monkeypatch):
    """Every call an analytic `full` frame makes to the trace, AO, bounce
    and sky kernels (1, 1, 2 and 3 of them), with the frame's own mask,
    none, a partial one and an empty one: one launch, every output equal
    to the dense plain version's bit for bit on the lanes live in the
    mask and the frame's own (the frame's dead lanes hold unspecified
    inputs), and no dead lane written."""
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = preset("full").replace(spp_per_frame=spp,
                                    enable_env_map=int(env))
    table = None
    if env:
        faces = np.random.RandomState(2).randint(0, 256, (6, 16, 16, 3))
        table = env_from_numpy(faces.astype(np.uint8), "cuda")
    calls = _an_gate_calls(params, size, table)
    assert {n: sum(c[0] == n for c in calls) for n in GATE_CALLS} \
        == GATE_CALLS
    _gate_sentinel(monkeypatch)
    g = torch.Generator(device="cuda").manual_seed(spp)
    for k, (name, a, active) in enumerate(calls):
        _check_gate_masks(k, name, a, active, g)


def _mask_cases(shape, active, g):
    """The masks a live-lane call is held to its plain version with: the
    frame's own `active`, none, a partial one (30% of the lanes, from
    `g`), an empty one; every lane, the last lane alone, ~1% and ~65% of
    the lanes, one drawn a pixel (30%) and broadcast over a leading sample
    axis, one byte for every lane (a scalar broadcast), and 30% of the
    lanes at an address one byte past an aligned one (the kernels' wide
    mask loads fall back to bytes)."""
    def drawn(p, over=shape):
        return torch.rand(over, generator=g, device="cuda") < p
    last = torch.zeros(shape, dtype=torch.bool, device="cuda")
    last.view(-1)[-1] = True
    buf = torch.zeros(last.numel() + 1, dtype=torch.bool, device="cuda")
    buf[1:] = drawn(0.3).reshape(-1)
    return {"frame": active, "none": None, "partial": drawn(0.3),
            "empty": torch.zeros(shape, dtype=torch.bool, device="cuda"),
            "full": torch.ones(shape, dtype=torch.bool, device="cuda"),
            "last": last, "sparse": drawn(0.01), "dense": drawn(0.65),
            "pixel": drawn(0.3, shape[1:] if len(shape) > 2
                           else shape).expand(shape),
            "one": torch.ones((), dtype=torch.bool,
                              device="cuda").expand(shape),
            "unaligned": buf[1:].view(shape)}


def _check_gate_masks(k, name, a, active, g):
    """Call `k` of gate wrapper `name` (arguments `a`, the frame's mask
    `active`) with each of _mask_cases (from `g`): one launch, every
    output equal to the dense plain version's bit for bit on the lanes
    live in the mask and the frame's own (the frame's dead lanes hold
    unspecified inputs), and no dead lane written (the outputs filled by
    _gate_sentinel)."""
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    shape = _gate_shape(name, a)
    want = _gate_plain(name, a, active)
    masks = _mask_cases(shape, active, g)
    for how, mask in masks.items():
        before = dict(cuda_lib.LAUNCHES)
        got = _gate_out(name, getattr(an_trace_cuda, name)(**a,
                                                           active=mask))
        assert _grew(before) == {**{c: 0 for c in before},
                                 GATE_COUNTERS[name]: 1}
        torch.cuda.synchronize()
        live = (torch.ones(shape, dtype=torch.bool, device="cuda")
                if mask is None else mask.expand(shape))
        both = live if active is None else live & active.expand(shape)
        for field, w in want.items():
            x = got[field]
            assert torch.equal(x[both], w.expand(x.shape)[both]), (
                k, name, how, field)
            assert bool((x[~live] == SENTINEL).all()), (k, name, how, field)


@pytest.mark.parametrize("samples", [1, 4, 32])
@pytest.mark.parametrize("radius", [0.05, 0.8, 4.0])
def test_an_ao_kernel_matches_plain_across_radius_and_samples(
        radius, samples, monkeypatch):
    """The AO call of a 1080p analytic `full` frame at ao_radius 0.05, 0.8
    and 4.0 (the viewer's range) and ao_samples 1, 4 and 32 (its fewest
    and most): with the frame's own mask, none, a partial one and an
    empty one, one launch, AO bit for bit the plain version's on the live
    lanes (the kernel's any-hit test and culls against the plain closest
    hit), no dead lane written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = preset("full").replace(ao_radius=radius, ao_samples=samples)
    calls = [c for c in _an_gate_calls(params, (1080, 1920), None)
             if c[0] == "ambient_occlusion"]
    assert len(calls) == 1
    _gate_sentinel(monkeypatch)
    g = torch.Generator(device="cuda").manual_seed(samples)
    _check_gate_masks(0, *calls[0], g)


def test_an_trace_kernel_reads_a_broadcast_origin_and_rows_a_pixel():
    """The primary trace's camera origin is one row for every lane, a
    mask and rays broadcast over a sample axis one row a pixel: the
    kernel's hits equal the dense plain trace's bit for bit."""
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
    scene, h_raw, h, px, py, vdir = _analytic(preset("full"), 37, 131)
    rd = -vdir
    ro = scene.cam_pos.expand(rd.shape)
    for ro_, rd_, act in ((ro, rd, None),
                          (_batch(ro, 4), _batch(rd, 4),
                           _batch(h_raw.valid, 4))):
        shape = rd_.shape[:-1]
        modes = [an_trace_cuda.lane_input(x, shape, w, dt, rd.device,
                                          "x")[0].mode
                 for x, w, dt in ((ro_, 3, torch.float32),
                                  (rd_, 3, torch.float32))]
        assert modes == [an_trace_cuda.ONE, an_trace_cuda.LANE
                         if act is None else an_trace_cuda.PIXEL]
        got = an_trace_cuda.trace(ro_, rd_, scene.params,
                                  scene.point_light_pos, True, True,
                                  active=act)
        want = tsa.trace_analytic_core(ro_, rd_, scene.params,
                                       scene.point_light_pos, True, True)
        live = (torch.ones(shape, dtype=torch.bool, device="cuda")
                if act is None else act)
        for x, w in zip(got, want):
            assert torch.equal(x[live], w.expand(x.shape)[live])


def test_an_gate_wrappers_reject_bad_inputs():
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    scene, h_raw, h, px, py, vdir = _analytic(preset("full"), 8, 8)
    rd = -vdir
    with pytest.raises(TypeError):
        an_trace_cuda.trace(scene.cam_pos.expand(rd.shape).double(),
                            rd.double(), scene.params,
                            scene.point_light_pos, True, True)
    with pytest.raises(ValueError, match="point_light_world"):
        an_trace_cuda.trace(scene.cam_pos.expand(rd.shape), rd,
                            scene.params, scene.point_light_pos.clone(),
                            True, True)
    with pytest.raises(TypeError):
        an_trace_cuda.sky(rd, scene.params, None, h_raw.valid.int())
    with pytest.raises(ValueError):
        an_trace_cuda.sky(rd, scene.params, None, h_raw.valid.cpu())


def test_an_bands_in_turn_on_card_match_render_frame():
    """The analytic `full` frame under a cubemap as four row bands a frame
    on the card, one after another, three frames: every plane of every
    frame and the accumulation equal render_frame's bit for bit (the
    kernels index lanes by their rows, and nothing on the path reduces in
    an order that follows the band's shape)."""
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    from opengl_raytracing_tpu_torch.models import RenderState, render_frame
    from opengl_raytracing_tpu_torch.parallel.shardmap import (
        render_bands_in_turn)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, w, n = 96, 128, 4
    params = preset("full").replace(enable_env_map=1)
    faces = np.random.RandomState(5).randint(0, 256, (6, 16, 16, 3))
    env = env_from_numpy(faces.astype(np.uint8), "cuda")
    cam = Camera()
    cam.aspect = w / h
    state = RenderState.create(h, w, "cuda")
    bands = [RenderState(torch.zeros((h // n, w, 4), device="cuda"), 0)
             for _ in range(n)]
    for i in range(3):
        fin = camera_frame_inputs(cam, "cuda", jitter=(0.1 * i, -0.2),
                                  frame_index=i)
        state, out = render_frame(params, fin, state, env, None, height=h,
                                  width=w)
        bands, outs, _ = render_bands_in_turn(params, fin, bands, env, None,
                                              height=h, width=w)
        for name, got in zip(out._fields, zip(*outs)):
            assert torch.equal(torch.cat(got), getattr(out, name)), name
    assert torch.equal(torch.cat([b.accum for b in bands]), state.accum)


# ---- glass's and the mirror's rays and mix kernels (csrc/an_shade.cu) ----

SHADE_CALLS = ("mirror_ray", "mirror_mix", "glass_rays", "glass_mix")
SHADE_RAYS = ("reflect", "straight", "bent")
# an eager frame's launches: an_full (`full`, a cubemap) and an_baseline
SHADE_FRAME_LAUNCHES = {
    "an_full": dict(an_direct=7, an_trace=1, an_ao=1, an_bounce=2, sky=3,
                    svgf_present=1, glass_rays=1, glass_mix=1, mirror_ray=1,
                    mirror_mix=1, an_hit_mix=1),
    "an_baseline": dict(an_direct=5, an_trace=1, sky=1, tonemap=1,
                        glass_rays=1, glass_mix=1, mirror_ray=1,
                        mirror_mix=1, an_hit_mix=1)}


def _shade_calls(params, size, env):
    """The calls one eager analytic frame on the card makes to the four
    wrappers of ops/an_shade_cuda.py, [(name, arguments)], and the frame's
    launches."""
    import inspect
    from opengl_raytracing_tpu_torch.models import RenderState, render_frame
    from opengl_raytracing_tpu_torch.ops import an_shade_cuda
    h, w = size
    calls, real = [], {n: getattr(an_shade_cuda, n) for n in SHADE_CALLS}

    def spy(name):
        def fn(*args, **kw):
            bound = inspect.signature(real[name]).bind(*args, **kw)
            bound.apply_defaults()
            calls.append((name, dict(bound.arguments)))
            return real[name](*args, **kw)
        return fn
    cam = Camera()
    cam.aspect = w / h
    fin = camera_frame_inputs(cam, "cuda", jitter=(0.2, -0.1), frame_index=5)
    before = dict(cuda_lib.LAUNCHES)
    try:
        for n in SHADE_CALLS:
            setattr(an_shade_cuda, n, spy(n))
        render_frame(params, fin, RenderState.create(h, w, "cuda"), env,
                     height=h, width=w)
    finally:
        for n, fn in real.items():
            setattr(an_shade_cuda, n, fn)
    torch.cuda.synchronize()
    return calls, {k: v for k, v in _grew(before).items() if v}


def _shade_fields(name, r):
    """{output: tensor} of a rays or mix call's result."""
    if name == "mirror_ray":
        return dict(zip(Hit._fields, r.hit), view=r.view, sky=r.sky)
    if name == "glass_rays":
        out = dict(k=r.k, cos=r.cos_theta)
        for j, ray in enumerate(SHADE_RAYS):
            out.update({f"{ray}_{f}": x for f, x in zip(Hit._fields,
                                                        r.hits[j])})
            out.update({f"{ray}_view": r.views[j], f"{ray}_sky": r.skies[j]})
        return out
    return dict(radiance=r)


def _shade_plain(name, a):
    if name == "glass_rays":
        return _shade_fields(name, lt.glass_rays_plain(a["scene"], a["h"],
                                                       a["wo"], a["mat"]))
    if name == "mirror_ray":
        return _shade_fields(name, lt.mirror_ray_plain(a["scene"], a["h"],
                                                       a["wo"]))
    if name == "glass_mix":
        return _shade_fields(name, lt.glass_mix_plain(
            a["scene"], a["h"], a["mat"], a["rays"], a["lit"]))
    return _shade_fields(name, lt.mirror_mix_plain(
        a["scene"], a["h"], a["mat"], a["ray"], a["direct"], a["gi"]))


def _shade_written(want, live):
    """{output: the live lanes the kernel writes it on}: a rays kernel's
    skies where the mix reads them, the rest on every live lane."""
    def missed(ray):
        return ~(want[f"{ray}t" if ray else "t"] < 1e30)
    out = {f: live for f in want}
    if "sky" in want:
        out["sky"] = live & missed("")
    if "straight_sky" in want:
        out["straight_sky"] = live & missed("straight_")
        out["bent_sky"] = live & (want["k"] > 0.0) & missed("bent_")
    return out


def _shade_shape(name, a):
    if name in ("glass_rays", "mirror_ray"):
        return a["h"].t.shape
    return (a["rays"].k if name == "glass_mix" else a["ray"].hit.t).shape


def _nan_equal(x, w):
    return bool(((x == w) | (torch.isnan(x) & torch.isnan(w))).all())


@pytest.mark.parametrize("case", list(SHADE_FRAME_LAUNCHES))
@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_an_shade_kernels_match_plain(size, spp, case):
    """Every call an analytic frame makes to glass's and the mirror's rays
    and mix kernels, with the frame's own mask, none, a partial one and an
    empty one: one launch, every output equal to the dense plain version's
    bit for bit on the lanes live in the mask and the frame's own and
    written there (the rays kernels' skies where the mixes read them), a
    mix's `out` untouched on its dead lanes; and the frame's launches."""
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    from opengl_raytracing_tpu_torch.ops import an_shade_cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = case == "an_full"
    params = preset("full" if env else "baseline").replace(
        spp_per_frame=spp, enable_env_map=int(env))
    table = None
    if env:
        faces = np.random.RandomState(3).randint(0, 256, (6, 16, 16, 3))
        table = env_from_numpy(faces.astype(np.uint8), "cuda")
    calls, launches = _shade_calls(params, size, table)
    assert launches == SHADE_FRAME_LAUNCHES[case]
    assert [c[0] for c in calls] == list(SHADE_CALLS)
    g = torch.Generator(device="cuda").manual_seed(spp)
    for name, a in calls:
        shape = _shade_shape(name, a)
        want = _shade_plain(name, a)
        frame = a["active"]
        assert frame is not None
        masks = {"frame": frame, "none": None,
                 "partial": torch.rand(shape, generator=g,
                                       device="cuda") < 0.3,
                 "empty": torch.zeros(shape, dtype=torch.bool,
                                      device="cuda")}
        mix = name.endswith("_mix")
        args = {k: v for k, v in a.items() if k not in ("active", "out")}
        for how, mask in masks.items():
            out = torch.full(shape + (3,), SENTINEL, device="cuda")
            before = dict(cuda_lib.LAUNCHES)
            fn = getattr(an_shade_cuda, name)
            got = _shade_fields(name, fn(**args, active=mask, out=out)
                                if mix else fn(**args, active=mask))
            assert _grew(before) == {**{c: 0 for c in before}, name: 1}
            torch.cuda.synchronize()
            live = (torch.ones(shape, dtype=torch.bool, device="cuda")
                    if mask is None else mask.expand(shape))
            both = live & frame.expand(shape)
            for field, lanes in _shade_written(want, both).items():
                x = got[field]
                assert _nan_equal(x[lanes], want[field].expand(x.shape)[lanes]
                                  ), (name, how, field)
            if mix:
                assert bool((out[~live] == SENTINEL).all()), (name, how)


# the masks glass's and the mirror's rays kernels (live_lanes) are held
# to their plain versions with
RAYS_MASKS = ("frame", "every", "none_live", "scattered", "unaligned",
              "heavy")


def _rays_masks(how, frame, shape):
    """Mask `how` of a rays call of `shape` whose frame handed it `frame`:
    the frame's own; every lane live; none; ~1% of the lanes drawn with
    numpy from a seed; the frame's mask at an address one byte past a
    4-byte boundary (the kernel's wide mask loads fall back to bytes);
    `heavy`'s own (a byte a pixel under 4 samples)."""
    if how in ("frame", "heavy"):
        return frame
    if how == "every":
        return torch.ones(shape, dtype=torch.bool, device="cuda")
    if how == "none_live":
        return torch.zeros(shape, dtype=torch.bool, device="cuda")
    if how == "scattered":
        drawn = np.random.default_rng(23).random(tuple(shape)) < 0.01
        return torch.from_numpy(drawn).cuda()
    buf = torch.zeros(shape.numel() + 1, dtype=torch.bool, device="cuda")
    buf[1:] = frame.expand(shape).reshape(-1)
    view = buf[1:].view(shape)
    assert view.data_ptr() % 4 != 0
    return view


@pytest.mark.parametrize("sky", ["cubemap", "gradient"])
@pytest.mark.parametrize("how", RAYS_MASKS)
@pytest.mark.parametrize("name", ["glass_rays", "mirror_ray"])
def test_an_shade_rays_kernels_on_every_kind_of_mask(name, how, sky,
                                                     monkeypatch):
    """Glass's or the mirror's rays kernel on an analytic frame's call
    (`full` at 270x480; `heavy`, 4 samples, for its pixel mask) with
    each of RAYS_MASKS, under the cubemap and the gradient sky: one
    launch; on the lanes live in the mask and the frame's own, every
    output the dense plain version's bits where the kernel writes it (the
    skies where the mixes read them); on every dead lane every output as
    it was given (NaN, -7 for a material id)."""
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    from opengl_raytracing_tpu_torch.ops import an_shade_cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cube = sky == "cubemap"
    params = preset("heavy" if how == "heavy" else "full").replace(
        enable_env_map=int(cube))
    table = None
    if cube:
        faces = np.random.RandomState(4).randint(0, 256, (6, 16, 16, 3))
        table = env_from_numpy(faces.astype(np.uint8), "cuda")
    calls, _ = _shade_calls(params, (270, 480), table)
    a = dict(next(c for n, c in calls if n == name))
    frame = a.pop("active")
    shape = _shade_shape(name, a)
    if how == "heavy":  # a byte a pixel under the 4 samples
        from opengl_raytracing_tpu_torch.ops import an_trace_cuda
        assert shape[0] == 4 and an_trace_cuda.lane_input(
            frame, shape, 0, torch.bool, frame.device, "active")[0].mode \
            == an_trace_cuda.PIXEL
    want = _shade_plain(name, a)
    mask = _rays_masks(how, frame, shape)
    monkeypatch.setattr(an_shade_cuda, "_empty",
                        lambda size, dtype, device: torch.full(
                            size if isinstance(size, tuple) else (size,),
                            float("nan") if dtype.is_floating_point else -7,
                            dtype=dtype, device=device))
    before = dict(cuda_lib.LAUNCHES)
    got = _shade_fields(name, getattr(an_shade_cuda, name)(**a,
                                                           active=mask))
    assert _grew(before) == {**{c: 0 for c in before}, name: 1}
    torch.cuda.synchronize()
    live = mask.expand(shape)
    both = live & frame.expand(shape)
    assert how == "none_live" or bool(both.any())
    for field, lanes in _shade_written(want, both).items():
        x = got[field]
        assert _nan_equal(x[lanes], want[field].expand(x.shape)[lanes]), (
            field)
        dead = x[~live]
        assert bool((dead.isnan() if x.is_floating_point() else
                     dead == -7).all()), field


def test_an_shade_wrappers_reject_bad_inputs():
    from opengl_raytracing_tpu_torch.ops import an_shade_cuda
    scene, h_raw, h, px, py, vdir = _analytic(preset("full"), 8, 8)
    with pytest.raises(TypeError):
        an_shade_cuda.mirror_ray(scene, h, vdir.double(), h_raw.valid)
    with pytest.raises(ValueError):
        an_shade_cuda.glass_rays(scene, h, vdir, None, h_raw.valid.cpu())
    rays = an_shade_cuda.glass_rays(scene, h, vdir, None, h_raw.valid)
    lit = [torch.zeros_like(v) for v in rays.views]
    with pytest.raises(ValueError):  # `out` of another shape
        an_shade_cuda.glass_mix(scene, h, None, rays, lit, h_raw.valid,
                                torch.zeros((4, 4, 3), device="cuda"))


# ---- both scenes' hit-mix kernels (csrc/hit_mix.cu) ----

# an eager frame's launches: the BVH frames' GI sky is the hit-mix
# kernel's (before it, `sky` 2 and no hit-mix launch)
HIT_MIX_FRAME_LAUNCHES = {
    "full": dict(closest=1, bvh_direct=2, bounce=1, ao=1, sky=1,
                 bvh_hit_mix=1, svgf_present=1),
    "heavy": dict(closest=1, bvh_direct=2, bounce=1, ao=1, sky=1,
                  bvh_hit_mix=1, svgf_present=1),
    "an_full": SHADE_FRAME_LAUNCHES["an_full"],
    "an_baseline": SHADE_FRAME_LAUNCHES["an_baseline"]}
HIT_MIX_CASES = {"full": ("full", 1, True), "heavy": ("heavy", 4, True),
                 "an_full": ("full", 2, False),
                 "an_baseline": ("baseline", 1, False)}


def _hit_mix_calls(params, size, env, bvh):
    """The calls one eager frame on the card (the BVH scene with `bvh`,
    else the analytic one) makes to the wrappers of ops/hit_mix_cuda.py,
    [(name, arguments)], each call's `radiance` as it was before the call
    (the wrapper updates it in place), and the frame's launches."""
    import inspect
    from opengl_raytracing_tpu_torch.models import RenderState, render_frame
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    from opengl_raytracing_tpu_torch.ops.scene import BVHDevice
    h, w = size
    names = ("bvh_hit_mix", "an_hit_mix")
    calls, real = [], {n: getattr(hit_mix_cuda, n) for n in names}

    def spy(name):
        def fn(*args, **kw):
            bound = inspect.signature(real[name]).bind(*args, **kw)
            bound.apply_defaults()
            a = dict(bound.arguments)
            a["radiance"] = a["radiance"].clone()
            calls.append((name, a))
            return real[name](*args, **kw)
        return fn
    cam = Camera()
    cam.aspect = w / h
    if bvh is not None:
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))
    fin = camera_frame_inputs(cam, "cuda", jitter=(0.2, -0.1), frame_index=5)
    before = dict(cuda_lib.LAUNCHES)
    try:
        for n in names:
            setattr(hit_mix_cuda, n, spy(n))
        render_frame(params, fin, RenderState.create(h, w, "cuda"), env,
                     None if bvh is None else BVHDevice(bvh), height=h,
                     width=w, use_bvh=bvh is not None)
    finally:
        for n, fn in real.items():
            setattr(hit_mix_cuda, n, fn)
    torch.cuda.synchronize()
    return calls, {k: v for k, v in _grew(before).items() if v}


def _hit_mix_unread(a, live):
    """The arguments `a` of a hit-mix call with every lane `live` marks
    dead set to one valid value in its per-lane inputs (the frame leaves
    them unspecified; the plain version computes every lane)."""
    def fill(x, value):
        if x is None:
            return None
        shape = live.shape
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
        x = x.expand(shape + x.shape[len(shape):])
        return torch.where(live[..., None] if value.dim() else live, x,
                           value)
    up = (0.0, 1.0, 0.0)
    out = dict(a, radiance=fill(a["radiance"], up), ao=fill(a["ao"], 1.0))
    gi = a["gi"]
    if gi is not None:
        hit = gi.hit._replace(t=fill(gi.hit.t, 1.0))
        out["gi"] = gi._replace(hit=hit, cos_theta=fill(gi.cos_theta, 0.5),
                                lit=fill(gi.lit, up),
                                **({"wi": fill(gi.wi, up)}
                                   if hasattr(gi, "wi") else
                                   {"sky": fill(gi.sky, up)}))
    return out


def _hit_mix_poisoned(a, live):
    """The arguments `a` of a hit-mix call with GI's per-lane rows (t,
    cosine, light, direction or sky) NaN on the lanes `live` marks dead:
    a kernel that read another lane's row would show it."""
    gi = a["gi"]
    if gi is None:
        return a

    def nan(x):
        shape = live.shape
        x = x.expand(shape + x.shape[len(shape):])
        keep = live[..., None] if x.dim() > len(shape) else live
        return torch.where(keep, x, torch.full((), float("nan"),
                                               device=x.device))
    hit = gi.hit._replace(t=nan(gi.hit.t))
    return dict(a, gi=gi._replace(hit=hit, cos_theta=nan(gi.cos_theta),
                                  lit=nan(gi.lit),
                                  **({"wi": nan(gi.wi)} if hasattr(gi, "wi")
                                     else {"sky": nan(gi.sky)})))


@pytest.mark.parametrize("case", list(HIT_MIX_CASES))
@pytest.mark.parametrize("size", SIZES)
def test_hit_mix_kernels_match_plain(bvh, size, case):
    """Every call a frame makes to its hit-mix kernel, with each of
    _mask_cases and GI's rows poisoned on the mask's dead lanes
    (_hit_mix_poisoned): one launch, the radiance bit for bit the dense
    plain version's (lighting.bvh_hit_mix_plain, an_hit_mix_plain) on the
    lanes live in the mask and the frame's own that the kernel writes
    (the analytic one: the diffuse and the marker lanes), every other
    lane of `out` untouched; and the frame's launches: the BVH frame's
    sky once, one hit-mix launch."""
    from opengl_raytracing_tpu_torch.convert import env_from_numpy
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    preset_name, spp, on_bvh = HIT_MIX_CASES[case]
    env = case in ("full", "an_full")
    params = preset(preset_name).replace(spp_per_frame=spp,
                                         enable_env_map=int(env))
    table = None
    if env:
        faces = np.random.RandomState(4).randint(0, 256, (6, 16, 16, 3))
        table = env_from_numpy(faces.astype(np.uint8), "cuda")
    calls, launches = _hit_mix_calls(params, size, table,
                                     bvh if on_bvh else None)
    assert launches == HIT_MIX_FRAME_LAUNCHES[case]
    name = "bvh_hit_mix" if on_bvh else "an_hit_mix"
    assert [c[0] for c in calls] == [name]
    a = calls[0][1]
    shape = a["radiance"].shape[:-1]
    frame = a["active"].expand(shape)
    want_in = _hit_mix_unread(a, frame)
    args = {k: v for k, v in want_in.items() if k != "active"}
    if on_bvh:
        want = lt.bvh_hit_mix_plain(args["scene"], args["radiance"],
                                    args["gi"], args["ao"])
        writes = torch.ones(shape, dtype=torch.bool, device="cuda")
    else:
        want = lt.an_hit_mix_plain(args["scene"], args["h"],
                                   args["radiance"], args["gi"], args["ao"])
        writes = lt.an_mix_lanes(args["h"].mat, args["scene"].params
                                 ).expand(shape)
        assert bool(writes[frame].any()) and not bool(writes[frame].all())
    g = torch.Generator(device="cuda").manual_seed(spp)
    masks = _mask_cases(shape, a["active"], g)
    for how, mask in masks.items():
        live = (torch.ones(shape, dtype=torch.bool, device="cuda")
                if mask is None else mask.expand(shape))
        written = live & writes
        out = torch.where(written[..., None], args["radiance"],
                          torch.full_like(args["radiance"], SENTINEL))
        before = dict(cuda_lib.LAUNCHES)
        got = getattr(hit_mix_cuda, name)(
            **dict(_hit_mix_poisoned(args, live), radiance=out),
            active=mask)
        assert got is out
        assert _grew(before) == {**{c: 0 for c in before}, name: 1}
        torch.cuda.synchronize()
        both = written & frame
        assert _nan_equal(out[both], want[both]), (case, how)
        assert bool((out[~written] == SENTINEL).all()), (case, how)


def test_hit_mix_wrappers_reject_bad_inputs():
    from opengl_raytracing_tpu_torch.ops import hit_mix_cuda
    scene, h_raw, h, px, py, vdir = _analytic(preset("full"), 8, 8)
    radiance = torch.zeros((8, 8, 3), device="cuda")
    with pytest.raises(TypeError):  # not float32
        hit_mix_cuda.an_hit_mix(scene, h, radiance.double(), None, None,
                                h_raw.valid)
    with pytest.raises(ValueError):  # the mask on another device
        hit_mix_cuda.an_hit_mix(scene, h, radiance, None, None,
                                h_raw.valid.cpu())
    with pytest.raises(ValueError):  # the radiance not contiguous
        hit_mix_cuda.bvh_hit_mix(scene, radiance.transpose(0, 1), None,
                                 None, h_raw.valid)
