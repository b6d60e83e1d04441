"""What the direct-light kernels of csrc/an_direct.cu compute for
themselves, held on the CPU to the plain versions they replace.

The kernels cannot run here, so their per-pixel arithmetic is transcribed
to numpy, reading every constant from the `AnScene` struct that
ops/an_cuda.py builds for the launch, and from the parameter block its
`prm` pointer names (tests/torch_param_block.py):

* the disk offsets (the uint32 hash of sampling.rand, cp_offset's
  rotation, remainder, concentric_sample) bit for bit against
  lighting._disk_offsets.  cos and sin come from the library the plain
  version calls (numpy's float32 cos/sin round an ulp apart from
  torch's); on the card the kernel's cosf/sinf are held to torch's by
  tests/test_torch_cuda.py;
* the gradient sky of the reflected view, bit for bit;
* the material table (the block's rows, the struct's types) against
  get_material and JAX's get_material, exactly, for every id and
  glass/mirror toggle;
* the pixel-centre grids as the kernels index them through the strides
  of the wrappers' `cuda_lib.PixelGrid`, for every memory layout a caller may
  pass, and read in place (no copy) where they are broadcast.

The plain BVH direct light, `direct_light_bvh_plain`, is held to the JAX
package's `direct_light_bvh` at 48x64 on the goldens' bunny scene, to
the K3 tolerance of tests/test_torch_analytic.py (rtol 2e-5 / atol 2e-6),
on the lanes whose radiance the caller keeps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.ops import materials as jmaterials
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import scene_analytic as jsa
from opengl_raytracing_tpu.ops.bvh_traverse import trace_bvh as jtrace_bvh
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import bvh_from_numpy, params_from
from opengl_raytracing_tpu_torch.models import preset
from opengl_raytracing_tpu_torch.models.pipeline import (_sanitize_hit,
                                                         pixel_centers)
from opengl_raytracing_tpu_torch.ops import an_cuda, cuda_lib
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.materials import get_material
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.ops.vecmath import normalize, reflect
from opengl_raytracing_tpu_torch.sampling import FrameValue, frame_record
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

from torch_param_block import block_at

torch.set_num_threads(2)

H, W = 48, 64
TOL_K3 = dict(rtol=2e-5, atol=2e-6)
F32 = np.float32
M32 = 0xFFFFFFFF
WRAP = 2 ** 31 // 1663 + 5  # frame * 1663 wraps int32 here


# ---- numpy transcription of the kernels' per-pixel arithmetic ----

def _lcg(v):
    return v * np.uint32(1664525) + np.uint32(1013904223)


def _hash2(vx, vy):
    vx, vy = _lcg(vx), _lcg(vy)
    vx = vx ^ (vy >> np.uint32(16))
    vy = vy ^ (vx << np.uint32(5))
    return _lcg(vx) ^ _lcg(vy)


def _rand(x, y, kx, ky):
    ux = np.maximum(x, F32(0.0)).astype(np.uint32) ^ np.uint32(kx)
    uy = np.maximum(y, F32(0.0)).astype(np.uint32) ^ np.uint32(ky)
    return _hash2(ux, uy).astype(F32) / F32(4294967296.0)


def _rem1(x):
    m = np.fmod(x, F32(1.0))
    return np.where((m != 0.0) & (m < 0.0), m + F32(1.0), m)


def _concentric(s, ux, uy):
    """(r, phi) of concentric_sample; the caller takes r*cos, r*sin."""
    a = F32(2.0) * ux - F32(1.0)
    b = F32(2.0) * uy - F32(1.0)
    a_dom = np.abs(a) > np.abs(b)
    safe_a = np.where(np.abs(a) > F32(1e-20), a, F32(1.0))
    safe_b = np.where(np.abs(b) > F32(1e-20), b, F32(1.0))
    r = np.where(a_dom, a, b)
    phi = np.where(a_dom, F32(s.pi_4) * (b / safe_a),
                   F32(s.pi_2) - F32(s.pi_4) * (a / safe_b))
    zero = (a == 0.0) & (b == 0.0)
    return np.where(zero, F32(0.0), r), np.where(zero, F32(0.0), phi)


def kernel_keys(s, record):
    """The kernels' RNG keys and ld2, derived as sampling.cuh and cp_rot /
    disk_offset derive them from the struct's frame values and the frame
    record it points to: (cp keys, sample keys, ld)."""
    index = int(record[0]) & M32
    fi = (index * s.cp.a + s.cp.b) & M32
    c1, c2 = (fi * 911) & M32, (fi * 577) & M32
    r = (index * s.smp.a + s.smp.b) & M32
    return ((c1, (c1 * 1663) & M32, c2, (c2 * 1663) & M32),
            (r, (r * 1663) & M32), record[1:3].numpy().view(F32))


def kernel_offsets(s, record, px, py):
    """The kernels' disk_offset for every pixel: [(dx, dy)] * 4."""
    cp_key, smp_key, ld = kernel_keys(s, record)
    rx = _rem1(_rand(px, py, cp_key[0], cp_key[1]) + ld[0])
    ry = _rem1(_rand(py, px, cp_key[2], cp_key[3]) + ld[1])
    out = []
    for k in range(4):
        fk, off = F32(k), F32(31 * k + 7)
        ux = _rand(px + fk, py + fk, smp_key[0], smp_key[1])
        uy = _rand(py + off, px + off, smp_key[0], smp_key[1])
        r, phi = _concentric(s, _rem1(ux + rx), _rem1(uy + ry))
        phi = torch.from_numpy(phi)
        out.append((r * torch.cos(phi).numpy(), r * torch.sin(phi).numpy()))
    return out


def kernel_sky_reflection(s, n, v):
    """The kernels' sky(reflect_view(v, n)) for unit rows n, v."""
    i = -v
    dn = F32(2.0) * (n[..., 0] * i[..., 0] + n[..., 1] * i[..., 1]
                     + n[..., 2] * i[..., 2])
    r = i - n * dn[..., None]
    t = np.clip(F32(0.5) * (r[..., 1] + F32(1.0)), F32(0.0), F32(1.0))
    block = block_at(s.prm)
    top, bottom = block["sky_top"], block["sky_bottom"]
    return top + (bottom - top) * (F32(1.0) - t)[..., None]


def _analytic_scene(**change):
    return SceneCtx.create(preset("baseline").replace(**change),
                           torch.tensor([0.0, 1.0, 4.0]))


@pytest.mark.parametrize("rng_frame,frame_index", [
    (0, 0), (1, 1), (7, 7), (1023, 1023), (1024, 1024), (WRAP, WRAP),
    (3 * 131 + 17, 3), (-2, 5)])
def test_kernel_offsets_match_disk_offsets(rng_frame, frame_index):
    """Bit for bit, on the frame's broadcast pixel grid and on a row band
    further down (row_offset), as the sharded path hands it."""
    frame = FrameValue.of(frame_index, "cpu")
    rng = frame * 0 + rng_frame  # a constant of the record: (0, rng_frame)
    s, record = an_cuda.scene_args(_analytic_scene(), rng, frame)
    for row_offset in (0, 517):
        px, py = pixel_centers(H, W, "cpu", row_offset)
        want = tlt._disk_offsets(rng, frame, px, py)
        got = kernel_offsets(s, record, px.numpy(), py.numpy())
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx.numpy())
            np.testing.assert_array_equal(gy, wy.numpy())
        assert np.abs(got[0][0]).max() > 0.5


@pytest.mark.parametrize("index,spp,s", [(0, 1, 0), (7, 1, 0), (33, 4, 3),
                                         (WRAP, 2, 1)])
def test_kernel_offsets_of_the_device_frame(index, spp, s):
    """The frame's own form: frame_index the record's index, rng_frame the
    seed index * spp + s and the mirror GI's seed * 131 + 17 of it, as
    FrameValues of one record, against the plain offsets of the same
    device frame and of the host ints, each in a record of its own."""
    record = frame_record(index, "cpu")
    frame = FrameValue(record)
    seed, host_seed = frame * spp + s, index * spp + s
    for rng, host_rng in ((seed, host_seed),
                          (seed * 131 + 17, host_seed * 131 + 17)):
        args, got_record = an_cuda.scene_args(_analytic_scene(), rng, frame)
        assert got_record is record
        px, py = pixel_centers(H, W, "cpu", 0)
        got = kernel_offsets(args, record, px.numpy(), py.numpy())
        for want in (tlt._disk_offsets(rng, frame, px, py),
                     tlt._disk_offsets(FrameValue.of(host_rng, "cpu"),
                                       FrameValue.of(index, "cpu"), px,
                                       py)):
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx.numpy())
                np.testing.assert_array_equal(gy, wy.numpy())


def test_kernel_offsets_cover_the_disk_edge_cases():
    """Pixel coordinates below zero truncate to 0, the exact centre of the
    disk (a == b == 0) maps to 0, and off-grid coordinates hash alike."""
    rng = np.random.RandomState(0)
    px = np.concatenate([rng.uniform(-3.0, 2000.0, 512), [-0.5, 0.0, 1e6]])
    py = np.concatenate([rng.uniform(-3.0, 1200.0, 512), [-2.0, 0.5, 3.0]])
    px, py = px.astype(F32), py.astype(F32)
    nine = FrameValue.of(9, "cpu")
    s, record = an_cuda.scene_args(_analytic_scene(), nine, nine)
    want = tlt._disk_offsets(nine, nine, torch.from_numpy(px),
                             torch.from_numpy(py))
    for (gx, gy), (wx, wy) in zip(kernel_offsets(s, record, px, py), want):
        np.testing.assert_array_equal(gx, wx.numpy())
        np.testing.assert_array_equal(gy, wy.numpy())
    r, phi = _concentric(s, np.array([0.5], F32), np.array([0.5], F32))
    assert r[0] == 0.0 and phi[0] == 0.0


def test_kernel_sky_reflection_matches_plain():
    rng = np.random.RandomState(1)
    n = rng.randn(4096, 3).astype(F32)
    v = rng.randn(4096, 3).astype(F32)
    n[:2] = [[0, 1, 0], [0, 1, 0]]
    v[:2] = [[0, 1, 0], [0, -1, 0]]
    tn, tv = normalize(torch.from_numpy(n)), normalize(torch.from_numpy(v))
    scene = _analytic_scene()
    want = scene.sky(reflect(-tv, tn)).numpy()
    zero = FrameValue.of(0, "cpu")
    got = kernel_sky_reflection(an_cuda.scene_args(scene, zero, zero)[0],
                                tn.numpy(), tv.numpy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("glass,mirror", [(1, 1), (0, 1), (1, 0), (0, 0)])
def test_material_table_matches_get_material(glass, mirror):
    """Every id (the marker and unknown ids take the grey fallback row)."""
    params = preset("baseline").replace(
        mat_glass_enabled=glass, mat_mirror_enabled=mirror,
        mat_albedo_color=(0.3, 0.6, 0.2), mat_albedo_spec_strength=0.45,
        mat_albedo_gloss=24.0, mat_glass_color=(0.9, 0.8, 0.6),
        mat_glass_distortion=0.2, mat_mirror_color=(0.9, 0.95, 0.7),
        mat_mirror_gloss=64.0)
    zero = FrameValue.of(0, "cpu")
    s, _ = an_cuda.scene_args(SceneCtx.create(params, torch.zeros(3)), zero,
                              zero)
    block = block_at(s.prm)
    ids = torch.arange(-2, 8, dtype=torch.int32)
    rows = [int(i) if 0 <= i < an_cuda.MAT_ROWS - 1 else an_cuda.MAT_ROWS - 1
            for i in ids]
    jparams = jpreset("baseline").replace(**{
        k: getattr(params, k) for k in (
            "mat_glass_enabled", "mat_mirror_enabled", "mat_albedo_color",
            "mat_albedo_spec_strength", "mat_albedo_gloss",
            "mat_glass_color", "mat_glass_distortion", "mat_mirror_color",
            "mat_mirror_gloss")})
    for want in (get_material(ids, params),
                 jmaterials.get_material(jnp.asarray(ids.numpy()), jparams)):
        np.testing.assert_array_equal(block["mat_albedo"][rows],
                                      np.asarray(want.albedo))
        for field, got in (("spec_strength", block["mat_spec"]),
                           ("gloss", block["mat_gloss"]),
                           ("mtype", s.mat_type)):
            np.testing.assert_array_equal(
                np.array([got[r] for r in rows]).astype(
                    np.asarray(getattr(want, field)).dtype),
                np.asarray(getattr(want, field)), err_msg=field)
    assert sorted(set(s.mat_type)) == sorted(
        {0} | ({2} if glass else set()) | ({1} if mirror else set()))


def _grid_layout(x, layout):
    """The [H, W] grid `x` in a memory layout, as [H, W] (as [2, H, W]
    for "unfoldable", whose leading dims do not fold into one)."""
    return {"broadcast": lambda: x, "contiguous": x.contiguous,
            "transposed": lambda: x.t().contiguous().t(),
            "flat": lambda: x.reshape(-1),
            "unfoldable": lambda: torch.stack([x, x], 1).permute(1, 0, 2),
            }[layout]()


@pytest.mark.parametrize("layout", ["broadcast", "contiguous", "transposed",
                                    "flat", "unfoldable"])
def test_pixel_grid_matches_the_grids(layout):
    """Lane i reads px[(i // cols) * px_sr + (i % cols) * px_sc] of the
    grid's storage (pixel_centre in csrc/sampling.cuh): the grids' values
    in the call's order, and the frame's broadcast grids are not copied."""
    px, py = pixel_centers(H, W, "cpu", 517)
    gx, gy = _grid_layout(px, layout), _grid_layout(py, layout)
    shape = gx.shape
    grid, keep = cuda_lib.pixel_grid(gx, gy, shape, torch.device("cpu"))
    i = np.arange(shape.numel())
    r, c = i // grid.cols, i % grid.cols
    for ptr, sr, sc, x in ((grid.px, grid.px_sr, grid.px_sc, gx),
                           (grid.py, grid.py_sr, grid.py_sc, gy)):
        held = [k for k in keep if k.data_ptr() == ptr][0]
        storage = torch.tensor([], dtype=torch.float32).set_(
            held.untyped_storage()).numpy()
        base = (ptr - held.untyped_storage().data_ptr()) // 4
        np.testing.assert_array_equal(storage[base + r * sr + c * sc],
                                      x.reshape(-1).numpy())
    if layout == "broadcast":
        assert (grid.px, grid.py) == (px.data_ptr(), py.data_ptr())
        assert (grid.px_sr, grid.py_sc) == (0, 0)


@pytest.fixture(scope="module")
def bunny():
    """Primary hits of the goldens' bunny scene (make_bunny(2), the camera
    at fov 12 on the bunny) from the JAX walker, with the pixel centres
    and view directions both sides shade with."""
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
    px, py = np.meshgrid(np.arange(W, dtype=F32) + 0.5,
                         np.arange(H, dtype=F32) + 0.5)
    x = (px / W * 2 - 1) * thf * cam.aspect
    y = (py / H * 2 - 1) * thf
    rd = fwd + x[..., None] * right + y[..., None] * up
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(F32)
    ro = np.broadcast_to(cam.position, rd.shape).astype(F32)
    jh = jtrace_bvh(jbvh.arrays, jnp.asarray(ro), jnp.asarray(rd))
    hit = np.array(jh.valid)
    assert 0.2 < hit.mean() < 0.9
    h = tsa.Hit(*(torch.from_numpy(np.array(x)) for x in jh))
    h = _sanitize_hit(h, torch.from_numpy(ro), torch.from_numpy(rd))
    return dict(jbvh=jbvh, bvh=bvh, cam_pos=cam.position, h=h, hit=hit,
                px=px, py=py, rd=rd)


@pytest.mark.parametrize("variant", [
    dict(), dict(sun_enabled=0), dict(point_light_enabled=0, sky_enabled=0)])
@pytest.mark.parametrize("frame_index,masked", [(0, True), (1024, False)])
def test_direct_light_bvh_plain_matches_jax(bunny, variant, frame_index,
                                            masked):
    jparams = jpreset("baseline").replace(**variant)
    jscene = JSceneCtx.create(jparams, jnp.asarray(bunny["cam_pos"]),
                              use_bvh=True, bvh=bunny["jbvh"])
    scene = SceneCtx.create(params_from(jparams),
                            torch.from_numpy(bunny["cam_pos"]), use_bvh=True,
                            bvh=bunny["bvh"])
    h, hit = bunny["h"], bunny["hit"]
    px, py, rd = bunny["px"], bunny["py"], bunny["rd"]
    active = torch.from_numpy(hit) if masked else None
    fv = FrameValue.of(frame_index, "cpu")
    args = (scene, h, fv, fv, torch.from_numpy(-rd),
            torch.from_numpy(px), torch.from_numpy(py), active)
    before = dict(cuda_lib.LAUNCHES)
    got = tlt.direct_light_bvh(*args).numpy()
    assert cuda_lib.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(got,
                                  tlt.direct_light_bvh_plain(*args).numpy())
    want = np.asarray(jlt.direct_light_bvh(
        jscene, jsa.Hit(*(jnp.asarray(x.numpy()) for x in h)),
        jnp.int32(frame_index), jnp.int32(frame_index), jnp.asarray(-rd),
        jnp.asarray(px), jnp.asarray(py),
        active=jnp.asarray(hit) if masked else None))
    assert np.isfinite(got).all() and got[hit].std() > 0.01
    np.testing.assert_allclose(got[hit], want[hit], **TOL_K3)
