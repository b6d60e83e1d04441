"""The schedule of the present-pass kernels of csrc/svgf.cu, held on the
CPU to the plain versions they replace.

The kernels cannot run here, so what they do is transcribed to numpy block
by block, with the source's numbers (run length, output tile, run stride):

* `load_tile`: the halo tile staged in three planes (r g b px | py pz nx
  ny | nz), the normal normalised once, zeros outside the image, each tile
  row's columns run-strided (`tile_at`);
* `filter_runs`: a thread's run of pixels along a row, each tile pixel
  read once per tile row and used for every pixel of the run it is a tap
  of, taps dy outer and dx inner; interior blocks with no bounds test, rim
  blocks skipping tile rows and pixels outside the image; runs that
  straddle the right edge;
* the tail (`tone_channel`): strength blend, exposure, ACES, clamp, gamma;
* `tonemap_kernel`: four pixels a thread and the ragged last thread;
* a row band of the image (the filter entries' `halo`, `row0`,
  `full_h`): the planes' halo rows, the taps' rows tested in the image,
  the interior test on the band's rows, planes and image, and the partial
  last block row of a 270-row band (1080 rows over 4 cards).

The transcription equals `svgf_filter` and `present_plain` bit for bit
(sqrt, exp and pow are torch's, as the plain versions call them: torch's
vectorised CPU sqrt is not always correctly rounded, numpy's is; pow is
applied image-wide, see `tone_channel`).  The
layout is held to what the source's header says of it: every tile pixel a
slot of its own, a warp's 16-byte and 4-byte loads free of bank conflicts,
and the interior test true exactly where the whole halo tile is inside.

`present` on CPU tensors launches nothing, and the wrappers' CPU branches
agree with the JAX package's `present` to 1e-5 (elementwise float32).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.ops import svgf as jsvgf

from opengl_raytracing_tpu_torch.convert import params_from
from opengl_raytracing_tpu_torch.models import param_block, preset
from opengl_raytracing_tpu_torch.ops import cuda_lib, svgf_cuda
from opengl_raytracing_tpu_torch.ops import svgf as tsvgf
from opengl_raytracing_tpu_torch.ops.tonemap import visualize_motion
from opengl_raytracing_tpu_torch.params import f32

torch.set_num_threads(2)

F32 = np.float32
RADIUS, TAPS = 3, 7
YC = np.float32([0.299, 0.587, 0.114])
SIZES = [(37, 131), (1, 1), (3, 300), (40, 33), (70, 96)]


# the numbers of csrc/svgf.cu (test_constants_are_the_sources holds them
# to it): pixels a run, the output tile, the run stride of a tile row
RUN, BX, BY, STRIDE = 2, 32, 16, 24
THREADS_X = BX // RUN
TX, TY = BX + 2 * RADIUS, BY + 2 * RADIUS
PITCH = STRIDE * RUN
COLS = RUN + 2 * RADIUS


def _tsqrt(x):
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _texp(x):
    return torch.exp(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _tpow(x, e):
    return torch.pow(torch.from_numpy(np.ascontiguousarray(x)), e).numpy()


def tile_at(ty, tx):
    return ty * PITCH + (tx % RUN) * STRIDE + tx // RUN


def interior(bx0, by0, h, w, halo=0, row0=0, full_h=None):
    """svgf_block's test, for the h output rows of a band with `halo`
    rows of planes above and below, at row `row0` of a `full_h` image."""
    full_h = h if full_h is None else full_h
    return (bx0 >= RADIUS and bx0 + BX + RADIUS <= w and by0 + BY <= h
            and by0 - RADIUS >= -halo and by0 + BY + RADIUS <= h + halo
            and row0 + by0 - RADIUS >= 0
            and row0 + by0 + BY + RADIUS <= full_h)


# ---- numpy transcription of the kernels ----

def load_tile(accum, gpos, gnrm, x0, y0, inside, halo=0):
    """Planes a [slots,4], b [slots,4], c [slots] of one block; the input
    planes hold h output rows and `halo` more above and below."""
    w = accum.shape[1]
    h = accum.shape[0] - 2 * halo
    a = np.full((PITCH * TY, 4), np.nan, F32)
    b = np.full((PITCH * TY, 4), np.nan, F32)
    c = np.full(PITCH * TY, np.nan, F32)
    k = np.arange(TX * TY)
    ty, tx = k // TX, k % TX
    gx, gy = x0 + tx, y0 + ty
    ok = (gx >= 0) & (gx < w) & (gy >= -halo) & (gy < h + halo)
    if inside:  # no test in the kernel: every load must be in the planes
        assert ok.all()
    va = np.zeros((k.size, 4), F32)
    vb = np.zeros((k.size, 4), F32)
    vc = np.zeros(k.size, F32)
    col, pos, nrm = (x[gy[ok] + halo, gx[ok]] for x in (accum, gpos, gnrm))
    nx, ny, nz = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    d = np.maximum(nx * nx + ny * ny + nz * nz, F32(0.0))
    length = np.maximum(_tsqrt(d), F32(1e-12))
    va[ok] = np.stack([col[:, 0], col[:, 1], col[:, 2], pos[:, 0]], -1)
    vb[ok] = np.stack([pos[:, 1], pos[:, 2], nx / length, ny / length], -1)
    vc[ok] = nz / length
    t = tile_at(ty, tx)
    a[t], b[t], c[t] = va, vb, vc
    return a, b, c


def centre_of(va, vb, vc, m2, mx, my, prm):
    var_max, k_var0, k_col0, k_var_m, k_col_m = (F32(x) for x in prm)
    ce = dict(r=va[..., 0], g=va[..., 1], b=va[..., 2], px=va[..., 3],
              py=vb[..., 0], pz=vb[..., 1], nx=vb[..., 2], ny=vb[..., 3],
              nz=vc)
    lum = ce["r"] * YC[0] + ce["g"] * YC[1] + ce["b"] * YC[2]
    var_c = np.clip(m2 - lum * lum, F32(0.0), var_max)
    mot = _tsqrt(mx * mx + my * my)
    t = np.clip((mot - F32(0.005)) / F32(0.05 - 0.005), F32(0.0), F32(1.0))
    t = t * t * (F32(3.0) - F32(2.0) * t)
    k_var = k_var0 + (k_var_m - k_var0) * t
    k_color = k_col0 + (k_col_m - k_col0) * t
    ce["var_boost"] = F32(1.0) + var_c * (F32(1.0) + k_var * F32(0.5))
    ce["w_off"] = ce["var_boost"] * (F32(1.0) + var_c * F32(4.0))
    ce["k_col"] = k_color * F32(0.3) + F32(0.05)
    return ce


def tone_channel(raw, fil, tone):
    """tone_channel up to its powf, which `gamma` applies to the whole
    image at once: torch's CPU pow rounds an element of a vector's ragged
    tail an ulp apart from the same element inside a full vector, so the
    transcription calls it on the plain version's layout."""
    s, exposure = (F32(x) for x in tone)
    lin = raw + (fil - raw) * s
    x = lin * exposure
    m = ((x * (F32(2.51) * x + F32(0.03)))
         / (x * (F32(2.43) * x + F32(0.59)) + F32(0.14)))
    return np.clip(m, F32(0.0), F32(1.0))


def gamma(m):
    # the exponent as the plain version hands it to torch (a double: its
    # CPU pow takes a vector's ragged tail through std::pow(float, double))
    return _tpow(m, 1.0 / 2.2)


def filter_runs(a, b, c, accum, motion, bx0, by0, inside, prm, tone, out,
                halo=0, row0=0, full_h=None):
    """One block's threads, all at once: arrays over [BY, THREADS_X]; the
    planes hold `halo` rows above and below the h output rows, which
    start at row `row0` of a `full_h` image."""
    w = accum.shape[1]
    h = accum.shape[0] - 2 * halo
    full_h = h if full_h is None else full_h
    tx, ty = np.meshgrid(np.arange(THREADS_X), np.arange(BY))
    xs, y = bx0 + tx * RUN, by0 + ty
    live = np.ones_like(xs, bool) if inside else (xs < w) & (y < h)
    t0 = ty * PITCH + tx
    yc = np.minimum(y, h - 1)  # threads that returned: any valid address
    ce, acc = [], []
    for j in range(RUN):
        t = t0 + tile_at(RADIUS, j + RADIUS)
        inb = np.ones_like(xs, bool) if inside else xs + j < w
        xc = np.minimum(np.where(inb, xs + j, xs), w - 1)
        if inside:
            assert (xs + j < w).all() and (y < h).all()
        ce.append(centre_of(a[t], b[t], c[t], accum[yc + halo, xc, 3],
                            motion[yc + halo, xc, 0],
                            motion[yc + halo, xc, 1], prm))
        acc.append([np.zeros(xs.shape, F32) for _ in range(4)])
    for r in range(TAPS):
        gy = row0 + y - RADIUS + r  # the tap row in the image
        row_ok = np.ones_like(xs, bool) if inside else \
            (gy >= 0) & (gy < full_h)
        for col in range(COLS):
            gx = xs - RADIUS + col
            ok = row_ok if inside else row_ok & (gx >= 0) & (gx < w)
            t = t0 + tile_at(r, col)
            va, vb, vc = a[t], b[t], c[t]   # read once, used by the run
            assert not np.isnan(va[ok & live]).any()
            for j in range(RUN):
                dx = col - j
                if dx < 0 or dx >= TAPS:
                    continue
                p = ce[j]
                dr, dg, db = va[..., 0] - p["r"], va[..., 1] - p["g"], \
                    va[..., 2] - p["b"]
                dc2 = dr * dr + dg * dg + db * db
                qx, qy, qz = va[..., 3] - p["px"], vb[..., 0] - p["py"], \
                    vb[..., 1] - p["pz"]
                dist2 = qx * qx + qy * qy + qz * qz
                nd = p["nx"] * vb[..., 2] + p["ny"] * vb[..., 3] + p["nz"] * vc
                ndist = F32(1.0) - np.clip(nd, F32(-1.0), F32(1.0))
                expo = dc2 * p["k_col"] + dist2 * F32(0.02) + ndist * F32(2.0)
                base = p["var_boost"] if (dx == RADIUS and r == RADIUS) \
                    else p["w_off"]
                with np.errstate(invalid="ignore"):
                    wgt = base * _texp(-expo)
                rgbw = (va[..., 0] * wgt, va[..., 1] * wgt, va[..., 2] * wgt,
                        wgt)
                for k in range(4):  # a skipped tap leaves the sums alone
                    acc[j][k] = np.where(ok, acc[j][k] + rgbw[k], acc[j][k])
    for j in range(RUN):
        ar, ag, ab, aw = acc[j]
        store = live if inside else live & (xs + j < w)
        den = np.maximum(aw, F32(1e-20))
        keep = aw <= 0.0
        with np.errstate(invalid="ignore", divide="ignore"):
            fil = [np.where(keep, ce[j][n], s / den)
                   for n, s in (("r", ar), ("g", ag), ("b", ab))]
        if tone is not None:
            fil = [tone_channel(ce[j][n], f, tone)
                   for n, f in zip("rgb", fil)]
        out[y[store], (xs + j)[store]] = np.stack(fil, -1)[store]


def kernel_svgf(accum, motion, gpos, gnrm, prm, tone=None, halo=0, row0=0,
                full_h=None):
    """ort_svgf (tone None) or ort_svgf_present, block by block, on the
    whole image or on a band (planes with `halo` rows above and below the
    band's, which starts at row `row0` of a `full_h` image)."""
    h, w = accum.shape[0] - 2 * halo, accum.shape[1]
    out = np.full((h, w, 3), np.nan, F32)
    n_inside = 0
    for by0 in range(0, h, BY):
        for bx0 in range(0, w, BX):
            inside = interior(bx0, by0, h, w, halo, row0, full_h)
            n_inside += inside
            planes = load_tile(accum, gpos, gnrm, bx0 - RADIUS, by0 - RADIUS,
                               inside, halo)
            filter_runs(*planes, accum, motion, bx0, by0, inside, prm, tone,
                        out, halo, row0, full_h)
    return (out if tone is None else gamma(out)), n_inside


def kernel_tonemap(accum, tone, pixels=4):
    """tonemap_kernel: thread i takes pixels 4i..4i+3 of the flat image."""
    h, w = accum.shape[:2]
    n = h * w
    flat = accum.reshape(n, 4)
    out = np.full((n, 3), np.nan, F32)
    i0 = np.arange(0, n, pixels)
    for k in range(pixels):
        i = np.minimum(i0 + k, n - 1)  # past the end: the last pixel again
        v = np.stack([tone_channel(flat[i, ch], flat[i, ch], tone)
                      for ch in range(3)], -1)
        store = i0 + k < n
        out[(i0 + k)[store]] = v[store]
    return gamma(out.reshape(h, w, 3))


# ---- inputs ----

def _inputs(h, w, seed, sky=0.25):
    rng = np.random.RandomState(seed)
    col = (0.9 + 0.5 * rng.randn(h, w, 3)).astype(F32)   # HDR: ACES matters
    m2 = (col @ YC) ** 2 + rng.uniform(0.0, 0.08, (h, w)).astype(F32)
    accum = np.concatenate([col, m2[..., None]], -1).astype(F32)
    motion = (0.03 * rng.randn(h, w, 2)).astype(F32)
    gpos = (rng.randn(h, w, 3) * 0.3).astype(F32)
    gnrm = (rng.randn(h, w, 3) * 2.0).astype(F32)      # not unit length
    is_sky = rng.rand(h, w) < sky                      # as the frame writes
    gpos[is_sky] = 0.0
    gnrm[is_sky] = 0.0
    return accum, motion, gpos, gnrm


def _t(x):
    return torch.from_numpy(x)


def _prm(params):
    """The five svgf_* words the kernel reads from the parameter block."""
    block = param_block.views(torch.from_numpy(param_block.pack(params)))
    return tuple(float(block[f"svgf_{k}"]) for k in (
        "var_max", "k_var", "k_color", "k_var_motion", "k_color_motion"))


# ---- tests ----

def test_constants_are_the_sources():
    with open(os.path.join(cuda_lib._CSRC, "svgf.cu")) as fh:
        src = fh.read()
    for line in (f"constexpr int kRun = {RUN};",
                 f"constexpr int kBX = {BX}, kBY = {BY};",
                 f"constexpr int kStride = {STRIDE};",
                 f"constexpr int kRadius = {RADIUS}, kTaps = 2 * kRadius + 1;",
                 "constexpr int kTonePixels = 4, kToneThreads = 256;"):
        assert src.count(line) == 1, line


@pytest.mark.parametrize("size", SIZES)
def test_filter_schedule_matches_plain_filter(size):
    inputs = _inputs(*size, seed=sum(size))
    params = preset("full")
    got, n_inside = kernel_svgf(*inputs, _prm(params))
    want = tsvgf.svgf_filter(*(_t(x) for x in inputs), params).numpy()
    np.testing.assert_array_equal(got, want)
    # the sizes with room for one take the interior body too
    assert (n_inside > 0) == (size[0] >= 2 * BY + RADIUS
                              and size[1] >= 2 * BX + RADIUS)


@pytest.mark.parametrize("change", [
    dict(svgf_var_max=0.01), dict(svgf_k_var=2.5), dict(svgf_k_color=0.4),
    dict(svgf_k_var_motion=0.2), dict(svgf_k_color_motion=3.0)])
def test_filter_schedule_takes_each_parameter(change):
    inputs = _inputs(37, 131, seed=3)
    params = preset("full").replace(**change)
    got, _ = kernel_svgf(*inputs, _prm(params))
    want = tsvgf.svgf_filter(*(_t(x) for x in inputs), params).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sky", [0.0, 1.0])
def test_filter_schedule_all_surface_and_all_sky(sky):
    inputs = _inputs(37, 131, seed=11, sky=sky)
    params = preset("full")
    got, _ = kernel_svgf(*inputs, _prm(params))
    want = tsvgf.svgf_filter(*(_t(x) for x in inputs), params).numpy()
    np.testing.assert_array_equal(got, want)


def test_zero_weight_pixel_keeps_its_colour():
    """The kernel's `aw <= 0` branch, as the plain version's where(): with
    k_var = -4 and the variance clamped at var_max = 1 the variance boost
    is 1 + 1 * (1 - 2) = 0, so every tap of such a pixel weighs 0."""
    accum, motion, gpos, gnrm = _inputs(9, 40, seed=2)
    accum[2:7, 5:30, 3] += F32(4.0)   # variance far above var_max
    params = preset("full").replace(svgf_var_max=1.0, svgf_k_var=-4.0,
                                    svgf_k_var_motion=-4.0)
    got, _ = kernel_svgf(accum, motion, gpos, gnrm, _prm(params))
    want = tsvgf.svgf_filter(_t(accum), _t(motion), _t(gpos), _t(gnrm),
                             params).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2:7, 5:30], accum[2:7, 5:30, :3])
    assert np.abs(got[0] - accum[0, :, :3]).max() > 1e-3  # filtered elsewhere


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("strength", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("exposure", [1.0, 0.6])
def test_present_schedule_matches_plain_present(size, strength, exposure):
    inputs = _inputs(*size, seed=sum(size) + 1)
    params = preset("full").replace(svgf_strength=strength,
                                    exposure=exposure)
    got, _ = kernel_svgf(*inputs, _prm(params), tsvgf.tone_params(params))
    want = tsvgf.present_plain(*(_t(x) for x in inputs), params).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_present_strength_is_clamped_on_the_host():
    params = preset("full")
    assert tsvgf.tone_params(params.replace(svgf_strength=1.7))[0] == 1.0
    assert tsvgf.tone_params(params.replace(svgf_strength=-0.2))[0] == 0.0
    inputs = _inputs(20, 45, seed=8)
    got, _ = kernel_svgf(*inputs, _prm(params), tsvgf.tone_params(
        params.replace(svgf_strength=1.7)))
    want = tsvgf.present_plain(*(_t(x) for x in inputs),
                               params.replace(svgf_strength=1.7)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES + [(2, 2), (5, 205)])
@pytest.mark.parametrize("exposure", [1.0, 0.6])
def test_tonemap_schedule_matches_plain_present(size, exposure):
    accum = _inputs(*size, seed=sum(size) + 2)[0]
    params = preset("baseline").replace(exposure=exposure)
    assert not params.enable_svgf
    got = kernel_tonemap(accum, tsvgf.tone_params(params))
    want = tsvgf.present_plain(_t(accum), None, None, None, params).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(1080, 1920), (600, 800), (37, 131),
                                  (22, 38), (21, 38), (22, 37), (1, 1)])
def test_interior_blocks_are_those_with_the_whole_tile_inside(size):
    h, w = size
    n_inside = 0
    for by0 in range(0, h, BY):
        for bx0 in range(0, w, BX):
            whole = (bx0 - RADIUS >= 0 and by0 - RADIUS >= 0
                     and bx0 - RADIUS + TX - 1 <= w - 1
                     and by0 - RADIUS + TY - 1 <= h - 1)
            assert interior(bx0, by0, h, w) == whole
            n_inside += whole
    if size == (1080, 1920):  # all but the rim takes the fast body
        blocks = -(-h // BY) * -(-w // BX)
        assert n_inside >= 0.9 * blocks


# bands: (image height, width, band rows, first row, halo).  1080 rows
# over 4 cards give 270-row bands, whose last block row is partial (270 =
# 16 * 16 + 14); the middle bands take the body without tests on every
# other block row, their halo rows in the planes; the first and last have
# the image's edge; halo 1 and 0 read zeros past the planes where the
# image goes on (as the plain version pads)
BANDS = [(1080, 96, 270, 270, 3), (1080, 96, 270, 810, 3),
         (1080, 96, 270, 0, 3), (32, 64, 8, 8, 3), (37, 131, 12, 24, 3),
         (40, 70, 20, 10, 1), (40, 70, 20, 10, 0)]


def _band_inputs(full_h, w, bh, row0, halo, seed):
    """The whole image's planes, and the band's with `halo` rows of the
    image above and below it (zeros past the image's edge, as the ring
    shifts deliver them)."""
    whole = _inputs(full_h, w, seed)
    band = []
    for x in whole:
        pad = np.zeros((halo,) + x.shape[1:], F32)
        band.append(np.ascontiguousarray(np.concatenate([pad, x, pad])[
            row0:row0 + bh + 2 * halo]))
    return whole, band


@pytest.mark.parametrize("band", BANDS[:2] + BANDS[3:])
def test_band_filter_schedule_matches_plain_band_filter(band):
    full_h, w, bh, row0, halo = band
    whole, ext = _band_inputs(full_h, w, bh, row0, halo, seed=bh + row0)
    params = preset("full")
    got, n_inside = kernel_svgf(*ext, _prm(params), halo=halo, row0=row0,
                                full_h=full_h)
    want = tsvgf.svgf_filter(*(_t(x) for x in ext), params, halo=halo,
                             row_offset=row0, full_height=full_h).numpy()
    np.testing.assert_array_equal(got, want)
    if halo == RADIUS:  # with its halo a band is the whole image's rows
        full = tsvgf.svgf_filter(*(_t(x) for x in whole), params).numpy()
        np.testing.assert_array_equal(got, full[row0:row0 + bh])
    if bh == 270:  # the interior body runs, and the partial block row too
        assert n_inside > 0 and bh % BY
        assert not np.isnan(got).any()


# bands of whole vectors: the band's pow sees the whole image's lanes
@pytest.mark.parametrize("band", [BANDS[2], BANDS[3]])
@pytest.mark.parametrize("strength", [0.7, 1.0])
def test_band_present_schedule_matches_plain_band_present(band, strength):
    full_h, w, bh, row0, halo = band
    whole, ext = _band_inputs(full_h, w, bh, row0, halo, seed=bh + 1)
    params = preset("full").replace(svgf_strength=strength)
    got, _ = kernel_svgf(*ext, _prm(params), tsvgf.tone_params(params),
                         halo=halo, row0=row0, full_h=full_h)
    want = tsvgf.present_plain(*(_t(x) for x in ext), params, halo=halo,
                               row_offset=row0, full_height=full_h).numpy()
    np.testing.assert_array_equal(got, want)
    full = tsvgf.present_plain(*(_t(x) for x in whole), params).numpy()
    np.testing.assert_array_equal(got, full[row0:row0 + bh])


@pytest.mark.parametrize("band", BANDS)
def test_band_interior_blocks(band):
    """The interior test of a band: every output row in the band, the
    whole halo tile in the planes (band and halo rows) and in the image.
    1080 over 4: the middle bands' every block row but the partial last
    one, the first band's from the second on."""
    full_h, w, bh, row0, halo = band
    rows = []
    for by0 in range(0, bh, BY):
        whole = (by0 + BY <= bh and by0 - RADIUS >= -halo
                 and by0 + BY + RADIUS <= bh + halo
                 and row0 + by0 - RADIUS >= 0
                 and row0 + by0 + BY + RADIUS <= full_h)
        for bx0 in range(0, w, BX):
            cols = bx0 - RADIUS >= 0 and bx0 + BX + RADIUS <= w
            assert interior(bx0, by0, bh, w, halo, row0, full_h) == (
                whole and cols)
        rows.append(whole)
    if bh == 270:
        assert rows[-1] is False  # the partial last block row
        assert all(rows[1:-1]) and rows[0] == (row0 > 0)


def test_tile_layout():
    """Every tile pixel has a slot of its own, and a warp's loads of one tap
    column are free of bank conflicts: the 4-byte plane on 32 distinct
    banks, each quarter warp's 16-byte loads on 8 distinct 16-byte lanes."""
    ty, tx = np.meshgrid(np.arange(TY), np.arange(TX), indexing="ij")
    slots = tile_at(ty, tx).ravel()
    assert len(set(slots)) == TX * TY and slots.max() < PITCH * TY
    tid = np.arange(32)
    wx, wy = tid % THREADS_X, tid // THREADS_X
    for r in range(TAPS):
        for col in range(COLS):
            t = (wy + r) * PITCH + wx + tile_at(0, col)
            np.testing.assert_array_equal(
                t, tile_at(wy + r, wx * RUN + col))
            assert len(set(t % 32)) == 32
            for quarter in range(4):
                assert len(set(t[8 * quarter:8 * quarter + 8] % 8)) == 8


@pytest.mark.parametrize("svgf", [1, 0])
@pytest.mark.parametrize("half_texel", ["0", "1"])
def test_present_on_cpu_launches_nothing(monkeypatch, svgf, half_texel):
    monkeypatch.setenv("ORT_PRESENT_HALF_TEXEL", half_texel)
    inputs = [_t(x) for x in _inputs(24, 40, seed=4)]
    params = preset("full").replace(enable_svgf=svgf)
    before = dict(cuda_lib.LAUNCHES)
    kept = inputs[0].clone()
    got = tsvgf.present(*inputs, params)
    assert cuda_lib.LAUNCHES == before
    assert torch.equal(inputs[0], kept)  # the accumulation is only read
    if half_texel == "1":
        inputs = [tsvgf._half_texel(x) for x in inputs]
    assert torch.equal(got, tsvgf.present_plain(*inputs, params))
    # the motion view: the wheel of the (shifted) motion, no launch either
    wheel = tsvgf.present(*inputs, params, show_motion=True)
    assert cuda_lib.LAUNCHES == before
    motion = tsvgf._half_texel(inputs[1]) if half_texel == "1" else inputs[1]
    assert torch.equal(wheel, visualize_motion(motion,
                                               f32(params.motion_scale)))


@pytest.mark.parametrize("svgf", [1, 0])
def test_wrappers_on_cpu_match_jax_present(svgf):
    """svgf_present and tonemap on CPU tensors (their plain versions)
    against the JAX package's present, SVGF on and off."""
    inputs = _inputs(24, 64, seed=6)
    jparams = jpreset("full").replace(enable_svgf=svgf, exposure=0.8)
    params = params_from(jparams)
    before = dict(cuda_lib.LAUNCHES)
    if svgf:
        got = svgf_cuda.svgf_present(*(_t(x) for x in inputs), params)
    else:
        got = svgf_cuda.tonemap(_t(inputs[0]), params)
    assert cuda_lib.LAUNCHES == before
    want = np.asarray(jsvgf.present(*(jnp.asarray(x) for x in inputs),
                                    jparams, allow_pallas=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
