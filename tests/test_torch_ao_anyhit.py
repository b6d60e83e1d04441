"""The analytic AO kernel's any-hit rule and culls (csrc/an_trace.cu
an_ao_kernel) against the plain closest-hit rule, on the CPU.

The kernel counts a hemisphere ray as occluded where some primitive has a
valid root t < 1e30 and t < ao_radius (each root its plain expression,
the primitives in any order, stopping at the first); the plain version
(lighting.ambient_occlusion_analytic_plain) takes the closest hit of the
whole scene and tests t < ao_radius.  The kernel also skips, for every
sample of a lane, the spheres beyond kAoReach * (ao_radius + r) +
kAoSlack and the floor beyond ao_radius * kAoReach, and the floor under
a floor lane's hemisphere; per ray, the floor where the signs say t <= 0
and a sphere the ray leaves from outside.  tests/
test_torch_analytic_gates.py transcribes these rules (ao_lanes,
ao_blocked, model_ao), reading kAoReach and kAoSlack from the source, so
a cull loosened there is a cull loosened here.  This file holds them:

(a) on adversarial rays, ray by ray, at ao_radius 0.05, 0.8 and 4.0:
    roots of each sphere and of the floor at ao_radius and within a few
    ulps of it on both sides, grazing rays (disc about 0, |denom| about
    the 1e-6 guard), origins on a sphere's surface (c2 about 0), origins
    at the cull's reach, random rays: the same bit as the plain rule, the
    culls taking part;
(b) on adversarial lanes (floor points round each sphere's foot and far
    away, sphere and marker surfaces, tilted and unnormalized normals,
    points under the floor) at ao_radius 0.05, 0.8 and 4.0 and
    ao_samples 1, 4 and 32: the transcription's AO the plain version's
    bit for bit, some lanes drawing no sample;
(c) at 48x64 against the JAX package: the transcribed AO against
    compute_ao and the transcribed bounce, through the port's GI, against
    one_bounce_gi_analytic, with tests/test_torch_gi_ao.py's tolerances.

On the card, chip_smoke.py's phase an_gates and tests/test_torch_cuda.py
hold the kernel itself to the plain version bit for bit at the same
radii and sample counts.  The file takes a few seconds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu.ops import lighting as jlt

from opengl_raytracing_tpu_torch.constants import EPS
from opengl_raytracing_tpu_torch.ops import an_trace_cuda
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.sampling import FrameValue

from test_torch_analytic_gates import (AO_REACH, AO_SLACK, F32, _consts,
                                       _params, ao_blocked, ao_lanes,
                                       bind_params, model_ao, model_bounce)
from test_torch_gi_ao import (EDGE_FRAC, _ao_counts, _frame, _gi_bad_lanes,
                              _pix)
from test_torch_walk_sampling import _norm

torch.set_num_threads(2)

RADII = [0.05, 0.8, 4.0]
SAMPLES = [1, 4, 32]
MARKER_AT = (0.5, 1.1, -3.0)   # the marker near the spheres and the floor


def _scene_params(radius, samples=4):
    return _params("full", ao_radius=radius, ao_samples=samples,
                   point_light_enabled=1, point_light_pos=MARKER_AT)


def _spheres(s, block):
    """[(centre, r2)] of the albedo, glass and mirror spheres and the
    marker, as the kernel reads them."""
    return ([(F32(list(s.sphere_c[k])), F32(s.sphere_r2[k]))
             for k in range(3)]
            + [(F32(block["point_light_world"]), F32(s.marker_r2))])


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(F32)
    return _norm(v)


def _perp(u, rng):
    """A unit vector perpendicular to each row of u."""
    w = _unit(rng, len(u))
    w = w - u * (w * u).sum(-1, keepdims=True)
    return _norm(w.astype(F32))


def _ulps(x, k):
    """x moved k ulps (float32), elementwise."""
    x = np.asarray(x, F32)
    out = x.copy()
    for _ in range(abs(int(k))):
        out = np.nextafter(out, F32(np.inf) if k > 0 else F32(-np.inf))
    return out


def adversarial_rays(s, block, radius, seed=0):
    """{family: (origins [N, 3], directions [N, 3])} of rays whose plain
    root sits at ao_radius or a few ulps off, graze a sphere or the floor,
    leave a sphere's surface, start at the culls' reach, or go anywhere."""
    rng = np.random.RandomState(seed)
    R = F32(radius)
    out = {}
    o_at, d_at, o_gr, d_gr, o_sf, d_sf, o_rc, d_rc = ([] for _ in range(8))
    for c, r2 in _spheres(s, block):
        r = np.sqrt(r2, dtype=F32)
        # a root at ao_radius: the ray at the centre from R + r, and off
        # centre by e from R + sqrt(r^2 - e^2); each moved by -12..12 ulps
        u = _unit(rng, 64)
        e = (rng.uniform(0.0, 0.9, (64, 1)) * r).astype(F32)
        w = _perp(u, rng)
        back = (R + np.sqrt(r2 - e[:, 0] ** 2).astype(F32)).astype(F32)
        back[:16] = R + r
        e[:16] = 0.0
        for k in range(-12, 13):
            b_k = _ulps(back, k)
            o_at.append((c + w * e - u * b_k[:, None]).astype(F32))
            d_at.append(u)
        # grazing: the ray passes the centre at r (1 + j 2^-22), j -8..8
        u, w = _unit(rng, 32), None
        w = _perp(u, rng)
        for j in range(-8, 9):
            miss = F32(r * (1.0 + j * 2.0 ** -22))
            lead = rng.uniform(0.001, 1.5 * radius + 0.01, (32, 1))
            o_gr.append((c + w * miss - u * lead.astype(F32)).astype(F32))
            d_gr.append(u)
        # origins on the surface and a few ulps off it, any direction
        w = _unit(rng, 64)
        for k in (-3, -1, 0, 1, 3):
            o_sf.append((c + w * _ulps(np.full((64, 1), r), k)).astype(F32))
            d_sf.append(_unit(rng, 64))
        # origins at the sphere's cull reach (and just inside, outside)
        # with rays at the centre and grazing it
        reach = (R + np.sqrt(r2, dtype=F32)) * AO_REACH + AO_SLACK
        u = _unit(rng, 48)
        for k in (-2, 0, 2):
            o = (c - u * _ulps(np.full((48, 1), reach), k)).astype(F32)
            o_rc += [o, o]
            d_rc += [u, _norm((u + _perp(u, rng) * (r / reach)).astype(F32))]
    out["root_at_radius"] = (np.concatenate(o_at), np.concatenate(d_at))
    out["grazing_sphere"] = (np.concatenate(o_gr), np.concatenate(d_gr))
    out["on_surface"] = (np.concatenate(o_sf), np.concatenate(d_sf))
    out["at_reach"] = (np.concatenate(o_rc), np.concatenate(d_rc))
    # the floor (y = 0): roots at ao_radius and ulps off it; grazing rays
    # about the |denom| guard; origins at the floor's cull reach
    n = 256
    d = _unit(rng, n)
    d[:, 1] = -np.abs(d[:, 1]) - F32(0.05)
    d = _norm(d)
    o, dd = [], []
    for k in range(-12, 13):
        h = _ulps(-d[:, 1] * R, k)
        o.append(np.stack([rng.uniform(-6, 6, n), h,
                           rng.uniform(-9, 2, n)], -1).astype(F32))
        dd.append(d)
    out["floor_root_at_radius"] = (np.concatenate(o), np.concatenate(dd))
    d = _unit(rng, n)
    d[:, 1] = F32(rng.choice([5e-7, -5e-7, 1e-6, -1e-6, 1.5e-6, -1.5e-6,
                              0.0], n))
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(-1e-3, 1.0, n),
                  rng.uniform(-9, 2, n)], -1).astype(F32)
    out["floor_grazing"] = (o, d)
    far = R * AO_REACH
    d = _unit(rng, n)
    d[:, 1] = -np.abs(d[:, 1])
    o = np.stack([rng.uniform(-6, 6, n),
                  _ulps(np.full(n, far), rng.randint(-2, 3)),
                  rng.uniform(-9, 2, n)], -1).astype(F32)
    out["floor_at_reach"] = (o, d)
    # anywhere: around the camera and the spheres, any direction
    o = rng.uniform((-3.0, -0.1, -7.0), (3.0, 3.5, 1.0), (2048, 3))
    out["random"] = (o.astype(F32), _unit(rng, 2048))
    return out


def _plain_bits(params, o, d, radius):
    """The plain rule: the closest hit of the whole scene valid and below
    ao_radius (ambient_occlusion_analytic_plain's)."""
    p = bind_params(params)
    h = tsa.trace_analytic(torch.from_numpy(o), torch.from_numpy(d), p,
                           p["point_light_world"])
    return (h.valid & (h.t < p["ao_radius"])).numpy()


@pytest.mark.parametrize("radius", RADII)
def test_any_hit_and_culls_are_the_closest_hit_rule(radius):
    """(a): every adversarial ray's bit under the kernel's rule (its lane
    culls from the origin, the any-hit test with its exact skips) is the
    plain rule's; the culls and both outcomes take part."""
    params = _scene_params(radius)
    s, block = _consts(params)
    eps, R = F32(s.eps), F32(block["ao_radius"])
    seen = dict(blocked=0, clear=0, sphere_culled=0, floor_culled=0)
    for family, (o, d) in adversarial_rays(s, block, radius).items():
        with np.errstate(over="ignore", invalid="ignore"):
            lanes = ao_lanes(s, block, o, R, 1, eps)
            got = ao_blocked(lanes, d, eps, R)
        want = _plain_bits(params, o, d, R)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (family, radius, bad[:8], o[bad[:4]],
                               d[bad[:4]])
        seen["blocked"] += int(want.sum())
        seen["clear"] += int((~want).sum())
        seen["sphere_culled"] += int((~lanes["near"]).sum())
        seen["floor_culled"] += int((~lanes["floor"]).sum())
    assert all(v > 0 for v in seen.values()), seen


def adversarial_lanes(s, block, seed=0):
    """A Hit of lanes at adversarial points: floor points round each
    sphere's foot (n exactly up) and far from every sphere, points on
    the spheres and the marker (unit, scaled and tilted normals), floor
    points with tilted normals and points under the floor (by less than
    ao_bias, and by more: the origin above it, and under it)."""
    rng = np.random.RandomState(seed)
    p, n, mat = [], [], []
    for k, (c, r2) in enumerate(_spheres(s, block)):
        r = np.sqrt(r2, dtype=F32)
        foot = rng.uniform(-2.5, 2.5, (96, 2)) * (1.0 + r)
        p.append(np.stack([c[0] + foot[:, 0], np.zeros(96),
                           c[2] + foot[:, 1]], -1))
        n.append(np.tile([0.0, 1.0, 0.0], (96, 1)))
        mat.append(np.zeros(96))
        w = _unit(rng, 96)
        p.append(c + w * r)
        n.append(w * rng.choice([1.0, 3.0, 0.25], (96, 1)))
        mat.append(np.full(96, k + 1))
    far = np.stack([rng.uniform(-40, 40, 64), np.zeros(64),
                    rng.uniform(-60, -30, 64)], -1)
    p.append(far)
    n.append(np.tile([0.0, 1.0, 0.0], (64, 1)))
    mat.append(np.zeros(64))
    tilt = np.stack([rng.uniform(-3, 3, 64), np.zeros(64),
                     rng.uniform(-6, 0, 64)], -1)
    p.append(tilt)
    n.append(np.stack([rng.uniform(-0.3, 0.3, 64), np.ones(64),
                       rng.uniform(-0.3, 0.3, 64)], -1))
    mat.append(np.zeros(64))
    under = tilt.copy()
    under[:, 1] = np.repeat(F32([-1e-3, -1e-2, -0.1, -0.7]), 16)
    p.append(under)
    n.append(np.tile([0.0, 1.0, 0.0], (64, 1)))
    mat.append(np.zeros(64))
    p, n = (np.concatenate(x).astype(F32) for x in (p, n))
    t = np.ones(len(p), F32)
    return Hit(torch.from_numpy(t), torch.from_numpy(p),
               torch.from_numpy(n),
               torch.from_numpy(np.concatenate(mat).astype(np.int32)))


@pytest.mark.parametrize("samples", SAMPLES)
@pytest.mark.parametrize("radius", RADII)
def test_ao_lanes_are_the_plain_version(radius, samples):
    """(b): the transcribed kernel's AO on adversarial lanes equals
    ambient_occlusion_analytic_plain's bit for bit; some lanes draw no
    sample and some are occluded."""
    params = _scene_params(radius, samples)
    s, block = _consts(params)
    scene = SceneCtx.create(params, torch.tensor([0.0, 1.0, 5.0]))
    h = adversarial_lanes(s, block, seed=samples)
    n = h.t.shape[0]
    px = torch.from_numpy((np.arange(n) % 97 + 0.5).astype(F32))
    py = torch.from_numpy((np.arange(n) // 97 + 0.5).astype(F32))
    fi = FrameValue.of(11, "cpu")
    a, record = an_trace_cuda.ao_args(scene.params, fi)
    stats = {}
    got = model_ao(s, block, a, record, h.p.numpy(), h.n.numpy(),
                   px.numpy(), py.numpy(), stats)
    want = tlt.ambient_occlusion_analytic_plain(scene, h, fi, px, py)
    np.testing.assert_array_equal(got, want.numpy())
    sampled = stats["sampled"]
    assert 0 < sampled.sum() < n, sampled.sum()
    assert (got < 1.0).any()


@pytest.fixture(scope="module")
def an_frame():
    return _frame(False)


@pytest.mark.parametrize("frame_index", [0, 7])
def test_kernel_rules_meet_the_jax_package(an_frame, frame_index,
                                           monkeypatch):
    """(c): at 48x64, the transcribed AO kernel against the JAX package's
    compute_ao (occlusion counts equal but on tie lanes, 0.5% of them at
    most and one sample each) and the transcribed bounce kernel, through
    the port's one_bounce_gi_analytic, against the JAX package's (1e-4 on
    the hit lanes, but edge lanes)."""
    f = an_frame
    scene, hit = f["scene"], f["hit"]
    px, py, jpx, jpy = _pix(f)
    params = scene.params.host
    s, block = _consts(params)
    fv = FrameValue.of(frame_index, "cpu")
    a, record = an_trace_cuda.ao_args(scene.params, fv)
    h = f["h"]
    shape = h.t.shape
    with np.errstate(over="ignore", invalid="ignore"):
        got = model_ao(s, block, a, record, h.p.numpy().reshape(-1, 3),
                       h.n.numpy().reshape(-1, 3), px.numpy().reshape(-1),
                       py.numpy().reshape(-1)).reshape(shape)
    want = np.asarray(jlt.compute_ao(f["jscene"], f["jh"],
                                     jnp.int32(frame_index), jpx, jpy))
    cg = _ao_counts(got[hit], params)
    cw = _ao_counts(want[hit], params)
    tie = cg != cw
    assert tie.mean() <= EDGE_FRAC and (np.abs(cg - cw)[tie] == 1).all()
    assert (cg > 0).sum() >= 5

    def bounce(scene_, h0, rng, seed, px_, py_, active=None):
        b, rec = an_trace_cuda.bounce_args(scene_.params, rng, seed)
        with np.errstate(over="ignore", invalid="ignore"):
            (t, hp, hn, mat), wi, cos = model_bounce(
                s, block, b, rec, h0.p.numpy().reshape(-1, 3),
                h0.n.numpy().reshape(-1, 3), px_.numpy().reshape(-1),
                py_.numpy().reshape(-1), 0)
        sh = h0.t.shape
        return (Hit(torch.from_numpy(t).reshape(sh),
                    torch.from_numpy(hp).reshape(sh + (3,)),
                    torch.from_numpy(hn).reshape(sh + (3,)),
                    torch.from_numpy(mat).reshape(sh)),
                torch.from_numpy(wi).reshape(sh + (3,)),
                torch.from_numpy(cos).reshape(sh))
    monkeypatch.setattr(an_trace_cuda, "bounce", bounce)
    gi = tlt.one_bounce_gi_analytic(scene, h, fv, fv, fv, px, py).numpy()
    jgi = np.asarray(jlt.one_bounce_gi_analytic(
        f["jscene"], f["jh"], jnp.int32(frame_index), jnp.int32(frame_index),
        jnp.int32(frame_index), jpx, jpy))
    assert np.isfinite(gi[hit]).all() and gi[hit].std() > 0.01
    bad = _gi_bad_lanes(gi, jgi, hit)
    assert bad.sum() <= EDGE_FRAC * hit.sum(), bad.sum()


def test_cull_constants_leave_a_margin():
    """The culls' reach is wider than the rule: kAoReach > 1 and
    kAoSlack > 0 (a float32 root moves by far less than 1% of it); every
    cull rests on eps > 0."""
    assert AO_REACH > F32(1.0) and AO_SLACK > F32(0.0)
    assert F32(EPS) > 0


def test_floor_basis_is_build_onb():
    """sampling.cuh build_onb takes the floor normal's basis without its
    normalize: its bits are the plain sampling.build_onb's on normals at
    and about (+0, 1, +0) (signed zeros, subnormal and one-ulp tilts, the
    0.99 switch) and elsewhere."""
    from opengl_raytracing_tpu_torch import sampling as ts
    from test_torch_analytic_gates import _onb
    tiny = np.float32(1e-45)
    special = np.array([[0.0, 1.0, 0.0], [-0.0, 1.0, 0.0], [0.0, 1.0, -0.0],
                        [tiny, 1.0, 0.0], [0.0, 1.0, tiny],
                        [0.0, _ulps(F32(1.0), -1), 0.0], [0.0, -1.0, 0.0],
                        [0.0, 0.99, 0.0], [0.0, _ulps(F32(0.99), -1), 0.0],
                        [1e-4, 1.0, 0.0], [0.0, 0.0, 1.0]], F32)
    rng = np.random.RandomState(5)
    n = np.concatenate([special, _unit(rng, 256)]).astype(F32)
    got = _onb(n)
    want = ts.build_onb(torch.from_numpy(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32),
                                      w.numpy().view(np.uint32))
