"""The analytic scene's live-lane kernels (csrc/an_trace.cu: the trace,
AO, GI bounce and sky kernels behind ops/an_trace_cuda.py; csrc/
an_shade.cu: glass's and the mirror's rays and mix kernels behind
ops/an_shade_cuda.py), on the CPU.

The frame hands each of these calls a device mask of the lanes that read
its result (models/pipeline.py:_shade_analytic, ops/lighting.py), the
port's form of the JAX package's occupancy gates; on the card the kernel
computes those lanes alone and leaves the others unwritten.  The kernels
cannot run here, so:

(a) the masks bite on the CPU: each wrapper is replaced by one that fills
    every lane its mask marks dead with garbage (NaN, or values that look
    like a hit: t = 0.5, a mirror's material id), and the frames rendered
    so must equal the unwrapped frames bit for bit (the analytic presets,
    the gradient sky and a cubemap, 1 and 2 samples, mirror and glass
    off and on); each call's mask is the one the frame is meant to hand
    (the sky: the misses of its select; the secondaries: the mirror and
    glass lanes) and the frame reads no other lane.  Each kernel's lanes
    as the kernel reads them (`an_trace_cuda.lane_input`: a row a lane, a
    row a pixel of the samples' shared hit, one row for every lane),
    computed on the live lanes alone by (c)'s transcription, equal the
    dense plain version there bit for bit, for the frame's own masks,
    none, a partial one and an empty one, at 1 and 2 samples;
(b) the port's frame meets the JAX package's gated frames
    (ORT_ANALYTIC_GATE_FRAC 0.5 with ORT_SKY_MISS_GATE 0.9 under a random
    environment; ORT_ANALYTIC_GATE_FRAC 1e-6, its dense fallback, with
    ORT_AN_HIT_GATE 0.9; under jax.disable_jit, so that each lax.cond runs
    the one branch it takes) within tests/test_torch_analytic.py's frame
    tolerance, rtol and atol 1e-4, plus the JAX gates' own 1e-5
    (tests/test_pipeline.py), at 32x128: a width of 128 lanes, so that
    the JAX tile gates apply;
(c) a numpy transcription of the kernels' per-lane rules (an_scene.cuh's
    trace_closest and an_lanes.cuh's hit_out: the primitive order, the
    floor's denominator guard, valid & t < best, the miss's bits, the
    winner's normal; the AO rays at offsets 37i+3 / 19i+11 from a
    lane's origin, sphere terms and basis built once, each an any-hit
    test within ao_radius behind the kernel's culls (ao_lanes,
    ao_blocked; kAoReach and kAoSlack read from csrc/an_trace.cu; tests/
    test_torch_ao_anyhit.py holds them on adversarial rays), and
    _ao_value's remap; the bounce ray at offsets seed*13 / seed*37 of the
    lane's sample, both kernels' basis taken without its normalize on
    the floor's normal (build_onb); the gradient sky and the
    cubemap times its intensity; glass's setup, refract, its three
    secondaries, views and skies where the mix reads them, the mirror's
    reflected ray, and both mixes' selects, mixes and Fresnel term),
    reading every constant from the structs the wrappers build, equals
    the plain versions bit for bit (the mirror's GI tail with the CPU's
    cos / PI: on the card the kernel and PyTorch multiply by the float32
    reciprocal);
(d) tests/torch_recorder.py sees the same operations and host arguments
    at several frame indices and parameter sets with the masks in place,
    and no host read.

cos, sin and sqrt in the transcription come from torch, as the plain
versions call them (tests/test_torch_walk_sampling.py); on the card the
kernels' IEEE forms are held to PyTorch's by tests/test_torch_cuda.py
and chip_smoke.py's phase an_gates.  The file takes ~40 s alone:
    python -m pytest tests/test_torch_analytic_gates.py -q
"""

import contextlib
import os

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

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.constants import EPS
from opengl_raytracing_tpu_torch.convert import (camera_frame_inputs,
                                                 env_from_numpy,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (RenderState, preset,
                                                render_frame)
from opengl_raytracing_tpu_torch.models.pipeline import render_staged
from opengl_raytracing_tpu_torch.ops import (an_cuda, an_shade_cuda,
                                             an_trace_cuda)
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)
from opengl_raytracing_tpu_torch.utils import image as timage

from test_torch_cubemap import kernel_sample_cubemap
from test_torch_walk_sampling import (M32, _cross, _dot, _keys, _lib,
                                      _norm, _rand)
from torch_param_block import block_at, seeded_values
from torch_recorder import HOST_READS, recording

torch.set_num_threads(2)

H, W = 48, 64
JH, JW = 32, 128   # (b): 128 lanes a row, so the JAX tile gates apply
F32 = np.float32
INF = F32(1e30)
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
CUBEMAP = os.path.join(ROOT, "cubemaps", "sky_day.png")
WRAPPERS = ("trace", "ambient_occlusion", "bounce", "sky")
SHADE_WRAPPERS = ("glass_rays", "glass_mix", "mirror_ray", "mirror_mix")


@pytest.fixture(scope="module")
def day_sky():
    return env_from_numpy(timage.load_cubemap_cross(CUBEMAP), "cpu")


def _params(name, spp=1, env=False, **change):
    return preset(name).replace(spp_per_frame=spp,
                                enable_env_map=int(env), **change)


def _fin(index, h=H, w=W):
    cam = Camera()
    cam.aspect = w / h
    return camera_frame_inputs(cam, "cpu", jitter=(0.13, -0.21),
                               frame_index=index)


def _render(params, env, index=3):
    """One analytic frame at 48x64 on a history of `index`: its image and
    accumulation."""
    rng = np.random.RandomState(index)
    accum = torch.from_numpy(rng.uniform(0.0, 1.0, (H, W, 4)).astype(F32))
    state, out = render_frame(params, _fin(index), RenderState(accum, index),
                              env, height=H, width=W)
    return out.image.clone(), state.accum.clone()


# ---- (a) the masks, in the frame ----

GARBAGE = {  # (float, t, material id) on dead lanes
    "nan": (float("nan"), float("nan"), -77),
    "plausible": (0.25, 0.5, 3),   # a valid t and a mirror
    "huge": (3e4, -1.0, 2),        # far off, and a glass id
}
UNREAD = (0.5, 0.5, 0)  # a dead input lane as a plain version is handed it


def _spy(monkeypatch, calls, garbage=None):
    """Replace the four wrappers by ones that note each call's (name,
    arguments, active) and, with `garbage`, fill the lanes its mask marks
    dead with GARBAGE[garbage].  With `garbage`, each of them and the
    direct light (K3's wrapper) also compute as the kernels do, which
    read no dead lane: the plain versions, which compute every lane, are
    handed UNREAD on the lanes their own mask marks dead, and K3's dead
    lanes are filled with the garbage as well."""
    real = {name: getattr(an_trace_cuda, name) for name in WRAPPERS}
    real_k3 = an_cuda.direct_light
    fv, tv, mv = GARBAGE[garbage] if garbage else (None, None, None)

    def dead_as(active, shape, x, value):
        if garbage is None or active is None:
            return x
        shape = torch.broadcast_shapes(shape, active.shape)
        dead = ~active.expand(shape)
        if x.dim() > len(shape):
            dead = dead[..., None]
        return torch.where(dead, torch.full_like(x, value), x)

    def hit(active, h, values=(fv, tv, mv)):
        s, (f, t, m) = h.t.shape, values
        return Hit(dead_as(active, s, h.t, t), dead_as(active, s, h.p, f),
                   dead_as(active, s, h.n, f), dead_as(active, s, h.mat, m))

    def unread(active, h):
        return hit(active, h, UNREAD)

    def trace(ro, rd, params, plp, glass, marker, eps=EPS, active=None):
        calls.append(("trace", dict(ro=ro, rd=rd, params=params, plp=plp,
                                    glass=glass, marker=marker, eps=eps),
                      active))
        s = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
        return hit(active, real["trace"](
            dead_as(active, s, ro, UNREAD[0]),
            dead_as(active, s, rd, UNREAD[0]), params, plp, glass, marker,
            eps, active))

    def ambient_occlusion(scene, h, fi, px, py, active=None):
        calls.append(("ambient_occlusion", dict(scene=scene, h=h, fi=fi,
                                                px=px, py=py), active))
        return dead_as(active, h.t.shape,
                       real["ambient_occlusion"](scene, unread(active, h),
                                                 fi, px, py, active), fv)

    def bounce(scene, h0, rng, seed, px, py, active=None):
        calls.append(("bounce", dict(scene=scene, h0=h0, rng=rng, seed=seed,
                                     px=px, py=py), active))
        h1, wi, cos = real["bounce"](scene, unread(active, h0), rng, seed,
                                     px, py, active)
        s = h1.t.shape
        return (hit(active, h1), dead_as(active, s, wi, fv),
                dead_as(active, s, cos, fv))

    def sky(d, params, env_map=None, active=None):
        calls.append(("sky", dict(d=d, params=params, env_map=env_map),
                      active))
        s = d.shape[:-1]
        return dead_as(active, s,
                       real["sky"](dead_as(active, s, d, UNREAD[0]), params,
                                   env_map, active), fv)

    def direct_light(scene, h, rng, fi, vdir, px, py, active=None,
                     offsets_out=None):
        out = real_k3(scene, unread(active, h), rng, fi,
                      dead_as(active, h.t.shape, vdir, UNREAD[0]), px, py,
                      active, offsets_out)
        return dead_as(active, out.shape[:-1], out, fv)

    real_shade = {name: getattr(an_shade_cuda, name)
                  for name in SHADE_WRAPPERS}

    def sky_at(written, s, x):
        # a sky the rays kernel looks up on the lanes `written` alone
        if garbage is None:
            return x
        return dead_as(written, s, x, fv)

    def glass_rays(scene, h, wo, mat=None, active=None):
        calls.append(("glass_rays", dict(scene=scene, h=h, wo=wo, mat=mat),
                      active))
        s = h.t.shape
        rays = real_shade["glass_rays"](
            scene, unread(active, h), dead_as(active, s, wo, UNREAD[0]),
            mat, active)
        live = torch.ones(s, dtype=torch.bool) if active is None \
            else active.expand(s)
        hits = tuple(hit(active, h2) for h2 in rays.hits)
        written = (live, live & ~rays.hits[1].valid,
                   live & (rays.k > 0.0) & ~rays.hits[2].valid)
        return tlt.GlassRays(
            hits, tuple(dead_as(active, s, v, fv) for v in rays.views),
            tuple(sky_at(w, s, x) for w, x in zip(written, rays.skies)),
            dead_as(active, s, rays.k, fv),
            dead_as(active, s, rays.cos_theta, fv))

    def mirror_ray(scene, h, wo, active=None):
        calls.append(("mirror_ray", dict(scene=scene, h=h, wo=wo), active))
        s = h.t.shape
        ray = real_shade["mirror_ray"](
            scene, unread(active, h), dead_as(active, s, wo, UNREAD[0]),
            active)
        live = torch.ones(s, dtype=torch.bool) if active is None \
            else active.expand(s)
        return tlt.MirrorRay(hit(active, ray.hit),
                             dead_as(active, s, ray.view, fv),
                             sky_at(live & ~ray.hit.valid, s, ray.sky))

    def mix(name):
        def fn(scene, h, mat, *rest, active=None, out=None):
            calls.append((name, dict(scene=scene, h=h, mat=mat, rest=rest,
                                     out=out), active))
            got = real_shade[name](scene, h, mat, *rest, active=active,
                                   out=out)
            # without `out` the kernel leaves its dead lanes unwritten
            return got if out is not None else dead_as(
                active, got.shape[:-1], got, fv)
        return fn

    for name, fn in (("trace", trace),
                     ("ambient_occlusion", ambient_occlusion),
                     ("bounce", bounce), ("sky", sky)):
        monkeypatch.setattr(an_trace_cuda, name, fn)
    for name, fn in (("glass_rays", glass_rays), ("mirror_ray", mirror_ray),
                     ("glass_mix", mix("glass_mix")),
                     ("mirror_mix", mix("mirror_mix"))):
        monkeypatch.setattr(an_shade_cuda, name, fn)
    monkeypatch.setattr(an_cuda, "direct_light", direct_light)


FRAME_CASES = {
    "an_baseline": dict(name="baseline"),
    "an_full": dict(name="full", env=True),
    "full_gradient": dict(name="full"),
    "full_spp2": dict(name="full", spp=2, env=True),
    "full_spp2_gradient": dict(name="full", spp=2),
    "full_no_mirror_glass": dict(name="full", env=True, mat_mirror_enabled=0,
                                 mat_glass_enabled=0),
    "full_no_point_light": dict(name="full", point_light_enabled=0),
}


@pytest.mark.parametrize("garbage", list(GARBAGE))
@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_frames_read_no_dead_lane(case, garbage, day_sky, monkeypatch):
    c = dict(FRAME_CASES[case])
    params = _params(c.pop("name"), **c)
    env = day_sky if params.enable_env_map else None
    want = _render(params, env)
    calls = []
    _spy(monkeypatch, calls, garbage)
    got = _render(params, env)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # every call but the primary trace is handed a mask with a live and a
    # dead lane at this camera, so the garbage had lanes to reach
    assert calls[0][0] == "trace" and calls[0][2] is None
    for name, _, active in calls[1:]:
        assert active is not None, name
        assert active.dtype == torch.bool


@pytest.mark.parametrize("name,env", [("baseline", False), ("full", True)])
def test_bvh_frames_read_no_dead_sky_lane(name, env, day_sky, monkeypatch):
    """The BVH scene's sky goes through the sky kernel's wrapper too: the
    primary lookup on the misses alone (GI's at the bounce is the BVH
    hit-mix kernel's, on the hit lanes: tests/test_torch_hit_mix.py).  A
    bunny frame whose dead sky lanes are NaN is the dense frame bit for
    bit."""
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    bvh = prepare_bvh(tris, "cpu")
    params = _params(name, env=env)
    cam = Camera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    fin = camera_frame_inputs(cam, "cpu", jitter=(0.13, -0.21),
                              frame_index=3)

    def render():
        state, out = render_frame(params, fin, RenderState.create(H, W, "cpu"),
                                  day_sky if env else None, bvh, height=H,
                                  width=W, use_bvh=True)
        return out.image.clone(), state.accum.clone()
    want = render()
    calls = []
    _spy(monkeypatch, calls, "nan")
    got = render()
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [c[0] for c in calls] == ["sky"]
    primary = calls[0][2]
    assert primary is not None and 0.0 < float(primary.float().mean()) < 1.0


def _labels(params):
    """The wrapper calls of an analytic frame in order, each (wrapper,
    label): the primary trace and sky, AO, GI's bounce and sky, the
    mirror's ray, GI and mix, glass's rays and mix."""
    gi, ao = bool(params.enable_gi), bool(params.enable_ao)
    out = [("trace", "primary_trace"), ("sky", "primary_sky")]
    if ao and params.spp_per_frame > 1:
        out.append(("ambient_occlusion", "ao"))  # hoisted out of the samples
    if gi:
        out += [("bounce", "gi_bounce"), ("sky", "gi_sky")]
    if ao and params.spp_per_frame == 1:
        out.append(("ambient_occlusion", "ao"))
    if params.mat_mirror_enabled:
        # the mirror's trace and sky are the ray kernel's (mirror_ray)
        out.append(("mirror_ray", "mirror_ray"))
        if gi:
            out += [("bounce", "mirror_gi_bounce"), ("sky", "mirror_gi_sky")]
        out.append(("mirror_mix", "mirror_mix"))
    if params.mat_glass_enabled:
        # glass's three traces and three skies are the rays kernel's
        out += [("glass_rays", "glass_rays"), ("glass_mix", "glass_mix")]
    return out


def record_calls(params, env, monkeypatch, index=3):
    """{label: (wrapper, arguments, active)} of one frame's wrapper calls
    (_labels)."""
    calls = []
    _spy(monkeypatch, calls)
    _render(params, env, index)
    monkeypatch.undo()
    labels = _labels(params)
    assert [c[0] for c in calls] == [w for w, _ in labels]
    return {label: c for (_, label), c in zip(labels, calls)}


def bind_params(params):
    from opengl_raytracing_tpu_torch.params import bind
    return bind(params, "cpu")


def _plain_trace(call):
    a = call[1]
    return tsa.trace_analytic_core(a["ro"], a["rd"], a["params"], a["plp"],
                                   a["glass"], a["marker"], a["eps"])


@pytest.mark.parametrize("spp", [1, 2])
def test_masks_are_the_lanes_each_select_reads(spp, day_sky, monkeypatch):
    """The mask each call is handed, rebuilt from the frame's dense values:
    the primary sky its misses, AO the hits, GI's bounce the diffuse hits,
    the mirror's and glass's rays and mixes their material's hits (the
    rays kernels trace there and look each sky up where its ray missed,
    glass's bent sky where it refracts too), GI's bounce at the mirror's
    hit the mirror's valid hits, GI's skies where the bounce missed among
    its caller's lanes.  At 2 samples the shared hit's masks are broadcast
    over the samples, and the kernels read them once a pixel."""
    from opengl_raytracing_tpu_torch.constants import MAT_POINTLIGHT_SPHERE
    from opengl_raytracing_tpu_torch.ops.materials import (
        MTYPE_DIFFUSE, MTYPE_GLASS, MTYPE_MIRROR, get_material)
    from opengl_raytracing_tpu_torch.ops.vecmath import normalize, refract
    params = _params("full", spp=spp, env=True)
    p = bind_params(params)
    calls = record_calls(params, day_sky, monkeypatch)
    h = _plain_trace(calls["primary_trace"])
    hit = h.valid
    mat = get_material(h.mat, p)
    diffuse = (hit & (h.mat != MAT_POINTLIGHT_SPHERE)
               & (mat.mtype == MTYPE_DIFFUSE))
    mirror, glass = hit & (mat.mtype == MTYPE_MIRROR), hit & (
        mat.mtype == MTYPE_GLASS)
    a = calls["mirror_ray"][1]
    mirror_ray = tlt.mirror_ray_plain(a["scene"], a["h"], a["wo"])
    h_mirror = mirror_ray.hit
    a = calls["glass_rays"][1]
    glass_rays = tlt.glass_rays_plain(a["scene"], a["h"], a["wo"], a["mat"])

    def bounce_valid(label):
        a = calls[label][1]
        return tlt.gi_bounce_analytic_plain(a["scene"], a["h0"], a["rng"],
                                            a["seed"], a["px"],
                                            a["py"])[0].valid
    rd = calls["primary_trace"][1]["rd"]
    _, k = refract(-normalize(-rd), normalize(h.n),
                   1.0 / torch.clamp_min(mat.ior, 1.0001))
    want = {
        "primary_trace": None, "primary_sky": ~hit, "ao": hit,
        "gi_bounce": diffuse, "gi_sky": diffuse & ~bounce_valid("gi_bounce"),
        "mirror_ray": mirror, "mirror_mix": mirror,
        "mirror_gi_bounce": mirror & h_mirror.valid,
        "mirror_gi_sky": (mirror & h_mirror.valid
                          & ~bounce_valid("mirror_gi_bounce")),
        "glass_rays": glass, "glass_mix": glass,
    }
    # the lanes the rays kernels trace and look each sky up on, which
    # were the masks of calls of their own: the mirror's trace and its sky
    # where it missed; glass's three traces and reflected sky, the
    # straight sky where it missed, the bent sky where it refracts and
    # missed
    shape = _shape_of("glass_rays", calls["glass_rays"][1])
    live = {name: calls[name][2].expand(shape).reshape(-1).numpy()
            for name in ("mirror_ray", "glass_rays")}
    moved = {
        "mirror_trace": (live["mirror_ray"], mirror),
        "mirror_sky": (sky_lanes("mirror_ray", mirror_ray,
                                 live["mirror_ray"])[0],
                       mirror & ~h_mirror.valid),
        **{f"glass_{ray}_trace": (live["glass_rays"], glass)
           for ray in ("reflect", "straight", "bent")},
        **{f"glass_{ray}_sky": (lanes, w) for ray, lanes, w in zip(
            ("reflect", "straight", "bent"),
            sky_lanes("glass_rays", glass_rays, live["glass_rays"]),
            (glass, glass & ~glass_rays.hits[1].valid,
             glass & (k > 0.0) & ~glass_rays.hits[2].valid))},
    }
    for label, (got, w) in moved.items():
        np.testing.assert_array_equal(
            got, w.expand(shape).reshape(-1).numpy(), err_msg=label)
        assert not w.all(), label
        assert w.any() or label in ("glass_straight_sky",
                                    "glass_bent_sky"), label
    assert set(want) == set(calls)
    for label, (name, args, active) in calls.items():
        if want[label] is None:
            assert active is None, label
            continue
        shape = _shape_of(name, args)
        assert torch.equal(active.expand(shape),
                           want[label].expand(shape)), label
        # each mask has a dead lane, and a live one but where every
        # straight or bent ray through the glass at this camera hits
        assert not want[label].all(), label
        assert want[label].any() or label in ("glass_straight_sky",
                                              "glass_bent_sky"), label
    if spp > 1:
        for label in ("ao", "gi_bounce", "mirror_ray", "glass_rays"):
            mode = an_trace_cuda.lane_input(
                calls[label][2], _shape_of(*calls[label][:2]), 0, torch.bool,
                torch.device("cpu"), "active")[0].mode
            assert mode == (an_trace_cuda.LANE if label == "ao"
                            else an_trace_cuda.PIXEL), label


# ---- (c) the kernels' per-lane rules, transcribed ----

def _consts(params, env=None):
    """What the kernels read: the AnScene the wrappers build and the
    parameter block it points to."""
    s = an_cuda.scene_struct(bind_params(params), env)
    return s, block_at(s.prm)


def model_trace(s, block, o, d, glass, marker, eps):
    """an_scene.cuh trace_closest + an_trace.cu hit_out on rows o, d
    [N, 3]: (t, p, n, mat)."""
    fn = F32(list(s.floor_n))
    denom = _dot(d, fn)
    safe = np.where(np.abs(denom) < F32(1e-6), F32(1.0), denom)
    tf = -(_dot(o, fn) + F32(s.floor_d)) / safe
    t = np.full(len(o), INF, F32)
    k = np.full(len(o), -1)
    take = (np.abs(denom) >= F32(1e-6)) & (tf >= eps) & (tf < t)
    t, k = np.where(take, tf, t), np.where(take, 0, k)
    centres = {j + 1: F32(list(s.sphere_c[j])) for j in range(3)}
    centres[4] = F32(block["point_light_world"])
    r2 = {1: s.sphere_r2[0], 2: s.sphere_r2[1], 3: s.sphere_r2[2],
          4: s.marker_r2}
    for j in [1] + [2] * bool(glass) + [3] + [4] * bool(marker):
        oc = o - centres[j]
        b = _dot(oc, d)
        disc = b * b - (_dot(oc, oc) - F32(r2[j]))
        sq = _lib("sqrt", np.maximum(disc, F32(0.0)))
        t_near, t_far = -b - sq, -b + sq
        tj = np.where(t_near < eps, t_far, t_near)
        take = (disc >= F32(0.0)) & (tj >= eps) & (tj < t)
        t, k = np.where(take, tj, t), np.where(take, j, k)
    p = o + d * t[:, None]
    n = np.zeros_like(p)
    n[k == 0] = fn
    for j, c in centres.items():
        if (k == j).any():
            n[k == j] = _norm(p[k == j] - c)
    return t, p, n, np.where(k < 0, 0, k).astype(np.int32)


def _kernel_constant(name):
    """A float constant of csrc/an_trace.cu (`constexpr float name = v;`)."""
    import re
    path = os.path.join(ROOT, "opengl_raytracing_tpu_torch", "csrc",
                        "an_trace.cu")
    with open(path) as fh:
        m = re.search(rf"constexpr\s+float\s+{name}\s*=\s*([-+0-9.eE]+)f;",
                      fh.read())
    assert m, f"{name} not in an_trace.cu"
    return F32(m.group(1))


AO_REACH = _kernel_constant("kAoReach")
AO_SLACK = _kernel_constant("kAoSlack")


def _onb(nn):
    """sampling.cuh build_onb around unit normals nn [N, 3]: (t, b), taken
    as (+0, +0, 1) and (1, +0, +0) without its normalize where nn is
    (+0, 1, +0) exactly (the floor's hits)."""
    up = np.where((np.abs(nn[..., 1]) < F32(0.99))[..., None],
                  F32([0.0, 1.0, 0.0]), F32([1.0, 0.0, 0.0]))
    t = _norm(_cross(up, nn))
    b = _cross(nn, t)
    bits = nn.view(np.uint32)
    floor = ((bits[..., 0] == 0) & (nn[..., 1] == F32(1.0))
             & (bits[..., 2] == 0))[..., None]
    return (np.where(floor, F32([0.0, 0.0, 1.0]), t),
            np.where(floor, F32([1.0, 0.0, 0.0]), b))


def _hemisphere_dir(t, b, nn, ux, uy, two_pi):
    """sampling.cuh hemisphere_dir: the sample in the basis (t, b, nn)."""
    phi = F32(two_pi) * ux
    r = _lib("sqrt", uy)
    x, z = r * _lib("cos", phi), r * _lib("sin", phi)
    y = _lib("sqrt", np.maximum(F32(1.0) - uy, F32(0.0)))
    return _norm((t * x[..., None] + b * z[..., None]) + nn * y[..., None])


def ao_lanes(s, block, o, radius, marker, eps):
    """an_ao_kernel's terms of lanes with origins o [N, 3]: the spheres'
    (albedo, glass, mirror, marker) oc [4, N, 3] and c2 [4, N], which of
    them the lane tests (`near` [4, N]: not culled by their reach), the
    floor's numerator and whether the floor is tested (not beyond
    ao_radius * |n| * kAoReach); every cull off where eps <= 0."""
    culls = eps > F32(0.0)
    fn = F32(list(s.floor_n))
    centres = [F32(list(s.sphere_c[k])) for k in range(3)] + [
        F32(block["point_light_world"])]
    r2 = [F32(s.sphere_r2[k]) for k in range(3)] + [F32(s.marker_r2)]
    oc = np.stack([o - c for c in centres])
    q = _dot(oc, oc)
    c2 = np.stack([q[k] - r2[k] for k in range(4)])
    near = np.zeros(q.shape, bool)
    for k in range(3 + bool(marker)):
        reach = (radius + _lib("sqrt", r2[k])) * AO_REACH + AO_SLACK
        near[k] = ~(q[k] > reach * reach) if culls else True
    num = -(_dot(o, fn) + F32(s.floor_d))
    floor_far = radius * _lib("sqrt", _dot(fn, fn)) * AO_REACH
    floor = ~(np.abs(num) > floor_far) if culls else np.ones(len(o), bool)
    return dict(oc=oc, c2=c2, near=near, num=num, floor=floor, fn=fn,
                culls=culls)


def ao_floor_up(lanes, nn):
    """The lanes whose every hemisphere direction stays on the floor's
    side: the floor normal (0, y > 0, 0), the lane's normal nn = (0, y >
    0, 0) (so that the basis's t.y and b.y are 0 and every direction has
    d.y >= 0), the origin not below the floor; an_ao_kernel tests no
    floor there."""
    fn, num = lanes["fn"], lanes["num"]
    up = bool(lanes["culls"] and fn[0] == 0 and fn[2] == 0 and fn[1] > 0)
    return (up & (nn[:, 0] == 0) & (nn[:, 2] == 0) & (nn[:, 1] > 0)
            & ~(num > 0))


def ao_blocked(lanes, d, eps, radius, keep=None):
    """an_trace.cu ao_blocked on directions d [N, 3]: whether a tested
    primitive has a valid root below 1e30 and ao_radius, each root its
    plain expression, with the exact skips (the floor's signs, disc < 0,
    b >= 0 with c2 >= 0).  `keep` [N] (a lane's floor and spheres tested
    at all) defaults to every lane."""
    keep = np.ones(len(d), bool) if keep is None else keep
    culls = lanes["culls"]
    num = lanes["num"]
    denom = _dot(d, lanes["fn"])
    fl = keep & lanes["floor"] & (np.abs(denom) >= F32(1e-6))
    if culls:
        fl &= (num > 0) == (denom > 0)
    tf = num / np.where(fl, denom, F32(1.0))
    blocked = fl & (tf >= eps) & (tf < INF) & (tf < radius)
    away = eps * F32(2.0 ** 20)
    for k in range(4):
        oc, c2 = lanes["oc"][k], lanes["c2"][k]
        b = _dot(oc, d)
        disc = b * b - c2
        ok = keep & lanes["near"][k] & (disc >= 0)
        ok &= ~((b >= 0) & (c2 >= 0) & (b < away))
        sq = _lib("sqrt", np.maximum(disc, F32(0.0)))
        t_near, t_far = -b - sq, -b + sq
        t = np.where(t_near < eps, t_far, t_near)
        blocked |= ok & (t >= eps) & (t < INF) & (t < radius)
    return blocked


def model_ao(s, block, args, record, p, n, px, py, stats=None):
    """an_ao_kernel on rows: the biased origin, the lane's sphere terms,
    culls and basis once, `samples` hemisphere rays at offsets 37i+3 /
    19i+11, each an any-hit test within ao_radius (ao_blocked), remapped;
    a lane with nothing left to test draws no sample.  `stats` (a dict)
    gets the lanes that drew samples."""
    eps, radius = F32(s.eps), F32(block["ao_radius"])
    nn = _norm(n)
    o = p + nn * F32(block["ao_bias"])
    lanes = ao_lanes(s, block, o, radius, args.marker, eps)
    lanes["floor"] &= ~ao_floor_up(lanes, nn)
    sampled = lanes["near"].any(0) | lanes["floor"]
    n2 = _norm(nn)
    t, b = _onb(n2)
    key = _keys(((int(record[0]) & M32) * args.fi.a + args.fi.b) & M32)
    occ = np.zeros(len(p), np.int64)
    for i in range(args.samples):
        o1, o2 = F32(37 * i + 3), F32(19 * i + 11)
        ux = _rand(px + o1, py + o1, key)
        uy = _rand(py + o2, px + o2, key)
        d = _hemisphere_dir(t, b, n2, ux, uy, args.two_pi)
        occ += ao_blocked(lanes, d, eps, radius, sampled)
    if stats is not None:
        stats["sampled"] = sampled
    ao = F32(1.0) - occ.astype(F32) / F32(args.samples)
    return np.minimum(np.maximum(F32(block["ao_min"])
                                 + F32(block["ao_span"]) * ao,
                                 F32(block["ao_min"])), F32(1.0))


def _value_at(record, aff, smp):
    """sampling.cuh frame_value at sample `smp`: uint32 bits."""
    return ((int(record[0]) & M32) * aff.a + aff.b + smp * aff.c) & M32


def _i32f(bits):
    return F32(bits - (1 << 32) if bits >> 31 else bits)


def model_bounce(s, block, args, record, p, n, px, py, smp):
    """an_bounce_kernel on rows of one sample `smp`: the rand pair at
    offsets seed*13 / seed*37, wi, cos and the closest hit from
    p + n0*EPS."""
    key = _keys(_value_at(record, args.rng, smp))
    seed = _value_at(record, args.seed, smp)
    so, so2 = _i32f((seed * 13) & M32), _i32f((seed * 37) & M32)
    ux = _rand(px + so, py + so, key)
    uy = _rand(py + so2, px + so2, key)
    n0 = _norm(n)
    nn = _norm(n0)
    t, b = _onb(nn)
    wi = _hemisphere_dir(t, b, nn, ux, uy, args.two_pi)
    cos = np.maximum(_dot(n0, wi), F32(0.0))
    hit = model_trace(s, block, p + n0 * F32(s.eps), wi, True, args.marker,
                      F32(s.eps))
    return hit, wi, cos


def model_sky(s, block, env, d):
    """an_scene.cuh sky on rows: the cubemap times its intensity, or the
    gradient."""
    if env is not None:
        return (kernel_sample_cubemap(env.reshape(-1).numpy(), env.shape[1],
                                      d)
                * F32(block["env_map_intensity"]))
    t = np.minimum(np.maximum(F32(0.5) * (d[:, 1] + F32(1.0)), F32(0.0)),
                   F32(1.0))
    top, bottom = F32(block["sky_top"]), F32(block["sky_bottom"])
    return top + (bottom - top) * (F32(1.0) - t)[:, None]


def _lanes(x, shape, width, dtype=torch.float32):
    """x's value on every lane of `shape`, read as the kernel reads it:
    its rows (a row a lane, a pixel or one) at each lane's row."""
    lane_in, rows = an_trace_cuda.lane_input(x, shape, width, dtype,
                                             torch.device("cpu"), "x")
    i = np.arange(shape.numel())
    row = {an_trace_cuda.LANE: i,
           an_trace_cuda.PIXEL: i % an_trace_cuda.n_px_of(shape),
           an_trace_cuda.ONE: np.zeros_like(i)}[lane_in.mode]
    return rows.numpy()[row]


def _live(active, shape):
    if active is None:
        return np.ones(shape.numel(), bool)
    return _lanes(active, shape, 0, torch.bool)


def _check(got, want, live, what):
    """`got` on the live lanes against the dense `want` [N, ...] there."""
    want = want.reshape((len(live),) + got.shape[1:])
    np.testing.assert_array_equal(got, want[live], err_msg=what)


def check_trace_call(args, live, s, block):
    shape = torch.broadcast_shapes(args["ro"].shape[:-1],
                                   args["rd"].shape[:-1])
    o, d = _lanes(args["ro"], shape, 3)[live], _lanes(args["rd"], shape,
                                                      3)[live]
    marker = an_trace_cuda._marker(args["params"], args["marker"])
    got = model_trace(s, block, o, d, args["glass"], marker, F32(args["eps"]))
    want = tsa.trace_analytic_core(args["ro"], args["rd"], args["params"],
                                   args["plp"], args["glass"],
                                   args["marker"], args["eps"])
    for g, w, name in zip(got, want, ("t", "p", "n", "mat")):
        _check(g, w.numpy(), live, name)


def check_ao_call(args, live, s, block):
    h = args["h"]
    shape = h.t.shape
    a, record = an_trace_cuda.ao_args(args["scene"].params, args["fi"])
    px = args["px"].expand(shape).reshape(-1).numpy()[live]
    py = args["py"].expand(shape).reshape(-1).numpy()[live]
    got = model_ao(s, block, a, record, _lanes(h.p, shape, 3)[live],
                   _lanes(h.n, shape, 3)[live], px, py)
    want = tlt.ambient_occlusion_analytic_plain(
        args["scene"], h, args["fi"], args["px"], args["py"])
    _check(got, want.numpy(), live, "ao")


def check_bounce_call(args, live, s, block):
    h0 = args["h0"]
    shape = h0.t.shape
    a, record = an_trace_cuda.bounce_args(args["scene"].params, args["rng"],
                                          args["seed"])
    n_px = an_trace_cuda.n_px_of(shape) if len(shape) > 2 else shape.numel()
    i = np.arange(shape.numel())
    smp = i // n_px
    p, n = _lanes(h0.p, shape, 3), _lanes(h0.n, shape, 3)
    px = args["px"].expand(shape).reshape(-1).numpy()
    py = args["py"].expand(shape).reshape(-1).numpy()
    h1, wi, cos = tlt.gi_bounce_analytic_plain(args["scene"], h0,
                                               args["rng"], args["seed"],
                                               args["px"], args["py"])
    for k in np.unique(smp[live]):
        lanes = live & (smp == k)
        (t, hp, hn, mat), gwi, gcos = model_bounce(
            s, block, a, record, p[lanes], n[lanes], px[lanes], py[lanes],
            int(k))
        for g, w, name in ((t, h1.t, "t"), (hp, h1.p, "p"), (hn, h1.n, "n"),
                           (mat, h1.mat, "mat"), (gwi, wi, "wi"),
                           (gcos, cos, "cos")):
            _check(g, w.numpy(), lanes, name)


def check_sky_call(args, live, s, block):
    d = args["d"]
    shape = d.shape[:-1]
    env = an_cuda.env_table(bind_params(args["params"]), args["env_map"],
                            torch.device("cpu"))
    s, block = _consts(args["params"], env)
    got = model_sky(s, block, env, _lanes(d, shape, 3)[live])
    want = tsa.sky(d, args["params"], args["env_map"])
    _check(got, want.numpy(), live, "sky")


def _mat_row(block, field, ids):
    """get_material's row of each id (ids 0-3, else the last) in `field`
    of the parameter block."""
    rows = np.where((ids >= 0) & (ids < 4), ids, 4)
    table = F32(block[field])
    return table.reshape(5, -1)[rows].squeeze(-1) if table.size == 5 \
        else table.reshape(5, 3)[rows]


def _mix(a, b, t):
    return a + (b - a) * t


def _reflect(i, n):
    return i - (F32(2.0) * _dot(n, i))[:, None] * n


def sky_lanes(name, rays, live):
    """The lanes on which a rays kernel looks up each of its skies
    (csrc/an_shade.cu), given its dense plain results `rays`: glass's
    reflected sky on every live lane, the straight ray's where it missed,
    the bent ray's where it refracts and missed; the mirror's where its
    ray missed."""
    if name == "mirror_ray":
        return (live & ~rays.hit.valid.reshape(-1).numpy(),)
    miss = [~h2.valid.reshape(-1).numpy() for h2 in rays.hits]
    return (live, live & miss[1],
            live & (rays.k.reshape(-1).numpy() > F32(0.0)) & miss[2])


def model_glass_rays(s, block, env, c, p, n, wo, mat, cam):
    """an_glass_rays_kernel on rows: (hits, views, skies, k, cos), each
    sky on every row (the kernel writes it where sky_lanes says)."""
    nn, v = _norm(n), _norm(wo)
    i = -v
    ior = np.maximum(_mat_row(block, "mat_ior", mat), F32(c.min_ior))
    eta = F32(1.0) / ior
    r = _reflect(i, nn)
    cos = np.minimum(np.maximum(_dot(-i, nn), F32(0.0)), F32(1.0))
    cosi = _dot(nn, i)
    k = F32(1.0) - eta * eta * (F32(1.0) - cosi * cosi)
    kk = eta * cosi + _lib("sqrt", np.maximum(k, F32(0.0)))
    t_phys = np.where((k < F32(0.0))[:, None], F32(0.0),
                      eta[:, None] * i - kk[:, None] * nn)
    t_dir = _norm(_mix(i, _norm(t_phys), F32(c.distortion)))
    hits, views, skies = [], [], []
    for d in (r, i, t_dir):
        o = p + d * F32(c.eps)
        hit = model_trace(s, block, o, d, False, c.marker, F32(c.eps))
        hits.append(hit)
        views.append(_norm(cam - hit[1]))
        skies.append(model_sky(s, block, env, d))
    return hits, views, skies, k, cos


def model_glass_mix(block, c, mat, t, skies, lit, k, cos):
    """an_glass_mix_kernel on rows."""
    env = skies[0]
    local = np.where((t[0] < INF)[:, None], lit[0], env)
    reflect_col = _mix(env, local, F32(c.local_refl))
    straight = np.where((t[1] < INF)[:, None], lit[1], skies[1])
    bent = np.where((t[2] < INF)[:, None], lit[2], skies[2])
    refr = np.where((k > F32(0.0))[:, None],
                    _mix(straight, bent, F32(c.distortion)), straight)
    refr = refr * _mat_row(block, "mat_albedo", mat)
    ior = np.maximum(_mat_row(block, "mat_ior", mat), F32(c.min_ior))
    q = (ior - F32(1.0)) / (ior + F32(1.0))
    f0 = q * q
    fresnel = f0 + (F32(1.0) - f0) * torch.pow(
        torch.from_numpy(F32(1.0) - cos), 5.0).numpy()
    return _mix(refr, reflect_col, fresnel[:, None])


def model_mirror_ray(s, block, env, c, p, n, wo):
    """an_mirror_ray_kernel on rows: (hit, view -r, sky)."""
    i = -_norm(wo)
    r = _reflect(i, _norm(n))
    hit = model_trace(s, block, p + r * F32(c.eps), r, True, c.marker,
                      F32(c.eps))
    return hit, -r, model_sky(s, block, env, r)


def model_mirror_mix(block, c, mat, t, hmat, sky, direct, gi):
    """an_mirror_mix_kernel on rows; `gi` (t, cos, lit, sky) or None.  The
    GI tail's cos / PI is the CPU's division, as the plain version on the
    CPU takes it (on the card the kernel and PyTorch multiply by the
    float32 reciprocal, `c.inv_pi`)."""
    col = direct
    if gi is not None:
        gt, cs, glit, gsky = gi
        li = np.where((gt < INF)[:, None], glit, gsky)
        g = _mat_row(block, "mat_albedo", hmat) * (cs / F32(tlt.PI))[:, None] \
            * li
        g = np.where((cs > F32(0.0))[:, None], g, F32(0.0))
        col = col + g * F32(block["gi_scale_analytic"])
    col = np.where((t < INF)[:, None], col, sky)
    return col * _mat_row(block, "mat_albedo", mat)


def _rows(x, shape, width, live, dtype=torch.float32):
    return _lanes(x, shape, width, dtype)[live]


def _flat(x, live):
    """A row-a-lane input (an output of the calls between the rays and
    the mix call) on the live lanes."""
    n = len(live)
    return x.reshape((n, 3) if x.numel() == 3 * n else (n,)).numpy()[live]


def check_glass_rays_call(args, live, s, block):
    h, wo, scene = args["h"], args["wo"], args["scene"]
    shape = h.t.shape
    c = an_shade_cuda.shade_consts(scene.params)
    env = an_cuda.env_table(scene.params, scene.env_map, torch.device("cpu"))
    hits, views, skies, k, cos = model_glass_rays(
        s, block, env, c, _rows(h.p, shape, 3, live),
        _rows(h.n, shape, 3, live), _rows(wo, shape, 3, live),
        _rows(h.mat, shape, 0, live, torch.int32),
        _rows(scene.cam_pos, shape, 3, live))
    want = tlt.glass_rays_plain(scene, h, wo, args["mat"])
    for j in range(3):
        for g, w, name in zip(hits[j], want.hits[j], ("t", "p", "n", "mat")):
            _check(g, w.numpy(), live, f"ray {j} {name}")
        _check(views[j], want.views[j].numpy(), live, f"view {j}")
    for j, lanes in enumerate(sky_lanes("glass_rays", want, live)):
        _check(skies[j][lanes[live]], want.skies[j].numpy(), lanes,
               f"sky {j}")
    _check(k, want.k.numpy(), live, "k")
    _check(cos, want.cos_theta.numpy(), live, "cos")


def check_glass_mix_call(args, live, s, block):
    h, scene = args["h"], args["scene"]
    rays, lit = args["rest"]
    c = an_shade_cuda.shade_consts(scene.params)
    got = model_glass_mix(
        block, c, _rows(h.mat, rays.k.shape, 0, live, torch.int32),
        [_flat(h2.t, live) for h2 in rays.hits],
        [_flat(x, live) for x in rays.skies], [_flat(x, live) for x in lit],
        _flat(rays.k, live), _flat(rays.cos_theta, live))
    want = tlt.glass_mix_plain(scene, h, args["mat"], rays, lit)
    _check(got, want.numpy(), live, "glass")


def check_mirror_ray_call(args, live, s, block):
    h, wo, scene = args["h"], args["wo"], args["scene"]
    shape = h.t.shape
    c = an_shade_cuda.shade_consts(scene.params)
    env = an_cuda.env_table(scene.params, scene.env_map, torch.device("cpu"))
    hit, view, sky = model_mirror_ray(
        s, block, env, c, _rows(h.p, shape, 3, live),
        _rows(h.n, shape, 3, live), _rows(wo, shape, 3, live))
    want = tlt.mirror_ray_plain(scene, h, wo)
    for g, w, name in zip(hit, want.hit, ("t", "p", "n", "mat")):
        _check(g, w.numpy(), live, name)
    _check(view, want.view.numpy(), live, "view")
    (lanes,) = sky_lanes("mirror_ray", want, live)
    _check(sky[lanes[live]], want.sky.numpy(), lanes, "sky")


def check_mirror_mix_call(args, live, s, block):
    h, scene = args["h"], args["scene"]
    ray, direct, gi = args["rest"]
    c = an_shade_cuda.shade_consts(scene.params)
    got = model_mirror_mix(
        block, c, _rows(h.mat, ray.hit.t.shape, 0, live, torch.int32),
        _flat(ray.hit.t, live), _flat(ray.hit.mat, live),
        _flat(ray.sky, live), _flat(direct, live),
        None if gi is None else (_flat(gi.hit.t, live),
                                 _flat(gi.cos_theta, live),
                                 _flat(gi.lit, live), _flat(gi.sky, live)))
    want = tlt.mirror_mix_plain(scene, h, args["mat"], ray, direct, gi)
    _check(got, want.numpy(), live, "mirror")


CHECKS = {"trace": check_trace_call, "ambient_occlusion": check_ao_call,
          "bounce": check_bounce_call, "sky": check_sky_call,
          "glass_rays": check_glass_rays_call,
          "glass_mix": check_glass_mix_call,
          "mirror_ray": check_mirror_ray_call,
          "mirror_mix": check_mirror_mix_call}


def _shape_of(name, args):
    if name == "trace":
        return torch.broadcast_shapes(args["ro"].shape[:-1],
                                      args["rd"].shape[:-1])
    if name == "sky":
        return args["d"].shape[:-1]
    if name in ("glass_mix", "mirror_mix"):
        return args["rest"][0].k.shape if name == "glass_mix" \
            else args["rest"][0].hit.t.shape
    return (args["h0"] if name == "bounce" else args["h"]).t.shape


@pytest.mark.parametrize("spp", [1, 2])
def test_kernel_lanes_match_the_plain_versions(spp, day_sky, monkeypatch):
    """(a) and (c) on every call of an an_full frame: the transcription on
    the live lanes of the frame's own mask, of no mask, of a partial mask
    and of an empty one, each input read as the kernel reads it, equals
    the dense plain version there bit for bit."""
    params = _params("full", spp=spp, env=True)
    calls = record_calls(params, day_sky, monkeypatch)
    s, block = _consts(params)
    rng = np.random.RandomState(spp)
    for label, (name, args, active) in calls.items():
        shape = _shape_of(name, args)
        masks = {"frame": active, "none": None,
                 "partial": torch.from_numpy(rng.rand(*shape) < 0.3),
                 "empty": torch.zeros(shape, dtype=torch.bool)}
        for how, mask in masks.items():
            live = _live(mask, shape)
            if how == "empty":
                assert not live.any()
            if live.any():  # the frame's glass skies may have none
                # a miss's p is o + d*1e30: its squares overflow, as in
                # the plain version
                with np.errstate(over="ignore", invalid="ignore"):
                    CHECKS[name](args, live, s, block)


def _rays(seed, n=4096):
    """Rays at every primitive of the scene and at none: from around the
    camera, from inside the spheres, grazing the floor (|d.y| below and
    above the 1e-6 guard), straight up, at the marker."""
    rng = np.random.RandomState(seed)
    o = rng.uniform((-3.0, 0.05, -7.0), (3.0, 3.5, 1.0), (n, 3)).astype(F32)
    aim = rng.uniform((-2.0, 0.0, -6.0), (2.0, 2.0, -2.0), (n, 3))
    d = (aim - o).astype(F32)
    q = n // 8
    d[:q] = rng.normal(size=(q, 3))                   # any direction
    d[q:2 * q, 1] = rng.choice([0.0, 5e-7, -5e-7, 2e-6, -2e-6], q)
    o[2 * q:3 * q] = F32([1.2, 0.7, -2.5]) + rng.uniform(-0.3, 0.3, (q, 3))
    d[3 * q:3 * q + 8] = (0.0, 1.0, 0.0)              # up: a miss
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(F32))


@pytest.mark.parametrize("glass, marker", [(True, True), (False, True),
                                           (True, False)])
@pytest.mark.parametrize("point_light", [1, 0])
def test_trace_rules_are_the_plain_trace(glass, marker, point_light):
    """The trace's rules on rays aimed at every primitive and at none: t,
    p, the normal and the material bit for bit, misses' p = o + d*1e30."""
    params = _params("full", point_light_enabled=point_light,
                     point_light_pos=(0.5, 1.1, -3.0))
    p = bind_params(params)
    s, block = _consts(params)
    o, d = _rays(7 + point_light)
    # the marker sits on some of the rays
    d[3 * 512 + 8:3 * 512 + 72] = torch.from_numpy(_norm(
        F32(block["point_light_world"]) - o[3 * 512 + 8:3 * 512 + 72]
        .numpy()))
    want = tsa.trace_analytic_core(o, d, p, p["point_light_world"], glass,
                                   marker)
    mk = an_trace_cuda._marker(p, marker)
    got = model_trace(s, block, o.numpy(), d.numpy(), glass, mk, F32(EPS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    t = got[0]
    assert (t == INF).any()
    for m in (0, 1, 3) + ((2,) if glass else ()) + ((4,) if mk else ()):
        assert (got[3][t < INF] == m).any(), m
    miss = t == INF
    np.testing.assert_array_equal(got[1][miss],
                                  o.numpy()[miss] + d.numpy()[miss] * INF)
    assert not got[2][miss].any()


# ---- (b) the JAX package's gated frames ----

def _jfin(cam):
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    return JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.asarray((0.0, 0.0), jnp.float32),
        curr_view_proj=jnp.asarray(vp), prev_view_proj=jnp.asarray(vp),
        camera_moved=jnp.int32(0))


def _rand_env(seed=3, f=8):
    """tests/test_pipeline.py's random environment."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (6, f, f, 3)).astype(F32) / F32(255.0)


def _jax_frame(jparams, jenv, no_jit=False):
    cam = JCamera()
    cam.aspect = JW / JH
    with jax.disable_jit() if no_jit else contextlib.nullcontext():
        _, out = jrender_frame(jparams, _jfin(cam),
                               JRenderState.create(JH, JW), env_map=jenv,
                               height=JH, width=JW)
        return np.asarray(out.image), _jfin(cam)


def _port_frame(jparams, jfin, env):
    params = params_from(jparams)
    _, out = render_frame(params, frame_inputs_from_numpy(jfin, "cpu"),
                          RenderState.create(JH, JW, "cpu"),
                          None if env is None else env_from_numpy(env, "cpu"),
                          height=JH, width=JW)
    return out.image.numpy()


# the JAX gates' settings, two frames: the glass and mirror tile gate with
# room (its compact branch) and the sky miss gate under a random
# environment; the tile gate with no room (its dense fallback) and the hit
# gate.  Both frames run with jit disabled: a lax.cond then runs the one
# branch it takes, op by op, where an eager lax.cond compiles both
# branches' shade trees (20 s a frame here)
GATES = {
    "analytic_and_sky_miss_gates": (
        {"ORT_ANALYTIC_GATE_FRAC": "0.5", "ORT_SKY_MISS_GATE": "0.9"}, True),
    "analytic_fallback_and_hit_gates": (
        {"ORT_ANALYTIC_GATE_FRAC": "1e-6", "ORT_AN_HIT_GATE": "0.9"}, False),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_frame_meets_the_jax_gated_frame(gate, monkeypatch):
    env_vars, with_env = GATES[gate]
    for k in ("ORT_ANALYTIC_GATE_FRAC", "ORT_SKY_MISS_GATE",
              "ORT_AN_HIT_GATE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env_vars.items():
        monkeypatch.setenv(k, v)
    jparams = jpreset("full").replace(enable_env_map=int(with_env))
    env = _rand_env() if with_env else None
    want, jfin = _jax_frame(jparams, None if env is None
                            else jnp.asarray(env), no_jit=True)
    got = _port_frame(jparams, jfin, env)
    assert np.isfinite(got).all() and got.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 + 1e-5)


# ---- (d) the recorder ----

REC_FRAMES = (1, 8, 2 ** 20 + 5)
REC_CASES = {"an_baseline": ("baseline", 1, False),
             "an_full": ("full", 1, True), "an_full_spp2": ("full", 2, True)}


@pytest.mark.parametrize("case", list(REC_CASES))
def test_masked_frame_is_the_same_for_every_frame(case, day_sky,
                                                  monkeypatch):
    name, spp, with_env = REC_CASES[case]
    params = _params(name, spp=spp, env=with_env)
    env = day_sky if with_env else None
    runs = ([(params, index) for index in REC_FRAMES]
            + [(params.replace(**seeded_values(seed)), REC_FRAMES[0])
               for seed in (1, 2)])
    rng = np.random.RandomState(0)
    hist = torch.from_numpy(rng.uniform(0.0, 1.0, (H, W, 4)).astype(F32))
    for p, index in runs:  # warm: caches and each parameter set's block
        render_staged(p, _fin(index), RenderState(hist.clone(), index), env,
                      height=H, width=W)
    records = []
    for p, index in runs:
        fin, state = _fin(index), RenderState(hist.clone(), index)
        with recording(monkeypatch) as rec:
            render_staged(p, fin, state, env, height=H, width=W)
        monkeypatch.undo()
        records.append(rec.ops)
    kernels = [op for op in records[0] if op[0] == "kernel"]
    names = [op[1] for op in kernels]
    labels = _labels(params)
    gates = WRAPPERS + SHADE_WRAPPERS
    assert [n for n in names if n in gates] == [w for w, _ in labels]
    # the masks reach the kernels: every call but the primary trace reads
    # one (the last of each call's input modes)
    calls = [op for op in kernels if op[1] in gates]
    assert calls[0][2][-1][-1] is None
    assert all(op[2][-1][-1] is not None for op in calls[1:])
    for ops in records[1:]:
        assert len(ops) == len(records[0])
        for i, (a, b) in enumerate(zip(records[0], ops)):
            assert a == b, f"operation {i}: {a} != {b}"
    reads = sorted({op[0] for op in records[0] if op[0] in HOST_READS})
    assert not reads, f"the frame reads the device: {reads}"
    assert not [op for op in records[0]
                if op[0] in ("aten::index.Tensor", "aten::masked_select",
                             "aten::index_put_")
                and "torch.bool" in str(op)], "a boolean index"
