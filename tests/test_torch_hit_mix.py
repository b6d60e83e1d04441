"""Both scenes' shading tails on the hit lanes (csrc/hit_mix.cu behind
ops/hit_mix_cuda.py), on the CPU.

After its direct light (and GI's bounce) each scene's shading is one
call: `bvh_hit_mix` (GI's tail with the sky of the bounce's misses, the
GI sum, the AO product) and `an_hit_mix` (GI's tail, the GI sum and the
AO product on the diffuse lanes, the point-light marker's emissive),
each handed the frame's hit mask and on the card computing its live
lanes alone: the rest of the JAX package's hit gates.  The kernels
cannot run here, so:

(a) the masks bite on the CPU: every wrapper of the frame is replaced by
    one that fills the lanes its mask marks dead with garbage (the
    analytic ones by tests/test_torch_analytic_gates.py's spies, the BVH
    direct light and AO here; NaN, or values that look like a hit), and
    each hit mix leaves garbage on every lane it does not write; the
    frames rendered so equal bit for bit the frames of the previous dense
    form (a private copy of the shading tails below, over every lane):
    BVH `full` (the gradient sky and cubemaps/sky_day.png), `heavy` at 2
    samples, `realistic`, GI or AO alone; the analytic `full` under the
    gradient sky and sky_day.png, 2 samples, GI and AO off and on, the
    marker, mirror and glass off and on, `baseline`;
(b) the port's trace_and_shade and frame meet the JAX package's gated and
    dense ones, with its gates set through the environment
    (ORT_BVH_GATE_FRAC 0.6 and 1e-6 as in tests/test_pipeline.py, 0 its
    dense form; ORT_AN_HIT_GATE 0.9 at a 128-lane width, 0 dense):
    rtol and atol 1e-4 on trace_and_shade and the frame, the tolerance
    of tests/test_torch_spp_batch.py and tests/test_torch_analytic_gates
    .py, plus the JAX gates' own 6e-7 against their dense form where a
    gate is on;
(c) a numpy transcription of the kernels' per-lane rules (the BVH
    tail's valid select and sky, albedo * (cos / PI) * li, the firefly
    clamp as the reciprocal times GI_MAX_LUM, the cut; the analytic
    tail from the material table; the marker's falloff as a reciprocal;
    the lanes each kernel writes; each input read as the kernel reads it,
    the hit and AO a row a pixel under the sample axis), reading its
    constants from the structs the wrappers build, equals the plain
    versions bit for bit on live lanes, for the frame's mask, none, a
    partial one and an empty one, at 1 and 2 samples.  cos / PI is the
    CPU's division, as the plain version on the CPU takes it (the card's
    kernels and PyTorch multiply by float32(1 / float32(PI)));
(d) tests/torch_recorder.py sees the hit mix once a frame among the same
    operations and host arguments at every frame index and parameter
    set, and no host read.

The file takes ~160 s alone, most of it the JAX package's compiles in (b):
    python -m pytest tests/test_torch_hit_mix.py -q
"""

import functools
import inspect
import types

import numpy as np
import jax
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import RenderState as JRenderState
from opengl_raytracing_tpu.models import pipeline as jpipe
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models import render_frame as jrender_frame
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.constants import (BVH_ALBEDO, GI_MAX_LUM,
                                                   GI_MIN_COS_THETA,
                                                   MAT_POINTLIGHT_SPHERE, PI,
                                                   YCOEFF)
from opengl_raytracing_tpu_torch.convert import (camera_frame_inputs,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (RenderState, pipeline,
                                                render_frame)
from opengl_raytracing_tpu_torch.models.pipeline import render_staged
from opengl_raytracing_tpu_torch.ops import (an_cuda, bvh_cuda, cuda_lib,
                                             hit_mix_cuda)
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.ops.scene_analytic import Hit
from opengl_raytracing_tpu_torch.ops.vecmath import const3, dot, length
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

from test_torch_analytic_gates import (GARBAGE, H, INF, W, _consts,
                                       _jax_frame, _jfin, _lanes, _live,
                                       _mat_row, _params, _port_frame,
                                       _rand_env, _render, _spy, bind_params,
                                       day_sky, model_sky)  # noqa: F401
from test_torch_spp_batch import _frame as _both_frames
from test_torch_walk_sampling import _dot, _lib
from torch_param_block import seeded_values
from torch_recorder import HOST_READS, recording

torch.set_num_threads(2)

F32 = np.float32
MIX = ("bvh_hit_mix", "an_hit_mix")


# ---- the previous dense form: the shading tails over every lane ----

def _dense_bvh_tail(scene, radiance, gi, ao, active=None):
    """_shade_bvh's tail as it was before its kernel: GI's tail with the
    sky on every lane, the GI sum and the AO product, over every lane."""
    params = scene.params
    if gi is not None:
        li = torch.where(gi.hit.valid[..., None], gi.lit, scene.sky(gi.wi))
        dev = gi.cos_theta.device
        contrib = (const3(BVH_ALBEDO, dev) * (gi.cos_theta / PI)[..., None]
                   * li)
        lum = dot(contrib, const3(YCOEFF, dev))
        scale = torch.where(lum > GI_MAX_LUM,
                            GI_MAX_LUM / torch.clamp_min(lum, 1e-6), 1.0)
        contrib = contrib * scale[..., None]
        radiance = radiance + torch.where(
            (gi.cos_theta > GI_MIN_COS_THETA)[..., None], contrib, 0.0) \
            * params["gi_scale_bvh"]
    if ao is not None:
        radiance = radiance * ao[..., None]
    return radiance


def _dense_an_tail(scene, h, radiance, gi, ao, active=None):
    """_shade_analytic's tail as it was before its kernel: GI's tail, the
    GI sum, the AO product and the marker's select, over every lane."""
    params = scene.params
    if gi is not None:
        radiance = radiance + tlt.gi_tail_analytic(scene, h, gi) \
            * params["gi_scale_analytic"]
    if ao is not None:
        radiance = radiance * ao[..., None]
    base_col = params["point_light_color"] * params["point_light_intensity"]
    d = length(h.p - scene.cam_pos)
    falloff = 1.0 / torch.clamp_min(d * d * 0.25 + 1.0, 1.0)
    emissive = base_col * falloff[..., None]
    is_marker = h.mat == MAT_POINTLIGHT_SPHERE
    return torch.where(is_marker[..., None], emissive, radiance)


def _dense(monkeypatch):
    monkeypatch.setattr(hit_mix_cuda, "bvh_hit_mix", _dense_bvh_tail)
    monkeypatch.setattr(hit_mix_cuda, "an_hit_mix", _dense_an_tail)


# ---- (a) the masks, in the frame ----

def _bvh_scene():
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    return prepare_bvh(tris, "cpu")


@pytest.fixture(scope="module")
def bunny():
    return _bvh_scene()


def _bvh_render(params, env, bvh, index=3):
    """One bunny frame at 48x64 on a seeded history: image, accumulation."""
    cam = Camera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    fin = camera_frame_inputs(cam, "cpu", jitter=(0.13, -0.21),
                              frame_index=index)
    rng = np.random.RandomState(index)
    accum = torch.from_numpy(rng.uniform(0.0, 1.0, (H, W, 4)).astype(F32))
    state, out = render_frame(params, fin, RenderState(accum, index), env,
                              bvh, height=H, width=W, use_bvh=True)
    return out.image.clone(), state.accum.clone()


def _dead(active, x, value):
    """`x` [..., (3)] with the lanes `active` marks dead set to `value`."""
    if active is None:
        return x
    shape = torch.broadcast_shapes(x.shape[:active.dim()], active.shape)
    dead = ~active.expand(shape)
    if x.dim() > len(shape):
        dead = dead[..., None]
    return torch.where(dead, torch.full_like(x, value), x)


def _unread_gi(gi, live):
    """GI's rows with valid values on the lanes `live` marks dead, as a
    plain version is handed them (the kernels read none of them)."""
    if gi is None:
        return None
    up = torch.tensor((0.0, 1.0, 0.0))
    rows = dict(hit=gi.hit._replace(t=torch.where(live, gi.hit.t, 1.0)),
                cos_theta=torch.where(live, gi.cos_theta, 0.5),
                lit=torch.where(live[..., None], gi.lit, up))
    if hasattr(gi, "wi"):
        rows["wi"] = torch.where(live[..., None], gi.wi, up)
    else:
        rows["sky"] = torch.where(live[..., None], gi.sky, up)
    return gi._replace(**rows)


def _mix_spy(monkeypatch, calls, value):
    """Replace the two hit-mix wrappers by ones that note each call and,
    as the kernels read no dead lane and write only their lanes, hand the
    real (plain) route valid values on the dead lanes and leave `value`
    on every lane they do not write; and the BVH direct light and AO by
    ones that leave `value` on their dead lanes."""
    real = {n: getattr(hit_mix_cuda, n) for n in MIX}

    def mix(name):
        def fn(*args, **kw):
            a = inspect.signature(real[name]).bind(*args, **kw)
            a.apply_defaults()
            a = dict(a.arguments)
            calls.append((name, a["active"]))
            radiance, active = a["radiance"], a["active"]
            shape = radiance.shape[:-1]
            live = active.expand(shape)
            written = live
            if name == "an_hit_mix":
                written = live & tlt.an_mix_lanes(
                    a["h"].mat, a["scene"].params).expand(shape)
            tmp = torch.where(live[..., None], radiance, 0.5)
            ao = a["ao"]
            ao = None if ao is None else torch.where(
                live, ao.expand(shape), 1.0)
            real[name](**dict(a, radiance=tmp, ao=ao,
                              gi=_unread_gi(a["gi"], live)))
            return radiance.copy_(torch.where(
                written[..., None], tmp, torch.full_like(tmp, value)))
        return fn
    real_k5 = an_cuda.direct_light_bvh
    real_ao = bvh_cuda.ambient_occlusion

    def k5(*args, **kw):
        a = inspect.signature(real_k5).bind(*args, **kw)
        return _dead(a.arguments.get("active"), real_k5(*args, **kw), value)

    def ao(*args, **kw):
        a = inspect.signature(real_ao).bind(*args, **kw)
        return _dead(a.arguments.get("active"), real_ao(*args, **kw), value)
    for name in MIX:
        monkeypatch.setattr(hit_mix_cuda, name, mix(name))
    monkeypatch.setattr(an_cuda, "direct_light_bvh", k5)
    monkeypatch.setattr(bvh_cuda, "ambient_occlusion", ao)


BVH_CASES = {
    "full": dict(name="full"),
    "full_cubemap": dict(name="full", env=True),
    "heavy_spp2": dict(name="heavy", spp=2),
    "realistic": dict(name="realistic"),
    "gi_only": dict(name="full", enable_ao=0),
    "ao_only": dict(name="full", enable_gi=0),
}
# (case, garbage): NaN everywhere, valid-looking values on two cases
BVH_RUNS = [(c, "nan") for c in BVH_CASES] + [("full", "plausible"),
                                              ("heavy_spp2", "plausible")]


@pytest.mark.parametrize("case,garbage", BVH_RUNS)
def test_bvh_frames_read_no_dead_lane(case, garbage, bunny, day_sky,
                                      monkeypatch):
    c = dict(BVH_CASES[case])
    params = _params(c.pop("name"), **c)
    env = day_sky if params.enable_env_map else None
    _dense(monkeypatch)
    want = _bvh_render(params, env, bunny)
    monkeypatch.undo()
    calls = []
    _mix_spy(monkeypatch, calls, GARBAGE[garbage][0])
    got = _bvh_render(params, env, bunny)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # one call, handed the hit mask: some lanes live, some dead
    assert [c[0] for c in calls] == ["bvh_hit_mix"]
    live = calls[0][1].float().mean()
    assert 0.0 < float(live) < 1.0


AN_CASES = {
    "full_gradient": dict(name="full"),
    "full_cubemap": dict(name="full", env=True),
    "full_spp2": dict(name="full", spp=2, env=True),
    "gi_only": dict(name="full", enable_ao=0),
    "ao_only": dict(name="full", enable_gi=0),
    "no_gi_ao": dict(name="full", enable_gi=0, enable_ao=0),
    "no_mirror_glass": dict(name="full", mat_mirror_enabled=0,
                            mat_glass_enabled=0),
    "no_marker": dict(name="full", point_light_enabled=0),
    "baseline": dict(name="baseline"),
}
AN_RUNS = [(c, "nan") for c in AN_CASES] + [
    ("full_cubemap", "plausible"), ("full_spp2", "plausible"),
    ("no_mirror_glass", "huge")]


@pytest.mark.parametrize("case,garbage", AN_RUNS)
def test_analytic_frames_read_no_dead_lane(case, garbage, day_sky,
                                           monkeypatch):
    c = dict(AN_CASES[case])
    params = _params(c.pop("name"), **c)
    env = day_sky if params.enable_env_map else None
    _dense(monkeypatch)
    want = _render(params, env)
    monkeypatch.undo()
    calls = []
    _spy(monkeypatch, [], garbage)
    _mix_spy(monkeypatch, calls, GARBAGE[garbage][0])
    got = _render(params, env)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [c[0] for c in calls] == ["an_hit_mix"]
    assert 0.0 < float(calls[0][1].float().mean()) < 1.0


# ---- (c) the kernels' per-lane rules, transcribed ----

def _record(monkeypatch, render):
    """The hit-mix calls of one frame (`render()`), each's arguments with
    its radiance as the call found it."""
    calls = []
    real = {n: getattr(hit_mix_cuda, n) for n in MIX}

    def spy(name):
        def fn(*args, **kw):
            a = inspect.signature(real[name]).bind(*args, **kw)
            a.apply_defaults()
            a = dict(a.arguments)
            calls.append((name, dict(a, radiance=a["radiance"].clone())))
            return real[name](*args, **kw)
        return fn
    for name in MIX:
        monkeypatch.setattr(hit_mix_cuda, name, spy(name))
    render()
    monkeypatch.undo()
    return calls


def model_bvh_mix(s, block, env, c, r, gi, ao):
    """bvh_hit_mix_kernel on rows: the radiance `r` [N, 3], GI's rows (t,
    wi, cos, lit) or None, AO [N] or None."""
    if gi is not None:
        t, wi, cs, lit = gi
        miss = ~(t < INF)
        li = lit.copy()
        if miss.any():
            li[miss] = model_sky(s, block, env, wi[miss])
        g = F32(list(s.bvh_albedo)) * (cs / F32(PI))[:, None] * li
        lum = _dot(g, F32(list(c.ycoeff)))
        over = lum > F32(c.max_lum)
        scale = (F32(1.0) / np.maximum(lum, F32(c.lum_floor))) \
            * F32(c.max_lum)
        g = np.where(over[:, None], g * scale[:, None], g)
        g = np.where((cs > F32(c.min_cos))[:, None], g, F32(0.0))
        r = r + g * F32(block["gi_scale_bvh"])
    if ao is not None:
        r = r * ao[:, None]
    return r


def model_an_writes(s, mat):
    """The lanes an_hit_mix_kernel writes of material ids `mat`: the
    marker's, and those whose type in the scene's table is diffuse."""
    types = np.asarray(list(s.mat_type))[np.where((mat >= 0) & (mat < 4),
                                                  mat, 4)]
    return (mat == MAT_POINTLIGHT_SPHERE) | (types == 0)


def model_an_mix(s, block, c, mat, p, cam, r, gi, ao):
    """an_hit_mix_kernel on rows it writes: a marker's emissive, else GI's
    tail (t, cos, lit, sky or None) times gi_scale_analytic added, then
    the product with AO (or None)."""
    if gi is not None:
        t, cs, lit, sky = gi
        li = np.where((t < INF)[:, None], lit, sky)
        g = _mat_row(block, "mat_albedo", mat) * (cs / F32(PI))[:, None] * li
        g = np.where((cs > F32(0.0))[:, None], g, F32(0.0))
        r = r + g * F32(block["gi_scale_analytic"])
    if ao is not None:
        r = r * ao[:, None]
    d3 = p - cam
    d = _lib("sqrt", np.maximum(_dot(d3, d3), F32(0.0)))
    falloff = F32(1.0) / np.maximum(d * d * F32(0.25) + F32(1.0), F32(1.0))
    base = F32(block["point_light_color"]) \
        * F32(block["point_light_intensity"])
    return np.where((mat == MAT_POINTLIGHT_SPHERE)[:, None],
                    base * falloff[:, None], r)


def _rows(x, n, width=0):
    """A row-a-lane input (an output of the calls before) as [n(, w)]."""
    return x.reshape((n, width) if width else (n,)).numpy()


def check_bvh_call(a, live):
    scene = a["scene"]
    shape = a["radiance"].shape[:-1]
    n = shape.numel()
    env = an_cuda.env_table(scene.params, scene.env_map,
                            torch.device("cpu"))
    s, block = _consts(scene.params, env)
    gi = a["gi"]
    rows = None if gi is None else tuple(
        _rows(x, n, w)[live] for x, w in ((gi.hit.t, 0), (gi.wi, 3),
                                          (gi.cos_theta, 0), (gi.lit, 3)))
    ao = None if a["ao"] is None else _lanes(a["ao"], shape, 0)[live]
    got = model_bvh_mix(s, block, env, hit_mix_cuda.mix_consts(),
                        _rows(a["radiance"], n, 3)[live], rows, ao)
    want = tlt.bvh_hit_mix_plain(scene, a["radiance"], gi, a["ao"])
    np.testing.assert_array_equal(got, _rows(want, n, 3)[live])


def check_an_call(a, live):
    scene, h = a["scene"], a["h"]
    shape = a["radiance"].shape[:-1]
    n = shape.numel()
    s, block = _consts(scene.params)
    mat = _lanes(h.mat, shape, 0, torch.int32)
    writes = model_an_writes(s, mat)
    np.testing.assert_array_equal(writes, tlt.an_mix_lanes(
        h.mat, scene.params).expand(shape).reshape(-1).numpy())
    lanes = live & writes
    gi = a["gi"]
    rows = None if gi is None else tuple(
        _rows(x, n, w)[lanes] for x, w in ((gi.hit.t, 0), (gi.cos_theta, 0),
                                           (gi.lit, 3), (gi.sky, 3)))
    ao = None if a["ao"] is None else _lanes(a["ao"], shape, 0)[lanes]
    got = model_an_mix(s, block, hit_mix_cuda.mix_consts(), mat[lanes],
                       _lanes(h.p, shape, 3)[lanes],
                       _lanes(scene.cam_pos, shape, 3)[lanes],
                       _rows(a["radiance"], n, 3)[lanes], rows, ao)
    want = tlt.an_hit_mix_plain(scene, h, a["radiance"], gi, a["ao"])
    np.testing.assert_array_equal(got, _rows(want, n, 3)[lanes])
    return int(lanes.sum())


RULE_CASES = {"bvh_full": (True, "full", 1, False),
              "bvh_spp2_cubemap": (True, "heavy", 2, True),
              "an_full": (False, "full", 1, False),
              "an_spp2_cubemap": (False, "full", 2, True),
              "an_no_ao": (False, "full", 2, False)}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_kernel_lanes_match_the_plain_versions(case, bunny, day_sky,
                                               monkeypatch):
    on_bvh, name, spp, cube = RULE_CASES[case]
    change = dict(enable_ao=0) if case == "an_no_ao" else {}
    params = _params(name, spp=spp, env=cube, **change)
    env = day_sky if cube else None
    calls = _record(monkeypatch, (lambda: _bvh_render(params, env, bunny))
                    if on_bvh else (lambda: _render(params, env)))
    assert len(calls) == 1
    kind, a = calls[0]
    assert kind == ("bvh_hit_mix" if on_bvh else "an_hit_mix")
    shape = a["radiance"].shape[:-1]
    if spp > 1:  # the hit's mask read once a pixel
        assert an_trace_mode(a["active"], shape) == "pixel"
    rng = np.random.RandomState(spp)
    masks = {"frame": a["active"], "none": None,
             "partial": torch.from_numpy(rng.rand(*shape) < 0.3),
             "empty": torch.zeros(shape, dtype=torch.bool)}
    frame = _live(a["active"], shape)
    for how, mask in masks.items():
        # the frame's dead lanes hold unspecified inputs: the kernel is
        # compared where the frame's mask is live too
        live = _live(mask, shape) & frame
        if how == "empty":
            assert not live.any()
        if on_bvh:
            check_bvh_call(a, live)
        else:
            written = check_an_call(a, live)
            assert bool(written) == (how != "empty")


def an_trace_mode(x, shape):
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    mode = an_trace_cuda.lane_input(x, shape, 0, x.dtype, x.device,
                                    "x")[0].mode
    return {an_trace_cuda.LANE: "lane", an_trace_cuda.PIXEL: "pixel",
            an_trace_cuda.ONE: "one"}[mode]


def test_tail_rules_at_the_clamp_and_the_cut():
    """The transcriptions on lanes at the tails' edges, against the plain
    versions bit for bit: the BVH tail at luminances around GI_MAX_LUM,
    cosines at and around GI_MIN_COS_THETA and 0, misses under the
    gradient sky; the analytic tail at cos <= 0, every material id
    (the written lanes), and the marker from the camera's position
    (falloff 1) out to far away."""
    params = bind_params(_params("full"))
    cam = torch.tensor((0.3, 1.2, 4.0))
    scene = types.SimpleNamespace(params=params, env_map=None, cam_pos=cam)
    rng = np.random.RandomState(11)
    n = 4096
    cs = rng.uniform(-0.2, 1.0, n).astype(F32)
    cs[:8] = (F32(GI_MIN_COS_THETA), np.nextafter(F32(GI_MIN_COS_THETA),
                                                 F32(1.0)), 0.0, -0.0,
              1.0, 0.5, F32(0.1), 0.0999)
    lit = rng.uniform(0.0, 40.0, (n, 3)).astype(F32)
    # luminances on both sides of the clamp: lit scaled so some land at it
    lit[8:64] = (F32(GI_MAX_LUM) * F32(PI) / F32(0.85)
                 / np.maximum(cs[8:64, None], F32(1e-3))
                 * rng.uniform(0.99, 1.01, (56, 1)).astype(F32))
    t = np.where(rng.rand(n) < 0.3, INF, F32(1.0)).astype(F32)
    wi = rng.normal(size=(n, 3)).astype(F32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    r = rng.uniform(0.0, 2.0, (n, 3)).astype(F32)
    ao = rng.uniform(0.2, 1.0, n).astype(F32)
    gi = tlt.GiLightBvh(Hit(torch.from_numpy(t), torch.zeros(n, 3),
                            torch.zeros(n, 3), torch.zeros(n, dtype=torch.int32)),
                        torch.from_numpy(wi), torch.from_numpy(cs),
                        torch.from_numpy(lit))
    want = tlt.bvh_hit_mix_plain(scene, torch.from_numpy(r), gi,
                                 torch.from_numpy(ao))
    s, block = _consts(params)
    got = model_bvh_mix(s, block, None, hit_mix_cuda.mix_consts(), r,
                        (t, wi, cs, lit), ao)
    np.testing.assert_array_equal(got, want.numpy())
    lum = _dot(F32(BVH_ALBEDO) * (cs / F32(PI))[:, None] * lit,
               F32(YCOEFF))
    assert (lum > F32(GI_MAX_LUM)).sum() > 20
    assert (lum[8:64] <= F32(GI_MAX_LUM)).any()

    # the analytic tail and the marker
    mat = rng.randint(-1, 6, n).astype(np.int32)
    p = (cam.numpy() + rng.normal(size=(n, 3)).astype(F32)
         * rng.uniform(0.0, 20.0, (n, 1)).astype(F32))
    p[:4] = cam.numpy()
    mat[:4] = MAT_POINTLIGHT_SPHERE
    sky = rng.uniform(0.0, 2.0, (n, 3)).astype(F32)
    h = Hit(torch.ones(n), torch.from_numpy(p), torch.zeros(n, 3),
            torch.from_numpy(mat))
    gi_an = tlt.GiLight(gi.hit, torch.from_numpy(cs), torch.from_numpy(lit),
                        torch.from_numpy(sky))
    s, block = _consts(params)
    writes = model_an_writes(s, mat)
    np.testing.assert_array_equal(
        writes, tlt.an_mix_lanes(h.mat, params).numpy())
    assert writes.any() and not writes.all()
    want = tlt.an_hit_mix_plain(scene, h, torch.from_numpy(r), gi_an,
                                torch.from_numpy(ao)).numpy()
    got = model_an_mix(s, block, hit_mix_cuda.mix_consts(), mat[writes],
                       p[writes], cam.numpy()[None], r[writes],
                       (t[writes], cs[writes], lit[writes], sky[writes]),
                       ao[writes])
    np.testing.assert_array_equal(got, want[writes])
    base = F32(block["point_light_color"]) \
        * F32(block["point_light_intensity"])
    np.testing.assert_array_equal(want[:4], np.broadcast_to(base, (4, 3)))


# ---- (b) the JAX package's gated and dense frames ----

def _gates(monkeypatch, **env):
    for k in ("ORT_BVH_GATE_FRAC", "ORT_AN_HIT_GATE",
              "ORT_ANALYTIC_GATE_FRAC", "ORT_SKY_MISS_GATE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


# (ORT_BVH_GATE_FRAC, samples): the compact branch with the sample axis,
# the dense form (the dense fallback: the frame's test below)
BVH_GATES = {"compact_spp2": ("0.6", 2), "dense": ("0", 1)}


@pytest.mark.parametrize("gate", list(BVH_GATES))
def test_bvh_trace_and_shade_meets_the_jax_gated_form(gate, monkeypatch):
    frac, spp = BVH_GATES[gate]
    _gates(monkeypatch, ORT_BVH_GATE_FRAC=frac)
    args, jargs = _both_frames(True, spp, 5)
    got = pipeline.trace_and_shade(*args, use_bvh=True)
    want = jpipe.trace_and_shade(*jargs, use_bvh=True, show_motion=False)
    curr = got[0].numpy()
    assert np.isfinite(curr).all()
    atol = 1e-4 + (6e-7 if frac != "0" else 0.0)
    for name, g, w in zip(("curr", "motion", "gpos", "gnrm"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=atol, err_msg=name)
    hit = got[3].abs().sum(-1) > 0
    assert 0.0 < float(hit.float().mean()) < 1.0
    assert float(got[0][hit].std()) > 0.01


def test_bvh_frame_meets_the_jax_gated_frame(monkeypatch):
    """A whole `full` bunny frame (GI, AO, TAA, SVGF) against the JAX
    package's jitted frame through its BVH hit gate on its dense fallback
    (ORT_BVH_GATE_FRAC 1e-6: one tile of room, more tiles hit)."""
    _gates(monkeypatch, ORT_BVH_GATE_FRAC="1e-6")
    tris = gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))
    jbvh = jprepare_bvh(tris)
    bvh = prepare_bvh(tris, "cpu")
    jparams = jpreset("full").replace(enable_env_map=0)
    cam = JCamera()
    cam.aspect = W / H
    cam.fov = 12.0
    cam.point_at((-2.0, 1.5, 0.0))
    jfin = _jfin(cam)
    jrender = jax.jit(functools.partial(jrender_frame, height=H, width=W,
                                        use_bvh=True))
    jstate, jout = jrender(jparams, jfin, JRenderState.create(H, W), None,
                           jbvh)
    state, out = render_frame(params_from(jparams),
                              frame_inputs_from_numpy(jfin, "cpu"),
                              RenderState.create(H, W, "cpu"), None, bvh,
                              height=H, width=W, use_bvh=True)
    img = out.image.numpy()
    assert np.isfinite(img).all() and img.std() > 0.01
    np.testing.assert_allclose(img, np.asarray(jout.image), rtol=1e-4,
                               atol=1e-4 + 6e-7)
    np.testing.assert_allclose(state.accum.numpy(), np.asarray(jstate.accum),
                               rtol=1e-4, atol=1e-4 + 6e-7)


# (environment, preset changes, with a random cubemap): the hit gate on
# its compact branch at 32x128 (AO off: the GI sum alone reaches the
# mix), and the dense form with a cubemap
AN_GATES = {"hit_gate": ({"ORT_AN_HIT_GATE": "0.9",
                          "ORT_ANALYTIC_GATE_FRAC": "1e-6"},
                         dict(enable_ao=0), False),
            "dense": ({"ORT_AN_HIT_GATE": "0", "ORT_ANALYTIC_GATE_FRAC": "0",
                       "ORT_SKY_MISS_GATE": "0"}, {}, True)}


@pytest.mark.parametrize("gate", list(AN_GATES))
def test_analytic_frame_meets_the_jax_gated_frame(gate, monkeypatch):
    env_vars, change, with_env = AN_GATES[gate]
    _gates(monkeypatch, **env_vars)
    jparams = jpreset("full").replace(enable_env_map=int(with_env), **change)
    env = _rand_env() if with_env else None
    want, jfin = _jax_frame(jparams, None if env is None
                            else jax.numpy.asarray(env), no_jit=True)
    got = _port_frame(jparams, jfin, env)
    assert np.isfinite(got).all() and got.std() > 0.02
    atol = 1e-4 + (1e-5 if gate == "hit_gate" else 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


# ---- (d) the recorder ----

REC_CASES = {"bvh_heavy": (True, "heavy", 2), "an_full": (False, "full", 1)}


@pytest.mark.parametrize("case", list(REC_CASES))
def test_frame_calls_the_hit_mix_once_the_same_every_frame(case, bunny,
                                                          monkeypatch):
    on_bvh, name, spp = REC_CASES[case]
    params = _params(name, spp=spp)
    bvh = bunny if on_bvh else None
    cam = Camera()
    cam.aspect = W / H
    if on_bvh:
        cam.fov = 12.0
        cam.point_at((-2.0, 1.5, 0.0))

    def fin(index):
        return camera_frame_inputs(cam, "cpu", jitter=(0.13, -0.21),
                                   frame_index=index)
    runs = ([(params, index) for index in (1, 2 ** 20 + 5)]
            + [(params.replace(**seeded_values(1)), 1)])
    hist = torch.from_numpy(np.random.RandomState(0).uniform(
        0.0, 1.0, (H, W, 4)).astype(F32))
    for p, index in runs:  # warm: caches and each parameter set's block
        render_staged(p, fin(index), RenderState(hist.clone(), index), None,
                      bvh, height=H, width=W, use_bvh=on_bvh)
    records = []
    for p, index in runs:
        f, state = fin(index), RenderState(hist.clone(), index)
        with recording(monkeypatch) as rec:
            render_staged(p, f, state, None, bvh, height=H, width=W,
                          use_bvh=on_bvh)
        monkeypatch.undo()
        records.append(rec.ops)
    kernels = [op[1] for op in records[0] if op[0] == "kernel"]
    mix = "bvh_hit_mix" if on_bvh else "an_hit_mix"
    assert kernels.count(mix) == 1
    assert not (set(MIX) - {mix}) & set(kernels)
    if on_bvh:
        # the direct light, GI's bounce and its light, AO, then the mix;
        # the sky once (the primary misses)
        assert kernels.index(mix) > max(
            i for i, k in enumerate(kernels)
            if k in ("direct_light_bvh", "trace_bounce",
                     "ambient_occlusion"))
        assert kernels.count("sky") == 1
    else:
        assert kernels.index(mix) < kernels.index("mirror_mix")
    # the mix reads the hit mask (the last of its input modes)
    op = next(op for op in records[0] if op[:2] == ("kernel", mix))
    assert op[2][-1][-1] is not None
    for ops in records[1:]:
        assert len(ops) == len(records[0])
        for i, (x, y) in enumerate(zip(records[0], ops)):
            assert x == y, f"operation {i}: {x} != {y}"
    reads = sorted({op[0] for op in records[0] if op[0] in HOST_READS})
    assert not reads, f"the frame reads the device: {reads}"
    assert cuda_lib.LAUNCHES[mix] == 0  # CPU tensors: the plain version
