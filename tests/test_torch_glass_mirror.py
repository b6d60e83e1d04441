"""Glass and mirror shading split at their kernels (csrc/an_shade.cu
behind ops/an_shade_cuda.py), on the CPU.

`shade_glass` and `shade_mirror` are a rays call (the setup, the
secondary traces, the skies), the direct light at the secondaries' hits
(and, for the mirror with GI, its bounce), and a mix call (the selects
and mixes), each of which runs a kernel on the card on the material's
lanes alone.  Here:

(a) the four plain halves (lighting.glass_rays_plain, glass_mix_plain,
    mirror_ray_plain, mirror_mix_plain), composed with the direct light
    and GI's bounce, equal the JAX package's lt.shade_glass and
    lt.shade_mirror on the JAX hit's glass and mirror lanes, on the same
    seeded inputs, within K3's tolerance (rtol 2e-5, atol 2e-6: the JAX
    direct light's transcendentals), GI's bounce included.  48x64, the
    gradient sky and cubemaps/sky_day.png, 1 and 2 samples (the port's
    sample batch over [spp, H, W], the JAX package's function once a
    sample seed);
(b) the rewritten shade_glass / shade_mirror equal the unsplit
    composition they replace (a private copy below) bit for bit on the
    lanes the caller keeps, with the frame's masks and without, and with
    `out` they leave every other lane of it as it was;
(c) an an_baseline frame meets the JAX package's gated frame
    (ORT_ANALYTIC_GATE_FRAC 0.5, its glass and mirror tile gate on its
    compact branch) within tests/test_torch_analytic_gates.py's frame
    tolerance; the an_full frame's gate is that file's
    test_frame_meets_the_jax_gated_frame.

The file takes ~40 s alone:
    python -m pytest tests/test_torch_glass_mirror.py -q
"""

import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models.pipeline import primary_rays
from opengl_raytracing_tpu.models.pipeline import _sanitize_hit as jsanitize
from opengl_raytracing_tpu.ops import lighting as jlt
from opengl_raytracing_tpu.ops import materials as jmat
from opengl_raytracing_tpu.ops.scene import SceneCtx as JSceneCtx

from opengl_raytracing_tpu_torch.constants import EPS
from opengl_raytracing_tpu_torch.convert import env_from_numpy, params_from
from opengl_raytracing_tpu_torch.models.pipeline import _material_lanes
from opengl_raytracing_tpu_torch.ops import cuda_lib
from opengl_raytracing_tpu_torch.ops import lighting as tlt
from opengl_raytracing_tpu_torch.ops import materials as tmat
from opengl_raytracing_tpu_torch.ops import scene_analytic as tsa
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx
from opengl_raytracing_tpu_torch.ops.vecmath import (mix, normalize, reflect,
                                                     refract, dot)
from opengl_raytracing_tpu_torch.sampling import FrameValue, sample_seeds
from opengl_raytracing_tpu_torch.utils import image as timage

from test_torch_analytic_gates import GATES, _jax_frame, _port_frame

torch.set_num_threads(2)

H, W = 48, 64
F32 = np.float32
TOL_K3 = dict(rtol=2e-5, atol=2e-6)
FRAME = {1: 6, 2: 3}  # frame index a sample count: seeds 6, and 6 and 7
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
CUBEMAP = os.path.join(ROOT, "cubemaps", "sky_day.png")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _scene(env_name, gi):
    """The JAX hit of the default camera on the analytic scene (`full`,
    GI on or off, the gradient sky or sky_day.png), both packages' scene
    contexts, pixel centres and view directions."""
    from test_torch_gi_ao import _jfin
    cam = JCamera()
    cam.aspect = W / H
    jparams = jpreset("full").replace(enable_gi=int(gi),
                                      enable_env_map=int(env_name == "day"))
    env = (timage.load_cubemap_cross(CUBEMAP) if env_name == "day"
           else None)
    jscene = JSceneCtx.create(jparams, jnp.asarray(cam.position),
                              env_map=None if env is None
                              else jnp.asarray(env), use_bvh=False)
    scene = SceneCtx.create(params_from(jparams), _t(cam.position),
                            env_map=None if env is None
                            else env_from_numpy(env, "cpu"), use_bvh=False)
    px, py, rd = primary_rays(H, W, _jfin(cam), jparams)
    ro = jnp.broadcast_to(jnp.asarray(cam.position), rd.shape)
    jh_raw = jscene.trace(ro, rd)
    jh = jsanitize(jh_raw, ro, rd)
    return dict(jscene=jscene, scene=scene, jh=jh, hit=np.asarray(
        jh_raw.valid), h=tsa.Hit(*(_t(x) for x in jh)), px=np.asarray(px),
        py=np.asarray(py), vdir=-np.asarray(rd))


@functools.lru_cache(maxsize=None)
def _jax_shade(which, env_name, gi, seed, frame_index):
    f = _scene(env_name, gi)
    jfn = jlt.shade_mirror if which == "mirror" else jlt.shade_glass
    jm = jmat.get_material(f["jh"].mat, f["jscene"].params)
    return np.asarray(jfn(f["jscene"], f["jh"], jnp.asarray(f["vdir"]), jm,
                          jnp.int32(seed), jnp.int32(frame_index),
                          jnp.asarray(f["px"]), jnp.asarray(f["py"])))


def _batch(f, spp):
    """The port's inputs as the frame hands them: with spp > 1 the hit,
    view and pixel centres broadcast over a leading sample axis, the seeds
    one sampled value."""
    fi = FrameValue.of(FRAME[spp], "cpu")
    h, vdir, px, py = f["h"], _t(f["vdir"]), _t(f["px"]), _t(f["py"])
    if spp > 1:
        h = tsa.Hit(*(x.expand((spp,) + x.shape) for x in h))
        vdir, px, py = (x.expand((spp,) + x.shape) for x in (vdir, px, py))
    return h, vdir, px, py, sample_seeds(fi, spp), fi


def _halves(which, scene, h, vdir, px, py, seed, fi):
    """The four plain halves composed, as shade_glass and shade_mirror
    compose their calls on the CPU."""
    if which == "glass":
        rays = tlt.glass_rays_plain(scene, h, vdir)
        lit = [tlt.direct_light_plain(scene, h2, seed, fi, v2, px, py)
               for h2, v2 in zip(rays.hits, rays.views)]
        return tlt.glass_mix_plain(scene, h, None, rays, lit)
    ray = tlt.mirror_ray_plain(scene, h, vdir)
    direct = tlt.direct_light_plain(scene, ray.hit, seed, fi, ray.view, px,
                                    py)
    gi = None
    if scene.params.enable_gi:
        gi = tlt.gi_light_analytic(scene, ray.hit, seed, seed * 131 + 17, fi,
                                   px, py)
    return tlt.mirror_mix_plain(scene, h, None, ray, direct, gi)


# (which, sky, samples, GI): glass reads no GI
CASES = [("glass", env, spp, False) for env in ("gradient", "day")
         for spp in (1, 2)] + [
    ("mirror", "gradient", 1, False), ("mirror", "day", 2, False),
    ("mirror", "day", 1, True), ("mirror", "gradient", 2, True)]


@pytest.mark.parametrize("which,env_name,spp,gi", CASES)
def test_plain_halves_match_jax(which, env_name, spp, gi):
    f = _scene(env_name, gi)
    scene = f["scene"]
    h, vdir, px, py, seed, fi = _batch(f, spp)
    before = dict(cuda_lib.LAUNCHES)
    got = _halves(which, scene, h, vdir, px, py, seed, fi).numpy()
    assert cuda_lib.LAUNCHES == before  # CPU tensors: no kernel
    got = got.reshape((spp, H, W, 3))
    mtype = tmat.get_material(f["h"].mat, scene.params).mtype.numpy()
    lanes = f["hit"] & (mtype == (tmat.MTYPE_MIRROR if which == "mirror"
                                  else tmat.MTYPE_GLASS))
    assert lanes.sum() > 15
    for s in range(spp):
        want = _jax_shade(which, env_name, gi, FRAME[spp] * spp + s,
                          FRAME[spp])
        g, w = got[s][lanes], want[lanes]
        assert np.isfinite(g).all() and g.std() > 1e-3
        np.testing.assert_allclose(g, w, **TOL_K3)


# ---- (b) the split against the unsplit composition ----

def _parent_gi(scene, h0, rng_frame, seed, frame_index, px, py, active):
    """one_bounce_gi_analytic as one function, before its split."""
    from opengl_raytracing_tpu_torch.constants import PI
    from opengl_raytracing_tpu_torch.ops import an_trace_cuda
    mat0 = tmat.get_material(h0.mat, scene.params)
    h1, wi, cos_theta = an_trace_cuda.bounce(scene, h0, rng_frame, seed, px,
                                             py, active)
    li_hit = tlt.direct_light(scene, h1, rng_frame, frame_index, -wi, px, py,
                              tlt.and_lanes(h1.valid, active))
    li = torch.where(h1.valid[..., None], li_hit,
                     scene.sky(wi, tlt.and_lanes(active, ~h1.valid)))
    out = mat0.albedo * (cos_theta / PI)[..., None] * li
    return torch.where((cos_theta > 0.0)[..., None], out, 0.0)


def _parent_glass(scene, h, wo, mat, seed, frame_index, px, py, active):
    """shade_glass as one function, before its split."""
    from opengl_raytracing_tpu_torch.constants import (
        GLASS_DISTORTION_STRENGTH, GLASS_LOCAL_REFL_WEIGHT)
    n = normalize(h.n)
    v = normalize(wo)
    i = -v
    ior = torch.clamp_min(mat.ior, 1.0001)
    eta = 1.0 / ior
    r = reflect(i, n)
    reflect_env = scene.sky(r, active)
    cos_theta = torch.clamp(dot(-i, n), 0.0, 1.0)
    t_phys, k = refract(i, n, eta)
    t_dir = normalize(mix(i, normalize(t_phys), GLASS_DISTORTION_STRENGTH))

    def secondary(d):
        h2 = scene.trace_ignore_glass(h.p + d * EPS, d, active=active)
        v2 = normalize(scene.cam_pos - h2.p)
        return tlt.direct_light(scene, h2, seed, frame_index, v2, px, py,
                                tlt.and_lanes(h2.valid, active)), h2.valid

    refl_lit, refl_valid = secondary(r)
    straight_lit, str_valid = secondary(i)
    bent_lit, bent_valid = secondary(t_dir)
    reflect_local = torch.where(refl_valid[..., None], refl_lit, reflect_env)
    reflect_col = mix(reflect_env, reflect_local, GLASS_LOCAL_REFL_WEIGHT)
    straight_col = torch.where(str_valid[..., None], straight_lit,
                               scene.sky(i, tlt.and_lanes(active,
                                                          ~str_valid)))
    bent_col = torch.where(bent_valid[..., None], bent_lit,
                           scene.sky(t_dir, tlt.and_lanes(
                               active, k > 0.0, ~bent_valid)))
    refr_col = torch.where((k > 0.0)[..., None],
                           mix(straight_col, bent_col,
                               GLASS_DISTORTION_STRENGTH), straight_col)
    refr_col = refr_col * mat.albedo
    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * torch.pow(1.0 - cos_theta, 5.0)
    return mix(refr_col, reflect_col, fresnel[..., None])


def _parent_mirror(scene, h, wo, mat, seed, frame_index, px, py, active):
    """shade_mirror as one function, before its split."""
    n = normalize(h.n)
    i = -normalize(wo)
    r = reflect(i, n)
    h2 = scene.trace(h.p + r * EPS, r, active=active)
    lanes = tlt.and_lanes(h2.valid, active)
    col_hit = tlt.direct_light(scene, h2, seed, frame_index, -r, px, py,
                               lanes)
    if scene.params.enable_gi:
        col_hit = col_hit + _parent_gi(
            scene, h2, seed, seed * 131 + 17, frame_index, px, py,
            lanes) * scene.params["gi_scale_analytic"]
    col = torch.where(h2.valid[..., None], col_hit,
                      scene.sky(r, tlt.and_lanes(active, ~h2.valid)))
    return col * mat.albedo


@pytest.mark.parametrize("masked", [False, True], ids=["all", "frame"])
@pytest.mark.parametrize("which,env_name,spp,gi", CASES)
def test_split_is_the_unsplit_composition(which, env_name, spp, gi, masked):
    f = _scene(env_name, gi)
    scene = f["scene"]
    h, vdir, px, py, seed, fi = _batch(f, spp)
    mat = tmat.get_material(h.mat, scene.params)
    _, mirror, glass = _material_lanes(h.mat, scene.params)
    active = None
    if masked:
        hit = torch.from_numpy(f["hit"].copy()).expand(h.t.shape)
        active = tlt.and_lanes(hit, mirror if which == "mirror" else glass)
    parent = _parent_mirror if which == "mirror" else _parent_glass
    want = parent(scene, h, vdir, mat, seed, fi, px, py, active)
    fn = tlt.shade_mirror if which == "mirror" else tlt.shade_glass
    # the frame's form: no material handed over, written into `out`
    out = torch.full(h.t.shape + (3,), -7.0)
    got = fn(scene, h, vdir, None if masked else mat, seed, fi, px, py,
             active, out=out)
    assert got is out
    keep = (torch.ones(h.t.shape, dtype=torch.bool) if active is None
            else active.expand(h.t.shape))
    assert int(keep.sum()) > 15
    assert torch.equal(got[keep], want[keep])
    assert bool((got[~keep] == -7.0).all())
    # without `out`: the result itself
    plain = fn(scene, h, vdir, mat, seed, fi, px, py, active)
    assert torch.equal(plain[keep], want[keep])


# ---- (c) the an_baseline frame against the JAX gated frame ----

def test_an_baseline_frame_meets_the_jax_gated_frame(monkeypatch):
    env_vars, _ = GATES["analytic_and_sky_miss_gates"]
    for k in ("ORT_ANALYTIC_GATE_FRAC", "ORT_SKY_MISS_GATE",
              "ORT_AN_HIT_GATE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ORT_ANALYTIC_GATE_FRAC",
                       env_vars["ORT_ANALYTIC_GATE_FRAC"])
    jparams = jpreset("baseline")
    want, jfin = _jax_frame(jparams, None, no_jit=True)
    got = _port_frame(jparams, jfin, None)
    assert np.isfinite(got).all() and got.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 + 1e-5)
