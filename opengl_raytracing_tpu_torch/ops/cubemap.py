"""Cubemap sampling (PyTorch).

Counterpart of `opengl_raytracing_tpu/ops/cubemap.py`.  The reference
samples a GL cubemap with `texture(uEnvMap, dir)` (reference:
shaders/rt/rt_scene_analytic.glsl:213-215).  Here the environment is a
`[6, F, F, 3]` float32 tensor and the face select and the bilinear
CLAMP_TO_EDGE fetch are done by hand: face math per the GL spec's cubemap
selection table, in the face order the loader produces (+X,-X,+Y,-Y,+Z,-Z;
reference: src/render/cubemap.cpp:86-91).

One form only: four row gathers of the flat `[6*F*F, 3]` table and the
blend `top + (bot - top) * fy`, the taps and the order every gather
lowering of the JAX package bit-matches.  The kernels repeat this
arithmetic per lane (csrc/cubemap.cuh); the sky kernel, the BVH hit mix
and glass's and the mirror's rays read the table's [6, F, F, 4] copy
(`texel4_table`).

Divisions here are tensor by tensor: PyTorch's CUDA `x / scalar` multiplies
by the reciprocal, which may round an ulp away from the true quotient the
CPU, the JAX package and the kernel compute.
"""

from __future__ import annotations

import weakref

import torch


def direction_to_face_uv(d):
    """dir [...,3] -> (face int32 [...], s [...], t [...]) in [0,1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    # face ids: 0:+X 1:-X 2:+Y 3:-Y 4:+Z 5:-Z
    face = torch.where(
        x_major, torch.where(x >= 0, 0, 1),
        torch.where(y_major, torch.where(y >= 0, 2, 3),
                    torch.where(z >= 0, 4, 5))).to(torch.int32)

    ma = torch.where(x_major, ax, torch.where(y_major, ay, az))
    ma = torch.clamp_min(ma, 1e-12)

    sc = torch.where(
        x_major, torch.where(x >= 0, -z, z),
        torch.where(y_major, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(
        x_major, -y,
        torch.where(y_major, torch.where(y >= 0, z, -z), -y))

    s = 0.5 * (sc / ma + 1.0)
    t = 0.5 * (tc / ma + 1.0)
    return face, s, t


def texel_table(env):
    """The float32 table of an environment: a uint8 table (8-bit sources)
    becomes k / 255 by true division, a float table is returned as is."""
    if env.dtype == torch.uint8:
        return env.to(torch.float32) / torch.full((), 255.0,
                                                  device=env.device)
    return env


# id(table) -> {the table's version: its [6, F, F, 4] copy}
_TEXEL4 = {}


def texel4_table(env):
    """The float32 table `env` [6, F, F, 3] as [6, F, F, 4], the rgb its
    bits and the fourth channel 0: the sky kernel's and the BVH hit mix's
    taps, an aligned 16-byte load each.  Made at the first call for the
    table as it stands (its identity and version) and kept while `env`
    lives, so a frame never copies it and a captured frame reads the copy
    its warm-up made (the graph key names the table by identity)."""
    versions = _TEXEL4.get(id(env))
    if versions is None:
        versions = _TEXEL4[id(env)] = {}
        weakref.finalize(env, _TEXEL4.pop, id(env), None)
    version = 0 if env.is_inference() else env._version
    got = versions.get(version)
    if got is None:
        got = versions[version] = torch.nn.functional.pad(env, (0, 1))
    return got


def sample_cubemap(env, d):
    """Bilinear cubemap fetch: env [6,F,F,3], d [...,3] -> rgb [...,3].

    Equivalent to GL_LINEAR + CLAMP_TO_EDGE within a face (the reference
    does not request seamless filtering)."""
    face, s, t = direction_to_face_uv(d)
    f = env.shape[1]

    xs = s * f - 0.5
    ys = t * f - 0.5
    x0 = torch.clamp(torch.floor(xs), 0, f - 1)
    y0 = torch.clamp(torch.floor(ys), 0, f - 1)
    fxs = torch.clamp(xs - x0, 0.0, 1.0)
    fys = torch.clamp(ys - y0, 0.0, 1.0)
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, f - 1)
    y1 = torch.clamp_max(y0 + 1, f - 1)

    row0 = (face * f + y0) * f
    row1 = (face * f + y1) * f
    envf = texel_table(env).reshape(-1, 3)
    c00, c01 = envf[row0 + x0], envf[row0 + x1]
    c10, c11 = envf[row1 + x0], envf[row1 + x1]

    fx = fxs[..., None]
    fy = fys[..., None]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def dummy_cubemap(size: int = 1, device="cuda"):
    """1x1 blue-ish fallback cubemap so env samplers are always valid
    (reference: src/render/cubemap.cpp:7-31, pixel (128,128,255)/255), on
    `device` (the card unless the caller asks for the CPU)."""
    base = (torch.tensor([128.0, 128.0, 255.0], dtype=torch.float32)
            / torch.tensor(255.0)).to(device)
    return base.expand(6, size, size, 3).contiguous()
