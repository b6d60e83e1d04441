"""Tonemapping and debug color mapping
(reference: shaders/rt/rt_present.frag:65-104, 262-264).

Counterpart of `opengl_raytracing_tpu/ops/tonemap.py`: plain PyTorch ops
(the JAX package computes these outside any kernel too).
"""

from __future__ import annotations

import torch


def aces_tonemap(x, exposure: float):
    """ACES approximation (Narkowicz 2015) with exposure pre-multiply
    (reference: rt_present.frag:65-69)."""
    x = x * exposure
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def gamma_encode(x, gamma: float = 2.2):
    """sRGB-ish gamma (reference: rt_present.frag:263)."""
    return torch.pow(torch.clamp_min(x, 0.0), 1.0 / gamma)


def hsv2rgb(h, s, v):
    """(reference: rt_present.frag:74-77).  The hue wraps by
    `torch.remainder` (the sign of the divisor, as GLSL's mod), so a
    negative hue lands in [0, 1)."""
    def chan(offset):
        p = (torch.remainder(h + offset, 1.0) * 6.0 - 3.0).abs()
        return v * (1.0 + s * (torch.clamp(p - 1.0, 0.0, 1.0) - 1.0))
    return torch.stack([chan(0.0), chan(2.0 / 3.0), chan(1.0 / 3.0)], dim=-1)


def visualize_motion(motion, scale: float):
    """HSV motion wheel: hue = direction, value = magnitude; deadband black
    (reference: rt_present.frag:92-104)."""
    m = motion * scale
    mag = torch.sqrt((m * m).sum(-1))
    two_pi = torch.full((), 2.0 * 3.1415926535, dtype=torch.float32,
                        device=motion.device)
    hue = torch.atan2(m[..., 1], m[..., 0]) / two_pi + 0.5
    val = torch.clamp(mag, 0.0, 1.0)
    rgb = hsv2rgb(hue, torch.ones_like(hue), val)
    return torch.where((mag < 1e-4)[..., None], 0.0, rgb)
