"""Small vec3 helpers over [..., 3] tensors (GLSL built-in equivalents).

`dot` and `cross` are written out component by component, left to right.
That pins the float32 rounding order, so the plain PyTorch walker, its CUDA
kernel (csrc/bvh_trace.cu, the same expressions) and the JAX reference sum
in the same order on every device.
"""

from __future__ import annotations

import numpy as np
import torch


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    """jnp.cross's component formula."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def length(a):
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a, eps: float = 1e-12):
    return a / torch.clamp_min(length(a), eps)[..., None]


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n (i points toward the surface)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    """GLSL refract. eta may be a scalar or a per-lane [...] tensor.
    Returns (dir, k) where k<0 means total internal reflection (dir is
    zero there, as in GLSL)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=i.device)
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t = (eta[..., None] * i
         - (eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0)))[..., None] * n)
    return torch.where((k < 0.0)[..., None], 0.0, t), k


def mix(a, b, t):
    return a + (b - a) * t


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def div_host_scalar(x, d, d_inv):
    """x / d for a 0-d tensor `d` holding a host float, computed as PyTorch
    divides by the host float itself: on the CPU a true division, on a
    card a product with its float32 reciprocal `d_inv` (CUDA's
    `x / host_float`).  A value from the parameter block divides so, and
    the frame's bits stay those of the host scalar's division."""
    return x * d_inv if x.is_cuda else x / d


def luminance(c, coeff):
    return (c[..., 0] * coeff[0] + c[..., 1] * coeff[1] + c[..., 2] * coeff[2])


def v3(x, y, z, device=None):
    """Stack three scalars or same-shape tensors into [..., 3] float32."""
    parts = [torch.as_tensor(c, dtype=torch.float32, device=device)
             for c in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


_CONSTS: dict = {}


def const3(t, device):
    """The float32 tensor of host values `t` on `device`, made once per
    (values, device) and shared: a frame takes its constants without a
    host-to-device copy (a copy from pageable memory stops the host until
    the card drains, and cannot be captured in a CUDA graph).  The tensor
    is read-only by contract."""
    values = tuple(float(x) for x in np.asarray(t, np.float64).reshape(-1))
    key = (values, np.shape(t), torch.device(device))
    c = _CONSTS.get(key)
    if c is None:
        c = torch.tensor(t, dtype=torch.float32, device=device)
        _CONSTS[key] = c
    return c
