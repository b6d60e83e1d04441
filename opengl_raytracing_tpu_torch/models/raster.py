"""Raster-preview parity renderer (flat-color visibility pass).

Counterpart of `opengl_raytracing_tpu/models/raster.py`.  The reference's
raster mode draws the same scene with flat uniform colors as a "reference
image for comparison with the ray tracing output" (reference:
src/render/render.cpp:247-295, include/render/render.h:22-27).  There is
no rasterizer here either; primary-visibility ray casting produces the
identical image (same camera, same depth resolution, same flat colors --
reference: shaders/basic.frag:18-26 outputs the color unshaded).  The mesh
is traced by the port's closest-hit entry (`bvh_cuda.trace_closest`): the
CUDA kernel for CUDA tensors, the plain walk for CPU tensors.

Scene parity (reference: render.cpp:264-294):
  clear color (0.1, 0, 0.2); ground plane y=0 green (0.1,0.4,0.1);
  bunny mesh at translate(-2,1.5,0)*scale(0.5) white (0.9); sphere at
  translate(2,1,0)*scale(0.5) color (0.3,0.6,1.0); point-light marker
  sphere scale 0.15 at the orbit position, color = pointLightColor*3.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constants import INF
from ..params import RenderParams, bind
from ..ops import bvh_cuda
from ..ops.intersect import intersect_plane, intersect_sphere
from ..ops.scene import BVHDevice
from ..ops.vecmath import const3
from .pipeline import FrameInputs, primary_rays

CLEAR_COLOR = (0.1, 0.0, 0.2)
GROUND_COLOR = (0.1, 0.4, 0.1)
MESH_COLOR = (0.9, 0.9, 0.9)
SPHERE_COLOR = (0.3, 0.6, 1.0)
SPHERE_CENTER = (2.0, 1.0, 0.0)
SPHERE_RADIUS = 0.5
MARKER_RADIUS = 0.15


def render_raster(params: RenderParams, fin: FrameInputs,
                  bvh: Optional[BVHDevice], *, height: int, width: int):
    """Flat-shaded visibility image [H,W,3] (GL bottom-up rows), on the
    device of `fin`; `params` a RenderParams or a FrameParams there, bound
    once: the marker reads its position and colour from the parameter
    block (a FrameParams' own, as a captured preview passes its static
    block's, models/graph.py; a RenderParams' cached one)."""
    p = bind(params, fin.block.device)
    # the reference raster pass renders with the unjittered view/proj
    # (render.cpp sets plain currView/currProj); zero the TAA jitter so
    # the preview doesn't shimmer frame-to-frame
    _, _, rd = primary_rays(height, width, fin, p.replace(enable_jitter=0))
    dev = rd.device
    ro = fin.cam_pos.expand(rd.shape)

    best_t = torch.full((height, width), INF, dtype=torch.float32,
                        device=dev)
    color = const3(CLEAR_COLOR, dev).expand(height, width, 3)

    def consider(t, valid, col, best_t, color):
        closer = valid & (t < best_t)
        return (torch.where(closer, t, best_t),
                torch.where(closer[..., None], col, color))

    # Ground plane (the reference's plane model is a finite quad; the
    # infinite floor is what the ray-traced scene shows)
    t, v = intersect_plane(ro, rd, const3((0.0, 1.0, 0.0), dev), 0.0)
    best_t, color = consider(t, v, const3(GROUND_COLOR, dev), best_t, color)

    # Mesh (same BVH arrays as ray mode)
    if bvh is not None:
        h = bvh_cuda.trace_closest(bvh.arrays, ro, rd)
        best_t, color = consider(h.t, h.valid, const3(MESH_COLOR, dev),
                                 best_t, color)

    # Blue sphere
    t, v = intersect_sphere(ro, rd, const3(SPHERE_CENTER, dev),
                            SPHERE_RADIUS)
    best_t, color = consider(t, v, const3(SPHERE_COLOR, dev), best_t, color)

    # Point-light marker, at the orbit position and in the colour of the
    # parameter block
    if p.point_light_enabled:
        t, v = intersect_sphere(ro, rd, p["point_light_world"], MARKER_RADIUS)
        col = p["point_light_color"] * 3.0
        best_t, color = consider(t, v, col, best_t, color)

    return torch.clamp(color, 0.0, 1.0)
