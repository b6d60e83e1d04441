"""The frame function: primary rays -> shading -> TAA -> present.

PyTorch counterpart of `opengl_raytracing_tpu/models/pipeline.py`
(reference: shaders/rt/rt.frag:50-197, rt_present.frag:231-266,
src/render/render.cpp:55-243), for the BVH scene and the analytic scene,
with GI, AO, TAA and SVGF on or off, any number of samples a pixel, the
gradient sky or a cubemap environment, and the motion debug view: every
preset, and every argument the JAX `render_frame` takes.  The JAX
package's tile gates and swizzle are not ported: they leave the image
unchanged.

Samples a pixel (`spp_per_frame`) share the primary hit, the gbuffer, the
motion and, when there is more than one, the ambient occlusion; the
shading runs once a sample on the host, each with its own seed, and the
frame is their mean.

The layout at the public functions is the JAX package's: [H,W,C] images
with GL bottom-up rows and an [H,W,4] accumulation (rgb + M2).  Frames run
eagerly; a sequence of frames is a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..constants import MAT_POINTLIGHT_SPHERE
from ..params import RenderParams, f32
from ..sampling import ndc_from_world
from ..ops.materials import MTYPE_GLASS, MTYPE_MIRROR, get_material
from ..ops.scene import BVHDevice, SceneCtx
from ..ops.scene_analytic import Hit
from ..ops import lighting as lt
from ..ops.taa import resolve_taa
from ..ops.svgf import present
from ..ops.vecmath import const3, length, normalize


@dataclasses.dataclass(frozen=True)
class FrameInputs:
    """Per-frame camera/motion uniforms (reference: render.cpp:73-167),
    as float32 tensors on the render device.  `moved` is `camera_moved`
    as the host knows it (None: unknown), so the frame can skip TAA's
    moving path without reading the device; the two must agree."""
    cam_pos: torch.Tensor         # [3]
    cam_right: torch.Tensor       # [3]
    cam_up: torch.Tensor          # [3]
    cam_fwd: torch.Tensor         # [3]
    tan_half_fov: torch.Tensor    # []
    aspect: torch.Tensor          # []
    jitter: torch.Tensor          # [2] pixels, scaled by still/moving scale
    curr_view_proj: torch.Tensor  # [4,4]
    prev_view_proj: torch.Tensor  # [4,4]
    camera_moved: torch.Tensor    # [] int32 (0/1)
    moved: Optional[bool] = None  # camera_moved on the host


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Temporal state (replaces rt::Accum's ping-pong FBO, reference:
    include/render/accum.h:24-163).  The frame counter is a host int: it
    seeds the RNG, and keeping it on the host costs no device round trip."""
    accum: torch.Tensor  # [H,W,4] rgb + M2
    frame_index: int

    @staticmethod
    def create(height: int, width: int, device) -> "RenderState":
        return RenderState(torch.zeros((height, width, 4), device=device), 0)

    def reset(self) -> "RenderState":
        """Clear history (reference: src/render/accum.cpp:98-102)."""
        return RenderState(torch.zeros_like(self.accum), 0)


class FrameOutputs(NamedTuple):
    image: torch.Tensor   # [H,W,3] sRGB in [0,1]
    motion: torch.Tensor  # [H,W,2] NDC motion
    gpos: torch.Tensor    # [H,W,3]
    gnrm: torch.Tensor    # [H,W,3]


def primary_dirs(px, py, height: int, width: int, fin: FrameInputs,
                 params: RenderParams):
    """Jittered primary ray directions for given pixel centers
    (reference: rt.frag:55-68)."""
    if params.enable_jitter:
        jx, jy = fin.jitter[0], fin.jitter[1]
    else:
        jx = jy = 0.0
    u = (px + jx) / width
    v = (py + jy) / height
    ndc_x = u * 2.0 - 1.0
    ndc_y = v * 2.0 - 1.0
    d = (fin.cam_fwd
         + ndc_x[..., None] * fin.cam_right * (fin.tan_half_fov * fin.aspect)
         + ndc_y[..., None] * fin.cam_up * fin.tan_half_fov)
    return normalize(d)


def pixel_centers(height: int, width: int, device, row_offset: int = 0):
    """Pixel-center coordinate grids (GL bottom-up rows)."""
    px = (torch.arange(width, dtype=torch.float32, device=device)[None, :]
          + 0.5).expand(height, width)
    py = (torch.arange(height, dtype=torch.float32, device=device)[:, None]
          + 0.5 + float(row_offset)).expand(height, width)
    return px, py


def primary_rays(height: int, width: int, fin: FrameInputs,
                 params: RenderParams):
    """Full-grid pixel centers + jittered ray directions."""
    px, py = pixel_centers(height, width, fin.cam_pos.device)
    return px, py, primary_dirs(px, py, height, width, fin, params)


def _sanitize_hit(h: Hit, ro, rd) -> Hit:
    """Clamp miss lanes to finite values so masked shading math stays
    NaN-free (misses are overwritten by the sky select at the end)."""
    v = h.valid
    up = torch.tensor([0.0, 1.0, 0.0], device=h.t.device)
    return Hit(torch.where(v, h.t, 1.0),
               torch.where(v[..., None], h.p, ro + rd),
               torch.where(v[..., None], h.n, up),
               h.mat)


def _shade_bvh(scene: SceneCtx, h: Hit, seed: int, frame_index: int, vdir,
               px, py, active=None, ao=None):
    """BVH-scene shading (reference: rt.frag:105-117): direct light, plus
    the GI bounce and times AO when they are on.  `active` marks the
    lanes whose radiance survives the sky select; the others trace
    nothing and their values are unspecified.  `ao` may carry the
    occlusion term computed once for all samples: it depends on the pixel
    and the frame index, never on the sample's seed."""
    params = scene.params
    radiance = lt.direct_light_bvh(scene, h, seed, frame_index, vdir, px, py,
                                   active=active)
    if params.enable_gi:
        radiance = radiance + f32(params.gi_scale_bvh) * \
            lt.one_bounce_gi_bvh(scene, h, frame_index, seed, frame_index,
                                 px, py, active=active)
    if params.enable_ao:
        if ao is None:
            ao = lt.compute_ao(scene, h, frame_index, px, py, active=active)
        radiance = radiance * ao[..., None]
    return radiance


def _shade_analytic(scene: SceneCtx, h: Hit, seed: int, frame_index: int,
                    vdir, px, py, ao=None):
    """Analytic-scene material dispatch (reference: rt.frag:119-162):
    direct light (plus the GI bounce, times AO, when they are on), the
    emissive point-light marker, and the mirror and glass secondaries,
    computed for every lane and selected in like the fragment shader's
    divergent branches.  Direct light and GI are two calls, the JAX
    package's default (its 2-batch `direct_and_gi_analytic` is opt-in).
    `ao` as in `_shade_bvh`."""
    params = scene.params
    mat = get_material(h.mat, params)
    radiance = lt.direct_light(scene, h, seed, frame_index, vdir, px, py)
    if params.enable_gi:
        radiance = radiance + f32(params.gi_scale_analytic) * \
            lt.one_bounce_gi_analytic(scene, h, frame_index, seed,
                                      frame_index, px, py)
    if params.enable_ao:
        if ao is None:
            ao = lt.compute_ao(scene, h, frame_index, px, py)
        radiance = radiance * ao[..., None]

    # emissive point-light marker (reference: rt.frag:137-148)
    base_col = (const3(params.point_light_color, h.t.device)
                * params.point_light_intensity)
    d = length(h.p - scene.cam_pos)
    falloff = 1.0 / torch.clamp_min(d * d * 0.25 + 1.0, 1.0)
    emissive = base_col * falloff[..., None]
    is_marker = h.mat == MAT_POINTLIGHT_SPHERE
    radiance = torch.where(is_marker[..., None], emissive, radiance)

    if params.mat_mirror_enabled:
        mirror_r = lt.shade_mirror(scene, h, vdir, mat, seed, frame_index,
                                   px, py)
        radiance = torch.where((mat.mtype == MTYPE_MIRROR)[..., None],
                               mirror_r, radiance)
    if params.mat_glass_enabled:
        glass_r = lt.shade_glass(scene, h, vdir, mat, seed, frame_index,
                                 px, py)
        radiance = torch.where((mat.mtype == MTYPE_GLASS)[..., None],
                               glass_r, radiance)
    return radiance


def render_frame(params: RenderParams, fin: FrameInputs, state: RenderState,
                 env_map: Optional[torch.Tensor] = None,
                 bvh: Optional[BVHDevice] = None,
                 *, height: int, width: int, use_bvh: bool = False,
                 show_motion: bool = False):
    """One frame: trace + shade + TAA into the accumulation, then present.

    Returns (new_state, FrameOutputs).  The frame runs on the device of
    `state.accum`, which must also hold `fin` and `bvh`.  The new
    accumulation is written into `state.accum` in place (the ping-pong
    swap of reference: src/render/render.cpp:242): `resolve_taa` reads
    the whole history before it writes any of it, so `state` must not be
    used after the call, as with the JAX package's donated buffer.

    `env_map` is the cubemap environment as `convert.env_from_numpy`
    places it on the device (used when `params.enable_env_map`);
    `show_motion` returns the motion debug wheel as the image (the frame
    is shaded at 1 SPP and accumulated all the same).  When `fin.moved`
    is False, TAA takes its still path alone.
    """
    scene = SceneCtx.create(params, fin.cam_pos, env_map=env_map,
                            use_bvh=use_bvh, bvh=bvh)
    px, py, rd = primary_rays(height, width, fin, params)
    frame_index = state.frame_index
    curr, motion, gpos, gnrm = trace_and_shade(
        scene, params, fin, px, py, rd, frame_index, use_bvh=use_bvh,
        show_motion=show_motion)
    # TAA sees zero motion when the camera is static (reference:
    # rt.frag:184-190); SVGF reads the motion as traced
    taa_motion = torch.where(fin.camera_moved > 0, motion, 0.0)
    accum = resolve_taa(curr, taa_motion, state.accum, frame_index, params,
                        out=state.accum, moved=fin.moved)
    image = present(accum, motion, gpos, gnrm, params,
                    show_motion=show_motion)
    return (RenderState(accum, frame_index + 1),
            FrameOutputs(image, motion, gpos, gnrm))


def trace_and_shade(scene: SceneCtx, params: RenderParams, fin: FrameInputs,
                    px, py, rd, frame_index: int, *, use_bvh: bool,
                    show_motion: bool = False):
    """Trace + shade a pixel grid: primary trace, gbuffer, motion with the
    sky sentinel, the samples' shading with the sky select, their mean.

    Returns (curr [H,W,3], motion [H,W,2], gpos, gnrm)."""
    ro = fin.cam_pos.expand(rd.shape)
    h_raw = scene.trace(ro, rd)
    hit_mask = h_raw.valid
    h = _sanitize_hit(h_raw, ro, rd)

    # Motion + GBuffer (reference: rt.frag:94-101,168-175).
    motion = (ndc_from_world(h.p, fin.curr_view_proj)
              - ndc_from_world(h.p, fin.prev_view_proj))
    moved = fin.camera_moved > 0
    sky_sentinel = torch.where(moved, 4.0, 0.0)
    motion = torch.where(hit_mask[..., None], motion, sky_sentinel)
    gpos = torch.where(hit_mask[..., None], h.p, 0.0)
    gnrm = torch.where(hit_mask[..., None], normalize(h.n), 0.0)

    sky_radiance = scene.sky(rd)
    vdir = -rd
    spp = 1 if show_motion else max(int(params.spp_per_frame), 1)
    # the primary hit is the same for every sample (reference: rt.frag:79
    # loops the shading only), and so is AO: with more than one sample it
    # is computed once, ahead of them
    ao = None
    if params.enable_ao and spp > 1:
        ao = lt.compute_ao(scene, h, frame_index, px, py,
                           active=hit_mask if use_bvh else None)
    frame_sum = None
    for s in range(spp):
        seed = frame_index * spp + s
        if use_bvh:
            shaded = _shade_bvh(scene, h, seed, frame_index, vdir, px, py,
                                active=hit_mask, ao=ao)
        else:
            shaded = _shade_analytic(scene, h, seed, frame_index, vdir, px,
                                     py, ao=ao)
        sample = torch.where(hit_mask[..., None], shaded, sky_radiance)
        frame_sum = sample if frame_sum is None else frame_sum + sample
    if spp == 1:
        return frame_sum, motion, gpos, gnrm
    # a tensor divisor: on the card a division by a host scalar would
    # multiply by the reciprocal
    return (frame_sum / torch.full((), float(spp), device=rd.device), motion,
            gpos, gnrm)


def render_device(device) -> torch.device:
    """`device` as a torch.device, a CUDA one with its index.  Raises when
    it is CUDA and no card is present: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_render_fn(height: int, width: int, device, use_bvh: bool = False,
                   show_motion: bool = False):
    """Frame function bound to an image size, a device, the scene mode and
    the motion debug view: fn(params, fin, state, env_map=None, bvh=None).

    Raises at once when the device is CUDA and no card is present: the
    frame never runs on the CPU in its place."""
    device = render_device(device)

    def fn(params, fin, state, env_map=None, bvh=None):
        if state.accum.device != device:
            raise ValueError(f"state is on {state.accum.device}, the "
                             f"render function on {device}")
        return render_frame(params, fin, state, env_map, bvh,
                            height=height, width=width, use_bvh=use_bvh,
                            show_motion=show_motion)
    return fn
