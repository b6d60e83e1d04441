"""The frame function: primary rays -> shading -> TAA -> present.

PyTorch counterpart of `opengl_raytracing_tpu/models/pipeline.py`
(reference: shaders/rt/rt.frag:50-197, rt_present.frag:231-266,
src/render/render.cpp:55-243), for the BVH scene and the analytic scene,
with GI, AO, TAA and SVGF on or off, any number of samples a pixel, the
gradient sky or a cubemap environment, and the motion debug view: every
preset, and every argument the JAX `render_frame` takes.  The JAX
package's swizzle is not ported; its occupancy gates take the form of
device masks of the lanes each call's result is read on, which the
kernels honour (`_shade_analytic`): the image is the dense form's.

Samples a pixel (`spp_per_frame`) share the primary hit, the gbuffer, the
motion and, when there is more than one, the ambient occlusion.  As in the
JAX package, the samples shade as one pass over a leading sample axis
([spp, H, W]: the shared hit broadcast as views, each sample's seed
`frame * spp + s` one `sampling.FrameValue` with a sample stride), and the
frame is their mean.  The kernels of that pass take the axis inside one
launch: the BVH direct light traces the sun and point shadow rays once a
pixel for every sample (the JAX package's `spp_dup`), the GI bounce call
and the analytic direct light sample each lane's own seed.

The layout at the public functions is the JAX package's: [H,W,C] images
with GL bottom-up rows and an [H,W,4] accumulation (rgb + M2).

Every per-frame value reaches the frame through the device block of its
FrameInputs (models/frame_block.py): the frame index as a device int32, as
the JAX package's `RenderState.frame_index` is, ld2 of it, and the camera's
uniforms.  The frame's operations are then the same for every frame, and
`make_render_fn` captures the frame once per configuration as a CUDA graph
and replays it (models/graph.py: the port's counterpart of the JAX
package's jitted frame); `render_frame` itself runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import MAT_POINTLIGHT_SPHERE
from ..params import RenderParams, bind
from ..sampling import Frame, FrameValue, ndc_from_world, sample_seeds
from ..ops.materials import (MTYPE_DIFFUSE, MTYPE_GLASS, MTYPE_MIRROR,
                             material_type)
from ..ops.scene import BVHDevice, SceneCtx
from ..ops.scene_analytic import Hit
from ..ops import hit_mix_cuda
from ..ops import lighting as lt
from ..ops.taa import resolve_taa
from ..ops.svgf import present
from ..ops.vecmath import const3, normalize
from . import frame_block


def _field(name: str) -> property:
    return property(lambda self: self._views[name],
                    doc=f"`{name}`: its view of the block")


@dataclasses.dataclass(frozen=True)
class FrameInputs:
    """Per-frame camera/motion uniforms (reference: render.cpp:73-167),
    held in one device block (models/frame_block.py) that also holds the
    frame's record: the frame index and ld2 of it.  The uniforms are read
    as views of the block (`cam_pos` [3], `cam_right` [3], `cam_up` [3],
    `cam_fwd` [3], `tan_half_fov` [], `aspect` [], `jitter` [2] pixels,
    scaled by the still/moving scale, `curr_view_proj` [4,4],
    `prev_view_proj` [4,4], `camera_moved` [] int32 0/1).  Build them with
    `FrameInputs.stage` (or convert.frame_inputs_from_numpy), which makes
    the block with one host-to-device copy; `words` keeps the block's host
    words, so that the frame can restage them under another frame index
    (`at_frame`).  `moved` is `camera_moved` as the host knows it (None:
    unknown), so the frame can skip TAA's moving path without reading the
    device; the two must agree."""
    block: torch.Tensor                       # int32 [frame_block.WORDS]
    words: Optional[np.ndarray] = dataclasses.field(default=None,
                                                    compare=False)
    moved: Optional[bool] = None              # camera_moved on the host
    _views: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_views", frame_block.views(self.block))

    cam_pos = _field("cam_pos")
    cam_right = _field("cam_right")
    cam_up = _field("cam_up")
    cam_fwd = _field("cam_fwd")
    tan_half_fov = _field("tan_half_fov")
    aspect = _field("aspect")
    jitter = _field("jitter")
    curr_view_proj = _field("curr_view_proj")
    prev_view_proj = _field("prev_view_proj")
    camera_moved = _field("camera_moved")

    @staticmethod
    def stage(words: np.ndarray, device, moved: Optional[bool]
              ) -> "FrameInputs":
        """FrameInputs of the host block `words` (frame_block.pack) on
        `device`: one host-to-device copy."""
        return FrameInputs(frame_block.stage(words, device), words, moved)

    @property
    def frame_index(self) -> Optional[int]:
        """The frame index in the block, where the host words are known."""
        return None if self.words is None else int(self.words[0])

    @property
    def frame(self) -> FrameValue:
        """The frame index on the device, as the kernels and the RNG take
        it."""
        return FrameValue(self.block[:3])

    def at_frame(self, frame_index: int) -> "FrameInputs":
        """These inputs with the record of `frame_index`: themselves when
        their block holds it, else restaged from `words` (one copy)."""
        if self.frame_index == frame_index:
            return self
        if self.words is None:
            raise ValueError("FrameInputs without host words cannot be "
                             "restaged at another frame index")
        return FrameInputs.stage(frame_block.at_frame(self.words,
                                                      frame_index),
                                 self.block.device, self.moved)


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Temporal state (replaces rt::Accum's ping-pong FBO, reference:
    include/render/accum.h:24-163).  The frame counter is a host int; the
    frame's block carries it to the device (FrameInputs.frame)."""
    accum: torch.Tensor  # [H,W,4] rgb + M2
    frame_index: int

    @staticmethod
    def create(height: int, width: int, device) -> "RenderState":
        return RenderState(torch.zeros((height, width, 4), device=device), 0)

    def reset(self) -> "RenderState":
        """Clear history (reference: src/render/accum.cpp:98-102): the
        accumulation is zeroed in place, so a captured frame that owns it
        keeps it; `self` must not be used after the call."""
        return RenderState(self.accum.zero_(), 0)


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
    up = const3((0.0, 1.0, 0.0), h.t.device)
    return Hit(torch.where(v, h.t, 1.0),
               torch.where(v[..., None], h.p, ro + rd),
               torch.where(v[..., None], h.n, up),
               h.mat)


def _shade_bvh(scene: SceneCtx, h: Hit, seed: Frame, frame_index: Frame,
               vdir, px, py, active=None, ao=None, spp: int = 1):
    """BVH-scene shading (reference: rt.frag:105-117): direct light, plus
    the GI bounce and times AO when they are on.  `active` marks the
    lanes whose radiance survives the sky select; the others trace
    nothing and their values are unspecified.  On the card GI's tail
    (the sky where its bounce missed included), the GI sum and the AO
    product run on the `active` lanes alone, in one kernel
    (ops/hit_mix_cuda.py): the JAX package's BVH hit gate.  `ao` may carry the
    occlusion term computed once for all samples: it depends on the pixel
    and the frame index, never on the sample's seed.  With `spp` > 1 the
    inputs carry a leading sample axis over which the hit, `vdir` and
    `active` are broadcast, and `seed` is the samples' seeds: the direct
    light traces the sun and point shadow rays once for all samples
    (`spp_dup`)."""
    params = scene.params
    radiance = lt.direct_light_bvh(scene, h, seed, frame_index, vdir, px, py,
                                   active=active, spp_dup=spp)
    if not (params.enable_gi or params.enable_ao):
        return radiance
    gi = None
    if params.enable_gi:
        gi = lt.gi_light_bvh(scene, h, frame_index, seed, frame_index, px,
                             py, active=active)
    if params.enable_ao and ao is None:
        ao = lt.compute_ao(scene, h, frame_index, px, py, active=active)
    # GI's tail (its sky too), the GI sum and the AO product, on `active`
    return hit_mix_cuda.bvh_hit_mix(scene, radiance, gi,
                                    ao if params.enable_ao else None,
                                    active)


def _material_lanes(mat_id, params):
    """(diffuse, mirror, glass): the lanes of each of get_material's
    resolved types (`material_type`, once a frame), the diffuse ones
    without the point-light marker (the lanes whose direct light the
    frame keeps); once a pixel where `mat_id` allows (`lt.per_pixel`)."""
    mtype = lt.per_pixel(lambda m: material_type(m, params), mat_id)
    diffuse = lt.per_pixel(lambda m, t: (m != MAT_POINTLIGHT_SPHERE)
                           & (t == MTYPE_DIFFUSE), mat_id, mtype)
    return (diffuse, lt.per_pixel(lambda t: t == MTYPE_MIRROR, mtype),
            lt.per_pixel(lambda t: t == MTYPE_GLASS, mtype))


def _shade_analytic(scene: SceneCtx, h: Hit, seed: Frame, frame_index: Frame,
                    vdir, px, py, active=None, ao=None):
    """Analytic-scene material dispatch (reference: rt.frag:119-162):
    direct light (plus the GI bounce, times AO, when they are on), the
    emissive point-light marker, and the mirror and glass secondaries,
    selected in like the fragment shader's divergent branches.  Direct
    light and GI are two calls, the JAX package's default (its 2-batch
    `direct_and_gi_analytic` is opt-in).

    `active` (bool, None: all) marks the lanes whose radiance the caller
    keeps (the sky select drops the misses).  Every call below is handed,
    as a device mask, the lanes that its select and the caller's read,
    and on the card its kernel computes those alone: the direct light and
    the GI bounce on the diffuse lanes, AO on the hit lanes, GI's tail,
    the GI sum, the AO product and the marker on the hit lanes (the
    hit-mix kernel, ops/hit_mix_cuda.py), the mirror's and glass's rays
    and mixes on the mirror and glass lanes, the direct light at a
    secondary hit on its valid hits among them, and each sky lookup where
    its select reads it (ops/lighting.py).  The masks derive from one
    resolved material type a frame (`_material_lanes`).  That is the
    frame's form of the JAX package's occupancy gates (the glass and
    mirror tile gate, the hit gate, the sky miss gate), without their
    dense fallback: the masks are elementwise tensors, so a captured
    graph replays them for any frame.  The hit-mix call and the mirror's
    and glass's mix calls write their radiance into the frame's on their
    lanes, in place, in the selects' stead.  Every other lane is dropped
    by a select before any sum, so the image is the dense form's bit for
    bit.  `ao` as in
    `_shade_bvh`; a leading sample axis broadcasts through every trace
    and call."""
    params = scene.params
    diffuse, mirror, glass = _material_lanes(h.mat, params)
    lanes = lt.and_lanes(active, diffuse)
    radiance = lt.direct_light(scene, h, seed, frame_index, vdir, px, py,
                               lanes)
    gi = None
    if params.enable_gi:
        gi = lt.gi_light_analytic(scene, h, frame_index, seed, frame_index,
                                  px, py, lanes)
    if params.enable_ao and ao is None:
        ao = lt.compute_ao(scene, h, frame_index, px, py, active=active)
    # GI's tail, the GI sum and the AO product on the diffuse lanes, the
    # emissive point-light marker (reference: rt.frag:137-148) on its own,
    # written in place
    radiance = hit_mix_cuda.an_hit_mix(scene, h, radiance, gi,
                                       ao if params.enable_ao else None,
                                       active)

    # the mirror and glass lanes' radiance, written in place
    if params.mat_mirror_enabled:
        lt.shade_mirror(scene, h, vdir, None, seed, frame_index, px, py,
                        lt.and_lanes(active, mirror), out=radiance)
    if params.mat_glass_enabled:
        lt.shade_glass(scene, h, vdir, None, seed, frame_index, px, py,
                       lt.and_lanes(active, glass), out=radiance)
    return radiance


def render_frame(params: RenderParams, fin: FrameInputs, state: RenderState,
                 env_map: Optional[torch.Tensor] = None,
                 bvh: Optional[BVHDevice] = None,
                 *, height: int, width: int, use_bvh: bool = False,
                 show_motion: bool = False):
    """One frame, run eagerly: trace + shade + TAA into the accumulation,
    then present.

    Returns (new_state, FrameOutputs).  The frame runs on the device of
    `state.accum`, which must also hold `fin` and `bvh`.  The new
    accumulation is written into `state.accum` in place (the ping-pong
    swap of reference: src/render/render.cpp:242): `resolve_taa` reads
    the whole history before it writes any of it, so `state` must not be
    used after the call, as with the JAX package's donated buffer.

    `fin`'s block must hold `state.frame_index`, or it is restaged with it
    (`FrameInputs.at_frame`: one host-to-device copy); the frame reads its
    per-frame values from the block alone (`render_staged`).

    `env_map` is the cubemap environment as `convert.env_from_numpy`
    places it on the device (used when `params.enable_env_map`);
    `show_motion` returns the motion debug wheel as the image (the frame
    is shaded at 1 SPP and accumulated all the same).  When `fin.moved`
    is False, TAA takes its still path alone.
    """
    return render_staged(params, fin.at_frame(state.frame_index), state,
                         env_map, bvh, height=height, width=width,
                         use_bvh=use_bvh, show_motion=show_motion)


def render_staged(params: RenderParams, fin: FrameInputs, state: RenderState,
                  env_map: Optional[torch.Tensor] = None,
                  bvh: Optional[BVHDevice] = None,
                  *, height: int, width: int, use_bvh: bool = False,
                  show_motion: bool = False, pblock=None):
    """`render_frame` of inputs whose block holds the frame's index: every
    per-frame value comes from the device block, none from the host, and
    every data field of `params` from its parameter block
    (models/param_block.py: `pblock` when given, a block holding
    `params`' words, as a captured frame's static one; else the cached
    block of `params`).  The sequence of operations and their host
    arguments is then the same for every frame and every value of the
    data fields (what makes one CUDA graph capture valid for all of them,
    models/graph.py)."""
    params = bind(params, state.accum.device, pblock)
    scene = SceneCtx.create(params, fin.cam_pos, env_map=env_map,
                            use_bvh=use_bvh, bvh=bvh)
    px, py, rd = primary_rays(height, width, fin, params)
    frame = fin.frame
    curr, motion, gpos, gnrm = trace_and_shade(
        scene, params, fin, px, py, rd, frame, use_bvh=use_bvh,
        show_motion=show_motion)
    # TAA sees zero motion when the camera is static (reference:
    # rt.frag:184-190); SVGF reads the motion as traced
    taa_motion = torch.where(fin.camera_moved > 0, motion, 0.0)
    accum = resolve_taa(curr, taa_motion, state.accum, frame, params,
                        out=state.accum, moved=fin.moved)
    image = present(accum, motion, gpos, gnrm, params,
                    show_motion=show_motion)
    return (RenderState(accum, state.frame_index + 1),
            FrameOutputs(image, motion, gpos, gnrm))


def sum_samples(x):
    """The sum of `x` [spp, ...] over its leading sample axis, added left
    to right, sample 0 first: ((x0 + x1) + x2) + ...  That is the JAX
    package's `jnp.sum(..., axis=0)` on its CPU path, where XLA reduces a
    leading axis with one accumulator per output element, starting from
    zero (0 + x0 == x0) and adding the samples in order.  The order is
    written out rather than left to `torch.sum`, whose order follows the
    device and the tensor's shape."""
    total = x[0]
    for k in range(1, x.shape[0]):
        total = total + x[k]
    return total


def trace_and_shade(scene: SceneCtx, params: RenderParams, fin: FrameInputs,
                    px, py, rd, frame_index: Frame, *, use_bvh: bool,
                    show_motion: bool = False):
    """Trace + shade a pixel grid: primary trace, gbuffer, motion with the
    sky sentinel, the samples' shading with the sky select, their mean
    (JAX `pipeline.py:trace_and_shade`).

    The samples shade as one pass: with spp > 1 the primary hit, px, py
    and the view direction are broadcast to [spp, H, W] as views, the
    seeds are `frame_index * spp + s` as one sampled value
    (`sampling.sample_seeds`), and `_shade_bvh` / `_shade_analytic` run
    once over the batch; AO is computed once ahead of it, as it depends
    on the pixel and the frame only.  Each sample takes the sky select,
    then `sum_samples` adds them in sample order and the mean divides by a
    tensor.  The motion view shades one sample.

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

    # the environment where the sky select below reads it: the misses
    sky_radiance = scene.sky(rd, ~hit_mask)
    vdir = -rd
    spp = 1 if show_motion else max(int(params.spp_per_frame), 1)
    # the primary hit is the same for every sample (reference: rt.frag:79
    # loops the shading only), and so is AO: with more than one sample it
    # is computed once, ahead of them
    ao = None
    if params.enable_ao and spp > 1:
        ao = lt.compute_ao(scene, h, frame_index, px, py, active=hit_mask)
    seeds = sample_seeds(frame_index, spp)
    if spp > 1:
        def batch(x):
            return x.expand((spp,) + x.shape)
        h_b = Hit(*(batch(x) for x in h))
        px_b, py_b, vdir_b, mask_b = (batch(px), batch(py), batch(vdir),
                                      batch(hit_mask))
    else:
        h_b, px_b, py_b, vdir_b, mask_b = h, px, py, vdir, hit_mask
    if use_bvh:
        shaded = _shade_bvh(scene, h_b, seeds, frame_index, vdir_b, px_b,
                            py_b, active=mask_b, ao=ao, spp=spp)
    else:
        shaded = _shade_analytic(scene, h_b, seeds, frame_index, vdir_b,
                                 px_b, py_b, active=mask_b, ao=ao)
    sample = torch.where(hit_mask[..., None], shaded, sky_radiance)
    if spp == 1:
        return sample, motion, gpos, gnrm
    # a tensor divisor: on the card a division by a host scalar would
    # multiply by the reciprocal
    return (sum_samples(sample) / torch.full((), float(spp),
                                             device=rd.device),
            motion, gpos, gnrm)


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
                   show_motion: bool = False, jit: bool = True):
    """Frame function bound to an image size, a device, the scene mode and
    the motion debug view: fn(params, fin, state, env_map=None, bvh=None)
    -> (new_state, FrameOutputs), the contract of `render_frame`.

    With `jit` (the default, the JAX package's jitted frame) on a CUDA
    device the frame is a CUDA graph, captured once per configuration and
    replayed (models/graph.py): the returned accumulation and outputs are
    the graph's own tensors, overwritten by its next replay.  A failed
    capture or replay raises; nothing runs the eager frame in its place.
    On the CPU there is nothing to capture and `jit` runs the eager frame,
    as `jit=False` does on the card.

    Raises at once when the device is CUDA and no card is present: the
    frame never runs on the CPU in its place."""
    device = render_device(device)
    captured = jit and device.type == "cuda"

    def fn(params, fin, state, env_map=None, bvh=None):
        if state.accum.device != device:
            raise ValueError(f"state is on {state.accum.device}, the "
                             f"render function on {device}")
        if captured:
            from . import graph
            st, out, _ = graph.render(params, fin, state, env_map, bvh,
                                      height=height, width=width,
                                      use_bvh=use_bvh,
                                      show_motion=show_motion)
            return st, out
        return render_frame(params, fin, state, env_map, bvh,
                            height=height, width=width, use_bvh=use_bvh,
                            show_motion=show_motion)
    return fn
