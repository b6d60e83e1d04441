"""Row-band multi-GPU renderer with its collectives written out.

Counterpart of `opengl_raytracing_tpu/parallel/shardmap.py`, whose
`shard_map` body spells out the communication of one frame over a mesh
of chips.  Here each rank of a `torch.distributed` group (NCCL on the
card, gloo on the CPU) renders one band of rows on its own device:

  * the scene (BVH, cubemap) is replicated on every rank;
  * a rank traces and shades only its band, `height // n` rows from
    `row0 = rank * (height // n)`, with the whole image's pixel centres:
    raygen and every kernel's sampling read the global px/py grids, so a
    band's samples are the whole frame's;
  * TAA reprojection may read the history anywhere on screen, so when the
    camera may have moved the previous accumulation is all-gathered and
    the band reprojects against the whole of it (`row_offset`); when the
    host knows the camera is still (`FrameInputs.moved is False`), the
    band blends with its own rows and nothing is exchanged;
  * the SVGF 7x7 stencil needs 3 rows of each neighbour: two ring shifts
    (`batch_isend_irecv`) exchange the halo rows of accum, motion, gpos
    and gnrm, edge ranks receive zeros, and K4 filters the band with its
    halo (`svgf_cuda.svgf_present`);
  * the frame statistic (mean luminance) is an all-reduce.

The frame is split into two functions of one band with the collectives
between them, `band_shade` (trace, shade, TAA) and `band_present` (SVGF
and the present pass of a band whose planes carry their halo rows), so
that the bands can also run one after another on one device
(`render_bands_in_turn`), the collectives replaced by slices of the other
bands' tensors.  Either way the bands equal the single-device
`render_frame`.

The reference's half-texel quirk (ORT_PRESENT_HALF_TEXEL=1) is not applied
to SVGF under bands, as in the JAX package, whose band path calls the
filter directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..constants import YCOEFF
from ..models.pipeline import (FrameInputs, FrameOutputs, RenderState,
                               pixel_centers, primary_dirs, trace_and_shade)
from ..ops import svgf_cuda
from ..ops.scene import BVHDevice, SceneCtx
from ..ops.svgf import present
from ..ops.taa import resolve_taa, still_skips
from ..ops.vecmath import luminance
from ..params import RenderParams, bind

HALO = 3  # SVGF stencil radius


def band_of(height: int, n: int, rank: int):
    """(first row, rows) of rank `rank`'s band of an image `height` rows
    high cut into `n` bands."""
    if n < 1 or not 0 <= rank < n or height % n:
        raise ValueError(f"height {height} must divide over {n} bands "
                         f"(rank {rank})")
    bh = height // n
    return rank * bh, bh


def needs_history(params: RenderParams, fin: FrameInputs,
                  frame_index: int) -> bool:
    """Whether this frame's TAA reads the whole previous accumulation, so
    that every rank must gather it: TAA on, a history to read, and the
    camera not known to be still (the degenerate `taa_still_thresh <= 0`
    reprojects even a still frame, as the JAX package guards).  The same
    on every rank: it reads host values only."""
    still = fin.moved is False and still_skips(params)
    return bool(params.enable_taa) and frame_index > 0 and not still


def band_shade(params: RenderParams, fin: FrameInputs, state: RenderState,
               history: Optional[torch.Tensor] = None,
               env_map: Optional[torch.Tensor] = None,
               bvh: Optional[BVHDevice] = None, *, row0: int, height: int,
               width: int, use_bvh: bool = False, show_motion: bool = False):
    """Trace, shade and TAA of one band: the `state.accum.shape[0]` rows of
    the image from row `row0`.

    `history` is the whole [height,W,4] previous accumulation when
    `needs_history` says the frame reads it, else None (the band's own
    accumulation is its history).  The band's new accumulation is written
    into `state.accum` in place, as `render_frame` does.  Returns
    (accum, motion, gpos, gnrm) of the band."""
    bh = state.accum.shape[0]
    frame_index = state.frame_index
    if history is None and bh != height \
            and needs_history(params, fin, frame_index):
        raise ValueError("this frame's TAA reprojects: pass the whole "
                         "previous accumulation as `history`")
    # the frame's per-frame values from its device block, and its data
    # parameters from their block, as render_frame reads them
    fin = fin.at_frame(frame_index)
    params = bind(params, state.accum.device)
    scene = SceneCtx.create(params, fin.cam_pos, env_map=env_map,
                            use_bvh=use_bvh, bvh=bvh)
    px, py = pixel_centers(bh, width, state.accum.device, row_offset=row0)
    rd = primary_dirs(px, py, height, width, fin, params)
    curr, motion, gpos, gnrm = trace_and_shade(
        scene, params, fin, px, py, rd, fin.frame, use_bvh=use_bvh,
        show_motion=show_motion)
    taa_motion = torch.where(fin.camera_moved > 0, motion, 0.0)
    if history is None:
        accum = resolve_taa(curr, taa_motion, state.accum, fin.frame,
                            params, out=state.accum, moved=fin.moved)
    else:
        accum = resolve_taa(curr, taa_motion, history, fin.frame, params,
                            out=state.accum, moved=fin.moved,
                            row_offset=row0)
    return accum, motion, gpos, gnrm


def presents_with_halo(params: RenderParams, show_motion: bool) -> bool:
    """Whether the present pass filters, and so needs the halo rows."""
    return bool(params.enable_svgf) and not show_motion


def band_present(accum, motion, gpos, gnrm, params: RenderParams, *,
                 halo: int, row0: int, height: int,
                 show_motion: bool = False):
    """The present pass of one band whose planes carry `halo` neighbour
    rows above and below (zeros past the image's edge): SVGF with the
    band's taps tested against the whole image (K4 on the card), then the
    blend, ACES and gamma; with SVGF off the tonemap pass of the band's
    own rows; or the motion view.  Returns the band's sRGB [BH,W,3]."""
    if presents_with_halo(params, show_motion):
        return svgf_cuda.svgf_present(accum, motion, gpos, gnrm, params,
                                      halo=halo, row_offset=row0,
                                      full_height=height)
    own = slice(halo, accum.shape[0] - halo)
    return present(accum[own], motion[own], gpos[own], gnrm[own], params,
                   show_motion=show_motion)


def with_halos(planes: Sequence[torch.Tensor], from_prev, from_next):
    """Each [BH,W,C] plane with HALO rows of the previous band above and of
    the next below: `from_prev` and `from_next` are the neighbours' rows
    of all the planes, their channels side by side ([HALO,W,sum C])."""
    out, c0 = [], 0
    for x in planes:
        c = x.shape[-1]
        out.append(torch.cat([from_prev[..., c0:c0 + c], x,
                              from_next[..., c0:c0 + c]], dim=0))
        c0 += c
    return out


def halo_rows(planes: Sequence[torch.Tensor], first: bool):
    """The first (or last) HALO rows of every plane, channels side by
    side: what a band sends its neighbour."""
    rows = slice(0, HALO) if first else slice(-HALO, None)
    return torch.cat([x[rows] for x in planes], dim=-1)


def _peer(mesh, rank: int) -> int:
    return rank if mesh.group is None else dist.get_global_rank(mesh.group,
                                                                rank)


def ring_halos(mesh, planes: Sequence[torch.Tensor]):
    """Exchange HALO rows of every plane with both neighbours (two ring
    shifts, one batch of point-to-point ops) and return the planes with
    their halos ([BH + 2*HALO, W, C] each).  Edge ranks receive zeros:
    the filter's image-bounds test weighs those rows 0 anyway."""
    if planes[0].shape[0] < HALO:
        raise ValueError(f"a band of {planes[0].shape[0]} rows is thinner "
                         f"than the SVGF halo ({HALO})")
    rank, n = mesh.rank, mesh.size
    w, c = planes[0].shape[1], sum(x.shape[-1] for x in planes)
    from_prev = torch.zeros((HALO, w, c), device=planes[0].device)
    from_next = torch.zeros_like(from_prev)
    ops = []
    if rank > 0:  # the previous band: my first rows, its last rows
        ops += [dist.P2POp(dist.isend, halo_rows(planes, True),
                           _peer(mesh, rank - 1), mesh.group),
                dist.P2POp(dist.irecv, from_prev, _peer(mesh, rank - 1),
                           mesh.group)]
    if rank < n - 1:
        ops += [dist.P2POp(dist.isend, halo_rows(planes, False),
                           _peer(mesh, rank + 1), mesh.group),
                dist.P2POp(dist.irecv, from_next, _peer(mesh, rank + 1),
                           mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return with_halos(planes, from_prev, from_next)


def gather_history(mesh, accum: torch.Tensor) -> torch.Tensor:
    """The whole [H,W,4] accumulation from every rank's band, on every
    rank (an all-gather into one tensor's row blocks)."""
    out = torch.empty((mesh.size * accum.shape[0],) + tuple(accum.shape[1:]),
                      dtype=accum.dtype, device=accum.device)
    dist.all_gather(list(out.chunk(mesh.size)), accum, group=mesh.group)
    return out


def gather_rows(mesh, x: torch.Tensor) -> Optional[torch.Tensor]:
    """A band tensor's whole image on rank 0 of the mesh (None on the
    others), for host I/O: the counterpart of reading a row-sharded JAX
    array on the host."""
    dst = _peer(mesh, 0)
    parts = [torch.empty_like(x) for _ in range(mesh.size)] \
        if mesh.rank == 0 else None
    dist.gather(x.contiguous(), parts, dst=dst, group=mesh.group)
    return torch.cat(parts, dim=0) if parts is not None else None


def _mean_lum_sum(image):
    return luminance(image, YCOEFF).sum()


def render_frame_shardmap(mesh, params: RenderParams, fin: FrameInputs,
                          state: RenderState,
                          env_map: Optional[torch.Tensor] = None,
                          bvh: Optional[BVHDevice] = None, *, height: int,
                          width: int, use_bvh: bool = False,
                          show_motion: bool = False):
    """One frame of this rank's band with the collectives written out.

    `mesh` is `sharding.make_mesh`'s: the process group, this rank and its
    device.  `state` holds the band's [BH,W,4] accumulation
    (`sharding.shard_image_rows`) on the mesh's device, as must `fin` and
    `bvh`; it is updated in place, so it must not be used after the call.
    Returns (new_state, FrameOutputs, mean_lum) with the band's tensors
    and the whole image's mean luminance, a 0-d tensor, on every rank."""
    row0, bh = band_of(height, mesh.size, mesh.rank)
    if tuple(state.accum.shape) != (bh, width, 4) \
            or state.accum.device != mesh.device:
        raise ValueError(f"rank {mesh.rank} holds an accumulation of shape "
                         f"{tuple(state.accum.shape)} on "
                         f"{state.accum.device}, not its band "
                         f"{(bh, width, 4)} on {mesh.device}")
    fin = fin.at_frame(state.frame_index)
    history = gather_history(mesh, state.accum) \
        if needs_history(params, fin, state.frame_index) else None
    planes = band_shade(params, fin, state, history, env_map, bvh, row0=row0,
                        height=height, width=width, use_bvh=use_bvh,
                        show_motion=show_motion)
    accum, motion, gpos, gnrm = planes
    halo = 0
    if presents_with_halo(params, show_motion):
        planes, halo = ring_halos(mesh, planes), HALO
    image = band_present(*planes, params, halo=halo, row0=row0,
                         height=height, show_motion=show_motion)
    lum = _mean_lum_sum(image).reshape(1)
    dist.all_reduce(lum, group=mesh.group)
    mean_lum = lum[0] / (height * width)
    return (RenderState(accum, state.frame_index + 1),
            FrameOutputs(image, motion, gpos, gnrm), mean_lum)


def make_shardmap_render_fn(mesh, height: int, width: int,
                            use_bvh: bool = False,
                            show_motion: bool = False):
    """`render_frame_shardmap` bound to the mesh, the image size, the scene
    mode and the motion view: fn(params, fin, state, env_map=None,
    bvh=None)."""
    def fn(params, fin, state, env_map=None, bvh=None):
        return render_frame_shardmap(mesh, params, fin, state, env_map, bvh,
                                     height=height, width=width,
                                     use_bvh=use_bvh,
                                     show_motion=show_motion)
    return fn


def render_bands_in_turn(params: RenderParams, fin: FrameInputs,
                         states: Sequence[RenderState],
                         env_map: Optional[torch.Tensor] = None,
                         bvh: Optional[BVHDevice] = None, *, height: int,
                         width: int, use_bvh: bool = False,
                         show_motion: bool = False):
    """One frame of every band on one device, one band after another: the
    step of `render_frame_shardmap` with each collective replaced by
    slices of the other bands' tensors (the gathered history a
    concatenation of the bands' accumulations, each halo its neighbours'
    rows, the luminance a sum).  `states` holds the bands' states, updated
    in place.  Returns (new states, FrameOutputs of each band, mean_lum)."""
    n = len(states)
    frame_index = states[0].frame_index
    fin = fin.at_frame(frame_index)
    history = torch.cat([s.accum for s in states], dim=0) \
        if needs_history(params, fin, frame_index) else None
    shaded = [band_shade(params, fin, s, history, env_map, bvh,
                         row0=band_of(height, n, k)[0], height=height,
                         width=width, use_bvh=use_bvh,
                         show_motion=show_motion)
              for k, s in enumerate(states)]
    images = []
    for k, planes in enumerate(shaded):
        halo = 0
        if presents_with_halo(params, show_motion):
            zeros = torch.zeros_like(halo_rows(planes, True))
            planes = with_halos(
                planes,
                halo_rows(shaded[k - 1], False) if k > 0 else zeros,
                halo_rows(shaded[k + 1], True) if k < n - 1 else zeros)
            halo = HALO
        images.append(band_present(*planes, params, halo=halo,
                                   row0=band_of(height, n, k)[0],
                                   height=height, show_motion=show_motion))
    lum = torch.stack([_mean_lum_sum(img) for img in images]).sum()
    return ([RenderState(a, frame_index + 1) for a, *_ in shaded],
            [FrameOutputs(img, *sh[1:]) for img, sh in zip(images, shaded)],
            lum / (height * width))
