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

`render_frame_shardmap` binds its parameters once and its collectives
write into static buffers (`exchange`): its operations are the same for
every frame, so that `make_shardmap_render_fn` captures it once per
configuration as one CUDA graph a rank, the collectives inside, and
replays it (parallel/graph.py: the counterpart of the JAX package's
`jax.jit` over `shard_map`).  Run eagerly, it is the same step on the
same buffers.

The reference's half-texel quirk (ORT_PRESENT_HALF_TEXEL=1) is not applied
to SVGF under bands, as in the JAX package, whose band path calls the
filter directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..constants import YCOEFF
from ..models import graph
from ..models.pipeline import (FrameInputs, FrameOutputs, RenderState,
                               pixel_centers, primary_dirs, trace_and_shade)
from ..ops import svgf_cuda
from ..ops.scene import BVHDevice, SceneCtx
from ..ops.svgf import present
from ..ops.taa import resolve_taa, still_skips
from ..ops.vecmath import luminance
from ..params import FrameParams, RenderParams, bind

HALO = 3  # SVGF stencil radius
CHANNELS = 4 + 2 + 3 + 3  # the halo rows of accum, motion, gpos, gnrm


def band_of(height: int, n: int, rank: int):
    """(first row, rows) of rank `rank`'s band of an image `height` rows
    high cut into `n` bands."""
    if n < 1 or not 0 <= rank < n or height % n:
        raise ValueError(f"height {height} must divide over {n} bands "
                         f"(rank {rank})")
    bh = height // n
    return rank * bh, bh


def needs_history(params, fin: FrameInputs) -> bool:
    """Whether this frame's TAA reads the whole previous accumulation, so
    that every rank must gather it: TAA on, and the camera not known to be
    still (the degenerate `taa_still_thresh <= 0` reprojects even a still
    frame), the JAX package's `moved or taa_still_thresh <= 0`.  Frame 0
    gathers too: TAA's first-frame passthrough is a select on the device,
    so the frame index never changes the step.  The same on every rank: it
    reads host values only."""
    still = fin.moved is False and still_skips(params)
    return bool(params.enable_taa) and not still


def band_shade(params: FrameParams, fin: FrameInputs, state: RenderState,
               history: Optional[torch.Tensor] = None,
               env_map: Optional[torch.Tensor] = None,
               bvh: Optional[BVHDevice] = None, *, row0: int, height: int,
               width: int, use_bvh: bool = False, show_motion: bool = False):
    """Trace, shade and TAA of one band: the `state.accum.shape[0]` rows of
    the image from row `row0`.

    `params` are the frame's bound parameters (`params.bind`: the block
    the whole step reads, a captured step's static one); `fin`'s block
    holds the frame's index.  `history` is the whole [height,W,4]
    previous accumulation when `needs_history` says the frame reads it,
    else None (the band's own accumulation is its history).  The band's
    new accumulation is written into `state.accum` in place, as
    `render_frame` does.  Returns (accum, motion, gpos, gnrm) of the
    band."""
    bh = state.accum.shape[0]
    if history is None and bh != height and needs_history(params, fin):
        raise ValueError("this frame's TAA reprojects: pass the whole "
                         "previous accumulation as `history`")
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


def band_present(accum, motion, gpos, gnrm, params: FrameParams, *,
                 halo: int, row0: int, height: int,
                 show_motion: bool = False):
    """The present pass of one band whose planes carry `halo` neighbour
    rows above and below (zeros past the image's edge): SVGF with the
    band's taps tested against the whole image (K4 on the card), then the
    blend, ACES and gamma; with SVGF off the tonemap pass of the band's
    own rows; or the motion view.  `params` are the step's bound
    parameters, as `band_shade` takes them.  Returns the band's sRGB
    [BH,W,3]."""
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


@dataclasses.dataclass(frozen=True)
class Exchange:
    """The static buffers of a band step's collectives."""
    history: torch.Tensor    # [H,W,4] the gathered accumulation
    from_prev: torch.Tensor  # [HALO,W,CHANNELS] the previous band's rows
    from_next: torch.Tensor  # [HALO,W,CHANNELS] the next band's rows


def exchange(mesh, height: int, width: int) -> Exchange:
    """The static buffers this rank's band step's collectives write into
    (made once, zeros, kept until `models.graph.clear()`): the same every
    frame, so that a captured step holds them.  Keyed on the mesh, since
    the halo buffer an edge rank never receives into must stay zero.  A
    step consumes them before it returns."""
    def make():
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=mesh.device)
        return Exchange(zeros(height, width, 4),
                        zeros(HALO, width, CHANNELS),
                        zeros(HALO, width, CHANNELS))
    return graph.static(("band exchange", mesh.device, mesh.group,
                         mesh.rank, mesh.size, height, width), make)


def ring_halos(mesh, planes: Sequence[torch.Tensor], buffers: Exchange):
    """Exchange HALO rows of every plane with both neighbours (two ring
    shifts, one batch of point-to-point ops) into the receive buffers of
    `buffers` and return the planes with their halos ([BH + 2*HALO, W, C]
    each).  Edge ranks receive zeros: the filter's image-bounds test
    weighs those rows 0 anyway."""
    if planes[0].shape[0] < HALO:
        raise ValueError(f"a band of {planes[0].shape[0]} rows is thinner "
                         f"than the SVGF halo ({HALO})")
    rank, n = mesh.rank, mesh.size
    from_prev, from_next = buffers.from_prev, buffers.from_next
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


def gather_history(mesh, accum: torch.Tensor,
                   buffers: Exchange) -> torch.Tensor:
    """The whole [H,W,4] accumulation from every rank's band, on every
    rank: one all-gather into the row blocks of `buffers.history`."""
    dist.all_gather_into_tensor(buffers.history, accum, group=mesh.group)
    return buffers.history


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


def check_band(mesh, state: RenderState, height: int, width: int):
    """Raise unless `state` holds this rank's band of an image `height` x
    `width` on the mesh's device."""
    _, bh = band_of(height, mesh.size, mesh.rank)
    if tuple(state.accum.shape) != (bh, width, 4) \
            or state.accum.device != mesh.device:
        raise ValueError(f"rank {mesh.rank} holds an accumulation of shape "
                         f"{tuple(state.accum.shape)} on "
                         f"{state.accum.device}, not its band "
                         f"{(bh, width, 4)} on {mesh.device}")


def render_frame_shardmap(mesh, params, fin: FrameInputs,
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
    `fin`'s block must hold `state.frame_index`, or it is restaged with it
    (one host-to-device copy).  `params` are bound once for the whole step
    (a FrameParams as it is, as a captured step passes its static
    block's; a RenderParams to its cached block), and the collectives
    write into `exchange`'s static buffers: every per-frame value comes
    from the device block and every data field from the parameter block,
    so the operations and their host arguments are the same for every
    frame index, camera and value of the data fields (what makes one CUDA
    graph valid for all of them, parallel/graph.py).  Returns (new_state,
    FrameOutputs, mean_lum) with the band's tensors and the whole image's
    mean luminance, a 0-d tensor, on every rank."""
    check_band(mesh, state, height, width)
    fin = fin.at_frame(state.frame_index)
    row0, _ = band_of(height, mesh.size, mesh.rank)
    params = bind(params, state.accum.device)
    buffers = exchange(mesh, height, width)
    history = None
    if needs_history(params, fin):
        history = gather_history(mesh, state.accum, buffers)
    planes = band_shade(params, fin, state, history, env_map, bvh, row0=row0,
                        height=height, width=width, use_bvh=use_bvh,
                        show_motion=show_motion)
    accum, motion, gpos, gnrm = planes
    halo = 0
    if presents_with_halo(params, show_motion):
        planes, halo = ring_halos(mesh, planes, buffers), HALO
    image = band_present(*planes, params, halo=halo, row0=row0,
                         height=height, show_motion=show_motion)
    lum = _mean_lum_sum(image).reshape(1)
    dist.all_reduce(lum, group=mesh.group)
    mean_lum = lum[0] / (height * width)
    return (RenderState(accum, state.frame_index + 1),
            FrameOutputs(image, motion, gpos, gnrm), mean_lum)


def make_shardmap_render_fn(mesh, height: int, width: int,
                            use_bvh: bool = False,
                            show_motion: bool = False, jit: bool = True):
    """`render_frame_shardmap` bound to the mesh, the image size, the scene
    mode and the motion view: fn(params, fin, state, env_map=None,
    bvh=None).

    With `jit` (the default, the JAX package's `jax.jit` over
    `shard_map`) on a CUDA mesh the step is one CUDA graph a rank, its
    collectives captured with it, captured once per configuration and
    replayed (parallel/graph.py): the returned accumulation, outputs and
    mean_lum are the graph's static tensors, overwritten by its next
    replay.  A failed capture or replay raises; nothing runs the eager
    step in its place.  On a CPU (gloo) mesh there is nothing to capture
    and `jit` runs the eager step, as `jit=False` does on the card."""
    if jit and mesh.device.type == "cuda":
        from . import graph
        step = graph.render
    else:
        step = render_frame_shardmap

    def fn(params, fin, state, env_map=None, bvh=None):
        return step(mesh, params, fin, state, env_map, bvh, height=height,
                    width=width, use_bvh=use_bvh, show_motion=show_motion)
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
    in place; `params` are bound once, as `render_frame_shardmap` binds
    them.  Returns
    (new states, FrameOutputs of each band, mean_lum)."""
    n = len(states)
    frame_index = states[0].frame_index
    fin = fin.at_frame(frame_index)
    params = bind(params, states[0].accum.device)
    history = torch.cat([s.accum for s in states], dim=0) \
        if needs_history(params, fin) else None
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
