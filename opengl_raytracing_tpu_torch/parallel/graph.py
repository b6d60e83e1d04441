"""The compiled band step: `shardmap.render_frame_shardmap` captured as one
CUDA graph a rank, its NCCL collectives inside, once per configuration,
and replayed every frame.

The port's counterpart of the JAX package's `jax.jit` over `shard_map`
(`make_shardmap_render_fn`) and over the GSPMD frame
(`make_sharded_render_fn`): one compiled program a frame holding the
trace, the shading, the history all-gather, the halo ring, the band's
SVGF and the luminance all-reduce.  It is models/graph.py's frame graph
for a band, and shares its machinery: the static frame block and
parameter block (`graph.static_inputs`), the static accumulation
(`graph._slot`, JAX's donation), the capture and replay with their
launch accounting and `capture_error_mode="thread_local"` (`graph.run`),
`graph.STATS` and `graph.clear()`.

Every rank must capture the same step at the same frame, and replay the
same steps in the same order, or the ranks' collectives fall out of
step.  So whether a rank replays or captures depends only on what every
rank of a program that drives its ranks alike (the same configurations,
scenes and live states, in the same order) holds alike:

  * The key (`band_key`) holds `graph_key`'s fields in a form that is the
    same on every rank: the scene (the BVH's and the environment's
    tensors) as its number in the order this process first rendered it
    (`_scene`), and the static accumulation as its number among the band
    steps' own slots, where `graph_key` holds identities and a pointer.
    Beside those: the mesh (its group, this rank, its device), the band
    (first row, rows), whether the present pass filters with the halo
    rows (`presents_with_halo`) and whether the step gathers the history
    (`needs_history`).  Neither the frame index, the camera nor a data
    field's value is in it.
  * The band steps' graphs are kept apart from the frame and raster
    graphs, and dropped only by `graph.clear()`: no other graph a rank
    renders alone evicts one.
  * Before the warm-up of a key, one small eager all-gather of a hash of
    what every rank's key holds alike (all but the group, the rank, the
    device and the band) checks that the ranks capture the same step,
    and raises on every rank where they do not.  It sees only ranks that
    capture at the same frame: a rank that captures while its peers
    replay (a program that drives its ranks differently) meets their
    collectives with its own, and waits until the group's timeout.

The collectives write into static buffers (`shardmap.exchange`).  The
warm-up of a key (its first frame, run eagerly on the static buffers and
the caller's stream) runs every collective the captured step runs: NCCL
sets up its communicator and connects its peers there, never inside the
capture.  A failed capture or replay raises: nothing runs the eager step
in its place.

The returned accumulation is the static one, which the state's next frame
overwrites in place; the outputs and the 0-d `mean_lum` are the graph's
static tensors, which the next replay of the key overwrites.  Copy them to
keep them.
"""

from __future__ import annotations

import hashlib
import weakref

import torch
import torch.distributed as dist

from ..models import graph
from ..models.pipeline import FrameInputs, RenderState
from ..params import bind, host_branches, static_key
from .shardmap import (band_of, check_band, needs_history,
                       presents_with_halo, render_frame_shardmap)


def _scene(device, env_map, bvh) -> int:
    """The number of the scene (the BVH's and the environment's tensors)
    among those the band steps on `device` have rendered, in the order
    first seen; the tensors are kept until `graph.clear()`, so a number
    never names two scenes."""
    tensors = (() if bvh is None else
               (bvh.arrays.bounds, bvh.arrays.meta, bvh.arrays.tris)) \
        + (env_map,)
    scenes = graph.static(("band scenes", device), list)
    for n, seen in enumerate(scenes):
        if len(seen) == len(tensors) \
                and all(a is b for a, b in zip(seen, tensors)):
            return n
    scenes.append(tensors)
    return len(scenes) - 1


def band_key(mesh, params, fin: FrameInputs, scene: int, slot: int, *,
             height: int, width: int, use_bvh: bool,
             show_motion: bool) -> tuple:
    """The configuration a captured band step is valid for (module
    docstring): what every rank holds alike (`key[:-2]`), then the mesh
    from this rank's view and its band.  The frame index, the camera and
    the data fields' values are not in it."""
    row0, bh = band_of(height, mesh.size, mesh.rank)
    return (("frame", height, width, bool(use_bvh), bool(show_motion),
             static_key(params), host_branches(params), fin.moved),
            ("scene", scene), ("slot", slot), ("ranks", mesh.size),
            ("halo", presents_with_halo(params, show_motion)),
            ("gather", needs_history(params, fin)),
            ("mesh", mesh.group, mesh.rank, mesh.device),
            ("band", row0, bh))


def agree(mesh, shared: tuple) -> None:
    """Raise unless every rank of the mesh is about to capture a step
    with the same `shared` fields: one eager all-gather of an 8-byte hash
    of them."""
    digest = hashlib.sha256(repr(shared).encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(digest, "little", signed=True)],
                        dtype=torch.int64, device=mesh.device)
    every = torch.empty(mesh.size, dtype=torch.int64, device=mesh.device)
    dist.all_gather_into_tensor(every, mine, group=mesh.group)
    hashes = every.tolist()
    if len(set(hashes)) != 1:
        raise RuntimeError(f"rank {mesh.rank}: the ranks are about to "
                           f"capture different band steps (key hashes "
                           f"{hashes}, this rank's {shared}): their "
                           f"collectives would fall out of step")


def render(mesh, params, fin: FrameInputs, state: RenderState, env_map=None,
           bvh=None, *, height: int, width: int, use_bvh: bool = False,
           show_motion: bool = False):
    """`render_frame_shardmap` on the card as a replay of this rank's
    captured band step: (new_state, FrameOutputs, mean_lum) of the band,
    the graph's static tensors."""
    device = state.accum.device
    if device.type != "cuda":
        raise ValueError(f"a band step is captured on a CUDA device, not "
                         f"{device}")
    check_band(mesh, state, height, width)
    fin = fin.at_frame(state.frame_index)
    _, bh = band_of(height, mesh.size, mesh.rank)
    slot = graph._slot(state, bh, width, pool="band")
    kw = dict(height=height, width=width, use_bvh=use_bvh,
              show_motion=show_motion)
    key = band_key(mesh, params, fin, _scene(device, env_map, bvh),
                   slot.index, **kw)
    static_fin, pblock = graph.static_inputs(params, fin, device)
    static_state = RenderState(slot.accum, state.frame_index)
    new_state = RenderState(slot.accum, state.frame_index + 1)
    slot.owner = weakref.ref(new_state)

    def frame():  # the parameters bound to the static block
        _, out, mean_lum = render_frame_shardmap(
            mesh, bind(params, device, pblock), static_fin, static_state,
            env_map, bvh, **kw)
        return out, mean_lum

    out, mean_lum = graph.run(key, frame, device,
                              keep=(bvh, env_map, slot.accum, mesh.group),
                              before_capture=lambda: agree(mesh, key[:-2]),
                              evict=False)
    return new_state, out, mean_lum
