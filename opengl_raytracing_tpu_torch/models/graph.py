"""The compiled frame: `render_staged` captured as a CUDA graph once per
configuration and replayed every frame.

The port's counterpart of the JAX package's jitted frame (`--jit`,
`Application._render_fn`, the turbo chain and bench.py's one-dispatch
chain).  A frame's operations read every per-frame value from its device
block (models/frame_block.py) and every data field of its parameters
from their parameter block (models/param_block.py), so one capture serves
every frame index, camera and slider value of a configuration, as one
jitted JAX frame does.

  * The key (`graph_key`) holds the image size and device, `use_bvh`,
    `show_motion`, `want_u8`, the static fields of `RenderParams`
    (`params.static_key`: JAX's pytree metadata) and the outcomes of the
    host's branches on data fields (`params.host_branches`), the host flag
    `fin.moved`, and the identity of the BVH's and the environment's
    tensors (the entry keeps them alive, so an identity is never reused
    while its graph lives), and the static accumulation it renders into.
    Neither the frame index, the camera nor a data field's value is in it.
  * Graphs share a static frame block and a static parameter block per
    device, and a static accumulation per size and device.  A call copies
    its inputs' frame block and its parameters' block into the static
    ones (two device copies), and its state's accumulation too where the
    state does not already hold a static one (JAX's donation: a fresh or
    reset state costs a copy, never a capture).  The last state a call
    returned with a static accumulation owns it while that state lives:
    a fresh state that arrives while another one owns the accumulation
    gets one of its own (another slot, and so its own captures), so two
    live states rendered in turns never overwrite each other's history.
  * The first frame of a key runs eagerly on the static buffers: it is
    the warm-up that loads the kernels' libraries and fills the constant
    caches, so the capture that follows makes no host copy.  The kernels
    have no per-stream state to initialise, so it runs on the caller's
    stream and is the real frame: no frame is rendered twice.  Later
    frames replay.
  * A capture runs in "thread_local" mode: other threads of the process
    (the viewer's HTTP threads) may use the card meanwhile.  A failed
    capture or replay raises: nothing runs the eager frame in its place.
  * `cuda_lib.LAUNCHES` counts what the capture enqueued; the capture's
    own counts are taken back, and each replay adds them, so the counts
    stay one per launch the card runs.  `STATS` counts captures and
    replays, `pool_bytes` each graph's memory.

The returned accumulation is a static one, which the state's next frame
overwrites in place (as `render_frame` does); the outputs are the graph's
static tensors, which the next replay of the key overwrites.  Copy them to
keep them.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Optional

import torch

from ..ops import cuda_lib
from ..params import host_branches, static_key
from .pipeline import FrameInputs, RenderState, render_staged
from . import frame_block, param_block

MAX_GRAPHS = 8  # the oldest graph is dropped beyond this many
STATS = {"captures": 0, "replays": 0}

_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_BLOCKS: dict = {}  # (device, words) -> a static block
_SLOTS: dict = {}   # (device, height, width) -> [_Slot]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    outputs: tuple      # (FrameOutputs, u8 or None) of the capture
    launches: dict      # cuda_lib.LAUNCHES of one replay
    pool_bytes: int     # device memory the capture reserved
    keep: tuple         # what the key names by identity, kept alive


@dataclasses.dataclass(eq=False)
class _Slot:
    accum: torch.Tensor               # a static accumulation
    owner: Optional[weakref.ref] = None  # the last state returned with it


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """[0,1] float image -> uint8 on its device, rounding half up as the
    JAX package's `clip(x * 255 + 0.5).astype(uint8)` does."""
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def graph_key(params, fin: FrameInputs, env_map, bvh, *, device, height,
              width, use_bvh, show_motion, want_u8) -> tuple:
    """The configuration a captured frame is valid for (module docstring);
    the frame index, the camera and the data fields' values are not in
    it."""
    tensors = (() if bvh is None else
               (bvh.arrays.bounds, bvh.arrays.meta, bvh.arrays.tris))
    return (torch.device(device), height, width, bool(use_bvh),
            bool(show_motion), bool(want_u8), static_key(params),
            host_branches(params), fin.moved,
            tuple(id(t) for t in tensors),
            None if env_map is None else id(env_map))


def _block(device, words: int) -> torch.Tensor:
    got = _BLOCKS.get((device, words))
    if got is None:
        got = _BLOCKS[(device, words)] = torch.zeros(
            words, dtype=torch.int32, device=device)
    return got


def _slot(state: RenderState, height: int, width: int) -> _Slot:
    """The static accumulation `state` renders into: the one it holds; else
    one that no live state owns, or a new one, given `state`'s history by
    one device copy."""
    slots = _SLOTS.setdefault((state.accum.device, height, width), [])
    for slot in slots:
        if slot.accum.data_ptr() == state.accum.data_ptr():
            return slot
    slot = next((s for s in slots if s.owner is None or s.owner() is None),
                None)
    if slot is None:
        slot = _Slot(torch.empty_like(state.accum,
                                      memory_format=torch.contiguous_format))
        slots.append(slot)
    slot.accum.copy_(state.accum)
    return slot


def render(params, fin: FrameInputs, state: RenderState, env_map=None,
           bvh=None, *, height: int, width: int, use_bvh: bool = False,
           show_motion: bool = False, want_u8: bool = False):
    """`render_frame` on the card as a replay of its captured graph:
    (new_state, FrameOutputs, the image quantized to uint8 on the device
    when `want_u8`, else None)."""
    device = state.accum.device
    if device.type != "cuda":
        raise ValueError(f"a frame is captured on a CUDA device, not "
                         f"{device}")
    fin = fin.at_frame(state.frame_index)
    slot = _slot(state, height, width)
    key = (graph_key(params, fin, env_map, bvh, device=device, height=height,
                     width=width, use_bvh=use_bvh, show_motion=show_motion,
                     want_u8=want_u8), slot.accum.data_ptr())
    block = _block(device, frame_block.WORDS)
    block.copy_(fin.block)
    static_fin = FrameInputs(block, moved=fin.moved)
    pblock = _block(device, param_block.WORDS)
    pblock.copy_(param_block.block(params, device))
    static_state = RenderState(slot.accum, state.frame_index)
    new_state = RenderState(slot.accum, state.frame_index + 1)
    slot.owner = weakref.ref(new_state)

    def frame():
        st, out = render_staged(params, static_fin, static_state, env_map,
                                bvh, height=height, width=width,
                                use_bvh=use_bvh, show_motion=show_motion,
                                pblock=pblock)
        return out, quantize_u8(out.image) if want_u8 else None

    g = _GRAPHS.get(key)
    if g is not None:
        _GRAPHS.move_to_end(key)
        g.graph.replay()
        cuda_lib.add_launches(g.launches)
        STATS["replays"] += 1
        return (new_state, *g.outputs)
    out = frame()  # the warm-up, and this frame's result
    _GRAPHS[key] = _capture(frame, device, keep=(bvh, env_map, slot.accum))
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    return (new_state, *out)


def _capture(frame, device, keep) -> _Graph:
    g = torch.cuda.CUDAGraph()
    before = dict(cuda_lib.LAUNCHES)
    # as the capture itself begins: then the pool is what the card holds
    # more after it
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    try:
        with torch.cuda.device(device), \
                torch.cuda.graph(g, capture_error_mode="thread_local"):
            outputs = frame()
        launches = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
    finally:
        cuda_lib.LAUNCHES.update(before)  # nothing ran: replays count
    STATS["captures"] += 1
    return _Graph(g, outputs, launches,
                  torch.cuda.memory_reserved(device) - reserved, keep)


def stats() -> dict:
    """Captures and replays so far, the graphs held and their memory."""
    return dict(STATS, graphs=len(_GRAPHS),
                pool_bytes=sum(g.pool_bytes for g in _GRAPHS.values()))


def clear() -> None:
    """Drop every captured graph and the static buffers (their memory
    returns once no output or state of theirs is referenced)."""
    _GRAPHS.clear()
    _BLOCKS.clear()
    _SLOTS.clear()

