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

`run` (replay or warm up and capture a key), `static_inputs` (the static
blocks filled for a call), `static` (a static object kept until `clear`)
and `_slot` serve two more graphs: the raster preview (`render_raster`,
the JAX package's jitted `Application._raster_fn`, keyed on `raster_key`:
the size and device, the BVH's tensors, the static fields and the host's
branches) and the band step of the row-band renderer
(parallel/graph.py).  Frame and raster graphs share one table, whose
oldest graph is dropped beyond `MAX_GRAPHS`; band steps are kept in
another, which only `clear` empties, and take their accumulations from
slots of their own, so that what a rank renders alone never changes
whether its band step replays or captures.

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
from ..params import bind, host_branches, static_key
from .pipeline import FrameInputs, RenderState, render_staged
from . import frame_block, param_block, raster

MAX_GRAPHS = 8  # the oldest frame or raster graph is dropped beyond this
STATS = {"captures": 0, "replays": 0}

_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_KEPT: dict = {}    # key -> a graph only `clear` drops (the band steps)
_STATIC: dict = {}  # key -> a static object (the blocks, parallel/graph.py's)
_SLOTS: dict = {}   # (pool, device, height, width) -> [_Slot]


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
    index: int                        # its place in its pool
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


def static(key, make):
    """The static object of `key` (a tensor, buffers), made by `make()` at
    its first call and kept until `clear()`."""
    got = _STATIC.get(key)
    if got is None:
        got = _STATIC[key] = make()
    return got


def _block(device, words: int) -> torch.Tensor:
    return static(("block", device, words), lambda: torch.zeros(
        words, dtype=torch.int32, device=device))


def _slot(state: RenderState, height: int, width: int,
          pool: str = "frame") -> _Slot:
    """The static accumulation `state` renders into, from `pool`'s: the one
    it holds; else one that no live state owns, or a new one, given
    `state`'s history by one device copy."""
    slots = _SLOTS.setdefault((pool, state.accum.device, height, width), [])
    for slot in slots:
        if slot.accum.data_ptr() == state.accum.data_ptr():
            return slot
    slot = next((s for s in slots if s.owner is None or s.owner() is None),
                None)
    if slot is None:
        slot = _Slot(torch.empty_like(state.accum,
                                      memory_format=torch.contiguous_format),
                     len(slots))
        slots.append(slot)
    slot.accum.copy_(state.accum)
    return slot


def static_inputs(params, fin: FrameInputs, device):
    """The device's static frame block and static parameter block, holding
    `fin`'s and `params`' words (two device copies): (FrameInputs of the
    static block, with `fin`'s host words, the static parameter block).
    Every graph of the device reads its inputs from these."""
    block = _block(device, frame_block.WORDS)
    block.copy_(fin.block)
    pblock = _block(device, param_block.WORDS)
    pblock.copy_(param_block.block(params, device))
    return FrameInputs(block, fin.words, fin.moved), pblock


def run(key, frame, device, keep, before_capture=None, evict=True):
    """The outputs of `frame()` for the configuration `key`: a replay of
    its graph, or, at the key's first call, `frame()` run eagerly (the
    warm-up, and this call's result) and then captured.  `keep` is what
    the key names by identity; `before_capture()`, when given, runs before
    the warm-up of a key that has no graph.  With `evict` the graph joins
    the frame and raster graphs, the oldest of which is dropped beyond
    MAX_GRAPHS; else it is kept until `clear()`."""
    graphs = _GRAPHS if evict else _KEPT
    g = graphs.get(key)
    if g is not None:
        if evict:
            _GRAPHS.move_to_end(key)
        g.graph.replay()
        cuda_lib.add_launches(g.launches)
        STATS["replays"] += 1
        return g.outputs
    if before_capture is not None:
        before_capture()
    out = frame()  # the warm-up, and this frame's result
    graphs[key] = _capture(frame, device, keep)
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    return out


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
    static_fin, pblock = static_inputs(params, fin, device)
    static_state = RenderState(slot.accum, state.frame_index)
    new_state = RenderState(slot.accum, state.frame_index + 1)
    slot.owner = weakref.ref(new_state)

    def frame():
        st, out = render_staged(params, static_fin, static_state, env_map,
                                bvh, height=height, width=width,
                                use_bvh=use_bvh, show_motion=show_motion,
                                pblock=pblock)
        return out, quantize_u8(out.image) if want_u8 else None

    out = run(key, frame, device, keep=(bvh, env_map, slot.accum))
    return (new_state, *out)


def raster_key(params, bvh, *, device, height, width) -> tuple:
    """The configuration a captured raster preview is valid for: the image
    size and device, the identity of the BVH's tensors, the static fields
    and the host's branches; not the camera, the frame or a data field's
    value."""
    tensors = (() if bvh is None else
               (bvh.arrays.bounds, bvh.arrays.meta, bvh.arrays.tris))
    return ("raster", torch.device(device), height, width,
            tuple(id(t) for t in tensors), static_key(params),
            host_branches(params))


def render_raster(params, fin: FrameInputs, bvh=None, *, height: int,
                  width: int):
    """`raster.render_raster` on the card as a replay of its captured
    graph: the flat-shaded image [H,W,3], the graph's static tensor."""
    device = fin.block.device
    if device.type != "cuda":
        raise ValueError(f"a raster preview is captured on a CUDA device, "
                         f"not {device}")
    static_fin, pblock = static_inputs(params, fin, device)
    key = raster_key(params, bvh, device=device, height=height, width=width)

    def frame():  # the parameters bound to the static block
        return raster.render_raster(bind(params, device, pblock), static_fin,
                                    bvh, height=height, width=width)
    return run(key, frame, device, keep=(bvh,))


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
    graphs = (*_GRAPHS.values(), *_KEPT.values())
    return dict(STATS, graphs=len(graphs),
                pool_bytes=sum(g.pool_bytes for g in graphs))


def clear() -> None:
    """Drop every captured graph and the static buffers (their memory
    returns once no output or state of theirs is referenced)."""
    _GRAPHS.clear()
    _KEPT.clear()
    _STATIC.clear()
    _SLOTS.clear()

