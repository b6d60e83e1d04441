"""The per-frame device block: every per-frame value of a frame in one
small tensor, filled by one copy from the host.

A frame reads its per-frame values -- the frame index, ld2 of it, the
camera's uniforms (`FrameInputs`' floats) and `camera_moved` -- from one
int32 [WORDS] block on its device (the float words viewed as float32).
The JAX package passes them as traced arguments of its jitted frame; here
they are the frame's one host-to-device copy, so that

  * a captured CUDA graph of the frame (models/graph.py) replays for any
    frame: its operations read the block, and no value of it is baked into
    a kernel argument;
  * the eager frame makes no other copy and never waits for the card.

The first three words are the frame's record (`sampling.frame_record`):
the kernels read the frame index and ld2 through a pointer to it.

A block is filled from a pinned host staging slot by one `non_blocking`
copy.  The slots form a ring per device, each guarded by an event
recorded after its copy: a slot is rewritten only once the copy that read
it has run (a turbo step stages k frames before the first runs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sampling import record_words

# name -> (first word, shape); every field is float32 but the int32 words
# `frame` and `camera_moved`
FIELDS = {
    "frame": (0, ()),
    "ld": (1, (2,)),
    "cam_pos": (3, (3,)),
    "cam_right": (6, (3,)),
    "cam_up": (9, (3,)),
    "cam_fwd": (12, (3,)),
    "tan_half_fov": (15, ()),
    "aspect": (16, ()),
    "jitter": (17, (2,)),
    "curr_view_proj": (19, (4, 4)),
    "prev_view_proj": (35, (4, 4)),
    "camera_moved": (51, ()),
}
INT_FIELDS = ("frame", "camera_moved")
# the FrameInputs fields the block holds
INPUT_FIELDS = tuple(k for k in FIELDS if k not in ("frame", "ld"))
WORDS = 64  # 52 used; a 256-byte block
SLOTS = 128  # staging slots of a device's ring


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def pack(src, frame_index: int) -> np.ndarray:
    """The host words of a block: the record of `frame_index`, then the
    float32 values of `src`'s fields (any object with FrameInputs' field
    names: numpy or JAX arrays, floats) and its `camera_moved` as int32."""
    words = np.zeros(WORDS, np.int32)
    words[:3] = record_words(frame_index)
    floats = words.view(np.float32)
    for name in INPUT_FIELDS:
        at, shape = FIELDS[name]
        value = np.asarray(getattr(src, name))
        if name in INT_FIELDS:
            words[at] = int(value)
        else:
            floats[at:at + _size(shape)] = np.asarray(
                value, np.float32).reshape(-1)
    return words


def at_frame(words: np.ndarray, frame_index: int) -> np.ndarray:
    """`words` with the record of another frame index."""
    words = words.copy()
    words[:3] = record_words(frame_index)
    return words


def views(block: torch.Tensor) -> dict:
    """{field: tensor view of `block`}: float32 views of the float words,
    int32 of `frame` and `camera_moved`."""
    floats = block.view(torch.float32)
    out = {}
    for name, (at, shape) in FIELDS.items():
        src = block if name in INT_FIELDS else floats
        out[name] = src[at:at + _size(shape)].view(shape)
    return out


class _Ring:
    """A device's pinned staging slots of one block size and the events of
    their copies."""

    def __init__(self, words: int):
        self.slots = torch.empty((SLOTS, words), dtype=torch.int32,
                                 pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(SLOTS)]
        self.next = 0

    def put(self, words: np.ndarray, block: torch.Tensor) -> None:
        i = self.next
        self.next = (i + 1) % SLOTS
        # never recorded: returns at once; else waits for the copy that
        # read this slot SLOTS stagings ago (long run, as a rule)
        self.events[i].synchronize()
        self.slots[i].numpy()[:] = words
        block.copy_(self.slots[i], non_blocking=True)
        self.events[i].record(torch.cuda.current_stream(block.device))


_RINGS: dict = {}


def stage(words: np.ndarray, device) -> torch.Tensor:
    """A new int32 block on `device` holding `words` (this module's blocks,
    and models/param_block.py's): on a card one `non_blocking` copy from a
    pinned staging slot, elsewhere a copy of the array there."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.array(words, np.int32)).to(device)
    block = torch.empty(len(words), dtype=torch.int32, device=device)
    key = (block.device, len(words))
    ring = _RINGS.get(key)
    if ring is None:
        ring = _RINGS[key] = _Ring(len(words))
    ring.put(words, block)
    return block
