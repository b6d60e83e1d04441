"""Row-band data parallelism over a `torch.distributed` process group.

Counterpart of `opengl_raytracing_tpu/parallel/sharding.py`.  The JAX
package lets XLA's SPMD partitioner place the collectives of a jitted
frame over a `Mesh`; PyTorch has no such partitioner, so the names here
are thin entries over the one band step of shardmap.py, which writes the
collectives out:

  * `make_mesh`: the process group of the ranks, this rank and its device
    (`cuda:<local rank>` unless the caller asks for the CPU, whose group
    must then be gloo: NCCL moves only CUDA tensors);
  * `shard_image_rows`: this rank's band of a whole-image `RenderState`;
  * `render_frame_sharded` / `make_sharded_render_fn`: the frame of this
    rank's band (shardmap.py:render_frame_shardmap), which also returns
    the frame's mean luminance; on the card `make_sharded_render_fn`
    replays it as one CUDA graph a rank (parallel/graph.py), as the JAX
    package jits its frame;
  * `spawn_ranks`: runs a function on n ranks in processes of their own
    (spawn start method, a file store in a temporary directory), for
    tests and smoke runs; a deployment starts its ranks its own way and
    calls `torch.distributed.init_process_group` itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from ..models.pipeline import RenderState, render_device
from .shardmap import (band_of, make_shardmap_render_fn,
                       render_frame_shardmap)

# a rank left waiting in a collective by a peer that failed raises after this
COLLECTIVE_TIMEOUT_S = 60
# after a rank fails, how long the launcher waits for the others' reports
# before it stops them: each failure is reported, the first cause with it
FAILED_GRACE_S = 5.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that render one frame together, from one rank's view."""
    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, cpu: bool = False) -> Mesh:
    """This rank's view of `group` (the default group when None), which
    must be initialised: its device is `cuda:<local rank>` (LOCAL_RANK, or
    the rank on one host) unless `cpu`, when the group must be gloo."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group first")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    backend = dist.get_backend(group)
    if cpu:
        if backend != "gloo":
            raise ValueError(f"a CPU mesh needs the gloo backend, not "
                             f"{backend}")
        device = torch.device("cpu")
    else:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = render_device(torch.device("cuda", local))
    return Mesh(group, rank, size, device)


def shard_image_rows(mesh: Mesh, state: RenderState) -> RenderState:
    """This rank's band of the whole-image state, on its device."""
    height = state.accum.shape[0]
    row0, bh = band_of(height, mesh.size, mesh.rank)
    return RenderState(
        state.accum[row0:row0 + bh].to(mesh.device, copy=True),
        state.frame_index)


def render_frame_sharded(mesh: Mesh, params, fin, state: RenderState,
                         env_map=None, bvh=None, *, height: int, width: int,
                         use_bvh: bool = False, show_motion: bool = False):
    """`render_frame` of this rank's band, the scene replicated: returns
    (new_state, FrameOutputs, mean_lum) with the band's tensors (gather
    with shardmap.gather_rows for host I/O)."""
    return render_frame_shardmap(mesh, params, fin, state, env_map, bvh,
                                 height=height, width=width, use_bvh=use_bvh,
                                 show_motion=show_motion)


def make_sharded_render_fn(mesh: Mesh, height: int, width: int,
                           use_bvh: bool = False, show_motion: bool = False,
                           jit: bool = True):
    """The band's frame function: fn(params, fin, state, env_map=None,
    bvh=None), `shardmap.make_shardmap_render_fn`'s: with `jit` (the
    default) on a CUDA mesh one CUDA graph a rank, captured once per
    configuration and replayed (parallel/graph.py); eager on a CPU mesh
    and with `jit=False`.  Raises at once when the mesh's device is CUDA
    and no card is present (make_mesh)."""
    return make_shardmap_render_fn(mesh, height, width, use_bvh=use_bvh,
                                   show_motion=show_motion, jit=jit)


def _rank_main(rank, n, store, cpu, fn, args, results):
    """One spawned rank: join the group, run fn(mesh, *args), report."""
    try:
        if not cpu:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "gloo" if cpu else "nccl", init_method=f"file://{store}",
            world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            out = fn(make_mesh(cpu=cpu), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, n: int, *args, cpu: bool = False,
                timeout: float = 300.0):
    """Run fn(mesh, *args) on ranks 0..n-1, each in a process of its own
    (one card each, or the CPU with gloo), and return their results in
    rank order.  `fn` must be importable by name and its results
    picklable (numpy arrays, not tensors).  A rank that raises, or a run
    that outlasts `timeout` seconds, stops every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, n, os.path.join(tmp, "store"), cpu,
                                   fn, args, results), daemon=True)
                 for rank in range(n)]
        for p in procs:
            p.start()
        out, failed = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) + len(failed) < n:
                try:
                    rank, ok, value = results.get(
                        timeout=max(deadline - time.monotonic(), 0.01))
                except queue.Empty:
                    if failed:
                        break
                    raise TimeoutError(
                        f"{n - len(out)} of {n} ranks did not finish in "
                        f"{timeout} s") from None
                (out if ok else failed)[rank] = value
                if failed:  # the peers it leaves waiting fail soon after
                    deadline = min(deadline, time.monotonic() + FAILED_GRACE_S)
            if failed:
                raise RuntimeError("\n".join(
                    f"rank {rank} of {n} failed:\n{tb}"
                    for rank, tb in sorted(failed.items())))
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[rank] for rank in range(n)]
