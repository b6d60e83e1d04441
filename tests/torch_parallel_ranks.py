"""What each rank of tests/test_torch_parallel.py runs, and the scenes both
sides build.  The spawned ranks import this module by name: it imports
torch and the port, never JAX."""

from types import SimpleNamespace

import torch
import torch.distributed as dist

from opengl_raytracing_tpu_torch.convert import frame_inputs_from_numpy
from opengl_raytracing_tpu_torch.models import RenderState
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.parallel import (make_sharded_render_fn,
                                                  shard_image_rows)
from opengl_raytracing_tpu_torch.parallel.shardmap import gather_rows
from opengl_raytracing_tpu_torch.scene import (gather_triangles, make_bunny,
                                               model_transform)

BUNNY_AT = (-2.0, 1.5, 0.0)
PLANES = ("image", "accum", "motion", "gpos", "gnrm")


def bunny_bvh(device):
    """The BVH scene of the tests: a small bunny the camera aims at."""
    tris = gather_triangles(make_bunny(2), model_transform(BUNNY_AT, 0.5))
    return prepare_bvh(tris, device)


def render_cases(mesh, cases, height, width):
    """Each case's frames through `make_sharded_render_fn` on this rank's
    band: {case: {"lums": every frame's mean_lum, "band": the band's image
    shape, and on rank 0 the last frame's planes gathered, as numpy}}.
    A case is {"params", "bvh" (bool), "show_motion", "frames" (dicts of
    the FrameInputs fields as numpy)}."""
    torch.set_num_threads(1)
    out = {}
    for name, case in cases.items():
        bvh = bunny_bvh(mesh.device) if case["bvh"] else None
        fn = make_sharded_render_fn(mesh, height, width, use_bvh=case["bvh"],
                                    show_motion=case["show_motion"])
        state = shard_image_rows(mesh, RenderState.create(height, width,
                                                          "cpu"))
        lums = []
        for fin in case["frames"]:
            state, outs, lum = fn(case["params"], frame_inputs_from_numpy(
                SimpleNamespace(**fin), mesh.device), state, None, bvh)
            lums.append(float(lum))
        planes = dict(zip(PLANES, (outs.image, state.accum, outs.motion,
                                   outs.gpos, outs.gnrm)))
        res = dict(lums=lums, band=tuple(outs.image.shape),
                   frame_index=state.frame_index)
        for k, v in planes.items():
            whole = gather_rows(mesh, v)
            res[k] = None if whole is None else whole.cpu().numpy()
        out[name] = res
    return out


def fail_on_rank_one(mesh):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group=mesh.group)
    return mesh.rank


def mesh_of_rank(mesh):
    return (mesh.rank, mesh.size, str(mesh.device))


def band_chain(mesh, case, height, width):
    """tests/test_torch_band_graph.py's ranks: the case's frames through
    `make_sharded_render_fn` at its default `jit` (on a gloo mesh, the
    eager step), with rank 0's every frame's gathered image and each
    frame's mean_lum and gather decision; then the key agreement check of
    the compiled step (parallel/graph.py:agree), once with what every
    rank holds alike and once with a field that differs between ranks
    (it must raise on every rank)."""
    from opengl_raytracing_tpu_torch.parallel.graph import agree
    from opengl_raytracing_tpu_torch.parallel.shardmap import needs_history
    torch.set_num_threads(1)
    fn = make_sharded_render_fn(mesh, height, width,
                                show_motion=case["show_motion"])
    state = shard_image_rows(mesh, RenderState.create(height, width, "cpu"))
    images, lums, gathers = [], [], []
    for f in case["frames"]:
        fin = frame_inputs_from_numpy(SimpleNamespace(**f), mesh.device)
        gathers.append(needs_history(case["params"], fin))
        state, outs, lum = fn(case["params"], fin, state, None, None)
        lums.append(float(lum))
        whole = gather_rows(mesh, outs.image)
        images.append(None if whole is None else whole.numpy())
    agree(mesh, ("the same on every rank",))
    try:
        agree(mesh, ("differs by rank", mesh.rank))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return dict(images=images, lums=lums, gathers=gathers, refused=refused)
