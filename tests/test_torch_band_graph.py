"""The compiled band step (opengl_raytracing_tpu_torch/parallel/graph.py)
and the compiled raster preview (models/graph.py: `render_raster`) on the
CPU, at 48x64.

A captured step is valid for every frame index, camera and slider value
only if its operations, and every host argument they take, are the same
whatever those are, and if every data field reaches it through the one
static parameter block it was captured with.  Held here:

* the band step, through `render_bands_in_turn` with 2 and 4 bands (the
  step with its collectives replaced by slices), given the static frame
  block and static parameter block as `parallel/graph.py` gives them:
  the same operations (tests/torch_recorder.py) at frame indices 0, 1,
  7, 8, 31 and 2^20+5 with two cameras, and at three seeded parameter
  sets; no host read; every parameter tensor an operation reads, and
  every block pointer a kernel would take, the static block's; never the
  cached block of a parameter set;
* a step with one set's host parameters and another set's words in its
  static block renders the other set bit for bit (a replay after a
  slider move);
* the band key holds the mesh, the band, the halo and the gather, and
  no frame index, camera or data value;
* `needs_history` in the JAX package's form (no frame-0 term): a moving
  chain's frames 0-2 on 2 gloo ranks gather the history at every frame,
  equal `render_frame` bit for bit and JAX's `make_shardmap_render_fn`
  on 2 of the conftest's virtual devices within
  tests/test_torch_parallel.py::test_matches_jax_shardmap's moving
  tolerances (q99 < 2e-3, max < 5e-2); mean_lum within 1e-4 of the host's
  reduction; the ranks' key agreement check passes when they agree and
  raises on every rank when they do not;
* the raster preview: the same recorder and key checks, and the preview
  read through a static block holding a seeded set's words, at three
  sets, against JAX's `render_raster` of that set within
  tests/test_torch_spp_motion_raster.py's tolerance (at most 2e-3 of the
  pixels differ, at silhouettes);
* on a CPU mesh `jit=True` is the eager step, and a capture asked of CPU
  tensors raises.

The card runs the captures (tests/test_torch_cuda.py, chip_smoke.py
phase `sharded`).
"""

import functools
import weakref
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from opengl_raytracing_tpu import Camera as JCamera
from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import RenderState as JRenderState
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models.raster import render_raster as jraster
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh
from opengl_raytracing_tpu.parallel import make_mesh as jmake_mesh
from opengl_raytracing_tpu.parallel import (
    shard_image_rows as jshard_image_rows)
from opengl_raytracing_tpu.parallel.shardmap import (
    make_shardmap_render_fn as jmake_shardmap_render_fn)

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 camera_frame_inputs,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import (RenderState, graph,
                                                param_block, preset, raster,
                                                render_frame)
from opengl_raytracing_tpu_torch.ops import cuda_lib
from opengl_raytracing_tpu_torch.ops.scene import prepare_bvh
from opengl_raytracing_tpu_torch.params import bind
from opengl_raytracing_tpu_torch.parallel import (make_mesh,
                                                  make_sharded_render_fn,
                                                  shard_image_rows)
from opengl_raytracing_tpu_torch.parallel import graph as pgraph
from opengl_raytracing_tpu_torch.parallel.sharding import Mesh, spawn_ranks
from opengl_raytracing_tpu_torch.parallel.shardmap import (
    make_shardmap_render_fn, render_bands_in_turn, render_frame_shardmap)
from opengl_raytracing_tpu_torch.sampling import generate_jitter2d
from opengl_raytracing_tpu_torch.scene import BVHArrays

from tests import torch_parallel_ranks as ranks
from torch_param_block import seeded_values
from torch_recorder import HOST_READS, recording

torch.set_num_threads(2)

H, W = 48, 64
FRAME_INDICES = (0, 1, 7, 8, 31, 2 ** 20 + 5)
PARAM_SEEDS = (1, 2, 3)
FIELDS = ("cam_pos", "cam_right", "cam_up", "cam_fwd", "tan_half_fov",
          "aspect", "jitter", "curr_view_proj", "prev_view_proj",
          "camera_moved")


@pytest.fixture(scope="module")
def bvh():
    return ranks.bunny_bvh("cpu")


def _camera(k):
    """Two cameras, k even or odd, aimed at the bunny from two places."""
    cam = Camera(aspect=W / H)
    cam.fov = 14.0
    cam.position = np.float32([0.3 * (k % 2), 1.0, 4.0 + 0.2 * (k % 2)])
    cam.point_at(ranks.BUNNY_AT)
    return cam


def _fin(k, index, moving):
    prev = _camera(k + 1)
    prev.yaw += 2.0
    return camera_frame_inputs(
        _camera(k), "cpu",
        jitter=(0.1 * (index % 3) - 0.1, 0.05 * (index % 4) - 0.07),
        prev_view_proj=prev.view_projection() if moving else None,
        moved=int(moving), frame_index=index)


def _history(n, seed):
    rng = np.random.RandomState(seed)
    whole = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    return [RenderState(torch.from_numpy(b.copy()), 0)
            for b in np.split(whole, n)]


def _at(states, index):
    return [RenderState(s.accum, index) for s in states]


class _Watch:
    """The parameter-block cache's calls and the block pointers the
    kernels' argument structs take, while a step runs."""

    def __init__(self, monkeypatch):
        self.cache_calls, self.pointers = 0, []
        block, ptr = param_block.block, cuda_lib.param_block_ptr

        def cached(*a, **kw):
            self.cache_calls += 1
            return block(*a, **kw)

        def pointer(*a, **kw):
            self.pointers.append(ptr(*a, **kw))
            return self.pointers[-1]
        monkeypatch.setattr(param_block, "block", cached)
        monkeypatch.setattr(cuda_lib, "param_block_ptr", pointer)


def _static(params, fin):
    """The static frame block and parameter block, filled as
    parallel/graph.py fills them before a replay: the frame block's inputs
    carry `fin`'s host words, so a step sees the frame's index (and
    restages nothing)."""
    static_fin, pblock = graph.static_inputs(params, fin, "cpu")
    assert static_fin.frame_index == fin.frame_index
    assert static_fin.at_frame(fin.frame_index) is static_fin
    return static_fin, pblock


def _record(monkeypatch, step, pblock, kernels_read_it=True):
    """`step()` under the recorder: (its result, the operations); the
    step must read the static block `pblock` and no cached block, and its
    kernels' argument structs (where `kernels_read_it`) point at it."""
    cached = {b.untyped_storage().data_ptr()
              for b in param_block._BLOCKS.values()}
    watch = _Watch(monkeypatch)
    with recording(monkeypatch) as rec:
        out = step()
    monkeypatch.undo()
    assert watch.cache_calls == 0, "the step read the parameter cache"
    assert set(watch.pointers) <= {pblock.data_ptr()}
    assert watch.pointers or not kernels_read_it
    assert pblock.untyped_storage().data_ptr() in rec.storages
    assert not cached & rec.storages, "an operation read a cached block"
    reads = sorted({op[0] for op in rec.ops if op[0] in HOST_READS})
    assert not reads, f"the step reads the device: {reads}"
    return out, rec.ops


def _runs(params):
    """(parameters, camera, frame index) of the recorded frames: six frame
    indices with two cameras, then three seeded parameter sets."""
    return ([(params, k % 2, index) for k, index in enumerate(FRAME_INDICES)]
            + [(params.replace(**seeded_values(seed)), seed % 2,
                FRAME_INDICES[seed]) for seed in PARAM_SEEDS])


def _same_ops(runs, records, kernels=True):
    if kernels:
        assert any(op[0] == "kernel" for op in records[0]), \
            "the step reached no kernel wrapper"
    for (p, k, index), ops in zip(runs[1:], records[1:]):
        what = f"frame {index}, camera {k}" + (
            "" if p is runs[0][0] else ", seeded values")
        assert len(ops) == len(records[0]), what
        for i, (a, b) in enumerate(zip(records[0], ops)):
            assert a == b, f"{what}, operation {i}: {a} != {b}"


# ---- the band step ----

BAND_CASES = {"full": ("full", False), "moving": ("full", True),
              "realistic": ("realistic", True)}


# every case on 2 bands; on 4 the case that exchanges the most (the
# gathered history and both halos of the middle bands)
@pytest.mark.parametrize("n,case", [(2, "full"), (2, "moving"),
                                    (2, "realistic"), (4, "moving")])
def test_band_step_is_the_same_for_every_frame(n, case, bvh, monkeypatch):
    name, moving = BAND_CASES[case]
    params = preset(name).replace(enable_env_map=0)
    runs = _runs(params)
    for p, _, _ in runs[:1] + runs[len(FRAME_INDICES):]:  # warm the caches
        fin, pblock = _static(p, _fin(0, 3, moving))
        render_bands_in_turn(bind(p, "cpu", pblock), fin,
                             _at(_history(n, 0), 3), None, bvh, height=H,
                             width=W, use_bvh=True)
    records, images = [], []
    for p, k, index in runs:
        fin, pblock = _static(p, _fin(k, index, moving))
        states = _at(_history(n, k + 1), index)
        bound = bind(p, "cpu", pblock)
        (states, outs, lum), ops = _record(
            monkeypatch, lambda: render_bands_in_turn(
                bound, fin, states, None, bvh, height=H, width=W,
                use_bvh=True), pblock)
        image = torch.cat([o.image for o in outs])
        assert torch.isfinite(image).all() and torch.isfinite(lum)
        assert all(s.frame_index == index + 1 for s in states)
        records.append(ops)
        images.append(image)
    _same_ops(runs, records)
    # the seeded values reached the image: the check is not vacuous
    assert not torch.equal(images[len(FRAME_INDICES)],
                           images[len(FRAME_INDICES) + 1])


@pytest.mark.parametrize("moving", [False, True], ids=["still", "moving"])
def test_band_step_after_a_slider_move_renders_the_new_values(moving, bvh):
    """The step as captured at set A (A's host parameters) reading set B's
    words through its static block, as a replay after a slider move does:
    B's eager step bit for bit, and not A's."""
    base = preset("full").replace(enable_env_map=0)
    a, b = (base.replace(**seeded_values(seed)) for seed in (4, 5))
    fin = _fin(0, 9, moving)
    pblock = param_block.block(b, "cpu").clone()
    got = render_bands_in_turn(bind(a, "cpu", pblock), fin,
                               _at(_history(4, 2), 9), None, bvh, height=H,
                               width=W, use_bvh=True)
    want = render_bands_in_turn(b, fin, _at(_history(4, 2), 9), None, bvh,
                                height=H, width=W, use_bvh=True)
    other = render_bands_in_turn(a, fin, _at(_history(4, 2), 9), None, bvh,
                                 height=H, width=W, use_bvh=True)
    for x, y in zip(got[0], want[0]):
        assert torch.equal(x.accum, y.accum)
    for x, y in zip(got[1], want[1]):
        for plane, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), plane
    assert torch.equal(got[2], want[2])
    assert not torch.equal(got[1][0].image, other[1][0].image)


def test_band_key_holds_mesh_band_halo_and_gather(bvh):
    params = preset("full")
    mesh = Mesh(None, 1, 4, torch.device("cpu"))

    def key(fin, p=params, m=mesh, scene=0, slot=0, **kw):
        args = dict(height=H, width=W, use_bvh=True, show_motion=False)
        args.update(kw)
        return pgraph.band_key(m, p, fin, scene, slot, **args)

    base = key(_fin(0, 0, True))
    assert base[1:] == (("scene", 0), ("slot", 0), ("ranks", 4),
                        ("halo", True), ("gather", True),
                        ("mesh", None, 1, mesh.device), ("band", 12, 12))
    # not the frame index, the camera or a data field's value
    assert key(_fin(1, 2 ** 20 + 5, True)) == base
    assert key(_fin(0, 3, True).at_frame(9)) == base
    for p in (params.replace(exposure=2.0),
              params.replace(taa_still_thresh=2e-5),
              params.replace(**seeded_values(7))):
        assert key(_fin(0, 0, True), p) == base
    # graph_key's configuration: the static fields, the size, the scene
    # mode, the motion view, the host flag `moved`
    for other in (key(_fin(0, 0, True), params.replace(enable_gi=0)),
                  key(_fin(0, 0, True), use_bvh=False),
                  key(_fin(0, 0, True), width=2 * W)):
        assert other[0] != base[0]
    assert key(_fin(0, 0, False))[0] != base[0]
    # the scene and the static accumulation, by number
    assert key(_fin(0, 0, True), scene=1)[1] == ("scene", 1)
    assert key(_fin(0, 0, True), slot=2)[2] == ("slot", 2)
    # the mesh, the band, the halo, the gather
    assert key(_fin(0, 0, True), m=Mesh(None, 2, 4, mesh.device)) != base
    assert key(_fin(0, 0, True), m=Mesh(None, 1, 2, mesh.device))[-1] \
        == ("band", 24, 24)
    assert key(_fin(0, 0, True), height=2 * H)[-1] == ("band", 24, 24)
    assert key(_fin(0, 0, True), params.replace(enable_svgf=0))[4] \
        == ("halo", False)
    assert key(_fin(0, 0, True), show_motion=True)[4] == ("halo", False)
    assert key(_fin(0, 0, False))[5] == ("gather", False)
    assert key(_fin(0, 0, True), params.replace(enable_taa=0))[5] \
        == ("gather", False)
    # a still camera gathers at taa_still_thresh <= 0 (JAX's guard)
    assert key(_fin(0, 0, False), params.replace(taa_still_thresh=0.0))[5] \
        == ("gather", True)
    # what the ranks compare before a capture: not the group, the rank,
    # the device or the band
    assert key(_fin(0, 0, True), m=Mesh(None, 3, 4, mesh.device))[:-2] \
        == base[:-2]


def test_band_key_names_scenes_and_slots_alike_on_every_rank():
    """Two processes that render the same scenes and states in the same
    order hold the same key, though their tensors' identities and
    addresses differ: the scene is its number in the order first seen,
    the accumulation its slot's number among the band steps' own."""
    def scenes_in_order():
        a, b = ranks.bunny_bvh("cpu"), ranks.bunny_bvh("cpu")
        env = torch.zeros((6, 4, 4, 3))
        graph.clear()
        try:
            return [pgraph._scene("cpu", e, s) for e, s in
                    ((None, a), (None, b), (None, a), (env, a), (env, None),
                     (None, b))]
        finally:
            graph.clear()
    first, second = scenes_in_order(), scenes_in_order()
    assert first == second == [0, 1, 0, 2, 3, 1]

    graph.clear()
    try:
        states = [RenderState.create(H // 2, W, "cpu") for _ in range(2)]
        band = []
        for s in states:  # each owned by a live state, as a step owns it
            band.append(graph._slot(s, H // 2, W, pool="band"))
            band[-1].owner = weakref.ref(s)
        # a frame slot of the same size is another pool's
        frame = graph._slot(states[0], H // 2, W)
        assert [s.index for s in band] == [0, 1] and frame.index == 0
        assert frame.accum.data_ptr() not in {s.accum.data_ptr()
                                              for s in band}
        # a state that holds a band slot keeps it
        held = RenderState(band[1].accum, 3)
        assert graph._slot(held, H // 2, W, pool="band") is band[1]
    finally:
        graph.clear()


def test_band_graphs_are_kept_apart_from_the_frame_graphs(monkeypatch):
    """A band step's graph stays however many frame and raster graphs a
    rank captures after it: only `clear()` drops it (captures stubbed,
    since the CPU has no CUDA graph)."""
    captured = []

    class Replayable:
        def __init__(self, name):
            self.name, self.replays = name, 0

        def replay(self):
            self.replays += 1

    def capture(frame, device, keep):
        captured.append(frame())
        return graph._Graph(Replayable(captured[-1]), captured[-1], {}, 0,
                            keep)
    monkeypatch.setattr(graph, "_capture", capture)
    graph.clear()
    try:
        agreed = []
        band = graph.run(("band",), lambda: "band", "cpu", (),
                         before_capture=lambda: agreed.append(1),
                         evict=False)
        for k in range(graph.MAX_GRAPHS + 3):
            graph.run(("frame", k), lambda k=k: f"frame {k}", "cpu", ())
        assert band == "band" and agreed == [1]
        assert len(graph._GRAPHS) == graph.MAX_GRAPHS
        assert ("frame", 0) not in graph._GRAPHS
        assert graph.run(("band",), lambda: "eager", "cpu", (),
                         before_capture=lambda: agreed.append(2),
                         evict=False) == "band"
        assert agreed == [1] and graph._KEPT[("band",)].graph.replays == 1
        assert graph.stats()["graphs"] == graph.MAX_GRAPHS + 1
    finally:
        graph.clear()
    assert not graph._GRAPHS and not graph._KEPT


# ---- needs_history in JAX's form, through 2 gloo ranks ----

def _slim(jparams):
    """JAX's tests/test_shardmap.py `_slim`."""
    return jparams.replace(enable_gi=0, enable_ao=0, mat_glass_enabled=0,
                           mat_mirror_enabled=0, enable_env_map=0)


def _moving_frames(params, n):
    cam = Camera()
    cam.aspect = W / H
    prev, frames = cam.view_projection(), []
    for i in range(n):
        cam.yaw += 1.5
        cam.position = cam.position + np.float32([0.05, 0.0, -0.05])
        right, up, fwd, thf = cam.basis()
        vp = cam.view_projection()
        frames.append(dict(
            cam_pos=np.float32(cam.position), cam_right=right, cam_up=up,
            cam_fwd=fwd, tan_half_fov=np.float32(thf),
            aspect=np.float32(cam.aspect),
            jitter=np.float32(generate_jitter2d(i)
                              * params.jitter_moving_scale),
            curr_view_proj=vp, prev_view_proj=prev,
            camera_moved=np.int32(1)))
        prev = vp
    return frames


JPARAMS = _slim(jpreset("full"))
CHAIN = dict(params=params_from(JPARAMS), show_motion=False,
             frames=_moving_frames(JPARAMS, 3))


@functools.lru_cache(maxsize=None)
def _chain():
    return spawn_ranks(ranks.band_chain, 2, CHAIN, H, W, cpu=True,
                       timeout=300.0)


def test_moving_frames_from_frame_0_match_render_frame_and_jax():
    results = _chain()
    assert all(r["gathers"] == [True] * 3 for r in results)
    images = results[0]["images"]
    state = RenderState.create(H, W, "cpu")
    mesh = jmake_mesh(jax.devices()[:2])
    jfn = jmake_shardmap_render_fn(mesh, H, W, donate=False)
    jstate = jshard_image_rows(mesh, JRenderState.create(H, W))
    for i, f in enumerate(CHAIN["frames"]):
        state, out = render_frame(CHAIN["params"],
                                  frame_inputs_from_numpy(SimpleNamespace(
                                      **f), "cpu"), state, height=H,
                                  width=W)
        np.testing.assert_array_equal(images[i], out.image.numpy(),
                                      f"frame {i}")
        jfin = JFrameInputs(**{k: jnp.asarray(f[k]) for k in FIELDS})
        jstate, jout, jlum = jfn(JPARAMS, jfin, jstate, None, None)
        diff = np.abs(images[i] - np.asarray(jout.image))
        assert np.quantile(diff, 0.99) < 2e-3 and diff.max() < 5e-2, i
        assert abs(results[0]["lums"][i] - float(jlum)) < 1e-4
        host = float((images[i] @ np.float32([0.299, 0.587, 0.114])).mean())
        assert all(abs(r["lums"][i] - host) < 1e-4 for r in results)


def test_ranks_that_disagree_on_the_key_raise():
    for rank, r in enumerate(_chain()):
        assert r["refused"] is not None, rank
        assert "different band steps" in r["refused"]


# ---- the raster preview ----

@pytest.mark.parametrize("with_mesh", [True, False], ids=["mesh", "no_mesh"])
def test_raster_preview_is_the_same_for_every_frame(with_mesh, bvh,
                                                    monkeypatch):
    params = preset("baseline").replace(point_light_orbit_enabled=1)
    scene = bvh if with_mesh else None
    runs = _runs(params)
    for p, _, _ in runs[:1] + runs[len(FRAME_INDICES):]:  # warm the caches
        fin, pblock = _static(p, _fin(0, 3, False))
        raster.render_raster(bind(p, "cpu", pblock), fin, scene, height=H,
                             width=W)
    records, images = [], []
    for p, k, index in runs:
        fin, pblock = _static(p, _fin(k, index, False))
        # K1 (the mesh's trace) reads no parameter block
        image, ops = _record(monkeypatch, functools.partial(
            raster.render_raster, bind(p, "cpu", pblock), fin, scene,
            height=H, width=W), pblock, kernels_read_it=False)
        records.append(ops)
        images.append(image)
    _same_ops(runs, records, kernels=with_mesh)
    assert not torch.equal(images[len(FRAME_INDICES)],
                           images[len(FRAME_INDICES) + 1])
    assert not torch.equal(images[0], images[1])  # the two cameras


def test_raster_key_holds_the_configuration_not_the_frame(bvh):
    params = preset("baseline")

    def key(p=params, scene=bvh, **kw):
        args = dict(device="cuda", height=H, width=W)
        args.update(kw)
        return graph.raster_key(p, scene, **args)

    base = key()
    for p in (params.replace(point_light_yaw=40.0),
              params.replace(**seeded_values(8))):
        assert key(p) == base
    for p in (params.replace(point_light_enabled=0),
              params.replace(point_light_orbit_enabled=1),
              params.replace(taa_still_thresh=0.0)):
        assert key(p) != base
    assert key(scene=None) != base
    assert key(scene=prepare_bvh(_tris(), "cpu")) != base
    assert key(height=H + 1) != base and key(device="cpu") != base
    assert base[0] == "raster"


def _tris():
    from opengl_raytracing_tpu_torch.scene import (gather_triangles,
                                                   make_bunny,
                                                   model_transform)
    return gather_triangles(make_bunny(2), model_transform(ranks.BUNNY_AT,
                                                           0.5))


@pytest.mark.parametrize("seed", PARAM_SEEDS)
def test_raster_preview_through_a_static_block_matches_jax(seed):
    """The preview with the default host parameters reading a seeded
    set's words through its static block (a replay after the sliders
    moved) against JAX's render_raster of that set."""
    jparams = jpreset("baseline").replace(point_light_orbit_enabled=1,
                                          **seeded_values(seed))
    params = params_from(jparams)
    host = preset("baseline").replace(point_light_orbit_enabled=1)
    jbvh = jprepare_bvh(_tris())
    scene = bvh_from_numpy(BVHArrays(*(np.asarray(x) for x in jbvh.arrays)),
                           "cpu")
    cam = JCamera()
    cam.aspect = W / H
    cam.point_at((1.0, 1.0, 0.0))
    right, up, fwd, thf = cam.basis()
    vp = cam.view_projection()
    jfin = JFrameInputs(
        cam_pos=jnp.asarray(cam.position), cam_right=jnp.asarray(right),
        cam_up=jnp.asarray(up), cam_fwd=jnp.asarray(fwd),
        tan_half_fov=jnp.float32(thf), aspect=jnp.float32(cam.aspect),
        jitter=jnp.zeros(2, jnp.float32), curr_view_proj=jnp.asarray(vp),
        prev_view_proj=jnp.asarray(vp), camera_moved=jnp.int32(0))
    want = np.asarray(jraster(jparams, jfin, jbvh, height=H, width=W))
    pblock = param_block.block(params, "cpu").clone()
    got = raster.render_raster(bind(host, "cpu", pblock),
                               frame_inputs_from_numpy(jfin, "cpu"), scene,
                               height=H, width=W).numpy()
    differ = (got != want).any(-1)
    assert differ.mean() <= 2e-3
    own = raster.render_raster(params, frame_inputs_from_numpy(jfin, "cpu"),
                               scene, height=H, width=W).numpy()
    np.testing.assert_array_equal(got, own)
    marker = tuple(np.minimum(np.float32(params.point_light_color)
                              * np.float32(3.0), 1.0))
    assert marker in {tuple(c) for c in got.reshape(-1, 3)}


# ---- the CPU runs the eager step; a capture needs the card ----

def test_a_cpu_mesh_runs_the_eager_step(tmp_path, bvh):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(cpu=True)
        params = preset("full").replace(enable_env_map=0)
        graph.clear()
        stats = dict(graph.STATS)
        outs = {}
        for name, fn in (
                ("jit", make_sharded_render_fn(mesh, H, W, use_bvh=True)),
                ("shardmap_jit", make_shardmap_render_fn(mesh, H, W,
                                                         use_bvh=True)),
                ("eager", make_sharded_render_fn(mesh, H, W, use_bvh=True,
                                                 jit=False))):
            state = shard_image_rows(mesh, RenderState.create(H, W, "cpu"))
            images = []
            for i in range(3):
                state, out, lum = fn(params, _fin(i, i, True), state, None,
                                     bvh)
                images.append(out.image)
            outs[name] = images
        for name in ("jit", "shardmap_jit"):
            for a, b in zip(outs[name], outs["eager"]):
                assert torch.equal(a, b), name
        assert graph.STATS == stats and not graph._GRAPHS \
            and not graph._KEPT
        # a capture needs CUDA tensors
        band = shard_image_rows(mesh, RenderState.create(H, W, "cpu"))
        with pytest.raises(ValueError, match="CUDA"):
            pgraph.render(mesh, params, _fin(0, 0, True), band, None, bvh,
                          height=H, width=W, use_bvh=True)
        with pytest.raises(ValueError, match="CUDA"):
            graph.render_raster(params, _fin(0, 0, False), bvh, height=H,
                                width=W)
        with pytest.raises(ValueError, match="CUDA"):
            graph.render(params, _fin(0, 0, False),
                         RenderState.create(H, W, "cpu"), None, bvh,
                         height=H, width=W, use_bvh=True)
        # the eager entry is the step the graph captures
        state = shard_image_rows(mesh, RenderState.create(H, W, "cpu"))
        _, out, _ = render_frame_shardmap(mesh, params, _fin(0, 0, True),
                                          state, None, bvh, height=H,
                                          width=W, use_bvh=True)
        assert torch.equal(out.image, outs["eager"][0])
    finally:
        dist.destroy_process_group()
        graph.clear()
