"""The frame that one CUDA graph captures for every frame (models/graph.py).

A captured frame is valid for any frame index and camera only if the
frame's operations, and every host argument they take, are the same
whatever the frame: the per-frame values reach it through the device
block alone (models/frame_block.py).  Held here on the CPU:

* frame invariance: a warm frame's operations and their non-tensor
  arguments under a TorchDispatchMode, with the kernels' wrappers replaced
  by stubs that record what the card's launch would take (the argument
  structs' bytes, their pointers aside) and run the plain versions out of
  the record, are the same at frame indices 1, 7, 8, 31, 32 and 2^20+5
  with a camera that differs every frame, and with every data field of
  the parameters at three seeded non-default values
  (tests/torch_param_block.py), for baseline, full, heavy, moving and
  an_full;
* no host reads: such a frame calls no aten::_local_scalar_dense, no
  aten::nonzero and no aten::lift_fresh;
* the kernels' argument structs (`bounce_args`, `ao_args`, `scene_args`)
  are byte-identical for two frame indices held in one record;
* the device frame's arithmetic: the device ld2 bit for bit the host one
  for frames 0..4096 and large ones, rand and the sample offsets of a
  device frame value the host's int32 arithmetic, TAA's device selects
  the host rule's float32 constants at frames 0, 1, 7, 8, 31 and 32;
* parity: the port's frame at frame indices 0, 1, 7, 8, 31, 32 and
  2^20+5, from a history, against JAX's `render_frame` (the BVH and the
  analytic scene, GI, AO and TAA on), within test_torch_pipeline.py's
  1e-4;
* the graph key: a static field's value and the host's branch on
  `taa_still_thresh > 0` change it; the frame index, the camera and the
  data fields' values do not;
* FrameInputs' fields are views of its block; two live states get a
  static accumulation each.

The card runs the capture itself (tests/test_torch_cuda.py, chip_smoke.py
phase `graph`).
"""

import dataclasses
import functools
import weakref

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import reference_oracle as ref

from opengl_raytracing_tpu.models import FrameInputs as JFrameInputs
from opengl_raytracing_tpu.models import RenderState as JRenderState
from opengl_raytracing_tpu.models import preset as jpreset
from opengl_raytracing_tpu.models import render_frame as jrender_frame
from opengl_raytracing_tpu.ops import taa as jtaa
from opengl_raytracing_tpu.ops.scene import prepare_bvh as jprepare_bvh

from opengl_raytracing_tpu_torch.camera import Camera
from opengl_raytracing_tpu_torch.convert import (bvh_from_numpy,
                                                 camera_frame_inputs,
                                                 env_from_numpy,
                                                 frame_inputs_from_numpy,
                                                 params_from)
from opengl_raytracing_tpu_torch.models import RenderState, preset
from opengl_raytracing_tpu_torch.models import frame_block
from opengl_raytracing_tpu_torch.models import graph
from opengl_raytracing_tpu_torch.models.graph import graph_key
from opengl_raytracing_tpu_torch.models.pipeline import (FrameInputs,
                                                         pixel_centers,
                                                         render_frame,
                                                         render_staged)
from opengl_raytracing_tpu_torch.ops import an_cuda, bvh_cuda
from opengl_raytracing_tpu_torch.ops.scene import SceneCtx, prepare_bvh
from opengl_raytracing_tpu_torch.ops.taa import _still_weights, resolve_taa
from opengl_raytracing_tpu_torch.ops.vecmath import luminance
from opengl_raytracing_tpu_torch.constants import YCOEFF
from opengl_raytracing_tpu_torch.params import STATIC_FIELDS, f32
from opengl_raytracing_tpu_torch.sampling import (FrameValue, _frame_bits,
                                                  frame_f32, frame_record,
                                                  halton, ld2, rand)
from opengl_raytracing_tpu_torch.scene import (BVHArrays, gather_triangles,
                                               make_bunny, model_transform)

from torch_param_block import seeded_values
from torch_recorder import HOST_READS, recording

torch.set_num_threads(2)

H, W = 16, 24
FRAMES = (1, 7, 8, 31, 32, 2 ** 20 + 5)
PARITY_FRAMES = (0, 1, 7, 8, 31, 32, 2 ** 20 + 5)
HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::lift_fresh")


@pytest.fixture(scope="module")
def tris():
    return gather_triangles(make_bunny(2),
                            model_transform((-2.0, 1.5, 0.0), 0.5))


def _camera(k):
    """A camera that differs with k: position, yaw and aim."""
    cam = Camera(aspect=W / H)
    cam.fov = 14.0
    cam.position = np.float32([0.1 * k % 0.7, 1.0, 4.0 + 0.05 * (k % 5)])
    cam.point_at((-2.0, 1.5, 0.0))
    return cam


def _fin(k, frame_index, moving, prev_cam=None):
    cam = _camera(k)
    prev = (_camera(k + 1) if prev_cam is None else prev_cam)
    jitter = np.float32([0.1 * (k % 3) - 0.1, 0.05 * (k % 4) - 0.07])
    return camera_frame_inputs(
        cam, "cpu", jitter=jitter,
        prev_view_proj=prev.view_projection() if moving else None,
        moved=int(moving), frame_index=frame_index)


def _history(seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (H, W, 4)).astype(
        np.float32))


CASES = {
    "baseline": dict(preset="baseline", use_bvh=True),
    "full": dict(preset="full", use_bvh=True),
    "heavy": dict(preset="heavy", use_bvh=True),
    "moving": dict(preset="full", use_bvh=True, moving=True),
    "an_full": dict(preset="full", use_bvh=False, env=True),
}


def _case(name, tris):
    c = CASES[name]
    params = preset(c["preset"]).replace(enable_env_map=int(c.get("env",
                                                                  False)))
    env = None
    if c.get("env"):
        faces = np.random.RandomState(3).randint(0, 256, (6, 4, 4, 3))
        env = env_from_numpy(faces.astype(np.uint8), "cpu")
    bvh = prepare_bvh(tris, "cpu") if c["use_bvh"] else None
    return params, env, bvh, c["use_bvh"], c.get("moving", False)


PARAM_SEEDS = (1, 2, 3)


@pytest.mark.parametrize("name", list(CASES))
def test_frame_is_the_same_for_every_frame(name, tris, monkeypatch):
    params, env, bvh, use_bvh, moving = _case(name, tris)
    # every data field at seeded values: the static fields, and so the
    # graph key, stay the default's
    runs = [(params, k, index) for k, index in enumerate(FRAMES)] + [
        (params.replace(**seeded_values(seed)), seed, FRAMES[seed])
        for seed in PARAM_SEEDS]
    assert all(graph_key(p, _fin(0, 0, moving), env, bvh, device="cuda",
                         height=H, width=W, use_bvh=use_bvh,
                         show_motion=False, want_u8=False)
               == graph_key(params, _fin(0, 0, moving), env, bvh,
                            device="cuda", height=H, width=W,
                            use_bvh=use_bvh, show_motion=False,
                            want_u8=False) for p, _, _ in runs)

    # warm: the constants' caches and each parameter set's block fill here
    for p, _, _ in runs[:1] + runs[len(FRAMES):]:
        render_staged(p, _fin(0, 3, moving), RenderState(_history(0), 3),
                      env, bvh, height=H, width=W, use_bvh=use_bvh)
    records, images = [], []
    for p, k, index in runs:
        fin = _fin(k, index, moving)
        state = RenderState(_history(k), index)
        with recording(monkeypatch) as rec:
            _, out = render_staged(p, fin, state, env, bvh, height=H,
                                   width=W, use_bvh=use_bvh)
        monkeypatch.undo()
        assert torch.isfinite(out.image).all()
        records.append(rec.ops)
        images.append(out.image)
    kernels = [op for op in records[0] if op[0] == "kernel"]
    assert kernels, "the frame reached no kernel wrapper"
    assert len(records[0]) > 100
    for (p, _, index), ops in zip(runs[1:], records[1:]):
        what = f"frame {index}" + ("" if p is params else ", seeded values")
        assert len(ops) == len(records[0]), what
        for i, (a, b) in enumerate(zip(records[0], ops)):
            assert a == b, f"{what}, operation {i}: {a} != {b}"
    # the seeded values reached the image: the check is not vacuous
    assert not torch.equal(images[len(FRAMES)], images[len(FRAMES) + 1])
    reads = sorted({op[0] for op in records[0] if op[0] in HOST_READS})
    assert not reads, f"the frame reads the device: {reads}"


def test_kernel_arguments_are_the_same_for_every_frame():
    """One record, two frame indices written into it: the argument structs
    do not change, pointers included."""
    record = frame_record(7, "cpu")
    frame = FrameValue(record)
    seed = frame * 4 + 3
    scene = SceneCtx.create(preset("full"), torch.zeros(3))

    def structs():
        return (bytes(bvh_cuda.bounce_args(frame, seed)[0]),
                bytes(bvh_cuda.ao_args(preset("full"), frame)[0]),
                bytes(an_cuda.scene_args(scene, seed * 131 + 17, frame)[0]),
                bytes(an_cuda.scene_args(scene, seed, frame)[0]))
    first = structs()
    record.copy_(frame_record(2 ** 20 + 5, "cpu"))
    assert structs() == first
    # another seed differs: the check above is not vacuous
    assert bytes(bvh_cuda.bounce_args(frame, seed + 1)[0]) != first[0]
    # a frame reaches a kernel as a FrameValue, never by value
    for args in ((7, 7 * 4 + 3), (frame, 31)):
        with pytest.raises(TypeError, match="FrameValue"):
            bvh_cuda.bounce_args(*args)


def test_device_ld2_is_the_host_ld2():
    """JAX's device Halton (a fixed number of float32 steps under `where`)
    against the host loop, bit for bit, for frames 0..4096 and large ones,
    int32's last included (i + 1 wraps to a negative index: 0, as in
    JAX)."""
    idx = np.concatenate([np.arange(4097), [2 ** 20 + 5, 12345678,
                                            2 ** 31 - 2, 2 ** 31 - 1]])
    dev = ld2(torch.from_numpy(idx.astype(np.int32)))
    for k, (x, y) in enumerate(zip(*(d.numpy() for d in dev))):
        assert (float(x), float(y)) == ld2(int(idx[k])), int(idx[k])
    assert ld2(2 ** 31 - 1) == (0.0, 0.0)
    for i in (0, 5, 4095, 2 ** 20 + 5):
        for b in (2, 3):
            assert float(halton(torch.tensor(i, dtype=torch.int32), b)) \
                == halton(i, b)


def _int32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


@pytest.mark.parametrize("index", [0, 1, 7, 1663, 2 ** 20 + 5, 2 ** 31 - 1])
def test_device_frame_values_are_the_host_ints(index):
    """A FrameValue index * a + b is the host's int32 arithmetic: its bits
    times a multiplier, float32 of it, and rand of it as the 0-d int32
    tensor of the host value and as the scalar oracle give them."""
    px, py = pixel_centers(H, W, "cpu", 517)
    frame = FrameValue(frame_record(index, "cpu"))
    for a, b in ((1, 0), (4, 3), (4 * 131, 3 * 131 + 17), (19, 0)):
        host = _int32(index * a + b)
        dev = frame * a + b
        assert int(_frame_bits(dev, 1663)) == (host * 1663) & 0xFFFFFFFF
        assert float(frame_f32(dev * 19)) == float(np.float32(
            _int32(host * 19)))
        got = rand(px, py, dev)
        t = torch.tensor(host, dtype=torch.int32)
        assert torch.equal(got, rand(px, py, t))
        for i, j in ((0, 0), (5, 17), (H - 1, W - 1)):
            assert float(got[i, j]) == np.float32(ref.rand(
                float(px[i, j]), float(py[i, j]), host))


@pytest.mark.parametrize("index", [0, 1, 7, 8, 31, 32])
@pytest.mark.parametrize("moved", [False, None])
def test_taa_device_selects_are_the_host_branch(index, moved):
    """TAA's still weights and first frame, selected on the device, are the
    float32 constants of the host rule (min below frame 8, avg below 32,
    max after; no history at frame 0); the still path blends with them bit
    for bit, in place too, and the branch-free form is JAX's within
    test_torch_temporal.py's 1e-6."""
    jparams = jpreset("full")
    params = params_from(jparams)
    rng = np.random.RandomState(index)
    curr = torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    motion = torch.from_numpy(rng.uniform(-0.02, 0.02, (H, W, 2)).astype(
        np.float32))
    if moved is False:
        motion = torch.zeros_like(motion)
    hist = _history(index + 1)
    frame = FrameValue(frame_record(index, "cpu"))
    w = f32(params.taa_history_min_weight if index < 8 else
            params.taa_history_avg_weight if index < 32 else
            params.taa_history_max_weight)
    got_w, got_wc, first = _still_weights(frame, params)
    assert (float(got_w), float(got_wc), bool(first)) \
        == (w, f32(1.0 - w), index == 0)
    got = resolve_taa(curr, motion, hist, frame, params, moved=moved)
    lum = luminance(curr, YCOEFF)
    l2 = lum * lum
    if index == 0:
        assert torch.equal(got, torch.cat([curr, l2[..., None]], dim=-1))
    elif moved is False:
        want = torch.cat([hist[..., :3] * w + curr * f32(1.0 - w),
                          (hist[..., 3] * w + l2 * f32(1.0 - w))[..., None]],
                         dim=-1)
        assert torch.equal(got, want)
    else:
        want = jtaa.resolve_taa(jnp.asarray(curr.numpy()),
                                jnp.asarray(motion.numpy()),
                                jnp.asarray(hist.numpy()), jnp.int32(index),
                                jparams)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # written into the history itself, as render_frame does
    buf = hist.clone()
    assert resolve_taa(curr, motion, buf, frame, params, moved=moved,
                       out=buf) is buf
    assert torch.equal(buf, got)


# ---- parity with JAX ----

def _jfin(fin):
    return JFrameInputs(**{k: jnp.asarray(getattr(fin, k).numpy())
                           for k in frame_block.INPUT_FIELDS})


@pytest.mark.parametrize("use_bvh", [True, False])
def test_frame_matches_jax_at_frame_indices(use_bvh, tris):
    """From the same history at each frame index: the BVH and the analytic
    scene with GI, AO and TAA (the frame's every RNG site: the direct
    light's seeds and cp_offset, GI's offsets, the mirror GI's
    seed * 131 + 17, AO, TAA's weights and first frame)."""
    jparams = jpreset("full").replace(enable_svgf=0)
    params = params_from(jparams)
    jbvh = bvh = None
    if use_bvh:
        jbvh = jprepare_bvh(tris)
        bvh = bvh_from_numpy(BVHArrays(*(np.asarray(x)
                                         for x in jbvh.arrays)), "cpu")
    jrender = jax.jit(functools.partial(jrender_frame, height=H, width=W,
                                        use_bvh=use_bvh))
    for k, index in enumerate(PARITY_FRAMES):
        moving = k % 2 == 1
        fin = _fin(k, 0, moving)
        hist = _history(k + 11)
        jstate, jout = jrender(jparams, _jfin(fin),
                               JRenderState(jnp.asarray(hist.numpy()),
                                            jnp.int32(index)),
                               None, jbvh)
        state, out = render_frame(params, fin, RenderState(hist.clone(),
                                                           index),
                                  None, bvh, height=H, width=W,
                                  use_bvh=use_bvh)
        assert state.frame_index == int(jstate.frame_index) == index + 1
        for name in ("image", "motion", "gpos", "gnrm"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} at {index}")
        np.testing.assert_allclose(state.accum.numpy(),
                                   np.asarray(jstate.accum), rtol=1e-4,
                                   atol=1e-4, err_msg=f"accum at {index}")


# ---- the graph key ----

def test_graph_key_holds_the_configuration_not_the_frame(tris):
    bvh = prepare_bvh(tris, "cpu")
    params = preset("full")

    def key(fin, p=params, **kw):
        args = dict(device="cuda", height=H, width=W, use_bvh=True,
                    show_motion=False, want_u8=False)
        args.update(kw)
        return graph_key(p, fin, None, bvh, **args)

    base = key(_fin(0, 0, False))
    assert key(_fin(5, 2 ** 20 + 5, False)) == base  # index, camera
    assert key(_fin(1, 3, False).at_frame(9)) == base
    # data fields: their values reach the frame through the parameter
    # block, not the key (a slider move or an orbit step replays)
    for p in (params.replace(exposure=2.0),
              params.replace(sun_yaw=params.sun_yaw + 1.0),
              params.replace(taa_still_thresh=2e-5),
              params.replace(**seeded_values(7))):
        assert key(_fin(0, 0, False), p) == base
    # every static field, and the outcome of the host's branch on
    # taa_still_thresh
    for name in STATIC_FIELDS:
        value = getattr(params, name)
        p = params.replace(**{name: value + 1 if name != "ordered_primary"
                              else (value + 1) % 3})
        assert key(_fin(0, 0, False), p) != base, name
    assert key(_fin(0, 0, False), params.replace(spp_per_frame=2)) != base
    assert key(_fin(0, 0, False), params.replace(taa_still_thresh=0.0)) \
        != base
    assert key(_fin(0, 0, True)) != base  # the host flag moved
    assert key(dataclasses.replace(_fin(0, 0, False), moved=None)) != base
    for kw in (dict(want_u8=True), dict(show_motion=True),
               dict(height=H + 1), dict(use_bvh=False)):
        assert key(_fin(0, 0, False), **kw) != base
    other = prepare_bvh(tris, "cpu")
    assert graph_key(params, _fin(0, 0, False), None, other, device="cuda",
                     height=H, width=W, use_bvh=True, show_motion=False,
                     want_u8=False) != base


def test_frame_inputs_are_views_of_one_block():
    fin = _fin(2, 41, True)
    assert fin.frame_index == 41 and int(fin.frame.index) == 41
    words = fin.block.numpy()
    assert words[0] == 41
    assert tuple(words[1:3].view(np.float32)) == ld2(41)
    assert int(fin.camera_moved) == 1 and fin.moved is True
    # every field is its view of the block: a write to the block shows
    for name in frame_block.INPUT_FIELDS:
        at, shape = frame_block.FIELDS[name]
        field = getattr(fin, name)
        assert tuple(field.shape) == shape
        assert field.data_ptr() == fin.block.data_ptr() + 4 * at, name
    staged = FrameInputs.stage(fin.words, "cpu", fin.moved)
    staged.block[17:19] = torch.tensor([0.25, -0.5]).view(torch.int32)
    assert staged.jitter.tolist() == [0.25, -0.5]
    again = fin.at_frame(42)
    assert int(again.frame.index) == 42 and again.block is not fin.block
    assert torch.equal(again.cam_pos, fin.cam_pos)
    assert fin.at_frame(41) is fin
    unknown = dataclasses.replace(fin, moved=None)
    assert unknown.moved is None and unknown.block is fin.block
    assert torch.equal(unknown.prev_view_proj, fin.prev_view_proj)
    with pytest.raises(ValueError, match="host words"):
        FrameInputs(fin.block).at_frame(3)
    staged = FrameInputs.stage(frame_block.at_frame(fin.words, 5), "cpu",
                               fin.moved)
    assert torch.equal(staged.prev_view_proj, fin.prev_view_proj)
    assert frame_inputs_from_numpy(fin, "cpu", 41).words.tolist() \
        == fin.words.tolist()


def test_a_live_state_keeps_its_static_accumulation():
    """Two live states of one size rendered in turns each get a static
    accumulation of their own (the graph's `_slot`; the card renders with
    them in tests/test_torch_cuda.py); a state's chain keeps its slot, a
    fresh state's history is copied in, and a slot whose state is gone is
    given to the next fresh state."""
    graph.clear()
    a0, b0 = (RenderState(_history(s), 0) for s in (1, 2))
    slot_a = graph._slot(a0, H, W)
    assert torch.equal(slot_a.accum, a0.accum)
    assert slot_a.accum.data_ptr() != a0.accum.data_ptr()
    a1 = RenderState(slot_a.accum, 1)
    slot_a.owner = weakref.ref(a1)  # as render() sets it
    slot_b = graph._slot(b0, H, W)  # a1 lives: b0 gets its own
    assert slot_b is not slot_a and torch.equal(slot_b.accum, b0.accum)
    assert torch.equal(slot_a.accum, a0.accum)  # a's history kept
    b1 = RenderState(slot_b.accum, 1)
    slot_b.owner = weakref.ref(b1)
    assert graph._slot(a1, H, W) is slot_a
    assert graph._slot(b1, H, W) is slot_b
    del a1
    c0 = RenderState(_history(3), 0)
    assert graph._slot(c0, H, W) is slot_a  # a's state is gone
    assert torch.equal(slot_a.accum, c0.accum)
    assert torch.equal(slot_b.accum, b0.accum)
    other = graph._slot(RenderState(_history(4)[:, :-1].contiguous(), 0),
                        H, W - 1)  # another size
    assert other is not slot_a and other is not slot_b
    graph.clear()
