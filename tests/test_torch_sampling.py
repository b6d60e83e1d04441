"""The port's RNG and sampling helpers against the JAX package's.

The integer hash feeds the soft-shadow noise, so `hash2`, `rand`,
`cp_offset` and the Halton points must match bit for bit: the port's
int64-with-mask arithmetic has to give the uint32 results exactly.  The
helpers that call a transcendental (cos, sin) or a matmul are held to a
few float32 ulps instead, since XLA's CPU kernels and PyTorch's round
those differently in the last bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import reference_oracle as ref
from opengl_raytracing_tpu import sampling as js
from opengl_raytracing_tpu_torch import sampling as ts

torch.set_num_threads(2)

M32 = 0xFFFFFFFF


def _pixels(seed, n=4096, hi=2000.0):
    rng = np.random.RandomState(seed)
    px = (np.floor(rng.uniform(0, hi, n)) + 0.5).astype(np.float32)
    py = (np.floor(rng.uniform(0, hi, n)) + 0.5).astype(np.float32)
    # offsets as the disk sampler adds them, and negative inputs (clamped)
    px[:64] += np.float32(31 * 3 + 7)
    py[64:80] = -3.5
    return px, py


def test_hash2_bit_exact():
    rng = np.random.RandomState(0)
    vx = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64)
    vy = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64)
    vx[:4] = [0, M32, 1, 2 ** 31]
    vy[:4] = [M32, 0, 2 ** 31, 1]
    got = ts.hash2(torch.from_numpy(vx.astype(np.int64)),
                   torch.from_numpy(vy.astype(np.int64))).numpy()
    want = np.asarray(js.hash2(jnp.asarray(vx.astype(np.uint32)),
                               jnp.asarray(vy.astype(np.uint32))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for i in range(8):
        assert got[i] == ref.hash2(int(vx[i]), int(vy[i]))


@pytest.mark.parametrize("frame", [0, 1, 7, 1023, 2_000_000, 2 ** 31 - 1])
def test_rand_bit_exact(frame):
    px, py = _pixels(frame % 97)
    got = ts.rand(torch.from_numpy(px), torch.from_numpy(py),
                  ts.FrameValue.of(frame, "cpu")).numpy()
    want = np.asarray(js.rand(jnp.asarray(px), jnp.asarray(py),
                              jnp.int32(frame)))
    np.testing.assert_array_equal(got, want)
    for i in range(0, 4096, 512):
        assert got[i] == np.float32(ref.rand(max(px[i], 0.0),
                                             max(py[i], 0.0), frame))


@pytest.mark.parametrize("frame", [0, 3, 1000, 123457])
def test_cp_offset_and_ld2_exact(frame):
    px, py = _pixels(frame)
    got = ts.cp_offset(torch.from_numpy(px), torch.from_numpy(py),
                       ts.FrameValue.of(frame, "cpu"))
    want = js.cp_offset(jnp.asarray(px), jnp.asarray(py), jnp.int32(frame))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lx, ly = ts.ld2(frame)
    jx, jy = js.ld2(jnp.int32(frame))
    assert np.float32(lx) == np.asarray(jx)
    assert np.float32(ly) == np.asarray(jy)


def test_eps_for_dist_exact():
    d = np.geomspace(1e-6, 1e4, 999).astype(np.float32)
    np.testing.assert_array_equal(ts.eps_for_dist(torch.from_numpy(d)).numpy(),
                                  np.asarray(js.eps_for_dist(jnp.asarray(d))))


def test_concentric_sample_close():
    """cos/sin of two libraries: within 2 float32 ulps of the unit disk."""
    rng = np.random.RandomState(3)
    u = rng.rand(2, 4096).astype(np.float32)
    u[:, :3] = [[0.5, 0.5, 0.25], [0.5, 0.75, 0.5]]
    got = ts.concentric_sample(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    want = js.concentric_sample(jnp.asarray(u[0]), jnp.asarray(u[1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2.5e-7)


def test_ndc_from_world_close():
    """A float32 matmul summed in another order: within 1e-6 relative."""
    rng = np.random.RandomState(4)
    p = rng.uniform(-5, 5, (64, 48, 3)).astype(np.float32)
    vp = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    vp[3] = [0.1, 0.2, -0.9, 8.0]
    got = ts.ndc_from_world(torch.from_numpy(p), torch.from_numpy(vp))
    want = js.ndc_from_world(jnp.asarray(p), jnp.asarray(vp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
