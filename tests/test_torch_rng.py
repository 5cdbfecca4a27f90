"""The port's counter-based RNG against the JAX package's `ops/rng.py`:
identical seeded uint32 inputs through both, and the results must be
EXACTLY equal (the render's noise pattern is part of its contract)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.ops import rng as jrng
from project3_cuda_path_tracer_tpu_torch.ops import rng as trng

EDGES = [0, 1, 2**31 - 2, 2**32 - 1]


def _indices(n=4096, seed=0):
    r = np.random.default_rng(seed)
    vals = r.integers(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([vals, np.asarray(EDGES, np.uint64)]).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a.astype(np.int64))


def _j(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def test_utilhash_exact():
    idx = _indices()
    np.testing.assert_array_equal(
        trng.utilhash(_t(idx)).numpy(), _j(jrng.utilhash(jnp.asarray(idx)))
    )


@pytest.mark.parametrize(
    "iteration,depth",
    [(1, 0), (2, 7), (5000, 3), (17, trng.RAYGEN_STREAM), (2**31 - 1, 0),
     (2**32 - 1, 2**10 - 1)],
)
def test_make_seeded_state_exact(iteration, depth):
    idx = _indices(seed=iteration % 1000)
    want = np.asarray(
        jrng.make_seeded_state(
            jnp.uint32(iteration), jnp.asarray(idx), jnp.uint32(depth)
        )
    ).astype(np.int64)
    got = trng.make_seeded_state(iteration, _t(idx), depth).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() <= 2**31 - 2


def test_lcg_next_exact():
    r = np.random.default_rng(1)
    states = np.concatenate(
        [r.integers(1, 2**31 - 1, 4096), [1, 2, 2**31 - 2]]
    ).astype(np.int32)
    want = np.asarray(jrng.lcg_next(jnp.asarray(states))).astype(np.int64)
    got = trng.lcg_next(_t(states)).numpy()
    np.testing.assert_array_equal(got, want)
    # the uint32 split-and-fold agrees bit for bit on the edge words too
    edges = np.asarray(EDGES, np.uint32)
    want_e = np.asarray(jrng.lcg_next(jnp.asarray(edges))).astype(np.int64)
    np.testing.assert_array_equal(trng.lcg_next(_t(edges)).numpy(), want_e)


@pytest.mark.parametrize("n", [2, 5])
def test_uniforms_exact(n):
    idx = _indices(seed=n)
    want = jrng.uniforms(jnp.int32(9), jnp.asarray(idx), jnp.int32(4), n)
    got = trng.uniforms(9, _t(idx), 4, n)
    assert len(got) == n
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.min() >= 0.0 and g.max() < 1.0
