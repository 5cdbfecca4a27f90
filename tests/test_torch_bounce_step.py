"""Kernel #3's wrapper (its plain version, `bounce_step_reference`, on
CPU tensors) against the JAX package's `bounce_step_pallas` in interpret
mode, from the same 32x32 pool: one bounce (atol 1e-4, at most 1% outlier
lanes) and three bounces on a pool compacted before each bounce and
passed its live count (atol 3e-4, at most 3%); pix exact. Also the
wrapper's in-place contract and its skip of lanes past `num_alive`, and
one bounce of a sparse pool (half the lanes killed in scattered runs) by
the lane rule with every dead lane back unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from tests.test_torch_ops import assert_state_close, both_cameras, both_scenes


def to_jax(state):
    """A port pool -> the JAX package's state tuple (bool alive)."""
    vec = lambda v: JVec3(*(jnp.asarray(c.numpy()) for c in v))
    return (vec(state[0]), vec(state[1]), vec(state[2]), vec(state[3]),
            jnp.asarray(state[4].numpy() != 0), jnp.asarray(state[5].numpy()))


def by_pix(state):
    """Lanes reordered by pixel id (undoes compaction's permutation)."""
    order = np.argsort(np.asarray(state[5]))
    pick = lambda a: np.asarray(a)[order]
    return tuple(
        tuple(pick(c) for c in s) if i < 4 else pick(s)
        for i, s in enumerate(state)
    )


def start(name, settings_kw, iteration):
    jd, td = both_scenes(name)
    _, tc = both_cameras(name)
    tset = trender.RenderSettings(trace_depth=8, **settings_kw)
    jset = jrender.RenderSettings(trace_depth=8, use_bvh=False,
                                  use_pallas=True, **settings_kw)
    pool = tmk.first_bounce(td, tc, iteration, tset)
    return jd, td, jset, tset, pool


@pytest.mark.parametrize("name,settings_kw", [
    ("cornell.txt", {"antialias": True}),
    ("checker.txt", {}),
])
def test_one_bounce_matches_pallas(name, settings_kw):
    jd, td, jset, tset, pool = start(name, settings_kw, 4)
    want = jmk.bounce_step_pallas(to_jax(pool), jd, jnp.int32(4),
                                  jnp.int32(1), jset, interpret=True)
    lanes = tmk.pool_lanes(pool)
    launches = tmk.bounce_step.launches
    got = tmk.bounce_step(pool, td, 4, 1, tset)
    assert tmk.bounce_step.launches == launches  # CPU: no kernel launch
    # in place: the same lane tensors come back, holding the new state
    assert all(a is b for a, b in zip(tmk.pool_lanes(got), lanes))
    assert_state_close(got, want)


def test_three_compacted_bounces_with_num_alive_match_pallas():
    """cornell_glass + RR from depth 1: compaction before each bounce and
    the live count passed as num_alive to both kernels."""
    kw = {"russian_roulette": True, "rr_start_depth": 1, "compact": True}
    jd, td, jset, tset, pool = start("cornell_glass.txt", kw, 2)
    jstate = to_jax(pool)
    for depth in (1, 2, 3):
        jstate = jrender._maybe_compact(jstate, jset)
        pool = trender._maybe_compact(pool, tset)
        n_alive = trender._count_alive(pool)
        assert abs(int(n_alive) - int(jnp.sum(jstate[4]))) <= 0.01 * 1024
        # live lanes first
        alive = pool[4].numpy()
        assert alive[:int(n_alive)].all() and not alive[int(n_alive):].any()
        jstate = jmk.bounce_step_pallas(
            jstate, jd, jnp.int32(2), jnp.int32(depth), jset,
            interpret=True, num_alive=jnp.sum(jstate[4]),
        )
        pool = tmk.bounce_step(pool, td, 2, depth, tset, num_alive=n_alive)
    assert_state_close(by_pix(pool), by_pix(jstate), atol=3e-4,
                       outlier_frac=0.03)


def test_lanes_past_num_alive_are_left_as_they_are():
    _, td, _, tset, pool = start("cornell.txt", {}, 1)
    before = [a.clone() for a in tmk.pool_lanes(pool)]
    cut = 300
    assert pool[4][cut:].sum() > 0  # live lanes past the cut exist
    tmk.bounce_step(pool, td, 1, 1, tset,
                    num_alive=torch.tensor(cut, dtype=torch.int32))
    after = tmk.pool_lanes(pool)
    for a, b in zip(after, before):
        torch.testing.assert_close(a[cut:], b[cut:], rtol=0, atol=0)
    # and the lanes before it did bounce
    assert not torch.equal(after[0][:cut], before[0][:cut])


def test_sparse_pool_matches_pallas_and_keeps_dead_lanes():
    """Half of the 32x32 pool's lanes killed in runs of 1-24 (numpy,
    seeded), as a thin pool reaches #3: one bounce against the Pallas
    kernel by the lane rule, pix exact, and each lane dead on entry back
    unchanged, bit for bit."""
    jd, td, jset, tset, pool = start("cornell.txt", {"antialias": True}, 4)
    rng = np.random.default_rng(12)
    P = pool[4].shape[0]
    kill = np.zeros(P, bool)
    i, dead_run = 0, bool(rng.integers(0, 2))
    while i < P:
        run = int(rng.integers(1, 25))
        kill[i:i + run] = dead_run
        i, dead_run = i + run, not dead_run
    pool[4][torch.from_numpy(kill)] = 0
    dead = (pool[4] == 0).numpy()
    assert 0.4 < kill.mean() < 0.6 and dead.any() and not dead.all()
    before = [a.clone() for a in tmk.pool_lanes(pool)]
    want = jmk.bounce_step_pallas(to_jax(pool), jd, jnp.int32(4), jnp.int32(1), jset,
                                  interpret=True)
    got = tmk.bounce_step(pool, td, 4, 1, tset)
    assert_state_close(got, want)
    for a, b in zip(tmk.pool_lanes(got), before):
        assert torch.equal(a[dead].view(torch.int32), b[dead].view(torch.int32))
