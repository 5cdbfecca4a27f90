"""A plain Python model of #3's packing (`bounce_step`, csrc/bounce.cu)
on the CPU: a block of THREADS threads owns THREADS consecutive lanes,
reads their alive flags below the live count (the pool size, or
`num_alive`); a block whose first lane is at or past the count returns
whole, a block whose lanes are all live bounces them in place, and any
other packs its live lanes into its first threads with warp ballots and
the warps' counts (`block_prefix`). Held to numpy: every live lane below
min(n, num_alive) goes to exactly one thread, a block's threads take its
lanes in lane order, the threads that bounce are the block's first, and
no lane at or past the count, nor a dead one, is taken; on random and
clustered alive masks at 0%, 3%, 50% and 100% live, with and without a
count that cuts the pool, for blocks of the committed size and of the
variants' 256 and 512."""

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk

P = 3 * 1024 + 77  # not a multiple of a block's lanes


def block_prefix(keep):
    """(positions, kept) of `keep` (threads,) bool: each thread's place
    among the kept ones (the ballot of its warp below its lane plus the
    counts of the warps before), and their number."""
    warps = keep.reshape(-1, 32)
    counts = warps.sum(1)
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    below = np.cumsum(warps, 1) - warps  # popc(ballot & lanes below)
    return (before[:, None] + below).reshape(-1), int(counts.sum())


def model_pack(alive, num_alive, threads):
    """{(block, thread): the lane it bounces}."""
    n = alive.shape[0]
    end = n if num_alive is None else min(n, num_alive)
    taken = {}
    for b in range(-(-n // threads)):
        first = b * threads
        if first >= end:
            continue  # the whole block returns
        i = first + np.arange(threads)
        live = (i < end) & (alive[np.minimum(i, n - 1)] != 0)
        if live.all():  # __syncthreads_count: every lane in place
            taken.update({(b, t): int(i[t]) for t in range(threads)})
            continue
        at, kept = block_prefix(live)
        slots = np.full(threads, -1)
        slots[at[live]] = i[live]
        taken.update({(b, t): int(slots[t]) for t in range(kept)})
    return taken


def alive_mask(share, pattern, seed):
    """(P,) int32: each lane live with probability `share` ("random"), or
    runs of live lanes (1-40 long) between runs of dead ones whose mean
    length keeps the share ("clustered")."""
    rng = np.random.default_rng(seed)
    if pattern == "random" or share in (0.0, 1.0):
        return (rng.random(P) < share).astype(np.int32)
    out = np.zeros(P, np.int32)
    i = int(rng.integers(0, 100))
    while i < P:
        live = int(rng.integers(1, 41))
        out[i:i + live] = 1
        i += live + int(live * (1 - share) / share * rng.uniform(0.5, 1.5)) + 1
    return out


@pytest.mark.parametrize("threads", sorted({tmk.BOUNCE_THREADS, 256, 512}))
@pytest.mark.parametrize("cut", [None, 1900])
@pytest.mark.parametrize("pattern", ["random", "clustered"])
@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
def test_pack_model_takes_each_live_lane_once(share, pattern, cut, threads):
    alive = alive_mask(share, pattern, seed=int(1000 * share) + len(pattern))
    taken = model_pack(alive, cut, threads)
    got = list(taken.values())
    end = P if cut is None else cut
    want = np.flatnonzero(alive[:end])
    assert sorted(got) == want.tolist()  # each live lane below the count, once
    assert len(got) == len(set(got))
    for b in {b for b, _ in taken}:
        busy = sorted(t for bb, t in taken if bb == b)
        assert busy == list(range(len(busy)))  # the block's first threads
        lanes = [taken[(b, t)] for t in busy]
        assert lanes == sorted(lanes)  # in lane order
        assert all(b * threads <= i < (b + 1) * threads for i in lanes)
