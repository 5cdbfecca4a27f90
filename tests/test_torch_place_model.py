"""Plain Python models of two kernels' parallel bookkeeping, on the CPU:
B (`place_entries`, csrc/sorted.cu) as tiles of listed lanes whose
per-key reservations on the cursors interleave in a shuffled order, and
#7's block append (`mesh_candidates`, csrc/mesh.cu) with blocks
reserving their runs of the list in a shuffled order. B's model is held
to `place_entries_reference` per key (the order within a key is the
reservations'), with its total exact, on synthetic keys made from a
numpy seed: count 0 and 1, a tile's lanes -1 / 0 / +1, every entry one
key, only dead keys, E = 1 and E = 6, 2 x 6,144 bins, and a second run
on the cursors the first one left. #7's model gives exactly the flagged
lanes, each once, the lanes of each block in ascending order."""

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe

THREADS = tpipe.PLACE_THREADS  # csrc/sorted.cu kPlaceThreads
PER = tpipe.PLACE_MAX_E  # csrc/sorted.cu kPlacePer: entries a thread holds
CAND_LANES = 256  # csrc/mesh.cu kCandLanes: lanes a block of #7 owns


def tile_lanes(E: int) -> int:
    return THREADS * (PER // E)


def model_place(keys, n_listed, hist, cursor, rng):
    """B's places, modelled in Python: `keys` (E, P) A's slot-major keys,
    the first `n_listed` columns listed, `hist` their real keys' counts
    (bins = 2 x n_supers, the dead key), `cursor` (bins,) the cursors,
    updated in place. A tile is THREADS x (PER // E) lanes; thread t's
    entry i is slot i // (PER // E), lane tile * tile_lanes + t + (i % (PER
    // E)) x THREADS, id slot x P + lane. Its entries take ranks within
    their key in any order (the shared atomics': shuffled here), are
    staged in key order, and each key present reserves the tile's run in
    the key's window by one atomicAdd on its cursor; the reservations of
    all tiles and keys interleave in a shuffled order. An entry lands at
    start[key] + (the cursor's old value mod hist[key]) + its place in the
    tile's run. Returns (keys out, ids out, total), -1 where nothing was
    written; raises if two entries land on one place."""
    E, P = keys.shape
    bins = hist.shape[0]
    lanes = PER // E
    TL = tile_lanes(E)
    start = np.cumsum(hist) - hist
    total = int(hist.sum())
    out_key = np.full(E * P, -1, np.int64)
    out_id = np.full(E * P, -1, np.int64)
    i = np.arange(PER)
    slot, k = i // lanes, i % lanes
    runs = []  # (tile, key, the tile's keys and ids in key order, first place)
    for t in range(-(-n_listed // TL)):
        j = t * TL + np.arange(THREADS)[None, :] + k[:, None] * THREADS
        ok = (slot[:, None] < E) & (j < n_listed)
        key = np.where(ok, keys[np.minimum(slot, E - 1)[:, None], np.minimum(j, P - 1)],
                       bins)
        ids = slot[:, None] * P + j
        real = key < bins
        rk, rid = key[real], ids[real]
        perm = rng.permutation(rk.size)  # the ranks' order within a key
        rk, rid = rk[perm], rid[perm]
        order = np.argsort(rk, kind="stable")
        rk, rid = rk[order], rid[order]
        for b in np.unique(rk):
            first = int(np.searchsorted(rk, b))
            last = int(np.searchsorted(rk, b, side="right"))
            runs.append((b, rk[first:last], rid[first:last]))
    for r in rng.permutation(len(runs)):
        b, rk, rid = runs[r]
        old = int(cursor[b])
        cursor[b] += rk.size
        at = start[b] + old % hist[b] + np.arange(rk.size)
        if (out_key[at] != -1).any():
            raise AssertionError(f"two entries of key {b} on one place")
        out_key[at], out_id[at] = rk, rid
    return out_key, out_id, total


def synthetic_keys(E, P, n_listed, n_supers, kind, seed):
    """(E, P) int32 A-like keys made from a numpy seed: a window key (below
    n_supers) or a tail key (n_supers and up) or dead (2 x n_supers), by
    `kind`: "mixed" (about 40% dead), "one" (every real entry key 3),
    "dead" (no real entry). Columns past n_listed hold junk keys, which
    must not be placed."""
    rng = np.random.default_rng(seed)
    dead = 2 * n_supers
    keys = rng.integers(0, dead, (E, P))
    if kind == "one":
        keys[:] = min(3, dead - 1)
    keys[rng.uniform(size=(E, P)) < (1.0 if kind == "dead" else 0.4)] = dead
    keys[:, n_listed:] = rng.integers(0, dead + 1, (E, P - n_listed))
    return keys.astype(np.int32)


def reference_stream(keys, n_listed, n_supers):
    """`place_entries_reference`'s stream on the CPU, and A's histogram."""
    E, P = keys.shape
    dead = 2 * n_supers
    listed = keys[:, :n_listed]
    hist = np.bincount(listed[listed < dead], minlength=dead).astype(np.int32)
    sk = tpipe.SuperKeys(torch.from_numpy(keys), torch.zeros(6, P), torch.zeros(P),
                         torch.from_numpy(hist))
    st = tpipe.place_entries_reference(sk, torch.tensor([n_listed], dtype=torch.int32))
    return st, hist


def pairs(key, entry):
    """A stream's (key, id) pairs, sorted: the stream per key."""
    return np.sort(np.asarray(key, np.int64) * (1 << 32) + np.asarray(entry, np.int64))


def assert_place_per_key(keys, n_listed, n_supers, seed, runs=1):
    """The model over `runs` launches on one cursor: each run's stream a
    permutation of the reference's within each key, keys ascending, every
    place of [0, total) written, none past it."""
    st, hist = reference_stream(keys, n_listed, n_supers)
    m = int(st.total[0])
    cursor = np.zeros_like(hist, np.int64)
    rng = np.random.default_rng(seed)
    for _ in range(runs):
        key, ids, total = model_place(keys, n_listed, hist, cursor, rng)
        assert total == m
        assert (key[:m] >= 0).all() and (key[m:] == -1).all()
        assert (np.diff(key[:m]) >= 0).all()
        np.testing.assert_array_equal(key[:m], st.key[:m].numpy())
        np.testing.assert_array_equal(pairs(key[:m], ids[:m]),
                                      pairs(st.key[:m], st.entry[:m]))
    # a run adds exactly each key's count to its cursor
    np.testing.assert_array_equal(cursor, runs * hist.astype(np.int64))
    return m


@pytest.mark.parametrize("E,n_listed,kind,n_supers", [
    (6, 0, "mixed", 50),
    (6, 1, "mixed", 50),
    (6, tile_lanes(6) - 1, "mixed", 50),
    (6, tile_lanes(6), "mixed", 50),
    (6, tile_lanes(6) + 1, "mixed", 50),
    (1, tile_lanes(1) - 1, "mixed", 50),
    (1, tile_lanes(1), "mixed", 50),
    (1, tile_lanes(1) + 1, "mixed", 50),
    (6, 3 * tile_lanes(6) + 7, "one", 50),
    (6, 2 * tile_lanes(6) + 3, "dead", 50),
    (2, 2 * tile_lanes(2) + 5, "mixed", 6144),
])
def test_place_model_per_key(E, n_listed, kind, n_supers):
    """B's tiles with their reservations in a shuffled order place each
    key's entries in its window, per key the reference's stream."""
    P = max(n_listed + 37, 64)
    keys = synthetic_keys(E, P, n_listed, n_supers, kind, seed=E * 1000 + n_listed)
    m = assert_place_per_key(keys, n_listed, n_supers, seed=n_listed)
    if kind == "dead" or n_listed == 0:
        assert m == 0
    elif n_listed > 1:
        assert m > 0


@pytest.mark.parametrize("E", [6, 1])
def test_place_model_second_run(E):
    """B twice on one A output: the cursors the first run left (each key's
    count) give every key the same window again, by the modulo."""
    n_listed = 3 * tile_lanes(E) + 11
    keys = synthetic_keys(E, n_listed + 5, n_listed, 50, "mixed", seed=E)
    assert assert_place_per_key(keys, n_listed, 50, seed=7, runs=2) > 0


def model_candidates(alive, end, all_lanes, cand, rng):
    """#7's lanes and list, modelled in Python: block b owns lanes [b x
    CAND_LANES, +CAND_LANES); it sweeps, packed in lane order, the lanes
    below `end` that are live (every one under `all_lanes`); a swept live
    lane is a candidate iff `cand`; the block's candidates in lane order
    take one run of the list, the blocks reserving in a shuffled order.
    Returns (the swept lanes' mask, the list)."""
    n = alive.shape[0]
    swept = np.zeros(n, bool)
    blocks = []
    for first in range(0, min(n, end), CAND_LANES):
        lanes = np.arange(first, min(first + CAND_LANES, end))
        packed = lanes[alive[lanes] | all_lanes]
        swept[packed] = True
        blocks.append(packed[alive[packed] & cand[packed]])
    runs = [blocks[b] for b in rng.permutation(len(blocks))]
    return swept, np.concatenate(runs) if runs else np.zeros(0, np.int64)


@pytest.mark.parametrize("live,num_alive,all_lanes", [
    (0.9, None, False), (0.2, None, False), (0.0, None, False),
    (0.2, 1000, False), (0.2, None, True), (1.0, 129, False),
])
def test_candidates_model_lists_flagged_lanes(live, num_alive, all_lanes):
    """The list holds exactly the flagged lanes (live, below the live
    count, candidates), each once; a block's run ascends; the lanes swept
    are the live ones below the count, or every one under all_lanes. The
    plain version's mask (`_live_mask`) is the same set."""
    rng = np.random.default_rng(int(live * 10) + (num_alive or 0))
    n = 5000
    alive = rng.uniform(size=n) < live
    cand = rng.uniform(size=n) < 0.5
    end = n if num_alive is None else num_alive
    swept, lst = model_candidates(alive, end, all_lanes, cand, rng)
    below = np.arange(n) < end
    flagged = alive & cand & below
    assert lst.shape[0] == flagged.sum() == np.unique(lst).shape[0]
    assert set(lst.tolist()) == set(np.nonzero(flagged)[0].tolist())
    np.testing.assert_array_equal(swept, below & (alive | all_lanes))
    for first in range(0, n, CAND_LANES):
        run = lst[(lst >= first) & (lst < first + CAND_LANES)]
        assert (np.diff(run) > 0).all()
    live_mask = tpipe._live_mask(torch.from_numpy(alive.astype(np.int32)), n, "cpu",
                                 None if num_alive is None else torch.tensor(num_alive))
    np.testing.assert_array_equal(live_mask.numpy() & cand, flagged)
