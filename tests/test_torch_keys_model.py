"""A plain Python model of A's key selection (`super_keys`,
csrc/sorted.cu) on the CPU: from the supers a ray enters, a word of 32 at
a time (bit b: super w0 + b), to the E keys (each word's entered supers
fill the free slots in ascending order, `__fns`; a ray stops once it has
entered more than E; the last slot the E-th entered super or the
overflow tail) and the key histogram. Held exactly to
`pipeline.super_rank` over seeded rays and boxes whose pruning bounds
are set so that lanes enter no super, fewer than E-1, E-1, exactly E,
E+1 and more: E in 1..8, 1 to 300 supernodes (a word -1 / 0 / +1, the
repo's 50 and 68, three words, and past the kernel's 256 staged at a
time)."""

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe

MAX_E = tpipe.PLACE_MAX_E  # csrc/sorted.cu kPlacePer: A's most keys a lane
N_LANES = 400


def slabs(q, boxes):
    """(te, hit), each (n, S): the entry t = max(tmin, 0) and whether
    tmax >= tmin and tmax > 0, by `super_rank`'s own expression
    ((lo - o) * inv_d)."""
    qox, qoy, qoz, qdx, qdy, qdz = q
    idx_, idy_, idz_ = 1.0 / qdx, 1.0 / qdy, 1.0 / qdz
    te, hit = [], []
    for row in boxes:
        t1x, t2x = (row[0] - qox) * idx_, (row[3] - qox) * idx_
        t1y, t2y = (row[1] - qoy) * idy_, (row[4] - qoy) * idy_
        t1z, t2z = (row[2] - qoz) * idz_, (row[5] - qoz) * idz_
        tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                             torch.minimum(t1z, t2z))
        tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                             torch.maximum(t1z, t2z))
        te.append(torch.clamp(tmin, min=0.0))
        hit.append((tmax >= tmin) & (tmax > 0))
    return torch.stack(te, 1), torch.stack(hit, 1)


def entered(q, bt, boxes):
    """(n, S) bool: lane j enters super s (te < bt, strict)."""
    te, hit = slabs(q, boxes)
    return (hit & (te < bt[:, None])).numpy()


def nth_set(word, r):
    """The bit index of the r-th (from 1) set bit of each word (`__fns`)."""
    bits = (word[:, None] >> np.arange(32, dtype=np.uint64)[None, :]) & np.uint64(1)
    return np.argmax(np.cumsum(bits, axis=1) == np.asarray(r)[:, None], axis=1)


def model_keys(mask, E):
    """A's keys (E, n) and histogram (2 S,) from the entered mask, as the
    kernel selects them: per word, c = popcount; slot e (e < E) takes the
    word's (e - cnt)-th entered super while 0 <= e - cnt < c; cnt += c; a
    lane stops after the word that takes cnt past E."""
    n, S = mask.shape
    dead = 2 * S
    key = np.full((MAX_E, n), dead, np.int64)
    cnt = np.zeros(n, np.int64)
    going = np.ones(n, bool)
    for w0 in range(0, S, 32):
        bits = mask[:, w0:w0 + 32].astype(np.uint64)
        word = (bits << np.arange(bits.shape[1], dtype=np.uint64)).sum(1).astype(np.uint64)
        word[~going] = 0
        c = np.array([bin(int(w)).count("1") for w in word], np.int64)
        for e in range(min(E, MAX_E)):
            rank = e - cnt
            take = (c > 0) & (cnt < E) & (rank >= 0) & (rank < c)
            if take.any():
                key[e, take] = w0 + nth_set(word[take], rank[take] + 1)
        cnt += c
        going &= cnt <= E
    last = key[E - 1].copy()
    over = cnt > E
    if E == 1:
        last[over] = S + key[0, over]
    else:
        last[over] = S + key[E - 2, over] + 1
    keys = np.concatenate([key[:E - 1], last[None]], 0)
    real = keys[keys < dead]
    return keys, np.bincount(real, minlength=dead)


def lanes_and_boxes(S, E, seed):
    """Seeded supernode boxes (S, 8) and rays q (6 x (n,)) from outside
    them, each ray's bound bt placed between the te of its k-th and
    (k+1)-th entered box, k cycling over 0, E-2, E-1, E, E+1, E+3 and all
    of them (clipped to what the ray enters)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, (S, 3))
    half = rng.uniform(0.15, 0.7, (S, 3))
    boxes = np.concatenate([centre - half, centre + half, np.zeros((S, 2))], 1)
    boxes = torch.tensor(boxes, dtype=torch.float32)
    o = rng.normal(size=(N_LANES, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (N_LANES, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = tuple(torch.tensor(a, dtype=torch.float32) for a in (*o.T, *d.T))
    te, hits = (a.numpy() for a in slabs(q, boxes))
    targets = [0, E - 2, E - 1, E, E + 1, E + 3, S]
    bt = np.full(N_LANES, tpipe.FLT_MAX, np.float32)
    for j in range(N_LANES):
        ts = np.sort(te[j, hits[j]])
        k = max(targets[j % len(targets)], 0)
        if k < ts.size:
            bt[j] = ts[k]  # te < bt strict: exactly the k nearer boxes (no ties)
    return q, torch.tensor(bt), boxes


@pytest.mark.parametrize("n_supers", [1, 31, 32, 33, 50, 64, 68, 96, 300])
@pytest.mark.parametrize("E", range(1, MAX_E + 1))
def test_key_model_equals_super_rank(E, n_supers):
    q, bt, boxes = lanes_and_boxes(n_supers, E, seed=100 * E + n_supers)
    mask = entered(q, bt, boxes)
    n_in = mask.sum(1)
    # the lanes the cases need, as far as n_supers allows
    assert (n_in == 0).any() and (n_in == min(E, n_supers)).any()
    if E >= 3:
        assert ((n_in > 0) & (n_in < E - 1)).any()
    if n_supers > E:
        assert (n_in == E + 1).any() and (n_in > E + 1).any()
    keys, hist = model_keys(mask, E)
    want = tpipe.super_rank(q, bt, boxes, E).numpy()
    np.testing.assert_array_equal(keys, want)
    real = want[want < 2 * n_supers]
    np.testing.assert_array_equal(hist, np.bincount(real, minlength=2 * n_supers))
