"""The radix route of the big-mesh path (PT_TPU_SORT_RADIX=1) on the CPU:
the plain splits and the plain unsort (`radix_split_reference`,
`radix_unsplit_reference`) against numpy's stable argsort and its
inverse (one-bit and 8-bit digit passes, one and two passes, streams of
0, 1 and about one tile, the compaction split's ids and digit
histograms), the plain sort and unsort against the JAX package's
`_radix_sort_stream` / `_radix_unsort_stream` (#15-#17, Pallas in
interpret mode), a plain Python model of the kernel's tiles and
decoupled look-back, and the whole plain route on mesh.txt forced onto
the sorted route against the counting-sort route (B), entry for entry and
image for image. Every comparison here is exact: the radix moves 32-bit
words and computes no float."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from project3_cuda_path_tracer_tpu.ops import pipeline as jpipe
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.render import Renderer, RenderSettings
from tests.conftest import SCENES
from tests.test_torch_bigmesh_route import forced, plain_route  # noqa: F401
from tests.test_torch_mesh_intersect import MESH_GEOM, both_mesh_scenes, mesh_rays
from tests.test_torch_ops import tv

RADIX = ("radix_split", "radix_unscatter", "window_sweep_stream")
TILE = tpipe.RADIX_TILE


def stream_of(key, payload, m, bits):
    """A RadixStream of keys `key` (L,) and payload (k, L) at [0, m), the
    entry ids 0..L-1 and the digit histograms of `bits`-bit keys."""
    key = torch.tensor(key, dtype=torch.int32)
    length = torch.tensor([m], dtype=torch.int32)
    hist = torch.stack([tpipe.radix_digit_counts(key, length, b, w)
                        for b, w in tpipe.radix_passes(bits)])
    return tpipe.RadixStream(key, torch.tensor(payload), length,
                             torch.arange(key.shape[0], dtype=torch.int32), hist)


def lanes(h):
    """An Intersections' lanes."""
    return [h.t, *h.normal, h.material_id, h.outside, h.tex_u, h.tex_v, h.has_uv]


@pytest.mark.parametrize("bit", [0, 3, 6])
def test_split_pass_matches_stable_argsort(bit):
    """One binary pass (width 1 at shift `bit`) over the first m of L
    elements (keys up to the dead key 2 * 50, as on mesh_big): key, payload
    and carried ids exactly numpy's stable argsort by the key's bit, and
    the unscatter by id the exact inverse on [0, m). Exact."""
    rng = np.random.default_rng(bit)
    L, m = 1000, 777
    key = rng.integers(0, 101, L).astype(np.int32)
    payload = rng.standard_normal((3, L)).astype(np.float32)
    st = stream_of(key, payload, m, 7)
    sp = tpipe.RadixSplit(st.key, st.length, bit, width=1,
                          hist=tpipe.radix_digit_counts(st.key, st.length, bit, 1))
    assert sp.hist[:2].sum() == m and not sp.hist[2:].any()
    perm = np.argsort((key[:m] >> bit) & 1, kind="stable")
    got = tpipe.radix_split(sp, st.payload, st.entry)
    np.testing.assert_array_equal(got.key[:m].numpy(), key[:m][perm])
    np.testing.assert_array_equal(got.payload[:, :m].numpy(), payload[:, :m][:, perm])
    np.testing.assert_array_equal(got.entry[:m].numpy(), perm)
    assert got.length is st.length and got.hist is None
    back = tpipe.radix_unscatter(got, got.payload)
    np.testing.assert_array_equal(back[:, :m].numpy(), payload[:, :m])


@pytest.mark.parametrize("n_supers", [1, 5, 50, 300, 6144])
def test_sort_stream_matches_stable_argsort(n_supers):
    """`radix_sort_stream` over the route's passes of bit_length(2 *
    n_supers) bits (one pass up to 127 supernodes, two for 300 and for
    MAX_SUPERS = 6144, keys up to 2 * 6144) on keys up to the dead key:
    exactly numpy's stable argsort by key on [0, m), the ids carried, the
    histograms kept, and `radix_unscatter` its exact inverse on an int32
    and a float32 result array. Exact."""
    rng = np.random.default_rng(n_supers)
    L, m = 5000, 4700
    dead = 2 * n_supers
    key = rng.integers(0, dead + 1, L).astype(np.int32)
    payload = rng.standard_normal((6, L)).astype(np.float32)
    bits = tpipe.radix_key_bits(dead)
    passes = tpipe.radix_passes(bits)
    assert len(passes) == (1 if n_supers < 128 else 2)
    stream = stream_of(key, payload, m, bits)
    srt = tpipe.radix_sort_stream(stream, bits)
    perm = np.argsort(key[:m], kind="stable")
    np.testing.assert_array_equal(srt.key[:m].numpy(), key[:m][perm])
    np.testing.assert_array_equal(srt.payload[:, :m].numpy(), payload[:, :m][:, perm])
    np.testing.assert_array_equal(srt.entry[:m].numpy(), perm)
    assert srt.hist is stream.hist
    res = np.zeros((2, L), np.float32)
    res[0, :m] = np.arange(m)[perm]
    res[1, :m] = payload[0, :m][perm]
    res = torch.tensor(res)
    res[0] = res[0].to(torch.int32).view(torch.float32)  # int32 bits ride
    back = tpipe.radix_unscatter(srt, res)
    np.testing.assert_array_equal(back[0, :m].view(torch.int32).numpy(), np.arange(m))
    np.testing.assert_array_equal(back[1, :m].numpy(), payload[0, :m])


@pytest.mark.parametrize("m", [0, 1, TILE - 1, TILE, TILE + 1])
def test_digit_pass_lengths(m):
    """One 8-bit pass (shift 0) and one at shift 3 over streams of 0, 1 and
    about one of the kernel's tiles (RADIX_TILE elements) in a buffer of
    m + 37: exactly numpy's stable argsort by the digit on [0, m), its
    digit counts summing to m. Exact."""
    rng = np.random.default_rng(m)
    L = m + 37
    key = rng.integers(0, 1 << 11, L).astype(np.int32)
    payload = rng.standard_normal((2, L)).astype(np.float32)
    st = stream_of(key, payload, m, 8)
    for shift in (0, 3):
        hist = tpipe.radix_digit_counts(st.key, st.length, shift, 8)
        assert int(hist.sum()) == m
        got = tpipe.radix_split(tpipe.RadixSplit(st.key, st.length, shift, width=8,
                                                 hist=hist), st.payload, st.entry)
        perm = np.argsort((key[:m] >> shift) & 255, kind="stable")
        np.testing.assert_array_equal(got.key[:m].numpy(), key[:m][perm])
        np.testing.assert_array_equal(got.payload[:, :m].numpy(),
                                      payload[:, :m][:, perm])
        np.testing.assert_array_equal(got.entry[:m].numpy(), perm)


def test_compaction_split_keeps_real_entries_in_id_order():
    """The compaction split of slot-major (E, P) keys: the real entries
    (column j < count, key below the dead key) in entry-id order with their
    column's payload and their ids slot * P + j, the dead keys and the
    unwritten columns j >= count (random keys there, dead or not) left
    out; its length the real entries; its digit histograms those of the
    real keys (two passes for a dead key of 2 * 300); the unscatter puts
    each result back at its [slot, j] and zeros elsewhere. Exact."""
    rng = np.random.default_rng(3)
    for E, P, count, dead in ((6, 700, 611, 100), (2, 900, 900, 600)):
        keys = rng.integers(0, dead + 1, (E, P)).astype(np.int32)
        keys[rng.uniform(size=(E, P)) < 0.4] = dead
        rays = rng.standard_normal((6, P)).astype(np.float32)
        sp = tpipe.RadixSplit(torch.tensor(keys),
                              torch.tensor([count], dtype=torch.int32), -1, dead)
        st = tpipe.radix_split(sp, torch.tensor(rays))
        real = (keys < dead) & (np.arange(P) < count)[None]
        slot, j = np.nonzero(real)
        total = len(slot)
        assert 0 < total < E * count and int(st.length[0]) == total
        np.testing.assert_array_equal(st.key[:total].numpy(), keys[slot, j])
        np.testing.assert_array_equal(st.payload[:, :total].numpy(), rays[:, j])
        np.testing.assert_array_equal(st.entry[:total].numpy(), slot * P + j)
        bits = tpipe.radix_key_bits(dead)
        want = [np.bincount((keys[slot, j] >> b) & ((1 << w) - 1), minlength=256)
                for b, w in tpipe.radix_passes(bits)]
        assert st.hist.shape == (len(want), tpipe.RADIX_DIGITS)
        np.testing.assert_array_equal(st.hist.numpy(), np.stack(want))
        res = torch.zeros((2, E * P))
        res[0, :total] = torch.arange(1, total + 1, dtype=torch.float32)
        back = tpipe.radix_unscatter(st, res).view(2, E, P)
        want_back = np.zeros((E, P), np.float32)
        want_back[slot, j] = np.arange(1, total + 1)
        np.testing.assert_array_equal(back[0].numpy(), want_back)
        assert not back[1].any()


def test_radix_sort_matches_jax_radix_stream():
    """One stream of two 64x128 tiles, keys in [0, 8) (3 bits) and two
    payloads, through the port's plain sort and the JAX package's
    `_radix_sort_stream` (#15 `_kr_partition` + #16 `_kr_stitch2` per bit,
    interpret mode): element for element equal; a width-1 pass equal to
    one `_kr_partition` + `_kr_stitch2` call on the same input; the port's
    unsort by id and the JAX `_radix_unsort_stream` (#17) both round-trip
    bit-exactly. Exact."""
    rows, lane = 2 * jpipe.TILE_ROWS, jpipe.LANE
    rng = np.random.default_rng(11)
    key = rng.integers(0, 8, (rows, lane)).astype(np.float32)
    pays = [rng.standard_normal((rows, lane)).astype(np.float32) for _ in range(2)]
    arrays = [jnp.asarray(a) for a in [key] + pays]
    n_t = rows // jpipe.TILE_ROWS
    with pltpu.force_tpu_interpret_mode():
        p0, p1, c0 = jpipe._kr_partition(arrays[0], arrays, 0, True)
        csum0 = jnp.cumsum(c0)
        goff0 = csum0 - c0
        goff1 = csum0[n_t - 1] + jnp.arange(n_t, dtype=jnp.int32) * jpipe.TILE_LANES - goff0
        c1 = jpipe.TILE_LANES - c0
        one_pass = jpipe._kr_stitch2(p0, p1, goff0, c0, csum0, goff1, c1, goff1 + c1,
                                     True)
        jsorted, jstages = jpipe._radix_sort_stream(arrays, 3, True)
        jback = jpipe._radix_unsort_stream(list(jsorted[1:]), jstages, True)
    n = rows * lane
    flat = lambda a: np.asarray(a).reshape(-1)  # noqa: E731
    stream = stream_of(flat(key).astype(np.int32), np.stack([flat(p) for p in pays]), n, 3)
    sp = tpipe.RadixSplit(stream.key, stream.length, 0, width=1,
                          hist=tpipe.radix_digit_counts(stream.key, stream.length, 0, 1))
    one = tpipe.radix_split(sp, stream.payload, stream.entry)
    np.testing.assert_array_equal(one.key.numpy(), flat(one_pass[0]).astype(np.int32))
    for got, want in zip(one.payload, one_pass[1:]):
        np.testing.assert_array_equal(got.numpy(), flat(want))
    srt = tpipe.radix_sort_stream(stream, 3)
    np.testing.assert_array_equal(srt.key.numpy(), flat(jsorted[0]).astype(np.int32))
    for got, want in zip(srt.payload, jsorted[1:]):
        np.testing.assert_array_equal(got.numpy(), flat(want))
    back = tpipe.radix_unscatter(srt, srt.payload)
    for got, jgot, src in zip(back, jback, pays):
        np.testing.assert_array_equal(got.numpy(), flat(src))
        np.testing.assert_array_equal(np.asarray(jgot), src)


# ---- a plain model of csrc/radix.cu's tiles and decoupled look-back ----

def model_split(digits, m, R, rng):
    """The places csrc/radix.cu's radix_split_kernel gives the elements of
    a split, modelled in Python: `digits` (m,) int, each element's digit in
    [0, R) or -1 (a compaction split's one: not placed); base of digit d =
    the digits below d overall. Tiles of RADIX_TILE are taken in index
    order (the device-side counter) but run interleaved in a random order
    (`rng`): each publishes its aggregates, then per digit walks back over
    the words earlier tiles have published so far, WINDOW at a time
    (summing up to the first word not published yet, where it reads again,
    or to the first inclusive one), then publishes its inclusive prefix. In
    a tile, warp w holds elements [w * 32 * K, (w + 1) * 32 * K), lane l
    element 32 * i + l; ranks come row by row, the lanes of one digit in
    lane order after the digit's count so far in the warp (the kernel's
    __match_any_sync); an element's place in the tile's sorted order is its
    digit's start in the tile + its warp's offset + its rank, and its place
    in the stream that + the digit's base + its count in earlier tiles -
    its start in the tile (the kernel's staged write)."""
    threads, WINDOW = tpipe.RADIX_THREADS, 4  # csrc/radix.cu kWindow
    W, K = threads // 32, TILE // threads
    n_tiles = -(-m // TILE)
    counts = np.bincount(digits[digits >= 0], minlength=R)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flag = np.zeros((n_tiles, R), np.int64)  # 0 none, 1 aggregate, 2 inclusive
    word = np.zeros((n_tiles, R), np.int64)
    dest = np.full(m, -1, np.int64)

    def tile_run(t):
        v = t * TILE + np.arange(W)[:, None, None] * 32 * K \
            + np.arange(K)[None, :, None] * 32 + np.arange(32)[None, None, :]
        dig = np.where(v < m, digits[np.minimum(v, m - 1)], -1)
        run = np.zeros((W, R), np.int64)
        rank = np.zeros((W, K, 32), np.int64)
        lower = np.tril(np.ones((32, 32), bool), -1)  # [l, l'] l' < l
        for w in range(W):
            for i in range(K):
                row = dig[w, i]
                before = ((row[None, :] == row[:, None]) & lower).sum(1)
                ok = row >= 0
                rank[w, i, ok] = run[w, row[ok]] + before[ok]
                np.add.at(run[w], row[ok], 1)
        total = run.sum(0)
        local = np.cumsum(total) - total  # each digit's start in the tile
        offset = local + np.cumsum(run, 0) - run  # each warp's, in the tile
        flag[t], word[t] = (2 if t == 0 else 1), total
        yield
        earlier = np.zeros(R, np.int64)
        if t > 0:
            for d in rng.permutation(R):
                u = t - 1
                while True:
                    window = [(flag[x, d], word[x, d]) if x >= 0 else (2, 0)
                              for x in range(u, u - WINDOW, -1)]
                    used, done = 0, False
                    for f, c in window:
                        if f == 0:
                            break
                        earlier[d] += c
                        used += 1
                        if f == 2:
                            done = True
                            break
                    if done:
                        break
                    u -= used
                    yield
                flag[t, d], word[t, d] = 2, earlier[d] + total[d]
                if rng.uniform() < 0.3:
                    yield
        ok = dig >= 0
        at = offset[np.arange(W)[:, None, None], dig] + rank
        place = (start + earlier - local)[dig] + at
        dest[v[ok]] = place[ok]

    running, taken = [], 0
    while taken < n_tiles or running:
        if taken < n_tiles and (not running or rng.uniform() < 0.4):
            running.append(tile_run(taken))
            taken += 1
        proc = running[rng.integers(len(running))]
        try:
            next(proc)
        except StopIteration:
            running.remove(proc)
    return dest

@pytest.mark.parametrize("case", [("digit", 8, 3 * TILE + 5), ("digit", 1, 2 * TILE + 1),
                                  ("digit", 6, TILE - 1), ("compact", 1, 5 * TILE - 7)])
def test_lookback_model_gives_stable_places(case):
    """The model of the kernel's tiles, windowed decoupled look-back and
    staged places (`model_split`), tiles running interleaved in a shuffled
    order, each reading only the words earlier tiles have published: every element's
    place is its place in numpy's stable argsort by the digit, for 8-bit,
    1-bit and 6-bit digit passes over 1-4 tiles and for a compaction
    split (digit 0 for a real entry, the rest not placed) over 5 tiles.
    The digit passes' places are the plain split's. Exact."""
    kind, width, m = case
    rng = np.random.default_rng(m)
    if kind == "compact":
        digits = np.where(rng.uniform(size=m) < 0.45, 0, -1)
        R = 1
    else:
        key = rng.integers(0, 1 << 10, m).astype(np.int32)
        digits = (key >> 2) & ((1 << width) - 1)
        R = 1 << width
    dest = model_split(digits, m, R, rng)
    placed = np.nonzero(digits >= 0)[0]
    order = placed[np.argsort(digits[placed], kind="stable")]
    want = np.full(m, -1)
    want[order] = np.arange(order.shape[0])
    np.testing.assert_array_equal(dest, want)
    if kind == "digit":
        st = stream_of(key, key[None].view(np.float32), m, 10)
        got = tpipe.radix_split(tpipe.RadixSplit(st.key, st.length, 2, width=width,
                                                 hist=tpipe.radix_digit_counts(
                                                     st.key, st.length, 2, width)),
                                st.payload, st.entry)
        np.testing.assert_array_equal(got.entry.numpy()[dest], np.arange(m))


@pytest.mark.parametrize("E", [6, 2])
def test_radix_route_matches_counting_route(forced, E):  # noqa: F811
    """The plain radix route on mesh.txt forced onto the sorted route (five
    supernodes, 4 bits, one pass), at E = 6 and the tail-heavy E = 2: its
    sorted stream exactly B's (key, ray and id of every entry: a stable
    sort is the (key, entry id) sort), C's results at every real [slot, j]
    exactly the counting route's, and `intersect_pipeline` under
    SORT_RADIX exactly the counting route's on every lane. No kernel
    launch on CPU tensors. Exact."""
    _, td, _, _ = both_mesh_scenes()
    sn = td.super_ranges[MESH_GEOM][1]
    o, d = mesh_rays(1024, seed=7)
    cands, _, sk, st, eh = plain_route(tv(o), tv(d), E)
    E_, P = sk.keys.shape
    n, m = int(cands.count[0]), int(st.total[0])
    before = [getattr(tpipe, k).launches for k in RADIX]
    compact = tpipe.RadixSplit(sk.keys, cands.count, -1, 2 * sn)
    stream = tpipe.radix_split(compact, sk.rays)
    assert int(stream.length[0]) == m
    srt = tpipe.radix_sort_stream(stream, tpipe.radix_key_bits(2 * sn))
    assert torch.equal(srt.key[:m], st.key[:m])
    assert torch.equal(srt.entry[:m], st.entry[:m])
    assert torch.equal(srt.payload[:, :m], sk.rays[:, st.entry[:m].long() % P])
    got = tpipe.radix_window_sweep(sk, cands.count, td, MESH_GEOM)
    real = (sk.keys < 2 * sn) & (torch.arange(P) < n)[None]
    tails = (sk.keys[:, :n] >= sn) & (sk.keys[:, :n] < 2 * sn)
    assert E == 6 or bool(tails.any())
    for a, b in zip(got, eh):
        assert torch.equal(a[real], b[real])
    assert bool((got.t[real] < tpipe.FLT_MAX).any())
    forced.setattr(tpipe, "SORT_EXPAND", E)
    alive = torch.tensor(np.random.default_rng(9).uniform(size=o.shape[0]) < 0.8)
    want = tpipe.intersect_pipeline(tv(o), tv(d), alive, td)
    forced.setattr(tpipe, "SORT_RADIX", True)
    isect = tpipe.intersect_pipeline(tv(o), tv(d), alive, td)
    for a, b in zip(lanes(isect), lanes(want)):
        assert torch.equal(a, b)
    assert before == [getattr(tpipe, k).launches for k in RADIX]


def test_renderer_radix_route_matches_counting_route(forced):  # noqa: F811
    """A Renderer on mesh.txt forced onto the sorted route, one iteration
    at depth 3 and 32x32: under SORT_RADIX the image equals the counting
    route's exactly."""
    s = tscene.load_scene(os.path.join(SCENES, "mesh.txt"))
    c = s.state.camera
    s.state.camera = tscene.derive_camera(
        (32, 32), c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance)
    calls = []
    route = tpipe.radix_window_sweep
    forced.setattr(tpipe, "radix_window_sweep",
                   lambda *a, **k: calls.append(1) or route(*a, **k))
    images = []
    for radix in (False, True):
        forced.setattr(tpipe, "SORT_RADIX", radix)
        r = Renderer(s, RenderSettings(trace_depth=3, antialias=True), device="cpu")
        r.step_batch(1)
        images.append(r.image())
    assert len(calls) == 3  # one geom, three depths, radix run only
    assert np.isfinite(images[0]).all() and images[0].max() > 0
    np.testing.assert_array_equal(images[1], images[0])
