"""The radix route of the big-mesh path (PT_TPU_SORT_RADIX=1) on the CPU:
the plain split and unsplit (`radix_split_reference`,
`radix_unsplit_reference`, `radix_counts_reference`) against numpy's
stable argsort and its inverse, the plain sort and unsort against the JAX
package's `_radix_sort_stream` / `_radix_unsort_stream` (#15-#17, Pallas
in interpret mode), and the whole plain route on mesh.txt forced onto the
sorted route against the counting-sort route (B), entry for entry and
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

RADIX = ("radix_counts", "radix_scatter", "radix_unscatter", "window_sweep_stream")


def stream_of(key, payload, m):
    return tpipe.RadixStream(torch.tensor(key, dtype=torch.int32),
                             torch.tensor(payload),
                             torch.tensor([m], dtype=torch.int32))


def lanes(h):
    """An Intersections' lanes."""
    return [h.t, *h.normal, h.material_id, h.outside, h.tex_u, h.tex_v, h.has_uv]


def block_zeros(zero):
    """Zeros per RADIX_BLOCK elements, the last block padded."""
    pad = np.zeros(-len(zero) % tpipe.RADIX_BLOCK, bool)
    return np.concatenate([zero, pad]).reshape(-1, tpipe.RADIX_BLOCK).sum(1)


@pytest.mark.parametrize("bit", [0, 3, 6])
def test_split_pass_matches_stable_argsort(bit):
    """One pass over the first m of L elements (keys up to the dead key 2 *
    50, as on mesh_big): key and payload exactly numpy's stable argsort by
    the key's bit, the per-block zero counts exactly, and the unsplit the
    exact inverse on [0, m). Exact."""
    rng = np.random.default_rng(bit)
    L, m = 1000, 777
    key = rng.integers(0, 101, L).astype(np.int32)
    payload = rng.standard_normal((3, L)).astype(np.float32)
    sp = tpipe.RadixSplit(torch.tensor(key), torch.tensor([m], dtype=torch.int32),
                          bit)
    perm = np.argsort((key[:m] >> bit) & 1, kind="stable")
    got_key, got = tpipe.radix_split_reference(sp, torch.tensor(payload))
    np.testing.assert_array_equal(got_key[:m].numpy(), key[:m][perm])
    np.testing.assert_array_equal(got[:, :m].numpy(), payload[:, :m][:, perm])
    zero = np.arange(L) < m
    zero[:m] &= ((key[:m] >> bit) & 1) == 0
    np.testing.assert_array_equal(tpipe.radix_counts_reference(sp).numpy(),
                                  block_zeros(zero))
    back = tpipe.radix_unsplit_reference(sp, got)
    np.testing.assert_array_equal(back[:, :m].numpy(), payload[:, :m])


@pytest.mark.parametrize("n_supers", [1, 5, 50])
def test_sort_stream_matches_stable_argsort(n_supers):
    """`radix_sort_stream` over bit_length(2 * n_supers) passes (the
    route's bit count) on keys up to the dead key: exactly numpy's stable
    argsort by key on [0, m), and `radix_unsort_stream` its exact inverse
    on an int32 and a float32 result array. Exact."""
    rng = np.random.default_rng(n_supers)
    L, m = 1536, 1400
    key = rng.integers(0, 2 * n_supers + 1, L).astype(np.int32)
    payload = rng.standard_normal((6, L)).astype(np.float32)
    bits = max(1, (2 * n_supers).bit_length())
    srt, stages = tpipe.radix_sort_stream(stream_of(key, payload, m), bits)
    assert len(stages) == bits
    perm = np.argsort(key[:m], kind="stable")
    np.testing.assert_array_equal(srt.key[:m].numpy(), key[:m][perm])
    np.testing.assert_array_equal(srt.payload[:, :m].numpy(), payload[:, :m][:, perm])
    res = np.zeros((2, L), np.float32)
    res[0, :m] = np.arange(m)[perm]
    res[1, :m] = payload[0, :m][perm]
    res = torch.tensor(res)
    res[0] = res[0].to(torch.int32).view(torch.float32)  # int32 bits ride
    back = tpipe.radix_unsort_stream(res, stages)
    np.testing.assert_array_equal(back[0, :m].view(torch.int32).numpy(), np.arange(m))
    np.testing.assert_array_equal(back[1, :m].numpy(), payload[0, :m])


def test_compaction_split_keeps_real_entries_in_id_order():
    """The compaction split of slot-major (E, P) keys: the real entries
    (column j < count, key below the dead key) in entry-id order with their
    column's payload, the dead keys and the unwritten columns j >= count
    (random keys there, dead or not) left out; total = the last scanned
    block count; the unsplit puts each result back at its [slot, j] and
    zeros elsewhere. Exact."""
    rng = np.random.default_rng(3)
    E, P, count, dead = 6, 700, 611, 100
    keys = rng.integers(0, dead + 1, (E, P)).astype(np.int32)
    keys[rng.uniform(size=(E, P)) < 0.4] = dead
    rays = rng.standard_normal((6, P)).astype(np.float32)
    sp = tpipe.RadixSplit(torch.tensor(keys), torch.tensor([count], dtype=torch.int32),
                          -1, dead)
    key, payload, csum = tpipe.radix_split(sp, torch.tensor(rays))
    real = (keys < dead) & (np.arange(P) < count)[None]
    slot, j = np.nonzero(real)
    total = len(slot)
    assert 0 < total < E * count and int(csum[-1]) == total
    np.testing.assert_array_equal(csum.numpy(),
                                  np.cumsum(block_zeros(real.reshape(-1))))
    np.testing.assert_array_equal(key[:total].numpy(), keys[slot, j])
    np.testing.assert_array_equal(payload[:, :total].numpy(), rays[:, j])
    res = torch.zeros((2, E * P))
    res[0, :total] = torch.arange(1, total + 1, dtype=torch.float32)
    back = tpipe.radix_unscatter(sp, csum, res).view(2, E, P)
    want = np.zeros((E, P), np.float32)
    want[slot, j] = np.arange(1, total + 1)
    np.testing.assert_array_equal(back[0].numpy(), want)
    assert not back[1].any()


def test_radix_sort_matches_jax_radix_stream():
    """One stream of two 64x128 tiles, keys in [0, 8) (3 bits) and two
    payloads, through the port's plain sort and the JAX package's
    `_radix_sort_stream` (#15 `_kr_partition` + #16 `_kr_stitch2` per bit,
    interpret mode): element for element equal; one pass equal to one
    `_kr_partition` + `_kr_stitch2` call on the same input; both unsorts
    (`_radix_unsort_stream`, #17) round-trip bit-exactly. Exact."""
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
    stream = stream_of(flat(key).astype(np.int32), np.stack([flat(p) for p in pays]), n)
    k1, pay1, _ = tpipe.radix_split(tpipe.RadixSplit(stream.key, stream.length, 0),
                                    stream.payload)
    np.testing.assert_array_equal(k1.numpy(), flat(one_pass[0]).astype(np.int32))
    for got, want in zip(pay1, one_pass[1:]):
        np.testing.assert_array_equal(got.numpy(), flat(want))
    srt, stages = tpipe.radix_sort_stream(stream, 3)
    np.testing.assert_array_equal(srt.key.numpy(), flat(jsorted[0]).astype(np.int32))
    for got, want in zip(srt.payload, jsorted[1:]):
        np.testing.assert_array_equal(got.numpy(), flat(want))
    back = tpipe.radix_unsort_stream(srt.payload, stages)
    for got, jgot, src in zip(back, jback, pays):
        np.testing.assert_array_equal(got.numpy(), flat(src))
        np.testing.assert_array_equal(np.asarray(jgot), src)


@pytest.mark.parametrize("E", [6, 2])
def test_radix_route_matches_counting_route(forced, E):  # noqa: F811
    """The plain radix route on mesh.txt forced onto the sorted route (five
    supernodes, 4 bits), at E = 6 and the tail-heavy E = 2: its sorted
    stream exactly B's (key and ray of every entry: a stable sort is the
    (key, entry id) sort), C's results at every real [slot, j] exactly the
    counting route's, and `intersect_pipeline` under SORT_RADIX exactly the
    counting route's on every lane. No kernel launch on CPU tensors.
    Exact."""
    _, td, _, _ = both_mesh_scenes()
    sn = td.super_ranges[MESH_GEOM][1]
    o, d = mesh_rays(1024, seed=7)
    cands, _, sk, st, eh = plain_route(tv(o), tv(d), E)
    E_, P = sk.keys.shape
    n, m = int(cands.count[0]), int(st.total[0])
    before = [getattr(tpipe, k).launches for k in RADIX]
    compact = tpipe.RadixSplit(sk.keys, cands.count, -1, 2 * sn)
    key, rays, csum = tpipe.radix_split(compact, sk.rays)
    assert int(csum[-1]) == m
    srt, stages = tpipe.radix_sort_stream(tpipe.RadixStream(key, rays, csum[-1:]),
                                          (2 * sn).bit_length())
    assert torch.equal(srt.key[:m], st.key[:m])
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
