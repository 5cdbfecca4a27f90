"""The big-mesh route's tables and its first two steps against the JAX
package: the chunk and supernode boxes, ranges and object boxes of
`scene_to_device` exactly equal on mesh.txt and mesh_big.txt; A's plain
keys (`super_rank`) key for key equal to `_super_rank_xla` on seeded
object-space rays against mesh_big's 50 supernodes, overflow tails
included, for E in {6, 2, 1}; B's plain stream (`place_entries_reference`)
a permutation of the real entries with non-decreasing keys whose
(lane, slot) set per key is the one `_kc_compact` -> `_ks_stitch` -> sort
gives (Pallas in interpret mode, two 64x128 tiles)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import pipeline as jpipe
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.megakernel import pack_scene_tables
from tests.conftest import SCENES

HIERARCHY = ("chunk_ranges", "super_ranges", "mesh_obj_aabbs")


@pytest.fixture(scope="module")
def mesh_big():
    """(JAX DeviceScene, the port's own DeviceScene) of mesh_big.txt with
    the BVH, each package building its own, loaded once."""
    path = os.path.join(SCENES, "mesh_big.txt")
    return (jdevice.scene_to_device(jscene.load_scene(path), use_bvh=True),
            tdevice.scene_to_device(tscene.load_scene(path), "cpu"))


def assert_hierarchy_equal(td, jd):
    for n in ("mesh_chunk_aabbs", "mesh_super_aabbs"):
        np.testing.assert_array_equal(getattr(td, n).numpy(),
                                      np.asarray(getattr(jd, n)), err_msg=n)
    for n in HIERARCHY:
        assert getattr(td, n) == getattr(jd, n), n


def test_hierarchy_tables_equal_jax_mesh():
    path = os.path.join(SCENES, "mesh.txt")
    jd = jdevice.scene_to_device(jscene.load_scene(path), use_bvh=True)
    td = tdevice.scene_to_device(tscene.load_scene(path), "cpu")
    assert_hierarchy_equal(td, jd)
    assert td.super_ranges[6] == (0, 5) and td.chunk_ranges[6] == (0, 160)
    assert tpipe.sorted_geoms(td) == () and tpipe.dense_geoms(td) == (6,)


def test_hierarchy_tables_equal_jax_mesh_big(mesh_big):
    """mesh_big's tables exactly; its one geom takes the sorted route, and
    the packed geoms table gives #8 no node of it to walk."""
    jd, td = mesh_big
    assert_hierarchy_equal(td, jd)
    (g,) = td.mesh_geoms
    assert td.tri_ranges[g][1] == 51_200 and td.super_ranges[g][1] == 50
    assert tpipe.sorted_geoms(td) == (g,) and tpipe.dense_geoms(td) == ()
    tri, attr, box, geoms, chunk, sup = pack_scene_tables(td).mesh
    assert geoms.tolist() == [[g, td.bvh_roots[g][0], 0, 0]]
    assert torch.equal(chunk, td.mesh_chunk_aabbs)
    assert torch.equal(sup, td.mesh_super_aabbs)
    assert chunk.shape == (1600, 8) and sup.shape == (50, 8)


def seeded_object_rays(td, g, n, seed):
    """Seeded object-space rays around mesh_big's object box: origins in a
    box three times its size, directions aimed inside it, unit length;
    bounds from a miss (FLT_MAX) to short of the box, a tenth of the lanes
    dead (-FLT_MAX, which enters nothing)."""
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(td.mesh_obj_aabbs[g][:3]),
              np.asarray(td.mesh_obj_aabbs[g][3:]))
    c, h = (lo + hi) / 2, (hi - lo) / 2
    o = c + rng.uniform(-3, 3, (n, 3)) * h
    d = c + rng.uniform(-1, 1, (n, 3)) * h - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bt = np.where(rng.uniform(size=n) < 0.3, np.float32(tpipe.FLT_MAX),
                  rng.uniform(0.5, 4, n) * np.linalg.norm(h))
    bt[rng.uniform(size=n) < 0.1] = -tpipe.FLT_MAX
    q = np.concatenate([o, d], axis=1).astype(np.float32).T
    return q, bt.astype(np.float32)


@pytest.mark.parametrize("E", [6, 2, 1])
def test_super_keys_equal_jax(mesh_big, E):
    """A's plain keys key for key equal to `_super_rank_xla`'s; the seeds
    give every slot and the overflow tail lanes (more than E entered
    supers)."""
    jd, td = mesh_big
    (g,) = td.mesh_geoms
    ss, sn = td.super_ranges[g]
    q, bt = seeded_object_rays(td, g, 4096, seed=E)
    want = jpipe._super_rank_xla(jnp.asarray(np.asarray(jd.mesh_super_aabbs)),
                                 ss, sn, E, *(jnp.asarray(a) for a in q),
                                 jnp.asarray(bt))
    got = tpipe.super_rank(tuple(torch.tensor(a) for a in q), torch.tensor(bt),
                           td.mesh_super_aabbs[ss:ss + sn], E)
    want = np.stack([np.asarray(k) for k in want])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    real = got < 2 * sn
    tail = real[E - 1] & (got[E - 1] >= sn)
    assert bool(tail.any()) and bool((real[E - 1] & ~tail).any())
    assert not bool(real[:, torch.tensor(bt) < 0].any())  # dead lanes


@pytest.fixture(scope="module")
def compaction(mesh_big):
    """E = 2 slots of 8,192 seeded lanes against mesh_big (two 64x128
    tiles): (keys, q, the JAX stream's keys, ids and payload row 0 in
    (key, id) order, its total) from `_kc_compact` -> `_ks_stitch`, Pallas
    in interpret mode, run once for the tests below."""
    jd, td = mesh_big
    (g,) = td.mesh_geoms
    ss, sn = td.super_ranges[g]
    E, P = 2, 8192
    q, bt = seeded_object_rays(td, g, P, seed=11)
    keys = tpipe.super_rank(tuple(torch.tensor(a) for a in q), torch.tensor(bt),
                            td.mesh_super_aabbs[ss:ss + sn], E)
    dead = 2 * sn
    keyf = jnp.asarray(keys.reshape(-1).numpy().astype(np.float32))
    qep = tuple(jnp.tile(jnp.asarray(a), E) for a in q)
    packed8, counts = jpipe._kc_compact(keyf, qep, dead, True)
    csum = jnp.cumsum(counts)
    rows = E * P // jpipe.LANE
    dense8 = jpipe._ks_stitch(packed8, csum - counts, counts, csum, rows, dead,
                              E * P, True)
    jkey = np.asarray(dense8[0]).reshape(-1).astype(np.int64)
    jidx = np.asarray(dense8[1]).reshape(-1).astype(np.int64)
    m = int(csum[-1])
    order = np.lexsort((jidx, jkey))[:m]
    return (keys, q, bt, dead, jkey[order], jidx[order],
            np.asarray(dense8[2]).reshape(-1)[order], m)


def test_place_entries_equal_jax_compaction(compaction):
    """B's plain stream against `_kc_compact` -> `_ks_stitch` -> sort by
    (key, entry) over E = 2 slots of 8,192 lanes (two 64x128 tiles)."""
    keys, q, bt, dead, jkey, jidx, jpay, jm = compaction
    E, P = keys.shape
    real = keys[keys < dead].long()
    sk = tpipe.SuperKeys(keys, torch.tensor(q), torch.tensor(bt),
                         torch.bincount(real, minlength=dead).int())
    st = tpipe.place_entries_reference(
        sk, torch.tensor([P], dtype=torch.int32))
    m = int(st.total[0])
    assert m == real.shape[0] and 0.2 * E * P < m < 0.9 * E * P
    key, entry = st.key[:m], st.entry[:m].long()
    assert bool((key[1:] >= key[:-1]).all())
    assert torch.equal(torch.sort(entry).values,
                       torch.nonzero(keys.reshape(-1) < dead)[:, 0])
    assert torch.equal(keys.reshape(-1)[entry], key)
    assert jm == m
    np.testing.assert_array_equal(jkey, key.numpy())
    # per key, the same (slot, lane) set: entry = slot * P + lane, in both
    mine = np.lexsort((entry.numpy(), key.numpy()))
    np.testing.assert_array_equal(jidx, entry.numpy()[mine])
    # the payloads rode along: the entry's lane's rays
    np.testing.assert_array_equal(jpay, q[0][jidx % P])


def test_place_model_equal_jax_compaction(compaction):
    """csrc/sorted.cu's B as modelled in tests/test_torch_place_model.py
    (tiles of listed lanes, reservations in a shuffled order) on the same
    keys: per key the (slot, lane) set of `_kc_compact` -> `_ks_stitch`,
    keys ascending, its total exact; and again on the cursors the first
    run left."""
    from tests.test_torch_place_model import model_place

    keys, _, _, dead, jkey, jidx, _, jm = compaction
    k = keys.numpy()
    hist = np.bincount(k[k < dead], minlength=dead)
    cursor = np.zeros(dead, np.int64)
    rng = np.random.default_rng(5)
    for _ in range(2):
        key, ids, total = model_place(k, k.shape[1], hist, cursor, rng)
        assert total == jm
        np.testing.assert_array_equal(key[:jm], jkey)
        mine = np.lexsort((ids[:jm], key[:jm]))
        np.testing.assert_array_equal(ids[:jm][mine], jidx)
