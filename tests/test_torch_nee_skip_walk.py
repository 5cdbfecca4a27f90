"""The walk of the NEE kernels #5 and #6 on mesh scenes (csrc/nee.cu
`mesh_walks`: each lane's stackless walk of every mesh geom's binary BVH,
one int cursor, hit ? (leaf ? test, go skip : i + 1) : skip), on the CPU:

- a mesh whose BVH is deeper than any stack would hold (mesh.txt's
  icosphere over a chain of MESH_CHAIN_TRIS triangles, chip_smoke.py
  `chain_bvh`: wide depth past 64) packs under `nee`, and the port's
  `_nee_mis_bounce` on it matches the JAX package's, fed the same chain,
  by the lane rule of tests/test_megakernel.py:57-76 (16x16, depth 2);
- the tables the walk reads (ops/megakernel.py::pack_nee_bvh: the binary
  BVH's node rows and every mesh geom's root, the sorted route's
  included) are exactly the JAX package's BVH arrays, on mesh.txt,
  mesh_big.txt and a two-mesh scene, and are packed only with `nee`;
- the walk itself in plain PyTorch (chip_smoke.py `skip_walk`, which also
  counts its work for the kernels' bounds), unseeded and seeded from an
  object-space bound as the kernels seed it, against the JAX
  `mesh_intersect_bvh` (hit or miss; distance and normal within 1e-4) and
  its twin in the port (bit for bit) on mesh.txt, mesh_big.txt and the
  chain, but on at most 1% of lanes; and its shadow walk against the JAX
  nearest hit: occluded iff that hit's world distance lies in (0, bound),
  but on at most 1%."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import bvh_traverse as jbvh
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import bvh_traverse as tbvh
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.intersect import FLT_MAX
from chip_smoke import MESH_CHAIN_TRIS, chain_bvh, skip_walk, wide_depth
from tests.conftest import SCENES
from tests.test_torch_mesh_load import two_mesh_scene
from tests.test_torch_nee import assert_aux_close, to_jax
from tests.test_torch_nee_mesh import both, camera_state, settings_pair
from tests.test_torch_ops import assert_state_close, tv


@functools.lru_cache(maxsize=None)
def scenes_of(path):
    """(JAX DeviceScene, the port's DeviceScene from its own loader) of
    the scene file at `path`, with the BVH."""
    return (jdevice.scene_to_device(jscene.load_scene(path), use_bvh=True),
            tdevice.scene_to_device(tscene.load_scene(path), "cpu"))


def path_of(name, tmp_path_factory):
    if name == "two_meshes":
        return two_mesh_scene(tmp_path_factory.mktemp("two"))
    return os.path.join(SCENES, f"{name}.txt")


def jax_chain(jd, td):
    """The JAX DeviceScene jd with the BVH of the port's DeviceScene td
    (a chain_bvh of the same triangles)."""
    arr = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    vec = lambda v: JVec3(*(arr(c) for c in v))  # noqa: E731
    return dataclasses.replace(
        jd, bvh_min=vec(td.bvh_min), bvh_max=vec(td.bvh_max),
        bvh_first=arr(td.bvh_first), bvh_count=arr(td.bvh_count),
        bvh_skip=arr(td.bvh_skip), bvh_leaf=arr(td.bvh_leaf), bvh_roots=td.bvh_roots)


@pytest.fixture(scope="module")
def walk_scenes():
    """name -> (JAX DeviceScene, port DeviceScene): mesh.txt, mesh_big.txt
    and mesh.txt over the chain (both packages given the same chain)."""
    out = {name: scenes_of(os.path.join(SCENES, f"{name}.txt"))
           for name in ("mesh", "mesh_big")}
    jd, td = out["mesh"]
    (g,) = td.mesh_geoms
    deep = chain_bvh(td, g, count=MESH_CHAIN_TRIS)
    out["chain"] = (jax_chain(jd, deep), deep)
    return out


def aimed_rays(td, g, n, seed):
    """Seeded rays from the Cornell room, three quarters aimed into mesh
    geom g's world box, the rest anywhere."""
    lo, hi = (np.asarray(td.mesh_obj_aabbs[g][:3]), np.asarray(td.mesh_obj_aabbs[g][3:]))
    xf = td.transform[g].numpy()
    rng = np.random.default_rng(seed)
    aim = rng.uniform(lo, hi, (n, 3)) @ xf[:3, :3].T + xf[:3, 3]
    o = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3))
    d = np.where(np.arange(n)[:, None] % 4 == 3, rng.normal(size=(n, 3)), aim - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def jax_hits(jd, g, o, d):
    """The JAX package's walk of mesh geom g: (dist, normal (P,3)), numpy."""
    dist, normal, *_ = jbvh.mesh_intersect_bvh(
        jd, g, JVec3(*(jnp.asarray(c) for c in o.T)), JVec3(*(jnp.asarray(c) for c in d.T)))
    return np.asarray(dist), np.stack([np.asarray(c) for c in normal], 1)


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_chain_past_wide_depth_64_packs_for_nee(walk_scenes):
    """The fault: a BVH deeper than wide depth 64 (a stack in a block's
    shared memory could not hold its walk) packs under `nee`, its node
    rows and root those of the chain, with nothing limiting the depth."""
    _, deep = walk_scenes["chain"]
    (g,) = deep.mesh_geoms
    assert wide_depth(deep) > 64
    t = tmk.pack_scene_tables(deep, nee=True)
    B = deep.bvh_first.shape[0]
    assert B == 2 * (-(-MESH_CHAIN_TRIS // 4)) - 1
    assert t.node.shape == (B, 4) and t.roots.tolist() == [[0, B]]
    np.testing.assert_array_equal(
        t.node.numpy(), np.stack([deep.bvh_first.numpy(), deep.bvh_count.numpy(),
                                  deep.bvh_skip.numpy(), deep.bvh_leaf.numpy()], 1))
    assert t.aw is not None and len(t.mesh) == 6


@pytest.mark.parametrize("depth", [0, 1])
def test_chain_nee_bounce_matches_jax(depth):
    """One bounce of the plain estimator that #5 and #6 are held to, on
    mesh.txt over the chain (16x16, trace depth 2, AA): the port's
    `_nee_mis_bounce` against the JAX package's, fed the same chain, from
    the same state (at depth 1 the port's own depth-0 output), by the lane
    rule; the mesh is hit and shadow rays are cast."""
    jd, td, _, tc = both("mesh.txt", (16, 16))
    (g,) = td.mesh_geoms
    deep = chain_bvh(td, g, count=MESH_CHAIN_TRIS)
    jdeep = jax_chain(jd, deep)
    tset, jset = settings_pair(2, antialias=True)
    it = 3
    state, aux = camera_state(tc, it, tset)
    if depth == 1:
        state, aux = trender._nee_mis_bounce(state, aux, deep, it, 0, tset, False)
    jstate, jaux = to_jax(state, aux)
    want, want_aux = jrender._nee_mis_bounce(jstate, jaux, jdeep, jnp.int32(it), depth,
                                             jset, depth == 1)
    probe = {}
    got, got_aux = trender._nee_mis_bounce(state, aux, deep, it, depth, tset, depth == 1,
                                           probe=probe)
    assert_state_close(got, want)
    assert_aux_close(got, got_aux, want, want_aux)
    assert probe["shadow"].any()
    hit = trender.intersect_scene(state[0], state[1], deep)
    assert (hit.material_id.numpy() == int(deep.geom_material_id[g])).any()


@pytest.mark.parametrize("name", ["mesh", "mesh_big", "two_meshes"])
def test_nee_bvh_tables_are_jax_bvh(name, tmp_path_factory):
    """The node rows and roots #5 and #6 walk, packed from the port's own
    loader, are exactly the JAX package's BVH arrays (first, count, skip,
    leaf; each mesh geom's (first node, node count)), every mesh geom
    rooted, the sorted route's too (whose `geoms` row #7 and #8 read keeps
    no node count); without `nee` they are not packed, and the mesh
    pipeline's six tables are the same either way."""
    jd, td = scenes_of(path_of(name, tmp_path_factory))
    t = tmk.pack_scene_tables(td, nee=True)
    node = t.node.numpy()
    assert t.node.dtype == torch.int32 and node.shape == (np.asarray(jd.bvh_first).shape[0], 4)
    for k, a in enumerate((jd.bvh_first, jd.bvh_count, jd.bvh_skip, jd.bvh_leaf)):
        np.testing.assert_array_equal(node[:, k], np.asarray(a).astype(np.int32))
    assert t.roots.dtype == torch.int32
    assert t.roots.tolist() == [list(jd.bvh_roots[g]) for g in td.mesh_geoms]
    assert (t.roots[:, 1] > 0).all()
    sorted_ = tpipe.sorted_geoms(td)
    assert bool(sorted_) == (name == "mesh_big")
    assert [int(c) for c in t.mesh[3][:, 2]] == [
        0 if g in sorted_ else jd.bvh_roots[g][1] for g in td.mesh_geoms]
    plain = tmk.pack_scene_tables(td)
    assert plain.node is None and plain.roots is None
    assert all(torch.equal(a, b) for a, b in zip(plain.mesh, t.mesh))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("name", ["mesh", "mesh_big", "chain"])
def test_skip_walk_matches_jax_bvh_walk(walk_scenes, name, seeded):
    """The kernels' walk for the nearest hit on seeded rays against the
    JAX walk (hit or miss on every lane, distance and normal within 1e-4)
    and against its twin in the port, the plain `mesh_intersect_bvh` that
    the plain NEE estimator runs (distance, normal, side and UVs bit for
    bit), each but on at most 1% of lanes. Seeded (a bound below a hit on
    about half the hits and above it on the others, none on a third of
    the lanes), a lane keeps its unseeded winner, the same triangle, where
    that winner's object t lies below the bound, and has none elsewhere."""
    jd, td = walk_scenes[name]
    (g,) = td.mesh_geoms
    o, d = aimed_rays(td, g, 1024 if name == "chain" else 2048, seed=21)
    n = o.shape[0]
    want_t, want_n = jax_hits(jd, g, o, d)
    twin = tbvh.mesh_intersect_bvh(td, g, tv(o), tv(d))
    hit = want_t > 0
    assert 0.3 < hit.mean() < 0.95
    t0, tri0, u0, v0 = skip_walk(td, g, tv(o), tv(d), torch.full((n,), FLT_MAX))
    t, tri, u, v = t0, tri0, u0, v0
    keep = tri0 >= 0  # the lanes that keep the unseeded winner
    if seeded:
        rng = np.random.default_rng(22)
        scale = torch.from_numpy(rng.choice(np.float32([0.5, 1.5]), n))
        seed = torch.where(tri0 >= 0, t0 * scale, FLT_MAX)
        seed[torch.from_numpy(rng.permutation(n)[: n // 3])] = FLT_MAX
        t, tri, u, v = skip_walk(td, g, tv(o), tv(d), seed)
        keep = (tri0 >= 0) & (t0 < seed)
        assert 0.1 < float(keep.float().mean()) < 0.9
    has = tri >= 0
    ro, rd, _ = tbvh._object_ray(td, g, tv(o), tv(d))
    got = tbvh._mesh_hit(td, g, tv(o), tv(d), ro, rd, torch.where(has, t, FLT_MAX),
                         torch.where(has, tri, 0), u, v)
    got_n = np.stack([c.numpy() for c in got[1]], 1)
    k = keep.numpy()
    off = (tri != torch.where(keep, tri0, -1)).numpy()
    # where a lane keeps its winner: the twin's bits, the JAX hit within 1e-4
    twin_bits = np.stack([bits(a.numpy()) for a in (twin[0], *twin[1], twin[3], twin[4])], 1)
    got_bits = np.stack([bits(a.numpy()) for a in (got[0], *got[1], got[3], got[4])], 1)
    off |= k & ((got_bits != twin_bits).any(1) | (twin[2] != got[2]).numpy())
    off |= k & ~(hit & (np.abs(got[0].numpy() - want_t) <= 1e-4)
                 & (np.abs(got_n - want_n) <= 1e-4).all(1))
    if not seeded:
        off |= ~k & hit
    assert off.mean() <= 0.01, int(off.sum())


@pytest.mark.parametrize("name", ["mesh", "mesh_big", "chain"])
def test_skip_shadow_walk_matches_jax_nearest_hit(walk_scenes, name):
    """The kernels' shadow walk (its bound's object-space image the bound
    times frobenius3(inv), as the kernels take it) against the plain
    estimator's rule on the JAX nearest hit: occluded iff its world
    distance lies in (0, bound), on all but 1% of lanes, the bounds drawn
    around the hits; a shadow walk tests no more boxes than the unbounded
    walk."""
    jd, td = walk_scenes[name]
    (g,) = td.mesh_geoms
    o, d = aimed_rays(td, g, 1024 if name == "chain" else 2048, seed=23)
    n = o.shape[0]
    want_t, _ = jax_hits(jd, g, o, d)
    rng = np.random.default_rng(24)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bound = torch.from_numpy(np.where(want_t > 0, want_t * scale, 5.0).astype(np.float32))
    frob = tpipe._frobenius3(td.inverse_transform[g])
    shadow_work, path_work = {}, {}
    occ = skip_walk(td, g, tv(o), tv(d), bound * frob, shadow=bound, work=shadow_work)
    skip_walk(td, g, tv(o), tv(d), torch.full((n,), FLT_MAX), work=path_work)
    want = (want_t > 0) & (want_t < bound.numpy())
    assert 0.1 < want.mean() < 0.8
    assert (occ.numpy() != want).mean() <= 0.01
    assert int(shadow_work["nodes"]) <= int(path_work["nodes"])
    assert 0 < int(shadow_work["dists"]) <= int(shadow_work["tris"])
