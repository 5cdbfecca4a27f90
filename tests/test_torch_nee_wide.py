"""The wide BVH that the NEE kernels #5 and #6 walk on mesh scenes
(ops/megakernel.py::pack_nee_wide_tables: every mesh geom collapsed by
models/wide_bvh.py, the big-mesh route's geoms included) and the plain
counterparts of their walks (ops/bvh_traverse.py::mesh_intersect_wide for
the nearest hit, mesh_occluded_wide for the shadow ray), on the CPU:

- each geom's tree in the NEE tables is exactly the tree #8's tables give
  it (`pack_wide_tables`), and the sorted route's geoms get a root;
- the wide walk over those tables in the kernels' order (the nearest
  entered child first, the others in child order) against the binary
  walk (`mesh_intersect_bvh`, the walk of the plain NEE estimator) and
  against #8's order (every entered child by tmin) on
  mesh.txt and mesh_big.txt: the hit distance and the winning triangle
  exactly but on the lanes whose winning t lies an ulp inside a box's slab
  entry, counted and held to the lane rule of
  tests/test_megakernel.py:57-76 (at most 1% of lanes); seeded from an
  object-space bound (the kernels' image of the nearest hit so far), the
  winner is the unseeded one where it is strictly nearer, else none;
- the shadow walk against the binary walk's nearest hit: a lane is
  occluded iff that hit's world distance lies in (0, bound), but on 1%;
- a tree deeper than a block's shared memory holds the kernels' stack for
  (NEE_STACK_MAX) is refused with a ValueError naming its depth; one far
  deeper than the scenes' own (wide depth 7) packs, and its walk matches
  the binary walk."""

import functools
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.models.wide_bvh import WIDTH
from project3_cuda_path_tracer_tpu_torch.ops import bvh_traverse as tbvh
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.intersect import FLT_MAX
from chip_smoke import chain_bvh
from tests.conftest import SCENES
from tests.test_torch_mesh_intersect import assert_lane_rule
from tests.test_torch_mesh_load import two_mesh_scene
from tests.test_torch_ops import tv


@functools.lru_cache(maxsize=None)
def port_scene(path):
    return tdevice.scene_to_device(tscene.load_scene(path), "cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (port DeviceScene, its tables packed with `nee`)."""
    paths = {
        "mesh": os.path.join(SCENES, "mesh.txt"),
        "mesh_big": os.path.join(SCENES, "mesh_big.txt"),
        "two_meshes": two_mesh_scene(tmp_path_factory.mktemp("two")),
    }
    return {name: (port_scene(p), tmk.pack_scene_tables(port_scene(p), nee=True))
            for name, p in paths.items()}


def tree(wide, root):
    """A geom's tree as nested tuples, node numbers left out: per child
    slot its box, count and (for an inner child) its subtree."""
    def node(n):
        out = []
        for k in range(WIDTH):
            ref, cnt = (int(v) for v in wide.ref[n, :, k])
            sub = node(ref) if cnt == 0 else ref
            out.append((tuple(wide.box[n, :, k].tolist()), cnt, sub))
        return tuple(out)
    return node(int(root))


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


@pytest.mark.parametrize("name", ["mesh", "mesh_big", "two_meshes"])
def test_nee_wide_tables_hold_every_geom(scenes, name):
    """Every mesh geom has a root in the NEE tables, the sorted route's
    too, and its tree is the one #8's collapse gives it (over every geom
    as dense, as chip_smoke.py's dense yardstick packs them); with no geom
    on the sorted route the NEE tables are #8's own."""
    td, t = scenes[name]
    w = t.nee_wide
    assert w.walked == len(td.mesh_geoms) and bool((w.root >= 0).all())
    assert tmk.nee_stack(w) == (WIDTH - 1) * w.depth <= tmk.NEE_STACK_MAX
    sorted_ = tpipe.sorted_geoms(td)
    assert (w is t.wide) == (not sorted_)
    assert bool(sorted_) == (name == "mesh_big")
    threshold = tpipe.SORT_SUPER_MIN_TRIS
    tpipe.SORT_SUPER_MIN_TRIS = 2**31  # every geom dense
    try:
        dense = tpipe.pack_wide_tables(td)
    finally:
        tpipe.SORT_SUPER_MIN_TRIS = threshold
    for k, g in enumerate(td.mesh_geoms):
        if g in sorted_:
            assert int(t.wide.root[k]) == -1
        else:
            assert tree(t.wide, t.wide.root[k]) == tree(w, w.root[k])
        assert tree(dense, dense.root[k]) == tree(w, w.root[k])
    assert w.depth == dense.depth


@pytest.mark.parametrize("name", ["mesh", "mesh_big"])
def test_nee_wide_walk_matches_binary_walk(scenes, name):
    """The nearest hit over the NEE tables against the binary walk on
    seeded rays: distance and winning triangle bit for bit on every lane
    but those where the wide walk met a triangle an ulp inside a box's
    slab entry (counted; at most 1%), and the lane rule on every output.
    Seeded from the object-space image of half the hit distance, a lane
    keeps its winner where it is strictly nearer than the seed."""
    td, t = scenes[name]
    w = t.nee_wide
    (g,) = td.mesh_geoms
    o, d = aimed_rays(td, g, 2048, seed=21)
    pb, pw = {}, {}
    want = tbvh.mesh_intersect_bvh(td, g, tv(o), tv(d), probe=pb)
    got = tbvh.mesh_intersect_wide(td, w, g, int(w.root[0]), tv(o), tv(d), probe=pw,
                                   nee=True)
    hit = want[0].numpy() > 0
    assert 0.3 < hit.mean() < 0.95
    off = ((got[0].numpy().view(np.int32) != want[0].numpy().view(np.int32))
           | (pw["tri"].numpy() != pb["tri"].numpy()))
    assert off.mean() <= 0.01, int(off.sum())
    assert_lane_rule([got[0].numpy(), *(c.numpy()[hit] for c in got[1]),
                      got[3].numpy()[hit], got[4].numpy()[hit]],
                     [want[0].numpy(), *(c.numpy()[hit] for c in want[1]),
                      want[3].numpy()[hit], want[4].numpy()[hit]])
    assert (got[2].numpy()[hit] != want[2].numpy()[hit]).mean() <= 0.01
    # the walk's work: a fraction of the binary walk's steps
    assert int(pw["nodes"].sum() + pw["leaves"].sum()) < int(pb["nodes"].sum()) / 3
    assert int(pw["stack"].max()) - 1 <= (WIDTH - 1) * w.depth
    # #8's order (every entered child by tmin) finds the same winners
    p8 = {}
    tbvh.mesh_intersect_wide(td, w, g, int(w.root[0]), tv(o), tv(d), probe=p8)
    assert float((p8["tri"] != pw["tri"]).float().mean()) <= 0.001

    # seeded: each lane's object-space t halved (FLT_MAX on a miss)
    obj_t = tbvh._wide_walk(td, w, g, int(w.root[0]), tv(o),
                            *tbvh._object_ray(td, g, tv(o), tv(d)), None, None, None,
                            True)[0]
    seed = torch.where(torch.from_numpy(hit), obj_t * 0.5, FLT_MAX)
    seed[::3] = FLT_MAX  # a third unseeded
    ps = {}
    tbvh.mesh_intersect_wide(td, w, g, int(w.root[0]), tv(o), tv(d), probe=ps, t_max=seed,
                             nee=True)
    nearer = (pw["tri"] >= 0) & (obj_t < seed)
    assert torch.equal(ps["tri"], torch.where(nearer, pw["tri"], -1))
    assert bool((ps["nodes"] <= pw["nodes"]).all())


@pytest.mark.parametrize("name", ["mesh", "mesh_big"])
def test_nee_shadow_walk_matches_binary_nearest_hit(scenes, name):
    """The shadow walk against the plain estimator's rule on the binary
    walk's nearest hit: occluded iff its world distance lies in (0,
    bound), on all but 1% of lanes, bounds drawn around the hits; a
    blocked lane tested a leaf, and the walk's stack stayed within the
    kernels' (nee_stack)."""
    td, t = scenes[name]
    w = t.nee_wide
    (g,) = td.mesh_geoms
    o, d = aimed_rays(td, g, 2048, seed=22)
    want_t = tbvh.mesh_intersect_bvh(td, g, tv(o), tv(d))[0]
    rng = np.random.default_rng(23)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, want_t.shape[0]).astype(np.float32))
    bound = torch.where(want_t > 0, want_t * scale, torch.tensor(5.0))
    ps = {}
    occ = tbvh.mesh_occluded_wide(td, w, g, int(w.root[0]), tv(o), tv(d), bound, probe=ps)
    want = (want_t > 0) & (want_t < bound)
    assert 0.2 < float(want.float().mean()) < 0.8
    assert float((occ != want).float().mean()) <= 0.01
    assert bool((ps["leaves"][occ] >= 1).all())
    assert int(ps["stack"].max()) - 1 <= tmk.nee_stack(w)


def test_tree_deeper_than_the_nee_stack_is_refused(scenes):
    """mesh.txt's icosphere over a chain BVH (wide depth past
    NEE_STACK_MAX / (WIDTH - 1)): packing the tables under `nee` raises a
    ValueError naming the depth; #8's tables (no `nee`) still pack, and
    the plain binary walk of the chain gives the scene's own hits (but on
    slab-ulp lanes, at most 1%)."""
    td, _ = scenes["mesh"]
    (g,) = td.mesh_geoms
    deep = chain_bvh(td, g)
    wide = tpipe.pack_wide_tables(deep, every=True)
    assert tmk.nee_stack(wide) > tmk.NEE_STACK_MAX
    with pytest.raises(ValueError, match=f"depth {wide.depth}"):
        tmk.pack_scene_tables(deep, nee=True)
    assert tmk.pack_scene_tables(deep).nee_wide is None
    o, d = aimed_rays(td, g, 256, seed=24)
    got = tbvh.mesh_intersect_bvh(deep, g, tv(o), tv(d))[0]
    want = tbvh.mesh_intersect_bvh(td, g, tv(o), tv(d))[0]
    assert float((got != want).float().mean()) <= 0.01
    assert float((want > 0).float().mean()) > 0.3


def test_deep_tree_within_the_nee_stack_walks(scenes):
    """A chain BVH over 600 of the icosphere's triangles (wide depth past
    14, a stack of more than the 48 KB a block takes without opting in,
    and twice the scenes' deepest tree's) packs under `nee` with its
    stack from its depth; its wide walk in the kernels' order finds the
    binary walk's hit and winning triangle on all but 1% of lanes, within
    that stack."""
    td, _ = scenes["mesh"]
    (g,) = td.mesh_geoms
    deep = chain_bvh(td, g, count=600)
    w = tmk.pack_scene_tables(deep, nee=True).nee_wide
    assert w.depth >= 14 and tmk.nee_stack(w) * 4 * 128 > 48 * 1024
    assert tmk.nee_stack(w) <= tmk.NEE_STACK_MAX
    o, d = aimed_rays(td, g, 1024, seed=25)
    pb, pw = {}, {}
    want = tbvh.mesh_intersect_bvh(deep, g, tv(o), tv(d), probe=pb)
    tbvh.mesh_intersect_wide(deep, w, g, int(w.root[0]), tv(o), tv(d), probe=pw, nee=True)
    assert float((want[0] > 0).float().mean()) > 0.05
    assert float((pw["tri"] != pb["tri"]).float().mean()) <= 0.01
    assert int(pw["stack"].max()) - 1 <= tmk.nee_stack(w)
