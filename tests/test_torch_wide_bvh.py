"""The wide BVH that kernel #8 walks (models/wide_bvh.py, packed by
ops/pipeline.py::pack_wide_tables) and its plain walk
(ops/bvh_traverse.py::mesh_intersect_wide), on the CPU: the collapse puts
every triangle in exactly one leaf, in BVH order; every child box
encloses its subtree; the recorded depth is the tree's and the walk's
stack stays within its bound, on mesh.txt, mesh_big.txt (collapsed as the
dense walk would) and a scene of two mesh geoms; the wide walk matches the
binary walk (`mesh_intersect_bvh`) under the lane rule of
tests/test_megakernel.py:57-76; and the port's plain #7 -> wide walk ->
#10 chain on mesh.txt at 32x32 matches the JAX package's XLA intersect
path, run as tests/test_torch_mesh_intersect.py runs it."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops.camera import generate_rays as jgen
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.models import wide_bvh
from project3_cuda_path_tracer_tpu_torch.ops import bvh_traverse as tbvh
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from tests.conftest import SCENES
from tests.test_torch_mesh_intersect import (
    assert_isect_close,
    assert_lane_rule,
    both_mesh_scenes,
    mesh_rays,
)
from tests.test_torch_mesh_load import two_mesh_scene
from tests.test_torch_ops import arr, jv, tv

W = wide_bvh.WIDTH


@functools.lru_cache(maxsize=None)
def port_scene(path):
    return tdevice.scene_to_device(tscene.load_scene(path), "cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (port DeviceScene, its wide tables over every mesh geom,
    as the dense walk would have them)."""
    paths = {
        "mesh": os.path.join(SCENES, "mesh.txt"),
        "mesh_big": os.path.join(SCENES, "mesh_big.txt"),
        "two_meshes": two_mesh_scene(tmp_path_factory.mktemp("two")),
    }
    out = {}
    threshold = tpipe.SORT_SUPER_MIN_TRIS
    tpipe.SORT_SUPER_MIN_TRIS = 2**31  # every geom dense, mesh_big's too
    try:
        for name, path in paths.items():
            td = port_scene(path)
            out[name] = (td, tpipe.pack_wide_tables(td))
    finally:
        tpipe.SORT_SUPER_MIN_TRIS = threshold
    return out


def walk_tree(wide, root):
    """Depth-first over a geom's wide tree in child order: its leaves
    (first, count) in that order, its deepest inner-node depth, and (box,
    child reference, child count, depth) of every child slot used."""
    leaves, slots, depth = [], [], 0
    todo = [(int(root), 1)]
    while todo:
        node, dep = todo.pop()
        depth = max(depth, dep)
        kids = []
        for k in range(W):
            ref, cnt = (int(v) for v in wide.ref[node, :, k])
            if cnt < 0:
                continue
            slots.append((wide.box[node, :, k].numpy(), ref, cnt, dep))
            kids.append((ref, cnt))
        assert kids, "a wide node without children"
        for ref, cnt in reversed(kids):  # the stack pops the first child first
            if cnt == 0:
                todo.append((ref, dep + 1))
        for ref, cnt in kids:
            if cnt > 0:
                leaves.append((ref, cnt, node))
    return leaves, slots, depth


def leaves_in_order(wide, root):
    """The leaves of a geom's tree, in child order depth first."""
    out = []

    def visit(node):
        for k in range(W):
            ref, cnt = (int(v) for v in wide.ref[node, :, k])
            if cnt == 0:
                visit(ref)
            elif cnt > 0:
                out.append((ref, cnt))

    visit(int(root))
    return out


@pytest.mark.parametrize("name", ["mesh", "mesh_big", "two_meshes"])
def test_leaves_cover_every_triangle_once_in_bvh_order(scenes, name):
    td, wide = scenes[name]
    assert len(td.mesh_geoms) == (2 if name == "two_meshes" else 1)
    for k, g in enumerate(td.mesh_geoms):
        start, count = td.tri_ranges[g]
        leaves = leaves_in_order(wide, wide.root[k])
        assert all(1 <= cnt <= W for _, cnt in leaves)
        firsts = [ref for ref, _ in leaves]
        ends = [ref + cnt for ref, cnt in leaves]
        assert firsts[0] == start and ends[-1] == start + count
        assert firsts[1:] == ends[:-1]  # contiguous, ascending, disjoint


@pytest.mark.parametrize("name", ["mesh", "mesh_big", "two_meshes"])
def test_child_boxes_enclose_their_subtrees(scenes, name):
    """A leaf's box holds its triangles' corners, an inner child's box
    every box of its node (object space, exactly: they are min / max of
    the same float32 values)."""
    td, wide = scenes[name]
    corners = torch.stack([torch.stack(list(v), 1) for v in
                           (td.tri_v0, td.tri_v1, td.tri_v2)], 1).numpy()
    for k, g in enumerate(td.mesh_geoms):
        _, slots, _ = walk_tree(wide, wide.root[k])
        for box, ref, cnt, _ in slots:
            lo, hi = box[:3], box[3:]
            if cnt > 0:
                pts = corners[ref:ref + cnt].reshape(-1, 3)
            else:
                used = wide.ref[ref, 1].numpy() >= 0
                b = wide.box[ref].numpy()[:, used]
                pts = np.concatenate([b[:3].T, b[3:].T])
            assert (pts >= lo).all() and (pts <= hi).all()


@pytest.mark.parametrize("name", ["mesh", "mesh_big", "two_meshes"])
def test_depth_and_stack_bound(scenes, name):
    """The tables' stack size is (WIDTH - 1) x depth + 1 for the deepest
    tree, the plain walk's stack never goes past it, and collapsing cuts
    the binary tree's depth at least in half."""
    td, wide = scenes[name]
    depths = [walk_tree(wide, wide.root[k])[2] for k in range(len(td.mesh_geoms))]
    assert wide.stack == wide_bvh.stack_bound(max(depths))
    for k, g in enumerate(td.mesh_geoms):
        start, count = td.bvh_roots[g]
        skip = td.bvh_skip.numpy()
        leaf = td.bvh_leaf.numpy()
        binary = 0
        todo = [(start, 1)]
        while todo:  # the binary tree's depth
            i, dep = todo.pop()
            binary = max(binary, dep)
            if not leaf[i]:
                todo += [(i + 1, dep + 1), (int(skip[i + 1]), dep + 1)]
        assert depths[k] <= (binary + 1) // 2
    # the walk, on rays aimed at the first mesh geom's box
    g = td.mesh_geoms[0]
    lo, hi = (np.asarray(td.mesh_obj_aabbs[g][:3]), np.asarray(td.mesh_obj_aabbs[g][3:]))
    xf = td.transform[g].numpy()
    rng = np.random.default_rng(7)
    n = 512
    aim = rng.uniform(lo, hi, (n, 3)) @ xf[:3, :3].T + xf[:3, 3]
    o = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    probe = {}
    t, *_ = tbvh.mesh_intersect_wide(td, wide, g, int(wide.root[0]),
                                     tv(o.astype(np.float32)), tv(d.astype(np.float32)),
                                     probe=probe)
    assert (t > 0).float().mean() > 0.2
    assert int(probe["stack"].max()) <= wide.stack
    assert bool((probe["leaves"] >= 1).any())
    assert bool((probe["tris"] <= W * probe["leaves"]).all())


@pytest.mark.parametrize("name", ["mesh", "two_meshes"])
def test_wide_walk_matches_binary_walk(scenes, name):
    """mesh_intersect_wide against mesh_intersect_bvh on seeded rays, per
    mesh geom, under the lane rule; the object-space winner differs only
    where a triangle's t lies an ulp inside a box's slab entry, which
    these rays never meet."""
    td, wide = scenes[name]
    o, d = mesh_rays(2048, seed=11)
    for k, g in enumerate(td.mesh_geoms):
        want = tbvh.mesh_intersect_bvh(td, g, tv(o), tv(d))
        got = tbvh.mesh_intersect_wide(td, wide, g, int(wide.root[k]), tv(o), tv(d))
        hit = want[0].numpy() > 0
        if name == "mesh":
            assert 0.3 < hit.mean() < 0.9
        assert_lane_rule([got[0].numpy(), *(c.numpy()[hit] for c in got[1]),
                          got[3].numpy()[hit], got[4].numpy()[hit]],
                         [want[0].numpy(), *(c.numpy()[hit] for c in want[1]),
                          want[3].numpy()[hit], want[4].numpy()[hit]])
        assert (got[0].numpy() != want[0].numpy()).mean() <= 0.001
        assert (got[2].numpy()[hit] != want[2].numpy()[hit]).mean() <= 0.01


def test_wide_sweep_matches_binary_sweep_on_two_meshes(scenes):
    """#8's two plain versions over #7's plain candidates on rays that see
    both mesh geoms (some lanes are candidates of both): the lane rule,
    and per lane the same work counted (`walks`), the wide one in fewer
    steps."""
    td, wide = scenes["two_meshes"]
    o, d = mesh_rays(2048, seed=12)
    aim = np.float32([2.0, 2.0, -2.0])  # the quad's centre
    rng = np.random.default_rng(13)
    src = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (512, 3)).astype(np.float32)
    dq = aim + rng.normal(0, 0.5, (512, 3)).astype(np.float32) - src
    dq /= np.linalg.norm(dq, axis=1, keepdims=True)
    o, d = np.concatenate([o, src]), np.concatenate([d, dq]).astype(np.float32)
    cands = tpipe.mesh_candidates_reference(tv(o), tv(d), None, td)
    pb, pw = {}, {}
    want = tpipe.mesh_sweep_reference(tv(o), tv(d), cands, td, probe=pb)
    got = tpipe.mesh_sweep_wide_reference(tv(o), tv(d), cands, td, wide, probe=pw)
    assert int((pw["walks"] == 2).sum()) > 0  # lanes that are candidates of both
    assert torch.equal(pw["walks"], pb["walks"])
    assert int(pw["nodes"].sum() + pw["leaves"].sum()) < int(pb["nodes"].sum()) / 3
    assert_lane_rule([a.numpy() for a in (got.t, *got.normal, got.tex_u, got.tex_v)],
                     [a.numpy() for a in (want.t, *want.normal, want.tex_u, want.tex_v)])
    assert (got.material_id != want.material_id).float().mean() <= 0.001
    assert torch.equal(got.has_uv, want.has_uv) or (
        (got.has_uv != want.has_uv).float().mean() <= 0.001)


def test_wide_chain_matches_jax_xla_intersect():
    """The port's plain #7 -> wide walk -> #10 on mesh.txt's 32x32 camera
    rays and seeded rays against the JAX `intersect_scene_any` on its XLA
    path: the lane rule, material ids and flags on all but 1% of lanes."""
    jd, td, jc, _ = both_mesh_scenes()
    co, cd, _ = jgen(jc, jnp.int32(1), False, False)
    o, d = mesh_rays(1024, seed=14)
    o = np.concatenate([arr(co), o])
    d = np.concatenate([arr(cd), d])
    jset = jrender.RenderSettings(use_pallas=False)
    want = jax.jit(jrender.intersect_scene_any, static_argnames="settings")(
        jv(o), jv(d), jd, jset)
    cands = tpipe.mesh_candidates_reference(tv(o), tv(d), None, td)
    hits = tpipe.mesh_sweep_wide_reference(tv(o), tv(d), cands, td)
    got = tpipe.merge_hits(cands, hits)
    assert_isect_close(got, want)
    assert (got.material_id.numpy() == 4).mean() > 0.2  # the mesh is seen
    assert bool((hits.t[~cands.cand] == -1).all())
