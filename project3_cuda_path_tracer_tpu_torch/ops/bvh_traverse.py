"""Stackless BVH traversal over the path pool (plain PyTorch).

The twin of the JAX package's `ops/bvh_traverse.py::mesh_intersect_bvh`:
over the flat preorder + escape-pointer layout of models/bvh.py each
lane's whole traversal state is one int32 cursor,
    hit node i's AABB ? (leaf ? test its triangles, go skip[i]
                               : descend to i+1)
                      : jump to skip[i]
and the whole pool advances in lock-step, one node per step, until every
lane has left the geom's node range. On a CUDA tensor each step reads a
`while any(active)` flag back to the host; this version is the plain
reference of kernel #8 (csrc/mesh.cu, `mesh_sweep`), which walks the same
nodes in the same order, one thread per ray.
"""

from __future__ import annotations

import torch

from ..models.bvh import LEAF_SIZE
from ..models.device import DeviceScene
from .intersect import (
    FLT_MAX,
    MISS,
    RAY_EPS,
    transform_dir,
    transform_point,
    triangle_intersect,
)
from .vec import Vec3, take as vtake


def _aabb_hit(nmin: Vec3, nmax: Vec3, o: Vec3, inv_d: Vec3, t_best):
    """Slab test against per-lane AABBs (IEEE inf for axis-parallel
    rays), pruning nodes that start past the best hit so far."""
    t1 = (nmin - o) * inv_d
    t2 = (nmax - o) * inv_d
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t1.x, t2.x), torch.minimum(t1.y, t2.y)),
        torch.minimum(t1.z, t2.z),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t1.x, t2.x), torch.maximum(t1.y, t2.y)),
        torch.maximum(t1.z, t2.z),
    )
    return (tmax >= tmin) & (tmax > 0) & (tmin < t_best)


def mesh_intersect_bvh(scene: DeviceScene, geom_index: int, origins: Vec3,
                       dirs: Vec3, probe: dict | None = None):
    """BVH-accelerated intersection with one mesh instance.

    Returns (dist (P,), normal Vec3, outside (P,), tex_u (P,), tex_v (P,))
    with the naive sweep's distance/normal/UV semantics (ops/sweep.py).

    probe: a dict that, when given, receives per lane the walk's work, for
    counting kernel #8's operations (chip_smoke.py's bounds): `nodes`, the
    nodes whose box the lane tested, and `tris`, the triangles it tested
    (both (P,) int64)."""
    node_start, node_count = scene.bvh_roots[geom_index]
    node_end = node_start + node_count
    inv = scene.inverse_transform[geom_index]
    xf = scene.transform[geom_index]
    inv_t = scene.inv_transpose[geom_index]

    ro = transform_point(inv, origins)
    rd = transform_dir(inv, dirs).normalize()
    inv_d = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    P = ro.x.shape[0]
    device = ro.x.device
    T = scene.tri_v0.x.shape[0]

    cur = torch.full((P,), node_start, dtype=torch.int64, device=device)
    bt = torch.full((P,), FLT_MAX, dtype=torch.float32, device=device)
    btri = torch.zeros(P, dtype=torch.int64, device=device)
    bu = torch.zeros(P, dtype=torch.float32, device=device)
    bv = torch.zeros(P, dtype=torch.float32, device=device)
    nodes = torch.zeros(P, dtype=torch.int64, device=device)
    tris = torch.zeros(P, dtype=torch.int64, device=device)

    while True:
        active = cur < node_end
        if not bool(active.any()):
            break
        safe = torch.clamp(cur, node_start, node_end - 1)
        hit = _aabb_hit(vtake(scene.bvh_min, safe), vtake(scene.bvh_max, safe),
                        ro, inv_d, bt) & active
        leaf = scene.bvh_leaf[safe]
        first = scene.bvh_first[safe].to(torch.int64)
        count = scene.bvh_count[safe]
        nodes += active

        # the leaf's (at most LEAF_SIZE) triangles, unrolled
        do_leaf = hit & leaf
        for k in range(LEAF_SIZE):
            tri = torch.clamp(first + k, 0, max(T - 1, 0))
            valid_k = do_leaf & (k < count)
            tris += valid_k
            t, u, v, ok = triangle_intersect(
                vtake(scene.tri_v0, tri), vtake(scene.tri_v1, tri),
                vtake(scene.tri_v2, tri), ro, rd,
            )
            better = valid_k & ok & (t < bt)
            bt = torch.where(better, t, bt)
            btri = torch.where(better, tri, btri)
            bu = torch.where(better, u, bu)
            bv = torch.where(better, v, bv)

        descend = hit & ~leaf
        nxt = torch.where(descend, cur + 1, scene.bvh_skip[safe].to(torch.int64))
        cur = torch.where(active, nxt, cur)

    if probe is not None:
        probe.update(nodes=nodes, tris=tris)
    hit = bt < FLT_MAX
    w = 1.0 - bu - bv
    n_obj = (vtake(scene.tri_n0, btri) * w + vtake(scene.tri_n1, btri) * bu
             + vtake(scene.tri_n2, btri) * bv).normalize()
    if scene.mesh_has_uv[geom_index]:
        tex_u = (w * scene.tri_uv0u[btri] + bu * scene.tri_uv1u[btri]
                 + bv * scene.tri_uv2u[btri])
        tex_v = (w * scene.tri_uv0v[btri] + bu * scene.tri_uv1v[btri]
                 + bv * scene.tri_uv2v[btri])
    else:
        tex_u = tex_v = torch.zeros_like(bt)

    p_obj = ro + rd * (bt - RAY_EPS)
    p_world = transform_point(xf, p_obj)
    n_world = transform_dir(inv_t, n_obj).normalize()
    outside = n_world.dot(dirs) < 0.0
    n_world = n_world * torch.where(outside, 1.0, -1.0)
    dist = (origins - p_world).length()
    return torch.where(hit, dist, MISS), n_world, outside, tex_u, tex_v
