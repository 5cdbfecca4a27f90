"""BVH traversal over the path pool (plain PyTorch): the binary walk and
the wide walk, the plain references of kernel #8.

`mesh_intersect_bvh` is the twin of the JAX package's
`ops/bvh_traverse.py::mesh_intersect_bvh`: over the flat preorder +
escape-pointer layout of models/bvh.py each lane's whole traversal state
is one int32 cursor,
    hit node i's AABB ? (leaf ? test its triangles, go skip[i]
                               : descend to i+1)
                      : jump to skip[i]
and the whole pool advances in lock-step, one node per step, until every
lane has left the geom's node range. The loop reads its `any(active)`
flag back to the host at every step on the CPU and every
`_FLAG_EVERY_CUDA` steps on a CUDA tensor, where a read waits for the
card (a finished lane's cursor stays past the range, so the steps in
between change nothing).

`mesh_intersect_wide` walks the wide BVH of models/wide_bvh.py in the
order kernel #8 (csrc/mesh.cu, `mesh_sweep`) walks it, a stack per lane,
nearest child first; the tests use it to check the wide tables and the
kernel's walk on the CPU.
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

_FLAG_EVERY_CUDA = 16


def _slab(lo: Vec3, hi: Vec3, o: Vec3, inv_d: Vec3):
    """The slab interval (tmin, tmax) of AABBs (IEEE inf for
    axis-parallel rays), the kernels' `slab_span`."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t1.x, t2.x), torch.minimum(t1.y, t2.y)),
        torch.minimum(t1.z, t2.z),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t1.x, t2.x), torch.maximum(t1.y, t2.y)),
        torch.maximum(t1.z, t2.z),
    )
    return tmin, tmax


def _aabb_hit(nmin: Vec3, nmax: Vec3, o: Vec3, inv_d: Vec3, t_best):
    """Slab test against per-lane AABBs, pruning nodes that start past
    the best hit so far."""
    tmin, tmax = _slab(nmin, nmax, o, inv_d)
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
    ro, rd, inv_d = _object_ray(scene, geom_index, origins, dirs)
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

    every = _FLAG_EVERY_CUDA if device.type == "cuda" else 1
    step = 0
    while True:
        active = cur < node_end
        if step % every == 0 and not bool(active.any()):
            break
        step += 1
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
    return _mesh_hit(scene, geom_index, origins, dirs, ro, rd, bt, btri, bu, bv)


def _object_ray(scene: DeviceScene, geom_index: int, origins: Vec3, dirs: Vec3):
    """The rays in the geom's object space: origin, normalised direction
    and its reciprocal."""
    inv = scene.inverse_transform[geom_index]
    ro = transform_point(inv, origins)
    rd = transform_dir(inv, dirs).normalize()
    return ro, rd, Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)


def _mesh_hit(scene: DeviceScene, geom_index: int, origins: Vec3, dirs: Vec3,
              ro: Vec3, rd: Vec3, bt, btri, bu, bv):
    """The world-space tail of a walk's winner (object-space t `bt`,
    FLT_MAX for none; triangle `btri`; barycentrics `bu`, `bv`): (dist,
    normal, outside, tex_u, tex_v) with the naive sweep's semantics."""
    xf = scene.transform[geom_index]
    inv_t = scene.inv_transpose[geom_index]
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


def mesh_intersect_wide(scene: DeviceScene, wide, geom_index: int, root: int,
                        origins: Vec3, dirs: Vec3, probe: dict | None = None):
    """One mesh instance's hits by a walk of its wide BVH
    (models/wide_bvh.py; `wide` holds the `box` and `ref` tables on the
    scene's device and `stack`, the entries a walk's stack may need), in
    the order kernel #8 (csrc/mesh.cu, `mesh_sweep`) walks it: a stack of
    (reference, count, tmin); pop the top, skip it when its tmin is past
    the best t; at an inner node slab-test every child against the best t
    (tmin <= t enters), push the entered ones nearest first (the lowest
    child on equal tmin); at a leaf test its triangles, the least (t,
    triangle) wins, and it replaces the best when (t, triangle) is less.
    Every ray advances one stack entry per step, until all stacks are
    empty. The winner is the least (t, triangle) of the triangles tested:
    the binary walk's, but where a triangle's t lies an ulp inside its
    box's slab entry. Returns what mesh_intersect_bvh returns.

    probe: a dict that, when given, receives per lane `nodes` (inner
    wide nodes expanded), `leaves` (leaves tested), `tris` (triangles
    tested) and `stack` (the deepest its stack went), each (P,) int64."""
    ro, rd, inv_d = _object_ray(scene, geom_index, origins, dirs)
    P = ro.x.shape[0]
    device = ro.x.device
    T = scene.tri_v0.x.shape[0]
    W = wide.box.shape[2]
    S = int(wide.stack)
    rows = torch.arange(P, device=device)
    kids = torch.arange(W, device=device)
    s_ref = torch.zeros((P, S), dtype=torch.int64, device=device)
    s_cnt = torch.zeros((P, S), dtype=torch.int64, device=device)
    s_tmin = torch.zeros((P, S), dtype=torch.float32, device=device)
    s_ref[:, 0] = root
    s_tmin[:, 0] = -float("inf")
    sp = torch.ones(P, dtype=torch.int64, device=device)
    bt = torch.full((P,), FLT_MAX, dtype=torch.float32, device=device)
    btri = torch.full((P,), T, dtype=torch.int64, device=device)
    bu = torch.zeros(P, dtype=torch.float32, device=device)
    bv = torch.zeros(P, dtype=torch.float32, device=device)
    work = {k: torch.zeros(P, dtype=torch.int64, device=device)
            for k in ("nodes", "leaves", "tris")}
    work["stack"] = sp.clone()
    col = lambda a: a[:, None]  # noqa: E731
    ro_w, rd_w, inv_w = (Vec3(col(v.x), col(v.y), col(v.z)) for v in (ro, rd, inv_d))

    while True:
        active = sp > 0
        if not bool(active.any()):
            break
        top = torch.clamp(sp - 1, min=0)
        ref, cnt, tm = s_ref[rows, top], s_cnt[rows, top], s_tmin[rows, top]
        sp = sp - active.long()
        keep = active & (tm <= bt)
        inner = keep & (cnt == 0)
        leaf = keep & (cnt > 0)

        # an inner node: its children, entered ones pushed nearest first
        node = torch.where(inner, ref, 0)
        box, kref = wide.box[node], wide.ref[node].long()  # (P,6,W), (P,2,W)
        tmin, tmax = _slab(Vec3(box[:, 0], box[:, 1], box[:, 2]),
                           Vec3(box[:, 3], box[:, 4], box[:, 5]), ro_w, inv_w)
        enter = (col(inner) & (kref[:, 1] >= 0) & (tmax >= tmin) & (tmax > 0)
                 & (tmin <= col(bt)))
        before = (tmin[:, None, :] < tmin[:, :, None]) | (
            (tmin[:, None, :] == tmin[:, :, None]) & (kids[None, :] < kids[:, None]))
        rank = (before & enter[:, None, :]).sum(2)
        n_enter = enter.sum(1)
        pos = col(sp + n_enter - 1) - rank
        p_i, k_i = torch.nonzero(enter, as_tuple=True)
        at = pos[p_i, k_i]
        s_ref[p_i, at] = kref[p_i, 0, k_i]
        s_cnt[p_i, at] = kref[p_i, 1, k_i]
        s_tmin[p_i, at] = tmin[p_i, k_i]
        sp = sp + n_enter

        # a leaf: its triangles, the least (t, triangle) against the best
        tri = col(ref) + kids[None, :]
        valid = col(leaf) & (kids[None, :] < col(cnt))
        safe = torch.clamp(tri, 0, max(T - 1, 0))
        t, u, v, ok = triangle_intersect(
            vtake(scene.tri_v0, safe), vtake(scene.tri_v1, safe),
            vtake(scene.tri_v2, safe), ro_w, rd_w)
        hit = valid & ok
        tt = torch.where(hit, t, float("inf"))
        mt = tt.min(1).values
        wk = (hit & (tt == col(mt))).to(torch.int8).argmax(1)
        wtri = tri[rows, wk]
        better = hit.any(1) & ((mt < bt) | ((mt == bt) & (wtri < btri)))
        bt = torch.where(better, mt, bt)
        btri = torch.where(better, wtri, btri)
        bu = torch.where(better, u[rows, wk], bu)
        bv = torch.where(better, v[rows, wk], bv)

        work["nodes"] += inner
        work["leaves"] += leaf
        work["tris"] += valid.sum(1)
        work["stack"] = torch.maximum(work["stack"], sp)

    if probe is not None:
        probe.update(work)
    # no hit: triangle 0's tail, as the binary walk gives it
    return _mesh_hit(scene, geom_index, origins, dirs, ro, rd, bt,
                     torch.where(bt < FLT_MAX, btri, 0), bu, bv)
