"""Whole-scene intersection sweep: min-t over all geoms for the path pool.

The plain PyTorch twin of the JAX package's `ops/sweep.py`: the CUDA
reference's per-thread linear scan over geoms (computeIntersections,
src/pathtrace.cu:149-213) becomes a Python loop over the geom list, each
step a batched primitive test over the whole pool, in geom-index order
with the strict-< update. A mesh instance intersects in object space,
through its BVH (ops/bvh_traverse.py) or, without it, a naive sweep over
all its triangles.
"""

from __future__ import annotations

import torch

from ..models.device import DeviceScene
from ..models.scene import GeomType
from .bvh_traverse import mesh_intersect_bvh
from .intersect import (
    FLT_MAX,
    MISS,
    RAY_EPS,
    Intersections,
    box_intersect,
    closer_hit,
    sphere_intersect,
    transform_dir,
    transform_point,
    triangle_intersect,
)
from .vec import Vec3, take as vtake, where as vwhere

# triangles per step of the naive sweep: each step tests (chunk, P) pairs
_TRI_CHUNK = 64


def _mesh_intersect_naive(scene: DeviceScene, geom_index: int, origins: Vec3,
                          dirs: Vec3):
    """Naive triangle sweep for one mesh instance (the BVH-off path, the
    comparison baseline of INSTRUCTION.md:128-131): the first triangle of
    the geom's range with the least t wins, as in the JAX package's
    chunked sweep.

    Returns (dist (P,), normal Vec3, outside (P,), tex_u (P,), tex_v (P,))
    with tex_u/v the interpolated OBJ texture coordinates of the winning
    triangle (zeros when the mesh has no vt records)."""
    start, count = scene.tri_ranges[geom_index]
    inv = scene.inverse_transform[geom_index]
    xf = scene.transform[geom_index]
    inv_t = scene.inv_transpose[geom_index]

    ro = transform_point(inv, origins)
    rd = transform_dir(inv, dirs).normalize()
    P = ro.x.shape[0]
    device = ro.x.device
    ro_b = Vec3(ro.x[None, :], ro.y[None, :], ro.z[None, :])
    rd_b = Vec3(rd.x[None, :], rd.y[None, :], rd.z[None, :])

    bt = torch.full((P,), FLT_MAX, dtype=torch.float32, device=device)
    bidx = torch.zeros(P, dtype=torch.int64, device=device)
    bu = torch.zeros(P, dtype=torch.float32, device=device)
    bv = torch.zeros(P, dtype=torch.float32, device=device)
    for c0 in range(0, count, _TRI_CHUNK):
        lo, hi = start + c0, start + min(count, c0 + _TRI_CHUNK)

        def col(v: Vec3) -> Vec3:
            return Vec3(v.x[lo:hi, None], v.y[lo:hi, None], v.z[lo:hi, None])

        t, u, v, _ = triangle_intersect(col(scene.tri_v0), col(scene.tri_v1),
                                        col(scene.tri_v2), ro_b, rd_b)
        row = torch.argmin(t, dim=0)  # the first least t
        tmin = t.gather(0, row[None, :])[0]
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bidx = torch.where(better, c0 + row, bidx)
        bu = torch.where(better, u.gather(0, row[None, :])[0], bu)
        bv = torch.where(better, v.gather(0, row[None, :])[0], bv)

    hit = bt < FLT_MAX
    tri = start + bidx
    w = 1.0 - bu - bv
    n_obj = (vtake(scene.tri_n0, tri) * w + vtake(scene.tri_n1, tri) * bu
             + vtake(scene.tri_n2, tri) * bv).normalize()
    if scene.mesh_has_uv[geom_index]:
        tex_u = (w * scene.tri_uv0u[tri] + bu * scene.tri_uv1u[tri]
                 + bv * scene.tri_uv2u[tri])
        tex_v = (w * scene.tri_uv0v[tri] + bu * scene.tri_uv1v[tri]
                 + bv * scene.tri_uv2v[tri])
    else:
        tex_u = tex_v = torch.zeros_like(bt)

    p_obj = ro + rd * (bt - RAY_EPS)
    p_world = transform_point(xf, p_obj)
    n_world = transform_dir(inv_t, n_obj).normalize()
    outside = n_world.dot(dirs) < 0.0
    n_world = n_world * torch.where(outside, 1.0, -1.0)
    dist = (origins - p_world).length()
    return torch.where(hit, dist, MISS), n_world, outside, tex_u, tex_v


def intersect_scene(origins: Vec3, dirs: Vec3, scene: DeviceScene,
                    use_bvh: bool = True, meshes: bool = True) -> Intersections:
    """Min-t sweep over all geoms; per src/pathtrace.cu:176-211 update rule.
    `use_bvh` picks the mesh traversal (the BVH where the geom has one);
    `meshes=False` sweeps the analytic geoms alone (kernel #7's plain
    version)."""
    P = origins.x.shape[0]
    device = origins.x.device
    best_t = torch.full((P,), MISS, dtype=torch.float32, device=device)
    best_n = Vec3.zeros(P, device)
    best_mat = torch.full((P,), -1, dtype=torch.int32, device=device)
    best_outside = torch.ones(P, dtype=torch.bool, device=device)
    best_u = torch.zeros(P, dtype=torch.float32, device=device)
    best_v = torch.zeros(P, dtype=torch.float32, device=device)
    best_has_uv = torch.zeros(P, dtype=torch.bool, device=device)

    for i, gt in enumerate(scene.gtypes):
        tex_u = tex_v = None
        if gt == int(GeomType.SPHERE):
            t, n, outside = sphere_intersect(
                scene.transform[i],
                scene.inverse_transform[i],
                scene.inv_transpose[i],
                origins,
                dirs,
            )
        elif gt == int(GeomType.CUBE):
            t, n, outside = box_intersect(
                scene.transform[i], scene.inverse_transform[i], origins, dirs
            )
        elif gt == int(GeomType.MESH):
            if not meshes or scene.tri_ranges[i][1] == 0:
                continue
            traverse = (mesh_intersect_bvh
                        if use_bvh and scene.bvh_roots[i][1] > 0
                        else _mesh_intersect_naive)
            t, n, outside, tex_u, tex_v = traverse(scene, i, origins, dirs)
        else:
            raise ValueError(f"unknown geom type {gt}")

        better = closer_hit(t, best_t)
        best_t = torch.where(better, t, best_t)
        best_n = vwhere(better, n, best_n)
        best_mat = torch.where(better, scene.geom_material_id[i], best_mat)
        best_outside = torch.where(better, outside, best_outside)
        if tex_u is not None and scene.mesh_has_uv[i]:
            best_u = torch.where(better, tex_u, best_u)
            best_v = torch.where(better, tex_v, best_v)
            best_has_uv = best_has_uv | better
        else:
            best_has_uv = best_has_uv & ~better

    return Intersections(
        t=best_t, normal=best_n, material_id=best_mat, outside=best_outside,
        tex_u=best_u, tex_v=best_v, has_uv=best_has_uv,
    )
