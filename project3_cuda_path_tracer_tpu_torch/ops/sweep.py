"""Whole-scene intersection sweep: min-t over all geoms for the path pool.

The plain PyTorch twin of the JAX package's `ops/sweep.py::intersect_scene`
for analytic geoms (spheres and boxes): the CUDA reference's per-thread
linear scan over geoms (computeIntersections, src/pathtrace.cu:149-213)
becomes a Python loop over the geom list, each step a batched primitive
test over the whole pool, in geom-index order with the strict-< update.
Mesh geoms arrive with the mesh slice (ROADMAP) and raise here.
"""

from __future__ import annotations

import torch

from ..models.device import DeviceScene
from ..models.scene import GeomType
from .intersect import (
    MISS,
    Intersections,
    box_intersect,
    closer_hit,
    sphere_intersect,
)
from .vec import Vec3, where as vwhere


def intersect_scene(origins: Vec3, dirs: Vec3, scene: DeviceScene) -> Intersections:
    """Min-t sweep over all geoms; per src/pathtrace.cu:176-211 update rule."""
    P = origins.x.shape[0]
    device = origins.x.device
    best_t = torch.full((P,), MISS, dtype=torch.float32, device=device)
    best_n = Vec3.zeros(P, device)
    best_mat = torch.full((P,), -1, dtype=torch.int32, device=device)
    best_outside = torch.ones(P, dtype=torch.bool, device=device)

    for i, gt in enumerate(scene.gtypes):
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
            raise NotImplementedError(
                "mesh geoms are not ported yet (ROADMAP, port slice 4)"
            )
        else:
            raise ValueError(f"unknown geom type {gt}")

        better = closer_hit(t, best_t)
        best_t = torch.where(better, t, best_t)
        best_n = vwhere(better, n, best_n)
        best_mat = torch.where(better, scene.geom_material_id[i], best_mat)
        best_outside = torch.where(better, outside, best_outside)

    return Intersections(
        t=best_t, normal=best_n, material_id=best_mat, outside=best_outside
    )
