"""Direct lighting: a point sampled on an emissive geom (next-event
estimation), plain PyTorch.

The twin of the JAX package's `ops/lights.py`, op for op: one uniform
point on one uniformly chosen emissive geom per lane, with its surface
normal, the inverse pdf of the (light, point) choice and the light's
emitted radiance. The shadow ray and the MIS weights are the caller's
(render._nee_mis_bounce, render._nee_final_step). The CUDA kernels
compute the same sample in csrc/path_common.cuh (`sample_light`).

Light surfaces are the two analytic primitives:
- cube: a face chosen by world-area weights |c_i x c_j| of the instance
  transform's columns, the point uniform on that face;
- sphere: a uniform direction scaled to radius 0.5 in object space (the
  world area assumes a uniform scale, as the scenes have).
"""

from __future__ import annotations

import math

import torch

from ..models.device import DeviceScene
from ..models.scene import GeomType
from ..utils.math3d import TWO_PI
from .intersect import transform_dir, transform_point
from .vec import Vec3, where as vwhere


def _columns(xf: torch.Tensor):
    """The first three columns of a (4,4) transform, as Vec3 scalars."""
    return tuple(Vec3(xf[0, j], xf[1, j], xf[2, j]) for j in range(3))


def _cube_light_sample(xf, inv_t, u1, u2, u3):
    """Uniform point on a transformed unit cube's surface. Returns
    (point Vec3, normal Vec3, total world area, a 0-d tensor)."""
    c0, c1, c2 = _columns(xf)
    a_x = c1.cross(c2).length()  # +-x faces
    a_y = c0.cross(c2).length()
    a_z = c0.cross(c1).length()
    total = 2.0 * (a_x + a_y + a_z)

    t = u3 * total
    # face picker: [ax, ax, ay, ay, az, az] cumulative
    pick_x = t < 2 * a_x
    pick_y = (~pick_x) & (t < 2 * a_x + 2 * a_y)
    # sign: the second half of each pair
    sgn_x = torch.where(t < a_x, 0.5, -0.5)
    sgn_y = torch.where(t - 2 * a_x < a_y, 0.5, -0.5)
    sgn_z = torch.where(t - 2 * a_x - 2 * a_y < a_z, 0.5, -0.5)

    e1 = u1 - 0.5
    e2 = u2 - 0.5
    p_obj = Vec3(
        torch.where(pick_x, sgn_x, e1),
        torch.where(pick_x, e1, torch.where(pick_y, sgn_y, e2)),
        torch.where(pick_x | pick_y, e2, sgn_z),
    )
    n_obj = Vec3(
        torch.where(pick_x, torch.sign(sgn_x), 0.0),
        torch.where(pick_y, torch.sign(sgn_y), 0.0),
        torch.where(pick_x | pick_y, 0.0, torch.sign(sgn_z)),
    )
    p_world = transform_point(xf, p_obj)
    n_world = transform_dir(inv_t, n_obj).normalize()
    return p_world, n_world, total


def _sphere_light_sample(xf, inv_t, u1, u2):
    """Uniform point on a transformed radius-0.5 sphere (uniform scale
    assumed for the area)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    p_obj = Vec3(r * torch.cos(phi), r * torch.sin(phi), z) * 0.5
    p_world = transform_point(xf, p_obj)
    n_world = transform_dir(inv_t, p_obj).normalize()
    scale = _columns(xf)[0].length()
    area = math.pi * scale * scale  # 4*pi*(0.5*scale)^2
    return p_world, n_world, area


def sample_lights(scene: DeviceScene, u_light, u1, u2):
    """One point on one (uniformly chosen) emissive geom per lane.

    Returns (point Vec3, normal Vec3, weight = area * n_lights, Le Vec3):
    weight is the inverse pdf of the (light, point) choice and Le the
    chosen light's emitted radiance (colour * emittance, untextured). A
    lane whose u_light * n_lights floors to no light index gets zeros."""
    lights = scene.emissive_geoms
    n = len(lights)
    if n == 0:
        raise ValueError("direct lighting needs an emissive geom")

    P = u1.shape[0]
    device = u1.device
    point = Vec3.zeros(P, device)
    normal = Vec3.zeros(P, device)
    weight = torch.zeros(P, dtype=torch.float32, device=device)
    le = Vec3.zeros(P, device)

    pick_idx = torch.floor(u_light * n).to(torch.int32)
    for k, gi in enumerate(lights):
        xf = scene.transform[gi]
        inv_t = scene.inv_transpose[gi]
        if scene.gtypes[gi] == int(GeomType.SPHERE):
            p, nrm, area = _sphere_light_sample(xf, inv_t, u1, u2)
        else:
            # the face picker consumes u_light's fractional remainder
            p, nrm, area = _cube_light_sample(
                xf, inv_t, u1, u2, (u_light * n) % 1.0
            )
        mid = scene.geom_material_id[gi].long()  # stays on the device
        emit = scene.mat_emittance[mid]
        le_k = Vec3(scene.mat_color.x[mid] * emit, scene.mat_color.y[mid] * emit,
                    scene.mat_color.z[mid] * emit)
        pick = pick_idx == k
        point = vwhere(pick, p, point)
        normal = vwhere(pick, nrm, normal)
        weight = torch.where(pick, area * n, weight)
        le = vwhere(pick, le_k, le)

    return point, normal, weight, le


def lights_area_weight(scene: DeviceScene) -> torch.Tensor:
    """The mean light area x n_lights, a float32 0-d tensor on the
    scene's device: the light pdf model that both MIS weights share
    (render._nee_mis_bounce, the NEE kernels), never a sampling pdf, so
    it need not be exact per light. Float32 ops in the JAX package's
    order (its render._lights_area_weight); 1.0 without lights."""
    areas = []
    for gi in scene.emissive_geoms:
        xf = scene.transform[gi]
        if scene.gtypes[gi] == int(GeomType.SPHERE):
            s = _columns(xf)[0].length()
            areas.append(math.pi * s * s)
        else:
            c0, c1, c2 = _columns(xf)
            areas.append(
                2.0 * (c1.cross(c2).length() + c0.cross(c2).length()
                       + c0.cross(c1).length())
            )
    if not areas:
        return torch.tensor(1.0, dtype=torch.float32, device=scene.device)
    return sum(areas) / len(areas) * len(areas)
