"""Ray-primitive intersection over the whole path pool (plain PyTorch).

The twin of the JAX package's `ops/intersect.py`. It reimplements the
unit-object-space instance tests of the CUDA reference's
src/intersections.h:
- unit cube [-0.5,0.5]^3 slab test incl. inside/outside handling and the
  slab-winning normal (:48-90),
- radius-0.5 sphere quadratic, nearer-positive-root, inside normal flip
  (:102-144),
- object-space ray direction NORMALIZED before the test, returned "t" is
  the world-space euclidean distance |origin - hit|, -1 on miss,
- getPointOnRay's 1e-4 backoff (:27-29),
- box normals via `transform`, sphere normals via invTranspose;
and the lane-wise Moller-Trumbore triangle test of the mesh paths.

The 4x4 instance matrices are applied as scalar-broadcast multiply-adds,
so each lane's arithmetic matches the JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .vec import Vec3

RAY_EPS = 1e-4  # getPointOnRay backoff, src/intersections.h:28
MISS = -1.0
FLT_MAX = 3.402823466e38


@dataclass
class Intersections:
    """SoA ShadeableIntersection (src/sceneStructs.h:72-76) + outside flag
    + the interpolated OBJ texture coordinates of a UV-mapped mesh hit
    (zeros / False for analytic geoms and meshes without vt records)."""

    t: torch.Tensor  # (P,) world euclidean distance, -1 = miss
    normal: Vec3  # (P,) lanes, world normal, oriented per reference rules
    material_id: torch.Tensor  # (P,) int32, -1 on miss
    outside: torch.Tensor  # (P,) bool: the ray started outside the surface
    tex_u: torch.Tensor = None  # (P,) barycentric-interpolated OBJ u
    tex_v: torch.Tensor = None  # (P,)
    has_uv: torch.Tensor = None  # (P,) bool: tex_u/v valid on this lane

    def __post_init__(self):
        if self.tex_u is None:
            z = torch.zeros_like(self.t)
            self.tex_u, self.tex_v = z, z.clone()
            self.has_uv = torch.zeros_like(self.t, dtype=torch.bool)


def transform_point(m: torch.Tensor, p: Vec3) -> Vec3:
    """(4,4) @ [p,1] as scalar-broadcast multiply-adds."""
    return Vec3(
        m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3],
        m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3],
        m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3],
    )


def transform_dir(m: torch.Tensor, d: Vec3) -> Vec3:
    """(4,4) @ [d,0] as scalar-broadcast multiply-adds."""
    return Vec3(
        m[0, 0] * d.x + m[0, 1] * d.y + m[0, 2] * d.z,
        m[1, 0] * d.x + m[1, 1] * d.y + m[1, 2] * d.z,
        m[2, 0] * d.x + m[2, 1] * d.y + m[2, 2] * d.z,
    )


def _slab_axis(o, d):
    """Per-axis slab interval + entering-face sign (src/intersections.h:58-76).
    Relies on IEEE division: d == 0 gives +-inf."""
    t1 = (-0.5 - o) / d
    t2 = (0.5 - o) / d
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    sign = torch.where(t2 < t1, 1.0, -1.0)
    return ta, tb, sign


def box_intersect(transform, inverse_transform, origins: Vec3, dirs: Vec3):
    """Batched boxIntersectionTest (src/intersections.h:48-90).

    Returns (dist (P,), normal Vec3, outside (P,))."""
    q_o = transform_point(inverse_transform, origins)
    q_d = transform_dir(inverse_transform, dirs).normalize()

    tax, tbx, sx = _slab_axis(q_o.x, q_d.x)
    tay, tby, sy = _slab_axis(q_o.y, q_d.y)
    taz, tbz, sz = _slab_axis(q_o.z, q_d.z)

    # tmin = max over axes of positive ta; the winning axis gives the
    # entering-face normal
    tax_m = torch.where(tax > 0, tax, -FLT_MAX)
    tay_m = torch.where(tay > 0, tay, -FLT_MAX)
    taz_m = torch.where(taz > 0, taz, -FLT_MAX)
    tmin = torch.maximum(tax_m, torch.maximum(tay_m, taz_m))
    tmax = torch.minimum(tbx, torch.minimum(tby, tbz))

    win_x = tmin == tax_m
    win_y = (~win_x) & (tmin == tay_m)
    n_in = Vec3(
        torch.where(win_x, sx, 0.0),
        torch.where(win_y, sy, 0.0),
        torch.where(win_x | win_y, 0.0, sz),
    )
    # exit-face normal, used when the ray starts inside (:81-84)
    ex_x = tmax == tbx
    ex_y = (~ex_x) & (tmax == tby)
    n_out = Vec3(
        torch.where(ex_x, sx, 0.0),
        torch.where(ex_y, sy, 0.0),
        torch.where(ex_x | ex_y, 0.0, sz),
    )

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(inside, tmax, tmin)
    n_obj = Vec3(
        torch.where(inside, n_out.x, n_in.x),
        torch.where(inside, n_out.y, n_in.y),
        torch.where(inside, n_out.z, n_in.z),
    )

    p_obj = q_o + q_d * (t_obj - RAY_EPS)
    p_world = transform_point(transform, p_obj)
    n_world = transform_dir(transform, n_obj).normalize()
    dist = (origins - p_world).length()
    return torch.where(hit, dist, MISS), n_world, ~inside


def sphere_intersect(
    transform, inverse_transform, inv_transpose, origins: Vec3, dirs: Vec3
):
    """Batched sphereIntersectionTest (src/intersections.h:102-144)."""
    ro = transform_point(inverse_transform, origins)
    rd = transform_dir(inverse_transform, dirs).normalize()

    v_dot_d = ro.dot(rd)
    radicand = v_dot_d * v_dot_d - (ro.dot(ro) - 0.25)
    has_root = radicand >= 0
    sq = torch.sqrt(torch.clamp(radicand, min=0.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq

    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    outside = both_pos
    hit = has_root & ~both_neg

    p_obj = ro + rd * (t_obj - RAY_EPS)
    p_world = transform_point(transform, p_obj)
    n_world = transform_dir(inv_transpose, p_obj).normalize()
    n_world = n_world * torch.where(outside, 1.0, -1.0)
    dist = (origins - p_world).length()
    return torch.where(hit, dist, MISS), n_world, outside


def triangle_intersect(v0: Vec3, v1: Vec3, v2: Vec3, o: Vec3, d: Vec3):
    """Moller-Trumbore, lane-wise: each lane tests its own triangle (the
    vertices may broadcast). The glm::intersectRayTriangle analog
    (INSTRUCTION.md:127).

    Returns (t (P,), u, v, valid) with t = FLT_MAX where invalid."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o - v0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    valid = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > RAY_EPS)
    return torch.where(valid, t, FLT_MAX), u, v, valid


def closer_hit(t_new: torch.Tensor, t_best: torch.Tensor) -> torch.Tensor:
    """Min-t update rule per src/pathtrace.cu:192 (t > 0 && t_min > t),
    with t_best == MISS treated as FLT_MAX. Strict `<`: on an exact tie
    the earlier geom keeps the hit."""
    best = torch.where(t_best > 0, t_best, FLT_MAX)
    return (t_new > 0) & (best > t_new)
