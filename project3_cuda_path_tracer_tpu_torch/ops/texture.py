"""Texture + bump mapping and the environment map, plain PyTorch.

The twin of the JAX package's `ops/texture.py`: the procedural checker,
file textures and bump maps (INSTRUCTION.md:114-116) and the lat-long
environment radiance of escaped rays.

Two UV parameterizations, chosen per lane:
- meshes with OBJ vt records use their own per-face UVs, interpolated
  barycentrically at intersection time (Intersections.tex_u/v),
- everything else gets box-projected world space: the hit point's two
  coordinates orthogonal to the dominant normal axis, scaled by the
  material's TEXSCALE and wrapped.

File textures are fetched bilinearly with wrap addressing, bump taps and
the environment map nearest-neighbour, from the flattened f32 atlases of
models/device.py (one (N*R*R,) column per channel). The CUDA kernels
compute the same stage in csrc/path_common.cuh (`surface`, `env_fetch`).
Textures of another size than TEX_RES, and HDR environment maps, are
refused when the scene loads (models/scene.py; ROADMAP §1 queues them).
"""

from __future__ import annotations

import math

import torch

from ..utils.math3d import SQRT_OF_ONE_THIRD
from .vec import Vec3, where as vwhere

TEX_RES = 256
ENV_H, ENV_W = 256, 512  # models/scene.py's lat-long table


def box_uv(p: Vec3, n: Vec3, scale: torch.Tensor):
    """World-space box-projected UV in [0,1): pick the two coordinates
    orthogonal to the dominant normal axis."""
    ax, ay, az = n.x.abs(), n.y.abs(), n.z.abs()
    dom_x = (ax >= ay) & (ax >= az)
    dom_y = (~dom_x) & (ay >= az)
    u = torch.where(dom_x, p.z, torch.where(dom_y, p.x, p.x))
    v = torch.where(dom_x, p.y, torch.where(dom_y, p.z, p.y))
    u = u * scale
    v = v * scale
    return u - torch.floor(u), v - torch.floor(v)


def checker(p: Vec3, scale: torch.Tensor) -> torch.Tensor:
    """3D procedural checkerboard: 1.0 / 0.35 by cell parity."""
    s = (
        torch.floor(p.x * scale) + torch.floor(p.y * scale)
        + torch.floor(p.z * scale)
    ).to(torch.int32)
    return torch.where((s & 1) == 0, 1.0, 0.35)


def _gather(channel_flat: torch.Tensor, tex_id, u, v) -> torch.Tensor:
    """Nearest-neighbour fetch (the bump taps: the finite differences
    want raw texels)."""
    ix = torch.clamp((u * TEX_RES).to(torch.int32), 0, TEX_RES - 1)
    iy = torch.clamp((v * TEX_RES).to(torch.int32), 0, TEX_RES - 1)
    flat = (tex_id * TEX_RES + iy) * TEX_RES + ix
    return channel_flat[flat.to(torch.int64)]


def _gather_bilinear(channel_flat: torch.Tensor, tex_id, u, v) -> torch.Tensor:
    """Bilinear fetch with wrap addressing (texel centres at (i+0.5)/R).
    The wrap is a floor modulo (x0 is -1 left of the first centre), so
    `torch.remainder`, never `fmod`."""
    fx = u * TEX_RES - 0.5
    fy = v * TEX_RES - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = torch.remainder(x0.to(torch.int32), TEX_RES)
    y0i = torch.remainder(y0.to(torch.int32), TEX_RES)
    x1i = torch.remainder(x0i + 1, TEX_RES)
    y1i = torch.remainder(y0i + 1, TEX_RES)
    base = tex_id * TEX_RES

    def tap(iy, ix):
        return channel_flat[((base + iy) * TEX_RES + ix).to(torch.int64)]

    c00 = tap(y0i, x0i)
    c01 = tap(y0i, x1i)
    c10 = tap(y1i, x0i)
    c11 = tap(y1i, x1i)
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def sample_file_texture(tex_r, tex_g, tex_b, tex_id, u, v) -> Vec3:
    """Bilinear-filtered albedo fetch from the flattened atlas."""
    return Vec3(
        _gather_bilinear(tex_r, tex_id, u, v),
        _gather_bilinear(tex_g, tex_id, u, v),
        _gather_bilinear(tex_b, tex_id, u, v),
    )


def env_radiance(scene, dirs: Vec3) -> Vec3:
    """Environment radiance for escaped rays: the constant ENVLIGHT
    colour, replaced per lane by the lat-long ENVMAP sample when one is
    loaded. Lat-long convention: u from atan2(z, x), v from acos(y)
    (y-up world)."""
    P = dirs.x.shape[0]
    if scene.has_env_map:
        u = torch.atan2(dirs.z, dirs.x) * (0.5 / math.pi) + 0.5
        v = torch.acos(torch.clamp(dirs.y, -1.0, 1.0)) * (1.0 / math.pi)
        ix = torch.clamp((u * ENV_W).to(torch.int32), 0, ENV_W - 1)
        iy = torch.clamp((v * ENV_H).to(torch.int32), 0, ENV_H - 1)
        flat = (iy * ENV_W + ix).to(torch.int64)
        return Vec3(scene.env_r[flat], scene.env_g[flat], scene.env_b[flat])
    return Vec3.broadcast(scene.env_color, P)


def apply_textures(scene, p_hit: Vec3, normal: Vec3, mat_id: torch.Tensor,
                   base_color: Vec3, tex_u=None, tex_v=None, has_uv=None):
    """Modulate the albedo by the material's texture (checker or file) and
    perturb the shading normal by its bump map. Returns (color, normal).

    tex_u/tex_v/has_uv (from Intersections): lanes that hit a UV-mapped
    mesh sample the texture by the OBJ's own parameterization; all other
    lanes use the box projection. The scene's flags (any_textured,
    n_file_textures, any_bump) select the stages, as in the JAX package."""
    safe = torch.clamp(mat_id, min=0).to(torch.int64)
    kind = scene.mat_tex_kind[safe]
    scale = scene.mat_tex_scale[safe]

    def pick_uv(u_box, v_box):
        if tex_u is None or has_uv is None:
            return u_box, v_box
        um = tex_u - torch.floor(tex_u)  # OBJ wrap
        vm = 1.0 - (tex_v - torch.floor(tex_v))  # OBJ v is bottom-up
        return torch.where(has_uv, um, u_box), torch.where(has_uv, vm, v_box)

    color = base_color
    if scene.any_textured:
        u, v = pick_uv(*box_uv(p_hit, normal, scale))
        ck = checker(p_hit, scale)
        color = vwhere(kind == 1, base_color * ck, base_color)
        if scene.n_file_textures > 0:
            tid = scene.mat_tex_id[safe]
            tc = sample_file_texture(scene.tex_r, scene.tex_g, scene.tex_b,
                                     tid, u, v)
            color = vwhere(kind == 2, base_color * tc, color)

    if scene.any_bump:
        bid = scene.mat_bump_id[safe]
        bscale = scene.mat_bump_scale[safe]
        has_bump = bid >= 0
        bid_c = torch.clamp(bid, min=0)
        u, v = pick_uv(*box_uv(p_hit, normal, scale))
        eps = 1.0 / TEX_RES
        h0 = _gather(scene.bump_h, bid_c, u, v)
        hu = _gather(scene.bump_h, bid_c, torch.remainder(u + eps, 1.0), v)
        hv = _gather(scene.bump_h, bid_c, u, torch.remainder(v + eps, 1.0))
        dhdu = (hu - h0) / eps
        dhdv = (hv - h0) / eps
        # tangent frame via the not-normal-axis trick (interactions.h:24)
        use_x = normal.x.abs() < SQRT_OF_ONE_THIRD
        use_y = (~use_x) & (normal.y.abs() < SQRT_OF_ONE_THIRD)
        nn = Vec3(
            use_x.to(torch.float32),
            use_y.to(torch.float32),
            (~(use_x | use_y)).to(torch.float32),
        )
        t1 = normal.cross(nn).normalize()
        t2 = normal.cross(t1).normalize()
        perturbed = (
            normal + (t1 * dhdu + t2 * dhdv) * (-bscale * 0.1)
        ).normalize()
        normal = vwhere(has_bump, perturbed, normal)

    return color, normal
