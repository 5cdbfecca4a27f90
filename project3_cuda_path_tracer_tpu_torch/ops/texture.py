"""Procedural texturing: the 3D checker, plain PyTorch.

The checker-only part of the JAX package's `ops/texture.py`: `checker`
and the `kind == 1` branch of `apply_textures`. File textures (`kind ==
2`), box-projected UVs and bump maps arrive with port slice 6 (ROADMAP);
megakernel.check_supported refuses a scene that needs them. The CUDA
kernels compute the same factor in csrc/path_common.cuh (`checker`).
"""

from __future__ import annotations

import torch

from .vec import Vec3, where as vwhere


def checker(p: Vec3, scale: torch.Tensor) -> torch.Tensor:
    """3D procedural checkerboard: 1.0 / 0.35 by cell parity."""
    s = (
        torch.floor(p.x * scale) + torch.floor(p.y * scale)
        + torch.floor(p.z * scale)
    ).to(torch.int32)
    return torch.where((s & 1) == 0, 1.0, 0.35)


def apply_textures(scene, p_hit: Vec3, mat_id: torch.Tensor,
                   base_color: Vec3) -> Vec3:
    """Modulate the albedo of checker materials (TEXTURE checker) by the
    checker at the world-space hit point; other materials keep theirs."""
    if scene.n_file_textures > 0 or scene.any_bump:
        raise NotImplementedError(
            "file textures and bump maps are not ported yet: see ROADMAP, "
            "port slice 6"
        )
    safe = torch.clamp(mat_id, min=0).to(torch.int64)
    kind = scene.mat_tex_kind[safe]
    ck = checker(p_hit, scene.mat_tex_scale[safe])
    return vwhere(kind == 1, base_color * ck, base_color)
