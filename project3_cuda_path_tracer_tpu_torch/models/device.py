"""Device-resident scene and camera tables (torch tensors).

The port's subset of the JAX package's `models/device.py`: instance
matrices and their motion-blur velocities, material columns (with the
subsurface sigma and the texture and bump columns), the flattened
texture, bump and lat-long environment atlases (`tex_r/g/b`, `bump_h`,
`env_r/g/b`: one (N*R*R,) or (H*W,) column per channel, as there), the
constant environment colour, the triangle soup and the flat BVH of every
mesh geom (the JAX names: `tri_*`, `bvh_*`, `tri_ranges`, `bvh_roots`,
`mesh_has_uv`), the chunk and supernode boxes of every mesh geom
(`mesh_chunk_aabbs`, `mesh_super_aabbs`, `chunk_ranges`, `super_ranges`,
`mesh_obj_aabbs`: the big-mesh route's hierarchy), plus the static
metadata (geom types, material-class and feature flags) that selects the
shader's RNG draw layout and its stages. The TPU-only tables (packed
96-lane triangle rows and their stream padding, bf16 attribute slabs)
have no counterpart: the CUDA kernels read the soup and the f32 atlases
themselves.

Triangle order: with `use_bvh` (the default, and what `Renderer` always
builds, because the mesh kernels walk the BVH) the soup is reordered
exactly as the JAX package's `scene_to_device(use_bvh=True)` reorders it,
so both packages hold identical tables; the reorder happens on a copy,
and the caller's host `Scene` keeps file order. `RenderSettings.use_bvh`
then selects only the plain path's traversal: the naive sweep over the
same (BVH-ordered) soup, or the BVH walk. With `use_bvh=False` here the
soup keeps file order and no BVH is built, as in the JAX package; the
mesh kernels refuse such tables.

Every constructor here takes an explicit `device`; nothing picks one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from ..ops.vec import Vec3
from .scene import Camera, GeomType, Scene

# triangles per chunk and chunks per supernode of the big-mesh route's
# hierarchy (the JAX package's ops/megakernel.py MESH_CHUNK / MESH_SUPER)
MESH_CHUNK = 32
MESH_SUPER = 32

# DeviceScene tensor fields, in the JAX package's names; Vec3 fields are
# handed over as (N,3) arrays by device_scene_from_numpy.
ARRAY_FIELDS = (
    "transform",
    "inverse_transform",
    "inv_transpose",
    "geom_material_id",
    "geom_velocity",
    "mat_specular_exponent",
    "mat_has_reflective",
    "mat_has_refractive",
    "mat_ior",
    "mat_emittance",
    "mat_sss",
    "mat_tex_kind",
    "mat_tex_id",
    "mat_tex_scale",
    "mat_bump_id",
    "mat_bump_scale",
    "tex_r",
    "tex_g",
    "tex_b",
    "bump_h",
    "env_color",
    "env_r",
    "env_g",
    "env_b",
    "tri_uv0u",
    "tri_uv0v",
    "tri_uv1u",
    "tri_uv1v",
    "tri_uv2u",
    "tri_uv2v",
    "bvh_first",
    "bvh_count",
    "bvh_skip",
    "bvh_leaf",
    "mesh_chunk_aabbs",
    "mesh_super_aabbs",
)
INT_FIELDS = ("geom_material_id", "mat_tex_kind", "mat_tex_id", "mat_bump_id",
              "bvh_first", "bvh_count", "bvh_skip")
BOOL_FIELDS = ("bvh_leaf",)
VEC3_FIELDS = (
    "mat_color",
    "mat_specular_color",
    "tri_v0",
    "tri_v1",
    "tri_v2",
    "tri_n0",
    "tri_n1",
    "tri_n2",
    "bvh_min",
    "bvh_max",
)
META_FIELDS = (
    "gtypes",
    "tri_ranges",
    "bvh_roots",
    "mesh_has_uv",
    "chunk_ranges",
    "super_ranges",
    "mesh_obj_aabbs",
    "emissive_geoms",
    "any_refractive",
    "any_partial_reflective",
    "any_glossy",
    "any_sss",
    "any_textured",
    "any_bump",
    "has_env_const",
    "has_env_map",
    "n_file_textures",
    "n_bump_textures",
)


@dataclass
class DeviceScene:
    # --- geometry ---
    transform: torch.Tensor  # (G,4,4) f32
    inverse_transform: torch.Tensor  # (G,4,4) f32
    inv_transpose: torch.Tensor  # (G,4,4) f32
    geom_material_id: torch.Tensor  # (G,) int32
    geom_velocity: torch.Tensor  # (G,3) world translation per shutter time
    # --- materials (M rows; colours as Vec3 of (M,) columns) ---
    mat_color: Vec3
    mat_specular_exponent: torch.Tensor  # (M,)
    mat_specular_color: Vec3
    mat_has_reflective: torch.Tensor  # (M,)
    mat_has_refractive: torch.Tensor  # (M,)
    mat_ior: torch.Tensor  # (M,)
    mat_emittance: torch.Tensor  # (M,)
    mat_sss: torch.Tensor  # (M,) subsurface extinction sigma, 0 = none
    # texture and bump columns, and the flattened atlases (ops/texture.py)
    mat_tex_kind: torch.Tensor  # (M,) int32: 0 none, 1 checker, 2 file
    mat_tex_id: torch.Tensor  # (M,) int32 file texture of a kind-2 material
    mat_tex_scale: torch.Tensor  # (M,) texture tiling scale
    mat_bump_id: torch.Tensor  # (M,) int32 bump map, -1 none
    mat_bump_scale: torch.Tensor  # (M,)
    tex_r: torch.Tensor  # (N*R*R,) f32, N file textures of R x R texels
    tex_g: torch.Tensor
    tex_b: torch.Tensor
    bump_h: torch.Tensor  # (Nb*R*R,) f32 heights
    # environment radiance for escaped rays: the constant ENVLIGHT colour,
    # and the lat-long ENVMAP's channels, (H*W,) each (empty when absent)
    env_color: torch.Tensor  # (3,)
    env_r: torch.Tensor
    env_g: torch.Tensor
    env_b: torch.Tensor
    # --- triangle soup (object space, all meshes concatenated; BVH
    # order, see the module docstring) as Vec3 of (T,) columns ---
    tri_v0: Vec3
    tri_v1: Vec3
    tri_v2: Vec3
    tri_n0: Vec3  # per-corner normals (the face normal where the OBJ has none)
    tri_n1: Vec3
    tri_n2: Vec3
    # per-corner texture coordinates as (T,) columns; zeros where the
    # geom's OBJ had no vt (mesh_has_uv)
    tri_uv0u: torch.Tensor
    tri_uv0v: torch.Tensor
    tri_uv1u: torch.Tensor
    tri_uv1v: torch.Tensor
    tri_uv2u: torch.Tensor
    tri_uv2v: torch.Tensor
    # --- flat BVH of every mesh geom, concatenated (models/bvh.py):
    # preorder with escape pointers, one (B,) column per field ---
    bvh_min: Vec3  # node AABB min (object space)
    bvh_max: Vec3
    bvh_first: torch.Tensor  # (B,) int32 leaf's first triangle (global)
    bvh_count: torch.Tensor  # (B,) int32 leaf's triangle count
    bvh_skip: torch.Tensor  # (B,) int32 escape pointer (global node index)
    bvh_leaf: torch.Tensor  # (B,) bool
    # --- chunk and supernode boxes of every mesh geom, concatenated: a
    # chunk is MESH_CHUNK consecutive triangles of the (BVH-ordered) soup,
    # a supernode MESH_SUPER consecutive chunks; rows [min xyz, max xyz,
    # 0, 0] in object space ---
    mesh_chunk_aabbs: torch.Tensor  # (C,8) f32
    mesh_super_aabbs: torch.Tensor  # (S,8) f32
    # --- static metadata ---
    gtypes: Tuple[int, ...]
    tri_ranges: Tuple[Tuple[int, int], ...]  # per geom (tri_start, tri_count)
    bvh_roots: Tuple[Tuple[int, int], ...]  # per geom (node_start, node_count)
    mesh_has_uv: Tuple[bool, ...]  # per geom: its OBJ carried vt records
    chunk_ranges: Tuple[Tuple[int, int], ...]  # per geom (first chunk, count)
    super_ranges: Tuple[Tuple[int, int], ...]  # per geom (first super, count)
    mesh_obj_aabbs: Tuple[Tuple[float, ...], ...]  # per geom (min xyz, max xyz)
    emissive_geoms: Tuple[int, ...]  # geoms whose material emits
    # material-class flags: the shader's RNG draw layout and the set of
    # branches a scene can take follow from these
    any_refractive: bool
    any_partial_reflective: bool  # any 0 < REFL < 1 (probabilistic mix)
    any_glossy: bool  # any SPECEX > 0 (Phong imperfect specular)
    # the surface and environment features: they select the kernels'
    # texture stage (ops/megakernel.py::kernel_flags)
    any_sss: bool  # any SSS > 0 (subsurface scattering)
    any_textured: bool  # any TEXTURE (checker or file)
    any_bump: bool  # any BUMP
    has_env_const: bool  # nonzero constant ENVLIGHT colour
    has_env_map: bool  # lat-long ENVMAP present
    n_file_textures: int  # file textures in the scene's atlas
    n_bump_textures: int  # bump maps in the scene's atlas

    @property
    def device(self) -> torch.device:
        return self.transform.device

    @property
    def mesh_geoms(self) -> Tuple[int, ...]:
        """The mesh geoms that hold triangles, in geom order."""
        return tuple(i for i, (_, c) in enumerate(self.tri_ranges) if c > 0)


@dataclass
class DeviceCamera:
    """Camera parameters as small tensors; resolution is static."""

    position: torch.Tensor  # (3,)
    view: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    pixel_length: torch.Tensor  # (2,)
    aperture: torch.Tensor  # () thin-lens radius, 0 = pinhole
    focal_distance: torch.Tensor  # ()
    resolution: Tuple[int, int]


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def camera_to_device(cam: Camera, device) -> DeviceCamera:
    focal = cam.focal_distance
    if focal <= 0.0:
        focal = float(np.linalg.norm(cam.look_at - cam.position))
    return DeviceCamera(
        position=_f32(cam.position, device),
        view=_f32(cam.view, device),
        up=_f32(cam.up, device),
        right=_f32(cam.right, device),
        pixel_length=_f32(cam.pixel_length, device),
        aperture=_f32(cam.aperture, device),
        focal_distance=_f32(focal, device),
        resolution=(int(cam.resolution[0]), int(cam.resolution[1])),
    )


def _mesh_hierarchy(scene: Scene):
    """The chunk and supernode boxes of every mesh geom over the scene's
    soup as it stands (BVH order once the BVH is built), exactly as the
    JAX package's `scene_to_device` builds them: (chunk rows (C,8),
    super rows (S,8), chunk_ranges, super_ranges, mesh_obj_aabbs)."""
    g = scene.geoms
    t = scene.triangles
    chunks, supers = [], []
    chunk_ranges, super_ranges, obj_aabbs = [], [], []
    n_chunk = n_super = 0
    for gi in range(g.count):
        s, c = int(g.tri_start[gi]), int(g.tri_count[gi])
        if g.gtype[gi] != int(GeomType.MESH) or c == 0:
            chunk_ranges.append((0, 0))
            super_ranges.append((0, 0))
            obj_aabbs.append((0.0,) * 6)
            continue
        n_c = -(-c // MESH_CHUNK)
        n_s = -(-n_c // MESH_SUPER)
        # per-triangle bounds, padded to whole chunks with empty boxes; a
        # min or max is exact in any order
        lo = np.full((n_c * MESH_CHUNK, 3), np.inf, np.float32)
        hi = np.full((n_c * MESH_CHUNK, 3), -np.inf, np.float32)
        lo[:c] = np.minimum(np.minimum(t.v0[s:s + c], t.v1[s:s + c]), t.v2[s:s + c])
        hi[:c] = np.maximum(np.maximum(t.v0[s:s + c], t.v1[s:s + c]), t.v2[s:s + c])
        c_lo = lo.reshape(n_c, MESH_CHUNK, 3).min(axis=1)
        c_hi = hi.reshape(n_c, MESH_CHUNK, 3).max(axis=1)
        s_lo = np.full((n_s * MESH_SUPER, 3), np.inf, np.float32)
        s_hi = np.full((n_s * MESH_SUPER, 3), -np.inf, np.float32)
        s_lo[:n_c], s_hi[:n_c] = c_lo, c_hi
        s_lo = s_lo.reshape(n_s, MESH_SUPER, 3).min(axis=1)
        s_hi = s_hi.reshape(n_s, MESH_SUPER, 3).max(axis=1)
        for rows, a, b in ((chunks, c_lo, c_hi), (supers, s_lo, s_hi)):
            r = np.zeros((a.shape[0], 8), np.float32)
            r[:, 0:3], r[:, 3:6] = a, b
            rows.append(r)
        obj_aabbs.append(tuple(float(x) for x in c_lo.min(axis=0))
                         + tuple(float(x) for x in c_hi.max(axis=0)))
        chunk_ranges.append((n_chunk, n_c))
        super_ranges.append((n_super, n_s))
        n_chunk += n_c
        n_super += n_s
    stack = lambda rows: (np.concatenate(rows) if rows  # noqa: E731
                          else np.zeros((0, 8), np.float32))
    return (stack(chunks), stack(supers), tuple(chunk_ranges),
            tuple(super_ranges), tuple(obj_aabbs))


def scene_to_device(scene: Scene, device, use_bvh: bool = True) -> DeviceScene:
    """The scene's tables on `device`; with `use_bvh`, each mesh geom's
    BVH and the soup in BVH order (see the module docstring)."""
    g = scene.geoms
    m = scene.materials
    t = scene.triangles
    if use_bvh and t.count > 0:
        from .bvh import build_scene_bvh

        # build_scene_bvh reorders the soup in place: give it a copy
        scene = replace(scene, triangles=copy.copy(t))
        nodes_min, nodes_max, meta, bvh_roots = build_scene_bvh(scene)
        t = scene.triangles
    else:
        nodes_min = np.zeros((0, 3), np.float32)
        nodes_max = np.zeros((0, 3), np.float32)
        meta = np.zeros((0, 4), np.int32)
        bvh_roots = [(0, 0)] * g.count
    chunk_aabbs, super_aabbs, chunk_ranges, super_ranges, obj_aabbs = (
        _mesh_hierarchy(scene))
    fields = {
        "transform": g.transform,
        "inverse_transform": g.inverse_transform,
        "inv_transpose": g.inv_transpose,
        "geom_material_id": g.material_id,
        "geom_velocity": g.velocity,
        "mat_color": m.color,
        "mat_specular_exponent": m.specular_exponent,
        "mat_specular_color": m.specular_color,
        "mat_has_reflective": m.has_reflective,
        "mat_has_refractive": m.has_refractive,
        "mat_ior": m.index_of_refraction,
        "mat_emittance": m.emittance,
        "mat_sss": m.subsurface,
        "mat_tex_kind": m.tex_kind,
        "mat_tex_id": m.tex_id,
        "mat_tex_scale": m.tex_scale,
        "mat_bump_id": m.bump_id,
        "mat_bump_scale": m.bump_scale,
        "tex_r": scene.textures[..., 0].reshape(-1),
        "tex_g": scene.textures[..., 1].reshape(-1),
        "tex_b": scene.textures[..., 2].reshape(-1),
        "bump_h": scene.bumps.reshape(-1),
        "env_color": scene.env_color,
        "env_r": scene.env_map[..., 0].reshape(-1),
        "env_g": scene.env_map[..., 1].reshape(-1),
        "env_b": scene.env_map[..., 2].reshape(-1),
        "tri_v0": t.v0,
        "tri_v1": t.v1,
        "tri_v2": t.v2,
        "tri_n0": t.n0,
        "tri_n1": t.n1,
        "tri_n2": t.n2,
        "tri_uv0u": t.uv0[:, 0],
        "tri_uv0v": t.uv0[:, 1],
        "tri_uv1u": t.uv1[:, 0],
        "tri_uv1v": t.uv1[:, 1],
        "tri_uv2u": t.uv2[:, 0],
        "tri_uv2v": t.uv2[:, 1],
        "bvh_min": nodes_min,
        "bvh_max": nodes_max,
        "bvh_first": meta[:, 0],
        "bvh_count": meta[:, 1],
        "bvh_skip": meta[:, 2],
        "bvh_leaf": meta[:, 3].astype(bool),
        "mesh_chunk_aabbs": chunk_aabbs,
        "mesh_super_aabbs": super_aabbs,
    }
    info = dict(
        gtypes=tuple(int(x) for x in g.gtype),
        tri_ranges=tuple(
            (int(s), int(c)) for s, c in zip(g.tri_start, g.tri_count)
        ),
        bvh_roots=tuple(bvh_roots),
        mesh_has_uv=tuple(bool(x) for x in g.has_uv),
        chunk_ranges=chunk_ranges,
        super_ranges=super_ranges,
        mesh_obj_aabbs=obj_aabbs,
        emissive_geoms=tuple(
            int(i)
            for i in range(g.count)
            if m.emittance[g.material_id[i]] > 0
        ),
        any_refractive=bool((m.has_refractive > 0).any()),
        any_partial_reflective=bool(
            ((m.has_reflective > 0) & (m.has_reflective < 1)).any()
        ),
        any_glossy=bool((m.specular_exponent > 0).any()),
        any_sss=bool((m.subsurface > 0).any()),
        any_textured=bool((m.tex_kind > 0).any()),
        any_bump=bool((m.bump_id >= 0).any()),
        has_env_const=bool((scene.env_color != 0).any()),
        has_env_map=bool(scene.env_map.size > 0),
        n_file_textures=int(scene.textures.shape[0]),
        n_bump_textures=int(scene.bumps.shape[0]),
    )
    return device_scene_from_numpy(fields, info, device)


def device_scene_from_numpy(fields: dict, meta: dict, device) -> DeviceScene:
    """Build a DeviceScene from numpy tables and static metadata.

    `fields` maps each name of ARRAY_FIELDS and VEC3_FIELDS to an array
    (Vec3 fields as (N,3)); `meta` maps each name of META_FIELDS to its
    value. Extra keys are ignored, so the JAX package's DeviceScene,
    converted to numpy field by field, can be handed over whole: the
    tests feed both packages identical tables this way."""
    kw = {}
    for name in ARRAY_FIELDS:
        a = np.asarray(fields[name])
        if name in INT_FIELDS:
            kw[name] = torch.tensor(a.astype(np.int32), device=device)
        elif name in BOOL_FIELDS:
            kw[name] = torch.tensor(a.astype(bool), device=device)
        else:
            kw[name] = _f32(a, device)
    for name in VEC3_FIELDS:
        a = np.asarray(fields[name], np.float32).reshape(-1, 3)
        kw[name] = Vec3(*(_f32(a[:, c], device) for c in range(3)))
    for name in META_FIELDS:
        v = meta[name]
        if name in ("gtypes", "emissive_geoms"):
            kw[name] = tuple(int(x) for x in v)
        elif name in ("tri_ranges", "bvh_roots", "chunk_ranges",
                      "super_ranges"):
            kw[name] = tuple((int(a), int(b)) for a, b in v)
        elif name == "mesh_obj_aabbs":
            kw[name] = tuple(tuple(float(x) for x in box) for box in v)
        elif name == "mesh_has_uv":
            kw[name] = tuple(bool(x) for x in v)
        elif name in ("n_file_textures", "n_bump_textures"):
            kw[name] = int(v)
        else:
            kw[name] = bool(v)
    return DeviceScene(**kw)


def advance_time(scene: DeviceScene, t: float) -> DeviceScene:
    """Translate each geom by velocity * t (motion blur): for
    M' = T(v t) @ M the transform's translation gains v t, the inverse's
    loses inverse[:3,:3] @ (v t), and the inverse transpose's 3x3 part is
    unchanged. The product is an elementwise multiply and a left-to-right
    sum, as in the JAX package (not a matmul). Returns a new DeviceScene;
    `scene` is untouched."""
    vt = scene.geom_velocity * t  # (G,3)
    xf = scene.transform.clone()
    xf[:, :3, 3] = xf[:, :3, 3] + vt
    lin = scene.inverse_transform[:, :3, :3] * vt[:, None, :]  # (G,3,3)
    delta = lin[:, :, 0] + lin[:, :, 1] + lin[:, :, 2]
    inv = scene.inverse_transform.clone()
    inv[:, :3, 3] = inv[:, :3, 3] + (-delta)
    return replace(scene, transform=xf, inverse_transform=inv)
