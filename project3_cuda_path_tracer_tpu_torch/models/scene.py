"""Scene data model and text-format parser.

A copy of the JAX package's `models/scene.py` (numpy only), so that the
port imports nothing of that package: an OBJECT of type `mesh` reads its
OBJ (`FILE`, models/mesh.py) into the scene's concatenated triangle
soup, indexed per geom by `tri_start`/`tri_count`.

Replaces the CUDA reference's AoS POD structs + istream parser
(src/sceneStructs.h:8-76, src/scene.cpp) with SoA numpy arrays:
geometry as stacked (G,4,4) transform tensors plus int32 type/material
vectors; materials as (M,) / (M,3) columns.

The text format is byte-compatible with the reference
(format spec INSTRUCTION.md:258-301):
  MATERIAL <id> then 7 lines RGB/SPECEX/SPECRGB/REFL/REFR/REFRIOR/EMITTANCE
  CAMERA then 5 lines RES/FOVY/ITERATIONS/DEPTH/FILE then EYE/LOOKAT/UP
  OBJECT <id> then type, "material <id>", TRANS/ROTAT/SCALE until blank

Camera derivation matches src/scene.cpp:133-142 with one
deliberate fix: the reference computes `camera.right` from an
uninitialized `view` (src/scene.cpp:138) before setting `view` at :142 —
masked upstream because main.cpp re-derives the basis before the first
frame (src/main.cpp:102-120). We compute right/up AFTER view, which is
what the reference's runtime actually renders with.

Extensions beyond the reference format (all optional keys, ignored by
scenes that don't use them):
  CAMERA block: APERTURE <r> and FOCAL <d> enable thin-lens DoF
    (INSTRUCTION.md:110-111).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils import math3d
from ..utils.image import read_hdr, read_png
from ..utils.resample import resize_bilinear


class GeomType(enum.IntEnum):
    # Reference enum order: SPHERE=0, CUBE=1 (src/sceneStructs.h:10-13).
    SPHERE = 0
    CUBE = 1
    MESH = 2  # extension: triangle mesh instance (INSTRUCTION.md:123)


BACKGROUND_COLOR = np.zeros(3, dtype=np.float32)  # src/sceneStructs.h:8


@dataclass
class GeomsSoA:
    """Stacked instance data for all geoms. Shapes: (G,) / (G,4,4)."""

    gtype: np.ndarray  # int32 (G,)
    material_id: np.ndarray  # int32 (G,)
    transform: np.ndarray  # float32 (G,4,4)
    inverse_transform: np.ndarray  # float32 (G,4,4)
    inv_transpose: np.ndarray  # float32 (G,4,4)
    # Mesh instancing: for gtype==MESH, [tri_start, tri_count) indexes the
    # scene-level concatenated triangle soup; 0/0 otherwise.
    tri_start: np.ndarray  # int32 (G,)
    tri_count: np.ndarray  # int32 (G,)
    # Motion blur (INSTRUCTION.md:119-120): world-space translation per
    # unit shutter time; zero for static geoms. Scene key: VELOCITY.
    velocity: np.ndarray  # float32 (G,3)
    # True for mesh geoms whose OBJ carried vt records (per-corner UVs)
    has_uv: np.ndarray = None  # bool (G,)

    def __post_init__(self):
        if self.has_uv is None:
            self.has_uv = np.zeros((self.gtype.shape[0],), bool)

    @property
    def count(self) -> int:
        return int(self.gtype.shape[0])


@dataclass
class MaterialsSoA:
    """Material table columns. Shapes: (M,) / (M,3).

    Mirrors Material (src/sceneStructs.h:31-41).
    """

    color: np.ndarray  # (M,3)
    specular_exponent: np.ndarray  # (M,)
    specular_color: np.ndarray  # (M,3)
    has_reflective: np.ndarray  # (M,)
    has_refractive: np.ndarray  # (M,)
    index_of_refraction: np.ndarray  # (M,)
    emittance: np.ndarray  # (M,)
    subsurface: np.ndarray = None  # (M,) SSS extinction sigma
    # texture/bump extension (INSTRUCTION.md:114-116):
    tex_kind: np.ndarray = None  # (M,) int32: 0 none, 1 checker, 2 file
    tex_id: np.ndarray = None  # (M,) int32 index into the scene atlas
    tex_scale: np.ndarray = None  # (M,)
    bump_id: np.ndarray = None  # (M,) int32, -1 = none
    bump_scale: np.ndarray = None  # (M,)

    def __post_init__(self):
        n = self.emittance.shape[0]
        if self.subsurface is None:
            self.subsurface = np.zeros((n,), np.float32)
        if self.tex_kind is None:
            self.tex_kind = np.zeros((n,), np.int32)
        if self.tex_id is None:
            self.tex_id = np.zeros((n,), np.int32)
        if self.tex_scale is None:
            self.tex_scale = np.ones((n,), np.float32)
        if self.bump_id is None:
            self.bump_id = np.full((n,), -1, np.int32)
        if self.bump_scale is None:
            self.bump_scale = np.ones((n,), np.float32)

    @property
    def count(self) -> int:
        return int(self.emittance.shape[0])


@dataclass
class Camera:
    """Pinhole (+ optional thin-lens) camera; mirrors src/sceneStructs.h:43-52."""

    resolution: tuple  # (x, y) static python ints
    position: np.ndarray  # (3,)
    look_at: np.ndarray  # (3,)
    view: np.ndarray  # (3,)
    up: np.ndarray  # (3,)
    right: np.ndarray  # (3,)
    fov: np.ndarray  # (fovx, fovy) degrees
    pixel_length: np.ndarray  # (2,)
    aperture: float = 0.0  # thin-lens radius; 0 = pinhole
    focal_distance: float = 0.0  # 0 = auto (|look_at - position|)

    @property
    def pixel_count(self) -> int:
        return self.resolution[0] * self.resolution[1]


def derive_camera(
    resolution,
    position,
    look_at,
    up,
    fovy_deg: float,
    aperture: float = 0.0,
    focal_distance: float = 0.0,
) -> Camera:
    """fov / pixelLength / basis derivation per src/scene.cpp:133-142.

    NOTE the reference treats FOVY as a *half*-angle: yscaled=tan(fovy°)
    is the half-height of the image plane at unit distance.

    Deliberate deviation #2 (besides the uninitialized-`right` parser
    quirk): the reference runtime rebuilds the basis in runCuda
    (src/main.cpp:108-113) as UNNORMALIZED right=cross(view,(0,1,0)),
    up=cross(right,view); both shrink by sin(view∠y) for pitched
    cameras, narrowing the effective FOV. We normalize, giving the FOV
    the scene file asks for at any pitch. Level cameras (the canonical
    Cornell golden: EYE.y == LOOKAT.y) are identical either way.
    """
    resx, resy = int(resolution[0]), int(resolution[1])
    position = np.asarray(position, dtype=np.float32)
    look_at = np.asarray(look_at, dtype=np.float32)
    up_in = np.asarray(up, dtype=np.float32)

    yscaled = float(np.tan(fovy_deg * (math3d.PI / 180.0)))
    xscaled = yscaled * resx / resy
    fovx = float(np.arctan(xscaled) * 180.0 / math3d.PI)
    pixel_length = np.array(
        [2.0 * xscaled / resx, 2.0 * yscaled / resy], dtype=np.float32
    )

    view = math3d.normalize(look_at - position)
    right = math3d.normalize(np.cross(view, up_in))
    up_ortho = math3d.normalize(np.cross(right, view))

    return Camera(
        resolution=(resx, resy),
        position=position,
        look_at=look_at,
        view=view.astype(np.float32),
        up=up_ortho.astype(np.float32),
        right=right.astype(np.float32),
        fov=np.array([fovx, fovy_deg], dtype=np.float32),
        pixel_length=pixel_length,
        aperture=float(aperture),
        focal_distance=float(focal_distance),
    )


@dataclass
class RenderState:
    """Render state; mirrors RenderState (src/sceneStructs.h:54-60)."""

    camera: Camera
    iterations: int
    trace_depth: int
    image_name: str


@dataclass
class TriangleSoup:
    """Concatenated object-space triangle soup for all mesh geoms, as
    loaded from the OBJs; the world transform is applied through each
    geom's instance matrices like sphere/cube."""

    v0: np.ndarray  # (T,3)
    v1: np.ndarray  # (T,3)
    v2: np.ndarray  # (T,3)
    n0: np.ndarray  # (T,3) per-vertex normals (face normal if absent)
    n1: np.ndarray
    n2: np.ndarray
    # per-corner texture coordinates from the OBJ's vt records; zeros +
    # has_uv=False when the OBJ carries none
    uv0: np.ndarray = None  # (T,2)
    uv1: np.ndarray = None
    uv2: np.ndarray = None
    has_uv: bool = False

    def __post_init__(self):
        if self.uv0 is None:
            z2 = np.zeros((self.v0.shape[0], 2), np.float32)
            self.uv0, self.uv1, self.uv2 = z2, z2.copy(), z2.copy()

    @property
    def count(self) -> int:
        return int(self.v0.shape[0])

    @staticmethod
    def empty() -> "TriangleSoup":
        z = np.zeros((0, 3), dtype=np.float32)
        return TriangleSoup(z, z, z, z, z, z)


@dataclass
class Scene:
    """Host-side parsed scene: geoms + materials + render state.

    Mirrors the Scene class surface (src/scene.h:20-25): public `geoms`,
    `materials`, `state`.
    """

    geoms: GeomsSoA
    materials: MaterialsSoA
    state: RenderState
    triangles: TriangleSoup = field(default_factory=TriangleSoup.empty)
    source_path: str = ""
    # texture atlas: all file textures resampled to TEX_RES^2 (albedo RGB
    # and bump heights); empty arrays when no textures are used
    textures: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 256, 256, 3), np.float32)
    )
    bumps: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 256, 256), np.float32)
    )
    # environment light (extension; reference background is black):
    # constant sky radiance + optional lat-long radiance map (H,W,3)
    env_color: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    env_map: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0, 3), np.float32)
    )


class SceneParseError(ValueError):
    pass


def _tokenize(line: str) -> List[str]:
    return line.split()


class _LineReader:
    """Sequential line reader with the reference's safeGetline semantics
    (CRLF tolerant — src/utilities.cpp:82-112)."""

    def __init__(self, text: str):
        self.lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.pos = 0

    def next_line(self) -> Optional[str]:
        if self.pos >= len(self.lines):
            return None
        line = self.lines[self.pos]
        self.pos += 1
        return line


def load_scene(path: str) -> Scene:
    """Parse a scene file. Line-oriented dispatch on MATERIAL/OBJECT/CAMERA
    headers per src/scene.cpp:16-32."""
    with open(path, "r") as f:
        text = f.read()
    rd = _LineReader(text)

    materials: List[dict] = []
    geoms: List[dict] = []
    camera: Optional[Camera] = None
    iterations = 0
    trace_depth = 0
    image_name = "render"
    env = {"color": np.zeros(3, np.float32), "map_path": None, "scale": 1.0}
    tri_blocks: List[TriangleSoup] = []
    tri_total = 0

    while True:
        line = rd.next_line()
        if line is None:
            break
        if not line.strip():
            continue
        tokens = _tokenize(line)
        if tokens[0] == "MATERIAL":
            mid = int(tokens[1])
            if mid != len(materials):
                # Sequential-ID validation per src/scene.cpp:155-157.
                raise SceneParseError(
                    f"MATERIAL ID {mid} does not match expected {len(materials)}"
                )
            materials.append(
                _parse_material(
                    rd, base_dir=os.path.dirname(os.path.abspath(path))
                )
            )
        elif tokens[0] == "OBJECT":
            oid = int(tokens[1])
            if oid != len(geoms):
                raise SceneParseError(
                    f"OBJECT ID {oid} does not match expected {len(geoms)}"
                )
            g, tris = _parse_geom(
                rd, base_dir=os.path.dirname(os.path.abspath(path))
            )
            if tris is not None:
                g["tri_start"] = tri_total
                g["tri_count"] = tris.count
                g["has_uv"] = tris.has_uv
                tri_blocks.append(tris)
                tri_total += tris.count
            geoms.append(g)
        elif tokens[0] == "CAMERA":
            camera, iterations, trace_depth, image_name, env = _parse_camera(
                rd, base_dir=os.path.dirname(os.path.abspath(path))
            )

    if camera is None:
        raise SceneParseError(f"no CAMERA block in {path}")

    geoms_soa = _build_geoms_soa(geoms)
    mats_soa, textures, bumps = _build_materials_soa(materials)
    triangles = _concat_triangles(tri_blocks)
    state = RenderState(
        camera=camera,
        iterations=iterations,
        trace_depth=trace_depth,
        image_name=image_name,
    )
    env_map = np.zeros((0, 0, 3), np.float32)
    if env["map_path"]:
        env_map = _load_env_map(env["map_path"]) * env["scale"]
    return Scene(
        geoms=geoms_soa,
        materials=mats_soa,
        state=state,
        triangles=triangles,
        source_path=path,
        textures=textures,
        bumps=bumps,
        env_color=env["color"],
        env_map=env_map,
    )


ENV_H, ENV_W = 256, 512  # lat-long env maps resampled to this


def _load_env_map(path: str) -> np.ndarray:
    """Load a lat-long environment image as (ENV_H, ENV_W, 3) float
    radiance, as the JAX package loads it. HDR formats keep their range: a
    Radiance `.hdr` (`utils.image.read_hdr`) resampled by nearest
    neighbour, the JAX package's index formula; LDR is mapped to [0,1]: an
    8-bit PNG (`utils.image.read_png`) resized bilinearly to the table,
    bit for bit Pillow's BILINEAR (`utils.resample`). `.exr` raises
    ValueError: no EXR decoder is installed (the JAX package reads it
    through imageio's plugins, which need one)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        raise ValueError(
            f"{path}: .exr environment maps need an EXR decoder, and none is "
            "installed (the JAX package reads them through imageio, which "
            "finds no backend for them either); convert the map to .hdr"
        )
    if ext == ".hdr":
        img = read_hdr(path)
        # nearest-neighbor resample (the JAX package's formula)
        ys = (np.arange(ENV_H) * img.shape[0] // ENV_H).clip(0, img.shape[0] - 1)
        xs = (np.arange(ENV_W) * img.shape[1] // ENV_W).clip(0, img.shape[1] - 1)
        return np.ascontiguousarray(img[np.ix_(ys, xs)])
    img = resize_bilinear(read_png(path, "RGB"), ENV_W, ENV_H)
    # int * float32(1/255) — must match the JAX package's atlas fetch
    # (ops/megakernel.py::_env_fetch) bit-for-bit; see _load_texture.
    return img.astype(np.float32) * np.float32(1.0 / 255.0)


def _parse_material(rd: _LineReader, base_dir: str = ".") -> dict:
    """Reads the reference's 7 property lines (src/scene.cpp:163-183)
    and, being blank-terminated rather than count-terminated, also our
    optional extension keys (texture/bump mapping, INSTRUCTION.md:114):
      TEXTURE <checker | path.png>   albedo texture (procedural or file)
      TEXSCALE <s>                   texture tiling scale (default 1)
      BUMP <path.png>                height map for bump mapping
      BUMPSCALE <s>                  bump strength (default 1)
    Reference scenes (exactly 7 lines then a blank) parse identically.
    """
    m = dict(
        color=np.zeros(3, np.float32),
        specular_exponent=0.0,
        specular_color=np.zeros(3, np.float32),
        has_reflective=0.0,
        has_refractive=0.0,
        index_of_refraction=0.0,
        emittance=0.0,
        subsurface=0.0,  # SSS extinction sigma (INSTRUCTION.md:121); 0 = off
        texture=None,  # None | "checker" | path
        tex_scale=1.0,
        bump=None,
        bump_scale=1.0,
    )
    while True:
        line = rd.next_line()
        if line is None or not line.strip():
            break
        tokens = _tokenize(line)
        key = tokens[0]
        if key == "RGB":
            m["color"] = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "SPECEX":
            m["specular_exponent"] = float(tokens[1])
        elif key == "SPECRGB":
            m["specular_color"] = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "REFL":
            m["has_reflective"] = float(tokens[1])
        elif key == "REFR":
            m["has_refractive"] = float(tokens[1])
        elif key == "REFRIOR":
            m["index_of_refraction"] = float(tokens[1])
        elif key == "EMITTANCE":
            m["emittance"] = float(tokens[1])
        elif key == "SSS":
            m["subsurface"] = float(tokens[1])
        elif key == "TEXTURE":
            m["texture"] = (
                tokens[1]
                if tokens[1] == "checker"
                else _resolve(tokens[1], base_dir)
            )
        elif key == "TEXSCALE":
            m["tex_scale"] = float(tokens[1])
        elif key == "BUMP":
            m["bump"] = _resolve(tokens[1], base_dir)
        elif key == "BUMPSCALE":
            m["bump_scale"] = float(tokens[1])
    return m


def _resolve(path: str, base_dir: str) -> str:
    return path if os.path.isabs(path) else os.path.join(base_dir, path)


def _parse_geom(rd: _LineReader, base_dir: str):
    """Type line, material link, TRANS/ROTAT/SCALE until blank
    per src/scene.cpp:35-90. VELOCITY (motion blur) and `mesh` + FILE
    are our extensions. Returns (geom dict, TriangleSoup or None)."""
    g = dict(
        gtype=GeomType.SPHERE,
        material_id=0,
        translation=np.zeros(3, np.float32),
        rotation=np.zeros(3, np.float32),
        scale=np.ones(3, np.float32),
        tri_start=0,
        tri_count=0,
        velocity=np.zeros(3, np.float32),
    )
    tris = None

    line = rd.next_line()
    if line:
        name = line.strip()
        if name == "sphere":
            g["gtype"] = GeomType.SPHERE
        elif name == "cube":
            g["gtype"] = GeomType.CUBE
        elif name == "mesh":
            g["gtype"] = GeomType.MESH
        else:
            raise SceneParseError(f"unknown geom type {name!r}")

    line = rd.next_line()
    if line:
        tokens = _tokenize(line)
        g["material_id"] = int(tokens[1])

    while True:
        line = rd.next_line()
        if line is None or not line.strip():
            break
        tokens = _tokenize(line)
        key = tokens[0]
        if key == "TRANS":
            g["translation"] = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "ROTAT":
            g["rotation"] = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "SCALE":
            g["scale"] = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "VELOCITY":
            g["velocity"] = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "FILE":
            from .mesh import load_obj

            tris = load_obj(_resolve(tokens[1], base_dir))
    return g, tris


def _parse_camera(rd: _LineReader, base_dir: str = "."):
    """5 fixed property lines then EYE/LOOKAT/UP until blank
    per src/scene.cpp:92-151. APERTURE/FOCAL are our DoF extension, as
    are the environment-light keys (the reference hardcodes
    BACKGROUND_COLOR=black, src/sceneStructs.h:8):
      ENVLIGHT r g b   constant sky radiance for escaped rays
      ENVMAP path      lat-long HDR/LDR image (overrides ENVLIGHT color)
      ENVSCALE s       multiplier applied to either
    """
    resolution = (0, 0)
    fovy = 45.0
    iterations = 0
    trace_depth = 0
    image_name = "render"
    position = np.zeros(3, np.float32)
    look_at = np.zeros(3, np.float32)
    up = np.array([0, 1, 0], np.float32)
    aperture = 0.0
    focal = 0.0
    env_color = np.zeros(3, np.float32)
    env_map_path = None
    env_scale = 1.0

    for _ in range(5):
        line = rd.next_line()
        if line is None:
            break
        tokens = _tokenize(line)
        if not tokens:
            continue
        key = tokens[0]
        if key == "RES":
            resolution = (int(tokens[1]), int(tokens[2]))
        elif key == "FOVY":
            fovy = float(tokens[1])
        elif key == "ITERATIONS":
            iterations = int(tokens[1])
        elif key == "DEPTH":
            trace_depth = int(tokens[1])
        elif key == "FILE":
            image_name = tokens[1]

    while True:
        line = rd.next_line()
        if line is None or not line.strip():
            break
        tokens = _tokenize(line)
        key = tokens[0]
        if key == "EYE":
            position = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "LOOKAT":
            look_at = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "UP":
            up = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "APERTURE":
            aperture = float(tokens[1])
        elif key == "FOCAL":
            focal = float(tokens[1])
        elif key == "ENVLIGHT":
            env_color = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "ENVMAP":
            env_map_path = tokens[1]
            if not os.path.isabs(env_map_path):
                env_map_path = os.path.join(base_dir, env_map_path)
        elif key == "ENVSCALE":
            env_scale = float(tokens[1])

    cam = derive_camera(resolution, position, look_at, up, fovy, aperture, focal)
    env = {
        "color": env_color * env_scale,
        "map_path": env_map_path,
        "scale": env_scale,
    }
    return cam, iterations, trace_depth, image_name, env


def _build_geoms_soa(geoms: List[dict]) -> GeomsSoA:
    n = len(geoms)
    transforms = np.zeros((n, 4, 4), np.float32)
    inverses = np.zeros((n, 4, 4), np.float32)
    inv_transposes = np.zeros((n, 4, 4), np.float32)
    gtypes = np.zeros((n,), np.int32)
    mat_ids = np.zeros((n,), np.int32)
    tri_start = np.zeros((n,), np.int32)
    tri_count = np.zeros((n,), np.int32)
    velocity = np.zeros((n, 3), np.float32)
    has_uv = np.zeros((n,), bool)
    for i, g in enumerate(geoms):
        # TRS composition + inverse + invTranspose per src/scene.cpp:82-85.
        t = math3d.build_transformation_matrix(
            g["translation"], g["rotation"], g["scale"]
        )
        transforms[i] = t
        inverses[i] = math3d.inverse(t)
        inv_transposes[i] = math3d.inverse_transpose(t)
        gtypes[i] = int(g["gtype"])
        mat_ids[i] = g["material_id"]
        tri_start[i] = g["tri_start"]
        tri_count[i] = g["tri_count"]
        velocity[i] = g["velocity"]
        has_uv[i] = g.get("has_uv", False)
    return GeomsSoA(
        gtype=gtypes,
        material_id=mat_ids,
        transform=transforms,
        inverse_transform=inverses,
        inv_transpose=inv_transposes,
        tri_start=tri_start,
        tri_count=tri_count,
        velocity=velocity,
        has_uv=has_uv,
    )


TEX_RES = 256  # all file textures are resampled to this square size


def _load_texture(path: str, grayscale: bool = False) -> np.ndarray:
    """An 8-bit PNG as (TEX_RES, TEX_RES, 3) float albedo in [0,1], or
    (TEX_RES, TEX_RES) heights when `grayscale` (`utils.image.read_png`:
    Pillow's RGB / L conversion), resized bilinearly to the atlas,
    bit for bit the JAX package's Pillow BILINEAR (`utils.resample`)."""
    img = resize_bilinear(read_png(path, "L" if grayscale else "RGB"),
                          TEX_RES, TEX_RES)
    # int * float32(1/255), NOT /255: the JAX package's atlas fetch
    # (ops/megakernel.py::_file_tex_fetch) recovers the exact integer
    # texel and multiplies by float32(1/255) — same formula here makes
    # the XLA gather path and the kernel path bit-identical.
    return img.astype(np.float32) * np.float32(1.0 / 255.0)


def _build_materials_soa(materials: List[dict]):
    n = max(len(materials), 1)

    def col(key, width=None):
        if width:
            out = np.zeros((n, width), np.float32)
        else:
            out = np.zeros((n,), np.float32)
        for i, m in enumerate(materials):
            out[i] = m[key]
        return out

    tex_kind = np.zeros((n,), np.int32)
    tex_id = np.zeros((n,), np.int32)
    tex_scale = np.ones((n,), np.float32)
    bump_id = np.full((n,), -1, np.int32)
    bump_scale = np.ones((n,), np.float32)
    tex_paths: List[str] = []
    bump_paths: List[str] = []

    for i, m in enumerate(materials):
        tex_scale[i] = m.get("tex_scale", 1.0)
        bump_scale[i] = m.get("bump_scale", 1.0)
        tex = m.get("texture")
        if tex == "checker":
            tex_kind[i] = 1
        elif tex:
            tex_kind[i] = 2
            if tex not in tex_paths:
                tex_paths.append(tex)
            tex_id[i] = tex_paths.index(tex)
        bump = m.get("bump")
        if bump:
            if bump not in bump_paths:
                bump_paths.append(bump)
            bump_id[i] = bump_paths.index(bump)

    textures = (
        np.stack([_load_texture(p) for p in tex_paths])
        if tex_paths
        else np.zeros((0, TEX_RES, TEX_RES, 3), np.float32)
    )
    bumps = (
        np.stack([_load_texture(p, grayscale=True) for p in bump_paths])
        if bump_paths
        else np.zeros((0, TEX_RES, TEX_RES), np.float32)
    )

    soa = MaterialsSoA(
        color=col("color", 3),
        specular_exponent=col("specular_exponent"),
        specular_color=col("specular_color", 3),
        has_reflective=col("has_reflective"),
        has_refractive=col("has_refractive"),
        index_of_refraction=col("index_of_refraction"),
        emittance=col("emittance"),
        subsurface=col("subsurface"),
        tex_kind=tex_kind,
        tex_id=tex_id,
        tex_scale=tex_scale,
        bump_id=bump_id,
        bump_scale=bump_scale,
    )
    return soa, textures, bumps


def _concat_triangles(blocks: List[TriangleSoup]) -> TriangleSoup:
    if not blocks:
        return TriangleSoup.empty()
    return TriangleSoup(
        v0=np.concatenate([b.v0 for b in blocks]),
        v1=np.concatenate([b.v1 for b in blocks]),
        v2=np.concatenate([b.v2 for b in blocks]),
        n0=np.concatenate([b.n0 for b in blocks]),
        n1=np.concatenate([b.n1 for b in blocks]),
        n2=np.concatenate([b.n2 for b in blocks]),
        uv0=np.concatenate([b.uv0 for b in blocks]),
        uv1=np.concatenate([b.uv1 for b in blocks]),
        uv2=np.concatenate([b.uv2 for b in blocks]),
        has_uv=any(b.has_uv for b in blocks),
    )


def scene_summary(scene: Scene) -> str:
    s = scene.state
    return (
        f"scene {os.path.basename(scene.source_path) or '<inline>'}: "
        f"{scene.geoms.count} geoms, {scene.materials.count} materials, "
        f"{scene.triangles.count} triangles, "
        f"{s.camera.resolution[0]}x{s.camera.resolution[1]} "
        f"@ {s.iterations} spp, depth {s.trace_depth}"
    )
