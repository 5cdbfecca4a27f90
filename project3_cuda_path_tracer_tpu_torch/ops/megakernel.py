"""The path-tracing kernels: wrappers, plain versions and launch counts.

Six wrappers, each replacing one Pallas kernel of the JAX package's
`ops/megakernel.py`:

- `full_iteration` (#1, `full_iteration_pallas`): raygen and all
  `trace_depth` bounces of up to ITERATIONS_PER_LAUNCH iterations in one
  launch, each pixel's radiance added into the accumulator iteration
  after iteration, by persistent warps whose lanes start the pixel's
  next path when one ends and take a new pixel from a device-side
  counter when the pixel's iterations are done (csrc/full_iteration.cu);
- `first_bounce` (#2, `first_bounce_pallas`): raygen and the depth-0
  bounce, written to a new pool (csrc/bounce.cu);
- `bounce_step` (#3, `bounce_step_pallas`): one fused intersect + shade
  bounce over the pool, in place, skipping lanes at or past a device-side
  live count under compaction (csrc/bounce.cu);
- `shade_step` (#4, `shade_step_pallas`): the shading half of a bounce
  over given Intersections, written to a new pool (csrc/bounce.cu);
- `bounce_step_nee` (#5, `bounce_step_pallas_nee`): one NEE + MIS bounce
  (light sample, shadow ray, power-heuristic weights) over the pool and
  its two MIS aux lanes, in place, by persistent warps that pack the
  pool's live slots into full warps (csrc/nee.cu);
- `full_iteration_nee` (#6, `full_iteration_nee_pallas`): raygen and
  the whole NEE + MIS estimator over all `trace_depth` bounces of up to
  ITERATIONS_PER_LAUNCH iterations in one launch, added into the
  accumulator iteration after iteration, by persistent warps as #1's
  (csrc/nee.cu).

On CUDA tensors a wrapper launches its hand-written kernel (built by
ops/_native.py) or raises; on CPU tensors, and on CUDA tensors under
`RenderSettings.plain` (--no-pallas), it runs its plain PyTorch version
(`*_reference`: generate_rays / intersect_scene / render._shade_step /
render._nee_mis_bounce, the JAX package's XLA path op for op): one
predicate, `runs_plain`, decides for every wrapper. Each wrapper counts
its launches in `<wrapper>.launches`. Each is wrapped by
utils/debug.py's `stage` (--debug-nans: its outputs checked for NaN),
and `_launch`, the one choke point of every launch, checks the card's
error after each launch under --debug.

The pool is the JAX package's state tuple (origins, dirs, throughput,
radiance, alive, pix) with Vec3 lanes, `alive` as int32 (0/1) and `pix`
as int32, every lane a contiguous (P,) tensor. The NEE kernels' MIS aux
is (prev_pdf, prev_nondelta), two float32 (P,) lanes, the flag as 0/1.

The kernels' scene tables (`pack_scene_tables`) keep the JAX kernel's
(G,16) matrix rows and its material column map through column 12
(tex_kind, tex_scale) in `mat`, its columns 13-16 (tex id, bump id, bump
scale, SSS sigma) in `surf`, the f32 texture, bump and lat-long env
atlases, plus the emissive geom indices and the MIS light pdf model
(ops/lights.py::lights_area_weight) for the NEE kernels, and on a mesh
scene the triangle and BVH tables of the mesh pipeline
(`pack_mesh_tables`, read by ops/pipeline.py's kernels #7-#14) and,
under NEE, the binary BVH's `node` rows and each mesh geom's root
(`pack_nee_bvh`). #1-#3 sweep analytic geoms only: a mesh scene takes
ops/pipeline.py (and #4, which intersects nothing), and their wrappers
refuse one. The NEE kernels #5 and #6 render a mesh scene themselves:
their instantiations on the mesh tables walk each mesh geom's binary BVH
with one int cursor (hit ? i + 1 : skip, no stack, any depth) for the
nearest hit and for the shadow ray, the big-mesh route's geoms included.

A scene with file textures, bump maps, a lat-long env map or SSS sets
the surface-stage flags (FLAG_SURFACE_STAGE), and the kernels' C entry
points then launch their instantiations on `TexTables` (each kernel is a
template on its tables), which compile csrc/path_common.cuh's surface
stage; the instantiations on `Tables` keep the code the kernels had
before it existed.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.device import DeviceCamera, DeviceScene
from ..utils import debug
from .lights import lights_area_weight
from .vec import Vec3

# material table columns: the JAX kernel's fixed map through column 12
# (`mat`), then its columns 13-16 (`surf`). The kernels without the surface
# stage read `mat` alone, at its stride of MAT_COLS.
MAT_COLS = 13
SURF_COLS = 4

# settings / scene-class flags, as csrc/path_common.cuh reads them
FLAG_ANTIALIAS = 1
FLAG_DOF = 2
FLAG_PARTIAL_REFL = 4
FLAG_REFRACTIVE = 8
FLAG_RUSSIAN_ROULETTE = 16
FLAG_GLOSSY = 32
FLAG_ENV_CONST = 64
FLAG_STRATIFIED = 128
FLAG_SOBOL = 256
FLAG_CHECKER = 512
FLAG_FILE_TEX = 1024
FLAG_BUMP = 2048
FLAG_ENV_MAP = 4096
FLAG_SSS = 8192
# the flags whose stages only the kernels' instantiations on TexTables compile
FLAG_SURFACE_STAGE = FLAG_FILE_TEX | FLAG_BUMP | FLAG_ENV_MAP | FLAG_SSS

class SceneTables(NamedTuple):
    xf: torch.Tensor  # (G,16) f32 transforms, row-major
    inv: torch.Tensor  # (G,16) f32 inverses
    invt: torch.Tensor  # (G,16) f32 inverse transposes
    gtype: torch.Tensor  # (G,) int32
    gmat: torch.Tensor  # (G,) int32 material ids
    mat: torch.Tensor  # (M,MAT_COLS) f32: color rgb, specular rgb,
    #                    REFL, REFR, IOR, EMITTANCE, SPECEX, tex_kind,
    #                    tex_scale
    env: torch.Tensor  # (3,) f32 constant environment radiance
    lights: torch.Tensor  # (L,) int32 emissive geom indices (NEE kernels)
    surf: torch.Tensor  # (M,SURF_COLS) f32: tex id, bump id, bump scale, SSS
    tex: torch.Tensor  # (N*R*R,4) f32 file texels r, g, b, 0
    bump: torch.Tensor  # (Nb*R*R,) f32 bump heights
    envmap: torch.Tensor  # (ENV_H*ENV_W,4) f32 env texels r, g, b, 0 (or (0,4))
    aw: float | None  # mean light area x L as a float32 value (the NEE
    #                   kernels' MIS); None when packed without `nee`
    # the mesh pipeline's tables (pack_mesh_tables); None without meshes
    mesh: tuple | None = None
    # C's lane-major tables (ops/pipeline.py::pack_sweep_tables); None
    # without meshes
    sweep: tuple | None = None
    # #8's wide BVH (ops/pipeline.py::pack_wide_tables); None without
    # meshes
    wide: tuple | None = None
    # #5's and #6's binary BVH (pack_nee_bvh): (B,4) i32 node rows and
    # (M,2) i32 each mesh geom's root; None without meshes or when packed
    # without `nee`
    node: torch.Tensor | None = None
    roots: torch.Tensor | None = None


# the tables the kernels read, as a C array of pointers in this order
_TABLE_PTRS = 12

# #1's iterations per launch: a lane renders its pixel's paths of all of
# them before it takes the next pixel, so the launch's tail (the last
# paths of the last pixels) is paid once per launch, not per iteration;
# at 800x800 a launch of 32 iterations lasts about 7 ms on an H100
ITERATIONS_PER_LAUNCH = 32
# #3's threads, and lanes, a block (csrc/bounce.cu kBounceThreads): a
# block packs the live ones of its lanes into its first threads
BOUNCE_THREADS = 128


def draw_slots(any_partial_refl: bool, any_refractive: bool,
               russian_roulette: bool):
    """The scene-specialised RNG draw layout: 2 hemisphere draws, then
    one each for the spec/diffuse lottery, the Fresnel lottery and
    Russian roulette, only where the scene or settings can take that
    branch. Returns (n_draws, slot_branch, slot_fresnel, slot_rr)."""
    n_draws = 2
    slot_branch = slot_fresnel = slot_rr = None
    if any_partial_refl:
        slot_branch = n_draws
        n_draws += 1
    if any_refractive:
        slot_fresnel = n_draws
        n_draws += 1
    if russian_roulette:
        slot_rr = n_draws
        n_draws += 1
    return n_draws, slot_branch, slot_fresnel, slot_rr


def checker_only(scene) -> bool:
    """True when the scene's only texturing is the procedural checker,
    which the kernels compute with no table."""
    return (
        scene.any_textured
        and scene.n_file_textures == 0
        and not scene.any_bump
    )


def check_supported(scene: DeviceScene, settings) -> None:
    """Raise ValueError when a kernel that intersects inside itself (#1,
    #2, #3, #5, #6, #9) is asked to render under triangle sharding
    (`settings.tri_axis`): it would see its own slice's triangles only.
    The tri-shard tier intersects through render.intersect_scene_any,
    which merges every slice's hits, and shades with #4, as the JAX
    package's kernel_plan turns its fused tiers off under tri_axis. The
    check is the same on every device."""
    if settings.tri_axis is not None:
        raise ValueError(
            "triangle sharding (tri_axis) needs the merged intersect: this "
            "kernel intersects inside itself; render.trace_paths runs the "
            "tri-shard tier (intersect_scene_any over the shards, then "
            "shade_step)"
        )


def _require_analytic(scene: DeviceScene, what: str) -> None:
    """#1-#3 sweep analytic geoms only."""
    if scene.mesh_geoms:
        raise ValueError(f"{what}: a mesh scene takes the mesh pipeline "
                         "(ops/pipeline.py), not this kernel")


def kernel_flags(scene: DeviceScene, settings) -> int:
    return (
        FLAG_ANTIALIAS * bool(settings.antialias)
        | FLAG_DOF * bool(settings.depth_of_field)
        | FLAG_PARTIAL_REFL * scene.any_partial_reflective
        | FLAG_REFRACTIVE * scene.any_refractive
        | FLAG_RUSSIAN_ROULETTE * bool(settings.russian_roulette)
        | FLAG_GLOSSY * scene.any_glossy
        | FLAG_ENV_CONST * scene.has_env_const
        | FLAG_STRATIFIED * bool(settings.stratified)
        | FLAG_SOBOL * bool(settings.sobol)
        | FLAG_CHECKER * checker_only(scene)
        | FLAG_FILE_TEX * (scene.n_file_textures > 0)
        | FLAG_BUMP * scene.any_bump
        | FLAG_ENV_MAP * scene.has_env_map
        | FLAG_SSS * scene.any_sss
    )


def pack_geom_tables(scene: DeviceScene):
    """The (G,16) transform and inverse rows: the only tables that
    motion blur moves, re-packed once per iteration."""
    G = scene.transform.shape[0]
    return (
        scene.transform.reshape(G, 16).contiguous(),
        scene.inverse_transform.reshape(G, 16).contiguous(),
    )


def pack_mesh_tables(scene: DeviceScene) -> tuple:
    """The mesh pipeline's tables (csrc/mesh_common.cuh's MeshTables), on
    the scene's device: tri (T,12) f32 [v0, v1, v2, 3 pad], attr (T,16)
    f32 [n0, n1, n2, uv0, uv1, uv2, pad], box (B,8) f32 [min, pad, max,
    pad] of the binary BVH's nodes, geoms (M,4) i32 [geom index, first
    node, node count (0 for a geom of the sorted route,
    ops/pipeline.py::sorted_geoms), has_uv] for the M mesh geoms, and the
    big-mesh route's chunk (C,8) and supernode (S,8) boxes [min, max, 0,
    0]. #7 reads each geom's root box; #8 walks the wide BVH collapsed
    from the binary nodes (ops/pipeline.py::pack_wide_tables), which gives
    a geom of the sorted route no root; #5 and #6 walk the binary nodes
    themselves (`pack_nee_bvh`). The tables live in object space, so
    motion blur never re-packs them."""
    from .pipeline import sorted_geoms

    mesh = scene.mesh_geoms
    big = sorted_geoms(scene)
    if any(scene.bvh_roots[g][1] == 0 for g in mesh):
        raise ValueError("the mesh kernels walk the BVH: build the tables "
                         "with scene_to_device(scene, device, use_bvh=True)")
    T = scene.tri_v0.x.shape[0]
    B = scene.bvh_first.shape[0]
    dev = scene.device
    zt = torch.zeros(T, dtype=torch.float32, device=dev)
    zb = torch.zeros(B, dtype=torch.float32, device=dev)
    tri = torch.stack([*scene.tri_v0, *scene.tri_v1, *scene.tri_v2, zt, zt, zt],
                      dim=1).contiguous()
    attr = torch.stack(
        [*scene.tri_n0, *scene.tri_n1, *scene.tri_n2,
         scene.tri_uv0u, scene.tri_uv0v, scene.tri_uv1u, scene.tri_uv1v,
         scene.tri_uv2u, scene.tri_uv2v, zt], dim=1).contiguous()
    box = torch.stack([*scene.bvh_min, zb, *scene.bvh_max, zb], dim=1).contiguous()
    geoms = torch.tensor(
        [[g, scene.bvh_roots[g][0], 0 if g in big else scene.bvh_roots[g][1],
          int(scene.mesh_has_uv[g])] for g in mesh],
        dtype=torch.int32, device=dev,
    ).reshape(len(mesh), 4)
    return (tri, attr, box, geoms, scene.mesh_chunk_aabbs.contiguous(),
            scene.mesh_super_aabbs.contiguous())


def pack_nee_bvh(scene: DeviceScene) -> tuple:
    """#5's and #6's walk tables: node (B,4) i32 [first triangle, count,
    skip, is_leaf] of the binary BVH, and roots (M,2) i32 [first node,
    node count] of every mesh geom (`scene.bvh_roots`), the sorted route's
    included (pack_mesh_tables' `geoms` gives such a geom no node count,
    which #7 and #8 rely on). Object space, so motion blur never re-packs
    them."""
    mesh = scene.mesh_geoms
    node = torch.stack([scene.bvh_first, scene.bvh_count, scene.bvh_skip,
                        scene.bvh_leaf.to(torch.int32)], dim=1).contiguous()
    roots = torch.tensor([scene.bvh_roots[g] for g in mesh], dtype=torch.int32,
                         device=scene.device).reshape(len(mesh), 2)
    return node, roots


def pack_scene_tables(scene: DeviceScene, nee: bool = False) -> SceneTables:
    """The kernels' tables; with `nee` also the MIS light pdf model, read
    back to the host once here, so no NEE launch waits on the device for
    it (motion blur only translates, so it never changes the value); on a
    mesh scene also the mesh pipeline's tables, C's, #8's wide BVH and,
    with `nee`, the binary BVH's nodes and roots that #5 and #6 walk
    (`pack_nee_bvh`)."""
    from .pipeline import pack_sweep_tables, pack_wide_tables

    G = scene.transform.shape[0]
    dev = scene.device
    mat = torch.stack(
        [
            scene.mat_color.x, scene.mat_color.y, scene.mat_color.z,
            scene.mat_specular_color.x, scene.mat_specular_color.y,
            scene.mat_specular_color.z,
            scene.mat_has_reflective, scene.mat_has_refractive,
            scene.mat_ior, scene.mat_emittance,
            scene.mat_specular_exponent,
            scene.mat_tex_kind.to(torch.float32), scene.mat_tex_scale,
        ],
        dim=1,
    ).contiguous()
    surf = torch.stack(
        [scene.mat_tex_id.to(torch.float32), scene.mat_bump_id.to(torch.float32),
         scene.mat_bump_scale, scene.mat_sss],
        dim=1,
    ).contiguous()

    def rgb0(r, g, b):  # texels as rows r, g, b, 0: one 16-byte load each
        return torch.stack([r, g, b, torch.zeros_like(r)], dim=1).contiguous()

    xf, inv = pack_geom_tables(scene)
    node, roots = pack_nee_bvh(scene) if nee and scene.mesh_geoms else (None, None)
    return SceneTables(
        xf=xf,
        inv=inv,
        invt=scene.inv_transpose.reshape(G, 16).contiguous(),
        gtype=torch.tensor(scene.gtypes, dtype=torch.int32, device=dev).reshape(G),
        gmat=scene.geom_material_id.to(torch.int32).contiguous(),
        mat=mat,
        env=scene.env_color.contiguous(),
        lights=torch.tensor(scene.emissive_geoms, dtype=torch.int32,
                            device=dev).reshape(-1),
        surf=surf,
        tex=rgb0(scene.tex_r, scene.tex_g, scene.tex_b),
        bump=scene.bump_h.contiguous(),
        envmap=rgb0(scene.env_r, scene.env_g, scene.env_b),
        aw=float(lights_area_weight(scene)) if nee else None,
        mesh=pack_mesh_tables(scene) if scene.mesh_geoms else None,
        sweep=pack_sweep_tables(scene) if scene.mesh_geoms else None,
        wide=pack_wide_tables(scene) if scene.mesh_geoms else None,
        node=node,
        roots=roots,
    )


def pack_camera(cam: DeviceCamera) -> torch.Tensor:
    """DeviceCamera -> (16,) f32: position, view, up, right,
    pixel_length, aperture, focal distance."""
    return torch.cat(
        [
            cam.position, cam.view, cam.up, cam.right, cam.pixel_length,
            cam.aperture.reshape(1), cam.focal_distance.reshape(1),
        ]
    ).to(torch.float32).contiguous()


# ---- the pool ------------------------------------------------------------

def pool_lanes(state) -> list:
    """The 14 lanes of a pool in kernel order: 12 float32, alive, pix."""
    origins, dirs, throughput, radiance, alive, pix = state
    return [*origins, *dirs, *throughput, *radiance, alive, pix]


def _pool_from_shade(state):
    """render._shade_step's state (bool alive) -> a pool (int32 alive)."""
    return state[:4] + (state[4].to(torch.int32), state[5])


def _shade_from_pool(state):
    return state[:4] + (state[4] != 0, state[5])


def _new_pool(P: int, device, pix: torch.Tensor | None = None):
    """Uninitialised pool lanes: 12 float32 rows of one buffer, alive
    and (unless given) pix."""
    f = torch.empty((12, P), dtype=torch.float32, device=device)
    if pix is None:
        pix = torch.empty(P, dtype=torch.int32, device=device)
    return (
        Vec3(f[0], f[1], f[2]), Vec3(f[3], f[4], f[5]),
        Vec3(f[6], f[7], f[8]), Vec3(f[9], f[10], f[11]),
        torch.empty(P, dtype=torch.int32, device=device), pix,
    )


# ---- plain versions --------------------------------------------------------

def first_bounce_reference(scene: DeviceScene, cam: DeviceCamera,
                           iteration: int, settings):
    """Raygen + the depth-0 bounce, plain PyTorch: the pool after it."""
    from ..render import _shade_step
    from .camera import generate_rays
    from .sweep import intersect_scene

    origins, dirs, pix = generate_rays(
        cam, iteration, settings.antialias, settings.depth_of_field
    )
    P = pix.shape[0]
    state = (origins, dirs, Vec3.ones(P, pix.device), Vec3.zeros(P, pix.device),
             torch.ones(P, dtype=torch.bool, device=pix.device), pix)
    isect = intersect_scene(origins, dirs, scene)
    return _pool_from_shade(
        _shade_step(state, isect, scene, iteration, 0, settings)
    )


def bounce_step_reference(state, scene: DeviceScene, iteration: int,
                          depth: int, settings, num_alive=None, isect=None):
    """One intersect + shade bounce over the pool, plain PyTorch; returns
    a new pool. Lanes at or past `num_alive` (a scalar tensor) are left
    as they are, as the kernel leaves them. `isect`: the pool's
    Intersections when the caller has them (the mesh pipeline's #9),
    else `intersect_scene` computes them."""
    from ..render import _shade_step
    from .sweep import intersect_scene

    s = _shade_from_pool(state)
    alive_in = s[4]
    if num_alive is not None:
        skip = torch.arange(alive_in.shape[0], device=alive_in.device) >= num_alive
        s = s[:4] + (alive_in & ~skip, s[5])
    if isect is None:
        isect = intersect_scene(s[0], s[1], scene)
    out = _shade_step(s, isect, scene, iteration, depth, settings)
    if num_alive is not None:
        out = out[:4] + (torch.where(skip, alive_in, out[4]), out[5])
    return _pool_from_shade(out)


def shade_step_reference(state, isect, scene: DeviceScene, iteration: int,
                         depth: int, settings):
    """The shading half of a bounce over given Intersections, plain
    PyTorch; returns a new pool."""
    from ..render import _shade_step

    return _pool_from_shade(
        _shade_step(_shade_from_pool(state), isect, scene, iteration, depth,
                    settings)
    )


def full_iteration_reference(
    scene: DeviceScene, cam: DeviceCamera, iteration: int, settings
) -> Vec3:
    """The plain PyTorch version of #1: one full sample per pixel,
    returned as per-pixel radiance (a Vec3 of (P,) lanes). Runs on any
    device."""
    state = first_bounce_reference(scene, cam, iteration, settings)
    for depth in range(1, settings.trace_depth):
        state = bounce_step_reference(state, scene, iteration, depth, settings)
    return state[3]


def bounce_step_nee_reference(state, aux, scene: DeviceScene, iteration: int,
                              depth: int, settings, is_last: bool):
    """One NEE + MIS bounce over the pool, plain PyTorch
    (render._nee_mis_bounce); returns a new (pool, aux), the aux flag as
    float32 0/1. Unlike the kernel, it also writes the aux lanes of lanes
    that were dead on entry; no later step reads those."""
    from ..render import _nee_mis_bounce

    out, (pdf, nondelta) = _nee_mis_bounce(
        _shade_from_pool(state), (aux[0], aux[1] > 0.5), scene, iteration,
        depth, settings, is_last,
    )
    return _pool_from_shade(out), (pdf, nondelta.to(torch.float32))


def full_iteration_nee_reference(
    scene: DeviceScene, cam: DeviceCamera, iteration: int, settings
) -> Vec3:
    """The plain PyTorch version of #6: raygen, then the NEE + MIS
    estimator (render._nee_mis_bounce) over depths 0..D-1 with the MIS
    aux starting at zeros and the last depth at is_last; per-pixel
    radiance as a Vec3 of (P,) lanes. Runs on any device."""
    from ..render import _nee_mis_bounce
    from .camera import generate_rays

    origins, dirs, pix = generate_rays(
        cam, iteration, settings.antialias, settings.depth_of_field
    )
    P = pix.shape[0]
    dev = pix.device
    state = (origins, dirs, Vec3.ones(P, dev), Vec3.zeros(P, dev),
             torch.ones(P, dtype=torch.bool, device=dev), pix)
    aux = (torch.zeros(P, dtype=torch.float32, device=dev),
           torch.zeros(P, dtype=torch.bool, device=dev))
    D = settings.trace_depth
    for depth in range(D):
        state, aux = _nee_mis_bounce(state, aux, scene, iteration, depth,
                                     settings, is_last=depth == D - 1)
    return state[3]


# ---- launch plumbing -------------------------------------------------------

def _check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


_LANE_NAMES = ("origins.x", "origins.y", "origins.z", "dirs.x", "dirs.y",
               "dirs.z", "throughput.x", "throughput.y", "throughput.z",
               "radiance.x", "radiance.y", "radiance.z", "alive", "pix")


def _check_pool(state, P: int, device) -> list:
    lanes = pool_lanes(state)
    for k, (name, a) in enumerate(zip(_LANE_NAMES, lanes)):
        dtype = torch.float32 if k < 12 else torch.int32
        _check_tensor(a, name, dtype, (P,), device)
    return lanes


def runs_plain(device: torch.device, plain: bool = False) -> bool:
    """The one choice between a kernel and its plain PyTorch version,
    made by every wrapper here and in ops/pipeline.py: the plain version on
    CPU tensors, and on CUDA tensors when `plain` is asked for
    (`RenderSettings.plain`, the CLI's --no-pallas); else the kernel."""
    return device.type == "cpu" or bool(plain)


def _require_cuda(device, what: str) -> None:
    if device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {device}")


def _check_tables(t: SceneTables, scene: DeviceScene, device) -> None:
    from .texture import ENV_H, ENV_W, TEX_RES

    G = len(scene.gtypes)
    M = t.mat.shape[0]
    texels = TEX_RES * TEX_RES
    for name, a, dtype, shape in (
        ("xf", t.xf, torch.float32, (G, 16)),
        ("inv", t.inv, torch.float32, (G, 16)),
        ("invt", t.invt, torch.float32, (G, 16)),
        ("gtype", t.gtype, torch.int32, (G,)),
        ("gmat", t.gmat, torch.int32, (G,)),
        ("mat", t.mat, torch.float32, (M, MAT_COLS)),
        ("env", t.env, torch.float32, (3,)),
        ("lights", t.lights, torch.int32, (len(scene.emissive_geoms),)),
        ("surf", t.surf, torch.float32, (M, SURF_COLS)),
        ("tex", t.tex, torch.float32, (scene.n_file_textures * texels, 4)),
        ("bump", t.bump, torch.float32, (scene.n_bump_textures * texels,)),
        ("envmap", t.envmap, torch.float32,
         (ENV_H * ENV_W if scene.has_env_map else 0, 4)),
    ):
        _check_tensor(a, name, dtype, shape, device)


def _ptrs(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (None -> NULL)."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if a is None else a.data_ptr() for a in tensors)
    )


def _launch(name: str, what: str, *args) -> None:
    from ._native import load

    rc = load().fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    if debug.STATE.launches:  # --debug: checkCUDAError after the launch
        debug.check_launch(what, name)


def _device_args(device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _tables_for(scene: DeviceScene, tables, device, nee: bool = False):
    t = tables if tables is not None else pack_scene_tables(scene, nee)
    _check_tables(t, scene, device)
    if nee and t.aw is None:
        raise ValueError("the NEE kernels need tables packed with "
                         "pack_scene_tables(scene, nee=True)")
    return t, _ptrs(t[:_TABLE_PTRS])


def _require_lights(scene: DeviceScene, what: str) -> None:
    if not scene.emissive_geoms:
        raise ValueError(f"{what}: NEE needs an emissive geom")


def _nee_mesh_args(t: SceneTables, scene: DeviceScene, device) -> tuple:
    """The NEE kernels' mesh arguments: the pointers of the mesh tables
    and of the binary BVH's nodes and roots, and the mesh geoms' count;
    (NULL, 0) without meshes (the analytic instantiations)."""
    if not scene.mesh_geoms:
        return None, 0
    from .pipeline import check_mesh_tables

    check_mesh_tables(t, scene, device)
    if t.node is None or t.roots is None:
        raise ValueError("the NEE kernels need the binary BVH's nodes and "
                         "roots (pack_scene_tables(scene, nee=True))")
    _check_tensor(t.node, "node", torch.int32, (scene.bvh_first.shape[0], 4), device)
    _check_tensor(t.roots, "roots", torch.int32, (len(scene.mesh_geoms), 2), device)
    return _ptrs(list(t.mesh) + [t.node, t.roots]), len(scene.mesh_geoms)


# ---- the wrappers ----------------------------------------------------------

@debug.stage
def full_iteration(
    scene: DeviceScene,
    cam: DeviceCamera,
    iteration0: int,
    settings,
    accum: Vec3,
    n_iters: int = 1,
    tables: SceneTables | None = None,
) -> None:
    """Render iterations iteration0 .. iteration0 + n_iters - 1 (1-based)
    and add their per-pixel radiance into `accum` (three (P,) float32
    tensors) in place, iteration after iteration.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once per ITERATIONS_PER_LAUNCH iterations (or fewer) on PyTorch's
    current stream, counting each launch in `full_iteration.launches`;
    any other device raises. The tables are packed once per call unless
    given."""
    _whole_iterations(full_iteration, full_iteration_reference, False, scene,
                      cam, iteration0, settings, accum, n_iters, tables)


def _whole_iterations(wrapper, reference, nee: bool, scene: DeviceScene,
                      cam: DeviceCamera, iteration0: int, settings,
                      accum: Vec3, n_iters: int, tables) -> None:
    """The body of the two whole-iteration wrappers (#1, and #6 when
    `nee`): the plain version on CPU tensors, else launches of
    `pt_<wrapper>`, one per ITERATIONS_PER_LAUNCH iterations or fewer,
    counted in `wrapper.launches`. The kernels' persistent warps take
    pixels from a device-side counter, one int32 word per launch, so no
    launch shares a count with another and the host never reads one."""
    what = wrapper.__name__
    check_supported(scene, settings)
    if nee:
        _require_lights(scene, what)
    else:
        _require_analytic(scene, what)
    device = accum.x.device
    if int(iteration0) < 1:
        raise ValueError(f"iterations are 1-based, got {iteration0}")
    if runs_plain(device, settings.plain):
        for k in range(n_iters):
            rad = reference(scene, cam, iteration0 + k, settings)
            for a, r in zip(accum, rad):
                a.add_(r)
        return
    _require_cuda(device, what)

    resx, resy = cam.resolution
    P = resx * resy
    for name, a in zip(("accum.x", "accum.y", "accum.z"), accum):
        _check_tensor(a, name, torch.float32, (P,), device)
    t, tptr = _tables_for(scene, tables, device, nee)
    lights = ((len(scene.emissive_geoms), t.aw, *_nee_mesh_args(t, scene, device))
              if nee else ())
    cam_vec = pack_camera(cam)
    _check_tensor(cam_vec, "camera", torch.float32, (16,), device)
    acc = _ptrs(list(accum))
    dev_index, stream = _device_args(device)
    flags = kernel_flags(scene, settings)
    runs = [(int(iteration0) + k, min(ITERATIONS_PER_LAUNCH, n_iters - k))
            for k in range(0, n_iters, ITERATIONS_PER_LAUNCH)]
    # the pixel counters: one word per launch, zeroed by one memset here
    counters = torch.zeros(len(runs), dtype=torch.int32, device=device)
    for j, (first, count) in enumerate(runs):
        _launch(
            f"pt_{what}", what,
            tptr, len(scene.gtypes), *lights, cam_vec.data_ptr(), acc,
            first, count, resx, resy, int(settings.trace_depth),
            int(settings.rr_start_depth), flags, counters[j].data_ptr(),
            dev_index, stream,
        )
        wrapper.launches += 1


@debug.stage
def first_bounce(scene: DeviceScene, cam: DeviceCamera, iteration: int,
                 settings, tables: SceneTables | None = None):
    """Raygen + the depth-0 bounce of iteration `iteration` (1-based),
    returned as a new pool with pix = slot. CPU: the plain version; CUDA:
    one launch of the kernel, counted in `first_bounce.launches`."""
    check_supported(scene, settings)
    _require_analytic(scene, "first_bounce")
    device = cam.position.device
    if runs_plain(device, settings.plain):
        return first_bounce_reference(scene, cam, iteration, settings)
    _require_cuda(device, "first_bounce")
    resx, resy = cam.resolution
    t, tptr = _tables_for(scene, tables, device)
    cam_vec = pack_camera(cam)
    _check_tensor(cam_vec, "camera", torch.float32, (16,), device)
    out = _new_pool(resx * resy, device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_first_bounce", "first_bounce",
        tptr, len(scene.gtypes), cam_vec.data_ptr(), _ptrs(pool_lanes(out)),
        int(iteration), resx, resy, int(settings.rr_start_depth),
        kernel_flags(scene, settings), dev_index, stream,
    )
    first_bounce.launches += 1
    return out


@debug.stage
def bounce_step(state, scene: DeviceScene, iteration: int, depth: int,
                settings, num_alive: torch.Tensor | None = None,
                tables: SceneTables | None = None):
    """One intersect + shade bounce over the pool, IN PLACE (the JAX
    version returns new arrays; this one writes the pool's own lanes and
    returns the same tuple). With `num_alive` (an int32 scalar tensor on
    the pool's device; live lanes first, as after compaction) lanes at or
    past it are skipped. CPU: the plain version, copied back into the
    lanes; CUDA: one launch, counted in `bounce_step.launches`; no host
    sync either way."""
    check_supported(scene, settings)
    _require_analytic(scene, "bounce_step")
    device = state[5].device
    if runs_plain(device, settings.plain):
        new = bounce_step_reference(state, scene, iteration, depth, settings,
                                    num_alive)
        for dst, src in zip(pool_lanes(state), pool_lanes(new)):
            dst.copy_(src)
        return state
    _require_cuda(device, "bounce_step")
    P = state[5].shape[0]
    lanes = _check_pool(state, P, device)
    if num_alive is not None:
        _check_tensor(num_alive.reshape(1), "num_alive", torch.int32, (1,), device)
    t, tptr = _tables_for(scene, tables, device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_bounce_step", "bounce_step",
        tptr, len(scene.gtypes), _ptrs(lanes),
        None if num_alive is None else num_alive.data_ptr(), P,
        int(iteration), int(depth), int(settings.rr_start_depth),
        kernel_flags(scene, settings), dev_index, stream,
    )
    bounce_step.launches += 1
    return state


@debug.stage
def shade_step(state, isect, scene: DeviceScene, iteration: int, depth: int,
               settings, tables: SceneTables | None = None):
    """The shading half of a bounce over `isect` (ops.intersect.
    Intersections in pool order), returned as a new pool; pix passes
    through, and each lane draws its numbers by its own pix, so a pool
    permuted together with its Intersections (the material sort) shades
    to the same permutation of the same lanes; under --shard tri the merged
    pool of every slice (render.trace_paths). CPU: the plain version;
    CUDA: one launch, counted in `shade_step.launches`."""
    device = state[5].device
    if runs_plain(device, settings.plain):
        return shade_step_reference(state, isect, scene, iteration, depth,
                                    settings)
    _require_cuda(device, "shade_step")
    P = state[5].shape[0]
    lanes = _check_pool(state, P, device)
    is_lanes = [isect.t, *isect.normal, isect.material_id,
                isect.outside.to(torch.int32), isect.tex_u, isect.tex_v,
                isect.has_uv.to(torch.int32)]
    for name, a, dtype in zip(
        ("isect.t", "isect.normal.x", "isect.normal.y", "isect.normal.z",
         "isect.material_id", "isect.outside", "isect.tex_u", "isect.tex_v",
         "isect.has_uv"),
        is_lanes, [torch.float32] * 4 + [torch.int32] * 2 + [torch.float32] * 2
        + [torch.int32],
    ):
        _check_tensor(a, name, dtype, (P,), device)
    t, tptr = _tables_for(scene, tables, device)
    out = _new_pool(P, device, pix=state[5])
    dev_index, stream = _device_args(device)
    _launch(
        "pt_shade_step", "shade_step",
        tptr, len(scene.gtypes), _ptrs(lanes), _ptrs(is_lanes),
        _ptrs(pool_lanes(out)), P, int(iteration), int(depth),
        int(settings.rr_start_depth), kernel_flags(scene, settings),
        dev_index, stream,
    )
    shade_step.launches += 1
    return out


@debug.stage
def bounce_step_nee(state, aux, scene: DeviceScene, iteration: int,
                    depth: int, settings, is_last: bool,
                    tables: SceneTables | None = None,
                    counter: torch.Tensor | None = None):
    """One NEE + MIS bounce over the pool and its MIS aux lanes
    (prev_pdf, prev_nondelta: float32 (P,), the flag 0/1), IN PLACE;
    returns (state, aux), the same tensors. `is_last`: the light sample
    takes full weight and every lane ends. A lane dead on entry keeps its
    lanes and aux bit for bit; a lane that ends here gets aux (0, 0).
    CPU: the plain version, copied back into the lanes alive on entry;
    CUDA: one launch, counted in `bounce_step_nee.launches`, whose
    persistent warps take the pool in chunks from a device-side counter
    and bounce its live slots 32 at a time. `counter`: that word, an
    int32 zero on the device that no other launch uses (`_trace_nee`
    zeroes one per depth together); allocated here when None."""
    check_supported(scene, settings)
    _require_lights(scene, "bounce_step_nee")
    device = state[5].device
    if runs_plain(device, settings.plain):
        live = state[4] != 0
        new, new_aux = bounce_step_nee_reference(
            state, aux, scene, iteration, depth, settings, is_last
        )
        for dst, src in zip(pool_lanes(state) + list(aux),
                            pool_lanes(new) + list(new_aux)):
            dst.copy_(torch.where(live, src, dst))
        return state, aux
    _require_cuda(device, "bounce_step_nee")
    P = state[5].shape[0]
    lanes = _check_pool(state, P, device)
    for name, a in zip(("prev_pdf", "prev_nondelta"), aux):
        _check_tensor(a, name, torch.float32, (P,), device)
    t, tptr = _tables_for(scene, tables, device, nee=True)
    mesh = _nee_mesh_args(t, scene, device)
    if counter is None:
        counter = torch.zeros((), dtype=torch.int32, device=device)
    _check_tensor(counter, "counter", torch.int32, (), device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_bounce_step_nee", "bounce_step_nee",
        tptr, len(scene.gtypes), len(scene.emissive_geoms), t.aw, *mesh,
        _ptrs(lanes + list(aux)), P, int(iteration), int(depth),
        int(bool(is_last)), int(settings.rr_start_depth),
        kernel_flags(scene, settings), counter.data_ptr(), dev_index, stream,
    )
    bounce_step_nee.launches += 1
    return state, aux


@debug.stage
def full_iteration_nee(
    scene: DeviceScene,
    cam: DeviceCamera,
    iteration0: int,
    settings,
    accum: Vec3,
    n_iters: int = 1,
    tables: SceneTables | None = None,
) -> None:
    """Render iterations iteration0 .. iteration0 + n_iters - 1 (1-based)
    with the NEE + MIS estimator and add their per-pixel radiance into
    `accum` in place, iteration after iteration. CPU: the plain version;
    CUDA: one launch per ITERATIONS_PER_LAUNCH iterations (or fewer),
    counted in `full_iteration_nee.launches`, as `full_iteration`."""
    _whole_iterations(full_iteration_nee, full_iteration_nee_reference, True,
                      scene, cam, iteration0, settings, accum, n_iters, tables)


full_iteration.launches = 0
first_bounce.launches = 0
bounce_step.launches = 0
shade_step.launches = 0
bounce_step_nee.launches = 0
full_iteration_nee.launches = 0
