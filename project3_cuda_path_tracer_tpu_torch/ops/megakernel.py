"""The whole-iteration kernel: wrapper, plain version and launch count.

`full_iteration` replaces the JAX package's
`ops/megakernel.py::full_iteration_pallas`: one launch per iteration does
raygen and all `trace_depth` bounces and adds each pixel's radiance into
the accumulator. On CUDA tensors it launches the hand-written kernel
(csrc/full_iteration.cu, built by ops/_native.py) or raises; on CPU
tensors, and only there, it runs the plain PyTorch version,
`full_iteration_reference` (generate_rays -> D x (intersect_scene ->
_shade_step) -> radiance), the JAX package's XLA path op for op.

The kernel's scene tables (`pack_scene_tables`) keep the JAX kernel's
(G,16) matrix rows and its first 11 material columns; the mesh, texture
and env-map tables arrive with their slices (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.device import DeviceCamera, DeviceScene
from .vec import Vec3

# material table columns (the first 11 of the JAX kernel's layout)
MAT_COLS = 11

# settings / scene-class flags, as csrc/full_iteration.cu reads them
FLAG_ANTIALIAS = 1
FLAG_DOF = 2
FLAG_PARTIAL_REFL = 4
FLAG_REFRACTIVE = 8
FLAG_RUSSIAN_ROULETTE = 16
FLAG_GLOSSY = 32
FLAG_ENV_CONST = 64


class SceneTables(NamedTuple):
    xf: torch.Tensor  # (G,16) f32 transforms, row-major
    inv: torch.Tensor  # (G,16) f32 inverses
    invt: torch.Tensor  # (G,16) f32 inverse transposes
    gtype: torch.Tensor  # (G,) int32
    gmat: torch.Tensor  # (G,) int32 material ids
    mat: torch.Tensor  # (M,MAT_COLS) f32: color rgb, specular rgb,
    #                    REFL, REFR, IOR, EMITTANCE, SPECEX
    env: torch.Tensor  # (3,) f32 constant environment radiance


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


def check_supported(scene: DeviceScene, settings) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a scene or
    setting that this slice of the port does not render. The check is
    the same on every device: the CPU path never renders what the card
    cannot."""
    refusals = [
        (scene.any_sss, "subsurface scattering (SSS)", 3),
        (scene.any_textured, "textures (TEXTURE)", 3),
        (scene.any_bump, "bump maps (BUMP)", 3),
        (scene.has_env_map, "lat-long environment maps (ENVMAP)", 3),
        (settings.sort_by_material, "material sort", 2),
        (settings.compact, "stream compaction", 2),
        (settings.cache_first_bounce, "the first-bounce cache", 2),
        (settings.stratified, "stratified (R2) sampling", 2),
        (settings.sobol, "Sobol sampling", 2),
        (settings.motion_blur, "motion blur", 2),
        (settings.direct_lighting, "direct lighting (final-bounce NEE)", 3),
        (settings.nee_mis, "NEE with MIS", 3),
        (settings.tri_axis is not None, "triangle sharding", 5),
    ]
    for needed, what, slice_no in refusals:
        if needed:
            raise NotImplementedError(
                f"{what} is not ported yet: see ROADMAP, port slice "
                f"{slice_no}"
            )


def kernel_flags(scene: DeviceScene, settings) -> int:
    return (
        FLAG_ANTIALIAS * bool(settings.antialias)
        | FLAG_DOF * bool(settings.depth_of_field)
        | FLAG_PARTIAL_REFL * scene.any_partial_reflective
        | FLAG_REFRACTIVE * scene.any_refractive
        | FLAG_RUSSIAN_ROULETTE * bool(settings.russian_roulette)
        | FLAG_GLOSSY * scene.any_glossy
        | FLAG_ENV_CONST * scene.has_env_const
    )


def pack_scene_tables(scene: DeviceScene) -> SceneTables:
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
        ],
        dim=1,
    ).contiguous()
    return SceneTables(
        xf=scene.transform.reshape(G, 16).contiguous(),
        inv=scene.inverse_transform.reshape(G, 16).contiguous(),
        invt=scene.inv_transpose.reshape(G, 16).contiguous(),
        gtype=torch.tensor(scene.gtypes, dtype=torch.int32, device=dev).reshape(G),
        gmat=scene.geom_material_id.to(torch.int32).contiguous(),
        mat=mat,
        env=scene.env_color.contiguous(),
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


def full_iteration_reference(
    scene: DeviceScene, cam: DeviceCamera, iteration: int, settings
) -> Vec3:
    """The plain PyTorch version: one full sample per pixel, returned as
    per-pixel radiance (a Vec3 of (P,) lanes). Runs on any device."""
    from ..render import trace_paths

    return trace_paths(scene, cam, iteration, settings)


def _check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def full_iteration(
    scene: DeviceScene,
    cam: DeviceCamera,
    iteration0: int,
    settings,
    accum: Vec3,
    n_iters: int = 1,
) -> None:
    """Render iterations iteration0 .. iteration0 + n_iters - 1 (1-based)
    and add their per-pixel radiance into `accum` (three (P,) float32
    tensors) in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once per iteration on PyTorch's current stream, counting each launch
    in `full_iteration.launches`; any other device raises. The tables
    are packed once per call."""
    check_supported(scene, settings)
    device = accum.x.device
    if int(iteration0) < 1:
        raise ValueError(f"iterations are 1-based, got {iteration0}")
    if device.type == "cpu":
        for k in range(n_iters):
            rad = full_iteration_reference(scene, cam, iteration0 + k, settings)
            for a, r in zip(accum, rad):
                a.add_(r)
        return
    if device.type != "cuda":
        raise RuntimeError(f"full_iteration: no kernel for device {device}")

    resx, resy = cam.resolution
    P = resx * resy
    for name, a in zip(("accum.x", "accum.y", "accum.z"), accum):
        _check_tensor(a, name, torch.float32, (P,), device)
    t = pack_scene_tables(scene)
    G = len(scene.gtypes)
    M = t.mat.shape[0]
    for name, a, dtype, shape in (
        ("xf", t.xf, torch.float32, (G, 16)),
        ("inv", t.inv, torch.float32, (G, 16)),
        ("invt", t.invt, torch.float32, (G, 16)),
        ("gtype", t.gtype, torch.int32, (G,)),
        ("gmat", t.gmat, torch.int32, (G,)),
        ("mat", t.mat, torch.float32, (M, MAT_COLS)),
        ("env", t.env, torch.float32, (3,)),
    ):
        _check_tensor(a, name, dtype, shape, device)
    cam_vec = pack_camera(cam)
    _check_tensor(cam_vec, "camera", torch.float32, (16,), device)

    from ._native import load

    fn = load().lib.pt_full_iteration
    dev_index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    flags = kernel_flags(scene, settings)
    for k in range(n_iters):
        rc = fn(
            t.xf.data_ptr(), t.inv.data_ptr(), t.invt.data_ptr(),
            t.gtype.data_ptr(), t.gmat.data_ptr(), G,
            t.mat.data_ptr(), cam_vec.data_ptr(), t.env.data_ptr(),
            accum.x.data_ptr(), accum.y.data_ptr(), accum.z.data_ptr(),
            int(iteration0) + k, resx, resy, int(settings.trace_depth),
            int(settings.rr_start_depth), flags, dev_index, stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"full_iteration kernel launch failed: CUDA error {rc}"
            )
        full_iteration.launches += 1


full_iteration.launches = 0
