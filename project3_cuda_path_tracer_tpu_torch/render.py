"""The render core: settings, the plain shading path, and the renderer.

The PyTorch counterpart of the JAX package's `render.py` for this slice
of the port. The CUDA reference's shape
    generateRayFromCamera -> while(depth) { computeIntersections; shade }
    -> finalGather -> tonemap
has two implementations here:
- the hand-written whole-iteration kernel (ops/megakernel.py::
  full_iteration, csrc/full_iteration.cu), which `Renderer` runs on CUDA;
- its plain PyTorch version, `trace_paths` below (generate_rays -> per
  depth intersect_scene -> _shade_step), which runs on the CPU and which
  the tests hold against the JAX package's XLA path.

There is no tier choice to make: every scene and setting this slice
renders takes the same kernel, with no limit on geoms x materials (that
rule of the JAX package was a TPU compile-time trade-off). What the
slice does not render is refused on every device by
megakernel.check_supported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .models.device import (
    DeviceCamera,
    DeviceScene,
    camera_to_device,
    scene_to_device,
)
from .models.scene import Scene, derive_camera
from .ops import rng
from .ops.bsdf import scatter
from .ops.camera import generate_rays
from .ops.intersect import Intersections
from .ops.megakernel import check_supported, draw_slots, full_iteration
from .ops.sweep import intersect_scene
from .ops.vec import Vec3, take as vtake, where as vwhere
from .utils import image as image_io


@dataclass(frozen=True)
class RenderSettings:
    """Runtime toggles; the same fields and defaults as the JAX
    package's RenderSettings. Fields of later slices are kept so that a
    setting the port does not render yet is refused by name
    (megakernel.check_supported). `use_bvh` and `use_pallas` select
    nothing here: analytic scenes have no BVH, and the device alone
    decides the path (the kernel on CUDA, its plain version on the CPU)."""

    trace_depth: int = 8
    sort_by_material: bool = False
    compact: bool = False
    cache_first_bounce: bool = False
    antialias: bool = False
    depth_of_field: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 3
    direct_lighting: bool = False
    nee_mis: bool = False
    stratified: bool = False
    sobol: bool = False
    tri_axis: "str | None" = None
    motion_blur: bool = False
    use_bvh: bool = True
    use_pallas: bool = False


def _gather_materials(scene: DeviceScene, mat_id: torch.Tensor):
    safe = torch.clamp(mat_id, min=0).to(torch.int64)
    return (
        vtake(scene.mat_color, safe),
        vtake(scene.mat_specular_color, safe),
        scene.mat_has_reflective[safe],
        scene.mat_has_refractive[safe],
        scene.mat_ior[safe],
        scene.mat_emittance[safe],
        scene.mat_specular_exponent[safe] if scene.any_glossy else None,
    )


def _shade_step(state, isect: Intersections, scene: DeviceScene,
                iteration: int, depth: int, settings: RenderSettings):
    """One masked shading step over the whole pool; the JAX package's
    `_shade_step` for analytic materials and the constant environment.

    state = (origins, dirs, throughput, radiance, alive, pix). RNG draws
    follow the scene-specialised slot layout (megakernel.draw_slots),
    keyed (iteration, pixelIndex, depth)."""
    origins, dirs, throughput, radiance, alive, pix = state
    hit = isect.t > 0.0
    zeros = Vec3.zeros(pix.shape[0], pix.device)

    if scene.has_env_const:
        # escaped rays collect the environment radiance, then die
        env = Vec3.broadcast(scene.env_color, pix.shape[0])
        radiance = radiance + vwhere(alive & ~hit, throughput * env, zeros)

    n_draws, slot_branch, slot_fresnel, slot_rr = draw_slots(
        scene.any_partial_reflective,
        scene.any_refractive,
        settings.russian_roulette,
    )
    u = rng.uniforms(iteration, pix, depth, n_draws)

    mats = _gather_materials(scene, isect.material_id)
    new_origin, new_dir, tint, emitted, at_light = scatter(
        origins,
        dirs,
        isect.t,
        isect.normal,
        isect.outside,
        *mats,
        u_hemi1=u[0],
        u_hemi2=u[1],
        u_branch=None if slot_branch is None else u[slot_branch],
        u_fresnel=None if slot_fresnel is None else u[slot_fresnel],
    )

    live_hit = alive & hit
    # light hit: contribute throughput * (color*emittance), terminate
    lit = live_hit & at_light
    radiance = radiance + vwhere(lit, throughput * emitted, zeros)
    cont = live_hit & ~at_light
    throughput = vwhere(cont, throughput * tint, throughput)

    if settings.russian_roulette:
        # kill low-throughput paths with survival prob = max component,
        # compensating survivors
        p_survive = torch.clamp(throughput.max_component(), 0.05, 1.0)
        do_rr = cont & (depth >= settings.rr_start_depth)
        killed = do_rr & (u[slot_rr] >= p_survive)
        throughput = vwhere(do_rr, throughput * (1.0 / p_survive), throughput)
        cont = cont & ~killed

    alive = cont
    origins = vwhere(alive, new_origin, origins)
    dirs = vwhere(alive, new_dir, dirs)
    return (origins, dirs, throughput, radiance, alive, pix)


def trace_paths(scene: DeviceScene, cam: DeviceCamera, iteration: int,
                settings: RenderSettings) -> Vec3:
    """One full sample per pixel, plain PyTorch: raygen -> trace_depth x
    (intersect_scene -> _shade_step). Returns per-pixel radiance."""
    origins, dirs, pix = generate_rays(
        cam, iteration, settings.antialias, settings.depth_of_field
    )
    P = pix.shape[0]
    device = pix.device
    state = (
        origins,
        dirs,
        Vec3.ones(P, device),
        Vec3.zeros(P, device),
        torch.ones(P, dtype=torch.bool, device=device),
        pix,
    )
    for depth in range(settings.trace_depth):
        isect = intersect_scene(state[0], state[1], scene)
        state = _shade_step(state, isect, scene, iteration, depth, settings)
    return state[3]


def render_batch(scene: DeviceScene, cam: DeviceCamera, accum: Vec3,
                 iteration0: int, n_iters: int,
                 settings: RenderSettings) -> Vec3:
    """n_iters full samples added into accum (in place), starting at the
    1-based iteration id `iteration0`: the whole-iteration kernel on CUDA,
    its plain version on the CPU."""
    full_iteration(scene, cam, iteration0, settings, accum, n_iters=n_iters)
    return accum


def tonemap(accum: Vec3, iteration: int, resolution) -> torch.Tensor:
    """Running average -> (H,W,3) uint8 frame; sendImageToPBO semantics
    (src/pathtrace.cu:48-68): trunc(pix/iter*255) clamped to [0,255]."""
    resx, resy = resolution
    scale = float(np.float32(255.0) / np.float32(max(iteration, 1)))

    def chan(c):
        return torch.clamp((c * scale).to(torch.int32), 0, 255).to(torch.uint8)

    img = torch.stack([chan(accum.x), chan(accum.y), chan(accum.z)], dim=-1)
    return img.reshape(resy, resx, 3)


def resolve_device(device) -> torch.device:
    """The device a Renderer runs on. CUDA must be present when asked
    for: nothing drifts to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to render with the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


class Renderer:
    """Progressive renderer: owns the accumulator, iteration count
    and camera state. Camera changes reset the iteration to 0 and clear
    the accumulator (reset-on-camera-change, src/main.cpp:102-128)."""

    def __init__(self, scene: Scene, settings: RenderSettings | None = None,
                 *, device):
        self.device = resolve_device(device)
        self.scene = scene
        self.settings = settings or RenderSettings(
            trace_depth=scene.state.trace_depth or 8
        )
        if self.settings.trace_depth <= 0:
            self.settings = replace(self.settings, trace_depth=8)
        self.dev_scene = scene_to_device(scene, self.device)
        check_supported(self.dev_scene, self.settings)
        self.camera = scene.state.camera
        self.dev_camera = camera_to_device(self.camera, self.device)
        self.start_time_string = image_io.current_time_string()
        self._reset_buffers()

    # -- state management -------------------------------------------------
    def _reset_buffers(self):
        self.accum = Vec3.zeros(self.camera.pixel_count, self.device)
        self.iteration = 0

    def set_camera(self, camera):
        """Any camera change resets progressive state."""
        self.camera = camera
        self.dev_camera = camera_to_device(camera, self.device)
        self._reset_buffers()

    def orbit_camera(self, dphi=0.0, dtheta=0.0, dzoom=0.0, look_at=None):
        """Spherical-coordinate orbit controls (src/main.cpp:149-205):
        derive phi/theta/zoom from the current camera, apply deltas,
        rebuild the basis like runCuda (src/main.cpp:102-120)."""
        cam = self.camera
        la = np.asarray(look_at if look_at is not None else cam.look_at, np.float32)
        offset = cam.position - la
        zoom = float(np.linalg.norm(offset))
        view = (la - cam.position) / max(zoom, 1e-9)
        view_xz = np.array([view[0], 0.0, view[2]])
        view_zy = np.array([0.0, view[1], view[2]])
        nxz = np.linalg.norm(view_xz)
        nzy = np.linalg.norm(view_zy)
        phi = float(np.arccos(np.clip(np.dot(view_xz / max(nxz, 1e-9), [0, 0, -1]), -1, 1)))
        if view[0] > 0:
            phi = -phi
        theta = float(np.arccos(np.clip(np.dot(view_zy / max(nzy, 1e-9), [0, 1, 0]), -1, 1)))

        phi += dphi
        theta = float(np.clip(theta + dtheta, 0.001, np.pi - 0.001))
        zoom = max(0.1, zoom + dzoom)

        pos = zoom * np.array(
            [np.sin(phi) * np.sin(theta), np.cos(theta), np.cos(phi) * np.sin(theta)],
            np.float32,
        )
        self.set_camera(derive_camera(
            cam.resolution,
            pos + la,
            la,
            np.array([0, 1, 0], np.float32),
            float(cam.fov[1]),
            cam.aperture,
            cam.focal_distance,
        ))

    def pan_camera(self, dx: float = 0.0, dy: float = 0.0):
        """Pan the look-at point in the ground plane (the reference's
        MMB drag, src/main.cpp:191-202): the camera translates with its
        target, phi/theta/zoom unchanged."""
        cam = self.camera
        fwd = np.array([cam.view[0], 0.0, cam.view[2]], np.float32)
        rgt = np.array([cam.right[0], 0.0, cam.right[2]], np.float32)
        fwd /= max(float(np.linalg.norm(fwd)), 1e-9)
        rgt /= max(float(np.linalg.norm(rgt)), 1e-9)
        delta = (-dx * rgt + dy * fwd).astype(np.float32)
        self.set_camera(derive_camera(
            cam.resolution,
            cam.position + delta,
            cam.look_at + delta,
            np.array([0, 1, 0], np.float32),
            float(cam.fov[1]),
            cam.aperture,
            cam.focal_distance,
        ))

    # -- rendering ---------------------------------------------------------
    def step(self) -> int:
        """Render one sample per pixel (one `pathtrace()` call). It runs
        the whole-iteration kernel too: the per-bounce kernels arrive in
        port slice 2 (ROADMAP)."""
        return self.step_batch(1)

    def step_batch(self, n: int) -> int:
        """Render n samples per pixel; the accumulator stays on the device."""
        if n <= 0:
            return self.iteration
        render_batch(self.dev_scene, self.dev_camera, self.accum,
                     self.iteration + 1, n, self.settings)
        self.iteration += n
        return self.iteration

    # -- output -------------------------------------------------------------
    def image(self) -> np.ndarray:
        """(H,W,3) float radiance accumulator on host."""
        resx, resy = self.camera.resolution
        chans = [c.detach().cpu().numpy().reshape(resy, resx) for c in self.accum]
        return np.stack(chans, axis=-1)

    def frame_uint8(self) -> np.ndarray:
        """Tonemapped preview frame (H,W,3) uint8."""
        return tonemap(
            self.accum, self.iteration, self.camera.resolution
        ).cpu().numpy()

    def save(self, out_dir: str = ".", hdr: bool = False) -> str:
        return image_io.save_render(
            self.image(),
            self.iteration,
            self.scene.state.image_name,
            self.start_time_string,
            hdr=hdr,
            out_dir=out_dir,
        )

    # -- checkpoint/resume --------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        np.savez_compressed(
            path,
            accum=self.image(),
            iteration=self.iteration,
            resolution=np.array(self.camera.resolution),
        )
        return path

    def load_checkpoint(self, path: str):
        data = np.load(path)
        if tuple(data["resolution"]) != tuple(self.camera.resolution):
            raise ValueError("checkpoint resolution mismatch")
        img = np.asarray(data["accum"], np.float32)
        self.accum = Vec3(*(
            torch.tensor(img[..., c].reshape(-1), device=self.device)
            for c in range(3)
        ))
        self.iteration = int(data["iteration"])
