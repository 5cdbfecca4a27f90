"""The render core: settings, the shading step, the per-bounce path and
the renderer.

The PyTorch counterpart of the JAX package's `render.py`. The CUDA
reference's shape
    generateRayFromCamera -> while(depth) { computeIntersections; shade }
    -> finalGather -> tonemap
has two tiers here, as in the JAX package:
- the whole-iteration kernel (ops/megakernel.py::full_iteration, #1),
  which `render_batch` runs whenever no per-bounce feature is on;
- the per-bounce wavefront path, `trace_paths`: first_bounce (#2) or, on
  a first-bounce cache, shade_step (#4) over the cached depth-0
  intersections, then bounce_step (#3) for depths 1..D-1, with stream
  compaction between bounces and the motion-blur shutter time. It runs
  under `Renderer.step()` always and under `render_batch` with
  --compact, --cache-first-bounce or --motion-blur.
Between the kernels runs only the glue the JAX package runs in XLA: the
compaction permutation, the alive sums, the radiance scatter
(`index_add_`), and the per-iteration re-pack of the moved transforms.

Every wrapper launches its hand-written kernel on CUDA tensors and runs
its plain PyTorch version on CPU tensors, so the same functions render
on both devices. What the port does not render yet is refused on every
device by megakernel.check_supported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .models.device import (
    DeviceCamera,
    DeviceScene,
    advance_time,
    camera_to_device,
    scene_to_device,
)
from .models.scene import Scene, derive_camera
from .ops import rng
from .ops.bsdf import scatter
from .ops.camera import generate_rays
from .ops.intersect import Intersections
from .ops.megakernel import (
    SceneTables,
    bounce_step,
    check_supported,
    draw_slots,
    first_bounce,
    full_iteration,
    pack_geom_tables,
    pack_scene_tables,
    shade_step,
)
from .ops.sweep import intersect_scene
from .ops.texture import apply_textures
from .ops.vec import Vec3, take as vtake, where as vwhere
from .utils import image as image_io


@dataclass(frozen=True)
class RenderSettings:
    """Runtime toggles; the same fields and defaults as the JAX
    package's RenderSettings. Fields of later slices are kept so that a
    setting the port does not render yet is refused by name
    (megakernel.check_supported). `use_bvh` and `use_pallas` select
    nothing here: analytic scenes have no BVH, and the device alone
    decides the path (the kernels on CUDA, their plain versions on the
    CPU)."""

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

    def effective_cache(self) -> bool:
        # AA and DoF jitter the camera rays, which invalidates a
        # first-bounce cache
        return self.cache_first_bounce and not (
            self.antialias or self.depth_of_field
        )


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
    if (settings.stratified or settings.sobol) and depth == 0:
        # padded QMC: the depth-0 hemisphere pair comes from the R2
        # lattice (or the Owen-scrambled Sobol sequence); deeper bounces
        # keep their independent draws (ops/rng.py)
        pair = rng.sobol_pair if settings.sobol else rng.stratified_pair
        u = pair(iteration, pix, 0) + u[2:]

    mats = _gather_materials(scene, isect.material_id)
    if scene.any_textured:
        p_hit = origins + dirs * (isect.t - 1e-4)
        mats = (apply_textures(scene, p_hit, isect.material_id, mats[0]),) + mats[1:]
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


def _permute_state(state, perm: torch.Tensor):
    origins, dirs, throughput, radiance, alive, pix = state
    return (
        vtake(origins, perm),
        vtake(dirs, perm),
        vtake(throughput, perm),
        vtake(radiance, perm),
        alive[perm],
        pix[perm],
    )


def _maybe_compact(state, settings: RenderSettings):
    """Stream compaction: live lanes packed to the front (stable), so
    bounce_step can skip every lane at or past the live count - the
    static-shape analog of thrust::partition (src/pathtrace.cu:313-317).

    The exclusive-scan permutation of the JAX package: live lane i goes
    to cumsum(alive)[i]-1, dead lane i to n_alive + cumsum(dead)[i]-1;
    one scatter of an iota inverts it into the gather permutation. All
    on the device, no host sync."""
    if not settings.compact:
        return state
    alive = state[4].to(torch.int64)
    P = alive.shape[0]
    n_alive = alive.sum()
    front = torch.cumsum(alive, 0) - 1
    back = n_alive + torch.cumsum(1 - alive, 0) - 1
    dest = torch.where(alive != 0, front, back)
    perm = torch.empty_like(dest).scatter_(
        0, dest, torch.arange(P, dtype=torch.int64, device=alive.device)
    )
    return _permute_state(state, perm)


def _count_alive(state) -> torch.Tensor:
    """The live lanes of a pool, as an int32 scalar tensor on its device."""
    return torch.sum(state[4], dtype=torch.int32)


def _empty_cache(pixel_count: int, device) -> Intersections:
    return Intersections(
        t=torch.zeros(pixel_count, dtype=torch.float32, device=device),
        normal=Vec3.zeros(pixel_count, device),
        material_id=torch.zeros(pixel_count, dtype=torch.int32, device=device),
        outside=torch.zeros(pixel_count, dtype=torch.bool, device=device),
    )


def shutter_time(iteration: int) -> float:
    """The motion-blur shutter sample of an iteration: the first draw of
    stream TIME_STREAM at index 0. Computed on the host (the integer RNG
    and one float multiply give the same bits on every device)."""
    u = rng.uniforms(iteration, torch.zeros(1, dtype=torch.int32),
                     rng.TIME_STREAM, 1)
    return float(u[0][0])


def _device_tables(scene: DeviceScene) -> SceneTables | None:
    """The kernels' packed tables on CUDA; None on the CPU (the plain
    versions read the DeviceScene itself)."""
    return pack_scene_tables(scene) if scene.device.type == "cuda" else None


def trace_paths(
    scene: DeviceScene,
    cam: DeviceCamera,
    iteration: int,
    cache: Intersections | None,
    settings: RenderSettings,
    use_cache: bool,
    tables: SceneTables | None = None,
    count_alive: bool = True,
):
    """One full sample per pixel through the per-bounce path: first_bounce
    (#2), or shade_step (#4) over the depth-0 intersections under the
    first-bounce cache, then bounce_step (#3) for depths 1..D-1, with
    compaction between bounces.

    `iteration` is 1-based. `cache` holds the depth-0 Intersections in
    pixel order and is read only when `use_cache`. `tables` are the
    kernels' packed tables (packed here when None; with motion blur only
    their transforms are re-packed). Returns (radiance Vec3, pix (P,),
    depth-0 Intersections, alive_counts (D,) int32 on the device, or
    None when neither `count_alive` nor compaction needs them). pix
    tracks the pool permutation of compaction."""
    if settings.motion_blur:
        # one shutter-time sample per iteration: move the geoms, re-pack
        # only the two (G,16) tables that change
        scene = advance_time(scene, shutter_time(iteration))
        if tables is not None:
            xf, inv = pack_geom_tables(scene)
            tables = tables._replace(xf=xf, inv=inv)
    if tables is None:
        tables = _device_tables(scene)
    device = scene.device

    if settings.effective_cache():
        # depth 0 from the cached (or freshly computed) intersections of
        # the pinhole camera rays; the cache is pixel-ordered
        origins, dirs, pix = generate_rays(
            cam, iteration, settings.antialias, settings.depth_of_field
        )
        P = pix.shape[0]
        state = (
            Vec3(*(c.contiguous() for c in origins)), dirs,
            Vec3.ones(P, device), Vec3.zeros(P, device),
            torch.ones(P, dtype=torch.int32, device=device), pix,
        )
        isect0 = cache if use_cache else intersect_scene(origins, dirs, scene)
        cache_out = isect0
        state = shade_step(state, isect0, scene, iteration, 0, settings,
                           tables=tables)
    else:
        state = first_bounce(scene, cam, iteration, settings, tables=tables)
        cache_out = _empty_cache(state[5].shape[0], device)
    state = _maybe_compact(state, settings)
    counts = None
    if count_alive or settings.compact:
        counts = [_count_alive(state)]

    # depths 1..D-1: the wavefront bounce loop (src/pathtrace.cu:340-377)
    for depth in range(1, settings.trace_depth):
        state = bounce_step(
            state, scene, iteration, depth, settings,
            num_alive=counts[-1] if settings.compact else None,
            tables=tables,
        )
        state = _maybe_compact(state, settings)
        if counts is not None:
            counts.append(_count_alive(state))

    alive_counts = torch.stack(counts) if counts is not None else None
    return state[3], state[5], cache_out, alive_counts


def _scatter_add(accum: Vec3, pix: torch.Tensor, radiance: Vec3) -> None:
    """finalGather through a permuted pool: accum[pix] += radiance, in
    place. pix is a permutation, so each slot receives one add and the
    result is deterministic."""
    index = pix.to(torch.int64)
    for a, r in zip(accum, radiance):
        a.index_add_(0, index, r)


def render_iteration(
    scene: DeviceScene,
    cam: DeviceCamera,
    accum: Vec3,
    iteration: int,
    cache: Intersections | None,
    settings: RenderSettings,
    use_cache: bool,
    tables: SceneTables | None = None,
    count_alive: bool = True,
):
    """One full sample per pixel through the per-bounce path, added into
    accum in place (finalGather, src/pathtrace.cu:269-278). Returns
    (accum, depth-0 Intersections, alive_counts)."""
    radiance, pix, cache_out, alive_counts = trace_paths(
        scene, cam, iteration, cache, settings, use_cache, tables=tables,
        count_alive=count_alive,
    )
    if settings.compact:
        _scatter_add(accum, pix, radiance)
    else:
        for a, r in zip(accum, radiance):  # pool slot == pixel
            a.add_(r)
    return accum, cache_out, alive_counts


def whole_kernel(settings: RenderSettings) -> bool:
    """Whether render_batch runs the whole-iteration kernel: the JAX
    package's kernel_plan.whole_kernel for what the port renders, without
    its geoms x materials limit (a TPU compile-time trade-off)."""
    return not (
        settings.compact
        or settings.effective_cache()
        or settings.motion_blur
    )


def render_batch(scene: DeviceScene, cam: DeviceCamera, accum: Vec3,
                 iteration0: int, n_iters: int,
                 settings: RenderSettings,
                 tables: SceneTables | None = None) -> Vec3:
    """n_iters full samples added into accum (in place), starting at the
    1-based iteration id `iteration0`: the whole-iteration kernel when
    `whole_kernel(settings)`, else the per-bounce path, with the
    first-bounce cache computed once per batch from iteration0's pinhole
    rays. CPU tensors take the plain versions throughout."""
    if whole_kernel(settings):
        full_iteration(scene, cam, iteration0, settings, accum,
                       n_iters=n_iters, tables=tables)
        return accum
    if tables is None:
        tables = _device_tables(scene)
    use_cache = settings.effective_cache()
    cache = None
    if use_cache:
        origins, dirs, _ = generate_rays(cam, iteration0, False, False)
        cache = intersect_scene(origins, dirs, scene)
    for k in range(n_iters):
        render_iteration(scene, cam, accum, iteration0 + k, cache, settings,
                         use_cache, tables=tables, count_alive=False)
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
    """Progressive renderer: owns the accumulator, iteration count,
    camera state and first-bounce cache. Camera changes reset the
    iteration to 0 and clear the accumulator and the cache
    (reset-on-camera-change, src/main.cpp:102-128).

    Runs on the card unless `device="cpu"` is asked for."""

    def __init__(self, scene: Scene, settings: RenderSettings | None = None,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.settings = settings or RenderSettings(
            trace_depth=scene.state.trace_depth or 8
        )
        if self.settings.trace_depth <= 0:
            self.settings = replace(self.settings, trace_depth=8)
        self.dev_scene = scene_to_device(scene, self.device)
        check_supported(self.dev_scene, self.settings)
        self.tables = _device_tables(self.dev_scene)
        self.camera = scene.state.camera
        self.dev_camera = camera_to_device(self.camera, self.device)
        self.start_time_string = image_io.current_time_string()
        self._reset_buffers()

    # -- state management -------------------------------------------------
    def _reset_buffers(self):
        P = self.camera.pixel_count
        self.accum = Vec3.zeros(P, self.device)
        self.cache = _empty_cache(P, self.device)
        self.cache_valid = False
        self.iteration = 0
        self.last_alive_counts = None

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
        """Render one sample per pixel (one `pathtrace()` call) through
        the per-bounce path; fills `last_alive_counts` (live paths after
        each depth, on the device) and, on the first step with an
        effective first-bounce cache, the cache."""
        self.iteration += 1
        # trust the cache only once a step has filled it: after
        # load_checkpoint (or a reset) it is zeros, and zeros read as
        # "every ray missed"
        use_cache = self.settings.effective_cache() and self.cache_valid
        _, cache_out, alive = render_iteration(
            self.dev_scene, self.dev_camera, self.accum, self.iteration,
            self.cache, self.settings, use_cache, tables=self.tables,
        )
        if self.settings.effective_cache() and not self.cache_valid:
            self.cache = cache_out
            self.cache_valid = True
        self.last_alive_counts = alive
        return self.iteration

    def step_batch(self, n: int) -> int:
        """Render n samples per pixel (see render_batch); the accumulator
        stays on the device."""
        if n <= 0:
            return self.iteration
        render_batch(self.dev_scene, self.dev_camera, self.accum,
                     self.iteration + 1, n, self.settings, tables=self.tables)
        self.iteration += n
        return self.iteration

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, iterations: int | None = None, progress_every: int = 0):
        """Step until `iterations` (the scene's ITERATIONS by default),
        yielding the iteration count every `progress_every` steps."""
        target = iterations if iterations is not None else self.scene.state.iterations
        while self.iteration < target:
            self.step()
            if progress_every and self.iteration % progress_every == 0:
                self._sync()
                yield self.iteration
        self._sync()

    def render(self, iterations: int | None = None) -> np.ndarray:
        for _ in self.run(iterations):
            pass
        return self.image()

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
        # the checkpoint holds no depth-0 intersections: the next step()
        # recomputes and re-validates the cache
        self.cache = _empty_cache(self.camera.pixel_count, self.device)
        self.cache_valid = False
