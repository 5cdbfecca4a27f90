"""Sharded rendering over a list of devices: the PyTorch counterpart of
the JAX package's `parallel/shard.py`.

Three axes, composed as a grid of spp x px x tri shards, as there:

- spp (sample batches): shard s of S traces iteration (call-1)*S + s + 1
  over its pixels; the S radiances of a pixel slice are summed in s order
  and then added to its accumulator (the JAX package's accum + psum);
- px (pixel tiles): shard p of N traces the pixels [p*P/N, (p+1)*P/N) and
  owns that slice of the accumulator; P % N must be 0;
- tri (triangle slices): every mesh geom's triangles split into T
  contiguous slices of ceil(count/T) (`tri_sharded_device_scenes`); the
  rays of an (s, p) group go to each of its T shards, whose hits are
  min-merged at every intersect (render.merge_isect_shards) before #4
  shades the merged pool (the tri-shard tier of render.trace_paths).

One process drives every shard over a list of torch devices, as the JAX
package's single controller drives its device mesh: shard (s, p, t) lives
on devices[(s*px + p)*tri + t]. There is no collective library. The pool
of an (s, p) group lives on the device of its shard t = 0; the rays go to
the other tri shards' devices and their hits come back; the spp
radiances go to the accumulator's device (that of shard (0, p, 0)). A
list may repeat a device, so that several shards share one card: the
tests and chip_smoke.py put them all on `cuda:0`, which runs the path of
every shard in turn (a check of the path, not a scale-out). With
`devices=None` the renderer puts one shard on each visible card, or, on
the CPU, every shard there.

The image is the sequential Renderer's at the same sample count: the RNG
keys on (iteration, pixel, depth), so neither a pixel's slice nor the
order of the spp shards changes its draws. The spp sum rounds otherwise
(rtol 1e-6); a px slice renders exactly what the whole frame renders
through the same route (on the CPU exactly the Renderer's image); tri
agrees by the lane rule (the merge settles exact ties between slices by
the lowest shard, the unsharded BVH walk by its own order).
"""

from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from ..models.device import DeviceScene, camera_to_device, scene_to_device
from ..models.scene import GeomType, TriangleSoup
from ..ops.vec import Vec3
from ..render import (
    RenderSettings,
    TriShard,
    _device_tables,
    _scatter_add,
    log_plain,
    resolve_device,
    trace_paths,
)
from ..utils import image as image_io

_SOUP_KEYS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")


def parse_shard_spec(spec: str):
    """Parse the CLI --shard value: any of spp=N / px=N / tri=N,
    comma-separated (e.g. "spp=4", "px=2,tri=2")."""
    spp, px, tri = 1, 1, 1
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad --shard component {part!r}; expected spp=N, px=N "
                f"or tri=N"
            )
        k, v = part.split("=", 1)
        k = k.strip()
        if k == "spp":
            spp = int(v)
        elif k == "px":
            px = int(v)
        elif k == "tri":
            tri = int(v)
        else:
            raise ValueError(f"unknown --shard axis {k!r} (spp/px/tri)")
    return spp, px, tri


def tri_slice_scenes(scene, n: int) -> list:
    """The n host Scenes of a --shard tri=n split, in the JAX package's
    slicing: each mesh geom's triangles (in file order) split into n
    contiguous slices of ceil(count/n); a short slice is padded with
    duplicates of a real triangle of the same geom (its own last, or the
    geom's last when it has none). A duplicate never changes the merged
    hit: it hits at exactly the t of its original, with the same normal
    and UVs, and the merge's ties go to the lowest shard. Analytic geoms,
    materials, textures and lights are in every slice."""
    soup = scene.triangles
    g = scene.geoms
    slices = []
    for d in range(n):
        parts = {k: [] for k in _SOUP_KEYS}
        new_start = np.zeros((g.count,), np.int32)
        new_count = np.zeros((g.count,), np.int32)
        cursor = 0
        for i in range(g.count):
            cnt = int(g.tri_count[i])
            if g.gtype[i] != int(GeomType.MESH) or cnt == 0:
                continue
            start = int(g.tri_start[i])
            per = -(-cnt // n)
            lo = start + d * per
            take = max(0, min(start + cnt, lo + per) - lo)
            src = max(start, min(lo + max(take, 1) - 1, start + cnt - 1))
            for k in _SOUP_KEYS:
                arr = getattr(soup, k)[lo:lo + take]
                pad = per - take
                if pad:
                    fill = np.repeat(getattr(soup, k)[src:src + 1], pad, axis=0)
                    arr = np.concatenate([arr, fill])
                parts[k].append(arr)
            new_start[i] = cursor
            new_count[i] = per
            cursor += per
        cat = {
            k: (np.concatenate(v) if v
                else np.zeros((0, 3 if k[0] in "vn" else 2), np.float32))
            for k, v in parts.items()
        }
        slices.append(replace(
            scene,
            triangles=TriangleSoup(**cat, has_uv=soup.has_uv),
            geoms=replace(g, tri_start=new_start, tri_count=new_count),
        ))
    return slices


def tri_sharded_device_scenes(scene, n: int, device_of) -> list:
    """The n DeviceScenes of a --shard tri=n split (`tri_slice_scenes`),
    slice t on `device_of(t)`. Each slice gets its own BVH, wide BVH and
    chunk and supernode tables from `scene_to_device`, over its own
    triangles; its big-mesh routing (`ops/pipeline.py::sorted_geoms`) sees
    the slice's count. Of the JAX package's slicing the duplicate padding
    is kept; its `use_bvh=False` and full-mesh object boxes, which exist
    to stack the slices into one SPMD pytree, are not."""
    return [scene_to_device(s, device_of(t))
            for t, s in enumerate(tri_slice_scenes(scene, n))]


def scene_to(scene: DeviceScene, device) -> DeviceScene:
    """`scene` on `device` (itself when it is there already)."""
    device = _canonical(device)
    if scene.device == device:
        return scene

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, Vec3):
            return Vec3(*(c.to(device) for c in v))
        return v

    return replace(scene, **{f.name: move(getattr(scene, f.name))
                             for f in fields(scene)})


def _canonical(device) -> torch.device:
    """A device with its index (cuda -> cuda:<current>), so that equal
    devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _pixel_slice(n_pixels: int, n_px: int, resolution) -> int:
    if n_pixels % n_px != 0:
        resx, resy = resolution
        raise ValueError(
            f"pixel count {n_pixels} ({resx}x{resy}) is not divisible by "
            f"the 'px' shard count {n_px}; choose a resolution or shard "
            f"count so every shard owns an equal pixel slice"
        )
    return n_pixels // n_px


def render_iteration_sharded(groups, cameras, accums, call: int,
                             settings: RenderSettings) -> list:
    """One sharded call (the JAX package's `render_iteration_sharded`),
    added into the accumulator slices in place.

    `groups[s][p]` is the tri group of shard (s, p): a tuple of TriShard,
    shard 0 on the pool's device (one shard without tri sharding);
    `cameras[s][p]` the camera on that device; `accums[p]` the Vec3 of px
    slice p, P/N lanes, on the device of shard (0, p, 0); `call` the
    1-based index of this call. Shard (s, p) traces iteration (call-1)*S +
    s + 1 over the pixels offset_p + arange(P/N) (`trace_paths` with
    `pix`; the whole frame, and so #2 on an analytic scene, when N = 1)
    with its tri group as `shards`, the first-bounce cache unused, as
    there. Under --sort-materials or --compact the radiance is scattered
    to pix_out - offset_p. The S radiances of a slice are summed in s
    order on its accumulator's device and then added to it. Returns
    `accums`."""
    S, N = len(groups), len(groups[0])
    resolution = cameras[0][0].resolution
    n_pixels = resolution[0] * resolution[1]
    local_n = _pixel_slice(n_pixels, N, resolution)
    tri = settings.tri_axis is not None
    scatter = settings.sort_by_material or settings.compact
    for p in range(N):
        acc = accums[p]
        offset = p * local_n
        total = None
        for s in range(S):
            shards = groups[s][p]
            scene, tables = shards[0]
            dev = scene.device
            pix = None
            if N > 1:
                pix = offset + torch.arange(local_n, dtype=torch.int32, device=dev)
            radiance, pix_out, _, _ = trace_paths(
                scene, cameras[s][p], (call - 1) * S + s + 1, None, settings,
                False, tables=tables, count_alive=False, pix=pix,
                shards=shards if tri else None,
            )
            if scatter:
                summed = Vec3.zeros(local_n, dev)
                _scatter_add(summed, pix_out - offset, radiance)
            else:
                summed = radiance
            summed = Vec3(*(c.to(acc.x.device) for c in summed))
            total = summed if total is None else total + summed
        for a, r in zip(acc, total):
            a.add_(r)
    return accums


class ShardedRenderer:
    """The Renderer surface (step_batch / iteration / image / save /
    checkpoints) over a grid of spp x px x tri shards (the JAX package's
    ShardedRenderer over its device mesh).

    Shard (s, p, t) lives on devices[(s*px + p)*tri + t]. `devices`: an
    explicit list (it may repeat a device: several shards on one card);
    None: with device "cuda" one shard on each visible card (too few is a
    ValueError), with "cpu" every shard on the CPU. CUDA is never swapped
    for the CPU: asking for it without a card raises, as the Renderer
    does. One `step_batch` call advances S samples a call."""

    def __init__(self, scene, settings: RenderSettings | None = None,
                 spp: int = 1, px: int = 1, tri: int = 1, *, device="cuda",
                 devices=None):
        if spp < 1 or px < 1 or tri < 1:
            raise ValueError("shard factors must be >= 1")
        need = spp * px * tri
        if devices is None:
            dev = _canonical(device)
            devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                    if dev.type == "cuda" else [dev] * need)
        else:
            devs = [_canonical(d) for d in devices]
        if need > len(devs):
            kind = devs[0].type if devs else torch.device(device).type
            raise ValueError(
                f"--shard spp={spp},px={px},tri={tri} needs {need} "
                f"devices; {len(devs)} available ({kind})"
            )
        settings = settings or RenderSettings(
            trace_depth=scene.state.trace_depth or 8)
        if settings.trace_depth <= 0:
            settings = replace(settings, trace_depth=8)
        if tri > 1:
            # the tri-shard tier: intersect every slice, merge, shade (#4)
            settings = replace(settings, tri_axis="tri")
        self.settings = settings
        self.spp, self.px, self.tri = spp, px, tri
        self.devices = devs[:need]
        self.device = self.devices[0]
        log_plain(settings, self.devices)
        self.scene = scene

        def dev_of(s, p, t):
            return self.devices[(s * px + p) * tri + t]

        if tri > 1:
            slices = tri_sharded_device_scenes(scene, tri, lambda t: dev_of(0, 0, t))
        else:
            slices = [scene_to_device(scene, self.device)]
        built = {}

        def shard_at(t, dev):
            # one DeviceScene and one set of tables for each slice and device
            if (t, dev) not in built:
                ds = scene_to(slices[t], dev)
                built[t, dev] = TriShard(ds, _device_tables(ds, settings))
            return built[t, dev]

        self.groups = [[tuple(shard_at(t, dev_of(s, p, t)) for t in range(tri))
                        for p in range(px)] for s in range(spp)]
        self.start_time_string = image_io.current_time_string()
        self.set_camera(scene.state.camera)

    def set_camera(self, camera):
        """Render from `camera` (its resolution's pixels must split into
        px equal slices); the accumulator and the sample count start over,
        as the Renderer's do on a camera change. The shards' scenes stay."""
        local_n = _pixel_slice(camera.pixel_count, self.px, camera.resolution)
        self.camera = camera
        cams = {}
        for s in range(self.spp):
            for p in range(self.px):
                dev = self.groups[s][p][0].scene.device
                if dev not in cams:
                    cams[dev] = camera_to_device(camera, dev)
        self.cameras = [[cams[self.groups[s][p][0].scene.device] for p in range(self.px)]
                        for s in range(self.spp)]
        self.accums = [Vec3.zeros(local_n, self.groups[0][p][0].scene.device)
                       for p in range(self.px)]
        self.calls = 0

    @property
    def iteration(self) -> int:
        """Total samples accumulated (the divide-by-samples count)."""
        return self.calls * self.spp

    def step_batch(self, n_samples: int) -> int:
        """Advance by >= n_samples (rounded up to whole spp batches)."""
        calls = max(1, -(-n_samples // self.spp))
        for _ in range(calls):
            self.calls += 1
            render_iteration_sharded(self.groups, self.cameras, self.accums,
                                     self.calls, self.settings)
        return self.iteration

    def synchronize(self) -> None:
        """Wait for the work queued on every card of the grid."""
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def image(self) -> np.ndarray:
        """(H,W,3) float radiance accumulator gathered to the host."""
        resx, resy = self.camera.resolution
        chans = [np.concatenate([a[c].detach().cpu().numpy() for a in self.accums])
                 for c in range(3)]
        return np.stack([c.reshape(resy, resx) for c in chans], axis=-1)

    def save_checkpoint(self, path: str) -> str:
        """The Renderer's .npz contract: sequential and sharded
        checkpoints resume in either renderer."""
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
        it = int(data["iteration"])
        if it % self.spp != 0:
            raise ValueError(
                f"checkpoint iteration {it} is not divisible by the "
                f"spp shard factor {self.spp}; resume with a matching "
                f"--shard spp or the sequential renderer"
            )
        img = np.asarray(data["accum"], np.float32)
        flat = [img[..., c].reshape(-1) for c in range(3)]
        n = flat[0].shape[0] // self.px
        self.accums = [
            Vec3(*(torch.tensor(f[p * n:(p + 1) * n], device=a.x.device) for f in flat))
            for p, a in enumerate(self.accums)
        ]
        self.calls = it // self.spp

    def save(self, out_dir: str = ".", hdr: bool = False) -> str:
        return image_io.save_render(
            self.image(),
            self.iteration,
            self.scene.state.image_name,
            self.start_time_string,
            hdr=hdr,
            out_dir=out_dir,
        )
