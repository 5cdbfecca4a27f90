"""Camera ray generation: pinhole + stratified AA jitter + thin-lens DoF.

The plain PyTorch twin of the JAX package's `ops/camera.py`, and of the
raygen at the top of the CUDA kernel (csrc/full_iteration.cu). Pinhole
direction math matches generateRayFromCamera (src/pathtrace.cu:122-143):
    dir = normalize(view - right*pixelLength.x*(x - resx*0.5)
                         - up*pixelLength.y*(y - resy*0.5))
with pixel index = x + y*resx. AA and DoF draw 4 uniforms per pixel on
RNG stream RAYGEN_STREAM, keyed (iteration, pixelIndex).
"""

from __future__ import annotations

import math

import torch

from ..models.device import DeviceCamera
from . import rng
from .vec import Vec3


def concentric_disk(u1: torch.Tensor, u2: torch.Tensor):
    """Low-distortion unit-disk sampling (PBRT 6.2.3 style) for the lens."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    x_major = ox.abs() > oy.abs()
    r = torch.where(x_major, ox.abs(), oy.abs())
    theta = torch.where(
        x_major,
        (math.pi / 4.0) * (oy / torch.where(ox == 0, 1.0, ox)),
        (math.pi / 2.0) - (math.pi / 4.0) * (ox / torch.where(oy == 0, 1.0, oy)),
    )
    degenerate = (ox == 0) & (oy == 0)
    x = torch.where(degenerate, 0.0, r * torch.cos(theta))
    y = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return x, y


def generate_rays(
    cam: DeviceCamera,
    iteration: int,
    antialias: bool,
    depth_of_field: bool,
    pix: torch.Tensor | None = None,
):
    """Primary rays for the given global pixel ids `pix` ((P,) int32 on
    the camera's device), by default every pixel of the frame, slot i ==
    pixel i; a sharded caller passes its slice of the frame. The draws are
    keyed on (iteration, pixel index), so a pixel gets the same ray in any
    slice.

    `iteration` is 1-based, as in the render loop. Returns
    (origins Vec3, dirs Vec3, pixel_index (P,) int32) on the camera's
    device."""
    resx, resy = cam.resolution
    device = cam.position.device
    if pix is None:
        pix = torch.arange(resx * resy, dtype=torch.int32, device=device)
    x = (pix % resx).to(torch.float32)
    y = torch.div(pix, resx, rounding_mode="floor").to(torch.float32)

    u = None
    if antialias or depth_of_field:
        u = rng.uniforms(iteration, pix, rng.RAYGEN_STREAM, 4)

    if antialias:
        # stratified sub-pixel jitter: iteration k lands in stratum
        # (k-1) mod 16 of a 4x4 grid
        K = 4
        s = (int(iteration) - 1) % (K * K)
        x = x + (float(s % K) + u[0]) * (1.0 / K) - 0.5
        y = y + (float(s // K) + u[1]) * (1.0 / K) - 0.5

    sx = cam.pixel_length[0] * (x - resx * 0.5)
    sy = cam.pixel_length[1] * (y - resy * 0.5)
    view = Vec3(cam.view[0], cam.view[1], cam.view[2])
    right = Vec3(cam.right[0], cam.right[1], cam.right[2])
    up = Vec3(cam.up[0], cam.up[1], cam.up[2])
    dirs = (view - right * sx - up * sy).normalize()
    origins = Vec3.broadcast(cam.position, pix.shape[0])

    if depth_of_field:
        # thin lens: sample the aperture disk, keep the focal-plane point
        lens_x, lens_y = concentric_disk(u[2], u[3])
        lens_offset = right * (cam.aperture * lens_x) + up * (
            cam.aperture * lens_y
        )
        ft = cam.focal_distance / torch.clamp(dirs.dot(view), min=1e-6)
        focus_point = origins + dirs * ft
        origins = origins + lens_offset
        dirs = (focus_point - origins).normalize()

    return origins, dirs, pix
