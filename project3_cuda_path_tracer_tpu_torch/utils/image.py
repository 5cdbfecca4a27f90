"""Image output: PNG + Radiance HDR with the reference's save contract.

A copy of the JAX package's `utils/image.py`. Contract (per the CUDA
reference's src/main.cpp:78-99 and src/image.cpp:22-45):
- accumulator is divided by the sample count,
- the x axis is FLIPPED (img.setPixel(width-1-x, y)),
- values clamped to [0,1] then scaled to 8-bit for PNG,
- filename = "{name}.{start-time}.{N}samp.png" where start-time is the
  process start timestamp (src/preview.cpp:13-19 strftime "%Y-%m-%d_%H-%M-%Sz",
  gmtime).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def current_time_string(t: Optional[float] = None) -> str:
    """UTC timestamp fmt matching src/preview.cpp:13-19."""
    return time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime(t))


def tonemap_to_uint8(accum: np.ndarray, samples: float) -> np.ndarray:
    """(H,W,3) float accumulator -> (H,W,3) uint8, pix/iter*255 clamped.

    Matches sendImageToPBO (src/pathtrace.cu:48-68): truncation toward zero
    after scaling, clamp to [0,255].
    """
    scaled = accum / max(float(samples), 1.0) * 255.0
    return np.clip(scaled.astype(np.int32), 0, 255).astype(np.uint8)


def apply_save_transform(accum: np.ndarray, samples: float) -> np.ndarray:
    """Divide-by-samples + x-flip per src/main.cpp:83-89. accum is (H,W,3)."""
    img = accum / max(float(samples), 1.0)
    return img[:, ::-1, :]


def save_png(path: str, data_u8: np.ndarray) -> str:
    from PIL import Image

    if not path.endswith(".png"):
        path = path + ".png"
    Image.fromarray(data_u8, mode="RGB").save(path)
    return path


def save_hdr(path: str, data_f32: np.ndarray) -> str:
    """Radiance .hdr writer (saveHDR analog, src/image.cpp:41-45)."""
    import imageio.v3 as iio

    if not path.endswith(".hdr"):
        path = path + ".hdr"
    iio.imwrite(path, data_f32.astype(np.float32))
    return path


def save_render(
    accum: np.ndarray,
    samples: int,
    image_name: str,
    start_time_string: Optional[str] = None,
    hdr: bool = False,
    out_dir: str = ".",
) -> str:
    """Full save pipeline with the reference's filename convention."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    ts = start_time_string or current_time_string()
    base = os.path.join(out_dir, f"{image_name}.{ts}.{samples}samp")
    img = apply_save_transform(accum, samples)
    if hdr:
        return save_hdr(base, img)
    data_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return save_png(base, data_u8)
