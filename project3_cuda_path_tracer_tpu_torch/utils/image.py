"""Image output: PNG + Radiance HDR with the reference's save contract,
and a PNG reader for the scene's textures.

A copy of the JAX package's `utils/image.py`. Contract (per the CUDA
reference's src/main.cpp:78-99 and src/image.cpp:22-45):
- accumulator is divided by the sample count,
- the x axis is FLIPPED (img.setPixel(width-1-x, y)),
- values clamped to [0,1] then scaled to 8-bit for PNG,
- filename = "{name}.{start-time}.{N}samp.png" where start-time is the
  process start timestamp (src/preview.cpp:13-19 strftime "%Y-%m-%d_%H-%M-%Sz",
  gmtime).

`read_png` decodes the textures and env maps with zlib and numpy alone,
so that loading a scene needs no imaging package.
"""

from __future__ import annotations

import struct
import time
import zlib
from typing import Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes per pixel at 8 bits: L, RGB, palette, LA, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth).
    Each byte depends on the byte of the pixel to its left, above it and
    above-left, so the pixels of one anti-diagonal (x + y constant) are
    independent: they are reconstructed together, h + w - 1 steps."""
    rows = raw.reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not one of 0-4")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column before
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]  # left
        b = out[y, x + 1]  # above
        c = out[y, x]  # above-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma in 8 bits with Pillow's fixed-point rounding (its
    "L" conversion)."""
    v = rgb[..., :3].astype(np.uint32)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def read_png(path: str, mode: str = "RGB") -> np.ndarray:
    """An 8-bit, non-interlaced PNG (greyscale, RGB, palette, greyscale +
    alpha or RGBA) as a uint8 array: (H, W, 3) for mode "RGB", (H, W) for
    mode "L", converted as Pillow's `convert(mode)` converts (alpha
    dropped, palette looked up, RGB to luma). Raises ValueError for any
    other PNG."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode {mode!r}: use 'RGB' or 'L'")
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: only 8-bit non-interlaced L, RGB, palette, LA and "
            "RGBA PNGs are read"
        )
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}")
    px = _png_unfilter(raw, h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        rgb = palette[px[..., 0]]
    elif ctype in (0, 4):
        grey = px[..., 0]
        return grey if mode == "L" else np.repeat(grey[..., None], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return _luma(rgb) if mode == "L" else np.ascontiguousarray(rgb)


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
