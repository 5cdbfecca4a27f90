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
so that loading a scene needs no imaging package; `read_hdr` decodes a
Radiance `.hdr` env map the same way. `save_png` and `save_hdr` write the
renders with zlib, struct and numpy: no Pillow, no imageio.
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


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def save_png(path: str, data_u8: np.ndarray) -> str:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG, every row with filter
    0 (None), the rows deflated by zlib."""
    if not path.endswith(".png"):
        path = path + ".png"
    img = np.ascontiguousarray(data_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png takes (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row: filter byte 0
    rows[:, 1:] = img.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))
    return path


# a new-style run-length scanline: 2, 2, then the width in 15 bits
_RLE_MIN_W, _RLE_MAX_W = 8, 0x7FFF


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float radiance -> (..., 4) uint8 RGBE by Radiance's
    `float2rgbe` (as OpenCV's rgbe.cpp has it): v = the largest component;
    below 1e-32 all four bytes 0; else (m, e) = frexp(v), the scale
    m * 256 / v in double rounded to float, each component times it
    truncated to a byte, and e + 128."""
    rgb = np.asarray(rgb, np.float32)
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)
    small = ~(v >= 1e-32)  # NaN too
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (m.astype(np.float64) * 256.0 / v.astype(np.float64)).astype(np.float32)
    scale[small] = 0.0
    # float -> int truncation, then the low byte (the C cast to unsigned char)
    out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = ((rgb * scale[..., None]).astype(np.int64) & 0xFF).astype(np.uint8)
    out[..., 3] = ((e + 128) & 0xFF).astype(np.uint8)
    out[small] = 0
    return out


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32: each byte times
    2**(e - 136), zero where e is 0 (OpenCV's rgbe2float, exact in
    float32)."""
    rgbe = np.asarray(rgbe, np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f[..., None]
    out[e == 0] = 0.0
    return out


def save_hdr(path: str, data_f32: np.ndarray) -> str:
    """Radiance .hdr writer (saveHDR analog, src/image.cpp:41-45): an
    (H, W, 3) float image as 32-bit_rle_rgbe, `-Y H +X W` (rows top to
    bottom), the pixels by `float_to_rgbe`. Scanlines of 8 to 32767 pixels
    are new-style run-length lines of literal dumps of at most 128 bytes
    per channel; other widths are flat."""
    if not path.endswith(".hdr"):
        path = path + ".hdr"
    img = np.asarray(data_f32, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_hdr takes (H, W, 3) floats, got {img.shape}")
    h, w, _ = img.shape
    rgbe = float_to_rgbe(img)
    if _RLE_MIN_W <= w <= _RLE_MAX_W:
        # per row: 2, 2, w >> 8, w & 255, then per channel the row's bytes
        # in dumps of up to 128, each after its length
        starts = np.arange(0, w, 128)
        lens = np.minimum(128, w - starts)
        planes = rgbe.transpose(0, 2, 1)  # (h, 4, w)
        body = np.insert(planes, starts, lens.astype(np.uint8), axis=2)
        head = np.broadcast_to(np.array([2, 2, w >> 8, w & 0xFF], np.uint8), (h, 4))
        data = np.concatenate([head, body.reshape(h, -1)], axis=1).tobytes()
    else:
        data = rgbe.tobytes()
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(data)
    return path


def _hdr_scanline(data: bytes, pos: int, w: int, path: str):
    """One scanline of w RGBE pixels at `pos`: new-style run-length when it
    starts 2, 2 with its width (8 <= w <= 32767), else flat. Returns
    ((w, 4) uint8, the position after it)."""
    if (_RLE_MIN_W <= w <= _RLE_MAX_W and pos + 4 <= len(data)
            and data[pos] == 2 and data[pos + 1] == 2 and not data[pos + 2] & 0x80):
        if (data[pos + 2] << 8 | data[pos + 3]) != w:
            raise ValueError(f"{path}: a run-length scanline of the wrong width")
        pos += 4
        line = np.empty((4, w), np.uint8)
        for c in range(4):
            x = 0
            while x < w:
                if pos >= len(data):
                    raise ValueError(f"{path}: truncated scanline")
                n = data[pos]
                if n > 128:  # a run: n - 128 copies of the next byte
                    n -= 128
                    if x + n > w or pos + 1 >= len(data):
                        raise ValueError(f"{path}: bad run-length data")
                    line[c, x:x + n] = data[pos + 1]
                    pos += 2
                else:  # a dump of n literal bytes
                    if n == 0 or x + n > w or pos + 1 + n > len(data):
                        raise ValueError(f"{path}: bad run-length data")
                    line[c, x:x + n] = np.frombuffer(data, np.uint8, n, pos + 1)
                    pos += 1 + n
                x += n
        return line.T, pos
    if pos + 4 * w > len(data):
        raise ValueError(f"{path}: truncated pixel data")
    return np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4), pos + 4 * w


def read_hdr(path: str) -> np.ndarray:
    """A Radiance .hdr (32-bit_rle_rgbe, flat or new-style run-length
    scanlines) as (H, W, 3) float32 radiance by `rgbe_to_float`, row 0 at
    the top, column 0 at the left, under each of the row-major
    resolution strings (`-Y H +X W` the usual one, `+Y` bottom-up rows,
    `-X` right-to-left columns). Keeps the file's range (no exposure
    applied). Raises ValueError for anything else (XYZE, column-major
    scanlines, old-style run lengths)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance file")
    pos = 0
    while True:  # the header: lines up to an empty one
        end = data.find(b"\n", pos)
        if end < 0:
            raise ValueError(f"{path}: no end of header")
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"{path}: {line.decode(errors='replace')}: only "
                             "32-bit_rle_rgbe is read")
    end = data.find(b"\n", pos)
    fields = data[pos:end if end >= 0 else len(data)].split()
    pos = end + 1
    if (len(fields) != 4 or (fields[0][1:], fields[2][1:]) != (b"Y", b"X")
            or any(f[:1] not in (b"-", b"+") for f in fields[::2])):
        raise ValueError(f"{path}: resolution string {b' '.join(fields)!r}: only "
                         "row-major ones (-Y/+Y H -X/+X W) are read")
    n_lines, n_per = int(fields[1]), int(fields[3])
    lines = []
    for _ in range(n_lines):
        line, pos = _hdr_scanline(data, pos, n_per, path)
        lines.append(line)
    img = rgbe_to_float(np.stack(lines)) if lines else np.zeros((0, n_per, 3), np.float32)
    if fields[0][:1] == b"+":  # rows stored bottom-up
        img = img[::-1]
    if fields[2][:1] == b"-":  # columns stored right to left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


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
