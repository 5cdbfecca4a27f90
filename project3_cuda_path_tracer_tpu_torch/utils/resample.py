"""Bilinear resampling of 8-bit images, bit for bit Pillow's.

The JAX package resizes textures and env maps with Pillow's
`Image.resize(size, Image.BILINEAR)`. This is that resampler in numpy
(Pillow's libImaging/Resample.c for 8 bits per channel), so the port
loads any size without Pillow:

- per axis, the coefficients of a triangle filter of support 1 scaled by
  the downscale factor (at least 1), computed and normalised in float64,
  summed in the C loop's order;
- the coefficients to fixed point with PRECISION_BITS fraction bits,
  rounded half away from zero as `normalize_coeffs_8bpc` does;
- a horizontal pass, clipped to uint8, then a vertical pass over its
  result, each output the rounded integer sum of its taps. A pass whose
  size does not change is skipped, as Pillow skips it.

After the coefficients everything is integer arithmetic, so the result is
Pillow's exactly, in RGB (each channel alone) and in L.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for BILINEAR
    over the whole input: each output's first input index (out,) and its
    fixed-point weights (out, ksize), zero past the taps it has."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    # (int) truncates toward zero, then the bounds are clamped
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize, dtype=np.int64)
    arg = (((x[None, :] + xmin[:, None]).astype(np.float64) - center[:, None]) + 0.5) * ss
    arg = np.abs(arg)
    w = np.where(arg < 1.0, 1.0 - arg, 0.0)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size, np.float64)
    for k in range(ksize):  # the C loop's order of the sum
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, kk.astype(np.int64)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.where(acc >= (1 << PRECISION_BITS << 8), 255,
                    np.where(acc <= 0, 0, acc >> PRECISION_BITS)).astype(np.uint8)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's resampler along `axis` of a 2-D plane."""
    in_size = img.shape[axis]
    xmin, kk = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    taps = np.take(img.astype(np.int64), idx, axis=axis)  # (.., out, ksize, ..)
    if axis == 0:
        acc = (taps * kk[:, :, None]).sum(axis=1)
    else:
        acc = (taps * kk[None, :, :]).sum(axis=2)
    return _clip8(acc + (1 << (PRECISION_BITS - 1)))


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """An (H, W) or (H, W, C) uint8 image resized to (height, width) as
    Pillow's `Image.resize((width, height), Image.BILINEAR)` resizes an L
    or RGB image: bit for bit."""
    img = np.asarray(img, np.uint8)
    if img.ndim not in (2, 3):
        raise ValueError(f"resize_bilinear takes (H, W) or (H, W, C), got {img.shape}")
    if width <= 0 or height <= 0:
        raise ValueError(f"resize_bilinear: size {width}x{height}")
    if img.shape[:2] == (height, width):
        return img.copy()
    planes = [img] if img.ndim == 2 else [img[..., c] for c in range(img.shape[2])]
    out = []
    for p in planes:
        if p.shape[1] != width:
            p = _pass(p, width, 1)
        if p.shape[0] != height:
            p = _pass(p, height, 0)
        out.append(p)
    return out[0] if img.ndim == 2 else np.stack(out, axis=-1)
