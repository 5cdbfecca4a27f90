"""Counter-based per-path RNG, bit-exact with the JAX package's `ops/rng.py`.

The CUDA reference seeds a thrust::default_random_engine (minstd LCG,
multiplier 48271 modulo 2^31-1) per (iter, path index, depth) with
    h = utilhash((1 << 31) | (depth << 22) | iter) ^ utilhash(index)
(src/pathtrace.cu:41-45) and draws U(0,1) floats from it. The stream is
keyed on the path's *pixelIndex*, not its pool slot, so permutations of
the pool leave the noise pattern unchanged.

PyTorch has no uint32 arithmetic on every device, so the uint32 math
runs in int64 with a `& 0xFFFFFFFF` after every `+`, `<<` and `*`
(`>>` of a non-negative int64 needs none). A product of two full 32-bit
words would pass 2^63, so `_mul_u32` splits the constant into 16-bit
halves and never leaves the int64 range. The results equal the JAX
package's uint32 results bit for bit (tests/test_torch_rng.py). The CUDA
kernels (csrc/path_common.cuh) compute the same in native uint32.

`stratified_pair` (rotated R2 lattice) and `sobol_pair` (Owen-scrambled
Sobol) replace the hemisphere pair at depth 0 only ("padded QMC"; see the
JAX package's `ops/rng.py` for why deeper bounces keep the LCG draws).
"""

from __future__ import annotations

import numpy as np
import torch

_LCG_M = 2147483647  # 2^31 - 1
_LCG_A = 48271
_U32 = 0xFFFFFFFF
# float32(1/(m-1)) as a Python float: exact in float32, so the product
# rounds as the JAX package's float32 multiply does
_INV_M1 = float(np.float32(1.0 / (_LCG_M - 1)))

# Depth slots that seed the camera-jitter draws (AA/DoF), the final-bounce
# light sample of --direct-lighting and the motion-blur shutter time,
# distinct from every bounce depth; the per-bounce NEE light sample of
# depth d draws from stream NEE_DEPTH_BASE + d.
RAYGEN_STREAM = 255
NEE_STREAM = 254
TIME_STREAM = 253
NEE_DEPTH_BASE = 128

# R2 lattice increments: round(2^32 / p) and round(2^32 / p^2), p the
# plastic constant
_R2_A1 = 3242174889
_R2_A2 = 2447445414


def _u32(a) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 bit pattern."""
    return a.to(torch.int64) & _U32


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c < 2^32,
    without passing 2^63: c is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def utilhash(a: torch.Tensor) -> torch.Tensor:
    """uint32 hash of src/intersections.h:12-20; int64 in, int64 out."""
    a = _u32(a)
    a = ((a + 0x7ED55D16) + (a << 12)) & _U32
    a = (a ^ 0xC761C23C) ^ (a >> 19)
    a = ((a + 0x165667B1) + (a << 5)) & _U32
    a = ((a + 0xD3A2646C) & _U32) ^ ((a << 9) & _U32)
    a = ((a + 0xFD7046C5) + (a << 3)) & _U32
    a = (a ^ 0xB55A4F09) ^ (a >> 16)
    return a


def make_seeded_state(iter_, index: torch.Tensor, depth) -> torch.Tensor:
    """Seed per src/pathtrace.cu:41-45, folded into minstd's [1, m-1].

    `iter_` and `depth` are Python ints or scalar tensors; `index` a (P,)
    integer tensor. Returns the int64 state (< 2^31)."""
    key = ((1 << 31) | ((int(depth) << 22) & _U32) | (int(iter_) & _U32)) & _U32
    h = utilhash(torch.tensor([key], dtype=torch.int64, device=index.device))
    h = h ^ utilhash(index)
    s = (h >> 31) + (h & 0x7FFFFFFF)
    s = torch.where(s >= _LCG_M, s - _LCG_M, s)
    return torch.where(s == 0, torch.ones_like(s), s)


def lcg_next(state: torch.Tensor) -> torch.Tensor:
    """One minstd step x <- 48271*x mod (2^31-1).

    The same split-and-fold as the JAX package's division-free uint32
    version, so even states outside [1, m-1] map to the same bits."""
    x = _u32(state)
    a = (x >> 16) * _LCG_A & _U32
    b = (x & 0xFFFF) * _LCG_A & _U32
    s = ((a >> 15) + ((a & 0x7FFF) << 16) + (b >> 31) + (b & 0x7FFFFFFF)) & _U32
    s = (s >> 31) + (s & 0x7FFFFFFF)
    return torch.where(s >= _LCG_M, s - _LCG_M, s)


def lcg_uniform(state: torch.Tensor) -> torch.Tensor:
    """Map state in [1, m-1] to U[0,1) float32."""
    return (state.to(torch.float32) - 1.0) * _INV_M1


def uniforms(iter_, index: torch.Tensor, depth, n: int):
    """`n` sequential U(0,1) floats per lane: a tuple of n (P,) tensors,
    as drawn from one seeded engine per path per bounce."""
    state = make_seeded_state(iter_, index, depth)
    outs = []
    for _ in range(n):
        state = lcg_next(state)
        outs.append(lcg_uniform(state))
    return tuple(outs)


def u32_to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """uint32 (as int64) -> [0,1) float32 from the top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def stratified_pair(iter_, index: torch.Tensor, depth):
    """Randomized-QMC (u1,u2) at this (iteration, pixel, depth): the R2
    lattice, Cranley-Patterson-rotated per (pixel, depth). Drop-in for
    the first two `uniforms`."""
    it = torch.tensor(int(iter_) & _U32, dtype=torch.int64, device=index.device)
    d = int(depth) & _U32
    idx = _u32(index)
    key1 = torch.tensor([((d << 8) | 1) & _U32], dtype=torch.int64,
                        device=index.device)
    rot1 = utilhash(idx ^ utilhash(key1))
    rot2 = utilhash(idx ^ utilhash(key1 + 1))
    u1 = u32_to_unit_float((_mul_u32(it, _R2_A1) + rot1) & _U32)
    u2 = u32_to_unit_float((_mul_u32(it, _R2_A2) + rot2) & _U32)
    return u1, u2


def _sobol2_table():
    """Second-dimension Sobol direction numbers (m_k = m_{k-1} XOR
    2 m_{k-1}), as 32-bit words."""
    m = [1]
    for _ in range(31):
        m.append(m[-1] ^ (2 * m[-1]))
    return tuple((mk << (32 - k - 1)) & _U32 for k, mk in enumerate(m))


_SOBOL_V2 = _sobol2_table()


def _reverse_bits_u32(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _U32) | (x >> 16)


def _owen_hash_u32(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras-style nested uniform scramble of reversed-bit x."""
    x = (x + seed) & _U32
    x = x ^ _mul_u32(x, 0x6C50B47C)
    x = x ^ _mul_u32(x, 0xB82F1E52)
    x = x ^ _mul_u32(x, 0xC7AFE638)
    x = x ^ _mul_u32(x, 0x8D22F6E6)
    return x


def _sobol2_u32(n: torch.Tensor) -> torch.Tensor:
    """Second-dimension Sobol integer via the direction-number XOR."""
    r = torch.zeros_like(n)
    for k, v in enumerate(_SOBOL_V2):
        r = torch.where(((n >> k) & 1) > 0, r ^ v, r)
    return r


def sobol_pair(iter_, index: torch.Tensor, depth):
    """Owen-scrambled Sobol (u1,u2) at this (iteration, pixel, depth);
    the sample index is iteration - 1 (iterations are 1-based)."""
    it = torch.tensor((int(iter_) - 1) & _U32, dtype=torch.int64,
                      device=index.device)
    d = int(depth) & _U32
    idx = _u32(index)
    keys = torch.tensor([((d << 8) | k) & _U32 for k in (1, 2, 3)],
                        dtype=torch.int64, device=index.device)
    hk = utilhash(keys)
    s1 = utilhash(idx ^ hk[0])
    s2 = utilhash(idx ^ hk[1])
    s_idx = utilhash(idx ^ hk[2])
    n = _reverse_bits_u32(_owen_hash_u32(_reverse_bits_u32(it), s_idx))
    x1 = _reverse_bits_u32(n)
    x2 = _sobol2_u32(n)
    u1 = u32_to_unit_float(_reverse_bits_u32(_owen_hash_u32(
        _reverse_bits_u32(x1), s1
    )))
    u2 = u32_to_unit_float(_reverse_bits_u32(_owen_hash_u32(
        _reverse_bits_u32(x2), s2
    )))
    return u1, u2
