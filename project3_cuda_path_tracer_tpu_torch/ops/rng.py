"""Counter-based per-path RNG, bit-exact with the JAX package's `ops/rng.py`.

The CUDA reference seeds a thrust::default_random_engine (minstd LCG,
multiplier 48271 modulo 2^31-1) per (iter, path index, depth) with
    h = utilhash((1 << 31) | (depth << 22) | iter) ^ utilhash(index)
(src/pathtrace.cu:41-45) and draws U(0,1) floats from it. The stream is
keyed on the path's *pixelIndex*, not its pool slot, so permutations of
the pool leave the noise pattern unchanged.

PyTorch has no uint32 arithmetic on every device, so the uint32 math
runs in int64 with a `& 0xFFFFFFFF` after every `+`, `<<` and `*`
(`>>` of a non-negative int64 needs none). The results equal the JAX
package's uint32 results bit for bit (tests/test_torch_rng.py). The CUDA
kernel (csrc/full_iteration.cu) computes the same in native uint32.

`stratified_pair` and `sobol_pair` arrive with the per-bounce kernels
(ROADMAP, port slice 2).
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

# Depth slot that seeds the camera-jitter draws (AA/DoF), distinct from
# every bounce depth.
RAYGEN_STREAM = 255


def _u32(a) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 bit pattern."""
    return a.to(torch.int64) & _U32


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
