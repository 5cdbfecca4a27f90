"""Vec3: structure-of-arrays 3-vectors as three dense (P,) tensors.

The port keeps the JAX package's layout (its `ops/vec.py`) at every
public function, so that the parity tests compare like with like: a
3-vector over the path pool is three (P,) float32 tensors, not one (P,3)
tensor. The CUDA kernel reads and writes the same per-channel lanes
(coalesced, one thread per pixel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_sq())

    def normalize(self, eps: float = 1e-30) -> "Vec3":
        inv = torch.rsqrt(self.length_sq() + eps)
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    # -- misc ---------------------------------------------------------------
    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    # -- constructors -------------------------------------------------------
    @staticmethod
    def zeros(n: int, device) -> "Vec3":
        return Vec3(
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
        )

    @staticmethod
    def ones(n: int, device) -> "Vec3":
        return Vec3(
            torch.ones(n, dtype=torch.float32, device=device),
            torch.ones(n, dtype=torch.float32, device=device),
            torch.ones(n, dtype=torch.float32, device=device),
        )

    @staticmethod
    def broadcast(v: torch.Tensor, n: int) -> "Vec3":
        """From a length-3 tensor to a Vec3 of three (n,) lanes."""
        return Vec3(v[0].expand(n), v[1].expand(n), v[2].expand(n))


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Lane-wise select; mask is (P,) bool. Either side may hold
    scalars that broadcast."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def take(v: Vec3, idx: torch.Tensor) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])
