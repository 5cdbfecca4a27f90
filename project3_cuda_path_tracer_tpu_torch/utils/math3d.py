"""Host-side 3D math helpers (numpy): transform composition, constants.

A copy of the JAX package's `utils/math3d.py`, so that the port imports
nothing of that package. Behavioural contracts from the CUDA reference
(CIS565 Project3-CUDA-Path-Tracer):
- constants: EPSILON/PI/etc. per the reference's src/utilities.h:10-15
- TRS composition T * Rx * Ry * Rz * S with degree->radian conversion per
  src/utilities.cpp:65-72 (glm column-major, right-handed)

These run at scene-load time on the host, so plain numpy (float32) is the
right tool; the device side consumes the resulting (4,4) matrices as
torch tensors.
"""

from __future__ import annotations

import numpy as np

PI = 3.1415926535897932384626422832795028841971
TWO_PI = 6.2831853071795864769252867665590057683943
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476
EPSILON = 1e-5


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _rotate_x(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rotate_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def _rotate_z(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def build_transformation_matrix(
    translation, rotation_deg, scale
) -> np.ndarray:
    """Compose T * Rx * Ry * Rz * S (rotation angles in degrees).

    Matches the reference's src/utilities.cpp:65-72. Matrices act on
    column vectors (world = M @ [x, y, z, 1]).
    """
    t = np.eye(4, dtype=np.float64)
    t[:3, 3] = np.asarray(translation, dtype=np.float64)
    r = _rotate_x(rotation_deg[0]) @ _rotate_y(rotation_deg[1]) @ _rotate_z(rotation_deg[2])
    s = np.diag([scale[0], scale[1], scale[2], 1.0]).astype(np.float64)
    return (t @ r @ s).astype(np.float32)


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """inverse-transpose of a 4x4 (normal matrix), like glm::inverseTranspose
    used at the reference's src/scene.cpp:85."""
    return np.linalg.inv(m.astype(np.float64)).T.astype(np.float32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)
