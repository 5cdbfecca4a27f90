"""Wavefront OBJ triangle-mesh loading (INSTRUCTION.md:123-132).

The port's own copy of the JAX package's pure-Python OBJ parser (numpy
only; the JAX package's optional ctypes path to a native parser is left
out: both give the same soup). Supports v/vt/vn/f records with v,
v//vn, v/vt, v/vt/vn face syntax and fan-triangulation of polygons.
Negative indices are OBJ-standard relative indices. Texture coordinates
(vt) are carried per corner; a mesh with any face lacking vt gets
has_uv=False.
"""

from __future__ import annotations

import numpy as np

from .scene import TriangleSoup


def load_obj(path: str) -> TriangleSoup:
    """Load an OBJ into a TriangleSoup."""
    verts: list = []
    normals: list = []
    texcoords: list = []
    faces: list = []  # list of lists of (vi, ti, ni) triples

    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                # OBJ vt may carry 1-3 floats; keep (u, v)
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                texcoords.append([u, v])
            elif tag == "f":
                corners = []
                for spec in parts[1:]:
                    fields = spec.split("/")
                    vi = int(fields[0])
                    ti = 0
                    ni = 0
                    if len(fields) >= 2 and fields[1]:
                        ti = int(fields[1])
                    if len(fields) >= 3 and fields[2]:
                        ni = int(fields[2])
                    corners.append((vi, ti, ni))
                # fan triangulation for quads/ngons
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])

    v = np.asarray(verts, dtype=np.float32)
    vn = np.asarray(normals, dtype=np.float32) if normals else None
    vt = np.asarray(texcoords, dtype=np.float32) if texcoords else None
    t = len(faces)
    v0 = np.zeros((t, 3), np.float32)
    v1 = np.zeros((t, 3), np.float32)
    v2 = np.zeros((t, 3), np.float32)
    n0 = np.zeros((t, 3), np.float32)
    n1 = np.zeros((t, 3), np.float32)
    n2 = np.zeros((t, 3), np.float32)
    uv0 = np.zeros((t, 2), np.float32)
    uv1 = np.zeros((t, 2), np.float32)
    uv2 = np.zeros((t, 2), np.float32)
    all_uv = vt is not None and t > 0

    def _vidx(i: int, n: int) -> int:
        return i - 1 if i > 0 else n + i

    for ti_, face in enumerate(faces):
        pos = [v[_vidx(vi, len(v))] for vi, _, _ in face]
        v0[ti_], v1[ti_], v2[ti_] = pos
        has_normals = vn is not None and all(ni != 0 for _, _, ni in face)
        if has_normals:
            nrm = [vn[_vidx(ni, len(vn))] for _, _, ni in face]
            n0[ti_], n1[ti_], n2[ti_] = nrm
        else:
            fn = np.cross(pos[1] - pos[0], pos[2] - pos[0])
            norm = np.linalg.norm(fn)
            fn = fn / norm if norm > 0 else np.array([0, 1, 0], np.float32)
            n0[ti_] = n1[ti_] = n2[ti_] = fn
        if vt is not None and all(tc != 0 for _, tc, _ in face):
            tcs = [vt[_vidx(tc, len(vt))] for _, tc, _ in face]
            uv0[ti_], uv1[ti_], uv2[ti_] = tcs
        else:
            # has_uv is per geom (every triangle of a has_uv mesh samples
            # by UV), so one vt-less face demotes the whole mesh
            all_uv = False

    return TriangleSoup(
        v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
        uv0=uv0, uv1=uv1, uv2=uv2, has_uv=all_uv,
    )


def mesh_bounds(tris: TriangleSoup):
    """Object-space AABB over all triangles (bounding-volume culling,
    INSTRUCTION.md:128-131)."""
    if tris.count == 0:
        return np.zeros(3, np.float32), np.zeros(3, np.float32)
    allv = np.concatenate([tris.v0, tris.v1, tris.v2], axis=0)
    return allv.min(axis=0), allv.max(axis=0)
