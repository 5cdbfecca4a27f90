"""BVH construction (host side, numpy) -> flat int32/float32 arrays.

The port's own copy of the JAX package's binned-SAH construction
(`models/bvh.py::_build_numpy`; that package's optional native C++
construction gives identical arrays and is left out). Each mesh's BVH is built
over its object-space triangles and flattened in DFS preorder with
escape ("skip") pointers, which makes traversal stackless
(ops/bvh_traverse.py, csrc/mesh.cu):
  hit AABB  -> descend to i+1 (preorder: left child is adjacent)
  miss      -> jump to skip[i] (next subtree in preorder)
so one int32 cursor per ray is the whole traversal state.

Leaves hold up to LEAF_SIZE triangles, contiguous after a build-time
reorder of the scene's triangle soup.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np

LEAF_SIZE = 4
SAH_BINS = 16


def _build_numpy(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Binned-SAH recursive build. Returns (nodes_min (B,3),
    nodes_max (B,3), meta (B,4) int32, tri_order (T,) int32).

    meta rows: [first_tri, tri_count, skip, is_leaf]; first_tri/count
    are valid for leaves (indices into the REORDERED triangle array; an
    internal node keeps its right child's index there); skip = preorder
    index of the next node when this subtree is skipped (B = past the end
    for the rightmost spine)."""
    T = v0.shape[0]
    centroid = (v0 + v1 + v2) / 3.0
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)

    order = np.arange(T, dtype=np.int32)
    nodes_min: List[np.ndarray] = []
    nodes_max: List[np.ndarray] = []
    meta: List[List[int]] = []

    def area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit(lo: int, hi: int) -> int:
        """Build the subtree over order[lo:hi]; returns its node index."""
        idx = len(meta)
        ids = order[lo:hi]
        nodes_min.append(tmin[ids].min(axis=0))
        nodes_max.append(tmax[ids].max(axis=0))
        meta.append([lo, hi - lo, -1, 1])  # provisional leaf

        n = hi - lo
        if n <= LEAF_SIZE:
            return idx

        # binned SAH along the centroid extent's longest axis; median
        # split when SAH finds no win
        c = centroid[ids]
        c_min, c_max = c.min(axis=0), c.max(axis=0)
        extent = c_max - c_min
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            mid = lo + n // 2
        else:
            rel = (c[:, axis] - c_min[axis]) / extent[axis]
            bins = np.minimum((rel * SAH_BINS).astype(np.int32), SAH_BINS - 1)
            counts = np.bincount(bins, minlength=SAH_BINS)
            best_cost, best_split = np.inf, None
            bin_min = np.full((SAH_BINS, 3), np.inf)
            bin_max = np.full((SAH_BINS, 3), -np.inf)
            for b in range(SAH_BINS):
                sel = bins == b
                if sel.any():
                    bin_min[b] = tmin[ids[sel]].min(axis=0)
                    bin_max[b] = tmax[ids[sel]].max(axis=0)
            left_min = np.minimum.accumulate(bin_min, axis=0)
            left_max = np.maximum.accumulate(bin_max, axis=0)
            right_min = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            right_max = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            left_cnt = np.cumsum(counts)
            for b in range(SAH_BINS - 1):
                nl, nr = left_cnt[b], n - left_cnt[b]
                if nl == 0 or nr == 0:
                    continue
                cost = nl * area(left_min[b], left_max[b]) + nr * area(
                    right_min[b + 1], right_max[b + 1]
                )
                if cost < best_cost:
                    best_cost, best_split = cost, b
            if best_split is None:
                mid = lo + n // 2
            else:
                sel_left = bins <= best_split
                left_ids = ids[sel_left]
                right_ids = ids[~sel_left]
                order[lo : lo + len(left_ids)] = left_ids
                order[lo + len(left_ids) : hi] = right_ids
                mid = lo + len(left_ids)
        if mid == lo or mid == hi:
            mid = lo + n // 2

        meta[idx][3] = 0  # internal
        emit(lo, mid)  # left child == idx+1 (preorder)
        right = emit(mid, hi)
        meta[idx][0] = right
        meta[idx][1] = 0
        return idx

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if T > 0:
            emit(0, T)
    finally:
        sys.setrecursionlimit(old_limit)

    B = len(meta)
    meta_arr = np.asarray(meta, np.int32).reshape(B, 4)
    # skip pointers: node i's subtree ends where its sibling (or an
    # ancestor's sibling) begins; an iterative DFS in emit()'s preorder
    skip = np.full(B, B, np.int32)
    work = [(0, B)] if B else []
    while work:
        i, s = work.pop()
        skip[i] = s
        if meta_arr[i, 3] == 0:  # internal
            right = meta_arr[i, 0]
            work.append((i + 1, right))  # left child skips to right
            work.append((right, s))  # right child skips out
    meta_arr[:, 2] = skip

    return (
        np.asarray(nodes_min, np.float32).reshape(B, 3),
        np.asarray(nodes_max, np.float32).reshape(B, 3),
        meta_arr,
        order,
    )


def build_mesh_bvh(v0, v1, v2):
    """Build one mesh's BVH (numpy)."""
    return _build_numpy(v0, v1, v2)


def build_scene_bvh(scene):
    """Build BVHs for every mesh geom; returns the concatenated flat
    arrays (nodes_min, nodes_max, meta) plus per-geom (node_start,
    node_count) roots, and REORDERS the scene's triangle soup in place so
    that each leaf references a contiguous run (as the JAX package
    does)."""
    from .scene import GeomType

    t = scene.triangles
    all_min, all_max, all_meta = [], [], []
    roots = []
    node_base = 0
    new_order = np.arange(t.count, dtype=np.int64)

    for gi in range(scene.geoms.count):
        if scene.geoms.gtype[gi] != int(GeomType.MESH):
            roots.append((0, 0))
            continue
        s, c = int(scene.geoms.tri_start[gi]), int(scene.geoms.tri_count[gi])
        if c == 0:
            roots.append((0, 0))
            continue
        nm, nx, meta, order = build_mesh_bvh(
            t.v0[s : s + c], t.v1[s : s + c], t.v2[s : s + c]
        )
        new_order[s : s + c] = s + order.astype(np.int64)
        # leaf first_tri is local to the mesh: offset to the global soup
        leaf = meta[:, 3] == 1
        meta = meta.copy()
        meta[leaf, 0] += s
        # skip pointers are local node indices: offset to the global table
        meta[:, 2] += node_base
        roots.append((node_base, meta.shape[0]))
        all_min.append(nm)
        all_max.append(nx)
        all_meta.append(meta)
        node_base += meta.shape[0]

    for name in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
        setattr(t, name, np.ascontiguousarray(getattr(t, name)[new_order]))

    if all_min:
        return (
            np.concatenate(all_min),
            np.concatenate(all_max),
            np.concatenate(all_meta),
            roots,
        )
    return (
        np.zeros((0, 3), np.float32),
        np.zeros((0, 3), np.float32),
        np.zeros((0, 4), np.int32),
        roots,
    )
