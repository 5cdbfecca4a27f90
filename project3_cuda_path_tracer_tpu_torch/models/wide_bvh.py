"""The wide BVH that kernel #8 walks (host side, numpy).

Each mesh geom's binary BVH (models/bvh.py: preorder with escape
pointers, leaves of up to LEAF_SIZE triangles) is collapsed once, at
scene load, into nodes of up to WIDTH children. A child is either an
inner node (a binary subtree of more than WIDTH triangles, itself
collapsed) or a leaf: a binary subtree of at most WIDTH triangles, which
is one contiguous range of the BVH-ordered soup, so a leaf is still
[first, count]. The triangles do not move. A node is built greedily, as
wide BVHs usually are: start from the binary node's two children and
open the child of largest box area that must stay an inner node, until
there are WIDTH children or none is left to open. Children keep the
binary preorder, so a walk of the wide tree in child order meets the
leaves in ascending triangle order.

The tables are structure-of-arrays, so that lane k of a group of WIDTH
lanes reads child k's word of a row and the group's reads of a row are
one WIDTH*4-byte load:

  box  (N, 6, WIDTH) f32: min x, y, z, max x, y, z of each child's box
       (the binary node's box, object space);
  ref  (N, 2, WIDTH) i32: row 0 the child's reference, row 1 its
       triangle count: 0 for an inner child (row 0 its wide node index),
       1..WIDTH for a leaf (row 0 its first triangle), -1 for no child;
  root (M,) i32: per mesh geom asked for, its root wide node.

The JAX package has no such layout; it is the kernel's data layout, and
WIDTH is a constant of the kernel (csrc/mesh.cu, kWide), not a knob.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np

WIDTH = 8


class WideBVH(NamedTuple):
    box: np.ndarray  # (N, 6, WIDTH) f32
    ref: np.ndarray  # (N, 2, WIDTH) i32
    root: np.ndarray  # (M,) i32, -1 where no tree was asked for
    depth: int  # most inner nodes on a root-to-leaf path, over all geoms


def stack_bound(depth: int) -> int:
    """Entries a walk's stack can hold at once: the root, then at each
    inner node one child popped and at most WIDTH pushed."""
    return (WIDTH - 1) * depth + 1


def _subtree_ranges(start: int, count: int, first, tri_count, skip, leaf):
    """Per binary node of [start, start + count): its right child (-1 for
    a leaf) and its subtree's triangle range [lo, hi). A preorder child
    lies after its parent, so one pass from the end fills both."""
    right = np.full(count, -1, np.int64)
    lo = np.zeros(count, np.int64)
    hi = np.zeros(count, np.int64)
    for i in range(count - 1, -1, -1):
        if leaf[start + i]:
            lo[i] = first[start + i]
            hi[i] = lo[i] + tri_count[start + i]
        else:
            r = int(skip[start + i + 1]) - start  # the left child skips to it
            right[i] = r
            lo[i] = lo[i + 1]
            hi[i] = hi[r]
    return right, lo, hi


def _collapse_geom(start: int, count: int, bmin, bmax, first, tri_count, skip,
                   leaf, base: int):
    """The wide nodes of one geom's binary BVH, numbered from `base` in
    breadth-first order (the root first). Returns (box rows, ref rows,
    depth)."""
    right, lo, hi = _subtree_ranges(start, count, first, tri_count, skip, leaf)
    ext = bmax[start:start + count] - bmin[start:start + count]
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    inner = (right >= 0) & (hi - lo > WIDTH)

    def row(kids):
        box = np.zeros((6, WIDTH), np.float32)
        ref = np.zeros((2, WIDTH), np.int32)
        ref[1] = -1
        for k, c in enumerate(kids):
            box[:3, k] = bmin[start + c]
            box[3:, k] = bmax[start + c]
        return box, ref

    if not inner[0]:  # the whole geom fits one leaf
        box, ref = row([0])
        ref[:, 0] = lo[0], hi[0] - lo[0]
        return [box], [ref], 1
    boxes, refs, depth = [], [], 0
    queue = deque([(0, 1)])  # (binary node, its wide depth)
    n_made = 1
    while queue:
        b, dep = queue.popleft()
        depth = max(depth, dep)
        kids = [b + 1, int(right[b])]
        while len(kids) < WIDTH:
            openable = [j for j, c in enumerate(kids) if inner[c]]
            if not openable:
                break
            j = max(openable, key=lambda j: area[kids[j]])
            c = kids[j]
            kids[j:j + 1] = [c + 1, int(right[c])]
        box, ref = row(kids)
        for k, c in enumerate(kids):
            if inner[c]:
                ref[:, k] = base + n_made, 0
                n_made += 1
                queue.append((c, dep + 1))
            else:
                ref[:, k] = lo[c], hi[c] - lo[c]
        boxes.append(box)
        refs.append(ref)
    return boxes, refs, depth


def collapse(bvh_min: np.ndarray, bvh_max: np.ndarray, bvh_first: np.ndarray,
             bvh_count: np.ndarray, bvh_skip: np.ndarray, bvh_leaf: np.ndarray,
             roots) -> WideBVH:
    """The wide BVH of the binary trees at `roots` ((node_start,
    node_count) each, in the flat binary arrays of models/bvh.py as the
    device scene holds them: (B,3) boxes, (B,) first / count / skip /
    leaf); a root of count 0 gets no tree (root -1)."""
    boxes, refs, root, depth = [], [], [], 0
    for start, count in roots:
        if count == 0:
            root.append(-1)
            continue
        root.append(len(boxes))
        b, r, dep = _collapse_geom(int(start), int(count), bvh_min, bvh_max,
                                   bvh_first, bvh_count, bvh_skip, bvh_leaf,
                                   len(boxes))
        boxes += b
        refs += r
        depth = max(depth, dep)
    n = len(boxes)
    return WideBVH(
        box=np.stack(boxes) if n else np.zeros((0, 6, WIDTH), np.float32),
        ref=np.stack(refs) if n else np.zeros((0, 2, WIDTH), np.int32),
        root=np.asarray(root, np.int32).reshape(len(root)),
        depth=depth,
    )
