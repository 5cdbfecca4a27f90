"""The mesh pipeline: kernels #7-#10 and the big-mesh route's four, their
plain versions and launch counts, and the two chains the JAX package's
`ops/pipeline.py` names.

Four wrappers, each replacing one Pallas kernel of the JAX package's
dense mesh route:

- `mesh_candidates` (#7, `_intersect_phase` K1): the analytic winner of
  each lane, and the lanes whose ray enters a mesh geom's object-space
  root box before that winner (`mesh_candidacy`), listed on the device
  (each block packs its live lanes into full warps and appends its
  candidates with one atomic);
- `mesh_sweep` (#8, `_intersect_phase` K2): the mesh winner of each
  listed lane, by a walk of each candidate geom's wide BVH
  (`pack_wide_tables`, models/wide_bvh.py), a group of eight threads per
  listed lane;
- `bounce_step_mesh` (#9, `bounce_step_pipeline` K3): the merge of the two
  winners and the shading half of the bounce, in place on the pool;
- `intersect_mesh` (#10, `intersect_pipeline` K3): the same merge, as
  Intersections.

A mesh geom above SORT_SUPER_MIN_TRIS triangles (`sorted_geoms`) takes
the JAX package's sorted-stream route (`_sorted_mesh_merge`) instead of
#8: `sorted_mesh_merge` runs four wrappers over #7's candidate list for
each such geom, in geom order, after #8 has swept the others
(csrc/sorted.cu):

- `super_keys` (A; `_super_rank_xla` and #12 `_kc_compact`'s counts): the
  object-space ray, the pruning bound and up to SORT_EXPAND supernode keys
  per listed lane (the last one the overflow tail), and a histogram of the
  keys;
- `place_entries` (B; #12's packing, #13 `_ks_stitch`, the global sort):
  a counting sort of the real entries by key into one dense stream, one
  launch that scans A's histogram itself;
- `window_sweep` (C; #11 `_window_sweep`): each entry's winner over the
  triangles of its supernode (a tail entry: of every supernode from its
  start on), one warp per entry over C's lane-major tables
  (`pack_sweep_tables`);
- `merge_entries` (D; #14 `_kx_expand`, the slot merge, `_mesh_epilogue`):
  each lane's winner over its entries, in world space, merged into #8's
  hit lanes.

Under SORT_RADIX (the JAX package's `PT_TPU_SORT_RADIX=1`, off by
default) B gives way to the radix route (csrc/radix.cu), as the JAX
package's radix kernels #15-#17 replace both of its sorts
(`radix_window_sweep`), over two wrappers:

- `radix_split` (#15 `_kr_partition` and #16 `_kr_stitch2` in one
  single-pass launch): each element's key and payload to its place in
  the stable split by a digit of the key (up to 8 bits), its place from
  a decoupled look-back over the tiles before it;
- `radix_unscatter` (#17 `_kr_unpartition`, the whole unsort): each
  result back at the entry id the sort carried;

run as the compaction split of A's keys (the real entries in entry-id
order, with their rays and ids, and the digit histograms of their keys),
ceil(bit_length(2 * n_supers) / 8) 8-bit LSB passes (`radix_sort_stream`;
one pass up to 127 supernodes), C in stream order (`window_sweep_stream`)
and one unscatter of C's results to [slot, j] before D.

The chains: `bounce_step_pipeline` is #7 -> #8 [-> A -> B -> C -> D per
big geom] -> #9 (one bounce of the mesh path), `intersect_pipeline` #7 ->
#8 [-> A-D] -> #10 (`render.intersect_scene_any`: the first-bounce cache
fill, --direct-lighting's two intersect calls and every depth under
--sort-materials). On a scene without mesh geoms `intersect_pipeline` is
#7 -> #10: #7 sweeps the analytic geoms over empty mesh tables (no lane
is a candidate) and #8 and the big-mesh route have no work.

The material sort (`sort_permutation`) is a new use of `radix_split`:
one stable digit pass per 8 bits of the key (one pass up to 255
materials) over the slot iota, its digit counts from `digit_counts`.

On CUDA tensors a wrapper launches its hand-written kernel
(csrc/mesh.cu, sorted.cu or radix.cu, built by ops/_native.py) or raises;
on CPU tensors, and with `plain` (the chains pass
`RenderSettings.plain`, --no-pallas) on CUDA tensors too
(`megakernel.runs_plain`), it runs its plain PyTorch version
(`*_reference`): #7 the
analytic `intersect_scene` plus the candidacy mask plus `torch.nonzero`,
#8 `mesh_intersect_bvh` on the candidate rays (the naive sweep when
`use_bvh` is off, as `RenderSettings.use_bvh` selects for the plain
path; `mesh_sweep_wide_reference` walks #8's wide tables in the kernel's
order, for the tests), #9 the merge plus `render._shade_step`, #10 the
merge, A-D the sorted route op for op (`super_rank` mirrors
`_super_rank_xla`). Each wrapper counts its launches in
`<wrapper>.launches`.

The merge (`merge_hits`): the mesh hit wins iff the lane is a candidate,
t_mesh > 0 and (t_a > 0 ? t_a : FLT_MAX) > t_mesh, so an exact tie goes to
the analytic geom (the JAX pipeline's rule; its XLA `intersect_scene`
merges in geom order instead, which differs only on exact ties).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..models.device import MESH_CHUNK, MESH_SUPER, DeviceScene
from ..models.wide_bvh import WIDTH, collapse, stack_bound
from ..utils import debug
from .bvh_traverse import _aabb_hit, mesh_intersect_bvh, mesh_intersect_wide
from .intersect import (
    FLT_MAX,
    MISS,
    RAY_EPS,
    Intersections,
    closer_hit,
    transform_dir,
    transform_point,
    triangle_intersect,
)
from .megakernel import (
    SceneTables,
    _check_pool,
    _check_tensor,
    _device_args,
    _launch,
    _ptrs,
    _require_cuda,
    _tables_for,
    bounce_step_reference,
    check_supported,
    kernel_flags,
    pack_scene_tables,
    pool_lanes,
    runs_plain,
)
from .sweep import _mesh_intersect_naive, intersect_scene
from .vec import Vec3, take as vtake, where as vwhere

# a mesh geom above this many triangles takes the sorted route (the JAX
# package's ops/pipeline.py SORT_SUPER_MIN_TRIS)
SORT_SUPER_MIN_TRIS = 16384
# entries per candidate lane of the sorted route: one per entered
# supernode, the last slot the overflow tail (the JAX package's
# SORT_EXPAND)
SORT_EXPAND = 6
# A's histogram lives in 48 KB of shared memory: 2 bins per supernode
MAX_SUPERS = 6144
# B's tiles (csrc/sorted.cu): PLACE_THREADS threads a block, each holding
# PLACE_MAX_E entries, E slots of PLACE_MAX_E // E lanes (kPlacePer); A
# holds a lane's E keys in registers and D is instantiated for each E, so
# E <= PLACE_MAX_E for both too
PLACE_THREADS = 256
PLACE_MAX_E = 8
# the radix route in place of B (the JAX package's SORT_RADIX, read from
# the same environment variable at import, off by default; read again at
# each call, so a caller may set the module constant)
SORT_RADIX = os.environ.get("PT_TPU_SORT_RADIX", "0") == "1"
# the radix kernels (csrc/radix.cu): threads per block, elements per tile
# of a split (8 a thread), digit values (one 8-bit digit at most), passes
# at most (keys of up to 31 bits), and 32-bit arrays one launch moves
RADIX_THREADS = 256
RADIX_TILE = 2048
RADIX_MAX_WIDTH = 8
RADIX_DIGITS = 1 << RADIX_MAX_WIDTH
RADIX_MAX_PASSES = 4
RADIX_MAX_WORDS = 8


def sorted_geoms(scene: DeviceScene) -> tuple:
    """The mesh geoms that take the sorted route, in geom order."""
    return tuple(g for g in scene.mesh_geoms
                 if scene.tri_ranges[g][1] > SORT_SUPER_MIN_TRIS)


def dense_geoms(scene: DeviceScene) -> tuple:
    """The mesh geoms that #8 walks, in geom order."""
    big = sorted_geoms(scene)
    return tuple(g for g in scene.mesh_geoms if g not in big)


class Candidates(NamedTuple):
    """#7's output. The analytic fields hold every lane #7 processed (in
    the bounce route the live lanes below the live count; in the intersect
    route every lane); `lanes[:count]` are the candidate lanes, in no
    particular order."""

    t: torch.Tensor  # (P,) f32 analytic winner's distance, -1 on a miss
    normal: Vec3  # (P,) lanes
    material_id: torch.Tensor  # (P,) int32, -1 on a miss
    outside: torch.Tensor  # (P,) bool
    cand: torch.Tensor  # (P,) bool: the lane is a mesh candidate
    lanes: torch.Tensor  # (P,) int32: candidate lane ids first
    count: torch.Tensor  # (1,) int32 on the device: how many


# ---- plain versions --------------------------------------------------------

def _frobenius3(inv: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm of inv's 3x3 block, summed row by row."""
    return torch.sqrt(
        inv[0, 0] * inv[0, 0] + inv[0, 1] * inv[0, 1] + inv[0, 2] * inv[0, 2]
        + inv[1, 0] * inv[1, 0] + inv[1, 1] * inv[1, 1] + inv[1, 2] * inv[1, 2]
        + inv[2, 0] * inv[2, 0] + inv[2, 1] * inv[2, 1] + inv[2, 2] * inv[2, 2]
    )


def mesh_candidacy(scene: DeviceScene, g: int, origins: Vec3, dirs: Vec3,
                   t_a: torch.Tensor) -> torch.Tensor:
    """Does each ray enter mesh geom g's object-space root box before the
    analytic hit? The bound is t_a times the Frobenius norm of inv's 3x3
    block (>= its operator norm, so no closer mesh hit is cut), FLT_MAX on
    a miss. Exact for the merge: a mesh hit behind the bound loses to the
    analytic one anyway."""
    inv = scene.inverse_transform[g]
    ro = transform_point(inv, origins)
    rd = transform_dir(inv, dirs).normalize()
    bound = torch.where(t_a > 0, t_a * _frobenius3(inv), FLT_MAX)
    root = scene.bvh_roots[g][0]
    lo = Vec3(*(c[root] for c in scene.bvh_min))
    hi = Vec3(*(c[root] for c in scene.bvh_max))
    inv_d = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    return _aabb_hit(lo, hi, ro, inv_d, bound)


def _live_mask(alive, P: int, device, num_alive) -> torch.Tensor:
    live = (torch.ones(P, dtype=torch.bool, device=device) if alive is None
            else alive != 0)
    if num_alive is not None:
        live = live & (torch.arange(P, device=device) < num_alive)
    return live


def mesh_candidates_reference(origins: Vec3, dirs: Vec3, alive,
                              scene: DeviceScene, num_alive=None) -> Candidates:
    """#7, plain: the analytic sweep of every lane, the candidacy union
    over the mesh geoms of the live lanes (below `num_alive` when given),
    and the candidates by `torch.nonzero`, in lane order."""
    P = origins.x.shape[0]
    device = origins.x.device
    a = intersect_scene(origins, dirs, scene, meshes=False)
    cand = torch.zeros(P, dtype=torch.bool, device=device)
    for g in scene.mesh_geoms:
        cand = cand | mesh_candidacy(scene, g, origins, dirs, a.t)
    cand = cand & _live_mask(alive, P, device, num_alive)
    found = torch.nonzero(cand)[:, 0].to(torch.int32)
    lanes = torch.zeros(P, dtype=torch.int32, device=device)
    lanes[: found.shape[0]] = found
    count = torch.tensor([found.shape[0]], dtype=torch.int32, device=device)
    return Candidates(a.t, a.normal, a.material_id, a.outside, cand, lanes,
                      count)


def _miss(n: int, device) -> Intersections:
    """n lanes of no hit: the initial values of intersect_scene's sweep."""
    return Intersections(
        t=torch.full((n,), MISS, dtype=torch.float32, device=device),
        normal=Vec3.zeros(n, device),
        material_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        outside=torch.ones(n, dtype=torch.bool, device=device),
    )


def _select(mask: torch.Tensor, a: Intersections, b: Intersections) -> Intersections:
    """Lane-wise a where mask, else b (every field)."""
    return Intersections(
        t=torch.where(mask, a.t, b.t), normal=vwhere(mask, a.normal, b.normal),
        material_id=torch.where(mask, a.material_id, b.material_id),
        outside=torch.where(mask, a.outside, b.outside),
        tex_u=torch.where(mask, a.tex_u, b.tex_u),
        tex_v=torch.where(mask, a.tex_v, b.tex_v),
        has_uv=torch.where(mask, a.has_uv, b.has_uv),
    )


def mesh_sweep_reference(origins: Vec3, dirs: Vec3, cands: Candidates,
                         scene: DeviceScene, use_bvh: bool = True,
                         probe: dict | None = None) -> Intersections:
    """#8, plain: for each candidate lane and each mesh geom that #8 walks
    (`dense_geoms`) it is a candidate of, `mesh_intersect_bvh` (the binary
    walk; or the naive sweep without `use_bvh`), the winners merged in
    geom order with the min-t rule. Lanes that are no candidate get no hit
    (t = -1), as do candidates that hit no triangle.

    probe: a dict that, when given, receives the walk's work per
    candidate lane, summed over the geoms walked (for kernel #8's bound):
    `walks` (geom walks), `nodes` (nodes tested) and `tris` (triangles
    tested), each (count,) int64."""
    def walk(g, o, d, sub):
        if use_bvh:
            return mesh_intersect_bvh(scene, g, o, d, probe=sub)
        return _mesh_intersect_naive(scene, g, o, d)

    return _mesh_sweep_plain(origins, dirs, cands, scene, walk, probe)


def mesh_sweep_wide_reference(origins: Vec3, dirs: Vec3, cands: Candidates,
                              scene: DeviceScene, wide: WideTables | None = None,
                              probe: dict | None = None) -> Intersections:
    """#8's own walk, plain: `mesh_sweep_reference` with each geom walked
    over its wide BVH (`mesh_intersect_wide`, the kernel's order), from
    `wide` (`pack_wide_tables(scene)` when not given). It differs from the
    binary walk only on lanes whose winning triangle's t lies an ulp
    inside a box's slab entry. Used by the tests, never on a path.

    probe: as mesh_sweep_reference's, with `walks`, `nodes` (inner wide
    nodes), `leaves`, `tris` summed over the geoms walked and `stack` (the
    deepest stack) their max."""
    wide = pack_wide_tables(scene) if wide is None else wide

    def walk(g, o, d, sub):
        root = int(wide.root[scene.mesh_geoms.index(g)])
        return mesh_intersect_wide(scene, wide, g, root, o, d, probe=sub)

    return _mesh_sweep_plain(origins, dirs, cands, scene, walk, probe)


def _mesh_sweep_plain(origins: Vec3, dirs: Vec3, cands: Candidates,
                      scene: DeviceScene, walk, probe) -> Intersections:
    """The body of #8's plain versions: `walk(g, o, d, sub)` gives one
    geom's hits of the rays (o, d), its per-lane work in `sub`."""
    P = origins.x.shape[0]
    device = origins.x.device
    n = int(cands.count[0])
    idx = cands.lanes[:n].to(torch.int64)
    o, d, ta = vtake(origins, idx), vtake(dirs, idx), cands.t[idx]
    best = _miss(n, device)
    work = {"walks": torch.zeros(n, dtype=torch.int64, device=device)}
    for g in dense_geoms(scene):
        sel = torch.nonzero(mesh_candidacy(scene, g, o, d, ta))[:, 0]
        sub = {}
        t, nrm, out, tu, tv = walk(g, vtake(o, sel), vtake(d, sel), sub)
        hit = _miss(n, device)
        hit.t[sel] = t
        for dst, src in zip(hit.normal, nrm):
            dst[sel] = src
        hit.material_id[sel] = scene.geom_material_id[g]
        hit.outside[sel] = out
        if scene.mesh_has_uv[g]:
            hit.tex_u[sel] = tu
            hit.tex_v[sel] = tv
            hit.has_uv[sel] = True
        else:
            hit.tex_u, hit.tex_v = best.tex_u, best.tex_v
        best = _select(closer_hit(hit.t, best.t), hit, best)
        work["walks"][sel] += 1
        for k, v in sub.items():
            w = work.setdefault(k, torch.zeros(n, dtype=torch.int64, device=device))
            w[sel] = torch.maximum(w[sel], v) if k == "stack" else w[sel] + v
    if probe is not None:
        for k in ("nodes", "tris"):
            work.setdefault(k, torch.zeros(n, dtype=torch.int64, device=device))
        probe.update(work)
    out = _miss(P, device)
    out.t[idx] = best.t
    for dst, src in zip(out.normal, best.normal):
        dst[idx] = src
    out.material_id[idx] = best.material_id
    out.outside[idx] = best.outside
    out.tex_u[idx] = best.tex_u
    out.tex_v[idx] = best.tex_v
    out.has_uv[idx] = best.has_uv
    return out


def merge_hits(cands: Candidates, hits: Intersections) -> Intersections:
    """#10, plain (and the front half of #9): the mesh hit where the lane
    is a candidate and the mesh is strictly nearer than the analytic hit
    (a miss counts as FLT_MAX), else the analytic hit with no UVs."""
    prev = torch.where(cands.t > 0, cands.t, FLT_MAX)
    better = cands.cand & (hits.t > 0) & (prev > hits.t)
    analytic = Intersections(cands.t, cands.normal, cands.material_id,
                             cands.outside)
    return _select(better, hits, analytic)


def bounce_step_mesh_reference(state, cands: Candidates, hits: Intersections,
                               scene: DeviceScene, iteration: int, depth: int,
                               settings, num_alive=None):
    """#9, plain: the merge, then the shading half of the bounce exactly as
    #3's plain version runs it; returns a new pool."""
    return bounce_step_reference(state, scene, iteration, depth, settings,
                                 num_alive, isect=merge_hits(cands, hits))


# ---- the sorted route, plain versions --------------------------------------

class SuperKeys(NamedTuple):
    """A's output for one big geom. Column j is entry j of #7's candidate
    list (j < count; the rest are not written by the kernel); every array
    is (.., P), P the pool size, so an entry's id is slot * P + j."""

    keys: torch.Tensor  # (E, P) int32 slot-major keys, 2 * n_supers: no entry
    rays: torch.Tensor  # (6, P) f32 object-space origin and unit direction
    bt0: torch.Tensor  # (P,) f32 object-space pruning bound
    hist: torch.Tensor  # (2 * n_supers,) int32 real entries per key
    # (2 * n_supers,) int32: B's cursor, zeroed with hist by A's launch (the
    # kernel's output only; B makes a zeroed one where it is None)
    cursor: torch.Tensor | None = None


class Stream(NamedTuple):
    """B's output: the real entries sorted by key, at [0, total)."""

    key: torch.Tensor  # (E * P,) int32
    entry: torch.Tensor  # (E * P,) int32 entry id slot * P + j
    total: torch.Tensor  # (1,) int32 on the device


class EntryHits(NamedTuple):
    """C's output at each real entry's id (the rest not written by the
    kernel): its winner over its supernode(s), in object space."""

    t: torch.Tensor  # (E, P) f32, FLT_MAX where no triangle won
    tri: torch.Tensor  # (E, P) int32 winning soup triangle, -1 for none
    u: torch.Tensor  # (E, P) f32 barycentrics
    v: torch.Tensor


def entry_hits(res: torch.Tensor) -> EntryHits:
    """EntryHits over the rows of one float32 buffer (4, ...): t, the
    triangle's int32 bits, u, v (the layout the radix route moves)."""
    return EntryHits(res[0], res[1].view(torch.int32), res[2], res[3])


class RadixSplit(NamedTuple):
    """One stable split: the elements in order of a digit of their key, in
    their order within a digit. `shift` >= 0: a digit pass over the first
    `count` elements of a stream key (L,), digit (key >> shift) & (2**width
    - 1) with width <= RADIX_MAX_WIDTH, `hist` its counts over those
    elements (`radix_digit_counts`); width 1 is one binary pass (one
    `_kr_partition` + `_kr_stitch2`). `shift` < 0: the compaction split of
    A's slot-major keys (E, P), flag 0 iff the entry is real (column j <
    count, #7's listed lanes, and key < `dead`); its zeros are the real
    entries in entry-id order, its ones are not placed, its payload is read
    by column (lane j's object-space ray), and it also gives each real
    entry's id and the stream's digit histograms (`radix_passes` of
    `radix_key_bits(dead)`)."""

    key: torch.Tensor  # (L,) int32 stream keys, or (E, P) A's keys
    count: torch.Tensor  # (1,) int32 on the device: length, or listed lanes
    shift: int  # the digit's lowest key bit; -1: the compaction split
    dead: int = 0  # the compaction split's dead key, 2 * n_supers
    width: int = 1  # the digit's bits
    hist: torch.Tensor | None = None  # (RADIX_DIGITS,) int32 digit counts


class RadixStream(NamedTuple):
    """A stream of the radix route: entries at [0, length) of buffers of
    capacity L (E x the pool)."""

    key: torch.Tensor  # (L,) int32
    payload: torch.Tensor  # (k, L) 32-bit words (the six ray lanes, f32)
    length: torch.Tensor  # (1,) int32 on the device
    entry: torch.Tensor | None = None  # (L,) int32 entry id slot * P + j
    # (passes, RADIX_DIGITS) int32: the keys' count of each value of each
    # digit of `radix_passes` (a permutation of the stream keeps it)
    hist: torch.Tensor | None = None


class RadixWork(NamedTuple):
    """The device scratch of one sort (one depth of the radix route): one
    int32 buffer, zeroed by the compaction split's launch, holding the
    stream's digit histograms and length (the compaction split's outputs)
    and, per split (the compaction split, then each of `radix_passes`), its
    tile counter and its look-back words (a word per tile of the capacity
    and digit value)."""

    buf: torch.Tensor  # (words,) int32, all of the below
    hist: torch.Tensor  # (passes, RADIX_DIGITS)
    length: torch.Tensor  # (1,)
    tiles: torch.Tensor  # (1 + passes,) tile counters
    status: tuple  # per split, (tiles x 2**width,) look-back words


def super_rank(q, bt: torch.Tensor, boxes: torch.Tensor, E: int) -> torch.Tensor:
    """The JAX package's `_super_rank_xla`, op for op: for object-space
    rays q = (ox, oy, oz, dx, dy, dz) and pruning bounds bt (each (n,)),
    the (E, n) int32 keys over the geom's supernode boxes (S, 8): slot k
    the k-th entered super (ascending index), 2 * S where there is none;
    a lane entering more than E supers turns its last slot into the
    overflow tail key S + slot[E-2] + 1 (S + slot[0] at E == 1)."""
    qox, qoy, qoz, qdx, qdy, qdz = q
    idx_ = 1.0 / qdx
    idy_ = 1.0 / qdy
    idz_ = 1.0 / qdz
    n_supers = boxes.shape[0]
    dead = 2 * n_supers
    slots = [torch.full_like(qox, dead, dtype=torch.int32) for _ in range(E)]
    cnt = torch.zeros_like(qox, dtype=torch.int32)
    for s in range(n_supers):
        row = boxes[s]
        t1x = (row[0] - qox) * idx_
        t2x = (row[3] - qox) * idx_
        t1y = (row[1] - qoy) * idy_
        t2y = (row[4] - qoy) * idy_
        t1z = (row[2] - qoz) * idz_
        t2z = (row[5] - qoz) * idz_
        tmin = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z),
        )
        tmax = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z),
        )
        te = torch.clamp(tmin, min=0.0)
        ok = (tmax >= tmin) & (tmax > 0) & (te < bt)
        slots = [torch.where(ok & (cnt == j), s, sl) for j, sl in enumerate(slots)]
        cnt = cnt + ok.to(torch.int32)
    over = cnt > E
    if E == 1:
        return torch.where(over, n_supers + slots[0], slots[0])[None]
    last = torch.where(over, n_supers + slots[E - 2] + 1, slots[E - 1])
    return torch.stack(slots[:E - 1] + [last]).to(torch.int32)


def _geom_rows(scene: DeviceScene, g: int) -> dict:
    """Big geom g's ranges: its supers, chunks and soup triangles."""
    (ss, sn), (cs, cn), (ts, tc) = (scene.super_ranges[g], scene.chunk_ranges[g],
                                    scene.tri_ranges[g])
    return dict(super_start=ss, n_supers=sn, chunk_start=cs, n_chunks=cn,
                tri_start=ts, tri_count=tc)


def super_keys_reference(origins: Vec3, dirs: Vec3, cands: Candidates,
                         hits: Intersections, scene: DeviceScene, g: int,
                         E: int) -> SuperKeys:
    """A, plain: for each listed lane, the ray in geom g's object space,
    its bound min(analytic t, mesh t so far) times the Frobenius norm of
    inv's 3x3 (FLT_MAX with neither, as `_sorted_mesh_merge`'s bt0), then
    `super_rank` and the keys' histogram."""
    P = cands.lanes.shape[0]
    device = cands.t.device
    n = int(cands.count[0])
    r = _geom_rows(scene, g)
    sn = r["n_supers"]
    idx = cands.lanes[:n].to(torch.int64)
    inv = scene.inverse_transform[g]
    ro = transform_point(inv, vtake(origins, idx))
    rd = transform_dir(inv, vtake(dirs, idx)).normalize()
    ta, tm = cands.t[idx], hits.t[idx]
    eff = torch.where(tm > 0, torch.where(ta > 0, torch.minimum(tm, ta), tm), ta)
    bt = torch.where(eff > 0, eff * _frobenius3(inv), FLT_MAX)
    boxes = scene.mesh_super_aabbs[r["super_start"]:r["super_start"] + sn]
    q = (*ro, *rd)
    k = super_rank(q, bt, boxes, E)
    keys = torch.full((E, P), 2 * sn, dtype=torch.int32, device=device)
    keys[:, :n] = k
    rays = torch.zeros((6, P), dtype=torch.float32, device=device)
    rays[:, :n] = torch.stack(q)
    bt0 = torch.full((P,), FLT_MAX, dtype=torch.float32, device=device)
    bt0[:n] = bt
    real = k[k < 2 * sn].to(torch.int64)
    hist = torch.bincount(real, minlength=2 * sn).to(torch.int32)
    return SuperKeys(keys, rays, bt0, hist)


def place_entries_reference(sk: SuperKeys, count: torch.Tensor) -> Stream:
    """B, plain: the real entries of the `count` listed lanes
    (`torch.nonzero` of the keys below the dead key, in id order) in a
    stable sort by key."""
    E, P = sk.keys.shape
    dead = sk.hist.shape[0]
    listed = sk.keys[:, :int(count[0])]
    slot, j = torch.nonzero(listed < dead, as_tuple=True)
    k = listed[slot, j]
    order = torch.sort(k, stable=True).indices
    m = k.shape[0]
    key = torch.full((E * P,), dead, dtype=torch.int32, device=k.device)
    entry = torch.zeros(E * P, dtype=torch.int32, device=k.device)
    key[:m] = k[order]
    entry[:m] = (slot * P + j)[order].to(torch.int32)
    return Stream(key, entry, torch.tensor([m], dtype=torch.int32,
                                           device=k.device))


def _entry_supers(key: torch.Tensor, n_supers: int, s2: int) -> torch.Tensor:
    """The entries (by key) that sweep super s2: a window entry its own
    super, a tail entry every super from its start on."""
    tail = key >= n_supers
    return (~tail & (key == s2)) | (tail & (key - n_supers <= s2))


def window_sweep_reference(stream: Stream, sk: SuperKeys, scene: DeviceScene,
                           g: int, probe: dict | None = None) -> EntryHits:
    """C, plain: vectorised over the entries that sweep a super x one
    chunk of MESH_CHUNK triangles, looping over the supers in ascending
    order and their chunks in order. Each entry's carry starts at
    FLT_MAX; a chunk whose box the entry's ray does not enter before its
    running best t is skipped for that entry (exact, see csrc/sorted.cu);
    within a chunk the first least t wins if it beats the carry strictly,
    which is the kernel's ascending strict-< scan.

    probe: a dict that, when given, receives the work per entry, for C's
    bound: `chunks` (chunk boxes tested) and `tris` (triangles tested),
    each (total,) int64 in stream order."""
    E, P = sk.keys.shape
    device = sk.keys.device
    m = int(stream.total[0])
    entry = stream.entry[:m].to(torch.int64)
    bt, best, bu, bv = _sweep_entries(stream.key[:m], sk.rays[:, entry % P], scene,
                                      g, probe)
    out = EntryHits(
        t=torch.full((E, P), FLT_MAX, dtype=torch.float32, device=device),
        tri=torch.full((E, P), -1, dtype=torch.int32, device=device),
        u=torch.zeros((E, P), dtype=torch.float32, device=device),
        v=torch.zeros((E, P), dtype=torch.float32, device=device),
    )
    for a, val in zip(out, (bt, best, bu, bv)):
        a.view(-1)[entry] = val
    return out


def window_sweep_stream_reference(stream: RadixStream, scene: DeviceScene,
                                  g: int, probe: dict | None = None) -> torch.Tensor:
    """C in stream order, plain (the radix route's C): each entry of the
    sorted stream swept as `window_sweep_reference` sweeps it, its ray the
    stream's payload at its place. Returns a (4, L) float32 buffer (rows t,
    the triangle's int32 bits, u, v; `entry_hits`) holding each entry's
    result at its place, FLT_MAX, -1, 0, 0 past the length. probe: as
    `window_sweep_reference`'s."""
    L = stream.key.shape[0]
    m = int(stream.length[0])
    res = torch.zeros((4, L), dtype=torch.float32, device=stream.key.device)
    eh = entry_hits(res)
    eh.t.fill_(FLT_MAX)
    eh.tri.fill_(-1)
    found = _sweep_entries(stream.key[:m], stream.payload[:, :m], scene, g, probe)
    for a, val in zip(eh, found):
        a[:m] = val
    return res


def _sweep_entries(key: torch.Tensor, q: torch.Tensor, scene: DeviceScene, g: int,
                   probe: dict | None) -> tuple:
    """C's sweep of m entries with keys `key` (m,) and object-space rays
    `q` (6, m), vectorised per super and chunk; returns their (t, triangle
    int32, u, v), each (m,)."""
    device = key.device
    r = _geom_rows(scene, g)
    sn, cs, cn = r["n_supers"], r["chunk_start"], r["n_chunks"]
    ts, tc = r["tri_start"], r["tri_count"]
    m = key.shape[0]
    key = key.to(torch.int64)
    bt = torch.full((m,), FLT_MAX, dtype=torch.float32, device=device)
    best = torch.full((m,), -1, dtype=torch.int64, device=device)
    bu = torch.zeros(m, dtype=torch.float32, device=device)
    bv = torch.zeros(m, dtype=torch.float32, device=device)
    n_chunks = torch.zeros(m, dtype=torch.int64, device=device)
    n_tris = torch.zeros(m, dtype=torch.int64, device=device)
    for s2 in range(sn):
        sel = torch.nonzero(_entry_supers(key, sn, s2))[:, 0]
        if sel.shape[0] == 0:
            continue
        ro = Vec3(*q[0:3, sel])
        rd = Vec3(*q[3:6, sel])
        inv_d = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
        ro_b = Vec3(ro.x[None], ro.y[None], ro.z[None])
        rd_b = Vec3(rd.x[None], rd.y[None], rd.z[None])
        sbt, sbest, su, sv = bt[sel], best[sel], bu[sel], bv[sel]
        for c in range(min(MESH_SUPER, cn - s2 * MESH_SUPER)):
            cg = s2 * MESH_SUPER + c
            row = scene.mesh_chunk_aabbs[cs + cg]
            ok = _aabb_hit(Vec3(row[0], row[1], row[2]), Vec3(row[3], row[4], row[5]),
                           ro, inv_d, sbt)
            lo = ts + cg * MESH_CHUNK
            hi = min(ts + tc, lo + MESH_CHUNK)
            n_chunks[sel] += 1
            n_tris[sel] += ok * (hi - lo)

            def col(v: Vec3) -> Vec3:
                return Vec3(v.x[lo:hi, None], v.y[lo:hi, None], v.z[lo:hi, None])

            t, u, v, _ = triangle_intersect(col(scene.tri_v0), col(scene.tri_v1),
                                            col(scene.tri_v2), ro_b, rd_b)
            t = torch.where(ok[None], t, FLT_MAX)
            k = torch.argmin(t, dim=0)  # the first least t
            tmin = t.gather(0, k[None])[0]
            better = tmin < sbt
            sbt = torch.where(better, tmin, sbt)
            sbest = torch.where(better, lo + k, sbest)
            su = torch.where(better, u.gather(0, k[None])[0], su)
            sv = torch.where(better, v.gather(0, k[None])[0], sv)
        bt[sel], best[sel], bu[sel], bv[sel] = sbt, sbest, su, sv
    if probe is not None:
        probe.update(chunks=n_chunks, tris=n_tris)
    return bt, best.to(torch.int32), bu, bv


def merge_entries_reference(origins: Vec3, dirs: Vec3, cands: Candidates,
                            hits: Intersections, sk: SuperKeys, eh: EntryHits,
                            scene: DeviceScene, g: int) -> Intersections:
    """D, plain, IN PLACE on `hits`: per listed lane the least t over its
    real slots in slot order (strict <), the hit rule t < FLT_MAX and t <
    bt0, the winner's interpolated normal and UVs and the world-space tail
    of `mesh_intersect_bvh`, then the strict merge into the lane's mesh
    hit. Returns `hits`."""
    E, P = sk.keys.shape
    n = int(cands.count[0])
    dead = sk.hist.shape[0]
    real = sk.keys[:, :n] < dead
    ts = torch.where(real, eh.t[:, :n], FLT_MAX)
    bt, tri, bu, bv = ts[0], eh.tri[0, :n], eh.u[0, :n], eh.v[0, :n]
    for e in range(1, E):
        better = ts[e] < bt
        bt = torch.where(better, ts[e], bt)
        tri = torch.where(better, eh.tri[e, :n], tri)
        bu = torch.where(better, eh.u[e, :n], bu)
        bv = torch.where(better, eh.v[e, :n], bv)
    hit = (bt < FLT_MAX) & (bt < sk.bt0[:n])
    tri = torch.where(hit, tri, 0).to(torch.int64)
    w = 1.0 - bu - bv
    n_obj = (vtake(scene.tri_n0, tri) * w + vtake(scene.tri_n1, tri) * bu
             + vtake(scene.tri_n2, tri) * bv).normalize()
    has_uv = scene.mesh_has_uv[g]
    if has_uv:
        tex_u = (w * scene.tri_uv0u[tri] + bu * scene.tri_uv1u[tri]
                 + bv * scene.tri_uv2u[tri])
        tex_v = (w * scene.tri_uv0v[tri] + bu * scene.tri_uv1v[tri]
                 + bv * scene.tri_uv2v[tri])
    else:
        tex_u = tex_v = torch.zeros_like(bt)
    idx = cands.lanes[:n].to(torch.int64)
    o, d = vtake(origins, idx), vtake(dirs, idx)
    ro, rd = Vec3(*sk.rays[0:3, :n]), Vec3(*sk.rays[3:6, :n])
    p_world = transform_point(scene.transform[g], ro + rd * (bt - RAY_EPS))
    n_world = transform_dir(scene.inv_transpose[g], n_obj).normalize()
    outside = n_world.dot(d) < 0.0
    n_world = n_world * torch.where(outside, 1.0, -1.0)
    t_g = torch.where(hit, (o - p_world).length(), MISS)
    better = closer_hit(t_g, hits.t[idx])
    win = idx[better]
    hits.t[win] = t_g[better]
    for dst, src in zip(hits.normal, n_world):
        dst[win] = src[better]
    hits.material_id[win] = scene.geom_material_id[g]
    hits.outside[win] = outside[better]
    hits.has_uv[win] = has_uv
    hits.tex_u[win] = tex_u[better]
    hits.tex_v[win] = tex_v[better]
    return hits


# ---- the radix route, plain versions ---------------------------------------

def radix_key_bits(dead: int) -> int:
    """The key bits the radix route sorts: bit_length(2 * n_supers), the
    dead key's (the JAX package's bit count)."""
    return max(1, dead.bit_length())


def radix_passes(bits: int) -> list:
    """The digit passes of a sort of `bits`-bit keys: (shift, width) of
    each RADIX_MAX_WIDTH-bit digit from bit 0 up, the last one narrower."""
    return [(b, min(RADIX_MAX_WIDTH, bits - b)) for b in range(0, bits, RADIX_MAX_WIDTH)]


def radix_digit_counts(key: torch.Tensor, length: torch.Tensor, shift: int,
                       width: int) -> torch.Tensor:
    """A digit pass's `hist`, plain: how many of the stream's keys at [0,
    length) hold each value of the digit (key >> shift) & (2**width - 1),
    (RADIX_DIGITS,) int32 (zeros past 2**width)."""
    return digit_counts(key[:int(length[0])], shift, width)


def digit_counts(key: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """A digit pass's `hist` over the whole of a non-negative key (L,):
    how many keys hold each value of the digit (key >> shift) & (2**width
    - 1), (RADIX_DIGITS,) int32, zeros past 2**width. `radix_digit_counts`
    without its length, so no host sync: a histogram of unit bins (exact
    for any count below 2**24)."""
    digit = (key >> shift) & ((1 << width) - 1)
    return torch.histc(digit.to(torch.float32), bins=RADIX_DIGITS, min=0,
                       max=RADIX_DIGITS).to(torch.int32)


def radix_split_reference(sp: RadixSplit, payload: torch.Tensor,
                          entry: torch.Tensor | None = None) -> RadixStream:
    """One stable split, plain (`radix_split`): a stable sort by the digit
    (or the compaction's nonzero) with the gathers. The key, the payload
    (k, capacity) of 32-bit words ((k, P) for the compaction split, read by
    column) and the entry ids (`entry`, carried by a digit pass; made by
    the compaction split) at their places. Returns the split stream at [0,
    length), zeros after; for the compaction split with its entry ids,
    length and digit histograms; for a digit pass with `sp.count` as its
    length and no histograms."""
    device = sp.key.device
    words = payload.view(torch.int32)
    hist = None
    if sp.shift < 0:
        E, P = sp.key.shape
        listed = torch.arange(P, device=device) < sp.count
        real = (listed[None, :] & (sp.key < sp.dead)).reshape(-1)
        src = torch.nonzero(real)[:, 0]  # the real entries' ids, in order
        cols, ids = src % P, src
        length = torch.tensor([src.shape[0]], dtype=torch.int32, device=device)
    else:
        m = int(sp.count[0])
        digit = (sp.key[:m] >> sp.shift) & ((1 << sp.width) - 1)
        src = torch.sort(digit, stable=True).indices
        cols, ids = src, None if entry is None else entry[src]
        length = sp.count
    cap, m = sp.key.numel(), src.shape[0]
    key = torch.zeros(cap, dtype=torch.int32, device=device)
    key[:m] = sp.key.reshape(-1)[src]
    out = torch.zeros((words.shape[0], cap), dtype=torch.int32, device=device)
    out[:, :m] = words[:, cols]
    if ids is not None:
        ent = torch.zeros(cap, dtype=torch.int32, device=device)
        ent[:m] = ids
        ids = ent
    if sp.shift < 0:
        hist = torch.stack([radix_digit_counts(key, length, b, w)
                            for b, w in radix_passes(radix_key_bits(sp.dead))])
    return RadixStream(key, out.view(payload.dtype), length, ids, hist)


def radix_unsplit_reference(stream: RadixStream, results: torch.Tensor) -> torch.Tensor:
    """The whole unsort, plain (`radix_unscatter`): from `results` (k, L)
    of 32-bit words in the order of `stream` (sorted), each entry's words
    at its id, out[:, entry[i]] = results[:, i] for i below the stream's
    length; zeros elsewhere. With ids slot * P + j, (k, E * P) reshapes to
    (k, E, P)."""
    m = int(stream.length[0])
    words = results.view(torch.int32)
    out = torch.zeros_like(words)
    out[:, stream.entry[:m].long()] = words[:, :m]
    return out.view(results.dtype)


# ---- launch plumbing -------------------------------------------------------

def _mesh_tables(scene: DeviceScene, tables, device):
    """(tables, table pointers, mesh pointers) for the mesh kernels; on a
    scene without mesh geoms the mesh pointers are NULL (empty mesh
    tables: the kernels read them for none of their n_mesh = 0 geoms)."""
    t, tptr = _tables_for(scene, tables, device)
    if not scene.mesh_geoms:
        return t, tptr, _ptrs([None] * 6)
    check_mesh_tables(t, scene, device)
    return t, tptr, _ptrs(list(t.mesh))


def check_mesh_tables(t: SceneTables, scene: DeviceScene, device) -> None:
    """Raise unless `t` holds the mesh tables of `scene` (pack_mesh_tables)
    on `device`: the mesh kernels' and the NEE kernels' check."""
    if t.mesh is None or len(t.mesh) != 6:
        raise ValueError("the mesh kernels need tables packed from a mesh "
                         "scene (pack_scene_tables)")
    T = scene.tri_v0.x.shape[0]
    B = scene.bvh_first.shape[0]
    for name, a, dtype, shape in zip(
        ("mesh.tri", "mesh.attr", "mesh.box", "mesh.geoms", "mesh.chunk",
         "mesh.super"), t.mesh,
        (torch.float32,) * 3 + (torch.int32,) + (torch.float32,) * 2,
        ((T, 12), (T, 16), (B, 8), (len(scene.mesh_geoms), 4),
         tuple(scene.mesh_chunk_aabbs.shape), tuple(scene.mesh_super_aabbs.shape)),
    ):
        _check_tensor(a, name, dtype, shape, device)


def pack_sweep_tables(scene: DeviceScene) -> tuple:
    """C's two tables, lane-major so that lane x of a warp reads word k of
    a row with one 128-byte access per warp: `tris` (C, 9, MESH_CHUNK) f32,
    per chunk its triangle x's v0, e1 = v1 - v0 and e2 = v2 - v0 (the
    kernel's Moller-Trumbore operands, float32 differences as the kernel
    would take them); `boxes` (S, 8, MESH_SUPER) f32, per supernode its
    chunk c's [min, max, 0, 0]. Zeros past a geom's last triangle and
    chunk. Over every mesh geom's chunks and supernodes, in the chunk and
    supernode tables' order."""
    dev = scene.device
    tris = torch.zeros((scene.mesh_chunk_aabbs.shape[0], 9, MESH_CHUNK),
                       dtype=torch.float32, device=dev)
    boxes = torch.zeros((scene.mesh_super_aabbs.shape[0], 8, MESH_SUPER),
                        dtype=torch.float32, device=dev)
    v0, v1, v2 = (torch.stack(list(v), 1) for v in (scene.tri_v0, scene.tri_v1,
                                                     scene.tri_v2))
    corners = torch.cat([v0, v1 - v0, v2 - v0], 1)
    for g in scene.mesh_geoms:
        r = _geom_rows(scene, g)
        cs, cn, ss, sn = r["chunk_start"], r["n_chunks"], r["super_start"], r["n_supers"]
        lanes = torch.zeros((cn * MESH_CHUNK, 9), dtype=torch.float32, device=dev)
        lanes[:r["tri_count"]] = corners[r["tri_start"]:r["tri_start"] + r["tri_count"]]
        tris[cs:cs + cn] = lanes.view(cn, MESH_CHUNK, 9).transpose(1, 2)
        rows = torch.zeros((sn * MESH_SUPER, 8), dtype=torch.float32, device=dev)
        rows[:cn] = scene.mesh_chunk_aabbs[cs:cs + cn]
        boxes[ss:ss + sn] = rows.view(sn, MESH_SUPER, 8).transpose(1, 2)
    return tris, boxes


class WideTables(NamedTuple):
    """#8's wide BVH (models/wide_bvh.py) on the scene's device."""

    box: torch.Tensor  # (N, 6, WIDTH) f32 child boxes
    ref: torch.Tensor  # (N, 2, WIDTH) i32 child reference and count
    root: torch.Tensor  # (M,) i32 per mesh geom: its root, -1 if #8 skips it
    stack: int  # stack entries a walk may need (wide_bvh.stack_bound)
    walked: int  # mesh geoms with a root (0: #8 writes "no hit" alone)


def pack_wide_tables(scene: DeviceScene) -> WideTables:
    """The wide BVH of every geom #8 walks (`dense_geoms`), collapsed in
    numpy from the scene's binary BVH; root -1 for the geoms of the sorted
    route. The triangles stay where they are. Packed once, with the
    scene's tables (object space: motion blur never re-packs them)."""
    dense = dense_geoms(scene)
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    wide = collapse(
        np.stack([host(c) for c in scene.bvh_min], 1),
        np.stack([host(c) for c in scene.bvh_max], 1),
        host(scene.bvh_first), host(scene.bvh_count), host(scene.bvh_skip),
        host(scene.bvh_leaf),
        [scene.bvh_roots[g] if g in dense else (0, 0) for g in scene.mesh_geoms],
    )
    dev = scene.device
    return WideTables(
        box=torch.from_numpy(wide.box).to(dev),
        ref=torch.from_numpy(wide.ref).to(dev),
        root=torch.from_numpy(wide.root).to(dev),
        stack=stack_bound(max(wide.depth, 1)),
        walked=int((wide.root >= 0).sum()),
    )


def _sweep_ptrs(t: SceneTables, scene: DeviceScene, device):
    """C's table pointers {tris, boxes} after checking them."""
    if t.sweep is None or len(t.sweep) != 2:
        raise ValueError("C needs tables packed from a mesh scene (pack_scene_tables)")
    for name, a, shape in zip(
        ("sweep.tris", "sweep.boxes"), t.sweep,
        ((scene.mesh_chunk_aabbs.shape[0], 9, MESH_CHUNK),
         (scene.mesh_super_aabbs.shape[0], 8, MESH_SUPER)),
    ):
        _check_tensor(a, name, torch.float32, shape, device)
    return _ptrs(list(t.sweep))


def _wide_ptrs(t: SceneTables, scene: DeviceScene, device):
    """#8's wide table pointers {box, ref, root} after checking them."""
    w = t.wide
    if not isinstance(w, WideTables):
        raise ValueError("#8 needs tables packed from a mesh scene (pack_scene_tables)")
    N = w.box.shape[0]
    for name, a, dtype, shape in (
        ("wide.box", w.box, torch.float32, (N, 6, WIDTH)),
        ("wide.ref", w.ref, torch.int32, (N, 2, WIDTH)),
        ("wide.root", w.root, torch.int32, (len(scene.mesh_geoms),)),
    ):
        _check_tensor(a, name, dtype, shape, device)
    return _ptrs([w.box, w.ref, w.root])


def _rays(origins: Vec3, dirs: Vec3, P: int, device) -> list:
    """The six ray lanes, contiguous float32 (P,) on `device`."""
    lanes = [a.contiguous() for a in (*origins, *dirs)]
    for name, a in zip(("origins.x", "origins.y", "origins.z", "dirs.x",
                        "dirs.y", "dirs.z"), lanes):
        _check_tensor(a, name, torch.float32, (P,), device)
    return lanes


def _hit_lanes(h) -> list:
    """The kernels' hit-lane order: t, normal, mat, outside, flag[, u, v]."""
    if isinstance(h, Candidates):
        return [h.t, *h.normal, h.material_id, h.outside, h.cand]
    return [h.t, *h.normal, h.material_id, h.outside, h.has_uv, h.tex_u, h.tex_v]


def _check_hits(h, P: int, device) -> list:
    lanes = _hit_lanes(h)
    types = [torch.float32] * 4 + [torch.int32, torch.bool, torch.bool,
                                   torch.float32, torch.float32]
    for k, (a, dtype) in enumerate(zip(lanes, types)):
        _check_tensor(a, f"hit lane {k}", dtype, (P,), device)
    return lanes


def _new_hits(P: int, device) -> Intersections:
    """Uninitialised Intersections lanes: six float32 rows of one buffer,
    material ids, and two bool rows of one buffer."""
    f = torch.empty((6, P), dtype=torch.float32, device=device)
    b = torch.empty((2, P), dtype=torch.bool, device=device)
    return Intersections(
        t=f[0], normal=Vec3(f[1], f[2], f[3]),
        material_id=torch.empty(P, dtype=torch.int32, device=device),
        outside=b[0], tex_u=f[4], tex_v=f[5], has_uv=b[1],
    )


# ---- the wrappers ----------------------------------------------------------

@debug.stage
def mesh_candidates(origins: Vec3, dirs: Vec3, alive, scene: DeviceScene,
                    num_alive: torch.Tensor | None = None,
                    all_lanes: bool = False,
                    tables: SceneTables | None = None,
                    plain: bool = False) -> Candidates:
    """#7 over the rays (origins, dirs) with `alive` (int32 or bool (P,),
    or None for all alive). With `num_alive` (an int32 scalar tensor on
    the device; live lanes first) lanes at or past it are skipped; with
    `all_lanes` dead lanes get their analytic hit too (the intersect
    route), else #7 writes nothing for them. CPU: the plain version (which
    fills every lane); CUDA: one launch (and the list count's memset),
    counted in `mesh_candidates.launches`."""
    device = origins.x.device
    if runs_plain(device, plain):
        return mesh_candidates_reference(origins, dirs, alive, scene, num_alive)
    _require_cuda(device, "mesh_candidates")
    P = origins.x.shape[0]
    rays = _rays(origins, dirs, P, device)
    if alive is not None:
        alive = alive.to(torch.int32).contiguous()
        _check_tensor(alive, "alive", torch.int32, (P,), device)
    if num_alive is not None:
        _check_tensor(num_alive.reshape(1), "num_alive", torch.int32, (1,), device)
    if P >= 1 << 29:
        raise ValueError(f"mesh_candidates: {P} lanes; the kernel takes fewer than 2**29")
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    f = torch.empty((4, P), dtype=torch.float32, device=device)
    b = torch.empty((2, P), dtype=torch.bool, device=device)
    out = Candidates(
        t=f[0], normal=Vec3(f[1], f[2], f[3]),
        material_id=torch.empty(P, dtype=torch.int32, device=device),
        outside=b[0], cand=b[1],
        lanes=torch.empty(P, dtype=torch.int32, device=device),
        count=torch.empty(1, dtype=torch.int32, device=device),
    )
    dev_index, stream = _device_args(device)
    _launch(
        "pt_mesh_candidates", "mesh_candidates",
        tptr, len(scene.gtypes), mptr, len(scene.mesh_geoms),
        _ptrs(rays + [alive]),
        None if num_alive is None else num_alive.data_ptr(), P,
        int(bool(all_lanes)), _ptrs(_hit_lanes(out)), out.lanes.data_ptr(),
        out.count.data_ptr(), dev_index, stream,
    )
    mesh_candidates.launches += 1
    return out


@debug.stage
def mesh_sweep(origins: Vec3, dirs: Vec3, cands: Candidates,
               scene: DeviceScene, tables: SceneTables | None = None,
               use_bvh: bool = True, plain: bool = False) -> Intersections:
    """#8: the mesh winner of each candidate lane of `cands` (#7's
    output), as Intersections lanes written at the lane's own index; the
    other lanes are not written (the kernel) or hold no hit (the plain
    version). `use_bvh` selects the plain version's traversal; the kernel
    always walks the wide BVH (`pack_wide_tables`), WIDTH lanes per
    candidate. CPU: the plain version; CUDA: one launch of as many blocks
    as stay resident, whatever the pool, counted in `mesh_sweep.launches`."""
    device = origins.x.device
    if runs_plain(device, plain):
        return mesh_sweep_reference(origins, dirs, cands, scene, use_bvh)
    _require_cuda(device, "mesh_sweep")
    P = origins.x.shape[0]
    rays = _rays(origins, dirs, P, device)
    _check_hits(cands, P, device)
    _check_tensor(cands.lanes, "lanes", torch.int32, (P,), device)
    _check_tensor(cands.count, "count", torch.int32, (1,), device)
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    wptr = _wide_ptrs(t, scene, device)
    out = _new_hits(P, device)
    next_entry = torch.empty(1, dtype=torch.int32, device=device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_mesh_sweep", "mesh_sweep",
        tptr, len(scene.gtypes), mptr, len(scene.mesh_geoms), wptr,
        int(t.wide.stack), int(t.wide.walked), _ptrs(rays + [None]),
        cands.t.data_ptr(), cands.lanes.data_ptr(), cands.count.data_ptr(), P,
        _ptrs(_hit_lanes(out)), next_entry.data_ptr(), dev_index, stream,
    )
    mesh_sweep.launches += 1
    return out


@debug.stage
def bounce_step_mesh(state, cands: Candidates, hits: Intersections,
                     scene: DeviceScene, iteration: int, depth: int, settings,
                     num_alive: torch.Tensor | None = None,
                     tables: SceneTables | None = None):
    """#9: merge #7's and #8's winners and shade, IN PLACE on the pool
    (returns the same tuple); lanes dead or at or past `num_alive` are
    left as they are. CPU: the plain version, copied back into the lanes;
    CUDA: one launch, counted in `bounce_step_mesh.launches`."""
    check_supported(scene, settings)
    device = state[5].device
    if runs_plain(device, settings.plain):
        new = bounce_step_mesh_reference(state, cands, hits, scene, iteration,
                                         depth, settings, num_alive)
        for dst, src in zip(pool_lanes(state), pool_lanes(new)):
            dst.copy_(src)
        return state
    _require_cuda(device, "bounce_step_mesh")
    P = state[5].shape[0]
    lanes = _check_pool(state, P, device)
    if num_alive is not None:
        _check_tensor(num_alive.reshape(1), "num_alive", torch.int32, (1,), device)
    t, tptr = _tables_for(scene, tables, device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_bounce_step_mesh", "bounce_step_mesh",
        tptr, len(scene.gtypes), _ptrs(lanes),
        None if num_alive is None else num_alive.data_ptr(), P,
        _ptrs(_check_hits(cands, P, device)), _ptrs(_check_hits(hits, P, device)),
        int(iteration), int(depth), int(settings.rr_start_depth),
        kernel_flags(scene, settings), dev_index, stream,
    )
    bounce_step_mesh.launches += 1
    return state


@debug.stage
def intersect_mesh(cands: Candidates, hits: Intersections,
                   plain: bool = False) -> Intersections:
    """#10: the merged Intersections of every lane (dead lanes keep their
    analytic hit). CPU: the plain version (`merge_hits`); CUDA: one
    launch, counted in `intersect_mesh.launches`."""
    device = cands.t.device
    if runs_plain(device, plain):
        return merge_hits(cands, hits)
    _require_cuda(device, "intersect_mesh")
    P = cands.t.shape[0]
    out = _new_hits(P, device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_intersect_mesh", "intersect_mesh",
        _ptrs(_check_hits(cands, P, device)), _ptrs(_check_hits(hits, P, device)),
        P, _ptrs(_hit_lanes(out)), dev_index, stream,
    )
    intersect_mesh.launches += 1
    return out


def _check_list(cands: Candidates, P: int, device) -> None:
    _check_tensor(cands.t, "cands.t", torch.float32, (P,), device)
    _check_tensor(cands.lanes, "lanes", torch.int32, (P,), device)
    _check_tensor(cands.count, "count", torch.int32, (1,), device)


def _check_keys(sk: SuperKeys, n_supers: int, device) -> tuple:
    """(E, P) of A's output, after checking its four tensors."""
    E, P = sk.keys.shape
    for name, a, dtype, shape in (
        ("keys", sk.keys, torch.int32, (E, P)),
        ("rays", sk.rays, torch.float32, (6, P)),
        ("bt0", sk.bt0, torch.float32, (P,)),
        ("hist", sk.hist, torch.int32, (2 * n_supers,)),
    ):
        _check_tensor(a, name, dtype, shape, device)
    return E, P


@debug.stage
def super_keys(origins: Vec3, dirs: Vec3, cands: Candidates,
               hits: Intersections, scene: DeviceScene, g: int,
               E: int | None = None,
               tables: SceneTables | None = None,
               plain: bool = False) -> SuperKeys:
    """A for big geom g over #7's list `cands`, with `hits` the mesh hit
    lanes so far (#8's, merged with earlier big geoms); E defaults to
    SORT_EXPAND. CPU: the plain version; CUDA: one memset (the histogram
    and B's cursor, one buffer) and one launch of the blocks that stay
    resident, which read the list's count on the device and hold a lane's
    keys in registers (E <= PLACE_MAX_E), counted in
    `super_keys.launches`."""
    E = SORT_EXPAND if E is None else E
    device = origins.x.device
    if runs_plain(device, plain):
        return super_keys_reference(origins, dirs, cands, hits, scene, g, E)
    _require_cuda(device, "super_keys")
    P = cands.lanes.shape[0]
    r = _geom_rows(scene, g)
    sn = r["n_supers"]
    if not 1 <= E <= PLACE_MAX_E:
        raise ValueError(f"super_keys: E must be in [1, {PLACE_MAX_E}], got {E}")
    if sn > MAX_SUPERS:
        raise ValueError(f"super_keys: geom {g} has {sn} supernodes, the "
                         f"histogram holds {MAX_SUPERS}")
    rays = _rays(origins, dirs, P, device)
    _check_list(cands, P, device)
    _check_tensor(hits.t, "hits.t", torch.float32, (P,), device)
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    counts = torch.empty(4 * sn, dtype=torch.int32, device=device)  # hist, cursor
    out = SuperKeys(
        keys=torch.empty((E, P), dtype=torch.int32, device=device),
        rays=torch.empty((6, P), dtype=torch.float32, device=device),
        bt0=torch.empty(P, dtype=torch.float32, device=device),
        hist=counts[:2 * sn], cursor=counts[2 * sn:],
    )
    dev_index, stream = _device_args(device)
    _launch(
        "pt_super_keys", "super_keys",
        tptr, len(scene.gtypes), mptr, _ptrs(rays + [None]), cands.t.data_ptr(),
        hits.t.data_ptr(), cands.lanes.data_ptr(), cands.count.data_ptr(), P, g,
        r["super_start"], sn, E, out.keys.data_ptr(), out.rays.data_ptr(),
        out.bt0.data_ptr(), out.hist.data_ptr(), dev_index, stream,
    )
    super_keys.launches += 1
    return out


@debug.stage
def place_entries(sk: SuperKeys, count: torch.Tensor,
                  plain: bool = False) -> Stream:
    """B over A's keys of the `count` listed lanes (#7's device-side
    count): the real entries placed by key into one stream. CPU: the plain
    version; CUDA: one launch of the blocks that stay resident, which scan
    A's histogram themselves and write the total (csrc/sorted.cu), counted
    in `place_entries.launches`. The cursor is A's (`sk.cursor`, zeroed
    with the histogram); a SuperKeys without one gets a zeroed one here."""
    device = sk.keys.device
    if runs_plain(device, plain):
        return place_entries_reference(sk, count)
    _require_cuda(device, "place_entries")
    bins = sk.hist.shape[0]
    E, P = _check_keys(sk, bins // 2, device)
    _check_tensor(count, "count", torch.int32, (1,), device)
    if not 1 <= E <= PLACE_MAX_E:
        raise ValueError(f"place_entries: E must be in [1, {PLACE_MAX_E}], got {E}")
    cursor = torch.zeros_like(sk.hist) if sk.cursor is None else sk.cursor
    _check_tensor(cursor, "cursor", torch.int32, (bins,), device)
    out = torch.empty(2 * E * P + 1, dtype=torch.int32, device=device)
    st = Stream(key=out[:E * P], entry=out[E * P:2 * E * P], total=out[2 * E * P:])
    dev_index, stream = _device_args(device)
    _launch(
        "pt_place_entries", "place_entries",
        sk.keys.data_ptr(), count.data_ptr(), P, E, bins // 2, sk.hist.data_ptr(),
        cursor.data_ptr(), st.key.data_ptr(), st.entry.data_ptr(), st.total.data_ptr(),
        dev_index, stream,
    )
    place_entries.launches += 1
    return st


@debug.stage
def window_sweep(st: Stream, sk: SuperKeys, scene: DeviceScene, g: int,
                 tables: SceneTables | None = None,
                 plain: bool = False) -> EntryHits:
    """C over B's stream, for big geom g. CPU: the plain version; CUDA:
    one launch of the blocks that stay resident, one warp per entry at a
    time (csrc/sorted.cu), over C's lane-major tables
    (`pack_sweep_tables`, packed with the scene's tables), counted in
    `window_sweep.launches`."""
    device = sk.keys.device
    if runs_plain(device, plain):
        return window_sweep_reference(st, sk, scene, g)
    _require_cuda(device, "window_sweep")
    r = _geom_rows(scene, g)
    E, P = _check_keys(sk, r["n_supers"], device)
    for name, a in (("stream.key", st.key), ("stream.entry", st.entry)):
        _check_tensor(a, name, torch.int32, (E * P,), device)
    _check_tensor(st.total, "stream.total", torch.int32, (1,), device)
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    out = EntryHits(
        t=torch.empty((E, P), dtype=torch.float32, device=device),
        tri=torch.empty((E, P), dtype=torch.int32, device=device),
        u=torch.empty((E, P), dtype=torch.float32, device=device),
        v=torch.empty((E, P), dtype=torch.float32, device=device),
    )
    dev_index, stream = _device_args(device)
    _launch(
        "pt_window_sweep", "window_sweep",
        mptr, _sweep_ptrs(t, scene, device), st.key.data_ptr(), st.entry.data_ptr(),
        st.total.data_ptr(), sk.rays.data_ptr(), P, E, r["super_start"], r["n_supers"],
        r["chunk_start"], r["n_chunks"], r["tri_start"], r["tri_count"],
        *(a.data_ptr() for a in out),
        dev_index, stream,
    )
    window_sweep.launches += 1
    return out


@debug.stage
def merge_entries(origins: Vec3, dirs: Vec3, cands: Candidates,
                  hits: Intersections, sk: SuperKeys, eh: EntryHits,
                  scene: DeviceScene, g: int,
                  tables: SceneTables | None = None,
                  plain: bool = False) -> Intersections:
    """D: big geom g's winner of each listed lane merged IN PLACE into
    `hits` (returned). CPU: the plain version; CUDA: one launch sized by
    the pool, of the kernel instantiated for E (E <= PLACE_MAX_E),
    counted in `merge_entries.launches`."""
    device = origins.x.device
    if runs_plain(device, plain):
        return merge_entries_reference(origins, dirs, cands, hits, sk, eh, scene, g)
    _require_cuda(device, "merge_entries")
    E, P = _check_keys(sk, _geom_rows(scene, g)["n_supers"], device)
    if not 1 <= E <= PLACE_MAX_E:
        raise ValueError(f"merge_entries: E must be in [1, {PLACE_MAX_E}], got {E}")
    for name, a, dtype in zip(("t", "tri", "u", "v"), eh,
                              (torch.float32, torch.int32, torch.float32,
                               torch.float32)):
        _check_tensor(a, f"entry hits.{name}", dtype, (E, P), device)
    _check_list(cands, P, device)
    rays = _rays(origins, dirs, P, device)
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_merge_entries", "merge_entries",
        tptr, len(scene.gtypes), mptr, _ptrs(rays + [None]),
        cands.lanes.data_ptr(), cands.count.data_ptr(), P, E,
        sk.hist.shape[0] // 2, g, int(scene.mesh_has_uv[g]), sk.keys.data_ptr(),
        *(a.data_ptr() for a in eh), sk.rays.data_ptr(), sk.bt0.data_ptr(),
        _ptrs(_check_hits(hits, P, device)), dev_index, stream,
    )
    merge_entries.launches += 1
    return hits


def _check_words(a: torch.Tensor, name: str, rows_max: int, cols: int, device) -> None:
    """A (k, cols) array of 32-bit words, k <= rows_max."""
    if a.dim() != 2 or not 0 < a.shape[0] <= rows_max:
        raise ValueError(f"{name} must be (k, {cols}) with 0 < k <= {rows_max}")
    if a.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"{name} has dtype {a.dtype}, expected 32-bit words")
    _check_tensor(a, name, a.dtype, (a.shape[0], cols), device)


def radix_work(capacity: int, bits: int, device) -> RadixWork:
    """The scratch (`RadixWork`) of one sort of up to `capacity` elements
    by `bits`-bit keys, not zeroed (the compaction split's launch zeroes
    it)."""
    passes = radix_passes(bits)
    tiles = -(-capacity // RADIX_TILE)
    sizes = [tiles] + [tiles << w for _, w in passes]
    head = len(passes) * RADIX_DIGITS + 1
    buf = torch.empty(head + 1 + len(passes) + sum(sizes), dtype=torch.int32,
                      device=device)
    status, at = [], head + 1 + len(passes)
    for size in sizes:
        status.append(buf[at:at + size])
        at += size
    return RadixWork(buf, buf[:head - 1].view(len(passes), RADIX_DIGITS),
                     buf[head - 1:head], buf[head:head + 1 + len(passes)], tuple(status))


@debug.stage
def radix_split(sp: RadixSplit, payload: torch.Tensor, entry: torch.Tensor | None = None,
                work: RadixWork | None = None,
                probe: torch.Tensor | None = None,
                plain: bool = False) -> RadixStream:
    """One stable split (`RadixSplit`, #15 + #16) carried out: the key, the
    payload (k, capacity) of 32-bit words ((k, P) for the compaction split,
    read by column) and the entry ids (`entry`, (capacity,) int32, carried
    by a digit pass; made by the compaction split) each at its place.
    Returns the split stream at [0, length), the rest not written: for the
    compaction split with its entry ids, length and digit histograms (views
    of `work`), for a digit pass with `sp.count` as its length and no
    histograms. `work`: the sort's scratch (`radix_work`), which the
    compaction split's launch zeroes and a digit pass at shift 8p uses as
    pass p's; None: a scratch of the split's own, zeroed by its launch.
    `probe`: None, or (2,) int32 on the device to which the launch adds its
    look-back's steps and spins. CPU: the plain version; CUDA: one launch
    on a persistent grid (after one memset where it zeroes the scratch), no
    host sync, counted in `radix_split.launches`."""
    device = sp.key.device
    if runs_plain(device, plain):
        return radix_split_reference(sp, payload, entry)
    _require_cuda(device, "radix_split")
    _check_tensor(sp.count, "split.count", torch.int32, (1,), device)
    compact = sp.shift < 0
    if compact:
        if sp.key.dim() != 2:
            raise ValueError("the compaction split takes A's (E, P) keys")
        E, n = sp.key.shape
        cap, cols, width = E * n, n, radix_key_bits(sp.dead)
        if entry is not None or sp.dead <= 0 or width >= RADIX_MAX_WIDTH * RADIX_MAX_PASSES:
            raise ValueError(f"compaction split: dead key {sp.dead}, entry {entry}")
    else:
        (cap,) = sp.key.shape
        E, n, cols, width = 1, cap, cap, sp.width
        if not 1 <= width <= RADIX_MAX_WIDTH or sp.shift + width > 31:
            raise ValueError(f"digit pass: shift {sp.shift}, width {width} out of range")
        if sp.hist is None:
            raise ValueError("a digit pass needs its digit counts (split.hist)")
        _check_tensor(sp.hist, "split.hist", torch.int32, (RADIX_DIGITS,), device)
        if entry is not None:
            _check_tensor(entry, "entry", torch.int32, (cap,), device)
    _check_tensor(sp.key, "split.key", torch.int32, tuple(sp.key.shape), device)
    if not 0 < cap <= 2**30 - RADIX_TILE:
        raise ValueError(f"radix split: capacity {cap} out of range")
    _check_words(payload, "payload", RADIX_MAX_WORDS - (entry is not None), cols, device)
    # the split's tile counter and look-back words: the compaction split's
    # are the work's first, pass p's the (1 + p)-th; the compaction split
    # (or a split with a scratch of its own) zeroes the whole work first
    region = 0 if compact else 1 + sp.shift // RADIX_MAX_WIDTH
    clear = None
    if work is None:
        work = radix_work(cap, width, device)
        region, clear = min(region, 1), work.buf
    elif compact:
        clear = work.buf
    elif sp.shift % RADIX_MAX_WIDTH or region >= len(work.status):
        raise ValueError(f"digit pass at shift {sp.shift}: no such pass in the work")
    if work.status[region].shape[0] < -(-cap // RADIX_TILE) << (0 if compact else width):
        raise ValueError("the work was made for a smaller sort")
    if probe is not None:
        _check_tensor(probe, "probe", torch.int32, (2,), device)
    key = torch.empty(cap, dtype=torch.int32, device=device)
    out = torch.empty((payload.shape[0], cap), dtype=payload.dtype, device=device)
    ent = None if entry is None and not compact else torch.empty(
        cap, dtype=torch.int32, device=device)
    ins, outs = list(payload), list(out)
    if entry is not None:
        ins, outs = ins + [entry], outs + [ent]
    dev_index, stream = _device_args(device)
    _launch("pt_radix_split", "radix_split", sp.key.data_ptr(), sp.count.data_ptr(),
            None if compact else sp.hist.data_ptr(), cap, n, E, sp.shift, width, sp.dead,
            _ptrs(ins), _ptrs(outs), len(ins), key.data_ptr(),
            ent.data_ptr() if compact else None,
            work.length.data_ptr() if compact else None,
            work.hist.data_ptr() if compact else None,
            work.tiles[region:region + 1].data_ptr(), work.status[region].data_ptr(),
            None if clear is None else clear.data_ptr(),
            0 if clear is None else clear.numel(),
            None if probe is None else probe.data_ptr(), dev_index, stream)
    radix_split.launches += 1
    if compact:
        return RadixStream(key, out, work.length, ent, work.hist)
    return RadixStream(key, out, sp.count, ent)


@debug.stage
def radix_unscatter(stream: RadixStream, results: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """The whole unsort (#17; the JAX package's `_radix_unsort_stream`, the
    inverse of the sort's permutation) in one launch: each entry's result
    words back at its id, out[:, entry[i]] = results[:, i] for i below the
    stream's length, from `results` (k, L) of 32-bit words in the order of
    `stream` into a (k, L) buffer (L = E * P: reshape to (k, E, P) for
    [slot, j]), the rest not written. CPU: the plain version (zeros
    there); CUDA: one launch on a persistent grid, counted in
    `radix_unscatter.launches`."""
    device = stream.key.device
    if runs_plain(device, plain):
        return radix_unsplit_reference(stream, results)
    _require_cuda(device, "radix_unscatter")
    (cap,) = stream.key.shape
    if stream.entry is None:
        raise ValueError("the unsort needs the stream's entry ids")
    _check_tensor(stream.entry, "stream.entry", torch.int32, (cap,), device)
    _check_tensor(stream.length, "stream.length", torch.int32, (1,), device)
    _check_words(results, "results", RADIX_MAX_WORDS, cap, device)
    out = torch.empty_like(results)
    dev_index, cuda_stream = _device_args(device)
    _launch("pt_radix_unscatter", "radix_unscatter", stream.entry.data_ptr(),
            stream.length.data_ptr(), cap, _ptrs(list(results)), _ptrs(list(out)),
            results.shape[0], dev_index, cuda_stream)
    radix_unscatter.launches += 1
    return out


@debug.stage
def window_sweep_stream(stream: RadixStream, scene: DeviceScene, g: int,
                        tables: SceneTables | None = None,
                        plain: bool = False) -> torch.Tensor:
    """C in stream order over the radix route's sorted stream (its payload
    the six object-space ray lanes), for big geom g: a (4, L) float32
    buffer of each entry's (t, triangle bits, u, v) at its place
    (`entry_hits`). CPU: the plain version; CUDA: one launch of C's
    stream-order instantiation, one warp per entry as `window_sweep`,
    counted in `window_sweep_stream.launches`."""
    device = stream.key.device
    if runs_plain(device, plain):
        return window_sweep_stream_reference(stream, scene, g)
    _require_cuda(device, "window_sweep_stream")
    r = _geom_rows(scene, g)
    L = stream.key.shape[0]
    _check_tensor(stream.key, "stream.key", torch.int32, (L,), device)
    _check_tensor(stream.payload, "stream.payload", torch.float32, (6, L), device)
    _check_tensor(stream.length, "stream.length", torch.int32, (1,), device)
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    res = torch.empty((4, L), dtype=torch.float32, device=device)
    dev_index, cuda_stream = _device_args(device)
    _launch(
        "pt_window_sweep_stream", "window_sweep_stream",
        mptr, _sweep_ptrs(t, scene, device), stream.key.data_ptr(), stream.length.data_ptr(),
        stream.payload.data_ptr(), L, r["super_start"], r["n_supers"],
        r["chunk_start"], r["n_chunks"], r["tri_start"], r["tri_count"],
        *(a.data_ptr() for a in entry_hits(res)), dev_index, cuda_stream,
    )
    window_sweep_stream.launches += 1
    return res


def radix_sort_stream(stream: RadixStream, bits: int,
                      work: RadixWork | None = None,
                      plain: bool = False) -> RadixStream:
    """The JAX package's `_radix_sort_stream`: a stable LSB radix sort of
    the stream by its `bits`-bit key, one `radix_split` per digit of
    `radix_passes(bits)` (one up to 8 bits), each from the stream's digit
    histograms (`stream.hist`, needed on CUDA). Stable on a stream in
    entry-id order, it is the (key, entry) sort; the entry ids ride along
    for the unsort. Returns the sorted stream (the histograms kept)."""
    for p, (shift, width) in enumerate(radix_passes(bits)):
        hist = None if stream.hist is None else stream.hist[p]
        sp = RadixSplit(stream.key, stream.length, shift, width=width, hist=hist)
        stream = radix_split(sp, stream.payload, stream.entry, work=work,
                             plain=plain)._replace(hist=stream.hist)
    return stream


def sort_permutation(key: torch.Tensor, bits: int,
                     plain: bool = False) -> torch.Tensor:
    """The stable sort of a non-negative int32 key (P,) below 2**bits, as
    the permutation that gathers it: perm (P,) int32 with key[perm]
    ascending and equal keys in slot order, i.e. `torch.sort(key,
    stable=True).indices` element for element. One `radix_split` digit
    pass per `radix_passes(bits)` (LSB first; one up to 8 bits), its
    payload the slot iota, its counts `digit_counts`. CPU: the plain
    splits; CUDA: one launch per pass (each with its own zeroed scratch),
    no host sync."""
    P = key.shape[0]
    device = key.device
    count = torch.full((1,), P, dtype=torch.int32, device=device)
    payload = torch.arange(P, dtype=torch.int32, device=device).view(1, P)
    key = key.to(torch.int32).contiguous()
    for shift, width in radix_passes(bits):
        sp = RadixSplit(key, count, shift, width=width,
                        hist=digit_counts(key, shift, width))
        st = radix_split(sp, payload, plain=plain)
        key, payload = st.key, st.payload
    return payload[0]


def radix_window_sweep(sk: SuperKeys, count: torch.Tensor, scene: DeviceScene,
                       g: int, tables: SceneTables | None = None,
                       plain: bool = False) -> EntryHits:
    """C's results at [slot, j] by the radix route (the JAX package's
    SORT_RADIX branch of `_sorted_mesh_merge`, in place of B and C): the
    compaction split of A's keys with their rays (entry ids and digit
    histograms made in the same launch), ceil(bit_length(2 * n_supers) /
    8) digit passes (`radix_sort_stream`), C in stream order and one
    unscatter of its results to their ids. The real entries' results are
    those of B -> C; the rest not written. On CUDA: 2 + passes launches
    and one memset (the sort's scratch), no host sync."""
    E, P = sk.keys.shape
    dead = sk.hist.shape[0]
    bits = radix_key_bits(dead)
    device = sk.keys.device
    work = None if runs_plain(device, plain) else radix_work(E * P, bits, device)
    stream = radix_split(RadixSplit(sk.keys, count, -1, dead), sk.rays, work=work,
                         plain=plain)
    srt = radix_sort_stream(stream, bits, work=work, plain=plain)
    res = window_sweep_stream(srt, scene, g, tables=tables, plain=plain)
    return entry_hits(radix_unscatter(srt, res, plain=plain).view(4, E, P))


def sorted_mesh_merge(origins: Vec3, dirs: Vec3, cands: Candidates,
                      hits: Intersections, scene: DeviceScene,
                      tables: SceneTables | None = None,
                      plain: bool = False) -> Intersections:
    """The JAX package's `_sorted_mesh_merge`: for each geom of the sorted
    route, in geom order, A -> B -> C -> D (under SORT_RADIX A -> the radix
    route -> D), merging its winner of each candidate lane into `hits`
    (#8's output) IN PLACE. Returns `hits`."""
    for g in sorted_geoms(scene):
        sk = super_keys(origins, dirs, cands, hits, scene, g, tables=tables,
                        plain=plain)
        if SORT_RADIX:
            eh = radix_window_sweep(sk, cands.count, scene, g, tables=tables,
                                    plain=plain)
        else:
            st = place_entries(sk, cands.count, plain=plain)
            eh = window_sweep(st, sk, scene, g, tables=tables, plain=plain)
        merge_entries(origins, dirs, cands, hits, sk, eh, scene, g, tables=tables,
                      plain=plain)
    return hits


# ---- the chains ------------------------------------------------------------

def bounce_step_pipeline(state, scene: DeviceScene, iteration: int,
                         depth: int, settings,
                         num_alive: torch.Tensor | None = None,
                         tables: SceneTables | None = None):
    """One bounce of the mesh path over the pool, IN PLACE: #7 -> #8 ->
    the sorted route (A -> B -> C -> D per big geom) -> #9 (the JAX
    package's `bounce_step_pipeline`, K1 -> K2 -> `_sorted_mesh_merge` ->
    K3). No host sync on CUDA. The tables are packed once here unless
    given."""
    check_supported(scene, settings)
    plain = settings.plain
    if tables is None and not runs_plain(scene.device, plain):
        tables = pack_scene_tables(scene)
    origins, dirs = state[0], state[1]
    cands = mesh_candidates(origins, dirs, state[4], scene, num_alive=num_alive,
                            tables=tables, plain=plain)
    hits = mesh_sweep(origins, dirs, cands, scene, tables=tables,
                      use_bvh=settings.use_bvh, plain=plain)
    sorted_mesh_merge(origins, dirs, cands, hits, scene, tables=tables, plain=plain)
    return bounce_step_mesh(state, cands, hits, scene, iteration, depth,
                            settings, num_alive=num_alive, tables=tables)


def intersect_pipeline(origins: Vec3, dirs: Vec3, alive, scene: DeviceScene,
                       tables: SceneTables | None = None,
                       use_bvh: bool = True, plain: bool = False) -> Intersections:
    """`intersect_scene` through #7 -> #8 -> the sorted route -> #10 (the
    JAX package's `intersect_pipeline`): the same Intersections contract,
    dead lanes (`alive`, None for all alive) with their analytic hit. On a
    scene without mesh geoms #7 -> #10 alone: no lane is a candidate, so
    #10 takes every lane's analytic hit (no UVs) and never reads the mesh
    hit lanes, which are left unwritten on CUDA."""
    if tables is None and not runs_plain(scene.device, plain):
        tables = pack_scene_tables(scene)
    # contiguous once here, not once in each of #7 and #8
    origins = Vec3(*(a.contiguous() for a in origins))
    dirs = Vec3(*(a.contiguous() for a in dirs))
    cands = mesh_candidates(origins, dirs, alive, scene, all_lanes=True,
                            tables=tables, plain=plain)
    P = origins.x.shape[0]
    if not scene.mesh_geoms:
        hits = (_miss(P, scene.device) if runs_plain(scene.device, plain)
                else _new_hits(P, scene.device))
        return intersect_mesh(cands, hits, plain=plain)
    hits = mesh_sweep(origins, dirs, cands, scene, tables=tables,
                      use_bvh=use_bvh, plain=plain)
    sorted_mesh_merge(origins, dirs, cands, hits, scene, tables=tables, plain=plain)
    return intersect_mesh(cands, hits, plain=plain)


def intersect_pipeline_reference(origins: Vec3, dirs: Vec3, alive,
                                 scene: DeviceScene,
                                 use_bvh: bool = True) -> Intersections:
    """`intersect_pipeline`'s plain versions on any device, no kernel
    launched: #7, #8 (`use_bvh`), A -> B -> C -> D for each geom of the
    sorted route, #10. On the CPU `intersect_pipeline` runs exactly this."""
    cands = mesh_candidates_reference(origins, dirs, alive, scene)
    hits = mesh_sweep_reference(origins, dirs, cands, scene, use_bvh=use_bvh)
    for g in sorted_geoms(scene):
        sk = super_keys_reference(origins, dirs, cands, hits, scene, g, SORT_EXPAND)
        st = place_entries_reference(sk, cands.count)
        eh = window_sweep_reference(st, sk, scene, g)
        merge_entries_reference(origins, dirs, cands, hits, sk, eh, scene, g)
    return merge_hits(cands, hits)


mesh_candidates.launches = 0
mesh_sweep.launches = 0
bounce_step_mesh.launches = 0
intersect_mesh.launches = 0
super_keys.launches = 0
place_entries.launches = 0
window_sweep.launches = 0
merge_entries.launches = 0
radix_split.launches = 0
radix_unscatter.launches = 0
window_sweep_stream.launches = 0
