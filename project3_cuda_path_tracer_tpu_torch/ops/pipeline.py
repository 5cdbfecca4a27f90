"""The mesh pipeline: kernels #7-#10, their plain versions and launch
counts, and the two chains the JAX package's `ops/pipeline.py` names.

Four wrappers, each replacing one Pallas kernel of the JAX package's
dense mesh route (its geoms of at most 16,384 triangles):

- `mesh_candidates` (#7, `_intersect_phase` K1): the analytic winner of
  each lane, and the lanes whose ray enters a mesh geom's object-space
  root box before that winner (`mesh_candidacy`), listed on the device;
- `mesh_sweep` (#8, `_intersect_phase` K2): the mesh winner of each
  listed lane, by a walk of each candidate geom's BVH;
- `bounce_step_mesh` (#9, `bounce_step_pipeline` K3): the merge of the two
  winners and the shading half of the bounce, in place on the pool;
- `intersect_mesh` (#10, `intersect_pipeline` K3): the same merge, as
  Intersections.

The chains: `bounce_step_pipeline` is #7 -> #8 -> #9 (one bounce of the
mesh path), `intersect_pipeline` #7 -> #8 -> #10 (the first-bounce cache
fill and --direct-lighting's two intersect calls).

On CUDA tensors a wrapper launches its hand-written kernel
(csrc/mesh.cu, built by ops/_native.py) or raises; on CPU tensors, and
only there, it runs its plain PyTorch version (`*_reference`): #7 the
analytic `intersect_scene` plus the candidacy mask plus `torch.nonzero`,
#8 `mesh_intersect_bvh` on the candidate rays (the naive sweep when
`use_bvh` is off, as `RenderSettings.use_bvh` selects for the plain
path), #9 the merge plus `render._shade_step`, #10 the merge. Each
wrapper counts its launches in `<wrapper>.launches`.

The merge (`merge_hits`): the mesh hit wins iff the lane is a candidate,
t_mesh > 0 and (t_a > 0 ? t_a : FLT_MAX) > t_mesh, so an exact tie goes to
the analytic geom (the JAX pipeline's rule; its XLA `intersect_scene`
merges in geom order instead, which differs only on exact ties).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.device import DeviceScene
from .bvh_traverse import _aabb_hit, mesh_intersect_bvh
from .intersect import (
    FLT_MAX,
    MISS,
    Intersections,
    closer_hit,
    transform_dir,
    transform_point,
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
)
from .sweep import _mesh_intersect_naive, intersect_scene
from .vec import Vec3, take as vtake, where as vwhere


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
    fro = torch.sqrt(
        inv[0, 0] * inv[0, 0] + inv[0, 1] * inv[0, 1] + inv[0, 2] * inv[0, 2]
        + inv[1, 0] * inv[1, 0] + inv[1, 1] * inv[1, 1] + inv[1, 2] * inv[1, 2]
        + inv[2, 0] * inv[2, 0] + inv[2, 1] * inv[2, 1] + inv[2, 2] * inv[2, 2]
    )
    bound = torch.where(t_a > 0, t_a * fro, FLT_MAX)
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
    """#8, plain: for each candidate lane and each mesh geom it is a
    candidate of, `mesh_intersect_bvh` (or the naive sweep without
    `use_bvh`), the winners merged in geom order with the min-t rule.
    Lanes that are no candidate get no hit (t = -1), as do candidates
    that hit no triangle.

    probe: a dict that, when given, receives the walk's work per
    candidate lane, summed over the geoms walked (for kernel #8's bound):
    `walks` (geom walks), `nodes` (nodes tested) and `tris` (triangles
    tested), each (count,) int64."""
    P = origins.x.shape[0]
    device = origins.x.device
    n = int(cands.count[0])
    idx = cands.lanes[:n].to(torch.int64)
    o, d, ta = vtake(origins, idx), vtake(dirs, idx), cands.t[idx]
    best = _miss(n, device)
    work = {k: torch.zeros(n, dtype=torch.int64, device=device)
            for k in ("walks", "nodes", "tris")}
    for g in scene.mesh_geoms:
        sel = torch.nonzero(mesh_candidacy(scene, g, o, d, ta))[:, 0]
        sub = {}
        if use_bvh:
            t, nrm, out, tu, tv = mesh_intersect_bvh(
                scene, g, vtake(o, sel), vtake(d, sel), probe=sub)
        else:
            t, nrm, out, tu, tv = _mesh_intersect_naive(
                scene, g, vtake(o, sel), vtake(d, sel))
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
        for k in ("nodes", "tris"):
            if k in sub:
                work[k][sel] += sub[k]
    if probe is not None:
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


# ---- launch plumbing -------------------------------------------------------

def _mesh_tables(scene: DeviceScene, tables, device):
    """(tables, table pointers, mesh pointers) for the mesh kernels."""
    t, tptr = _tables_for(scene, tables, device)
    if t.mesh is None or len(t.mesh) != 5:
        raise ValueError("the mesh kernels need tables packed from a mesh "
                         "scene (pack_scene_tables)")
    T = scene.tri_v0.x.shape[0]
    B = scene.bvh_first.shape[0]
    for name, a, dtype, shape in zip(
        ("mesh.tri", "mesh.attr", "mesh.box", "mesh.node", "mesh.geoms"), t.mesh,
        (torch.float32, torch.float32, torch.float32, torch.int32, torch.int32),
        ((T, 12), (T, 16), (B, 8), (B, 4), (len(scene.mesh_geoms), 4)),
    ):
        _check_tensor(a, name, dtype, shape, device)
    return t, tptr, _ptrs(list(t.mesh))


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

def mesh_candidates(origins: Vec3, dirs: Vec3, alive, scene: DeviceScene,
                    num_alive: torch.Tensor | None = None,
                    all_lanes: bool = False,
                    tables: SceneTables | None = None) -> Candidates:
    """#7 over the rays (origins, dirs) with `alive` (int32 or bool (P,),
    or None for all alive). With `num_alive` (an int32 scalar tensor on
    the device; live lanes first) lanes at or past it are skipped; with
    `all_lanes` dead lanes get their analytic hit too (the intersect
    route), else #7 writes nothing for them. CPU: the plain version (which
    fills every lane); CUDA: one launch, counted in
    `mesh_candidates.launches`."""
    device = origins.x.device
    if device.type == "cpu":
        return mesh_candidates_reference(origins, dirs, alive, scene, num_alive)
    _require_cuda(device, "mesh_candidates")
    P = origins.x.shape[0]
    rays = _rays(origins, dirs, P, device)
    if alive is not None:
        alive = alive.to(torch.int32).contiguous()
        _check_tensor(alive, "alive", torch.int32, (P,), device)
    if num_alive is not None:
        _check_tensor(num_alive.reshape(1), "num_alive", torch.int32, (1,), device)
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


def mesh_sweep(origins: Vec3, dirs: Vec3, cands: Candidates,
               scene: DeviceScene, tables: SceneTables | None = None,
               use_bvh: bool = True) -> Intersections:
    """#8: the mesh winner of each candidate lane of `cands` (#7's
    output), as Intersections lanes written at the lane's own index; the
    other lanes are not written (the kernel) or hold no hit (the plain
    version). `use_bvh` selects the plain version's traversal; the kernel
    always walks the BVH. CPU: the plain version; CUDA: one launch sized
    by the pool, counted in `mesh_sweep.launches`."""
    device = origins.x.device
    if device.type == "cpu":
        return mesh_sweep_reference(origins, dirs, cands, scene, use_bvh)
    _require_cuda(device, "mesh_sweep")
    P = origins.x.shape[0]
    rays = _rays(origins, dirs, P, device)
    _check_hits(cands, P, device)
    _check_tensor(cands.lanes, "lanes", torch.int32, (P,), device)
    _check_tensor(cands.count, "count", torch.int32, (1,), device)
    t, tptr, mptr = _mesh_tables(scene, tables, device)
    out = _new_hits(P, device)
    dev_index, stream = _device_args(device)
    _launch(
        "pt_mesh_sweep", "mesh_sweep",
        tptr, len(scene.gtypes), mptr, len(scene.mesh_geoms),
        _ptrs(rays + [None]), cands.t.data_ptr(), cands.lanes.data_ptr(),
        cands.count.data_ptr(), P, _ptrs(_hit_lanes(out)), dev_index, stream,
    )
    mesh_sweep.launches += 1
    return out


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
    if device.type == "cpu":
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


def intersect_mesh(cands: Candidates, hits: Intersections) -> Intersections:
    """#10: the merged Intersections of every lane (dead lanes keep their
    analytic hit). CPU: the plain version (`merge_hits`); CUDA: one
    launch, counted in `intersect_mesh.launches`."""
    device = cands.t.device
    if device.type == "cpu":
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


# ---- the chains ------------------------------------------------------------

def bounce_step_pipeline(state, scene: DeviceScene, iteration: int,
                         depth: int, settings,
                         num_alive: torch.Tensor | None = None,
                         tables: SceneTables | None = None):
    """One bounce of the mesh path over the pool, IN PLACE: #7 -> #8 ->
    #9 (the JAX package's `bounce_step_pipeline`, K1 -> K2 -> K3). No
    host sync on CUDA. The tables are packed once here unless given."""
    check_supported(scene, settings)
    if tables is None and scene.device.type == "cuda":
        tables = pack_scene_tables(scene)
    origins, dirs = state[0], state[1]
    cands = mesh_candidates(origins, dirs, state[4], scene, num_alive=num_alive,
                            tables=tables)
    hits = mesh_sweep(origins, dirs, cands, scene, tables=tables,
                      use_bvh=settings.use_bvh)
    return bounce_step_mesh(state, cands, hits, scene, iteration, depth,
                            settings, num_alive=num_alive, tables=tables)


def intersect_pipeline(origins: Vec3, dirs: Vec3, alive, scene: DeviceScene,
                       tables: SceneTables | None = None,
                       use_bvh: bool = True) -> Intersections:
    """`intersect_scene` for a mesh scene through #7 -> #8 -> #10 (the JAX
    package's `intersect_pipeline`): the same Intersections contract, dead
    lanes (`alive`, None for all alive) with their analytic hit."""
    if tables is None and scene.device.type == "cuda":
        tables = pack_scene_tables(scene)
    # contiguous once here, not once in each of #7 and #8
    origins = Vec3(*(a.contiguous() for a in origins))
    dirs = Vec3(*(a.contiguous() for a in dirs))
    cands = mesh_candidates(origins, dirs, alive, scene, all_lanes=True,
                            tables=tables)
    hits = mesh_sweep(origins, dirs, cands, scene, tables=tables,
                      use_bvh=use_bvh)
    return intersect_mesh(cands, hits)


mesh_candidates.launches = 0
mesh_sweep.launches = 0
bounce_step_mesh.launches = 0
intersect_mesh.launches = 0
