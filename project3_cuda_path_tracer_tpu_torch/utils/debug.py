"""Debug-mode nets (--debug, --debug-nans): the counterpart of the JAX
package's utils/debug.py.

The CUDA reference's always-on sanitizer is checkCUDAError: a
cudaDeviceSynchronize + cudaGetLastError after every kernel launch. The
JAX package has three nets; here they are, for CUDA and PyTorch, which
neither clamp an index as XLA does nor trap one:

1. `bounds_sweep(renderer)` (--debug, once at startup), the counterpart
   of `checkify_sweep`, in three parts:
   (a) `validate_tables`: every index a kernel reads raw from a table
       (the geoms' material ids, the materials' texture and bump ids, each
       mesh geom's triangle range, the binary and wide BVHs' children and
       leaf ranges, the chunk and supernode tables, the light geom ids)
       checked on the host to lie within its table;
   (b) one iteration of `trace_paths` exactly as the renderer runs it,
       under `index_checks`: a TorchFunctionMode that range-checks the
       index of every gather and scatter of the glue and raises
       IndexError naming the op and the port's file:line that called it;
   (c) the same iteration under `checks(launches=True)`.
2. `checks(launches=...)` (--debug, the whole run): after every kernel
   launch (ops/megakernel.py::_launch, the one choke point) the card is
   synchronised and its error read; a failure raises naming the kernel.
   `assert_finite(accum, iteration)` (--debug, each logging chunk): the
   accumulator's finite check, the JAX function's message.
3. `checks(nans=...)` (--debug-nans, the counterpart of jax_debug_nans):
   each wrapper (`stage`) checks its outputs after the call, the kernel's
   or its plain version's, on the lanes its contract defines; a NaN
   raises FloatingPointError naming the stage, the output and its count
   of NaN lanes. Then, as JAX re-runs the failing call op by op, the same
   call's plain version re-runs on a clone of its inputs taken before the
   call, under a TorchDispatchMode that names the first aten op whose NaN
   reached the stage's output (and any input that already held NaN).

When both flags are off, a wrapper pays one attribute test and `_launch`
one more: no sync, no clone, no mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import os
import traceback
from dataclasses import dataclass

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.abspath(__file__)


@dataclass
class DebugState:
    """What the wrappers and `_launch` read: all off by default."""

    launches: bool = False  # sync and read the error after each launch
    nans: bool = False  # check each stage's outputs for NaN


STATE = DebugState()


@contextlib.contextmanager
def checks(launches: bool = False, nans: bool = False):
    """Turn the per-launch check and the NaN check on inside the block
    (the flags already on stay on), and back as they were after it."""
    old = dataclasses.replace(STATE)
    STATE.launches = STATE.launches or launches
    STATE.nans = STATE.nans or nans
    try:
        yield STATE
    finally:
        STATE.launches, STATE.nans = old.launches, old.nans


# ---- 2. the accumulator and the launches -------------------------------

def assert_finite(accum, iteration: int) -> None:
    """Raise if the radiance accumulator contains NaN/Inf (forces a
    device sync; debug mode only)."""
    for name, lane in (("R", accum.x), ("G", accum.y), ("B", accum.z)):
        arr = np.asarray(lane.detach().cpu()) if torch.is_tensor(lane) else np.asarray(lane)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"accumulator channel {name} has {bad} non-finite values "
                f"at iteration {iteration} (enable --debug-nans to locate "
                f"the producing op)"
            )


def check_launch(what: str, name: str) -> None:
    """checkCUDAError after one launch: wait for every card and read its
    error; raise naming the kernel."""
    try:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    except RuntimeError as e:
        raise RuntimeError(f"--debug: kernel {what} ({name}) failed after its "
                           f"launch: {e}") from e


# ---- where a call came from ----------------------------------------------

def port_site() -> str:
    """The three innermost frames of the port (this module left out) on
    the current stack, innermost first, as `file:line (function)`."""
    out = []
    for fr in reversed(traceback.extract_stack()):
        f = os.path.abspath(fr.filename)
        if f == _THIS or not f.startswith(_PKG_DIR + os.sep):
            continue
        out.append(f"{os.path.relpath(f, os.path.dirname(_PKG_DIR))}:{fr.lineno} "
                   f"({fr.name})")
        if len(out) == 3:
            break
    return " <- ".join(out) if out else "outside the port"


# ---- 1(a). the tables -------------------------------------------------------

def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _in_range(table: str, values, lo: int, hi: int, what: str = "") -> None:
    v = np.asarray(values).reshape(-1).astype(np.int64)
    bad = np.nonzero((v < lo) | (v >= hi))[0]
    if bad.size:
        i = int(bad[0])
        raise IndexError(
            f"validate_tables: {table}[{i}] = {int(v[i])} lies outside "
            f"[{lo}, {hi}){' ' + what if what else ''} ({bad.size} bad "
            f"entr{'y' if bad.size == 1 else 'ies'})"
        )


def validate_tables(scene, tables=None) -> None:
    """Check on the host that every index a kernel (or the plain versions'
    gathers) reads raw from a table of `scene` (a DeviceScene) and of its
    packed `tables` (SceneTables, or None) lies within that table; raise
    IndexError naming the table and the first bad entry."""
    from ..models.wide_bvh import WIDTH

    G = len(scene.gtypes)
    M = scene.mat_color.x.shape[0]
    T = scene.tri_v0.x.shape[0]
    B = scene.bvh_first.shape[0]
    C = scene.mesh_chunk_aabbs.shape[0]
    S = scene.mesh_super_aabbs.shape[0]
    n_tex, n_bump = scene.n_file_textures, scene.n_bump_textures

    _in_range("geom_material_id", _host(scene.geom_material_id), 0, M, "(materials)")
    kind = _host(scene.mat_tex_kind)
    _in_range("mat_tex_kind", kind, 0, 3, "(none, checker, file)")
    _in_range("mat_tex_id", _host(scene.mat_tex_id)[kind == 2], 0, n_tex,
              "(file textures of the atlas)")
    bump = _host(scene.mat_bump_id)
    _in_range("mat_bump_id", bump[bump != -1], 0, n_bump, "(bump maps of the atlas)")
    _in_range("emissive_geoms", scene.emissive_geoms, 0, G, "(geoms)")

    # each mesh geom: its triangles, its BVH nodes, its chunks and supernodes
    first, count = _host(scene.bvh_first), _host(scene.bvh_count)
    skip, leaf = _host(scene.bvh_skip), _host(scene.bvh_leaf)
    for g in scene.mesh_geoms:
        s, c = scene.tri_ranges[g]
        _in_range(f"tri_ranges[{g}] (start, end)", [s, s + c], 0, T + 1,
                  "(triangles)")
        n0, nn = scene.bvh_roots[g]
        if nn:
            _in_range(f"bvh_roots[{g}] (first, end)", [n0, n0 + nn], 0, B + 1,
                      "(BVH nodes)")
            sl = slice(n0, n0 + nn)
            _in_range(f"bvh_skip of geom {g}", skip[sl], n0 + 1, n0 + nn + 1,
                      "(the geom's nodes, or its end)")
            inner = ~leaf[sl].astype(bool)
            _in_range(f"bvh inner child of geom {g}",
                      (np.arange(n0, n0 + nn) + 1)[inner], n0, n0 + nn,
                      "(the geom's nodes)")
            lf = leaf[sl].astype(bool)
            _in_range(f"bvh_first of geom {g}'s leaves", first[sl][lf], s, s + c + 1,
                      "(the geom's triangles)")
            _in_range(f"bvh leaf end of geom {g}", (first[sl] + count[sl])[lf],
                      s, s + c + 1, "(the geom's triangles)")
        c0, cn = scene.chunk_ranges[g]
        s0, sn = scene.super_ranges[g]
        _in_range(f"chunk_ranges[{g}] (first, end)", [c0, c0 + cn], 0, C + 1,
                  "(chunk boxes)")
        _in_range(f"super_ranges[{g}] (first, end)", [s0, s0 + sn], 0, S + 1,
                  "(supernode boxes)")
        _in_range(f"chunk_ranges[{g}] count", [cn], -(-c // 32), -(-c // 32) + 1,
                  "(the geom's triangles in chunks of 32)")
        _in_range(f"super_ranges[{g}] count", [sn], -(-cn // 32), -(-cn // 32) + 1,
                  "(the geom's chunks in supernodes of 32)")

    if tables is None:
        return
    _in_range("tables.gmat", _host(tables.gmat), 0, M, "(materials)")
    _in_range("tables.lights", _host(tables.lights), 0, G, "(geoms)")
    surf = _host(tables.surf)
    mkind = _host(tables.mat)[:, 11]
    _in_range("tables.surf tex id", surf[mkind == 2, 0], 0, n_tex,
              "(file textures of the atlas)")
    bump_f = surf[:, 1]
    _in_range("tables.surf bump id", bump_f[bump_f != -1], 0, n_bump,
              "(bump maps of the atlas)")
    if tables.mesh is not None:
        geoms = _host(tables.mesh[3])
        _in_range("mesh.geoms geom index", geoms[:, 0], 0, G, "(geoms)")
        _in_range("mesh.geoms (first node, end)",
                  np.concatenate([geoms[:, 1], geoms[:, 1] + geoms[:, 2]]), 0, B + 1,
                  "(BVH nodes)")
    if tables.node is not None:
        node = _host(tables.node)
        _in_range("node skip", node[:, 2], 0, B + 1, "(BVH nodes, or the end)")
        lf = node[:, 3] != 0
        _in_range("node leaf (first, end)",
                  np.concatenate([node[lf, 0], node[lf, 0] + node[lf, 1]]), 0, T + 1,
                  "(triangles)")
    if tables.roots is not None:
        roots = _host(tables.roots)
        _in_range("roots (first node, end)",
                  np.concatenate([roots[:, 0], roots[:, 0] + roots[:, 1]]), 0, B + 1,
                  "(BVH nodes)")
    if tables.wide is not None:
        ref = _host(tables.wide.ref)
        N = ref.shape[0]
        inner = ref[:, 1, :] == 0
        leafc = ref[:, 1, :] > 0
        _in_range("wide.ref count", ref[:, 1, :], -1, WIDTH + 1,
                  "(-1 none, 0 inner, 1..WIDTH a leaf)")
        _in_range("wide.ref inner child", ref[:, 0, :][inner], 0, N, "(wide nodes)")
        _in_range("wide.ref leaf (first, end)",
                  np.concatenate([ref[:, 0, :][leafc],
                                  ref[:, 0, :][leafc] + ref[:, 1, :][leafc]]), 0, T + 1,
                  "(triangles)")
        _in_range("wide.root", _host(tables.wide.root), -1, N, "(wide nodes, -1 none)")
    if tables.sweep is not None:
        for name, a, rows in (("sweep.tris", tables.sweep[0], C),
                              ("sweep.boxes", tables.sweep[1], S)):
            _in_range(f"{name} rows", [a.shape[0]], rows, rows + 1,
                      "(the chunk and supernode tables)")


# ---- 1(b). the glue's gathers and scatters ---------------------------------

def _tensor_index_dims(x, idx):
    """The integer index tensors of `x[idx]` with the dim of x each one
    indexes."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis
                 and not (torch.is_tensor(i) and i.dtype == torch.bool))
    n_real += sum(i.dim() for i in idx if torch.is_tensor(i) and i.dtype == torch.bool)
    out, d = [], 0
    for i in idx:
        if i is None:
            continue
        if i is Ellipsis:
            d += x.dim() - n_real
            continue
        if torch.is_tensor(i):
            if i.dtype == torch.bool:
                d += i.dim()
                continue
            if not i.dtype.is_floating_point:
                out.append((i, d))
        d += 1
    return out


def _check_index(op: str, index, size: int, dim: int, negative: bool) -> None:
    if not torch.is_tensor(index) or index.numel() == 0:
        return
    lo = -size if negative else 0
    mn, mx = int(index.min()), int(index.max())
    if mn < lo or mx >= size:
        bad = mn if mn < lo else mx
        raise IndexError(
            f"{op}: index {bad} out of range [{lo}, {size}) of dim {dim} "
            f"at {port_site()}"
        )


def _check_call(func, args, kwargs) -> None:
    kwargs = kwargs or {}
    name = getattr(func, "__name__", str(func))
    if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
        x, idx = args[0], args[1]
        for i, d in _tensor_index_dims(x, idx):
            _check_index(f"Tensor.{name}", i, x.shape[d], d, True)
    elif func in (torch.Tensor.index_put_, torch.Tensor.index_put, torch.index_put):
        x = args[0]
        idx = args[1] if len(args) > 1 else kwargs["indices"]
        for i, d in _tensor_index_dims(x, tuple(idx)):
            _check_index(name, i, x.shape[d], d, True)
    elif func in (torch.take, torch.Tensor.take):
        x = args[0]
        index = args[1] if len(args) > 1 else kwargs["index"]
        _check_index(name, index, x.numel(), 0, True)
    elif func in (torch.index_select, torch.Tensor.index_select, torch.gather,
                  torch.Tensor.gather, torch.Tensor.index_add_, torch.index_add,
                  torch.Tensor.index_add, torch.Tensor.scatter_add_,
                  torch.scatter_add, torch.Tensor.scatter_add, torch.Tensor.scatter_,
                  torch.scatter, torch.Tensor.scatter):
        x = args[0]
        dim = args[1] if len(args) > 1 else kwargs["dim"]
        index = args[2] if len(args) > 2 else kwargs["index"]
        dim = dim + x.dim() if dim < 0 else dim
        _check_index(name, index, x.shape[dim], dim, False)


class index_checks(torch.overrides.TorchFunctionMode):
    """Inside the block, every gather and scatter with a tensor index
    (`Tensor.__getitem__`/`__setitem__` with integer tensor indices,
    `index_select`, `gather`, `take`, `index_add_`, `scatter_add_`,
    `scatter_`, `index_put_`) checks its index against the size of the dim
    it indexes first, and raises IndexError naming the op and the port's
    file:line that called it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        _check_call(func, args, kwargs)
        return func(*args, **(kwargs or {}))


def bounds_sweep(renderer) -> None:
    """The counterpart of the JAX package's `checkify_sweep`: (a)
    `validate_tables` on the renderer's scene and its tables (each shard's
    of a ShardedRenderer), (b) one iteration of `trace_paths` (and its
    radiance scatter) exactly as the renderer runs it, into a scratch
    accumulator, under `index_checks`, (c) with every kernel launch
    checked. Raises on the first fault; silent when clean."""
    from ..ops.vec import Vec3
    from ..render import _scatter_add, trace_paths

    groups = getattr(renderer, "groups", None)
    if groups is None:
        validate_tables(renderer.dev_scene, renderer.tables)
    else:
        for sh in {id(sh): sh for g in groups for p in g for sh in p}.values():
            validate_tables(sh.scene, sh.tables)
    with checks(launches=True), index_checks():
        if groups is None:
            radiance, pix, _, _ = trace_paths(
                renderer.dev_scene, renderer.dev_camera, 1, None, renderer.settings,
                False, tables=renderer.tables, count_alive=False)
            acc = Vec3.zeros(renderer.camera.pixel_count, renderer.device)
            _scatter_add(acc, pix, radiance)
        else:
            from ..parallel.shard import render_iteration_sharded

            accs = [Vec3(*(torch.zeros_like(c) for c in a)) for a in renderer.accums]
            render_iteration_sharded(renderer.groups, renderer.cameras, accs, 1,
                                     renderer.settings)


# ---- 3. NaNs: each stage's outputs ----------------------------------------

def _clone(v):
    """A copy of a call's tensors, deep through dicts, tuples, NamedTuples
    and lists; the scene, its tables and settings are read-only and
    shared."""
    from ..ops.megakernel import SceneTables

    if torch.is_tensor(v):
        return v.clone()
    if isinstance(v, SceneTables):
        return v
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_clone(x) for x in v))
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    return v


def _flat(prefix: str, v):
    """(name, tensor) of every tensor under v."""
    if torch.is_tensor(v):
        yield prefix, v
    elif isinstance(v, tuple) and hasattr(v, "_fields"):
        for f, x in zip(v._fields, v):
            yield from _flat(f"{prefix}.{f}", x)
    elif isinstance(v, (tuple, list)):
        for k, x in enumerate(v):
            yield from _flat(f"{prefix}[{k}]", x)
    elif isinstance(v, dict):
        for k, x in v.items():
            yield from _flat(f"{prefix}.{k}", x)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            yield from _flat(f"{prefix}.{f.name}", getattr(v, f.name))


def _scatter_mask(index, n: int, device):
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[index.to(torch.int64)] = True
    return m


def _listed(cands):
    """The candidate lanes of #7's list, as a (P,) mask."""
    n = int(cands.count.reshape(-1)[0])
    return _scatter_mask(cands.lanes[:n], cands.lanes.shape[0], cands.lanes.device)


def _first(n_valid, size: int, device):
    return torch.arange(size, device=device) < int(torch.as_tensor(n_valid).reshape(-1)[0])


def _pool(v, name="pool"):
    return [(f"{name}{n}", t, None) for n, t in _flat("", v[:4])]


def _outputs(stage: str, a: dict, out) -> list:
    """(name, tensor, mask of the lanes its contract defines, or None for
    all) of each floating output of a call of `stage`."""
    if stage in ("full_iteration", "full_iteration_nee"):
        return [(f"accum.{c}", t, None) for c, t in zip("xyz", a["accum"])]
    if stage in ("first_bounce", "bounce_step", "shade_step", "bounce_step_mesh",
                 "_nee_final_step"):
        return _pool(out)
    if stage == "bounce_step_nee":
        return _pool(out[0]) + [(f"aux[{k}]", t, None) for k, t in enumerate(out[1])]
    if stage == "mesh_candidates":
        P = out.t.shape[0]
        mask = None
        if not a.get("all_lanes"):
            from ..ops.pipeline import _live_mask

            mask = _live_mask(a["alive"], P, out.t.device, a.get("num_alive"))
        return [(n, t, mask) for n, t in _flat("cands", (out.t, *out.normal))]
    if stage in ("mesh_sweep", "merge_entries"):
        mask = _listed(a["cands"])
        return [(f"hits.{f}", t, mask) for f, t in
                (("t", out.t), ("normal.x", out.normal.x), ("normal.y", out.normal.y),
                 ("normal.z", out.normal.z), ("tex_u", out.tex_u), ("tex_v", out.tex_v))]
    if stage == "intersect_mesh":
        return [(f"isect.{f}", t, None) for f, t in
                (("t", out.t), ("normal.x", out.normal.x), ("normal.y", out.normal.y),
                 ("normal.z", out.normal.z))]
    if stage == "super_keys":
        P = out.bt0.shape[0]
        mask = _first(a["cands"].count, P, out.bt0.device)
        return [("sk.bt0", out.bt0, mask)] + [
            (f"sk.rays[{k}]", out.rays[k], mask) for k in range(6)]
    if stage == "window_sweep":
        st = a["st"]
        n = int(st.total.reshape(-1)[0])
        mask = _scatter_mask(st.entry[:n], out.t.numel(), out.t.device)
        return [(f"entry_hits.{f}", t.reshape(-1), mask)
                for f, t in (("t", out.t), ("u", out.u), ("v", out.v))]
    if stage == "radix_split":
        if not out.payload.dtype.is_floating_point:
            return []
        mask = _first(out.length, out.payload.shape[1], out.payload.device)
        return [(f"payload[{k}]", out.payload[k], mask) for k in range(out.payload.shape[0])]
    if stage == "window_sweep_stream":
        mask = _first(a["stream"].length, out.shape[1], out.device)
        return [(f"res[{k}]", out[k], mask) for k in (0, 2, 3)]  # row 1: int bits
    if stage == "radix_unscatter":
        st = a["stream"]
        n = int(st.length.reshape(-1)[0])
        mask = _scatter_mask(st.entry[:n], out.shape[1], out.device)
        rows = (0, 2, 3) if out.shape[0] == 4 else range(out.shape[0])
        return [(f"out[{k}]", out[k], mask) for k in rows if out.dtype.is_floating_point]
    return []


class _NanOrigins(torch.utils._python_dispatch.TorchDispatchMode):
    """Runs a call op by op: each aten op whose floating output holds a NaN
    is recorded; its NaN is marked on the output tensor with the first op
    that made a NaN among its inputs' marks, or with itself when no input
    carried a mark (so a NaN that reached the call's output leads back to
    the op that first produced it from NaN-free, or unmarked, inputs)."""

    def __init__(self):
        super().__init__()
        self.ops = []  # (op, site) in the order they first made a NaN

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for _, t in _flat("", out if isinstance(out, (tuple, list)) else (out,))]
        nan = [t for t in outs if t.dtype.is_floating_point and t.numel()
               and bool(torch.isnan(t).any())]
        if nan:
            ins = [t for _, t in _flat("", (args, kwargs or {})) if torch.is_tensor(t)]
            marks = [getattr(t, "_nan_origin", None) for t in ins]
            marks = [m for m in marks if m is not None]
            if marks:
                mark = min(marks)
            else:
                self.ops.append((str(func), port_site()))
                mark = len(self.ops) - 1
            for t in nan:
                try:
                    t._nan_origin = mark
                except (AttributeError, RuntimeError):
                    pass
        return out


def _force_plain(sig, a: dict) -> dict:
    a = dict(a)
    if "plain" in sig.parameters:
        a["plain"] = True
    elif "settings" in sig.parameters:
        a["settings"] = dataclasses.replace(a["settings"], plain=True)
    return a


def _nan_report(fn, sig, stage: str, before: dict, kind: str, name: str, bad: int) -> str:
    msg = (f"--debug-nans: stage {stage} ({kind}): output {name} has {bad} NaN "
           f"lane{'s' if bad != 1 else ''}")
    held = [n for n, t in _flat("", before) if t.dtype.is_floating_point and t.numel()
            and bool(torch.isnan(t).any())]
    if held:
        msg += f"; inputs already holding NaN: {', '.join(n.lstrip('.') for n in held[:6])}"
    mode = _NanOrigins()
    with mode:
        rerun = fn(**_force_plain(sig, before))
    origins = set()
    for n, t, mask in _outputs(stage, before, rerun):
        m = torch.isnan(t) if mask is None else torch.isnan(t) & mask
        if bool(m.any()) and getattr(t, "_nan_origin", None) is not None:
            origins.add(t._nan_origin)
    if origins:
        op, site = mode.ops[min(origins)]
        msg += f"; its plain version's first NaN reaching the output: {op} at {site}"
    elif mode.ops:
        op, site = mode.ops[0]
        msg += f"; its plain version's first NaN: {op} at {site}"
    else:
        msg += "; its plain version, re-run on the same inputs, makes no NaN"
    return msg


def stage(fn):
    """A wrapper's debug net (--debug-nans): with `STATE.nans` on, clone
    the call's inputs, make the call (kernel or plain version), and check
    its outputs on the lanes its contract defines; on a NaN re-run the
    plain version on the clone under `_NanOrigins` and raise
    FloatingPointError naming the stage, the kernel or plain version, the
    output, its NaN lanes and the aten op. Off, one attribute test."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not STATE.nans:
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        before = _clone(dict(bound.arguments))
        out = fn(*args, **kwargs)
        a = dict(bound.arguments)
        for name, t, mask in _outputs(fn.__name__, a, out):
            m = torch.isnan(t) if mask is None else torch.isnan(t) & mask
            bad = int(m.sum())
            if bad:
                from ..ops.megakernel import runs_plain

                dev = t.device
                plain = a.get("plain", False)
                if "settings" in a and not plain:
                    plain = a["settings"].plain
                kind = "plain version" if runs_plain(dev, plain) else "kernel"
                raise FloatingPointError(
                    _nan_report(fn, sig, fn.__name__, before, kind, name, bad))
        return out

    return wrapper
