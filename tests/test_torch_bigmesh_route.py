"""The big-mesh route on mesh.txt (five supernodes), forced onto it by the
module constants: C's plain version (`window_sweep_reference`) against
the JAX package's #11 `_window_sweep` (Pallas in interpret mode) over the
same sorted stream, for E in {6, 2, 1}; and the whole plain route
(`intersect_pipeline` through A -> B -> C -> D) against the JAX package's
XLA `intersect_scene_any`, at E = 6 and at the tail-heavy E = 2, under the
lane rule of tests/test_megakernel.py:57-76 (at most 1% of lanes off by
more than 1e-4).

The JAX side's own sorted route is not run whole here: one 32x32 call of
its `intersect_pipeline` in interpret mode takes about five minutes on the
CPU. Its pieces are held one by one (A and B in
tests/test_torch_bigmesh_tables.py, C here), and the JAX package's own
tests hold its sorted route bit-identical to its dense one
(tests/test_radix.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu.ops import pipeline as jpipe
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
from tests.test_torch_mesh_intersect import (
    MESH_GEOM,
    assert_isect_close,
    assert_lane_rule,
    both_mesh_scenes,
    mesh_rays,
)
from tests.test_torch_ops import jv, tv


@pytest.fixture
def forced(monkeypatch):
    """mesh.txt's 5,120-triangle geom on the sorted route."""
    monkeypatch.setattr(tpipe, "SORT_SUPER_MIN_TRIS", 0)
    return monkeypatch


def plain_route(o, d, E):
    """The port's plain A -> B -> C of the icosphere over `o`, `d`: (the
    candidates, #8's hits, A's keys, B's stream, C's entry hits)."""
    _, td, _, _ = both_mesh_scenes()
    cands = tpipe.mesh_candidates_reference(o, d, None, td)
    hits = tpipe.mesh_sweep_reference(o, d, cands, td)
    sk = tpipe.super_keys_reference(o, d, cands, hits, td, MESH_GEOM, E)
    st = tpipe.place_entries_reference(sk, cands.count)
    eh = tpipe.window_sweep_reference(st, sk, td, MESH_GEOM)
    return cands, hits, sk, st, eh


def jax_window_sweep(st, sk, n_supers):
    """`_window_sweep` (interpret mode) over the port's sorted stream,
    padded to whole 8-row blocks with dead entries, as
    `_sorted_mesh_merge`'s windows_sweep lays it out: per entry (t, the
    winner's interpolated normal (3,)) in stream order."""
    jd, _, _, _ = both_mesh_scenes()
    m = int(st.total[0])
    P = sk.keys.shape[1]
    rows = max(8, -(-m // 1024) * 8)
    N = rows * jpipe.LANE
    key = np.full(N, 2 * n_supers, np.int32)
    key[:m] = st.key[:m].numpy()
    q = np.zeros((6, N), np.float32)
    q[5] = 1.0
    q[:, :m] = sk.rays[:, st.entry[:m].long() % P].numpy()
    key_j = jnp.asarray(key)
    bins = jnp.arange(2 * n_supers, dtype=jnp.int32)
    lo = jnp.searchsorted(key_j, bins, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(key_j, bins, side="right").astype(jnp.int32)
    blk = 8 * jpipe.LANE
    qstk = jnp.concatenate([jnp.asarray(a).reshape(rows, jpipe.LANE) for a in q],
                           axis=1)
    bstk = jnp.concatenate(
        [jnp.full((rows, jpipe.LANE), jmk.FLT_MAX, jnp.float32),
         jnp.zeros((rows, 3 * jpipe.LANE), jnp.float32)], axis=1)
    tables = jmk._pack_scene_tables(jd)
    out = np.asarray(jpipe._window_sweep(
        lo // blk, (hi + blk - 1) // blk, lo, hi, qstk, bstk, tables[5],
        tables[6], jd.mesh_attr_slabs, jmk._mesh_meta(jd)[MESH_GEOM], True,
        False, False))
    cols = out.reshape(rows, 4, jpipe.LANE).transpose(1, 0, 2).reshape(4, -1)
    return cols[0, :m], cols[1:, :m]


def lane_winners(t, entry, P):
    """Per lane, the stream place of its winning entry (least t, slot
    order on ties; -1 for none) and its t."""
    lane, slot = entry % P, entry // P
    best = np.full(P, np.float32(tpipe.FLT_MAX))
    arg = np.full(P, -1)
    for e in np.lexsort((slot, lane)):
        if t[e] < best[lane[e]]:
            best[lane[e]], arg[lane[e]] = t[e], e
    return best, arg


@pytest.mark.parametrize("E", [6, 2, 1])
def test_window_sweep_matches_jax(forced, E):
    """C against #11 per lane: the JAX window sweep tests a block's
    entries against every supernode whose window shares the block, which
    changes an entry's own result but no lane's after the merge and the
    bt0 filter (the JAX package's exactness argument). So the lanes'
    winners are compared: hit flags on all but 0.1% of the lanes, t and the
    interpolated normal by the lane rule."""
    _, td, _, _ = both_mesh_scenes()
    o, d = mesh_rays(1024, seed=7)
    cands, _, sk, st, eh = plain_route(tv(o), tv(d), E)
    sn = td.super_ranges[MESH_GEOM][1]
    m = int(st.total[0])
    P = sk.keys.shape[1]
    n = int(cands.count[0])
    entry = st.entry[:m].long().numpy()
    assert (st.key[:m].numpy() >= sn).mean() > (0.3 if E < 6 else -1)
    jt, jn = jax_window_sweep(st, sk, sn)
    mine = eh.t.reshape(-1).numpy()[entry]
    jb, ja = lane_winners(jt, entry, P)
    mb, ma = lane_winners(mine, entry, P)
    bt0 = sk.bt0.numpy()
    jhit = ((jb < tpipe.FLT_MAX) & (jb < bt0))[:n]
    mhit = ((mb < tpipe.FLT_MAX) & (mb < bt0))[:n]
    assert (jhit != mhit).mean() <= 0.001
    assert jhit.mean() > 0.5
    both = np.nonzero(jhit & mhit)[0]
    assert_lane_rule([mb[both]], [jb[both]])
    me = ma[both]
    tri = eh.tri.reshape(-1).numpy()[entry][me]
    u = eh.u.reshape(-1).numpy()[entry][me]
    v = eh.v.reshape(-1).numpy()[entry][me]
    w = 1.0 - u - v
    corner = lambda c: np.stack([a.numpy() for a in c], 1)[tri]  # noqa: E731
    nrm = (w[:, None] * corner(td.tri_n0) + u[:, None] * corner(td.tri_n1)
           + v[:, None] * corner(td.tri_n2))
    assert_lane_rule(list(nrm.T), list(jn[:, ja[both]]))


@pytest.mark.parametrize("E", [6, 2])
def test_sorted_intersect_matches_jax_xla(forced, E):
    """The plain #7 -> #8 -> A -> B -> C -> D -> #10 against the JAX
    `intersect_scene_any` on its XLA path (the BVH walk), on the 32x32
    camera rays and seeded rays aimed at the mesh, a fifth of the lanes
    dead; bit-equal to the port's own dense route on the live lanes. No
    kernel launch is counted on CPU tensors."""
    forced.setattr(tpipe, "SORT_EXPAND", E)
    jd, td, jc, _ = both_mesh_scenes()
    from project3_cuda_path_tracer_tpu.ops.camera import generate_rays as jgen

    co, cd, _ = jgen(jc, jnp.int32(1), True, False)
    o, d = mesh_rays(1024, seed=8)
    o = np.concatenate([np.stack([np.asarray(c) for c in co], 1), o])
    d = np.concatenate([np.stack([np.asarray(c) for c in cd], 1), d])
    alive = np.random.default_rng(9).uniform(size=o.shape[0]) < 0.8
    jset = jrender.RenderSettings(use_pallas=False)
    want = jax.jit(jrender.intersect_scene_any, static_argnames="settings")(
        jv(o), jv(d), jd, jset, alive=jnp.asarray(alive))
    route = ("super_keys", "place_entries", "window_sweep", "merge_entries")
    before = [getattr(tpipe, k).launches for k in route]
    got = tpipe.intersect_pipeline(tv(o), tv(d), torch.tensor(alive), td)
    assert before == [getattr(tpipe, k).launches for k in route]
    live = torch.tensor(alive)
    from project3_cuda_path_tracer_tpu.ops import intersect as jisect
    from project3_cuda_path_tracer_tpu_torch.ops import intersect as tisect

    sub = lambda i, msk: tisect.Intersections(  # noqa: E731
        i.t[msk], Vec3(*(c[msk] for c in i.normal)), i.material_id[msk],
        i.outside[msk], i.tex_u[msk], i.tex_v[msk], i.has_uv[msk])
    jsub = lambda i, msk: jisect.Intersections(  # noqa: E731
        i.t[msk], tuple(c[msk] for c in i.normal), i.material_id[msk],
        i.outside[msk], i.tex_u[msk], i.tex_v[msk], i.has_uv[msk])
    assert_isect_close(sub(got, live), jsub(want, alive))
    assert (got.material_id[live] == 4).float().mean() > 0.3  # the mesh is hit
    forced.setattr(tpipe, "SORT_SUPER_MIN_TRIS", 2**31)
    dense = tpipe.intersect_pipeline(tv(o), tv(d), torch.tensor(alive), td)
    for a, b in zip((got.t, *got.normal), (dense.t, *dense.normal)):
        assert torch.equal(a[live], b[live])
