"""C's traversal order on Hopper (csrc/sorted.cu `window_sweep_kernel`),
modelled in plain PyTorch and held bit for bit against the unchanged plain
version (`window_sweep_reference`).

The kernel gives each entry one warp: lane c slab-tests chunk box c of a
super against the running best t, a ballot lists the chunks entered, and
each of them in ascending order is one Moller-Trumbore step with lane x
on triangle x, whose winner is the least t's bit pattern (a min-reduction
of positive floats as unsigned ints) at the lowest lane that holds it,
taken if strictly below the carry. A tail entry first culls each super
from its start on by the super's box against the running t (lanes over
supers), unless a reciprocal of its direction is infinite. `warp_model`
is that order, op for op, over the kernel's lane-major tables
(`pack_sweep_tables`); the tests feed it and the plain version the
same sorted streams (mesh.txt forced onto the sorted route, and mesh_big)
at 32x32 plus seeded object-space rays, for E in {6, 2, 1}, and compare
(t, triangle, u, v) exactly. Two properties the kernel rests on are held
on their own: positive floats order as their bits, and on mesh_big's
tables a chunk box entered before a bound puts its super box there too.
"""

import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
from project3_cuda_path_tracer_tpu_torch.ops.intersect import FLT_MAX, RAY_EPS
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
INF_BITS = 0x7F800000  # +inf: above every hit's t bits, as in the kernel
LANES = 32  # MESH_CHUNK triangles and MESH_SUPER chunk boxes: one per lane


def _load(name, res=(32, 32)):
    s = tscene.load_scene(os.path.join(SCENES, name))
    c = s.state.camera
    s.state.camera = tscene.derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance)
    return tdevice.scene_to_device(s, "cpu"), tdevice.camera_to_device(s.state.camera, "cpu")


@pytest.fixture(scope="module")
def scenes():
    """{name: (DeviceScene, DeviceCamera)} at 32x32 on the CPU, each loaded
    once (mesh_big builds its BVH in a few seconds)."""
    return {name: _load(name) for name in ("mesh.txt", "mesh_big.txt")}


def _span(rows, o, inv):
    """The slab interval (tmin, tmax) of rays against boxes given as rows
    (..., 8) [min xyz, max xyz, 0, 0] (broadcast against the rays' (3, ...)
    origins and reciprocal directions), as the kernel's slab_span."""
    t1 = [(rows[..., k] - o[k]) * inv[k] for k in range(3)]
    t2 = [(rows[..., 3 + k] - o[k]) * inv[k] for k in range(3)]
    lo = [torch.minimum(a, b) for a, b in zip(t1, t2)]
    hi = [torch.maximum(a, b) for a, b in zip(t1, t2)]
    return (torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]),
            torch.minimum(torch.minimum(hi[0], hi[1]), hi[2]))


def _bits(t):
    return t.view(torch.int32).to(torch.int64)


def mt_edges(v0, e1, e2, o, d):
    """`triangle_intersect`'s Moller-Trumbore on a corner and two edges
    given (the kernel's operands): (t, u, v, valid), t = FLT_MAX where
    invalid."""
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o - v0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    valid = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > RAY_EPS)
    return torch.where(valid, t, FLT_MAX), u, v, valid


def warp_model(key, q, scene, g):
    """The kernel's sweep of m entries with keys `key` (m,) and object-space
    rays `q` (6, m), vectorised over the entries and stepped as one warp
    steps, from C's lane-major tables (`pack_sweep_tables`): super by
    super (a tail's culled by its box first), each super's chunk boxes in
    ascending order culled at the running t, each entered chunk reduced
    over its 32 lanes by the least t bits and the lowest lane. Returns (t,
    triangle int32, u, v), each (m,)."""
    tris, boxes = tpipe.pack_sweep_tables(scene)
    r = tpipe._geom_rows(scene, g)
    sn, ss, cs, cn = r["n_supers"], r["super_start"], r["chunk_start"], r["n_chunks"]
    ts, tc = r["tri_start"], r["tri_count"]
    m = key.shape[0]
    key = key.to(torch.int64)
    o, d = q[0:3], q[3:6]
    inv = 1.0 / d
    tail = key >= sn
    first = torch.where(tail, key - sn, key)
    cull = tail & torch.isfinite(inv).all(0)
    bt = torch.full((m,), FLT_MAX, dtype=torch.float32)
    best = torch.full((m,), -1, dtype=torch.int64)
    bu = torch.zeros(m, dtype=torch.float32)
    bv = torch.zeros(m, dtype=torch.float32)
    lane = torch.arange(LANES)
    for s in range(sn):
        tmin, tmax = _span(scene.mesh_super_aabbs[ss + s], o, inv)
        s_in = (tmax >= tmin) & (tmax > 0) & (tmin < bt)
        act = torch.where(tail, (first <= s) & (~cull | s_in), key == s)
        sel = torch.nonzero(act)[:, 0]
        if sel.shape[0] == 0:
            continue
        so, sd, sinv = o[:, sel], d[:, sel], inv[:, sel]
        c_min, c_max = _span(boxes[ss + s].T[:, None], so, sinv)  # (lane c, entries)
        c_in = (c_max >= c_min) & (c_max > 0)
        for c in range(min(LANES, cn - s * LANES)):
            entered = c_in[c] & (c_min[c] < bt[sel])
            real = (s * LANES + c) * LANES + lane < tc  # each lane's triangle
            w = tris[cs + s * LANES + c]  # (9, lanes)
            col = lambda k: Vec3(*(w[k + i][:, None] for i in range(3)))  # noqa: E731
            t, u, v, hit = mt_edges(col(0), col(3), col(6), Vec3(*so[:, None]),
                                    Vec3(*sd[:, None]))
            bits = torch.where(hit & real[:, None] & entered[None], _bits(t), INF_BITS)
            least = bits.min(0).values
            win = (bits == least[None]).to(torch.int8).argmax(0)  # the lowest lane
            better = least < _bits(bt[sel])
            pick = lambda a: a.gather(0, win[None])[0]  # noqa: E731
            upd = sel[better]
            bt[upd] = least[better].to(torch.int32).view(torch.float32)
            best[upd] = ts + (s * LANES + c) * LANES + win[better]
            bu[upd] = pick(u)[better]
            bv[upd] = pick(v)[better]
    return bt, best.to(torch.int32), bu, bv


def seeded_keys(scene, g, n, E, seed):
    """SuperKeys of n seeded object-space rays around geom g's object box:
    origins in a box three times its size, directions aimed inside it
    (every twentieth with an exact zero component, so an infinite
    reciprocal), bounds from FLT_MAX to short of the box, a tenth dead."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.mesh_obj_aabbs[g][:3])
    hi = np.asarray(scene.mesh_obj_aabbs[g][3:])
    c, h = (lo + hi) / 2, (hi - lo) / 2
    o = c + rng.uniform(-3, 3, (n, 3)) * h
    d = c + rng.uniform(-1, 1, (n, 3)) * h - o
    d[::20, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bt = np.where(rng.uniform(size=n) < 0.5, np.float32(FLT_MAX),
                  rng.uniform(0.5, 4, n) * np.linalg.norm(h))
    bt[rng.uniform(size=n) < 0.1] = -FLT_MAX
    q = torch.tensor(np.concatenate([o, d], axis=1).astype(np.float32).T)
    bt = torch.tensor(bt.astype(np.float32))
    ss, sn = scene.super_ranges[g]
    keys = tpipe.super_rank(tuple(q), bt, scene.mesh_super_aabbs[ss:ss + sn], E)
    real = keys[keys < 2 * sn].to(torch.int64)
    return tpipe.SuperKeys(keys, q, bt,
                           torch.bincount(real, minlength=2 * sn).to(torch.int32))


def camera_keys(scene, cam, g, E):
    """A's plain SuperKeys of the 32x32 AA camera rays of iteration 1 (the
    plain route's depth 0), every lane listed."""
    o, d, _ = generate_rays(cam, 1, True, False)
    cands = tpipe.mesh_candidates_reference(o, d, None, scene)
    hits = tpipe.mesh_sweep_reference(o, d, cands, scene)
    sk = tpipe.super_keys_reference(o, d, cands, hits, scene, g, E)
    n = int(cands.count[0])
    return tpipe.SuperKeys(sk.keys[:, :n], sk.rays[:, :n], sk.bt0[:n], sk.hist)


def joined_stream(scene, cam, g, E):
    """B's plain stream over the camera lanes and 2048 seeded lanes side by
    side, with their SuperKeys."""
    a, b = camera_keys(scene, cam, g, E), seeded_keys(scene, g, 2048, E, seed=E)
    sk = tpipe.SuperKeys(torch.cat([a.keys, b.keys], 1), torch.cat([a.rays, b.rays], 1),
                         torch.cat([a.bt0, b.bt0]), a.hist + b.hist)
    count = torch.tensor([sk.keys.shape[1]], dtype=torch.int32)
    return sk, tpipe.place_entries_reference(sk, count)


@pytest.mark.parametrize("E", [6, 2, 1])
@pytest.mark.parametrize("name", ["mesh.txt", "mesh_big.txt"])
def test_warp_order_matches_plain_sweep(scenes, monkeypatch, name, E):
    """The warp order's (t, triangle, u, v) bit for bit the plain C's, per
    entry, on window and tail entries (E = 1 and 2 make most of a lane's
    entries tails); mesh.txt's icosphere forced onto the sorted route."""
    monkeypatch.setattr(tpipe, "SORT_SUPER_MIN_TRIS", 0)
    scene, cam = scenes[name]
    (g,) = tpipe.sorted_geoms(scene)
    sn = scene.super_ranges[g][1]
    sk, st = joined_stream(scene, cam, g, E)
    m = int(st.total[0])
    P = sk.keys.shape[1]
    key = st.key[:m]
    tails = int((key >= sn).sum())
    assert tails < m and tails > (m // 4 if E < 6 else 0 if sn > E else -1)
    want = tpipe.window_sweep_reference(st, sk, scene, g)
    ids = st.entry[:m].to(torch.int64)
    got = warp_model(key, sk.rays[:, ids % P], scene, g)
    for a, b in zip(got, want):
        b = b.reshape(-1)[ids]
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (want.t.reshape(-1)[ids] < FLT_MAX).float().mean() > 0.2  # entries hit


def test_positive_float_bits_order_as_floats():
    """The kernel's chunk winner is the least unsigned t bit pattern: for
    non-negative floats, ties, FLT_MAX and +inf (a lane with no hit)
    included, that order is the floats' order."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(0, 1e3, 4000), rng.uniform(0, 1e-3, 1000),
        np.exp(rng.uniform(-80, 80, 2000)),
        [0.0, 1e-45, 1.17549435e-38, 1e-4, 1.0, 1.0, FLT_MAX, np.inf],
    ]).astype(np.float32)
    x = np.concatenate([x, x[:500]])  # ties
    bits = x.view(np.uint32)
    assert bits[np.isinf(x)].min() == INF_BITS
    np.testing.assert_array_equal(np.argsort(bits, kind="stable"),
                                  np.argsort(x, kind="stable"))
    a, b = rng.choice(x, 20000), rng.choice(x, 20000)
    np.testing.assert_array_equal(a.view(np.uint32) < b.view(np.uint32), a < b)


def test_super_box_holds_its_chunks(scenes):
    """The exactness of the tail's super cull on mesh_big's tables: for
    seeded rays with finite reciprocals and bounds, every chunk box entered
    before the bound has its super box entered before it too."""
    scene, _ = scenes["mesh_big.txt"]
    (g,) = scene.mesh_geoms
    ss, sn = scene.super_ranges[g]
    cs, cn = scene.chunk_ranges[g]
    sk = seeded_keys(scene, g, 512, 6, seed=11)
    keep = torch.isfinite(1.0 / sk.rays[3:6]).all(0)
    q, bt = sk.rays[:, keep], sk.bt0[keep]
    o, inv = q[0:3], 1.0 / q[3:6]
    c_min, c_max = _span(scene.mesh_chunk_aabbs[cs:cs + cn, None], o, inv)  # (cn, rays)
    s_min, s_max = _span(scene.mesh_super_aabbs[ss:ss + sn, None], o, inv)
    c_in = (c_max >= c_min) & (c_max > 0) & (c_min < bt)
    s_in = (s_max >= s_min) & (s_max > 0) & (s_min < bt)
    owner = torch.arange(cn) // LANES
    assert bool(c_in.any())
    assert not bool((c_in & ~s_in[owner]).any())
