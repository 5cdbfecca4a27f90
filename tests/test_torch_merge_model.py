"""Plain Python models, on the CPU, of how two kernels of the mesh path
read their inputs:

- D (`merge_entries`, csrc/sorted.cu): a listed lane's E slots are all
  loaded with no branch (each slot's key and t), the least t over the
  real slots (key below `dead`) is taken in slot order with a strict <,
  so a tie goes to the lowest slot, and only the winner's row of
  triangle, u and v is read, once; the hit rule is t < FLT_MAX and t <
  bt0. The kernel is instantiated for E = 1..PLACE_MAX_E. Held to a numpy
  transcription of the slot loop of the kernel before it (a dead slot
  skipped before its t is read, the winner's fields copied inside the
  loop) and to `merge_entries_reference`: the plain D over the E slots
  equals the plain D over the one slot the model picks. Cases: equal t in
  two real slots, dead keys in any slot (one holding the least t), t equal
  to bt0, and a count that cuts the pool, for every E in 1..8.
- #9 (`bounce_step_mesh`, csrc/mesh.cu): the merged hit decided from the
  candidacy flag and the two t alone (candidate, t_mesh > 0 and (t_a > 0
  ? t_a : FLT_MAX) > t_mesh), then each other field read from the
  winner's lanes only. Held to numpy's `mesh_wins` + `load_hit` of the
  kernel before it and to `pipeline.merge_hits` (the plain version) on
  t_a <= 0, t_mesh == t_a (the analytic hit wins), non-candidates and
  t_mesh <= 0.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.models.device import scene_to_device
from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.intersect import Intersections
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLT_MAX = np.float32(tpipe.FLT_MAX)
P = 301  # the pool
SUPERS = 9  # the geom's supernodes: keys 0 .. 2 * SUPERS - 1, dead = 2 * SUPERS
CASES = ["tie", "dead", "at_bound", "cut"]


def merge_model(keys, t, tri, u, v, bt0, count, dead):
    """D's merge of each listed lane j < count, as the kernel reads it:
    (hit, t, triangle, u, v, how many rows of tri/u/v it read) per lane."""
    E = keys.shape[0]
    out = []
    for j in range(count):
        key_row = [keys[e, j] for e in range(E)]  # every slot, no branch
        t_row = [t[e, j] for e in range(E)]
        bt, win = FLT_MAX, 0
        for e in range(E):  # slot order, strict <
            if key_row[e] < dead and t_row[e] < bt:
                bt, win = t_row[e], e
        if not (bt < FLT_MAX and bt < bt0[j]):
            out.append((False, bt, None, None, None, 0))
            continue
        out.append((True, bt, tri[win, j], u[win, j], v[win, j], 1))  # the winner's row once
    return out


def parent_loop(keys, t, tri, u, v, bt0, count, dead):
    """The kernel before: per slot, skip a dead one, else read its t and
    take the slot's fields when it is strictly less."""
    out = []
    for j in range(count):
        th = (FLT_MAX, 0, np.float32(0), np.float32(0))
        for e in range(keys.shape[0]):
            if keys[e, j] >= dead:
                continue
            if t[e, j] < th[0]:
                th = (t[e, j], tri[e, j], u[e, j], v[e, j])
        hit = th[0] < FLT_MAX and th[0] < bt0[j]
        out.append((hit, th[0], *(th[1:] if hit else (None, None, None))))
    return out


def merge_inputs(E, case, seed):
    """numpy inputs of D for one case: keys (E, P), t/tri/u/v (E, P), bt0
    (P,), the count."""
    rng = np.random.default_rng(seed)
    dead = 2 * SUPERS
    keys = rng.integers(0, dead + 1, (E, P)).astype(np.int32)  # some dead
    t = rng.uniform(0.5, 3.0, (E, P)).astype(np.float32)
    t[rng.random((E, P)) < 0.1] = FLT_MAX  # slots whose supers hold no hit
    tri = rng.integers(0, 5120, (E, P)).astype(np.int32)
    u = rng.uniform(0, 0.5, (E, P)).astype(np.float32)
    v = rng.uniform(0, 0.5, (E, P)).astype(np.float32)
    bt0 = rng.uniform(1.0, 4.0, P).astype(np.float32)
    count = P
    lanes = np.arange(P)
    if case == "tie" and E > 1:  # two real slots share the least t
        a, b = sorted(rng.choice(E, 2, replace=False))
        keys[[a, b]] = rng.integers(0, dead, (2, P))
        t[[a, b]] = np.float32(0.25)
    elif case == "dead":  # the least t sits in a dead slot
        e = rng.integers(0, E, P)
        keys[e, lanes] = dead
        t[e, lanes] = np.float32(0.01)
    elif case == "at_bound":  # the winner's t equals bt0: no hit
        keys[0] = rng.integers(0, dead, P)
        t[0] = np.float32(0.125)
        if E > 1:
            t[1:][t[1:] < 0.125] = np.float32(0.5)
        bt0[:] = np.float32(0.125)
    elif case == "cut":
        count = 173
    return keys, t, tri, u, v, bt0, count


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("E", range(1, tpipe.PLACE_MAX_E + 1))
def test_merge_model_matches_parent_loop(E, case):
    keys, t, tri, u, v, bt0, count = merge_inputs(E, case, seed=10 * E + CASES.index(case))
    dead = 2 * SUPERS
    got = merge_model(keys, t, tri, u, v, bt0, count, dead)
    want = parent_loop(keys, t, tri, u, v, bt0, count, dead)
    assert len(got) == count
    for g, w in zip(got, want):
        assert g[:5] == w
        assert g[5] == int(w[0])  # the winner's row read once, only on a hit
    hits = [g[0] for g in got]
    if case == "at_bound":
        assert not any(hits)
    if case == "tie" and E > 1:
        assert all(h for h in hits)  # 0.25 wins below every bt0 >= 1


@pytest.fixture(scope="module")
def mesh_scene():
    """mesh.txt on the CPU (its mesh geom's tables feed D's epilogue), and
    a copy whose mesh carries UVs."""
    ds = scene_to_device(load_scene(os.path.join(ROOT, "scenes", "mesh.txt")),
                         torch.device("cpu"))
    (g,) = ds.mesh_geoms
    rng = np.random.default_rng(7)
    uv = {name: torch.from_numpy(rng.random(ds.tri_uv0u.shape[0]).astype(np.float32))
          for name in ("tri_uv0u", "tri_uv0v", "tri_uv1u", "tri_uv1v", "tri_uv2u",
                       "tri_uv2v")}
    has_uv = tuple(True if k == g else h for k, h in enumerate(ds.mesh_has_uv))
    return g, {False: ds, True: dataclasses.replace(ds, mesh_has_uv=has_uv, **uv)}


def plain_d(ds, g, keys, t, tri, u, v, bt0, count, seed):
    """merge_entries_reference over these slots, on seeded lanes, rays and
    #8's hits: (the merged hits, the lanes listed)."""
    rng = np.random.default_rng(seed)
    lanes = rng.permutation(P).astype(np.int32)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    d = f(3, P)
    d = d / d.norm(dim=0)
    qd = f(3, P)
    qd = qd / qd.norm(dim=0)
    origins, dirs = Vec3(*f(3, P)), Vec3(*d)
    cands = tpipe.Candidates(
        t=torch.full((P,), -1.0), normal=Vec3(*torch.zeros(3, P)),
        material_id=torch.full((P,), -1, dtype=torch.int32),
        outside=torch.ones(P, dtype=torch.bool), cand=torch.ones(P, dtype=torch.bool),
        lanes=torch.from_numpy(lanes), count=torch.tensor([count], dtype=torch.int32))
    hit_t = torch.from_numpy(np.where(rng.random(P) < 0.5, -1.0,
                                      rng.uniform(0.5, 20.0, P)).astype(np.float32))
    hits = Intersections(hit_t, Vec3(*f(3, P)), torch.zeros(P, dtype=torch.int32),
                         torch.ones(P, dtype=torch.bool), torch.zeros(P), torch.zeros(P),
                         torch.zeros(P, dtype=torch.bool))
    sk = tpipe.SuperKeys(torch.from_numpy(keys), torch.cat([f(3, P), qd]),
                         torch.from_numpy(bt0), torch.zeros(2 * SUPERS, dtype=torch.int32))
    eh = tpipe.EntryHits(*(torch.from_numpy(a) for a in (t, tri, u, v)))
    out = tpipe.merge_entries_reference(origins, dirs, cands, hits, sk, eh, ds, g)
    return out, lanes[:count]


@pytest.mark.parametrize("has_uv", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("E", [1, 2, 6, 8])
def test_merge_model_matches_merge_entries_reference(mesh_scene, E, case, has_uv):
    """The plain D over E slots equals the plain D over the one slot the
    model picks (its key and (t, triangle, u, v); a dead key where it
    finds no hit), on every lane; lanes past the count untouched."""
    g, scenes = mesh_scene
    ds = scenes[has_uv]
    seed = 100 * E + CASES.index(case)
    keys, t, tri, u, v, bt0, count = merge_inputs(E, case, seed)
    dead = 2 * SUPERS
    model = merge_model(keys, t, tri, u, v, bt0, count, dead)
    one = [np.full((1, P), dead, np.int32), np.full((1, P), FLT_MAX, np.float32),
           np.zeros((1, P), np.int32), np.zeros((1, P), np.float32),
           np.zeros((1, P), np.float32)]
    for j, (hit, bt, wtri, wu, wv, _) in enumerate(model):
        if hit:
            one[0][0, j], one[1][0, j], one[2][0, j] = 0, bt, wtri
            one[3][0, j], one[4][0, j] = wu, wv
    got, listed = plain_d(ds, g, keys, t, tri, u, v, bt0, count, seed)
    want, _ = plain_d(ds, g, *one, bt0, count, seed)
    for a, b in zip((got.t, *got.normal, got.material_id, got.outside, got.tex_u,
                     got.tex_v, got.has_uv),
                    (want.t, *want.normal, want.material_id, want.outside, want.tex_u,
                     want.tex_v, want.has_uv)):
        assert torch.equal(a, b)
    before, _ = plain_d(ds, g, np.full((E, P), dead, np.int32), t, tri, u, v, bt0, count, seed)
    rest = np.setdiff1d(np.arange(P), listed)
    assert torch.equal(got.t[rest], before.t[rest])  # lanes past the count
    # a lane changes only where the model found a hit, and some do
    changed = set(np.flatnonzero((got.t != before.t).numpy()).tolist())
    found = {int(listed[j]) for j, m in enumerate(model) if m[0]}
    assert changed <= found
    assert bool(changed) == bool(found)


def test_merge_dispatch_covers_every_e():
    """pt_merge_entries refuses E outside [1, kPlacePer] and launches
    kMerge[E - 1], a table of D's instantiations for E = 1..kPlacePer in
    order; kPlacePer is PLACE_MAX_E, which the wrapper checks."""
    with open(os.path.join(ROOT, "project3_cuda_path_tracer_tpu_torch", "csrc",
                           "sorted.cu")) as f:
        src = f.read()
    per = int(re.search(r"constexpr int kPlacePer = (\d+);", src).group(1))
    assert per == tpipe.PLACE_MAX_E
    table = src[src.index("kMerge[] = {"):]
    table = table[:table.index("};")]
    assert re.findall(r"merge_entries_kernel<(\d+)>", table) == [
        str(e) for e in range(1, per + 1)]
    entry = src[src.index('extern "C" int pt_merge_entries('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (E < 1 || E > kPlacePer) return" in entry
    assert "kMerge[E - 1]" in entry


def select_model(flag, t_a, t_m, a_fields, m_fields):
    """#9's merged hit per lane: the winner from (flag, t_a, t_mesh), then
    each other field from the winner's lanes; (t, fields, where the mesh
    won)."""
    tm = np.where(flag, t_m, np.float32(0))  # t_mesh read only for a candidate
    mesh = (tm > 0) & (np.where(t_a > 0, t_a, FLT_MAX) > tm)
    t = np.where(mesh, tm, t_a)
    fields = [np.where(mesh, m, a) for a, m in zip(a_fields, m_fields)]
    return t, fields, mesh


def parent_select(flag, t_a, t_m, a_fields, m_fields):
    """mesh_wins + load_hit of the kernel before: the analytic hit whole,
    then the mesh hit whole where it wins."""
    out_t, out_f = [], []
    for i in range(flag.shape[0]):
        h = (t_a[i], [f[i] for f in a_fields])
        wins = bool(flag[i]) and t_m[i] > 0 and (t_a[i] if t_a[i] > 0 else FLT_MAX) > t_m[i]
        if wins:
            h = (t_m[i], [f[i] for f in m_fields])
        out_t.append(h[0])
        out_f.append(h[1])
    return np.array(out_t, np.float32), [np.array(c) for c in zip(*out_f)]


@pytest.mark.parametrize("case", ["mixed", "t_a_not_positive", "equal_t",
                                  "not_candidate", "t_mesh_not_positive"])
def test_select_model_matches_mesh_wins_and_merge_hits(case):
    rng = np.random.default_rng(["mixed", "t_a_not_positive", "equal_t", "not_candidate",
                                 "t_mesh_not_positive"].index(case))
    n = 997
    flag = rng.random(n) < 0.6
    t_a = np.where(rng.random(n) < 0.2, np.float32(-1),
                   rng.uniform(0.1, 10, n)).astype(np.float32)
    t_m = np.where(rng.random(n) < 0.3, np.float32(-1),
                   rng.uniform(0.1, 10, n)).astype(np.float32)
    if case == "t_a_not_positive":
        t_a[:] = rng.choice(np.array([-1.0, 0.0], np.float32), n)
    elif case == "equal_t":
        t_m[:] = t_a = np.abs(t_a) + np.float32(0.5)
    elif case == "not_candidate":
        flag[:] = False
    elif case == "t_mesh_not_positive":
        t_m[:] = rng.choice(np.array([-1.0, 0.0], np.float32), n)
    a_fields = [rng.normal(size=n).astype(np.float32) for _ in range(3)] + [
        rng.integers(-1, 5, n).astype(np.int32), rng.random(n) < 0.5]
    m_fields = [rng.normal(size=n).astype(np.float32) for _ in range(3)] + [
        rng.integers(-1, 5, n).astype(np.int32), rng.random(n) < 0.5]
    t, fields, mesh = select_model(flag, t_a, t_m, a_fields, m_fields)
    want_t, want_f = parent_select(flag, t_a, t_m, a_fields, m_fields)
    assert np.array_equal(t.view(np.int32), want_t.view(np.int32))
    for a, b in zip(fields, want_f):
        assert np.array_equal(a, b)
    if case in ("t_a_not_positive", "equal_t", "not_candidate", "t_mesh_not_positive"):
        expect = {"t_a_not_positive": flag & (t_m > 0), "equal_t": np.zeros(n, bool),
                  "not_candidate": np.zeros(n, bool),
                  "t_mesh_not_positive": np.zeros(n, bool)}[case]
        assert np.array_equal(mesh, expect)
    # the plain version of the merge (#10, and #9's front half)
    cands = tpipe.Candidates(
        torch.from_numpy(t_a), Vec3(*(torch.from_numpy(a) for a in a_fields[:3])),
        torch.from_numpy(a_fields[3]), torch.from_numpy(a_fields[4]),
        torch.from_numpy(flag), torch.zeros(n, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32))
    hits = Intersections(torch.from_numpy(t_m),
                         Vec3(*(torch.from_numpy(a) for a in m_fields[:3])),
                         torch.from_numpy(m_fields[3]), torch.from_numpy(m_fields[4]),
                         torch.zeros(n), torch.zeros(n), torch.zeros(n, dtype=torch.bool))
    plain = tpipe.merge_hits(cands, hits)
    assert torch.equal(plain.t, torch.from_numpy(t))
    for a, b in zip((*plain.normal, plain.material_id, plain.outside), fields):
        assert torch.equal(a, torch.from_numpy(b))
