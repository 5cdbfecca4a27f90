"""The port's mesh intersection against the JAX package's XLA path, from
identical tables (the JAX DeviceScene handed over): the triangle test,
the BVH walk and the naive sweep on seeded random rays, the whole-scene
sweep of mesh.txt, and the plain versions of the mesh kernels' chains
(#7 -> #8 -> #10 against `intersect_scene_any`, #7 -> #8 -> #9 against
intersect + `_shade_step`). Lane rule of tests/test_megakernel.py:57-76:
at most 1% of lanes off by more than 1e-4; material ids exact but for
at most 1% of lanes (exact wall/mesh ties)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import bvh_traverse as jbvh
from project3_cuda_path_tracer_tpu.ops import intersect as jisect
from project3_cuda_path_tracer_tpu.ops import sweep as jsweep
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.ops import bvh_traverse as tbvh
from project3_cuda_path_tracer_tpu_torch.ops import intersect as tisect
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops import sweep as tsweep
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.conftest import SCENES
from tests.test_torch_ops import arr, jv, tv
from tests.test_torch_scene import jax_scene_numpy

MESH_GEOM = 6  # mesh.txt's icosphere


@functools.lru_cache(maxsize=None)
def both_mesh_scenes(res=(32, 32)):
    """(JAX DeviceScene, port DeviceScene over the same tables, JAX
    camera, port camera) of mesh.txt at `res`, with the BVH."""
    js = jscene.load_scene(os.path.join(SCENES, "mesh.txt"))
    c = js.state.camera
    js.state.camera = jscene.derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    jd = jdevice.scene_to_device(js, use_bvh=True)
    td = tdevice.device_scene_from_numpy(*jax_scene_numpy(jd), "cpu")
    jc = jdevice.camera_to_device(js.state.camera)
    tc = tdevice.DeviceCamera(
        **{f: torch.tensor(np.asarray(getattr(jc, f)))
           for f in ("position", "view", "up", "right", "pixel_length",
                     "aperture", "focal_distance")},
        resolution=jc.resolution,
    )
    return jd, td, jc, tc


def mesh_rays(n=2048, seed=0):
    """Seeded origins in the Cornell room, three quarters aimed at the
    icosphere's box (centre (-1,4,-1), radius 0.75) and the rest anywhere."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3))
    aim = rng.uniform([-1.9, 3.1, -1.9], [-0.1, 4.9, -0.1], (n, 3))
    d = np.where(np.arange(n)[:, None] % 4 == 3,
                 rng.normal(size=(n, 3)), aim - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def assert_lane_rule(got, want, atol=1e-4, frac=0.01):
    for k, (g, w) in enumerate(zip(got, want)):
        bad = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)) > atol
        assert bad.mean() <= frac, (k, bad.mean())


def assert_isect_close(t, j):
    """Port Intersections against JAX ones: the lane rule on t, normal
    and UVs, outside and material ids on all but 1% of lanes."""
    assert_lane_rule([t.t.numpy(), *(c.numpy() for c in t.normal),
                      t.tex_u.numpy(), t.tex_v.numpy()],
                     [np.asarray(j.t), *(np.asarray(c) for c in j.normal),
                      np.asarray(j.tex_u), np.asarray(j.tex_v)])
    assert (t.material_id.numpy() != np.asarray(j.material_id)).mean() <= 0.01
    assert (t.outside.numpy() != np.asarray(j.outside)).mean() <= 0.01
    assert (t.has_uv.numpy() != np.asarray(j.has_uv)).mean() <= 0.01


def test_triangle_intersect_matches_jax():
    """Seeded triangles and rays of unit scale, one triangle per lane:
    t, u and v to 1e-6, the valid flag on all but 0.1% of lanes."""
    rng = np.random.default_rng(1)
    n = 4096
    v0, v1, v2 = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(3))
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32) + np.float32([0, 0, 3])
    aim = (v0 + v1 + v2) / 3 + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    with jax.disable_jit():  # op by op, as PyTorch runs it: no fused FMAs
        jt = jisect.triangle_intersect(jv(v0), jv(v1), jv(v2), jv(o), jv(d))
    tt = tisect.triangle_intersect(tv(v0), tv(v1), tv(v2), tv(o), tv(d))
    jvalid, tvalid = np.asarray(jt[3]), tt[3].numpy()
    assert 0.2 < tvalid.mean() < 0.9
    assert (jvalid != tvalid).mean() <= 0.001
    both = jvalid & tvalid
    for a, b in zip(tt[:3], jt[:3]):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=0, atol=1e-6)
    assert (tt[0].numpy()[~tvalid] == np.float32(tisect.FLT_MAX)).all()


@pytest.mark.parametrize("walk", ["bvh", "naive"])
def test_mesh_traversal_matches_jax(walk):
    """mesh_intersect_bvh and _mesh_intersect_naive on seeded rays."""
    jd, td, _, _ = both_mesh_scenes()
    o, d = mesh_rays()
    jfn, tfn = {"bvh": (jbvh.mesh_intersect_bvh, tbvh.mesh_intersect_bvh),
                "naive": (jsweep._mesh_intersect_naive,
                          tsweep._mesh_intersect_naive)}[walk]
    want = jax.jit(jfn, static_argnums=1)(jd, MESH_GEOM, jv(o), jv(d))
    got = tfn(td, MESH_GEOM, tv(o), tv(d))
    hit = np.asarray(want[0]) > 0
    assert 0.3 < hit.mean() < 0.9
    assert_lane_rule([got[0].numpy(), *(arr(got[1])[hit].T)],
                     [np.asarray(want[0]), *(arr(want[1])[hit].T)])
    assert (got[2].numpy()[hit] != np.asarray(want[2])[hit]).mean() <= 0.01


@pytest.mark.parametrize("use_bvh", [True, False])
def test_intersect_scene_matches_jax(use_bvh):
    """The whole-scene sweep of mesh.txt on its 32x32 camera rays and on
    seeded rays, with and without the BVH."""
    from project3_cuda_path_tracer_tpu.ops.camera import generate_rays as jgen

    jd, td, jc, _ = both_mesh_scenes()
    co, cd, _ = jgen(jc, jnp.int32(1), False, False)
    o, d = mesh_rays(1024, seed=2)
    o = np.concatenate([arr(co), o])
    d = np.concatenate([arr(cd), d])
    jfn = jax.jit(jsweep.intersect_scene, static_argnames="use_bvh")
    want = jfn(jv(o), jv(d), jd, use_bvh=use_bvh)
    got = tsweep.intersect_scene(tv(o), tv(d), td, use_bvh=use_bvh)
    assert_isect_close(got, want)
    assert (got.material_id.numpy() == 4).mean() > 0.2  # the mesh is seen


def test_plain_intersect_chain_matches_jax():
    """The plain #7 -> #8 -> #10 (intersect_pipeline on CPU tensors)
    against the JAX `intersect_scene_any` on its XLA path, with a fifth
    of the lanes dead: live lanes under the lane rule, dead lanes with
    their analytic hit alone; no kernel launch is counted."""
    jd, td, _, _ = both_mesh_scenes()
    o, d = mesh_rays(2048, seed=3)
    alive = np.random.default_rng(4).uniform(size=2048) < 0.8
    jset = jrender.RenderSettings(use_pallas=False)
    want = jax.jit(jrender.intersect_scene_any, static_argnames="settings")(
        jv(o), jv(d), jd, jset, alive=jnp.asarray(alive))
    launches = [f.launches for f in (tpipe.mesh_candidates, tpipe.mesh_sweep,
                                     tpipe.intersect_mesh)]
    got = tpipe.intersect_pipeline(tv(o), tv(d), torch.tensor(alive), td)
    assert launches == [f.launches for f in (
        tpipe.mesh_candidates, tpipe.mesh_sweep, tpipe.intersect_mesh)]
    live = torch.tensor(alive)
    sub = lambda i, m: tisect.Intersections(  # noqa: E731
        i.t[m], tuple(c[m] for c in i.normal), i.material_id[m], i.outside[m],
        i.tex_u[m], i.tex_v[m], i.has_uv[m])
    jsub = lambda i, m: jisect.Intersections(  # noqa: E731
        i.t[m], tuple(c[m] for c in i.normal), i.material_id[m], i.outside[m],
        i.tex_u[m], i.tex_v[m], i.has_uv[m])
    assert_isect_close(sub(got, live), jsub(want, alive))
    analytic = tsweep.intersect_scene(tv(o), tv(d), td, meshes=False)
    dead = ~live
    assert torch.equal(got.t[dead], analytic.t[dead])
    assert torch.equal(got.material_id[dead], analytic.material_id[dead])
    # the renderer's dispatch takes plain intersect_scene on the CPU
    any_ = trender.intersect_scene_any(tv(o), tv(d), td, trender.RenderSettings())
    assert_isect_close(sub(any_, live), jsub(want, alive))


def test_plain_bounce_pipeline_matches_jax():
    """The plain #7 -> #8 -> #9 (bounce_step_pipeline on CPU tensors) at
    depths 0 and 1 of mesh.txt's 32x32 AA camera rays, each from the same
    pool, against the JAX `_shade_step` over its XLA `intersect_scene`."""
    from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3

    jd, td, jc, tc = both_mesh_scenes()
    settings_kw = {"antialias": True, "russian_roulette": True,
                   "rr_start_depth": 1}
    jset = jrender.RenderSettings(use_pallas=False, **settings_kw)
    tset = trender.RenderSettings(**settings_kw)

    @functools.partial(jax.jit, static_argnames=("depth",))
    def jbounce(state, depth):
        isect = jsweep.intersect_scene(state[0], state[1], jd)
        return jrender._shade_step(state, isect, jd, jnp.int32(2),
                                   jnp.int32(depth), jset)

    pool = trender._camera_pool(tc, 2, tset)
    for depth in (0, 1):
        jstate = tuple(JVec3(*(jnp.asarray(c.numpy()) for c in v))
                       for v in pool[:4]) + (
            jnp.asarray(pool[4].numpy() != 0), jnp.asarray(pool[5].numpy()))
        want = jbounce(jstate, depth)
        got = tpipe.bounce_step_pipeline(pool, td, 2, depth, tset)
        assert got is pool
        for g, w in zip(got[:4], want[:4]):
            assert_lane_rule([c.numpy() for c in g], [np.asarray(c) for c in w])
        assert (got[4].numpy().astype(bool) != np.asarray(want[4])).mean() <= 0.01
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
        pool = tuple(TVec3(*(torch.tensor(np.asarray(c)) for c in v))
                     for v in want[:4]) + (
            torch.tensor(np.asarray(want[4])).to(torch.int32),
            torch.tensor(np.asarray(want[5])))


def test_candidacy_is_conservative_and_probe_counts():
    """Every lane whose nearest hit is the mesh is a candidate of #7's
    plain version; its candidates are the listed lanes; #8's probe counts
    the walk (at least the root per walk, at most 4 triangles per node)."""
    _, td, _, _ = both_mesh_scenes()
    o, d = mesh_rays(2048, seed=5)
    full = tsweep.intersect_scene(tv(o), tv(d), td)
    cands = tpipe.mesh_candidates_reference(tv(o), tv(d), None, td)
    on_mesh = full.material_id == 4
    assert on_mesh.float().mean() > 0.3
    assert bool(cands.cand[on_mesh].all())
    n = int(cands.count[0])
    assert torch.equal(cands.lanes[:n].long(), torch.nonzero(cands.cand)[:, 0])
    probe = {}
    hits = tpipe.mesh_sweep_reference(tv(o), tv(d), cands, td, probe=probe)
    assert probe["walks"].shape == (n,) and bool((probe["walks"] == 1).all())
    assert bool((probe["nodes"] >= 1).all())
    assert bool((probe["tris"] <= 4 * probe["nodes"]).all())
    merged = tpipe.merge_hits(cands, hits)
    assert (merged.material_id != full.material_id).float().mean() <= 0.01
    naive = tpipe.mesh_sweep_reference(tv(o), tv(d), cands, td, use_bvh=False)
    assert_lane_rule([hits.t.numpy()], [naive.t.numpy()])
