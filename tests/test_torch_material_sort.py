"""The port's material sort (`--sort-materials`) against the JAX package,
on the CPU at 16x16-32x32: the permutation and the permuted pool and
hits exactly the JAX `_maybe_sort_by_material`'s; the plain radix digit
pass that builds it exactly a stable `torch.sort`, dead keys included;
#7 -> #10 on an analytic scene exactly plain `intersect_scene`; one
intersect -> sort -> #4 bounce against the JAX `_maybe_sort_by_material` +
`_shade_step` by the lane rule; #4 on a permuted pool; sorted images
against unsorted ones; `--nee` refusing sort; `step()` against
`step_batch()` and the CLI. Inputs are made from a seed with numpy, the
scene tables are the JAX package's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_tpu.ops import sweep as jsweep
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops import sweep as tsweep
from project3_cuda_path_tracer_tpu_torch.ops.intersect import Intersections
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.conftest import SCENES
from tests.test_torch_ops import arr, assert_state_close, both_cameras, both_scenes, tv
from tests.test_torch_render import small

RES = (16, 16)
P = RES[0] * RES[1]


def camera_pools(name, iteration=2, seed=0):
    """The same pool on both sides: the camera rays of `iteration`, a
    seeded third of the lanes dead, seeded throughputs; (JAX DeviceScene,
    port DeviceScene, JAX state, port state (bool alive))."""
    jd, td = both_scenes(name)
    jc, _ = both_cameras(name, RES)
    jo, jdir, jpix = jcamera.generate_rays(jc, jnp.int32(iteration), False, False)
    rng = np.random.default_rng(seed)
    alive = rng.random(P) > 0.33
    thr = rng.uniform(0.2, 1.0, (P, 3)).astype(np.float32)
    rad = rng.uniform(0.0, 0.5, (P, 3)).astype(np.float32)
    js = (jo, jdir, JVec3(*(jnp.asarray(thr[:, c]) for c in range(3))),
          JVec3(*(jnp.asarray(rad[:, c]) for c in range(3))),
          jnp.asarray(alive), jpix)
    ts = (tv(arr(jo)), tv(arr(jdir)), tv(thr), tv(rad), torch.tensor(alive),
          torch.tensor(np.asarray(jpix)))
    return jd, td, js, ts


def torch_isect(ji) -> Intersections:
    return Intersections(
        t=torch.tensor(np.asarray(ji.t)), normal=tv(arr(ji.normal)),
        material_id=torch.tensor(np.asarray(ji.material_id)),
        outside=torch.tensor(np.asarray(ji.outside)),
        tex_u=torch.tensor(np.asarray(ji.tex_u)),
        tex_v=torch.tensor(np.asarray(ji.tex_v)),
        has_uv=torch.tensor(np.asarray(ji.has_uv)),
    )


def lanes(state, isect):
    """Every lane of a pool and its hits, as numpy arrays in one list."""
    out = []
    for v in (*state, isect.t, isect.normal, isect.material_id, isect.outside,
              isect.tex_u, isect.tex_v, isect.has_uv):
        out += [np.asarray(c) for c in v] if isinstance(v, (JVec3, TVec3)) else [np.asarray(v)]
    return out


@pytest.mark.parametrize("name", ["cornell.txt", "many_materials.txt"])
def test_sort_matches_jax_exactly(name):
    """(a) From the same JAX `intersect_scene` hits: the port's key and
    permutation are the JAX package's stable argsort, and the permuted
    pool and hits equal its `_maybe_sort_by_material`'s, lane for lane."""
    jd, td, js, ts = camera_pools(name)
    ji = jsweep.intersect_scene(js[0], js[1], jd, use_bvh=False)
    ti = torch_isect(ji)
    jset = jrender.RenderSettings(sort_by_material=True, use_pallas=False)
    tset = trender.RenderSettings(sort_by_material=True)
    bits = trender.material_key_bits(td)
    assert bits == (6 if name == "many_materials.txt" else 3)
    key = trender.material_keys(ts, ti, bits)
    jkey = jnp.where(js[4] & (ji.t > 0), ji.material_id, jnp.int32(2**31 - 1))
    perm = tpipe.sort_permutation(key, bits)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jnp.argsort(jkey, stable=True)))
    dead = (1 << bits) - 1
    assert (key == dead).sum() == int((~(js[4] & (ji.t > 0))).sum()) > 0
    jgot = jrender._maybe_sort_by_material(js, ji, jset)
    tgot = trender._maybe_sort_by_material(ts, ti, td, tset)
    for k, (a, b) in enumerate(zip(lanes(*tgot), lanes(*jgot))):
        np.testing.assert_array_equal(a, b, err_msg=f"lane {k}")
    # the sort is off without the setting
    same = trender._maybe_sort_by_material(ts, ti, td, trender.RenderSettings())
    assert same[0] is ts and same[1] is ti


@pytest.mark.parametrize("bits", [1, 3, 6, 8, 9, 12])
def test_digit_passes_match_stable_sort(bits):
    """(b) The plain split by material (one digit pass per 8 bits of the
    key) is a stable `torch.sort` element for element, with dead keys
    (all ones) on a third of the lanes, and each pass's digit counts are
    numpy's bincount of the digit."""
    rng = np.random.default_rng(bits)
    n = 3000
    dead = (1 << bits) - 1
    key = rng.integers(0, max(dead, 1), n).astype(np.int32)
    key[rng.random(n) < 0.33] = dead
    key = torch.tensor(key)
    perm = tpipe.sort_permutation(key, bits)
    assert perm.dtype == torch.int32
    want = torch.sort(key, stable=True).indices
    np.testing.assert_array_equal(perm.numpy(), want.numpy())
    for shift, width in tpipe.radix_passes(bits):
        want = np.bincount((key.numpy() >> shift) & ((1 << width) - 1),
                           minlength=tpipe.RADIX_DIGITS)
        np.testing.assert_array_equal(tpipe.digit_counts(key, shift, width).numpy(), want)
    assert len(tpipe.radix_passes(bits)) == (2 if bits > 8 else 1)


@pytest.mark.parametrize("name", ["cornell.txt", "many_materials.txt", "env.txt"])
def test_analytic_intersect_chain_is_intersect_scene(name):
    """#7 -> #10 (`intersect_pipeline` on a scene without mesh geoms,
    plain versions): exactly plain `intersect_scene`, no lane a
    candidate, no UVs; `intersect_scene_any` takes it."""
    _, td, _, ts = camera_pools(name)
    want = tsweep.intersect_scene(ts[0], ts[1], td)
    cands = tpipe.mesh_candidates(ts[0], ts[1], None, td, all_lanes=True)
    assert not cands.cand.any() and int(cands.count[0]) == 0
    for got in (tpipe.intersect_pipeline(ts[0], ts[1], ts[4], td),
                trender.intersect_scene_any(ts[0], ts[1], td, trender.RenderSettings())):
        for a, b in zip(lanes(ts, got), lanes(ts, want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,settings_kw,depth", [
    ("cornell.txt", {}, 0),
    ("cornell_glass.txt", {"russian_roulette": True, "rr_start_depth": 1}, 2),
    ("many_materials.txt", {"russian_roulette": True, "rr_start_depth": 1}, 1),
])
def test_sorted_bounce_matches_jax(name, settings_kw, depth):
    """(c) One intersect -> sort -> #4 bounce (`_sorted_bounce`, plain)
    against the JAX package's intersect_scene -> `_maybe_sort_by_material`
    -> `_shade_step`: the lane rule, pix exactly (the same permutation)."""
    jd, td, js, ts = camera_pools(name)
    jset = jrender.RenderSettings(trace_depth=8, use_bvh=False, use_pallas=False,
                                  sort_by_material=True, **settings_kw)
    tset = trender.RenderSettings(trace_depth=8, sort_by_material=True, **settings_kw)
    ji = jsweep.intersect_scene(js[0], js[1], jd, use_bvh=False)
    jst, jis = jrender._maybe_sort_by_material(js, ji, jset)
    want = jrender._shade_step(jst, jis, jd, jnp.int32(5), jnp.int32(depth), jset)
    pool = ts[:4] + (ts[4].to(torch.int32), ts[5])
    launches = tmk.shade_step.launches
    got = trender._sorted_bounce(pool, td, 5, depth, tset)
    assert tmk.shade_step.launches == launches  # CPU: the plain version
    got = got[:4] + (got[4] != 0, got[5])
    assert_state_close(got, want)


@pytest.mark.parametrize("name", ["cornell_glass.txt", "many_materials.txt"])
def test_shade_step_on_permuted_pool(name):
    """(d) #4 (plain) on a permuted pool and its permuted Intersections is
    bit for bit the same permutation of #4 on the pool as it was: each
    lane draws its numbers by its pix, not by its slot."""
    _, td, _, ts = camera_pools(name)
    settings = trender.RenderSettings(russian_roulette=True, rr_start_depth=0)
    pool = ts[:4] + (ts[4].to(torch.int32), ts[5])
    isect = tsweep.intersect_scene(ts[0], ts[1], td)
    perm = torch.tensor(np.random.default_rng(1).permutation(P))
    base = tmk.shade_step(pool, isect, td, 4, 2, settings)
    got = tmk.shade_step(trender._permute_state(pool, perm),
                         trender._permute_isect(isect, perm), td, 4, 2, settings)
    want = trender._permute_state(base, perm)
    for a, b in zip(tmk.pool_lanes(got), tmk.pool_lanes(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def render(scene, n, step=False, **kw):
    r = trender.Renderer(scene, trender.RenderSettings(trace_depth=4, **kw),
                         device="cpu")
    if step:
        for _ in range(n):
            r.step()
    else:
        r.step_batch(n)
    return r


@pytest.mark.parametrize("name,settings_kw", [
    ("cornell.txt", {}),
    ("cornell.txt", {"compact": True, "cache_first_bounce": True}),
    ("many_materials.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("mesh.txt", {"antialias": True}),
])
def test_sort_is_neutral(name, settings_kw):
    """(f) Sorting moves lanes, not their numbers: the sorted image equals
    the unsorted one to atol 1e-5 (tests/test_render.py:87-103), and the
    sorted path's live counts are the unsorted path's."""
    scene = small(tscene, name, RES)
    base = render(scene, 2, step=True, **settings_kw)
    got = render(scene, 2, step=True, sort_by_material=True, **settings_kw)
    np.testing.assert_allclose(got.image(), base.image(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.last_alive_counts.numpy(),
                                  base.last_alive_counts.numpy())


def test_nee_refuses_sort():
    """(g) --nee with sort: the JAX package's ValueError, from the
    Renderer's first step and from trace_paths."""
    scene = small(tscene, "cornell.txt", (8, 8))
    r = trender.Renderer(scene, trender.RenderSettings(
        trace_depth=2, nee_mis=True, sort_by_material=True), device="cpu")
    with pytest.raises(ValueError, match="sort/compact/first-bounce cache"):
        r.step()
    with pytest.raises(ValueError, match="sort/compact/first-bounce cache"):
        r.step_batch(1)


def test_step_matches_step_batch_and_cli(tmp_path):
    """(h) Under sort, step() and step_batch() render the same image (both
    take the sorted path: no whole-iteration kernel), and the CLI renders
    with --sort-materials on the CPU."""
    scene = small(tscene, "cornell_glass.txt", RES)
    kw = {"sort_by_material": True, "russian_roulette": True, "antialias": True}
    assert not trender.whole_kernel(trender.RenderSettings(sort_by_material=True))
    a = render(scene, 2, step=True, **kw)
    b = render(scene, 2, step=False, **kw)
    np.testing.assert_array_equal(a.image(), b.image())
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    path = tmp_path / "cornell16.txt"
    path.write_text(text.replace("RES         800 800", "RES         16 16"))
    launches = [f.launches for f in (tmk.shade_step, tpipe.radix_split,
                                     tpipe.mesh_candidates, tpipe.intersect_mesh)]
    rc = tmain([str(path), "--device", "cpu", "--iterations", "2", "--depth", "3",
                "--sort-materials", "--out-dir", str(tmp_path)])
    assert rc == 0
    assert len(list(tmp_path.glob("cornell.*.2samp.png"))) == 1
    assert launches == [f.launches for f in (tmk.shade_step, tpipe.radix_split,
                                             tpipe.mesh_candidates, tpipe.intersect_mesh)]
