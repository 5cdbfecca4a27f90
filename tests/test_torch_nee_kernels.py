"""The plain versions of kernels #5 and #6 (the wrappers on CPU tensors)
against the JAX package's Pallas kernels `bounce_step_pallas_nee` and
`full_iteration_nee_pallas` in interpret mode, from the same 32x32 scene
tables and the same pool.

#6: the image rule of tests/test_nee_megakernel.py (median under 1e-5,
under 3% of values off by more than 1e-3). #5: the lane rule of
tests/test_megakernel.py on the radiance and alive lanes (atol 1e-4, at
most 1% of lanes), pix exact; origins, directions, throughput and the MIS
aux on the lanes alive after the bounce in both (the Pallas kernel also
tints the throughput of lanes that is_last ends and writes aux for dead
lanes; no later step reads either)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.test_torch_bounce_step import to_jax
from tests.test_torch_nee import assert_nee_image_close
from tests.test_torch_ops import both_cameras, both_scenes

RES = (32, 32)
P = RES[0] * RES[1]


def settings_pair(depth, **kw):
    return (trender.RenderSettings(trace_depth=depth, nee_mis=True, **kw),
            jrender.RenderSettings(trace_depth=depth, nee_mis=True,
                                   use_bvh=False, use_pallas=True, **kw))


# Each configuration traces a Pallas kernel in interpret mode (~20 s), so
# the features share configurations: the glossy sphere (a non-delta lobe
# on a REFL=1 material), AA, stratified depth 0 and Russian roulette. The
# port's plain estimator is held against the XLA one more widely in
# tests/test_torch_nee.py.
@pytest.mark.parametrize("glossy,depth,kw", [
    (True, 3, {"antialias": True, "russian_roulette": True,
               "rr_start_depth": 1, "stratified": True}),
])
def test_full_iteration_nee_matches_pallas(glossy, depth, kw):
    jd, td = both_scenes("cornell.txt", glossy_mat=4 if glossy else None)
    jc, tc = both_cameras("cornell.txt")
    tset, jset = settings_pair(depth, **kw)
    aw = jrender._lights_area_weight(jd)
    launches = tmk.full_iteration_nee.launches
    for it in (1, 2):
        want = jmk.full_iteration_nee_pallas(
            jd, jmk.pack_camera(jc), aw, jnp.int32(it), jset, RES, 0,
            interpret=True,
        )
        accum = TVec3.zeros(P, "cpu")
        tmk.full_iteration_nee(td, tc, it, tset, accum)
        got = np.stack([c.numpy() for c in accum])
        assert_nee_image_close(got, np.stack([np.asarray(c) for c in want]))
    # CPU tensors run the plain version: no kernel launch is counted
    assert tmk.full_iteration_nee.launches == launches


def assert_nee_lanes_close(got, got_aux, want, want_aux):
    g = tmk.pool_lanes(got)
    w = [np.asarray(c) for v in want[:4] for c in v]
    w += [np.asarray(want[4]).astype(np.int32), np.asarray(want[5])]
    np.testing.assert_array_equal(g[13].numpy(), w[13])
    assert (g[12].numpy() != w[12]).mean() <= 0.01
    both_alive = (g[12].numpy() != 0) & (w[12] != 0)
    for k in range(12):
        bad = np.abs(g[k].numpy() - w[k]) > 1e-4
        lanes = bad if k >= 9 else bad[both_alive]  # radiance: every lane
        assert lanes.size == 0 or lanes.mean() <= 0.01, k
    for a, b in zip(got_aux, want_aux):
        bad = np.abs(a.numpy() - np.asarray(b)) > 1e-4
        assert not both_alive.any() or bad[both_alive].mean() <= 0.01


@pytest.mark.parametrize("name,glossy,kw", [
    ("cornell.txt", True, {"antialias": True, "stratified": True}),
])
def test_bounce_step_nee_matches_pallas(name, glossy, kw):
    """Depth 0 from the camera rays (aux at zeros), then depth 1 from the
    same pool twice: is_last False and True. The wrapper works in place."""
    jd, td = both_scenes(name, glossy_mat=4 if glossy else None)
    _, tc = both_cameras(name)
    tset, jset = settings_pair(4, **kw)
    aw = jrender._lights_area_weight(jd)
    it = 3
    origins, dirs, pix = generate_rays(tc, it, tset.antialias, False)
    pool = (TVec3(*(c.contiguous() for c in origins)), dirs,
            TVec3.ones(P, "cpu"), TVec3.zeros(P, "cpu"),
            torch.ones(P, dtype=torch.int32), pix)
    aux = (torch.zeros(P), torch.zeros(P))
    launches = tmk.bounce_step_nee.launches
    for depth, is_last in ((0, False), (1, False), (1, True)):
        start = tuple(TVec3(*(c.clone() for c in v)) for v in pool[:4]) + (
            pool[4].clone(), pool[5].clone())
        start_aux = tuple(a.clone() for a in aux)
        want, want_aux = jmk.bounce_step_pallas_nee(
            to_jax(start), tuple(jnp.asarray(a.numpy()) for a in start_aux),
            jd, aw, jnp.int32(it), jnp.int32(depth), jset, is_last,
            interpret=True,
        )
        lanes = tmk.pool_lanes(start) + list(start_aux)
        got, got_aux = tmk.bounce_step_nee(start, start_aux, td, it, depth,
                                           tset, is_last)
        assert all(a is b for a, b in zip(tmk.pool_lanes(got) + list(got_aux),
                                          lanes))
        assert_nee_lanes_close(got, got_aux, want, want_aux)
        if not is_last:
            pool, aux = got, got_aux
    assert tmk.bounce_step_nee.launches == launches
