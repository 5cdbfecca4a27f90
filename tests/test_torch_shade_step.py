"""Kernel #4's wrapper (its plain version, `shade_step_reference`, on
CPU tensors) against the JAX package's `shade_step_pallas` in interpret
mode and against the JAX package's XLA `_shade_step`, all three shading
the same 32x32 pool over the same Intersections (the JAX package's
`intersect_scene`). Lane rule of tests/test_megakernel.py: atol 1e-4, at
most 1% outlier lanes, pix exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu.ops import sweep as jsweep
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops.intersect import Intersections
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.test_torch_bounce_step import start, to_jax
from tests.test_torch_ops import assert_state_close


def to_torch_isect(ji):
    t = lambda a: torch.tensor(np.asarray(a))
    return Intersections(
        t=t(ji.t), normal=TVec3(*(t(c) for c in ji.normal)),
        material_id=t(ji.material_id).to(torch.int32), outside=t(ji.outside),
    )


@pytest.mark.parametrize("name,settings_kw,depth", [
    ("cornell.txt", {"stratified": True}, 0),
    ("cornell_glass.txt", {"russian_roulette": True, "rr_start_depth": 1}, 1),
    ("checker.txt", {"sobol": True}, 0),
])
def test_shade_step_matches_pallas_and_xla(name, settings_kw, depth):
    """Depth 0 exercises the QMC hemisphere pair (the cached first
    bounce's depth), depth 1 the glass lottery and Russian roulette."""
    jd, td, jset, tset, pool = start(name, settings_kw, 3)
    jstate = to_jax(pool)
    ji = jsweep.intersect_scene(jstate[0], jstate[1], jd, use_bvh=False)
    ti = to_torch_isect(ji)
    pallas = jmk.shade_step_pallas(jstate, ji, jd, jnp.int32(3),
                                   jnp.int32(depth), jset, interpret=True)
    xla = jrender._shade_step(jstate, ji, jd, jnp.int32(3), jnp.int32(depth),
                              jset)
    launches = tmk.shade_step.launches
    got = tmk.shade_step(pool, ti, td, 3, depth, tset)
    assert tmk.shade_step.launches == launches  # CPU: no kernel launch
    assert got[5] is pool[5] and got[4].dtype == torch.int32
    assert_state_close(got, pallas)
    assert_state_close(got, xla)
    # the plain version equals the port's own _shade_step lane for lane
    own = trender._shade_step(
        pool[:4] + (pool[4] != 0, pool[5]), ti, td, 3, depth, tset
    )
    for a, b in zip(tmk.pool_lanes(got)[:12], tmk.pool_lanes(own)[:12]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
