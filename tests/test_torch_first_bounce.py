"""Kernel #2's wrapper (its plain version, `first_bounce_reference`, on
CPU tensors) against the JAX package's `first_bounce_pallas` in
interpret mode: raygen + the depth-0 bounce of a 32x32 frame, with
tests/test_megakernel.py's lane rule (atol 1e-4, at most 1% outlier
lanes, pix exact)."""

import jax.numpy as jnp
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from tests.test_torch_ops import assert_state_close, both_cameras, both_scenes

CONFIGS = [
    ("cornell.txt", {"antialias": True}, 3),
    ("cornell_glass.txt", {"russian_roulette": True}, 2),
    ("checker.txt", {}, 5),
]


@pytest.mark.parametrize("name,settings_kw,iteration", CONFIGS)
def test_first_bounce_matches_pallas(name, settings_kw, iteration):
    jd, td = both_scenes(name)
    jc, tc = both_cameras(name)
    jset = jrender.RenderSettings(trace_depth=8, use_bvh=False,
                                  use_pallas=True, **settings_kw)
    tset = trender.RenderSettings(trace_depth=8, **settings_kw)
    want = jmk.first_bounce_pallas(
        jd, jmk.pack_camera(jc), jnp.int32(iteration), jset, (32, 32), 0,
        interpret=True,
    )
    launches = tmk.first_bounce.launches
    got = tmk.first_bounce(td, tc, iteration, tset)
    assert tmk.first_bounce.launches == launches  # CPU: no kernel launch
    assert got[4].dtype == got[5].dtype == tmk.torch.int32
    np.testing.assert_array_equal(got[5].numpy(), np.arange(32 * 32))
    assert_state_close(got, want)
    # some lanes died at depth 0 (the light, or escaped) and some live on
    alive = got[4].numpy()
    assert 0 < alive.sum() < alive.size
