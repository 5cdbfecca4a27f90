"""The NEE kernels' wrappers as the persistent-warp kernels use them, on
the CPU (their plain versions), against the JAX package's XLA path; no
Pallas interpret mode, so each test takes seconds:

- `Renderer.step_batch(3)` under --nee against the JAX package's XLA
  path at 32x32, under the image rule of tests/test_nee_megakernel.py;
- `bounce_step_nee` on a pool thinned to 10-20% live lanes by Russian
  roulette (a real trace, at the depth where that many are left): slots
  dead on entry keep every value bit for bit, live slots follow the JAX
  package's `_nee_mis_bounce` under the lane rule of
  tests/test_megakernel.py:57-76 (pix exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.test_torch_nee import (
    assert_aux_close,
    assert_nee_image_close,
    camera_state,
    settings_pair,
    to_jax,
)
from tests.test_torch_ops import assert_state_close, both_cameras, both_scenes
from tests.test_torch_render import small

RES = (32, 32)


@pytest.mark.parametrize("name,kw", [
    ("cornell.txt", {"antialias": True}),
    ("cornell.txt", {"russian_roulette": True, "rr_start_depth": 2,
                     "stratified": True}),
])
def test_step_batch_nee_matches_jax_xla(name, kw):
    """Port Renderer(device='cpu').step_batch(3) under --nee (#6's plain
    version) against the JAX package's XLA path, Renderer(use_pallas=
    False, nee_mis=True).step_batch(3), run op by op."""
    jr = jrender.Renderer(
        small(jscene, name, RES),
        jrender.RenderSettings(trace_depth=4, use_pallas=False, use_bvh=False,
                               nee_mis=True, **kw),
    )
    with jax.disable_jit():  # op by op: no whole-program compile
        jr.step_batch(3)
    tr = trender.Renderer(
        small(tscene, name, RES),
        trender.RenderSettings(trace_depth=4, nee_mis=True, **kw),
        device="cpu",
    )
    assert tr.step_batch(3) == 3
    img = tr.image()
    assert np.isfinite(img).all() and img.max() > 0
    assert_nee_image_close(img, jr.image())


@pytest.mark.parametrize("name,depth", [("cornell.txt", 5),
                                        ("many_materials.txt", 7)])
def test_bounce_step_nee_on_thinned_pool(name, depth):
    """A real trace with Russian roulette from depth 1, at the depth
    where 10-20% of the lanes are still live: the wrapper in place keeps
    every value of the dead slots bit for bit (lanes and aux), and its live
    slots follow the JAX package's `_nee_mis_bounce` on the same state
    under the lane rule, pix exactly."""
    jd, td = both_scenes(name)
    _, tc = both_cameras(name)
    tset, jset = settings_pair(10, antialias=True, russian_roulette=True,
                               rr_start_depth=1)
    it = 3
    state, aux = camera_state(tc, it, tset)
    for d in range(depth):
        state, aux = trender._nee_mis_bounce(state, aux, td, it, d, tset, False)
    live = state[4].clone()
    assert 0.10 <= float(live.float().mean()) <= 0.20, float(live.float().mean())

    pool = (*state[:4], state[4].to(torch.int32), state[5])
    lanes = [a.clone().contiguous() for a in tmk.pool_lanes(pool)]
    got = (TVec3(*lanes[0:3]), TVec3(*lanes[3:6]), TVec3(*lanes[6:9]),
           TVec3(*lanes[9:12]), lanes[12], lanes[13])
    got_aux = (aux[0].clone(), aux[1].to(torch.float32))
    before = [a.clone() for a in lanes + list(got_aux)]
    out, out_aux = tmk.bounce_step_nee(got, got_aux, td, it, depth, tset,
                                       is_last=False)
    assert out is got and out_aux is got_aux
    for a, b in zip(tmk.pool_lanes(out) + list(out_aux), before):
        assert torch.equal(a[~live].view(torch.int32), b[~live].view(torch.int32))

    jstate, jaux = to_jax(state, aux)
    want, want_aux = jrender._nee_mis_bounce(jstate, jaux, jd, jnp.int32(it),
                                             depth, jset, False)
    shade = (*out[:4], out[4] != 0, out[5])
    mask = live.numpy()
    take = lambda v: (TVec3(*(c[live] for c in v)) if isinstance(v, TVec3)
                      else v[live])
    jtake = lambda v: (type(v)(*(np.asarray(c)[mask] for c in v))
                       if isinstance(v, tuple) else np.asarray(v)[mask])
    assert_state_close(tuple(take(v) for v in shade),
                       tuple(jtake(v) for v in want))
    assert_aux_close(tuple(take(v) for v in shade),
                     (out_aux[0][live], out_aux[1][live] > 0.5),
                     tuple(jtake(v) for v in want),
                     tuple(np.asarray(a)[mask] for a in want_aux))
