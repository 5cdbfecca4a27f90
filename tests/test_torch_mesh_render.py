"""The mesh path end to end: the port's `trace_paths` on mesh.txt (the
plain versions of the mesh pipeline #7 -> #8 -> #9 on CPU tensors)
against the JAX package's XLA path (`render_iteration`, `use_pallas=False`:
`intersect_scene` with the BVH + `_shade_step`) from identical tables,
32x32, depth 3, under the image rule of tests/test_megakernel.py
(fewer than 2% of values off by more than 1e-3, median under 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from tests.test_torch_mesh_intersect import both_mesh_scenes
from tests.test_torch_render import assert_image_close
from tests.test_torch_wavefront import pixel_image

P = 32 * 32


def jax_render(settings_kw, it, cache=None):
    """One iteration of the JAX XLA path: (pixel radiance (P,3), the
    depth-0 Intersections, alive counts)."""
    jd, _, jc, _ = both_mesh_scenes()
    jset = jrender.RenderSettings(trace_depth=3, use_pallas=False, **settings_kw)
    use_cache = cache is not None
    accum, cache_out, counts = jrender.render_iteration(
        jd, jc, JVec3.zeros((P,)), jnp.int32(it),
        cache if use_cache else jrender._empty_cache(P), jset, use_cache,
    )
    return np.stack([np.asarray(c) for c in accum], -1), cache_out, counts


def port_trace(settings_kw, it, cache=None):
    _, td, _, tc = both_mesh_scenes()
    tset = trender.RenderSettings(trace_depth=3, **settings_kw)
    rad, pix, cache_out, counts = trender.trace_paths(
        td, tc, it, cache, tset, cache is not None)
    assert sorted(pix.tolist()) == list(range(P))
    return pixel_image(rad, pix), cache_out, counts


def assert_counts_close(got, want):
    # tie lanes may die or live differently
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 0.02 * P


@pytest.mark.parametrize("settings_kw", [{}, {"antialias": True}])
def test_mesh_trace_paths_matches_jax_xla(settings_kw):
    launches = [f.launches for f in (tpipe.mesh_candidates, tpipe.mesh_sweep,
                                     tpipe.bounce_step_mesh)]
    got, _, tcounts = port_trace(settings_kw, 3)
    want, _, jcounts = jax_render(settings_kw, 3)
    assert_image_close(got, want)
    assert_counts_close(tcounts, jcounts)
    assert got.max() > 0
    # CPU tensors: the plain versions, no kernel launch counted
    assert launches == [f.launches for f in (
        tpipe.mesh_candidates, tpipe.mesh_sweep, tpipe.bounce_step_mesh)]
