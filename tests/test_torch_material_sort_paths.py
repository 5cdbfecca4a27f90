"""`trace_paths` under --sort-materials (intersect -> sort -> #4 at every
depth, plain versions on the CPU) against the JAX package's XLA
`trace_paths` with sort (`use_pallas=False`), from identical tables:
alone and with compaction, the first-bounce cache, --direct-lighting and
zero-velocity --motion-blur on Cornell, alone on cornell_glass RR and
many_materials RR (32x32 depth 3, op by op on the JAX side), under the
image rule of tests/test_megakernel.py (fewer than 2% of values off by
more than 1e-3, median under 1e-5). mesh.txt:
tests/test_torch_material_sort_mesh.py."""

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu_torch import render as trender
from tests.test_torch_ops import both_cameras, both_scenes
from tests.test_torch_render import assert_image_close
from tests.test_torch_wavefront import P, jax_trace, pixel_image

CONFIGS = [
    ("cornell.txt", {}),
    ("cornell.txt", {"compact": True}),
    ("cornell.txt", {"direct_lighting": True}),
    ("cornell.txt", {"motion_blur": True, "antialias": True}),  # no VELOCITY
    ("cornell_glass.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("many_materials.txt", {"russian_roulette": True, "rr_start_depth": 1}),
]


@pytest.mark.parametrize("name,settings_kw", CONFIGS)
def test_sorted_trace_paths_matches_jax_xla(name, settings_kw):
    jd, td = both_scenes(name)
    jc, tc = both_cameras(name)
    kw = dict(settings_kw, sort_by_material=True)
    jrad, jpix, _, jcounts = jax_trace(jd, jc, 3, kw)
    tset = trender.RenderSettings(trace_depth=3, **kw)
    trad, tpix, _, tcounts = trender.trace_paths(td, tc, 3, None, tset, False)
    assert sorted(tpix.tolist()) == list(range(P))
    assert tpix.tolist() != list(range(P))  # the pool was permuted
    assert_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
    assert np.abs(tcounts.numpy() - np.asarray(jcounts)).max() <= 0.02 * P


def test_sorted_cache_matches_jax_xla():
    """The cache filled by one sorted iteration stays in pixel order; the
    next iteration renders from it, both against the JAX package's."""
    jd, td = both_scenes("cornell.txt")
    jc, tc = both_cameras("cornell.txt")
    kw = {"cache_first_bounce": True, "sort_by_material": True}
    tset = trender.RenderSettings(trace_depth=3, **kw)
    jrad, jpix, jcache, _ = jax_trace(jd, jc, 1, kw)
    trad, tpix, tcache, _ = trender.trace_paths(td, tc, 1, None, tset, False)
    assert_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
    np.testing.assert_array_equal(tcache.t.numpy() > 0, np.asarray(jcache.t) > 0)
    fresh = trender.intersect_scene_any(*trender._camera_pool(tc, 1, tset)[:2], td, tset)
    np.testing.assert_array_equal(tcache.t.numpy(), fresh.t.numpy())  # pixel order
    jrad, jpix, _, _ = jax_trace(jd, jc, 2, kw, cache=jcache)
    trad, tpix, _, _ = trender.trace_paths(td, tc, 2, tcache, tset, True)
    assert_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
