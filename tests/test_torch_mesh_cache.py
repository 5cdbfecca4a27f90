"""The mesh path's routes through `intersect_scene_any` against the JAX
package's XLA path (see tests/test_torch_mesh_render.py): the
first-bounce cache (filled by it) and --direct-lighting (its final
step's two intersect calls)."""

import numpy as np

from tests.test_torch_mesh_render import (
    assert_counts_close,
    jax_render,
    port_trace,
)
from tests.test_torch_render import assert_image_close


def test_mesh_direct_lighting_matches_jax_xla():
    kw = {"direct_lighting": True, "antialias": True}
    got, _, tcounts = port_trace(kw, 2)
    want, _, jcounts = jax_render(kw, 2)
    assert_image_close(got, want)
    assert_counts_close(tcounts, jcounts)
    assert int(tcounts[-1]) == 0  # the final step ends every lane


def test_mesh_cache_matches_jax_xla():
    """Fill the cache on one iteration, render the next from it."""
    kw = {"cache_first_bounce": True}
    got, tcache, _ = port_trace(kw, 1)
    want, jcache, _ = jax_render(kw, 1)
    assert_image_close(got, want)
    close = np.abs(tcache.t.numpy() - np.asarray(jcache.t)) <= 1e-4
    assert close.mean() >= 0.99
    np.testing.assert_array_equal(tcache.material_id.numpy() == 4,
                                  np.asarray(jcache.material_id) == 4)
    assert (tcache.material_id.numpy() == 4).mean() > 0.01  # mesh pixels
    got, _, _ = port_trace(kw, 2, cache=tcache)
    want, _, _ = jax_render(kw, 2, cache=jcache)
    assert_image_close(got, want)
