"""`trace_paths` under --sort-materials on mesh.txt (16x16, depth 3,
plain versions on the CPU): #7 -> #8 -> #10, or with the routing
threshold at 0 #7 -> A -> B -> C -> D -> #10, then the sort and #4 at
every depth, against the JAX package's XLA `render_iteration` with sort
(`use_pallas=False`) from identical tables, under the image rule of
tests/test_megakernel.py (fewer than 2% of values off by more than 1e-3,
median under 1e-5)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from tests.test_torch_mesh_intersect import both_mesh_scenes
from tests.test_torch_render import assert_image_close

MESH_RES = (16, 16)


@functools.lru_cache(maxsize=None)
def jax_mesh():
    """The JAX XLA path's iteration 2 on mesh.txt 16x16 depth 3 with sort
    (`render_iteration`, jitted): (pixel radiance (P, 3), alive counts)."""
    jd, _, jc, _ = both_mesh_scenes(MESH_RES)
    jset = jrender.RenderSettings(trace_depth=3, use_pallas=False,
                                  sort_by_material=True)
    n = MESH_RES[0] * MESH_RES[1]
    accum, _, counts = jrender.render_iteration(
        jd, jc, JVec3.zeros((n,)), jnp.int32(2), jrender._empty_cache(n), jset, False)
    return np.stack([np.asarray(c) for c in accum], -1), np.asarray(counts)


@pytest.mark.parametrize("route", ["dense", "forced_sorted"])
def test_sorted_mesh_trace_paths_matches_jax_xla(route, monkeypatch):
    """mesh.txt: #7 -> #8 -> #10 (or, with the routing threshold at 0, #7
    -> A -> B -> C -> D -> #10) -> sort -> #4 at every depth."""
    _, td, _, tc = both_mesh_scenes(MESH_RES)
    if route == "forced_sorted":
        monkeypatch.setattr(tpipe, "SORT_SUPER_MIN_TRIS", 0)
        assert tpipe.sorted_geoms(td) == td.mesh_geoms
    tset = trender.RenderSettings(trace_depth=3, sort_by_material=True)
    rad, pix, _, counts = trender.trace_paths(td, tc, 2, None, tset, False)
    n = MESH_RES[0] * MESH_RES[1]
    img = np.zeros((n, 3), np.float32)
    img[pix.numpy()] = np.stack([c.numpy() for c in rad], -1)
    want, jcounts = jax_mesh()
    assert_image_close(img, want)
    assert img.max() > 0
    assert np.abs(counts.numpy() - jcounts).max() <= 0.02 * n
