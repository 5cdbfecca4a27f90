"""The five smoke configs that need the surface stage (textured,
textured --nee, envmap, cornell_sss, mesh_textured), end to end on the
plain versions of the kernels that run them, against the JAX package's
XLA path (`use_pallas=False`) from identical tables, 32x32, depth 3:
`trace_paths` (the plain #2 -> #3 chain, #9's chain on mesh_textured
with its OBJ UVs, #5's under --nee, and --direct-lighting's final step),
the whole-iteration kernels #1 and #6 (`render_batch`), and the
first-bounce cache on mesh_textured (#7 -> #8 -> #10, then #4 with the
cached UVs). The image rule of tests/test_megakernel.py (fewer than 2%
of values off by more than 1e-3, median under 1e-5; 3% under --nee, as
tests/test_nee_megakernel.py), and three smoke configs' goldens
through `Renderer.step_batch` (textured, envmap, cornell_sss)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.test_torch_nee import assert_nee_image_close
from tests.test_torch_render import GOLDENS, assert_image_close, small
from tests.test_torch_texture import P, both_surface_scenes
from tests.test_torch_wavefront import pixel_image

DEPTH = 3


def settings_pair(kw):
    return (trender.RenderSettings(trace_depth=DEPTH, **kw),
            jrender.RenderSettings(trace_depth=DEPTH, use_pallas=False, **kw))


def jax_trace(jd, jc, it, jset, cache=None):
    """One iteration of the JAX XLA path, op by op (no whole-program
    compile): (pixel radiance (P,3), the depth-0 Intersections)."""
    with jax.disable_jit():
        accum, cache_out, _ = jrender.render_iteration(
            jd, jc, JVec3.zeros((P,)), jnp.int32(it),
            cache if cache is not None else jrender._empty_cache(P), jset,
            cache is not None,
        )
    return np.stack([np.asarray(c) for c in accum], -1), cache_out


def image_rule(kw):
    return assert_nee_image_close if kw.get("nee_mis") else assert_image_close


TRACE = [
    ("textured.txt", {"antialias": True}),
    ("envmap.txt", {}),
    ("cornell_sss.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("mesh_textured.txt", {"antialias": True}),
    ("textured.txt", {"nee_mis": True}),
    ("textured.txt", {"direct_lighting": True}),
]


@pytest.mark.parametrize("name,kw", TRACE)
def test_trace_paths_matches_jax_xla(name, kw):
    jd, td, jc, tc = both_surface_scenes(name)
    tset, jset = settings_pair(kw)
    it = 2
    want, _ = jax_trace(jd, jc, it, jset)
    counted = (tmk.bounce_step, tmk.bounce_step_nee, tpipe.bounce_step_mesh)
    launches = [f.launches for f in counted]
    trad, tpix, _, _ = trender.trace_paths(td, tc, it, None, tset, False)
    assert launches == [f.launches for f in counted]  # CPU: no kernel launch
    assert sorted(tpix.tolist()) == list(range(P))
    got = pixel_image(trad, tpix)
    image_rule(kw)(got, want)
    assert got.max() > 0


@pytest.mark.parametrize("name,kw", [
    ("textured.txt", {}),
    ("envmap.txt", {"antialias": True}),
    ("cornell_sss.txt", {}),
    ("textured.txt", {"nee_mis": True, "antialias": True}),
])
def test_whole_iteration_kernels_match_jax_xla(name, kw):
    """#1 (and #6 under --nee) through `render_batch`, their plain
    versions on CPU tensors, over two iterations."""
    jd, td, jc, tc = both_surface_scenes(name)
    tset, jset = settings_pair(kw)
    assert trender.whole_kernel(tset, td) or trender.nee_kernel(tset)
    accum = TVec3.zeros(P, "cpu")
    trender.render_batch(td, tc, accum, 4, 2, tset)
    want = sum(jax_trace(jd, jc, it, jset)[0] for it in (4, 5))
    image_rule(kw)(np.stack([c.numpy() for c in accum], -1), want)


def test_cached_first_bounce_on_mesh_uvs_matches_jax_xla():
    """mesh_textured under --cache-first-bounce: the cache's UVs (#10's
    plain version) against the JAX package's, and the next iteration's
    image shaded from them (#4's plain version)."""
    jd, td, jc, tc = both_surface_scenes("mesh_textured.txt")
    kw = {"cache_first_bounce": True}
    tset, jset = settings_pair(kw)
    want, jcache = jax_trace(jd, jc, 1, jset)
    trad, tpix, tcache, _ = trender.trace_paths(td, tc, 1, None, tset, False)
    assert_image_close(pixel_image(trad, tpix), want)
    np.testing.assert_array_equal(tcache.has_uv.numpy(), np.asarray(jcache.has_uv))
    assert tcache.has_uv.any()
    for a, b in ((tcache.tex_u, jcache.tex_u), (tcache.tex_v, jcache.tex_v)):
        assert (np.abs(a.numpy() - np.asarray(b)) > 1e-5).mean() <= 0.01
    want, _ = jax_trace(jd, jc, 2, jset, cache=jcache)
    trad, tpix, _, _ = trender.trace_paths(td, tc, 2, tcache, tset, True)
    assert_image_close(pixel_image(trad, tpix), want)


@pytest.mark.parametrize("name", ["textured.txt", "envmap.txt", "cornell_sss.txt"])
def test_surface_smoke_configs_match_goldens(name):
    """tools/smoke_pallas.py's analytic surface configs against the XLA
    path's 128x128, 2-iteration goldens (at most 4% of clipped pixels off
    by more than 0.05), through `Renderer.step_batch` (#1's plain version)
    at depth 8. textured --nee's and mesh_textured's goldens are held on
    the card (chip_smoke.py), as their plain paths at 128x128 take tens of
    seconds here; their estimators are held to the JAX package above."""
    goldens = np.load(GOLDENS)
    scene = small(tscene, name, (128, 128))
    r = trender.Renderer(scene, trender.RenderSettings(trace_depth=8), device="cpu")
    r.step_batch(2)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0
    diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[name].astype(np.float32))
    assert (diff > 0.05).mean() <= 0.04, (diff > 0.05).mean()
    assert torch.is_tensor(r.accum.x)
