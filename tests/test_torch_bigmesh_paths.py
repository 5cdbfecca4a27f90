"""mesh_big.txt (one 51,200-triangle geom: the port's sorted route) against
the JAX package's XLA path, from identical tables (the JAX DeviceScene
handed over), at 16x16: the plain `intersect_pipeline` (#7 -> #8 -> A ->
B -> C -> D -> #10) against `intersect_scene_any` under the lane rule of
tests/test_megakernel.py:57-76, and `trace_paths` at depth 3, plain and
AA, against `render_iteration` under the image rule (fewer than 2% of
values off by more than 1e-3, median under 1e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops.camera import generate_rays as jgen
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from tests.conftest import SCENES
from tests.test_torch_mesh_intersect import assert_isect_close
from tests.test_torch_ops import jv, tv
from tests.test_torch_render import assert_image_close
from tests.test_torch_scene import jax_scene_numpy

RES = (16, 16)
P = RES[0] * RES[1]


@pytest.fixture(scope="module")
def big():
    """(JAX DeviceScene, port DeviceScene over the same tables, JAX
    camera, port camera) of mesh_big.txt at 16x16, with the BVH."""
    js = jscene.load_scene(os.path.join(SCENES, "mesh_big.txt"))
    c = js.state.camera
    js.state.camera = jscene.derive_camera(
        RES, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    jd = jdevice.scene_to_device(js, use_bvh=True)
    td = tdevice.device_scene_from_numpy(*jax_scene_numpy(jd), "cpu")
    jc = jdevice.camera_to_device(js.state.camera)
    tc = tdevice.DeviceCamera(
        **{f: torch.tensor(np.asarray(getattr(jc, f)))
           for f in ("position", "view", "up", "right", "pixel_length",
                     "aperture", "focal_distance")},
        resolution=jc.resolution,
    )
    assert tpipe.sorted_geoms(td) == td.mesh_geoms
    return jd, td, jc, tc


def test_big_intersect_matches_jax_xla(big):
    """The 16x16 AA camera rays and seeded rays aimed at the mesh."""
    jd, td, jc, _ = big
    (g,) = td.mesh_geoms
    co, cd, _ = jgen(jc, jnp.int32(1), True, False)
    rng = np.random.default_rng(3)
    n = 768
    ro = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3))
    aim = td.transform[g][:3, 3].numpy() + rng.normal(0, 1.0, (n, 3))
    rd = (aim - ro) / np.linalg.norm(aim - ro, axis=1, keepdims=True)
    o = np.concatenate([np.stack([np.asarray(c) for c in co], 1), ro])
    d = np.concatenate([np.stack([np.asarray(c) for c in cd], 1), rd])
    o, d = o.astype(np.float32), d.astype(np.float32)
    jset = jrender.RenderSettings(use_pallas=False)
    want = jax.jit(jrender.intersect_scene_any, static_argnames="settings")(
        jv(o), jv(d), jd, jset)
    got = tpipe.intersect_pipeline(tv(o), tv(d), None, td)
    assert_isect_close(got, want)
    mat = int(td.geom_material_id[g])
    assert (got.material_id == mat).float().mean() > 0.3  # the mesh is hit


def jax_render(big, settings_kw, it):
    jd, _, jc, _ = big
    jset = jrender.RenderSettings(trace_depth=3, use_pallas=False, **settings_kw)
    accum, _, counts = jrender.render_iteration(
        jd, jc, JVec3.zeros((P,)), jnp.int32(it), jrender._empty_cache(P), jset,
        False,
    )
    return np.stack([np.asarray(c) for c in accum], -1), counts


@pytest.mark.parametrize("settings_kw", [{}, {"antialias": True}])
def test_big_trace_paths_matches_jax_xla(big, settings_kw, monkeypatch):
    """trace_paths through the plain mesh pipeline, the big geom on the
    sorted route at every depth."""
    _, td, _, tc = big
    tset = trender.RenderSettings(trace_depth=3, **settings_kw)
    calls = []
    keys = tpipe.super_keys_reference

    def counted(*a, **k):
        calls.append(1)
        return keys(*a, **k)

    monkeypatch.setattr(tpipe, "super_keys_reference", counted)
    rad, pix, _, tcounts = trender.trace_paths(td, tc, 2, None, tset, False)
    assert len(calls) == 3  # once per depth
    got = np.zeros((P, 3), np.float32)
    got[pix.numpy()] = np.stack([c.numpy() for c in rad], -1)
    want, jcounts = jax_render(big, settings_kw, 2)
    assert_image_close(got, want)
    assert np.abs(tcounts.numpy() - np.asarray(jcounts)).max() <= 0.02 * P
    assert got.max() > 0
