"""The port's light sampling (`ops/lights.py::sample_lights`) and MIS
light pdf model (`ops/lights.py::lights_area_weight`) against the JAX
package's (`ops/lights.py::sample_lights`, `render._lights_area_weight`),
on identical scene tables and seeded numpy uniforms: a cube light
(Cornell), several lights of both kinds (many_materials: five spheres and
a box) and a sphere light (Cornell with its sphere made emissive)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.ops import lights as jlights
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.ops import lights as tlights
from tests.test_torch_ops import small_jax_scene

# (scene, material made emissive or None, expected light geom types)
CASES = [
    ("cornell.txt", None, [1]),
    ("many_materials.txt", None, [1, 0, 0, 0, 0, 0]),
    ("cornell.txt", 4, [1, 0]),  # the mirror sphere emits too
]


def both(name, emit_mat):
    """(JAX DeviceScene, port DeviceScene) over the same numpy tables."""
    s = small_jax_scene(name)
    if emit_mat is not None:
        s.materials = copy.deepcopy(s.materials)
        s.materials.emittance[emit_mat] = 3.0
    jd = jdevice.scene_to_device(s, use_bvh=False)
    fields = {n: np.asarray(getattr(jd, n)) for n in tdevice.ARRAY_FIELDS}
    for n in tdevice.VEC3_FIELDS:
        fields[n] = np.stack([np.asarray(c) for c in getattr(jd, n)], -1)
    meta = {n: getattr(jd, n) for n in tdevice.META_FIELDS}
    return jd, tdevice.device_scene_from_numpy(fields, meta, "cpu")


def uniforms(n=4096, seed=7):
    """Seeded U[0,1) triples, with the edges: 0, the largest float below
    1, and 1 itself (the RNG's float mapping can round up to 1.0, which
    picks no light)."""
    u = np.random.default_rng(seed).uniform(size=(3, n)).astype(np.float32)
    edge = np.float32([0.0, np.nextafter(np.float32(1), np.float32(0)), 1.0])
    u[:, :3] = edge
    u[0, 3:6] = edge[::-1]
    return u


@pytest.mark.parametrize("name,emit_mat,kinds", CASES)
def test_sample_lights_matches_jax(name, emit_mat, kinds):
    jd, td = both(name, emit_mat)
    assert [td.gtypes[g] for g in td.emissive_geoms] == kinds
    u = uniforms()
    want = jlights.sample_lights(jd, *(jnp.asarray(c) for c in u))
    got = tlights.sample_lights(td, *(torch.tensor(c) for c in u))
    for what, g, w in zip(("point", "normal", "weight", "Le"), got, want):
        g = np.stack([np.asarray(c) for c in g]) if isinstance(g, tuple) else g.numpy()
        w = np.stack([np.asarray(c) for c in w]) if isinstance(w, tuple) else np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=what)
    # every light is picked, and u_light == 1.0 picks none
    picked = got[2].numpy() > 0
    assert not picked[2] and not picked[3] and picked[4:].all()


@pytest.mark.parametrize("name,emit_mat,kinds", CASES)
def test_lights_area_weight_matches_jax(name, emit_mat, kinds):
    jd, td = both(name, emit_mat)
    got = tlights.lights_area_weight(td)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(jrender._lights_area_weight(jd)),
                               rtol=1e-6)


def test_no_light_is_refused():
    _, td = both("env.txt", None)
    assert td.emissive_geoms == ()
    assert float(tlights.lights_area_weight(td)) == 1.0
    with pytest.raises(ValueError, match="emissive"):
        tlights.sample_lights(td, *(torch.zeros(4) for _ in range(3)))
