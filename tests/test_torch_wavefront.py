"""The port's per-bounce path (`render.trace_paths` through the kernel
wrappers, their plain versions on CPU tensors) against the JAX package's
`trace_paths` on its XLA path (`use_pallas=False`), from the same scene
tables: 32x32, depth 3, with tests/test_megakernel.py's image rule
(fewer than 2% of values off by more than 1e-3, median under 1e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from tests.conftest import SCENES
from tests.test_torch_ops import both_cameras, both_scenes
from tests.test_torch_render import assert_image_close

RES = (32, 32)
P = RES[0] * RES[1]


def moving_sphere_scene(tmp_path):
    """tests/test_features.py's moving-sphere scene (VELOCITY 6 0 0)."""
    text = open(os.path.join(SCENES, "sphere.txt")).read()
    text = text.replace("SCALE       3 3 3", "SCALE       3 3 3\nVELOCITY    6 0 0")
    path = tmp_path / "moving.txt"
    path.write_text(text)
    js = jscene.load_scene(str(path))
    c = js.state.camera
    js.state.camera = jscene.derive_camera(
        RES, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    jd = jdevice.scene_to_device(js, use_bvh=False)
    fields = {n: np.asarray(getattr(jd, n)) for n in tdevice.ARRAY_FIELDS}
    for n in tdevice.VEC3_FIELDS:
        fields[n] = np.stack([np.asarray(c) for c in getattr(jd, n)], -1)
    meta = {n: getattr(jd, n) for n in tdevice.META_FIELDS}
    jc = jdevice.camera_to_device(js.state.camera)
    tc = tdevice.DeviceCamera(
        **{f: torch.tensor(np.asarray(getattr(jc, f)))
           for f in ("position", "view", "up", "right", "pixel_length",
                     "aperture", "focal_distance")},
        resolution=jc.resolution,
    )
    return jd, tdevice.device_scene_from_numpy(fields, meta, "cpu"), jc, tc


def pixel_image(radiance, pix):
    """Per-slot radiance scattered into pixel order, (P,3)."""
    img = np.zeros((P, 3), np.float32)
    img[np.asarray(pix)] = np.stack([np.asarray(c) for c in radiance], -1)
    return img


def jax_trace(jd, jc, it, settings_kw, cache=None):
    jset = jrender.RenderSettings(trace_depth=3, use_bvh=False,
                                  use_pallas=False, **settings_kw)
    use_cache = cache is not None
    with jax.disable_jit():  # op by op: no whole-program compile
        return jrender.trace_paths(
            jd, jc, jnp.int32(it),
            cache if use_cache else jrender._empty_cache(P), jset, use_cache,
        )


CONFIGS = [
    ("cornell.txt", {"compact": True}),
    ("cornell_glass.txt", {"compact": True, "russian_roulette": True,
                           "rr_start_depth": 1}),
    ("cornell.txt", {"stratified": True}),
    ("cornell.txt", {"sobol": True}),
    ("checker.txt", {}),
    ("moving", {"motion_blur": True}),
]


@pytest.mark.parametrize("name,settings_kw", CONFIGS)
def test_trace_paths_matches_jax_xla(name, settings_kw, tmp_path):
    if name == "moving":
        jd, td, jc, tc = moving_sphere_scene(tmp_path)
    else:
        jd, td = both_scenes(name)
        jc, tc = both_cameras(name)
    it = 3
    jrad, jpix, _, jcounts = jax_trace(jd, jc, it, settings_kw)
    tset = trender.RenderSettings(trace_depth=3, **settings_kw)
    trad, tpix, _, tcounts = trender.trace_paths(td, tc, it, None, tset, False)
    assert sorted(tpix.tolist()) == list(range(P))
    assert_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
    assert tcounts.dtype == torch.int32 and tcounts.shape == (3,)
    # seam-tie lanes may die or live differently (~0.4% per bounce)
    assert np.abs(tcounts.numpy() - np.asarray(jcounts)).max() <= 0.02 * P


def test_cached_first_bounce_matches_jax_xla():
    """Fill the cache on one iteration, render the next from it: the
    cache and both images against the JAX package's."""
    jd, td = both_scenes("cornell.txt")
    jc, tc = both_cameras("cornell.txt")
    kw = {"cache_first_bounce": True}
    tset = trender.RenderSettings(trace_depth=3, **kw)
    jrad, jpix, jcache, _ = jax_trace(jd, jc, 1, kw)
    trad, tpix, tcache, _ = trender.trace_paths(td, tc, 1, None, tset, False)
    assert_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
    close = np.abs(tcache.t.numpy() - np.asarray(jcache.t)) <= 1e-4
    assert close.mean() >= 0.99
    np.testing.assert_array_equal(tcache.t.numpy() > 0, np.asarray(jcache.t) > 0)
    jrad, jpix, _, _ = jax_trace(jd, jc, 2, kw, cache=jcache)
    launches = tmk.shade_step.launches
    trad, tpix, tcache2, _ = trender.trace_paths(td, tc, 2, tcache, tset, True)
    assert tcache2 is tcache and tmk.shade_step.launches == launches
    assert_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
