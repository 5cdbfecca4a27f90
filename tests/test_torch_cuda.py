"""The hand-written CUDA kernel on the card: against its plain PyTorch
version, its launch count on the main path, and the wrapper's checks.

Every test here needs a CUDA device and nvcc (the kernel builds on first
use) and skips without them. The file imports neither JAX nor the
shared test harness, so on a machine with a card and no JAX it runs on
its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.models.device import (
    camera_to_device,
    scene_to_device,
)
from project3_cuda_path_tracer_tpu_torch.models.scene import derive_camera, load_scene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
from project3_cuda_path_tracer_tpu_torch.render import Renderer, RenderSettings

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel builds on first use)")
    return torch.device("cuda")


def small(name, res):
    s = load_scene(os.path.join(SCENES, name))
    c = s.state.camera
    s.state.camera = derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    return s


@pytest.mark.parametrize(
    "name,settings_kw",
    [("cornell.txt", {"antialias": True}),
     ("cornell_glass.txt", {"russian_roulette": True}),
     ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}),
     ("many_materials.txt", {"russian_roulette": True})],
)
def test_kernel_matches_plain_on_cuda(cuda_device, name, settings_kw):
    """One iteration at 64x64 through the kernel and its plain version on
    identical inputs; tests/test_megakernel.py's image rule."""
    scene = small(name, (64, 64))
    settings = RenderSettings(trace_depth=8, **settings_kw)
    ds = scene_to_device(scene, cuda_device)
    cam = camera_to_device(scene.state.camera, cuda_device)
    accum = Vec3.zeros(64 * 64, cuda_device)
    before = megakernel.full_iteration.launches
    megakernel.full_iteration(ds, cam, 3, settings, accum)
    torch.cuda.synchronize()
    assert megakernel.full_iteration.launches == before + 1
    plain = megakernel.full_iteration_reference(ds, cam, 3, settings)
    for g, w in zip(accum, plain):
        diff = np.abs(g.cpu().numpy() - w.cpu().numpy())
        assert (diff > 1e-3).mean() < 0.02
        assert np.median(diff) < 1e-5


def test_renderer_launches_once_per_iteration(cuda_device):
    scene = small("cornell.txt", (96, 64))
    r = Renderer(scene, RenderSettings(trace_depth=8, antialias=True),
                 device=cuda_device)
    before = megakernel.full_iteration.launches
    r.step()
    r.step_batch(4)
    assert megakernel.full_iteration.launches - before == r.iteration == 5
    img = r.image()
    assert img.shape == (64, 96, 3) and np.isfinite(img).all() and img.max() > 0


def test_wrapper_rejects_bad_inputs(cuda_device):
    scene = small("cornell.txt", (16, 16))
    settings = RenderSettings(trace_depth=2)
    ds = scene_to_device(scene, cuda_device)
    cam = camera_to_device(scene.state.camera, cuda_device)
    cpu_accum = Vec3.zeros(256, "cpu")
    with pytest.raises(ValueError, match="is on"):
        megakernel.full_iteration(
            ds, cam, 1, settings,
            Vec3(cpu_accum.x.to(cuda_device), cpu_accum.y, cpu_accum.z),
        )
    strided = torch.zeros(512, device=cuda_device)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        megakernel.full_iteration(
            ds, cam, 1, settings, Vec3(strided, strided.clone(), strided.clone())
        )
    with pytest.raises(ValueError, match="shape"):
        megakernel.full_iteration(ds, cam, 1, settings, Vec3.zeros(100, cuda_device))
