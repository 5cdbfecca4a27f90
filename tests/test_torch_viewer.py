"""The port's viewer (viewer.py) against the JAX package's: the same key
and drag sequences leave the port's camera where they leave the JAX
Renderer's (atol 1e-6) and reset the iteration each time; two frames of
the loop under matplotlib's Agg backend, as tests/test_viewer.py drives
the JAX one; the loop's body without a display (`next_frame`); the CLI's
--preview. Cornell 32x32, depth 3."""

import os

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu import viewer as jviewer
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch import viewer as tviewer
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from tests.conftest import SCENES
from tests.test_torch_render import small

RES = (32, 32)
KEYS = ["left", "up", "+", "d", "w", "right", "down", "-", "a", "x", "=", " ", "q"]
DRAGS = [(1, 40.0, 15.0), (3, 0.0, 400.0), (2, 30.0, -12.0), (1, -7.0, 90.0)]


@pytest.fixture()
def pair():
    j = jrender.Renderer(small(jscene, "cornell.txt", RES),
                         jrender.RenderSettings(trace_depth=3, use_bvh=False))
    t = trender.Renderer(small(tscene, "cornell.txt", RES),
                         trender.RenderSettings(trace_depth=3), device="cpu")
    return j, t


def assert_same_camera(j, t):
    for f in ("position", "look_at", "view", "up", "right", "pixel_length", "fov"):
        np.testing.assert_allclose(getattr(t.camera, f), getattr(j.camera, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert tuple(t.camera.resolution) == tuple(j.camera.resolution)


def test_keys_move_the_camera_as_jax(pair):
    j, t = pair
    og = t.scene.state.camera.look_at.copy()
    for key in KEYS:
        t.step()
        assert t.iteration == 1
        got = tviewer.handle_key(t, key, og)
        assert got == jviewer.handle_key(j, key, og)
        assert t.iteration == (1 if key == "q" else 0), key
        assert_same_camera(j, t)
    assert tviewer.handle_key(t, "s") == "save"
    assert tviewer.handle_key(t, "escape") == "quit"


def test_drags_move_the_camera_as_jax(pair):
    j, t = pair
    for button, dx, dy in DRAGS:
        t.step()
        tviewer.handle_drag(t, button, dx, dy, (400, 300))
        jviewer.handle_drag(j, button, dx, dy, (400, 300))
        assert t.iteration == 0
        assert_same_camera(j, t)


def test_two_frames_under_agg(pair, tmp_path):
    _, t = pair
    tviewer.run_viewer(t, target_iterations=4, batch=2, backend="Agg",
                       max_frames=2, out_dir=str(tmp_path))
    assert t.iteration == 4
    img = t.image() / 4
    assert img.max() > 0.5 and np.isfinite(img).all()
    assert len(list(tmp_path.glob("cornell.*.4samp.png"))) == 1


def test_next_frame_without_a_display(pair):
    _, t = pair
    frame = tviewer.next_frame(t, 2)
    assert t.iteration == 2
    np.testing.assert_array_equal(frame, t.frame_uint8()[:, ::-1, :])
    assert frame.shape == (RES[1], RES[0], 3) and frame.dtype == np.uint8


def test_cli_preview(tmp_path, monkeypatch):
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8"))
    monkeypatch.setenv("MPLBACKEND", "Agg")
    assert tmain([str(scene), "--device", "cpu", "--iterations", "8", "--depth", "2",
                  "--preview", "--out-dir", str(tmp_path)]) == 0
    assert len(list(tmp_path.glob("cornell.*.8samp.png"))) == 1
