"""The Renderer and the CLI render mesh_big.txt on the CPU (8x8, depth 2)
through the plain versions of the big-mesh route (#7 -> #8 -> A -> B -> C
-> D -> #9 at every depth), and mesh.txt still takes #7 -> #8 -> #9 with
no call of the sorted route."""

import os

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.render import Renderer, RenderSettings
from tests.conftest import SCENES

DENSE = ("mesh_candidates_reference", "mesh_sweep_reference",
         "bounce_step_mesh_reference")
SORTED = ("super_keys_reference", "place_entries_reference",
          "window_sweep_reference", "merge_entries_reference")
WRAPPERS = ("mesh_candidates", "mesh_sweep", "super_keys", "place_entries",
            "window_sweep", "merge_entries", "bounce_step_mesh",
            "intersect_mesh")


def spy(monkeypatch):
    """Count the calls of the plain versions that the wrappers make."""
    calls = dict.fromkeys(DENSE + SORTED, 0)
    for name in calls:
        fn = getattr(tpipe, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tpipe, name, counted)
    return calls


def small(name, res=(8, 8)):
    s = tscene.load_scene(os.path.join(SCENES, name))
    c = s.state.camera
    s.state.camera = tscene.derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance)
    return s


@pytest.mark.parametrize("name,sorted_calls", [("mesh_big.txt", 4),
                                               ("mesh.txt", 0)])
def test_renderer_routes_mesh_geoms(monkeypatch, name, sorted_calls):
    """One step_batch iteration and one step() at depth 2: the dense plain
    versions run at every depth, the sorted route's only for the geom
    above 16,384 triangles; on the CPU no kernel launch is counted."""
    calls = spy(monkeypatch)
    before = [getattr(tpipe, k).launches for k in WRAPPERS]
    r = Renderer(small(name), RenderSettings(trace_depth=2), device="cpu")
    r.step_batch(1)
    r.step()
    assert calls == dict(dict.fromkeys(DENSE, 4),
                         **dict.fromkeys(SORTED, sorted_calls))
    assert before == [getattr(tpipe, k).launches for k in WRAPPERS]
    img = r.image()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0


def test_cli_renders_big_mesh_on_cpu(tmp_path):
    text = open(os.path.join(SCENES, "mesh_big.txt")).read()
    scene = tmp_path / "mesh_big8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8")
                     .replace("assets/", os.path.join(SCENES, "assets") + "/"))
    assert "RES         8 8" in scene.read_text()
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "1", "--depth",
                "2", "--out-dir", str(tmp_path)])
    assert rc == 0
    assert len(list(tmp_path.glob("*.1samp.png"))) == 1
