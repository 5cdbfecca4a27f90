"""The port's profiling utilities on the CPU (utils/profiling.py, the JAX
package's utils/profiling.py): the stage breakdown's stages and times,
the alive curve, mrays_per_sec, and the CLI's --stats and --profile DIR."""

import json
import os

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.utils import profiling
from tests.conftest import SCENES
from tests.test_torch_render import small

STAGES = ["raygen", "intersect_sweep", "shade", "full_iteration"]


@pytest.mark.parametrize("name,settings_kw", [
    ("cornell.txt", {"antialias": True}),
    ("cornell.txt", {"sort_by_material": True, "compact": True}),
    ("mesh.txt", {}),
])
def test_stage_breakdown(name, settings_kw):
    """The JAX package's four stages (no `bounce_kernel` off the card),
    each a positive time, at 16x16; the renderer is left as it was."""
    r = trender.Renderer(small(tscene, name, (16, 16)),
                         trender.RenderSettings(trace_depth=3, **settings_kw),
                         device="cpu")
    r.step()
    before = r.image().copy()
    stages = profiling.stage_breakdown(r, reps=2)
    assert list(stages) == STAGES
    assert all(np.isfinite(v) and v > 0 for v in stages.values()), stages
    assert r.iteration == 1
    np.testing.assert_array_equal(r.image(), before)


def test_alive_curve_and_mrays():
    r = trender.Renderer(small(tscene, "cornell_glass.txt", (16, 16)),
                         trender.RenderSettings(trace_depth=4, russian_roulette=True,
                                                rr_start_depth=1),
                         device="cpu")
    curve = profiling.alive_curve(r)
    assert r.iteration == 1
    np.testing.assert_array_equal(curve, r.last_alive_counts.numpy())
    assert curve.shape == (4,) and curve[0] <= 256 and (np.diff(curve) <= 0).all()
    assert profiling.mrays_per_sec(r, iters=2) > 0
    assert r.iteration == 1 + 5 + 2


def test_cli_stats_and_profile(tmp_path, caplog):
    """--stats logs the alive curve and the four stages; --profile DIR
    writes a Chrome trace (JSON with trace events) into DIR."""
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8"))
    caplog.set_level("INFO")
    prof = tmp_path / "prof"
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "2", "--depth", "2",
                "--stats", "--profile", str(prof), "--out-dir", str(tmp_path)])
    assert rc == 0
    assert "alive rays per bounce (iter 1)" in caplog.text
    for stage in STAGES:
        assert f"stage {stage}" in caplog.text
    assert "bounce_kernel" not in caplog.text
    (trace,) = list(prof.glob("*.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("full_iteration" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in events)
    assert len(list(tmp_path.glob("cornell.*.2samp.png"))) == 1
