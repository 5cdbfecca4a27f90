"""--no-pallas (`RenderSettings.plain`): the one predicate every wrapper
uses (`ops/megakernel.py::runs_plain`), every wrapper that launches a
kernel asking it first, and on the CPU the same image bit for bit with
and without the setting (the plain versions run either way) through
`step_batch` and `step()`, on an analytic, a mesh, a textured, an NEE, a
sorted and a sharded render; the log line a card gets; the CLI. 16x16,
depth 3."""

import ast
import inspect
import logging
import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpl
from project3_cuda_path_tracer_tpu_torch.parallel.shard import ShardedRenderer
from tests.conftest import SCENES
from tests.test_torch_render import small

RES = (16, 16)


def test_runs_plain_predicate():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert tmk.runs_plain(cpu) and tmk.runs_plain(cpu, True)
    assert not tmk.runs_plain(cuda)
    assert tmk.runs_plain(cuda, True)
    assert trender.RenderSettings().plain is False
    assert trender.RenderSettings().use_pallas is False  # the JAX default, unused


def _launching_functions(module):
    tree = ast.parse(inspect.getsource(module))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            calls = [n.func.id for n in ast.walk(node)
                     if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
            if "_launch" in calls:
                yield node.name, calls


def test_every_launching_wrapper_asks_runs_plain():
    seen = set()
    for module in (tmk, tpl):
        for name, calls in _launching_functions(module):
            seen.add(name)
            assert "runs_plain" in calls, name
            assert calls.index("runs_plain") < calls.index("_launch"), name
    assert seen == {
        "_whole_iterations", "first_bounce", "bounce_step", "shade_step",
        "bounce_step_nee", "mesh_candidates", "mesh_sweep", "bounce_step_mesh",
        "intersect_mesh", "super_keys", "place_entries", "window_sweep",
        "merge_entries", "radix_split", "radix_unscatter", "window_sweep_stream"}


@pytest.mark.parametrize("name,kw", [
    ("cornell.txt", {"antialias": True}), ("mesh.txt", {}),
    ("textured.txt", {}), ("cornell.txt", {"nee_mis": True}),
    ("cornell.txt", {"sort_by_material": True, "compact": True}),
])
def test_plain_setting_same_image_on_cpu(name, kw):
    scene = small(tscene, name, RES)
    imgs = []
    for plain in (False, True):
        r = trender.Renderer(scene, trender.RenderSettings(trace_depth=3, plain=plain, **kw),
                             device="cpu")
        assert r.tables is None
        r.step_batch(2)
        r.step()
        imgs.append(r.image())
    assert imgs[0].max() > 0
    np.testing.assert_array_equal(imgs[1], imgs[0])


def test_plain_setting_sharded_same_image_on_cpu():
    scene = small(tscene, "mesh.txt", RES)
    imgs = []
    for plain in (False, True):
        sr = ShardedRenderer(scene, trender.RenderSettings(trace_depth=3, plain=plain),
                             px=2, tri=2, device="cpu")
        sr.step_batch(1)
        imgs.append(sr.image())
    np.testing.assert_array_equal(imgs[1], imgs[0])


def test_log_says_the_plain_versions_run_on_a_card(caplog):
    caplog.set_level(logging.INFO)
    trender.log_plain(trender.RenderSettings(plain=True), [torch.device("cpu")])
    assert "no kernel is launched" not in caplog.text
    trender.log_plain(trender.RenderSettings(), [torch.device("cuda", 0)])
    assert "no kernel is launched" not in caplog.text
    trender.log_plain(trender.RenderSettings(plain=True), [torch.device("cuda", 0)] * 2)
    assert "--no-pallas: the plain PyTorch versions render on cuda:0" in caplog.text


def test_cli_no_pallas_same_image(tmp_path):
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8"))
    imgs = []
    for extra in ([], ["--no-pallas"]):
        out = tmp_path / f"out{len(extra)}"
        assert tmain([str(scene), "--device", "cpu", "--iterations", "2", "--depth", "3",
                      "--hdr", "--out-dir", str(out)] + extra) == 0
        (hdr,) = out.glob("cornell.*.2samp.hdr")
        from project3_cuda_path_tracer_tpu_torch.utils.image import read_hdr

        imgs.append(read_hdr(str(hdr)))
    np.testing.assert_array_equal(imgs[1], imgs[0])
