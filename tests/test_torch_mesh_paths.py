"""The mesh path under Russian roulette + stratified sampling and under
stream compaction against the JAX package's XLA path (see
tests/test_torch_mesh_render.py); the CLI on mesh.txt on the CPU, with
and without --no-bvh."""

import os

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.cli import build_arg_parser, settings_from_args
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from tests.conftest import SCENES
from tests.test_torch_mesh_render import (
    assert_counts_close,
    jax_render,
    port_trace,
)
from tests.test_torch_render import assert_image_close


@pytest.mark.parametrize("settings_kw", [
    {"russian_roulette": True, "rr_start_depth": 1, "stratified": True},
    {"compact": True},
])
def test_mesh_routes_match_jax_xla(settings_kw):
    got, _, tcounts = port_trace(settings_kw, 2)
    want, _, jcounts = jax_render(settings_kw, 2)
    assert_image_close(got, want)
    assert_counts_close(tcounts, jcounts)


def test_cli_renders_mesh_on_cpu(tmp_path):
    """The CLI renders mesh.txt on the CPU, with the BVH and with --no-bvh
    (the plain naive sweep): the same image within the image rule."""
    text = open(os.path.join(SCENES, "mesh.txt")).read()
    scene = tmp_path / "mesh16.txt"
    scene.write_text(text.replace("RES         800 800", "RES         16 16")
                     .replace("assets/", os.path.join(SCENES, "assets") + "/"))
    imgs = []
    for extra in ([], ["--no-bvh"]):
        out = tmp_path / f"out{len(imgs)}"
        rc = tmain([str(scene), "--device", "cpu", "--iterations", "2",
                    "--depth", "3", "--out-dir", str(out), "--hdr", *extra])
        assert rc == 0
        assert len(list(out.glob("mesh.*.2samp.png"))) == 1
        hdrs = list(out.glob("mesh.*.2samp.hdr"))
        assert len(hdrs) == 1
        import imageio.v3 as iio

        imgs.append(np.asarray(iio.imread(hdrs[0]), np.float32))
    assert_image_close(imgs[1], imgs[0])
    args = build_arg_parser().parse_args([str(scene), "--no-bvh"])
    assert settings_from_args(args, tscene.load_scene(str(scene))).use_bvh is False
