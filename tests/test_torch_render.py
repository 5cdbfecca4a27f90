"""The slice end to end: the whole-iteration kernel's wrapper and the
progressive renderer of the port against the JAX package, the six
analytic smoke configs against the XLA goldens, the CLI, and the device
rules (no drift to the CPU, no JAX in the port)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.conftest import REPO_ROOT, SCENES

GOLDENS = os.path.join(REPO_ROOT, "tools", "goldens", "smoke_128.npz")
# the analytic smoke configs of tools/smoke_pallas.py, with their settings
ANALYTIC_SMOKE = [
    ("cornell.txt", {}),
    ("sphere.txt", {}),
    ("cornell_glass.txt", {"russian_roulette": True}),
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}),
    ("env.txt", {}),
    ("many_materials.txt", {"russian_roulette": True}),
]


def small(mod, name, res):
    s = mod.load_scene(os.path.join(SCENES, name))
    c = s.state.camera
    s.state.camera = mod.derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    return s


def assert_image_close(got, want):
    """tests/test_megakernel.py's image rule: seam-tie outliers only."""
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < 0.02, (diff > 1e-3).mean()
    assert np.median(diff) < 1e-5


def test_full_iteration_matches_pallas_kernel():
    """The kernel wrapper (its plain version on CPU tensors) against the
    JAX package's whole-iteration Pallas kernel in interpret mode:
    Cornell 32x32, depth 4, AA."""
    res = (32, 32)
    js = small(jscene, "cornell.txt", res)
    ts = small(tscene, "cornell.txt", res)
    jset = jrender.RenderSettings(trace_depth=4, antialias=True, use_pallas=True)
    tset = trender.RenderSettings(trace_depth=4, antialias=True)
    jd = jdevice.scene_to_device(js, use_bvh=False)
    jc = jdevice.camera_to_device(js.state.camera)
    td = tdevice.scene_to_device(ts, "cpu")
    tc = tdevice.camera_to_device(ts.state.camera, "cpu")
    launches = tmk.full_iteration.launches
    for it in (1, 2):
        want = jmk.full_iteration_pallas(
            jd, jmk.pack_camera(jc), jnp.int32(it), jset, res, 0,
            interpret=True,
        )
        accum = TVec3.zeros(res[0] * res[1], "cpu")
        tmk.full_iteration(td, tc, it, tset, accum)
        for g, w in zip(accum, want):
            assert_image_close(g.numpy(), np.asarray(w))
    # CPU tensors run the plain version: no kernel launch is counted
    assert tmk.full_iteration.launches == launches


@pytest.mark.parametrize(
    "name,settings_kw",
    [("cornell.txt", {"antialias": True}),
     ("cornell_glass.txt", {"russian_roulette": True})],
)
def test_renderer_matches_jax_xla_path(name, settings_kw):
    """Port Renderer(device='cpu').step_batch(2) against the JAX
    package's XLA path, Renderer(use_pallas=False).step_batch(2)."""
    res = (32, 32)
    jr = jrender.Renderer(
        small(jscene, name, res),
        jrender.RenderSettings(trace_depth=4, use_pallas=False, **settings_kw),
    )
    with jax.disable_jit():  # op by op: no whole-program compile
        jr.step_batch(2)
    tr = trender.Renderer(
        small(tscene, name, res),
        trender.RenderSettings(trace_depth=4, **settings_kw),
        device="cpu",
    )
    assert tr.step_batch(2) == 2
    assert_image_close(tr.image(), jr.image())
    np.testing.assert_array_equal(
        tr.frame_uint8(),
        np.asarray(jrender.tonemap(tr_accum_as_jax(tr), jnp.int32(2), res)),
    )


def tr_accum_as_jax(tr):
    from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3

    return JVec3(*(jnp.asarray(c.numpy()) for c in tr.accum))


@pytest.mark.parametrize("name,overrides", ANALYTIC_SMOKE)
def test_analytic_smoke_configs_match_goldens(name, overrides):
    """tools/smoke_pallas.py's image rule against the XLA path's 128x128,
    2-iteration goldens: at most 4% of clipped pixels off by > 0.05."""
    goldens = np.load(GOLDENS)
    scene = small(tscene, name, (128, 128))
    settings = trender.RenderSettings(
        trace_depth=min(scene.state.trace_depth or 8, 8), **overrides
    )
    r = trender.Renderer(scene, settings, device="cpu")
    r.step_batch(2)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0
    got = np.clip(img / 2, 0.0, 1.0)
    ref = goldens[name.replace(" ", "_")].astype(np.float32)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) > 0.05).mean() <= 0.04


def test_cli_cpu_render_imports_no_jax(tmp_path):
    """A fresh process renders 2 iterations through the CLI on the CPU,
    writes the PNG, and never imports JAX or the JAX package."""
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell32.txt"
    scene.write_text(text.replace("RES         800 800", "RES         32 32"))
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "from project3_cuda_path_tracer_tpu_torch.cli import main\n"
        f"rc = main([{str(scene)!r}, '--device', 'cpu', '--iterations', '2',"
        f" '--antialias', '--out-dir', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('project3_cuda_path_tracer_tpu.')"
        " or m == 'project3_cuda_path_tracer_tpu']\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stdout
    pngs = list(out.glob("cornell.*.2samp.png"))
    assert len(pngs) == 1


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = small(tscene, "cornell.txt", (8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trender.Renderer(scene, device="cuda")
    assert tmain([os.path.join(SCENES, "cornell.txt"), "--iterations", "1"]) == 1


@pytest.mark.parametrize(
    "name,settings_kw,what",
    [("textured.txt", {"tri_axis": "tri"}, "triangle sharding"),
     ("cornell.txt", {"tri_axis": "tri"}, "triangle sharding"),
     ("mesh.txt", {"tri_axis": "tri"}, "triangle sharding")],
)
def test_unported_features_raise(name, settings_kw, what):
    """Triangle sharding renders since the tri-shard tier landed: a
    Renderer with `tri_axis` set renders its one shard through it
    (intersect, merge, #4's plain version), on the surface-stage and mesh
    scenes as on the others, the image the untiered one's; a kernel that
    intersects inside itself refuses the setting, naming it."""
    scene = small(tscene, name, (8, 8))
    settings = trender.RenderSettings(trace_depth=3, **settings_kw)
    r = trender.Renderer(scene, settings, device="cpu")
    r.step_batch(1)
    plain = trender.Renderer(scene, trender.RenderSettings(trace_depth=3), device="cpu")
    plain.step_batch(1)
    assert r.image().max() > 0
    assert_image_close(r.image().reshape(-1, 3), plain.image().reshape(-1, 3))
    ds = tdevice.scene_to_device(scene, "cpu")
    cam = tdevice.camera_to_device(scene.state.camera, "cpu")
    with pytest.raises(ValueError, match=f"{what} \\(tri_axis\\)"):
        tmk.full_iteration(ds, cam, 1, settings, TVec3.zeros(64, "cpu"))


@pytest.mark.parametrize(
    "name,settings_kw",
    [("cornell_sss.txt", {"sort_by_material": True}),
     ("mesh_textured.txt", {"sort_by_material": True}),
     ("cornell.txt", {"sort_by_material": True})],
)
def test_sort_renders_like_unsorted(name, settings_kw):
    """Material sort renders on the CPU, on the surface-stage and mesh
    scenes as on the others, and the sorted image is the unsorted one
    (the RNG keys on the pixel, not the slot)."""
    scene = small(tscene, name, (8, 8))
    imgs = []
    for kw in ({}, settings_kw):
        r = trender.Renderer(scene, trender.RenderSettings(trace_depth=3, **kw),
                             device="cpu")
        r.step_batch(2)
        imgs.append(r.image())
    assert imgs[0].max() > 0
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("flag", ["--shard", "--preview", "--no-pallas"])
def test_cli_unported_flags_fail(flag, caplog, tmp_path, monkeypatch):
    """No flag is unported any more: --preview (the viewer, here under
    matplotlib's Agg backend) and --no-pallas render on the CPU; --shard
    renders too (tests/test_torch_shard.py), so here only a shard factor
    below 1 fails, before any render."""
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8"))
    monkeypatch.setenv("MPLBACKEND", "Agg")
    argv = [str(scene), "--device", "cpu", "--iterations", "2", "--depth", "2",
            "--out-dir", str(tmp_path), flag]
    if flag == "--shard":
        argv.append("spp=0")
        assert tmain(argv) == 1
        assert "shard factors must be >= 1" in caplog.text
        return
    caplog.set_level("INFO")
    assert tmain(argv) == 0
    assert "ROADMAP" not in caplog.text
    # the viewer steps in batches of 8 and saves at completion
    assert len(list(tmp_path.glob("cornell.*samp.png"))) == 1


@pytest.mark.parametrize("flag", ["--stats", "--sort-materials"])
def test_cli_ported_flags_render(flag, tmp_path, caplog):
    """--stats and --sort-materials render through the CLI on the CPU."""
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8"))
    caplog.set_level("INFO")
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "2", "--depth", "2",
                flag, "--out-dir", str(tmp_path)])
    assert rc == 0
    assert len(list(tmp_path.glob("cornell.*.2samp.png"))) == 1
    if flag == "--stats":
        assert "alive rays per bounce" in caplog.text and "full_iteration" in caplog.text


@pytest.mark.parametrize("flag", ["--nee", "--direct-lighting"])
def test_cli_renders_light_sampling_on_cpu(flag, tmp_path):
    """--nee and --direct-lighting render through the CLI on the CPU (the
    plain versions: no kernel launch is counted)."""
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell16.txt"
    scene.write_text(text.replace("RES         800 800", "RES         16 16"))
    launches = [tmk.full_iteration_nee.launches, tmk.bounce_step_nee.launches]
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "2",
                "--depth", "3", flag, "--out-dir", str(tmp_path)])
    assert rc == 0
    assert len(list(tmp_path.glob("cornell.*.2samp.png"))) == 1
    assert launches == [tmk.full_iteration_nee.launches,
                        tmk.bounce_step_nee.launches]


def test_checkpoint_round_trip_and_camera_reset(tmp_path):
    scene = small(tscene, "cornell.txt", (16, 16))
    r = trender.Renderer(scene, trender.RenderSettings(trace_depth=2),
                         device="cpu")
    r.step()
    r.step_batch(2)
    assert r.iteration == 3
    path = r.save_checkpoint(str(tmp_path / "ck.npz"))
    r2 = trender.Renderer(scene, trender.RenderSettings(trace_depth=2),
                          device="cpu")
    r2.load_checkpoint(path)
    assert r2.iteration == 3
    np.testing.assert_array_equal(r2.image(), r.image())
    r2.step()
    r.step()
    np.testing.assert_array_equal(r2.image(), r.image())
    png = r.save(out_dir=str(tmp_path))
    assert png.endswith(".4samp.png") and os.path.exists(png)
    r.orbit_camera(dphi=0.1)
    assert r.iteration == 0 and float(r.accum.x.abs().sum()) == 0.0
    r.pan_camera(dx=0.5)
    r.step()
    assert np.isfinite(r.image()).all()
