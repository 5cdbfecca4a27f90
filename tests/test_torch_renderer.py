"""The port's renderer on the per-bounce path, on the CPU: compaction,
the first-bounce cache and zero-velocity motion blur are neutral; the
cache survives checkpoints correctly; the new configs pass the golden
rule; the CLI takes the new flags; and no module of the port imports
JAX or the JAX package."""

import ast
import os

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from tests.conftest import REPO_ROOT, SCENES
from tests.test_torch_render import GOLDENS, small


def render(scene, n, step=False, **kw):
    r = trender.Renderer(scene, trender.RenderSettings(trace_depth=8, **kw),
                         device="cpu")
    if step:
        for _ in range(n):
            r.step()
    else:
        r.step_batch(n)
    return r


@pytest.mark.parametrize("step", [False, True])
@pytest.mark.parametrize("toggle", [
    {"compact": True},
    {"cache_first_bounce": True},
    {"motion_blur": True},  # cornell's geoms have zero velocity
    {"compact": True, "cache_first_bounce": True, "russian_roulette": True},
])
def test_toggles_are_neutral(toggle, step):
    """The RNG keys on pixelIndex, not pool slot, and the cache holds
    exactly what the fresh depth-0 intersect computes: the images agree
    to atol 1e-5, through step_batch and through step()."""
    scene = small(tscene, "cornell.txt", (32, 32))
    rr = {"russian_roulette": True} if toggle.get("russian_roulette") else {}
    base = render(scene, 3, step=step, **rr).image()
    got = render(scene, 3, step=step, **toggle).image()
    np.testing.assert_allclose(got, base, rtol=0, atol=1e-5)


def test_moving_sphere_blurs(tmp_path):
    """tests/test_features.py's moving emissive sphere lights more pixels
    with motion blur on than off."""
    text = open(os.path.join(SCENES, "sphere.txt")).read()
    path = tmp_path / "moving.txt"
    path.write_text(
        text.replace("SCALE       3 3 3", "SCALE       3 3 3\nVELOCITY    6 0 0")
    )
    scene = tscene.load_scene(str(path))
    c = scene.state.camera
    scene.state.camera = tscene.derive_camera(
        (32, 32), c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    static = render(scene, 16).image() / 16
    moving = render(scene, 16, motion_blur=True).image() / 16
    lit_static = (static.sum(-1) > 0.05).mean()
    lit_moving = (moving.sum(-1) > 0.05).mean()
    assert lit_moving > lit_static * 1.2, (lit_static, lit_moving)


def test_step_fills_alive_counts_and_cache():
    scene = small(tscene, "cornell.txt", (16, 16))
    r = render(scene, 1, step=True, cache_first_bounce=True, compact=True)
    counts = r.last_alive_counts.numpy()
    assert counts.shape == (8,) and (np.diff(counts) <= 0).all()
    assert 0 < counts[0] < 256
    assert r.cache_valid and (r.cache.t.numpy() > 0).mean() > 0.5
    # AA turns the cache off: nothing is cached
    r = render(scene, 1, step=True, cache_first_bounce=True, antialias=True)
    assert not r.cache_valid


def test_checkpoint_resume_with_first_bounce_cache(tmp_path):
    """After load_checkpoint the zeroed cache is not trusted: the next
    step rebuilds it and matches the uninterrupted render."""
    scene = small(tscene, "cornell.txt", (32, 32))
    r = render(scene, 2, step=True, cache_first_bounce=True)
    ck = r.save_checkpoint(str(tmp_path / "ck.npz"))
    r2 = trender.Renderer(
        scene, trender.RenderSettings(trace_depth=8, cache_first_bounce=True),
        device="cpu",
    )
    r2.load_checkpoint(ck)
    assert not r2.cache_valid
    before = r2.image().sum()
    r2.step()
    assert r2.image().sum() - before > 0.0
    assert r2.cache_valid
    r.step()
    np.testing.assert_allclose(r2.image(), r.image(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("step", [False, True])
@pytest.mark.parametrize("name,key,overrides", [
    ("checker.txt", "checker.txt", {}),
    ("cornell.txt", "cornell.txt_--stratified", {"stratified": True}),
    ("cornell.txt", "cornell.txt_--sobol", {"sobol": True}),
])
def test_new_smoke_configs_match_goldens(name, key, overrides, step):
    """tools/smoke_pallas.py's image rule against the XLA path's 128x128,
    2-iteration goldens: at most 4% of clipped pixels off by > 0.05."""
    goldens = np.load(GOLDENS)
    scene = small(tscene, name, (128, 128))
    r = trender.Renderer(
        scene,
        trender.RenderSettings(trace_depth=min(scene.state.trace_depth or 8, 8),
                               **overrides),
        device="cpu",
    )
    if step:
        r.step()
        r.step()
    else:
        r.step_batch(2)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0
    got = np.clip(img / 2, 0.0, 1.0)
    ref = goldens[key].astype(np.float32)
    assert (np.abs(got - ref) > 0.05).mean() <= 0.04


def test_whole_kernel_predicate():
    s = trender.RenderSettings
    assert trender.whole_kernel(s(antialias=True, stratified=True, sobol=True))
    assert trender.whole_kernel(s(cache_first_bounce=True, antialias=True))
    assert not trender.whole_kernel(s(compact=True))
    assert not trender.whole_kernel(s(cache_first_bounce=True))
    assert not trender.whole_kernel(s(motion_blur=True))


@pytest.mark.parametrize("flag", ["--compact", "--cache-first-bounce",
                                  "--motion-blur", "--stratified", "--sobol"])
def test_cli_accepts_slice_flags(flag, tmp_path):
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell16.txt"
    scene.write_text(text.replace("RES         800 800", "RES         16 16"))
    launches = [f.launches for f in (tmk.full_iteration, tmk.first_bounce,
                                     tmk.bounce_step, tmk.shade_step)]
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "2",
                "--depth", "3", flag, "--out-dir", str(tmp_path)])
    assert rc == 0
    assert len(list(tmp_path.glob("cornell.*.2samp.png"))) == 1
    # CPU: the plain versions, no kernel launch counted
    assert launches == [f.launches for f in (
        tmk.full_iteration, tmk.first_bounce, tmk.bounce_step, tmk.shade_step)]


def test_cli_sorts_and_refusals_name_their_module(tmp_path, caplog):
    """--sort-materials renders through the CLI; no flag is refused any
    more (`UNPORTED_FLAGS` is gone with ROADMAP §1 module 5), and --debug
    renders after a clean bounds sweep."""
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    scene = tmp_path / "cornell8.txt"
    scene.write_text(text.replace("RES         800 800", "RES         8 8"))
    assert tmain([str(scene), "--device", "cpu", "--iterations", "1", "--depth", "2",
                  "--sort-materials", "--compact", "--out-dir", str(tmp_path)]) == 0
    from project3_cuda_path_tracer_tpu_torch import cli

    assert not hasattr(cli, "UNPORTED_FLAGS")
    assert not hasattr(cli, "refuse_unported")
    caplog.set_level("INFO")
    argv = [str(scene), "--device", "cpu", "--debug", "--iterations", "1",
            "--depth", "2", "--out-dir", str(tmp_path)]
    assert tmain(argv) == 0
    assert "bounds sweep clean" in caplog.text


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port and chip_smoke.py, read as source: no
    import of jax or of the JAX package, at any depth of the file."""
    pkg = os.path.join(REPO_ROOT, "project3_cuda_path_tracer_tpu_torch")
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "project3_cuda_path_tracer_tpu"), (
                f, mod)
