"""The port's debug nets (utils/debug.py) on the CPU: `assert_finite`
raises the JAX function's exception with its message on the same arrays;
`bounds_sweep` is clean on Cornell, mesh.txt, mesh_big and textured, and
`validate_tables` catches one planted fault per table (a material id, a
texture id, a BVH child in the binary and the wide BVH, a triangle range,
a light id), naming the table; the glue's index check catches an
out-of-range permutation, naming the op and the port's file:line;
--debug-nans is silent on clean scenes and, with a NaN planted in a
material colour, names the stage and the aten op; and the CLI's --debug
and --debug-nans exit 0 on a clean scene and 1 on a NaN one. 16x16
scenes, mesh_big loaded once."""

import dataclasses
import os
from collections import namedtuple

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.utils import debug as jdebug
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops.megakernel import pack_scene_tables
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
from project3_cuda_path_tracer_tpu_torch.utils import debug
from tests.conftest import SCENES
from tests.test_torch_render import small

JVec = namedtuple("JVec", "x y z")
RES = (16, 16)


def renderer(name, **kw):
    return trender.Renderer(small(tscene, name, RES),
                            trender.RenderSettings(trace_depth=3, **kw), device="cpu")


@pytest.fixture(scope="module")
def big():
    return renderer("mesh_big.txt")


@pytest.mark.parametrize("bad", ["nan", "inf", None])
def test_assert_finite_as_jax(bad):
    rng = np.random.default_rng(0)
    lanes = [rng.random(64).astype(np.float32) for _ in range(3)]
    if bad:
        lanes[1][[3, 9, 11]] = float(bad)
    errs = []
    for fn, acc in ((jdebug.assert_finite, JVec(*lanes)),
                    (debug.assert_finite, Vec3(*(torch.tensor(a) for a in lanes)))):
        try:
            fn(acc, 7)
            errs.append(None)
        except FloatingPointError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (bad is None)


@pytest.mark.parametrize("name,kw", [
    ("cornell.txt", {}), ("cornell.txt", {"compact": True, "sort_by_material": True}),
    ("mesh.txt", {"cache_first_bounce": True}), ("textured.txt", {}),
    ("cornell.txt", {"direct_lighting": True}),
])
def test_bounds_sweep_clean(name, kw):
    r = renderer(name, **kw)
    debug.bounds_sweep(r)
    debug.validate_tables(r.dev_scene, pack_scene_tables(r.dev_scene))


def test_bounds_sweep_clean_on_mesh_big(big):
    debug.bounds_sweep(big)
    debug.validate_tables(big.dev_scene, pack_scene_tables(big.dev_scene))


def _planted(scene_name, plant, big_renderer=None):
    r = big_renderer if big_renderer is not None else renderer(scene_name)
    ds = dataclasses.replace(r.dev_scene)
    tables = pack_scene_tables(ds, nee=True)
    return plant(ds, tables)


def _set(t, index, value):
    t = t.clone()
    t[index] = value
    return t


@pytest.mark.parametrize("scene_name,what,plant", [
    ("cornell.txt", "geom_material_id",
     lambda ds, t: (dataclasses.replace(
         ds, geom_material_id=_set(ds.geom_material_id, 2, 99)), t)),
    ("cornell.txt", "tables.gmat", lambda ds, t: (ds, t._replace(gmat=_set(t.gmat, 0, -1)))),
    ("textured.txt", "mat_tex_id",
     lambda ds, t: (dataclasses.replace(
         ds, mat_tex_id=torch.where(ds.mat_tex_kind == 2, 7, ds.mat_tex_id)), t)),
    ("mesh.txt", "bvh_skip",
     lambda ds, t: (dataclasses.replace(ds, bvh_skip=_set(ds.bvh_skip, 1, 10**6)), t)),
    ("mesh.txt", "wide.ref inner child",
     lambda ds, t: (ds, t._replace(wide=t.wide._replace(ref=_set(
         t.wide.ref, (0, 0, int(torch.nonzero(t.wide.ref[0, 1] == 0)[0, 0])), 10**6))))),
    ("mesh.txt", "tri_ranges",
     lambda ds, t: (dataclasses.replace(ds, tri_ranges=tuple(
         (s, c + 5) if c else (s, c) for s, c in ds.tri_ranges)), t)),
    ("cornell.txt", "tables.lights", lambda ds, t: (ds, t._replace(lights=_set(t.lights, 0, 40)))),
])
def test_validate_tables_catches_planted_faults(scene_name, what, plant):
    ds, tables = _planted(scene_name, plant)
    with pytest.raises(IndexError, match=f"validate_tables: {what}"):
        debug.validate_tables(ds, tables)


def test_validate_tables_catches_big_mesh_chunks(big):
    def plant(ds, t):
        g = ds.mesh_geoms[0]
        c0, cn = ds.chunk_ranges[g]
        ranges = list(ds.chunk_ranges)
        ranges[g] = (c0 + 3, cn)
        return dataclasses.replace(ds, chunk_ranges=tuple(ranges)), t

    ds, tables = _planted("mesh_big.txt", plant, big)
    with pytest.raises(IndexError, match="validate_tables: chunk_ranges"):
        debug.validate_tables(ds, tables)


def test_glue_permutation_out_of_range_is_caught(monkeypatch):
    """A compaction permutation one past the pool: the gather that would
    read it raises IndexError naming the op and the port's file:line."""
    r = renderer("cornell.txt", compact=True)
    P = r.camera.pixel_count
    permute = trender._permute_state
    monkeypatch.setattr(trender, "_permute_state",
                        lambda st, perm: permute(st, torch.where(perm == 0, P, perm)))
    with pytest.raises(IndexError) as e:
        debug.bounds_sweep(r)
    msg = str(e.value)
    assert f"index {P} out of range" in msg
    assert "Tensor.__getitem__" in msg
    assert "project3_cuda_path_tracer_tpu_torch/render.py:" in msg, msg
    assert "(_permute_state)" in msg


def test_index_checks_ops():
    """Each checked op: in range passes through, out of range raises."""
    x = torch.arange(10.0)
    idx = torch.tensor([0, 10])
    with debug.index_checks():
        assert x[torch.tensor([1, -1])].tolist() == [1.0, 9.0]
        for call in (lambda: x[idx], lambda: x.index_select(0, idx),
                     lambda: torch.gather(x, 0, idx), lambda: torch.take(x, idx),
                     lambda: x.clone().index_add_(0, idx, torch.ones(2)),
                     lambda: x.clone().scatter_add_(0, idx, torch.ones(2)),
                     lambda: x.clone().index_put_((idx,), torch.ones(2)),
                     lambda: x.clone().__setitem__(idx, 0.0)):
            with pytest.raises(IndexError, match="out of range"):
                call()


@pytest.mark.parametrize("name,kw", [
    ("cornell.txt", {}), ("cornell.txt", {"nee_mis": True}),
    ("mesh.txt", {"antialias": True}), ("textured.txt", {"compact": True}),
])
def test_debug_nans_clean(name, kw):
    r = renderer(name, **kw)
    with debug.checks(nans=True):
        r.step_batch(2)
        r.step()
    assert np.isfinite(r.image()).all()


def test_debug_nans_names_stage_and_op():
    r = renderer("cornell.txt")
    r.dev_scene.mat_color.x[1] = float("nan")
    with debug.checks(nans=True), pytest.raises(FloatingPointError) as e:
        r.step_batch(1)
    msg = str(e.value)
    assert "stage full_iteration (plain version)" in msg
    assert "NaN lane" in msg and "scene.mat_color.x" in msg
    assert "aten.index" in msg and "(_gather_materials)" in msg, msg
    with debug.checks(nans=True), pytest.raises(FloatingPointError, match="stage first_bounce"):
        r.step()
    assert not debug.STATE.nans and not debug.STATE.launches


def _scene_file(tmp_path, colour="0.98 0.98 0.98"):
    text = open(os.path.join(SCENES, "cornell.txt")).read()
    text = text.replace("RES         800 800", "RES         8 8")
    text = text.replace("RGB         .98 .98 .98", f"RGB         {colour}", 1)
    path = tmp_path / "cornell8.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("flag", ["--debug", "--debug-nans"])
def test_cli_debug_flags(tmp_path, caplog, flag):
    caplog.set_level("INFO")
    argv = ["--device", "cpu", "--iterations", "2", "--depth", "2",
            "--out-dir", str(tmp_path), flag]
    assert tmain([_scene_file(tmp_path)] + argv) == 0
    assert len(list(tmp_path.glob("cornell.*.2samp.png"))) == 1
    # a NaN colour: the check fails and the run exits non-zero
    assert tmain([_scene_file(tmp_path, "nan 0.5 0.5")] + argv) == 1
    assert ("non-finite values" if flag == "--debug" else "--debug-nans: stage") in caplog.text


def test_launch_check_names_the_kernel(monkeypatch):
    """checkCUDAError's contract: a fault the synchronize after a launch
    reports is raised naming the kernel."""
    def fault(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", fault)
    with pytest.raises(RuntimeError, match=r"kernel bounce_step \(pt_bounce_step\) failed"):
        debug.check_launch("bounce_step", "pt_bounce_step")
