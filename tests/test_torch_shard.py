"""Sharding (parallel/shard.py) and the tri-shard tier on the CPU, against
the JAX package's `parallel/shard.py` and against the port's own
unsharded Renderer:

- `parse_shard_spec` on good and bad specs, as the JAX one;
- `tri_slice_scenes` / `tri_sharded_device_scenes` on mesh.txt, tri = 2
  and 3: each slice's triangles exactly the JAX slices (in order on the
  host, as a set in each slice's BVH order);
- `merge_isect_shards` exactly the JAX `_merge_isect_axis` under
  `jax.vmap(..., axis_name="tri")`, with exact ties and misses planted;
- `trace_paths(pix=...)` against the JAX `trace_paths(pix=...)` (XLA
  path, op by op), image rule;
- `ShardedRenderer` against the JAX `ShardedRenderer` on 8 virtual CPU
  devices (XLA path): spp=2 on Cornell, px=2 on Cornell with --compact,
  tri=2 on mesh.txt, image rule;
- `ShardedRenderer` against the port's `Renderer` at the same sample
  count: spp rtol 1e-6, px exact, tri by the image rule (alone, with
  sort, --direct-lighting, --nee, --motion-blur and on mesh_textured);
- checkpoints across the sharded and the sequential renderer, the spp
  mismatch refused (the JAX package's tests/test_parallel.py:597-673);
- the CLI with `--device cpu --shard px=2,tri=2`.

Every shard is on the CPU; no test starts a subprocess."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops.intersect import Intersections as JIsect
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu.parallel import shard as jshard
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline
from project3_cuda_path_tracer_tpu_torch.ops.intersect import Intersections as TIsect
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from project3_cuda_path_tracer_tpu_torch.parallel import shard as tshard
from tests.test_torch_ops import both_cameras, both_scenes
from tests.test_torch_render import SCENES, assert_image_close, small

SPECS = ["spp=4", "px=2,tri=2", " spp=2 , px=2 ,", "tri=3", "", "spp=2,spp=3"]
BAD_SPECS = ["spp", "foo=2", "px=x", "spp=2,tri"]


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


@pytest.fixture(scope="module")
def mesh_scenes():
    """mesh.txt at 16x16 for each package (loaded once)."""
    return small(jscene, "mesh.txt", (16, 16)), small(tscene, "mesh.txt", (16, 16))


# ---- parse_shard_spec, the slices, the merge ----------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_parse_shard_spec_matches_jax(spec):
    assert tshard.parse_shard_spec(spec) == jshard.parse_shard_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_shard_spec_refuses_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jshard.parse_shard_spec(spec)
    with pytest.raises(ValueError) as got:
        tshard.parse_shard_spec(spec)
    assert str(got.value) == str(want.value)


def _rows(v0, v1, v2, n0, n1, n2, uv0, uv1, uv2):
    """One (T, 24) row per triangle, in the given order."""
    return np.concatenate([np.asarray(a, np.float32).reshape(len(v0), -1)
                           for a in (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2)], 1)


@pytest.mark.parametrize("n", [2, 3])
def test_tri_slices_match_jax(n, mesh_scenes):
    """Each slice's triangles (padding included) are exactly the JAX
    package's: on the host in its order, and in the slice's DeviceScene
    (BVH-ordered) as the same set; each slice's chunk boxes cover them."""
    js, ts = mesh_scenes
    stacked = jshard.tri_sharded_device_scenes(js, n, use_bvh=False)
    host = tshard.tri_slice_scenes(ts, n)
    dev = tshard.tri_sharded_device_scenes(ts, n, lambda t: torch.device("cpu"))
    (mesh_g,) = [i for i, (_, c) in enumerate(dev[0].tri_ranges) if c]
    per = -(-int(ts.geoms.tri_count[mesh_g]) // n)
    for t in range(n):
        def col(v):
            return np.stack([np.asarray(c)[t] for c in v], -1)

        want = _rows(*(col(getattr(stacked, f"tri_{k}")) for k in ("v0", "v1", "v2",
                                                                   "n0", "n1", "n2")),
                     *(np.stack([np.asarray(getattr(stacked, f"tri_uv{i}u"))[t],
                                 np.asarray(getattr(stacked, f"tri_uv{i}v"))[t]], -1)
                       for i in range(3)))
        h = host[t].triangles
        np.testing.assert_array_equal(
            _rows(h.v0, h.v1, h.v2, h.n0, h.n1, h.n2, h.uv0, h.uv1, h.uv2), want)
        assert host[t].geoms.tri_count[mesh_g] == per
        d = dev[t]
        assert d.tri_ranges[mesh_g] == (0, per) and d.bvh_roots[mesh_g][1] > 0

        def tcol(v):
            return np.stack([c.numpy() for c in v], -1)

        got = _rows(*(tcol(getattr(d, f"tri_{k}")) for k in ("v0", "v1", "v2",
                                                             "n0", "n1", "n2")),
                    *(np.stack([getattr(d, f"tri_uv{i}u").numpy(),
                                getattr(d, f"tri_uv{i}v").numpy()], -1) for i in range(3)))
        np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                      want[np.lexsort(want.T[::-1])])


def _seeded_hits(n, P, seed):
    """n shards' hits of one pool: t in (-1, 4) with misses (-1 and 0),
    exact ties between shards planted on a quarter of the lanes (some of
    them between every shard), and random normals, materials, sides and
    UVs."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.05, 4.0, (n, P)).astype(np.float32)
    t[rng.random((n, P)) < 0.25] = -1.0
    t[rng.random((n, P)) < 0.05] = 0.0
    tie = rng.random(P) < 0.25
    pair = rng.integers(1, max(n, 2), P)
    if n > 1:
        t[pair[tie], np.nonzero(tie)[0]] = t[0, tie]
    every = rng.random(P) < 0.05
    t[:, every] = t[0, every]
    return dict(
        t=t,
        normal=rng.standard_normal((3, n, P)).astype(np.float32),
        material_id=rng.integers(-1, 9, (n, P)).astype(np.int32),
        outside=rng.random((n, P)) < 0.5,
        tex_u=rng.random((n, P)).astype(np.float32),
        tex_v=rng.random((n, P)).astype(np.float32),
        has_uv=rng.random((n, P)) < 0.5,
    )


@pytest.mark.parametrize("n", [2, 3, 4])
def test_merge_isect_shards_matches_jax(n):
    h = _seeded_hits(n, 2048, seed=n)
    jin = JIsect(t=jnp.asarray(h["t"]), normal=JVec3(*(jnp.asarray(c) for c in h["normal"])),
                 material_id=jnp.asarray(h["material_id"]), outside=jnp.asarray(h["outside"]),
                 tex_u=jnp.asarray(h["tex_u"]), tex_v=jnp.asarray(h["tex_v"]),
                 has_uv=jnp.asarray(h["has_uv"]))
    want = jax.vmap(lambda i: jrender._merge_isect_axis(i, "tri"), axis_name="tri")(jin)
    shards = [TIsect(t=torch.tensor(h["t"][d]),
                     normal=TVec3(*(torch.tensor(c[d]) for c in h["normal"])),
                     material_id=torch.tensor(h["material_id"][d]),
                     outside=torch.tensor(h["outside"][d]),
                     tex_u=torch.tensor(h["tex_u"][d]), tex_v=torch.tensor(h["tex_v"][d]),
                     has_uv=torch.tensor(h["has_uv"][d])) for d in range(n)]
    got = trender.merge_isect_shards(shards)
    for g, w in ((got.t, want.t), (got.material_id, want.material_id),
                 (got.outside, want.outside), (got.tex_u, want.tex_u),
                 (got.tex_v, want.tex_v), (got.has_uv, want.has_uv),
                 *zip(got.normal, want.normal)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])


def test_merge_of_one_shard_is_itself():
    h = _seeded_hits(1, 64, seed=0)
    one = TIsect(t=torch.tensor(h["t"][0]), normal=TVec3(*(torch.tensor(c[0]) for c in h["normal"])),
                 material_id=torch.tensor(h["material_id"][0]),
                 outside=torch.tensor(h["outside"][0]))
    assert trender.merge_isect_shards([one]) is one


# ---- trace_paths over a slice of the frame -------------------------------

def _slice_image(radiance, pix, offset, n):
    img = np.zeros((n, 3), np.float32)
    img[np.asarray(pix) - offset] = np.stack([np.asarray(c) for c in radiance], -1)
    return img


@pytest.mark.parametrize("name,settings_kw", [
    ("cornell.txt", {}),
    ("cornell.txt", {"antialias": True, "compact": True}),
    ("cornell.txt", {"antialias": True, "nee_mis": True}),
])
def test_trace_paths_pix_matches_jax_xla(name, settings_kw):
    """The second half of Cornell 32x32 (depth 3) through each package's
    `trace_paths(pix=...)`: the JAX XLA path op by op, the port's plain
    versions; image rule."""
    jd, td = both_scenes(name)
    jc, tc = both_cameras(name)
    n = 32 * 32 // 2
    offset = n
    jset = jrender.RenderSettings(trace_depth=3, use_bvh=False, use_pallas=False,
                                  **settings_kw)
    with jax.disable_jit():
        jrad, jpix, _, _ = jrender.trace_paths(
            jd, jc, jnp.int32(3), jrender._empty_cache(n), jset, False,
            offset + jnp.arange(n, dtype=jnp.int32))
    tset = trender.RenderSettings(trace_depth=3, **settings_kw)
    trad, tpix, _, _ = trender.trace_paths(
        td, tc, 3, None, tset, False,
        pix=offset + torch.arange(n, dtype=torch.int32))
    assert sorted(tpix.tolist()) == list(range(offset, offset + n))
    assert_image_close(_slice_image(trad, tpix, offset, n),
                       _slice_image(jrad, jpix, offset, n))


# ---- the sharded renderer against the JAX one ----------------------------

@pytest.mark.parametrize("name,res,settings_kw,shard", [
    ("cornell.txt", (16, 16), {}, {"spp": 2}),
    ("cornell.txt", (16, 16), {"compact": True}, {"px": 2}),
    ("mesh.txt", (32, 16), {}, {"tri": 2}),
])
def test_sharded_renderer_matches_jax(name, res, settings_kw, shard, eight_devices):
    """Two calls of each package's ShardedRenderer (depth 3; the JAX one
    on its XLA path over virtual CPU devices), image rule."""
    js = small(jscene, name, res)
    ts = small(tscene, name, res)
    n = shard.get("spp", 1) * shard.get("px", 1) * shard.get("tri", 1)
    jr = jshard.ShardedRenderer(
        js, jrender.RenderSettings(trace_depth=3, use_bvh=False, use_pallas=False,
                                   **settings_kw),
        devices=eight_devices[:n], **shard)
    jr.step_batch(2 * shard.get("spp", 1))
    tr = tshard.ShardedRenderer(ts, trender.RenderSettings(trace_depth=3, **settings_kw),
                                device="cpu", **shard)
    tr.step_batch(2 * shard.get("spp", 1))
    assert tr.iteration == jr.iteration
    got, want = tr.image(), jr.image()
    assert want.max() > 0
    assert_image_close(got.reshape(-1, 3) / tr.iteration, want.reshape(-1, 3) / jr.iteration)


# ---- the sharded renderer against the port's Renderer --------------------

def _renderer_image(scene, settings, n):
    r = trender.Renderer(scene, settings, device="cpu")
    r.step_batch(n)
    return r.image()


@pytest.mark.parametrize("settings_kw,shard", [
    ({}, {"spp": 2}),
    ({"antialias": True, "russian_roulette": True, "rr_start_depth": 1}, {"spp": 3}),
])
def test_spp_shards_equal_renderer(settings_kw, shard):
    scene = small(tscene, "cornell.txt", (16, 16))
    settings = trender.RenderSettings(trace_depth=3, **settings_kw)
    sr = tshard.ShardedRenderer(scene, settings, device="cpu", **shard)
    sr.step_batch(3)  # rounded up to whole spp batches
    assert sr.iteration == -(-3 // shard["spp"]) * shard["spp"]
    want = _renderer_image(scene, settings, sr.iteration)
    np.testing.assert_allclose(sr.image(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("settings_kw,shard", [
    ({"antialias": True}, {"px": 2}),
    ({"antialias": True, "compact": True}, {"px": 4}),
    ({"cache_first_bounce": True, "sort_by_material": True}, {"px": 2}),
    ({"direct_lighting": True}, {"px": 2, "spp": 2}),
])
def test_px_shards_equal_renderer(settings_kw, shard):
    """A pixel slice renders exactly the Renderer's pixels (each pixel's
    draws are keyed on its id, not its slot); with spp too, exactly the
    Renderer's sum of the spp shards' samples up to rounding."""
    scene = small(tscene, "cornell.txt", (16, 16))
    settings = trender.RenderSettings(trace_depth=3, **settings_kw)
    sr = tshard.ShardedRenderer(scene, settings, device="cpu", **shard)
    sr.step_batch(2)
    want = _renderer_image(scene, settings, sr.iteration)
    if "spp" in shard:
        np.testing.assert_allclose(sr.image(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(sr.image(), want)


def _moving_mesh():
    moved = small(tscene, "mesh.txt", (16, 16))
    moved.geoms.velocity[moved.geoms.gtype == tscene.GeomType.MESH] = (2.0, 0.0, 0.0)
    return moved


@pytest.mark.parametrize("name,settings_kw,shard", [
    ("mesh.txt", {"antialias": True}, {"tri": 2}),
    ("mesh.txt", {"sort_by_material": True, "compact": True}, {"tri": 3}),
    ("mesh.txt", {"direct_lighting": True}, {"tri": 2, "px": 2}),
    ("mesh.txt", {"nee_mis": True}, {"tri": 2}),
    ("moving", {"motion_blur": True, "antialias": True}, {"tri": 2, "spp": 2}),
    ("mesh_textured.txt", {"antialias": True}, {"tri": 2}),
])
def test_tri_shards_match_renderer(name, settings_kw, shard, mesh_scenes):
    """The tri-shard tier (every slice's chain, the merge, #4's plain
    version; --nee the plain estimator over merged intersects) against the
    unsharded Renderer, image rule; mesh_textured's quad carries its OBJ
    UVs through the merge."""
    scene = (_moving_mesh() if name == "moving" else
             mesh_scenes[1] if name == "mesh.txt" else small(tscene, name, (16, 16)))
    settings = trender.RenderSettings(trace_depth=3, **settings_kw)
    sr = tshard.ShardedRenderer(scene, settings, device="cpu", **shard)
    assert sr.settings.tri_axis == "tri"
    sr.step_batch(shard.get("spp", 1))
    want = _renderer_image(scene, settings, sr.iteration)
    got = sr.image()
    assert want.max() > 0 and np.isfinite(got).all()
    assert_image_close(got.reshape(-1, 3), want.reshape(-1, 3))


def test_tri_intersect_matches_unsharded_lanes():
    """One intersect of the camera rays of mesh_textured, 3 slices merged,
    against the unsharded chain by the lane rule; UVs on the quad's hits
    come through the merge."""
    scene = small(tscene, "mesh_textured.txt", (16, 16))
    settings = trender.RenderSettings(trace_depth=3, antialias=True)
    sr = tshard.ShardedRenderer(scene, settings, tri=3, device="cpu")
    r = trender.Renderer(scene, settings, device="cpu")
    pool = trender._camera_pool(r.dev_camera, 2, settings)
    got = trender.intersect_scene_any(pool[0], pool[1], None, sr.settings,
                                      shards=sr.groups[0][0])
    want = trender.intersect_scene_any(pool[0], pool[1], r.dev_scene, settings)
    assert bool(want.has_uv.any())
    # on the CPU each shard's chain is the plain one exactly
    plain = trender.merge_isect_shards([pipeline.intersect_pipeline_reference(
        pool[0], pool[1], None, sh.scene) for sh in sr.groups[0][0]])
    for g, w in zip(got.normal, plain.normal):
        assert torch.equal(g, w)
    assert torch.equal(got.t, plain.t) and torch.equal(got.tex_u, plain.tex_u)
    for g, w in ((got.t, want.t), (got.material_id, want.material_id),
                 (got.has_uv, want.has_uv), (got.tex_u, want.tex_u), *zip(got.normal, want.normal)):
        off = (g.double() - w.double()).abs() > 1e-4
        assert off.float().mean() <= 0.01


def test_fused_kernels_refuse_tri():
    """#1, #2, #3, #5, #6 and #9 intersect inside themselves: under
    tri_axis their wrappers refuse; #4 takes the merged pool."""
    scene = small(tscene, "cornell.txt", (8, 8))
    from project3_cuda_path_tracer_tpu_torch.models import device as tdevice

    ds = tdevice.scene_to_device(scene, "cpu")
    cam = tdevice.camera_to_device(scene.state.camera, "cpu")
    settings = trender.RenderSettings(trace_depth=2, tri_axis="tri")
    for call in (lambda: tmk.first_bounce(ds, cam, 1, settings),
                 lambda: tmk.full_iteration(ds, cam, 1, settings, TVec3.zeros(64, "cpu"))):
        with pytest.raises(ValueError, match="tri_axis"):
            call()
    assert not trender.whole_kernel(settings) and not trender.nee_kernel(
        trender.RenderSettings(nee_mis=True, tri_axis="tri"))
    with pytest.raises(ValueError, match="tri_axis"):
        trender.trace_paths(ds, cam, 1, None, trender.RenderSettings(trace_depth=2), False,
                            shards=(trender.TriShard(ds),))


# ---- checkpoints, devices, the CLI ---------------------------------------

def test_checkpoint_cross_resume(tmp_path):
    """The Renderer's .npz both ways (JAX tests/test_parallel.py:597-641):
    a sharded save resumes in the sequential renderer, and in a sharded
    one, continuing to the sequential render of the same samples."""
    scene = small(tscene, "cornell.txt", (16, 16))
    settings = trender.RenderSettings(trace_depth=3)
    rs = tshard.ShardedRenderer(scene, settings, spp=2, px=2, device="cpu")
    rs.step_batch(2)
    ck = str(tmp_path / "ck.npz")
    rs.save_checkpoint(ck)
    rq = trender.Renderer(scene, settings, device="cpu")
    rq.load_checkpoint(ck)
    assert rq.iteration == 2
    rq.step_batch(2)
    ref = trender.Renderer(scene, settings, device="cpu")
    ref.step_batch(4)
    np.testing.assert_allclose(rq.image(), ref.image(), rtol=1e-6, atol=1e-6)
    rs2 = tshard.ShardedRenderer(scene, settings, spp=2, px=2, device="cpu")
    rs2.load_checkpoint(ck)
    assert rs2.iteration == 2
    rs2.step_batch(2)
    np.testing.assert_allclose(rs2.image(), ref.image(), rtol=1e-6, atol=1e-6)
    ck2 = str(tmp_path / "seq.npz")
    ref.save_checkpoint(ck2)
    rs3 = tshard.ShardedRenderer(scene, settings, px=2, device="cpu")
    rs3.load_checkpoint(ck2)
    np.testing.assert_array_equal(rs3.image(), ref.image())


def test_spp_mismatch_rejected(tmp_path):
    scene = small(tscene, "cornell.txt", (16, 16))
    settings = trender.RenderSettings(trace_depth=2)
    rs = tshard.ShardedRenderer(scene, settings, spp=3, device="cpu")
    rs.step_batch(3)
    ck = str(tmp_path / "ck3.npz")
    rs.save_checkpoint(ck)
    rs2 = tshard.ShardedRenderer(scene, settings, spp=2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        rs2.load_checkpoint(ck)


def test_devices_and_refusals(monkeypatch):
    scene = small(tscene, "cornell.txt", (8, 6))
    settings = trender.RenderSettings(trace_depth=2)
    with pytest.raises(ValueError, match="needs 4 devices; 2 available"):
        tshard.ShardedRenderer(scene, settings, spp=2, px=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        tshard.ShardedRenderer(scene, settings, spp=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tshard.ShardedRenderer(scene, settings, px=5, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tshard.ShardedRenderer(scene, settings, spp=2)
    # the grid's layout: shard (s, p, t) on devices[(s*px + p)*tri + t]
    sr = tshard.ShardedRenderer(scene, settings, spp=2, px=3, tri=1,
                                devices=["cpu"] * 7)
    assert len(sr.devices) == 6 and len(sr.groups) == 2 and len(sr.groups[0]) == 3
    assert len(sr.accums) == 3 and sr.accums[0].x.shape == (16,)
    # a camera change (the chip_smoke goldens' 128x128): the shards' scenes
    # stay, the accumulator and the count start over
    sr.step_batch(2)
    cam = small(tscene, "cornell.txt", (12, 4)).state.camera
    sr.set_camera(cam)
    assert sr.iteration == 0 and sr.accums[0].x.shape == (16,)
    sr.step_batch(2)
    want = _renderer_image(small(tscene, "cornell.txt", (12, 4)), settings, 2)
    np.testing.assert_allclose(sr.image(), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        sr.set_camera(small(tscene, "cornell.txt", (5, 5)).state.camera)


def test_cli_shard_renders(tmp_path, caplog):
    """--device cpu --shard px=2,tri=2 renders mesh.txt through the CLI,
    logging the grid; --stats is dropped with a warning; a checkpoint of
    the sharded run resumes in the sequential CLI."""
    text = open(os.path.join(SCENES, "mesh.txt")).read()
    text = text.replace("RES         800 800", "RES         16 16").replace(
        "assets/", os.path.join(SCENES, "assets") + "/")
    scene = tmp_path / "mesh16.txt"
    scene.write_text(text)
    caplog.set_level("INFO")
    ck = str(tmp_path / "ck.npz")
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "1", "--depth", "2",
                "--shard", "px=2,tri=2", "--stats", "--checkpoint", ck,
                "--out-dir", str(tmp_path)])
    assert rc == 0
    assert "spp=1 px=2 tri=2, 4 shard(s) on cpu, cpu, cpu, cpu" in caplog.text
    assert "does not support --preview/--stats" in caplog.text
    assert "alive rays per bounce" not in caplog.text
    assert len(list(tmp_path.glob("mesh.*.1samp.png"))) == 1
    rc = tmain([str(scene), "--device", "cpu", "--iterations", "2", "--depth", "2",
                "--checkpoint", ck, "--out-dir", str(tmp_path)])
    assert rc == 0 and "resumed from" in caplog.text
    assert len(list(tmp_path.glob("mesh.*.2samp.png"))) == 1
