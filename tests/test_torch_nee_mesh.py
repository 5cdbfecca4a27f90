"""--nee (NEE + MIS at every non-delta vertex) on mesh scenes: the port's
plain estimator, which is the plain version of kernels #5 and #6, against
the JAX package from identical tables (the JAX DeviceScene handed over).

- `_nee_mis_bounce`, one bounce, against the JAX XLA `_nee_mis_bounce`
  under the lane rule of tests/test_megakernel.py:57-99 (and the MIS aux
  on lanes alive after the bounce): mesh.txt and mesh_textured.txt at
  32x32, mesh_big.txt at 16x16 (one bounce only);
  (and on mesh.txt under --no-bvh: the naive sweep on both sides);
- `trace_paths` under --nee against the JAX XLA path under the image rule
  of tests/test_nee_megakernel.py (median under 1e-5, under 3% of values
  off by more than 1e-3), on mesh.txt with AA and Russian roulette, and
  with the icosphere moving under --motion-blur;
- the plain #6 (`full_iteration_nee_reference`) against the JAX
  `full_iteration_nee_pallas` in interpret mode on mesh.txt, by that
  rule;
- the Renderer (`step_batch`: #6's plain version; `step()`: #5's) and the
  CLI with --nee on the CPU, and the mesh geoms' BVH roots that the NEE
  kernels read (`pack_nee_bvh`)."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import megakernel as jmk
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.cli import main as tmain
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.conftest import SCENES
from tests.test_torch_nee import assert_aux_close, assert_nee_image_close, to_jax
from tests.test_torch_ops import assert_state_close
from tests.test_torch_render import small
from tests.test_torch_scene import jax_scene_numpy


@functools.lru_cache(maxsize=None)
def both(name, res=(32, 32), mesh_velocity=None):
    """(JAX DeviceScene, port DeviceScene over the same tables, JAX
    camera, port camera) of a mesh scene at `res`, with the BVH; with
    `mesh_velocity` (x, y, z) every mesh geom moves (VELOCITY)."""
    js = jscene.load_scene(os.path.join(SCENES, name))
    if mesh_velocity is not None:
        js.geoms.velocity[js.geoms.gtype == jscene.GeomType.MESH] = mesh_velocity
    c = js.state.camera
    js.state.camera = jscene.derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    jd = jdevice.scene_to_device(js, use_bvh=True)
    td = tdevice.device_scene_from_numpy(*jax_scene_numpy(jd), "cpu")
    jc = jdevice.camera_to_device(js.state.camera)
    tc = tdevice.DeviceCamera(
        **{f: torch.tensor(np.asarray(getattr(jc, f)))
           for f in ("position", "view", "up", "right", "pixel_length",
                     "aperture", "focal_distance")},
        resolution=jc.resolution,
    )
    assert td.mesh_geoms
    return jd, td, jc, tc


def settings_pair(depth, use_bvh=True, **kw):
    return (trender.RenderSettings(trace_depth=depth, nee_mis=True,
                                   use_bvh=use_bvh, **kw),
            jrender.RenderSettings(trace_depth=depth, nee_mis=True,
                                   use_bvh=use_bvh, use_pallas=False, **kw))


def camera_state(tc, it, tset):
    origins, dirs, pix = generate_rays(tc, it, tset.antialias,
                                       tset.depth_of_field)
    P = pix.shape[0]
    state = (origins, dirs, TVec3.ones(P, "cpu"), TVec3.zeros(P, "cpu"),
             torch.ones(P, dtype=torch.bool), pix)
    return state, (torch.zeros(P), torch.zeros(P, dtype=torch.bool))


def image(radiance, pix):
    """Per-slot radiance in pixel order, (P,3)."""
    out = np.zeros((np.asarray(pix).shape[0], 3), np.float32)
    out[np.asarray(pix)] = np.stack([np.asarray(c) for c in radiance], -1)
    return out


@pytest.mark.parametrize("name,res,depth,use_bvh", [
    ("mesh.txt", (32, 32), 0, True),
    ("mesh.txt", (32, 32), 1, True),
    ("mesh.txt", (32, 32), 1, False),
    ("mesh_textured.txt", (32, 32), 0, True),
    ("mesh_big.txt", (16, 16), 0, True),
])
def test_nee_mis_bounce_on_mesh_matches_jax(name, res, depth, use_bvh):
    """One bounce from the same state: at depth 0 the camera rays (AA)
    with the aux at zeros; at depth 1 the port's own depth-0 output. The
    mesh is hit, and some shadow rays are cast toward the light. Under
    --no-bvh (use_bvh False) both estimators take the naive triangle
    sweep for the hit and the shadow ray (the port's two intersect calls
    counted)."""
    jd, td, _, tc = both(name, res)
    tset, jset = settings_pair(4, use_bvh=use_bvh, antialias=True)
    it = 3
    state, aux = camera_state(tc, it, tset)
    if depth == 1:
        state, aux = trender._nee_mis_bounce(state, aux, td, it, 0, tset, False)
    jstate, jaux = to_jax(state, aux)
    want, want_aux = jrender._nee_mis_bounce(jstate, jaux, jd, jnp.int32(it),
                                             depth, jset, False)
    probe = {}
    calls = []
    plain = trender.intersect_scene

    def counted(*a, **k):
        calls.append(k["use_bvh"])
        return plain(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trender, "intersect_scene", counted)
        got, got_aux = trender._nee_mis_bounce(state, aux, td, it, depth, tset,
                                               False, probe=probe)
    assert calls == [use_bvh, use_bvh]
    assert_state_close(got, want)
    assert_aux_close(got, got_aux, want, want_aux)
    assert probe["shadow"].any() and (probe["shadow"] & probe["visible"]).any()
    mesh_mats = {int(td.geom_material_id[g]) for g in td.mesh_geoms}
    hit = plain(state[0], state[1], td)
    assert np.isin(hit.material_id.numpy(), list(mesh_mats)).any()


def jax_render(jd, jc, it, jset, P):
    """One iteration of the JAX XLA path, compiled (its BVH walks run
    op by op too slowly): (pixel radiance (P,3), alive counts)."""
    accum, _, counts = jrender.render_iteration(
        jd, jc, JVec3.zeros((P,)), jnp.int32(it), jrender._empty_cache(P),
        jset, False)
    return np.stack([np.asarray(c) for c in accum], -1), counts


def test_mesh_trace_paths_nee_matches_jax_xla():
    """trace_paths under --nee on mesh.txt (the #5 route: plain
    generate_rays, then #5's plain version at every depth), depth 2, AA
    and Russian roulette from depth 1 (one configuration: the JAX side
    compiles each)."""
    jd, td, jc, tc = both("mesh.txt")
    tset, jset = settings_pair(2, antialias=True, russian_roulette=True,
                               rr_start_depth=1)
    P = 32 * 32
    it = 2
    launches = [tmk.bounce_step_nee.launches, tpipe.mesh_candidates.launches]
    want, jcounts = jax_render(jd, jc, it, jset, P)
    trad, tpix, _, tcounts = trender.trace_paths(td, tc, it, None, tset, False)
    assert launches == [tmk.bounce_step_nee.launches, tpipe.mesh_candidates.launches]
    assert sorted(tpix.tolist()) == list(range(P))
    got = image(trad, tpix)
    assert_nee_image_close(got, want)
    assert got.max() > 0
    assert int(tcounts[-1]) == 0  # both estimators end every lane
    assert np.abs(tcounts.numpy() - np.asarray(jcounts)).max() <= 0.02 * P


def test_moving_mesh_trace_paths_nee_matches_jax_xla():
    """trace_paths under --nee --motion-blur on mesh.txt with the
    icosphere moving (VELOCITY 2 0 0): the #5 route on the geoms moved to
    the iteration's shutter time (the port re-packs only xf and inv, which
    the mesh walks read for the object ray, the bound and the world
    distance), depth 2, AA."""
    jd, td, jc, tc = both("mesh.txt", mesh_velocity=(2.0, 0.0, 0.0))
    (g,) = td.mesh_geoms
    assert td.geom_velocity[g].tolist() == [2.0, 0.0, 0.0]
    tset, jset = settings_pair(2, antialias=True, motion_blur=True)
    P = 32 * 32
    it = 3
    assert trender.shutter_time(it) > 0.05  # the icosphere moves
    launches = tmk.bounce_step_nee.launches
    want, _ = jax_render(jd, jc, it, jset, P)
    trad, tpix, _, _ = trender.trace_paths(td, tc, it, None, tset, False)
    assert tmk.bounce_step_nee.launches == launches
    got = image(trad, tpix)
    assert_nee_image_close(got, want)
    assert got.max() > 0
    # the icosphere the walks meet has moved
    moved = tdevice.advance_time(td, trender.shutter_time(it))
    assert float(moved.transform[g][0, 3] - td.transform[g][0, 3]) > 0.1


def test_full_iteration_nee_reference_on_mesh_matches_pallas():
    """The plain #6 (the wrapper on CPU tensors) against the JAX package's
    `full_iteration_nee_pallas` in interpret mode (its in-kernel mesh
    test and the shadow rays' capped sweep), mesh.txt at 32x32 (the JAX
    test's size), AA, one iteration at depth 1 (the JAX test's 3, cut for
    time): every lane's camera-ray hit, its light sample's shadow ray and
    its emission, on the icosphere and the walls alike."""
    res = (32, 32)
    jd, td, jc, tc = both("mesh.txt", res)
    tset, _ = settings_pair(1, antialias=True)
    jset = jrender.RenderSettings(trace_depth=1, nee_mis=True, antialias=True,
                                  use_pallas=True)
    aw = jrender._lights_area_weight(jd)
    want = jmk.full_iteration_nee_pallas(
        jd, jmk.pack_camera(jc), aw, jnp.int32(1), jset, res, 0,
        interpret=True,
    )
    launches = tmk.full_iteration_nee.launches
    accum = TVec3.zeros(res[0] * res[1], "cpu")
    tmk.full_iteration_nee(td, tc, 1, tset, accum)
    assert tmk.full_iteration_nee.launches == launches  # CPU: plain version
    got = np.stack([c.numpy() for c in accum])
    assert_nee_image_close(got, np.stack([np.asarray(c) for c in want]))
    assert got.max() > 0


def test_renderer_and_cli_render_mesh_nee_on_cpu(tmp_path):
    """Renderer(mesh scene, --nee) builds on the CPU (no refusal) and
    renders through step_batch (#6's plain version) and step() (#5's),
    the same iteration by either route within the image rule, no kernel
    launch counted; the CLI renders mesh.txt --nee."""
    scene = small(tscene, "mesh.txt", (16, 16))
    settings = trender.RenderSettings(trace_depth=3, nee_mis=True, antialias=True)
    assert trender.nee_kernel(settings)
    counted = (tmk.full_iteration_nee, tmk.bounce_step_nee,
               tpipe.mesh_candidates, tpipe.bounce_step_mesh)
    launches = [f.launches for f in counted]
    images = []
    for route in ("step_batch", "step"):
        r = trender.Renderer(scene, settings, device="cpu")
        r.step_batch(1) if route == "step_batch" else r.step()
        assert r.iteration == 1
        img = r.image()
        assert np.isfinite(img).all() and img.max() > 0
        images.append(img)
    assert launches == [f.launches for f in counted]
    assert_nee_image_close(images[0], images[1])

    text = open(os.path.join(SCENES, "mesh.txt")).read()
    path = tmp_path / "mesh16.txt"
    path.write_text(text.replace("RES         800 800", "RES         16 16")
                    .replace("assets/", os.path.join(SCENES, "assets") + "/"))
    out = tmp_path / "out"
    assert tmain([str(path), "--device", "cpu", "--iterations", "1",
                  "--depth", "2", "--nee", "--out-dir", str(out)]) == 0
    assert len(list(out.glob("mesh.*.1samp.png"))) == 1


@pytest.mark.parametrize("name", ["mesh.txt", "mesh_textured.txt"])
def test_pack_mesh_roots_is_bvh_roots(name):
    """The (M,2) roots the NEE kernels start their walks at: every mesh
    geom's (first node, node count) of scene.bvh_roots, in mesh order,
    packed only with `nee`; the mesh pipeline's `geoms` table is left as
    it was."""
    _, td, _, _ = both(name)
    t = tmk.pack_scene_tables(td, nee=True)
    assert t.roots.dtype == torch.int32
    np.testing.assert_array_equal(
        t.roots.numpy(), np.array([td.bvh_roots[g] for g in td.mesh_geoms]))
    assert (t.roots[:, 1] > 0).all()
    np.testing.assert_array_equal(t.mesh[3][:, 0].numpy(), td.mesh_geoms)
    assert tmk.pack_scene_tables(td).roots is None
    assert tmk.pack_scene_tables(tdevice.scene_to_device(
        tscene.load_scene(os.path.join(SCENES, "cornell.txt")), "cpu"), nee=True).roots is None
