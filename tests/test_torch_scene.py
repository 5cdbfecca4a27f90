"""The port's scene parser and device tables against the JAX package's:
for the six analytic smoke scenes the tables and flags must be exactly
equal, the camera derivation identical, and a mesh geom above the dense
route's 16,384 triangles built for the sorted route."""

import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops.megakernel import (
    MAT_COLS,
    pack_camera,
    pack_scene_tables,
)
from tests.conftest import SCENES

ANALYTIC = [
    "cornell.txt",
    "sphere.txt",
    "cornell_glass.txt",
    "cornell_dof.txt",
    "env.txt",
    "many_materials.txt",
]


def jax_scene_numpy(ds):
    """The JAX package's DeviceScene as (fields, meta) numpy dicts."""
    fields = {n: np.asarray(getattr(ds, n)) for n in tdevice.ARRAY_FIELDS}
    for n in tdevice.VEC3_FIELDS:
        fields[n] = np.stack([np.asarray(c) for c in getattr(ds, n)], -1)
    meta = {n: getattr(ds, n) for n in tdevice.META_FIELDS}
    return fields, meta


def torch_scene_numpy(ds):
    fields = {n: getattr(ds, n).numpy() for n in tdevice.ARRAY_FIELDS}
    for n in tdevice.VEC3_FIELDS:
        fields[n] = np.stack([c.numpy() for c in getattr(ds, n)], -1)
    meta = {n: getattr(ds, n) for n in tdevice.META_FIELDS}
    return fields, meta


def assert_scene_tables_equal(a, b):
    fa, ma = a
    fb, mb = b
    assert ma == mb
    assert set(fa) == set(fb)
    for n in fa:
        assert fa[n].shape == fb[n].shape, n
        np.testing.assert_array_equal(fa[n], fb[n], err_msg=n)


@pytest.mark.parametrize("name", ANALYTIC)
def test_scene_tables_equal_jax(name):
    path = os.path.join(SCENES, name)
    js = jscene.load_scene(path)
    ts = tscene.load_scene(path)
    # host-side parse: same geoms, materials, camera and environment
    for f in ("gtype", "material_id", "transform", "inverse_transform",
              "inv_transpose", "velocity"):
        np.testing.assert_array_equal(
            getattr(ts.geoms, f), getattr(js.geoms, f), err_msg=f
        )
    for f in ("color", "specular_exponent", "specular_color",
              "has_reflective", "has_refractive", "index_of_refraction",
              "emittance", "subsurface", "tex_kind", "bump_id"):
        np.testing.assert_array_equal(
            getattr(ts.materials, f), getattr(js.materials, f), err_msg=f
        )
    np.testing.assert_array_equal(ts.env_color, js.env_color)
    assert ts.state.iterations == js.state.iterations
    assert ts.state.trace_depth == js.state.trace_depth
    assert ts.state.image_name == js.state.image_name

    jd = jdevice.scene_to_device(js, use_bvh=False)
    td = tdevice.scene_to_device(ts, "cpu")
    assert_scene_tables_equal(torch_scene_numpy(td), jax_scene_numpy(jd))
    assert td.geom_material_id.dtype == torch.int32

    jc = jdevice.camera_to_device(js.state.camera)
    tc = tdevice.camera_to_device(ts.state.camera, "cpu")
    assert tc.resolution == jc.resolution
    for f in ("position", "view", "up", "right", "pixel_length",
              "aperture", "focal_distance"):
        np.testing.assert_array_equal(
            getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f
        )


@pytest.mark.parametrize(
    "res,fovy,aperture,focal",
    [((32, 32), 45.0, 0.0, 0.0), ((96, 54), 30.0, 0.35, 9.5),
     ((800, 800), 45.0, 0.0, 0.0)],
)
def test_derive_camera_equal_jax(res, fovy, aperture, focal):
    args = (res, np.array([0.0, 5.0, 10.5]), np.array([0.5, 4.0, 0.0]),
            np.array([0.0, 1.0, 0.0]), fovy, aperture, focal)
    jc = jscene.derive_camera(*args)
    tc = tscene.derive_camera(*args)
    assert tc.resolution == jc.resolution
    for f in ("position", "look_at", "view", "up", "right", "fov",
              "pixel_length"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    assert (tc.aperture, tc.focal_distance) == (jc.aperture, jc.focal_distance)


@pytest.mark.parametrize("name", ["cornell_glass.txt", "many_materials.txt"])
def test_device_scene_from_numpy_round_trip(name):
    """The JAX package's tables handed over as numpy build the same
    DeviceScene as the port's own parse, and survive a second trip."""
    path = os.path.join(SCENES, name)
    jd = jdevice.scene_to_device(jscene.load_scene(path), use_bvh=False)
    fields, meta = jax_scene_numpy(jd)
    from_jax = tdevice.device_scene_from_numpy(fields, meta, "cpu")
    own = tdevice.scene_to_device(tscene.load_scene(path), "cpu")
    assert_scene_tables_equal(torch_scene_numpy(from_jax), torch_scene_numpy(own))
    again = tdevice.device_scene_from_numpy(*torch_scene_numpy(from_jax), "cpu")
    assert_scene_tables_equal(torch_scene_numpy(again), torch_scene_numpy(own))

    # the kernel's packed tables carry the same numbers
    t = pack_scene_tables(own)
    G, M = len(own.gtypes), own.mat_emittance.shape[0]
    assert t.xf.shape == (G, 16) and t.mat.shape == (M, MAT_COLS)
    np.testing.assert_array_equal(t.xf.numpy(), fields["transform"].reshape(G, 16))
    np.testing.assert_array_equal(t.gtype.numpy(), np.asarray(meta["gtypes"]))
    np.testing.assert_array_equal(t.mat[:, 9].numpy(), fields["mat_emittance"])
    cam = tdevice.camera_to_device(tscene.load_scene(path).state.camera, "cpu")
    assert pack_camera(cam).shape == (16,)


def test_mesh_scene_raises():
    """A mesh geom above 16,384 triangles (mesh_big.txt's 51,200) is no
    longer refused: the Renderer builds it, with the chunk and supernode
    tables of the sorted route. Nor is a mesh scene under --nee: the
    Renderer builds it, and its tables carry the BVH roots of the NEE
    kernels' walks."""
    scene = tscene.load_scene(os.path.join(SCENES, "mesh_big.txt"))
    assert int(scene.geoms.tri_count.max()) == 51_200
    r = trender.Renderer(scene, device="cpu")
    (g,) = r.dev_scene.mesh_geoms
    assert r.dev_scene.super_ranges[g] == (0, 50)
    assert r.dev_scene.mesh_chunk_aabbs.shape == (1600, 8)
    r = trender.Renderer(tscene.load_scene(os.path.join(SCENES, "mesh.txt")),
                         trender.RenderSettings(nee_mis=True), device="cpu")
    assert r.settings.nee_mis and r.dev_scene.mesh_geoms
    assert trender.nee_kernel(r.settings)
    roots = pack_scene_tables(r.dev_scene, nee=True).roots
    assert roots.tolist() == [list(r.dev_scene.bvh_roots[g])
                              for g in r.dev_scene.mesh_geoms]


@pytest.mark.parametrize(
    "name,flag",
    [("textured.txt", "any_textured"), ("cornell_sss.txt", "any_sss"),
     ("envmap.txt", "has_env_map"), ("checker.txt", "any_textured")],
)
def test_feature_flags_of_later_slices(name, flag):
    """Texture, SSS and env-map scenes parse (numpy and zlib only); their
    flags match the JAX package's: they select the kernels' surface
    stage."""
    path = os.path.join(SCENES, name)
    td = tdevice.scene_to_device(tscene.load_scene(path), "cpu")
    jd = jdevice.scene_to_device(jscene.load_scene(path), use_bvh=False)
    assert getattr(td, flag) is True
    for n in tdevice.META_FIELDS:
        assert getattr(td, n) == getattr(jd, n), n
