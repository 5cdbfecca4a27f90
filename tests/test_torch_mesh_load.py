"""The port's mesh host side against the JAX package's: the OBJ soup, the
BVH arrays and the BVH-ordered soup, the scene parse, and the device
tables (the port's own `scene_to_device` and the JAX DeviceScene handed
over through `device_scene_from_numpy`), all exactly equal."""

import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.models import bvh as jbvh
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import mesh as jmesh
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu_torch.models import bvh as tbvh
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import mesh as tmesh
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import pipeline as tpipe
from project3_cuda_path_tracer_tpu_torch.ops.megakernel import pack_scene_tables
from tests.conftest import SCENES
from tests.test_torch_scene import (
    assert_scene_tables_equal,
    jax_scene_numpy,
    torch_scene_numpy,
)

SOUP = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")

# v/vt/vn, a quad (fan-triangulated), negative indices; TINY_OBJ adds a
# face without vt (the mesh loses has_uv) and one with neither vt nor vn
# (the face normal)
TINY_FULL_UV = """# tiny
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 -1
f 1/1/1 2/2/1 3/3/1 4/4/1
f -5/-4/-1 -4/-3/-1 -1/-2/-1
"""
TINY_OBJ = TINY_FULL_UV + "f 1//2 2//2 5//2\nf 3 4 5\n"


def _obj(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    path.write_text({"tiny": TINY_OBJ, "tiny_uv": TINY_FULL_UV}[name])
    return str(path)


def assert_soups_equal(a, b):
    assert a.count == b.count and a.has_uv == b.has_uv
    for n in SOUP:
        np.testing.assert_array_equal(getattr(a, n), getattr(b, n), err_msg=n)


@pytest.mark.parametrize("name", ["icosphere", "tiny", "tiny_uv"])
def test_load_obj_equal_jax(name, tmp_path):
    path = (os.path.join(SCENES, "assets", "icosphere.obj")
            if name == "icosphere" else _obj(tmp_path, name))
    got = tmesh.load_obj(path)
    assert_soups_equal(got, jmesh.load_obj(path))
    assert got.count == {"icosphere": 5120, "tiny": 5, "tiny_uv": 3}[name]
    assert got.has_uv == (name == "tiny_uv")
    for a, b in zip(tmesh.mesh_bounds(got), jmesh.mesh_bounds(got)):
        np.testing.assert_array_equal(a, b)


def two_mesh_scene(tmp_path):
    """mesh.txt with a second mesh geom, the UV-mapped quad (a later
    mesh's triangles and nodes start past the first one's)."""
    text = open(os.path.join(SCENES, "mesh.txt")).read().replace(
        "assets/", os.path.join(SCENES, "assets") + "/")
    quad = os.path.join(SCENES, "assets", "uv_quad.obj")
    text += ("\nOBJECT 7\nmesh\nmaterial 1\nFILE        " + quad
             + "\nTRANS       2 2 -2\nROTAT       0 30 0\nSCALE       2 2 2\n")
    path = tmp_path / "two_meshes.txt"
    path.write_text(text)
    return str(path)


@pytest.fixture
def scene_path(request, tmp_path):
    if request.param == "two_meshes":
        return two_mesh_scene(tmp_path)
    return os.path.join(SCENES, request.param)


@pytest.mark.parametrize("scene_path", ["mesh.txt", "two_meshes"],
                         indirect=True)
def test_scene_bvh_equal_jax(scene_path):
    """Scene parse, BVH arrays and the reordered soup, exactly."""
    ts, js = tscene.load_scene(scene_path), jscene.load_scene(scene_path)
    for f in ("gtype", "material_id", "tri_start", "tri_count", "has_uv",
              "transform", "inverse_transform", "inv_transpose"):
        np.testing.assert_array_equal(getattr(ts.geoms, f), getattr(js.geoms, f),
                                      err_msg=f)
    assert_soups_equal(ts.triangles, js.triangles)
    assert "triangles" in tscene.scene_summary(ts)
    got = tbvh.build_scene_bvh(ts)
    want = jbvh.build_scene_bvh(js)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    assert_soups_equal(ts.triangles, js.triangles)  # the same reorder


@pytest.mark.parametrize("scene_path", ["mesh.txt", "two_meshes"],
                         indirect=True)
def test_mesh_device_tables_equal_jax(scene_path):
    """The port's scene_to_device against the JAX package's, with the BVH
    and without it; the JAX DeviceScene handed over whole builds the same
    tables; the host soup keeps file order."""
    ts = tscene.load_scene(scene_path)
    file_order = ts.triangles.v0.copy()
    for use_bvh in (True, False):
        jd = jdevice.scene_to_device(jscene.load_scene(scene_path),
                                     use_bvh=use_bvh)
        td = tdevice.scene_to_device(ts, "cpu", use_bvh=use_bvh)
        want = jax_scene_numpy(jd)
        assert_scene_tables_equal(torch_scene_numpy(td), want)
        from_jax = tdevice.device_scene_from_numpy(*want, "cpu")
        assert_scene_tables_equal(torch_scene_numpy(from_jax), want)
        assert from_jax.bvh_leaf.dtype == torch.bool
        assert from_jax.bvh_skip.dtype == torch.int32
    np.testing.assert_array_equal(ts.triangles.v0, file_order)
    td = tdevice.scene_to_device(ts, "cpu")
    assert td.mesh_geoms == tuple(
        i for i, c in enumerate(ts.geoms.tri_count) if c > 0)


def test_pack_mesh_tables():
    """The mesh kernels' packed tables carry the DeviceScene's numbers."""
    td = tdevice.scene_to_device(tscene.load_scene(
        os.path.join(SCENES, "mesh.txt")), "cpu")
    tri, attr, box, geoms, chunk, sup = pack_scene_tables(td).mesh
    assert torch.equal(chunk, td.mesh_chunk_aabbs) and chunk.shape == (160, 8)
    assert torch.equal(sup, td.mesh_super_aabbs) and sup.shape == (5, 8)
    T, B = td.tri_v0.x.shape[0], td.bvh_first.shape[0]
    assert (T, B) == (5120, td.bvh_roots[6][1])
    assert tri.shape == (T, 12) and attr.shape == (T, 16)
    assert box.shape == (B, 8)
    for k, v in enumerate((td.tri_v0, td.tri_v1, td.tri_v2)):
        for c in range(3):
            assert torch.equal(tri[:, 3 * k + c], v[c])
    assert torch.equal(attr[:, 11], td.tri_uv1u)
    assert torch.equal(box[:, 4], td.bvh_max.x)
    assert geoms.tolist() == [[6, 0, B, 0]]
    assert pack_scene_tables(tdevice.scene_to_device(tscene.load_scene(
        os.path.join(SCENES, "cornell.txt")), "cpu")).mesh is None
    with pytest.raises(ValueError, match="BVH"):
        pack_scene_tables(tdevice.scene_to_device(
            tscene.load_scene(os.path.join(SCENES, "mesh.txt")), "cpu",
            use_bvh=False))


def test_check_mesh_sizes():
    """The routing threshold: a mesh geom above 16,384 triangles takes the
    sorted route (#11-#14's counterparts), one of at most 16,384 the dense
    BVH walk (#8), in geom order; mesh_big.txt's 51,200-triangle geom is
    routed to the sorted route from the host scene's triangle counts."""
    from types import SimpleNamespace

    scene = SimpleNamespace(mesh_geoms=(1, 2, 4),
                            tri_ranges=((0, 0), (0, 5120), (5120, 16384),
                                        (0, 0), (21504, 16385)))
    assert tpipe.SORT_SUPER_MIN_TRIS == 16384
    assert tpipe.sorted_geoms(scene) == (4,)
    assert tpipe.dense_geoms(scene) == (1, 2)
    big = tscene.load_scene(os.path.join(SCENES, "mesh_big.txt"))
    (g,) = np.nonzero(big.geoms.tri_count)[0]
    big_scene = SimpleNamespace(
        mesh_geoms=(int(g),),
        tri_ranges=tuple(zip(big.geoms.tri_start.tolist(),
                             big.geoms.tri_count.tolist())))
    assert tpipe.sorted_geoms(big_scene) == (g,)
    assert big_scene.tri_ranges[g][1] == 51_200
