"""The port's plain ops against the JAX package's, on identical inputs:
camera rays, primitive and scene intersection, scatter, and the shading
step over three bounces. Inputs are made from a seed with numpy and the
scene tables are the JAX package's, handed over with
device_scene_from_numpy."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import bsdf as jbsdf
from project3_cuda_path_tracer_tpu.ops import camera as jcamera
from project3_cuda_path_tracer_tpu.ops import intersect as jintersect
from project3_cuda_path_tracer_tpu.ops import sweep as jsweep
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.ops import bsdf as tbsdf
from project3_cuda_path_tracer_tpu_torch.ops import camera as tcamera
from project3_cuda_path_tracer_tpu_torch.ops import intersect as tintersect
from project3_cuda_path_tracer_tpu_torch.ops import sweep as tsweep
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.conftest import SCENES


def small_jax_scene(name, res=(32, 32)):
    s = jscene.load_scene(os.path.join(SCENES, name))
    c = s.state.camera
    s.state.camera = jscene.derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    return s


def both_scenes(name, glossy_mat=None):
    """(JAX DeviceScene, port DeviceScene) over the same numpy tables."""
    jd = jdevice.scene_to_device(small_jax_scene(name), use_bvh=False)
    if glossy_mat is not None:
        sexp = np.asarray(jd.mat_specular_exponent).copy()
        sexp[glossy_mat] = 64.0
        jd = dataclasses.replace(
            jd, mat_specular_exponent=jnp.asarray(sexp), any_glossy=True
        )
    fields = {n: np.asarray(getattr(jd, n)) for n in tdevice.ARRAY_FIELDS}
    for n in tdevice.VEC3_FIELDS:
        fields[n] = np.stack([np.asarray(c) for c in getattr(jd, n)], -1)
    meta = {n: getattr(jd, n) for n in tdevice.META_FIELDS}
    return jd, tdevice.device_scene_from_numpy(fields, meta, "cpu")


def both_cameras(name, res=(32, 32)):
    s = small_jax_scene(name, res)
    jc = jdevice.camera_to_device(s.state.camera)
    tc = tdevice.DeviceCamera(
        **{f: torch.tensor(np.asarray(getattr(jc, f)))
           for f in ("position", "view", "up", "right", "pixel_length",
                     "aperture", "focal_distance")},
        resolution=jc.resolution,
    )
    return jc, tc


def jv(a: np.ndarray) -> JVec3:
    return JVec3(*(jnp.asarray(a[:, c]) for c in range(3)))


def tv(a: np.ndarray) -> TVec3:
    return TVec3(*(torch.tensor(a[:, c]) for c in range(3)))


def arr(v) -> np.ndarray:
    return np.stack([np.asarray(c) for c in v], -1)


def room_rays(n=4096, seed=0):
    """Seeded origins inside the Cornell room and unit directions."""
    r = np.random.default_rng(seed)
    o = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def assert_state_close(a, b, atol=1e-4, outlier_frac=0.01):
    """tests/test_megakernel.py's lane rule: seam ties flip a small
    fraction of lanes (~0.4% per bounce), which then diverge entirely;
    `pix` must match exactly."""
    for i, name in enumerate(["origins", "dirs", "throughput", "radiance"]):
        for c in range(3):
            av = np.asarray(a[i][c])
            bv = np.asarray(b[i][c])
            bad = np.abs(av - bv) > atol
            assert bad.mean() <= outlier_frac, (
                f"{name}[{c}]: {bad.mean():.2%} lanes differ "
                f"(max {np.abs(av - bv).max():.4f})"
            )
    assert (np.asarray(a[4]) != np.asarray(b[4])).mean() <= outlier_frac
    np.testing.assert_array_equal(np.asarray(a[5]), np.asarray(b[5]))


def assert_t_close(got, want):
    """Hit distances: within atol 1e-5 (+1e-5 relative: world distances
    reach ~30) on at least 99% of lanes. The rest are grazing hits,
    where the sphere quadratic's sqrt of a near-zero radicand magnifies
    the ulp-level difference of the two rsqrt implementations; hit and
    miss must still agree on every lane."""
    close = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
    assert close.mean() >= 0.99, (close.mean(), np.abs(got - want).max())
    np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize(
    "name,iteration,aa,dof",
    [("cornell.txt", 1, False, False), ("cornell.txt", 7, True, False),
     ("cornell_dof.txt", 3, True, True), ("cornell_dof.txt", 18, False, True)],
)
def test_generate_rays(name, iteration, aa, dof):
    jc, tc = both_cameras(name)
    jo, jd, jp = jcamera.generate_rays(jc, jnp.int32(iteration), aa, dof)
    to, td, tp = tcamera.generate_rays(tc, iteration, aa, dof)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(arr(to), arr(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(arr(td), arr(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("geom", [1, 3, 6])  # floor box, back wall, sphere
def test_primitive_intersect(geom):
    jd, td = both_scenes("cornell.txt")
    o, d = room_rays(seed=geom)
    if jd.gtypes[geom] == 0:
        jt, jn, jout = jintersect.sphere_intersect(
            jd.transform[geom], jd.inverse_transform[geom],
            jd.inv_transpose[geom], jv(o), jv(d),
        )
        tt, tn, tout = tintersect.sphere_intersect(
            td.transform[geom], td.inverse_transform[geom],
            td.inv_transpose[geom], tv(o), tv(d),
        )
    else:
        jt, jn, jout = jintersect.box_intersect(
            jd.transform[geom], jd.inverse_transform[geom], jv(o), jv(d)
        )
        tt, tn, tout = tintersect.box_intersect(
            td.transform[geom], td.inverse_transform[geom], tv(o), tv(d)
        )
    jt = np.asarray(jt)
    hit = jt > 0
    assert 0.02 < hit.mean() < 0.98  # both hits and misses are exercised
    assert_t_close(tt.numpy(), jt)
    np.testing.assert_allclose(arr(tn)[hit], arr(jn)[hit], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tout.numpy()[hit], np.asarray(jout)[hit])


@pytest.mark.parametrize("name", ["cornell.txt", "many_materials.txt"])
def test_intersect_scene(name):
    jd, td = both_scenes(name)
    o, d = room_rays(seed=7)
    ji = jsweep.intersect_scene(jv(o), jv(d), jd, use_bvh=False)
    ti = tsweep.intersect_scene(tv(o), tv(d), td)
    assert_t_close(ti.t.numpy(), np.asarray(ji.t))
    same_mat = ti.material_id.numpy() == np.asarray(ji.material_id)
    assert same_mat.mean() >= 0.99
    assert ti.material_id.dtype == torch.int32


@pytest.mark.parametrize(
    "name,glossy_mat",
    [("many_materials.txt", None), ("cornell_glass.txt", None),
     ("cornell.txt", 4)],
)
def test_scatter(name, glossy_mat):
    """Every analytic lobe: diffuse, mirror, partial-reflective lottery,
    glass with Fresnel/TIR, and (SPECEX=64 on the mirror) Phong glossy."""
    jd, td = both_scenes(name, glossy_mat)
    o, d = room_rays(seed=11)
    ji = jsweep.intersect_scene(jv(o), jv(d), jd, use_bvh=False)
    ti = tsweep.intersect_scene(tv(o), tv(d), td)
    r = np.random.default_rng(3)
    u = r.random((4, o.shape[0]), dtype=np.float32)
    jm = jrender._gather_materials(jd, ji.material_id)[:7]
    tm = trender._gather_materials(td, ti.material_id)[:7]
    ja = jbsdf.scatter(
        jv(o), jv(d), ji.t, ji.normal, ji.outside, *jm,
        u_hemi1=jnp.asarray(u[0]), u_hemi2=jnp.asarray(u[1]),
        u_branch=jnp.asarray(u[2]) if jd.any_partial_reflective else None,
        u_fresnel=jnp.asarray(u[3]) if jd.any_refractive else None,
    )
    ta = tbsdf.scatter(
        tv(o), tv(d), ti.t, ti.normal, ti.outside, *tm,
        u_hemi1=torch.tensor(u[0]), u_hemi2=torch.tensor(u[1]),
        u_branch=torch.tensor(u[2]) if td.any_partial_reflective else None,
        u_fresnel=torch.tensor(u[3]) if td.any_refractive else None,
    )
    hit = np.asarray(ji.t) > 0
    for k in range(4):  # origin, dir, tint, emitted
        diff = np.abs(arr(ta[k]) - arr(ja[k]))[hit]
        assert (diff > 1e-4).mean() <= 0.01, (k, diff.max())
    np.testing.assert_array_equal(ta[4].numpy(), np.asarray(ja[4]))


@pytest.mark.parametrize(
    "name,settings_kw",
    [("cornell.txt", {}),
     ("cornell_glass.txt", {"russian_roulette": True, "rr_start_depth": 1}),
     ("many_materials.txt", {"russian_roulette": True, "rr_start_depth": 1}),
     ("env.txt", {})],
)
def test_shade_step_three_bounces(name, settings_kw):
    jd, td = both_scenes(name)
    jc, tc = both_cameras(name)
    jo, jdir, jpix = jcamera.generate_rays(jc, jnp.int32(2), False, False)
    P = jpix.shape[0]
    js = (jo, jdir, JVec3.ones((P,)), JVec3.zeros((P,)),
          jnp.ones((P,), bool), jpix)
    ts = (tv(arr(jo)), tv(arr(jdir)), TVec3.ones(P, "cpu"),
          TVec3.zeros(P, "cpu"), torch.ones(P, dtype=torch.bool),
          torch.tensor(np.asarray(jpix)))
    jset = jrender.RenderSettings(trace_depth=8, use_bvh=False, **settings_kw)
    tset = trender.RenderSettings(trace_depth=8, **settings_kw)
    for depth in range(3):
        ji = jsweep.intersect_scene(js[0], js[1], jd, use_bvh=False)
        js = jrender._shade_step(js, ji, jd, jnp.int32(5), jnp.int32(depth), jset)
        ti = tsweep.intersect_scene(ts[0], ts[1], td)
        ts = trender._shade_step(ts, ti, td, 5, depth, tset)
    # seam-tie divergence compounds per bounce (~0.4%/bounce)
    assert_state_close(ts, js, atol=3e-4, outlier_frac=0.03)
