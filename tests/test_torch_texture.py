"""The port's surface stage against the JAX package's, from identical
inputs: the Pillow-free PNG reader against Pillow, the scene tables of
the four texture, env-map and SSS scenes exactly, the texture functions
of ops/texture.py on seeded lanes (atol 1e-6; u and v at 0 and 1 - 1/512
so the bilinear wrap at x0 = -1 is taken; UV lanes and box lanes; bump
maps on and off), and the shading step with file textures, bump maps,
the lat-long env map, mesh UVs and SSS over two bounces (the lane rule of
tests/test_megakernel.py:57-99: atol 1e-4, at most 1% outlier lanes, pix
exact; the RNG bit-exact). 32x32 scenes, each loaded once."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import sweep as jsweep
from project3_cuda_path_tracer_tpu.ops import texture as jtex
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import texture as ttex
from project3_cuda_path_tracer_tpu_torch.ops.intersect import Intersections
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from project3_cuda_path_tracer_tpu_torch.utils.image import read_png
from tests.conftest import SCENES
from tests.test_torch_bounce_step import to_jax
from tests.test_torch_ops import arr, assert_state_close, jv, tv
from tests.test_torch_scene import (
    assert_scene_tables_equal,
    jax_scene_numpy,
    torch_scene_numpy,
)

ASSETS = os.path.join(SCENES, "assets")
SURFACE_SCENES = ["textured.txt", "envmap.txt", "cornell_sss.txt",
                  "mesh_textured.txt"]
RES = (32, 32)
P = RES[0] * RES[1]
ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def both_surface_scenes(name):
    """(JAX DeviceScene, port DeviceScene over the same tables, JAX
    camera, port camera) of a scene at 32x32, with the BVH on a mesh."""
    js = jscene.load_scene(os.path.join(SCENES, name))
    c = js.state.camera
    js.state.camera = jscene.derive_camera(
        RES, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    jd = jdevice.scene_to_device(js, use_bvh=js.triangles.count > 0)
    td = tdevice.device_scene_from_numpy(*jax_scene_numpy(jd), "cpu")
    jc = jdevice.camera_to_device(js.state.camera)
    tc = tdevice.DeviceCamera(
        **{f: torch.tensor(np.asarray(getattr(jc, f)))
           for f in ("position", "view", "up", "right", "pixel_length",
                     "aperture", "focal_distance")},
        resolution=jc.resolution,
    )
    return jd, td, jc, tc


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ---- the PNG reader -----------------------------------------------------

@pytest.mark.parametrize("name,mode", [("stripes.png", "RGB"),
                                       ("bubbles.png", "L"),
                                       ("sky.png", "RGB")])
def test_png_reader_equals_pillow_on_assets(name, mode):
    """The three assets as the scenes load them (the albedo as RGB, the
    bump map as L, the sky as RGB): exactly Pillow's arrays."""
    path = os.path.join(ASSETS, name)
    want = np.asarray(Image.open(path).convert(mode))
    got = read_png(path, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pil_mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reader_equals_pillow_on_colour_types(pil_mode, tmp_path):
    """Every colour type the reader takes, written by Pillow from seeded
    noise with smooth ramps (so its encoder picks several row filters),
    read back as RGB and as L: exactly Pillow's conversions."""
    rng = np.random.default_rng(7)
    h, w = 19, 23
    ramp = (np.add.outer(np.arange(h) * 9, np.arange(w) * 5) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgba = np.where(rng.random((h, w, 1)) < 0.5, ramp[..., None], noise)
    img = Image.fromarray(rgba.astype(np.uint8), "RGBA").convert(pil_mode)
    path = str(tmp_path / f"{pil_mode}.png")
    img.save(path)
    for mode in ("RGB", "L"):
        want = np.asarray(Image.open(path).convert(mode))
        np.testing.assert_array_equal(read_png(path, mode), want)


def test_texture_of_another_size_and_hdr_env_maps_refused(tmp_path):
    """Resampling and .hdr env maps are ported: a texture off the atlas's
    size and an env map off its table's size load exactly as the JAX
    loaders load them (Pillow's BILINEAR), and an .hdr env map loads; only
    an .exr env map is still refused, with a ValueError naming the missing
    decoder (tests/test_torch_image_io.py holds the rest)."""
    small = tmp_path / "small.png"
    img = np.random.default_rng(0).integers(0, 256, (8, 12, 3), dtype=np.uint8)
    Image.fromarray(img).save(small)
    for grey in (False, True):
        np.testing.assert_array_equal(tscene._load_texture(str(small), grey),
                                      jscene._load_texture(str(small), grey))
    np.testing.assert_array_equal(tscene._load_env_map(str(small)),
                                  jscene._load_env_map(str(small)))
    from project3_cuda_path_tracer_tpu_torch.utils.image import save_hdr

    sky = save_hdr(str(tmp_path / "sky.hdr"), img.astype(np.float32) / 7.0)
    assert tscene._load_env_map(sky).shape == (tscene.ENV_H, tscene.ENV_W, 3)
    with pytest.raises(ValueError, match="exr.*decoder"):
        tscene._load_env_map(str(tmp_path / "sky.exr"))


# ---- the tables ---------------------------------------------------------

@pytest.mark.parametrize("name", SURFACE_SCENES)
def test_surface_scene_tables_equal_jax(name):
    """The port's own parse and tables (the atlases included) exactly the
    JAX package's `scene_to_device`, and the kernels' packed atlases the
    same numbers."""
    path = os.path.join(SCENES, name)
    js = jscene.load_scene(path)
    jd = jdevice.scene_to_device(js, use_bvh=js.triangles.count > 0)
    td = tdevice.scene_to_device(tscene.load_scene(path), "cpu")
    assert_scene_tables_equal(torch_scene_numpy(td), jax_scene_numpy(jd))
    t = tmk.pack_scene_tables(td)
    M = td.mat_emittance.shape[0]
    assert t.surf.shape == (M, tmk.SURF_COLS)
    np.testing.assert_array_equal(t.surf[:, 0].numpy(), np.asarray(jd.mat_tex_id))
    np.testing.assert_array_equal(t.surf[:, 1].numpy(), np.asarray(jd.mat_bump_id))
    np.testing.assert_array_equal(t.surf[:, 3].numpy(), np.asarray(jd.mat_sss))
    np.testing.assert_array_equal(t.tex[:, :3].numpy(), np.stack(
        [np.asarray(jd.tex_r), np.asarray(jd.tex_g), np.asarray(jd.tex_b)], -1))
    np.testing.assert_array_equal(t.envmap[:, 1].numpy(), np.asarray(jd.env_g))
    np.testing.assert_array_equal(t.bump.numpy(), np.asarray(jd.bump_h))
    # the scene's features select the kernels' surface-stage twins
    flags = tmk.kernel_flags(td, trender.RenderSettings())
    assert bool(flags & tmk.FLAG_SURFACE_STAGE)
    tmk.check_supported(td, trender.RenderSettings())


# ---- ops/texture.py -----------------------------------------------------

def uv_lanes(n, seed):
    """Seeded u, v in [0, 1) with the edges 0 and 1 - 1/512 (the bilinear
    wrap's x0 = -1 and x1 = 256) and 1 - 2^-24 among them."""
    rng = np.random.default_rng(seed)
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    edges = np.array([0.0, 1.0 - 1.0 / 512, 1.0 - 2.0 ** -24, 1.0 / 512],
                     np.float32)
    u[:16] = np.repeat(edges, 4)
    v[:16] = np.tile(edges, 4)
    return u, v


def test_box_uv_and_checker_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-6, 6, (4096, 3)).astype(np.float32)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n[:64] = np.eye(3, dtype=np.float32)[np.arange(64) % 3]  # axis ties
    n[64:128, 0] = n[64:128, 1]  # |x| == |y|
    scale = rng.uniform(0.1, 2.0, 4096).astype(np.float32)
    ju, jw = jtex.box_uv(jv(p), jv(n), jnp.asarray(scale))
    tu, tw = ttex.box_uv(tv(p), tv(n), torch.tensor(scale))
    close(tu, ju)
    close(tw, jw)
    close(ttex.checker(tv(p), torch.tensor(scale)),
          jtex.checker(jv(p), jnp.asarray(scale)), atol=0)


def test_texture_fetches_match_jax():
    """Nearest and bilinear fetches of textured.txt's stripes and bubbles
    atlases, and the albedo fetch, over seeded lanes and the edges."""
    jd, td, _, _ = both_surface_scenes("textured.txt")
    u, v = uv_lanes(4096, 2)
    tid = np.zeros(4096, np.int32)
    jargs = (jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v))
    targs = (torch.tensor(tid), torch.tensor(u), torch.tensor(v))
    close(ttex._gather(td.bump_h, *targs), jtex._gather(jd.bump_h, *jargs))
    close(ttex._gather_bilinear(td.tex_g, *targs),
          jtex._gather_bilinear(jd.tex_g, *jargs))
    got = ttex.sample_file_texture(td.tex_r, td.tex_g, td.tex_b, *targs)
    want = jtex.sample_file_texture(jd.tex_r, jd.tex_g, jd.tex_b, *jargs)
    close(arr(got), arr(want))
    # the wrap: at u = v = 0 the four taps are texels 255 (x0 = y0 = -1)
    # and 0 of each axis, each weighted 1/4
    R = ttex.TEX_RES
    g = td.tex_g.numpy().reshape(R, R)
    corner = 0.25 * (g[R - 1, R - 1] + g[R - 1, 0] + g[0, R - 1] + g[0, 0])
    (k,) = np.nonzero((u == 0) & (v == 0))[0][:1]
    close(got.y[k], corner)


def test_env_radiance_matches_jax():
    """The lat-long fetch on seeded directions, the poles and the seam
    (z = 0 behind the viewer, atan2's branch cut); the constant colour
    on a scene without a map."""
    jd, td, _, _ = both_surface_scenes("envmap.txt")
    rng = np.random.default_rng(3)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:6] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, -0.0], [1, 0, 0],
             [0, 0, 1]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    close(arr(ttex.env_radiance(td, tv(d))), arr(jtex.env_radiance(jd, jv(d))))
    jd2, td2, _, _ = both_surface_scenes("textured.txt")
    close(arr(ttex.env_radiance(td2, tv(d))), arr(jtex.env_radiance(jd2, jv(d))))


@pytest.mark.parametrize("name", ["textured.txt", "mesh_textured.txt"])
def test_apply_textures_matches_jax(name):
    """Every material of the scene on seeded hit points and normals: no
    texture, the checker, the file texture, the bump map (textured.txt's
    sphere) on and off; half the lanes with mesh UVs (wrapped from
    [-2, 3]), half box-projected."""
    jd, td, _, _ = both_surface_scenes(name)
    rng = np.random.default_rng(5)
    n_lanes = 4096
    p = rng.uniform(-5, 5, (n_lanes, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_lanes, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    M = int(td.mat_emittance.shape[0])
    mat = (np.arange(n_lanes) % M).astype(np.int32)
    base = rng.uniform(0.2, 1.0, (n_lanes, 3)).astype(np.float32)
    tu = rng.uniform(-2, 3, n_lanes).astype(np.float32)
    tw = rng.uniform(-2, 3, n_lanes).astype(np.float32)
    tu[:16], tw[:16] = uv_lanes(16, 4)
    has_uv = rng.random(n_lanes) < 0.5
    jc, jn = jtex.apply_textures(
        jd, jv(p), jv(nrm), jnp.asarray(mat), jv(base),
        tex_u=jnp.asarray(tu), tex_v=jnp.asarray(tw), has_uv=jnp.asarray(has_uv))
    tc, tn = ttex.apply_textures(
        td, tv(p), tv(nrm), torch.tensor(mat), tv(base),
        tex_u=torch.tensor(tu), tex_v=torch.tensor(tw),
        has_uv=torch.tensor(has_uv))
    close(arr(tc), arr(jc))
    close(arr(tn), arr(jn))
    # the stages were taken: some albedo textured, some normal bumped
    assert (np.abs(arr(tc) - base) > 1e-3).any()
    assert (np.abs(arr(tn) - nrm) > 1e-3).any() == bool(td.any_bump)


# ---- the shading step ---------------------------------------------------

def jax_isect_to_torch(ji):
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return Intersections(
        t=t(ji.t), normal=TVec3(*(t(c) for c in ji.normal)),
        material_id=t(ji.material_id).to(torch.int32), outside=t(ji.outside),
        tex_u=t(ji.tex_u), tex_v=t(ji.tex_v), has_uv=t(ji.has_uv),
    )


def pool_from_jax(js):
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    vec = lambda v: TVec3(*(t(c).contiguous() for c in v))  # noqa: E731
    return (vec(js[0]), vec(js[1]), vec(js[2]), vec(js[3]),
            t(js[4]).to(torch.int32), t(js[5]))


@pytest.mark.parametrize("name,settings_kw", [
    ("textured.txt", {"antialias": True}),
    ("envmap.txt", {}),
    ("cornell_sss.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("mesh_textured.txt", {"stratified": True}),
])
def test_shade_step_matches_jax(name, settings_kw):
    """Depths 0 and 1 from the same pool and the JAX package's
    Intersections (mesh UVs included): the port's `_shade_step` (#4's
    plain version) against the JAX XLA `_shade_step`. Depth 1 of
    cornell_sss starts lanes inside the sphere (the exit lobe)."""
    jd, td, _, tc = both_surface_scenes(name)
    tset = trender.RenderSettings(trace_depth=8, **settings_kw)
    jset = jrender.RenderSettings(trace_depth=8, use_pallas=False, **settings_kw)
    pool = trender._camera_pool(tc, 3, tset)
    for depth in (0, 1):
        jstate = to_jax(pool)
        ji = jsweep.intersect_scene(jstate[0], jstate[1], jd,
                                    use_bvh=bool(td.mesh_geoms))
        want = jrender._shade_step(jstate, ji, jd, jnp.int32(3),
                                   jnp.int32(depth), jset)
        got = tmk.shade_step(pool, jax_isect_to_torch(ji), td, 3, depth, tset)
        assert_state_close(got, want)
        if name == "cornell_sss.txt" and depth == 1:
            assert (~np.asarray(ji.outside) & (np.asarray(ji.t) > 0)).any()
        if name == "envmap.txt":
            assert (np.asarray(ji.t) < 0).any()  # lanes escape to the map
        pool = pool_from_jax(want)
