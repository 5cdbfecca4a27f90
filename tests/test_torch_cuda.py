"""The hand-written CUDA kernels on the card: each against its plain
PyTorch version, their launch counts on the render paths, and the
wrappers' checks.

Every test here needs a CUDA device and nvcc (the kernels build on first
use) and skips without them. The file imports neither JAX nor the
shared test harness, so on a machine with a card and no JAX it runs on
its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.models.device import (
    camera_to_device,
    scene_to_device,
)
from project3_cuda_path_tracer_tpu_torch.models.scene import (
    GeomType,
    derive_camera,
    load_scene,
)
from project3_cuda_path_tracer_tpu_torch.ops import megakernel
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
from project3_cuda_path_tracer_tpu_torch.ops.sweep import intersect_scene
from project3_cuda_path_tracer_tpu_torch.render import (
    Renderer,
    RenderSettings,
    _count_alive,
    _maybe_compact,
)

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels build on first use)")
    return torch.device("cuda")


def small(name, res):
    s = load_scene(os.path.join(SCENES, name))
    c = s.state.camera
    s.state.camera = derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    return s


# pixels of #1 that may differ in any bit from its plain version: a
# handful (about 1 in 4,000 at 64x64) on which a float op of the kernel
# and its torch counterpart round an ulp apart and a lottery flips; the
# per-bounce kernels #2 -> #3, bit-identical to #1, differ on the same
# pixels
FULL_BITS_OFF = 0.001


def per_bounce_radiance(ds, cam, settings, iteration):
    """#2, then #3 at every depth: the per-bounce kernels run the same
    device code as #1 one thread per pixel, so #1 matches them bit for
    bit."""
    pool = megakernel.first_bounce(ds, cam, iteration, settings)
    for depth in range(1, settings.trace_depth):
        pool = megakernel.bounce_step(pool, ds, iteration, depth, settings)
    return pool[3]


def assert_bit_identical(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def assert_full_matches_plain(accum, plain, iterations=1):
    """#1's rule: bit-identical to the plain version on all but
    FULL_BITS_OFF of the pixels per iteration summed, and
    tests/test_megakernel.py's image rule over all of them."""
    off = torch.zeros_like(accum[0], dtype=torch.bool)
    for g, w in zip(accum, plain):
        off |= g.view(torch.int32) != w.view(torch.int32)
        diff = np.abs(g.cpu().numpy() - w.cpu().numpy())
        assert (diff > 1e-3).mean() < 0.02
        assert np.median(diff) < 1e-5
    assert float(off.float().mean()) <= FULL_BITS_OFF * iterations


@pytest.mark.parametrize(
    "name,settings_kw",
    [("cornell.txt", {"antialias": True}),
     ("cornell_glass.txt", {"russian_roulette": True}),
     ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}),
     ("many_materials.txt", {"russian_roulette": True}),
     ("checker.txt", {}),
     ("cornell.txt", {"stratified": True}),
     ("cornell.txt", {"sobol": True}),
     ("env.txt", {}),
     ("cornell_glass.txt", {"russian_roulette": True, "antialias": True})],
)
def test_kernel_matches_plain_on_cuda(cuda_device, name, settings_kw):
    """One iteration at 64x64 through the kernel and its plain version on
    identical inputs: bit for bit but on a handful of pixels, and
    tests/test_megakernel.py's image rule; bit for bit against the
    per-bounce kernels."""
    scene = small(name, (64, 64))
    settings = RenderSettings(trace_depth=8, **settings_kw)
    ds = scene_to_device(scene, cuda_device)
    cam = camera_to_device(scene.state.camera, cuda_device)
    accum = Vec3.zeros(64 * 64, cuda_device)
    before = megakernel.full_iteration.launches
    megakernel.full_iteration(ds, cam, 3, settings, accum)
    torch.cuda.synchronize()
    assert megakernel.full_iteration.launches == before + 1
    plain = megakernel.full_iteration_reference(ds, cam, 3, settings)
    assert_full_matches_plain(accum, plain)
    assert_bit_identical(accum, per_bounce_radiance(ds, cam, settings, 3))


@pytest.mark.parametrize("res", [(64, 64), (800, 800), (37, 23)])
def test_full_iteration_matches_plain_at_sizes_on_cuda(cuda_device, res):
    """#1's persistent warps at 4,096 pixels, at the main path's 640,000
    and at an odd 851 (the last chunk ragged), on Cornell AA at two
    iterations: #1's rule against the plain version, and bit for bit
    against the per-bounce kernels."""
    ds, cam, settings = _setup(cuda_device, "cornell.txt", {"antialias": True}, res)
    for it in (1, 6):
        accum = Vec3.zeros(res[0] * res[1], cuda_device)
        megakernel.full_iteration(ds, cam, it, settings, accum)
        torch.cuda.synchronize()
        assert_full_matches_plain(accum, megakernel.full_iteration_reference(
            ds, cam, it, settings))
        assert_bit_identical(accum, per_bounce_radiance(ds, cam, settings, it))


def test_full_iteration_launches_are_independent_on_cuda(cuda_device):
    """One call of ITERATIONS_PER_LAUNCH + 8 iterations (two back-to-back
    launches, each its own pixel counter) adds exactly what as many
    one-iteration calls add, whichever lanes the counters gave the pixels
    to; step_batch(25), one launch, against 25 plain iterations summed in
    the same order."""
    ds, cam, settings = _setup(cuda_device, "cornell_glass.txt",
                               {"russian_roulette": True, "antialias": True})
    P = 64 * 64
    n = megakernel.ITERATIONS_PER_LAUNCH + 8
    both = Vec3.zeros(P, cuda_device)
    before = megakernel.full_iteration.launches
    megakernel.full_iteration(ds, cam, 4, settings, both, n_iters=n)
    assert megakernel.full_iteration.launches - before == 2
    apart = Vec3.zeros(P, cuda_device)
    for it in range(4, 4 + n):
        megakernel.full_iteration(ds, cam, it, settings, apart)
    torch.cuda.synchronize()
    assert_bit_identical(both, apart)
    r = Renderer(small("cornell.txt", (64, 64)),
                 RenderSettings(trace_depth=8, antialias=True), device=cuda_device)
    before = megakernel.full_iteration.launches
    r.step_batch(25)
    torch.cuda.synchronize()
    assert megakernel.full_iteration.launches - before == 1
    want = Vec3.zeros(P, cuda_device)
    for it in range(1, 26):
        for a, w in zip(want, megakernel.full_iteration_reference(
                r.dev_scene, r.dev_camera, it, r.settings)):
            a.add_(w)
    assert_full_matches_plain(r.accum, want, iterations=25)


def test_renderer_launches_once_per_iteration(cuda_device):
    """step_batch launches #1 once per run of up to
    ITERATIONS_PER_LAUNCH iterations; step() takes the per-bounce path
    (#2 once, #3 depth-1 times) and launches #1 never."""
    scene = small("cornell.txt", (96, 64))
    r = Renderer(scene, RenderSettings(trace_depth=8, antialias=True),
                 device=cuda_device)
    before = megakernel.full_iteration.launches
    before_fb = megakernel.first_bounce.launches
    before_bs = megakernel.bounce_step.launches
    r.step()
    r.step_batch(4)
    assert megakernel.full_iteration.launches - before == 1
    assert megakernel.first_bounce.launches - before_fb == 1
    assert megakernel.bounce_step.launches - before_bs == 7
    assert r.iteration == 5
    img = r.image()
    assert img.shape == (64, 96, 3) and np.isfinite(img).all() and img.max() > 0


def test_wrapper_rejects_bad_inputs(cuda_device):
    scene = small("cornell.txt", (16, 16))
    settings = RenderSettings(trace_depth=2)
    ds = scene_to_device(scene, cuda_device)
    cam = camera_to_device(scene.state.camera, cuda_device)
    cpu_accum = Vec3.zeros(256, "cpu")
    with pytest.raises(ValueError, match="is on"):
        megakernel.full_iteration(
            ds, cam, 1, settings,
            Vec3(cpu_accum.x.to(cuda_device), cpu_accum.y, cpu_accum.z),
        )
    strided = torch.zeros(512, device=cuda_device)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        megakernel.full_iteration(
            ds, cam, 1, settings, Vec3(strided, strided.clone(), strided.clone())
        )
    with pytest.raises(ValueError, match="shape"):
        megakernel.full_iteration(ds, cam, 1, settings, Vec3.zeros(100, cuda_device))


def assert_lanes_close(got, want):
    """The image rule, lane by lane over a pool: seam-tie outliers only;
    pix exact."""
    for k, (g, w) in enumerate(zip(megakernel.pool_lanes(got),
                                   megakernel.pool_lanes(want))):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if k == 13:
            np.testing.assert_array_equal(g, w)
            continue
        diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
        assert (diff > 1e-3).mean() < 0.02, k
        assert np.median(diff) < 1e-5, k


def _setup(cuda_device, name, settings_kw, res=(64, 64)):
    scene = small(name, res)
    settings = RenderSettings(trace_depth=8, **settings_kw)
    ds = scene_to_device(scene, cuda_device)
    cam = camera_to_device(scene.state.camera, cuda_device)
    return ds, cam, settings


PER_BOUNCE = [
    ("cornell.txt", {"antialias": True}),
    ("cornell_glass.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("checker.txt", {"sobol": True}),
    ("cornell.txt", {"stratified": True}),
]


@pytest.mark.parametrize("name,settings_kw", PER_BOUNCE)
def test_first_bounce_matches_plain_on_cuda(cuda_device, name, settings_kw):
    ds, cam, settings = _setup(cuda_device, name, settings_kw)
    before = megakernel.first_bounce.launches
    got = megakernel.first_bounce(ds, cam, 3, settings)
    torch.cuda.synchronize()
    assert megakernel.first_bounce.launches == before + 1
    want = megakernel.first_bounce_reference(ds, cam, 3, settings)
    assert_lanes_close(got, want)


# #2's sweep in chunks of staged geoms, its origin terms once per block
# without depth of field and per lane with it, its blocks partly off the
# image; "many_boxes" is Cornell with 300 boxes added
# (chip_smoke.many_boxes_scene)
FIRST_BOUNCE_CONFIGS = [
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}, (64, 64)),
    ("many_materials.txt", {"russian_roulette": True}, (64, 64)),
    ("env.txt", {}, (64, 64)),
    ("cornell.txt", {"antialias": True}, (37, 23)),
    ("cornell.txt", {"antialias": True}, (1, 1)),
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}, (1, 1)),
    ("many_boxes", {"antialias": True}, (64, 64)),
    ("many_boxes", {"antialias": True}, (37, 23)),
]


@pytest.mark.parametrize("name,settings_kw,res", FIRST_BOUNCE_CONFIGS)
def test_first_bounce_configs_on_cuda(cuda_device, tmp_path, name, settings_kw, res):
    """#2 against its plain version (the lane rule), and #1 bit for bit
    against #2 -> #3: with depth of field (each lane's own origin), on
    many_materials' 38 geoms and the 307 of "many_boxes" (more than one
    staged chunk), on env.txt's 3 geoms and its misses, and at 37x23 and
    1x1 (a block mostly off the image)."""
    if name == "many_boxes":
        from chip_smoke import many_boxes_scene

        name = many_boxes_scene(str(tmp_path / "many_boxes.txt"))
    ds, cam, settings = _setup(cuda_device, name, settings_kw, res)
    before = megakernel.first_bounce.launches
    got = megakernel.first_bounce(ds, cam, 3, settings)
    torch.cuda.synchronize()
    assert megakernel.first_bounce.launches == before + 1
    assert_lanes_close(got, megakernel.first_bounce_reference(ds, cam, 3, settings))
    accum = Vec3.zeros(res[0] * res[1], cuda_device)
    megakernel.full_iteration(ds, cam, 3, settings, accum)
    torch.cuda.synchronize()
    assert_bit_identical(accum, per_bounce_radiance(ds, cam, settings, 3))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("name,settings_kw", PER_BOUNCE)
def test_bounce_step_matches_plain_on_cuda(cuda_device, name, settings_kw,
                                           compact):
    """Three bounces in place; with `compact`, the pool is compacted
    before each and the kernel gets the live count on the device."""
    ds, cam, settings = _setup(cuda_device, name, dict(settings_kw, compact=compact))
    pool = megakernel.first_bounce_reference(ds, cam, 2, settings)
    before = megakernel.bounce_step.launches
    for depth in (1, 2, 3):
        pool = _maybe_compact(pool, settings)
        n_alive = _count_alive(pool) if compact else None
        want = megakernel.bounce_step_reference(pool, ds, 2, depth, settings,
                                                num_alive=n_alive)
        got = megakernel.bounce_step(pool, ds, 2, depth, settings,
                                     num_alive=n_alive)
        torch.cuda.synchronize()
        assert got is pool
        assert_lanes_close(got, want)
        pool = want  # the next bounce starts from the same lanes
    assert megakernel.bounce_step.launches == before + 3


def _alive_pattern(P, share, pattern, seed):
    """(P,) int32: each lane live with probability `share` ("scattered"),
    or runs of 1-40 live lanes between dead runs that keep the share
    ("clustered"); numpy, seeded."""
    rng = np.random.default_rng(seed)
    if pattern == "scattered" or share in (0.0, 1.0):
        return (rng.random(P) < share).astype(np.int32)
    out = np.zeros(P, np.int32)
    i = int(rng.integers(0, 100))
    while i < P:
        live = int(rng.integers(1, 41))
        out[i:i + live] = 1
        i += live + int(live * (1 - share) / share * rng.uniform(0.5, 1.5)) + 1
    return out


@pytest.mark.parametrize("pattern", ["scattered", "clustered"])
@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
def test_bounce_step_packs_live_lanes_on_cuda(cuda_device, share, pattern):
    """#3 on Cornell AA 64x64 (after the plain first bounce) with the live
    lanes set to a share, scattered or clustered, with no live count and
    with one that cuts the pool: every lane dead on entry or at or past
    the count unchanged bit for bit, pix exactly, the rest by the lane
    rule against the plain version."""
    ds, cam, settings = _setup(cuda_device, "cornell.txt", {"antialias": True})
    pool = megakernel.first_bounce_reference(ds, cam, 2, settings)
    P = pool[5].shape[0]
    alive = torch.tensor(_alive_pattern(P, share, pattern, int(100 * share)),
                         device=cuda_device)
    lanes = [a.clone().contiguous() for a in megakernel.pool_lanes(pool)]
    lanes[12] = alive
    start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
             Vec3(*lanes[9:12]), lanes[12], lanes[13])
    for cut in (None, 2500):
        n_alive = None if cut is None else torch.tensor(cut, dtype=torch.int32,
                                                        device=cuda_device)
        want = megakernel.bounce_step_reference(start, ds, 2, 1, settings,
                                                num_alive=n_alive)
        copy = [a.clone() for a in megakernel.pool_lanes(start)]
        got = (Vec3(*copy[0:3]), Vec3(*copy[3:6]), Vec3(*copy[6:9]),
               Vec3(*copy[9:12]), copy[12], copy[13])
        before = megakernel.bounce_step.launches
        megakernel.bounce_step(got, ds, 2, 1, settings, num_alive=n_alive)
        torch.cuda.synchronize()
        assert megakernel.bounce_step.launches == before + 1
        still = alive == 0
        if cut is not None:
            still[cut:] = True
        for g, b in zip(megakernel.pool_lanes(got), megakernel.pool_lanes(start)):
            assert torch.equal(g[still].view(torch.int32), b[still].view(torch.int32))
        assert_lanes_close(got, want)
        if share == 0.0:
            assert not got[4].any()


@pytest.mark.parametrize("name,settings_kw", PER_BOUNCE)
def test_shade_step_matches_plain_on_cuda(cuda_device, name, settings_kw):
    ds, cam, settings = _setup(cuda_device, name, settings_kw)
    pool = megakernel.first_bounce_reference(ds, cam, 4, settings)
    for depth in (0, 1):
        isect = intersect_scene(pool[0], pool[1], ds)
        before = megakernel.shade_step.launches
        got = megakernel.shade_step(pool, isect, ds, 4, depth, settings)
        torch.cuda.synchronize()
        assert megakernel.shade_step.launches == before + 1
        want = megakernel.shade_step_reference(pool, isect, ds, 4, depth, settings)
        assert_lanes_close(got, want)


@pytest.mark.parametrize("settings_kw,fb,bs,ss", [
    ({"antialias": True}, 3, 21, 0),
    ({"compact": True}, 3, 21, 0),
    ({"cache_first_bounce": True}, 0, 21, 3),
])
def test_step_launches_per_bounce_kernels(cuda_device, settings_kw, fb, bs, ss):
    """Renderer.step() runs D kernels per iteration: #2 (or #4 under the
    cache) once, then #3 D-1 times; #1 never."""
    r = Renderer(small("cornell.txt", (64, 48)),
                 RenderSettings(trace_depth=8, **settings_kw), device=cuda_device)
    counts = [f.launches for f in (megakernel.full_iteration,
                                   megakernel.first_bounce,
                                   megakernel.bounce_step,
                                   megakernel.shade_step)]
    for _ in range(3):
        r.step()
    torch.cuda.synchronize()
    now = [f.launches for f in (megakernel.full_iteration,
                                megakernel.first_bounce,
                                megakernel.bounce_step,
                                megakernel.shade_step)]
    assert [b - a for a, b in zip(counts, now)] == [0, fb, bs, ss]
    assert r.last_alive_counts.device.type == "cuda"
    assert np.isfinite(r.image()).all() and r.image().max() > 0


# ---- kernels #5 and #6: NEE + MIS ----

NEE = [
    ("cornell.txt", {"antialias": True}, None),
    ("cornell.txt", {"russian_roulette": True, "rr_start_depth": 2,
                     "stratified": True}, None),
    ("cornell.txt", {"antialias": True}, 4),  # the sphere made glossy
    ("many_materials.txt", {"russian_roulette": True}, None),
]


def _nee_setup(cuda_device, name, settings_kw, glossy_mat, res=(64, 64)):
    scene = small(name, res)
    if glossy_mat is not None:
        m = scene.materials
        m.specular_exponent = m.specular_exponent.copy()
        m.specular_exponent[glossy_mat] = 24.0
    settings = RenderSettings(trace_depth=8, nee_mis=True, **settings_kw)
    ds = scene_to_device(scene, cuda_device)
    cam = camera_to_device(scene.state.camera, cuda_device)
    return ds, cam, settings


@pytest.mark.parametrize("name,settings_kw,glossy_mat", NEE)
def test_full_iteration_nee_matches_plain_on_cuda(cuda_device, name, settings_kw,
                                                  glossy_mat):
    """#6 against its plain version, one iteration at 64x64, with
    tests/test_nee_megakernel.py's image rule."""
    ds, cam, settings = _nee_setup(cuda_device, name, settings_kw, glossy_mat)
    accum = Vec3.zeros(64 * 64, cuda_device)
    before = megakernel.full_iteration_nee.launches
    megakernel.full_iteration_nee(ds, cam, 3, settings, accum)
    torch.cuda.synchronize()
    assert megakernel.full_iteration_nee.launches == before + 1
    plain = megakernel.full_iteration_nee_reference(ds, cam, 3, settings)
    for g, w in zip(accum, plain):
        diff = np.abs(g.cpu().numpy() - w.cpu().numpy())
        assert (diff > 1e-3).mean() < 0.03
        assert np.median(diff) < 1e-5


def assert_nee_lanes_close(got, got_aux, want, want_aux):
    """pix exactly; alive per lane under the lane rule of
    tests/test_megakernel.py:57-76 (at most 1% of lanes differ); radiance
    on every lane; the other lanes and the aux on lanes alive after the
    bounce in both (no later step reads the others)."""
    g = [a.cpu().numpy() for a in megakernel.pool_lanes(got)]
    w = [a.cpu().numpy() for a in megakernel.pool_lanes(want)]
    np.testing.assert_array_equal(g[13], w[13])
    assert (g[12] != w[12]).mean() <= 0.01
    both_alive = (g[12] != 0) & (w[12] != 0)
    ga = [a.cpu().numpy() for a in got_aux]
    wa = [a.cpu().numpy() for a in want_aux]
    for k, (a, b) in enumerate(zip(g[:12] + ga, w[:12] + wa)):
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        if 9 <= k <= 11:  # radiance: every lane
            assert (diff > 1e-3).mean() < 0.02, k
        elif both_alive.any():
            assert (diff[both_alive] > 1e-3).mean() < 0.02, k


@pytest.mark.parametrize("name,settings_kw,glossy_mat", NEE)
def test_bounce_step_nee_matches_plain_on_cuda(cuda_device, name, settings_kw,
                                               glossy_mat):
    """#5 in place at depths 0-2 and at depth 3 with is_last, each from
    the plain version's own pool."""
    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays

    ds, cam, settings = _nee_setup(cuda_device, name, settings_kw, glossy_mat)
    origins, dirs, pix = generate_rays(cam, 2, settings.antialias, False)
    P = pix.shape[0]
    pool = (Vec3(*(c.contiguous() for c in origins)), dirs,
            Vec3.ones(P, cuda_device), Vec3.zeros(P, cuda_device),
            torch.ones(P, dtype=torch.int32, device=cuda_device), pix)
    aux = (torch.zeros(P, device=cuda_device), torch.zeros(P, device=cuda_device))
    before = megakernel.bounce_step_nee.launches
    for depth, is_last in ((0, False), (1, False), (2, False), (3, True)):
        want, want_aux = megakernel.bounce_step_nee_reference(
            pool, aux, ds, 2, depth, settings, is_last)
        start = [a.clone() for a in megakernel.pool_lanes(pool)]
        start_pool = (Vec3(*start[0:3]), Vec3(*start[3:6]), Vec3(*start[6:9]),
                      Vec3(*start[9:12]), start[12], start[13])
        start_aux = tuple(a.clone() for a in aux)
        got, got_aux = megakernel.bounce_step_nee(start_pool, start_aux, ds, 2,
                                                  depth, settings, is_last)
        torch.cuda.synchronize()
        assert got is start_pool and got_aux is start_aux
        assert_nee_lanes_close(got, got_aux, want, want_aux)
        pool, aux = want, want_aux
    assert megakernel.bounce_step_nee.launches == before + 4


@pytest.mark.parametrize("res", [(64, 64), (37, 23)])
def test_full_iteration_nee_matches_plain_at_sizes_on_cuda(cuda_device, res):
    """#6's persistent warps at 4,096 pixels and at an odd 851 (the last
    warp's pixels ragged), Cornell AA and many_materials RR, two
    iterations in one call against two plain iterations summed in order:
    tests/test_nee_megakernel.py's image rule."""
    for name, kw in (("cornell.txt", {"antialias": True}),
                     ("many_materials.txt", {"russian_roulette": True})):
        ds, cam, settings = _nee_setup(cuda_device, name, kw, None, res)
        P = res[0] * res[1]
        accum = Vec3.zeros(P, cuda_device)
        before = megakernel.full_iteration_nee.launches
        megakernel.full_iteration_nee(ds, cam, 5, settings, accum, n_iters=2)
        torch.cuda.synchronize()
        assert megakernel.full_iteration_nee.launches == before + 1
        want = Vec3.zeros(P, cuda_device)
        for it in (5, 6):
            for a, w in zip(want, megakernel.full_iteration_nee_reference(
                    ds, cam, it, settings)):
                a.add_(w)
        for g, w in zip(accum, want):
            diff = np.abs(g.cpu().numpy() - w.cpu().numpy())
            assert (diff > 1e-3).mean() < 0.03
            assert np.median(diff) < 1e-5


def test_full_iteration_nee_launches_are_independent_on_cuda(cuda_device):
    """One call of ITERATIONS_PER_LAUNCH + 8 iterations (two back-to-back
    launches, each its own pixel counter) adds, bit for bit, what as many
    one-iteration calls add, whichever lanes took the pixels."""
    ds, cam, settings = _nee_setup(cuda_device, "cornell.txt",
                                   {"antialias": True, "russian_roulette": True},
                                   4)
    P = 64 * 64
    n = megakernel.ITERATIONS_PER_LAUNCH + 8
    both = Vec3.zeros(P, cuda_device)
    before = megakernel.full_iteration_nee.launches
    megakernel.full_iteration_nee(ds, cam, 4, settings, both, n_iters=n)
    assert megakernel.full_iteration_nee.launches - before == 2
    apart = Vec3.zeros(P, cuda_device)
    for it in range(4, 4 + n):
        megakernel.full_iteration_nee(ds, cam, it, settings, apart)
    torch.cuda.synchronize()
    assert megakernel.full_iteration_nee.launches - before == 2 + n
    assert_bit_identical(both, apart)


def _thinned_nee_pool(cuda_device, res, live_share, seed):
    """Cornell AA --nee's pool and aux after the plain version's depths 0
    and 1 (a real aux), with `alive` drawn anew: each slot live with
    probability `live_share` (numpy, seeded)."""
    ds, cam, settings = _nee_setup(cuda_device, "cornell.txt", {"antialias": True},
                                   None, res)
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    pool = _camera_pool(cam, 2, settings)
    P = pool[5].shape[0]
    aux = (torch.zeros(P, device=cuda_device), torch.zeros(P, device=cuda_device))
    for depth in (0, 1):
        pool, aux = megakernel.bounce_step_nee_reference(pool, aux, ds, 2, depth,
                                                         settings, False)
    live = np.random.default_rng(seed).random(P) < live_share
    lanes = [a.clone().contiguous() for a in megakernel.pool_lanes(pool)]
    lanes[12] = torch.tensor(live.astype(np.int32), device=cuda_device)
    pool = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
            Vec3(*lanes[9:12]), lanes[12], lanes[13])
    return ds, settings, pool, tuple(a.contiguous() for a in aux)


@pytest.mark.parametrize("live_share", [0.0, 0.05, 0.9])
def test_bounce_step_nee_packs_live_slots_on_cuda(cuda_device, live_share):
    """#5's packed warps on pools 0%, 5% and 90% live, at 37x23 (851
    slots, not a multiple of 32) and 64x64, depth 2 and depth 7 with
    is_last: every value of a slot dead on entry unchanged (lanes and
    aux), live slots against the plain version with pix exactly."""
    for k, res in enumerate(((37, 23), (64, 64))):
        ds, settings, pool, aux = _thinned_nee_pool(cuda_device, res, live_share, k)
        dead = pool[4] == 0
        for depth, is_last in ((2, False), (7, True)):
            want, want_aux = megakernel.bounce_step_nee_reference(
                pool, aux, ds, 2, depth, settings, is_last)
            start = [a.clone() for a in megakernel.pool_lanes(pool)]
            got = (Vec3(*start[0:3]), Vec3(*start[3:6]), Vec3(*start[6:9]),
                   Vec3(*start[9:12]), start[12], start[13])
            got_aux = tuple(a.clone() for a in aux)
            megakernel.bounce_step_nee(got, got_aux, ds, 2, depth, settings, is_last)
            torch.cuda.synchronize()
            for g, b in zip(megakernel.pool_lanes(got) + list(got_aux),
                            megakernel.pool_lanes(pool) + list(aux)):
                assert torch.equal(g[dead].view(torch.int32), b[dead].view(torch.int32))
            assert_nee_lanes_close(got, got_aux, want, want_aux)
            if live_share == 0.0:
                assert not got[4].any()


@pytest.mark.parametrize("settings_kw,counts", [
    # (full_iteration, first_bounce, bounce_step, shade_step,
    #  bounce_step_nee, full_iteration_nee) per 3 step() + 3 step_batch
    ({"nee_mis": True, "antialias": True}, [0, 0, 0, 0, 24, 1]),
    ({"nee_mis": True, "motion_blur": True}, [0, 0, 0, 0, 48, 0]),
    ({"direct_lighting": True}, [0, 6, 36, 0, 0, 0]),
])
def test_light_sampling_launches(cuda_device, settings_kw, counts):
    """--nee: step_batch runs #6 once per run of up to
    ITERATIONS_PER_LAUNCH iterations, step() runs #5 once per depth (so
    does step_batch under motion blur); --direct-lighting:
    #2 once, #3 for depths 1..D-2, then the plain final step."""
    wrappers = (megakernel.full_iteration, megakernel.first_bounce,
                megakernel.bounce_step, megakernel.shade_step,
                megakernel.bounce_step_nee, megakernel.full_iteration_nee)
    r = Renderer(small("cornell.txt", (64, 48)),
                 RenderSettings(trace_depth=8, **settings_kw), device=cuda_device)
    before = [f.launches for f in wrappers]
    for _ in range(3):
        r.step()
    r.step_batch(3)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == counts
    assert r.last_alive_counts.device.type == "cuda"
    assert int(r.last_alive_counts[-1]) == 0
    assert np.isfinite(r.image()).all() and r.image().max() > 0


# ---- kernels #7-#10: the mesh pipeline ----

MESH = [
    {},
    {"antialias": True},
    {"russian_roulette": True, "rr_start_depth": 1, "stratified": True},
    {"compact": True},
]


def assert_lane_rule(got, want, atol=1e-4, frac=0.01):
    """tests/test_megakernel.py:57-76's lane rule over parallel lists of
    (P,) tensors: at most `frac` of the lanes off by more than `atol`."""
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu().numpy().astype(np.float64)
        w = w.detach().cpu().numpy().astype(np.float64)
        assert (np.abs(g - w) > atol).mean() <= frac, k


def hit_lanes(h):
    return [h.t, *h.normal, h.material_id, h.outside, h.tex_u, h.tex_v, h.has_uv]


def assert_candidates(got, want, alive, n_alive, P, device):
    """#7's list exactly its flagged live lanes below the live count, each
    once; its candidate set within 0.1% of the plain one's; its analytic
    hits on those lanes by the lane rule."""
    n = int(got.count[0])
    lanes = got.lanes[:n].long()
    assert torch.unique(lanes).shape[0] == n
    listed = torch.zeros(P, dtype=torch.bool, device=device)
    listed[lanes] = True
    live = (alive != 0) & (torch.arange(P, device=device)
                           < (P if n_alive is None else n_alive))
    assert torch.equal(listed, got.cand & live)
    assert float((listed != (want.cand & live)).float().mean()) <= 0.001
    assert_lane_rule([a[live] for a in (got.t, *got.normal)],
                     [a[live] for a in (want.t, *want.normal)])
    assert torch.equal(got.material_id[live] >= 0, got.t[live] > 0)


@pytest.mark.parametrize("settings_kw,res", [(kw, (64, 64)) for kw in MESH]
                         + [({"antialias": True}, (256, 256))])
def test_mesh_kernels_match_plain_on_cuda(cuda_device, settings_kw, res):
    """#7, #8, #9 and #10 on mesh.txt at 64x64 (and 256x256: hundreds of
    blocks' runs in #7's list), depths 0-3, each from the plain version's
    own inputs: #7's list exactly its flagged lanes, its candidate set
    within 0.1% of the lanes and its analytic hits, also with a live count
    cutting the pool and under all_lanes (every lane's analytic hit); #8's,
    #9's and #10's lanes under the lane rule, pix exactly."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam, settings = _setup(cuda_device, "mesh.txt", settings_kw, res)
    P = res[0] * res[1]
    pool = _camera_pool(cam, 2, settings)
    counts = [getattr(pipeline, k).launches for k in
              ("mesh_candidates", "mesh_sweep", "bounce_step_mesh",
               "intersect_mesh")]
    for depth in range(4):
        pool = _maybe_compact(pool, settings)
        n_alive = _count_alive(pool) if settings.compact else None
        o, d, alive = pool[0], pool[1], pool[4]
        want7 = pipeline.mesh_candidates_reference(o, d, alive, ds, n_alive)
        got7 = pipeline.mesh_candidates(o, d, alive, ds, num_alive=n_alive)
        torch.cuda.synchronize()
        assert_candidates(got7, want7, alive, n_alive, P, cuda_device)
        # a live count that cuts the pool mid-block, and all_lanes
        cut = torch.tensor(P // 3 + 5, dtype=torch.int32, device=cuda_device)
        assert_candidates(pipeline.mesh_candidates(o, d, alive, ds, num_alive=cut),
                          pipeline.mesh_candidates_reference(o, d, alive, ds, cut),
                          alive, cut, P, cuda_device)
        every = pipeline.mesh_candidates(o, d, alive, ds, all_lanes=True)
        everyw = pipeline.mesh_candidates_reference(o, d, alive, ds)
        torch.cuda.synchronize()
        assert_candidates(every, everyw, alive, None, P, cuda_device)
        assert_lane_rule([every.t, *every.normal, every.material_id],
                         [everyw.t, *everyw.normal, everyw.material_id])
        want8 = pipeline.mesh_sweep_reference(o, d, want7, ds)
        got8 = pipeline.mesh_sweep(o, d, want7, ds)
        torch.cuda.synchronize()
        assert_lane_rule([a[want7.cand] for a in hit_lanes(got8)],
                         [a[want7.cand] for a in hit_lanes(want8)])
        # #10 on every lane of the intersect route
        all7 = pipeline.mesh_candidates_reference(o, d, alive, ds)
        all8 = pipeline.mesh_sweep_reference(o, d, all7, ds)
        got10 = pipeline.intersect_mesh(all7, all8)
        torch.cuda.synchronize()
        assert_lane_rule(hit_lanes(got10), hit_lanes(pipeline.merge_hits(all7, all8)))
        want9 = pipeline.bounce_step_mesh_reference(pool, want7, want8, ds, 2,
                                                    depth, settings, n_alive)
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        got9 = pipeline.bounce_step_mesh(start, want7, want8, ds, 2, depth,
                                         settings, num_alive=n_alive)
        torch.cuda.synchronize()
        assert got9 is start
        g9, w9 = megakernel.pool_lanes(got9), megakernel.pool_lanes(want9)
        assert torch.equal(g9[13], w9[13])
        assert_lane_rule(g9[:13], w9[:13])
        pool = want9
    now = [getattr(pipeline, k).launches for k in
           ("mesh_candidates", "mesh_sweep", "bounce_step_mesh", "intersect_mesh")]
    assert [b - a for a, b in zip(counts, now)] == [12, 4, 4, 4]


@pytest.mark.parametrize("settings_kw,counts", [
    # (#7, #8, #9, #10, #4) over 2 step() + 2 step_batch at depth 8
    ({"antialias": True}, [32, 32, 32, 0, 0]),
    ({"compact": True}, [32, 32, 32, 0, 0]),
    # the cache: #7 -> #8 -> #10 on the first step() and once per batch
    ({"cache_first_bounce": True}, [30, 30, 28, 2, 4]),
    # direct lighting: 7 bounces, then the final step's two intersects
    ({"direct_lighting": True}, [36, 36, 28, 8, 0]),
])
def test_mesh_path_launches(cuda_device, settings_kw, counts):
    """The mesh path runs the mesh pipeline at every depth and never
    #1, #2, #3, #5 or #6."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    wrappers = (pipeline.mesh_candidates, pipeline.mesh_sweep,
                pipeline.bounce_step_mesh, pipeline.intersect_mesh,
                megakernel.shade_step)
    others = (megakernel.full_iteration, megakernel.first_bounce,
              megakernel.bounce_step, megakernel.bounce_step_nee,
              megakernel.full_iteration_nee)
    r = Renderer(small("mesh.txt", (64, 48)),
                 RenderSettings(trace_depth=8, **settings_kw), device=cuda_device)
    before = [f.launches for f in wrappers + others]
    r.step()
    r.step()
    r.step_batch(2)
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(wrappers + others, before)]
    assert got == counts + [0] * len(others)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


def two_meshes(tmp_path):
    """mesh.txt with a second mesh geom, the UV-mapped quad."""
    text = open(os.path.join(SCENES, "mesh.txt")).read().replace(
        "assets/", os.path.join(SCENES, "assets") + "/")
    text += ("\nOBJECT 7\nmesh\nmaterial 1\nFILE        "
             + os.path.join(SCENES, "assets", "uv_quad.obj")
             + "\nTRANS       2 2 -2\nROTAT       0 30 0\nSCALE       2 2 2\n")
    path = tmp_path / "two_meshes.txt"
    path.write_text(text)
    return load_scene(str(path))


def seeded_rays(device, n, aims, seed):
    """n rays from seeded points in the Cornell room, each aimed near one
    of `aims` (world points) in turn."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], (n, 3))
    aim = np.asarray(aims, np.float64)[np.arange(n) % len(aims)]
    d = aim + rng.normal(0, 0.6, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (Vec3(*(torch.tensor(c, dtype=torch.float32, device=device) for c in o.T)),
            Vec3(*(torch.tensor(c, dtype=torch.float32, device=device) for c in d.T)))


def test_mesh_sweep_on_two_mesh_geoms_on_cuda(cuda_device, tmp_path):
    """#8 over a scene of two mesh geoms, on rays aimed at the icosphere
    and at the quad, some of them candidates of both: the lane rule
    against the plain binary walk and against the plain wide walk."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    ds = scene_to_device(two_meshes(tmp_path), cuda_device)
    o, d = seeded_rays(cuda_device, 4096, [(-1, 4, -1), (2, 2, -2)], seed=21)
    cands = pipeline.mesh_candidates_reference(o, d, None, ds)
    n = int(cands.count[0])
    probe = {}
    want = pipeline.mesh_sweep_reference(o, d, cands, ds)
    wide = pipeline.mesh_sweep_wide_reference(o, d, cands, ds, probe=probe)
    got = pipeline.mesh_sweep(o, d, cands, ds)
    torch.cuda.synchronize()
    assert int((probe["walks"] == 2).sum()) > 0
    lanes = cands.lanes[:n].long()
    assert_lane_rule([a[lanes] for a in hit_lanes(got)],
                     [a[lanes] for a in hit_lanes(want)])
    assert_lane_rule([a[lanes] for a in hit_lanes(got)],
                     [a[lanes] for a in hit_lanes(wide)])
    assert float((got.material_id[lanes] != want.material_id[lanes]).float().mean()) <= 0.001


def test_mesh_sweep_dense_walk_on_big_mesh_on_cuda(cuda_device, big_mesh, monkeypatch):
    """The dense-walk yardstick: mesh_big's 51,200 triangles on #8's wide
    walk (the routing threshold raised in this test only), at depths 0-2
    of a 64x64 AA iteration, each from the plain chain's pool: the lane
    rule against the plain binary walk, #9's pix exactly."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    monkeypatch.setattr(pipeline, "SORT_SUPER_MIN_TRIS", 2**31)
    tables = megakernel.pack_scene_tables(ds)
    assert int(tables.wide.root[0]) == 0 and pipeline.sorted_geoms(ds) == ()
    settings = RenderSettings(trace_depth=8, antialias=True)
    pool = _camera_pool(cam, 2, settings)
    for depth in range(3):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        n = int(cands.count[0])
        want = pipeline.mesh_sweep_reference(o, d, cands, ds)
        got = pipeline.mesh_sweep(o, d, cands, ds, tables=tables)
        torch.cuda.synchronize()
        assert n > 0
        lanes = cands.lanes[:n].long()
        assert_lane_rule([a[lanes] for a in hit_lanes(got)],
                         [a[lanes] for a in hit_lanes(want)])
        want9 = pipeline.bounce_step_mesh_reference(pool, cands, want, ds, 2, depth,
                                                    settings)
        lanes9 = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes9[0:3]), Vec3(*lanes9[3:6]), Vec3(*lanes9[6:9]),
                 Vec3(*lanes9[9:12]), lanes9[12], lanes9[13])
        got9 = pipeline.bounce_step_mesh(start, cands, got, ds, 2, depth, settings,
                                         tables=tables)
        torch.cuda.synchronize()
        assert torch.equal(megakernel.pool_lanes(got9)[13],
                           megakernel.pool_lanes(want9)[13])
        pool = want9


def test_mesh_sweep_tie_and_slab_lanes_on_cuda(cuda_device):
    """The lanes on which the wide walk's order can change the winner: the
    plain wide walk against the plain binary walk (the same float ops, so
    only a triangle whose t lies an ulp inside a box's slab entry, or an
    exact tie, can part them) and #8 against the plain wide walk, counted
    at every depth of mesh.txt 64x64 AA: each at most 0.1% of the
    candidate lanes."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam, settings = _setup(cuda_device, "mesh.txt", {"antialias": True})
    tables = megakernel.pack_scene_tables(ds)
    pool = _camera_pool(cam, 2, settings)
    slab = off = total = 0
    for depth in range(8):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        lanes = cands.lanes[:int(cands.count[0])].long()
        binary = pipeline.mesh_sweep_reference(o, d, cands, ds)
        wide = pipeline.mesh_sweep_wide_reference(o, d, cands, ds, tables.wide)
        got = pipeline.mesh_sweep(o, d, cands, ds, tables=tables)
        torch.cuda.synchronize()
        slab += int((wide.t[lanes] != binary.t[lanes]).sum())
        off += int(((got.t[lanes] - wide.t[lanes]).abs() > 1e-4).sum())
        total += lanes.shape[0]
        pool = pipeline.bounce_step_mesh_reference(pool, cands, binary, ds, 2, depth,
                                                   settings)
    assert total > 1000
    assert slab <= 0.001 * total and off <= 0.001 * total


@pytest.fixture(scope="module")
def big_mesh():
    """mesh_big.txt (one 51,200-triangle geom: the sorted route) at 64x64
    on the card, loaded once: (DeviceScene, DeviceCamera)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels build on first use)")
    s = small("mesh_big.txt", (64, 64))
    dev = torch.device("cuda")
    return scene_to_device(s, dev), camera_to_device(s.state.camera, dev)


def entry_pairs(key, entry, total):
    """The (key, entry) pairs of a stream's real entries, sorted, as one
    int64 array (the order within a key is the atomics')."""
    m = int(total[0])
    pairs = key[:m].long() * (1 << 32) + entry[:m].long()
    return torch.sort(pairs).values


def assert_place_counts(pipeline, keys, n, dead, device):
    """B over the first c columns of A-like keys (E, P) whose first n are
    written, for c = 0, 1 and a tile's lanes -1 / 0 / +1 as far as n
    allows, against the plain version: per key, the total exact. The
    histogram is the c columns', and B zeroes its own cursor. Returns the
    launches of B it made."""
    E, P = keys.shape
    launches = 0
    tile = pipeline.PLACE_THREADS * (pipeline.PLACE_MAX_E // E)  # B's tile of lanes
    for c in (0, 1, tile - 1, tile, tile + 1):
        if c > n:
            continue
        listed = keys[:, :c]
        hist = torch.bincount(listed[listed < dead].long(), minlength=dead).int()
        sk = pipeline.SuperKeys(keys, torch.zeros(6, P, device=device),
                                torch.zeros(P, device=device), hist)
        count = torch.tensor([c], dtype=torch.int32, device=device)
        got = pipeline.place_entries(sk, count)
        launches += 1
        want = pipeline.place_entries_reference(sk, count)
        torch.cuda.synchronize()
        assert int(got.total[0]) == int(want.total[0]) == int(hist.sum()), c
        assert torch.equal(entry_pairs(*got), entry_pairs(*want)), c
    return launches


@pytest.mark.parametrize("E,seed", [(6, 0), (1, 1), (2, 2)])
def test_place_entries_counts_on_cuda(cuda_device, E, seed):
    """B on seeded keys of 2 x 6,144 bins over three tiles of lanes, at
    counts 0, 1 and a tile's lanes -1 / 0 / +1 and all of them; and twice
    on one output of A's layout (the cursors the first run left)."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    rng = np.random.default_rng(seed)
    dead = 2 * pipeline.MAX_SUPERS
    P = 3 * pipeline.PLACE_THREADS * (pipeline.PLACE_MAX_E // E) + 17
    keys = rng.integers(0, dead, (E, P))
    keys[rng.uniform(size=(E, P)) < 0.4] = dead
    keys = torch.tensor(keys, dtype=torch.int32, device=cuda_device)
    assert_place_counts(pipeline, keys, P, dead, cuda_device)
    counts = torch.zeros(2 * dead, dtype=torch.int32, device=cuda_device)
    counts[:dead] = torch.bincount(keys[keys < dead].long(), minlength=dead)
    sk = pipeline.SuperKeys(keys, torch.zeros(6, P, device=cuda_device),
                            torch.zeros(P, device=cuda_device), counts[:dead],
                            counts[dead:])
    count = torch.tensor([P], dtype=torch.int32, device=cuda_device)
    want = pipeline.place_entries_reference(sk, count)
    for _ in range(2):
        got = pipeline.place_entries(sk, count)
        torch.cuda.synchronize()
        assert int(got.total[0]) == int(want.total[0])
        assert torch.equal(entry_pairs(*got), entry_pairs(*want))
        assert bool((got.key[1:int(got.total[0])] >= got.key[:int(got.total[0]) - 1]).all())
    assert torch.equal(counts[dead:], 2 * counts[:dead])


@pytest.mark.parametrize("E", [6, 2, 1])
def test_sorted_route_matches_plain_on_cuda(cuda_device, big_mesh, E):
    """A-D on mesh_big.txt at 64x64, depths 0-7, each from the plain
    version's own inputs (the pool after the plain bounce before): A's
    keys exactly those of `super_rank` over its own object-space rays and
    bounds, which match the plain ones by the lane rule; B's stream per
    key exactly the plain one's; C's t and u, v by the lane rule, its
    triangle on 99% of the entries (ties); D's hit lanes and the whole
    chain (#9's pool) by the lane rule, pix exactly. #8 walks no big
    geom."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    settings = RenderSettings(trace_depth=8, antialias=True)
    (g,) = pipeline.sorted_geoms(ds)
    ss, sn = ds.super_ranges[g]
    pool = _camera_pool(cam, 2, settings)
    route = ("super_keys", "place_entries", "window_sweep", "merge_entries")
    before = [getattr(pipeline, k).launches for k in route]
    extra_b = 0
    for depth in range(8):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        n = int(cands.count[0])
        hits = pipeline.mesh_sweep(o, d, cands, ds)
        torch.cuda.synchronize()
        assert bool((hits.t[cands.lanes[:n].long()] == -1).all())  # #8 skips g
        hits = pipeline.mesh_sweep_reference(o, d, cands, ds)
        sk = pipeline.super_keys(o, d, cands, hits, ds, g, E)
        torch.cuda.synchronize()
        keys = pipeline.super_rank(tuple(sk.rays[:, :n]), sk.bt0[:n],
                                   ds.mesh_super_aabbs[ss:ss + sn], E)
        assert torch.equal(sk.keys[:, :n], keys)
        real = keys[keys < 2 * sn].long()
        assert torch.equal(sk.hist, torch.bincount(real, minlength=2 * sn).int())
        want_sk = pipeline.super_keys_reference(o, d, cands, hits, ds, g, E)
        assert (sk.keys[:, :n] != want_sk.keys[:, :n]).float().mean() <= 0.001
        assert_lane_rule(list(sk.rays[:, :n]), list(want_sk.rays[:, :n]))
        st = pipeline.place_entries(sk, cands.count)
        want_st = pipeline.place_entries_reference(sk, cands.count)
        torch.cuda.synchronize()
        assert int(st.total[0]) == int(want_st.total[0]) == real.shape[0]
        assert torch.equal(entry_pairs(*st), entry_pairs(*want_st))
        # B again on the same A output (on the cursors the first run left)
        again = pipeline.place_entries(sk, cands.count)
        torch.cuda.synchronize()
        assert int(again.total[0]) == real.shape[0]
        assert torch.equal(entry_pairs(*again), entry_pairs(*want_st))
        extra_b += 1  # B's launches beyond the route's own
        if depth == 0:  # B over the first 0, 1 and a tile's lanes -1 / 0 / +1
            extra_b += assert_place_counts(pipeline, sk.keys, n, 2 * sn, cuda_device)
        eh = pipeline.window_sweep(st, sk, ds, g)
        want_eh = pipeline.window_sweep_reference(st, sk, ds, g)
        torch.cuda.synchronize()
        ids = st.entry[:int(st.total[0])].long()
        flat = lambda a: a.reshape(-1)[ids]  # noqa: E731
        assert_lane_rule([flat(eh.t), flat(eh.u), flat(eh.v)],
                         [flat(want_eh.t), flat(want_eh.u), flat(want_eh.v)])
        assert (flat(eh.tri) != flat(want_eh.tri)).float().mean() <= 0.01
        clone = lambda h: type(h)(*(  # noqa: E731
            Vec3(*(c.clone() for c in f)) if isinstance(f, Vec3) else f.clone()
            for f in (h.t, h.normal, h.material_id, h.outside, h.tex_u, h.tex_v,
                      h.has_uv)))
        got = pipeline.merge_entries(o, d, cands, clone(hits), sk, eh, ds, g)
        want = pipeline.merge_entries_reference(o, d, cands, clone(hits), sk, eh,
                                                ds, g)
        torch.cuda.synchronize()
        lanes = cands.lanes[:n].long()
        assert_lane_rule([a[lanes] for a in hit_lanes(got)],
                         [a[lanes] for a in hit_lanes(want)])
        # the whole bounce: #7 -> #8 -> A-D -> #9 against its plain chain
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        tables = megakernel.pack_scene_tables(ds)
        pipeline.SORT_EXPAND, old = E, pipeline.SORT_EXPAND
        try:
            chain = pipeline.bounce_step_pipeline(start, ds, 2, depth, settings,
                                                  tables=tables)
        finally:
            pipeline.SORT_EXPAND = old
        torch.cuda.synchronize()
        plain = pipeline.merge_entries_reference(
            o, d, cands, clone(hits), want_sk,
            pipeline.window_sweep_reference(
                pipeline.place_entries_reference(want_sk, cands.count), want_sk,
                ds, g), ds, g)
        want9 = pipeline.bounce_step_mesh_reference(pool, cands, plain, ds, 2,
                                                    depth, settings)
        g9, w9 = megakernel.pool_lanes(chain), megakernel.pool_lanes(want9)
        assert torch.equal(g9[13], w9[13])
        assert_lane_rule(g9[:13], w9[:13])
        pool = want9
    now = [getattr(pipeline, k).launches for k in route]
    assert [b - a for a, b in zip(before, now)] == [16, 16 + extra_b, 16, 16]


def test_big_mesh_path_launches(cuda_device):
    """mesh_big.txt through the Renderer: #7 -> #8 -> A -> B -> C -> D ->
    #9 at every depth of step() and step_batch, nothing of #1-#6."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    wrappers = tuple(getattr(pipeline, k) for k in (
        "mesh_candidates", "mesh_sweep", "super_keys", "place_entries",
        "window_sweep", "merge_entries", "bounce_step_mesh", "intersect_mesh"))
    others = (megakernel.full_iteration, megakernel.first_bounce,
              megakernel.bounce_step, megakernel.bounce_step_nee,
              megakernel.full_iteration_nee)
    r = Renderer(small("mesh_big.txt", (64, 48)),
                 RenderSettings(trace_depth=8, antialias=True), device=cuda_device)
    before = [f.launches for f in wrappers + others]
    r.step()
    r.step_batch(2)
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(wrappers + others, before)]
    assert got == [24] * 7 + [0] + [0] * len(others)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


@pytest.fixture(scope="module")
def bunny():
    """bunny.txt (one 69,120-triangle geom: the sorted route, 68
    supernodes) at 64x64 on the card, loaded once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels build on first use)")
    s = small("bunny.txt", (64, 64))
    dev = torch.device("cuda")
    return scene_to_device(s, dev), camera_to_device(s.state.camera, dev)


@pytest.mark.parametrize("E", [1, 2, 6, 8])
@pytest.mark.parametrize("scene", ["big_mesh", "bunny"])
def test_super_keys_equal_super_rank_on_cuda(cuda_device, request, scene, E):
    """A on mesh_big (50 supernodes) and bunny (68) at 64x64, at every
    depth of one iteration (the pools advanced by the kernels' bounce):
    its keys exactly `super_rank`'s over A's own object-space rays and
    bounds, its histogram exactly theirs and B's cursor zero."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = request.getfixturevalue(scene)
    settings = RenderSettings(trace_depth=8, antialias=True)
    tables = megakernel.pack_scene_tables(ds)
    (g,) = pipeline.sorted_geoms(ds)
    ss, sn = ds.super_ranges[g]
    pool = _camera_pool(cam, 2, settings)
    listed = 0
    for depth in range(8):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates(o, d, alive, ds, tables=tables)
        hits = pipeline.mesh_sweep(o, d, cands, ds, tables=tables)
        before = pipeline.super_keys.launches
        sk = pipeline.super_keys(o, d, cands, hits, ds, g, E, tables=tables)
        torch.cuda.synchronize()
        assert pipeline.super_keys.launches == before + 1
        n = int(cands.count[0])
        listed += n
        keys = pipeline.super_rank(tuple(sk.rays[:, :n]), sk.bt0[:n],
                                   ds.mesh_super_aabbs[ss:ss + sn], E)
        assert torch.equal(sk.keys[:, :n], keys), depth
        real = keys[keys < 2 * sn].long()
        assert torch.equal(sk.hist, torch.bincount(real, minlength=2 * sn).int()), depth
        assert not sk.cursor.any()
        pool = pipeline.bounce_step_pipeline(pool, ds, 2, depth, settings, tables=tables)
    assert listed > 0


def test_super_keys_rejects_e_above_its_registers_on_cuda(cuda_device, big_mesh):
    """A holds a lane's keys in registers, PLACE_MAX_E of them at most."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    (g,) = pipeline.sorted_geoms(ds)
    pool = _camera_pool(cam, 2, RenderSettings(trace_depth=8, antialias=True))
    o, d, alive = pool[0], pool[1], pool[4]
    cands = pipeline.mesh_candidates(o, d, alive, ds)
    hits = pipeline.mesh_sweep(o, d, cands, ds)
    for E in (0, pipeline.PLACE_MAX_E + 1):
        with pytest.raises(ValueError, match="E must be in"):
            pipeline.super_keys(o, d, cands, hits, ds, g, E)


def radix_exact(pl, got, want, m):
    """Two split streams equal on [0, m): keys, moved words and ids."""
    assert torch.equal(got.key[:m], want.key[:m])
    assert torch.equal(got.payload[:, :m].view(torch.int32),
                       want.payload[:, :m].view(torch.int32))
    assert (got.entry is None) == (want.entry is None)
    if got.entry is not None:
        assert torch.equal(got.entry[:m], want.entry[:m])


def radix_sort_on_cuda(pl, keys, rays, count, dead):
    """The compaction split and every digit pass of the route's sort of A-
    like keys (E, P) on the card, each against its plain version exactly
    (keys, moved words, ids; the compaction's length and digit
    histograms); the sorted stream the stable torch.sort gather of the
    compacted one with its ids; the unscatter exactly its plain version
    and the round trip of the rays to every real [slot, j]. Returns (the
    sorted stream, its length)."""
    E, P = keys.shape
    compact = pl.RadixSplit(keys, count, -1, dead)
    work = pl.radix_work(E * P, pl.radix_key_bits(dead), keys.device)
    stream = pl.radix_split(compact, rays, work=work)
    want = pl.radix_split_reference(compact, rays)
    torch.cuda.synchronize()
    total = int(stream.length[0])
    real = (keys < dead) & (torch.arange(P, device=keys.device) < count)[None]
    assert total == int(want.length[0]) == int(real.sum())
    radix_exact(pl, stream, want, total)
    assert torch.equal(stream.hist, want.hist)
    srt = stream
    for p, (shift, width) in enumerate(pl.radix_passes(pl.radix_key_bits(dead))):
        sp = pl.RadixSplit(srt.key, srt.length, shift, width=width, hist=srt.hist[p])
        got = pl.radix_split(sp, srt.payload, srt.entry, work=work)
        torch.cuda.synchronize()
        radix_exact(pl, got, pl.radix_split_reference(sp, srt.payload, srt.entry), total)
        srt = got._replace(hist=srt.hist)
    order = torch.sort(stream.key[:total], stable=True).indices
    assert torch.equal(srt.key[:total], stream.key[:total][order])
    assert torch.equal(srt.payload[:, :total], stream.payload[:, order])
    assert torch.equal(srt.entry[:total], stream.entry[:total][order])
    back = pl.radix_unscatter(srt, srt.payload[:4].clone())
    want_back = pl.radix_unsplit_reference(srt, srt.payload[:4])
    torch.cuda.synchronize()
    flat = real.reshape(-1)
    assert torch.equal(back[:, flat], want_back[:, flat])
    assert torch.equal(back[:, flat],
                       rays[:4, None, :].expand(4, E, P).reshape(4, -1)[:, flat])
    return srt, total


def test_radix_kernels_match_plain_on_cuda(cuda_device):
    """radix_split and radix_unscatter against their plain versions,
    exactly (integers and moved floats): the compaction split of seeded
    (E, P) keys (dead keys and unwritten columns past the count included)
    with its ids, length and digit histograms, the one 8-bit pass of
    bit_length(2 * 50) bits and a one-bit pass (width 1, the function of
    one `_kr_partition` + `_kr_stitch2`), each with its own scratch; the
    sorted stream is the stable torch.sort gather, and the unsort by id
    round-trips. 2 + 1 split launches and 1 unscatter. Bad inputs raise."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    rng = np.random.default_rng(5)
    E, P, count, dead = 6, 20000, 17777, 100
    keys = rng.integers(0, dead + 1, (E, P)).astype(np.int32)
    keys[rng.uniform(size=(E, P)) < 0.5] = dead
    keys = torch.tensor(keys, device=cuda_device)
    rays = torch.tensor(rng.standard_normal((6, P)).astype(np.float32),
                        device=cuda_device)
    cnt = torch.tensor([count], dtype=torch.int32, device=cuda_device)
    wrappers = (pl.radix_split, pl.radix_unscatter)
    before = [f.launches for f in wrappers]
    srt, total = radix_sort_on_cuda(pl, keys, rays, cnt, dead)
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 1]
    for bit in (0, 4):
        sp = pl.RadixSplit(srt.key, srt.length, bit, width=1,
                           hist=pl.radix_digit_counts(srt.key, srt.length, bit, 1))
        got = pl.radix_split(sp, srt.payload, srt.entry)  # its own scratch
        torch.cuda.synchronize()
        radix_exact(pl, got, pl.radix_split_reference(sp, srt.payload, srt.entry), total)
    compact = pl.RadixSplit(keys, cnt, -1, dead)
    with pytest.raises(ValueError):
        pl.radix_split(compact, torch.zeros((9, P), device=cuda_device))
    with pytest.raises(ValueError):
        pl.radix_split(pl.RadixSplit(srt.key, srt.length, 0, width=9, hist=srt.hist[0]),
                       srt.payload)
    with pytest.raises(ValueError):
        pl.radix_split(pl.RadixSplit(srt.key, srt.length, 0, width=8), srt.payload)
    with pytest.raises(TypeError):
        pl.radix_unscatter(srt, srt.payload[:4].double())


@pytest.mark.parametrize("n_supers", [300, 6144])
def test_radix_two_passes_on_cuda(cuda_device, n_supers):
    """Keys up to 2 x 300 and 2 x MAX_SUPERS = 12,288 (bit_length 10 and
    14: two passes, 8 + 2 and 8 + 6 bits): the compaction split, both
    passes and the unscatter exactly their plain versions on the card, the
    sort the stable torch.sort gather. 3 split launches and 1 unscatter."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    rng = np.random.default_rng(n_supers)
    E, P, count, dead = 6, 30000, 29001, 2 * n_supers
    keys = rng.integers(0, dead + 1, (E, P)).astype(np.int32)
    keys[rng.uniform(size=(E, P)) < 0.3] = dead
    keys = torch.tensor(keys, device=cuda_device)
    rays = torch.tensor(rng.standard_normal((6, P)).astype(np.float32),
                        device=cuda_device)
    cnt = torch.tensor([count], dtype=torch.int32, device=cuda_device)
    assert len(pl.radix_passes(pl.radix_key_bits(dead))) == 2
    before = [pl.radix_split.launches, pl.radix_unscatter.launches]
    radix_sort_on_cuda(pl, keys, rays, cnt, dead)
    assert [pl.radix_split.launches - before[0],
            pl.radix_unscatter.launches - before[1]] == [3, 1]


def test_radix_empty_stream_on_cuda(cuda_device):
    """No listed lane, and listed lanes whose keys are all dead: the
    compaction split gives length 0 and zero histograms (its launch zeroes
    the scratch, filled with -1 here), and the pass and the unscatter
    launch over an empty stream without a fault."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    E, P, dead = 6, 5000, 100
    rays = torch.ones((6, P), device=cuda_device)
    for count, fill in ((0, 7), (P, dead)):
        keys = torch.full((E, P), fill, dtype=torch.int32, device=cuda_device)
        cnt = torch.tensor([count], dtype=torch.int32, device=cuda_device)
        work = pl.radix_work(E * P, pl.radix_key_bits(dead), cuda_device)
        work.buf.fill_(-1)  # the compaction split's launch zeroes it
        stream = pl.radix_split(pl.RadixSplit(keys, cnt, -1, dead), rays, work=work)
        srt = pl.radix_sort_stream(stream, pl.radix_key_bits(dead), work=work)
        out = pl.radix_unscatter(srt, torch.zeros((4, E * P), device=cuda_device))
        torch.cuda.synchronize()
        assert int(stream.length[0]) == 0 and not stream.hist.any()
        assert srt.length is stream.length and out.shape == (4, E * P)


@pytest.mark.parametrize("E", [6, 2])
def test_radix_route_matches_counting_route_on_cuda(cuda_device, big_mesh, E):
    """mesh_big.txt at 64x64, depths 0-7, from the plain bounce's pool: the
    stream-order C against its plain version over the radix kernels' sorted
    stream (C's rule: t, u, v by the lane rule, the triangle on 99% of the
    entries), the radix route's C results at every real [slot, j] and the
    whole bounce (#7 -> #8 -> A -> radix route -> D -> #9) bit-equal to the
    counting route's (B -> C) on every lane."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    settings = RenderSettings(trace_depth=8, antialias=True)
    tables = megakernel.pack_scene_tables(ds)
    (g,) = pipeline.sorted_geoms(ds)
    sn = ds.super_ranges[g][1]
    pool = _camera_pool(cam, 2, settings)
    radix = ("radix_split", "radix_unscatter", "window_sweep_stream")
    before = [getattr(pipeline, k).launches for k in radix]
    bits = pipeline.radix_key_bits(2 * sn)
    for depth in range(8):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        n = int(cands.count[0])
        hits = pipeline.mesh_sweep_reference(o, d, cands, ds)
        sk = pipeline.super_keys(o, d, cands, hits, ds, g, E, tables=tables)
        eh = pipeline.window_sweep(pipeline.place_entries(sk, cands.count), sk, ds, g,
                                   tables=tables)
        compact = pipeline.RadixSplit(sk.keys, cands.count, -1, 2 * sn)
        srt = pipeline.radix_sort_stream(pipeline.radix_split(compact, sk.rays), bits)
        got = pipeline.entry_hits(pipeline.window_sweep_stream(srt, ds, g, tables=tables))
        want = pipeline.entry_hits(pipeline.window_sweep_stream_reference(srt, ds, g))
        torch.cuda.synchronize()
        m = int(srt.length[0])
        assert_lane_rule([a[:m] for a in (got.t, got.u, got.v)],
                         [a[:m] for a in (want.t, want.u, want.v)])
        assert (got.tri[:m] != want.tri[:m]).float().mean() <= 0.01
        rad = pipeline.radix_window_sweep(sk, cands.count, ds, g, tables=tables)
        torch.cuda.synchronize()
        real = (sk.keys < 2 * sn) & (torch.arange(sk.keys.shape[1], device=cuda_device)
                                     < n)[None]
        for a, b in zip(rad, eh):
            assert torch.equal(a[real], b[real])
        chains = []
        for flag in (False, True):
            lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
            start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                     Vec3(*lanes[9:12]), lanes[12], lanes[13])
            old = pipeline.SORT_RADIX, pipeline.SORT_EXPAND
            pipeline.SORT_RADIX, pipeline.SORT_EXPAND = flag, E
            try:
                chains.append(pipeline.bounce_step_pipeline(start, ds, 2, depth, settings,
                                                            tables=tables))
            finally:
                pipeline.SORT_RADIX, pipeline.SORT_EXPAND = old
        torch.cuda.synchronize()
        for a, b in zip(megakernel.pool_lanes(chains[1]), megakernel.pool_lanes(chains[0])):
            assert torch.equal(a, b)
        pool = pipeline.bounce_step_mesh_reference(
            pool, cands, pipeline.merge_entries_reference(
                o, d, cands, hits, sk, eh, ds, g), ds, 2, depth, settings)
    passes = len(pipeline.radix_passes(bits))
    now = [getattr(pipeline, k).launches for k in radix]
    # per depth: the split and sort above, the route, the radix chain (each
    # the compaction split and one 8-bit pass; the route and the chain one
    # unscatter each)
    assert passes == 1
    assert [b - a for a, b in zip(before, now)] == [8 * 3 * (1 + passes), 8 * 2, 8 * 3]


def c_rule(got, want, m):
    """C's rule over the first m entries of two EntryHits-like tuples (t,
    triangle, u, v): t, u and v by the lane rule, the triangle on 99% of
    the entries (ties)."""
    assert_lane_rule([a[:m] for a in (got[0], got[2], got[3])],
                     [a[:m] for a in (want[0], want[2], want[3])])
    assert (got[1][:m] != want[1][:m]).float().mean() <= 0.01


@pytest.mark.parametrize("part", ["window", "tail_from_0"])
def test_window_sweep_work_split_on_cuda(cuda_device, big_mesh, part):
    """C's two instantiations on streams that stress the warp-per-entry
    split, from mesh_big.txt's 64x64 AA camera rays and the rays after one
    bounce: (window) only B's window entries, the prefix of its
    stream; (tail_from_0) every real entry made a tail from super 0, the
    worst case for a tail (every super swept). Each against its plain
    version by C's rule, and the two bit-equal entry for entry."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    settings = RenderSettings(trace_depth=8, antialias=True)
    tables = megakernel.pack_scene_tables(ds)
    (g,) = pipeline.sorted_geoms(ds)
    sn = ds.super_ranges[g][1]
    pool = _camera_pool(cam, 2, settings)
    for depth in range(2):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        hits = pipeline.mesh_sweep_reference(o, d, cands, ds)
        sk = pipeline.super_keys(o, d, cands, hits, ds, g, tables=tables)
        st = pipeline.place_entries(sk, cands.count)
        torch.cuda.synchronize()
        m = int(st.total[0])
        P = sk.keys.shape[1]
        key = st.key.clone()
        if part == "window":
            m = int((st.key[:m] < sn).sum())
            key[m:] = 2 * sn
        else:
            key[:m] = sn
        assert m > 100
        total = torch.tensor([m], dtype=torch.int32, device=cuda_device)
        part_st = pipeline.Stream(key, st.entry, total)
        eh = pipeline.window_sweep(part_st, sk, ds, g, tables=tables)
        want = pipeline.window_sweep_reference(part_st, sk, ds, g)
        payload = torch.zeros((6, key.shape[0]), device=cuda_device)
        ids = st.entry[:m].long()
        payload[:, :m] = sk.rays[:, ids % P]
        stream = pipeline.RadixStream(key, payload, total)
        res = pipeline.entry_hits(pipeline.window_sweep_stream(stream, ds, g, tables=tables))
        want_s = pipeline.entry_hits(pipeline.window_sweep_stream_reference(stream, ds, g))
        torch.cuda.synchronize()
        flat = [a.reshape(-1)[ids] for a in eh]
        c_rule(flat, [a.reshape(-1)[ids] for a in want], m)
        c_rule(res, want_s, m)
        for a, b in zip(flat, res):
            assert torch.equal(a.view(torch.int32), b[:m].view(torch.int32))
        assert (flat[0] < pipeline.FLT_MAX).float().mean() > 0.05  # entries hit
        pool = pipeline.bounce_step_pipeline(pool, ds, 2, depth, settings, tables=tables)


@pytest.mark.parametrize("E", [6, 1])
def test_window_sweep_routes_bit_equal_on_cuda(cuda_device, big_mesh, E):
    """mesh_big.txt at 64x64, every depth, from the plain bounce's pool:
    C on the counting route against its plain version by C's rule, C's
    results at every real [slot, j] of the radix route bit-equal to the
    counting route's, and D's hit lanes over each bit-equal (E = 1: every
    lane that enters two supers has one tail entry)."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    settings = RenderSettings(trace_depth=8, antialias=True)
    tables = megakernel.pack_scene_tables(ds)
    (g,) = pipeline.sorted_geoms(ds)
    sn = ds.super_ranges[g][1]
    pool = _camera_pool(cam, 2, settings)
    tails = 0
    for depth in range(8):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        n = int(cands.count[0])
        hits = pipeline.mesh_sweep_reference(o, d, cands, ds)
        sk = pipeline.super_keys(o, d, cands, hits, ds, g, E, tables=tables)
        st = pipeline.place_entries(sk, cands.count)
        eh = pipeline.window_sweep(st, sk, ds, g, tables=tables)
        want = pipeline.window_sweep_reference(st, sk, ds, g)
        rad = pipeline.radix_window_sweep(sk, cands.count, ds, g, tables=tables)
        torch.cuda.synchronize()
        m = int(st.total[0])
        tails += int((st.key[:m] >= sn).sum())
        ids = st.entry[:m].long()
        c_rule([a.reshape(-1)[ids] for a in eh], [a.reshape(-1)[ids] for a in want], m)
        real = (sk.keys < 2 * sn) & (torch.arange(sk.keys.shape[1], device=cuda_device)
                                     < n)[None]
        for a, b in zip(rad, eh):
            assert torch.equal(a[real].view(torch.int32), b[real].view(torch.int32))
        lanes = cands.lanes[:n].long()
        got = [pipeline.merge_entries(o, d, cands, hits_copy(hits), sk, x, ds, g,
                                      tables=tables) for x in (eh, rad)]
        torch.cuda.synchronize()
        for a, b in zip(hit_lanes(got[0]), hit_lanes(got[1])):
            assert torch.equal(a[lanes], b[lanes])
        pool = pipeline.bounce_step_mesh_reference(
            pool, cands, pipeline.merge_entries_reference(o, d, cands, hits, sk, eh, ds, g),
            ds, 2, depth, settings)
    assert tails > 0


def hits_copy(h):
    return type(h)(*(Vec3(*(c.clone() for c in f)) if isinstance(f, Vec3) else f.clone()
                     for f in (h.t, h.normal, h.material_id, h.outside, h.tex_u,
                               h.tex_v, h.has_uv)))


def test_big_mesh_radix_path_launches(cuda_device):
    """mesh_big.txt through the Renderer under SORT_RADIX: #7 -> #8 -> A ->
    the radix route (2 splits: the compaction and one 8-bit pass of 7 bits;
    C in stream order; 1 unscatter) -> D -> #9 at every depth of step() and
    step_batch; neither B nor the counting-route C."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    names = ("mesh_candidates", "mesh_sweep", "super_keys", "merge_entries",
             "bounce_step_mesh", "window_sweep_stream", "radix_unscatter",
             "radix_split", "place_entries", "window_sweep", "intersect_mesh")
    r = Renderer(small("mesh_big.txt", (64, 48)),
                 RenderSettings(trace_depth=8, antialias=True), device=cuda_device)
    before = [getattr(pipeline, k).launches for k in names]
    pipeline.SORT_RADIX, old = True, pipeline.SORT_RADIX
    try:
        r.step()
        r.step_batch(2)
    finally:
        pipeline.SORT_RADIX = old
    torch.cuda.synchronize()
    got = [getattr(pipeline, k).launches - b for k, b in zip(names, before)]
    assert got == [24] * 7 + [24 * 2] + [0] * 3
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


def pool_copy(pool):
    lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
    return (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]), Vec3(*lanes[9:12]),
            lanes[12], lanes[13])


@pytest.mark.parametrize("pattern", ["scattered", "clustered"])
@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
def test_bounce_step_mesh_live_lanes_on_cuda(cuda_device, share, pattern):
    """#9 on mesh.txt AA 64x64 at depth 1 (after the plain depth 0) with
    the live lanes set to a share, scattered or clustered, #7's and #8's
    plain hits for them, with no live count and with one that cuts the
    pool: every lane dead on entry or at or past the count unchanged bit
    for bit, pix exactly, the rest by the lane rule against the plain
    version; a second launch on the same inputs equal to the first bit for
    bit."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam, settings = _setup(cuda_device, "mesh.txt", {"antialias": True})
    pool = _camera_pool(cam, 2, settings)
    cands = pipeline.mesh_candidates_reference(pool[0], pool[1], pool[4], ds)
    hits = pipeline.mesh_sweep_reference(pool[0], pool[1], cands, ds)
    pool = pipeline.bounce_step_mesh_reference(pool, cands, hits, ds, 2, 0, settings)
    P = pool[5].shape[0]
    alive = torch.tensor(_alive_pattern(P, share, pattern, int(100 * share) + 7),
                         device=cuda_device)
    start = pool_copy(pool)
    start[4].copy_(alive)
    for cut in (None, 2500):
        n_alive = None if cut is None else torch.tensor(cut, dtype=torch.int32,
                                                        device=cuda_device)
        cands = pipeline.mesh_candidates_reference(start[0], start[1], alive, ds, n_alive)
        hits = pipeline.mesh_sweep_reference(start[0], start[1], cands, ds)
        want = pipeline.bounce_step_mesh_reference(start, cands, hits, ds, 2, 1, settings,
                                                   n_alive)
        runs = []
        for _ in range(2):
            got = pool_copy(start)
            before = pipeline.bounce_step_mesh.launches
            pipeline.bounce_step_mesh(got, cands, hits, ds, 2, 1, settings, num_alive=n_alive)
            torch.cuda.synchronize()
            assert pipeline.bounce_step_mesh.launches == before + 1
            runs.append(got)
        got = runs[0]
        for a, b in zip(megakernel.pool_lanes(runs[0]), megakernel.pool_lanes(runs[1])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        still = alive == 0
        if cut is not None:
            still[cut:] = True
        for g, b in zip(megakernel.pool_lanes(got), megakernel.pool_lanes(start)):
            assert torch.equal(g[still].view(torch.int32), b[still].view(torch.int32))
        g9, w9 = megakernel.pool_lanes(got), megakernel.pool_lanes(want)
        assert torch.equal(g9[13], w9[13])
        assert_lane_rule(g9[:13], w9[:13])
        if share == 0.0:
            assert not got[4].any()


@pytest.mark.parametrize("E", [1, 2, 6, 8])
def test_merge_entries_slots_on_cuda(cuda_device, big_mesh, E):
    """D on mesh_big.txt at 64x64, depths 0-2, E = 1, 2, 6 and 8, A, B and
    C by the kernels from the plain chain's pool: the listed lanes' hits by
    the lane rule against the plain version and every other lane unchanged
    bit for bit, on the whole list and on a count that cuts it; a second
    launch on the same inputs equal to the first bit for bit. E = 9 is
    refused."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam = big_mesh
    settings = RenderSettings(trace_depth=8, antialias=True)
    (g,) = pipeline.sorted_geoms(ds)
    pool = _camera_pool(cam, 2, settings)
    launches = 0
    for depth in range(3):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds)
        n = int(cands.count[0])
        hits = pipeline.mesh_sweep_reference(o, d, cands, ds)
        sk = pipeline.super_keys(o, d, cands, hits, ds, g, E)
        eh = pipeline.window_sweep(pipeline.place_entries(sk, cands.count), sk, ds, g)
        for count in (n, n // 2 + 3):
            part = cands._replace(count=torch.tensor([count], dtype=torch.int32,
                                                     device=cuda_device))
            want = pipeline.merge_entries_reference(o, d, part, hits_copy(hits), sk, eh, ds, g)
            runs = []
            for _ in range(2):
                before = pipeline.merge_entries.launches
                runs.append(pipeline.merge_entries(o, d, part, hits_copy(hits), sk, eh, ds, g))
                torch.cuda.synchronize()
                assert pipeline.merge_entries.launches == before + 1
                launches += 1
            for a, b in zip(hit_lanes(runs[0]), hit_lanes(runs[1])):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            got = runs[0]
            listed = torch.zeros(hits.t.shape[0], dtype=torch.bool, device=cuda_device)
            listed[cands.lanes[:count].long()] = True
            assert_lane_rule([a[listed] for a in hit_lanes(got)],
                             [a[listed] for a in hit_lanes(want)])
            for a, b in zip(hit_lanes(got), hit_lanes(hits)):
                assert torch.equal(a[~listed].view(torch.uint8), b[~listed].view(torch.uint8))
            assert bool((got.t[listed] != hits.t[listed]).any())  # some lane merged
        plain = pipeline.merge_entries_reference(o, d, cands, hits_copy(hits), sk, eh, ds, g)
        pool = pipeline.bounce_step_mesh_reference(pool, cands, plain, ds, 2, depth, settings)
    assert launches == 12
    if E == 8:  # D holds no instantiation above PLACE_MAX_E
        wide = sk._replace(keys=torch.cat([sk.keys, sk.keys[:1]]))
        wide_eh = pipeline.EntryHits(*(torch.cat([a, a[:1]]) for a in eh))
        with pytest.raises(ValueError, match="E must be in"):
            pipeline.merge_entries(o, d, cands, hits_copy(hits), wide, wide_eh, ds, g)


# ---- the surface stage: the kernels instantiated on TexTables ----

# the scenes that need it, with settings that take their branches; their
# kernels run path_common.cuh's surface stage (file textures, bump maps,
# the lat-long env map, SSS)
SURFACE = [
    ("textured.txt", {"antialias": True}),
    ("envmap.txt", {}),
    ("cornell_sss.txt", {"russian_roulette": True, "rr_start_depth": 1}),
]


def assert_image_rule(got, want, frac=0.02):
    """tests/test_megakernel.py's image rule over Vec3 lanes (3% for the
    NEE kernels, as tests/test_nee_megakernel.py)."""
    for g, w in zip(got, want):
        diff = np.abs(g.cpu().numpy() - w.cpu().numpy())
        assert (diff > 1e-3).mean() < frac
        assert np.median(diff) < 1e-5


@pytest.mark.parametrize("name,settings_kw", SURFACE)
def test_surface_stage_whole_and_per_bounce_kernels_on_cuda(cuda_device, name,
                                                             settings_kw):
    """#1 against its plain version (the image rule) and bit for bit
    against #2 -> #3; #2 and three bounces of #3 against their plain
    versions (lanes), at 64x64."""
    ds, cam, settings = _setup(cuda_device, name, settings_kw)
    assert megakernel.kernel_flags(ds, settings) & megakernel.FLAG_SURFACE_STAGE
    accum = Vec3.zeros(64 * 64, cuda_device)
    megakernel.full_iteration(ds, cam, 3, settings, accum)
    torch.cuda.synchronize()
    assert_image_rule(accum, megakernel.full_iteration_reference(ds, cam, 3, settings))
    assert_bit_identical(accum, per_bounce_radiance(ds, cam, settings, 3))
    got = megakernel.first_bounce(ds, cam, 3, settings)
    torch.cuda.synchronize()
    assert_lanes_close(got, megakernel.first_bounce_reference(ds, cam, 3, settings))
    pool = megakernel.first_bounce_reference(ds, cam, 3, settings)
    for depth in (1, 2, 3):
        want = megakernel.bounce_step_reference(pool, ds, 3, depth, settings)
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        got = megakernel.bounce_step(start, ds, 3, depth, settings)
        torch.cuda.synchronize()
        assert_lanes_close(got, want)
        pool = want


@pytest.mark.parametrize("name,settings_kw", SURFACE + [("mesh_textured.txt", {})])
def test_surface_stage_shade_step_on_cuda(cuda_device, name, settings_kw):
    """#4 at depths 0 and 1 over the pool's Intersections: plain
    `intersect_scene` on the analytic scenes, #7 -> #8 -> #10 (with the
    quad's OBJ UVs) on mesh_textured, as the first-bounce cache fills."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam, settings = _setup(cuda_device, name, settings_kw)
    pool = _camera_pool(cam, 4, settings)
    for depth in (0, 1):
        if ds.mesh_geoms:
            isect = pipeline.intersect_pipeline(pool[0], pool[1], None, ds)
            assert isect.has_uv.any()
        else:
            isect = intersect_scene(pool[0], pool[1], ds)
        before = megakernel.shade_step.launches
        got = megakernel.shade_step(pool, isect, ds, 4, depth, settings)
        torch.cuda.synchronize()
        assert megakernel.shade_step.launches == before + 1
        want = megakernel.shade_step_reference(pool, isect, ds, 4, depth, settings)
        assert_lanes_close(got, want)
        pool = want


@pytest.mark.parametrize("name,settings_kw", [
    ("textured.txt", {"antialias": True}),
    ("cornell_sss.txt", {"russian_roulette": True, "rr_start_depth": 2}),
])
def test_surface_stage_nee_kernels_on_cuda(cuda_device, name, settings_kw):
    """#6 against its plain version over two iterations and #5 at depths
    0-2 and 3 (is_last), with the NEE rule: a bump-mapped, file-textured
    scene and a subsurface one (whose sphere takes no light sample)."""
    ds, cam, settings = _setup(cuda_device, name, dict(settings_kw, nee_mis=True))
    P = 64 * 64
    accum = Vec3.zeros(P, cuda_device)
    megakernel.full_iteration_nee(ds, cam, 5, settings, accum, n_iters=2)
    torch.cuda.synchronize()
    want = Vec3.zeros(P, cuda_device)
    for it in (5, 6):
        for a, w in zip(want, megakernel.full_iteration_nee_reference(ds, cam, it, settings)):
            a.add_(w)
    assert_image_rule(accum, want, frac=0.03)
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    pool = _camera_pool(cam, 2, settings)
    aux = (torch.zeros(P, device=cuda_device), torch.zeros(P, device=cuda_device))
    for depth, is_last in ((0, False), (1, False), (2, False), (3, True)):
        want, want_aux = megakernel.bounce_step_nee_reference(
            pool, aux, ds, 2, depth, settings, is_last)
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        got, got_aux = megakernel.bounce_step_nee(start, tuple(a.clone() for a in aux),
                                                  ds, 2, depth, settings, is_last)
        torch.cuda.synchronize()
        assert_nee_lanes_close(got, got_aux, want, want_aux)
        pool, aux = want, want_aux


@pytest.mark.parametrize("settings_kw", [{}, {"antialias": True, "compact": True}])
def test_surface_stage_mesh_bounce_on_cuda(cuda_device, settings_kw):
    """#9 on mesh_textured at depths 0-3 from the plain version's own
    candidates and mesh hits (the quad's OBJ UVs): the lane rule, pix
    exactly."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam, settings = _setup(cuda_device, "mesh_textured.txt", settings_kw)
    pool = _camera_pool(cam, 2, settings)
    uv_lanes = 0
    for depth in range(4):
        pool = _maybe_compact(pool, settings)
        n_alive = _count_alive(pool) if settings.compact else None
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pipeline.mesh_candidates_reference(o, d, alive, ds, n_alive)
        hits = pipeline.mesh_sweep_reference(o, d, cands, ds)
        uv_lanes += int((pipeline.merge_hits(cands, hits).has_uv & (alive != 0)).sum())
        want = pipeline.bounce_step_mesh_reference(pool, cands, hits, ds, 2, depth,
                                                   settings, n_alive)
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        got = pipeline.bounce_step_mesh(start, cands, hits, ds, 2, depth, settings,
                                        num_alive=n_alive)
        torch.cuda.synchronize()
        g, w = megakernel.pool_lanes(got), megakernel.pool_lanes(want)
        assert torch.equal(g[13], w[13])
        assert_lane_rule(g[:13], w[:13])
        pool = want
    assert uv_lanes > 0


@pytest.mark.parametrize("name,settings_kw", [
    ("textured.txt", {}), ("envmap.txt", {}), ("cornell_sss.txt", {}),
    ("textured.txt", {"nee_mis": True}), ("mesh_textured.txt", {}),
])
def test_surface_stage_renderer_on_cuda(cuda_device, name, settings_kw):
    """The Renderer through step_batch and step() on each surface scene
    at 64x48: finite, lit images; the kernels of the path launched."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    r = Renderer(small(name, (64, 48)), RenderSettings(trace_depth=8, **settings_kw),
                 device=cuda_device)
    wrappers = (megakernel.full_iteration, megakernel.full_iteration_nee,
                megakernel.first_bounce, megakernel.bounce_step_nee,
                pipeline.bounce_step_mesh)
    before = [f.launches for f in wrappers]
    r.step_batch(2)
    r.step()
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(wrappers, before)]
    if name == "mesh_textured.txt":
        assert got == [0, 0, 0, 0, 24]
    elif settings_kw:
        assert got == [0, 1, 0, 8, 0]
    else:
        assert got == [1, 0, 1, 0, 0]
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


# ---- kernels #5 and #6 on mesh scenes: the BVH walks for the hit and the
# shadow ray ----

MESH_NEE = [
    ("mesh.txt", {"antialias": True}),
    ("mesh.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("mesh_textured.txt", {"antialias": True}),  # the quad's OBJ UVs
    ("mesh_big.txt", {"antialias": True}),  # a geom of the big-mesh route
    ("two_meshes", {"antialias": True}),  # two mesh geoms: the walks' loop
]


def _mesh_nee_scene(tmp_path, name):
    """A scene of MESH_NEE at its file's resolution; "moving_mesh" is
    mesh.txt with the icosphere moving (VELOCITY 2 0 0)."""
    if name == "two_meshes":
        return two_meshes(tmp_path)
    scene = load_scene(os.path.join(SCENES, "mesh.txt" if name == "moving_mesh" else name))
    if name == "moving_mesh":
        scene.geoms.velocity[scene.geoms.gtype == GeomType.MESH] = (2.0, 0.0, 0.0)
    return scene


def _mesh_nee_setup(cuda_device, tmp_path, name, settings_kw):
    scene = _mesh_nee_scene(tmp_path, name)
    c = scene.state.camera
    scene.state.camera = derive_camera(
        (64, 64), c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance)
    settings = RenderSettings(trace_depth=8, nee_mis=True, **settings_kw)
    return (scene_to_device(scene, cuda_device),
            camera_to_device(scene.state.camera, cuda_device), settings)


@pytest.mark.parametrize("name,settings_kw", MESH_NEE)
def test_nee_kernels_on_mesh_match_plain_on_cuda(cuda_device, tmp_path, name,
                                                 settings_kw):
    """The mesh instantiations of #6 (two iterations in one call against
    two plain iterations summed in order, the NEE image rule) and of #5 (at
    depths 0-2 and 3 with is_last, each from the plain version's own pool:
    pix exactly, alive on at most 1% of lanes, the NEE lanes), at 64x64."""
    ds, cam, settings = _mesh_nee_setup(cuda_device, tmp_path, name, settings_kw)
    assert ds.mesh_geoms
    _nee_kernels_match_plain(cuda_device, ds, cam, settings)


def _nee_kernels_match_plain(cuda_device, ds, cam, settings):
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    P = 64 * 64
    accum = Vec3.zeros(P, cuda_device)
    before = megakernel.full_iteration_nee.launches
    megakernel.full_iteration_nee(ds, cam, 5, settings, accum, n_iters=2)
    torch.cuda.synchronize()
    assert megakernel.full_iteration_nee.launches == before + 1
    want = Vec3.zeros(P, cuda_device)
    for it in (5, 6):
        for a, w in zip(want, megakernel.full_iteration_nee_reference(ds, cam, it, settings)):
            a.add_(w)
    assert_image_rule(accum, want, frac=0.03)
    assert float(accum.x.max()) > 0
    pool = _camera_pool(cam, 2, settings)
    aux = (torch.zeros(P, device=cuda_device), torch.zeros(P, device=cuda_device))
    before = megakernel.bounce_step_nee.launches
    for depth, is_last in ((0, False), (1, False), (2, False), (3, True)):
        want, want_aux = megakernel.bounce_step_nee_reference(
            pool, aux, ds, 2, depth, settings, is_last)
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        got, got_aux = megakernel.bounce_step_nee(start, tuple(a.clone() for a in aux),
                                                  ds, 2, depth, settings, is_last)
        torch.cuda.synchronize()
        assert_nee_lanes_close(got, got_aux, want, want_aux)
        pool, aux = want, want_aux
    assert megakernel.bounce_step_nee.launches == before + 4


def test_deep_tree_renders_nee_on_cuda(cuda_device, tmp_path):
    """--nee on mesh.txt with its icosphere's BVH replaced by a chain over
    MESH_CHAIN_TRIS of its triangles (chip_smoke.chain_bvh: 909 binary
    nodes, wide depth past 64, deeper than a walk with its stack in a
    block's shared memory could take): the tables pack, and #6 and #5
    against their plain versions walking the same chain, by the rules of
    test_nee_kernels_on_mesh_match_plain_on_cuda."""
    from chip_smoke import MESH_CHAIN_TRIS, chain_bvh, wide_depth

    ds, cam, settings = _mesh_nee_setup(cuda_device, tmp_path, "mesh.txt",
                                        {"antialias": True})
    (g,) = ds.mesh_geoms
    ds = chain_bvh(ds, g, count=MESH_CHAIN_TRIS)
    assert wide_depth(ds) > 64
    _nee_kernels_match_plain(cuda_device, ds, cam, settings)


def test_nee_step_on_moving_mesh_matches_plain_on_cuda(cuda_device, tmp_path):
    """--nee --motion-blur on mesh.txt with the icosphere moving: #5's
    mesh instantiation on the tables as `_trace_paths` re-packs them at
    the iteration's shutter time (xf and inv only: the walks' object ray,
    bound and world distance) against its plain version on the moved
    geoms, at depths 0-2 and 3 with is_last (the lane rule above); then
    Renderer.step_batch launches #5 once per depth and nothing else."""
    from project3_cuda_path_tracer_tpu_torch.models.device import advance_time
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool, shutter_time

    settings_kw = {"antialias": True, "motion_blur": True}
    ds, cam, settings = _mesh_nee_setup(cuda_device, tmp_path, "moving_mesh", settings_kw)
    it = 3
    moved = advance_time(ds, shutter_time(it))
    (g,) = ds.mesh_geoms
    assert float(moved.transform[g][0, 3] - ds.transform[g][0, 3]) > 0.1
    xf, inv = megakernel.pack_geom_tables(moved)
    tables = megakernel.pack_scene_tables(ds, nee=True)._replace(xf=xf, inv=inv)
    P = 64 * 64
    pool = _camera_pool(cam, it, settings)
    aux = (torch.zeros(P, device=cuda_device), torch.zeros(P, device=cuda_device))
    before = megakernel.bounce_step_nee.launches
    for depth, is_last in ((0, False), (1, False), (2, False), (3, True)):
        want, want_aux = megakernel.bounce_step_nee_reference(
            pool, aux, moved, it, depth, settings, is_last)
        lanes = [a.clone() for a in megakernel.pool_lanes(pool)]
        start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                 Vec3(*lanes[9:12]), lanes[12], lanes[13])
        got, got_aux = megakernel.bounce_step_nee(start, tuple(a.clone() for a in aux),
                                                  moved, it, depth, settings, is_last,
                                                  tables=tables)
        torch.cuda.synchronize()
        assert_nee_lanes_close(got, got_aux, want, want_aux)
        pool, aux = want, want_aux
    assert megakernel.bounce_step_nee.launches == before + 4
    others = (megakernel.full_iteration_nee, pipeline.mesh_candidates,
              pipeline.mesh_sweep, pipeline.bounce_step_mesh)
    r = Renderer(_mesh_nee_scene(tmp_path, "moving_mesh"), settings, device=cuda_device)
    before = [f.launches for f in (megakernel.bounce_step_nee,) + others]
    r.step_batch(2)
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip((megakernel.bounce_step_nee,) + others, before)]
    assert got == [2 * settings.trace_depth] + [0] * len(others)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


def test_nee_route_bits_on_mesh_on_cuda(cuda_device, tmp_path):
    """#6 and the #5 route (Renderer.step()'s trace) on mesh.txt from the
    same camera rays: on the pixels whose camera ray the plain raygen
    gives with the kernels' bits the radiance may differ only where a
    float op of the two copies of the estimator rounds apart; held here
    to the NEE image rule, and bit for bit on at least 95% of pixels."""
    from project3_cuda_path_tracer_tpu_torch.render import _trace_nee

    ds, cam, settings = _mesh_nee_setup(cuda_device, tmp_path, "mesh.txt",
                                        {"antialias": True})
    acc = Vec3.zeros(64 * 64, cuda_device)
    megakernel.full_iteration_nee(ds, cam, 3, settings, acc)
    radiance = _trace_nee(ds, cam, 3, settings, None, False)[0]
    torch.cuda.synchronize()
    assert_image_rule(acc, radiance, frac=0.03)
    off = torch.zeros(64 * 64, dtype=torch.bool, device=cuda_device)
    for g, c in zip(acc, radiance):
        off |= g.view(torch.int32) != c.view(torch.int32)
    assert float(off.float().mean()) <= 0.05


@pytest.mark.parametrize("name", ["mesh.txt", "mesh_big.txt"])
def test_mesh_nee_launches(cuda_device, name):
    """--nee on a mesh scene: step_batch runs #6 once per run of up to
    ITERATIONS_PER_LAUNCH iterations, step() #5 once per depth, and no
    mesh pipeline kernel (#7-#10, A-D) runs."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    wrappers = (megakernel.bounce_step_nee, megakernel.full_iteration_nee)
    others = (megakernel.full_iteration, megakernel.first_bounce,
              megakernel.bounce_step, megakernel.shade_step,
              pipeline.mesh_candidates, pipeline.mesh_sweep,
              pipeline.bounce_step_mesh, pipeline.intersect_mesh,
              pipeline.super_keys, pipeline.place_entries, pipeline.window_sweep,
              pipeline.merge_entries)
    r = Renderer(small(name, (64, 48)),
                 RenderSettings(trace_depth=8, nee_mis=True, antialias=True),
                 device=cuda_device)
    before = [f.launches for f in wrappers + others]
    for _ in range(3):
        r.step()
    r.step_batch(3)
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(wrappers + others, before)]
    assert got == [24, 1] + [0] * len(others)
    assert int(r.last_alive_counts[-1]) == 0
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


@pytest.mark.parametrize("name", ["bunny.txt", "mesh_critter.txt", "mesh_stream.txt"])
def test_big_meshes_render_nee_on_cuda(cuda_device, name):
    """--nee on big-mesh scenes (every geom on the sorted route, which #8's
    tables give no root; the NEE tables root every geom's binary BVH;
    mesh_critter's tree the deepest of the scenes): #6 through step_batch
    and #5 through step() against the plain versions
    (RenderSettings.plain) by the NEE image rule, at 32x32."""
    scene = small(name, (32, 32))
    wrappers = (megakernel.full_iteration_nee, megakernel.bounce_step_nee)
    imgs = {}
    for plain in (False, True):
        r = Renderer(scene, RenderSettings(trace_depth=8, nee_mis=True, antialias=True,
                                           plain=plain), device=cuda_device)
        if not plain:
            roots = megakernel.pack_scene_tables(r.dev_scene, nee=True).roots
            assert roots.tolist() == [list(r.dev_scene.bvh_roots[g])
                                      for g in r.dev_scene.mesh_geoms]
        before = [w.launches for w in wrappers]
        r.step_batch(1)
        r.step()
        torch.cuda.synchronize()
        got = [w.launches - b for w, b in zip(wrappers, before)]
        assert got == ([0, 0] if plain else [1, 8])
        imgs[plain] = r.image()
    assert np.isfinite(imgs[False]).all() and imgs[False].max() > 0
    _image_rule(imgs[False], imgs[True], 0.03)


# ---- the material sort (--sort-materials): #7 -> [#8 -> A-D ->] #10, a
# radix_split digit pass, #4 over the sorted pool ----

def test_analytic_intersect_kernels_match_plain_on_cuda(cuda_device):
    """#7 -> #10 on scenes without mesh geoms (empty mesh tables, no
    candidate, #8 skipped) against plain `intersect_scene`, by the rule
    for hit distances (on 99% of lanes: t relative, the normal within
    1e-3, material and side exactly): Cornell, many_materials and env at 64x64 and 800x800, every lane
    and a third dead (dead lanes keep their analytic hit)."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    for name, res in (("cornell.txt", (64, 64)), ("many_materials.txt", (64, 64)),
                      ("env.txt", (64, 64)), ("cornell.txt", (800, 800))):
        ds, cam, settings = _setup(cuda_device, name, {"antialias": True}, res)
        pool = _camera_pool(cam, 2, settings)
        want = intersect_scene(pool[0], pool[1], ds)
        alive = (torch.arange(res[0] * res[1], device=cuda_device) % 3 != 0).to(torch.int32)
        for a in (None, alive):
            before = [pipeline.mesh_candidates.launches, pipeline.mesh_sweep.launches,
                      pipeline.intersect_mesh.launches]
            got = pipeline.intersect_pipeline(pool[0], pool[1], a, ds)
            torch.cuda.synchronize()
            assert [pipeline.mesh_candidates.launches, pipeline.mesh_sweep.launches,
                    pipeline.intersect_mesh.launches] == [before[0] + 1, before[1],
                                                          before[2] + 1]
            # tests/test_torch_ops.py's rule for hit distances on 99% of
            # lanes: t within 1e-5 + 1e-5 |t| (world distances reach ~30);
            # the normal within 1e-3 (a t an ulp-scale apart moves a
            # sphere hit's point, so its normal, by more than 1e-4 near
            # grazing); material and side exactly
            close = (got.t - want.t).abs() <= 1e-5 + 1e-5 * want.t.abs()
            assert float(close.float().mean()) >= 0.99
            assert_lane_rule(list(got.normal), list(want.normal), atol=1e-3)
            assert_lane_rule([got.material_id, got.outside], [want.material_id, want.outside],
                             atol=0.0)
            assert float(((got.t > 0) != (want.t > 0)).float().mean()) <= 0.001
            assert not got.has_uv.any() and not got.tex_u.any()
            assert torch.equal(got.material_id >= 0, got.t > 0)


@pytest.mark.parametrize("bits", [3, 6, 9])
@pytest.mark.parametrize("n", [64 * 64, 800 * 800, 1920 * 1080])
def test_material_permutation_is_stable_sort_on_cuda(cuda_device, bits, n):
    """`sort_permutation` (one radix_split digit pass per 8 key bits over
    the slot iota) equals a stable torch.sort's indices element for
    element, dead keys (all ones) on a third of the lanes, with no host
    sync."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    rng = np.random.default_rng(bits + n)
    dead = (1 << bits) - 1
    key = rng.integers(0, dead, n).astype(np.int32)
    key[rng.random(n) < 0.33] = dead
    key = torch.tensor(key, device=cuda_device)
    before = pipeline.radix_split.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        perm = pipeline.sort_permutation(key, bits)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert pipeline.radix_split.launches - before == len(pipeline.radix_passes(bits))
    assert torch.equal(perm.long(), torch.sort(key, stable=True).indices)


@pytest.mark.parametrize("name", ["cornell_glass.txt", "many_materials.txt"])
def test_shade_step_on_permuted_pool_on_cuda(cuda_device, name):
    """#4 on a permuted pool with its permuted Intersections is bit for
    bit the same permutation of #4 on the unpermuted pool (RNG keyed on
    pix), the sort's own permutation and a random one."""
    from project3_cuda_path_tracer_tpu_torch.render import (
        _camera_pool,
        _maybe_sort_by_material,
        _permute_isect,
        _permute_state,
        intersect_scene_any,
    )

    ds, cam, settings = _setup(cuda_device, name, {"russian_roulette": True,
                                                  "rr_start_depth": 0,
                                                  "antialias": True})
    sort = RenderSettings(trace_depth=8, russian_roulette=True, rr_start_depth=0,
                          antialias=True, sort_by_material=True)
    pool = megakernel.shade_step(_camera_pool(cam, 3, settings),
                                 intersect_scene_any(*_camera_pool(cam, 3, settings)[:2],
                                                     ds, settings), ds, 3, 0, settings)
    isect = intersect_scene_any(pool[0], pool[1], ds, settings, alive=pool[4])
    base = megakernel.shade_step(pool, isect, ds, 3, 1, settings)
    _, sorted_isect = _maybe_sort_by_material(pool, isect, ds, sort)
    key = torch.where((pool[4] != 0) & (isect.t > 0), isect.material_id, 2**31 - 1)
    for perm in (torch.sort(key, stable=True).indices,
                 torch.randperm(pool[5].shape[0], device=cuda_device)):
        got = megakernel.shade_step(_permute_state(pool, perm), _permute_isect(isect, perm),
                                    ds, 3, 1, settings)
        want = _permute_state(base, perm)
        torch.cuda.synchronize()
        for g, w in zip(megakernel.pool_lanes(got), megakernel.pool_lanes(want)):
            assert torch.equal(g, w)
    assert torch.equal(sorted_isect.material_id, isect.material_id[
        torch.sort(key, stable=True).indices])


@pytest.mark.parametrize("name,settings_kw,counts", [
    # (#7, #8, #10, #4, radix_split) over 2 step() + step_batch(2), depth 8
    ("cornell.txt", {"antialias": True}, [32, 0, 32, 32, 32]),
    ("cornell.txt", {"compact": True}, [32, 0, 32, 32, 32]),
    # the cache: depth 0 from it, filled by the first step() and once per batch
    ("cornell.txt", {"cache_first_bounce": True}, [30, 0, 30, 32, 32]),
    # direct lighting: 7 sorted bounces, then the final step's two intersects
    ("cornell.txt", {"direct_lighting": True}, [36, 0, 36, 28, 28]),
    ("many_materials.txt", {"russian_roulette": True}, [32, 0, 32, 32, 32]),
    ("mesh.txt", {"antialias": True}, [32, 32, 32, 32, 32]),
])
def test_sorted_path_launches_on_cuda(cuda_device, name, settings_kw, counts):
    """Under --sort-materials every depth is #7 [-> #8] -> #10, one
    radix_split digit pass and #4; no #1, #2, #3, #5, #6 or #9; a sorted
    bounce makes no host sync; the image is the unsorted path's by the
    image rule."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool, _sorted_bounce

    wrappers = (pipeline.mesh_candidates, pipeline.mesh_sweep, pipeline.intersect_mesh,
                megakernel.shade_step, pipeline.radix_split)
    others = (megakernel.full_iteration, megakernel.first_bounce,
              megakernel.bounce_step, megakernel.bounce_step_nee,
              megakernel.full_iteration_nee, pipeline.bounce_step_mesh)
    scene = small(name, (64, 48))
    imgs = []
    for sort in (True, False):
        r = Renderer(scene, RenderSettings(trace_depth=8, sort_by_material=sort,
                                           **settings_kw), device=cuda_device)
        before = [f.launches for f in wrappers + others]
        r.step()
        r.step()
        r.step_batch(2)
        torch.cuda.synchronize()
        if sort:
            got = [f.launches - b for f, b in zip(wrappers + others, before)]
            assert got == counts + [0] * len(others)
            pool = _camera_pool(r.dev_camera, 5, r.settings)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _sorted_bounce(pool, r.dev_scene, 5, 0, r.settings, tables=r.tables)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        imgs.append(r.image())
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0
    assert_image_rule([torch.tensor(imgs[0][..., c]) for c in range(3)],
                      [torch.tensor(imgs[1][..., c]) for c in range(3)])


def test_sorted_big_mesh_launches_on_cuda(cuda_device):
    """mesh_big under --sort-materials through both big-mesh routes: per
    depth #7 -> #8 -> A -> B -> C -> D (or A -> the radix route -> D) ->
    #10, the material digit pass and #4; the route's splits and the
    material sort's each with their own scratch."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    keys = ("mesh_candidates", "mesh_sweep", "super_keys", "place_entries",
            "window_sweep", "merge_entries", "intersect_mesh", "radix_split",
            "radix_unscatter", "window_sweep_stream", "bounce_step_mesh")
    r = Renderer(small("mesh_big.txt", (64, 48)),
                 RenderSettings(trace_depth=8, antialias=True, sort_by_material=True),
                 device=cuda_device)
    for radix in (False, True):
        r.set_camera(r.camera)
        flag, pipeline.SORT_RADIX = pipeline.SORT_RADIX, radix
        try:
            before = {k: getattr(pipeline, k).launches for k in keys}
            before["shade_step"] = megakernel.shade_step.launches
            r.step()
            r.step_batch(1)
            torch.cuda.synchronize()
        finally:
            pipeline.SORT_RADIX = flag
        got = {k: getattr(pipeline, k).launches - before[k] for k in keys}
        got["shade_step"] = megakernel.shade_step.launches - before["shade_step"]
        (g,) = pipeline.sorted_geoms(r.dev_scene)
        passes = len(pipeline.radix_passes(pipeline.radix_key_bits(
            2 * r.dev_scene.super_ranges[g][1])))
        route = ({"radix_split": 16 * (2 + passes), "radix_unscatter": 16,
                  "window_sweep_stream": 16, "place_entries": 0, "window_sweep": 0}
                 if radix else {"radix_split": 16, "radix_unscatter": 0,
                                "window_sweep_stream": 0, "place_entries": 16,
                                "window_sweep": 16})
        assert got == dict(mesh_candidates=16, mesh_sweep=16, super_keys=16,
                           merge_entries=16, intersect_mesh=16, bounce_step_mesh=0,
                           shade_step=16, **route), (radix, got)
        img = r.image()
        assert np.isfinite(img).all() and img.max() > 0


# ---- sharding (parallel/shard.py): the shards co-located on one card ----

SHARD_KERNELS = ("mesh_candidates", "mesh_sweep", "super_keys", "place_entries",
                 "window_sweep", "merge_entries", "intersect_mesh", "bounce_step_mesh",
                 "radix_split", "radix_unscatter", "window_sweep_stream")
FUSED = ("full_iteration", "first_bounce", "bounce_step", "shade_step",
         "full_iteration_nee", "bounce_step_nee")


def shard_launches():
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    got = {k: getattr(pipeline, k).launches for k in SHARD_KERNELS}
    got.update({k: getattr(megakernel, k).launches for k in FUSED})
    return got


def launches_since(before):
    return {k: v - before[k] for k, v in shard_launches().items() if v != before[k]}


def test_sharded_spp_px_on_cuda(cuda_device):
    """spp=2 and px=2 with both shards on one card (Cornell 64x64 d8 AA):
    spp runs #2 -> #3 per shard and equals Renderer.step() at the same
    samples (rtol 1e-6: only the sum rounds otherwise); px runs the
    slice's camera rays and #3 from depth 0, exactly the whole frame traced
    the same way, and within the image rule of step() (#2 computes its
    own camera rays)."""
    from project3_cuda_path_tracer_tpu_torch.parallel.shard import ShardedRenderer
    from project3_cuda_path_tracer_tpu_torch.render import trace_paths

    scene = small("cornell.txt", (64, 64))
    settings = RenderSettings(trace_depth=8, antialias=True)
    r = Renderer(scene, settings, device=cuda_device)
    r.step()
    r.step()
    want = r.image()
    devs = [cuda_device] * 2
    sr = ShardedRenderer(scene, settings, spp=2, devices=devs)
    before = shard_launches()
    sr.step_batch(2)
    torch.cuda.synchronize()
    assert launches_since(before) == {"first_bounce": 2, "bounce_step": 14}
    np.testing.assert_allclose(sr.image(), want, rtol=1e-6, atol=1e-6)
    px = ShardedRenderer(scene, settings, px=2, devices=devs)
    before = shard_launches()
    px.step_batch(2)
    torch.cuda.synchronize()
    assert launches_since(before) == {"bounce_step": 2 * 2 * 8}
    P = 64 * 64
    whole = Vec3.zeros(P, cuda_device)
    for it in (1, 2):
        rad, pix, _, _ = trace_paths(r.dev_scene, r.dev_camera, it, None, settings, False,
                                     tables=r.tables,
                                     pix=torch.arange(P, dtype=torch.int32, device=cuda_device))
        for a, c in zip(whole, rad):
            a.add_(c)
    got = px.image()
    np.testing.assert_array_equal(
        got, np.stack([c.cpu().numpy().reshape(64, 64) for c in whole], -1))
    assert_image_rule([torch.tensor(got[..., c]) for c in range(3)],
                      [torch.tensor(want[..., c]) for c in range(3)])


@pytest.mark.parametrize("name,settings_kw", [
    ("mesh.txt", {"antialias": True}),
    ("mesh_textured.txt", {"antialias": True}),
    ("mesh.txt", {"antialias": True, "sort_by_material": True, "compact": True}),
    ("mesh.txt", {"direct_lighting": True}),
])
def test_tri_shards_on_cuda(cuda_device, name, settings_kw):
    """tri=2 with both shards on one card (64x48 d8): at every depth of one
    iteration driven by the kernels, each shard's #7 -> #8 -> #10 and one #4
    and nothing else; the merged hits against the plain merge of the plain
    per-slice chains and against the unsharded kernels (lane rule); #4 on
    the merged pool against its plain version (lane rule, pix exactly);
    through step_batch the launches of the tier and the image within the
    image rule of the unsharded Renderer."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.parallel.shard import ShardedRenderer
    from project3_cuda_path_tracer_tpu_torch.render import (
        _camera_pool,
        intersect_scene_any,
        merge_isect_shards,
    )

    scene = small(name, (64, 48))
    settings = RenderSettings(trace_depth=8, **settings_kw)
    sr = ShardedRenderer(scene, settings, tri=2, devices=[cuda_device] * 2)
    r = Renderer(scene, settings, device=cuda_device)
    group = sr.groups[0][0]
    ds0, tables0 = group[0]
    pool = _camera_pool(r.dev_camera, 2, settings)
    for depth in range(8):
        before = shard_launches()
        got = intersect_scene_any(pool[0], pool[1], None, sr.settings, alive=pool[4],
                                  shards=group)
        out = megakernel.shade_step(pool, got, ds0, 2, depth, sr.settings, tables=tables0)
        torch.cuda.synchronize()
        assert launches_since(before) == {"mesh_candidates": 2, "mesh_sweep": 2,
                                          "intersect_mesh": 2, "shade_step": 1}
        plain = merge_isect_shards([pipeline.intersect_pipeline_reference(
            pool[0], pool[1], pool[4], sh.scene) for sh in group])
        whole = intersect_scene_any(pool[0], pool[1], r.dev_scene, settings,
                                    alive=pool[4], tables=r.tables)
        assert_lane_rule(hit_lanes(got), hit_lanes(plain))
        assert_lane_rule(hit_lanes(got), hit_lanes(whole))
        want = megakernel.shade_step_reference(pool, got, ds0, 2, depth, sr.settings)
        assert torch.equal(out[5], want[5])
        assert_lane_rule(megakernel.pool_lanes(out)[:13], megakernel.pool_lanes(want)[:13])
        pool = out
    before = shard_launches()
    sr.step_batch(2)
    torch.cuda.synchronize()
    got_l = launches_since(before)
    assert set(got_l) <= {"mesh_candidates", "mesh_sweep", "intersect_mesh", "shade_step",
                          "radix_split"}, got_l
    assert got_l["shade_step"] == 2 * (7 if settings.direct_lighting else 8)
    r.step_batch(2)
    assert_image_rule([torch.tensor(sr.image()[..., c]) for c in range(3)],
                      [torch.tensor(r.image()[..., c]) for c in range(3)])


def test_tri_shards_big_mesh_on_cuda(cuda_device, big_mesh):
    """mesh_big under tri=2 on one card: each slice of 25,600 triangles
    keeps the sorted route (A-D after #8) at every depth; the merged hits
    against the plain merge of the plain per-slice chains (lane rule)."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.parallel.shard import ShardedRenderer
    from project3_cuda_path_tracer_tpu_torch.render import (
        _camera_pool,
        intersect_scene_any,
        merge_isect_shards,
    )

    scene = small("mesh_big.txt", (64, 64))
    settings = RenderSettings(trace_depth=8, antialias=True)
    sr = ShardedRenderer(scene, settings, tri=2, devices=[cuda_device] * 2)
    group = sr.groups[0][0]
    assert all(len(pipeline.sorted_geoms(sh.scene)) == 1 for sh in group)
    ds, cam = big_mesh
    pool = _camera_pool(cam, 2, settings)
    for depth in range(3):
        before = shard_launches()
        got = intersect_scene_any(pool[0], pool[1], None, sr.settings, alive=pool[4],
                                  shards=group)
        torch.cuda.synchronize()
        assert launches_since(before) == dict.fromkeys(
            ("mesh_candidates", "mesh_sweep", "super_keys", "place_entries",
             "window_sweep", "merge_entries", "intersect_mesh"), 2)
        plain = merge_isect_shards([pipeline.intersect_pipeline_reference(
            pool[0], pool[1], pool[4], sh.scene) for sh in group])
        assert_lane_rule(hit_lanes(got), hit_lanes(plain))
        pool = megakernel.shade_step(pool, got, group[0].scene, 2, depth, sr.settings,
                                     tables=group[0].tables)


# ---- the last modules: --no-pallas, --debug, --debug-nans, the loaders'
# remainder, the viewer (ROADMAP §1 modules 5 and 1) ----

def _all_wrappers():
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    return [getattr(megakernel, n) for n in (
        "full_iteration", "first_bounce", "bounce_step", "shade_step", "bounce_step_nee",
        "full_iteration_nee")] + [getattr(pipeline, n) for n in (
        "mesh_candidates", "mesh_sweep", "bounce_step_mesh", "intersect_mesh", "super_keys",
        "place_entries", "window_sweep", "merge_entries", "radix_split", "radix_unscatter",
        "window_sweep_stream")]


def _launch_total():
    return sum(w.launches for w in _all_wrappers())


def _image_rule(got, want, frac=0.02):
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < frac, (diff > 1e-3).mean()
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("name,settings_kw", [
    ("cornell.txt", {}), ("mesh.txt", {}), ("textured.txt", {}), ("cornell.txt", {"nee_mis": True}),
])
def test_no_pallas_on_cuda(cuda_device, name, settings_kw, caplog):
    """--no-pallas (RenderSettings.plain): the plain versions render on the
    card, no launch counted, and the log says so; the kernels' image by
    the image rule; without it the kernels launch."""
    import logging

    scene = small(name, (64, 64))
    imgs, counts = {}, {}
    caplog.set_level(logging.INFO)
    for plain in (False, True):
        caplog.clear()
        r = Renderer(scene, RenderSettings(trace_depth=8, plain=plain, **settings_kw),
                     device=cuda_device)
        before = _launch_total()
        r.step_batch(2)
        r.step()
        counts[plain] = _launch_total() - before
        imgs[plain] = r.image()
        assert ("no kernel is launched" in caplog.text) == plain
    assert counts[True] == 0 and counts[False] > 0
    _image_rule(imgs[True], imgs[False], 0.03 if settings_kw.get("nee_mis") else 0.02)


@pytest.mark.parametrize("name,settings_kw,radix", [
    ("cornell.txt", {"antialias": True}, False), ("cornell.txt", {"nee_mis": True}, False),
    ("mesh.txt", {"cache_first_bounce": True}, False), ("mesh_big.txt", {}, False),
    ("mesh_big.txt", {}, True), ("cornell.txt", {"sort_by_material": True}, False),
])
def test_debug_checks_clean_on_cuda(cuda_device, name, settings_kw, radix):
    """--debug and --debug-nans on the kernels: the bounds sweep, every
    launch checked and every stage's output scanned, all clean."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline
    from project3_cuda_path_tracer_tpu_torch.utils import debug

    r = Renderer(small(name, (32, 32)), RenderSettings(trace_depth=8, **settings_kw),
                 device=cuda_device)
    flag = pipeline.SORT_RADIX
    pipeline.SORT_RADIX = radix
    try:
        before = _launch_total()
        with debug.checks(launches=True, nans=True):
            debug.bounds_sweep(r)
            r.step_batch(2)
            r.step()
        assert _launch_total() > before
    finally:
        pipeline.SORT_RADIX = flag
    assert np.isfinite(r.image()).all()


def test_debug_launch_check_after_every_launch(cuda_device, monkeypatch):
    """--debug's per-launch check sits in `_launch`: one call per launch,
    naming its kernel; none with the flags off."""
    from project3_cuda_path_tracer_tpu_torch.utils import debug

    seen = []
    monkeypatch.setattr(debug, "check_launch", lambda what, name: seen.append(what))
    r = Renderer(small("cornell.txt", (32, 32)), RenderSettings(trace_depth=4),
                 device=cuda_device)
    r.step()
    assert seen == []
    with debug.checks(launches=True):
        r.step()
    assert seen == ["first_bounce", "bounce_step", "bounce_step", "bounce_step"]


@pytest.mark.parametrize("route,stage", [("step", "first_bounce"),
                                         ("step_batch", "full_iteration")])
def test_debug_nans_names_kernel_on_cuda(cuda_device, route, stage):
    from project3_cuda_path_tracer_tpu_torch.render import _device_tables
    from project3_cuda_path_tracer_tpu_torch.utils import debug

    r = Renderer(small("cornell.txt", (32, 32)), RenderSettings(trace_depth=4),
                 device=cuda_device)
    r.dev_scene.mat_color.x[1] = float("nan")
    r.tables = _device_tables(r.dev_scene, r.settings)
    with debug.checks(nans=True), pytest.raises(FloatingPointError) as e:
        r.step() if route == "step" else r.step_batch(1)
    assert f"stage {stage} (kernel)" in str(e.value)
    assert "aten." in str(e.value)


@pytest.mark.parametrize("name", ["textured.txt", "envmap.txt"])
def test_loaders_on_cuda(cuda_device, tmp_path, name):
    """A texture resampled from 300x200 and a .hdr env map (300x150)
    through #1 on TexTables against its plain version."""
    from chip_smoke import loader_scenes

    path = loader_scenes(str(tmp_path))[name]
    scene = load_scene(path)
    c = scene.state.camera
    scene.state.camera = derive_camera((64, 64), c.position, c.look_at,
                                       np.array([0, 1, 0], np.float32), float(c.fov[1]),
                                       c.aperture, c.focal_distance)
    imgs = {}
    for plain in (False, True):
        r = Renderer(scene, RenderSettings(trace_depth=8, plain=plain), device=cuda_device)
        before = megakernel.full_iteration.launches
        r.step_batch(2)
        assert megakernel.full_iteration.launches - before == (0 if plain else 1)
        imgs[plain] = r.image()
    _image_rule(imgs[False], imgs[True])


def test_viewer_frames_on_cuda(cuda_device):
    from project3_cuda_path_tracer_tpu_torch import viewer

    r = Renderer(small("cornell.txt", (64, 64)), RenderSettings(trace_depth=8),
                 device=cuda_device)
    before = megakernel.full_iteration.launches
    frames = [viewer.next_frame(r, 2) for _ in range(3)]
    assert r.iteration == 6 and megakernel.full_iteration.launches - before == 3
    assert all(f.shape == (64, 64, 3) and f.dtype == np.uint8 for f in frames)


@pytest.mark.parametrize("flags,says", [(["--debug"], "bounds sweep clean"),
                                        (["--debug-nans"], "checked for NaN"),
                                        (["--no-pallas"], "no kernel is launched")])
def test_cli_last_flags_on_cuda(cuda_device, tmp_path, flags, says):
    import subprocess
    import sys

    repo = os.path.dirname(SCENES)
    scene = tmp_path / "cornell64.txt"
    scene.write_text(open(os.path.join(SCENES, "cornell.txt")).read()
                     .replace("RES         800 800", "RES         64 64"))
    proc = subprocess.run(
        [sys.executable, "-m", "project3_cuda_path_tracer_tpu_torch", str(scene),
         "--iterations", "4", "--out-dir", str(tmp_path), *flags],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert says in proc.stderr
    assert len(list(tmp_path.glob("cornell.*.4samp.png"))) == 1
