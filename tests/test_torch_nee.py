"""The port's light-sampling estimators against the JAX package's XLA
path (`use_pallas=False`), from the same scene tables at 32x32:
`_nee_mis_bounce` on one bounce (the lane rule of tests/test_megakernel.py
and the MIS aux on lanes alive after the bounce), `trace_paths` under
--nee and under --direct-lighting (the image rule of
tests/test_nee_megakernel.py: median under 1e-5, under 3% of values off
by more than 1e-3), and the JAX package's ValueErrors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu import render as jrender
from project3_cuda_path_tracer_tpu.ops.vec import Vec3 as JVec3
from project3_cuda_path_tracer_tpu_torch import render as trender
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.test_torch_ops import assert_state_close, both_cameras, both_scenes
from tests.test_torch_render import GOLDENS, small
from tests.test_torch_wavefront import pixel_image

RES = (32, 32)
P = RES[0] * RES[1]


def assert_nee_image_close(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert np.median(diff) < 1e-5
    assert (diff > 1e-3).mean() < 0.03, (diff > 1e-3).mean()


def to_jax(state, aux):
    vec = lambda v: JVec3(*(jnp.asarray(c.numpy()) for c in v))
    st = (vec(state[0]), vec(state[1]), vec(state[2]), vec(state[3]),
          jnp.asarray(state[4].numpy()), jnp.asarray(state[5].numpy()))
    return st, (jnp.asarray(aux[0].numpy()), jnp.asarray(aux[1].numpy()))


def settings_pair(depth, **kw):
    return (trender.RenderSettings(trace_depth=depth, **kw),
            jrender.RenderSettings(trace_depth=depth, use_bvh=False,
                                   use_pallas=False, **kw))


def camera_state(tc, it, tset):
    origins, dirs, pix = generate_rays(tc, it, tset.antialias,
                                       tset.depth_of_field)
    state = (origins, dirs, TVec3.ones(P, "cpu"), TVec3.zeros(P, "cpu"),
             torch.ones(P, dtype=torch.bool), pix)
    return state, (torch.zeros(P), torch.zeros(P, dtype=torch.bool))


def assert_aux_close(got_state, got_aux, want_state, want_aux):
    """The MIS aux, on lanes alive after the bounce in both: no later
    step reads the others."""
    both_alive = got_state[4].numpy() & np.asarray(want_state[4])
    pdf_bad = np.abs(got_aux[0].numpy() - np.asarray(want_aux[0])) > 1e-4
    nd_bad = got_aux[1].numpy() != np.asarray(want_aux[1])
    if not both_alive.any():  # after is_last: zeros everywhere, in both
        assert not pdf_bad.any() and not nd_bad.any()
        return
    assert pdf_bad[both_alive].mean() <= 0.01
    assert nd_bad[both_alive].mean() <= 0.01


@pytest.mark.parametrize("name,glossy,depth,is_last", [
    ("cornell.txt", False, 0, False),
    ("cornell.txt", False, 1, False),
    ("cornell.txt", False, 1, True),
    ("cornell.txt", True, 1, False),
    ("many_materials.txt", False, 1, False),
])
def test_nee_mis_bounce_matches_jax(name, glossy, depth, is_last):
    """One bounce from the same state: at depth 0 the camera rays with the
    aux at zeros; at depth 1 the port's own depth-0 output, whose aux is
    no longer zero."""
    jd, td = both_scenes(name, glossy_mat=4 if glossy else None)
    _, tc = both_cameras(name)
    kw = {"antialias": True, "russian_roulette": name == "many_materials.txt"}
    tset, jset = settings_pair(4, **kw)
    it = 3
    state, aux = camera_state(tc, it, tset)
    if depth == 1:
        state, aux = trender._nee_mis_bounce(state, aux, td, it, 0, tset, False)
        assert aux[1].any()  # diffuse vertices: MIS-weighted next hits
    jstate, jaux = to_jax(state, aux)
    want, want_aux = jrender._nee_mis_bounce(jstate, jaux, jd, jnp.int32(it),
                                             depth, jset, is_last)
    got, got_aux = trender._nee_mis_bounce(state, aux, td, it, depth, tset,
                                           is_last)
    assert_state_close(got, want)
    assert_aux_close(got, got_aux, want, want_aux)
    if is_last:
        assert not got[4].any() and not got_aux[1].any()
        assert float(got_aux[0].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["cornell.txt", "many_materials.txt"])
def test_nee_mis_bounce_probe(name):
    """The probe changes nothing, and its masks nest as the kernels
    branch: shadow rays come from NEE-able lanes, which are live
    non-emissive hits, and a light term reaches only an unoccluded
    shadow lane."""
    _, td = both_scenes(name)
    _, tc = both_cameras(name)
    tset = trender.RenderSettings(trace_depth=4, antialias=True)
    state, aux = camera_state(tc, 3, tset)
    want = trender._nee_mis_bounce(state, aux, td, 3, 0, tset, False)
    probe = {}
    got = trender._nee_mis_bounce(state, aux, td, 3, 0, tset, False,
                                  probe=probe)
    flat = lambda s: [c for v in s[0] + s[1]
                      for c in (v if isinstance(v, TVec3) else (v,))]
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g, w)
    live, lit = probe["live_hit"], probe["lit"]
    nee_able, shadow, visible = probe["nee_able"], probe["shadow"], probe["visible"]
    assert not (nee_able & ~(live & ~lit)).any()
    assert not (shadow & ~nee_able).any()
    assert (shadow & visible).any() and (nee_able & ~shadow).any()
    lit_by_light = live & ~lit & (got[0][3].max_component() > 0)
    assert not (lit_by_light & ~(shadow & visible)).any()
    assert torch.isfinite(probe["r"][shadow]).all()


def jax_trace(jd, jc, it, jset):
    with jax.disable_jit():  # op by op: no whole-program compile
        return jrender.trace_paths(jd, jc, jnp.int32(it),
                                   jrender._empty_cache(P), jset, False)


TRACE = [  # (scene, glossy sphere, depth, settings)
    ("cornell.txt", False, 4, {"nee_mis": True, "antialias": True}),
    ("cornell.txt", False, 5, {"nee_mis": True, "russian_roulette": True,
                               "rr_start_depth": 2, "stratified": True}),
    ("cornell.txt", False, 1, {"nee_mis": True}),
    ("cornell.txt", True, 4, {"nee_mis": True, "antialias": True}),
    ("cornell.txt", False, 3, {"direct_lighting": True}),
    ("cornell.txt", False, 3, {"direct_lighting": True, "compact": True}),
]


@pytest.mark.parametrize("name,glossy,depth,kw", TRACE)
def test_trace_paths_matches_jax_xla(name, glossy, depth, kw):
    jd, td = both_scenes(name, glossy_mat=4 if glossy else None)
    jc, tc = both_cameras(name)
    tset, jset = settings_pair(depth, **kw)
    it = 2
    jrad, jpix, _, jcounts = jax_trace(jd, jc, it, jset)
    trad, tpix, _, tcounts = trender.trace_paths(td, tc, it, None, tset, False)
    assert sorted(tpix.tolist()) == list(range(P))
    assert_nee_image_close(pixel_image(trad, tpix), pixel_image(jrad, jpix))
    assert tcounts.dtype == torch.int32 and tcounts.shape == (depth,)
    assert int(tcounts[-1]) == 0  # both estimators end every lane
    assert np.abs(tcounts.numpy() - np.asarray(jcounts)).max() <= 0.02 * P


@pytest.mark.parametrize("name,kw,key", [
    ("cornell.txt", {"nee_mis": True}, "cornell.txt_--nee"),
    ("many_materials.txt", {"nee_mis": True, "russian_roulette": True},
     "many_materials.txt_--nee"),
])
def test_nee_smoke_configs_match_goldens(name, kw, key):
    """tools/smoke_pallas.py's two analytic --nee configs against the XLA
    path's 128x128, 2-iteration goldens (at most 4% of clipped pixels off
    by more than 0.05), through step_batch (#6's plain version)."""
    goldens = np.load(GOLDENS)
    scene = small(tscene, name, (128, 128))
    settings = trender.RenderSettings(
        trace_depth=min(scene.state.trace_depth or 8, 8), **kw
    )
    r = trender.Renderer(scene, settings, device="cpu")
    r.step_batch(2)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0
    diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[key].astype(np.float32))
    assert (diff > 0.05).mean() <= 0.04


@pytest.mark.parametrize("name,kw,match", [
    ("env.txt", {"nee_mis": True}, "area light"),
    ("env.txt", {"direct_lighting": True}, "area light"),
    ("cornell.txt", {"nee_mis": True, "compact": True}, "nee_mis"),
    ("cornell.txt", {"nee_mis": True, "cache_first_bounce": True}, "nee_mis"),
])
def test_lighting_value_errors(name, kw, match):
    """The JAX package's refusals, from trace_paths and from the batch
    path; the same settings raise there too."""
    jd, td = both_scenes(name)
    jc, tc = both_cameras(name)
    tset, jset = settings_pair(3, **kw)
    with pytest.raises(ValueError, match=match):
        jax_trace(jd, jc, 1, jset)
    with pytest.raises(ValueError, match=match):
        trender.trace_paths(td, tc, 1, None, tset, False)
    with pytest.raises(ValueError, match=match):
        trender.render_batch(td, tc, TVec3.zeros(P, "cpu"), 1, 1, tset)
