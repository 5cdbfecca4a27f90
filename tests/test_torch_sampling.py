"""The port's depth-0 QMC samplers, procedural checker, new scene tables
and motion-blur transform update against the JAX package's, on the same
inputs: the samplers bit for bit, the rest exactly or to float ulps."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project3_cuda_path_tracer_tpu.models import device as jdevice
from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.ops import rng as jrng
from project3_cuda_path_tracer_tpu.ops import texture as jtexture
from project3_cuda_path_tracer_tpu_torch.models import device as tdevice
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.ops import megakernel as tmk
from project3_cuda_path_tracer_tpu_torch.ops import rng as trng
from project3_cuda_path_tracer_tpu_torch.ops import texture as ttexture
from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3 as TVec3
from tests.conftest import SCENES


def _pixel_ids():
    """A grid of pixel ids: the first 800x800 row block and ids near
    2^31 and 2^32 (uint32 wrap-around in the hashes)."""
    return np.concatenate([
        np.arange(0, 2048), np.arange(2**31 - 64, 2**31 + 64),
        np.arange(2**32 - 16, 2**32),
    ]).astype(np.uint32)


@pytest.mark.parametrize("sampler", ["stratified_pair", "sobol_pair"])
@pytest.mark.parametrize("depth", [0, 3])
def test_qmc_pairs_bit_exact(sampler, depth):
    """Iterations 1..64 (and two large ones) over the pixel-id grid:
    both floats of the pair equal the JAX package's bit for bit."""
    idx = _pixel_ids()
    t_idx = torch.tensor(idx.astype(np.int64))
    j_idx = jnp.asarray(idx)
    jfn = getattr(jrng, sampler)
    tfn = getattr(trng, sampler)
    for it in list(range(1, 65)) + [5000, 2**31 + 7]:
        want = jfn(jnp.uint32(it), j_idx, depth)
        got = tfn(it, t_idx, depth)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert 0.0 <= float(g.min()) and float(g.max()) < 1.0


def test_rng_constants_match():
    assert trng._SOBOL_V2 == tuple(int(v) for v in jrng._SOBOL_V2)
    from project3_cuda_path_tracer_tpu import render as jrender

    assert trng.TIME_STREAM == jrender.TIME_STREAM
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x = x.astype(np.uint32)
    np.testing.assert_array_equal(
        trng._reverse_bits_u32(torch.tensor(x.astype(np.int64))).numpy(),
        np.asarray(jrng._reverse_bits_u32(jnp.asarray(x))).astype(np.int64),
    )


def test_checker_matches_jax():
    r = np.random.default_rng(5)
    p = r.uniform(-12.0, 12.0, (8192, 3)).astype(np.float32)
    scale = r.choice([0.5, 0.8, 1.0, 2.5], 8192).astype(np.float32)
    want = jtexture.checker(
        jtexture.Vec3(*(jnp.asarray(p[:, c]) for c in range(3))),
        jnp.asarray(scale),
    )
    got = ttexture.checker(
        TVec3(*(torch.tensor(p[:, c]) for c in range(3))), torch.tensor(scale)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _both(path):
    js = jscene.load_scene(path)
    ts = tscene.load_scene(path)
    return (jdevice.scene_to_device(js, use_bvh=False),
            tdevice.scene_to_device(ts, "cpu"))


@pytest.mark.parametrize("name", ["checker.txt", "cornell.txt"])
def test_new_device_fields_carry_across(name):
    """geom_velocity, mat_tex_kind, mat_tex_scale and n_file_textures:
    the port's own parse equals the JAX package's tables, and
    device_scene_from_numpy carries them across."""
    jd, td = _both(os.path.join(SCENES, name))
    for f in ("geom_velocity", "mat_tex_kind", "mat_tex_scale"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    assert td.mat_tex_kind.dtype == torch.int32
    assert td.n_file_textures == jd.n_file_textures == 0
    fields = {n: np.asarray(getattr(jd, n)) for n in tdevice.ARRAY_FIELDS}
    for n in tdevice.VEC3_FIELDS:
        fields[n] = np.stack([np.asarray(c) for c in getattr(jd, n)], -1)
    meta = {n: getattr(jd, n) for n in tdevice.META_FIELDS}
    across = tdevice.device_scene_from_numpy(fields, meta, "cpu")
    for f in ("geom_velocity", "mat_tex_kind", "mat_tex_scale"):
        np.testing.assert_array_equal(getattr(across, f).numpy(),
                                      getattr(td, f).numpy(), err_msg=f)
    assert across.n_file_textures == 0
    assert tmk.checker_only(across) == (name == "checker.txt")
    # the packed material table carries tex_kind and tex_scale in
    # columns 11 and 12
    mat = tmk.pack_scene_tables(across).mat
    assert mat.shape[1] == tmk.MAT_COLS == 13
    np.testing.assert_array_equal(mat[:, 11].numpy(),
                                  fields["mat_tex_kind"].astype(np.float32))
    np.testing.assert_array_equal(mat[:, 12].numpy(), fields["mat_tex_scale"])


@pytest.mark.parametrize("t", [0.0, 0.37, 0.999])
def test_advance_time_matches_jax(tmp_path, t):
    """The moving-sphere scene: both packages translate the transform and
    its inverse by the same velocity * t."""
    text = open(os.path.join(SCENES, "sphere.txt")).read().replace(
        "SCALE       3 3 3", "SCALE       3 3 3\nROTAT       0 30 10\n"
        "VELOCITY    6 0.5 -1"
    )
    path = tmp_path / "moving.txt"
    path.write_text(text)
    jd, td = _both(str(path))
    assert np.abs(td.geom_velocity.numpy()).max() > 0
    tf = float(np.float32(t))
    ja = jdevice.advance_time(jd, jnp.float32(tf))
    ta = tdevice.advance_time(td, tf)
    np.testing.assert_array_equal(ta.transform.numpy(), np.asarray(ja.transform))
    np.testing.assert_allclose(ta.inverse_transform.numpy(),
                               np.asarray(ja.inverse_transform),
                               rtol=0, atol=1e-6)
    # the input scene is untouched and invTranspose does not move
    np.testing.assert_array_equal(td.transform.numpy(), np.asarray(jd.transform))
    assert ta.inv_transpose is td.inv_transpose
