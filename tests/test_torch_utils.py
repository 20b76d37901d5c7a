"""mcpt_tpu_torch's RNG, math, ONB, camera, film and image helpers against
mcpt_tpu's, on the CPU with the same numpy inputs."""
import dataclasses

import jax
import jax.extend as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy

T = torch.from_numpy


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    from mcpt_tpu_torch.utils.rng import prng_key

    assert prng_key(seed) == tuple(int(x) for x in np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


def test_threefry_bitwise_equal_to_jax(rng):
    """threefry2x32 in int64: every word bitwise equal on 65,536 counter pairs."""
    from mcpt_tpu_torch.utils.rng import threefry2x32

    key = (0x12345678, 0x9ABCDEF0)
    x = rng.integers(0, 2**32, size=(2, 32768), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jex.random.threefry_2x32(jnp.asarray(key, jnp.uint32), jnp.asarray(x.ravel())))
    w0, w1 = threefry2x32(key, T(x[0].astype(np.int64)), T(x[1].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([to_numpy(w0), to_numpy(w1)]), want.astype(np.int64))


@pytest.mark.parametrize("n", [2, 7])
def test_sample_uniforms_bitwise_equal_to_jax(rng, n):
    from mcpt_tpu.utils.rng import sample_uniforms as jsu
    from mcpt_tpu_torch.utils.rng import prng_key, sample_uniforms as tsu

    R = 4096
    pix = rng.integers(0, 2**22, R).astype(np.int32)
    sid = rng.integers(0, 2**20, R).astype(np.uint32)
    tag = rng.integers(0, 60, R).astype(np.uint32)
    for s, t in ((sid, tag), (5, 0), (sid, 3)):
        want = np.asarray(jsu(jax.random.PRNGKey(11), jnp.asarray(pix), jnp.asarray(s), jnp.asarray(t), n))
        got = tsu(prng_key(11), T(pix), torch.as_tensor(np.asarray(s, np.int64)),
                  torch.as_tensor(np.asarray(t, np.int64)), n)
        np.testing.assert_array_equal(to_numpy(got), want)


def test_math_helpers_match_jax(rng):
    """cross / normalize / power_heuristic / luminance: rtol 1e-6."""
    from mcpt_tpu.utils import math as JM
    from mcpt_tpu_torch.utils import math as TM

    a = rng.normal(size=(256, 3)).astype(np.float32)
    b = rng.normal(size=(256, 3)).astype(np.float32)
    p = np.abs(rng.normal(size=256)).astype(np.float32) * 10.0 ** rng.integers(-20, 20, 256)
    q = np.abs(rng.normal(size=256)).astype(np.float32)
    p[:4] = 0.0
    q[:2] = 0.0
    for jf, tf, args in ((JM.cross, TM.cross, (a, b)), (JM.normalize, TM.normalize, (a,)),
                         (JM.power_heuristic, TM.power_heuristic, (p.astype(np.float32), q)),
                         (JM.luminance, TM.luminance, (a,))):
        np.testing.assert_allclose(to_numpy(tf(*map(T, args))), np.asarray(jf(*map(jnp.asarray, args))),
                                   rtol=1e-6, atol=1e-7)


def test_onb_matches_jax(rng):
    """make_onb / to_local / to_world: rtol 1e-5."""
    from mcpt_tpu.render import onb as JO
    from mcpt_tpu_torch.render import onb as TO

    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] = [[1, 0, 0]] * 4 + [[0.95, 0.3122499, 0]] * 4
    v = rng.normal(size=(512, 3)).astype(np.float32)
    jb, tb = JO.make_onb(jnp.asarray(n)), TO.make_onb(T(n))
    for x, y in zip(jb, tb):
        np.testing.assert_allclose(to_numpy(y), np.asarray(x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_numpy(TO.to_local(tb, T(v))), np.asarray(JO.to_local(jb, jnp.asarray(v))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_numpy(TO.to_world(tb, T(v))), np.asarray(JO.to_world(jb, jnp.asarray(v))),
                               rtol=1e-5, atol=1e-6)


def test_generate_rays_matches_jax(veach_scene, rng):
    """Camera rays at 64x48 with the same jitter: rtol 1e-5."""
    from mcpt_tpu.render.camera import generate_rays as jgen
    from mcpt_tpu_torch.render.camera import generate_rays as tgen
    from tests.torch_parity import torch_scene

    cam_j = dataclasses.replace(veach_scene.camera, width=64, height=48)
    cam_t = dataclasses.replace(torch_scene(veach_scene).camera, width=64, height=48)
    jit = rng.random((64 * 48, 2)).astype(np.float32)
    pix = np.arange(64 * 48, dtype=np.int32)
    jo, jd = jgen(cam_j, jnp.asarray(jit), jnp.asarray(pix))
    to, td = tgen(cam_t, T(jit), T(pix).long())
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(to_numpy(td), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_film_accumulate_and_tonemap_match_jax(rng):
    """NaN scrubbing, counts and the u8 tonemap: equal to mcpt_tpu's."""
    from mcpt_tpu.io.image import tonemap as jtone
    from mcpt_tpu.render import film as JF
    from mcpt_tpu_torch.io.image import tonemap as ttone
    from mcpt_tpu_torch.render import film as TF

    rad = rng.random((2, 12, 16, 3)).astype(np.float32) * 2
    rad[0, 3, 4, 1] = np.nan
    rad[1, 0, 0, :] = np.nan
    jf = JF.accumulate(JF.make_film(12, 16), jnp.asarray(rad), spp_added=2.0)
    tf = TF.accumulate(TF.make_film(12, 16, "cpu"), T(rad), spp_added=2.0)
    assert tf.nan_count == int(jf.nan_count) == 4 and tf.spp == float(jf.spp)
    np.testing.assert_allclose(to_numpy(tf.accum), np.asarray(jf.accum), rtol=1e-6)
    np.testing.assert_array_equal(TF.to_display(tf), JF.to_display(jf))
    np.testing.assert_array_equal(ttone(to_numpy(tf.accum), 2.0), jtone(np.asarray(jf.accum), 2.0))
