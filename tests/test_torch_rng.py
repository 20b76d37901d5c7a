"""The fixed-bounce loop's RNG (host-side key folding and splitting, and
the per-ray streams) against jax.random and mcpt_tpu.utils.rng, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy

SEEDS = [0, 3, 7, 12345, 2**31 - 1]


def _key_words(k):
    return tuple(int(x) for x in np.asarray(k))


def test_written_against_partitionable_threefry():
    """jax.random.split depends on jax_threefry_partitionable; the port
    follows JAX's default, True since 0.5 (the fold-like split)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_equal_jax(seed):
    from mcpt_tpu_torch.utils.rng import fold_in, prng_key, split

    jk, tk = jax.random.PRNGKey(seed), prng_key(seed)
    assert _key_words(jk) == tk
    for data in (0, 1, 2, 5, 499, 2**31, 2**32 - 1):
        assert fold_in(tk, data) == _key_words(jax.random.fold_in(jk, data)), data
    for n in (1, 2, 3, 8):
        assert split(tk, n) == [_key_words(k) for k in jax.random.split(jk, n)], n
    # the chains the inverse loop builds: fold_in(key, step), then split
    ka, kb = split(fold_in(tk, 3))
    ja, jb = jax.random.split(jax.random.fold_in(jk, 3))
    assert (ka, kb) == (_key_words(ja), _key_words(jb))


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
@pytest.mark.parametrize("n", [2, 7])
def test_ray_uniforms_equal_jax(seed, n):
    """per_ray_keys / ray_uniforms on 4,096 random pixel ids, for the
    camera stream and bounce streams, from a folded sample key."""
    from mcpt_tpu.utils import rng as JR
    from mcpt_tpu_torch.utils import rng as TR

    g = np.random.default_rng(seed)
    pix = g.integers(0, 2**24, 4096).astype(np.int32)
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tk = TR.fold_in(TR.prng_key(seed), 5)
    jctx = JR.per_ray_keys(jk, jnp.asarray(pix))
    tctx = TR.per_ray_keys(tk, torch.from_numpy(pix))
    for tag in (0, 1, 5, 24):
        want = np.asarray(JR.ray_uniforms(jctx, tag, n))
        np.testing.assert_array_equal(to_numpy(TR.ray_uniforms(tctx, tag, n)), want)
