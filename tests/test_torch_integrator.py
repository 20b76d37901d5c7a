"""The port's wavefront integrator and renderer against mcpt_tpu's on the CPU.

Both packages get the same scene arrays (scene_from_arrays) and the same
state; the JAX side runs its main path for veach, the fused Woop kernel in
interpret mode (intersect.DENSE_ALGO = "woop-fused").
"""
import dataclasses

import jax
import numpy as np
import pytest

from tests.torch_parity import to_numpy, to_torch, torch_scene

SEED = 3


def _small(scene, w, h):
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w, height=h))


@pytest.fixture
def woop_fused(monkeypatch):
    from mcpt_tpu.ops import intersect

    monkeypatch.setattr(intersect, "DENSE_ALGO", "woop-fused")
    jax.clear_caches()  # DENSE_ALGO is read at trace time
    yield
    jax.clear_caches()


@pytest.mark.parametrize("scene_fix", ["veach_scene", "cornell_scene_bvh"])
def test_split_shade_one_iteration_matches_jax(request, woop_fused, scene_fix):
    """One X step from an identical state: integer state and RNG-driven
    decisions bitwise, floats allclose (rtol 1e-5, atol 1e-6)."""
    from mcpt_tpu.render import integrator as JI
    from mcpt_tpu_torch.render import integrator as TI
    from mcpt_tpu_torch.utils.rng import prng_key

    jscene = _small(request.getfixturevalue(scene_fix), 16, 12)
    tscene = _small(torch_scene(jscene), 16, 12)
    R, spp, mb = 16 * 12, 2, 4
    key = jax.random.PRNGKey(SEED)
    pidx = jax.numpy.arange(R, dtype=jax.numpy.int32)
    st = JI.split_state0(R, spp)
    miss = (jax.numpy.full((R,), np.finfo(np.float32).max), jax.numpy.full((R,), -1, jax.numpy.int32),
            jax.numpy.zeros((R,)), jax.numpy.zeros((R,)), jax.numpy.zeros((R,), bool))
    st, _ = JI.split_shade(jscene, st, *miss, key, pidx, 0, spp, mb)
    for it in range(3):  # advance the JAX state to bounce 2, NEE pending
        hits = JI.split_trace(jscene, st["o"], st["d"], st["so"], st["sd"], st["smax"])
        tst = {k: to_torch(v) for k, v in st.items()}
        jst, jn = JI.split_shade(jscene, st, *hits, key, pidx, 0, spp, mb)
        got, tn = TI.split_shade(tscene, tst, *[to_torch(h) for h in hits], prng_key(SEED),
                                 to_torch(pidx).long(), 0, spp, mb)
        assert int(tn) == int(jn)
        for k, v in jst.items():
            want, have = np.asarray(v), to_numpy(got[k])
            if want.dtype.kind in "biu":
                np.testing.assert_array_equal(have, want.astype(have.dtype), err_msg=f"iter {it} {k}")
            else:
                np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6, err_msg=f"iter {it} {k}")
        st = jst


def _jax_render(scene, w, h, bounces, passes):
    from mcpt_tpu.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=bounces, width=w, height=h, seed=SEED))
    for _ in range(passes):
        r.step()
    return np.asarray(r.film.accum) / float(r.film.spp), r.stats


def _torch_render(scene, w, h, bounces, passes):
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=bounces, width=w, height=h, seed=SEED))
    for _ in range(passes):
        r.step()
    return to_numpy(r.film.accum) / r.film.spp, r.stats


@pytest.mark.parametrize("scene_fix,w,h", [("veach_scene", 48, 32), ("cornell_scene_bvh", 32, 24)])
def test_render_matches_jax(request, woop_fused, scene_fix, w, h):
    """Whole render, 2 spp at 4 bounces: >= 99 % of components within
    rtol 1e-3 (atol 1e-3) and channel means within rtol 2e-3, the contract
    of tests/test_woop.py's render cross-check."""
    jscene = request.getfixturevalue(scene_fix)
    a, ja = _jax_render(jscene, w, h, 4, 2)
    b, tb = _torch_render(torch_scene(jscene), w, h, 4, 2)
    assert tb["nan_scrubbed"] == 0 and ja["nan_scrubbed"] == 0
    close = np.isclose(b, a, rtol=1e-3, atol=1e-3).mean()
    assert close >= 0.99, f"only {close:.4f} of components close"
    np.testing.assert_allclose(b.mean(axis=(0, 1)), a.mean(axis=(0, 1)), rtol=2e-3)
    assert tb["traced_rays"] == pytest.approx(ja["traced_rays"], rel=1e-3)
