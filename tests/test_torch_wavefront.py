"""trace_wavefront / trace_image_wavefront, the "render these pixels, these
samples" functions the sharded pass is built on: the port's (on its split
iteration) against mcpt_tpu's loop-mode ones, chunking and a subset of
pixels change no sample, and the renderer's pass is the same function."""
import dataclasses

import jax
import numpy as np
import torch

from tests.torch_parity import to_numpy, torch_scene


def _small(scene, w, h):
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w, height=h))


def test_trace_image_wavefront_matches_jax(cornell_scene_bvh):
    """cornell 16x12, samples 3-4 (start_idx 3, spp 2), 4 bounces, every
    other pixel: L_sum under tests/test_torch_integrator.py's contract,
    traced rays within 1e-3, and the returns' shapes and kinds."""
    from mcpt_tpu.render.integrator import trace_image_wavefront as jax_trace
    from mcpt_tpu_torch.render.integrator import trace_image_wavefront
    from mcpt_tpu_torch.utils.rng import prng_key

    js = _small(cornell_scene_bvh, 16, 12)
    ts = _small(torch_scene(cornell_scene_bvh), 16, 12)
    pidx = np.arange(0, 16 * 12, 2, dtype=np.int32)
    L, nr, nc = trace_image_wavefront(ts, ts.camera, prng_key(5), torch.from_numpy(pidx), 3, 2, 4)
    jL, jnr, jnc = jax_trace(js, js.camera, jax.random.PRNGKey(5), jax.numpy.asarray(pidx), 3, 2, 4)
    assert L.shape == (pidx.shape[0], 3) and nr.dim() == nc.dim() == 0
    a, b = to_numpy(L), np.asarray(jL)
    assert np.isclose(a, b, rtol=1e-3, atol=1e-3).mean() >= 0.99
    np.testing.assert_allclose(a.mean(axis=0), b.mean(axis=0), rtol=2e-3)
    assert int(nc) == int(jnc) == 0
    assert abs(int(nr) - int(jnr)) <= 1e-3 * int(jnr)


def test_chunks_and_pixel_subsets_change_no_sample():
    """Chunks of 96 lanes, a subset of pixels and trace_wavefront's one
    wavefront give the pixels of a Renderer pass bit for bit."""
    import os

    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.integrator import trace_image_wavefront, trace_wavefront
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer
    from mcpt_tpu_torch.utils.rng import prng_key

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = _small(load_scene(os.path.join(root, "scenes", "cornell-box.obj"), device="cpu"), 16, 12)
    r = Renderer(s, RenderConfig(max_bounces=3, spp_per_pass=2, seed=1))
    r.step()
    whole = r.film.accum.reshape(-1, 3)
    all_px = torch.arange(16 * 12)
    L, nr, _ = trace_image_wavefront(s, s.camera, prng_key(1), all_px, 0, 2, 3, chunk_rays=96)
    assert torch.equal(L, whole) and float(nr) == r.film.rays
    sub = torch.arange(5, 16 * 12, 7)
    L2, _, _ = trace_image_wavefront(s, s.camera, prng_key(1), sub, 0, 2, 3)
    assert torch.equal(L2, whole[sub])
    L3, nr3, nc3, iters = trace_wavefront(s, s.camera, prng_key(1), all_px, 0, 2, 3)
    assert torch.equal(L3, whole) and int(nr3) == int(nr) and int(nc3) == 0 and int(iters) > 2
