"""Kernels against their plain versions on the card (marker `cuda`; skipped
without one). Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def veach_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from mcpt_tpu_torch.io.obj import load_scene

    return load_scene(os.path.join(ROOT, "scenes", "veach-mis.obj"), device="cuda")


def _rays(scene, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = scene.geom.v0.amin(0), scene.geom.v0.amax(0)
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g, device="cuda")
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device="cuda"), dim=1)
    o[::97] = 1e30  # parked lanes
    t_max = scene.scale * torch.rand(n, generator=g, device="cuda")
    return o, d, t_max


@pytest.mark.parametrize("n", [1, 255, 257, 70000])
def test_kernels_equal_plain_versions_bitwise(veach_cuda, n):
    from mcpt_tpu_torch.ops import woop

    ws = veach_cuda.woop
    o, d, t_max = _rays(veach_cuda, n, n)
    rays_c = woop.pack_rays(o, d, 1e-3, woop.F32_MAX)
    mask_c = woop.tile_chunk_mask(rays_c, ws.boxes)
    k = woop.closest_hit_woop_kernel(ws, rays_c, mask_c)
    p = woop.closest_hit_woop_plain(ws, rays_c, mask_c)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    rays_a = woop.pack_rays(o, d, 1e-3, t_max)
    mask_a = woop.tile_chunk_mask(rays_a, ws.boxes)
    assert torch.equal(woop.any_hit_woop_kernel(ws, rays_a, mask_a), woop.any_hit_woop_plain(ws, rays_a, mask_a))


def test_render_runs_through_kernels(veach_cuda):
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    before, plain = dict(woop.LAUNCHES), dict(woop.PLAIN_CALLS)
    r = Renderer(veach_cuda, RenderConfig(max_bounces=6, width=64, height=48))
    r.step()
    assert all(woop.LAUNCHES[k] > before[k] for k in before)
    assert woop.PLAIN_CALLS == plain
    assert r.stats["nan_scrubbed"] == 0 and float(r.film.accum.mean()) > 0
