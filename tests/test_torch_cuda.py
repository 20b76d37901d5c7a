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


@pytest.fixture(scope="module")
def stress_cuda():
    """bathroom-stress at 5,986 triangles (chip_smoke.py's in-memory
    generator), on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import sys

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke.stress_scene(6000, 0, ("cuda", "cpu"))


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


@pytest.mark.parametrize("n", [1, 127, 129, 70000])
def test_traversal_kernels_equal_plain_versions_bitwise(stress_cuda, n):
    from mcpt_tpu_torch.ops import traverse
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays

    scene = stress_cuda[0]
    ts = scene.trav
    o, d, t_max = _rays(scene, n, n)
    o[1::89] = 5.0  # unparked origins on the room's middle planes, along an axis
    d[1::89] = torch.tensor([0.0, 1.0, 0.0], device="cuda")
    rays_c = pack_rays(o, d, 1e-3, F32_MAX)
    k = traverse.closest_hit_traverse_kernel(ts, rays_c)
    p = traverse.closest_hit_traverse_plain(ts, rays_c)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    rays_a = pack_rays(o, d, 1e-3, t_max)
    assert torch.equal(traverse.any_hit_traverse_kernel(ts, rays_a), traverse.any_hit_traverse_plain(ts, rays_a))


def test_traversal_wrappers_route_by_device(stress_cuda):
    """A CPU tensor takes the plain walk and launches nothing; a CUDA tensor
    launches the kernel and never takes the plain walk; both answer alike."""
    from mcpt_tpu_torch.ops import traverse

    cuda, cpu = stress_cuda
    o, d, t_max = _rays(cuda, 3000, 7)
    out = {}
    for dev, scene in (("cuda", cuda), ("cpu", cpu)):
        launches, plain = dict(traverse.LAUNCHES), dict(traverse.PLAIN_CALLS)
        args = (scene.trav, o.to(dev), d.to(dev), 1e-3)
        out[dev] = (traverse.closest_hit_traverse(*args, traverse.F32_MAX),
                    traverse.any_hit_traverse(*args, t_max.to(dev)))
        if dev == "cuda":
            assert traverse.PLAIN_CALLS == plain
            assert traverse.LAUNCHES == {k: launches[k] + 1 for k in launches}
        else:
            assert traverse.LAUNCHES == launches
            assert traverse.PLAIN_CALLS == {k: plain[k] + 1 for k in plain}
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])


def test_stress_render_runs_through_traversal_kernels(stress_cuda):
    from mcpt_tpu_torch.ops import traverse, woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    launches = dict(traverse.LAUNCHES)
    plain = (dict(traverse.PLAIN_CALLS), dict(woop.PLAIN_CALLS), dict(woop.LAUNCHES))
    r = Renderer(stress_cuda[0], RenderConfig(max_bounces=6, width=64, height=48))
    r.step()
    assert all(traverse.LAUNCHES[k] > launches[k] for k in launches)
    assert (traverse.PLAIN_CALLS, woop.PLAIN_CALLS, woop.LAUNCHES) == plain
    assert r.stats["nan_scrubbed"] == 0 and float(r.film.accum.mean()) > 0
