"""Kernels against their plain versions on the card (marker `cuda`; skipped
without one). Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import os
import sys

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


@pytest.mark.parametrize("n", [0, 1, 255, 257, 70000])
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


@pytest.mark.parametrize("n", [0, 1, 255, 257, 70000])
def test_any_kernel_equals_plain_version_bitwise(veach_cuda, n):
    """The any-hit kernel on random rays and on shadow rays that end just
    short of (or exactly at) a hit, t_lo = 0 on some (rays the pre-test
    leaves to the exact predicate)."""
    from mcpt_tpu_torch.ops import woop

    ws = veach_cuda.woop
    o, d, t_max = _rays(veach_cuda, n, n + 3)
    rc = woop.pack_rays(o, d, 1e-3, woop.F32_MAX)
    t, tri, _, _ = woop.closest_hit_woop_plain(ws, rc, woop.tile_chunk_mask(rc, ws.boxes))
    k = torch.arange(n, device="cuda")
    t_max = torch.where(tri >= 0, torch.where(k % 2 == 0, t, t * 0.999), t_max)
    t_min = torch.where(k % 5 == 0, 0.0, 1e-3)
    rays = woop.pack_rays(o, d, t_min, t_max)
    mask = woop.tile_chunk_mask(rays, ws.boxes)
    launches = woop.LAUNCHES["any"]
    assert torch.equal(woop.any_hit_woop_kernel(ws, rays, mask), woop.any_hit_woop_plain(ws, rays, mask))
    assert woop.LAUNCHES["any"] == launches + (n > 0)


def test_render_runs_through_kernels(veach_cuda):
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    before, plain = dict(woop.LAUNCHES), dict(woop.PLAIN_CALLS)
    r = Renderer(veach_cuda, RenderConfig(max_bounces=6, width=64, height=48))
    r.step()
    assert all(woop.LAUNCHES[k] > before[k] for k in before)
    assert woop.PLAIN_CALLS == plain
    assert r.stats["nan_scrubbed"] == 0 and float(r.film.accum.mean()) > 0


@pytest.mark.parametrize("n", [0, 1, 127, 129, 70000])
def test_traversal_kernels_equal_plain_versions_bitwise(stress_cuda, n):
    """Closest hit (the ordered walk) against closest_hit_ordered_plain, any
    hit against any_hit_ordered_plain and the skip-link walk."""
    from mcpt_tpu_torch.ops import traverse
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays

    scene = stress_cuda[0]
    ts = scene.trav
    o, d, t_max = _rays(scene, n, n)
    o[1::89] = 5.0  # unparked origins on the room's middle planes, along an axis
    d[1::89] = torch.tensor([0.0, 1.0, 0.0], device="cuda")
    rays_c = pack_rays(o, d, 1e-3, F32_MAX)
    k = traverse.closest_hit_traverse_kernel(ts, rays_c)
    p = traverse.closest_hit_ordered_plain(ts, rays_c)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    rays_a = pack_rays(o, d, 1e-3, t_max)
    want = traverse.any_hit_ordered_plain(ts, rays_a)
    assert torch.equal(want, traverse.any_hit_traverse_plain(ts, rays_a))
    assert torch.equal(traverse.any_hit_traverse_kernel(ts, rays_a), want)


@pytest.mark.parametrize("D", [64, 100, 128])
def test_closest_kernel_on_deep_trees_equals_plain_version_bitwise(D):
    """The closest-hit kernel with its 64-entry stack (D = 64) and with its
    128-entry stack (deeper trees, whose walks here fill more than 64
    entries) against closest_hit_ordered_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import sys

    import numpy as np

    from mcpt_tpu_torch.ops import traverse
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays

    # by path: a site-wide package named `tests` may shadow this directory
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from torch_parity import deep_chain
    finally:
        sys.path.pop(0)
    ts, o, d = deep_chain(D, np.random.default_rng(D), device="cuda")
    rays = pack_rays(torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda(), 1e-3, F32_MAX)
    k = traverse.closest_hit_traverse_kernel(ts, rays)
    p = traverse.closest_hit_ordered_plain(ts, rays)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert bool((p[1] >= 0).any())


@pytest.mark.parametrize("D", [64, 100, 128])
def test_any_kernel_on_deep_trees_equals_plain_version_bitwise(D):
    """The any-hit kernel with its 64-entry stack (D = 64) and its 128-entry
    stack, against any_hit_ordered_plain and the skip-link walk, on
    deep_chain's rays with finite t_max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import sys

    import numpy as np

    from mcpt_tpu_torch.ops import traverse
    from mcpt_tpu_torch.ops.woop import pack_rays

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from torch_parity import deep_chain
    finally:
        sys.path.pop(0)
    ts, o, d = deep_chain(D, np.random.default_rng(D), device="cuda")
    t_max = torch.from_numpy(np.random.default_rng(D + 1).uniform(0.5, 4.0, o.shape[0]).astype(np.float32))
    rays = pack_rays(torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda(), 1e-3, t_max.cuda())
    want = traverse.any_hit_ordered_plain(ts, rays)
    assert torch.equal(want, traverse.any_hit_traverse_plain(ts, rays))
    assert torch.equal(traverse.any_hit_traverse_kernel(ts, rays), want)
    assert 0.2 < float(want.float().mean()) < 0.8


@pytest.mark.parametrize("scene", ["veach", "stress"])
def test_closest_kernel_on_camera_rays_equals_plain_version_bitwise(veach_cuda, stress_cuda, scene):
    """The Woop closest-hit kernel, whose interval pre-test culls against the
    running best_t, on 3,072 of the scene camera's rays and on their
    bounce-like continuations (origins at the hits, random directions),
    against closest_hit_woop_plain; on veach-mis and on the 5,986-triangle
    stress scene's triangles packed into Woop chunks."""
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.render.camera import generate_rays

    s = veach_cuda if scene == "veach" else stress_cuda[0]
    ws = s.woop if scene == "veach" else woop.pack_woop_table(s.geom.v0, s.geom.e1, s.geom.e2)
    g = torch.Generator(device="cuda").manual_seed(5)
    R = 64 * 48
    pix = torch.randint(0, s.camera.width * s.camera.height, (R,), generator=g, device="cuda")
    o, d = generate_rays(s.camera, torch.rand((R, 2), generator=g, device="cuda"), pix)
    t_min = 1e-4 * s.scale
    rays = woop.pack_rays(o, d, t_min, woop.F32_MAX)
    mask = woop.tile_chunk_mask(rays, ws.boxes)
    k = woop.closest_hit_woop_kernel(ws, rays, mask)
    p = woop.closest_hit_woop_plain(ws, rays, mask)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    hit = p[1] >= 0
    assert float(hit.float().mean()) > 0.5
    o2 = (o + d * p[0][:, None])[hit]
    d2 = torch.nn.functional.normalize(torch.randn(o2.shape, generator=g, device="cuda"), dim=1)
    rays2 = woop.pack_rays(o2, d2, t_min, woop.F32_MAX)
    mask2 = woop.tile_chunk_mask(rays2, ws.boxes)
    for a, b in zip(woop.closest_hit_woop_kernel(ws, rays2, mask2), woop.closest_hit_woop_plain(ws, rays2, mask2)):
        assert torch.equal(a, b)


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


def _treelet_layouts(scene):
    """The scene's own treelet layout (c = s_b = 128: one superblock at
    5,986 triangles) and a deep one over the same BVH (c = 16, s_b = 8)."""
    import dataclasses

    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.scene import _to

    bvh = {k: getattr(scene.bvh, k).cpu().numpy() for k in ("lo", "hi", "first", "count", "skip")}
    deep = _to(build_treelets(bvh, scene.num_tris, 16, 8), scene.device)
    return {"own": scene, "deep": dataclasses.replace(scene, treelets=deep)}


@pytest.mark.parametrize("layout", ["own", "deep"])
@pytest.mark.parametrize("n", [1, 129, 70000])
def test_treelet_kernels_equal_plain_versions_bitwise(stress_cuda, layout, n):
    """The schedule walk kernels (v = 512, v = 64 with blanked rows, and v
    = 8192, past the default shared memory) and the select kernels against
    their plain walks on the same sorted tiles."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops.woop import F32_MAX

    scene = _treelet_layouts(stress_cuda[0])[layout]
    tl, ts = scene.treelets, scene.trav
    o, d, t_max = _rays(scene, n, n + 1)
    o[1::89] = 5.0  # unparked origins on the room's middle planes, along an axis
    d[1::89] = torch.tensor([0.0, 1.0, 0.0], device="cuda")
    for closest in (True, False):
        rays, _ = S.sorted_tiles(scene, o, d, 1e-3, F32_MAX if closest else t_max)
        kind = "closest" if closest else "any"
        for v in (512, 64, 8192):
            sched, _, _ = S.build_schedule_plain(tl, rays, v)
            k = getattr(S, f"{kind}_hit_schedule_kernel")(tl, ts, rays, sched)
            p = getattr(S, f"{kind}_hit_schedule_plain")(tl, ts, rays, sched)
            for a, b in zip(k, p) if closest else ((k, p),):
                assert torch.equal(a, b), (kind, v)
        k = getattr(SL, f"{kind}_hit_select_kernel")(tl, ts, rays)
        p = getattr(SL, f"{kind}_hit_select_plain")(tl, ts, rays)
        for a, b in zip(k, p) if closest else ((k, p),):
            assert torch.equal(a, b), kind


@pytest.mark.parametrize("layout", ["own", "deep"])
@pytest.mark.parametrize("n", [1, 129, 70000])
def test_prepass_kernel_equals_plain_version_bitwise(stress_cuda, layout, n):
    """The schedule pre-pass kernel against build_schedule_plain (keys,
    incomplete tiles, live counts) at v = 64 (blanked rows), 512 and 8192,
    on sorted tiles and on unsorted ones, closest-hit and any-hit t bounds."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays

    scene = _treelet_layouts(stress_cuda[0])[layout]
    tl = scene.treelets
    o, d, t_max = _rays(scene, n, n + 7)
    o[2::89] = 5.0
    d[2::89] = torch.tensor([0.0, 0.0, -1.0], device="cuda")
    batches = [S.sorted_tiles(scene, o, d, 1e-3, F32_MAX)[0], S.sorted_tiles(scene, o, d, 1e-3, t_max)[0],
               S.pad_tiles(pack_rays(o, d, 1e-3, t_max))]
    launches = S.LAUNCHES["prepass"]
    for rays in batches:
        for v in (64, 512, 8192):
            got = S.build_schedule_kernel(tl, rays, v)
            want = S.build_schedule_plain(tl, rays, v)
            for a, b in zip(got, want):
                assert torch.equal(a, b), v
    assert S.LAUNCHES["prepass"] == launches + 9


def test_treelet_wrappers_route_by_device(stress_cuda):
    """A CPU tensor takes the plain versions (pre-pass and walks) and
    launches nothing; a CUDA tensor launches the kernels and never takes a
    plain version; both answer alike, and alike the BVH traversal."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops import traverse

    cuda, cpu = stress_cuda
    o, d, t_max = _rays(cuda, 3000, 9)
    out = {}
    for dev, scene in (("cuda", cuda), ("cpu", cpu)):
        counts = [(dict(m.LAUNCHES), dict(m.PLAIN_CALLS)) for m in (S, SL)]
        args = (scene, o.to(dev), d.to(dev), 1e-3)
        out[dev] = (S.closest_hit_schedule(*args), S.any_hit_schedule(*args, t_max.to(dev)),
                    SL.closest_hit_select(*args), SL.any_hit_select(*args, t_max.to(dev)))
        for m, (launches, plain) in zip((S, SL), counts):
            ran, idle = (m.LAUNCHES, m.PLAIN_CALLS) if dev == "cuda" else (m.PLAIN_CALLS, m.LAUNCHES)
            # one walk a call; the schedule's two calls each run the pre-pass
            assert ran == {k: (launches if dev == "cuda" else plain)[k] + (2 if k == "prepass" else 1)
                           for k in launches}
            assert idle == (plain if dev == "cuda" else launches)
    want = (traverse.closest_hit_traverse(cpu.trav, o.cpu(), d.cpu(), 1e-3, traverse.F32_MAX),
            traverse.any_hit_traverse(cpu.trav, o.cpu(), d.cpu(), 1e-3, t_max.cpu()))
    for i in range(4):
        for a, b, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (out["cuda"][i], out["cpu"][i],
                                                                            want[i % 2]))):
            assert torch.equal(a.cpu(), b) and torch.equal(b, w)


@pytest.mark.parametrize("layout", ["own", "deep"])
def test_schedule_entry_points_fall_back_exactly(stress_cuda, layout):
    """With v at the median live count about half the tiles overflow: the
    entry points send their rays through traverse.cu and answer as the BVH
    traversal does, bit for bit."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import traverse

    from mcpt_tpu_torch.render.camera import generate_rays

    scene = _treelet_layouts(stress_cuda[0])[layout]
    g = torch.Generator(device="cuda").manual_seed(6)
    o1, d1 = generate_rays(scene.camera, torch.rand((10000, 2), generator=g, device="cuda"),
                           torch.arange(10000, device="cuda"))  # coherent tiles
    o2, d2, t2 = _rays(scene, 10000, 5)
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    t_max = torch.cat([scene.scale * torch.rand(10000, generator=g, device="cuda"), t2])
    for kind, tm in (("closest", traverse.F32_MAX), ("any", t_max)):
        rays = S.sorted_tiles(scene, o, d, 1e-3, tm)[0]
        v = int(S.build_schedule(scene.treelets, rays, S.MAX_V)[2].median())
        _, inc, _ = S.build_schedule(scene.treelets, rays, v)
        assert 0 < int(inc.sum()) < inc.shape[0]
        launches = traverse.LAUNCHES[kind]
        got = getattr(S, f"{kind}_hit_schedule")(scene, o, d, 1e-3, tm, v=v)
        assert traverse.LAUNCHES[kind] == launches + 1
        want = getattr(traverse, f"{kind}_hit_traverse")(scene.trav, o, d, 1e-3, tm)
        for a, b in zip(got, want) if kind == "closest" else ((got, want),):
            assert torch.equal(a, b), kind


def test_stress_render_runs_through_select_kernels(stress_cuda, monkeypatch):
    from mcpt_tpu_torch.ops import intersect, select, traverse, woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    monkeypatch.setattr(intersect, "TREELET_SELECT", "smem")
    launches = dict(select.LAUNCHES)
    others = (dict(traverse.LAUNCHES), dict(traverse.PLAIN_CALLS), dict(select.PLAIN_CALLS),
              dict(woop.LAUNCHES))
    r = Renderer(stress_cuda[0], RenderConfig(max_bounces=6, width=64, height=48))
    r.step()
    assert all(select.LAUNCHES[k] > launches[k] for k in launches)
    assert (traverse.LAUNCHES, traverse.PLAIN_CALLS, select.PLAIN_CALLS, woop.LAUNCHES) == others
    assert r.stats["nan_scrubbed"] == 0 and float(r.film.accum.mean()) > 0


@pytest.mark.parametrize("D", [16, 40])
def test_select_kernel_on_deep_treelets_equals_plain_walk_bitwise(D):
    """A treelet D inner nodes deep (deep_chain's BVH as one treelet): the
    select kernels with their 16-entry stack (D = 16) and their 128-entry
    stack against their plain walk, bit for bit, in sorted and slot order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import sys

    import numpy as np

    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays
    from mcpt_tpu_torch.scene import _to

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from torch_parity import deep_chain
    finally:
        sys.path.pop(0)
    ts, o, d, bvh = deep_chain(D, np.random.default_rng(D), device="cuda", with_bvh=True)
    tl = _to(build_treelets({k: getattr(bvh, k).cpu().numpy() for k in ("lo", "hi", "first", "count", "skip")},
                            D + 1), torch.device("cuda"))
    assert tl.tdepth == D
    t_max = torch.from_numpy(np.random.default_rng(D + 1).uniform(0.5, 4.0, o.shape[0]).astype(np.float32))
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    for kind, tm in (("closest", F32_MAX), ("any", t_max.cuda())):
        rays = pad_tiles(pack_rays(o, d, 1e-3, tm))
        k = getattr(SL, f"{kind}_hit_select_kernel")(tl, ts, rays)
        p = getattr(SL, f"{kind}_hit_select_plain")(tl, ts, rays)
        for a, b in zip(k, p) if kind == "closest" else ((k, p),):
            assert torch.equal(a, b), kind


@pytest.mark.parametrize("D", [16, 40])
def test_schedule_kernels_on_deep_treelets_equal_plain_versions_bitwise(D):
    """deep_chain's BVH as one treelet D inner nodes deep: the pre-pass
    kernel and the schedule walk kernels (16-entry stack at D = 16, the
    128-entry one above) against their plain versions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import sys

    import numpy as np

    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.ops.woop import F32_MAX, pack_rays
    from mcpt_tpu_torch.scene import _to

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from torch_parity import deep_chain
    finally:
        sys.path.pop(0)
    ts, o, d, bvh = deep_chain(D, np.random.default_rng(D + 2), device="cuda", with_bvh=True)
    tl = _to(build_treelets({k: getattr(bvh, k).cpu().numpy() for k in ("lo", "hi", "first", "count", "skip")},
                            D + 1), torch.device("cuda"))
    assert tl.tdepth == D
    t_max = torch.from_numpy(np.random.default_rng(D + 3).uniform(0.5, 4.0, o.shape[0]).astype(np.float32))
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    for kind, tm in (("closest", F32_MAX), ("any", t_max.cuda())):
        rays = S.pad_tiles(pack_rays(o, d, 1e-3, tm))
        sched = S.build_schedule_kernel(tl, rays)
        for a, b in zip(sched, S.build_schedule_plain(tl, rays)):
            assert torch.equal(a, b), kind
        k = getattr(S, f"{kind}_hit_schedule_kernel")(tl, ts, rays, sched[0])
        p = getattr(S, f"{kind}_hit_schedule_plain")(tl, ts, rays, sched[0])
        for a, b in zip(k, p) if kind == "closest" else ((k, p),):
            assert torch.equal(a, b), kind


def _grads_kernel_and_plain(scene, mod, swaps, w, h, bounces):
    """loss_and_grad through the kernels (their launches counted), then
    with the plain versions swapped in (chip_smoke.py's phases 16-17 at a
    small size), deterministic algorithms on: the backward of an index
    gather sums with atomics on the card otherwise."""
    import dataclasses

    from mcpt_tpu_torch.diff.grad import extract_params, loss_and_grad
    from mcpt_tpu_torch.ops.plain_route import deterministic, plain_route
    from mcpt_tpu_torch.utils.rng import prng_key

    sc = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w, height=h))
    p = extract_params(sc)
    black = torch.zeros((h, w, 3), device="cuda")
    with deterministic():
        before = dict(mod.LAUNCHES)
        k = loss_and_grad(p, sc, black, prng_key(2), 1, bounces)
        launched = {c: mod.LAUNCHES[c] - before[c] for c in before}
        with plain_route(mod, swaps):
            pl = loss_and_grad(p, sc, black, prng_key(2), 1, bounces)
    return k, pl, launched


def _assert_same(k, pl):
    (lk, gk), (lp, gp) = k, pl
    assert torch.equal(lk, lp)
    for name, v in gk.tensors().items():
        assert torch.isfinite(v).all(), name
        assert torch.equal(v, getattr(gp, name)), name


def test_gradients_through_woop_kernels_equal_plain_bitwise(veach_cuda):
    """A gradient step (kd, ks, radiance, dverts) on veach at 32x24, 1 spp,
    3 bounces launches both Woop kernels, and equals the step through their
    plain versions bit for bit."""
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.ops.plain_route import WOOP_PLAIN

    k, pl, launched = _grads_kernel_and_plain(veach_cuda, woop, WOOP_PLAIN, 32, 24, 3)
    assert min(launched.values()) > 0, launched
    _assert_same(k, pl)


def test_gradients_through_traversal_kernels_equal_plain_bitwise(stress_cuda):
    """The same on the 5,986-triangle stress scene at 32x18, 1 spp, 2
    bounces, through the traversal kernels (vertex field over every vertex)."""
    from mcpt_tpu_torch.ops import traverse
    from mcpt_tpu_torch.ops.plain_route import TRAVERSE_PLAIN

    k, pl, launched = _grads_kernel_and_plain(stress_cuda[0], traverse, TRAVERSE_PLAIN, 32, 18, 2)
    assert min(launched.values()) > 0, launched
    assert k[1].dverts is not None
    _assert_same(k, pl)


def test_inverse_step_on_card():
    """One Adam step on cornell at 16x16 (the dense route) on the card:
    finite loss and parameters, no gradient entry scrubbed, kd moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from mcpt_tpu_torch.diff.grad import extract_params, render_image
    from mcpt_tpu_torch.diff.inverse import make_inverse_step
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.utils.rng import prng_key

    s = load_scene(os.path.join(ROOT, "scenes", "cornell-box.obj"), device="cuda")
    s = dataclasses.replace(s, camera=dataclasses.replace(s.camera, width=16, height=16))
    p = extract_params(s)
    with torch.no_grad():
        target = render_image(p, s, prng_key(7), 2, 3)
    init, step = make_inverse_step(s, target, spp=1, max_bounces=3, radiance_lr=0.2)
    start = dataclasses.replace(p, kd=p.kd * 0.5)
    st, loss = step(init(start), prng_key(1))
    assert torch.isfinite(loss) and int(st.scrubbed) == 0
    assert all(torch.isfinite(v).all() for v in st.params.tensors().values())
    assert not torch.equal(st.params.kd, start.kd)


TESTS = os.path.join(ROOT, "tests")


def _tests_module(name):
    """A helper module of tests/ by file name: these tests run with
    --noconftest, where a package named `tests` elsewhere on the path may
    shadow this directory."""
    import importlib

    sys.path.insert(0, TESTS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(TESTS)


def test_cli_render_and_resume_on_card(veach_cuda, tmp_path, capsys):
    """`render` on the card (veach-mis at 64x64, 4 bounces, 1 spp a pass,
    the Woop kernels): a resume from the 1-spp checkpoint gives the
    uninterrupted run's PNG and radiance bit for bit."""
    import numpy as np
    from PIL import Image

    from mcpt_tpu_torch.cli import main
    from mcpt_tpu_torch.ops import woop

    scene = os.path.join(ROOT, "scenes", "veach-mis.obj")
    base = ["render", scene, "--width", "64", "--height", "64", "--spp-per-pass", "1", "--bounces", "4"]
    ck = str(tmp_path / "ck.npz")
    before = woop.LAUNCHES["closest"]
    assert main(base + ["--spp", "1", "--checkpoint", ck, "--checkpoint-every", "1",
                        "--out", str(tmp_path / "one.png")]) == 0
    assert woop.LAUNCHES["closest"] > before
    outs = {}
    for name, extra in (("resumed", ["--resume", ck]), ("full", [])):
        png, rad = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}.npz")
        assert main(base + ["--spp", "2", "--out", png, "--save-radiance", rad, *extra]) == 0
        outs[name] = (np.asarray(Image.open(png)), np.load(rad)["radiance"])
    assert '"nan_scrubbed": 0' in capsys.readouterr().out
    for a, b in zip(outs["resumed"], outs["full"]):
        np.testing.assert_array_equal(a, b)


def test_f64_grazing_rays_on_card():
    """The f64 dense route on CUDA tensors tells apart rays 1e-5 either
    side of a triangle's edges at 1e4 (tests/test_torch_f64.py's case),
    which f32 cannot, and equals the CPU's answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import types

    from mcpt_tpu_torch.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce

    f64_case = _tests_module("test_torch_f64")
    OFFSETS = f64_case.OFFSETS
    v0, e1, e2, org, d = f64_case._grazing()
    inside = [off > 0 for off in OFFSETS for _ in range(3)]
    for dev in ("cuda", "cpu"):
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        scene = types.SimpleNamespace(geom=types.SimpleNamespace(v0=f(v0), e1=f(e1), e2=f(e2)))
        o, dd = torch.tensor(org, device=dev), torch.tensor(d, device=dev)
        hit = closest_hit_bruteforce(scene, o, dd, f64=True)
        assert (hit.tri >= 0).tolist() == inside
        assert any_hit_bruteforce(scene, o, dd, f64=True).tolist() == inside
        if dev == "cuda":
            card = hit
    assert torch.equal(card.t.cpu(), hit.t) and torch.equal(card.tri.cpu(), hit.tri)


def test_two_rank_gloo_sharded_render_on_one_card(veach_cuda, tmp_path):
    """A 2x1 ShardedRenderer of two gloo ranks sharing the card (veach at
    64x64, 4 bounces, 2 spp) gives the single-process film bit for bit, its
    ranks launching the Woop kernels."""
    from mcpt_tpu_torch.ops import _build
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    _build.library()  # built here, so that the ranks only load it
    sys.path.insert(0, TESTS)  # the spawned ranks import the rank program by this path
    try:
        M = _tests_module("torch_mesh_ranks")
        res = M.spawn(M.card_two_ranks, 2, tmp_path, device="cuda")
    finally:
        sys.path.remove(TESTS)
    r = Renderer(veach_cuda, RenderConfig(max_bounces=4, spp_per_pass=2, width=64, height=64))
    r.step()
    for x in res:
        assert x["backend"] == "gloo" and x["launches"]["closest"] > 0
        assert torch.equal(x["film"]["accum"], r.film.accum.cpu())
        assert x["film"]["rays"] == r.film.rays and x["film"]["nan_count"] == r.film.nan_count
