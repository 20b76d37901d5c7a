"""The port's intersection (dense Moller-Trumbore and the Woop kernels'
plain versions) against mcpt_tpu's, on the CPU.

The Woop contract is tests/test_woop.py's for the fused kernel: triangle
ids agree on > 99 % of rays (rounding may flip knife-edge rays) and u, v
are >= -1e-6 where they agree. The JAX kernel's projection is an XLA matmul
that sums in its own order, so values differ by a few ulps of the projected
coordinates, not of t: t is held to rtol 1e-6 plus 1e-6 of the scene
diagonal, u and v (up to ~100 before the subtraction for small triangles
seen from afar) to 1e-4 absolute.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_intersect import _random_tri_scene
from tests.torch_parity import to_numpy, torch_scene

F32_MAX = float(np.finfo(np.float32).max)


def _rays(rng, R, lo=-2.0, hi=2.0):
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _veach_rays(scene, rng, R=2048):
    """64x16 camera rays (image-coherent tiles), random interior rays, two
    parked lanes and a masked ray."""
    from mcpt_tpu.render.camera import generate_rays

    lo, hi = np.asarray(scene.geom.v0).min(0), np.asarray(scene.geom.v0).max(0)
    o, d = _rays(rng, R)
    o = (lo + (hi - lo) * rng.random((R, 3))).astype(np.float32)
    cam = dataclasses.replace(scene.camera, width=64, height=16)
    co, cd = generate_rays(cam, jnp.asarray(rng.random((1024, 2)), jnp.float32))
    o[:1024], d[:1024] = np.asarray(co), np.asarray(cd)
    o[5] = o[700] = 1e30
    t_max = rng.uniform(0.5, 40.0, R).astype(np.float32)
    t_max[9] = 0.0
    return o, d, t_max


def _jax_layout(ws):
    """The port's WoopSet in mcpt_tpu's TPU layout: tbl f32[8, n_chunks*6*chunk]
    (the [T,6,8] matmul block, chunk- then component-major), eps widened to
    [8, Tp], boxes f32[8, 128] (lo.xyz hi.xyz valid pad, one column a chunk)."""
    tbl = to_numpy(ws.tbl)
    Tp = tbl.shape[1]
    wp = tbl.T.reshape(Tp, 3, 4)
    blk = np.zeros((Tp, 6, 8), np.float32)
    blk[:, 0:3, 0:4] = wp
    blk[:, 3:6, 4:7] = wp[:, :, 0:3]
    jtbl = blk.reshape(ws.n_chunks, ws.chunk, 6, 8).transpose(3, 0, 2, 1).reshape(8, -1)
    boxes = np.zeros((8, 128), np.float32)
    boxes[0:3], boxes[3:6] = F32_MAX, -F32_MAX
    boxes[0:6, :ws.n_chunks] = to_numpy(ws.boxes).T
    boxes[6, :ws.n_chunks] = 1.0
    eps = {e: np.broadcast_to(to_numpy(x), (8, Tp)) for e, x in ((1e-5, ws.eps_closest), (1e-6, ws.eps_any))}
    return jtbl, eps, boxes


@pytest.mark.parametrize("which", ["random", "veach"])
def test_pack_woop_table_matches_jax(rng, veach_scene, which):
    """tbl, eps, boxes and the chunk count, laid out as mcpt_tpu lays them
    out, equal mcpt_tpu's, except row 3 of tbl: p = -W v0 is a 3-term dot
    product that XLA sums in its own order, so it is held to 4 ulps of the
    largest |W||v0| term."""
    from mcpt_tpu.ops.pallas.woop import _auto_chunk, pack_woop_table as jpack
    from mcpt_tpu_torch.ops.woop import auto_chunk, pack_woop_table as tpack

    if which == "random":
        _, v0, e1, e2 = _random_tri_scene(rng, 600)
        v0, e1, e2 = (np.asarray(x, np.float32) for x in (v0, e1, e2))
    else:
        g = veach_scene.geom
        v0, e1, e2 = (np.array(x) for x in (g.v0, g.e1, g.e2))
    chunk = _auto_chunk(v0.shape[0])
    assert auto_chunk(v0.shape[0]) == chunk
    ws = tpack(torch.from_numpy(v0), torch.from_numpy(e1), torch.from_numpy(e2))
    assert ws.chunk == chunk and ws.n_tris == v0.shape[0]
    g_tbl, g_eps, g_boxes = _jax_layout(ws)
    for eps in (1e-5, 1e-6):
        want = jpack(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), eps, chunk=chunk)
        assert ws.n_chunks == want[3]
        np.testing.assert_array_equal(g_eps[eps], np.asarray(want[1]))
        np.testing.assert_array_equal(g_boxes, np.asarray(want[2]))
        w = np.asarray(want[0])
        rows = [0, 1, 2, 4, 5, 6, 7]
        np.testing.assert_array_equal(g_tbl[rows], w[rows])
        atol = 4 * 2.0**-24 * np.abs(w[0:3]).sum(axis=0).max() * np.abs(v0).max()
        np.testing.assert_allclose(g_tbl[3], w[3], rtol=0, atol=atol)


@pytest.mark.parametrize("tile", [128, 256])
def test_tile_chunk_mask_matches_jax(rng, veach_scene, tile):
    """The per-tile chunk bitmask equals mcpt_tpu's _tile_chunk_mask at the same tile size."""
    from mcpt_tpu.ops.pallas.woop import _pack_rays, _tile_chunk_mask, pack_woop_table as jpack
    from mcpt_tpu_torch.ops.woop import pack_rays, tile_chunk_mask

    g = veach_scene.geom
    tbl, eps, boxes, n_chunks = jpack(g.v0, g.e1, g.e2, 1e-6, chunk=512)
    o, d, t_max = _veach_rays(veach_scene, rng, R=2000)
    jr, _, _ = _pack_rays(jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), tile)
    want = np.asarray(_tile_chunk_mask(jr, boxes, n_chunks, tile))
    port_boxes = torch.from_numpy(np.array(boxes)[0:6, :n_chunks].T.copy())
    got = tile_chunk_mask(pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-3, torch.from_numpy(t_max)),
                          port_boxes, tile)
    np.testing.assert_array_equal(to_numpy(got), want)
    assert (want != 0).any() and (want != (1 << n_chunks) - 1).any()


def _woop_inputs(request, rng, which):
    if which == "random600":
        jscene, *_ = _random_tri_scene(rng, 600)
        o, d = _rays(rng, 512)
        t_max = rng.uniform(0.5, 6.0, 512).astype(np.float32)
    else:
        jscene = request.getfixturevalue("veach_scene")
        o, d, t_max = _veach_rays(jscene, rng)
    return jscene, torch_scene(jscene), o, d, t_max


@pytest.mark.parametrize("which", ["random600", "veach"])
def test_plain_closest_matches_jax_fused_kernel(request, rng, which):
    from mcpt_tpu.ops.pallas.woop import closest_hit_woop_fused
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.ops.woop import closest_hit_woop

    jscene, tscene, o, d, _ = _woop_inputs(request, rng, which)
    t_min = 1e-4 * jscene.scale
    ref = closest_hit_woop_fused(jscene, jnp.asarray(o), jnp.asarray(d), t_min=t_min, interpret=True)
    calls = dict(woop.PLAIN_CALLS)
    t, tri, u, v = closest_hit_woop(tscene.woop, torch.from_numpy(o), torch.from_numpy(d), t_min, F32_MAX)
    assert woop.PLAIN_CALLS["closest"] == calls["closest"] + 1  # CPU tensors take the plain version
    rtri, rt = np.array(ref.tri), np.asarray(ref.t)
    rtri[[5, 700] if which == "veach" else []] = -1  # parked lanes: the port tests nothing
    same = to_numpy(tri) == rtri
    assert same.mean() > 0.99, (~same).sum()
    sel = same & (rtri >= 0)
    assert sel.sum() > 50
    np.testing.assert_allclose(to_numpy(t)[sel], rt[sel], rtol=1e-6, atol=1e-6 * jscene.scale)
    np.testing.assert_allclose(to_numpy(u)[sel], np.asarray(ref.u)[sel], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_numpy(v)[sel], np.asarray(ref.v)[sel], rtol=0, atol=1e-4)
    assert (to_numpy(u)[sel] >= -1e-6).all() and (to_numpy(v)[sel] >= -1e-6).all()
    miss = to_numpy(tri) < 0
    assert (to_numpy(t)[miss] == F32_MAX).all() and (to_numpy(u)[miss] == 0).all()


@pytest.mark.parametrize("which", ["random600", "veach"])
def test_plain_any_matches_jax_fused_kernel(request, rng, which):
    from mcpt_tpu.ops.pallas.woop import any_hit_woop_fused
    from mcpt_tpu_torch.ops.woop import any_hit_woop

    jscene, tscene, o, d, t_max = _woop_inputs(request, rng, which)
    t_min = 1e-4 * jscene.scale
    ref = np.array(any_hit_woop_fused(jscene, jnp.asarray(o), jnp.asarray(d), t_min=t_min,
                                        t_max=jnp.asarray(t_max), interpret=True))
    if which == "veach":
        ref[[5, 700, 9]] = False  # parked lanes and the empty interval test nothing
    got = to_numpy(any_hit_woop(tscene.woop, torch.from_numpy(o), torch.from_numpy(d), t_min,
                                torch.from_numpy(t_max)))
    assert (got == ref).mean() > 0.99
    assert 0.05 < ref.mean() < 0.95


def test_dense_bruteforce_matches_jax(rng, cornell_scene):
    """Dense Moller-Trumbore: ids agree on > 99.9 % of rays; t at rtol 1e-6
    plus 1e-6 of the scene diagonal (sums over xyz in another order)."""
    from mcpt_tpu.ops.intersect import any_hit_bruteforce as jany, closest_hit_bruteforce as jclosest
    from mcpt_tpu_torch.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce

    jscene, *_ = _random_tri_scene(rng, 300)
    for js in (jscene, cornell_scene):
        ts = torch_scene(js)
        o, d = _rays(rng, 1024, -js.scale / 3, js.scale / 3)
        ref = jclosest(js, jnp.asarray(o), jnp.asarray(d), chunk=128)
        hit = closest_hit_bruteforce(ts, torch.from_numpy(o), torch.from_numpy(d), chunk=128)
        same = to_numpy(hit.tri) == np.asarray(ref.tri)
        assert same.mean() > 0.999
        sel = same & (np.asarray(ref.tri) >= 0)
        np.testing.assert_allclose(to_numpy(hit.t)[sel], np.asarray(ref.t)[sel], rtol=1e-6,
                                   atol=1e-6 * js.scale)
        t_max = js.scale * 0.3
        ra = np.asarray(jany(js, jnp.asarray(o), jnp.asarray(d), t_max=t_max))
        ga = to_numpy(any_hit_bruteforce(ts, torch.from_numpy(o), torch.from_numpy(d), t_max=t_max))
        assert (ra == ga).mean() > 0.999


def test_interval_and_degenerate_triangle():
    """Open t_max for closest hit, closed for any hit; a zero-area triangle
    never accepts (tests/test_woop.py's cases, on the Woop plain versions)."""
    from mcpt_tpu_torch.ops.woop import any_hit_woop, pack_woop_table, closest_hit_woop

    def ws_of(v0, e1, e2):
        return pack_woop_table(*(torch.tensor([x], dtype=torch.float32) for x in (v0, e1, e2)))

    ws = ws_of([-1.0, -1.0, 0.0], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0])
    o, d = torch.tensor([[0.0, 0.0, -1.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    assert closest_hit_woop(ws, o, d, 1e-4, 2.0)[1][0] == 0
    assert closest_hit_woop(ws, o, d, 1e-4, 1.0)[1][0] == -1  # open
    assert bool(any_hit_woop(ws, o, d, 1e-4, 1.0)[0])  # closed
    assert not bool(any_hit_woop(ws, o, d, 1e-4, 0.5)[0])
    degen = ws_of([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0])
    assert closest_hit_woop(degen, o, d, 1e-4, F32_MAX)[1][0] == -1
    assert not bool(any_hit_woop(degen, o, d, 1e-4, F32_MAX)[0])


def test_dispatch_by_triangle_count(cornell_scene, veach_scene, rng):
    """Dense wave up to 256 triangles, the Woop pair up to 4,096, the BVH
    traversal pair above (with kernel u/v, so the slim expander)."""
    from mcpt_tpu_torch.ops import intersect, traverse, woop
    from mcpt_tpu_torch.ops.woop import pack_woop_table

    assert not intersect.uses_woop_kernel(torch_scene(cornell_scene))
    assert intersect.uses_woop_kernel(torch_scene(veach_scene))
    jbig, *_ = _random_tri_scene(np.random.default_rng(5), 5000)
    big = torch_scene(dataclasses.replace(jbig, bvh=None))
    assert big.trav is None and not intersect.uses_woop_kernel(big)
    from mcpt_tpu_torch.ops.bvh import attach_bvh
    from mcpt_tpu_torch.scene import finalize_scene, to_device

    host = dataclasses.replace(big, geom=dataclasses.replace(
        big.geom, **{k: to_numpy(getattr(big.geom, k)) for k in ("v0", "e1", "e2", "vn", "uv", "mat_id", "area")}),
        light_tris=np.zeros(0, np.int32))
    big = finalize_scene(to_device(attach_bvh(host), "cpu"))
    assert intersect.uses_traversal_kernel(big) and intersect.dispatch_returns_uv(big)
    calls = (dict(traverse.PLAIN_CALLS), dict(woop.PLAIN_CALLS))
    hit = intersect.closest_hit(big, torch.zeros((1, 3)), torch.ones((1, 3)) / 3 ** 0.5)
    assert hit.u is not None and hit.v is not None
    intersect.any_hit(big, torch.zeros((1, 3)), torch.ones((1, 3)) / 3 ** 0.5, t_max=1.0)
    assert traverse.PLAIN_CALLS == {k: calls[0][k] + 1 for k in calls[0]}
    assert woop.PLAIN_CALLS == calls[1]
    with pytest.raises(ValueError, match="32-bit chunk mask"):
        pack_woop_table(*(torch.from_numpy(x.astype(np.float32)) for x in rng.random((3, 33 * 1024, 3))))


def test_kernel_wrappers_take_only_cuda_tensors(veach_scene):
    """The kernel entry points raise on CPU tensors instead of falling back."""
    from mcpt_tpu_torch.ops import woop

    ws = torch_scene(veach_scene).woop
    rays = woop.pack_rays(torch.zeros((4, 3)), torch.ones((4, 3)), 1e-3, 1.0)
    mask = woop.tile_chunk_mask(rays, ws.boxes)
    launches = dict(woop.LAUNCHES)
    for fn in (woop.closest_hit_woop_kernel, woop.any_hit_woop_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(ws, rays, mask)
    assert woop.LAUNCHES == launches


PRETEST_SEEDS = [21, 22, 23, 24]


def _exact_any(ws, rays):
    """(accept, t) [R, Tp] of the exact any-hit predicate of every pair, as
    any_hit_woop_plain computes it (no chunk mask)."""
    from mcpt_tpu_torch.ops import woop

    acc, ts = [], []
    for c in range(ws.n_chunks):
        t, u, v, ok = woop._project(rays, ws.tbl, ws.eps_any, c, ws.chunk)
        acc.append(ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0) & (t >= rays[:, 3:4])
                   & (t <= rays[:, 7:8]))
        ts.append(t)
    return torch.cat(acc, dim=1), torch.cat(ts, dim=1)


def _adversarial_rays(rng, ws, v0, e1, e2, R):
    """Rays aimed at a vertex, an edge point or an interior point of a random
    triangle; a quarter of them graze its plane with |d'_z| within a few
    ulps of eps (|n . d| at 1e-6); t_lo and t_hi around the hit, or set to
    the exact path's own t of the aimed pair, so that t == t_lo or t ==
    t_hi."""
    from mcpt_tpu_torch.ops.woop import pack_rays

    T = v0.shape[0]
    tri = rng.integers(0, T, R)
    kind = rng.integers(0, 3, R)
    a, b = rng.random(R), rng.random(R)
    corner = rng.integers(0, 3, R)
    uv_vertex = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])[corner]
    uv_edge = np.stack([np.where(corner == 0, a, np.where(corner == 1, 0.0, a)),
                        np.where(corner == 0, 0.0, np.where(corner == 1, a, 1.0 - a))], axis=1)
    uv_in = np.stack([a * (1 - b), a * b], axis=1)
    uv = np.where((kind == 0)[:, None], uv_vertex, np.where((kind == 1)[:, None], uv_edge, uv_in))
    p0, f1, f2 = (x[tri].astype(np.float64) for x in (v0, e1, e2))
    target = p0 + uv[:, 0:1] * f1 + uv[:, 1:2] * f2
    n = np.cross(f1, f2)
    nn = np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    graze = rng.random(R) < 0.25
    inplane = d - (d * n).sum(1, keepdims=True) * n / nn**2
    inplane /= np.linalg.norm(inplane, axis=1, keepdims=True)
    beta = 1e-6 / nn[:, 0] * (1.0 + rng.integers(-8, 9, R) * 2.0**-22)
    d = np.where(graze[:, None], inplane + beta[:, None] * n / nn, d)
    extent = np.abs(np.concatenate([v0, v0 + e1, v0 + e2])).max()
    dist = extent * 10.0 ** rng.uniform(-3, 0.5, R)
    o = (target - d * dist[:, None]).astype(np.float32)
    d = d.astype(np.float32)
    lo = np.full(R, 1e-4 * extent, np.float32)
    hi = (dist * np.where(rng.random(R) < 0.5, 1.01, 1 - 1e-3)).astype(np.float32)
    rays = pack_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo), torch.from_numpy(hi))
    # the exact path's t of the aimed pair becomes t_lo or t_hi of half of them
    t_aim = _exact_any(ws, rays)[1][torch.arange(R), torch.from_numpy(tri)]
    mode = torch.from_numpy(rng.integers(0, 4, R))
    ok = torch.isfinite(t_aim) & (t_aim > 1e-3 * extent)
    rays[:, 7] = torch.where(ok & (mode == 0), t_aim, rays[:, 7])
    rays[:, 3] = torch.where(ok & (mode == 1), t_aim, rays[:, 3])
    rays[:, 7] = torch.where(ok & (mode == 1), 2 * t_aim, rays[:, 7])
    return rays


@pytest.mark.parametrize("which", ["veach", "soup"])
def test_any_pretest_never_rejects_an_accepted_pair(veach_scene, which):
    """The any-hit kernel's division-free interval pre-test (ops/woop.py
    mirror of csrc/woop.cu) rejects no pair that the exact predicate
    accepts, on rays aimed at vertices and edges, grazing at |d'_z| ~ eps,
    and with the hit at exactly t_lo or t_hi; on veach's own triangles and
    on a soup of triangles from 1e-3 to 1e2 across. It rejects no pair of a
    ray with t_lo = 0 (not an ordinary ray)."""
    from mcpt_tpu_torch.ops.woop import any_pretest_rejects, pack_woop_table

    at_lo = at_hi = accepted = rejected = 0
    for seed in PRETEST_SEEDS:
        rng = np.random.default_rng(seed)
        if which == "veach":
            g = veach_scene.geom
            v0, e1, e2 = (np.asarray(x, np.float32) for x in (g.v0, g.e1, g.e2))
        else:
            T = 600
            size = 10.0 ** rng.uniform(-3, 2, (T, 1))
            v0 = rng.uniform(-50, 50, (T, 3)).astype(np.float32)
            e1 = (rng.normal(size=(T, 3)) * size).astype(np.float32)
            e2 = (rng.normal(size=(T, 3)) * size).astype(np.float32)
        ws = pack_woop_table(*(torch.from_numpy(np.array(x)) for x in (v0, e1, e2)))
        for _ in range(2):
            rays = _adversarial_rays(rng, ws, v0, e1, e2, 512)
            acc, t = _exact_any(ws, rays)
            rej = any_pretest_rejects(ws, rays)
            bad = rej & acc
            assert not bool(bad.any()), torch.nonzero(bad)[:5]
            rejected += int(rej.sum())
            accepted += int(acc.sum())
            at_lo += int((acc & (t == rays[:, 3:4])).sum())
            at_hi += int((acc & (t == rays[:, 7:8])).sum())
            rays[:, 3] = 0.0
            assert not bool(any_pretest_rejects(ws, rays).any())
    assert accepted > 500 and at_lo > 20 and at_hi > 20, (accepted, at_lo, at_hi)
    assert rejected > 0


def _exact_closest(ws, rays):
    """(accept, t) [R, Tp] of the exact closest-hit predicate of every pair
    as closest_hit_woop_plain computes it, before the running best (no chunk
    mask): t in [t_lo, t_hi), u, v, 1 - u - v >= 0."""
    from mcpt_tpu_torch.ops import woop

    acc, ts = [], []
    for c in range(ws.n_chunks):
        t, u, v, ok = woop._project(rays, ws.tbl, ws.eps_closest, c, ws.chunk)
        acc.append(ok & (t >= rays[:, 3:4]) & (t < rays[:, 7:8]) & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0))
        ts.append(t)
    return torch.cat(acc, dim=1), torch.cat(ts, dim=1)


@pytest.mark.parametrize("which", ["veach", "soup"])
def test_closest_pretest_never_rejects_a_winning_pair(veach_scene, which):
    """The closest-hit kernel's division-free interval pre-test against
    [t_lo, best_t] (ops/woop.py mirror of csrc/woop.cu) rejects no pair
    that the exact closest predicate accepts below the given best_t, on
    test_any_pretest_never_rejects_an_accepted_pair's adversarial rays
    (aimed at vertices and edges, grazing at |d'_z| ~ eps, hits at exactly
    t_lo or t_hi), with best_t at t_hi, at the t of the ray's farthest
    accepted pair (a hit at exactly best_t), one ulp above it (a hit one ulp
    below best_t, which must win) and anywhere in [t_lo, t_hi]. It rejects no pair of a ray with
    t_lo = 0 (not an ordinary ray)."""
    from mcpt_tpu_torch.ops.woop import closest_pretest_rejects, pack_woop_table

    at_lo = at_best = below_best = winners = rejected = 0
    for seed in PRETEST_SEEDS:
        rng = np.random.default_rng(seed)
        if which == "veach":
            g = veach_scene.geom
            v0, e1, e2 = (np.asarray(x, np.float32) for x in (g.v0, g.e1, g.e2))
        else:
            T = 600
            size = 10.0 ** rng.uniform(-3, 2, (T, 1))
            v0 = rng.uniform(-50, 50, (T, 3)).astype(np.float32)
            e1 = (rng.normal(size=(T, 3)) * size).astype(np.float32)
            e2 = (rng.normal(size=(T, 3)) * size).astype(np.float32)
        ws = pack_woop_table(*(torch.from_numpy(np.array(x)) for x in (v0, e1, e2)))
        for _ in range(2):
            R = 512
            rays = _adversarial_rays(rng, ws, v0, e1, e2, R)
            acc, t = _exact_closest(ws, rays)
            # the t of the ray's farthest accepted pair (-1 without one)
            t_aim = torch.where(acc, t, -1.0).amax(dim=1)
            lo, hi = rays[:, 3], rays[:, 7]
            mode = torch.from_numpy(rng.integers(0, 4, R))
            anywhere = lo + (hi - lo) * torch.from_numpy(rng.random(R).astype(np.float32))
            has = t_aim >= lo
            best = torch.where(mode == 0, hi, anywhere)
            best = torch.where(has & (mode == 1), t_aim, best)
            best = torch.where(has & (mode == 2), torch.minimum(torch.nextafter(t_aim, hi), hi), best)
            best = best[:, None]
            win = acc & (t < best)
            rej = closest_pretest_rejects(ws, rays, best)
            bad = rej & win
            assert not bool(bad.any()), torch.nonzero(bad)[:5]
            rejected += int(rej.sum())
            winners += int(win.sum())
            at_lo += int((win & (t == rays[:, 3:4])).sum())
            at_best += int((acc & (t == best)).sum())
            below_best += int((win & (torch.nextafter(t, torch.tensor(np.inf)) == best)).sum())
            rays[:, 3] = 0.0
            assert not bool(closest_pretest_rejects(ws, rays, best).any())
    assert winners > 500 and at_lo > 20 and at_best > 20 and below_best > 20, (winners, at_lo, at_best, below_best)
    assert rejected > 0
