"""The port's schedule-fed treelet traversal (ops/schedule.py) against
mcpt_tpu's on the CPU.

  * The pre-pass's plain version equals mcpt_tpu's build_schedule bit for
    bit (keys, incomplete tiles, live counts), at v = 512 and at v = 64,
    where tiles overflow and are blanked.
  * The plain walks, through the wrappers with their exact fallback, equal
    the port's BVH traversal bit for bit (same Moller-Trumbore, same
    (min t, lowest id) rule), and the kernel's walk and the reference walk
    agree with mcpt_tpu's treelet kernel in interpret mode and with the
    dense brute force: triangle ids on >= 99.9 % of rays (XLA sums the dot
    products in its own order, so a grazing ray can flip), t within rtol
    1e-6 + 1e-6 of the scene size, (u, v) within 1e-4
    (tests/test_torch_traverse.py's tolerances).
Soups of <= 3,000 triangles at c = 16, s_b = 8; rays from this module's own
generators.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import soup_rays, to_numpy, treelet_soup

F32_MAX = float(np.finfo(np.float32).max)
SCALE = 10.0  # the soups' extent


@pytest.fixture(scope="module")
def soup():
    return treelet_soup(np.random.default_rng(11), 3000, 16, 8)


def _rays(seed, R):
    """Soup rays with parked lanes (|o| = 1e30), empty intervals and finite
    t_max on some: (o, d, t_max)."""
    rng = np.random.default_rng(seed)
    o, d = soup_rays(rng, R)
    o[R // 3: R // 3 + 40] = 1e30
    t_max = np.full(R, F32_MAX, np.float32)
    k = slice(R // 2, R // 2 + R // 8)
    t_max[k] = rng.uniform(0.0, 4.0, R // 8)
    t_max[R // 2] = 0.0
    return o, d, t_max


def port_sort(port, o, d):
    from mcpt_tpu_torch.ops.traverse import ray_sort_order

    return ray_sort_order(port.trav, torch.from_numpy(o), torch.from_numpy(d))


def _packed(o, d, t_max):
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.woop import pack_rays

    return pad_tiles(pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-4, torch.from_numpy(t_max)))


@pytest.mark.parametrize("v", [512, 64])
@pytest.mark.parametrize("seed", [1, 2])
def test_prepass_matches_jax(soup, v, seed):
    from mcpt_tpu.ops.pallas.schedule import build_schedule as jax_build
    from mcpt_tpu.ops.pallas.traverse import _pack_rays
    from mcpt_tpu_torch.ops import schedule as S

    jax_scene, port, *_ = soup
    o, d, t_max = _rays(seed, 1900)  # ragged: 15 tiles, the last one part padding
    order = to_numpy(port_sort(port, o, d))  # the pre-pass takes sorted rays
    o, d, t_max = o[order], d[order], t_max[order]
    jr, _, _ = _pack_rays(jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_max), 128)
    js, ji, jn = jax_build(jax_scene.treelets, jr, 128, v)
    ps, pi, pn = S.build_schedule_plain(port.treelets, _packed(o, d, t_max), v)
    np.testing.assert_array_equal(to_numpy(ps), np.asarray(js).reshape(ps.shape))
    np.testing.assert_array_equal(to_numpy(pi), np.asarray(ji))
    np.testing.assert_array_equal(to_numpy(pn), np.asarray(jn))
    assert bool(pi.any()) == (v == 64) and int(pn.min()) < int(pn.max())


def test_prepass_does_not_depend_on_the_chunk(soup, monkeypatch):
    from mcpt_tpu_torch.ops import schedule as S

    _, port, *_ = soup
    rays = _packed(*_rays(3, 1280))
    want = S.build_schedule_plain(port.treelets, rays, 512)
    monkeypatch.setattr(S, "_PREPASS_PAIRS", 3 * port.treelets.g)  # 3 tiles a chunk
    for a, b in zip(S.build_schedule_plain(port.treelets, rays, 512), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("v", [512, 64])
def test_wrappers_equal_the_bvh_traversal(soup, v):
    """Closest and any hit, the fallback taking the incomplete tiles at
    v = 64: bit for bit the port's BVH walk, ragged batch, parked lanes,
    t bounds."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import traverse as tv

    _, port, *_ = soup
    o, d, t_max = _rays(4 + v, 1500)
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-4)
    plain = dict(tv.PLAIN_CALLS)
    got = S.closest_hit_schedule(port, *args, torch.from_numpy(t_max), v=v)
    assert (tv.PLAIN_CALLS["closest"] > plain["closest"]) == (v == 64)  # the fallback ran
    want = tv.closest_hit_traverse(port.trav, *args, torch.from_numpy(t_max))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0.3 < float((got[1] >= 0).float().mean()) < 0.95
    assert (to_numpy(got[1])[1500 // 3: 1500 // 3 + 40] == -1).all() and int(got[1][750]) == -1
    t_any = torch.from_numpy(np.minimum(t_max, 3.0))
    ga = S.any_hit_schedule(port, *args, t_any, v=v)
    assert torch.equal(ga, tv.any_hit_traverse(port.trav, *args, t_any))
    assert 0.1 < float(ga.float().mean()) < 0.9


def test_plain_walks_match_jax_treelet_kernel_and_bruteforce(soup):
    """The plain walks, the kernels' (per-ray walks of each scheduled
    treelet's sub-BVH) and the reference (packet) walk, with no fallback (v
    = 512 leaves every tile complete), against mcpt_tpu's treelet kernel in
    interpret mode and the dense brute force."""
    from mcpt_tpu.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce
    from mcpt_tpu.ops.pallas.traverse import any_hit_treelets, closest_hit_treelets
    from mcpt_tpu_torch.ops import schedule as S
    from tests.test_treelets import _dense_scene

    jax_scene, port, v0, e1, e2 = soup
    o, d, t_max = _rays(9, 1024)
    order = to_numpy(port_sort(port, o, d))
    o, d, t_max = o[order], d[order], t_max[order]
    rays = _packed(o, d, t_max)
    sched, inc, _ = S.build_schedule(port.treelets, rays, 512)
    assert not bool(inc.any())
    jargs = (jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_max))
    ref = closest_hit_treelets(jax_scene, *jargs, ray_tile=128, interpret=True, sort_rays=False)
    dense = closest_hit_bruteforce(_dense_scene(v0, e1, e2), *jargs)
    t_any = np.minimum(t_max, 3.0).astype(np.float32)
    rays_a = _packed(o, d, t_any)
    sched_a, _, _ = S.build_schedule(port.treelets, rays_a, 512)
    jargs_a = (jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_any))
    wants_a = (any_hit_treelets(jax_scene, *jargs_a, ray_tile=128, interpret=True, sort_rays=False),
               any_hit_bruteforce(_dense_scene(v0, e1, e2), *jargs_a))
    for closest, anyhit in ((S.closest_hit_schedule_plain, S.any_hit_schedule_plain),
                            (S.closest_hit_schedule_packet_plain, S.any_hit_schedule_packet_plain)):
        counts = {}
        t, tri, u, v = closest(port.treelets, port.trav, rays, sched, counts)
        assert counts["treelet_visits"] > 8 and counts["tri_tests"] > 0
        tri = to_numpy(tri)
        for name, want in (("treelet kernel", ref), ("brute force", dense)):
            rtri = np.asarray(want.tri)
            same = tri == rtri
            assert same.mean() >= 0.999, f"{closest.__name__} against the {name}: {(~same).sum()} ids differ"
            sel = same & (rtri >= 0)
            np.testing.assert_allclose(to_numpy(t)[sel], np.asarray(want.t)[sel], rtol=1e-6, atol=1e-6 * SCALE)
        sel = (tri == np.asarray(ref.tri)) & (tri >= 0)
        np.testing.assert_allclose(to_numpy(u)[sel], np.asarray(ref.u)[sel], rtol=0, atol=1e-4)
        np.testing.assert_allclose(to_numpy(v)[sel], np.asarray(ref.v)[sel], rtol=0, atol=1e-4)

        got = to_numpy(anyhit(port.treelets, port.trav, rays_a, sched_a))[:1024]
        for want in wants_a:
            assert (got == np.asarray(want)).mean() >= 0.999, anyhit.__name__


def test_early_exit_and_fallback_cases(soup):
    """A tile whose closest hits lie in its first treelet stops early (fewer
    visits than live keys); an empty schedule row tests nothing; a blanked
    (incomplete) row tests nothing, and the wrapper's fallback answers."""
    from mcpt_tpu_torch.ops import schedule as S

    _, port, *_ = soup
    o = np.zeros((128, 3), np.float32)
    o[:] = (0.0, 0.0, -7.0)  # one bundle from outside the soup, into it
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (128, 1))
    d[:, 0:2] = np.random.default_rng(5).uniform(-0.02, 0.02, (128, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = _packed(o, d, np.full(128, F32_MAX, np.float32))
    sched, _, n_live = S.build_schedule(port.treelets, rays, 512)
    counts = {}
    out = S.closest_hit_schedule_plain(port.treelets, port.trav, rays, sched, counts)
    assert bool((out[1] >= 0).all()) and counts["treelet_visits"] < int(n_live[0])
    blank = torch.full_like(sched, S.KEY_MISS)
    counts = {}
    out = S.closest_hit_schedule_plain(port.treelets, port.trav, rays, blank, counts)
    assert bool((out[1] == -1).all()) and counts.get("treelet_visits", 0) == 0
    assert not bool(S.any_hit_schedule_plain(port.treelets, port.trav, rays, blank).any())


def test_kernel_wrappers_refuse_cpu_tensors(soup):
    from mcpt_tpu_torch.ops import schedule as S

    _, port, *_ = soup
    rays = _packed(*_rays(6, 256))
    sched, _, _ = S.build_schedule(port.treelets, rays, 512)
    launches = dict(S.LAUNCHES)
    for fn in (S.closest_hit_schedule_kernel, S.any_hit_schedule_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(port.treelets, port.trav, rays, sched)
    with pytest.raises(ValueError, match="CUDA"):
        S.build_schedule_kernel(port.treelets, rays, 512)
    assert S.LAUNCHES == launches


@pytest.mark.parametrize("R", [0, 1])
def test_empty_and_single_ray_batches(soup, R):
    """Both treelet routes on 0 rays and on 1 ray (a tile of 127 pads)."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops import traverse as tv

    _, port, *_ = soup
    o, d = (torch.from_numpy(x) for x in soup_rays(np.random.default_rng(R), 4))
    o, d = o[1:1 + R], d[1:1 + R]
    want = tv.closest_hit_traverse(port.trav, o, d, 1e-4, F32_MAX)
    for fn in (S.closest_hit_schedule, SL.closest_hit_select):
        got = fn(port, o, d, 1e-4, F32_MAX)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) and got[0].shape == (R,)
    want = tv.any_hit_traverse(port.trav, o, d, 1e-4, 5.0)
    for fn in (S.any_hit_schedule, SL.any_hit_select):
        got = fn(port, o, d, 1e-4, 5.0)
        assert torch.equal(got, want) and got.dtype == torch.bool
