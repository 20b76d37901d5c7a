"""The port's superblock-select treelet traversal (ops/select.py: the plain
version of the select kernels, per-ray walks of each staged treelet) and
the MCPT_TREELET_SELECT=smem route against mcpt_tpu on the CPU
(tests/test_torch_select_walk.py holds the walk against the reference
walk).

mcpt_tpu's select kernels (ops/pallas/select.py) have no interpret mode;
they compute the same hits as its voted treelet kernel, which does, so the
plain walks are held against that kernel in interpret mode and the dense
brute force (ids on >= 99.9 % of rays, t within rtol 1e-6 + 1e-6 of the
scene size, (u, v) within 1e-4, as in tests/test_torch_schedule.py), and
against the port's BVH traversal bit for bit. The route is checked as
tests/test_torch_traverse.py checks the traversal's: one split_shade
iteration against mcpt_tpu's, and a small render.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import soup_rays, to_numpy, to_torch, torch_scene, treelet_soup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_MAX = float(np.finfo(np.float32).max)
SCALE = 10.0
SEED = 3


@pytest.fixture(scope="module")
def soup():
    return treelet_soup(np.random.default_rng(21), 2500, 16, 8)


def _sorted_rays(port, seed, R):
    from mcpt_tpu_torch.ops.traverse import ray_sort_order

    rng = np.random.default_rng(seed)
    o, d = soup_rays(rng, R)
    o[R // 5: R // 5 + 30] = 1e30  # parked lanes
    t_max = np.full(R, F32_MAX, np.float32)
    t_max[R // 2: R // 2 + R // 8] = rng.uniform(0.0, 4.0, R // 8)
    order = to_numpy(ray_sort_order(port.trav, torch.from_numpy(o), torch.from_numpy(d)))
    return o[order], d[order], t_max[order]


def _packed(o, d, t_max):
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.woop import pack_rays

    return pad_tiles(pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-4, torch.from_numpy(t_max)))


def test_plain_select_matches_jax_treelet_kernel_and_bruteforce(soup):
    from mcpt_tpu.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce
    from mcpt_tpu.ops.pallas.traverse import any_hit_treelets, closest_hit_treelets
    from mcpt_tpu_torch.ops import select as SL
    from tests.test_treelets import _dense_scene

    jax_scene, port, v0, e1, e2 = soup
    o, d, t_max = _sorted_rays(port, 1, 1024)
    counts = {}
    t, tri, u, v = SL.closest_hit_select_plain(port.treelets, port.trav, _packed(o, d, t_max), counts)
    assert counts["treelet_visits"] > 8 and counts["tri_tests"] > 0
    jargs = (jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_max))
    ref = closest_hit_treelets(jax_scene, *jargs, ray_tile=128, interpret=True, sort_rays=False)
    tri = to_numpy(tri)
    for name, want in (("treelet kernel", ref), ("brute force", closest_hit_bruteforce(_dense_scene(v0, e1, e2), *jargs))):
        rtri = np.asarray(want.tri)
        same = tri == rtri
        assert same.mean() >= 0.999, f"{name}: {(~same).sum()} ids differ"
        sel = same & (rtri >= 0)
        np.testing.assert_allclose(to_numpy(t)[sel], np.asarray(want.t)[sel], rtol=1e-6, atol=1e-6 * SCALE)
    sel = (tri == np.asarray(ref.tri)) & (tri >= 0)
    assert 0.3 < sel.mean() < 0.95
    np.testing.assert_allclose(to_numpy(u)[sel], np.asarray(ref.u)[sel], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_numpy(v)[sel], np.asarray(ref.v)[sel], rtol=0, atol=1e-4)

    t_any = np.minimum(t_max, 3.0).astype(np.float32)
    got = to_numpy(SL.any_hit_select_plain(port.treelets, port.trav, _packed(o, d, t_any)))
    jargs = (jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_any))
    for want in (any_hit_treelets(jax_scene, *jargs, ray_tile=128, interpret=True, sort_rays=False),
                 any_hit_bruteforce(_dense_scene(v0, e1, e2), *jargs)):
        assert (got == np.asarray(want)).mean() >= 0.999
    assert 0.1 < got.mean() < 0.9


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_select_equals_the_bvh_traversal(soup, seed):
    """The wrappers (sort, pad to tiles, plain walk, scatter back) against
    the port's BVH walk, bit for bit, on a ragged batch with parked lanes
    and finite t_max."""
    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops import traverse as tv

    _, port, *_ = soup
    rng = np.random.default_rng(seed)
    o, d = soup_rays(rng, 1100)
    o[7:19] = 1e30
    t_max = rng.uniform(0.5, 12.0, 1100).astype(np.float32)
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-4)
    got = SL.closest_hit_select(port, *args, F32_MAX)
    for a, b in zip(got, tv.closest_hit_traverse(port.trav, *args, F32_MAX)):
        assert torch.equal(a, b)
    ga = SL.any_hit_select(port, *args, torch.from_numpy(t_max))
    assert torch.equal(ga, tv.any_hit_traverse(port.trav, *args, torch.from_numpy(t_max)))
    assert (to_numpy(got[1])[7:19] == -1).all() and not to_numpy(ga)[7:19].any()


def test_kernel_wrappers_refuse_cpu_tensors(soup):
    from mcpt_tpu_torch.ops import select as SL

    _, port, *_ = soup
    o, d, t_max = _sorted_rays(port, 5, 256)
    launches = dict(SL.LAUNCHES)
    for fn in (SL.closest_hit_select_kernel, SL.any_hit_select_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(port.treelets, port.trav, _packed(o, d, t_max))
    assert SL.LAUNCHES == launches


@pytest.fixture(scope="module")
def stress(tmp_path_factory):
    """(JAX scene with treelets, the port's scene carrying them across)."""
    sys.path.insert(0, os.path.join(ROOT, "scenes"))
    try:
        import generate
    finally:
        sys.path.pop(0)
    from mcpt_tpu.io.obj import load_scene

    out = tmp_path_factory.mktemp("stress_sel")
    assert generate.gen_stress(str(out), target_tris=6000) == 5986
    js = load_scene(os.path.join(str(out), "bathroom-stress.obj"), with_bvh=True)
    return js, torch_scene(js)


@pytest.fixture
def smem(monkeypatch):
    from mcpt_tpu_torch.ops import intersect

    monkeypatch.setattr(intersect, "TREELET_SELECT", "smem")


def test_dispatch_follows_treelet_select(stress, monkeypatch):
    """vote: the BVH traversal; smem: the select walk; the same hits."""
    from mcpt_tpu_torch.ops import intersect, select, traverse

    _, ts = stress
    rng = np.random.default_rng(8)
    lo, hi = to_numpy(ts.geom.v0).min(0), to_numpy(ts.geom.v0).max(0)
    o = torch.from_numpy((lo + (hi - lo) * rng.random((600, 3))).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(600, 3)).astype(np.float32)), dim=1)
    out = {}
    for mode in ("vote", "smem"):
        monkeypatch.setattr(intersect, "TREELET_SELECT", mode)
        calls = (dict(traverse.PLAIN_CALLS), dict(select.PLAIN_CALLS))
        out[mode] = (intersect.closest_hit(ts, o, d, 1e-3), intersect.any_hit(ts, o, d, 1e-3, 2.0))
        mine, other = (select, traverse) if mode == "smem" else (traverse, select)
        before = calls[0] if mine is traverse else calls[1]
        assert mine.PLAIN_CALLS == {k: before[k] + 1 for k in before}
        assert other.PLAIN_CALLS == (calls[1] if mine is traverse else calls[0])
        assert intersect.dispatch_returns_uv(ts)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(out["vote"][0], f), getattr(out["smem"][0], f))
    assert torch.equal(out["vote"][1], out["smem"][1])


def test_split_shade_one_iteration_matches_jax(stress, smem, monkeypatch):
    """One X step from an identical state, the port's hits taken through the
    select route and mcpt_tpu dispatching to its treelet kernel (the slim
    expander, kernel u/v): integer state bitwise, floats allclose (rtol
    1e-5, atol 1e-6); three steps reach bounce 2 with a pending NEE."""
    from mcpt_tpu.ops import intersect as jax_intersect
    from mcpt_tpu.render import integrator as JI
    from mcpt_tpu_torch.ops import select
    from mcpt_tpu_torch.render import integrator as TI
    from mcpt_tpu_torch.utils.rng import prng_key

    monkeypatch.setattr(jax_intersect, "TRAVERSAL", "treelets")
    jax.clear_caches()  # TRAVERSAL is read at trace time
    js, ts = stress
    w, h = 16, 12
    js = dataclasses.replace(js, camera=dataclasses.replace(js.camera, width=w, height=h))
    ts = dataclasses.replace(ts, camera=dataclasses.replace(ts.camera, width=w, height=h))
    assert jax_intersect.dispatch_returns_uv(js)
    R, spp, mb = w * h, 2, 4
    key = jax.random.PRNGKey(SEED)
    pidx = jnp.arange(R, dtype=jnp.int32)
    st = JI.split_state0(R, spp)
    miss = (jnp.full((R,), F32_MAX), jnp.full((R,), -1, jnp.int32), jnp.zeros((R,)), jnp.zeros((R,)),
            jnp.zeros((R,), bool))
    st, _ = JI.split_shade(js, st, *miss, key, pidx, 0, spp, mb)
    calls = dict(select.PLAIN_CALLS)
    for it in range(3):
        tst = {k: to_torch(v) for k, v in st.items()}
        hits = TI.split_trace(ts, tst["o"].float(), tst["d"].float(), tst["so"].float(),
                              tst["sd"].float(), tst["smax"].float())
        jst, jn = JI.split_shade(js, st, *(jnp.asarray(to_numpy(x)) for x in hits), key, pidx, 0, spp, mb)
        got, tn = TI.split_shade(ts, tst, *hits, prng_key(SEED), to_torch(pidx).long(), 0, spp, mb)
        assert int(tn) == int(jn)
        for k, v in jst.items():
            want, have = np.asarray(v), to_numpy(got[k])
            if want.dtype.kind in "biu":
                np.testing.assert_array_equal(have, want.astype(have.dtype), err_msg=f"iter {it} {k}")
            else:
                np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6, err_msg=f"iter {it} {k}")
        st = jst
    assert select.PLAIN_CALLS["closest"] >= calls["closest"] + 3
    jax.clear_caches()


def test_render_matches_vote_route_and_jax(stress, monkeypatch):
    """32x24, 2 spp, 4 bounces through the select route: the film equals the
    vote route's bit for bit (the hits are the same), and holds
    tests/test_woop.py's render contract against mcpt_tpu's CPU render
    (>= 99 % of components within rtol 1e-3, atol 1e-3; channel means
    within rtol 2e-3)."""
    from mcpt_tpu.render.renderer import RenderConfig as JConfig, Renderer as JRenderer
    from mcpt_tpu_torch.ops import intersect, select
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    js, ts = stress
    films = {}
    for mode in ("vote", "smem"):
        monkeypatch.setattr(intersect, "TREELET_SELECT", mode)
        calls = dict(select.PLAIN_CALLS)
        r = Renderer(ts, RenderConfig(max_bounces=4, width=32, height=24, seed=SEED))
        r.step()
        r.step()
        assert r.stats["nan_scrubbed"] == 0
        assert (select.PLAIN_CALLS["closest"] > calls["closest"]) == (mode == "smem")
        films[mode] = r.film.accum / r.film.spp
    assert torch.equal(films["smem"], films["vote"])
    jr = JRenderer(js, JConfig(max_bounces=4, width=32, height=24, seed=SEED))
    jr.step()
    jr.step()
    a = np.asarray(jr.film.accum) / float(jr.film.spp)
    b = to_numpy(films["smem"])
    assert np.isclose(b, a, rtol=1e-3, atol=1e-3).mean() >= 0.99
    np.testing.assert_allclose(b.mean(axis=(0, 1)), a.mean(axis=(0, 1)), rtol=2e-3)
