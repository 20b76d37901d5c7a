"""The port's BVH traversal (ops/traverse.py) against mcpt_tpu's on the CPU.

Scene: bathroom-stress at target_tris=6000 (5,986 triangles, above the
4,096 where dispatch leaves the Woop pair), written by scenes/generate.py's
gen_stress and loaded by mcpt_tpu.io.obj.load_scene; the port gets the same
triangles through scene_from_arrays.

Tolerances. The port's walk visits the nodes of mcpt_tpu's skip-link walk
(closest_hit_bvh / any_hit_bvh) with the same predicates, but XLA sums the
Moller-Trumbore dot products in its own order, so a grazing ray can flip:
triangle ids and any-hit answers agree on >= 99.9 % of rays, t within
rtol 1e-6 plus 1e-6 of the scene diagonal. The treelet kernel (interpret
mode, <= 512 rays) tests the same pairs in another arrangement; its (u, v)
are held to 1e-4 absolute, as the Woop kernel's are.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import deep_chain, to_numpy, to_torch, torch_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_MAX = float(np.finfo(np.float32).max)
SEED = 3


@pytest.fixture
def rng():
    """Draws of this module's own, whatever ran before on the worker."""
    return np.random.default_rng(20)


@pytest.fixture(scope="module")
def stress_files(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "scenes"))
    try:
        import generate
    finally:
        sys.path.pop(0)
    out = tmp_path_factory.mktemp("stress")
    assert generate.gen_stress(str(out), target_tris=6000) == 5986
    return os.path.join(str(out), "bathroom-stress.obj")


@pytest.fixture(scope="module")
def stress(stress_files):
    """(JAX scene with treelets, the port's scene from its arrays)."""
    from mcpt_tpu.io.obj import load_scene

    js = load_scene(stress_files, with_bvh=True)
    assert js.treelets is not None and js.num_tris == 5986
    return js, torch_scene(js)


def _rays(js, rng, R):
    """Camera rays of a 32x16 image ([0, 512)), axis-parallel rays that
    start on a face of a node's box ([512, 608): 0 * inf = NaN in the slab
    test, and the box is missed), and random rays from inside the room."""
    from mcpt_tpu.render.camera import generate_rays

    lo, hi = np.asarray(js.geom.v0).min(0), np.asarray(js.geom.v0).max(0)
    o = (lo + (hi - lo) * rng.random((R, 3))).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cam = dataclasses.replace(js.camera, width=32, height=16)
    co, cd = generate_rays(cam, jnp.asarray(rng.random((512, 2)), jnp.float32))
    o[:512], d[:512] = np.asarray(co), np.asarray(cd)
    blo, bhi = np.asarray(js.bvh.lo), np.asarray(js.bvh.hi)
    for k, i in enumerate(range(512, 512 + 96)):  # origin on a box face, axis-parallel direction
        n = 1 + k * 7 % (blo.shape[0] - 1)
        a = k % 3
        o[i] = blo[n] + (bhi[n] - blo[n]) * rng.random(3)
        o[i, a] = blo[n, a] if k % 2 else bhi[n, a]
        d[i] = 0.0
        d[i, (a + 1) % 3] = 1.0 if k % 4 < 2 else -1.0
    return o, d


def _pack(o, d, t_min, t_max):
    from mcpt_tpu_torch.ops.woop import pack_rays

    return pack_rays(torch.from_numpy(o), torch.from_numpy(d), t_min, torch.as_tensor(t_max))


def test_plain_closest_matches_jax_bvh_walk(stress, rng):
    from mcpt_tpu.ops.traverse import closest_hit_bvh
    from mcpt_tpu_torch.ops.traverse import closest_hit_traverse_plain

    js, ts = stress
    o, d = _rays(js, rng, 2048)
    t_min = 1e-4 * js.scale
    ref = closest_hit_bvh(js, jnp.asarray(o), jnp.asarray(d), t_min=t_min)
    counts = {}
    t, tri, u, v = closest_hit_traverse_plain(ts.trav, _pack(o, d, t_min, F32_MAX), counts)
    rtri, rt = np.asarray(ref.tri), np.asarray(ref.t)
    same = to_numpy(tri) == rtri
    assert same.mean() >= 0.999, (~same).sum()
    sel = same & (rtri >= 0)
    assert 0.5 < sel.mean() < 1.0
    np.testing.assert_allclose(to_numpy(t)[sel], rt[sel], rtol=1e-6, atol=1e-6 * js.scale)
    assert (to_numpy(u)[sel] >= -1e-6).all() and (to_numpy(v)[sel] >= -1e-6).all()
    miss = to_numpy(tri) < 0
    assert (to_numpy(t)[miss] == F32_MAX).all() and (to_numpy(u)[miss] == 0).all()
    assert counts["node_visits"] > 2048 and counts["tri_tests"] > 0


def test_plain_any_matches_jax_bvh_walk(stress, rng):
    from mcpt_tpu.ops.traverse import any_hit_bvh
    from mcpt_tpu_torch.ops.traverse import any_hit_traverse_plain

    js, ts = stress
    o, d = _rays(js, rng, 2048)
    t_min = 1e-4 * js.scale
    t_max = (js.scale * rng.uniform(0.0, 0.4, 2048)).astype(np.float32)
    t_max[7] = 0.0  # empty interval
    ref = np.asarray(any_hit_bvh(js, jnp.asarray(o), jnp.asarray(d), t_min=t_min, t_max=jnp.asarray(t_max)))
    got = to_numpy(any_hit_traverse_plain(ts.trav, _pack(o, d, t_min, t_max)))
    assert (got == ref).mean() >= 0.999
    assert 0.05 < ref.mean() < 0.95 and not got[7]


def test_slab_nan_misses_the_box():
    """A ray along +x that starts on the box's y = 0 face: (lo - o) * inf is
    NaN, and NaN-propagating min/max make the slab test miss (mcpt_tpu's
    jnp.minimum/maximum); with NaN dropped, as fminf/fmaxf drop it, the box
    would be hit."""
    from mcpt_tpu_torch.ops.traverse import _slab

    nd = torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]])
    o = torch.tensor([[-1.0, 0.0, 0.5]])
    inv = 1.0 / torch.tensor([[1.0, 0.0, 0.0]])
    assert not bool(_slab(nd, o, inv, torch.tensor([0.0]), torch.tensor([10.0]))[0])
    o[0, 1] = 0.5  # inside the slab in y: hit
    assert bool(_slab(nd, o, inv, torch.tensor([0.0]), torch.tensor([10.0]))[0])


def test_plain_matches_jax_treelet_kernel(stress, rng):
    """Both wrappers against the treelet Pallas kernels in interpret mode, on
    384 rays (sorted, 3 tiles of 128): camera rays and random rays. Not the
    rays that start on a node box's face: the treelet layout's boxes are
    other boxes, so there the reference's NaN miss falls elsewhere."""
    from mcpt_tpu.ops.pallas.traverse import any_hit_treelets, closest_hit_treelets
    from mcpt_tpu_torch.ops.traverse import any_hit_traverse, closest_hit_traverse

    js, ts = stress
    o, d = _rays(js, rng, 736)
    keep = np.r_[256:512, 608:736]
    o, d = o[keep], d[keep]
    t_min = 1e-4 * js.scale
    t_max = (js.scale * rng.uniform(0.0, 0.4, o.shape[0])).astype(np.float32)
    ref = closest_hit_treelets(js, jnp.asarray(o), jnp.asarray(d), t_min=t_min, interpret=True)
    t, tri, u, v = closest_hit_traverse(ts.trav, torch.from_numpy(o), torch.from_numpy(d), t_min, F32_MAX)
    rtri = np.asarray(ref.tri)
    same = to_numpy(tri) == rtri
    assert same.mean() >= 0.99, (~same).sum()
    sel = same & (rtri >= 0)
    assert sel.sum() > 100
    np.testing.assert_allclose(to_numpy(t)[sel], np.asarray(ref.t)[sel], rtol=1e-6, atol=1e-6 * js.scale)
    np.testing.assert_allclose(to_numpy(u)[sel], np.asarray(ref.u)[sel], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_numpy(v)[sel], np.asarray(ref.v)[sel], rtol=0, atol=1e-4)
    ra = np.asarray(any_hit_treelets(js, jnp.asarray(o), jnp.asarray(d), t_min=t_min,
                                     t_max=jnp.asarray(t_max), interpret=True))
    ga = to_numpy(any_hit_traverse(ts.trav, torch.from_numpy(o), torch.from_numpy(d), t_min,
                                   torch.from_numpy(t_max)))
    assert (ga == ra).mean() >= 0.99 and 0.05 < ra.mean() < 0.95


def test_ray_sort_order_matches_jax(stress, rng):
    """The permutation equals mcpt_tpu's _ray_sort_order bit for bit, and the
    BVH root box the port reads the bounds from equals the union of the
    valid superblock boxes that mcpt_tpu reads them from."""
    from mcpt_tpu.ops.pallas.traverse import _ray_sort_order
    from mcpt_tpu_torch.ops.traverse import ray_sort_order

    js, ts = stress
    o, d = _rays(js, rng, 4096)
    o[::5] = o[0]  # coincident origins: the direction bits decide
    want = np.asarray(_ray_sort_order(js.treelets, jnp.asarray(o), jnp.asarray(d)))
    got = to_numpy(ray_sort_order(ts.trav, torch.from_numpy(o), torch.from_numpy(d)))
    np.testing.assert_array_equal(got, want)
    sb = np.asarray(js.treelets.sb_box)
    valid = sb[6] > 0
    np.testing.assert_array_equal(to_numpy(ts.trav.nodes[0, 0:3]), sb[0:3, valid].min(axis=1))
    np.testing.assert_array_equal(to_numpy(ts.trav.nodes[0, 4:7]), sb[3:6, valid].max(axis=1))


def test_wrappers_sort_and_take_the_plain_walk_on_cpu(stress, rng):
    """On CPU tensors the wrappers run the kernels' plain walks (the walks
    of the child-pair table; once a call, no launch); sorting and
    scattering back changes no output."""
    from mcpt_tpu_torch.ops import traverse as tv

    js, ts = stress
    o, d = _rays(js, rng, 700)
    t_min, t_max = 1e-4 * js.scale, (js.scale * rng.uniform(0, 0.4, 700)).astype(np.float32)
    plain, launches = dict(tv.PLAIN_CALLS), dict(tv.LAUNCHES)
    got = tv.closest_hit_traverse(ts.trav, torch.from_numpy(o), torch.from_numpy(d), t_min, F32_MAX)
    want = tv.closest_hit_ordered_plain(ts.trav, _pack(o, d, t_min, F32_MAX))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ga = tv.any_hit_traverse(ts.trav, torch.from_numpy(o), torch.from_numpy(d), t_min, torch.from_numpy(t_max))
    assert torch.equal(ga, tv.any_hit_ordered_plain(ts.trav, _pack(o, d, t_min, t_max)))
    assert tv.PLAIN_CALLS == {k: plain[k] + 2 for k in plain} and tv.LAUNCHES == launches
    for fn in (tv.closest_hit_traverse_kernel, tv.any_hit_traverse_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(ts.trav, _pack(o, d, t_min, F32_MAX))
    assert tv.LAUNCHES == launches


def _trav_of(v0, e1, e2):
    """TraversalSet of a few triangles given as lists of rows."""
    from mcpt_tpu_torch.ops.bvh import _build_bvh_sah
    from mcpt_tpu_torch.ops.traverse import pack_traversal
    from mcpt_tpu_torch.scene import FlatBVH

    g = [np.array(x, np.float64) for x in (v0, e1, e2)]
    nodes, perm = _build_bvh_sah(*g)
    return pack_traversal(FlatBVH(**{k: torch.from_numpy(x) for k, x in nodes.items()}),
                          *(torch.from_numpy(x[perm].astype(np.float32)) for x in g))


def test_interval_and_degenerate_triangle():
    """Open t_max for closest hit, closed for any hit; a zero-area triangle
    never accepts (test_torch_woop.py's cases, through the BVH walk; a second
    triangle, off the ray, at z = -0.5 makes the ray enter the leaf's box
    before t_max)."""
    from mcpt_tpu_torch.ops.traverse import any_hit_traverse, closest_hit_traverse

    ts = _trav_of([[-1.0, -1.0, 0.0], [5.0, 5.0, -0.5]], [[2.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                  [[0.0, 2.0, 0.0], [0.0, 1.0, 0.0]])
    o, d = torch.tensor([[0.0, 0.0, -1.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    assert closest_hit_traverse(ts, o, d, 1e-4, 2.0)[1][0] == 0
    assert closest_hit_traverse(ts, o, d, 1e-4, 1.0)[1][0] == -1  # open
    assert bool(any_hit_traverse(ts, o, d, 1e-4, 1.0)[0])  # closed
    assert not bool(any_hit_traverse(ts, o, d, 1e-4, 0.5)[0])
    degen = _trav_of([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [[2.0, 0.0, 0.0]])
    assert closest_hit_traverse(degen, o, d, 1e-4, F32_MAX)[1][0] == -1
    assert not bool(any_hit_traverse(degen, o, d, 1e-4, F32_MAX)[0])


def test_flat_box_at_t_max_is_missed_as_in_jax():
    """The strict slab test culls a flat box that the ray reaches at exactly
    t_max, so an any-hit on its triangle at t == t_max is missed, as in
    mcpt_tpu's any_hit_bvh (and its treelet kernel's entry test); the
    far * 1.001 fudge keeps it just past t_max."""
    from mcpt_tpu.ops.bvh import attach_bvh as jattach
    from mcpt_tpu.ops.traverse import any_hit_bvh
    from mcpt_tpu_torch.ops.traverse import any_hit_traverse
    from tests.test_intersect import _random_tri_scene

    v0, e1, e2 = [[-1.0, -1.0, 0.0]], [[2.0, 0.0, 0.0]], [[0.0, 2.0, 0.0]]
    ts = _trav_of(v0, e1, e2)
    js, *_ = _random_tri_scene(np.random.default_rng(0), 1)
    js = dataclasses.replace(js, geom=dataclasses.replace(
        js.geom, v0=jnp.asarray(v0, jnp.float32), e1=jnp.asarray(e1, jnp.float32),
        e2=jnp.asarray(e2, jnp.float32)))
    js = jattach(js, with_treelets=False)
    o, d = np.array([[0.0, 0.0, -1.0]], np.float32), np.array([[0.0, 0.0, 1.0]], np.float32)
    for t_max, want in ((1.0, False), (1.0005, True)):
        ref = bool(np.asarray(any_hit_bvh(js, jnp.asarray(o), jnp.asarray(d), t_min=1e-4, t_max=t_max))[0])
        got = bool(any_hit_traverse(ts, torch.from_numpy(o), torch.from_numpy(d), 1e-4, t_max)[0])
        assert got == ref == want


@pytest.fixture
def treelet_dispatch(monkeypatch):
    from mcpt_tpu.ops import intersect

    monkeypatch.setattr(intersect, "TRAVERSAL", "treelets")
    jax.clear_caches()  # TRAVERSAL is read at trace time
    yield
    jax.clear_caches()


def test_split_shade_one_iteration_matches_jax(stress, treelet_dispatch):
    """One X step from an identical state, with mcpt_tpu dispatching to the
    treelet kernel (the slim expander, kernel u/v): integer state bitwise,
    floats allclose (rtol 1e-5, atol 1e-6). Both sides get the hits of the
    port's walk; three steps reach bounce 2 with a pending NEE, and the
    textured floor panel is hit."""
    from mcpt_tpu.ops.intersect import dispatch_returns_uv as jax_uv
    from mcpt_tpu.render import integrator as JI
    from mcpt_tpu_torch.render import integrator as TI
    from mcpt_tpu_torch.utils.rng import prng_key

    js, ts = stress
    w, h = 16, 12
    js = dataclasses.replace(js, camera=dataclasses.replace(js.camera, width=w, height=h))
    ts = dataclasses.replace(ts, camera=dataclasses.replace(ts.camera, width=w, height=h))
    assert jax_uv(js)
    R, spp, mb = w * h, 2, 4
    key = jax.random.PRNGKey(SEED)
    pidx = jnp.arange(R, dtype=jnp.int32)
    st = JI.split_state0(R, spp)
    miss = (jnp.full((R,), F32_MAX), jnp.full((R,), -1, jnp.int32), jnp.zeros((R,)), jnp.zeros((R,)),
            jnp.zeros((R,), bool))
    st, _ = JI.split_shade(js, st, *miss, key, pidx, 0, spp, mb)
    textured = 0
    for it in range(3):
        tst = {k: to_torch(v) for k, v in st.items()}
        hits = TI.split_trace(ts, tst["o"].float(), tst["d"].float(), tst["so"].float(),
                              tst["sd"].float(), tst["smax"].float())
        tri = to_numpy(hits[1])
        textured += int((np.asarray(js.mats.tex_id)[np.asarray(js.geom.mat_id)[tri[tri >= 0]]] >= 0).sum())
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
    assert textured > 0


def test_render_matches_jax(stress):
    """32x24, 2 spp, 4 bounces against mcpt_tpu's default CPU route (the
    skip-link BVH walk): >= 99 % of components within rtol 1e-3 (atol
    1e-3) and channel means within rtol 2e-3 (tests/test_woop.py's render
    contract); the same count of traced rays within 1e-3."""
    from mcpt_tpu.ops.intersect import uses_treelets
    from mcpt_tpu.render.renderer import RenderConfig as JConfig, Renderer as JRenderer
    from mcpt_tpu_torch.ops import traverse as tv
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    js, ts = stress
    assert not uses_treelets(js)  # the CPU default is the BVH walk
    jr = JRenderer(js, JConfig(max_bounces=4, width=32, height=24, seed=SEED))
    tr = Renderer(ts, RenderConfig(max_bounces=4, width=32, height=24, seed=SEED))
    plain = dict(tv.PLAIN_CALLS)
    for _ in range(2):
        jr.step()
        tr.step()
    assert tv.PLAIN_CALLS["closest"] > plain["closest"] and tv.PLAIN_CALLS["any"] > plain["any"]
    a = np.asarray(jr.film.accum) / float(jr.film.spp)
    b = to_numpy(tr.film.accum) / tr.film.spp
    assert tr.stats["nan_scrubbed"] == 0 and jr.stats["nan_scrubbed"] == 0
    close = np.isclose(b, a, rtol=1e-3, atol=1e-3).mean()
    assert close >= 0.99, f"only {close:.4f} of components close"
    np.testing.assert_allclose(b.mean(axis=(0, 1)), a.mean(axis=(0, 1)), rtol=2e-3)
    assert tr.stats["traced_rays"] == pytest.approx(jr.stats["traced_rays"], rel=1e-3)


ORDERED_SEEDS = [20, 21]


def _bvh_depths(bvh):
    """Depth (inner nodes above) of every node of a FlatBVH, walked in preorder."""
    count, skip = (to_numpy(getattr(bvh, k)) for k in ("count", "skip"))
    depth = np.zeros(count.shape[0], np.int64)
    for n in range(count.shape[0]):
        if count[n] == 0:
            depth[n + 1] = depth[skip[n + 1]] = depth[n] + 1
    return depth


def _chain_bvh(D):
    """A FlatBVH whose inner nodes form a chain D deep (each inner node's
    left child a one-triangle leaf), and its D + 1 triangles."""
    from mcpt_tpu_torch.scene import FlatBVH

    N = 2 * D + 1
    count = np.zeros(N, np.int32)
    first = np.zeros(N, np.int32)
    skip = np.full(N, -1, np.int32)
    leaves = [2 * k + 1 for k in range(D)] + [2 * D]
    for i, n in enumerate(leaves):
        count[n], first[n] = 1, i
    for k in range(D):
        skip[2 * k + 1] = 2 * k + 2  # a left leaf skips to its sibling
    lo = np.tile(np.float32([0, 0, 0]), (N, 1))
    hi = np.tile(np.float32([1, 1, 1]), (N, 1))
    bvh = FlatBVH(**{k: torch.from_numpy(x) for k, x in
                     (("lo", lo), ("hi", hi), ("first", first), ("count", count), ("skip", skip))})
    tri = torch.tensor([[0.0, 0.0, 0.5]]).repeat(D + 1, 1)
    return bvh, tri, torch.tensor([[1.0, 0.0, 0.0]]).repeat(D + 1, 1), torch.tensor([[0.0, 1.0, 0.0]]).repeat(D + 1, 1)


@pytest.mark.parametrize("which", ["stress", "soup"])
def test_child_pair_table(stress, which):
    """Every row of the child-pair table holds the boxes of inner node n's
    children n+1 and skip[n+1] bit for bit, and their refs; walking the refs
    from the root reaches every leaf of the BVH once; depth is the most inner
    nodes above a leaf. A chain deeper than STACK_SIZE raises ValueError,
    one of STACK_SIZE does not."""
    from mcpt_tpu_torch.ops import traverse as tv

    cases = []
    if which == "stress":
        cases.append((stress[1].bvh, stress[1].trav))
    else:
        for seed in ORDERED_SEEDS:
            ts = _trav_of(*np.random.default_rng(seed).uniform(-1, 1, (3, 300, 3)))
            cases.append((None, ts))
    for bvh, ts in cases:
        nodes = to_numpy(ts.nodes)
        count = nodes[:, 3].view(np.int32) & 7
        skip = nodes[:, 7].view(np.int32)
        inner = np.nonzero(count == 0)[0]
        pairs = to_numpy(ts.pairs)
        assert pairs.shape == (inner.shape[0], 16)
        row_of = {int(n): r for r, n in enumerate(inner)}
        word = nodes[:, 3].view(np.int32)

        def ref(c):
            return row_of[c] * 8 if count[c] == 0 else int(word[c])

        for r, n in enumerate(inner):
            left, right = n + 1, skip[n + 1]
            np.testing.assert_array_equal(pairs[r, 0:3], nodes[left, 0:3])
            np.testing.assert_array_equal(pairs[r, 4:7], nodes[left, 4:7])
            np.testing.assert_array_equal(pairs[r, 8:11], nodes[right, 0:3])
            np.testing.assert_array_equal(pairs[r, 12:15], nodes[right, 4:7])
            assert pairs[r, 3:4].view(np.int32)[0] == ref(left)
            assert pairs[r, 7:8].view(np.int32)[0] == ref(right)
        assert ts.root_ref == ref(0)
        seen, todo = [], [ts.root_ref]
        while todo:
            x = todo.pop()
            if x & 7:
                seen.append(x)
            else:
                todo += [int(v) for v in pairs[x >> 3, [3, 7]].view(np.int32)]
        assert sorted(seen) == sorted(int(w) for w in word[count > 0])
        if bvh is not None:
            np.testing.assert_array_equal(nodes[:, 0:3], to_numpy(bvh.lo))
            assert ts.depth == int(_bvh_depths(bvh)[to_numpy(bvh.count) > 0].max())
    assert tv.pack_traversal(*_chain_bvh(tv.STACK_SIZE)).depth == tv.STACK_SIZE
    with pytest.raises(ValueError, match="deeper"):
        tv.pack_traversal(*_chain_bvh(tv.STACK_SIZE + 1))


@pytest.mark.parametrize("seed", ORDERED_SEEDS)
def test_ordered_closest_matches_jax_bvh_walk(stress, seed):
    """The ordered walk (closest_hit_ordered_plain) against mcpt_tpu's
    closest_hit_bvh, box-face rays included, at
    test_plain_closest_matches_jax_bvh_walk's tolerances."""
    from mcpt_tpu.ops.traverse import closest_hit_bvh
    from mcpt_tpu_torch.ops.traverse import closest_hit_ordered_plain

    js, ts = stress
    o, d = _rays(js, np.random.default_rng(seed), 2048)
    t_min = 1e-4 * js.scale
    ref = closest_hit_bvh(js, jnp.asarray(o), jnp.asarray(d), t_min=t_min)
    counts = {}
    t, tri, u, v = closest_hit_ordered_plain(ts.trav, _pack(o, d, t_min, F32_MAX), counts)
    rtri, rt = np.asarray(ref.tri), np.asarray(ref.t)
    same = to_numpy(tri) == rtri
    assert same.mean() >= 0.999, (~same).sum()
    sel = same & (rtri >= 0)
    assert 0.5 < sel.mean() < 1.0
    np.testing.assert_allclose(to_numpy(t)[sel], rt[sel], rtol=1e-6, atol=1e-6 * js.scale)
    assert (to_numpy(u)[sel] >= -1e-6).all() and (to_numpy(v)[sel] >= -1e-6).all()
    miss = to_numpy(tri) < 0
    assert (to_numpy(t)[miss] == F32_MAX).all() and (to_numpy(u)[miss] == 0).all()
    assert counts["pair_visits"] > 2048 and counts["tri_tests"] > 0


@pytest.mark.parametrize("which", ["stress", "soup"])
def test_ordered_walk_against_skip_link_walk(stress, which):
    """The two closest-hit walks over one BVH: the same triangle except on a
    tie, where each differing ray's two t lie within one ulp of each other;
    where the ids agree, t, u and v are bit for bit the same. The ordered
    walk visits fewer inner rows than the skip-link walk visits nodes."""
    from mcpt_tpu_torch.ops import traverse as tv

    for seed in ORDERED_SEEDS:
        rng = np.random.default_rng(seed)
        if which == "stress":
            js, port = stress
            ts = port.trav
            o, d = _rays(js, rng, 2048)
            t_min = 1e-4 * js.scale
        else:
            ts = _trav_of(*rng.uniform(-1, 1, (3, 400, 3)))
            o = rng.uniform(-1.5, 1.5, (2048, 3)).astype(np.float32)
            d = rng.normal(size=(2048, 3))
            d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
            t_min = 1e-4
        rays = _pack(o, d, t_min, F32_MAX)
        c_skip, c_ord = {}, {}
        a = tv.closest_hit_traverse_plain(ts, rays, c_skip)
        b = tv.closest_hit_ordered_plain(ts, rays, c_ord)
        same = a[1] == b[1]
        for x, y in zip(a, b):
            assert torch.equal(x[same], y[same])
        ta, tb = to_numpy(a[0])[~to_numpy(same)], to_numpy(b[0])[~to_numpy(same)]
        assert (np.abs(ta - tb) <= np.spacing(np.maximum(np.abs(ta), np.abs(tb)))).all(), (ta, tb)
        assert int((~same).sum()) <= 16
        assert 0 < c_ord["pair_visits"] < c_skip["node_visits"]


@pytest.mark.parametrize("D", [64, 100, 128])
def test_ordered_walk_on_deep_trees(D):
    """Chains up to STACK_SIZE deep (tests/torch_parity.deep_chain), whose
    walks fill stacks beyond 64 entries: pack_traversal takes them, and the
    ordered walk gives the skip-link walk's (t, tri, u, v) bit for bit (no
    ties and no box-face hits here)."""
    from mcpt_tpu_torch.ops import traverse as tv

    ts, o, d = deep_chain(D, np.random.default_rng(D))
    assert ts.depth == D <= tv.STACK_SIZE
    rays = _pack(o, d, 1e-3, F32_MAX)
    a = tv.closest_hit_traverse_plain(ts, rays)
    b = tv.closest_hit_ordered_plain(ts, rays)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert 0.2 < float((b[1] >= 0).float().mean()) < 0.8


ANY_SEEDS = [30, 31]


def _grazing_rays(ts, rng, R):
    """Rays aimed at a point of a random triangle, nearly in its plane (the
    normal component 1e-6 to 1e-2 of the direction), from 0.1 to 3 units
    away, and their t_max a little short of the point or past it."""
    tri = ts.tris.numpy().astype(np.float64)[rng.integers(0, ts.n_tris, R)]
    v0, e1, e2 = tri[:, 0:3], tri[:, 4:7], tri[:, 8:11]
    a, b = rng.random((2, R))
    target = v0 + (a * (1 - b))[:, None] * e1 + (a * b)[:, None] * e2
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=(R, 3))
    d -= (d * n).sum(1, keepdims=True) * n
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d += n * (10.0 ** rng.uniform(-6, -2, (R, 1))) * rng.choice([-1.0, 1.0], (R, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.1, 3.0, R)
    o = target - d * dist[:, None]
    t_max = dist * np.where(rng.random(R) < 0.5, 1 - 1e-3, 1.5)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def _shadow_rays(js, ts, rng, R):
    """Camera rays' closest hits (the port's walk) joined to points on the
    light, t_max short of the light by 1e-3 of the distance, as the
    integrator's NEE rays are; the camera rays that miss are left out."""
    from mcpt_tpu_torch.ops.traverse import closest_hit_ordered_plain
    from mcpt_tpu_torch.render.integrator import pack_light_table, sample_light_point

    o, d = _rays(js, rng, R)
    o, d = o[:512], d[:512]
    t, tri, _, _ = closest_hit_ordered_plain(ts.trav, _pack(o, d, 1e-4 * js.scale, F32_MAX))
    hit = to_numpy(tri) >= 0
    pts = (o + d * to_numpy(t)[:, None])[hit]
    u = torch.from_numpy(rng.random((pts.shape[0], 3)).astype(np.float32))
    lp = to_numpy(sample_light_point(pack_light_table(ts), ts.num_lights, u[:, 0], u[:, 1], u[:, 2])[0])
    sv = lp - pts
    dist = np.linalg.norm(sv, axis=1)
    return pts.astype(np.float32), (sv / dist[:, None]).astype(np.float32), (dist * (1 - 1e-3)).astype(np.float32)


@pytest.mark.parametrize("which", ["random", "grazing", "shadow"])
def test_any_ordered_walk_matches_skip_link_and_jax(stress, which):
    """The any-hit kernel's walk of the child-pair table
    (any_hit_ordered_plain) gives the skip-link walk's answer on every
    ray, and mcpt_tpu's any_hit_bvh's at
    test_plain_any_matches_jax_bvh_walk's tolerance; on random rays (box
    faces included), rays grazing a triangle's plane, and shadow rays from
    camera hits to the light. It visits fewer inner rows than the skip-link
    walk visits nodes. On grazing rays the |det| >= eps threshold and the
    edges flip with XLA's summation order on about 1 % of rays; there every
    ray on which the port's walk and mcpt_tpu's differ must be one on which
    the two packages' dense waves (any_hit_bruteforce) differ too, so the
    walks themselves add no difference."""
    from mcpt_tpu.ops.intersect import any_hit_bruteforce as jax_dense
    from mcpt_tpu.ops.traverse import any_hit_bvh
    from mcpt_tpu_torch.ops import traverse as tv
    from mcpt_tpu_torch.ops.intersect import any_hit_bruteforce

    js, ts = stress
    t_min = 1e-4 * js.scale
    for seed in ANY_SEEDS:
        rng = np.random.default_rng(seed)
        if which == "random":
            o, d = _rays(js, rng, 2048)
            t_max = (js.scale * rng.uniform(0.0, 0.4, 2048)).astype(np.float32)
        elif which == "grazing":
            o, d, t_max = _grazing_rays(ts.trav, rng, 2048)
        else:
            o, d, t_max = _shadow_rays(js, ts, rng, 1024)
        rays = _pack(o, d, t_min, t_max)
        c_skip, c_near = {}, {}
        want = tv.any_hit_traverse_plain(ts.trav, rays, c_skip)
        near = tv.any_hit_ordered_plain(ts.trav, rays, c_near)
        assert torch.equal(near, want)
        jargs = (js, jnp.asarray(o), jnp.asarray(d))
        ref = np.asarray(any_hit_bvh(*jargs, t_min=t_min, t_max=jnp.asarray(t_max)))
        differ = to_numpy(near) != ref
        if which == "grazing":
            dense = to_numpy(any_hit_bruteforce(ts, torch.from_numpy(o), torch.from_numpy(d), t_min=t_min,
                                                t_max=torch.from_numpy(t_max)))
            jdense = np.asarray(jax_dense(*jargs, t_min=t_min, t_max=jnp.asarray(t_max)))
            assert differ.mean() <= 0.02 and not (differ & (dense == jdense)).any()
        else:
            assert differ.mean() <= 0.001
        assert 0.005 < ref.mean() < 0.995, ref.mean()
        assert 0 < c_near["pair_visits"] < c_skip["node_visits"] and c_near["tri_tests"] > 0


@pytest.mark.parametrize("case", ["flat", "deep64", "deep100", "deep128"])
def test_any_ordered_walk_on_flat_box_and_deep_trees(case):
    """The any-hit walk of the child-pair table against the skip-link walk
    where they are easiest to part: the flat box reached at exactly t_max
    (still a miss, as in mcpt_tpu's any_hit_bvh; a hit just past it), and
    chains up to STACK_SIZE deep (tests/torch_parity.deep_chain), whose
    walks fill stacks beyond 64 entries."""
    from mcpt_tpu_torch.ops import traverse as tv

    if case == "flat":
        ts = _trav_of([[-1.0, -1.0, 0.0]], [[2.0, 0.0, 0.0]], [[0.0, 2.0, 0.0]])
        o, d = np.array([[0.0, 0.0, -1.0]] * 2, np.float32), np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
        rays = _pack(o, d, 1e-4, np.array([1.0, 1.0005], np.float32))
        want = torch.tensor([False, True])
    else:
        D = int(case[4:])
        ts, o, d = deep_chain(D, np.random.default_rng(D))
        assert ts.depth == D <= tv.STACK_SIZE
        rays = _pack(o, d, 1e-3, np.random.default_rng(D + 1).uniform(0.5, 4.0, o.shape[0]).astype(np.float32))
        want = tv.any_hit_traverse_plain(ts, rays)
        assert 0.2 < float(want.float().mean()) < 0.8
    assert torch.equal(tv.any_hit_traverse_plain(ts, rays), want)
    assert torch.equal(tv.any_hit_ordered_plain(ts, rays), want)
