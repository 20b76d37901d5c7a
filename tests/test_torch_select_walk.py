"""The select kernels' walk (ops/select.py closest_hit_select_plain /
any_hit_select_plain: per-ray walks of each staged treelet's sub-BVH)
against the reference walk (closest_hit_select_packet_plain /
any_hit_select_packet_plain: every tested ray of a tile against every
triangle of every treelet the tile visits, as mcpt_tpu's select kernels
test), and the sub-BVH arrays of the treelet layout (ops/treelets.py) that
the walk reads.

The two walks take the same superblocks and keys; a ray's walk culls a box
at its running best_t, as the BVH walk does, so on these random soups both
give the same answers bit for bit (the one-ulp box-face case of ROADMAP
queue 3 item 4 is where they could part). Every test draws from a
generator of its own.
"""
import numpy as np
import pytest
import torch

from tests.torch_parity import deep_chain, soup_rays, to_numpy, treelet_soup

F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module")
def soup():
    return treelet_soup(np.random.default_rng(21), 2500, 16, 8)


def _tiles(port, o, d, t_max):
    """Packed rays in the ray sort's order, padded to whole tiles."""
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.traverse import ray_sort_order
    from mcpt_tpu_torch.ops.woop import pack_rays

    o, d, t_max = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t_max))
    order = ray_sort_order(port.trav, o, d)
    return pad_tiles(pack_rays(o[order], d[order], 1e-4, t_max[order]))


def _same(kind, a, b):
    if kind == "any":
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_walk_equals_reference_walk(soup, seed, kind):
    """Ragged batches (not a whole number of tiles) with parked lanes and
    finite t_max: the walk's answers equal the reference walk's bit for
    bit, with fewer triangle tests."""
    from mcpt_tpu_torch.ops import select as SL

    _, port, *_ = soup
    rng = np.random.default_rng(seed)
    R = 290 + seed
    o, d = soup_rays(rng, R)
    o[40:52] = 1e30
    t_max = rng.uniform(0.5, 10.0, R).astype(np.float32)
    if kind == "closest":
        t_max[::3] = F32_MAX
    rays = _tiles(port, o, d, t_max)
    walk, ref = {}, {}
    got = getattr(SL, f"{kind}_hit_select_plain")(port.treelets, port.trav, rays, walk)
    want = getattr(SL, f"{kind}_hit_select_packet_plain")(port.treelets, port.trav, rays, ref)
    assert _same(kind, got, want)
    hits = got[1] >= 0 if kind == "closest" else got
    assert 0.1 < float(hits.float().mean()) < 0.95
    assert 0 < walk["tri_tests"] < ref["tri_tests"] and walk["pair_visits"] > 0
    assert walk["treelet_visits"] > 0 and walk["box_keys"] > 0


def test_walk_cuts_triangle_tests(soup):
    """On sorted camera-like rays (one origin, a 40-degree frustum onto the
    soup) the walk makes at most a quarter of the reference walk's triangle
    tests, and gives the same hits."""
    from mcpt_tpu_torch.ops import select as SL

    _, port, *_ = soup
    rng = np.random.default_rng(11)
    R = 512
    eye = np.array([0.5, -14.0, 1.0])
    ang = rng.uniform(-0.35, 0.35, (R, 2))
    d = np.stack([np.tan(ang[:, 0]), np.ones(R), np.tan(ang[:, 1])], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(eye, (R, 3)).astype(np.float32)
    rays = _tiles(port, o, d, np.full(R, F32_MAX, np.float32))
    walk, ref = {}, {}
    got = SL.closest_hit_select_plain(port.treelets, port.trav, rays, walk)
    want = SL.closest_hit_select_packet_plain(port.treelets, port.trav, rays, ref)
    assert _same("closest", got, want)
    assert float((got[1] >= 0).float().mean()) > 0.5
    assert 4 * walk["tri_tests"] <= ref["tri_tests"], (walk, ref)


def _subtree(tl, pairs, g):
    """(pair rows, triangles, deepest inner-node path) reached from row g's
    local root ref through the child-pair table, rebasing every ref read."""
    first, pf = int(tl.row_first[g]), int(tl.row_pair_first[g])
    rows, tris, deepest = [], [], 0
    todo = [(int(tl.row_root[g]), 0)]
    while todo:
        ref, depth = todo.pop()
        if ref & 7:
            tris += range(first + (ref >> 3), first + (ref >> 3) + (ref & 7))
            deepest = max(deepest, depth)
            continue
        row = pf + (ref >> 3)
        rows.append(row)
        for col in (3, 7):
            child = int(pairs[row, col:col + 1].view(torch.int32))
            todo.append((child - (first * 8 if child & 7 else pf * 8), depth + 1))
    return rows, tris, deepest


@pytest.mark.parametrize("T,c,s_b,seed", [(700, 16, 8, 3), (5000, 128, 128, 6)])
def test_sub_bvh_arrays_reproduce_each_treelet(T, c, s_b, seed):
    """Each treelet's pair rows and local root ref reproduce its subtree: a
    walk from the root reaches exactly its rows (each once) and its
    triangles (each once); the rows of two treelets never overlap; a
    single-leaf treelet has no rows; tdepth is the deepest such walk."""
    _, port, *_ = treelet_soup(np.random.default_rng(seed), T, c, s_b)
    tl, pairs = port.treelets, port.trav.pairs
    count, pc = to_numpy(tl.row_count), to_numpy(tl.row_pair_count)
    owner = np.full(pairs.shape[0], -1)
    deepest, single = 0, 0
    for g in np.nonzero(count)[0]:
        rows, tris, depth = _subtree(tl, pairs, g)
        pf = int(tl.row_pair_first[g])
        assert sorted(rows) == list(range(pf, pf + pc[g]))
        assert sorted(tris) == list(range(int(tl.row_first[g]), int(tl.row_first[g]) + count[g]))
        assert (owner[rows] == -1).all()
        owner[rows] = g
        deepest = max(deepest, depth)
        if pc[g] == 0:
            single += 1
            assert int(tl.row_root[g]) == count[g]  # a leaf ref: local first 0
    assert (to_numpy(tl.row_root)[count == 0] == -1).all() and (pc[count == 0] == 0).all()
    assert tl.tdepth == deepest > 0
    if c == 16:
        assert single > 0


@pytest.mark.parametrize("D", [16, 40])
def test_deep_treelet_walk_equals_bvh_walk(D):
    """A chain D inner nodes deep in one treelet (tdepth D: the kernels'
    16-entry stack up to 16, the 128-entry one above): the walk equals the
    BVH walk's answers bit for bit, closest and any hit."""
    from mcpt_tpu_torch.ops import select as SL
    from mcpt_tpu_torch.ops import traverse as tv
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.ops.woop import pack_rays
    from mcpt_tpu_torch.scene import _to

    ts, o, d, bvh = deep_chain(D, np.random.default_rng(D), with_bvh=True)
    tl = _to(build_treelets(bvh, D + 1), torch.device("cpu"))
    assert tl.tdepth == D and int((tl.row_count > 0).sum()) == 1
    o, d = torch.from_numpy(o[:600]), torch.from_numpy(d[:600])
    t_max = torch.from_numpy(np.random.default_rng(D + 1).uniform(0.5, 4.0, 600).astype(np.float32))
    for kind, tm in (("closest", F32_MAX), ("any", t_max)):
        rays = pad_tiles(pack_rays(o, d, 1e-3, tm))
        got = getattr(SL, f"{kind}_hit_select_plain")(tl, ts, rays)
        assert _same(kind, got, getattr(tv, f"{kind}_hit_ordered_plain")(ts, rays))
        hits = got[1] >= 0 if kind == "closest" else got
        assert 0.1 < float(hits.float().mean()) < 0.95
