"""The schedule kernels' walk and pre-pass (ops/schedule.py) on the CPU.

  * The walk (closest_hit_schedule_plain / any_hit_schedule_plain: per-ray
    walks of each scheduled treelet's sub-BVH, the step the select walk
    shares) against the reference walk (closest_hit_schedule_packet_plain /
    any_hit_schedule_packet_plain: every tested ray of a tile against every
    triangle of every treelet of its row, as mcpt_tpu's schedule kernels
    test), on the same rows. A ray's walk culls a box at its running
    best_t, as the BVH walk does, so the two can part only on a ray through
    a shared box face at exactly best_t (ROADMAP queue 3 item 4); on these
    soups they agree bit for bit, and a differing ray would be named in the
    failure.
  * The walk on deep layouts (c = 16, s_b = 8 on the stress scene, and
    deep_chain's single treelet 16 and 40 nodes deep) against the BVH walk,
    through the wrappers.
  * The pre-pass's superblock cull (build_schedule_plain(cull=True), the
    kernel's algorithm) against the test of every treelet, bit for bit,
    and the premise it rests on: every superblock box holds its treelets'.
Every test draws from a generator of its own.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from tests.torch_parity import deep_chain, soup_rays, to_numpy, treelet_soup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module")
def soup():
    return treelet_soup(np.random.default_rng(31), 2500, 16, 8)


@pytest.fixture(scope="module")
def stress():
    """The 5,986-triangle stress scene on the CPU with its own layout (c =
    s_b = 128: one superblock) and the deep one (c = 16, s_b = 8)."""
    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.scene import _to

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    (scene,) = chip_smoke.stress_scene(6000, 0, ("cpu",))
    bvh = {k: getattr(scene.bvh, k).numpy() for k in ("lo", "hi", "first", "count", "skip")}
    deep = _to(build_treelets(bvh, scene.num_tris, 16, 8), torch.device("cpu"))
    return {"own": scene, "deep": dataclasses.replace(scene, treelets=deep)}


def _tiles(port, o, d, t_max, t_min=1e-4):
    """Packed rays in the ray sort's order, padded to whole tiles."""
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.traverse import ray_sort_order
    from mcpt_tpu_torch.ops.woop import pack_rays

    o, d, t_max = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t_max))
    order = ray_sort_order(port.trav, o, d)
    return pad_tiles(pack_rays(o[order], d[order], t_min, t_max[order]))


def _differing(kind, got, want):
    """The rays on which two answers differ, with both answers."""
    if kind == "any":
        idx = torch.nonzero(got != want)[:, 0].tolist()
        return [(i, bool(got[i]), bool(want[i])) for i in idx]
    diff = torch.zeros_like(got[1], dtype=torch.bool)
    for a, b in zip(got, want):
        diff |= a.view(torch.int32) != b.view(torch.int32)
    idx = torch.nonzero(diff)[:, 0].tolist()
    return [(i, int(got[1][i]), float(got[0][i]), int(want[1][i]), float(want[0][i])) for i in idx]


def _camera(rng, R, eye):
    """Camera-like rays: one origin, a 40-degree frustum along +y."""
    ang = rng.uniform(-0.35, 0.35, (R, 2))
    d = np.stack([np.tan(ang[:, 0]), np.ones(R), np.tan(ang[:, 1])], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(np.asarray(eye, np.float32), (R, 3)).copy(), d


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_walk_equals_packet_walk(soup, seed, kind):
    """Ragged batches (not a whole number of tiles): four coherent bundles
    of short rays (a tile each, few live treelets), then random rays with
    parked lanes and finite t_max. On rows of v = 512, and of v = 64, where
    the random tiles overflow and are blanked, the walk's answers equal the
    reference walk's bit for bit, with fewer triangle tests."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops.woop import pack_rays

    _, port, *_ = soup
    rng = np.random.default_rng(100 + seed)
    R = 1100 + 7 * seed
    o, d = soup_rays(rng, R)
    t_max = rng.uniform(0.5, 10.0, R).astype(np.float32)
    if kind == "closest":
        t_max[::3] = F32_MAX
    L = 4 * S.RAY_TILE
    o[:L] = (rng.uniform(-4.0, 4.0, (4, 1, 3)) + rng.uniform(-0.2, 0.2, (4, S.RAY_TILE, 3))).reshape(-1, 3)
    cone = rng.normal(size=(4, 1, 3))
    cone = cone / np.linalg.norm(cone, axis=2, keepdims=True) + rng.normal(0.0, 0.05, (4, S.RAY_TILE, 3))
    d[:L] = (cone / np.linalg.norm(cone, axis=2, keepdims=True)).reshape(-1, 3)
    t_max[:L] = rng.uniform(0.2, 1.5, L)
    o[L + 40:L + 52] = 1e30
    rays = S.pad_tiles(pack_rays(*(torch.from_numpy(x) for x in (o, d)), 1e-4, torch.from_numpy(t_max)))
    for v in (512, 64):
        sched, inc, _ = S.build_schedule(port.treelets, rays, v)
        assert (0 < int(inc.sum()) < inc.shape[0]) == (v == 64)
        walk, ref = {}, {}
        got = getattr(S, f"{kind}_hit_schedule_plain")(port.treelets, port.trav, rays, sched, walk)
        want = getattr(S, f"{kind}_hit_schedule_packet_plain")(port.treelets, port.trav, rays, sched, ref)
        assert _differing(kind, got, want) == [], v
        hits = got[1] >= 0 if kind == "closest" else got
        assert 0.05 < float(hits.float().mean()) < 0.95
        assert not bool(hits[inc.repeat_interleave(S.RAY_TILE)].any())  # a blanked row tests nothing
        assert 0 < walk["tri_tests"] < ref["tri_tests"] and walk["pair_visits"] > 0
        assert 0 < walk["treelet_visits"] <= ref["treelet_visits"] and walk["box_keys"] > 0


def test_walk_cuts_triangle_tests(soup):
    """On sorted camera-like rays the walk makes at most a quarter of the
    reference walk's triangle tests, and gives the same hits."""
    from mcpt_tpu_torch.ops import schedule as S

    _, port, *_ = soup
    o, d = _camera(np.random.default_rng(41), 640, [0.5, -14.0, 1.0])
    rays = _tiles(port, o, d, np.full(640, F32_MAX, np.float32))
    sched, inc, _ = S.build_schedule(port.treelets, rays, 512)
    assert not bool(inc.any())
    walk, ref = {}, {}
    got = S.closest_hit_schedule_plain(port.treelets, port.trav, rays, sched, walk)
    want = S.closest_hit_schedule_packet_plain(port.treelets, port.trav, rays, sched, ref)
    assert _differing("closest", got, want) == []
    assert float((got[1] >= 0).float().mean()) > 0.5
    assert 4 * walk["tri_tests"] <= ref["tri_tests"], (walk, ref)


def test_walk_follows_its_cutoff(soup):
    """Closest hit stops at the first key at or past the tile's largest
    best_t: a row whose only keys lie past every ray's t_max visits
    nothing; the same keys under a larger t_max are visited."""
    from mcpt_tpu_torch.ops import schedule as S

    _, port, *_ = soup
    o, d = _camera(np.random.default_rng(43), 128, [0.5, -14.0, 1.0])
    far = _tiles(port, o, d, np.full(128, F32_MAX, np.float32))
    sched, _, n_live = S.build_schedule(port.treelets, far, 512)
    assert int(n_live[0]) > 1
    near = far.clone()
    near[:, 7] = torch.where(near[:, 3] < near[:, 7], torch.full_like(near[:, 7], 0.5), near[:, 7])
    counts = {}
    out = S.closest_hit_schedule_plain(port.treelets, port.trav, near, sched, counts)
    assert counts.get("treelet_visits", 0) == 0 and bool((out[1] == -1).all())
    counts = {}
    S.closest_hit_schedule_plain(port.treelets, port.trav, far, sched, counts)
    assert 0 < counts["treelet_visits"] <= int(n_live[0])


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("layout", ["own", "deep"])
def test_stress_layouts_equal_the_bvh_walk(stress, layout, kind):
    """The stress scene under both layouts, camera rays from inside the
    room and random rays, through the wrappers (v = 512, and v = 64 where
    the fallback takes the blanked tiles): the BVH walk's answers bit for
    bit."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import traverse as tv

    scene = stress[layout]
    rng = np.random.default_rng(7 if kind == "closest" else 8)
    o1, d1 = _camera(rng, 700, [5.0, 0.3, 5.0])
    o2 = rng.uniform(0.2, 9.8, (500, 3)).astype(np.float32)
    d2 = rng.normal(size=(500, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    o, d = (torch.from_numpy(np.concatenate(x)) for x in ((o1, o2), (d1, d2)))
    t_max = F32_MAX if kind == "closest" else torch.from_numpy(rng.uniform(0.5, 8.0, 1200).astype(np.float32))
    want = getattr(tv, f"{kind}_hit_traverse")(scene.trav, o, d, 1e-3, t_max)
    for v in (512, 64):
        got = getattr(S, f"{kind}_hit_schedule")(scene, o, d, 1e-3, t_max, v=v)
        assert _differing(kind, got, want) == [], v
    hits = want[1] >= 0 if kind == "closest" else want
    assert 0.1 < float(hits.float().mean()) <= 1.0


@pytest.mark.parametrize("D", [16, 40])
def test_deep_chain_walk_equals_bvh_walk(D):
    """A chain D inner nodes deep in one treelet (tdepth D: the kernels'
    16-entry stack up to 16, the 128-entry one above): the schedule walk,
    through the wrappers, equals the BVH walk bit for bit."""
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import traverse as tv
    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.scene import _to

    ts, o, d, bvh = deep_chain(D, np.random.default_rng(D + 3), with_bvh=True)
    tl = _to(build_treelets(bvh, D + 1), torch.device("cpu"))
    assert tl.tdepth == D and int((tl.row_count > 0).sum()) == 1
    scene = types.SimpleNamespace(trav=ts, treelets=tl)
    pick = np.random.default_rng(D + 4).permutation(o.shape[0])[:700]  # up the chain and across it
    o, d = torch.from_numpy(o[pick]), torch.from_numpy(d[pick])
    t_max = torch.from_numpy(np.random.default_rng(D + 5).uniform(0.5, 4.0, 700).astype(np.float32))
    for kind, tm in (("closest", F32_MAX), ("any", t_max)):
        got = getattr(S, f"{kind}_hit_schedule")(scene, o, d, 1e-3, tm)
        want = getattr(tv, f"{kind}_hit_traverse")(ts, o, d, 1e-3, tm)
        assert _differing(kind, got, want) == [], kind
        hits = got[1] >= 0 if kind == "closest" else got
        assert 0.1 < float(hits.float().mean()) < 0.95


def _layouts(soup, stress):
    _, port, *_ = soup
    return {"soup": port, "own": stress["own"], "deep": stress["deep"]}


@pytest.mark.parametrize("layout", ["soup", "own", "deep"])
def test_superblock_boxes_hold_their_treelets(soup, stress, layout):
    """The premise of the pre-pass's superblock cull: every real treelet
    box lies inside its superblock's box (both are BVH node boxes, the
    superblock an ancestor)."""
    tl = _layouts(soup, stress)[layout].treelets
    sb = to_numpy(tl.sb_box)[:, :tl.ns]
    blk = to_numpy(tl.blk_box)
    real = blk[:, 6, :] > 0
    assert real.sum() == int((tl.row_count > 0).sum()) > 0
    lo_ok = blk[:, 0:3, :] >= sb[0:3].T[:, :, None]
    hi_ok = blk[:, 3:6, :] <= sb[3:6].T[:, :, None]
    assert (lo_ok.all(axis=1) | ~real).all() and (hi_ok.all(axis=1) | ~real).all()


def _prepass_batches(port, rng):
    """Tiles of sorted rays: camera-like, random, and adversarial ones
    (parked lanes, all-parked tiles, a direction component of 0, -0, a
    denormal or NaN, empty intervals, and a tile whose origins lie on the
    largest superblock's lower z plane with d_z from 1e-40 up: there the
    superblock's test meets 0 * inf = NaN while treelets above the plane
    are hit, so the cull must keep a superblock whose test is NaN)."""
    lo, hi = to_numpy(port.trav.nodes[0, 0:3]), to_numpy(port.trav.nodes[0, 4:7])
    span = hi - lo
    o1, d1 = _camera(rng, 384, lo + span * [0.5, -0.5, 0.5])
    o2 = (lo + span * rng.uniform(-0.2, 1.2, (640, 3))).astype(np.float32)
    d2 = rng.normal(size=(640, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    t_max = np.full(o.shape[0], F32_MAX, np.float32)
    t_max[::5] = rng.uniform(0.1, 5.0, t_max[::5].shape[0])
    out = [_tiles(port, o, d, t_max)]
    # adversarial tiles, unsorted: each tile holds one kind
    R = 128
    o3 = np.repeat((lo + span * rng.uniform(0, 1, (6, 1, 3))).astype(np.float32), R, axis=1)
    d3 = np.repeat(d2[:6, None, :], R, axis=1) + rng.normal(0, 0.01, (6, R, 3)).astype(np.float32)
    d3[0, :, 0] = 0.0
    d3[1, :, 1] = -0.0
    d3[2, :, 2] = np.float32(1e-40)
    d3[3, ::7, 0] = np.nan
    o3[4] = 1e30  # every lane parked: an empty tile
    t3 = np.full((6, R), F32_MAX, np.float32)
    t3[5, ::2] = 0.0  # empty intervals
    tl = port.treelets
    sb = to_numpy(tl.sb_box)[:, :tl.ns]
    s = int(np.argmax(np.prod(sb[3:6] - sb[0:3], axis=0)))
    o4 = np.broadcast_to(np.array([(sb[0, s] + sb[3, s]) / 2, (sb[1, s] + sb[4, s]) / 2, sb[2, s]],
                                  np.float32), (R, 3))
    d4 = rng.normal(size=(R, 3))
    d4[:, 2] = np.abs(d4[:, 2]) + 0.2
    d4 = (d4 / np.linalg.norm(d4, axis=1, keepdims=True)).astype(np.float32)
    d4[0, 2] = np.float32(1e-40)
    from mcpt_tpu_torch.ops.woop import pack_rays

    out.append(pack_rays(*(torch.from_numpy(np.concatenate([x.reshape(-1, 3), y])) for x, y in ((o3, o4), (d3, d4))),
                         1e-4, torch.from_numpy(np.concatenate([t3.reshape(-1), np.full(R, F32_MAX, np.float32)]))))
    return out


@pytest.mark.parametrize("v", [512, 64])
@pytest.mark.parametrize("layout", ["soup", "own", "deep"])
def test_culled_prepass_equals_prepass(soup, stress, layout, v):
    """build_schedule_plain with the kernel's superblock cull equals it
    without, bit for bit (keys, incomplete tiles, live counts); on the
    coherent adversarial tiles, with more than one superblock, the cull
    drops superblocks and makes fewer box tests."""
    from mcpt_tpu_torch.ops import schedule as S

    port = _layouts(soup, stress)[layout]
    for i, rays in enumerate(_prepass_batches(port, np.random.default_rng(v + len(layout)))):
        culled, full = {}, {}
        want = S.build_schedule_plain(port.treelets, rays, v, counts=full)
        got = S.build_schedule_plain(port.treelets, rays, v, cull=True, counts=culled)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(want[2].max()) > 0
        if i == 1 and port.treelets.ns > 1:
            assert culled["box_tests"] < full["box_tests"]
