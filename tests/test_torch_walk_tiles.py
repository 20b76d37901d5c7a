"""The plain walks of the treelet routes are tile-local: each 128-ray tile's
answers depend on that tile's rays (and, for the schedule walks, its
schedule row) alone. chip_smoke.py phases 11-12 rely on it: they hold the
kernels against the plain and reference walks on every 8th whole tile of a
921,600-ray batch, with the kernels' outputs restricted to the same tiles.
Here every walk, run on a subset of whole tiles, gives the full run's
answers on those tiles bit for bit."""
import numpy as np
import pytest
import torch

from tests.torch_parity import soup_rays, treelet_soup

F32_MAX = float(np.finfo(np.float32).max)
TILE = 128


@pytest.fixture(scope="module")
def soup():
    return treelet_soup(np.random.default_rng(43), 2500, 16, 8)


def _tiles(port, rng, n_tiles):
    from mcpt_tpu_torch.ops.schedule import pad_tiles
    from mcpt_tpu_torch.ops.traverse import ray_sort_order
    from mcpt_tpu_torch.ops.woop import pack_rays

    R = n_tiles * TILE - 37  # ragged: the last tile is padded
    o, d = soup_rays(rng, R)
    t_max = rng.uniform(0.5, 10.0, R).astype(np.float32)
    t_max[::3] = F32_MAX
    o[100:140] = 1e30  # parked lanes
    o, d, t_max = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t_max))
    order = ray_sort_order(port.trav, o, d)
    return pad_tiles(pack_rays(o[order], d[order], 1e-4, t_max[order]))


def _restrict(kind, out, ids):
    return tuple(x[ids] for x in out) if kind == "closest" else out[ids]


def _same(kind, a, b):
    if kind == "any":
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("route", ["select", "schedule"])
def test_plain_walks_are_tile_local(soup, route, kind):
    from mcpt_tpu_torch.ops import schedule as S
    from mcpt_tpu_torch.ops import select as SL

    _, port, *_ = soup
    tl, ts = port.treelets, port.trav
    seed = [43, ("select", "schedule").index(route), ("closest", "any").index(kind)]
    rays = _tiles(port, np.random.default_rng(seed), 12)
    n_tiles = rays.shape[0] // TILE
    tiles = torch.arange(0, n_tiles, 3)
    ids = (tiles[:, None] * TILE + torch.arange(TILE)).reshape(-1)
    if route == "select":
        walks = [getattr(SL, f"{kind}_hit_select_plain"), getattr(SL, f"{kind}_hit_select_packet_plain")]
        full_args, sub_args = (tl, ts, rays), (tl, ts, rays[ids])
    else:
        sched = S.build_schedule_plain(tl, rays, 512)[0]
        walks = [getattr(S, f"{kind}_hit_schedule_plain"), getattr(S, f"{kind}_hit_schedule_packet_plain")]
        full_args, sub_args = (tl, ts, rays, sched), (tl, ts, rays[ids], sched[tiles].contiguous())
        # the pre-pass is tile-local too: each tile's row from its own rays
        assert all(torch.equal(a[tiles], b)
                   for a, b in zip(S.build_schedule_plain(tl, rays, 512),
                                   S.build_schedule_plain(tl, rays[ids], 512)))
    for walk in walks:
        full = walk(*full_args)
        sub = walk(*sub_args)
        assert _same(kind, _restrict(kind, full, ids), sub), walk.__name__
    hits = full[1] >= 0 if kind == "closest" else full
    assert 0.05 < float(hits.float().mean()) < 0.95
