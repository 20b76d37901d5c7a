"""Schedule-fed treelet traversal: closest hit and any hit of ray tiles
walking a precomputed list of treelets.

Port of mcpt_tpu/ops/pallas/schedule.py (the kernel pair `_closest_kernel`
/ `_any_kernel` and its pre-pass `build_schedule`), over the treelet layout
of ops/treelets.py:
  pre-pass (`build_schedule`: csrc/treelet.cu schedule_prepass_kernel on
    the card, `build_schedule_plain` here): per tile of RAY_TILE sorted
    rays, the bundle's componentwise origin, direction and t intervals; one
    interval slab test against every treelet box (the reference's far *
    1.001 where far > 0, strict lo < hi); the hits packed as int32 keys
    (high bits: f32 bits of the entry lower bound; low bits: the treelet
    row), sorted ascending (front to back) and cut to V. A tile with more
    than V live treelets is incomplete: its row is blanked to KEY_MISS and
    its rays go through the exact BVH traversal (ops/traverse.py) instead.
    The keys equal mcpt_tpu's bit for bit. The kernel first tests the
    superblock boxes and skips the treelets of those the bundle misses,
    which changes nothing (csrc/treelet.cu says why;
    build_schedule_plain(cull=True) mirrors it).
  walk (csrc/treelet.cu schedule_kernel, one CUDA block a tile, or the
    plain torch version here): the tile's keys in order, each treelet
    visited by the step the select walk takes too (`sub_walks`): every
    tested ray whose own key for the treelet (its slab test of the
    treelet's box over [t_lo, min(t_hi, best_t)], for closest hit a lower
    bound below its best_t; any hit: not occluded) is live walks the
    treelet's sub-BVH from its root, as the BVH traversal walks the whole
    tree (ops/traverse.ordered_closest_walk / ordered_any_walk over the
    treelet's rows of the child-pair table and its triangles, refs made
    local). Stop at KEY_MISS, or, for closest hit, at the first key whose
    lower bound is >= the largest best_t of the tile's tested rays (int
    compare of f32 bits, both >= 0), refreshed after every treelet, or, for
    any hit, when every tested ray is occluded. The TPU kernel tested every
    ray of the tile against every triangle of each treelet instead, and
    checked the cutoff every fourth pair; that walk stays here as the
    reference walk (closest_hit_schedule_packet_plain /
    any_hit_schedule_packet_plain, step `visit_treelet`).
Accept predicates are those of ops/intersect.py: closest hit |det| >= 1e-5,
t_lo <= t < t_hi, u, v >= 0, 1 - u - v >= 0, the smallest (t, triangle id);
any hit |det| >= 1e-6, t_lo <= t <= t_hi, 0 <= u <= 1, v >= 0, u + v <= 1.
Rays with an empty interval or a parked origin (|o| >= 1e29) are not
tested and miss, as in the other kernel pairs. Moller-Trumbore and the
slab tests are ops/traverse.py's, single rounded f32 operations in one
order, so the kernels equal their plain versions bit for bit. A ray's
walk culls a box at its running best_t, as the BVH walk does, so the walks
can differ from the reference walk and from the BVH traversal only in the
one-ulp box-face case of ROADMAP queue 3 item 4.

No render route runs this pair, in mcpt_tpu or here: `closest_hit_schedule`
/ `any_hit_schedule` are entry points of their own.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mcpt_tpu_torch.ops import traverse as tv
from mcpt_tpu_torch.ops.intersect import DET_EPS_ANY, DET_EPS_CLOSEST, F32_MAX, T_MIN
from mcpt_tpu_torch.ops.woop import PARKED, _ptr, pack_rays

RAY_TILE = 128  # rays per tile and per CUDA block
DEFAULT_V = 512  # schedule capacity a tile (mcpt_tpu DEFAULT_V)
MAX_V = 8192  # the kernels hold a tile's row in shared memory
KEY_MISS = 2**31 - 1
ID_MISS = 2**30
_PREPASS_PAIRS = 1 << 22  # tile x treelet pairs a pre-pass chunk: bounds its [tiles, G] temporaries
_PLAIN_PAIRS = 1 << 25  # elements of a plain walk's largest temporary in a chunk

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0, "prepass": 0}
PLAIN_CALLS = {"closest": 0, "any": 0, "prepass": 0}


def bits_for(n: int) -> int:
    """Low key bits that hold an index below n: ceil(log2(max(n, 2)))."""
    return max(1, (max(n, 2) - 1).bit_length())


def pad_tiles(rays: torch.Tensor) -> torch.Tensor:
    """Packed rays (ops/woop.pack_rays) padded to a multiple of RAY_TILE with
    rays that are not tested (t_lo = t_hi = 0, direction (1, 1, 1))."""
    R = rays.shape[0]
    pad = -(-R // RAY_TILE) * RAY_TILE - R
    if pad == 0:
        return rays
    fill = torch.zeros((pad, 8), dtype=rays.dtype, device=rays.device)
    fill[:, 4:7] = 1.0
    return torch.cat([rays, fill])


def _bundle_bounds(rays: torch.Tensor):
    """Per tile of RAY_TILE rays, the componentwise intervals of origin and
    direction and the t range of its tested rays (mcpt_tpu _bundle_bounds);
    a tile with none gets +inf/-inf bounds, which the slab test misses."""
    rt = RAY_TILE
    n = rays.shape[0] // rt
    o = rays[:, 0:3].reshape(n, rt, 3)
    d = rays[:, 4:7].reshape(n, rt, 3)
    t_lo = rays[:, 3].reshape(n, rt)
    t_hi = rays[:, 7].reshape(n, rt)
    valid = (t_lo < t_hi) & (torch.amax(torch.abs(o), dim=-1) < PARKED)
    v3 = valid[..., None]
    inf = float("inf")
    return (torch.where(v3, o, inf).amin(1), torch.where(v3, o, -inf).amax(1),
            torch.where(v3, d, inf).amin(1), torch.where(v3, d, -inf).amax(1),
            torch.where(valid, t_lo, inf).amin(1), torch.where(valid, t_hi, -inf).amax(1))


def _interval_bounds(olo, ohi, dlo, dhi, blo, bhi):
    """near and far [tiles, L] of the bundles against the boxes (mcpt_tpu
    _interval_slab): interval arithmetic per axis, an axis whose directions
    change sign unbounded; far * 1.001 where far > 0."""
    inf = float("inf")
    near = torch.full((olo.shape[0], blo.shape[0]), -inf, device=olo.device)
    far = torch.full_like(near, inf)
    for a in range(3):
        pos = dlo[:, a] > 0.0
        neg = dhi[:, a] < 0.0
        ok = pos | neg
        ilo = 1.0 / torch.where(ok, dhi[:, a], 1.0)
        ihi = 1.0 / torch.where(ok, dlo[:, a], 1.0)
        ilo, ihi = torch.minimum(ilo, ihi)[:, None], torch.maximum(ilo, ihi)[:, None]

        def t_int(b):
            q_lo = b[None, :] - ohi[:, a][:, None]
            q_hi = b[None, :] - olo[:, a][:, None]
            p1, p2, p3, p4 = q_lo * ilo, q_lo * ihi, q_hi * ilo, q_hi * ihi
            return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                    torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

        t1_lb, t1_ub = t_int(blo[:, a])
        t2_lb, t2_ub = t_int(bhi[:, a])
        near_a = torch.minimum(t1_lb, t2_lb)
        far_a = torch.maximum(t1_ub, t2_ub)
        far_a = torch.where(far_a > 0, far_a * tv.FAR_FUDGE, far_a)
        mixed = (~pos & ~neg)[:, None]
        near = torch.maximum(near, torch.where(mixed, -inf, near_a))
        far = torch.minimum(far, torch.where(mixed, inf, far_a))
    return near, far


def _bundle_hits(tlo, thi, near, far):
    return torch.maximum(tlo[:, None], near) < torch.minimum(thi[:, None], far)


def _interval_slab(olo, ohi, dlo, dhi, tlo, thi, blo, bhi, valid_box):
    """Bundle-vs-box test and entry lower bound [tiles, G] (mcpt_tpu
    _interval_slab): hit iff max(t_lo, near) < min(t_hi, far)."""
    near, far = _interval_bounds(olo, ohi, dlo, dhi, blo, bhi)
    hit = valid_box[None, :] & _bundle_hits(tlo, thi, near, far)
    # max(near, 0) with +0 where XLA's max gives +0 (torch.maximum keeps -0);
    # NaN near is a miss and its key is KEY_MISS either way
    return hit, torch.where(near > 0, near, 0.0)


def build_schedule_plain(tl, rays: torch.Tensor, v: int = DEFAULT_V, cull: bool = False,
                         counts: Optional[dict] = None):
    """Keys i32[n_tiles, v], incomplete bool[n_tiles] and live treelets
    i32[n_tiles] of packed, sorted rays (a multiple of RAY_TILE of them):
    mcpt_tpu's build_schedule bit for bit, the [n_tiles, v/4, 4] row laid
    out flat. Runs in chunks of tiles; the result does not depend on them.

    With `cull`, the kernel's superblock cull: each tile's treelet rows in
    a superblock that its bundle misses, with a near and a far that are not
    NaN, are dropped (csrc/treelet.cu says why that drops no hit); the
    result is the same. With `counts`, adds the (tile, box) interval tests
    of the algorithm run ("box_tests": every real treelet row, or with cull
    every real superblock and the real rows of the ones kept)."""
    PLAIN_CALLS["prepass"] += 1
    g_total = tl.g
    bits_g = bits_for(g_total)
    n_tiles = rays.shape[0] // RAY_TILE
    dev = rays.device
    bb = tl.blk_box.permute(0, 2, 1).reshape(g_total, 8)
    blo, bhi, valid_box = bb[:, 0:3], bb[:, 3:6], bb[:, 6] > 0.0
    sb = tl.sb_box[:, :tl.ns].T
    sb_of_row = torch.arange(g_total, device=dev) // tl.s_b
    real_rows = valid_box.view(tl.ns, tl.s_b).sum(dim=1)
    bounds = _bundle_bounds(rays)
    gid = torch.arange(g_total, dtype=torch.int32, device=dev)
    sched = torch.empty((n_tiles, v), dtype=torch.int32, device=dev)
    n_live = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    tests = 0
    step = max(1, _PREPASS_PAIRS // max(g_total, 1))
    for i0 in range(0, n_tiles, step):
        sl = slice(i0, min(n_tiles, i0 + step))
        b = tuple(x[sl] for x in bounds)
        hit, entry = _interval_slab(*b, blo, bhi, valid_box)
        if cull:
            near, far = _interval_bounds(*b[:4], sb[:, 0:3], sb[:, 3:6])
            keep = _bundle_hits(b[4], b[5], near, far) | near.isnan() | far.isnan()
            hit &= keep[:, sb_of_row]
            tests += keep.numel() + int((keep.long() * real_rows).sum())
        else:
            tests += hit.shape[0] * int(real_rows.sum())
        fb = torch.clamp(entry, max=F32_MAX).view(torch.int32)
        key = torch.where(hit, ((fb >> bits_g) << bits_g) | gid, KEY_MISS)
        if g_total < v:  # fewer treelets than the capacity: pad with misses
            key = torch.cat([key, torch.full((key.shape[0], v - g_total), KEY_MISS, dtype=torch.int32,
                                             device=dev)], dim=1)
        nl = hit.sum(dim=1, dtype=torch.int32)
        srt = torch.sort(key, dim=1).values[:, :v]
        # a cut schedule could hide the closest hit: blank it, the exact
        # traversal takes the tile
        sched[sl] = torch.where((nl > v)[:, None], KEY_MISS, srt)
        n_live[sl] = nl
    if counts is not None:
        counts["box_tests"] = counts.get("box_tests", 0) + tests
    return sched, n_live > v, n_live


def build_schedule_kernel(tl, rays: torch.Tensor, v: int = DEFAULT_V):
    """Launch csrc/treelet.cu's schedule_prepass_kernel; same contract as
    build_schedule_plain."""
    from mcpt_tpu_torch.ops._build import check, library

    check_treelet_inputs(tl, rays)
    if not 0 < v <= MAX_V:
        raise ValueError(f"v must lie in 1..{MAX_V}")
    n_tiles = rays.shape[0] // RAY_TILE
    dev = rays.device
    sched = torch.empty((n_tiles, v), dtype=torch.int32, device=dev)
    incomplete = torch.empty((n_tiles,), dtype=torch.bool, device=dev)
    n_live = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    if n_tiles:
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        check(library().schedule_prepass(_ptr(rays), _ptr(tl.sb_box), _ptr(tl.blk_box), n_tiles, tl.ns, tl.nsp,
                                         tl.s_b, v, bits_for(tl.g), _ptr(sched), _ptr(incomplete), _ptr(n_live),
                                         stream), "schedule_prepass")
        LAUNCHES["prepass"] += 1
    return sched, incomplete, n_live


def build_schedule(tl, rays: torch.Tensor, v: int = DEFAULT_V):
    """The schedule of packed, sorted rays (build_schedule_plain's
    contract): the pre-pass kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if rays.is_cuda:
        return build_schedule_kernel(tl, rays, v)
    return build_schedule_plain(tl, rays, v)


# ---------------------------------------------------------------------------
# Plain versions: one treelet a step for every live tile of a chunk
# ---------------------------------------------------------------------------


def plain_chunk(rt: int, c: int) -> int:
    """Tiles a plain-walk chunk holds when its largest temporary is
    [tiles, rt, c]."""
    return max(1, _PLAIN_PAIRS // (rt * c))


def tile_view(rays: torch.Tensor, n_tiles: int):
    """o, d [n, rt, 3], t_lo, t_hi [n, rt] and the tested rays [n, rt] of
    packed rays laid out as n_tiles tiles."""
    ry = rays.reshape(n_tiles, -1, 8)
    o, t_lo, d, t_hi = ry[..., 0:3], ry[..., 3], ry[..., 4:7], ry[..., 7]
    active = (t_lo < t_hi) & (torch.abs(o) < PARKED).all(dim=-1)
    return o, d, t_lo, t_hi, active


def entry_keys(box, o, inv, t_lo, t_hi, bits, active):
    """Packed keys [n, rt, L] of rays [n, rt] against box tables [n, 8, L]
    (mcpt_tpu _entry_keys, in the kernels' operation order)."""
    inf = float("inf")
    near = torch.full(o.shape[:2] + (box.shape[2],), -inf, device=o.device)
    far = torch.full_like(near, inf)
    for a in range(3):
        oa, ia = o[..., a, None], inv[..., a, None]
        ta = (box[:, None, a, :] - oa) * ia
        tb = (box[:, None, 3 + a, :] - oa) * ia
        near = torch.maximum(near, torch.minimum(ta, tb))
        far = torch.minimum(far, torch.maximum(ta, tb) * tv.FAR_FUDGE)
    hit = (box[:, None, 6, :] > 0.0) & (torch.maximum(t_lo[..., None], near) < torch.minimum(t_hi[..., None], far))
    entry = torch.where(near > 0, near, 0.0)  # +0 for -0: the bits are the key
    ids = torch.arange(box.shape[2], dtype=torch.int32, device=o.device)
    key = ((entry.view(torch.int32) >> bits) << bits) | ids
    return torch.where(hit & active[..., None], key, KEY_MISS)


def lower_bound(key, bits):
    """A key's entry lower bound: its f32 bits with the low `bits` cleared."""
    return (key >> bits) << bits


class HitState:
    """Running closest hit (bt, bid, bu, bv) or occlusion (found) of a chunk
    of tiles [n, rt]."""

    def __init__(self, t_hi, closest: bool):
        self.closest = closest
        self.bt = t_hi.clone()
        self.bid = torch.full(t_hi.shape, ID_MISS, dtype=torch.int32, device=t_hi.device)
        self.bu = torch.zeros_like(t_hi)
        self.bv = torch.zeros_like(t_hi)
        self.found = torch.zeros(t_hi.shape, dtype=torch.bool, device=t_hi.device)

    def cut(self, active, lanes=None):
        """Largest f32 bits of best_t over each tile's tested rays (int32[n]),
        INT32_MIN for a tile without any."""
        bt = self.bt if lanes is None else self.bt[lanes]
        act = active if lanes is None else active[lanes]
        return torch.where(act, bt.view(torch.int32), -2**31).amax(dim=1)

    def pending(self, active, lanes=None):
        """Does each tile hold a tested ray that is not occluded yet?"""
        f = self.found if lanes is None else self.found[lanes]
        act = active if lanes is None else active[lanes]
        return (act & ~f).any(dim=1)

    def outputs(self):
        if not self.closest:
            return self.found
        hit = self.bid < ID_MISS
        return (torch.where(hit, self.bt, F32_MAX), torch.where(hit, self.bid, -1),
                torch.where(hit, self.bu, 0.0), torch.where(hit, self.bv, 0.0))


def visit_treelet(st: HitState, lanes, g, tl, tris, o, d, t_lo, t_hi, active, counts: Optional[dict]):
    """Test the rays of tiles `lanes` against treelet row g[i] each (the
    reference walks' step, mcpt_tpu's kernels' packet test: every tested
    ray against every triangle) and update `st`."""
    c = tl.c
    first = tl.row_first[g].long()
    cnt = tl.row_count[g].long()
    j = torch.arange(c, device=first.device)
    tvalid = j[None, :] < cnt[:, None]
    tri = tris[torch.clamp(first[:, None] + j, max=tris.shape[0] - 1)]
    o, d, t_lo, t_hi, act = o[lanes], d[lanes], t_lo[lanes], t_hi[lanes], active[lanes]
    tt, u, v, ok = tv._mt(tri[:, None], o[:, :, None], d[:, :, None],
                          DET_EPS_CLOSEST if st.closest else DET_EPS_ANY)
    lo, hi = t_lo[..., None], t_hi[..., None]
    live = tvalid[:, None, :] & act[..., None]
    if st.closest:
        bt, bid = st.bt[lanes], st.bid[lanes]
        acc = (live & ok & (tt >= lo) & (tt < hi) & (tt <= bt[..., None]) & (u >= 0) & (v >= 0)
               & (1.0 - u - v >= 0))
        row_t = torch.where(acc, tt, float("inf")).amin(dim=-1)
        jj = torch.where(acc & (tt == row_t[..., None]), j, c).amin(dim=-1).clamp(max=c - 1)
        row_id = (first[:, None] + jj).to(torch.int32)
        better = acc.any(dim=-1) & ((row_t < bt) | ((row_t == bt) & (row_id < bid)))
        st.bt[lanes] = torch.where(better, row_t, bt)
        st.bid[lanes] = torch.where(better, row_id, bid)
        st.bu[lanes] = torch.where(better, u.gather(2, jj[..., None])[..., 0], st.bu[lanes])
        st.bv[lanes] = torch.where(better, v.gather(2, jj[..., None])[..., 0], st.bv[lanes])
        tests = int((act.sum(dim=1) * cnt).sum()) if counts is not None else 0
    else:
        acc = (live & ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0) & (tt >= lo) & (tt <= hi))
        fnd = st.found[lanes]
        tests = 0
        if counts is not None:  # a ray stops at its first accept
            first_acc = torch.where(acc, j, c).amin(dim=-1)
            tests = int(torch.where(act & ~fnd, torch.minimum(first_acc + 1, cnt[:, None]), 0).sum())
        st.found[lanes] = fnd | acc.any(dim=-1)
    if counts is not None:
        counts["treelet_visits"] = counts.get("treelet_visits", 0) + int(lanes.shape[0])
        counts["tri_tests"] = counts.get("tri_tests", 0) + tests


def sub_walks(st: HitState, tiles, g, bits, tl, ts, o, d, inv, t_lo, t_hi, active, counts: Optional[dict]):
    """The per-ray walks of treelet row g[i] for the rays of tiles[i]: the
    step of the select and schedule walks (csrc/treelet.cu visit_staged).
    A tested ray computes its own key for the treelet's box (over [t_lo,
    min(t_hi, best_t)] for closest hit; any hit: over [t_lo, t_hi], rays not
    yet occluded only); if it is live (closest hit: its lower bound, `bits`
    low bits cleared, below the ray's best_t bits) the ray walks the
    treelet's sub-BVH from its root. o, d, inv, t_lo, t_hi and active are
    contiguous [n, RAY_TILE] tile views. Returns the entry keys it
    computed."""
    box = tl.blk_box[g // tl.s_b, :, g % tl.s_b][:, :, None]
    bt = st.bt[tiles]
    if st.closest:
        act = active[tiles]
        hi = torch.minimum(t_hi[tiles], bt)
    else:
        act = active[tiles] & ~st.found[tiles]
        hi = t_hi[tiles]
    own = entry_keys(box, o[tiles], inv[tiles], t_lo[tiles], hi, bits, act)[..., 0]
    live = own != KEY_MISS
    if st.closest:
        live &= lower_bound(own, bits) < bt.view(torch.int32)
    ti, ri = torch.nonzero(live, as_tuple=True)
    f, gl = tiles[ti] * RAY_TILE + ri, g[ti]  # the lanes' rays, flat
    ref = tl.row_root[gl].long()
    steps = 2 * int(tl.row_pair_count[gl].max()) + 1 if gl.shape[0] else 0
    args = (ts.pairs, ts.tris, o.reshape(-1, 3)[f], d.reshape(-1, 3)[f], t_lo.reshape(-1)[f],
            t_hi.reshape(-1)[f], ref, tl.tdepth, steps)
    base = dict(tbase=tl.row_first[gl].long(), pbase=tl.row_pair_first[gl].long())
    if st.closest:
        state = [x.view(-1) for x in (st.bt, st.bid, st.bu, st.bv)]
        best = [x[f] for x in state]
        tv.ordered_closest_walk(*args, best, counts, **base)
        for x, y in zip(state, best):
            x[f] = y
    else:
        found = torch.zeros(ref.shape[0], dtype=torch.bool, device=ref.device)
        tv.ordered_any_walk(*args, found, counts, **base)
        st.found.view(-1)[f] = found
    if counts is not None:
        counts["treelet_visits"] = counts.get("treelet_visits", 0) + int(tiles.shape[0])
    return int(act.sum())


def _walk(tl, ts, rays, sched, closest: bool, counts: Optional[dict], packet: bool):
    """Each tile's schedule row front to back (module docstring). The
    kernel's walk visits a treelet by per-ray walks (sub_walks) and takes
    the first key only below the cutoff too; the reference walk tests every
    tested ray against every triangle (visit_treelet), as mcpt_tpu's
    kernels do."""
    n_tiles, v = sched.shape
    bits_g = bits_for(tl.g)
    gmask = (1 << bits_g) - 1
    if n_tiles == 0:
        return HitState(rays[:, 7], closest).outputs()
    outs = []
    rt = rays.shape[0] // n_tiles
    # the reference's [tiles, rt, c] tests, or the walks' [rays, tdepth] stacks
    step = plain_chunk(rt, tl.c if packet else tl.tdepth + 1)
    for c0 in range(0, n_tiles, step):
        c1 = min(n_tiles, c0 + step)
        # contiguous, so that sub_walks reads the lanes of a flat view
        o, d, t_lo, t_hi, active = (x.contiguous() for x in tile_view(rays[c0 * rt:c1 * rt], c1 - c0))
        inv = 1.0 / d
        sc = sched[c0:c1]
        st = HitState(t_hi, closest)
        lanes = torch.nonzero(sc[:, 0] != KEY_MISS)[:, 0]
        if closest and not packet:
            lanes = lanes[lower_bound(sc[lanes, 0], bits_g) < st.cut(active, lanes)]
        keys = 0
        for pos in range(v):
            if lanes.shape[0] == 0:
                break
            g = (sc[lanes, pos] & gmask).long()
            if packet:
                visit_treelet(st, lanes, g, tl, ts.tris, o, d, t_lo, t_hi, active, counts)
            else:
                keys += sub_walks(st, lanes, g, bits_g, tl, ts, o, d, inv, t_lo, t_hi, active, counts)
            if pos + 1 == v:
                break
            nxt = sc[lanes, pos + 1]
            if closest:  # front to back: stop once no later treelet can hold a closer hit
                cont = st.cut(active, lanes) > lower_bound(nxt, bits_g)
            else:
                cont = st.pending(active, lanes)
            lanes = lanes[(nxt != KEY_MISS) & cont]
        out = st.outputs()
        outs.append(tuple(x.reshape(-1) for x in out) if closest else out.reshape(-1))
        if counts is not None and not packet:
            counts["box_keys"] = counts.get("box_keys", 0) + keys
    if closest:
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def closest_hit_schedule_plain(tl, ts, rays, sched, counts: Optional[dict] = None):
    """Plain torch walk (the kernel's) of each tile's schedule over the
    treelet layout `tl` and the traversal tables `ts`: (t, tri, u, v) of
    packed rays in tiles (one schedule row a tile); t = F32_MAX, tri = -1,
    u = v = 0 on a miss. With `counts`, adds the treelet visits, child-pair
    row visits, triangle tests and (ray, box) entry keys."""
    PLAIN_CALLS["closest"] += 1
    return _walk(tl, ts, rays, sched, True, counts, False)


def any_hit_schedule_plain(tl, ts, rays, sched, counts: Optional[dict] = None):
    """Plain torch walk (the kernel's) of each tile's schedule: occlusion
    bool[R]."""
    PLAIN_CALLS["any"] += 1
    return _walk(tl, ts, rays, sched, False, counts, False)


def closest_hit_schedule_packet_plain(tl, ts, rays, sched, counts: Optional[dict] = None):
    """The reference walk, faithful to mcpt_tpu's schedule kernels: each
    key's treelet tested by every tested ray of the tile against every
    triangle (visit_treelet). With `counts`, adds the treelet visits and
    triangle tests, which define the packet-test bound; nothing calls it on
    the way to a kernel."""
    return _walk(tl, ts, rays, sched, True, counts, True)


def any_hit_schedule_packet_plain(tl, ts, rays, sched, counts: Optional[dict] = None):
    """The reference walk for any hit (closest_hit_schedule_packet_plain)."""
    return _walk(tl, ts, rays, sched, False, counts, True)


def check_treelet_inputs(tl, rays, ts=None):
    """Raise ValueError unless the rays and the treelet layout, and with
    `ts` the traversal tables the walks stage, suit csrc/treelet.cu."""
    f32, i32 = torch.float32, torch.int32
    arrays = [("rays", rays, f32), ("sb_box", tl.sb_box, f32), ("blk_box", tl.blk_box, f32),
              ("row_first", tl.row_first, i32), ("row_count", tl.row_count, i32)]
    if ts is not None:
        arrays += [("tris", ts.tris, f32), ("pairs", ts.pairs, f32), ("row_pair_first", tl.row_pair_first, i32),
                   ("row_pair_count", tl.row_pair_count, i32), ("row_root", tl.row_root, i32)]
    for name, x, dt in arrays:
        if not x.is_cuda or not x.is_contiguous() or x.dtype != dt:
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor")
    if rays.dim() != 2 or rays.shape[1] != 8 or rays.shape[0] % RAY_TILE:
        raise ValueError(f"rays must be f32[R, 8] (ops/woop.pack_rays) in tiles of {RAY_TILE}")
    if tl.c > 128 or tl.s_b > 128 or tl.nsp > 1024:
        raise ValueError(f"the kernels stage at most 128 triangles a treelet, 128 slots and 1,024 "
                         f"superblocks (got c={tl.c}, s_b={tl.s_b}, nsp={tl.nsp})")
    if ts is None:
        return
    if ts.tris.dim() != 2 or ts.tris.shape[1] != 12:
        raise ValueError("tris must be f32[T, 12] (ops/traverse.TraversalSet.tris)")
    if ts.tris.data_ptr() % 16 or ts.pairs.data_ptr() % 16:
        raise ValueError("tris and pairs must start on 16 bytes (the kernels copy them in bulk)")
    if not 0 <= tl.tdepth <= tv.STACK_SIZE:
        raise ValueError(f"treelets deeper than the kernels' stack of {tv.STACK_SIZE} entries")


def _launch(kind, tl, ts, rays, sched, outs):
    from mcpt_tpu_torch.ops._build import check, library

    check_treelet_inputs(tl, rays, ts)
    n_tiles = rays.shape[0] // RAY_TILE
    if (not sched.is_cuda or sched.dtype != torch.int32 or not sched.is_contiguous()
            or sched.shape[0] != n_tiles or not 0 < sched.shape[1] <= MAX_V):
        raise ValueError(f"sched must be a contiguous i32[n_tiles, v] CUDA tensor, v <= {MAX_V}")
    if n_tiles == 0:
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(rays.device).cuda_stream)
    fn = getattr(library(), f"schedule_{kind}")
    check(fn(_ptr(rays), _ptr(sched), _ptr(tl.blk_box), _ptr(ts.tris), _ptr(ts.pairs), _ptr(tl.row_first),
             _ptr(tl.row_count), _ptr(tl.row_pair_first), _ptr(tl.row_pair_count), _ptr(tl.row_root), n_tiles,
             sched.shape[1], tl.s_b, bits_for(tl.g), tl.tdepth, *(_ptr(x) for x in outs), stream),
          f"schedule_{kind}")
    LAUNCHES[kind] += 1


def closest_hit_schedule_kernel(tl, ts, rays, sched):
    """Launch csrc/treelet.cu's schedule kernel for closest hit; same
    contract as closest_hit_schedule_plain."""
    R = rays.shape[0]
    outs = (torch.empty(R, device=rays.device), torch.empty(R, dtype=torch.int32, device=rays.device),
            torch.empty(R, device=rays.device), torch.empty(R, device=rays.device))
    _launch("closest", tl, ts, rays, sched, outs)
    return outs


def any_hit_schedule_kernel(tl, ts, rays, sched):
    """Launch csrc/treelet.cu's schedule kernel for any hit; same contract
    as any_hit_schedule_plain."""
    out = torch.empty(rays.shape[0], dtype=torch.bool, device=rays.device)
    _launch("any", tl, ts, rays, sched, (out,))
    return out


def sorted_tiles(scene, org, dirn, t_min, t_max):
    """Packed rays in the ray sort's order (ops/traverse.ray_sort_order),
    padded to whole tiles, and the order."""
    if scene.treelets is None or scene.trav is None:
        raise ValueError("the treelet routes need the scene's BVH and treelet layout "
                         "(scenes above 4,096 triangles, loaded with with_bvh=True)")
    rays = pack_rays(org, dirn, t_min, t_max)
    order = tv.ray_sort_order(scene.trav, rays[:, 0:3], rays[:, 4:7])
    return pad_tiles(rays[order]), order


def scatter_back(out, order, R):
    """Results of sorted, padded rays in the callers' order."""
    def back(x):
        y = torch.empty_like(x[:R])
        y[order] = x[:R]
        return y

    return tuple(back(x) for x in out) if isinstance(out, tuple) else back(out)


def _schedule(scene, org, dirn, t_min, t_max, v, closest):
    R = org.shape[0]
    rays, order = sorted_tiles(scene, org, dirn, t_min, t_max)
    tl, ts = scene.treelets, scene.trav
    sched, incomplete, _ = build_schedule(tl, rays, v)
    if rays.is_cuda:
        out = (closest_hit_schedule_kernel if closest else any_hit_schedule_kernel)(tl, ts, rays, sched)
    else:
        out = (closest_hit_schedule_plain if closest else any_hit_schedule_plain)(tl, ts, rays, sched)
    if bool(incomplete.any()):  # the exact BVH traversal of the incomplete tiles' rays
        inc = incomplete_rays(incomplete)
        if rays.is_cuda:
            fallback = tv.closest_hit_traverse_kernel if closest else tv.any_hit_traverse_kernel
        else:
            fallback = tv.closest_hit_ordered_plain if closest else tv.any_hit_ordered_plain
        trav = fallback(ts, rays[inc])
        for a, b in zip(out, trav) if closest else ((out, trav),):
            a[inc] = b
    return scatter_back(out, order, R)


def incomplete_rays(incomplete):
    """Indices of the rays of the incomplete tiles."""
    tiles = torch.nonzero(incomplete)[:, 0]
    return (tiles[:, None] * RAY_TILE + torch.arange(RAY_TILE, device=tiles.device)).reshape(-1)


def closest_hit_schedule(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX, v: int = DEFAULT_V):
    """(t, tri, u, v) of each ray through the schedule-fed walk: the CUDA
    kernels (pre-pass, walk) on CUDA tensors, the plain versions on CPU
    tensors; incomplete tiles through the BVH traversal."""
    return _schedule(scene, org, dirn, t_min, t_max, v, True)


def any_hit_schedule(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX, v: int = DEFAULT_V):
    """bool[R] occlusion through the schedule-fed walk (see closest_hit_schedule)."""
    return _schedule(scene, org, dirn, t_min, t_max, v, False)
