"""Schedule-fed treelet traversal: closest hit and any hit of ray tiles
walking a precomputed list of treelets.

Port of mcpt_tpu/ops/pallas/schedule.py (the kernel pair `_closest_kernel`
/ `_any_kernel` and its pre-pass `build_schedule`), over the treelet layout
of ops/treelets.py:
  pre-pass (torch, `build_schedule`): per tile of RAY_TILE sorted rays,
    the bundle's componentwise origin, direction and t intervals; one
    interval slab test against every treelet box (the reference's far *
    1.001 where far > 0, strict lo < hi); the hits packed as int32 keys
    (high bits: f32 bits of the entry lower bound; low bits: the treelet
    row), sorted ascending (front to back) and cut to V. A tile with more
    than V live treelets is incomplete: its row is blanked to KEY_MISS and
    its rays go through the exact BVH traversal (ops/traverse.py) instead.
    The keys equal mcpt_tpu's bit for bit.
  walk (csrc/treelet.cu, one CUDA block a tile, or the plain torch version
    here): for each key in order, test every ray of the tile against every
    triangle of that treelet; stop at KEY_MISS, or, for closest hit, when
    the next key's lower bound is >= the largest best_t of the tile's
    tested rays (int compare of f32 bits, both >= 0), or, for any hit, when
    every tested ray is occluded. The check runs after every treelet (the
    TPU kernel checked every fourth pair: a scalar-core round trip there,
    one barrier here).
Accept predicates are those of ops/intersect.py: closest hit |det| >= 1e-5,
t_lo <= t < t_hi, u, v >= 0, 1 - u - v >= 0, the smallest (t, triangle id);
any hit |det| >= 1e-6, t_lo <= t <= t_hi, 0 <= u <= 1, v >= 0, u + v <= 1.
Rays with an empty interval or a parked origin (|o| >= 1e29) are not
tested and miss, as in the other kernel pairs. Moller-Trumbore is
ops/traverse.py's, single rounded f32 operations in one order, so the
kernels equal their plain versions, and the BVH traversal's results, bit
for bit.

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
_PLAIN_PAIRS = 1 << 25  # (ray, triangle) pairs a plain-walk chunk: bounds its [tiles, RAY_TILE, C] temporaries

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


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


def _interval_slab(olo, ohi, dlo, dhi, tlo, thi, blo, bhi, valid_box):
    """Bundle-vs-box test and entry lower bound [tiles, G] (mcpt_tpu
    _interval_slab): interval arithmetic per axis, an axis whose directions
    change sign unbounded; far * 1.001 where far > 0; hit iff lo < hi."""
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
    hit = valid_box[None, :] & (torch.maximum(tlo[:, None], near) < torch.minimum(thi[:, None], far))
    # max(near, 0) with +0 where XLA's max gives +0 (torch.maximum keeps -0);
    # NaN near is a miss and its key is KEY_MISS either way
    return hit, torch.where(near > 0, near, 0.0)


def build_schedule(tl, rays: torch.Tensor, v: int = DEFAULT_V):
    """Keys i32[n_tiles, v], incomplete bool[n_tiles] and live treelets
    i32[n_tiles] of packed, sorted rays (a multiple of RAY_TILE of them):
    mcpt_tpu's build_schedule bit for bit, the [n_tiles, v/4, 4] row laid
    out flat. Runs in chunks of tiles; the result does not depend on them."""
    g_total = tl.g
    bits_g = bits_for(g_total)
    n_tiles = rays.shape[0] // RAY_TILE
    dev = rays.device
    bb = tl.blk_box.permute(0, 2, 1).reshape(g_total, 8)
    blo, bhi, valid_box = bb[:, 0:3], bb[:, 3:6], bb[:, 6] > 0.0
    bounds = _bundle_bounds(rays)
    gid = torch.arange(g_total, dtype=torch.int32, device=dev)
    sched = torch.empty((n_tiles, v), dtype=torch.int32, device=dev)
    n_live = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    step = max(1, _PREPASS_PAIRS // max(g_total, 1))
    for i0 in range(0, n_tiles, step):
        sl = slice(i0, min(n_tiles, i0 + step))
        hit, entry = _interval_slab(*(b[sl] for b in bounds), blo, bhi, valid_box)
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
    return sched, n_live > v, n_live


# ---------------------------------------------------------------------------
# Plain versions: one treelet a step for every live tile of a chunk
# ---------------------------------------------------------------------------


def plain_chunk(rt: int, c: int) -> int:
    """Tiles a plain-walk chunk holds."""
    return max(1, _PLAIN_PAIRS // (rt * c))


def tile_view(rays: torch.Tensor, n_tiles: int):
    """o, d [n, rt, 3], t_lo, t_hi [n, rt] and the tested rays [n, rt] of
    packed rays laid out as n_tiles tiles."""
    ry = rays.reshape(n_tiles, -1, 8)
    o, t_lo, d, t_hi = ry[..., 0:3], ry[..., 3], ry[..., 4:7], ry[..., 7]
    active = (t_lo < t_hi) & (torch.abs(o) < PARKED).all(dim=-1)
    return o, d, t_lo, t_hi, active


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
    step every kernel of csrc/treelet.cu shares) and update `st`."""
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


def _walk(tl, tris, rays, sched, closest: bool, counts: Optional[dict]):
    n_tiles, v = sched.shape
    bits_g = bits_for(tl.g)
    gmask = (1 << bits_g) - 1
    if n_tiles == 0:
        return HitState(rays[:, 7], closest).outputs()
    outs = []
    rt = rays.shape[0] // n_tiles
    step = plain_chunk(rt, tl.c)
    for c0 in range(0, n_tiles, step):
        c1 = min(n_tiles, c0 + step)
        o, d, t_lo, t_hi, active = tile_view(rays[c0 * rt:c1 * rt], c1 - c0)
        sc = sched[c0:c1]
        st = HitState(t_hi, closest)
        lanes = torch.arange(c1 - c0, device=rays.device)
        for pos in range(v):
            lanes = lanes[sc[lanes, pos] != KEY_MISS]
            if lanes.shape[0] == 0:
                break
            visit_treelet(st, lanes, (sc[lanes, pos] & gmask).long(), tl, tris, o, d, t_lo, t_hi,
                         active, counts)
            if pos + 1 == v:
                break
            nxt = sc[lanes, pos + 1]
            if closest:  # front to back: stop once no later treelet can hold a closer hit
                cont = st.cut(active, lanes) > ((nxt >> bits_g) << bits_g)
            else:
                cont = st.pending(active, lanes)
            lanes = lanes[(nxt != KEY_MISS) & cont]
        out = st.outputs()
        outs.append(tuple(x.reshape(-1) for x in out) if closest else out.reshape(-1))
    if closest:
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def closest_hit_schedule_plain(tl, tris, rays, sched, counts: Optional[dict] = None):
    """Plain torch walk of each tile's schedule: (t, tri, u, v) of packed
    rays in tiles (one schedule row a tile); t = F32_MAX, tri = -1, u = v =
    0 on a miss. With `counts`, adds the treelet visits and triangle tests."""
    PLAIN_CALLS["closest"] += 1
    return _walk(tl, tris, rays, sched, True, counts)


def any_hit_schedule_plain(tl, tris, rays, sched, counts: Optional[dict] = None):
    """Plain torch walk of each tile's schedule: occlusion bool[R]."""
    PLAIN_CALLS["any"] += 1
    return _walk(tl, tris, rays, sched, False, counts)


def check_treelet_inputs(tl, tris, rays):
    """Raise ValueError unless the tables and rays suit csrc/treelet.cu."""
    for name, x, dt in (("rays", rays, torch.float32), ("tris", tris, torch.float32),
                        ("sb_box", tl.sb_box, torch.float32), ("blk_box", tl.blk_box, torch.float32),
                        ("row_first", tl.row_first, torch.int32), ("row_count", tl.row_count, torch.int32)):
        if not x.is_cuda or not x.is_contiguous() or x.dtype != dt:
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor")
    if rays.dim() != 2 or rays.shape[1] != 8 or rays.shape[0] % RAY_TILE:
        raise ValueError(f"rays must be f32[R, 8] (ops/woop.pack_rays) in tiles of {RAY_TILE}")
    if tris.dim() != 2 or tris.shape[1] != 12:
        raise ValueError("tris must be f32[T, 12] (ops/traverse.TraversalSet.tris)")
    if tl.c > 128 or tl.s_b > 128 or tl.nsp > 1024:
        raise ValueError(f"the kernels stage at most 128 triangles a treelet, 128 slots and 1,024 "
                         f"superblocks (got c={tl.c}, s_b={tl.s_b}, nsp={tl.nsp})")


def _launch(kind, tl, tris, rays, sched, outs):
    from mcpt_tpu_torch.ops._build import check, library

    check_treelet_inputs(tl, tris, rays)
    n_tiles = rays.shape[0] // RAY_TILE
    if (not sched.is_cuda or sched.dtype != torch.int32 or not sched.is_contiguous()
            or sched.shape[0] != n_tiles or not 0 < sched.shape[1] <= MAX_V):
        raise ValueError(f"sched must be a contiguous i32[n_tiles, v] CUDA tensor, v <= {MAX_V}")
    if n_tiles == 0:
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(rays.device).cuda_stream)
    fn = getattr(library(), f"schedule_{kind}")
    check(fn(_ptr(rays), _ptr(sched), _ptr(tris), _ptr(tl.row_first), _ptr(tl.row_count), n_tiles,
             sched.shape[1], bits_for(tl.g), *(_ptr(x) for x in outs), stream), f"schedule_{kind}")
    LAUNCHES[kind] += 1


def closest_hit_schedule_kernel(tl, tris, rays, sched):
    """Launch csrc/treelet.cu's schedule_closest_kernel; same contract as the plain version."""
    R = rays.shape[0]
    outs = (torch.empty(R, device=rays.device), torch.empty(R, dtype=torch.int32, device=rays.device),
            torch.empty(R, device=rays.device), torch.empty(R, device=rays.device))
    _launch("closest", tl, tris, rays, sched, outs)
    return outs


def any_hit_schedule_kernel(tl, tris, rays, sched):
    """Launch csrc/treelet.cu's schedule_any_kernel; same contract as the plain version."""
    out = torch.empty(rays.shape[0], dtype=torch.bool, device=rays.device)
    _launch("any", tl, tris, rays, sched, (out,))
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
    tl, tris = scene.treelets, scene.trav.tris
    sched, incomplete, _ = build_schedule(tl, rays, v)
    kind = "closest" if closest else "any"
    if rays.is_cuda:
        out = (closest_hit_schedule_kernel if closest else any_hit_schedule_kernel)(tl, tris, rays, sched)
    else:
        out = (closest_hit_schedule_plain if closest else any_hit_schedule_plain)(tl, tris, rays, sched)
    if bool(incomplete.any()):
        # the exact BVH traversal over the incomplete tiles' rays; the others
        # get t_max = 0, which tests nothing
        inc = incomplete.repeat_interleave(RAY_TILE)
        fb = rays.clone()
        fb[:, 7] = torch.where(inc, rays[:, 7], 0.0)
        if rays.is_cuda:
            fallback = tv.closest_hit_traverse_kernel if closest else tv.any_hit_traverse_kernel
        else:
            fallback = tv.closest_hit_ordered_plain if closest else tv.any_hit_ordered_plain
        trav = fallback(scene.trav, fb)
        out = (tuple(torch.where(inc, a, b) for a, b in zip(trav, out)) if closest
               else torch.where(inc, trav, out))
    return scatter_back(out, order, R)


def closest_hit_schedule(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX, v: int = DEFAULT_V):
    """(t, tri, u, v) of each ray through the schedule-fed walk: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors; incomplete
    tiles through the BVH traversal."""
    return _schedule(scene, org, dirn, t_min, t_max, v, True)


def any_hit_schedule(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX, v: int = DEFAULT_V):
    """bool[R] occlusion through the schedule-fed walk (see closest_hit_schedule)."""
    return _schedule(scene, org, dirn, t_min, t_max, v, False)
