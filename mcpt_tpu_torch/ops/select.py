"""Treelet traversal with superblock-by-superblock selection: closest hit
and any hit of ray tiles, the route that MCPT_TREELET_SELECT=smem takes.

Port of the function of mcpt_tpu/ops/pallas/select.py (`_closest_kernel`
/ `_any_kernel`): the same hits as the BVH traversal, found by walking the
treelet layout (ops/treelets.py) a superblock at a time. The TPU kernel
reads a per-superblock column-min of the tile's entry keys on its scalar
core; a CUDA block takes the same column-min into shared memory. Per tile
of RAY_TILE sorted rays (one CUDA block, or the plain torch version here):
  1. every tested ray's entry key for every superblock (the reference slab
     test over [t_lo, t_hi]: far * 1.001 on every axis, strict
     max(t_lo, near) < min(t_hi, far); key = f32 bits of max(near, 0) with
     the superblock in the low bits, KEY_MISS on a miss), and their
     column-min over the tile;
  2. superblocks in ascending column-min (front to back), each taken once.
     Stop at KEY_MISS, or for closest hit when the column-min's lower bound
     is >= the cutoff (the largest f32 bits of best_t of the tile's tested
     rays), or for any hit when every tested ray is occluded. Skip a
     superblock unless some tested ray's own key for it is live (closest:
     its lower bound below that ray's best_t; any: the ray not occluded);
  3. inside a superblock, the column-min over the rays of the treelet keys
     (slab over [t_lo, min(t_hi, best_t)] for closest hit; not-occluded
     rays for any hit), and the live slots in ascending key (front to
     back). Closest hit stops at the first slot whose lower bound is >= the
     cutoff, which is refreshed after every treelet (the TPU kernel walked
     slot order, as its scalar core could not sort, and refreshed the
     cutoff every CUT_REFRESH = 4 pairs);
  4. for each slot visited, every tested ray whose own key for the treelet
     is live (its slab test of the treelet's box over [t_lo, min(t_hi,
     best_t)] with its current best_t, and for closest hit a lower bound
     below its best_t bits; any hit: not occluded) walks the treelet's
     sub-BVH from its root, as the BVH traversal walks the whole tree
     (ops/traverse.ordered_closest_walk / ordered_any_walk over the
     treelet's rows of the child-pair table and its triangles, refs made
     local). The TPU kernel tested every ray of the tile against every
     triangle of the treelet instead; that reference walk stays here as
     closest_hit_select_packet_plain / any_hit_select_packet_plain.
The accept predicates and the (min t, lowest id) rule are those of
ops/intersect.py and traverse.cu, so the kernels equal their plain
versions bit for bit. A ray's walk culls a box at its running best_t, as
the BVH walk does, so both can differ from the reference walk only in the
one-ulp box-face case of ROADMAP queue 3 item 4.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mcpt_tpu_torch.ops import schedule as sc
from mcpt_tpu_torch.ops.intersect import F32_MAX, T_MIN
from mcpt_tpu_torch.ops.woop import _ptr

RAY_TILE = sc.RAY_TILE
KEY_MISS = sc.KEY_MISS

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}

_NEED, _WALK, _DONE = 0, 1, 2


def _visit_order(tcol, ascending: bool):
    """Each tile's live slots [n, s_b] in visiting order (ascending key, or
    ascending slot), KEY_MISS slots after them."""
    if ascending:  # live keys differ in their low bits, KEY_MISS is the largest
        return torch.argsort(tcol, dim=1, stable=True)
    return torch.argsort((tcol == KEY_MISS).to(torch.int32), dim=1, stable=True)


def _walk(tl, ts, rays, closest: bool, counts: Optional[dict], reference: bool):
    """The select loop nest for every tile of packed rays (module
    docstring). The kernels' walk takes a superblock's live slots in
    ascending key, the first one past the cutoff ending it, and each visit
    runs the per-ray walks (ops/schedule.sub_walks, the step the schedule
    walk shares); the reference walk takes them in slot order, skipping
    those past the cutoff, and each visit tests every tested ray against
    every triangle (ops/schedule.visit_treelet), as mcpt_tpu's kernels do.
    Each counts the entry keys its kernel computes: the kernels' only over
    the ns real superblock columns and a superblock's slots up to its last
    real treelet (pad boxes always miss), mcpt_tpu's over all NSp columns
    and S_B slots."""
    n_tiles = rays.shape[0] // RAY_TILE
    dev = rays.device
    bits_ns, bits_sb = sc.bits_for(tl.nsp), sc.bits_for(tl.s_b)
    s_b = tl.s_b
    pos = torch.arange(s_b, device=dev)
    if reference:
        chunk, n_cols = sc.plain_chunk(RAY_TILE, max(tl.c, tl.nsp)), tl.nsp
        n_slots = torch.full((tl.ns,), s_b, device=dev)
    else:
        chunk, n_cols = sc.plain_chunk(RAY_TILE, s_b), tl.ns
        n_slots = ((tl.row_count.view(tl.ns, s_b) > 0).long() * (pos + 1)).amax(dim=1)
    if n_tiles == 0:
        return sc.HitState(rays[:, 7], closest).outputs()
    outs = []
    for c0 in range(0, n_tiles, chunk):
        n = min(n_tiles, c0 + chunk) - c0
        # contiguous, so that sub_walks reads the lanes of a flat view
        o, d, t_lo, t_hi, active = (x.contiguous() for x in sc.tile_view(rays[c0 * RAY_TILE:(c0 + n) * RAY_TILE], n))
        inv = 1.0 / d
        st = sc.HitState(t_hi, closest)
        sub = sc.plain_chunk(RAY_TILE, tl.nsp)  # the [tiles, RAY_TILE, NSp] keys a part at a time
        colmin = torch.cat([sc.entry_keys(tl.sb_box[None, :, :tl.ns], o[i:i + sub], inv[i:i + sub],
                                          t_lo[i:i + sub], t_hi[i:i + sub], bits_ns, active[i:i + sub]).amin(dim=1)
                            for i in range(0, n, sub)])
        keys = int(active.sum()) * n_cols  # (ray, box) entry keys the kernel computes
        state = torch.full((n,), _NEED, dtype=torch.int64, device=dev)
        sbk = torch.zeros(n, dtype=torch.int64, device=dev)  # current superblock
        cursor = torch.zeros(n, dtype=torch.int64, device=dev)  # next position in its visiting order
        tcol = torch.full((n, s_b), KEY_MISS, dtype=torch.int32, device=dev)
        order = torch.zeros((n, s_b), dtype=torch.int64, device=dev)
        for _ in range(tl.nsp * (s_b + 1) + 1):  # every step takes a slot or a superblock
            # superblocks, until each tile has a treelet to test or is done
            for _ in range(tl.nsp + 1):
                walk = torch.nonzero(state == _WALK)[:, 0]
                if walk.shape[0]:  # the next position at or after the cursor to visit
                    tk = tcol[walk].gather(1, order[walk])
                    ok = tk != KEY_MISS
                    if closest:
                        ok &= sc.lower_bound(tk, bits_sb) < st.cut(active, walk)[:, None]
                    k = torch.where(ok & (pos[None, :] >= cursor[walk, None]), pos, s_b).amin(dim=1)
                    if not reference:  # ascending keys: the first slot at or past the cutoff ends it
                        k = torch.where(k == cursor[walk], k, s_b)
                    cursor[walk] = k
                    state[walk[k == s_b]] = _NEED
                need = torch.nonzero(state == _NEED)[:, 0]
                if need.shape[0] == 0:
                    break
                m, s = colmin[need].min(dim=1)
                colmin[need, s] = KEY_MISS
                stop = m == KEY_MISS
                if closest:
                    stop |= sc.lower_bound(m, bits_ns) >= st.cut(active, need)
                else:
                    stop |= ~st.pending(active, need)
                state[need[stop]] = _DONE
                need, s = need[~stop], s[~stop]
                # is the superblock live for some tested ray of the tile?
                box = tl.sb_box[:, s].T[:, :, None]
                own = sc.entry_keys(box, o[need], inv[need], t_lo[need], t_hi[need], bits_ns, active[need])[..., 0]
                keys += int(active[need].sum())
                if closest:
                    live = (own != KEY_MISS) & (sc.lower_bound(own, bits_ns) < st.bt[need].view(torch.int32))
                else:
                    live = (own != KEY_MISS) & ~st.found[need]
                go = live.any(dim=1)
                need, s = need[go], s[go]
                if need.shape[0] == 0:
                    continue
                sbk[need], cursor[need], state[need] = s, 0, _WALK
                hi = torch.minimum(t_hi[need], st.bt[need]) if closest else t_hi[need]
                act = active[need] if closest else active[need] & ~st.found[need]
                tcol[need] = sc.entry_keys(tl.blk_box[s], o[need], inv[need], t_lo[need], hi, bits_sb,
                                           act).amin(dim=1)
                order[need] = _visit_order(tcol[need], not reference)
                keys += int((act.sum(dim=1) * n_slots[s]).sum())
            else:
                raise RuntimeError("superblock selection did not settle")
            walk = torch.nonzero(state == _WALK)[:, 0]
            if walk.shape[0] == 0:
                break
            g = sbk[walk] * s_b + order[walk, cursor[walk]]
            if reference:
                sc.visit_treelet(st, walk, g, tl, ts.tris, o, d, t_lo, t_hi, active, counts)
            else:
                keys += sc.sub_walks(st, walk, g, bits_sb, tl, ts, o, d, inv, t_lo, t_hi, active, counts)
            cursor[walk] += 1
            if not closest:
                state[walk[~st.pending(active, walk)]] = _DONE
        else:
            raise RuntimeError("the select walk did not end")
        out = st.outputs()
        outs.append(tuple(x.reshape(-1) for x in out) if closest else out.reshape(-1))
        if counts is not None:
            counts["box_keys"] = counts.get("box_keys", 0) + keys
    if closest:
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def closest_hit_select_plain(tl, ts, rays, counts: Optional[dict] = None):
    """Plain torch select walk (the kernel's) of packed rays in tiles of
    RAY_TILE over the treelet layout `tl` and the traversal tables `ts`:
    (t, tri, u, v), t = F32_MAX, tri = -1, u = v = 0 on a miss. With
    `counts`, adds the treelet visits, child-pair row visits, triangle
    tests and (ray, box) entry keys."""
    PLAIN_CALLS["closest"] += 1
    return _walk(tl, ts, rays, True, counts, False)


def any_hit_select_plain(tl, ts, rays, counts: Optional[dict] = None):
    """Plain torch select walk (the kernel's): occlusion bool[R]."""
    PLAIN_CALLS["any"] += 1
    return _walk(tl, ts, rays, False, counts, False)


def closest_hit_select_packet_plain(tl, ts, rays, counts: Optional[dict] = None):
    """The reference walk, faithful to mcpt_tpu's select kernels: the same
    loop nest in slot order, each visit testing every tested ray of the tile
    against every triangle of the treelet (ops/schedule.visit_treelet). Its
    counts define the packet-test bound; nothing on the render path calls
    it."""
    return _walk(tl, ts, rays, True, counts, True)


def any_hit_select_packet_plain(tl, ts, rays, counts: Optional[dict] = None):
    """The reference walk for any hit (closest_hit_select_packet_plain)."""
    return _walk(tl, ts, rays, False, counts, True)


def _launch(kind, tl, ts, rays, outs):
    from mcpt_tpu_torch.ops._build import check, library

    sc.check_treelet_inputs(tl, rays, ts)
    n_tiles = rays.shape[0] // RAY_TILE
    if n_tiles == 0:
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(rays.device).cuda_stream)
    fn = getattr(library(), f"select_{kind}")
    check(fn(_ptr(rays), _ptr(tl.sb_box), _ptr(tl.blk_box), _ptr(ts.tris), _ptr(ts.pairs), _ptr(tl.row_first),
             _ptr(tl.row_count), _ptr(tl.row_pair_first), _ptr(tl.row_pair_count), _ptr(tl.row_root), n_tiles,
             tl.ns, tl.nsp, tl.s_b, sc.bits_for(tl.nsp), sc.bits_for(tl.s_b), tl.tdepth,
             *(_ptr(x) for x in outs), stream), f"select_{kind}")
    LAUNCHES[kind] += 1


def closest_hit_select_kernel(tl, ts, rays):
    """Launch csrc/treelet.cu's select kernel for closest hit; same contract
    as closest_hit_select_plain."""
    R = rays.shape[0]
    outs = (torch.empty(R, device=rays.device), torch.empty(R, dtype=torch.int32, device=rays.device),
            torch.empty(R, device=rays.device), torch.empty(R, device=rays.device))
    _launch("closest", tl, ts, rays, outs)
    return outs


def any_hit_select_kernel(tl, ts, rays):
    """Launch csrc/treelet.cu's select kernel for any hit; same contract as
    any_hit_select_plain."""
    out = torch.empty(rays.shape[0], dtype=torch.bool, device=rays.device)
    _launch("any", tl, ts, rays, (out,))
    return out


def _select(scene, org, dirn, t_min, t_max, closest):
    R = org.shape[0]
    rays, order = sc.sorted_tiles(scene, org, dirn, t_min, t_max)
    tl, ts = scene.treelets, scene.trav
    if rays.is_cuda:
        out = (closest_hit_select_kernel if closest else any_hit_select_kernel)(tl, ts, rays)
    else:
        out = (closest_hit_select_plain if closest else any_hit_select_plain)(tl, ts, rays)
    return sc.scatter_back(out, order, R)


def closest_hit_select(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX):
    """(t, tri, u, v) of each ray through the select walk: the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    return _select(scene, org, dirn, t_min, t_max, True)


def any_hit_select(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX):
    """bool[R] occlusion through the select walk (see closest_hit_select)."""
    return _select(scene, org, dirn, t_min, t_max, False)
