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
     rays for any hit), then the slots in slot order: test the tile against
     each treelet whose key is not KEY_MISS and (closest) whose lower bound
     is below the cutoff, which is refreshed after every treelet (the TPU
     kernel refreshed it every CUT_REFRESH = 4 pairs, a scalar-core round
     trip there; one block reduction here).
The treelet test is ops/schedule.visit_treelet's, with the accept predicates
and the (min t, lowest id) rule of ops/intersect.py, so the kernels equal
their plain versions, and the BVH traversal's results, bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mcpt_tpu_torch.ops import schedule as sc
from mcpt_tpu_torch.ops.intersect import F32_MAX, T_MIN
from mcpt_tpu_torch.ops.traverse import FAR_FUDGE
from mcpt_tpu_torch.ops.woop import _ptr

RAY_TILE = sc.RAY_TILE
KEY_MISS = sc.KEY_MISS

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}

_NEED, _WALK, _DONE = 0, 1, 2


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
        far = torch.minimum(far, torch.maximum(ta, tb) * FAR_FUDGE)
    hit = (box[:, None, 6, :] > 0.0) & (torch.maximum(t_lo[..., None], near) < torch.minimum(t_hi[..., None], far))
    entry = torch.where(near > 0, near, 0.0)  # +0 for -0: the bits are the key
    ids = torch.arange(box.shape[2], dtype=torch.int32, device=o.device)
    key = ((entry.view(torch.int32) >> bits) << bits) | ids
    return torch.where(hit & active[..., None], key, KEY_MISS)


def _lb(key, bits):
    return (key >> bits) << bits


def _walk(tl, tris, rays, closest: bool, counts: Optional[dict]):
    n_tiles = rays.shape[0] // RAY_TILE
    dev = rays.device
    bits_ns, bits_sb = sc.bits_for(tl.nsp), sc.bits_for(tl.s_b)
    s_b = tl.s_b
    slot = torch.arange(s_b, device=dev)
    if n_tiles == 0:
        return sc.HitState(rays[:, 7], closest).outputs()
    outs = []
    step = sc.plain_chunk(RAY_TILE, max(tl.c, tl.nsp))
    for c0 in range(0, n_tiles, step):
        n = min(n_tiles, c0 + step) - c0
        o, d, t_lo, t_hi, active = sc.tile_view(rays[c0 * RAY_TILE:(c0 + n) * RAY_TILE], n)
        inv = 1.0 / d
        st = sc.HitState(t_hi, closest)
        colmin = entry_keys(tl.sb_box[None], o, inv, t_lo, t_hi, bits_ns, active).amin(dim=1)
        keys = int(active.sum()) * tl.nsp  # (ray, box) entry keys the kernel computes
        state = torch.full((n,), _NEED, dtype=torch.int64, device=dev)
        sbk = torch.zeros(n, dtype=torch.int64, device=dev)  # current superblock
        cursor = torch.zeros(n, dtype=torch.int64, device=dev)
        tcol = torch.full((n, s_b), KEY_MISS, dtype=torch.int32, device=dev)
        for _ in range(tl.nsp * (s_b + 1) + 1):  # every step takes a slot or a superblock
            # superblocks, until each tile has a treelet to test or is done
            for _ in range(tl.nsp + 1):
                walk = torch.nonzero(state == _WALK)[:, 0]
                if walk.shape[0]:  # next live slot at or after the cursor
                    tk = tcol[walk]
                    live = (tk != KEY_MISS) & (slot[None, :] >= cursor[walk, None])
                    if closest:
                        live &= _lb(tk, bits_sb) < st.cut(active, walk)[:, None]
                    k = torch.where(live, slot, s_b).amin(dim=1)
                    cursor[walk] = k
                    state[walk[k == s_b]] = _NEED
                need = torch.nonzero(state == _NEED)[:, 0]
                if need.shape[0] == 0:
                    break
                m, s = colmin[need].min(dim=1)
                colmin[need, s] = KEY_MISS
                stop = m == KEY_MISS
                if closest:
                    stop |= _lb(m, bits_ns) >= st.cut(active, need)
                else:
                    stop |= ~st.pending(active, need)
                state[need[stop]] = _DONE
                need, s = need[~stop], s[~stop]
                # is the superblock live for some tested ray of the tile?
                box = tl.sb_box[:, s].T[:, :, None]
                own = entry_keys(box, o[need], inv[need], t_lo[need], t_hi[need], bits_ns, active[need])[..., 0]
                keys += int(active[need].sum())
                if closest:
                    live = (own != KEY_MISS) & (_lb(own, bits_ns) < st.bt[need].view(torch.int32))
                else:
                    live = (own != KEY_MISS) & ~st.found[need]
                go = live.any(dim=1)
                need, s = need[go], s[go]
                if need.shape[0] == 0:
                    continue
                sbk[need], cursor[need], state[need] = s, 0, _WALK
                hi = torch.minimum(t_hi[need], st.bt[need]) if closest else t_hi[need]
                act = active[need] if closest else active[need] & ~st.found[need]
                tcol[need] = entry_keys(tl.blk_box[s], o[need], inv[need], t_lo[need], hi, bits_sb,
                                        act).amin(dim=1)
                keys += int(act.sum()) * s_b
            else:
                raise RuntimeError("superblock selection did not settle")
            walk = torch.nonzero(state == _WALK)[:, 0]
            if walk.shape[0] == 0:
                break
            sc.visit_treelet(st, walk, sbk[walk] * s_b + cursor[walk], tl, tris, o, d, t_lo, t_hi,
                             active, counts)
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


def closest_hit_select_plain(tl, tris, rays, counts: Optional[dict] = None):
    """Plain torch select walk of packed rays in tiles of RAY_TILE: (t, tri,
    u, v), t = F32_MAX, tri = -1, u = v = 0 on a miss. With `counts`, adds
    the treelet visits, triangle tests and (ray, box) entry keys."""
    PLAIN_CALLS["closest"] += 1
    return _walk(tl, tris, rays, True, counts)


def any_hit_select_plain(tl, tris, rays, counts: Optional[dict] = None):
    """Plain torch select walk: occlusion bool[R]."""
    PLAIN_CALLS["any"] += 1
    return _walk(tl, tris, rays, False, counts)


def _launch(kind, tl, tris, rays, outs):
    from mcpt_tpu_torch.ops._build import check, library

    sc.check_treelet_inputs(tl, tris, rays)
    n_tiles = rays.shape[0] // RAY_TILE
    if n_tiles == 0:
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(rays.device).cuda_stream)
    fn = getattr(library(), f"select_{kind}")
    check(fn(_ptr(rays), _ptr(tl.sb_box), _ptr(tl.blk_box), _ptr(tris), _ptr(tl.row_first),
             _ptr(tl.row_count), n_tiles, tl.nsp, tl.s_b, sc.bits_for(tl.nsp), sc.bits_for(tl.s_b),
             *(_ptr(x) for x in outs), stream), f"select_{kind}")
    LAUNCHES[kind] += 1


def closest_hit_select_kernel(tl, tris, rays):
    """Launch csrc/treelet.cu's select_closest_kernel; same contract as the plain version."""
    R = rays.shape[0]
    outs = (torch.empty(R, device=rays.device), torch.empty(R, dtype=torch.int32, device=rays.device),
            torch.empty(R, device=rays.device), torch.empty(R, device=rays.device))
    _launch("closest", tl, tris, rays, outs)
    return outs


def any_hit_select_kernel(tl, tris, rays):
    """Launch csrc/treelet.cu's select_any_kernel; same contract as the plain version."""
    out = torch.empty(rays.shape[0], dtype=torch.bool, device=rays.device)
    _launch("any", tl, tris, rays, (out,))
    return out


def _select(scene, org, dirn, t_min, t_max, closest):
    R = org.shape[0]
    rays, order = sc.sorted_tiles(scene, org, dirn, t_min, t_max)
    tl, tris = scene.treelets, scene.trav.tris
    if rays.is_cuda:
        out = (closest_hit_select_kernel if closest else any_hit_select_kernel)(tl, tris, rays)
    else:
        out = (closest_hit_select_plain if closest else any_hit_select_plain)(tl, tris, rays)
    return sc.scatter_back(out, order, R)


def closest_hit_select(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX):
    """(t, tri, u, v) of each ray through the select walk: the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    return _select(scene, org, dirn, t_min, t_max, True)


def any_hit_select(scene, org, dirn, t_min=T_MIN, t_max=F32_MAX):
    """bool[R] occlusion through the select walk (see closest_hit_select)."""
    return _select(scene, org, dirn, t_min, t_max, False)
