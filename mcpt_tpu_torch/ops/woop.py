"""Woop-transform closest-hit and any-hit for mid-size scenes (veach class).

Port of mcpt_tpu/ops/pallas/woop.py. Triangles are in BVH order, so a
contiguous chunk of `chunk` triangles is spatially coherent and has a
tight box. Rays come in tiles of RAY_TILE (one CUDA block each); a
conservative interval-arithmetic bundle test (`tile_chunk_mask`) gives every
tile a bitmask of the chunks any of its rays can reach, and only those
chunks are tested. The accept predicates are those of ops/intersect.py.

Each function comes twice: the hand-written CUDA kernels in csrc/woop.cu,
launched by `closest_hit_woop` / `any_hit_woop` on CUDA tensors, and the
plain torch versions `closest_hit_woop_plain` / `any_hit_woop_plain`, which
the wrappers run on CPU tensors and which the card compares the kernels
with. Both write the projection o' = W o + p, d' = W d (the [R,8] @ [8,6C]
product of the TPU kernel) as its nonzero terms, multiplied and summed left
to right with every operation rounded to f32 and no fused multiply-add:
a library matmul sums in an order of its own, which moves results by an
ulp and flips rays that graze the hard accept thresholds. So the kernel
and its plain version agree bit for bit. The kernels put a division-free
interval pre-test in front of the exact predicate, which rejects a pair
only where the exact path would; any_pretest_rejects and
closest_pretest_rejects are its torch mirrors, which the tests hold to
the exact predicates.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from mcpt_tpu_torch.ops.intersect import DET_EPS_ANY, DET_EPS_CLOSEST, F32_MAX, _woop_tables, woop_eps

RAY_TILE = 256  # rays per CUDA block, and per chunk-mask tile
MAX_CHUNKS = 32  # chunk bits in one i32 mask word
_PLAIN_RAYS = 1 << 15  # rays per plain-version wave, bounds [R, C] temporaries
PARKED = 1e29  # |origin| of a lane parked outside the scene (integrator)

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


def auto_chunk(n_tris: int) -> int:
    """Triangles per cullable chunk: ~3 chunks a scene, a multiple of 128 in
    [128, 1024] (mcpt_tpu.ops.pallas.woop._auto_chunk)."""
    c = -(-n_tris // (3 * 128)) * 128
    return max(128, min(1024, c))


@dataclass(frozen=True)
class WoopSet:
    """Per-scene kernel tables, packed once by pack_woop_table.

    tbl row 4k+i holds W[k, i] (i < 3) or p[k] (i = 3) of every triangle,
    one column per triangle, padded with zero rows to n_chunks*chunk
    columns; a pad triangle has eps = F32_MAX and never accepts. boxes row c
    is chunk c's box (lo.xyz, hi.xyz) over its real triangles.
    """

    tbl: torch.Tensor  # f32[12, Tp]
    eps_closest: torch.Tensor  # f32[Tp]
    eps_any: torch.Tensor  # f32[Tp]
    boxes: torch.Tensor  # f32[n_chunks, 6]
    chunk: int
    n_chunks: int
    n_tris: int  # real triangles; the last chunk's tail is padding


def pack_woop_table(v0, e1, e2, chunk: int | None = None) -> WoopSet:
    """Geometry (in BVH order) -> WoopSet, `chunk` triangles a chunk
    (auto_chunk by default). Raises ValueError beyond MAX_CHUNKS chunks."""
    T = v0.shape[0]
    chunk = auto_chunk(T) if chunk is None else chunk
    n_chunks = max(1, -(-T // chunk))
    if n_chunks > MAX_CHUNKS:
        raise ValueError(f"{n_chunks} chunks of {chunk} triangles exceed the "
                         f"{MAX_CHUNKS}-bit chunk mask")
    Tp = n_chunks * chunk
    wp, inv = _woop_tables(v0, e1, e2)
    tbl = torch.nn.functional.pad(wp.reshape(T, 12).T, (0, Tp - T))
    inv = torch.nn.functional.pad(inv, (0, Tp - T))

    p0, p1, p2 = v0, v0 + e1, v0 + e2
    lo = torch.minimum(torch.minimum(p0, p1), p2)
    hi = torch.maximum(torch.maximum(p0, p1), p2)
    F = torch.full((Tp - T, 3), F32_MAX, device=v0.device)
    lo = torch.cat([lo, F]).reshape(n_chunks, chunk, 3).amin(dim=1)
    hi = torch.cat([hi, -F]).reshape(n_chunks, chunk, 3).amax(dim=1)
    return WoopSet(tbl=tbl.contiguous(), eps_closest=woop_eps(inv, DET_EPS_CLOSEST),
                   eps_any=woop_eps(inv, DET_EPS_ANY), boxes=torch.cat([lo, hi], dim=1),
                   chunk=chunk, n_chunks=n_chunks, n_tris=T)


def pack_rays(org, dirn, t_min, t_max) -> torch.Tensor:
    """[R, 8] f32 rows (o.xyz, t_lo, d.xyz, t_hi): two float4 loads a ray."""
    R = org.shape[0]
    dev = org.device
    t_lo = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(R)
    t_hi = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(R)
    return torch.cat([org.float(), t_lo[:, None], dirn.float(), t_hi[:, None]], dim=1).contiguous()


def _interval_slab(olo, ohi, dlo, dhi, tlo, thi, blo, bhi):
    """Conservative bundle-vs-box test (mcpt_tpu.ops.pallas.schedule).

    olo..dhi [n_tiles,3], blo/bhi [G,3] -> hit bool[n_tiles, G]. Interval
    arithmetic per axis; an axis whose directions change sign is unbounded.
    """
    near = torch.full((olo.shape[0], blo.shape[0]), -float("inf"), device=olo.device)
    far = torch.full_like(near, float("inf"))
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
        far_a = torch.where(far_a > 0, far_a * 1.001, far_a)  # AABB.cpp far fudge
        mixed = (~pos & ~neg)[:, None]
        near = torch.maximum(near, torch.where(mixed, -float("inf"), near_a))
        far = torch.minimum(far, torch.where(mixed, float("inf"), far_a))
    lo = torch.maximum(tlo[:, None], near)
    hi = torch.minimum(thi[:, None], far)
    # <=, where mcpt_tpu has <: any-hit accepts t == t_hi, and a flat box
    # reached exactly at t_hi must stay live. NaN bounds (empty tile) -> False
    return lo <= hi


def tile_chunk_mask(rays: torch.Tensor, boxes: torch.Tensor, tile: int = RAY_TILE) -> torch.Tensor:
    """Chunk-live bitmask i32[n_tiles] of each `tile` rays (packed by pack_rays).

    Bit c is set unless no ray of the tile can reach chunk c's box inside
    its closed [t_lo, t_hi]. Parked lanes (|o| >= 1e29), masked rays
    (t_hi <= t_lo) and the padding of the last tile are left out of the
    bundle; a tile with no live ray gets 0.
    """
    R = rays.shape[0]
    n_tiles = -(-R // tile)
    pad = n_tiles * tile - R
    o, t_lo, d, t_hi = rays[:, 0:3], rays[:, 3], rays[:, 4:7], rays[:, 7]
    valid = (t_lo < t_hi) & (torch.amax(torch.abs(o), dim=-1) < PARKED)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(n_tiles, tile)
    o = torch.nn.functional.pad(o, (0, 0, 0, pad)).reshape(n_tiles, tile, 3)
    d = torch.nn.functional.pad(d, (0, 0, 0, pad)).reshape(n_tiles, tile, 3)
    t_lo = torch.nn.functional.pad(t_lo, (0, pad)).reshape(n_tiles, tile)
    t_hi = torch.nn.functional.pad(t_hi, (0, pad)).reshape(n_tiles, tile)
    inf = float("inf")
    v3 = valid[..., None]
    olo = torch.where(v3, o, inf).amin(dim=1)
    ohi = torch.where(v3, o, -inf).amax(dim=1)
    dlo = torch.where(v3, d, inf).amin(dim=1)
    dhi = torch.where(v3, d, -inf).amax(dim=1)
    tlo = torch.where(valid, t_lo, inf).amin(dim=1)
    thi = torch.where(valid, t_hi, -inf).amax(dim=1)
    hit = _interval_slab(olo, ohi, dlo, dhi, tlo, thi, boxes[:, 0:3], boxes[:, 3:6])
    bits = hit.to(torch.int64) << torch.arange(boxes.shape[0], device=rays.device)[None, :]
    word = bits.sum(dim=1)  # disjoint bits: sum == OR
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def _project(rays, tbl, eps, c, chunk):
    """t, u, v, ok [R, chunk] for chunk c, in the kernel's operation order."""
    w = tbl[:, c * chunk:(c + 1) * chunk]  # w[4k + i]: W[k, i], w[4k + 3]: p[k]
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    dx, dy, dz = rays[:, 4:5], rays[:, 5:6], rays[:, 6:7]
    po = [ox * w[4 * k] + oy * w[4 * k + 1] + oz * w[4 * k + 2] + w[4 * k + 3] for k in range(3)]
    pd = [dx * w[4 * k] + dy * w[4 * k + 1] + dz * w[4 * k + 2] for k in range(3)]
    e = eps[c * chunk:(c + 1) * chunk][None, :]
    ok = torch.abs(pd[2]) >= e
    inv = torch.where(ok, 1.0 / torch.where(ok, pd[2], 1.0), 0.0)
    t = -po[2] * inv
    u = po[0] + t * pd[0]
    v = po[1] + t * pd[1]
    return t, u, v, ok


def _active(rays: torch.Tensor) -> torch.Tensor:
    """Rays that are tested at all: a non-empty [t_lo, t_hi] and an origin
    that is not parked (|o| < 1e29); the others miss, as in the kernels."""
    return (rays[:, 3] < rays[:, 7]) & (torch.abs(rays[:, 0:3]) < PARKED).all(dim=1)


def closest_hit_woop_plain(ws: WoopSet, rays: torch.Tensor, mask: torch.Tensor):
    """Plain torch closest hit: (t, tri, u, v), t = F32_MAX and tri = -1 on a miss."""
    PLAIN_CALLS["closest"] += 1
    R = rays.shape[0]
    dev = rays.device
    out_t = torch.full((R,), F32_MAX, device=dev)
    out_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((R,), device=dev)
    out_v = torch.zeros((R,), device=dev)
    act = torch.nonzero(_active(rays))[:, 0]
    for r0 in range(0, act.shape[0], _PLAIN_RAYS):
        ids = act[r0:r0 + _PLAIN_RAYS]
        ry = rays[ids]
        tile = ids // RAY_TILE
        bt = torch.full((ids.shape[0],), F32_MAX, device=dev)
        btri = torch.full((ids.shape[0],), -1, dtype=torch.int32, device=dev)
        bu = torch.zeros((ids.shape[0],), device=dev)
        bv = torch.zeros((ids.shape[0],), device=dev)
        for c in range(ws.n_chunks):
            live = ((mask[tile].to(torch.int64) >> c) & 1 != 0)[:, None]
            t, u, v, ok = _project(ry, ws.tbl, ws.eps_closest, c, ws.chunk)
            accept = (live & ok & (t >= ry[:, 3:4]) & (t < ry[:, 7:8]) & (u >= 0) & (v >= 0)
                      & (1.0 - u - v >= 0))
            t_cand = torch.where(accept, t, F32_MAX)
            row_t, row_i = torch.min(t_cand, dim=1)  # first index on ties
            better = row_t < bt  # strict: the lower chunk wins a tie
            sel = row_i[:, None]
            bt = torch.where(better, row_t, bt)
            btri = torch.where(better, (row_i + c * ws.chunk).to(torch.int32), btri)
            bu = torch.where(better, u.gather(1, sel)[:, 0], bu)
            bv = torch.where(better, v.gather(1, sel)[:, 0], bv)
        out_t[ids], out_tri[ids], out_u[ids], out_v[ids] = bt, btri, bu, bv
    return out_t, out_tri, out_u, out_v


def any_hit_woop_plain(ws: WoopSet, rays: torch.Tensor, mask: torch.Tensor):
    """Plain torch any hit: bool[R]."""
    PLAIN_CALLS["any"] += 1
    R = rays.shape[0]
    dev = rays.device
    out = torch.zeros((R,), dtype=torch.bool, device=dev)
    act = torch.nonzero(_active(rays))[:, 0]
    for r0 in range(0, act.shape[0], _PLAIN_RAYS):
        ids = act[r0:r0 + _PLAIN_RAYS]
        ry = rays[ids]
        tile = ids // RAY_TILE
        hit = torch.zeros((ids.shape[0],), dtype=torch.bool, device=dev)
        for c in range(ws.n_chunks):
            live = ((mask[tile].to(torch.int64) >> c) & 1 != 0)[:, None]
            t, u, v, ok = _project(ry, ws.tbl, ws.eps_any, c, ws.chunk)
            accept = (live & ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0)
                      & (t >= ry[:, 3:4]) & (t <= ry[:, 7:8]))
            hit |= accept.any(dim=1)
        out[ids] = hit
    return out


# The kernels' division-free pre-test (csrc/woop.cu, whose comment derives
# its margins): it applies to ordinary pairs only.
ORD_MAX = 2.0**24  # |o|, |d|, |W|, |p| of an ordinary pair
ORD_LO = 2.0**-100  # least t_lo of an ordinary ray
REL_MARGIN = 2.0**-20  # of t_lo and t_hi (best_t)


def _interval_rejects(ws: WoopSet, rays: torch.Tensor, t_up: torch.Tensor) -> torch.Tensor:
    """bool[R, Tp]: the interval test of csrc/woop.cu against [t_lo, t_up]
    (t_up broadcast against [R, Tp]), operation for operation: row 2 of the
    projection, each f32 operation rounded once, in the kernel's order."""
    w = ws.tbl
    o, d = rays[:, 0:3], rays[:, 4:7]
    lo = rays[:, 3:4]
    po2 = o[:, 0:1] * w[8] + o[:, 1:2] * w[9] + o[:, 2:3] * w[10] + w[11]
    pd2 = d[:, 0:1] * w[8] + d[:, 1:2] * w[9] + d[:, 2:3] * w[10]
    a = torch.abs(pd2)
    n = torch.where(pd2 < 0, po2, -po2)
    out = (n < (lo * (1.0 - REL_MARGIN)) * a) | (n > (t_up * (1.0 + REL_MARGIN)) * a)
    ray_ord = ((lo[:, 0] >= ORD_LO) & (torch.abs(o) <= ORD_MAX).all(dim=1)
               & (torch.abs(d) <= ORD_MAX).all(dim=1))
    tri_ord = (torch.abs(w) <= ORD_MAX).all(dim=0)
    return out & ray_ord[:, None] & tri_ord[None, :]


def any_pretest_rejects(ws: WoopSet, rays: torch.Tensor) -> torch.Tensor:
    """bool[R, Tp]: the pairs that csrc/woop.cu's any-hit kernel rejects
    before its exact predicate by its interval test against [t_lo, t_hi].
    The kernel's own |d'_z| >= eps test is not part of it. Every pair
    rejected here must be one that the exact predicate (any_hit_woop_plain)
    rejects; the tests hold it to that."""
    return _interval_rejects(ws, rays, rays[:, 7:8])


def closest_pretest_rejects(ws: WoopSet, rays: torch.Tensor, best_t: torch.Tensor) -> torch.Tensor:
    """bool[R, Tp]: the pairs that csrc/woop.cu's closest-hit kernel rejects
    before rows 0 and 1 and its division, by its interval test against
    [t_lo, best_t], where best_t (broadcast against [R, Tp]) is the ray's
    running best when the kernel reaches the pair: t_hi, or the t of an
    earlier accepted pair. The kernel's own |d'_z| >= eps test is not part
    of it. Every pair rejected here must be one whose exact closest-hit t
    does not lie in [t_lo, best_t): the tests hold it to that."""
    return _interval_rejects(ws, rays, best_t)


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _check_inputs(ws: WoopSet, rays, mask):
    for name, x in (("tbl", ws.tbl), ("eps_closest", ws.eps_closest), ("eps_any", ws.eps_any),
                    ("rays", rays), ("mask", mask)):
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if rays.dtype != torch.float32 or rays.shape[1] != 8 or mask.dtype != torch.int32:
        raise ValueError("rays must be f32[R,8] and mask i32[n_tiles]")
    if ws.n_chunks > MAX_CHUNKS:
        raise ValueError(f"{ws.n_chunks} chunks exceed the {MAX_CHUNKS}-bit chunk mask")
    if mask.shape[0] != -(-rays.shape[0] // RAY_TILE):
        raise ValueError("mask must have one word per RAY_TILE rays")


def closest_hit_woop_kernel(ws: WoopSet, rays: torch.Tensor, mask: torch.Tensor):
    """Launch csrc/woop.cu's closest-hit kernel; same contract as the plain version."""
    from mcpt_tpu_torch.ops._build import check, library

    _check_inputs(ws, rays, mask)
    R = rays.shape[0]
    dev = rays.device
    out_t = torch.empty((R,), device=dev)
    out_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    out_u = torch.empty((R,), device=dev)
    out_v = torch.empty((R,), device=dev)
    if R == 0:
        return out_t, out_tri, out_u, out_v
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(library().woop_closest(
        _ptr(rays), _ptr(ws.tbl), _ptr(ws.eps_closest), _ptr(mask), R, ws.n_chunks,
        ws.chunk, ws.n_tris, _ptr(out_t), _ptr(out_tri), _ptr(out_u), _ptr(out_v),
        ctypes.c_void_p(stream)), "woop_closest")
    LAUNCHES["closest"] += 1
    return out_t, out_tri, out_u, out_v


def any_hit_woop_kernel(ws: WoopSet, rays: torch.Tensor, mask: torch.Tensor):
    """Launch csrc/woop.cu's any-hit kernel; same contract as the plain version."""
    from mcpt_tpu_torch.ops._build import check, library

    _check_inputs(ws, rays, mask)
    R = rays.shape[0]
    out = torch.empty((R,), dtype=torch.bool, device=rays.device)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    check(library().woop_any(
        _ptr(rays), _ptr(ws.tbl), _ptr(ws.eps_any), _ptr(mask), R, ws.n_chunks, ws.chunk,
        ws.n_tris, _ptr(out), ctypes.c_void_p(stream)), "woop_any")
    LAUNCHES["any"] += 1
    return out


def closest_hit_woop(ws: WoopSet, org, dirn, t_min, t_max):
    """(t, tri, u, v) of each ray: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    rays = pack_rays(org, dirn, t_min, t_max)
    mask = tile_chunk_mask(rays, ws.boxes)
    if rays.is_cuda:
        return closest_hit_woop_kernel(ws, rays, mask)
    return closest_hit_woop_plain(ws, rays, mask)


def any_hit_woop(ws: WoopSet, org, dirn, t_min, t_max):
    """bool[R] occlusion: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    rays = pack_rays(org, dirn, t_min, t_max)
    mask = tile_chunk_mask(rays, ws.boxes)
    if rays.is_cuda:
        return any_hit_woop_kernel(ws, rays, mask)
    return any_hit_woop_plain(ws, rays, mask)
