"""BVH traversal: closest hit and any hit for large scenes (bathroom class).

Port of the function of mcpt_tpu/ops/pallas/traverse.py (the treelet kernel
pair `_closest_kernel` / `_any_kernel`, wrapped by closest_hit_treelets /
any_hit_treelets) onto walks of the BVH itself, after mcpt_tpu/ops/traverse.py
(closest_hit_bvh / any_hit_bvh). The TPU kernel cuts the BVH into
superblocks and treelets because a TPU core tests 128 rays against 128
triangles at once and must stage both in VMEM; a GPU thread walks its own
ray, so this pair walks the BVH directly; the treelet layout
(ops/treelets.py) serves the select and schedule pairs (ops/select.py,
ops/schedule.py). Results are those of the treelet kernel: (t, tri, u, v)
for closest hit, a bool for any hit.

The skip-link walk (any hit, and the reference walk for closest hit), per
ray, from the root: test the node's box (the reference's slab test,
src/AABB.cpp:25-36: far * 1.001, strict tmin < tmax, over [t_min,
min(best_t, t_max)] for closest hit and [t_min, t_max] for any hit;
min/max propagate NaN, so a ray parallel to a box plane that starts on it
misses the box, as jnp.minimum/maximum make it miss in the reference); on a
hit of an inner node go to node+1, on a hit of a leaf test its triangles and
go to skip, on a miss go to skip; -1 ends the walk, and an any-hit ray ends
at its first accept. The cursor only moves forward, so a walk ends within
the node count. Accept predicates are those of ops/intersect.py; a closest
hit takes the first of equal t in leaf order and then needs a strict
t < best_t, which is the reference's lowest-id-on-a-tie for the BVH walk.

The kernels walk the child-pair table instead, with a stack. The
closest-hit walk goes nearer child first (closest_hit_ordered_plain says
how): it tests the same boxes with the same slab test and the running
best_t, in another order, and takes the lower id on an equal t explicitly;
it can differ from the skip-link walk only where that walk's strict cull at
best_t hides a tie, or on a one-ulp box-face case (ROADMAP queue 3 item 4).
The any-hit walk (any_hit_ordered_plain) tests the same leaves as the
skip-link walk, in another order, so its answer is that walk's on every
ray.

Each function comes twice: the CUDA kernels in csrc/traverse.cu, launched by
`closest_hit_traverse` / `any_hit_traverse` on CUDA tensors, and the plain
torch versions (closest_hit_ordered_plain, any_hit_ordered_plain), which
the wrappers run on CPU tensors and which the card compares the kernels
with. The skip-link walks (closest_hit_traverse_plain,
any_hit_traverse_plain) stay as the reference walks; their visits and tests
define the kernels' bound. Both write Moller-Trumbore and the slab test as single f32 multiplies
and adds in one fixed order, with no fused multiply-add, so the two agree
bit for bit. Above RAY_TILE rays the wrappers sort the rays by (octant,
origin Morton, direction Morton) first, as mcpt_tpu's _ray_sort_order
does, and scatter the results back.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from mcpt_tpu_torch.ops.bvh import DEFAULT_LEAF_SIZE
from mcpt_tpu_torch.ops.intersect import DET_EPS_ANY, DET_EPS_CLOSEST, F32_MAX
from mcpt_tpu_torch.ops.woop import _active, _ptr, pack_rays

RAY_TILE = 128  # rays per CUDA block; the ray sort applies above it (mcpt_tpu DEFAULT_RAY_TILE)
FAR_FUDGE = 1.001  # reference AABB::Intersection far-plane factor
# The deepest tree (in inner nodes) that the kernels' stacks hold:
# csrc/traverse.cu launches a 64-entry stack up to depth 64 and a 128-entry
# one above it.
STACK_SIZE = 128

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


@dataclass(frozen=True)
class TraversalSet:
    """Per-scene kernel tables, packed once by pack_traversal.

    nodes row i: lo.xyz, first*8 + count (int32 bits), hi.xyz, skip (int32
    bits), two float4 loads a node; count 0 marks an inner node. tris row k:
    v0.xyz, 0, e1.xyz, 0, e2.xyz, 0, three float4 loads a triangle.

    pairs (the kernels' child-pair table) has one 64-byte row per
    inner node of the BVH, in preorder: left child's lo.xyz, left ref, left
    hi.xyz, right ref, right lo.xyz, 0, right hi.xyz, 0 (refs as int32
    bits). The children of inner node n are n+1 and skip[n+1], their boxes
    FlatBVH's own. A ref is row*8 for an inner child, first*8 + count (count
    1..4) for a leaf; root_ref is the root's. depth is the most inner nodes
    on a path from the root to a leaf, which is the most stack entries the
    walk can hold.
    """

    nodes: torch.Tensor  # f32[N, 8]
    tris: torch.Tensor  # f32[T, 12]
    pairs: torch.Tensor  # f32[n_inner, 16]
    n_nodes: int
    n_tris: int
    root_ref: int
    depth: int


def pack_traversal(bvh, v0, e1, e2) -> TraversalSet:
    """FlatBVH + geometry (in BVH order) -> TraversalSet. Raises ValueError
    when a leaf holds more than DEFAULT_LEAF_SIZE triangles or reaches past
    the last one, or when the tree is deeper than STACK_SIZE inner nodes."""
    T = v0.shape[0]
    N = bvh.lo.shape[0]
    count = bvh.count.to(torch.int32)
    first = bvh.first.to(torch.int32)
    if int(count.max()) > DEFAULT_LEAF_SIZE or int(count.min()) < 0:
        raise ValueError(f"leaves must hold 0..{DEFAULT_LEAF_SIZE} triangles")
    if int((first + count).max()) > T or int(first.min()) < 0:
        raise ValueError("a leaf reaches past the triangle buffer")
    word = torch.where(count > 0, first * 8 + count, 0).to(torch.int32)
    skip = bvh.skip.to(torch.int32)
    nodes = torch.cat([bvh.lo.float(), word.view(torch.float32)[:, None], bvh.hi.float(),
                       skip.view(torch.float32)[:, None]], dim=1)
    pairs, root_ref, depth = _child_pairs(nodes, word, skip)
    z = torch.zeros((T, 1), dtype=torch.float32, device=v0.device)
    tris = torch.cat([v0.float(), z, e1.float(), z, e2.float(), z], dim=1)
    return TraversalSet(nodes=nodes.contiguous(), tris=tris.contiguous(), pairs=pairs, n_nodes=N,
                        n_tris=T, root_ref=root_ref, depth=depth)


def _child_pairs(nodes, word, skip):
    """The child-pair table of a preorder skip-link BVH (see TraversalSet),
    its root ref and its depth; raises ValueError above STACK_SIZE."""
    N = nodes.shape[0]
    dev = nodes.device
    inner = torch.nonzero(word == 0)[:, 0]
    if inner.numel() and int(inner.max()) >= N - 1:
        raise ValueError("an inner node has no children: the BVH is not a preorder")
    left = inner + 1
    right = skip[left].long()
    if inner.numel() and (int(right.min()) <= 0 or int(right.max()) >= N):
        raise ValueError("an inner node's right child is out of range: the BVH is not a preorder")
    row = torch.full((N,), -1, dtype=torch.int64, device=dev)
    row[inner] = torch.arange(inner.numel(), device=dev)
    ref = torch.where(word == 0, row * 8, word.long()).to(torch.int32)
    pairs = torch.cat([nodes[left, 0:3], ref[left].view(torch.float32)[:, None], nodes[left, 4:7],
                       ref[right].view(torch.float32)[:, None], nodes[right, 0:3],
                       torch.zeros((inner.numel(), 1), device=dev), nodes[right, 4:7],
                       torch.zeros((inner.numel(), 1), device=dev)], dim=1).contiguous()
    # depth in inner nodes: each pass carries it one level down the tree
    parent = torch.full((N,), -1, dtype=torch.int64, device=dev)
    parent[left], parent[right] = inner, inner
    has = parent >= 0
    depth = torch.zeros(N, dtype=torch.int64, device=dev)
    for _ in range(STACK_SIZE + 1):
        deeper = torch.where(has, depth[parent.clamp(min=0)] + 1, 0)
        if torch.equal(deeper, depth):
            break
        depth = deeper
    deepest = int(depth[word != 0].max()) if N else 0
    if deepest > STACK_SIZE:
        raise ValueError(f"the BVH is deeper than the traversal kernels' stack of {STACK_SIZE} entries")
    return pairs, int(ref[0]), deepest


def ray_sort_order(ts: TraversalSet, org, dirn) -> torch.Tensor:
    """Stable permutation grouping rays by (direction octant, origin Morton,
    direction Morton): mcpt_tpu.ops.pallas.traverse._ray_sort_order, with the
    scene bounds taken from the BVH root box (the union of the superblock
    boxes there). 3 + 15 + 12 = 30 key bits."""
    smin, smax = ts.nodes[0, 0:3], ts.nodes[0, 4:7]
    ext = torch.clamp(smax - smin, min=1e-6)
    q = torch.clamp((org - smin) / ext * 31.0, 0, 31).to(torch.int32)  # 5 bits an axis
    qd = torch.clamp((dirn * 0.5 + 0.5) * 15.0, 0, 15).to(torch.int32)  # 4 bits an axis

    def spread(x, bits):  # interleave `bits` bits with 2-bit gaps
        r = torch.zeros_like(x)
        for b in range(bits):
            r = r | (((x >> b) & 1) << (3 * b))
        return r

    octant = (((dirn[:, 0] > 0).to(torch.int32) << 2) | ((dirn[:, 1] > 0).to(torch.int32) << 1)
              | (dirn[:, 2] > 0).to(torch.int32))
    m_o = (spread(q[:, 0], 5) << 2) | (spread(q[:, 1], 5) << 1) | spread(q[:, 2], 5)
    m_d = (spread(qd[:, 0], 4) << 2) | (spread(qd[:, 1], 4) << 1) | spread(qd[:, 2], 4)
    key = (octant << 27) | (m_o << 12) | m_d
    return torch.argsort(key, stable=True)


def _slab(nd, o, inv, t_lo, t_hi):
    """Box hit of each lane's node (rows of `nodes`), in the kernel's order."""
    return _slab_entry(nd, o, inv, t_lo, t_hi)[0]


def _slab_entry(nd, o, inv, t_lo, t_hi):
    """(box hit, entry t) of each lane's box (lo = nd[:, 0:3], hi =
    nd[:, 4:7]): the slab test in the kernel's order."""
    ta = (nd[:, 0:3] - o) * inv
    tb = (nd[:, 4:7] - o) * inv
    near = torch.minimum(ta, tb)
    far = torch.maximum(ta, tb) * FAR_FUDGE
    tmin = torch.maximum(t_lo, torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2]))
    tmax = torch.minimum(t_hi, torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2]))
    return tmin < tmax, tmin


def _mt(tri, o, d, det_eps):
    """Moller-Trumbore of triangles (rows of `tris`, last axis) against rays
    (o, d: last axis xyz), broadcast over the other axes, in the kernel's
    order: t, u, v, ok."""
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 4], tri[..., 5], tri[..., 6]
    e2x, e2y, e2z = tri[..., 8], tri[..., 9], tri[..., 10]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = sx * hx + sy * hy + sz * hz
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = dx * qx + dy * qy + dz * qz
    t = e2x * qx + e2y * qy + e2z * qz
    ok = torch.abs(det) >= det_eps
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    return t * inv, u * inv, v * inv, ok


def _walk(ts: TraversalSet, rays: torch.Tensor, closest: bool, counts: Optional[dict]):
    """The plain walk of every tested ray, all lanes a step at a time; lanes
    leave the batch when their walk ends. Returns the ids of the tested rays
    and their [t, tri, u, v] (any hit: tri >= 0 marks a hit)."""
    dev = rays.device
    ids = torch.nonzero(_active(rays))[:, 0]
    o, t_lo, d, t_max = rays[ids, 0:3], rays[ids, 3], rays[ids, 4:7], rays[ids, 7]
    inv = 1.0 / d
    n = ids.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    bt = torch.full((n,), F32_MAX, device=dev)
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    lane = torch.arange(n, device=dev)  # position of each live lane in the outputs
    out = [torch.full((n,), F32_MAX, device=dev), torch.full((n,), -1, dtype=torch.int32, device=dev),
           torch.zeros(n, device=dev), torch.zeros(n, device=dev)]
    eps = DET_EPS_CLOSEST if closest else DET_EPS_ANY
    visits = tests = 0
    for _ in range(ts.n_nodes):  # the cursor only moves forward
        if lane.shape[0] == 0:
            break
        visits += lane.shape[0]
        nd = ts.nodes[node]
        word = nd[:, 3].view(torch.int32)
        cnt = word & 7
        hit = _slab(nd, o, inv, t_lo, torch.minimum(bt, t_max) if closest else t_max)
        leaf = hit & (cnt > 0)
        li = torch.nonzero(leaf)[:, 0]
        if li.shape[0]:
            first = (word[li] >> 3).long()
            lo_, do_, tl_, tm_ = o[li], d[li], t_lo[li], t_max[li]
            lbt, ltri, lu, lv = bt[li], btri[li], bu[li], bv[li]
            found = torch.zeros(li.shape[0], dtype=torch.bool, device=dev)
            for k in range(DEFAULT_LEAF_SIZE):
                on = (k < cnt[li]) & ~found
                tests += int(on.sum())
                tri = torch.clamp(first + k, max=ts.n_tris - 1)
                t, u, v, ok = _mt(ts.tris[tri], lo_, do_, eps)
                if closest:
                    acc = (on & ok & (t >= tl_) & (t < torch.minimum(lbt, tm_)) & (u >= 0) & (v >= 0)
                           & (1.0 - u - v >= 0))
                else:
                    acc = (on & ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0) & (t >= tl_)
                           & (t <= tm_))
                    found |= acc
                lbt = torch.where(acc, t, lbt)
                ltri = torch.where(acc, tri.to(torch.int32), ltri)
                lu = torch.where(acc, u, lu)
                lv = torch.where(acc, v, lv)
            bt[li], btri[li], bu[li], bv[li] = lbt, ltri, lu, lv
        nxt = torch.where(hit & (cnt == 0), node + 1, nd[:, 7].view(torch.int32).long())
        if not closest:
            nxt = torch.where(btri >= 0, -1, nxt)  # an any-hit ray ends at its first accept
        done = nxt < 0
        if bool(done.any()):
            dl = lane[done]
            for x, y in zip(out, (bt, btri, bu, bv)):
                x[dl] = y[done]
            keep = ~done
            lane, nxt, o, d, inv, t_lo, t_max = (x[keep] for x in (lane, nxt, o, d, inv, t_lo, t_max))
            bt, btri, bu, bv = (x[keep] for x in (bt, btri, bu, bv))
        node = nxt
    if lane.shape[0]:
        raise RuntimeError(f"{lane.shape[0]} walks did not end within {ts.n_nodes} steps: "
                           "the BVH's skip links are not a preorder")
    if counts is not None:
        counts["node_visits"] = counts.get("node_visits", 0) + visits
        counts["tri_tests"] = counts.get("tri_tests", 0) + tests
    return ids, out


def closest_hit_traverse_plain(ts: TraversalSet, rays: torch.Tensor, counts: Optional[dict] = None):
    """Plain torch closest hit of packed rays (ops/woop.pack_rays) by the
    skip-link walk, the reference walk: (t, tri, u, v), t = F32_MAX, tri =
    -1 and u = v = 0 on a miss. With `counts`, adds this call's node visits
    and triangle tests to it (the closest-hit rows' bound in chip_smoke.py
    counts these)."""
    PLAIN_CALLS["closest"] += 1
    R = rays.shape[0]
    dev = rays.device
    res = [torch.full((R,), F32_MAX, device=dev), torch.full((R,), -1, dtype=torch.int32, device=dev),
           torch.zeros(R, device=dev), torch.zeros(R, device=dev)]
    ids, out = _walk(ts, rays, True, counts)
    for x, y in zip(res, out):
        x[ids] = y
    return tuple(res)


def closest_hit_ordered_plain(ts: TraversalSet, rays: torch.Tensor, counts: Optional[dict] = None):
    """Plain torch closest hit of packed rays by the closest-hit kernel's
    ordered walk: the same (t, tri, u, v) contract as
    closest_hit_traverse_plain. With `counts`, adds this call's child-pair
    visits (inner rows) and triangle tests to it.

    Each ray tests the root box, then walks the child-pair table from the
    root (ordered_closest_walk says how). All lanes take a step at a time,
    deciding each branch from the same state as the kernel, so the two
    agree bit for bit."""
    PLAIN_CALLS["closest"] += 1
    R = rays.shape[0]
    dev = rays.device
    res = [torch.full((R,), F32_MAX, device=dev), torch.full((R,), -1, dtype=torch.int32, device=dev),
           torch.zeros(R, device=dev), torch.zeros(R, device=dev)]
    ids = torch.nonzero(_active(rays))[:, 0]
    o, t_lo, d, t_hi = rays[ids, 0:3], rays[ids, 3], rays[ids, 4:7], rays[ids, 7]
    n = ids.shape[0]
    best = [x[:n].clone() for x in res]
    hit = _slab(ts.nodes[0:1].expand(n, 8), o, 1.0 / d, t_lo, torch.minimum(best[0], t_hi))
    ref = torch.where(hit, ts.root_ref, -1).long()
    ordered_closest_walk(ts.pairs, ts.tris, o, d, t_lo, t_hi, ref, ts.depth, ts.n_nodes + 1, best, counts)
    for x, y in zip(res, best):
        x[ids] = y
    return tuple(res)


def _row(pairs, ref, tb8, pb8, ii):
    """Child-pair rows of lanes ii at inner refs `ref`, and their children's
    refs. With tb8 and pb8 (8 * each lane's first triangle and first row)
    the refs are local: the row is pb8/8 + ref/8, and each child's ref is
    made local, a leaf's less tb8, an inner row's less pb8."""
    if tb8 is None:
        row = pairs[ref >> 3]
    else:
        tb8, pb8 = tb8[ii], pb8[ii]
        row = pairs[(ref + pb8) >> 3]
    refs = row[:, [3, 7]].view(torch.int32).long()
    if tb8 is not None:
        refs = refs - torch.where((refs & 7) != 0, tb8[:, None], pb8[:, None])
    return row, refs[:, 0], refs[:, 1]


def ordered_closest_walk(pairs, tris, o, d, t_lo, t_hi, ref, depth: int, max_steps: int, best,
                         counts: Optional[dict] = None, tbase=None, pbase=None):
    """The closest-hit kernels' ordered walk (csrc/ray_common.cuh Walk) of
    lanes [n] from their refs (< 0: nothing to walk), updating `best` = [t,
    tri, u, v] of each lane in place. With tbase, pbase (i64[n]) the refs
    are local to a treelet (ops/treelets.py): a leaf's triangles start at
    tbase, its rows at pbase, and every ref read from a row is rebased.

    At an inner row a lane tests both children's boxes over [t_lo,
    min(best_t, t_hi)], goes to the hit child with the smaller entry t (the
    left one on equal entries) and pushes the other with its entry t; at a
    leaf it tests the triangles, accepting t in [t_lo, t_hi) below best_t,
    or equal to it with a lower id; after a leaf or a row with no child hit
    it pops, dropping every entry whose t no longer lies below min(best_t,
    t_hi). A walk visits each row and leaf once, so `max_steps` (rows plus
    leaves) bounds it; `depth` bounds the stack."""
    dev = o.device
    n = ref.shape[0]
    inv = 1.0 / d
    n_tris = tris.shape[0]
    tb8 = pb8 = None
    if tbase is not None:
        tb8, pb8 = tbase * 8, pbase * 8
    stk_ref = torch.zeros((n, max(1, depth)), dtype=torch.int64, device=dev)  # depth entries at most
    stk_t = torch.zeros((n, max(1, depth)), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    kk = torch.arange(DEFAULT_LEAF_SIZE, device=dev)  # a leaf's triangle slots
    lane = torch.arange(n, device=dev)  # each live lane's place in `best`
    bt, btri, bu, bv = (x.clone() for x in best)
    visits = tests = 0
    for _ in range(max_steps + 1):
        done = ref < 0
        n_done = int(done.sum())
        if 2 * n_done >= lane.shape[0]:  # drop finished lanes once they are half
            for x, y in zip(best, (bt, btri, bu, bv)):
                x[lane[done]] = y[done]
            keep = ~done
            lane, ref, o, d, inv, t_lo, t_hi = (x[keep] for x in (lane, ref, o, d, inv, t_lo, t_hi))
            bt, btri, bu, bv, stk_ref, stk_t, sp = (x[keep] for x in (bt, btri, bu, bv, stk_ref, stk_t, sp))
            if tb8 is not None:
                tb8, pb8 = tb8[keep], pb8[keep]
        if n_done == done.shape[0]:
            break
        pop = torch.zeros(lane.shape[0], dtype=torch.bool, device=dev)
        ii = torch.nonzero((ref & 7) == 0)[:, 0]
        if ii.shape[0]:
            visits += ii.shape[0]
            row, lref, rref = _row(pairs, ref[ii], tb8, pb8, ii)
            th = torch.minimum(bt[ii], t_hi[ii])
            oi, invi, tli = o[ii], inv[ii], t_lo[ii]
            hl, tl = _slab_entry(row[:, 0:8], oi, invi, tli, th)
            hr, tr = _slab_entry(row[:, 8:16], oi, invi, tli, th)
            lfirst = tl <= tr
            both = hl & hr
            bi = ii[both]
            stk_ref[bi, sp[bi]] = torch.where(lfirst, rref, lref)[both]
            stk_t[bi, sp[bi]] = torch.where(lfirst, tr, tl)[both]
            sp[bi] += 1
            ref[ii] = torch.where(both, torch.where(lfirst, lref, rref),
                                  torch.where(hl, lref, torch.where(hr, rref, -1)))
            pop[ii] = ~(hl | hr)
        li = torch.nonzero((ref >= 0) & ((ref & 7) != 0))[:, 0]
        if li.shape[0]:
            first, cnt = ref[li] >> 3, ref[li] & 7
            if tb8 is not None:
                first = first + (tb8[li] >> 3)
            tl_, th_ = t_lo[li, None], t_hi[li, None]
            lbt, ltri, lu, lv = bt[li], btri[li], bu[li], bv[li]
            # the leaf's triangles at once, then kept in order
            on = kk[None, :] < cnt[:, None]
            tests += int(on.sum())
            tri = torch.clamp(first[:, None] + kk, max=n_tris - 1).to(torch.int32)
            t, u, v, ok = _mt(tris[tri], o[li, None], d[li, None], DET_EPS_CLOSEST)
            pre = on & ok & (t >= tl_) & (t < th_) & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0)
            for k in range(DEFAULT_LEAF_SIZE):
                tk, ik = t[:, k], tri[:, k]
                acc = pre[:, k] & ((tk < lbt) | ((tk == lbt) & (ik < ltri)))
                lbt = torch.where(acc, tk, lbt)
                ltri = torch.where(acc, ik, ltri)
                lu = torch.where(acc, u[:, k], lu)
                lv = torch.where(acc, v[:, k], lv)
            bt[li], btri[li], bu[li], bv[li] = lbt, ltri, lu, lv
            pop[li] = True
        pi = torch.nonzero(pop)[:, 0]
        ref[pi] = -1
        while pi.shape[0]:  # pop until an entry still lies below min(best_t, t_hi)
            pi = pi[sp[pi] > 0]
            sp[pi] -= 1
            cand = stk_t[pi, sp[pi]] < torch.minimum(bt[pi], t_hi[pi])
            ref[pi[cand]] = stk_ref[pi[cand], sp[pi[cand]]]
            pi = pi[~cand]
    if lane.shape[0]:
        raise RuntimeError(f"{lane.shape[0]} walks did not end within {max_steps + 1} steps")
    if counts is not None:
        counts["pair_visits"] = counts.get("pair_visits", 0) + visits
        counts["tri_tests"] = counts.get("tri_tests", 0) + tests


def any_hit_traverse_plain(ts: TraversalSet, rays: torch.Tensor, counts: Optional[dict] = None):
    """Plain torch any hit of packed rays by the skip-link walk, the
    reference walk: bool[R]. With `counts`, adds the node visits and the
    triangle tests up to each ray's first accept (the any-hit rows' bound in
    chip_smoke.py counts these)."""
    PLAIN_CALLS["any"] += 1
    res = torch.zeros(rays.shape[0], dtype=torch.bool, device=rays.device)
    ids, out = _walk(ts, rays, False, counts)
    res[ids] = out[1] >= 0
    return res


def any_hit_ordered_plain(ts: TraversalSet, rays: torch.Tensor, counts: Optional[dict] = None):
    """Plain torch any hit of packed rays by the any-hit kernel's walk of
    the child-pair table: bool[R], any_hit_traverse_plain's answer. With
    `counts`, adds this call's child-pair visits (inner rows) and triangle
    tests up to each ray's first accept to it.

    Each ray tests the root box, then walks the child-pair table from the
    root (ordered_any_walk says how). All lanes take a step at a time."""
    PLAIN_CALLS["any"] += 1
    R = rays.shape[0]
    dev = rays.device
    res = torch.zeros(R, dtype=torch.bool, device=dev)
    ids = torch.nonzero(_active(rays))[:, 0]
    o, t_lo, d, t_hi = rays[ids, 0:3], rays[ids, 3], rays[ids, 4:7], rays[ids, 7]
    n = ids.shape[0]
    hit = _slab(ts.nodes[0:1].expand(n, 8), o, 1.0 / d, t_lo, t_hi)
    ref = torch.where(hit, ts.root_ref, -1).long()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    ordered_any_walk(ts.pairs, ts.tris, o, d, t_lo, t_hi, ref, ts.depth, ts.n_nodes + 1, found, counts)
    res[ids] = found
    return res


def ordered_any_walk(pairs, tris, o, d, t_lo, t_hi, ref, depth: int, max_steps: int, found,
                     counts: Optional[dict] = None, tbase=None, pbase=None):
    """The any-hit kernels' walk (csrc/ray_common.cuh AnyWalk) of lanes [n]
    from their refs (< 0: nothing to walk), setting found[i] in place at a
    lane's first accept; tbase and pbase as in ordered_closest_walk.

    At an inner row a lane tests both children's boxes over [t_lo, t_hi];
    if both hit, it goes to the one with the smaller entry t (the left one
    on equal entries) and pushes the other; at a leaf it tests the
    triangles in order and ends at the first accept; after a leaf or a row
    with no child hit it pops."""
    dev = o.device
    n = ref.shape[0]
    inv = 1.0 / d
    n_tris = tris.shape[0]
    tb8 = pb8 = None
    if tbase is not None:
        tb8, pb8 = tbase * 8, pbase * 8
    stk = torch.zeros((n, max(1, depth)), dtype=torch.int64, device=dev)  # depth entries at most
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    kk = torch.arange(DEFAULT_LEAF_SIZE, device=dev)  # a leaf's triangle slots
    fnd = torch.zeros(n, dtype=torch.bool, device=dev)
    lane = torch.arange(n, device=dev)  # each live lane's place in `found`
    visits = tests = 0
    for _ in range(max_steps + 1):
        done = ref < 0
        n_done = int(done.sum())
        if 2 * n_done >= lane.shape[0]:  # drop finished lanes once they are half
            found[lane[done & fnd]] = True
            keep = ~done
            lane, ref, o, d, inv, t_lo, t_hi, stk, sp, fnd = (
                x[keep] for x in (lane, ref, o, d, inv, t_lo, t_hi, stk, sp, fnd))
            if tb8 is not None:
                tb8, pb8 = tb8[keep], pb8[keep]
        if n_done == done.shape[0]:
            break
        pop = torch.zeros(lane.shape[0], dtype=torch.bool, device=dev)
        ii = torch.nonzero((ref & 7) == 0)[:, 0]
        if ii.shape[0]:
            visits += ii.shape[0]
            row, lref, rref = _row(pairs, ref[ii], tb8, pb8, ii)
            oi, invi, tli, thi = o[ii], inv[ii], t_lo[ii], t_hi[ii]
            hl, tl = _slab_entry(row[:, 0:8], oi, invi, tli, thi)
            hr, tr = _slab_entry(row[:, 8:16], oi, invi, tli, thi)
            lfirst = tl <= tr
            both = hl & hr
            bi = ii[both]
            stk[bi, sp[bi]] = torch.where(lfirst, rref, lref)[both]
            sp[bi] += 1
            ref[ii] = torch.where(both, torch.where(lfirst, lref, rref),
                                  torch.where(hl, lref, torch.where(hr, rref, -1)))
            pop[ii] = ~(hl | hr)
        li = torch.nonzero((ref >= 0) & ((ref & 7) != 0))[:, 0]
        if li.shape[0]:
            first, cnt = ref[li] >> 3, ref[li] & 7
            if tb8 is not None:
                first = first + (tb8[li] >> 3)
            tl_, th_ = t_lo[li, None], t_hi[li, None]
            # the leaf's triangles at once; a lane stops at its first accept
            on = kk[None, :] < cnt[:, None]
            tri = torch.clamp(first[:, None] + kk, max=n_tris - 1)
            t, u, v, ok = _mt(tris[tri], o[li, None], d[li, None], DET_EPS_ANY)
            acc = on & ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0) & (t >= tl_) & (t <= th_)
            f = acc.any(dim=1)
            tests += int(torch.where(f, torch.where(acc, kk, DEFAULT_LEAF_SIZE).amin(dim=1) + 1, cnt).sum())
            fnd[li] = f
            ref[li[f]] = -1  # the walk ends at its first accept
            pop[li[~f]] = True
        pi = torch.nonzero(pop)[:, 0]
        has = sp[pi] > 0
        sp[pi] -= has.long()
        ref[pi] = torch.where(has, stk[pi, sp[pi]], -1)
    if lane.shape[0]:
        raise RuntimeError(f"{lane.shape[0]} walks did not end within {max_steps + 1} steps")
    if counts is not None:
        counts["pair_visits"] = counts.get("pair_visits", 0) + visits
        counts["tri_tests"] = counts.get("tri_tests", 0) + tests


def _check_inputs(ts: TraversalSet, rays):
    for name, x in (("nodes", ts.nodes), ("tris", ts.tris), ("pairs", ts.pairs), ("rays", rays)):
        if not x.is_cuda or not x.is_contiguous() or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous f32 CUDA tensor")
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError("rays must be f32[R,8] (ops/woop.pack_rays)")
    if (ts.nodes.shape != (ts.n_nodes, 8) or ts.tris.shape != (ts.n_tris, 12) or ts.pairs.dim() != 2
            or ts.pairs.shape[1] != 16 or ts.depth > STACK_SIZE):
        raise ValueError("tables do not match the TraversalSet's counts")
    if rays.shape[0] >= 2**31 - RAY_TILE:
        raise ValueError("too many rays for one launch")


def closest_hit_traverse_kernel(ts: TraversalSet, rays: torch.Tensor):
    """Launch csrc/traverse.cu's closest-hit kernel (the ordered walk of the
    child-pair table); same contract as closest_hit_ordered_plain."""
    from mcpt_tpu_torch.ops._build import check, library

    _check_inputs(ts, rays)
    R = rays.shape[0]
    dev = rays.device
    out_t = torch.empty((R,), device=dev)
    out_tri = torch.empty((R,), dtype=torch.int32, device=dev)
    out_u = torch.empty((R,), device=dev)
    out_v = torch.empty((R,), device=dev)
    if R == 0:
        return out_t, out_tri, out_u, out_v
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(library().traverse_closest(
        _ptr(rays), _ptr(ts.nodes), _ptr(ts.pairs), _ptr(ts.tris), R, ts.root_ref, ts.n_nodes, ts.depth,
        _ptr(out_t), _ptr(out_tri), _ptr(out_u), _ptr(out_v), ctypes.c_void_p(stream)), "traverse_closest")
    LAUNCHES["closest"] += 1
    return out_t, out_tri, out_u, out_v


def any_hit_traverse_kernel(ts: TraversalSet, rays: torch.Tensor):
    """Launch csrc/traverse.cu's any-hit kernel (the walk of the child-pair
    table, nearer child first); same contract as any_hit_ordered_plain."""
    from mcpt_tpu_torch.ops._build import check, library

    _check_inputs(ts, rays)
    R = rays.shape[0]
    out = torch.empty((R,), dtype=torch.bool, device=rays.device)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    check(library().traverse_any(
        _ptr(rays), _ptr(ts.nodes), _ptr(ts.pairs), _ptr(ts.tris), R, ts.root_ref, ts.n_nodes, ts.depth,
        _ptr(out), ctypes.c_void_p(stream)), "traverse_any")
    LAUNCHES["any"] += 1
    return out


def _sorted(ts: TraversalSet, org, dirn, t_min, t_max, kernel, plain):
    """Pack, sort above RAY_TILE rays, run the kernel on a CUDA tensor or the
    plain version on a CPU tensor, and scatter back to the callers' order."""
    rays = pack_rays(org, dirn, t_min, t_max)
    order = None
    if rays.shape[0] > RAY_TILE:
        order = ray_sort_order(ts, rays[:, 0:3], rays[:, 4:7])
        rays = rays[order]
    out = kernel(ts, rays) if rays.is_cuda else plain(ts, rays)
    if order is None:
        return out

    def back(x):
        y = torch.empty_like(x)
        y[order] = x
        return y

    return tuple(back(x) for x in out) if isinstance(out, tuple) else back(out)


def closest_hit_traverse(ts: TraversalSet, org, dirn, t_min, t_max):
    """(t, tri, u, v) of each ray: the CUDA kernel on a CUDA tensor, its plain
    version (the ordered walk) on a CPU tensor."""
    return _sorted(ts, org, dirn, t_min, t_max, closest_hit_traverse_kernel, closest_hit_ordered_plain)


def any_hit_traverse(ts: TraversalSet, org, dirn, t_min, t_max):
    """bool[R] occlusion: the CUDA kernel on a CUDA tensor, its plain version
    (the walk of the child-pair table) on a CPU tensor."""
    return _sorted(ts, org, dirn, t_min, t_max, any_hit_traverse_kernel, any_hit_ordered_plain)
