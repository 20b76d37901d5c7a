"""Skip-link BVH traversal: closest hit and any hit for large scenes (bathroom class).

Port of the function of mcpt_tpu/ops/pallas/traverse.py (the treelet kernel
pair `_closest_kernel` / `_any_kernel`, wrapped by closest_hit_treelets /
any_hit_treelets) onto the skip-link walk of mcpt_tpu/ops/traverse.py
(closest_hit_bvh / any_hit_bvh). The TPU kernel cuts the BVH into
superblocks and treelets because a TPU core tests 128 rays against 128
triangles at once and must stage both in VMEM; a GPU thread walks its own
ray, so this pair walks FlatBVH directly; the treelet layout
(ops/treelets.py) serves the select and schedule pairs (ops/select.py,
ops/schedule.py). Results are those of the treelet kernel: (t, tri, u, v)
for closest hit, a bool for any hit.

The walk, per ray, from the root: test the node's box (the reference's slab
test, src/AABB.cpp:25-36: far * 1.001, strict tmin < tmax, over
[t_min, min(best_t, t_max)] for closest hit and [t_min, t_max] for any hit;
min/max propagate NaN, so a ray parallel to a box plane that starts on it
misses the box, as jnp.minimum/maximum make it miss in the reference); on a
hit of an inner node go to node+1, on a hit of a leaf test its triangles and
go to skip, on a miss go to skip; -1 ends the walk, and an any-hit ray ends
at its first accept. The cursor only moves forward, so a walk ends within
the node count. Accept predicates are those of ops/intersect.py; a closest
hit takes the first of equal t in leaf order and then needs a strict
t < best_t, which is the reference's lowest-id-on-a-tie for the BVH walk.

Each function comes twice: the CUDA kernels in csrc/traverse.cu, launched by
`closest_hit_traverse` / `any_hit_traverse` on CUDA tensors, and the plain
torch versions, which the wrappers run on CPU tensors and which the card
compares the kernels with. Both write Moller-Trumbore and the slab test as
single f32 multiplies and adds in one fixed order, with no fused
multiply-add, so the two agree bit for bit. Above RAY_TILE rays the
wrappers sort the rays by (octant, origin Morton, direction Morton) first,
as mcpt_tpu's _ray_sort_order does, and scatter the results back.
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

# Launch counts of the kernels, and call counts of their plain versions.
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


@dataclass(frozen=True)
class TraversalSet:
    """Per-scene kernel tables, packed once by pack_traversal.

    nodes row i: lo.xyz, first*8 + count (int32 bits), hi.xyz, skip (int32
    bits), two float4 loads a node; count 0 marks an inner node. tris row k:
    v0.xyz, 0, e1.xyz, 0, e2.xyz, 0, three float4 loads a triangle.
    """

    nodes: torch.Tensor  # f32[N, 8]
    tris: torch.Tensor  # f32[T, 12]
    n_nodes: int
    n_tris: int


def pack_traversal(bvh, v0, e1, e2) -> TraversalSet:
    """FlatBVH + geometry (in BVH order) -> TraversalSet. Raises ValueError
    when a leaf holds more than DEFAULT_LEAF_SIZE triangles or reaches past
    the last one."""
    T = v0.shape[0]
    N = bvh.lo.shape[0]
    count = bvh.count.to(torch.int32)
    first = bvh.first.to(torch.int32)
    if int(count.max()) > DEFAULT_LEAF_SIZE or int(count.min()) < 0:
        raise ValueError(f"leaves must hold 0..{DEFAULT_LEAF_SIZE} triangles")
    if int((first + count).max()) > T or int(first.min()) < 0:
        raise ValueError("a leaf reaches past the triangle buffer")
    word = torch.where(count > 0, first * 8 + count, 0).to(torch.int32)
    nodes = torch.cat([bvh.lo.float(), word.view(torch.float32)[:, None], bvh.hi.float(),
                       bvh.skip.to(torch.int32).view(torch.float32)[:, None]], dim=1)
    z = torch.zeros((T, 1), dtype=torch.float32, device=v0.device)
    tris = torch.cat([v0.float(), z, e1.float(), z, e2.float(), z], dim=1)
    return TraversalSet(nodes=nodes.contiguous(), tris=tris.contiguous(), n_nodes=N, n_tris=T)


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
    ta = (nd[:, 0:3] - o) * inv
    tb = (nd[:, 4:7] - o) * inv
    near = torch.minimum(ta, tb)
    far = torch.maximum(ta, tb) * FAR_FUDGE
    tmin = torch.maximum(t_lo, torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2]))
    tmax = torch.minimum(t_hi, torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2]))
    return tmin < tmax


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
    """Plain torch closest hit of packed rays (ops/woop.pack_rays): (t, tri,
    u, v), t = F32_MAX, tri = -1 and u = v = 0 on a miss. With `counts`, adds
    this call's node visits and triangle tests to it."""
    PLAIN_CALLS["closest"] += 1
    R = rays.shape[0]
    dev = rays.device
    res = [torch.full((R,), F32_MAX, device=dev), torch.full((R,), -1, dtype=torch.int32, device=dev),
           torch.zeros(R, device=dev), torch.zeros(R, device=dev)]
    ids, out = _walk(ts, rays, True, counts)
    for x, y in zip(res, out):
        x[ids] = y
    return tuple(res)


def any_hit_traverse_plain(ts: TraversalSet, rays: torch.Tensor, counts: Optional[dict] = None):
    """Plain torch any hit of packed rays: bool[R]. With `counts`, adds the
    node visits and the triangle tests up to each ray's first accept."""
    PLAIN_CALLS["any"] += 1
    res = torch.zeros(rays.shape[0], dtype=torch.bool, device=rays.device)
    ids, out = _walk(ts, rays, False, counts)
    res[ids] = out[1] >= 0
    return res


def _check_inputs(ts: TraversalSet, rays):
    for name, x in (("nodes", ts.nodes), ("tris", ts.tris), ("rays", rays)):
        if not x.is_cuda or not x.is_contiguous() or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous f32 CUDA tensor")
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError("rays must be f32[R,8] (ops/woop.pack_rays)")
    if ts.nodes.shape != (ts.n_nodes, 8) or ts.tris.shape != (ts.n_tris, 12):
        raise ValueError("tables do not match the TraversalSet's counts")
    if rays.shape[0] >= 2**31 - RAY_TILE:
        raise ValueError("too many rays for one launch")


def closest_hit_traverse_kernel(ts: TraversalSet, rays: torch.Tensor):
    """Launch csrc/traverse.cu's closest-hit kernel; same contract as the plain version."""
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
        _ptr(rays), _ptr(ts.nodes), _ptr(ts.tris), R, ts.n_nodes, _ptr(out_t), _ptr(out_tri),
        _ptr(out_u), _ptr(out_v), ctypes.c_void_p(stream)), "traverse_closest")
    LAUNCHES["closest"] += 1
    return out_t, out_tri, out_u, out_v


def any_hit_traverse_kernel(ts: TraversalSet, rays: torch.Tensor):
    """Launch csrc/traverse.cu's any-hit kernel; same contract as the plain version."""
    from mcpt_tpu_torch.ops._build import check, library

    _check_inputs(ts, rays)
    R = rays.shape[0]
    out = torch.empty((R,), dtype=torch.bool, device=rays.device)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    check(library().traverse_any(
        _ptr(rays), _ptr(ts.nodes), _ptr(ts.tris), R, ts.n_nodes, _ptr(out),
        ctypes.c_void_p(stream)), "traverse_any")
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
    """(t, tri, u, v) of each ray: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    return _sorted(ts, org, dirn, t_min, t_max, closest_hit_traverse_kernel, closest_hit_traverse_plain)


def any_hit_traverse(ts: TraversalSet, org, dirn, t_min, t_max):
    """bool[R] occlusion: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    return _sorted(ts, org, dirn, t_min, t_max, any_hit_traverse_kernel, any_hit_traverse_plain)
