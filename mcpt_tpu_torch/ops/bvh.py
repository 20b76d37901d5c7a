"""Host-side BVH construction -> flattened skip-link arrays (numpy).

Nodes are in DFS preorder: on an AABB hit the next node is i+1, on a miss
skip[i] (-1 ends the walk); a leaf covers triangles first[i] ..
first[i]+count[i] of the reordered buffer. Triangles are permuted into leaf
order, which also makes contiguous triangle chunks spatially coherent: the
Woop kernel's chunk culling (ops/woop.py) relies on that.

The builder is the binned-SAH builder that mcpt_tpu runs by default
(mcpt_tpu/native/mcpt_native.cpp, mcpt_build_bvh), written here in numpy so
that the triangle order, and with it every triangle id, equals the JAX
package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from mcpt_tpu_torch.scene import FlatBVH, Scene, permute_scene_tris

DEFAULT_LEAF_SIZE = 4
_SAH_BINS = 16


def _tri_boxes(v0, e1, e2):
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    return lo, hi, (p0 + p1 + p2) / 3.0


def _half_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def _sah_split(order, l, r, cen, tlo, thi, node_lo, node_hi, leaf_size):
    """Split point of order[l:r) (partitioning it in place), as the native
    builder's find_split does, step for step."""
    seg = order[l:r]
    c = cen[seg]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    ext = c_hi - c_lo
    axis = 1 if ext[1] > ext[0] else 0
    if ext[2] > ext[axis]:
        axis = 2
    if ext[axis] <= 0.0:
        return (l + r) // 2
    scale = _SAH_BINS / ext[axis]
    cax = c[:, axis]
    bidx = np.clip(((cax - c_lo[axis]) * scale).astype(np.int64), 0, _SAH_BINS - 1)
    big = np.finfo(np.float64).max
    bin_lo = np.full((_SAH_BINS, 3), big)
    bin_hi = np.full((_SAH_BINS, 3), -big)
    np.minimum.at(bin_lo, bidx, tlo[seg])
    np.maximum.at(bin_hi, bidx, thi[seg])
    bin_cnt = np.bincount(bidx, minlength=_SAH_BINS)
    left_lo = np.minimum.accumulate(bin_lo, axis=0)
    left_hi = np.maximum.accumulate(bin_hi, axis=0)
    left_cnt = np.cumsum(bin_cnt)
    n = r - l
    best, best_bin = big, -1
    r_lo, r_hi = np.full(3, big), np.full(3, -big)
    for i in range(_SAH_BINS - 1, 0, -1):
        r_lo = np.minimum(r_lo, bin_lo[i])
        r_hi = np.maximum(r_hi, bin_hi[i])
        rc = n - left_cnt[i - 1]
        if left_cnt[i - 1] == 0 or rc == 0:
            continue
        cost = (_half_area(left_lo[i - 1], left_hi[i - 1]) * left_cnt[i - 1]
                + _half_area(r_lo, r_hi) * rc)
        if cost < best:
            best, best_bin = cost, i
    leaf_cost = _half_area(node_lo, node_hi) * n
    if best_bin < 0 or (n <= leaf_size and best >= leaf_cost):
        return (l + r) // 2
    split_val = c_lo[axis] + best_bin / scale
    # Lomuto partition with swaps, exactly as the native builder: the left
    # side keeps its order, the right side is permuted by the swaps.
    m = l
    for i in range(l, r):
        if cen[order[i], axis] < split_val:
            order[i], order[m] = order[m], order[i]
            m += 1
    if m == l or m == r:
        m = (l + r) // 2
    return m


def _build_bvh_sah(v0, e1, e2, leaf_size=DEFAULT_LEAF_SIZE):
    """Binned-SAH build (16 bins), preorder output. Returns (nodes, perm)."""
    T = v0.shape[0]
    tlo, thi, cen = _tri_boxes(v0, e1, e2)
    order = np.arange(T, dtype=np.int64)
    lo, hi, first, count, end = [], [], [], [], []
    frames = [[0, T, 0, -1, 0]]  # l, r, phase, node, m
    while frames:
        f = frames[-1]
        l, r, phase, idx, m = f
        if phase == 0:
            seg = order[l:r]
            nlo, nhi = tlo[seg].min(axis=0), thi[seg].max(axis=0)
            idx = len(lo)
            f[3] = idx
            lo.append(nlo)
            hi.append(nhi)
            first.append(0)
            count.append(0)
            end.append(0)
            if r - l <= leaf_size:
                first[idx], count[idx], end[idx] = l, r - l, idx + 1
                frames.pop()
                continue
            f[4] = _sah_split(order, l, r, cen, tlo, thi, nlo, nhi, leaf_size)
            f[2] = 1
            frames.append([l, f[4], 0, -1, 0])
        elif phase == 1:
            f[2] = 2
            frames.append([m, r, 0, -1, 0])
        else:
            end[idx] = len(lo)
            frames.pop()
    return _nodes(lo, hi, first, count, end), order


def _nodes(lo, hi, first, count, end):
    n = len(lo)
    skip = np.asarray(end, np.int64)
    return {
        "lo": np.asarray(lo, np.float32),
        "hi": np.asarray(hi, np.float32),
        "first": np.asarray(first, np.int32),
        "count": np.asarray(count, np.int32),
        "skip": np.where(skip >= n, -1, skip).astype(np.int32),
    }


def attach_bvh(scene: Scene, leaf_size: int = DEFAULT_LEAF_SIZE) -> Scene:
    """Build a BVH for a host (numpy) scene, permute its triangles into leaf
    order and attach the flat arrays."""
    g = scene.geom
    nodes, perm = _build_bvh_sah(np.asarray(g.v0, np.float64), np.asarray(g.e1, np.float64),
                                 np.asarray(g.e2, np.float64), leaf_size)
    scene = permute_scene_tris(scene, perm)
    return dataclasses.replace(scene, bvh=FlatBVH(**nodes))
