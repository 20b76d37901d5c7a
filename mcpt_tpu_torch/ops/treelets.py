"""Two-level treelet layout over the flat BVH: the data the schedule and
select kernels (ops/schedule.py, ops/select.py, csrc/treelet.cu) walk.

Port of mcpt_tpu/ops/treelets.py, numpy over the FlatBVH nodes:
  * treelet    = a BVH subtree with <= c triangles and its exact box; its
    triangles are contiguous in the BVH-ordered buffer;
  * superblock = a higher BVH subtree holding <= s_b whole treelets, with
    its exact box; its treelet slots are padded to s_b with inverted boxes.
Both cuts are subtree-aligned, so every box is a BVH node box.

Arrays (the box tables and row numbering are mcpt_tpu's exactly, so the
schedule keys, which carry the row in their low bits, mean the same row):
  sb_box    f32[8, NSp]     rows lo.xyz, hi.xyz, valid flag, pad; columns
                            past NS hold inverted boxes (NSp = NS rounded up
                            to 128)
  blk_box   f32[NS, 8, S_B] the treelet boxes of each superblock, same rows
  row_first i32[G]          treelet row g = s * S_B + k covers triangles
  row_count i32[G]          row_first[g] .. row_first[g] + row_count[g] - 1
                            of the BVH-ordered buffer (count 0: a pad slot)
Each treelet's own sub-BVH, read in place from the child-pair table
(ops/traverse.TraversalSet.pairs: one row per inner node, in preorder, so a
subtree's inner nodes are one run of rows):
  row_pair_first i32[G]     its inner nodes are pairs rows row_pair_first[g]
  row_pair_count i32[G]     .. + row_pair_count[g] - 1 (0: a single leaf)
  row_root       i32[G]     its root's ref made local (-1 for a pad slot)
  tdepth                    the most inner nodes on a path inside a treelet
A local ref subtracts the treelet's bases from a ref of the table: an inner
ref row*8 becomes (row - row_pair_first[g])*8, a leaf ref first*8 + count
becomes (first - row_first[g])*8 + count. The select kernels stage both runs
and rebase each ref they read (csrc/treelet.cu).
mcpt_tpu copies each treelet's triangles into a padded f32[G, 16, C] block
(136 MiB at bathroom-stress, a third of it padding); the port keeps the
triangles where they are (ops/traverse.TraversalSet.tris) and stores the
ranges, so triangle ids are the BVH-order indices, as mcpt_tpu's are.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DEFAULT_C = 128  # triangles per treelet
DEFAULT_SB = 128  # treelet slots per superblock
PAD_TRI_ID = 2**30  # id of mcpt_tpu's pad triangles

_INV_LO = np.float32(np.finfo(np.float32).max)
_INV_HI = np.float32(-np.finfo(np.float32).max)


@dataclass(frozen=True)
class TreeletSet:
    """The layout's arrays (module docstring); numpy on the host, tensors
    once the scene is on a device."""

    sb_box: torch.Tensor  # f32[8, NSp]
    blk_box: torch.Tensor  # f32[NS, 8, S_B]
    row_first: torch.Tensor  # i32[G]
    row_count: torch.Tensor  # i32[G]
    row_pair_first: torch.Tensor  # i32[G]
    row_pair_count: torch.Tensor  # i32[G]
    row_root: torch.Tensor  # i32[G]
    tdepth: int
    n_real_tris: int
    c: int

    @property
    def nsp(self) -> int:
        return self.sb_box.shape[1]

    @property
    def ns(self) -> int:
        return self.blk_box.shape[0]

    @property
    def s_b(self) -> int:
        return self.blk_box.shape[2]

    @property
    def g(self) -> int:
        return self.ns * self.s_b


def _subtree_ranges(count, skip):
    """Per-node (tri_start, tri_count, end) of the preorder flat BVH: node
    i's subtree covers triangles [sum of leaf counts before i, + its count)."""
    count = np.asarray(count, np.int64)
    skip = np.asarray(skip, np.int64)
    n = count.shape[0]
    end = np.where(skip < 0, n, skip)
    cum = np.concatenate([[0], np.cumsum(count)])
    return cum[:-1], cum[end] - cum[:-1], end


def _cut(count, end, keep):
    """Preorder frontier of the highest nodes with keep(i) (leaves always
    kept), as node indices in preorder."""
    out = []
    stack = [0]
    while stack:
        i = stack.pop()
        if count[i] > 0 or keep(i):
            out.append(i)
            continue
        stack.append(int(end[i + 1]))  # right child, popped after the left
        stack.append(i + 1)
    return np.asarray(out, np.int64)


def _sub_bvhs(count, end, tri_start, roots, row_first):
    """row_pair_first, row_pair_count, row_root (i32[G]) and tdepth of the
    rows whose treelet roots are the BVH nodes `roots` (-1: a pad slot)."""
    n = count.shape[0]
    inner = (count == 0).astype(np.int64)
    n_inner_before = np.concatenate([[0], np.cumsum(inner)])  # pairs row of inner node i
    # inner ancestors of each node: +1 inside (j, end[j]) of every inner j
    diff = np.zeros(n + 1, np.int64)
    j = np.nonzero(inner)[0]
    np.add.at(diff, j + 1, 1)
    np.add.at(diff, end[j], -1)
    depth = np.cumsum(diff)[:n]
    real = roots >= 0
    r = roots[real]
    pair_first = np.zeros(roots.shape[0], np.int32)
    pair_count = np.zeros(roots.shape[0], np.int32)
    root = np.full(roots.shape[0], -1, np.int32)
    pair_first[real] = n_inner_before[r]
    pair_count[real] = n_inner_before[end[r]] - n_inner_before[r]
    # a local ref: 0 for an inner root (its own row), count for a leaf root
    root[real] = np.where(count[r] > 0, (tri_start[r] - row_first[real]) * 8 + count[r], 0)
    # deepest path inside a treelet: each leaf against its treelet's root
    order = np.argsort(r, kind="stable")
    leaves = np.nonzero(count > 0)[0]
    k = np.searchsorted(r[order], leaves, side="right") - 1
    tdepth = int((depth[leaves] - depth[r[order][k]]).max()) if leaves.shape[0] else 0
    return pair_first, pair_count, root, tdepth


def _bvh_arrays(bvh, n_tris):
    """lo, hi, count, and the subtree ranges of a preorder FlatBVH (or a dict
    with its arrays) checked against n_tris."""
    get = bvh.get if isinstance(bvh, dict) else lambda k: getattr(bvh, k)
    lo, hi = (np.asarray(get(k), np.float32) for k in ("lo", "hi"))
    count = np.asarray(get("count"), np.int64)
    tri_start, tri_count, end = _subtree_ranges(count, np.asarray(get("skip")))
    if tri_count[0] != n_tris:
        raise ValueError(f"the BVH covers {tri_count[0]} triangles, not {n_tris}")
    leaf = count > 0
    if not (tri_start[leaf] == np.asarray(get("first"))[leaf]).all():
        raise ValueError("leaf ranges are not in preorder")
    return lo, hi, count, tri_start, tri_count, end


def build_treelets(bvh, n_tris: int, c: int = DEFAULT_C, s_b: int = DEFAULT_SB) -> TreeletSet:
    """The layout of a preorder FlatBVH (or a dict with its arrays) whose
    leaves cover n_tris triangles in BVH order. Numpy on the host."""
    lo, hi, count, tri_start, tri_count, end = _bvh_arrays(bvh, n_tris)

    tl = _cut(count, end, lambda i: tri_count[i] <= c)  # level 1: treelets
    tl_start, tl_count = tri_start[tl], tri_count[tl]

    def n_treelets_inside(i):
        a = np.searchsorted(tl_start, tri_start[i], side="left")
        b = np.searchsorted(tl_start, tri_start[i] + tri_count[i], side="left")
        return b - a

    sb = _cut(count, end, lambda i: n_treelets_inside(i) <= s_b)  # level 2: superblocks
    ns = len(sb)
    nsp = max(128, -(-ns // 128) * 128)
    sb_box = np.zeros((8, nsp), np.float32)
    sb_box[0:3], sb_box[3:6] = _INV_LO, _INV_HI
    sb_box[0:3, :ns], sb_box[3:6, :ns] = lo[sb].T, hi[sb].T
    sb_box[6, :ns] = 1.0

    blk_box = np.zeros((ns, 8, s_b), np.float32)
    blk_box[:, 0:3], blk_box[:, 3:6] = _INV_LO, _INV_HI
    row_first = np.zeros(ns * s_b, np.int32)
    row_count = np.zeros(ns * s_b, np.int32)
    # treelets are in preorder == triangle order: superblock s takes the run
    # of treelets that starts inside its triangle range
    a = np.searchsorted(tl_start, tri_start[sb], side="left")
    b = np.searchsorted(tl_start, tri_start[sb] + tri_count[sb], side="left")
    if not (a[1:] == b[:-1]).all() or a[0] != 0 or b[-1] != len(tl) or (b - a).max() > s_b:
        raise ValueError("superblocks do not partition the treelets")
    if not (tl_start[a] == tri_start[sb]).all():
        raise ValueError("a superblock does not start on a treelet boundary")
    s_of = np.repeat(np.arange(ns), b - a)
    k_of = np.arange(len(tl)) - np.repeat(a, b - a)
    blk_box[s_of, 0:3, k_of] = lo[tl]
    blk_box[s_of, 3:6, k_of] = hi[tl]
    blk_box[s_of, 6, k_of] = 1.0
    g = s_of * s_b + k_of
    row_first[g], row_count[g] = tl_start, tl_count
    roots = np.full(ns * s_b, -1, np.int64)
    roots[g] = tl
    pair_first, pair_count, root, tdepth = _sub_bvhs(count, end, tri_start, roots, row_first)
    return TreeletSet(sb_box=sb_box, blk_box=blk_box, row_first=row_first, row_count=row_count,
                      row_pair_first=pair_first, row_pair_count=pair_count, row_root=root, tdepth=tdepth,
                      n_real_tris=int(n_tris), c=int(c))


def treelets_from_jax(sb_box, blk_box, tri, n_real_tris: int, bvh) -> TreeletSet:
    """The port's layout from the numpy arrays of an mcpt_tpu TreeletSet
    over the preorder FlatBVH `bvh` (or a dict with its arrays): the boxes
    as they are, each tri row's ids as a (first, count) range, and as its
    root the highest node whose subtree covers exactly that range. Raises
    ValueError when a row's ids are not one contiguous run, or when no node
    covers a row's range."""
    tri = np.asarray(tri, np.float32)
    ids = np.ascontiguousarray(tri[:, 9, :]).view(np.int32)
    real = ids < PAD_TRI_ID
    count = real.sum(axis=1).astype(np.int32)
    first = np.where(count > 0, ids[:, 0], 0).astype(np.int32)
    want = first[:, None] + np.arange(tri.shape[2], dtype=np.int32)[None, :]
    if not (real == (np.arange(tri.shape[2])[None, :] < count[:, None])).all() or \
            not (np.where(real, ids, want) == want).all():
        raise ValueError("a treelet row is not a contiguous run of triangle ids")
    _, _, ncount, tri_start, tri_count, end = _bvh_arrays(bvh, n_real_tris)
    # the highest (first in preorder) node of each (start, count) range
    span = np.int64(n_real_tris) + 1
    keys, node = np.unique(tri_start * span + tri_count, return_index=True)
    real = count > 0
    want = first[real].astype(np.int64) * span + count[real]
    at = np.minimum(np.searchsorted(keys, want), keys.shape[0] - 1)
    if not (keys[at] == want).all():
        raise ValueError("a treelet row's triangles are not the range of one BVH subtree")
    roots = np.full(first.shape[0], -1, np.int64)
    roots[real] = node[at]
    pair_first, pair_count, root, tdepth = _sub_bvhs(ncount, end, tri_start, roots, first)
    return TreeletSet(sb_box=np.asarray(sb_box, np.float32), blk_box=np.asarray(blk_box, np.float32),
                      row_first=first, row_count=count, row_pair_first=pair_first, row_pair_count=pair_count,
                      row_root=root, tdepth=tdepth, n_real_tris=int(n_real_tris), c=int(tri.shape[2]))
