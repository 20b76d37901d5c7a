"""Host-side BVH construction -> flattened skip-link arrays (numpy).

Nodes are in DFS preorder: on an AABB hit the next node is i+1, on a miss
skip[i] (-1 ends the walk); a leaf covers triangles first[i] ..
first[i]+count[i] of the reordered buffer. Triangles are permuted into leaf
order, which also makes contiguous triangle chunks spatially coherent: the
Woop kernel's chunk culling (ops/woop.py) relies on that, and the traversal
kernels (ops/traverse.py) walk these arrays.

The builder is the binned-SAH builder that mcpt_tpu runs by default
(mcpt_tpu/native/mcpt_native.cpp, mcpt_build_bvh), kept as the port's own
C++ copy in csrc/host/bvh_sah.cpp and built with g++ on first use
(ops/_build.py), so that the triangle order, and with it every triangle id,
equals the JAX package's. A million triangles build in about a second.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from mcpt_tpu_torch.scene import FlatBVH, Scene, permute_scene_tris

DEFAULT_LEAF_SIZE = 4


def _build_bvh_sah(v0, e1, e2, leaf_size=DEFAULT_LEAF_SIZE):
    """Binned-SAH build (16 bins), preorder output. Returns (nodes, perm):
    nodes = {lo, hi, first, count, skip}, perm the leaf order of the
    triangles (tri_new[k] = tri_old[perm[k]])."""
    from mcpt_tpu_torch.ops._build import host_library

    v0, e1, e2 = (np.ascontiguousarray(x, np.float64) for x in (v0, e1, e2))
    T = v0.shape[0]
    if T == 0 or any(x.shape != (T, 3) for x in (e1, e2)):
        raise ValueError(f"v0, e1, e2 must be [T,3] with T > 0, got {v0.shape}, {e1.shape}, {e2.shape}")
    cap = 2 * T
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    perm = np.empty(T, np.int64)

    def p(a):
        return ctypes.c_void_p(a.ctypes.data)

    n = host_library().mcpt_torch_build_bvh(p(v0), p(e1), p(e2), T, leaf_size, p(lo), p(hi),
                                            p(first), p(count), p(skip), p(perm))
    if n <= 0:
        raise RuntimeError(f"BVH build failed (rc={n}) for {T} triangles")
    nodes = {"lo": lo[:n].copy(), "hi": hi[:n].copy(), "first": first[:n].copy(),
             "count": count[:n].copy(), "skip": skip[:n].copy()}
    return nodes, perm


def attach_bvh(scene: Scene, leaf_size: int = DEFAULT_LEAF_SIZE) -> Scene:
    """Build a BVH for a host (numpy) scene, permute its triangles into leaf
    order and attach the flat arrays; above 4,096 triangles also the
    treelet layout (ops/treelets.py), as mcpt_tpu's attach_bvh does."""
    from mcpt_tpu_torch.ops.intersect import BRUTE_FORCE_MAX_TRIS
    from mcpt_tpu_torch.ops.treelets import build_treelets

    g = scene.geom
    nodes, perm = _build_bvh_sah(g.v0, g.e1, g.e2, leaf_size)
    scene = permute_scene_tris(scene, perm)
    T = scene.num_tris
    treelets = build_treelets(nodes, T) if T > BRUTE_FORCE_MAX_TRIS else None
    return dataclasses.replace(scene, bvh=FlatBVH(**nodes), treelets=treelets)
