"""Helpers shared by the tests that hold mcpt_tpu_torch against mcpt_tpu:
carry a JAX scene's arrays across, and convert state between the two."""
import dataclasses

import numpy as np
import torch


def jax_scene_arrays(scene) -> dict:
    """Named numpy arrays of a JAX `Scene`, as mcpt_tpu_torch.scene.scene_from_arrays takes them."""
    d = {}
    for group in ("geom", "mats", "camera"):
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if val is not None:
                d[f"{group}.{f.name}"] = val if isinstance(val, int) else np.asarray(val)
    d["atlas.data"] = np.asarray(scene.atlas.data)
    d["atlas.size"] = np.asarray(scene.atlas.size)
    d["light_tris"] = np.asarray(scene.light_tris)
    if scene.bvh is not None:
        for f in dataclasses.fields(scene.bvh):
            d[f"bvh.{f.name}"] = np.asarray(getattr(scene.bvh, f.name))
    d["scale"] = scene.scale
    d["num_verts"] = scene.num_verts
    return d


def torch_scene(scene):
    """The port's scene (on the CPU) from a JAX scene's arrays, its treelet
    layout carried across when it has one."""
    from mcpt_tpu_torch.scene import scene_from_arrays

    d = jax_scene_arrays(scene)
    if getattr(scene, "treelets", None) is not None:
        for name in ("sb_box", "blk_box", "tri"):
            d[f"treelets.{name}"] = np.asarray(getattr(scene.treelets, name))
    return scene_from_arrays(d, device="cpu")


def to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def treelet_soup(rng, T, c=16, s_b=8):
    """A random triangle soup in BVH order (mcpt_tpu's numpy builder) with
    its treelet layout on both sides: (JAX stand-in scene with .treelets, the
    port's stand-in with .trav and .treelets from its own build, v0, e1, e2).
    Small c and s_b give a deep two-level layout at a few thousand
    triangles (tests/test_treelets.py's choice)."""
    import types

    from mcpt_tpu.ops.bvh import build_bvh_arrays
    from mcpt_tpu.ops.treelets import build_treelets as jax_build
    from mcpt_tpu_torch.ops.traverse import pack_traversal
    from mcpt_tpu_torch.ops.treelets import build_treelets
    from mcpt_tpu_torch.scene import FlatBVH, _to

    base = rng.uniform(-5.0, 5.0, (T, 3))
    e1 = rng.normal(size=(T, 3)) * 0.8
    e2 = rng.normal(size=(T, 3)) * 0.8
    nodes, perm = build_bvh_arrays(base, e1, e2, use_native=False)
    v0, e1, e2 = (x[perm].astype(np.float32) for x in (base, e1, e2))
    jts = jax_build(v0, e1, e2, nodes, c=c, s_b=s_b)
    bvh = FlatBVH(**{k: torch.from_numpy(np.asarray(nodes[k])) for k in ("lo", "hi", "first", "count", "skip")})
    port = types.SimpleNamespace(trav=pack_traversal(bvh, *(torch.from_numpy(x) for x in (v0, e1, e2))),
                                 treelets=_to(build_treelets(nodes, T, c, s_b), torch.device("cpu")))
    return types.SimpleNamespace(treelets=jts), port, v0, e1, e2


def soup_rays(rng, R, spread=6.0):
    """Rays from a box around the soup in random directions; the first
    quarter share one origin (a camera-like bundle)."""
    o = rng.uniform(-spread, spread, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[: R // 4] = o[0]
    return o, d


def deep_chain(D, rng, device="cpu", with_bvh=False):
    """A TraversalSet whose inner nodes form a chain D deep, and rays that
    walk it. Inner node 2k's children are leaf 2k+1 (triangle k) and inner
    node 2k+2, whose box holds every triangle below it, so a ray that enters
    that box first goes down the chain and pushes leaf after leaf: its stack
    holds up to D entries. Each triangle is an axis-aligned right triangle at
    a random z, in a leaf box 0.02 thick, and covers x, y in [0.5, 1]; a
    quarter of the rays go up through that square."""
    from mcpt_tpu_torch.ops.traverse import pack_traversal
    from mcpt_tpu_torch.scene import FlatBVH

    T, N = D + 1, 2 * D + 1
    corner = rng.uniform(0.0, 0.5, (T, 2))
    size = rng.uniform(1.0, 1.5, (T, 1))
    z = rng.uniform(0.0, 1.0, (T, 1))
    v0 = np.concatenate([corner, z], axis=1).astype(np.float32)
    e1 = np.concatenate([size, np.zeros((T, 2))], axis=1).astype(np.float32)
    e2 = np.concatenate([np.zeros((T, 1)), size, np.zeros((T, 1))], axis=1).astype(np.float32)
    leaf_lo = np.concatenate([corner, z - 0.01], axis=1)
    leaf_hi = np.concatenate([corner + size, z + 0.01], axis=1)
    below_lo = np.minimum.accumulate(leaf_lo[::-1])[::-1]  # over triangles k..D
    below_hi = np.maximum.accumulate(leaf_hi[::-1])[::-1]
    leaves = [2 * k + 1 for k in range(D)] + [2 * D]
    lo, hi = np.zeros((N, 3)), np.zeros((N, 3))
    count, first = np.zeros(N, np.int32), np.zeros(N, np.int32)
    skip = np.full(N, -1, np.int32)
    for k, n in enumerate(leaves):
        lo[n], hi[n], count[n], first[n] = leaf_lo[k], leaf_hi[k], 1, k
    for k in range(D):
        lo[2 * k], hi[2 * k] = below_lo[k], below_hi[k]
        skip[2 * k + 1] = 2 * k + 2  # a left leaf skips to its sibling
    bvh = FlatBVH(**{k: torch.from_numpy(x).to(device) for k, x in
                     (("lo", lo.astype(np.float32)), ("hi", hi.astype(np.float32)), ("first", first),
                      ("count", count), ("skip", skip))})
    ts = pack_traversal(bvh, *(torch.from_numpy(x).to(device) for x in (v0, e1, e2)))
    R = 4096
    o = np.concatenate([rng.uniform(-0.5, 2.5, (R, 2)), rng.uniform(-2.0, 3.0, (R, 1))], axis=1)
    d = rng.normal(size=(R, 3)) * [0.3, 0.3, 1.0]
    d[: R // 2, 2] = np.abs(d[: R // 2, 2])  # half aimed up the chain
    q = R // 4
    o[:q] = np.concatenate([rng.uniform(0.5, 0.75, (q, 2)), np.full((q, 1), -1.5)], axis=1)
    d[:q] = rng.normal(size=(q, 3)) * [0.05, 0.05, 0.0] + [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = (ts, o.astype(np.float32), d.astype(np.float32))
    return out + (bvh,) if with_bvh else out
