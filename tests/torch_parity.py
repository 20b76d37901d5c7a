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
    from mcpt_tpu_torch.scene import scene_from_arrays

    return scene_from_arrays(jax_scene_arrays(scene), device="cpu")


def to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
