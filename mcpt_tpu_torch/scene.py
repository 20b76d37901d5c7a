"""Scene representation: structure-of-arrays tensors on one device.

Mirrors mcpt_tpu/scene.py. Host loading builds numpy arrays; `to_device`
moves every array to the scene's device in one place, and all render code
consumes the resulting `Scene`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card; nothing moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclass(frozen=True)
class Camera:
    """Pinhole camera from the scene XML (reference: src/model.cpp:211-262)."""

    eye: torch.Tensor  # f32[3]
    lookat: torch.Tensor  # f32[3]
    up: torch.Tensor  # f32[3]
    fovy: torch.Tensor  # f32[] degrees
    width: int = 512
    height: int = 512


@dataclass(frozen=True)
class Materials:
    """Flat material table (reference: src/model.h:32-40). tr/ni are unused
    by shading and kept for parity."""

    kd: torch.Tensor  # f32[M,3]
    ks: torch.Tensor  # f32[M,3]
    ns: torch.Tensor  # f32[M]
    radiance: torch.Tensor  # f32[M,3]
    tex_id: torch.Tensor  # i32[M], -1 = use kd
    tr: torch.Tensor  # f32[M,3]
    ni: torch.Tensor  # f32[M]


@dataclass(frozen=True)
class Geometry:
    """Triangle soup with precomputed Moller-Trumbore edges."""

    v0: torch.Tensor  # f32[T,3]
    e1: torch.Tensor  # f32[T,3]  v1-v0
    e2: torch.Tensor  # f32[T,3]  v2-v0
    vn: torch.Tensor  # f32[T,3,3] per-vertex shading normals
    uv: torch.Tensor  # f32[T,3,2] per-vertex texture coords
    mat_id: torch.Tensor  # i32[T]
    area: torch.Tensor  # f32[T]
    vert_idx: Optional[torch.Tensor] = None  # i32[T,3] shared-vertex ids


@dataclass(frozen=True)
class TextureAtlas:
    """All image textures padded into one [N,H,W,3] block; size[i] = (w, h)."""

    data: torch.Tensor  # f32[N,H,W,3]
    size: torch.Tensor  # i32[N,2]


@dataclass(frozen=True)
class FlatBVH:
    """Preorder BVH with skip links (see ops/bvh.py for the layout)."""

    lo: torch.Tensor  # f32[N,3]
    hi: torch.Tensor  # f32[N,3]
    first: torch.Tensor  # i32[N]
    count: torch.Tensor  # i32[N]
    skip: torch.Tensor  # i32[N], -1 = done


@dataclass(frozen=True)
class Scene:
    geom: Geometry
    mats: Materials
    atlas: TextureAtlas
    light_tris: torch.Tensor  # i32[L]
    camera: Camera
    bvh: Optional[FlatBVH] = None
    # Woop kernel tables (ops/woop.WoopSet), built once per scene.
    woop: Optional[object] = None
    # BVH traversal kernel tables (ops/traverse.TraversalSet), built once per scene.
    trav: Optional[object] = None
    # Treelet layout of the BVH (ops/treelets.TreeletSet), above 4,096 triangles.
    treelets: Optional[object] = None
    # Scene bbox diagonal; secondary-ray t_min is RAY_EPS_REL * scale.
    scale: float = 1.0
    num_verts: int = 0

    @property
    def num_tris(self) -> int:
        return self.geom.v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tris.shape[0]

    @property
    def device(self) -> torch.device:
        return self.geom.v0.device


# Emitter threshold: |radiance| > 0.01 (reference: src/Render.cpp:41-42).
LIGHT_RADIANCE_THRESHOLD = 0.01


def _to(x, device):
    if x is None or isinstance(x, (int, float)):
        return x
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: _to(getattr(x, f.name), device)
                  for f in dataclasses.fields(x)}
        )
    return torch.as_tensor(np.array(x), device=device)


def to_device(scene: Scene, device) -> Scene:
    """Every array of `scene` (numpy or torch) as a tensor on `device`."""
    return _to(scene, resolve_device(device))


def build_scene_host(vertices, normals, uvs, faces, mats: dict, atlas, camera: dict) -> Scene:
    """Flatten indexed faces into the SoA triangle soup (numpy leaves).

    Mirrors mcpt_tpu.scene.build_scene_host (reference src/Render.cpp:12-44):
    corner-0 material, precomputed areas, emitters with |radiance| > 0.01.
    """
    f = np.asarray(faces)
    T = f.shape[0]
    v = vertices[f[:, :, 0]].astype(np.float64)
    vn = normals[f[:, :, 1]].astype(np.float32)
    if uvs.shape[0] == 0:
        uv = np.zeros((T, 3, 2), np.float32)
    else:
        uv = uvs[np.clip(f[:, :, 2], 0, uvs.shape[0] - 1)].astype(np.float32)
    mat_id = f[:, 0, 3].astype(np.int32)

    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    radiance = mats["radiance"]
    light_mask = np.linalg.norm(radiance[mat_id], axis=-1) > LIGHT_RADIANCE_THRESHOLD
    light_tris = np.nonzero(light_mask)[0].astype(np.int32)

    if atlas is None:
        atlas_data = np.zeros((1, 1, 1, 3), np.float32)
        atlas_size = np.ones((1, 2), np.int32)
    else:
        atlas_data, atlas_size = atlas

    geom = Geometry(
        v0=np.asarray(v0, np.float32),
        e1=np.asarray(e1, np.float32),
        e2=np.asarray(e2, np.float32),
        vn=np.asarray(vn, np.float32),
        uv=np.asarray(uv, np.float32),
        mat_id=mat_id,
        area=np.asarray(area, np.float32),
        vert_idx=np.asarray(f[:, :, 0], np.int32),
    )
    materials = Materials(
        kd=np.asarray(mats["kd"], np.float32),
        ks=np.asarray(mats["ks"], np.float32),
        ns=np.asarray(mats["ns"], np.float32),
        radiance=np.asarray(mats["radiance"], np.float32),
        tex_id=np.asarray(mats["tex_id"], np.int32),
        tr=np.asarray(mats.get("tr", np.zeros_like(mats["kd"])), np.float32),
        ni=np.asarray(mats.get("ni", np.ones_like(mats["ns"])), np.float32),
    )
    cam = Camera(
        eye=np.asarray(camera["eye"], np.float32),
        lookat=np.asarray(camera["lookat"], np.float32),
        up=np.asarray(camera["up"], np.float32),
        fovy=np.asarray(camera["fovy"], np.float32),
        width=int(camera["width"]),
        height=int(camera["height"]),
    )
    if vertices.shape[0] > 0:
        diag = float(np.linalg.norm(vertices.max(axis=0) - vertices.min(axis=0)))
    else:
        diag = 1.0
    return Scene(
        geom=geom,
        mats=materials,
        atlas=TextureAtlas(data=np.asarray(atlas_data, np.float32),
                           size=np.asarray(atlas_size, np.int32)),
        light_tris=light_tris,
        camera=cam,
        scale=diag if diag > 0 else 1.0,
        num_verts=int(vertices.shape[0]),
    )


def permute_scene_tris(scene: Scene, perm: np.ndarray) -> Scene:
    """Reorder the (numpy) triangle buffer into BVH leaf order and remap the
    light list."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    g = scene.geom
    geom = dataclasses.replace(
        g, **{f.name: None if getattr(g, f.name) is None else np.asarray(getattr(g, f.name))[perm]
              for f in dataclasses.fields(g)}
    )
    light_tris = inv[np.asarray(scene.light_tris)].astype(np.int32)
    return dataclasses.replace(scene, geom=geom, light_tris=light_tris)


_GEOM_KEYS = ("v0", "e1", "e2", "vn", "uv", "mat_id", "area", "vert_idx")
_MAT_KEYS = ("kd", "ks", "ns", "radiance", "tex_id", "tr", "ni")
_CAM_KEYS = ("eye", "lookat", "up", "fovy")
_BVH_KEYS = ("lo", "hi", "first", "count", "skip")


def scene_from_arrays(d: dict, device=None) -> Scene:
    """Build a Scene from named numpy arrays, e.g. those of a JAX `Scene`.

    Keys: geom.{v0,e1,e2,vn,uv,mat_id,area[,vert_idx]},
    mats.{kd,ks,ns,radiance,tex_id,tr,ni}, atlas.{data,size}, light_tris,
    camera.{eye,lookat,up,fovy,width,height}, scale, num_verts and, when the
    scene has a BVH, bvh.{lo,hi,first,count,skip}, and with it, optionally,
    an mcpt_tpu TreeletSet's treelets.{sb_box,blk_box,tri}. Triangles keep
    the given order, so triangle ids match the source exactly. A scene with
    a BVH above 4,096 triangles and no treelets gets the layout built from
    its BVH.
    """
    geom = Geometry(**{k: d.get("geom." + k) for k in _GEOM_KEYS})
    mats = Materials(**{k: d["mats." + k] for k in _MAT_KEYS})
    cam = Camera(**{k: d["camera." + k] for k in _CAM_KEYS},
                 width=int(d["camera.width"]), height=int(d["camera.height"]))
    from mcpt_tpu_torch.ops import treelets as tl
    from mcpt_tpu_torch.ops.intersect import BRUTE_FORCE_MAX_TRIS

    bvh = treelets = None
    n_tris = np.asarray(d["geom.v0"]).shape[0]
    if "bvh.lo" in d:
        bvh = FlatBVH(**{k: d["bvh." + k] for k in _BVH_KEYS})
        if "treelets.sb_box" in d:
            treelets = tl.treelets_from_jax(d["treelets.sb_box"], d["treelets.blk_box"],
                                            d["treelets.tri"], n_tris, bvh)
        elif n_tris > BRUTE_FORCE_MAX_TRIS:
            treelets = tl.build_treelets(bvh, n_tris)
    scene = Scene(
        geom=geom, mats=mats,
        atlas=TextureAtlas(data=d["atlas.data"], size=d["atlas.size"]),
        light_tris=d["light_tris"], camera=cam, bvh=bvh, treelets=treelets,
        scale=float(d["scale"]), num_verts=int(d.get("num_verts", 0)),
    )
    return finalize_scene(to_device(scene, device))


def finalize_scene(scene: Scene) -> Scene:
    """Attach the per-scene intersection tables that dispatch needs."""
    from mcpt_tpu_torch.ops.intersect import uses_traversal_kernel, uses_woop_kernel

    g = scene.geom
    if uses_woop_kernel(scene):
        from mcpt_tpu_torch.ops.woop import pack_woop_table

        scene = dataclasses.replace(scene, woop=pack_woop_table(g.v0, g.e1, g.e2))
    elif uses_traversal_kernel(scene) and scene.bvh is not None:
        from mcpt_tpu_torch.ops.traverse import pack_traversal

        scene = dataclasses.replace(scene, trav=pack_traversal(scene.bvh, g.v0, g.e1, g.e2))
    return scene
