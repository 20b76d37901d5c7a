"""Host-side scene loading: OBJ + MTL + XML camera/lights -> numpy SoA.

Port of mcpt_tpu/io/obj.py (reference src/model.cpp:44-281) with the
pure-Python OBJ parser only. `load_scene` returns a `Scene` on the device
the caller names (CUDA by default).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class MaterialTable:
    names: List[str] = field(default_factory=list)
    kd: List[np.ndarray] = field(default_factory=list)
    ks: List[np.ndarray] = field(default_factory=list)
    ns: List[float] = field(default_factory=list)
    tr: List[np.ndarray] = field(default_factory=list)
    ni: List[float] = field(default_factory=list)
    radiance: List[np.ndarray] = field(default_factory=list)
    tex_path: List[Optional[str]] = field(default_factory=list)

    def add(self, name: str, light_map: Dict[str, np.ndarray]):
        # Defaults of the reference Material struct (src/model.h:32-40).
        self.names.append(name)
        self.kd.append(np.zeros(3))
        self.ks.append(np.zeros(3))
        self.ns.append(1.0)
        self.tr.append(np.zeros(3))
        self.ni.append(1.0)
        self.radiance.append(np.asarray(light_map.get(name, np.zeros(3)), np.float64))
        self.tex_path.append(None)


@dataclass
class HostScene:
    """Raw parsed scene, before flattening."""

    vertices: np.ndarray  # f64[Nv,3]
    normals: np.ndarray  # f64[Nn,3]
    uvs: np.ndarray  # f64[Nt,2]
    faces: np.ndarray  # i32[T,3,4] (v, vn, vt, mat)
    materials: MaterialTable = None
    camera: dict = None


def load_xml_camera(path: str):
    """Parse the `<camera>` and top-level `<light>` elements of the scene XML
    (a multi-root fragment, so it is wrapped in a synthetic root)."""
    import xml.etree.ElementTree as ET

    with open(path, "r") as f:
        content = f.read()
    content = re.sub(r"<\?xml[^?]*\?>", "", content)
    root = ET.fromstring("<__root__>" + content + "</__root__>")

    cam_node = root.find("camera")
    if cam_node is None:
        raise ValueError(f"No <camera> node in {path}")

    def vec3_of(tag):
        n = cam_node.find(tag)
        return np.array([float(n.attrib["x"]), float(n.attrib["y"]), float(n.attrib["z"])])

    camera = {
        "width": int(cam_node.attrib["width"]),
        "height": int(cam_node.attrib["height"]),
        "fovy": float(cam_node.attrib["fovy"]),
        "eye": vec3_of("eye"),
        "lookat": vec3_of("lookat"),
        "up": vec3_of("up"),
    }
    lights: Dict[str, np.ndarray] = {}
    for ln in root.findall("light"):
        lights[ln.attrib["mtlname"]] = np.array(
            [float(x) for x in ln.attrib["radiance"].split(",")])
    return camera, lights


def load_mtl(path: str, light_map: Dict[str, np.ndarray]) -> MaterialTable:
    """MTL parser with the reference's keys (src/model.cpp:158-209)."""
    table = MaterialTable()
    base = os.path.dirname(path)
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                table.add(parts[1], light_map)
            elif not table.names:
                continue
            elif key == "Kd":
                table.kd[-1] = np.array([float(x) for x in parts[1:4]])
            elif key == "Ks":
                table.ks[-1] = np.array([float(x) for x in parts[1:4]])
            elif key == "Tr":
                table.tr[-1] = np.array([float(x) for x in parts[1:4]])
            elif key == "Ns":
                table.ns[-1] = float(parts[1])
            elif key == "Ni":
                table.ni[-1] = float(parts[1])
            elif key == "map_Kd":
                table.tex_path[-1] = os.path.join(base, parts[1])
    return table


def _parse_obj_python(path: str, material_map: Dict[str, int]):
    """Pure-Python OBJ parse; polygons are fanned into triangles."""
    verts, norms, uvs, faces = [], [], [], []
    cur_mat = 0
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vn "):
                p = line.split()
                norms.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                uvs.append((float(p[1]), float(p[2])))
            elif line.startswith("usemtl"):
                cur_mat = material_map.get(line.split()[1], 0)
            elif line.startswith("f "):
                corners = []
                for tok in line.split()[1:]:
                    idx = tok.split("/")
                    v = int(idx[0]) - 1
                    vt = int(idx[1]) - 1 if len(idx) > 1 and idx[1] else 0
                    vn = int(idx[2]) - 1 if len(idx) > 2 and idx[2] else 0
                    corners.append((v, vn, vt, cur_mat))
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))
    return (
        np.asarray(verts, np.float64).reshape(-1, 3),
        np.asarray(norms, np.float64).reshape(-1, 3),
        np.asarray(uvs, np.float64).reshape(-1, 2),
        np.asarray(faces, np.int32).reshape(-1, 3, 4),
    )


def find_mtllib(path: str) -> Optional[str]:
    with open(path, "r") as f:
        for line in f:
            if line.startswith("mtllib"):
                return line.split()[1]
    return None


def load_obj(path: str) -> HostScene:
    """OBJ + sibling MTL + XML (the XML is named after the MTL, model.cpp:70)."""
    base = os.path.dirname(path)
    camera, light_map, table = None, {}, MaterialTable()
    mtlname = find_mtllib(path)
    if mtlname is not None:
        xml_path = os.path.join(base, mtlname[:-3] + "xml")
        if os.path.exists(xml_path):
            camera, light_map = load_xml_camera(xml_path)
        table = load_mtl(os.path.join(base, mtlname), light_map)

    material_map = {n: i for i, n in enumerate(table.names)}
    verts, norms, uvs, faces = _parse_obj_python(path, material_map)
    if camera is None:
        camera = {
            "width": 512, "height": 512, "fovy": 40.0,
            "eye": np.array([0.0, 0.0, 3.0]), "lookat": np.zeros(3),
            "up": np.array([0.0, 1.0, 0.0]),
        }
    return HostScene(vertices=verts, normals=norms, uvs=uvs, faces=faces,
                     materials=table, camera=camera)


def build_atlas(table: MaterialTable):
    """map_Kd images -> one padded [N,H,W,3] block (LDR images promoted with
    gamma 2.2, as stbi_loadf does). Returns ((data, size) or None, tex_id)."""
    paths = [p for p in table.tex_path if p is not None]
    tex_id = np.full(len(table.names), -1, np.int32)
    if not paths:
        return None, tex_id
    from PIL import Image

    unique = sorted(set(paths))
    slot = {p: i for i, p in enumerate(unique)}
    imgs = []
    for p in unique:
        if p.lower().endswith(".hdr"):
            raise NotImplementedError(
                f"{p}: .hdr textures are not ported yet (mcpt_tpu.io.image.load_hdr)")
        im = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        imgs.append(im ** 2.2)
    H = max(im.shape[0] for im in imgs)
    W = max(im.shape[1] for im in imgs)
    data = np.zeros((len(imgs), H, W, 3), np.float32)
    size = np.zeros((len(imgs), 2), np.int32)
    for i, im in enumerate(imgs):
        data[i, : im.shape[0], : im.shape[1]] = im
        size[i] = (im.shape[1], im.shape[0])
    for m, p in enumerate(table.tex_path):
        if p is not None:
            tex_id[m] = slot[p]
    return (data, size), tex_id


def load_scene(path: str, with_bvh: bool = True, device=None):
    """OBJ path -> `Scene` on `device` (CUDA unless the caller passes another).

    With `with_bvh` the triangles are put in BVH order, with the same ids as
    mcpt_tpu.io.obj.load_scene(path, with_bvh=True).
    """
    from mcpt_tpu_torch.scene import build_scene_host, finalize_scene, resolve_device, to_device

    device = resolve_device(device)
    host = load_obj(path)
    t = host.materials
    atlas, tex_id = build_atlas(t)
    mats = {
        "kd": np.asarray(t.kd).reshape(-1, 3),
        "ks": np.asarray(t.ks).reshape(-1, 3),
        "ns": np.asarray(t.ns).reshape(-1),
        "tr": np.asarray(t.tr).reshape(-1, 3),
        "ni": np.asarray(t.ni).reshape(-1),
        "radiance": np.asarray(t.radiance).reshape(-1, 3),
        "tex_id": tex_id,
    }
    if mats["kd"].shape[0] == 0:  # OBJ with no materials at all
        mats = {
            "kd": np.full((1, 3), 0.7), "ks": np.zeros((1, 3)), "ns": np.ones(1),
            "tr": np.zeros((1, 3)), "ni": np.ones(1), "radiance": np.zeros((1, 3)),
            "tex_id": np.full(1, -1, np.int32),
        }
    scene = build_scene_host(host.vertices, host.normals, host.uvs, host.faces,
                             mats, atlas, host.camera)
    if with_bvh:
        from mcpt_tpu_torch.ops.bvh import attach_bvh

        scene = attach_bvh(scene)
    return finalize_scene(to_device(scene, device))
