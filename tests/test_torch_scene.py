"""The port's scene loading, BVH and scene_from_arrays against mcpt_tpu's."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_scene_arrays, to_numpy

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.mark.parametrize("name", ["cornell-box", "veach-mis", "cornell-box-mirror"])
def test_load_scene_matches_jax(name):
    """OBJ/MTL/XML parse, SAH BVH and triangle permutation: every array
    equal to mcpt_tpu.io.obj.load_scene(path, with_bvh=True)."""
    from mcpt_tpu.io.obj import load_scene as jload
    from mcpt_tpu_torch.io.obj import load_scene as tload

    path = os.path.join(SCENES, name + ".obj")
    want = jax_scene_arrays(jload(path, with_bvh=True))
    ts = tload(path, with_bvh=True, device="cpu")
    got = {}
    for group in ("geom", "mats", "camera", "bvh"):
        obj = getattr(ts, group)
        for f in dataclasses.fields(obj):
            got[f"{group}.{f.name}"] = getattr(obj, f.name)
    got.update({"atlas.data": ts.atlas.data, "atlas.size": ts.atlas.size,
                "light_tris": ts.light_tris, "scale": ts.scale, "num_verts": ts.num_verts})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(to_numpy(got[k]) if isinstance(got[k], torch.Tensor) else got[k],
                                      v, err_msg=k)


@pytest.mark.parametrize("T, flat_axis", [(1, None), (16, None), (700, None), (400, 0), (400, 2),
                                          ("stress6k", None)],
                         ids=["1", "16", "700", "flat0", "flat2", "stress6k"])
def test_sah_bvh_matches_native_builder(rng, T, flat_axis):
    """The port's C++ copy of the binned-SAH builder equals mcpt_tpu's native
    one, also for triangles in one plane (a wall of quads), whose centroid
    box has no extent on `flat_axis`, and on bathroom-stress at 5,986
    triangles (chip_smoke.py's in-memory generator: walls, a height field
    and icospheres, geometry in f32 as attach_bvh passes it)."""
    from mcpt_tpu.native.bvh_native import build_bvh_native
    from mcpt_tpu.ops.bvh import validate_bvh
    from mcpt_tpu_torch.ops.bvh import _build_bvh_sah

    if T == "stress6k":
        import sys

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        try:
            import chip_smoke
        finally:
            sys.path.pop(0)
        from mcpt_tpu_torch.scene import build_scene_host

        g = build_scene_host(*chip_smoke.stress_scene_arrays(6000, 0)).geom
        v0, e1, e2 = (np.asarray(x, np.float64) for x in (g.v0, g.e1, g.e2))
    else:
        v = rng.uniform(-5, 5, (T, 3, 3))
        if T == 16:
            v[:] = v[0]  # coincident centroids: the median fallback
        if flat_axis is not None:
            v[:, :, flat_axis] = 1.5
        v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    (jn, jp), (tn, tp) = build_bvh_native(v0, e1, e2, 4), _build_bvh_sah(v0, e1, e2, 4)
    np.testing.assert_array_equal(tp, jp)
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    validate_bvh(tn, tp, np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2))



def test_scene_from_arrays_carries_jax_scene(veach_scene):
    """A JAX scene's arrays carried across equal the port's own load, and
    the Woop tables are attached for a mid-size scene."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.scene import scene_from_arrays

    a = scene_from_arrays(jax_scene_arrays(veach_scene), device="cpu")
    b = load_scene(os.path.join(SCENES, "veach-mis.obj"), device="cpu")
    assert a.num_tris == b.num_tris == 1332 and a.scale == b.scale
    for x, y in ((a.geom.v0, b.geom.v0), (a.geom.vn, b.geom.vn), (a.light_tris, b.light_tris),
                 (a.woop.tbl, b.woop.tbl), (a.woop.boxes, b.woop.boxes), (a.mats.kd, b.mats.kd)):
        assert torch.equal(x, y)
    assert (a.woop.chunk, a.woop.n_chunks) == (512, 3)


def test_entry_points_default_to_cuda(monkeypatch):
    """With no card, an entry point raises unless the caller asks for the CPU."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.scene import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(SCENES, "cornell-box.obj")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scene(path)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert load_scene(path, device="cpu").device.type == "cpu"
