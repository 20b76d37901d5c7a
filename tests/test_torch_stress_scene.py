"""bathroom-stress on the port's host side: chip_smoke.py's in-memory
generator against scenes/generate.py's files, the port's loader against
mcpt_tpu's on the textured stress scene, and its dispatch. At
target_tris=6000 (5,986 triangles)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_scene_arrays, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stress_obj(tmp_path_factory):
    sys.path.insert(0, os.path.join(ROOT, "scenes"))
    try:
        import generate
    finally:
        sys.path.pop(0)
    out = tmp_path_factory.mktemp("stress")
    assert generate.gen_stress(str(out), target_tris=6000) == 5986
    return os.path.join(str(out), "bathroom-stress.obj")


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def _scene_fields(s) -> dict:
    out = {}
    for group in ("geom", "mats", "camera", "bvh", "atlas"):
        obj = getattr(s, group)
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            out[f"{group}.{f.name}"] = to_numpy(val) if isinstance(val, torch.Tensor) else val
    out.update(light_tris=to_numpy(s.light_tris), scale=s.scale, num_verts=s.num_verts)
    return out


def test_in_memory_generator_matches_files(stress_obj):
    """The same triangles in the same order with the same materials, camera
    and light; the texture bitwise; vertices, normals and uvs within 5e-7 of
    the parsed %.6f text (equal, in fact: both round to the same double).
    The finished scenes, BVH included, agree array for array."""
    from mcpt_tpu_torch.io.obj import build_atlas, load_obj, load_scene

    cs = _chip_smoke()
    v, n, uv, faces, mats, (tex, tex_size), cam = cs.stress_scene_arrays(6000, 0)
    host = load_obj(stress_obj)
    np.testing.assert_array_equal(faces, host.faces)
    for got, want in ((v, host.vertices), (n, host.normals), (uv, host.uvs)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    (want_tex, want_size), tex_id = build_atlas(host.materials)
    np.testing.assert_array_equal(tex, want_tex)
    np.testing.assert_array_equal(tex_size, want_size)
    t = host.materials
    np.testing.assert_array_equal(mats["tex_id"], tex_id)
    for k in ("kd", "ks", "ns", "tr", "ni", "radiance"):
        np.testing.assert_array_equal(mats[k], np.asarray(getattr(t, k)).reshape(mats[k].shape), err_msg=k)
    assert set(cam) == set(host.camera)
    for k in cam:
        np.testing.assert_array_equal(cam[k], host.camera[k], err_msg=k)

    (mem,) = cs.stress_scene(6000, 0, ("cpu",))
    disk = load_scene(stress_obj, device="cpu")
    a, b = _scene_fields(mem), _scene_fields(disk)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert mem.num_tris == 5986 and mem.num_lights == 2 and mem.trav is not None


def test_load_stress_scene_matches_jax(stress_obj):
    """OBJ/MTL/XML with a texture, the C++ SAH BVH and the triangle
    permutation: every array equal to mcpt_tpu.io.obj.load_scene's."""
    from mcpt_tpu.io.obj import load_scene as jload
    from mcpt_tpu_torch.io.obj import load_scene as tload

    want = jax_scene_arrays(jload(stress_obj, with_bvh=True))
    got = _scene_fields(tload(stress_obj, device="cpu"))
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (want["mats.tex_id"] >= 0).sum() == 1


def test_large_scene_dispatch(stress_obj):
    """Above 4,096 triangles dispatch takes the traversal pair (with kernel
    u/v, so the integrator takes the slim expander) and packs its tables,
    not the Woop table; without a BVH the traversal cannot run and says so."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.ops import intersect
    from mcpt_tpu_torch.ops.traverse import DEFAULT_LEAF_SIZE

    s = load_scene(stress_obj, device="cpu")
    assert intersect.uses_traversal_kernel(s) and not intersect.uses_woop_kernel(s)
    assert intersect.dispatch_returns_uv(s) and s.woop is None
    ts = s.trav
    assert ts.nodes.shape == (s.bvh.lo.shape[0], 8) and ts.tris.shape == (5986, 12)
    word = ts.nodes[:, 3].view(torch.int32)
    assert torch.equal(word & 7, s.bvh.count) and int((word & 7).max()) <= DEFAULT_LEAF_SIZE
    leaf = s.bvh.count > 0
    assert torch.equal((word >> 3)[leaf], s.bvh.first[leaf])
    assert torch.equal(ts.nodes[:, 7].view(torch.int32), s.bvh.skip)
    bare = load_scene(stress_obj, with_bvh=False, device="cpu")
    assert bare.trav is None
    with pytest.raises(ValueError, match="with_bvh=True"):
        intersect.closest_hit(bare, torch.zeros((1, 3)), torch.ones((1, 3)))
