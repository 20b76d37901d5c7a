"""The port's treelet layout (ops/treelets.py) against mcpt_tpu's
build_treelets on the CPU: the box tables bit for bit, and each row's
(row_first, row_count) range holding exactly the triangles of mcpt_tpu's
padded tri row. Random soups at tests/test_treelets.py's small c = 16,
s_b = 8 (a deep two-level layout), and the 5,986-triangle stress scene at
the default c = s_b = 128."""
import os
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy, treelet_soup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tri_rows(ts, v0, e1, e2):
    """mcpt_tpu's f32[G, 16, C] triangle block from the port's ranges."""
    from mcpt_tpu_torch.ops.treelets import PAD_TRI_ID

    first, count = to_numpy(ts.row_first), to_numpy(ts.row_count)
    tri = np.zeros((ts.g, 16, ts.c), np.float32)
    tri[:, 9, :] = np.int32(PAD_TRI_ID).view(np.float32)
    for g in np.nonzero(count)[0]:
        ids = np.arange(first[g], first[g] + count[g], dtype=np.int32)
        tri[g, 0:3, :count[g]] = v0[ids].T
        tri[g, 3:6, :count[g]] = e1[ids].T
        tri[g, 6:9, :count[g]] = e2[ids].T
        tri[g, 9, :count[g]] = ids.view(np.float32)
    return tri


def _bits(x):
    return np.ascontiguousarray(to_numpy(x)).view(np.int32)


@pytest.mark.parametrize("T,c,s_b,seed", [(700, 16, 8, 3), (3000, 16, 8, 4), (2500, 32, 16, 5),
                                           (5000, 128, 128, 6)])
def test_layout_matches_jax(T, c, s_b, seed):
    jax_scene, port, v0, e1, e2 = treelet_soup(np.random.default_rng(seed), T, c, s_b)
    jts, ts = jax_scene.treelets, port.treelets
    assert (ts.ns, ts.s_b, ts.c, ts.nsp) == (jts.ns, jts.s_b, jts.c, np.asarray(jts.sb_box).shape[1])
    np.testing.assert_array_equal(_bits(ts.sb_box), _bits(jts.sb_box))
    np.testing.assert_array_equal(_bits(ts.blk_box), _bits(jts.blk_box))
    np.testing.assert_array_equal(_bits(jax_tri_rows(ts, v0, e1, e2)), _bits(jts.tri))
    count = to_numpy(ts.row_count)
    assert count.sum() == T and count.max() <= c and (count > 0).sum() > ts.ns


_LAYOUT = ("sb_box", "blk_box", "row_first", "row_count", "row_pair_first", "row_pair_count", "row_root")


def _soup_bvh(port):
    """The soup's FlatBVH arrays, from its traversal tables' source."""
    from mcpt_tpu_torch.scene import FlatBVH

    n = port.trav.nodes
    word = n[:, 3].view(torch.int32)
    return FlatBVH(lo=n[:, 0:3].numpy(), hi=n[:, 4:7].numpy(), first=(word >> 3).numpy(),
                   count=(word & 7).numpy(), skip=n[:, 7].view(torch.int32).numpy())


def test_carry_across_round_trips():
    """treelets_from_jax turns mcpt_tpu's arrays into the port's layout,
    each treelet's sub-BVH arrays included, and the port's ranges give
    mcpt_tpu's tri block back; a row whose ids are not one contiguous run is
    refused."""
    from mcpt_tpu_torch.ops.treelets import treelets_from_jax

    jax_scene, port, v0, e1, e2 = treelet_soup(np.random.default_rng(7), 1500, 16, 8)
    jts = jax_scene.treelets
    bvh = _soup_bvh(port)
    got = treelets_from_jax(np.asarray(jts.sb_box), np.asarray(jts.blk_box), np.asarray(jts.tri), 1500, bvh)
    for name in _LAYOUT:
        np.testing.assert_array_equal(_bits(getattr(got, name)), _bits(getattr(port.treelets, name)), err_msg=name)
    assert got.tdepth == port.treelets.tdepth > 0
    np.testing.assert_array_equal(_bits(jax_tri_rows(got, v0, e1, e2)), _bits(jts.tri))
    bad = np.array(jts.tri)
    g = int(np.nonzero(to_numpy(got.row_count) >= 3)[0][0])
    ids = bad[g, 9, :3].view(np.int32).copy()
    bad[g, 9, :3] = ids[[1, 0, 2]].view(np.float32)
    with pytest.raises(ValueError, match="contiguous"):
        treelets_from_jax(np.asarray(jts.sb_box), np.asarray(jts.blk_box), bad, 1500, bvh)


def test_carry_across_refuses_a_row_without_a_subtree():
    """A row whose ids are one contiguous run, but not the triangles of one
    BVH subtree (here a treelet's first triangle dropped), has no root."""
    from mcpt_tpu_torch.ops.treelets import PAD_TRI_ID, treelets_from_jax

    jax_scene, port, *_ = treelet_soup(np.random.default_rng(8), 1500, 16, 8)
    jts = jax_scene.treelets
    bad = np.array(jts.tri)
    g = int(np.nonzero(to_numpy(port.treelets.row_count) >= 9)[0][0])
    bad[g, :, :-1] = bad[g, :, 1:]
    bad[g, 9, -1] = np.int32(PAD_TRI_ID).view(np.float32)
    with pytest.raises(ValueError, match="subtree"):
        treelets_from_jax(np.asarray(jts.sb_box), np.asarray(jts.blk_box), bad, 1500, _soup_bvh(port))


@pytest.fixture(scope="module")
def stress_pair(tmp_path_factory):
    """The 5,986-triangle stress scene: mcpt_tpu's load (BVH + treelets) and
    the port's in-memory generation with its own C++ BVH build."""
    sys.path.insert(0, os.path.join(ROOT, "scenes"))
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
        import generate
    finally:
        sys.path.pop(0)
        sys.path.pop(0)
    from mcpt_tpu.io.obj import load_scene

    out = tmp_path_factory.mktemp("stress_tl")
    assert generate.gen_stress(str(out), target_tris=6000) == 5986
    js = load_scene(os.path.join(str(out), "bathroom-stress.obj"), with_bvh=True)
    (ps,) = chip_smoke.stress_scene(6000, 0, ("cpu",))
    return js, ps


def test_stress_scene_layout_matches_jax(stress_pair):
    """attach_bvh builds the layout above 4,096 triangles, on the host, and
    it moves to the device with the scene: equal to mcpt_tpu's."""
    js, ps = stress_pair
    ts, jts = ps.treelets, js.treelets
    assert isinstance(ts.sb_box, torch.Tensor) and ts.row_first.dtype == torch.int32
    np.testing.assert_array_equal(_bits(ts.sb_box), _bits(jts.sb_box))
    np.testing.assert_array_equal(_bits(ts.blk_box), _bits(jts.blk_box))
    g = ps.geom
    np.testing.assert_array_equal(
        _bits(jax_tri_rows(ts, *(to_numpy(x) for x in (g.v0, g.e1, g.e2)))), _bits(jts.tri))


def test_stress_scene_sub_bvhs_equal_the_carried_ones(stress_pair):
    """The port's build and the JAX-carried path (treelets_from_jax over
    mcpt_tpu's arrays and its BVH) give the same sub-BVH arrays on the
    5,986-triangle stress scene."""
    from mcpt_tpu_torch.ops.treelets import treelets_from_jax

    js, ps = stress_pair
    jts = js.treelets
    bvh = {k: np.asarray(getattr(js.bvh, k)) for k in ("lo", "hi", "first", "count", "skip")}
    got = treelets_from_jax(np.asarray(jts.sb_box), np.asarray(jts.blk_box), np.asarray(jts.tri),
                            ps.num_tris, bvh)
    for name in _LAYOUT:
        np.testing.assert_array_equal(_bits(getattr(got, name)), _bits(getattr(ps.treelets, name)), err_msg=name)
    assert got.tdepth == ps.treelets.tdepth > 0


def test_small_scene_has_no_layout():
    from mcpt_tpu_torch.io.obj import load_scene

    scene = load_scene(os.path.join(ROOT, "scenes", "veach-mis.obj"), device="cpu")
    assert scene.num_tris <= 4096 and scene.treelets is None
