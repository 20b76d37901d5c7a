"""The port's edge (NEE visibility) term against mcpt_tpu's, on the CPU, on
tests/test_edge.py's occluder and two-occluder scenes and on the occluder
scene with its floor split past 256 triangles (chip_smoke.py's
write_occluder_scene), where the mutual-occlusion tests run the Woop
any-hit route (its plain version here)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy, torch_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT = dict(light_q0=(0.9, 1.5, 0.9), light_eu=(0.2, 0.0, 0.0), light_ev=(0.0, 0.0, 0.2),
             light_le=(30.0, 30.0, 30.0))


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.fixture(scope="module")
def occ_scenes(tmp_path_factory):
    """name -> (JAX scene, the port's scene from the same arrays)."""
    from mcpt_tpu.io.obj import load_scene
    from tests.test_edge import _write_occluder_scene, _write_two_occluder_scene

    out = {}
    for name, write in (("occ", _write_occluder_scene), ("occ2", _write_two_occluder_scene),
                        ("grid", lambda d: _chip_smoke().write_occluder_scene(d, 12))):
        js = load_scene(write(str(tmp_path_factory.mktemp(name))), with_bvh=True)
        out[name] = (js, torch_scene(js))
    assert out["grid"][1].num_tris > 256 and out["grid"][1].woop is not None
    return out


def test_chip_smoke_scene_is_test_edge_scene_at_one_cell(tmp_path):
    """write_occluder_scene(floor_n=1) builds test_edge.py's scene: the same
    triangles, materials, light and camera."""
    from mcpt_tpu_torch.io.obj import load_scene
    from tests.test_edge import _write_occluder_scene

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = load_scene(_write_occluder_scene(str(tmp_path / "a")), device="cpu", with_bvh=False)
    b = load_scene(_chip_smoke().write_occluder_scene(str(tmp_path / "b"), 1), device="cpu", with_bvh=False)
    for k in ("v0", "e1", "e2", "mat_id"):
        torch.testing.assert_close(getattr(b.geom, k), getattr(a.geom, k), rtol=0, atol=0)
    torch.testing.assert_close(b.mats.radiance, a.mats.radiance, rtol=0, atol=0)
    assert (b.camera.width, b.camera.height) == (a.camera.width, a.camera.height)


@pytest.mark.parametrize("name", ["occ", "occ2", "grid"])
def test_silhouette_tables_match_jax(occ_scenes, name):
    """Vertices and face normals within 1e-6, edges and opposite vertices equal."""
    from mcpt_tpu.diff.edge import build_silhouette_tables as jb
    from mcpt_tpu_torch.diff.edge import build_silhouette_tables as tb

    js, ts = occ_scenes[name]
    for a, b in zip(jb(js), tb(ts)):
        a, b = np.asarray(a), to_numpy(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a)


def _shading_inputs(js):
    """test_edge.py's inputs: pixel-centre primary hits on the floor, the
    floor's normal and albedo, and the adjoint of a left-half mean, on the
    pixels where that adjoint is not zero."""
    from mcpt_tpu.ops.intersect import closest_hit
    from mcpt_tpu.render.camera import generate_rays

    H = W = 16
    pidx = jnp.arange(H * W, dtype=jnp.int32)
    org, dirn = generate_rays(js.camera, jnp.full((H * W, 2), 0.5), pidx)
    hit = closest_hit(js, org, dirn)
    x = org + jnp.where(hit.valid, hit.t, 0.0)[:, None] * dirn
    on_floor = hit.valid & (js.geom.mat_id[jnp.maximum(hit.tri, 0)] == 0)
    pix_mask = (pidx % W < W // 2)
    n_w = float(pix_mask.sum()) * 3.0
    n_x = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), x.shape)
    kd = jnp.broadcast_to(jnp.array([0.75, 0.75, 0.75]), x.shape)
    weight = jnp.where((on_floor & pix_mask)[:, None], 1.0 / n_w, 0.0) * jnp.ones((1, 3))
    keep = np.asarray(on_floor & pix_mask)  # the other pixels add exactly zero
    return [np.asarray(v)[keep] for v in (x, n_x, kd, weight)]


@pytest.mark.parametrize("name,general", [("occ", False), ("occ2", False), ("occ2", True), ("grid", True)])
def test_edge_grad_matches_jax(occ_scenes, name, general):
    """nee_visibility_edge_grad with the scene's silhouette tables, the
    prototype path (the boundary edges, centroid orientation, no occlusion
    tests) or the general one (silhouette test, face orientation, mutual occlusion
    through any_hit): within rtol 1e-3 plus atol 1e-3 x the largest |JAX
    value|, with signal on the occluder's vertices. On the grid scene the
    port's occlusion tests run the Woop any-hit route."""
    from mcpt_tpu.diff import edge as JE
    from mcpt_tpu_torch.diff import edge as TE
    from mcpt_tpu_torch.ops import woop

    js, ts = occ_scenes[name]
    x, n_x, kd, weight = _shading_inputs(js)
    jv, je, jnf, jopp = JE.build_silhouette_tables(js)
    tv, te, tnf, topp = TE.build_silhouette_tables(ts)
    S = 4 if name == "grid" else 32  # the grid has ~460 edges
    jkw = dict(light_q0=jnp.array(LIGHT["light_q0"]), light_eu=jnp.array(LIGHT["light_eu"]),
               light_ev=jnp.array(LIGHT["light_ev"]), light_le=jnp.array(LIGHT["light_le"]), n_samples=S)
    tkw = dict(LIGHT, n_samples=S)
    if general:
        jkw.update(edge_nf=jnf, edge_opp=jv[jnp.maximum(jopp, 0)], scene=js)
        tkw.update(edge_nf=tnf, edge_opp=tv[torch.clamp(topp, min=0).long()], scene=ts)
    else:
        # the prototype's scope: boundary edges (one face); on an interior
        # edge its centroid orientation is a sign of ~0, which rounding flips
        bnd = np.asarray(jnf[:, 1]).any(axis=1) == 0
        je, te = je[bnd], te[torch.from_numpy(bnd)]
    # jitted: one XLA compilation instead of one per eager operation
    jfn = jax.jit(lambda *a: JE.nee_visibility_edge_grad(*a, jv, je, **jkw))
    want = np.asarray(jfn(*(jnp.asarray(v) for v in (x, n_x, kd, weight))))
    calls = woop.PLAIN_CALLS["any"]
    got = to_numpy(TE.nee_visibility_edge_grad(*(torch.from_numpy(v.copy()) for v in (x, n_x, kd, weight)),
                                               tv, te, **tkw))
    if name == "grid":
        assert woop.PLAIN_CALLS["any"] > calls
    occ = np.unique(np.asarray(js.geom.vert_idx)[np.asarray(js.geom.mat_id) == 1])
    assert np.abs(want[occ]).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_edge_term_matches_jax_and_drives_run_inverse(occ_scenes):
    """make_nee_edge_term's gradient against mcpt_tpu's on the occluder
    scene (16 samples an edge, a 1-spp estimate of the image, key 0, one
    target for both, rendered by the port; tolerance as above), then two
    run_inverse steps with it as
    extra_grad_fn: finite losses, and the vertex field moved."""
    from mcpt_tpu.diff.edge import make_nee_edge_term as jm
    from mcpt_tpu.diff.grad import extract_params
    from mcpt_tpu_torch.diff.edge import make_nee_edge_term as tm
    from mcpt_tpu_torch.diff.grad import params_from_arrays, render_image
    from mcpt_tpu_torch.diff.inverse import run_inverse
    from mcpt_tpu_torch.utils.rng import prng_key

    js, ts = occ_scenes["occ"]
    jp = extract_params(js)
    tp = params_from_arrays({k: np.asarray(getattr(jp, k)) for k in ("kd", "ks", "radiance", "dverts")})
    with torch.no_grad():
        ttarget = render_image(tp, ts, prng_key(0), 2, 2)
    jterm = jm(js, jnp.asarray(ttarget.numpy()), **{k: jnp.array(v) for k, v in LIGHT.items()}, n_samples=16,
               est_spp=1)
    want = np.asarray(jax.jit(lambda p, k: jterm(p, k).dverts)(jp, jax.random.PRNGKey(0)))
    tterm = tm(ts, ttarget, **LIGHT, n_samples=16, est_spp=1)
    got = tterm(tp, prng_key(0))
    assert not got.kd.any() and not got.ks.any() and not got.radiance.any()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(to_numpy(got.dverts), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())

    params, losses = run_inverse(ts, ttarget, tp, steps=2, spp=1, max_bounces=2, extra_grad_fn=tterm)
    assert np.isfinite(losses).all() and torch.isfinite(params.dverts).all()
    assert params.dverts.abs().max() > 0
