"""MCPT_F64_GEOM=1, the dense route in double (the reference traces geometry
in double, src/utils.h:5-18), against a numpy f64 oracle and against
mcpt_tpu's f64 closest_hit_bruteforce (tests/test_intersect.py:187's
grazing rays), and its place in the dispatch: after the kernel routes,
which stay f32.

mcpt_tpu's f64 path needs jax_enable_x64, which is process-global: the
test turns it on and restores it in `finally`, since other files run in
the same worker after this one."""
import os
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 1.0e4  # f32's spacing there is ~1e-3: the offsets below vanish in f32
OFFSETS = (1e-5, 3e-6, -3e-6, -1e-5)


def _grazing():
    """One triangle at (BASE, BASE, 0) with legs along x and y, and rays
    straight down onto points just inside and just outside each of its
    three edges (u = 0, v = 0, u + v = 1), in double."""
    v0 = np.array([[BASE, BASE, 0.0]])
    e1 = np.array([[1.0, 0.0, 0.0]])
    e2 = np.array([[0.0, 1.0, 0.0]])
    pts = []
    for off in OFFSETS:
        pts += [(BASE + off, BASE + 0.5), (BASE + 0.5, BASE + off), (BASE + 0.5 - off, BASE + 0.5 - off)]
    xy = np.array(pts)
    org = np.concatenate([xy, np.ones((len(pts), 1))], axis=1)
    d = np.tile([0.0, 0.0, -1.0], (len(pts), 1))
    return v0, e1, e2, org, d


def _oracle(v0, e1, e2, org, d, det_eps, closest):
    """Moller-Trumbore in numpy float64 with the reference's predicates:
    (t, tri) of the nearest accepted triangle, or the any-hit flags."""
    h = np.cross(d[:, None], e2[None])
    det = np.sum(e1[None] * h, -1)
    s = org[:, None] - v0[None]
    q = np.cross(s, e1[None])
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(det) >= det_eps, 1.0 / det, 0.0)
    u, v, t = np.sum(s * h, -1) * inv, np.sum(d[:, None] * q, -1) * inv, np.sum(e2[None] * q, -1) * inv
    ok = np.abs(det) >= det_eps
    if closest:
        acc = ok & (t >= 1e-4) & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0)
        tc = np.where(acc, t, np.inf)
        return tc.min(1), np.where(acc.any(1), tc.argmin(1), -1)
    return (ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 1e-4)).any(1)


def test_grazing_rays_match_f64_oracle_and_jax():
    import jax

    from mcpt_tpu_torch.ops.intersect import any_hit_bruteforce, closest_hit_bruteforce

    v0, e1, e2, org, d = _grazing()
    want_t, want_tri = _oracle(v0, e1, e2, org, d, 1e-5, True)
    want_any = _oracle(v0, e1, e2, org, d, 1e-6, False)
    inside = np.array([off > 0 for off in OFFSETS for _ in range(3)])
    np.testing.assert_array_equal(want_tri >= 0, inside)  # the oracle tells the sides apart
    # f32 storage, as both packages keep the scene (these coordinates are exact in f32)
    geom = types.SimpleNamespace(v0=torch.tensor(v0, dtype=torch.float32), e1=torch.tensor(e1, dtype=torch.float32),
                                 e2=torch.tensor(e2, dtype=torch.float32))
    scene = types.SimpleNamespace(geom=geom)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    hit = closest_hit_bruteforce(scene, o, dd, f64=True)
    assert hit.t.dtype == torch.float32 and hit.tri.dtype == torch.int32
    np.testing.assert_array_equal(hit.tri.numpy(), want_tri)
    np.testing.assert_array_equal(hit.t.numpy()[inside], want_t[inside].astype(np.float32))
    occ = any_hit_bruteforce(scene, o, dd, f64=True)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), want_any)
    # f32 cannot tell the two sides of an edge apart at all
    o32 = org.astype(np.float32)
    assert (o32[:6] == o32[6:]).all()
    f32 = closest_hit_bruteforce(scene, o.float(), dd.float())
    assert (f32.tri.numpy()[:6] == f32.tri.numpy()[6:]).all()

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        import jax.numpy as jnp

        from mcpt_tpu.ops.intersect import closest_hit_bruteforce as jax_closest

        jgeom = types.SimpleNamespace(v0=jnp.asarray(v0, jnp.float32), e1=jnp.asarray(e1, jnp.float32),
                                      e2=jnp.asarray(e2, jnp.float32))
        jhit = jax_closest(types.SimpleNamespace(geom=jgeom), jnp.asarray(org), jnp.asarray(d), f64=True)
        np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(jhit.tri))
        np.testing.assert_array_equal(hit.t.numpy(), np.asarray(jhit.t))
    finally:
        jax.config.update("jax_enable_x64", x64)


def test_env_switches_only_the_dense_route(monkeypatch):
    """MCPT_F64_GEOM=1 is read at each call: the dense dispatch of a small
    scene tells the grazing rays apart; a Woop-route scene (veach, 1,332
    triangles) still runs the Woop pair (its plain versions here) with the
    same answers as without the variable."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.ops import intersect, woop

    v0, e1, e2, org, d = _grazing()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    geom = types.SimpleNamespace(v0=f32(v0), e1=f32(e1), e2=f32(e2))
    dense = types.SimpleNamespace(geom=geom, num_tris=1, woop=None)
    inside = np.array([off > 0 for off in OFFSETS for _ in range(3)])
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    monkeypatch.delenv("MCPT_F64_GEOM", raising=False)
    assert not intersect.f64_geom()
    same = intersect.closest_hit(dense, o.float(), dd.float()).tri.numpy()
    assert (same[:6] == same[6:]).all()
    monkeypatch.setenv("MCPT_F64_GEOM", "1")
    np.testing.assert_array_equal(intersect.closest_hit(dense, o, dd).tri.numpy() >= 0, inside)
    np.testing.assert_array_equal(intersect.any_hit(dense, o, dd).numpy(), inside)

    veach = load_scene(os.path.join(ROOT, "scenes", "veach-mis.obj"), device="cpu")
    rng = np.random.default_rng(7)
    ro = torch.from_numpy(rng.uniform(-5, 5, (300, 3)).astype(np.float32))
    rd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32)), dim=1)
    calls = dict(woop.PLAIN_CALLS)
    with_env = intersect.closest_hit(veach, ro, rd)
    assert woop.PLAIN_CALLS["closest"] == calls["closest"] + 1 and with_env.u is not None
    monkeypatch.delenv("MCPT_F64_GEOM")
    without = intersect.closest_hit(veach, ro, rd)
    for a, b in zip((with_env.t, with_env.tri, with_env.u, with_env.v), (without.t, without.tri, without.u,
                                                                         without.v)):
        assert torch.equal(a, b)


def test_f64_render_agrees_with_f32(monkeypatch):
    """cornell at 24x24, 1 spp, 2 bounces: the f64 dense route renders (no NaN) and
    agrees with the f32 render under tests/test_torch_integrator.py's
    contract (cornell has no grazing geometry for double to fix)."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    s = load_scene(os.path.join(ROOT, "scenes", "cornell-box.obj"), device="cpu")
    films = []
    for env in ("0", "1"):
        monkeypatch.setenv("MCPT_F64_GEOM", env)
        r = Renderer(s, RenderConfig(max_bounces=2, width=24, height=24))
        r.step()
        assert r.stats["nan_scrubbed"] == 0
        films.append(r.film.accum.numpy())
    a, b = films
    assert np.isclose(a, b, rtol=1e-3, atol=1e-3).mean() >= 0.99
    np.testing.assert_allclose(a.mean(axis=(0, 1)), b.mean(axis=(0, 1)), rtol=2e-3)
