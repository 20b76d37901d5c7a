"""The port's fixed-bounce loop and detached-sampling gradients against
mcpt_tpu's, on the CPU.

Both packages get the same scene arrays (tests/torch_parity.py) and the
same parameters (diff.grad.params_from_arrays). The JAX side runs its CPU
dispatch: the dense XLA wave on cornell and veach, the skip-link BVH walk
on the grid scene; the port runs the dense torch wave, the Woop pair's
plain version and the traversal pair's plain walk. Hit ids may differ
only on ties or grazing rays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy, torch_scene

FIELDS = ("kd", "ks", "radiance", "dverts")


def _small(scene, w, h):
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w, height=h))


def _port_params(jp):
    from mcpt_tpu_torch.diff.grad import params_from_arrays

    return params_from_arrays({k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k)) for k in FIELDS})


@pytest.fixture(scope="module")
def cornell24(cornell_scene):
    js = _small(cornell_scene, 24, 24)
    return js, _small(torch_scene(js), 24, 24)


def _grid_scene(tmp_path_factory):
    from mcpt_tpu.io.obj import load_scene
    from tests.test_grad import _write_grid_scene

    return load_scene(_write_grid_scene(str(tmp_path_factory.mktemp("grid"))), with_bvh=True)


# (scene, width, height, spp, bounces): the dense route, the Woop route
# (veach, 1,332 triangles) and the traversal route (the 4,610-triangle grid)
CASES = {"cornell": (24, 24, 2, 4), "veach": (16, 12, 2, 4), "grid": (12, 12, 1, 2)}


@pytest.fixture(scope="module")
def grad_case(request, cornell_scene, veach_scene, tmp_path_factory):
    """mse_loss against a black target, key 3: (name, (JAX loss, gradient,
    image), (port loss, gradient), JAX scene, port scene, the port's plain
    calls). One JAX compilation gives the loss, its gradient and the image."""
    from mcpt_tpu.diff.grad import extract_params, render_image
    from mcpt_tpu_torch.diff import grad as TG
    from mcpt_tpu_torch.ops import traverse, woop
    from mcpt_tpu_torch.utils.rng import prng_key

    name = request.param
    W, H, spp, bounces = CASES[name]
    base = {"cornell": cornell_scene, "veach": veach_scene}.get(name) or _grid_scene(tmp_path_factory)
    js = _small(base, W, H)
    ts = _small(torch_scene(js), W, H)
    jp = extract_params(js)

    def loss_and_image(p):  # mcpt_tpu.diff.grad.mse_loss, keeping the image
        img = render_image(p, js, jax.random.PRNGKey(3), spp, bounces)
        return jnp.mean(img ** 2), img

    # jitted: one XLA compilation instead of one per eager operation
    (jl, jimg), jg = jax.jit(jax.value_and_grad(loss_and_image, has_aux=True))(jp)
    calls = {m.__name__: dict(m.PLAIN_CALLS) for m in (woop, traverse)}
    tl, tg = TG.loss_and_grad(_port_params(jp), ts, torch.zeros(H, W, 3), prng_key(3), spp, bounces)
    plain = {m.__name__: {k: v - calls[m.__name__][k] for k, v in m.PLAIN_CALLS.items()}
             for m in (woop, traverse)}
    return name, (float(jl), jg, np.asarray(jimg)), (float(tl), tg), js, ts, plain


@pytest.mark.parametrize("grad_case", ["cornell"], indirect=True)
def test_trace_image_matches_jax(grad_case):
    """Cornell 24x24, 4 bounces: the mean of the port's trace_image over the
    2 sample keys fold_in(key, s) against mcpt_tpu's render_image (its
    trace_image, differentiable) of the gradient case: >= 99 % of
    components within rtol 1e-3 (atol 1e-3) and channel means within rtol
    2e-3 (tests/test_torch_integrator.py's contract); a chunking of 100
    rays gives the same radiance bit for bit."""
    from mcpt_tpu_torch.render import integrator as TI
    from mcpt_tpu_torch.utils.rng import fold_in, prng_key

    _, (_, _, a), _, _, ts, _ = grad_case
    W, H, spp, bounces = CASES["cornell"]
    pidx = torch.arange(W * H)
    keys = [fold_in(prng_key(3), s) for s in range(spp)]
    tables = TI.path_tables(ts)
    runs = [TI.trace_image(ts, ts.camera, k, pidx, bounces, tables) for k in keys]
    b = to_numpy(sum(runs) / spp).reshape(H, W, 3)
    assert np.isclose(b, a, rtol=1e-3, atol=1e-3).mean() >= 0.99
    np.testing.assert_allclose(b.mean(axis=(0, 1)), a.mean(axis=(0, 1)), rtol=2e-3)
    c = TI.trace_image(ts, ts.camera, keys[0], pidx, bounces, TI.path_tables(ts), chunk_rays=100)
    assert torch.equal(c, runs[0])


@pytest.mark.parametrize("grad_case", list(CASES), indirect=True)
def test_mse_loss_and_grads_match_jax(grad_case):
    """Loss within rtol 1e-3; every gradient field within rtol 1e-3 plus
    atol 2e-3 x the field's largest |JAX gradient|, on the entries where
    JAX's is finite; the port's finite everywhere, with signal on the
    first material's kd and on an emitter's radiance."""
    name, (jl, jg, _), (tl, tg), js, _, plain = grad_case
    from mcpt_tpu_torch.ops import traverse, woop

    route = {"veach": woop.__name__, "grid": traverse.__name__}.get(name)
    if route is not None:  # the kernel route ran, through its plain version
        assert min(plain[route].values()) > 0, plain
    assert tl == pytest.approx(jl, rel=1e-3)
    for k in FIELDS:
        a = np.asarray(getattr(jg, k))
        b = to_numpy(getattr(tg, k))
        assert np.isfinite(b).all(), k
        fin = np.isfinite(a)
        if not fin.all():
            # mcpt_tpu's kd gradient is NaN on materials with kd = ks = 0
            # (veach's emitters): its energy-conservation scale takes
            # 1/max(maxc, 1e-30) whose backward overflows where maxc = 0,
            # and jnp.maximum's backward lets the NaN through; torch's clamp
            # backward masks it, so the port's is finite
            m = js.mats
            zero = (np.asarray(m.kd).max(axis=1) == 0) & (np.asarray(m.ks).max(axis=1) == 0)
            assert k == "kd" and zero[np.nonzero(~fin)[0]].all(), (k, np.argwhere(~fin))
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-3, atol=2e-3 * np.abs(a[fin]).max(), err_msg=k)
    assert np.abs(b).max() > 0
    g_kd = to_numpy(tg.kd)
    emissive = np.linalg.norm(np.asarray(js.mats.radiance), axis=-1) > 0.01
    assert np.abs(g_kd[0]).max() > 0
    assert np.abs(to_numpy(tg.radiance)[emissive]).max() > 0


def test_grads_match_finite_differences(cornell24):
    """The port's own gradient against central differences of its loss:
    kd and radiance within 5 % (tests/test_grad.py:29-70's bound and
    steps), and d(loss)/d(light vertices) along a downward translation of
    the light within 15 % (tests/test_grad.py's vertex bound, step 0.02)."""
    from mcpt_tpu_torch.diff.grad import extract_params, loss_and_grad, mse_loss
    from mcpt_tpu_torch.utils.rng import prng_key

    _, ts = cornell24
    p0 = extract_params(ts)
    target = torch.zeros(24, 24, 3)
    key = prng_key(3)
    loss, g = loss_and_grad(p0, ts, target, key, 2, 4)
    m_l = int(np.nonzero(to_numpy(ts.mats.radiance).max(axis=1) > 0.01)[0][0])

    def fd(field, m, c, eps, k=key, bounces=4, direction=None):
        def at(delta):
            if direction is None:
                arr = getattr(p0, field).clone()
                arr[m, c] += delta
            else:
                arr = p0.dverts + delta * direction
            return float(mse_loss(dataclasses.replace(p0, **{field: arr}), ts, target, k, 2, bounces))

        return (at(eps) - at(-eps)) / (2 * eps)

    for field, m, c, eps in (("kd", 0, 1, 2e-3), ("radiance", m_l, 0, 0.05)):
        ad = float(getattr(g, field)[m, c])
        num = fd(field, m, c, eps)
        assert abs(ad - num) <= 0.05 * max(abs(ad), abs(num), 1e-9), (field, ad, num)

    lv = np.unique(to_numpy(ts.geom.vert_idx)[to_numpy(ts.light_tris)])
    direction = torch.zeros_like(p0.dverts)
    direction[lv, 1] = -1.0
    key9 = prng_key(9)
    _, gv = loss_and_grad(p0, ts, target, key9, 2, 3)
    assert torch.isfinite(gv.dverts).all() and gv.dverts[lv].abs().max() > 0
    ad = float(torch.sum(gv.dverts * direction))
    num = fd("dverts", None, None, 0.02, k=key9, bounces=3, direction=direction)
    assert abs(ad - num) <= 0.15 * max(abs(ad), abs(num), 1e-9), (ad, num)


def test_render_image_packs_tables_once(cornell24, monkeypatch):
    """render_image packs the triangle and light tables once for all its
    samples (2 here), not once a sample or chunk, and its image equals the
    mean of trace_image's, each with tables of its own and chunked by 100
    rays, bit for bit."""
    from mcpt_tpu_torch.diff.grad import extract_params, render_image
    from mcpt_tpu_torch.render import integrator as TI
    from mcpt_tpu_torch.utils.rng import fold_in, prng_key

    _, ts = cornell24
    p0 = extract_params(ts)
    key = prng_key(3)
    pidx = torch.arange(24 * 24)
    want = sum(TI.trace_image(ts, ts.camera, fold_in(key, s), pidx, 2, TI.path_tables(ts), chunk_rays=100)
               for s in range(2)) / 2
    packs = {"tri": 0, "light": 0}
    for name, tag in (("pack_tri_table", "tri"), ("pack_light_table", "light")):
        def counted(scene, _f=getattr(TI, name), _tag=tag):
            packs[_tag] += 1
            return _f(scene)
        monkeypatch.setattr(TI, name, counted)
    img = render_image(p0, ts, key, 2, 2)
    assert packs == {"tri": 1, "light": 1}
    assert torch.equal(img, want.reshape(24, 24, 3))


def test_chip_smoke_grid_scene_is_test_grad_scene(tmp_path):
    """chip_smoke.py's copy of the grid scene writer (chip_smoke.py imports
    no jax, and tests/test_grad.py does) writes the same files."""
    import os
    import sys

    from tests.test_grad import _write_grid_scene

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _write_grid_scene(str(tmp_path / "a"))
    chip_smoke.write_grid_scene(str(tmp_path / "b"))
    for name in ("grid.obj", "grid.mtl", "grid.xml"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes(), name
