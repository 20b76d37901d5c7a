"""mcpt_tpu_torch's BSDF against mcpt_tpu's: the same lobes, directions and
uniforms (numpy, fixed seed) through both; fx, pdf and sample at rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy

RTOL, ATOL = 1e-5, 1e-6


def _lane_rtol(ns, ndim):
    """pow(h, ns) moves by ns ulps when h moves by one, so glossy lanes get
    rtol max(1e-5, ns * 2^-23); lanes with ns <= 83 stay at 1e-5."""
    r = np.maximum(RTOL, ns.astype(np.float64) * 2.0**-23)
    return r if ndim == 1 else r[:, None]


def _assert_close(got, want, ns, atol=ATOL, err_msg=""):
    got, want = to_numpy(got).astype(np.float64), np.asarray(want).astype(np.float64)
    tol = atol + _lane_rtol(ns, want.ndim) * np.abs(want)
    bad = ~(np.abs(got - want) <= tol) & ~(np.isnan(got) & np.isnan(want))
    assert not bad.any(), f"{err_msg}: {bad.sum()} of {bad.size} out of tolerance, e.g. {got[bad][:4]} vs {want[bad][:4]}"


def _inputs(rng, R=2048):
    kd = rng.random((R, 3)).astype(np.float32) * 0.9
    ks = rng.random((R, 3)).astype(np.float32) * 0.6
    ks[: R // 4] = 0.0  # diffuse only
    ns = (10.0 ** rng.uniform(0, 4.5, R)).astype(np.float32)  # some >= 1e4: mirrors
    kd[R // 2: R // 2 + 64] = 0.0  # zero albedo lanes
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo[: R // 8, 2] = -np.abs(wo[: R // 8, 2])  # below the surface
    wi = rng.normal(size=(R, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    u = rng.random((3, R)).astype(np.float32)
    return kd, ks, ns, wo, wi, u


def _lobes(kd, ks, ns):
    from mcpt_tpu.render.bsdf import build_lobes as jb
    from mcpt_tpu_torch.render.bsdf import build_lobes as tb

    return (jb(jnp.asarray(kd), jnp.asarray(ks), jnp.asarray(ns)),
            tb(torch.from_numpy(kd), torch.from_numpy(ks), torch.from_numpy(ns)))


def test_build_lobes_matches_jax(rng):
    kd, ks, ns, *_ = _inputs(rng)
    jl, tl = _lobes(kd, ks, ns)
    for name in ("kd", "ks", "ns", "has_spec", "is_mirror", "w_d", "w_s"):
        np.testing.assert_allclose(to_numpy(getattr(tl, name)), np.asarray(getattr(jl, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("fn", ["bsdf_fx", "bsdf_pdf", "glossy_fx", "glossy_pdf", "diffuse_pdf"])
def test_eval_matches_jax(rng, fn):
    from mcpt_tpu.render import bsdf as JB
    from mcpt_tpu_torch.render import bsdf as TB

    kd, ks, ns, wo, wi, _ = _inputs(rng)
    jl, tl = _lobes(kd, ks, ns)
    if fn == "diffuse_pdf":
        want = JB.diffuse_pdf(jnp.asarray(wo), jnp.asarray(wi))
        got = TB.diffuse_pdf(torch.from_numpy(wo), torch.from_numpy(wi))
    else:
        want = getattr(JB, fn)(jl, jnp.asarray(wo), jnp.asarray(wi))
        got = getattr(TB, fn)(tl, torch.from_numpy(wo), torch.from_numpy(wi))
    _assert_close(got, want, ns, err_msg=fn)


def test_sample_matches_jax(rng):
    from mcpt_tpu.render.bsdf import bsdf_sample as js
    from mcpt_tpu_torch.render.bsdf import bsdf_sample as ts

    kd, ks, ns, wo, _, u = _inputs(rng)
    jl, tl = _lobes(kd, ks, ns)
    want = js(jl, jnp.asarray(wo), *map(jnp.asarray, u))
    got = ts(tl, torch.from_numpy(wo), *map(torch.from_numpy, u))
    # wi is a unit vector whose glossy sample takes sin = sqrt(1 - cos^2):
    # a one-ulp difference in pow's cos moves a small sin by ulp/sin, so its
    # components are held at 2e-5 absolute
    for name, w, g in zip(("wi", "f", "pdf", "mirror"), want, got):
        atol = 2e-5 if name == "wi" else ATOL
        _assert_close(g, w, ns, atol=atol, err_msg=name)
