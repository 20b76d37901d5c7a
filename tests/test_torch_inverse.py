"""The port's Adam inverse-rendering step and loop against mcpt_tpu's, on
the CPU (cornell: the dense route)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_numpy, torch_scene

FIELDS = ("kd", "ks", "radiance", "dverts")
LR, RADIANCE_LR = 2e-2, 0.2


def _small(scene, w, h):
    return dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w, height=h))


def _start(kd, radiance, m_l):
    """Start values that put every clamp to work: the white material's kd
    at 0.999 / 0.0005 and the emitter's red radiance at 0.1, each pushed
    out of range by the extra gradient term below."""
    kd = np.array(kd)
    kd[0, 0], kd[0, 1] = 0.999, 0.0005
    rad = np.array(radiance)
    rad[m_l, 0] = 0.1
    return kd, rad


def _extra(m_l, n_mats, xp):
    """extra_grad_fn's fixed term: a push of -1e3 / +1e3 on kd[0, :2] and
    +1e3 on the emitter's red radiance, and NaN on ks[0, 0] and kd[1, 2]
    (scrubbed before it reaches Adam)."""
    kd = np.zeros((n_mats, 3), np.float32)
    kd[0, 0], kd[0, 1], kd[1, 2] = -1e3, 1e3, np.nan
    ks = np.zeros((n_mats, 3), np.float32)
    ks[0, 0] = np.nan
    rad = np.zeros((n_mats, 3), np.float32)
    rad[m_l, 0] = 1e3
    return xp(kd), xp(ks), xp(rad)


@pytest.fixture(scope="module")
def one_step(cornell_scene):
    """One make_inverse_step step of each package from the same parameters
    and key: cornell 16x16, 1 spp, 3 bounces, target rendered at the true
    parameters; mask on kd of materials 0-2 and the emitter's radiance
    (dverts frozen by its absent mask), radiance_lr, the extra term."""
    from mcpt_tpu.diff import grad as JG
    from mcpt_tpu.diff import inverse as JV
    from mcpt_tpu_torch.diff import grad as TG
    from mcpt_tpu_torch.diff import inverse as TV
    from mcpt_tpu_torch.utils.rng import prng_key

    js = _small(cornell_scene, 16, 16)
    ts = _small(torch_scene(js), 16, 16)
    jp = JG.extract_params(js)
    M = jp.kd.shape[0]
    m_l = int(np.nonzero(np.asarray(jp.radiance).max(axis=1) > 0.01)[0][0])
    target = JG.render_image(jp, js, jax.random.PRNGKey(7), 2, 3)
    kd, rad = _start(jp.kd, jp.radiance, m_l)
    jp = dataclasses.replace(jp, kd=jnp.asarray(kd), radiance=jnp.asarray(rad))
    mkd = np.zeros((M, 3), np.float32)
    mkd[:3] = 1.0
    mrad = np.zeros((M, 3), np.float32)
    mrad[m_l] = 1.0
    mks = np.ones((M, 3), np.float32)

    ekd, eks, erad = _extra(m_l, M, jnp.asarray)
    jmask = JG.SceneParams(kd=jnp.asarray(mkd), ks=jnp.asarray(mks), radiance=jnp.asarray(mrad))

    def jextra(params, key):
        return JG.SceneParams(kd=ekd, ks=eks, radiance=erad, dverts=jnp.zeros_like(params.dverts))

    init, step = JV.make_inverse_step(js, target, spp=1, max_bounces=3, learning_rate=LR, param_mask=jmask,
                                      radiance_lr=RADIANCE_LR, extra_grad_fn=jextra)
    jstate, jloss = step(init(jp), jax.random.PRNGKey(5))

    tkd, tks, trad = _extra(m_l, M, torch.from_numpy)
    tmask = TG.SceneParams(kd=torch.from_numpy(mkd), ks=torch.from_numpy(mks), radiance=torch.from_numpy(mrad))

    def textra(params, key):
        return TG.SceneParams(kd=tkd, ks=tks, radiance=trad, dverts=torch.zeros_like(params.dverts))

    tp = TG.params_from_arrays({k: np.asarray(getattr(jp, k)) for k in FIELDS})
    init, step = TV.make_inverse_step(ts, torch.tensor(np.asarray(target)), spp=1, max_bounces=3,
                                      learning_rate=LR, param_mask=tmask, radiance_lr=RADIANCE_LR,
                                      extra_grad_fn=textra)
    tstate, tloss = step(init(tp), prng_key(5))
    return jp, (jstate, float(jloss)), (tstate, float(tloss)), m_l


def test_inverse_step_matches_jax(one_step):
    """Loss within rtol 1e-3; every parameter after the step within
    atol 1e-3 x its learning rate of JAX's (Adam's first step moves each
    entry by about lr x the sign of its gradient)."""
    jp, (jstate, jloss), (tstate, tloss), m_l = one_step
    assert tloss == pytest.approx(jloss, rel=1e-3)
    assert tstate.step == int(jstate.step) == 1
    for k in FIELDS:
        a, b = np.asarray(getattr(jstate.params, k)), to_numpy(getattr(tstate.params, k))
        lr = RADIANCE_LR if k == "radiance" else LR
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3 * lr, err_msg=k)


def test_inverse_step_masks_scrubs_and_clamps(one_step):
    """What the step did, on the port's side: frozen entries unchanged,
    the NaN terms scrubbed (ks[0, 0] unmoved, everything finite), the
    clamps at kd 1 and 0 and radiance 0, and the emitter's radiance moved
    by its own rate."""
    jp, _, (tstate, _), m_l = one_step
    p = {k: to_numpy(getattr(tstate.params, k)) for k in FIELDS}
    p0 = {k: np.asarray(getattr(jp, k)) for k in FIELDS}
    assert all(np.isfinite(v).all() for v in p.values())
    assert int(tstate.scrubbed) == 2  # the extra term's two NaN entries
    np.testing.assert_array_equal(p["kd"][3:], p0["kd"][3:])
    np.testing.assert_array_equal(p["dverts"], p0["dverts"])
    assert p["kd"][0, 0] == 1.0 and p["kd"][0, 1] == 0.0 and p["radiance"][m_l, 0] == 0.0
    assert p["ks"][0, 0] == p0["ks"][0, 0]
    moved = np.abs(p["radiance"][m_l, 1:] - p0["radiance"][m_l, 1:])
    np.testing.assert_allclose(moved, RADIANCE_LR, rtol=1e-3)
    rad = p0["radiance"].copy()
    rad[m_l] = p["radiance"][m_l]
    np.testing.assert_array_equal(p["radiance"], rad)


def test_resume_equals_uninterrupted_run(cornell_scene, tmp_path):
    """run_inverse for 4 steps against 2 steps, a checkpoint, and a resumed
    run to 4: parameters and the last two losses bit for bit (two Adam
    groups, the vertex field free)."""
    from mcpt_tpu_torch.diff.grad import extract_params, render_image
    from mcpt_tpu_torch.diff.inverse import run_inverse
    from mcpt_tpu_torch.utils.rng import prng_key

    ts = _small(torch_scene(cornell_scene), 8, 8)
    p0 = extract_params(ts)
    target = render_image(p0, ts, prng_key(1), 1, 2).detach()
    start = dataclasses.replace(p0, kd=p0.kd * 0.5)
    kw = dict(spp=1, max_bounces=2, learning_rate=LR, radiance_lr=RADIANCE_LR, seed=3)
    full, losses = run_inverse(ts, target, start, steps=4, **kw)
    ck = str(tmp_path / "inv.npz")
    run_inverse(ts, target, start, steps=2, checkpoint_path=ck, checkpoint_every=2, **kw)
    resumed, losses2 = run_inverse(ts, target, start, steps=4, resume=ck, **kw)
    assert losses2 == losses[2:]
    for k in FIELDS:
        assert torch.equal(getattr(full, k), getattr(resumed, k)), k
    with np.load(ck, allow_pickle=False) as z:  # plain arrays, no pickle
        assert all(z[f].dtype != object for f in z.files)


def test_inverse_recovers_albedo(cornell_scene):
    """tests/test_grad.py's albedo recovery, shortened: the red wall's kd
    starts at 0.3 and Adam on the dual-render MSE (masked to that wall,
    24x24, 1 spp, 2 bounces, lr 2e-2, 30 steps, against a 32-spp target)
    brings every channel within 0.1 of the truth and at least halves its
    error. (Adam at a fixed rate on this noisy gradient settles near, not
    at, the truth: mcpt_tpu takes the same path, and its own test allows
    0.08 after 200 steps.)"""
    from mcpt_tpu_torch.diff.grad import SceneParams, extract_params, render_image
    from mcpt_tpu_torch.diff.inverse import run_inverse
    from mcpt_tpu_torch.utils.rng import prng_key

    ts = _small(torch_scene(cornell_scene), 24, 24)
    true = extract_params(ts)
    with torch.no_grad():
        target = render_image(true, ts, prng_key(11), 32, 2)
    red = 2  # material order: white, green, red, light
    kd = true.kd.clone()
    kd[red] = 0.3
    mask = SceneParams(kd=torch.zeros_like(kd).index_fill_(0, torch.tensor([red]), 1.0),
                       ks=torch.zeros_like(true.ks), radiance=torch.zeros_like(true.radiance))
    final, losses = run_inverse(ts, target, dataclasses.replace(true, kd=kd, dverts=None), steps=30, spp=1,
                                max_bounces=2, learning_rate=2e-2, param_mask=mask, seed=4)
    assert np.isfinite(losses).all()
    err = (final.kd[red] - true.kd[red]).abs()
    assert err.max() < 0.1 and (err <= 0.5 * (0.3 - true.kd[red]).abs()).all(), (final.kd[red], true.kd[red])
