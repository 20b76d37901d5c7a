"""tiles x spp rendering over torch.distributed (mcpt_tpu_torch/parallel/)
on the CPU: gloo ranks spawned as processes (tests/torch_mesh_ranks.py),
cornell-box at 32x32, 6 bounces, one pass of 2 spp, the white albedo's
green channel set to NaN so that every render scrubs NaNs.

Contracts:
  * a tiles-only mesh (2x1) renders each pixel's samples as one process
    does, so its film, NaN count and ray count equal the single-process
    ones bit for bit;
  * on the spp axis (1x2, 2x2) a pixel's partial sums are added across
    ranks: film within rtol = atol = 2e-6 (tests/test_parallel.py's bound
    for mcpt_tpu), counts exact;
  * the port's 2x2 film agrees with mcpt_tpu's ShardedRenderer on a 2x2
    mesh of the conftest's CPU devices under tests/test_torch_integrator.py's
    render contract;
  * a checkpoint of the 2-tile film resumes on one tile bitwise;
  * measure_scaling's per-rank rays sum to one process's, and
    measure_throughput_scaling gives a row for each rank count that
    divides the image height;
  * dryrun_grad_step on 2 ranks (cornell 16x16, 3 bounces) agrees with
    one process: the ranks' sums are added in another order, so the loss
    agrees within rtol 1e-6 and each gradient field within rtol 1e-5 plus
    1e-5 times its largest entry; both ranks take the same Adam step, bit
    for bit, and no parameter moves by more than the rate (Adam's first
    step, lr * g / (|g| + eps), turns a rounding difference in a gradient
    near eps into one of order lr, so the parameters are not held to one
    process's).
"""
import numpy as np
import pytest
import torch

from tests import torch_mesh_ranks as M


def _single(scene, passes=1, spp_per_pass=M.SPP):
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=M.BOUNCES, spp_per_pass=spp_per_pass))
    for _ in range(passes):
        r.step()
    return r.film


@pytest.fixture(scope="module")
def single():
    return _single(M.cornell(nan_kd=True))


def _same_counts(res, film):
    assert res["nan_count"] == film.nan_count > 0
    assert res["rays"] == film.rays and res["spp"] == film.spp


def test_two_ranks(tmp_path, single):
    from mcpt_tpu_torch.diff.inverse import dryrun_grad_step

    res = M.spawn(M.two_ranks, 2, tmp_path)
    for r in res:
        assert torch.equal(r["2x1"]["accum"], single.accum)
        _same_counts(r["2x1"], single)
        np.testing.assert_allclose(r["1x2"]["accum"].numpy(), single.accum.numpy(), rtol=2e-6, atol=2e-6)
        _same_counts(r["1x2"], single)
    # a 2-tile checkpoint resumed on one tile equals two passes of one process
    two = _single(M.cornell(nan_kd=True), passes=2)
    assert torch.equal(res[0]["resumed_1x1"]["accum"], two.accum)
    assert res[0]["resumed_1x1"]["spp"] == two.spp == 2 * M.SPP
    assert res[0]["resumed_1x1"]["nan_count"] == two.nan_count
    # the dry-run gradient step
    scene = M.cornell(width=16, height=16)
    loss, grads, _ = dryrun_grad_step(scene)
    start = {"kd": scene.mats.kd, "ks": scene.mats.ks, "radiance": scene.mats.radiance}
    for r in res:
        d = r["dryrun"]
        np.testing.assert_allclose(float(d["loss"]), float(loss), rtol=1e-6)
        for k, v in grads.tensors().items():
            scale = float(v.abs().max())
            np.testing.assert_allclose(d[f"g.{k}"].numpy(), v.numpy(), rtol=1e-5, atol=1e-5 * scale, err_msg=k)
            assert torch.equal(d[f"g.{k}"], res[0]["dryrun"][f"g.{k}"])  # one all-reduced answer
            assert torch.equal(d[f"p.{k}"], res[0]["dryrun"][f"p.{k}"])  # one Adam step
            if k in start:
                assert float((d[f"p.{k}"] - start[k]).abs().max()) <= 1e-2 + 1e-6  # lr, and f32 rounding
    assert float(grads.kd.abs().max()) > 0


def _jax_sharded_2x2():
    """mcpt_tpu's ShardedRenderer on make_mesh(2, 2) of the conftest's CPU
    devices, the same scene and pass (plain albedo)."""
    import jax

    from mcpt_tpu.io.obj import load_scene
    from mcpt_tpu.parallel.mesh import make_mesh
    from mcpt_tpu.parallel.shard import ShardedRenderer

    scene = load_scene(M.CORNELL, with_bvh=True)
    sr = ShardedRenderer(scene, mesh=make_mesh(2, 2, devices=jax.devices()[:4]), max_bounces=M.BOUNCES,
                         spp_per_pass=M.SPP, seed=0, width=M.W, height=M.H)
    sr.step()
    return np.asarray(jax.device_get(sr.film.accum)) / M.SPP


def test_four_ranks(tmp_path, single):
    from mcpt_tpu_torch.render.integrator import trace_image_wavefront
    from mcpt_tpu_torch.utils.rng import prng_key

    res = M.spawn(M.four_ranks, 4, tmp_path)
    for r in res:
        np.testing.assert_allclose(r["2x2_nan"]["accum"].numpy(), single.accum.numpy(), rtol=2e-6, atol=2e-6)
        _same_counts(r["2x2_nan"], single)
        assert torch.equal(r["2x2"]["accum"], res[0]["2x2"]["accum"])
    plain = _single(M.cornell())
    np.testing.assert_allclose(res[0]["2x2"]["accum"].numpy(), plain.accum.numpy(), rtol=2e-6, atol=2e-6)
    assert res[0]["2x2"]["nan_count"] == plain.nan_count == 0
    # against mcpt_tpu's sharded renderer
    a, b = res[0]["2x2"]["accum"].numpy() / M.SPP, _jax_sharded_2x2()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).mean()
    assert close >= 0.99, f"only {close:.4f} of components close"
    np.testing.assert_allclose(a.mean(axis=(0, 1)), b.mean(axis=(0, 1)), rtol=2e-3)
    # measure_scaling: per-rank rays of a 2-spp pass at 4 bounces sum to one process's
    sc = res[0]["scaling"]
    s = M.cornell()
    _, nrays, _ = trace_image_wavefront(s, s.camera, prng_key(0), torch.arange(M.W * M.H), 0, 2, 4)
    assert sc["devices"] == 4 and len(sc["rays_per_device"]) == 4 and min(sc["rays_per_device"]) > 0
    assert sc["total_rays"] == float(nrays) and 0.5 < sc["balance_efficiency"] <= 1.0
    assert all(r["scaling"] == sc for r in res)
    # measure_throughput_scaling: a row for 1, 2 and 4 ranks (16 % 3 != 0 skips 3), the same on every rank
    rows = res[0]["throughput"]
    assert [row["devices"] for row in rows] == [1, 2, 4] and rows[0]["speedup"] == 1.0
    assert all(row["mrays_per_s"] > 0 and row["efficiency"] == row["speedup"] / row["devices"] for row in rows)
    assert all(r["throughput"] == rows for r in res)
