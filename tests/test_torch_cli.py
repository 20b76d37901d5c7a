"""`python -m mcpt_tpu_torch` (mcpt_tpu_torch/cli.py) on the CPU, in
process: info against mcpt_tpu's CLI, render checkpoints and resume
(bitwise), previews, the live frame, inverse's frozen emitter albedo, the
mesh's refusal without a card, and render checkpoints and --save-radiance
across the two packages.

Every render is cornell-box at 32x32 or smaller, 1-2 spp, at most 4
bounces, --device cpu."""
import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "cornell-box.obj")
SMALL = ["--width", "32", "--height", "32", "--spp-per-pass", "1", "--bounces", "2", "--device", "cpu"]


def _main(argv):
    from mcpt_tpu_torch.cli import main

    return main(argv)


def _stats(text):
    return json.loads(text.strip().splitlines()[-1])


def test_info_equals_jax(capsys):
    from mcpt_tpu.cli import main as jax_main

    assert _main(["info", SCENE, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(["info", SCENE]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert got["triangles"] == 32 and got["camera"]["width"] == 1024


def test_defaults_are_mcpt_tpus():
    """mcpt_tpu/cli.py's defaults, plus --device cuda."""
    from mcpt_tpu_torch.cli import build_parser

    ap = build_parser()
    r = ap.parse_args(["render", SCENE])
    assert (r.spp, r.spp_per_pass, r.bounces, r.seed, r.device, r.mesh) == (64, None, 24, 0, "cuda", None)
    assert (r.checkpoint_every, r.preview_every, r.live, r.no_bvh) == (0, 0, False, False)
    i = ap.parse_args(["inverse", SCENE, "--target", "t.npz"])
    assert (i.spp, i.bounces, i.steps, i.lr, i.radiance_lr, i.device) == (4, 6, 500, 2e-2, 0.2, "cuda")
    assert ap.parse_args(["info", SCENE]).device == "cuda"


def test_render_checkpoint_resume_bitwise(tmp_path, capsys):
    """Two passes with a checkpoint after each; a resume from the 1-spp
    checkpoint gives the same PNG and radiance bit for bit (the
    counter-based RNG repeats the second sample), and the last line is the
    stats JSON."""
    ck, png, rad = (str(tmp_path / n) for n in ("ck.npz", "a.png", "a.npz"))
    assert _main(["render", SCENE, *SMALL, "--spp", "1", "--checkpoint", ck, "--checkpoint-every", "1",
                  "--out", str(tmp_path / "one.png")]) == 0
    with np.load(ck) as z:
        assert int(z["sample_idx"]) == 1 and int(z["seed"]) == 0
        assert z["accum"].dtype == np.float32 and z["accum"].shape == (32, 32, 3)
        assert z["spp"].dtype == z["rays"].dtype == np.float32 and z["nan_count"].dtype == np.int32
    capsys.readouterr()
    assert _main(["render", SCENE, *SMALL, "--spp", "2", "--resume", ck, "--out", png,
                  "--save-radiance", rad]) == 0
    out = capsys.readouterr().out
    assert "resumed at 1 spp" in out
    stats = _stats(out)
    assert stats["spp"] == 2 and stats["nan_scrubbed"] == 0 and stats["out"] == png
    full_png, full_rad = str(tmp_path / "b.png"), str(tmp_path / "b.npz")
    assert _main(["render", SCENE, *SMALL, "--spp", "2", "--out", full_png, "--save-radiance", full_rad]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(png)), np.asarray(Image.open(full_png)))
    np.testing.assert_array_equal(np.load(rad)["radiance"], np.load(full_rad)["radiance"])


def test_seed_mismatch_raises_system_exit(tmp_path):
    ck = str(tmp_path / "ck.npz")
    _main(["render", SCENE, "--width", "16", "--height", "16", "--spp", "1", "--bounces", "1", "--device", "cpu",
           "--checkpoint", ck, "--checkpoint-every", "1", "--out", str(tmp_path / "a.png")])
    with pytest.raises(SystemExit, match="checkpoint seed 0 != --seed 7"):
        _main(["render", SCENE, "--width", "16", "--height", "16", "--spp", "2", "--seed", "7", "--device", "cpu",
               "--resume", ck, "--out", str(tmp_path / "b.png")])


def test_preview_every_and_live(tmp_path, capsys):
    """--preview-every writes the preview on crossing each multiple (here
    at 1 and 2 of 3 spp, so it holds fewer samples than the final PNG);
    --live draws an ANSI half-block frame after every pass."""
    png, pv = str(tmp_path / "out.png"), str(tmp_path / "preview.png")
    assert _main(["render", SCENE, *SMALL, "--spp", "3", "--preview-every", "1", "--preview", pv,
                  "--out", png, "--live"]) == 0
    out = capsys.readouterr().out
    assert out.count("preview @") == 2 and "\x1b[38;2;" in out and "▀" in out and "3/3 spp" in out
    prev, final = np.asarray(Image.open(pv)), np.asarray(Image.open(png))
    assert prev.shape == final.shape == (32, 32, 3) and (prev != final).any()
    assert _stats(out)["spp"] == 3


def test_inverse_reports_unconstrained_emitter_kd(tmp_path, capsys):
    """inverse freezes and reports the emitter's albedo (an .npz target),
    and warns about saturation with a PNG target."""
    rad, tpng = str(tmp_path / "t.npz"), str(tmp_path / "t.png")
    small = ["--width", "16", "--height", "16", "--device", "cpu"]
    assert _main(["render", SCENE, *small, "--spp", "1", "--bounces", "2", "--save-radiance", rad,
                  "--out", tpng]) == 0
    capsys.readouterr()
    out = str(tmp_path / "params.npz")
    assert _main(["inverse", SCENE, *small, "--target", rad, "--steps", "2", "--spp", "1", "--bounces", "2",
                  "--out", out, "--checkpoint", str(tmp_path / "inv.npz")]) == 0
    text = capsys.readouterr().out
    stats = _stats(text)
    assert stats["steps"] == 2 and stats["unconstrained_kd_materials"] == [3]
    assert "freezing kd of emissive material(s) [3]" in text
    z = np.load(out)
    np.testing.assert_array_equal(z["unconstrained_kd"], [3])
    np.testing.assert_array_equal(z["kd"][3], np.full(3, 0.5, np.float32))  # frozen at the start value
    assert (z["kd"][:3] != 0.5).any() and np.isfinite(z["losses"]).all()
    assert _main(["inverse", SCENE, *small, "--target", tpng, "--steps", "1", "--spp", "1", "--bounces", "2",
                  "--out", out, "--checkpoint", str(tmp_path / "inv.npz")]) == 0
    assert "WARNING" in capsys.readouterr().err


def test_mesh_without_a_card_raises(tmp_path):
    """--mesh on the default device (cuda) with no card refuses and names
    --device cpu; nothing falls back to the CPU."""
    with pytest.raises(SystemExit, match="--device cpu"):
        _main(["render", SCENE, "--width", "16", "--height", "16", "--spp", "1", "--mesh", "2x1",
               "--out", str(tmp_path / "a.png")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(["render", SCENE, "--width", "16", "--height", "16", "--spp", "1", "--out", str(tmp_path / "b.png")])


def _jax_cli(argv):
    from mcpt_tpu.cli import main as jax_main

    return jax_main(argv)


def _close(a, b):
    """tests/test_torch_integrator.py's render contract."""
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).mean()
    assert close >= 0.99, f"only {close:.4f} of components close"
    np.testing.assert_allclose(a.mean(axis=(0, 1)), b.mean(axis=(0, 1)), rtol=2e-3)


def test_checkpoints_and_radiance_across_packages(tmp_path, capsys):
    """cornell 32x32, 4 bounces, 1 spp a pass. Each package writes a 1-spp
    checkpoint and resumes it to 2 spp with --save-radiance: the files have
    the same keys, dtypes and shapes; the port loads mcpt_tpu's exactly and
    its resume adds its own second sample to it bit for bit; each package
    resumes the other's checkpoint; and the two radiance files agree under
    the integrator contract."""
    import torch

    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.film import checkpoint_load, make_film
    from mcpt_tpu_torch.render.renderer import render_pass_chunked
    from mcpt_tpu_torch.utils.rng import prng_key

    common = ["--width", "32", "--height", "32", "--spp-per-pass", "1", "--bounces", "4"]
    p = {n: str(tmp_path / n) for n in ("ck_j.npz", "ck_t.npz", "r_j.npz", "r_t.npz", "r_tj.npz", "r_jt.npz")}
    png = str(tmp_path / "x.png")
    assert _jax_cli(["render", SCENE, *common, "--spp", "1", "--checkpoint", p["ck_j.npz"],
                     "--checkpoint-every", "1", "--out", png]) == 0
    assert _main(["render", SCENE, *common, "--device", "cpu", "--spp", "1", "--checkpoint", p["ck_t.npz"],
                  "--checkpoint-every", "1", "--out", png]) == 0
    with np.load(p["ck_j.npz"]) as zj, np.load(p["ck_t.npz"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert (zj[k].dtype, zj[k].shape) == (zt[k].dtype, zt[k].shape), k
        jax_accum = zj["accum"]
        film, seed, idx = checkpoint_load(p["ck_j.npz"], "cpu")
        np.testing.assert_array_equal(film.accum.numpy(), jax_accum)
        assert (film.spp, film.nan_count, film.rays, seed, idx) == (float(zj["spp"]), int(zj["nan_count"]),
                                                                     float(zj["rays"]), 0, 1)
    assert _jax_cli(["render", SCENE, *common, "--spp", "2", "--resume", p["ck_j.npz"], "--out", png,
                     "--save-radiance", p["r_j.npz"]]) == 0
    assert _jax_cli(["render", SCENE, *common, "--spp", "2", "--resume", p["ck_t.npz"], "--out", png,
                     "--save-radiance", p["r_jt.npz"]]) == 0
    assert _main(["render", SCENE, *common, "--device", "cpu", "--spp", "2", "--resume", p["ck_t.npz"],
                  "--out", png, "--save-radiance", p["r_t.npz"]]) == 0
    assert _main(["render", SCENE, *common, "--device", "cpu", "--spp", "2", "--resume", p["ck_j.npz"],
                  "--out", png, "--save-radiance", p["r_tj.npz"]]) == 0
    rad = {k: np.load(v)["radiance"] for k, v in p.items() if k.startswith("r_")}
    # the port's second sample, rendered alone, on mcpt_tpu's first
    s = load_scene(SCENE, device="cpu")
    s = dataclasses.replace(s, camera=dataclasses.replace(s.camera, width=32, height=32))
    second = render_pass_chunked(s, make_film(32, 32, "cpu"), prng_key(0), 1, 4, 1).accum.numpy()
    np.testing.assert_array_equal(rad["r_tj.npz"], (jax_accum + second) / np.float32(2.0))
    _close(rad["r_t.npz"], rad["r_j.npz"])
    _close(rad["r_jt.npz"], rad["r_j.npz"])
    _close(rad["r_tj.npz"], rad["r_t.npz"])
    assert torch.isfinite(torch.from_numpy(rad["r_t.npz"])).all()
