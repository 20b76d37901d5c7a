"""Fault injection on the port's CLI, as tests/test_cli.py does for
mcpt_tpu's: a render killed with SIGKILL (no cleanup) resumes from its
last checkpoint to a film bitwise equal to an uninterrupted run's. The
counter-based RNG repeats the remaining samples, and the atomic checkpoint
write means the file resumed from is whole. cornell-box 32x32, 2 bounces,
--device cpu, in subprocesses."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "cornell-box.obj")


def test_kill_and_resume_bitwise(tmp_path):
    ck = str(tmp_path / "ck.npz")
    base = [sys.executable, "-m", "mcpt_tpu_torch", "render", SCENE, "--width", "32", "--height", "32",
            "--spp-per-pass", "1", "--bounces", "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    # the victim: far more samples than it lives to finish, a checkpoint each
    proc = subprocess.Popen(base + ["--spp", "500", "--checkpoint", ck, "--checkpoint-every", "1",
                                    "--out", str(tmp_path / "never.png")],
                            env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while not os.path.exists(ck):
            assert proc.poll() is None, "the render exited before its first checkpoint"
            assert time.time() < deadline, "no checkpoint within 120 s"
            time.sleep(0.05)
        time.sleep(0.3)  # let the kill land mid-pass, not at a tidy boundary
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    with np.load(ck) as z:
        resumed_at = int(z["sample_idx"])
    assert resumed_at >= 1

    outs = {}
    for name, extra in (("resumed", ["--resume", ck]), ("full", [])):
        png, rad = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}.npz")
        r = subprocess.run(base + ["--spp", str(resumed_at + 2), "--out", png, "--save-radiance", rad, *extra],
                           env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        outs[name] = (np.asarray(Image.open(png)), np.load(rad)["radiance"])
    np.testing.assert_array_equal(outs["resumed"][0], outs["full"][0])
    np.testing.assert_array_equal(outs["resumed"][1], outs["full"][1])
