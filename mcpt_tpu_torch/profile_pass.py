"""Where one render pass, and one gradient step, of the port spends its
time on the card.

    python -m mcpt_tpu_torch.profile_pass

Profiles chip_smoke.py's two main paths, 24 bounces and 1 spp each:
veach-mis at 1024x1024 (the Woop kernels) and bathroom-stress at 1280x720
(the BVH traversal kernels; the scene is generated in memory by
chip_smoke.stress_scene); then the gradient steps of chip_smoke.py phases
15-17: mse_loss_dual on cornell at 256x256, 4 spp, 6 bounces (the
inverse-500 set-up's step without its Adam update), and loss_and_grad on
veach-mis at 1024x1024, 1 spp, 6 bounces and on bathroom-stress at
1280x720, 1 spp, 4 bounces (dverts over every vertex). For each: one
warm-up run, then one run under torch.profiler; prints its wall time, the
device time of each kernel (summed by name), the device's busy share, and
a JSON line with the totals. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEACH = os.path.join(ROOT, "scenes", "veach-mis.obj")
BOUNCES = 24


def _launches():
    from mcpt_tpu_torch.ops import traverse, woop

    return {**{f"woop_{k}": v for k, v in woop.LAUNCHES.items()},
            **{f"traverse_{k}": v for k, v in traverse.LAUNCHES.items()}}


def profile(label: str, scene, width: int, height: int, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=BOUNCES, width=width, height=height))
    r.step()  # warm-up: kernel build, allocator, library handles
    before = _launches()
    rays0 = r.film.rays
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.step()
    report(label, f"{width}x{height}", prof, 1e3 * r.pass_times[-1], r.film.rays - rays0, before, card)


def profile_grad(label: str, scene, width: int, height: int, spp: int, bounces: int, dual: bool,
                 card: str) -> None:
    """One gradient step (kd, ks, radiance and dverts where the scene has
    shared vertices) of the MSE against a black target, or of the dual MSE."""
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mcpt_tpu_torch.diff.grad import extract_params, mse_loss, mse_loss_dual, value_and_grad
    from mcpt_tpu_torch.utils.rng import prng_key

    sc = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=width, height=height))
    p = extract_params(sc)
    black = torch.zeros((height, width, 3), device=sc.device)

    def step():
        loss, g = value_and_grad(mse_loss_dual if dual else mse_loss, p, sc, black, prng_key(0), spp, bounces)
        float(loss)  # waits for the step

    step()  # warm-up
    before = _launches()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    report(label, f"{width}x{height}, {spp} spp, {bounces} bounces, gradient step", prof, wall_ms, None,
           before, card)


def report(label, what, prof, wall_ms, rays, before, card) -> None:
    after = _launches()
    kernels = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + dev / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    ours_ms = sum(ms for k, (ms, _) in kernels.items() if "woop_" in k or "traverse_" in k)
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    print(f"== {label} {what}, card: {card}")
    rate = "" if rays is None else f"{rays:.0f} rays, {rays / wall_ms / 1e3:.2f} Mrays/s, "
    print(f"{wall_ms:.2f} ms wall, {rate}intersection kernel launches {launches}")
    print(f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} % of the wall time), "
          f"{sum(n for _, n in kernels.values())} kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{ms:9.3f} ms {n:6d}x  {name[:110]}")
    print(json.dumps({"scene": label, "run": what, "card": card, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "intersection_kernels_ms": ours_ms,
                      "kernel_launches": sum(n for _, n in kernels.values()), "rays": rays}))


def main() -> None:
    from mcpt_tpu_torch.io.obj import load_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    profile("veach-mis", load_scene(VEACH, device="cuda"), 1024, 1024, card)
    sys.path.insert(0, ROOT)
    from chip_smoke import stress_scene

    (bath,) = stress_scene()
    profile("bathroom-stress", bath, 1280, 720, card)
    profile_grad("bathroom-stress", bath, 1280, 720, 1, 4, False, card)
    del bath
    profile_grad("cornell-box", load_scene(os.path.join(ROOT, "scenes", "cornell-box.obj"), device="cuda"),
                 256, 256, 4, 6, True, card)
    profile_grad("veach-mis", load_scene(VEACH, device="cuda"), 1024, 1024, 1, 6, False, card)


if __name__ == "__main__":
    main()
