"""Where one render pass of the port spends its time on the card.

    python -m mcpt_tpu_torch.profile_pass

Renders veach-mis at 1024x1024 and 24 bounces (chip_smoke.py's main path):
one warm-up pass, then one pass under torch.profiler, and prints
the pass's wall time, the device time of each kernel (summed by name), the
device's busy share of the pass, and a closing JSON line with the totals.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "scenes", "veach-mis.obj")
SIZE = 1024
BOUNCES = 24


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    scene = load_scene(SCENE, device="cuda")
    r = Renderer(scene, RenderConfig(max_bounces=BOUNCES, width=SIZE, height=SIZE))
    r.step()  # warm-up: kernel build, allocator, library handles
    before, rays0 = dict(woop.LAUNCHES), r.film.rays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.step()
    wall_ms = 1e3 * r.pass_times[-1]
    rays = r.film.rays - rays0
    kernels = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + dev / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    woop_ms = sum(ms for k, (ms, _) in kernels.items() if "woop_" in k)
    print(f"card: {card}")
    print(f"pass: {wall_ms:.2f} ms wall, {rays:.0f} rays, {rays / wall_ms / 1e3:.2f} Mrays/s, "
          f"woop launches {({k: woop.LAUNCHES[k] - before[k] for k in before})}")
    print(f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} % of the pass), "
          f"{sum(n for _, n in kernels.values())} kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{ms:9.3f} ms {n:6d}x  {name[:110]}")
    print(json.dumps({"card": card, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "woop_kernels_ms": woop_ms, "kernel_launches": sum(n for _, n in kernels.values()),
                      "rays": rays}))


if __name__ == "__main__":
    main()
