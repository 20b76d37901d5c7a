"""Where one render pass of the port spends its time on the card.

    python -m mcpt_tpu_torch.profile_pass

Profiles chip_smoke.py's two main paths, 24 bounces and 1 spp each:
veach-mis at 1024x1024 (the Woop kernels) and bathroom-stress at 1280x720
(the BVH traversal kernels; the scene is generated in memory by
chip_smoke.stress_scene). For each: one warm-up pass, then one pass under
torch.profiler; prints the pass's wall time, the device time of each kernel
(summed by name), the device's busy share of the pass, and a JSON line with
the totals. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEACH = os.path.join(ROOT, "scenes", "veach-mis.obj")
BOUNCES = 24


def profile(label: str, scene, width: int, height: int, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from mcpt_tpu_torch.ops import traverse, woop
    from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(scene, RenderConfig(max_bounces=BOUNCES, width=width, height=height))
    r.step()  # warm-up: kernel build, allocator, library handles
    before = {**{f"woop_{k}": v for k, v in woop.LAUNCHES.items()},
              **{f"traverse_{k}": v for k, v in traverse.LAUNCHES.items()}}
    rays0 = r.film.rays
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.step()
    after = {**{f"woop_{k}": v for k, v in woop.LAUNCHES.items()},
             **{f"traverse_{k}": v for k, v in traverse.LAUNCHES.items()}}
    wall_ms = 1e3 * r.pass_times[-1]
    rays = r.film.rays - rays0
    kernels = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + dev / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    ours_ms = sum(ms for k, (ms, _) in kernels.items() if "woop_" in k or "traverse_" in k)
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    print(f"== {label} {width}x{height}, card: {card}")
    print(f"pass: {wall_ms:.2f} ms wall, {rays:.0f} rays, {rays / wall_ms / 1e3:.2f} Mrays/s, "
          f"intersection kernel launches {launches}")
    print(f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} % of the pass), "
          f"{sum(n for _, n in kernels.values())} kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{ms:9.3f} ms {n:6d}x  {name[:110]}")
    print(json.dumps({"scene": label, "card": card, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
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


if __name__ == "__main__":
    main()
