#!/usr/bin/env python3
"""Time one checkout's closest-hit BVH kernel on a saved ray batch.

    python3 chip_smoke.py --save-closest-batch /tmp/batch.pt
    python3 time_closest_batch.py /tmp/batch.pt [--root CHECKOUT]

chip_smoke.py saves the rays of the bathroom-stress pass's third closest-hit
launch (phase 8), sorted as the wrapper launches them. This script builds
bathroom-stress in memory with the mcpt_tpu_torch and chip_smoke.py of
CHECKOUT (this one by default, or an unpacked earlier commit of the repo),
runs that checkout's traverse.closest_hit_traverse_kernel on the rays, and
prints its time (CUDA events, median of 7 runs after a warm-up, as
chip_smoke.py times), its hits, and a checksum of its triangle ids, so
that the kernels of two checkouts are compared on one batch. Needs one
CUDA card; exits 1 without one.
"""
import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", help="a tensor saved by chip_smoke.py --save-closest-batch")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose kernel is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_closest_batch: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from mcpt_tpu_torch.ops import _build
    from mcpt_tpu_torch.ops import traverse as tv

    for mod in (chip_smoke, tv):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not from {root}")
    _build.library()
    t0 = time.perf_counter()
    (scene,) = chip_smoke.stress_scene(chip_smoke.STRESS_TRIS, 0, ("cuda",))
    print(f"bathroom-stress: {scene.num_tris} triangles, built in {time.perf_counter() - t0:.2f} s")
    rays = torch.load(args.rays).cuda().contiguous()
    t, tri, _, _ = tv.closest_hit_traverse_kernel(scene.trav, rays)
    torch.cuda.synchronize()
    ms = chip_smoke.cuda_time_ms(lambda: tv.closest_hit_traverse_kernel(scene.trav, rays))
    ids = tri.long()
    print(f"traverse_closest of {root}: {rays.shape[0]} rays, {int((ids >= 0).sum())} hits, "
          f"id checksum {int((ids * torch.arange(1, ids.shape[0] + 1, device=ids.device)).sum())}, "
          f"kernel {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
