#!/usr/bin/env python3
"""Time one checkout's kernel on saved ray batches.

    python3 chip_smoke.py --save-batches /tmp/batches
    python3 time_closest_batch.py /tmp/batches/traverse_closest_third.pt [--root CHECKOUT]
    python3 time_closest_batch.py --kernel traverse_any /tmp/batches/traverse_any_third.pt ...
    python3 time_closest_batch.py --kernel woop_closest /tmp/batches/woop_closest_camera.pt ...
    python3 time_closest_batch.py --kernel select_closest /tmp/batches/select_closest_camera.pt ...
    python3 time_closest_batch.py --kernel schedule_closest /tmp/batches/schedule_closest_camera.pt ...

chip_smoke.py saves the packed rays of the batches it times (--save-batches
DIR; --save-closest-batch PATH saves the bathroom pass's third closest-hit
batch alone), in the order the wrappers launch them. This script loads the
scene with the mcpt_tpu_torch and chip_smoke.py of CHECKOUT (this one by
default, or an unpacked earlier commit of the repo): bathroom-stress, built
in memory, for the traversal kernels, and scenes/veach-mis.obj for
woop_closest (whose chunk mask it computes again from the rays). Then it
runs that checkout's kernel (--kernel: traverse_closest, the default,
traverse_any, woop_closest, select_closest, select_any, schedule_closest,
schedule_any or schedule_prepass; the treelet kernels take the sorted
128-ray tiles that chip_smoke.py phases 11 and 12 save, with the treelet
layout the checkout builds; the schedule walks take the rows saved beside
the tiles, <batch>_rows.pt, so that two checkouts walk the same rows, and
schedule_prepass times the checkout's build_schedule, the pre-pass a
schedule entry point runs on the card) on each batch and prints its time
(CUDA events, median of 7 runs after a warm-up, as chip_smoke.py times),
its hits and a checksum of its answer, so that the kernels of two
checkouts are compared on one batch. Needs one CUDA card; exits 1 without
one.
"""
import argparse
import os
import sys
import time

KERNELS = ("traverse_closest", "traverse_any", "woop_closest", "select_closest", "select_any", "schedule_closest",
           "schedule_any", "schedule_prepass")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rays", nargs="+", help="tensors saved by chip_smoke.py --save-batches or --save-closest-batch")
    ap.add_argument("--kernel", choices=KERNELS, default="traverse_closest", help="the kernel timed")
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
    from mcpt_tpu_torch.ops import woop

    for mod in (chip_smoke, tv, woop):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not from {root}")
    _build.library()
    t0 = time.perf_counter()
    if args.kernel == "woop_closest":
        from mcpt_tpu_torch.io.obj import load_scene

        scene = load_scene(os.path.join(root, "scenes", "veach-mis.obj"), device="cuda")
        ws = scene.woop

        def run(rays, aux):
            return woop.closest_hit_woop_kernel(ws, rays, aux)
    elif args.kernel == "schedule_prepass":
        from mcpt_tpu_torch.ops import schedule

        (scene,) = chip_smoke.stress_scene(chip_smoke.STRESS_TRIS, 0, ("cuda",))

        def run(rays, aux):
            return schedule.build_schedule(scene.treelets, rays, chip_smoke.SCHED_V)[0]
    elif args.kernel.startswith("schedule_"):
        import inspect

        from mcpt_tpu_torch.ops import schedule

        (scene,) = chip_smoke.stress_scene(chip_smoke.STRESS_TRIS, 0, ("cuda",))
        kern = getattr(schedule, f"{args.kernel.split('_')[1]}_hit_schedule_kernel")
        # a checkout before the per-ray walks takes the triangles, a later one the traversal tables
        tables = scene.trav.tris if "tris" in inspect.signature(kern).parameters else scene.trav

        def run(rays, aux):
            return kern(scene.treelets, tables, rays, aux)
    elif args.kernel.startswith("select_"):
        import inspect

        from mcpt_tpu_torch.ops import select

        (scene,) = chip_smoke.stress_scene(chip_smoke.STRESS_TRIS, 0, ("cuda",))
        kern = getattr(select, f"{args.kernel.split('_')[1]}_hit_select_kernel")
        # a checkout before the per-ray walks takes the triangles, a later one the traversal tables
        tables = scene.trav.tris if "tris" in inspect.signature(kern).parameters else scene.trav

        def run(rays, aux):
            return kern(scene.treelets, tables, rays)
    else:
        (scene,) = chip_smoke.stress_scene(chip_smoke.STRESS_TRIS, 0, ("cuda",))
        kern = tv.closest_hit_traverse_kernel if args.kernel == "traverse_closest" else tv.any_hit_traverse_kernel

        def run(rays, aux):
            return kern(scene.trav, rays)
    torch.cuda.synchronize()
    print(f"scene: {scene.num_tris} triangles, loaded in {time.perf_counter() - t0:.2f} s")
    for path in args.rays:
        rays = torch.load(path).cuda().contiguous()
        aux = None  # the Woop chunk mask, or the schedule rows saved beside the tiles
        if args.kernel == "woop_closest":
            aux = woop.tile_chunk_mask(rays, ws.boxes)
        elif args.kernel in ("schedule_closest", "schedule_any"):
            aux = torch.load(path[:-len(".pt")] + "_rows.pt").cuda().contiguous()
        out = run(rays, aux)
        torch.cuda.synchronize()
        ms = chip_smoke.cuda_time_ms(lambda: run(rays, aux))
        if args.kernel == "schedule_prepass":  # the rows' keys as ids, KEY_MISS as -1
            out = out.reshape(-1)
            out = (None, torch.where(out == 2**31 - 1, -1, out))
        ids = (out[1] if isinstance(out, tuple) else torch.where(out, 0, -1)).long()
        pos = torch.arange(1, ids.shape[0] + 1, device=ids.device)
        print(f"{args.kernel} of {root} on {os.path.basename(path)}: {rays.shape[0]} rays, "
              f"{int((ids >= 0).sum())} hits, checksum {int((ids * pos).sum())}, kernel {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
