"""Command line of the port: `python -m mcpt_tpu_torch render|inverse|info`.

Subcommands
-----------
  render   progressive path-traced render -> PNG (+ resumable checkpoints)
  inverse  inverse rendering: recover kd/radiance from a target image (Adam)
  info     print scene statistics (the reference prints these at
           src/main.cpp:14)

The flags and defaults are mcpt_tpu/cli.py's, plus --device (cuda by
default; without a card the command raises: pass --device cpu). Where the
port differs: --profile writes a torch.profiler Chrome trace
(DIR/trace.json); --mesh TxS spawns T*S ranks (torch.multiprocessing,
spawn) over torch.distributed, NCCL when every rank has a card of its own,
gloo otherwise (ranks on the CPU, or sharing cards), and rank 0 prints and
writes the files; kernels are built once before the ranks start.

Examples
--------
  python -m mcpt_tpu_torch render scenes/cornell-box.obj --spp 64 --out out.png
  python -m mcpt_tpu_torch render scenes/veach-mis.obj --spp 128 --mesh 2x1
  python -m mcpt_tpu_torch render scenes/cornell-box.obj --resume ckpt.npz
  python -m mcpt_tpu_torch inverse scenes/cornell-box.obj --target target.png
  python -m mcpt_tpu_torch info scenes/veach-mis.obj --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="path to .obj (with .mtl/.xml siblings)")
    p.add_argument("--width", type=int, default=None, help="override camera width")
    p.add_argument("--height", type=int, default=None, help="override camera height")
    p.add_argument("--spp", type=int, default=64, help="total samples per pixel")
    p.add_argument("--spp-per-pass", type=int, default=None,
                   help="samples per device step (default: min(spp, 16))")
    p.add_argument("--bounces", type=int, default=24,
                   help="max path length (RR starts at bounce 3, Render.cpp:164)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-bvh", action="store_true",
                   help="load without a BVH (scenes of at most 4,096 triangles)")
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default cuda; raises when there is no card)")


def _mesh_shape(spec: str) -> tuple[int, int]:
    try:
        nt, ns = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: expected TILESxSPP, e.g. 2x1") from None
    if nt < 1 or ns < 1:
        raise SystemExit(f"--mesh {spec!r}: both axes must be at least 1")
    return nt, ns


def _check_resume_seed(args) -> None:
    """A checkpoint of another seed is refused before anything renders: the
    RNG stream is keyed on the seed, so resuming would mix two streams."""
    if not args.resume:
        return
    import numpy as np

    with np.load(args.resume) as z:
        seed = int(z["seed"])
    if seed != args.seed:
        raise SystemExit(f"checkpoint seed {seed} != --seed {args.seed}; the RNG stream "
                         "is keyed on the seed, resuming would mix streams")


def _say(mesh, *a, **k) -> None:
    if mesh is None or mesh.rank == 0:
        print(*a, **k)


def _render_loop(args, mesh=None) -> int:
    """The render command on one process, or on one rank of `mesh` (every
    rank runs it in step; rank 0 prints and writes)."""
    import numpy as np
    import torch

    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.render.film import checkpoint_load, checkpoint_save, save

    device = mesh.device if mesh is not None else args.device
    scene = load_scene(args.scene, with_bvh=not args.no_bvh, device=device)
    spp_per_pass = args.spp_per_pass or min(args.spp, 16)
    if mesh is not None:
        from mcpt_tpu_torch.parallel.shard import ShardedRenderer

        r = ShardedRenderer(scene, mesh=mesh, max_bounces=args.bounces, spp_per_pass=spp_per_pass,
                            seed=args.seed, width=args.width, height=args.height)
    else:
        from mcpt_tpu_torch.render.renderer import RenderConfig, Renderer

        r = Renderer(scene, RenderConfig(max_bounces=args.bounces, seed=args.seed, spp_per_pass=spp_per_pass,
                                         width=args.width, height=args.height))
    writer = mesh is None or mesh.rank == 0

    if args.resume:
        film, _, sample_idx = checkpoint_load(args.resume, r.scene.device)
        r.film, r.sample_idx = film, sample_idx
        _say(mesh, f"[render] resumed at {sample_idx} spp from {args.resume}")

    prof = None
    if args.profile and writer:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if r.scene.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()

    name = os.path.splitext(os.path.basename(args.scene))[0]
    t0 = time.perf_counter()
    first_frame = True
    while r.sample_idx < args.spp:
        prev_spp = r.sample_idx
        r.step()
        spp = r.sample_idx
        dt = r.pass_times[-1]
        if args.live:
            # the reference's frame loop (src/main.cpp:21-36) in the terminal
            from mcpt_tpu_torch.io.term import live_draw

            film = r.film
            if writer:
                live_draw(film, spp, args.spp, dt * 1e3, first=first_frame)
            first_frame = False
        else:
            _say(mesh, f"[render] {spp}/{args.spp} spp  {dt * 1e3:.1f} ms/pass", flush=True)
        # fire on CROSSING a multiple of N: spp advances in spp_per_pass
        # strides, so `spp % N == 0` would never fire when N is not a
        # multiple of the stride
        crossed = (args.preview_every
                   and spp // args.preview_every > prev_spp // args.preview_every)
        if crossed and spp < args.spp:
            # the reference blits the accumulating film every frame
            # (src/main.cpp:26-36): one preview PNG, overwritten, through
            # the final save's tonemap
            pv = args.preview or f"{name}.preview.png"
            film = r.film
            if writer:
                save(film, pv)
            _say(mesh, f"[render] preview @ {spp} spp -> {pv}")
        if (args.checkpoint_every
                and spp // args.checkpoint_every > prev_spp // args.checkpoint_every):
            ck = args.checkpoint or f"{name}.ckpt.npz"
            film = r.film
            if writer:
                checkpoint_save(film, ck, args.seed, spp)
            _say(mesh, f"[render] checkpoint -> {ck}")
    wall = time.perf_counter() - t0

    if prof is not None:
        if r.scene.device.type == "cuda":
            torch.cuda.synchronize(r.scene.device)
        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"[render] profiler trace -> {os.path.join(args.profile, 'trace.json')}")

    film = r.film
    out = args.out or f"{name}.obj{r.sample_idx}.png"  # reference naming (Scene.cpp:37)
    if not writer:
        return 0
    save(film, out)
    if args.save_radiance:
        spp_col = np.maximum(np.asarray(np.float32(film.spp)), 1.0)[..., None]
        np.savez(args.save_radiance, radiance=film.accum.cpu().numpy() / spp_col)
        print(f"[render] radiance -> {args.save_radiance}")
    rays = float(film.rays)
    stats = {
        "scene": args.scene, "spp": r.sample_idx, "wall_s": round(wall, 3),
        "traced_rays": rays, "mrays_per_s": round(rays / wall / 1e6, 2),
        "nan_scrubbed": int(film.nan_count), "out": out,
    }
    print(json.dumps(stats), flush=True)
    return 0


def _mesh_rank(rank: int, n: int, init: str, backend: str, threads: int, args, nt: int, ns: int) -> None:
    """One rank of `render --mesh`: join the group, build the mesh, render."""
    import torch
    import torch.distributed as dist

    from mcpt_tpu_torch.parallel.mesh import make_mesh, rank_device

    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(args.device, rank))
    dist.init_process_group(backend, init_method=init, world_size=n, rank=rank)
    try:
        _render_loop(args, make_mesh(nt, ns, device=args.device))
    finally:
        dist.destroy_process_group()


def _render_mesh(args) -> int:
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from mcpt_tpu_torch.ops import _build
    from mcpt_tpu_torch.parallel.mesh import backend_for

    nt, ns = _mesh_shape(args.mesh)
    n = nt * ns
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--mesh {args.mesh} on --device cuda needs a CUDA card and none is visible; "
                         "pass --device cpu to run the ranks on the CPU")
    backend = backend_for(args.device, n)
    # build once here, so that no two ranks compile or link one library
    if not args.no_bvh:
        _build.host_library()
    if args.device == "cuda":
        _build.library()
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    print(f"[render] mesh {nt}x{ns}: {n} ranks on {args.device}"
          f"{f' ({cards} card(s))' if cards else ''}, backend {backend}", flush=True)
    store = tempfile.mkdtemp(prefix="mcpt_mesh_")
    try:
        threads = max(1, torch.get_num_threads() // n)
        mp.start_processes(_mesh_rank, args=(n, f"file://{os.path.join(store, 'store')}", backend, threads,
                                             args, nt, ns), nprocs=n, join=True, start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return 0


def cmd_render(args) -> int:
    _check_resume_seed(args)
    if args.mesh:
        return _render_mesh(args)
    return _render_loop(args)


def cmd_inverse(args) -> int:
    import numpy as np
    import torch

    from mcpt_tpu_torch.diff.grad import SceneParams, extract_params
    from mcpt_tpu_torch.diff.inverse import run_inverse
    from mcpt_tpu_torch.io.obj import load_scene

    scene = load_scene(args.scene, with_bvh=not args.no_bvh, device=args.device)
    dev = scene.device
    if args.target.endswith(".npz"):
        with np.load(args.target) as z:
            target = torch.as_tensor(np.asarray(z["radiance"], np.float32), device=dev)
    else:
        from mcpt_tpu_torch.io.image import load_png

        # invert the output tonemap (gamma 1/2, Scene.cpp:26-29); PNGs are
        # stored bottom-up (vertical flip at save), so flip back
        target = torch.as_tensor(np.ascontiguousarray(load_png(args.target)[::-1] ** 2.0), device=dev)
        # a PNG clamps radiance to [0,1] before the gamma curve
        # (Scene.cpp:27), so emission (radiance >> 1) cannot be recovered
        # from it; saturated pixels are the telltale
        sat = float((target >= 0.98).float().mean())
        if sat > 0.001:
            print(
                f"[inverse] WARNING: {sat:.1%} of target pixels are "
                "saturated — the PNG tonemap clamps radiance to [0,1], so "
                "light emission cannot be recovered from this target. "
                "Render the target with --save-radiance (.npz) instead.",
                file=sys.stderr,
            )

    if args.width or args.height:
        cam = dataclasses.replace(scene.camera, width=args.width or scene.camera.width,
                                  height=args.height or scene.camera.height)
        scene = dataclasses.replace(scene, camera=cam)
    H, W = scene.camera.height, scene.camera.width
    if tuple(target.shape) != (H, W, 3):
        raise SystemExit(f"target {tuple(target.shape)} != image {(H, W, 3)}")

    init = extract_params(scene)
    # start: mid-gray albedo; emission from the brightest target pixels
    # (emitters seen in the target carry about their radiance, the bounce-0
    # shortcut, src/Render.cpp:121-122); the vertex field is not optimised
    rad0 = target.reshape(-1, 3).amax(dim=0)
    guess = SceneParams(kd=torch.full_like(init.kd, 0.5), ks=init.ks,
                        radiance=torch.where(init.radiance > 0, rad0[None, :], 0.0))

    # an emitter's albedo is unconstrained by the image (its pixels are
    # dominated by emission and NEE never samples reflection off it with
    # measurable weight), so by default it is frozen and reported
    unconstrained_kd = []
    mask = None
    if not args.optimize_emitter_albedo:
        emissive = init.radiance.cpu().numpy().max(axis=1) > 0
        if emissive.any():
            unconstrained_kd = [int(i) for i in np.nonzero(emissive)[0]]
            keep = torch.as_tensor(~emissive[:, None], dtype=torch.float32, device=dev)
            mask = SceneParams(kd=keep * torch.ones_like(init.kd), ks=torch.ones_like(init.ks),
                               radiance=torch.ones_like(init.radiance))
            print(f"[inverse] freezing kd of emissive material(s) "
                  f"{unconstrained_kd}: unconstrained by the target "
                  "(pass --optimize-emitter-albedo to override)")

    def progress(i, loss, params):
        print(f"[inverse] step {i}  loss {loss:.3e}", flush=True)

    params, losses = run_inverse(
        scene, target, guess, steps=args.steps, spp=args.spp,
        max_bounces=args.bounces, learning_rate=args.lr, seed=args.seed,
        param_mask=mask,
        progress=progress,
        checkpoint_path=args.checkpoint or "inverse.ckpt.npz",
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        radiance_lr=args.radiance_lr or None,  # 0 -> share --lr
    )
    out = args.out or "inverse_params.npz"
    np.savez(out, kd=params.kd.detach().cpu().numpy(), ks=params.ks.detach().cpu().numpy(),
             radiance=params.radiance.detach().cpu().numpy(), losses=np.asarray(losses),
             unconstrained_kd=np.asarray(unconstrained_kd, np.int32))
    print(json.dumps({"final_loss": losses[-1], "steps": len(losses),
                      "unconstrained_kd_materials": unconstrained_kd,
                      "out": out}))
    return 0


def cmd_info(args) -> int:
    from mcpt_tpu_torch.io.obj import load_scene

    scene = load_scene(args.scene, with_bvh=False, device=args.device)
    cam = scene.camera
    info = {
        "scene": args.scene,
        "triangles": scene.num_tris,
        "materials": int(scene.mats.kd.shape[0]),
        "lights": int(scene.light_tris.shape[0]),
        "textures": int(scene.atlas.data.shape[0]) if scene.atlas is not None else 0,
        "camera": {
            "width": cam.width, "height": cam.height, "fovy": float(cam.fovy),
            "eye": [float(x) for x in cam.eye],
            "lookat": [float(x) for x in cam.lookat],
        },
    }
    print(json.dumps(info, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mcpt_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="progressive render -> PNG")
    _add_render_args(pr)
    pr.add_argument("--out", default=None, help="output PNG path")
    pr.add_argument("--mesh", default=None,
                    help="TILESxSPP mesh of ranks, e.g. 2x1 (default: one process)")
    pr.add_argument("--live", action="store_true",
                    help="progressive ANSI preview in the terminal after "
                         "every pass (the reference's GLFW display loop, "
                         "src/main.cpp:21-36, without a display server)")
    pr.add_argument("--preview-every", type=int, default=0,
                    help="write a tonemapped preview PNG every N spp (the "
                         "reference's progressive display, src/main.cpp:26-36)")
    pr.add_argument("--preview", default=None,
                    help="preview PNG path (default <scene>.preview.png)")
    pr.add_argument("--checkpoint", default=None, help="checkpoint path (.npz)")
    pr.add_argument("--checkpoint-every", type=int, default=0,
                    help="write a resumable checkpoint every N spp")
    pr.add_argument("--resume", default=None, help="resume from checkpoint (.npz)")
    pr.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace to DIR/trace.json")
    pr.add_argument("--save-radiance", default=None, metavar="PATH",
                    help="also write the linear mean radiance as .npz "
                         "(unclamped; the sound target for `inverse`)")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("inverse", help="inverse rendering (recover kd/emission)")
    _add_render_args(pi)
    pi.add_argument("--target", required=True, help="target image (.png or .npz)")
    pi.add_argument("--steps", type=int, default=500)
    pi.add_argument("--lr", type=float, default=2e-2)
    pi.add_argument("--radiance-lr", type=float, default=0.2,
                    help="separate Adam rate for emission (radiance lives "
                         "on a ~40x larger scale than reflectance; 0 = "
                         "share --lr)")
    pi.add_argument("--out", default=None, help="output params .npz")
    pi.add_argument("--checkpoint", default=None,
                    help="optimizer-state checkpoint path (.npz, default "
                         "inverse.ckpt.npz)")
    pi.add_argument("--checkpoint-every", type=int, default=0,
                    help="write the full Adam state every N steps")
    pi.add_argument("--resume", default=None,
                    help="resume from an optimizer-state checkpoint")
    pi.add_argument("--optimize-emitter-albedo", action="store_true",
                    help="also optimize the albedo of emissive materials "
                         "(default: frozen + reported as unconstrained — "
                         "an emitter's kd is unidentifiable from the image)")
    pi.set_defaults(fn=cmd_inverse, spp=4, bounces=6)

    pn = sub.add_parser("info", help="print scene statistics")
    pn.add_argument("scene")
    _add_device_arg(pn)
    pn.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
