"""Rank programs for tests/test_torch_parallel.py and the card tests: each
runs in a process spawned by torch.multiprocessing, joins a gloo group
through a file store, runs several mesh checks and saves what it found for
the test process to compare. Imports torch and the port only (no jax), so
that a spawned rank starts quickly.

Scenes: cornell-box (optionally with a NaN in the white albedo, so that
renders scrub NaNs and the mesh has counts to reduce)."""
import dataclasses
import os

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "scenes", "cornell-box.obj")
W = H = 32
BOUNCES = 6
SPP = 2  # spp_per_pass of every mesh render


def cornell(device="cpu", nan_kd=False, width=W, height=H):
    from mcpt_tpu_torch.io.obj import load_scene

    s = load_scene(CORNELL, device=device)
    s = dataclasses.replace(s, camera=dataclasses.replace(s.camera, width=width, height=height))
    if nan_kd:
        kd = s.mats.kd.clone()
        kd[0, 1] = float("nan")  # 'white', green channel
        s = dataclasses.replace(s, mats=dataclasses.replace(s.mats, kd=kd))
    return s


def _join(rank, n, store, device):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=n, rank=rank)
    if device != "cpu":
        torch.cuda.set_device(0)


def _film(r):
    f = r.film
    return {"accum": f.accum.cpu(), "spp": f.spp, "nan_count": f.nan_count, "rays": f.rays}


def two_ranks(rank, n, store, out, device):
    """2 ranks: the 2x1 and 1x2 meshes (one pass of SPP samples, NaN
    albedo), a 2-tile checkpoint resumed on 1 tile, and the dry-run
    gradient step on 2 tiles."""
    from mcpt_tpu_torch.diff.inverse import dryrun_grad_step
    from mcpt_tpu_torch.parallel.mesh import make_mesh
    from mcpt_tpu_torch.parallel.shard import ShardedRenderer
    from mcpt_tpu_torch.render.film import checkpoint_load, checkpoint_save

    _join(rank, n, store, device)
    res = {}
    s = cornell(device, nan_kd=True)
    for nt, ns in ((2, 1), (1, 2)):
        r = ShardedRenderer(s, mesh=make_mesh(nt, ns, device=device), max_bounces=BOUNCES, spp_per_pass=SPP)
        r.step()
        res[f"{nt}x{ns}"] = _film(r)
        if (nt, ns) == (2, 1):
            ck = os.path.join(os.path.dirname(out), "mesh_ck.npz")
            film = r.film
            if rank == 0:
                checkpoint_save(film, ck, 0, r.sample_idx)
            dist.barrier()
    one = make_mesh(1, 1, device=device, ranks=[0])  # every rank builds the groups
    if rank == 0:
        r = ShardedRenderer(s, mesh=one, max_bounces=BOUNCES, spp_per_pass=SPP)
        film, _, idx = checkpoint_load(ck, r.scene.device)
        r.film, r.sample_idx = film, idx
        r.step()
        res["resumed_1x1"] = _film(r)
    small = cornell(device, width=16, height=16)
    loss, grads, params = dryrun_grad_step(small, make_mesh(2, 1, device=device))
    res["dryrun"] = {"loss": loss.cpu(), **{f"g.{k}": v.cpu() for k, v in grads.tensors().items()},
                     **{f"p.{k}": v.cpu() for k, v in params.tensors().items()}}
    torch.save(res, f"{out}.{rank}.pt")
    dist.destroy_process_group()


def four_ranks(rank, n, store, out, device):
    """4 ranks: the 2x2 mesh (one pass of SPP samples, NaN albedo, and one
    of the plain scene for the comparison with mcpt_tpu), measure_scaling
    on it, and measure_throughput_scaling over 1 to 4 ranks (16x16, one
    timed pass a row)."""
    from mcpt_tpu_torch.parallel.mesh import make_mesh
    from mcpt_tpu_torch.parallel.shard import ShardedRenderer, measure_scaling, measure_throughput_scaling

    _join(rank, n, store, device)
    res = {}
    mesh = make_mesh(2, 2, device=device)
    for name, s in (("2x2_nan", cornell(device, nan_kd=True)), ("2x2", cornell(device))):
        r = ShardedRenderer(s, mesh=mesh, max_bounces=BOUNCES, spp_per_pass=SPP)
        r.step()
        res[name] = _film(r)
    res["scaling"] = measure_scaling(cornell(device), mesh, max_bounces=4)
    res["throughput"] = measure_throughput_scaling(cornell(device, width=16, height=16), counts=(1, 2, 3, 4),
                                                   warmup=0, timed=1)
    torch.save(res, f"{out}.{rank}.pt")
    dist.destroy_process_group()


def spawn(fn, n, tmp_path, device="cpu"):
    """Run fn on n spawned ranks; returns each rank's saved results."""
    import torch.multiprocessing as mp

    out = os.path.join(str(tmp_path), fn.__name__)
    mp.start_processes(fn, args=(n, os.path.join(str(tmp_path), "store"), out, device), nprocs=n, join=True,
                       start_method="spawn")
    return [torch.load(f"{out}.{r}.pt") for r in range(n)]


def card_two_ranks(rank, n, store, out, device):
    """2 gloo ranks sharing one card: veach-mis at 64x64, 4 bounces, one
    pass of 2 spp on a 2x1 mesh (the Woop kernels in each rank)."""
    from mcpt_tpu_torch.io.obj import load_scene
    from mcpt_tpu_torch.ops import woop
    from mcpt_tpu_torch.parallel.mesh import make_mesh
    from mcpt_tpu_torch.parallel.shard import ShardedRenderer

    _join(rank, n, store, device)
    s = load_scene(os.path.join(ROOT, "scenes", "veach-mis.obj"), device=device)
    r = ShardedRenderer(s, mesh=make_mesh(2, 1, device=device), max_bounces=4, spp_per_pass=2, width=64,
                        height=64)
    r.step()
    res = {"film": _film(r), "launches": dict(woop.LAUNCHES), "backend": dist.get_backend()}
    torch.save(res, f"{out}.{rank}.pt")
    dist.destroy_process_group()
