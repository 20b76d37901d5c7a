"""A ('tiles', 'spp') mesh of torch.distributed ranks, one process a rank.

Port of mcpt_tpu/parallel/mesh.py. The renderer's decomposition:
  * 'tiles': data parallelism over image rows (each rank owns an
    interleaved set of rows, parallel/shard.py); no traffic in the pass;
  * 'spp': sample parallelism (ranks render disjoint sample ids of the
    same pixels; their film sums are all-reduced over the rank's spp group).
The scene is loaded whole on every rank (only rays move).

Rank r of a mesh is tile ti = r // n_spp, spp index si = r % n_spp. The
backend rule (backend_for): NCCL when every rank has a card of its own,
gloo otherwise (ranks on the CPU, or ranks sharing cards). Under gloo a
collective on CUDA tensors goes through host memory explicitly
(all_reduce, all_gather below); nothing switches backend on failure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mcpt_tpu_torch.scene import resolve_device


def backend_for(device, n_ranks: int) -> str:
    """'nccl' when the ranks run on CUDA and the host has a card for each,
    else 'gloo'. Raises (resolve_device) for CUDA without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of world rank `rank`: CUDA card rank % card count (ranks
    share cards when there are fewer), or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (n_tiles, n_spp) mesh, its device and groups."""

    n_tiles: int
    n_spp: int
    ti: int
    si: int
    device: torch.device
    group: object  # every rank of the mesh
    tiles_group: object  # the ranks with this rank's si (n_tiles of them)
    spp_group: object  # the ranks with this rank's ti (n_spp of them)
    backend: str

    @property
    def rank(self) -> int:
        """This rank's index in the mesh (0 prints and writes files)."""
        return self.ti * self.n_spp + self.si


def make_mesh(n_tiles: Optional[int] = None, n_spp: int = 1, device=None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """Build a ('tiles', 'spp') mesh over `ranks` (default: the whole
    world) of the initialised default process group.

    Every world rank must call it, with the same arguments (new_group is
    collective over the world); a rank outside `ranks` gets None. `device`
    names where the ranks run (default CUDA; each rank on card
    rank % cards)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    ranks = tuple(sorted(range(dist.get_world_size()) if ranks is None else ranks))
    n = len(ranks)
    if n_tiles is None:
        n_tiles = n // n_spp
    if n_tiles * n_spp != n:
        raise ValueError(f"mesh {n_tiles}x{n_spp} != {n} ranks")
    me = dist.get_rank()
    group = dist.new_group(list(ranks))
    tiles_groups = [dist.new_group([ranks[t * n_spp + s] for t in range(n_tiles)]) for s in range(n_spp)]
    spp_groups = [dist.new_group([ranks[t * n_spp + s] for s in range(n_spp)]) for t in range(n_tiles)]
    if me not in ranks:
        return None
    i = ranks.index(me)
    ti, si = divmod(i, n_spp)
    return Mesh(n_tiles=n_tiles, n_spp=n_spp, ti=ti, si=si, device=rank_device(device, me), group=group, tiles_group=tiles_groups[si], spp_group=spp_groups[ti],
                backend=dist.get_backend())


def _staged(x: torch.Tensor, mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def all_reduce(x: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """Sum `x` over `group` in place (through host memory under gloo)."""
    if _staged(x, mesh):
        h = x.cpu()
        dist.all_reduce(h, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """[group size, *x.shape]: `x` of every rank of `group`, in group rank
    order (through host memory under gloo)."""
    src = x.cpu() if _staged(x, mesh) else x.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)
