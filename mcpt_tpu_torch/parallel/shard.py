"""Sharded progressive rendering over a ('tiles', 'spp') mesh of ranks.

Port of mcpt_tpu/parallel/shard.py onto torch.distributed, one process a
rank (parallel/mesh.py): image rows go to the 'tiles' axis, sample ids to
the 'spp' axis, every rank holds the whole scene, and the collectives are
an all_reduce of the film sums over the rank's spp group and of the NaN
and ray counts over the mesh. The RNG is counter-based per (pixel,
sample), so a tiles-only mesh renders every pixel exactly as one process
does (its film is bitwise the single-process film); on the spp axis the
partial sums of a pixel's samples are added across ranks, a different
summation order.

Rows are INTERLEAVED: tile ti renders image rows ti, ti + nt, ti + 2nt, ...
(contiguous blocks are imbalanced: path length follows image content),
and stores them compactly: storage row ti*rows + k holds image row
k*nt + ti. `ShardedRenderer.film` gathers the tiles into image order
(film_to_image_order); its setter takes an image-order film, e.g. a
checkpoint of any mesh shape or of one process (film_from_image_order).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from mcpt_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, make_mesh
from mcpt_tpu_torch.render.film import Film
from mcpt_tpu_torch.render.integrator import chunk_rays_for, trace_image_wavefront
from mcpt_tpu_torch.scene import Scene, to_device
from mcpt_tpu_torch.utils.rng import prng_key


def _check_shape(height: int, spp_per_pass: int, mesh: Mesh) -> None:
    if height % mesh.n_tiles:
        raise ValueError(f"image height {height} is not divisible by the mesh's {mesh.n_tiles} tiles")
    if spp_per_pass % mesh.n_spp:
        raise ValueError(f"spp_per_pass {spp_per_pass} is not divisible by the mesh's spp axis {mesh.n_spp}")


def film_to_image_order(film: Film, n_tiles: int) -> Film:
    """Storage-order film (storage row t*rows + k holds image row
    k*n_tiles + t) -> image row order."""
    H, W, _ = film.accum.shape
    rows = H // n_tiles
    acc = film.accum.reshape(n_tiles, rows, W, 3).transpose(0, 1)
    return dataclasses.replace(film, accum=acc.reshape(H, W, 3))


def film_from_image_order(film: Film, mesh: Mesh) -> Film:
    """Inverse of film_to_image_order, on the mesh's device: the whole film
    in storage order (a rank keeps rows ti*rows .. (ti+1)*rows of it)."""
    nt = mesh.n_tiles
    H, W, _ = film.accum.shape
    rows = H // nt
    acc = film.accum.to(mesh.device).reshape(rows, nt, W, 3).transpose(0, 1)
    return Film(accum=acc.reshape(H, W, 3).contiguous(), spp=float(film.spp),
                nan_count=int(film.nan_count), rays=float(film.rays))


def _pixel_idx(width: int, height: int, mesh: Mesh) -> torch.Tensor:
    """Pixel ids of this rank's interleaved rows, storage order."""
    nt = mesh.n_tiles
    rows = torch.arange(height // nt, device=mesh.device) * nt + mesh.ti
    return (rows[:, None] * width + torch.arange(width, device=mesh.device)[None, :]).reshape(-1)


def make_film_sharded(scene: Scene, mesh: Mesh) -> Film:
    """This rank's storage rows of an empty film."""
    cam = scene.camera
    return Film(accum=torch.zeros((cam.height // mesh.n_tiles, cam.width, 3), device=mesh.device),
                spp=0.0, nan_count=0, rays=0.0)


def render_pass_sharded(scene: Scene, film: Film, key, start_idx: int, mesh: Mesh, max_bounces: int,
                        spp_per_pass: int) -> Film:
    """Add spp_per_pass samples a pixel to this rank's rows (`film` holds
    them in storage order). Rank (ti, si) renders samples [start_idx +
    si*local_spp, +local_spp) of its rows, in the lanes one process would
    give the whole image (chunk_rays_for); the film sums are all-reduced
    over the spp group, the NaN and ray counts over the mesh. Raises
    ValueError unless H % n_tiles == 0 and spp_per_pass % n_spp == 0."""
    cam = scene.camera
    _check_shape(cam.height, spp_per_pass, mesh)
    local_spp = spp_per_pass // mesh.n_spp
    L, nrays, nan_ct = trace_image_wavefront(
        scene, cam, key, _pixel_idx(cam.width, cam.height, mesh), start_idx + mesh.si * local_spp, local_spp,
        max_bounces, chunk_rays=chunk_rays_for(scene))
    local = L.reshape(cam.height // mesh.n_tiles, cam.width, 3)
    if mesh.n_spp > 1:
        all_reduce(local, mesh, mesh.spp_group)
    counts = all_reduce(torch.stack([nan_ct, nrays]).to(torch.int64), mesh, mesh.group).tolist()
    return Film(accum=film.accum + local, spp=film.spp + spp_per_pass, nan_count=film.nan_count + counts[0],
                rays=film.rays + float(counts[1]))


def _sized(scene: Scene, width: Optional[int], height: Optional[int]) -> Scene:
    if not (width or height):
        return scene
    cam = dataclasses.replace(scene.camera, width=width or scene.camera.width,
                              height=height or scene.camera.height)
    return dataclasses.replace(scene, camera=cam)


def measure_scaling(scene: Scene, mesh: Mesh, max_bounces: int = 4, spp_per_pass: Optional[int] = None,
                    seed: int = 0) -> dict:
    """One sharded pass counted per rank: traced-ray load balance.

    A pass takes as long as its slowest rank, so rays/s scaling efficiency
    on uniform hardware is about the load balance mean(rays a rank) /
    max(rays a rank), less the collectives. On ranks that share a host or a
    card, wall time measures the sharing, so balance is the honest proxy.
    Every rank of the mesh calls it and gets the same dict."""
    cam = scene.camera
    spp_per_pass = spp_per_pass or mesh.n_spp
    _check_shape(cam.height, spp_per_pass, mesh)
    local_spp = spp_per_pass // mesh.n_spp
    _, nrays, _ = trace_image_wavefront(scene, cam, prng_key(seed), _pixel_idx(cam.width, cam.height, mesh),
                                        mesh.si * local_spp, local_spp, max_bounces)
    n_dev = mesh.n_tiles * mesh.n_spp
    counts = all_gather(nrays.to(torch.float64).reshape(1), mesh, mesh.group).reshape(-1).tolist()
    mx = max(counts)
    return {
        "devices": n_dev,
        "rays_per_device": counts,
        "total_rays": float(sum(counts)),
        "balance_efficiency": float(sum(counts) / n_dev / mx) if mx > 0 else 0.0,
    }


def measure_throughput_scaling(scene: Scene, devices=None, counts=(1, 2, 4, 8), max_bounces: int = 4,
                               seed: int = 0, warmup: int = 1, timed: int = 2) -> list:
    """Time one sharded pass at each rank count; report rays/s ratios.

    Row n renders over a (n, 1) tiles mesh of the first n of `devices`
    (world ranks; default all), on the scene's device: `timed` passes after
    `warmup`, Mrays/s, speedup against the first row and parallel
    efficiency. Every world rank calls it (meshes are built collectively);
    each gets the rows, timed on mesh rank 0. Ranks sharing a host or a
    card measure the sharing, not the program."""
    ranks = list(range(dist.get_world_size()) if devices is None else devices)
    rows_out, base = [], None
    for n in counts:
        if n > len(ranks):
            break
        if scene.camera.height % n:
            if dist.get_rank() == ranks[0]:
                print(f"[scaling] skipped {n} ranks: image height {scene.camera.height} % {n} != 0 (pad the "
                      "height or pick a divisible tile count to measure this row)")
            continue
        mesh = make_mesh(n, 1, device=scene.device, ranks=ranks[:n])
        # nccl broadcasts device tensors only
        row = torch.zeros(2, dtype=torch.float64, device=scene.device if dist.get_backend() == "nccl" else "cpu")
        if mesh is not None:
            sr = ShardedRenderer(scene, mesh=mesh, max_bounces=max_bounces, spp_per_pass=1, seed=seed)
            for _ in range(warmup):
                sr.step()
            rays0 = sr._film.rays
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            for _ in range(timed):
                sr.step()
            row[0], row[1] = time.perf_counter() - t0, sr._film.rays - rays0
        # mesh rank 0's row, to every world rank
        dist.broadcast(row, src=ranks[0])
        dt, rays = row.tolist()
        mrps = rays / dt / 1e6 if dt > 0 else 0.0
        if base is None:
            base = mrps
        speedup = mrps / base if base > 0 else 0.0
        rows_out.append({"devices": n, "mrays_per_s": mrps, "speedup": speedup, "efficiency": speedup / n})
    return rows_out


class ShardedRenderer:
    """Progressive renderer over a mesh; the API mirrors render.Renderer.
    Every rank of the mesh constructs it and calls each method in step
    (film, step, render and save are collective)."""

    def __init__(self, scene: Scene, mesh: Optional[Mesh] = None, max_bounces: int = 24,
                 spp_per_pass: Optional[int] = None, seed: int = 0, width: Optional[int] = None,
                 height: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        scene = _sized(scene, width, height)
        if scene.device != self.mesh.device:
            scene = to_device(scene, self.mesh.device)
        self.scene = scene
        self.max_bounces = max_bounces
        self.spp_per_pass = spp_per_pass or self.mesh.n_spp
        _check_shape(scene.camera.height, self.spp_per_pass, self.mesh)
        self.key = prng_key(seed)
        self.sample_idx = 0
        # _film holds this rank's rows in storage order; `film` presents
        # and accepts image order
        self._film = make_film_sharded(scene, self.mesh)
        self.pass_times: list[float] = []

    @property
    def film(self) -> Film:
        """The whole film in image row order, on this rank's device."""
        m = self.mesh
        acc = all_gather(self._film.accum, m, m.tiles_group)
        storage = dataclasses.replace(self._film, accum=acc.reshape(-1, *acc.shape[2:]))
        return film_to_image_order(storage, m.n_tiles)

    @film.setter
    def film(self, value: Film) -> None:
        """Takes an image-order film (a loaded checkpoint, say)."""
        full = film_from_image_order(value, self.mesh)
        rows = full.accum.shape[0] // self.mesh.n_tiles
        self._film = dataclasses.replace(full, accum=full.accum[self.mesh.ti * rows:(self.mesh.ti + 1) * rows]
                                         .clone())

    def step(self) -> Film:
        """One pass on every rank; returns the film in image order."""
        t0 = time.perf_counter()
        self._film = render_pass_sharded(self.scene, self._film, self.key, self.sample_idx, self.mesh,
                                         self.max_bounces, self.spp_per_pass)
        if self._film.accum.is_cuda:
            torch.cuda.synchronize(self._film.accum.device)
        self.pass_times.append(time.perf_counter() - t0)
        self.sample_idx += self.spp_per_pass
        return self.film

    def render(self, spp: int) -> Film:
        while self.sample_idx < spp:
            self.step()
        return self.film

    def save(self, path: str) -> str:
        """Write the PNG from mesh rank 0 (every rank calls it)."""
        from mcpt_tpu_torch.render.film import save

        film = self.film
        if self.mesh.rank == 0:
            save(film, path)
        return path
