"""Framebuffer: progressive (sum, spp) accumulator with NaN scrubbing
(reference src/Scene.cpp:12-21)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Film:
    accum: torch.Tensor  # f32[H,W,3] radiance sum
    spp: float  # samples accumulated per pixel
    nan_count: int  # NaN components scrubbed
    rays: float  # traced rays (primary + path + shadow)


def make_film(height: int, width: int, device) -> Film:
    return Film(accum=torch.zeros((height, width, 3), device=device), spp=0.0,
                nan_count=0, rays=0.0)


def accumulate(film: Film, radiance: torch.Tensor, spp_added: float = 1.0,
               rays_added: float = 0.0) -> Film:
    """radiance f32[S,H,W,3] (S sample layers) or [H,W,3]; NaNs count and
    are zeroed."""
    if radiance.dim() == 3:
        radiance = radiance[None]
    nan_mask = torch.isnan(radiance)
    scrubbed = torch.where(nan_mask, torch.zeros_like(radiance), radiance)
    return Film(
        accum=film.accum + scrubbed.sum(dim=0),
        spp=film.spp + spp_added,
        nan_count=film.nan_count + int(nan_mask.sum()),
        rays=film.rays + float(rays_added),
    )


def to_display(film: Film) -> np.ndarray:
    from mcpt_tpu_torch.io.image import tonemap

    return tonemap(film.accum.cpu().numpy(), film.spp)


def save(film: Film, path: str) -> str:
    from mcpt_tpu_torch.io.image import save_png

    return save_png(path, film.accum.cpu().numpy(), film.spp)


def checkpoint_save(film: Film, path: str, seed: int, sample_idx: int) -> None:
    """Write the resumable render state (accum, spp, counters, RNG position).

    The keys, dtypes and shapes are mcpt_tpu's (render/film.py
    checkpoint_save): accum f32[H,W,3], spp f32[], nan_count i32[], rays
    f32[], seed, sample_idx, so a checkpoint of either package resumes in
    the other. The write is atomic (a .tmp file, fsync, os.replace): a
    process killed mid-write leaves the previous checkpoint whole.
    """
    import os

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            accum=film.accum.detach().cpu().numpy().astype(np.float32),
            spp=np.asarray(film.spp, np.float32),
            nan_count=np.asarray(film.nan_count, np.int32),
            rays=np.asarray(film.rays, np.float32),
            seed=seed,
            sample_idx=sample_idx,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_load(path: str, device) -> tuple[Film, int, int]:
    """(film on `device`, seed, sample_idx) of a checkpoint. The film's
    accum is the file's bit for bit; `rays` went through f32 as in
    mcpt_tpu, so only that counter may differ in rounding from the run
    that wrote it."""
    with np.load(path) as z:
        film = Film(
            accum=torch.from_numpy(np.array(z["accum"], np.float32)).to(device),
            spp=float(z["spp"]),
            nan_count=int(z["nan_count"]),
            rays=float(z["rays"]) if "rays" in z else 0.0,
        )
        return film, int(z["seed"]), int(z["sample_idx"])
