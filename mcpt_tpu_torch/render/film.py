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
