"""Pinhole camera rays (reference Render::cast_Ray, src/Render.cpp:71-80).

Pixel i maps to (x, y) = (i % W, i // W); row y=0 is the bottom of the
saved image (the save flips vertically).
"""
from __future__ import annotations

import torch

from mcpt_tpu_torch.scene import Camera
from mcpt_tpu_torch.utils.math import PI, cross, normalize


def generate_rays(camera: Camera, jitter: torch.Tensor, pixel_idx: torch.Tensor):
    """jitter f32[R,2] in [0,1), pixel_idx int[R] -> (org [R,3], dir [R,3])."""
    W, H = camera.width, camera.height
    x = (pixel_idx % W).to(torch.float32)
    y = torch.div(pixel_idx, W, rounding_mode="floor").to(torch.float32)

    hfac = torch.tan(camera.fovy * (PI / 180.0) * 0.5) * 2.0
    front = normalize(camera.lookat - camera.eye)
    right = normalize(cross(front, camera.up))

    u = ((x + jitter[:, 0]) / W - 0.5) * hfac * (W / H)
    v = ((y + jitter[:, 1]) / H - 0.5) * hfac
    d = front[None, :] + u[:, None] * right[None, :] + v[:, None] * camera.up[None, :]
    d = normalize(d)
    return camera.eye.expand_as(d), d
