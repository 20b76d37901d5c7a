"""Batched vector helpers over the trailing axis (reference: src/utils.h)."""
from __future__ import annotations

import torch

# Matches the reference's float PI literal (src/utils.h:20).
PI = 3.14159265358979323846
INV_PI = 1.0 / PI


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdim=False."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D cross product over the trailing axis."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize over the trailing axis; eps=0 matches glm::normalize."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    return a / torch.sqrt(n2 + eps)


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance (reference BSDF.cpp:167-170)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def power_heuristic(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic, beta=2 (reference src/utils.h:56-60).

    Inputs are clipped to +-1e16 so the squares stay finite in f32, and 0/0
    maps to 0.
    """
    p1 = torch.clamp(p1, -1e16, 1e16)
    p2 = torch.clamp(p2, -1e16, 1e16)
    a = p1 * p1
    denom = a + p2 * p2
    pos = denom > 0
    return torch.where(pos, a / torch.where(pos, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))
