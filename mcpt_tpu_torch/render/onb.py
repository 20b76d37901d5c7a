"""Shading-local orthonormal basis (reference src/BSDF.h:9-27).

w = n, a = (0,1,0) if |w.x| > 0.9 else (1,0,0), v = normalize(w x a),
u = w x v. Local z is the shading normal.
"""
from __future__ import annotations

import torch

from mcpt_tpu_torch.utils.math import cross, normalize


def make_onb(n: torch.Tensor):
    """n: f32[...,3] unit normals -> (u, v, w), each f32[...,3]."""
    w = n
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    a = torch.where(torch.abs(w[..., 0:1]) > 0.9, ey, ex)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def to_local(onb, t: torch.Tensor) -> torch.Tensor:
    u, v, w = onb
    return torch.stack(
        [torch.sum(t * u, dim=-1), torch.sum(t * v, dim=-1), torch.sum(t * w, dim=-1)],
        dim=-1,
    )


def to_world(onb, a: torch.Tensor) -> torch.Tensor:
    u, v, w = onb
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w
