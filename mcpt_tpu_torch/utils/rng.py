"""Counter-based per-sample RNG: threefry2x32 in int64 arithmetic.

Every uniform is a pure function of (seed, pixel, sample id, stream tag,
slot), as in mcpt_tpu/utils/rng.py:

    word = threefry2x32(key, (pixel, (sid*MAX_TAGS + tag)*MAX_SLOTS + slot))

Torch has no uint32 add or shift on the CPU, so 32-bit words are held in
int64 tensors and masked back to 32 bits after every add; the draws equal
`jax.random`'s threefry bit for bit. Stream tags: 0 = camera jitter,
b+1 = bounce b.

The fixed-bounce loop (render/integrator.trace_paths) keys its streams by
a per-sample key instead, folded and split on the host with `fold_in` and
`split`, which equal `jax.random.fold_in` / `jax.random.split` on threefry
keys (with `jax_threefry_partitionable`, JAX's default since 0.5).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MAX_SLOTS = 8  # uniforms per (ray, tag) stream
MAX_TAGS = 64  # streams per (ray, sample)

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """Key words of `jax.random.PRNGKey(seed)` (threefry): (hi, lo) of seed."""
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)`: threefry of the counter pair (0, data)."""
    return threefry2x32(key, 0, data & _MASK)


def split(key: tuple[int, int], n: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, n)`: key i is threefry of the counter pair (0, i)."""
    return [fold_in(key, i) for i in range(n)]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words, or
    on Python ints."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def sample_uniforms(key, pixel_id: torch.Tensor, sid, tag, n: int) -> torch.Tensor:
    """[R, n] uniforms in [0, 1) keyed by (seed, pixel, global sample id, tag).

    `sid` and `tag` are ints or [R] integer tensors (values in uint32 range).
    Same stream as mcpt_tpu.utils.rng.sample_uniforms.
    """
    if n > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} uniforms per stream, got {n}")
    dev = pixel_id.device
    pix = pixel_id.to(torch.int64) & _MASK
    R = pix.shape[0]
    sid = torch.as_tensor(sid, dtype=torch.int64, device=dev)
    tag = torch.as_tensor(tag, dtype=torch.int64, device=dev)
    base = (((sid * MAX_TAGS) & _MASK) + tag) & _MASK
    base = (base * MAX_SLOTS) & _MASK
    npairs = (n + 1) // 2
    slot = torch.arange(npairs, dtype=torch.int64, device=dev)
    lo = (base.reshape(-1, 1).expand(R, 1) + slot[None, :]) & _MASK
    hi = pix[:, None].expand(R, npairs)
    w0, w1 = threefry2x32(key, hi, lo)
    words = torch.cat([w0, w1], dim=1)[:, :n]
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


@dataclass(frozen=True)
class RayRng:
    """Per-batch context of the fixed-bounce loop: a per-sample key and the
    rays' global pixel ids (int64 holding uint32)."""

    key: tuple[int, int]
    ray_id: torch.Tensor


def per_ray_keys(key: tuple[int, int], ray_id: torch.Tensor) -> RayRng:
    """mcpt_tpu.utils.rng.per_ray_keys."""
    return RayRng(key=key, ray_id=ray_id.to(torch.int64) & _MASK)


def ray_uniforms(ctx: RayRng, tag, n: int) -> torch.Tensor:
    """[R, n] uniforms of stream `tag` of each ray: threefry of the counter
    pairs (ray_id, tag*MAX_SLOTS + slot), as mcpt_tpu.utils.rng.ray_uniforms.
    That is sample_uniforms' stream at sample id 0."""
    return sample_uniforms(ctx.key, ctx.ray_id, 0, tag, n)
