"""Counter-based per-sample RNG: threefry2x32 in int64 arithmetic.

Every uniform is a pure function of (seed, pixel, sample id, stream tag,
slot), as in mcpt_tpu/utils/rng.py:

    word = threefry2x32(key, (pixel, (sid*MAX_TAGS + tag)*MAX_SLOTS + slot))

Torch has no uint32 add or shift on the CPU, so 32-bit words are held in
int64 tensors and masked back to 32 bits after every add; the draws equal
`jax.random`'s threefry bit for bit. Stream tags: 0 = camera jitter,
b+1 = bounce b.
"""
from __future__ import annotations

import torch

MAX_SLOTS = 8  # uniforms per (ray, tag) stream
MAX_TAGS = 64  # streams per (ray, sample)

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """Key words of `jax.random.PRNGKey(seed)` (threefry): (hi, lo) of seed."""
    return (seed >> 32) & _MASK, seed & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words."""
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
