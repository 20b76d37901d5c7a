"""Progressive renderer: `Renderer.step` adds `spp_per_pass` samples per pixel.

Port of mcpt_tpu/render/renderer.py's split path: render_pass_chunked runs
each pixel chunk through trace_chunk_split, the host loop that alternates
P (integrator.split_trace: the intersection kernels) and X
(integrator.split_shade) until every lane has finished its samples.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from mcpt_tpu_torch.ops.intersect import F32_MAX
from mcpt_tpu_torch.render.film import Film, make_film
from mcpt_tpu_torch.render.integrator import (
    chunk_rays_for, split_shade, split_state0, split_trace,
)
from mcpt_tpu_torch.scene import Scene
from mcpt_tpu_torch.utils.rng import prng_key

COMPACT_MIN = 16384  # smallest lane count the compaction ladder shrinks to


@dataclass
class RenderConfig:
    max_bounces: int = 24
    seed: int = 0
    spp_per_pass: int = 1
    width: Optional[int] = None  # override the camera's size
    height: Optional[int] = None


def _compact(st: dict, result, pos, pidx, size: int, spp: int):
    """Move the pending lanes into the first `size` slots.

    A lane's samples depend only on (pixel, sample id), so lanes move
    freely. Every lane's L_sum so far lands in `result` at its pixel slot
    `pos`; moved lanes keep accumulating and land again at the end.
    """
    pending = st["alive"] | (st["s"] < spp)
    result[pos] = st["L_sum"]
    idx = torch.argsort((~pending).to(torch.int8), stable=True)[:size]
    small = {k: (v if v.dim() == 0 else v[idx]) for k, v in st.items()}
    return small, pos[idx], pidx[idx]


def trace_chunk_split(scene: Scene, pidx, lane_valid, key, start_idx: int, max_bounces: int,
                      spp_per_pass: int, compact_min: int = COMPACT_MIN):
    """One wavefront chunk through the host loop.

    Returns (L_sum [R,3], nrays, nan_ct, iters). The loop is capped at
    spp*(max_bounces+3)+2 iterations (each iteration a lane advances its
    sample or its bounce, plus one step for a pending NEE) and raises if
    lanes are still pending there. When the pending count fits a 4x, 16x,
    ... smaller size (down to `compact_min`), the live lanes are packed into
    that many lanes, which changes no sample.
    """
    R = int(pidx.shape[0])
    dev = pidx.device
    st = split_state0(R, spp_per_pass, lane_valid, device=dev)
    result = torch.zeros((R, 3), device=dev)
    pos = torch.arange(R, device=dev)
    ladder = []
    s = R
    while s > compact_min:
        s = max(compact_min, -(-(s // 4) // 1024) * 1024 if s // 4 >= 1024 else compact_min)
        ladder.append(s)
    # X0: every lane is dead, so the first shade step only generates rays
    miss_t = torch.full((R,), F32_MAX, device=dev)
    miss_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((R,), device=dev)
    st, n_pend = split_shade(scene, st, miss_t, miss_tri, zeros, zeros,
                             torch.zeros((R,), dtype=torch.bool, device=dev), key, pidx,
                             start_idx, spp_per_pass, max_bounces)
    cur = R
    cap = spp_per_pass * (max_bounces + 3) + 2
    n_live = int(n_pend)
    for _ in range(cap):
        if n_live == 0:
            break
        tgt = None
        for size in ladder:
            if size < cur and n_live <= size:
                tgt = size
        if tgt is not None:
            st, pos, pidx = _compact(st, result, pos, pidx, tgt, spp_per_pass)
            cur = tgt
        hit_t, hit_tri, hit_u, hit_v, occ = split_trace(scene, st["o"], st["d"], st["so"],
                                                        st["sd"], st["smax"])
        st, n_pend = split_shade(scene, st, hit_t, hit_tri, hit_u, hit_v, occ, key, pidx,
                                 start_idx, spp_per_pass, max_bounces)
        n_live = int(n_pend)
    if n_live != 0:
        raise RuntimeError(f"wavefront hit its iteration cap ({cap}) with {n_live} lanes "
                           "pending: max_bounces/spp accounting bug")
    result[pos] = st["L_sum"]
    return result, st["nrays"], st["nan_ct"], st["iters"]


def render_pass_chunked(scene: Scene, film: Film, key, start_idx: int, max_bounces: int,
                        spp_per_pass: int, chunk: Optional[int] = None) -> Film:
    """Add `spp_per_pass` samples per pixel, one wavefront chunk of pixels at a time."""
    cam = scene.camera
    R = cam.width * cam.height
    dev = scene.device
    chunk = chunk or chunk_rays_for(scene)
    n_chunks = -(-R // chunk)
    Rp = n_chunks * chunk
    pidx = torch.cat([torch.arange(R, device=dev), torch.zeros(Rp - R, dtype=torch.int64, device=dev)])
    lane_valid = torch.arange(Rp, device=dev) < R
    parts, nrays, nan_ct = [], 0, 0
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        L, nr, nc, _ = trace_chunk_split(scene, pidx[sl], lane_valid[sl], key, start_idx,
                                         max_bounces, spp_per_pass)
        parts.append(L)
        nrays += int(nr)
        nan_ct += int(nc)
    img = torch.cat(parts)[:R].reshape(cam.height, cam.width, 3)
    return Film(accum=film.accum + img, spp=film.spp + spp_per_pass,
                nan_count=film.nan_count + nan_ct, rays=film.rays + float(nrays))


class Renderer:
    """Build once, call `step()` repeatedly (reference main frame loop,
    src/main.cpp:21-37). Runs on the scene's device."""

    def __init__(self, scene: Scene, config: RenderConfig = None):
        self.config = config or RenderConfig()
        if self.config.width or self.config.height:
            cam = dataclasses.replace(scene.camera,
                                      width=self.config.width or scene.camera.width,
                                      height=self.config.height or scene.camera.height)
            scene = dataclasses.replace(scene, camera=cam)
        self.scene = scene
        self.key = prng_key(self.config.seed)
        self.sample_idx = 0
        self.film = make_film(scene.camera.height, scene.camera.width, scene.device)
        self.pass_times: list[float] = []

    def step(self) -> Film:
        """Render one pass; the time includes the device's work."""
        t0 = time.perf_counter()
        self.film = render_pass_chunked(self.scene, self.film, self.key, self.sample_idx,
                                        self.config.max_bounces, self.config.spp_per_pass)
        if self.film.accum.is_cuda:
            torch.cuda.synchronize(self.film.accum.device)
        self.pass_times.append(time.perf_counter() - t0)
        self.sample_idx += self.config.spp_per_pass
        return self.film

    def render(self, spp: int, progress: Callable = None) -> Film:
        """Render until `spp` samples per pixel are accumulated."""
        while self.sample_idx < spp:
            self.step()
            if progress is not None:
                progress(self)
        return self.film

    def save(self, path: str) -> str:
        from mcpt_tpu_torch.render.film import save

        return save(self.film, path)

    @property
    def stats(self) -> dict:
        """Per-pass metrics; traced rays are counted on the device."""
        n = self.scene.camera.width * self.scene.camera.height
        t = self.pass_times[-1] if self.pass_times else float("nan")
        total_t = sum(self.pass_times)
        return {
            "passes": len(self.pass_times),
            "spp": self.sample_idx,
            "last_pass_s": t,
            "paths_per_s": n * self.config.spp_per_pass / t if t == t else float("nan"),
            "traced_rays": self.film.rays,
            "mrays_per_s": self.film.rays / total_t / 1e6 if total_t > 0 else float("nan"),
            "nan_scrubbed": self.film.nan_count,
        }
