"""Batched ray-triangle intersection and its dispatch.

Port of mcpt_tpu/ops/intersect.py. Epsilons follow the reference
(src/Triangle.cpp:48-106):
  * closest hit: |det| < 1e-5 rejects; accept t in [t_min, t_max) with
    u >= 0, v >= 0, 1-u-v >= 0; lowest triangle id on equal t;
  * any hit: |det| < 1e-6 rejects; accept t in [t_min, t_max] with
    u in [0,1], v >= 0, u+v <= 1.

Dispatch by triangle count:
  * T <= DENSE_KERNEL_MIN_TRIS (cornell): the dense torch Moller-Trumbore
    wave below, which is also the oracle for the kernels; in double with
    MCPT_F64_GEOM=1 (f64_geom), at mcpt_tpu's place in the dispatch: after
    the kernel routes, which stay f32;
  * DENSE_KERNEL_MIN_TRIS < T <= BRUTE_FORCE_MAX_TRIS (veach): the
    hand-written Woop kernel pair (ops/woop.py, csrc/woop.cu);
  * T > BRUTE_FORCE_MAX_TRIS (bathroom): the hand-written BVH traversal
    kernel pair (ops/traverse.py, csrc/traverse.cu), which needs the
    scene's BVH; with MCPT_TREELET_SELECT=smem, the superblock-select
    treelet kernel pair instead (ops/select.py, csrc/treelet.cu), which
    needs the scene's treelet layout too. mcpt_tpu reads the same variable
    (mcpt_tpu/ops/pallas/traverse.py TREELET_SELECT); both give the same
    hits.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from mcpt_tpu_torch.scene import Scene
from mcpt_tpu_torch.utils.math import cross, dot

T_MIN = 1e-4  # reference Ray::t1 (src/Render.h:30)
F32_MAX = float(torch.finfo(torch.float32).max)
DET_EPS_CLOSEST = 1e-5
DET_EPS_ANY = 1e-6

DEFAULT_CHUNK = 512  # triangles per dense wave
_RAY_BLOCK = 1 << 14  # rays per dense wave on the CPU, bounds the [R, C] temporaries
# ray-triangle pairs per dense wave on a card: one wave of a 1024x1024
# cornell batch (2^20 rays x 32 triangles, ~2 GiB of temporaries) instead
# of 64, each of ~40 small kernels. Rays are independent, so the wave size
# changes no answer.
_CUDA_WAVE_PAIRS = 1 << 25

BRUTE_FORCE_MAX_TRIS = 4096
DENSE_KERNEL_MIN_TRIS = 256

# Treelet selection of the large-scene route: "vote" (the BVH traversal
# kernels, the default) or "smem" (the select kernels). Read at each call,
# so a test can set the attribute.
TREELET_SELECT = os.environ.get("MCPT_TREELET_SELECT", "vote")
if TREELET_SELECT not in ("vote", "smem"):
    raise ValueError(f"MCPT_TREELET_SELECT={TREELET_SELECT!r} not in ('vote', 'smem')")


@dataclass(frozen=True)
class Hit:
    """Closest-hit record; tri == -1 is a miss. u/v are set by the Woop
    kernel path and None on the dense path (expand_hit recomputes them)."""

    t: torch.Tensor  # f32[R]
    tri: torch.Tensor  # i32[R]
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def f64_geom() -> bool:
    """MCPT_F64_GEOM=1: the dense route intersects in double, as the
    reference traces geometry (src/utils.h:5-18) and as mcpt_tpu's dense
    route does under the same variable. Read at each call."""
    return os.environ.get("MCPT_F64_GEOM") == "1"


def _mt_candidates(v0, e1, e2, org, dirn, det_eps, f64: bool = False):
    """Moller-Trumbore for rays [R,3] x triangles [C,3] -> t, u, v, ok [R,C];
    `f64` evaluates the whole predicate in double."""
    if f64:
        v0, e1, e2, org, dirn = (x.double() for x in (v0, e1, e2, org, dirn))
    o = org[:, None, :]
    d = dirn[:, None, :]
    h = cross(d, e2[None])
    det = dot(e1[None], h)
    s = o - v0[None]
    u = dot(s, h)
    q = cross(s, e1[None])
    v = dot(d, q)
    t = dot(e2[None], q)
    ok = torch.abs(det) >= det_eps
    inv = torch.where(ok, 1.0 / det, 0.0)
    return t * inv, u * inv, v * inv, ok


def _bound(x, R, device, f64: bool = False):
    """A t bound as [R,1]: f32, or with `f64` double (a Python number as
    double, a tensor widened exactly), as mcpt_tpu promotes it under x64."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=torch.float64 if f64 else torch.float32)
    else:
        x = torch.as_tensor(x, dtype=torch.float64 if f64 else torch.float32, device=device)
    return x.expand(R)[:, None] if x.dim() == 0 else x[:, None]


def _pad_chunks(scene: Scene, chunk: int):
    """Geometry in chunks of `chunk` triangles, detached: the dense wave
    selects hits and records no graph through displaced vertices."""
    g = scene.geom
    T = g.v0.shape[0]
    chunk = min(chunk, T)
    n = max(1, -(-T // chunk))
    pad = n * chunk - T

    def p(x):
        return torch.nn.functional.pad(x.detach(), (0, 0, 0, pad)).reshape(n, chunk, 3)

    valid = (torch.arange(n * chunk, device=g.v0.device) < T).reshape(n, chunk)
    return p(g.v0), p(g.e1), p(g.e2), valid, chunk


def _ray_block(device, chunk: int) -> int:
    """Rays per dense wave of `chunk` triangles on `device`."""
    if device.type == "cuda":
        return max(_RAY_BLOCK, _CUDA_WAVE_PAIRS // chunk)
    return _RAY_BLOCK


def closest_hit_bruteforce(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX,
                           chunk: int = DEFAULT_CHUNK, f64: bool = False) -> Hit:
    """Intersect-all closest hit in [rays, chunk] waves. `f64` tests in
    double; each chunk's nearest t is then rounded to f32 before it is
    compared across chunks, as in mcpt_tpu (t f32, tri i32 either way)."""
    R = org.shape[0]
    dev = org.device
    tm_all, tM_all = _bound(t_min, R, dev, f64), _bound(t_max, R, dev, f64)
    v0c, e1c, e2c, validc, chunk = _pad_chunks(scene, chunk)
    best_t = torch.full((R,), F32_MAX, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    block = _ray_block(dev, chunk)
    for r0 in range(0, R, block):
        rs = slice(r0, min(R, r0 + block))
        bt, btri = best_t[rs], best_tri[rs]
        tm, tM = tm_all[rs], tM_all[rs]
        for c in range(v0c.shape[0]):
            t, u, v, ok = _mt_candidates(v0c[c], e1c[c], e2c[c], org[rs], dirn[rs],
                                         DET_EPS_CLOSEST, f64)
            accept = (ok & (t >= tm) & (t < tM) & (u >= 0) & (v >= 0)
                      & (1.0 - u - v >= 0) & validc[c][None, :])
            t_cand = torch.where(accept, t, F32_MAX)
            row_t, row_i = torch.min(t_cand, dim=1)  # first index on ties
            row_t = row_t.float()
            better = row_t < bt
            bt = torch.where(better, row_t, bt)
            btri = torch.where(better, (row_i + c * chunk).to(torch.int32), btri)
        best_t[rs], best_tri[rs] = bt, btri
    return Hit(t=best_t, tri=best_tri)


def any_hit_bruteforce(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX,
                       chunk: int = DEFAULT_CHUNK, f64: bool = False) -> torch.Tensor:
    """Boolean occlusion test (shadow rays), inclusive t interval; `f64`
    tests in double."""
    R = org.shape[0]
    dev = org.device
    tm_all, tM_all = _bound(t_min, R, dev, f64), _bound(t_max, R, dev, f64)
    v0c, e1c, e2c, validc, chunk = _pad_chunks(scene, chunk)
    out = torch.zeros((R,), dtype=torch.bool, device=dev)
    block = _ray_block(dev, chunk)
    for r0 in range(0, R, block):
        rs = slice(r0, min(R, r0 + block))
        tm, tM = tm_all[rs], tM_all[rs]
        for c in range(v0c.shape[0]):
            t, u, v, ok = _mt_candidates(v0c[c], e1c[c], e2c[c], org[rs], dirn[rs],
                                         DET_EPS_ANY, f64)
            accept = (ok & (u >= 0) & (u <= 1.0) & (v >= 0) & (u + v <= 1.0)
                      & (t >= tm) & (t <= tM) & validc[c][None, :])
            out[rs] |= accept.any(dim=1)
    return out


def _woop_tables(v0, e1, e2):
    """Per-triangle Woop map [T,3,4] (the rows of W, each followed by p) and
    1/|n|^2 [T].

    W = [e1 e2 n]^-1 and p = -W v0 carry the triangle to the unit triangle;
    for a ray, o' = W o + p and d' = W d give t = -o'_z/d'_z,
    u = o'_x + t d'_x, v = o'_y + t d'_y, the same accept set as
    Moller-Trumbore. |det| >= eps maps to |d'_z| >= eps/|n|^2 (woop_eps);
    a degenerate triangle has 1/|n|^2 = 0.
    """
    n = cross(e1, e2)
    n2 = torch.sum(n * n, dim=-1)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, n2, 1.0), 0.0)
    r1 = cross(e2, n) * inv[:, None]
    r2 = cross(n, e1) * inv[:, None]
    r3 = n * inv[:, None]
    W = torch.stack([r1, r2, r3], dim=1)  # [T,3,3]
    p = -torch.einsum("tkj,tj->tk", W, v0)
    return torch.cat([W, p[:, :, None]], dim=2), inv


def woop_eps(inv, det_eps):
    """|d'_z| threshold of each triangle; a degenerate one never accepts."""
    return torch.where(inv > 0, det_eps * inv, F32_MAX)


def uses_woop_kernel(scene) -> bool:
    """Does dispatch run the Woop kernel pair for this scene?"""
    return DENSE_KERNEL_MIN_TRIS < scene.num_tris <= BRUTE_FORCE_MAX_TRIS


def uses_traversal_kernel(scene) -> bool:
    """Does dispatch run the BVH traversal kernel pair for this scene?"""
    return scene.num_tris > BRUTE_FORCE_MAX_TRIS


def dispatch_returns_uv(scene) -> bool:
    """Does closest_hit return kernel-computed (u, v)? Then the integrator
    uses the slim shading expansion."""
    return uses_woop_kernel(scene) or uses_traversal_kernel(scene)


def _traversal_set(scene):
    if scene.trav is None:
        raise ValueError(f"{scene.num_tris} triangles: scenes above {BRUTE_FORCE_MAX_TRIS} are "
                         "traversed through their BVH; load them with with_bvh=True")
    return scene.trav


def uses_select_kernel(scene) -> bool:
    """Does dispatch run the select treelet kernel pair for this scene?"""
    return uses_traversal_kernel(scene) and TREELET_SELECT == "smem"


def _detach(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def closest_hit(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX) -> Hit:
    """Closest hit of each ray through the route of this scene's size.

    Hit selection is discrete, so every route takes detached rays and
    bounds (mcpt_tpu wraps them in stop_gradient): under autograd no walk
    or wave records a graph, and the integrator re-derives t, u, v attached
    from the hit triangle's row (render/integrator.expand_hit).
    """
    org, dirn, t_min, t_max = (_detach(x) for x in (org, dirn, t_min, t_max))
    if uses_select_kernel(scene):
        from mcpt_tpu_torch.ops.select import closest_hit_select

        t, tri, u, v = closest_hit_select(scene, org, dirn, t_min, t_max)
        return Hit(t=t, tri=tri, u=u, v=v)
    if uses_traversal_kernel(scene):
        from mcpt_tpu_torch.ops.traverse import closest_hit_traverse

        t, tri, u, v = closest_hit_traverse(_traversal_set(scene), org, dirn, t_min, t_max)
        return Hit(t=t, tri=tri, u=u, v=v)
    if uses_woop_kernel(scene):
        from mcpt_tpu_torch.ops.woop import closest_hit_woop

        t, tri, u, v = closest_hit_woop(scene.woop, org, dirn, t_min, t_max)
        return Hit(t=t, tri=tri, u=u, v=v)
    return closest_hit_bruteforce(scene, org, dirn, t_min, t_max, f64=f64_geom())


def any_hit(scene: Scene, org, dirn, t_min=T_MIN, t_max=F32_MAX) -> torch.Tensor:
    """bool[R] occlusion of each ray in [t_min, t_max]; detached inputs, as
    closest_hit."""
    org, dirn, t_min, t_max = (_detach(x) for x in (org, dirn, t_min, t_max))
    if uses_select_kernel(scene):
        from mcpt_tpu_torch.ops.select import any_hit_select

        return any_hit_select(scene, org, dirn, t_min, t_max)
    if uses_traversal_kernel(scene):
        from mcpt_tpu_torch.ops.traverse import any_hit_traverse

        return any_hit_traverse(_traversal_set(scene), org, dirn, t_min, t_max)
    if uses_woop_kernel(scene):
        from mcpt_tpu_torch.ops.woop import any_hit_woop

        return any_hit_woop(scene.woop, org, dirn, t_min, t_max)
    return any_hit_bruteforce(scene, org, dirn, t_min, t_max, f64=f64_geom())
