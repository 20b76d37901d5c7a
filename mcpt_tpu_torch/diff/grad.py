"""Differentiable rendering: d(pixels)/d(materials, emission, vertices).

Port of mcpt_tpu/diff/grad.py with torch autograd. The fixed-bounce
estimator (render/integrator.trace_paths) detaches
every sampling decision, so autograd of a render is the detached-random
gradient: the random numbers are frozen, every smooth quantity (hit
points, normals, geometric pdf factors, MIS weights) is differentiated,
and discrete decisions (which triangle a ray hits, visibility, lobe
choice) are held fixed. It misses the visibility-edge terms (diff/edge.py
adds the NEE one).

Parameters: per-material kd, ks, radiance, and `dverts`, a displacement
field over the OBJ's shared vertex buffer [Nv,3] (geom.vert_idx maps each
triangle corner to its shared vertex). Hit selection runs on the scene's
base geometry: the intersection tables (scene.woop, scene.trav, the
treelets) are not rebuilt, which is exact at dverts = 0; an inverse run
that moves vertices rebuilds the scene between steps. The kernels take
detached rays and return only the hit triangle; t, u, v are re-derived
attached from the displaced triangle's row (integrator.make_expander
differentiable=True), so vertex gradients flow on every route.

The RNG is counter-based, so a render is a deterministic function of
(params, key) and finite differences check autograd directly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mcpt_tpu_torch.render.integrator import path_tables, trace_image
from mcpt_tpu_torch.scene import Scene
from mcpt_tpu_torch.utils.math import cross
from mcpt_tpu_torch.utils.rng import fold_in, split

FIELDS = ("kd", "ks", "radiance", "dverts")


@dataclass(frozen=True)
class SceneParams:
    """The differentiable subset of the scene: material table and vertex field."""

    kd: torch.Tensor  # [M,3]
    ks: torch.Tensor  # [M,3]
    radiance: torch.Tensor  # [M,3]
    # displacement over the shared vertex buffer [Nv,3]; None when the
    # scene has no vert_idx mapping
    dverts: Optional[torch.Tensor] = None

    def tensors(self) -> dict:
        """The fields that are set, by name."""
        return {k: getattr(self, k) for k in FIELDS if getattr(self, k) is not None}


def params_from_arrays(d) -> SceneParams:
    """The port's SceneParams from named arrays (numpy or torch), e.g. the
    fields of an mcpt_tpu SceneParams as numpy arrays; a missing or None
    dverts stays None. Tensors land on the CPU as float32."""
    def t(x):
        if x is None:
            return None
        return x.detach().float().clone() if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x, np.float32))

    return SceneParams(kd=t(d["kd"]), ks=t(d["ks"]), radiance=t(d["radiance"]), dverts=t(d.get("dverts")))


def extract_params(scene: Scene) -> SceneParams:
    """The scene's materials, and a zero vertex field when it has shared vertices."""
    dverts = None
    if scene.geom.vert_idx is not None and scene.num_verts > 0:
        dverts = torch.zeros((scene.num_verts, 3), device=scene.device)
    m = scene.mats
    return SceneParams(kd=m.kd, ks=m.ks, radiance=m.radiance, dverts=dverts)


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    """`scene` with the parameters' materials, and with the vertex field
    added to its geometry: v0, e1, e2 and the area (which feeds the NEE
    light pdf) recomputed attached. The intersection tables keep the base
    geometry."""
    mats = dataclasses.replace(scene.mats, kd=params.kd, ks=params.ks, radiance=params.radiance)
    scene = dataclasses.replace(scene, mats=mats)
    g = scene.geom
    if params.dverts is not None and g.vert_idx is not None:
        d = params.dverts[g.vert_idx.long()]  # [T,3,3] per-corner displacement
        e1 = g.e1 + d[:, 1] - d[:, 0]
        e2 = g.e2 + d[:, 2] - d[:, 0]
        n = cross(e1, e2)
        n2 = torch.sum(n * n, dim=-1)
        # double where: sqrt'(0) = inf on a degenerate triangle would make
        # the whole dverts gradient NaN (reference Triangle::area,
        # src/Triangle.cpp:24-28)
        safe = n2 > 0
        area = torch.where(safe, 0.5 * torch.sqrt(torch.where(safe, n2, 1.0)), 0.0)
        scene = dataclasses.replace(scene, geom=dataclasses.replace(g, v0=g.v0 + d[:, 0], e1=e1, e2=e2,
                                                                    area=area))
    return scene


def render_image(params: SceneParams, scene: Scene, key, spp: int, max_bounces: int) -> torch.Tensor:
    """Mean radiance [H,W,3] of `spp` samples a pixel, differentiable in
    `params`. `key` is a (hi, lo) threefry key; sample s uses fold_in(key, s)."""
    sc = apply_params(scene, params)
    cam = sc.camera
    W, H = cam.width, cam.height
    pixel_idx = torch.arange(W * H, device=sc.device)
    acc = torch.zeros((W * H, 3), device=sc.device)
    tables = path_tables(sc)
    for s in range(spp):
        rad = trace_image(sc, cam, fold_in(key, s), pixel_idx, max_bounces, tables)
        # scrub non-finite samples as the film does (Scene.cpp:15-18); a
        # scrubbed lane sends back no gradient
        acc = acc + torch.where(torch.isfinite(rad), rad, 0.0)
    return (acc / spp).reshape(H, W, 3)


def mse_loss(params: SceneParams, scene: Scene, target, key, spp: int, max_bounces: int) -> torch.Tensor:
    return torch.mean((render_image(params, scene, key, spp, max_bounces) - target) ** 2)


def mse_loss_dual(params: SceneParams, scene: Scene, target, key, spp: int, max_bounces: int) -> torch.Tensor:
    """Unbiased MSE surrogate from two independent renders A, B:
    mean((A - t)(B - t)). Plain MSE of a noisy render also differentiates
    the estimator's variance, which at low spp pulls albedo down."""
    ka, kb = split(key)
    a = render_image(params, scene, ka, spp, max_bounces)
    b = render_image(params, scene, kb, spp, max_bounces)
    return torch.mean((a - target) * (b - target))


def value_and_grad(loss_fn, params: SceneParams, *args):
    """(loss, grads) of loss_fn(params, *args): grads is a SceneParams of
    d loss / d field for every field that is set (None where it is not).
    The parameters given are not changed."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.tensors().items()}
    loss = loss_fn(dataclasses.replace(params, **leaves), *args)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), dataclasses.replace(params, **out)


def loss_and_grad(params: SceneParams, scene: Scene, target, key, spp: int, max_bounces: int):
    """(mse_loss, its gradient) at `params`."""
    return value_and_grad(mse_loss, params, scene, target, key, spp, max_bounces)
