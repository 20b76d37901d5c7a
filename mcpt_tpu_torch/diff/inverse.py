"""Inverse rendering: recover material albedo and light emission (and,
with a vertex field, geometry) from a target image by Adam on pixel-space
MSE.

Port of mcpt_tpu/diff/inverse.py with torch.optim.Adam in place of optax:
one step renders, takes the gradient of the dual-render MSE
(diff/grad.mse_loss_dual) by autograd, scrubs non-finite gradient entries,
adds opt-in extra gradient terms, masks frozen entries, steps Adam and
clamps the parameters to their physical range.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mcpt_tpu_torch.diff.grad import SceneParams, mse_loss_dual, value_and_grad
from mcpt_tpu_torch.scene import Scene
from mcpt_tpu_torch.utils.rng import fold_in, prng_key

# optax.adam's defaults, which torch.optim.Adam shares
BETAS = (0.9, 0.999)
EPS = 1e-8


@dataclass
class InverseState:
    """Parameters (leaf tensors Adam updates in place), the optimizer that
    holds both moments, the number of steps taken, and the number of
    non-finite gradient entries scrubbed to 0 so far (a 0-d tensor, read
    without a device sync per step)."""

    params: SceneParams
    opt: torch.optim.Adam
    step: int = 0
    scrubbed: torch.Tensor = None


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def make_inverse_step(scene: Scene, target, spp: int = 4, max_bounces: int = 6, learning_rate: float = 2e-2,
                      param_mask: Optional[SceneParams] = None, radiance_lr: Optional[float] = None,
                      extra_grad_fn: Optional[Callable] = None):
    """(init, step_fn) of the Adam loop.

    `param_mask` (0/1 per entry) freezes the entries where it is 0; a mask
    without dverts freezes the whole vertex field. `radiance_lr` gives
    emission an Adam group of its own (emitted radiance lives on a scale
    ~40x reflectance, so one rate cannot cross both distances in 500
    steps); kd, ks and dverts share `learning_rate`. `extra_grad_fn(params,
    key)` returns a SceneParams of gradient terms the detached estimator
    cannot see (diff/edge.make_nee_edge_term), zeros where it adds none.

    init(params) copies the parameters into leaf tensors and builds the
    optimizer; step_fn(state, key) takes one step in place and returns
    (state, loss). Step s uses fold_in(key, s).
    """
    def init(params: SceneParams) -> InverseState:
        leaves = {k: v.detach().clone() for k, v in params.tensors().items()}
        p = dataclasses.replace(params, **leaves)
        if radiance_lr is None:
            groups = [{"params": list(leaves.values())}]
        else:
            groups = [{"params": [v for k, v in leaves.items() if k != "radiance"]},
                      {"params": [leaves["radiance"]], "lr": radiance_lr}]
        return InverseState(params=p, opt=torch.optim.Adam(groups, lr=learning_rate, betas=BETAS, eps=EPS),
                            scrubbed=torch.zeros((), dtype=torch.int64, device=p.kd.device))

    def step_fn(state: InverseState, key):
        k = fold_in(key, state.step)
        loss, grads = value_and_grad(mse_loss_dual, state.params, scene, target, k, spp, max_bounces)
        # gradient hygiene, the loop's analog of the film's NaN scrub
        # (src/Scene.cpp:15-18): one non-finite backward would poison
        # Adam's moments for good
        raw = grads.tensors()
        state.scrubbed = state.scrubbed + sum((~torch.isfinite(x)).sum() for x in raw.values())
        g = {name: _finite(x) for name, x in raw.items()}
        if extra_grad_fn is not None:
            extra = extra_grad_fn(state.params, k)
            for name in g:
                e = getattr(extra, name)
                if e is not None:
                    state.scrubbed = state.scrubbed + (~torch.isfinite(e)).sum()
                    g[name] = g[name] + _finite(e)
        if param_mask is not None:
            for name in g:
                m = getattr(param_mask, name)
                g[name] = g[name] * m if m is not None else torch.zeros_like(g[name])
        with torch.no_grad():
            for name, x in state.params.tensors().items():
                x.grad = g[name]
            state.opt.step()
            state.opt.zero_grad(set_to_none=True)
            # physical constraints: reflectances in [0,1], emission >= 0;
            # dverts unconstrained
            p = state.params
            p.kd.clamp_(0.0, 1.0)
            p.ks.clamp_(0.0, 1.0)
            p.radiance.clamp_(min=0.0)
        state.step += 1
        return state, loss

    return init, step_fn


def checkpoint_save_inverse(state: InverseState, path: str) -> None:
    """Write the whole optimizer state (parameters, both Adam moments of
    every parameter, the step, the scrub count) as a .npz of named arrays,
    atomically: a kill during the write leaves the previous checkpoint
    whole."""
    arrays = {"step": np.asarray(state.step, np.int64), "scrubbed": state.scrubbed.cpu().numpy()}
    for name, x in state.params.tensors().items():
        arrays[f"params.{name}"] = x.detach().cpu().numpy()
        st = state.opt.state.get(x, {})
        if st:
            arrays[f"exp_avg.{name}"] = st["exp_avg"].cpu().numpy()
            arrays[f"exp_avg_sq.{name}"] = st["exp_avg_sq"].cpu().numpy()
            arrays[f"adam_step.{name}"] = st["step"].cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_load_inverse(path: str, template: InverseState) -> InverseState:
    """`template` (a freshly init()ed state for the same parameters and
    groups) with the checkpoint's parameters, moments and step loaded."""
    with np.load(path, allow_pickle=False) as data:
        names = {k.split(".", 1)[1] for k in data.files if k.startswith("params.")}
        have = set(template.params.tensors())
        if names != have:
            raise ValueError(f"checkpoint holds parameters {sorted(names)}, the optimizer {sorted(have)}")
        with torch.no_grad():
            for name, x in template.params.tensors().items():
                x.copy_(torch.from_numpy(data[f"params.{name}"]))
                if f"exp_avg.{name}" in data.files:
                    template.opt.state[x] = {
                        "step": torch.from_numpy(data[f"adam_step.{name}"]),
                        "exp_avg": torch.from_numpy(data[f"exp_avg.{name}"]).to(x.device),
                        "exp_avg_sq": torch.from_numpy(data[f"exp_avg_sq.{name}"]).to(x.device),
                    }
        template.step = int(data["step"])
        template.scrubbed = torch.from_numpy(data["scrubbed"]).to(template.scrubbed.device)
    return template


def run_inverse(scene: Scene, target, init_params: SceneParams, steps: int = 500, spp: int = 4,
                max_bounces: int = 6, learning_rate: float = 2e-2, seed: int = 0,
                param_mask: Optional[SceneParams] = None, progress: Optional[Callable] = None,
                checkpoint_path: Optional[str] = None, checkpoint_every: int = 0, resume: Optional[str] = None,
                radiance_lr: Optional[float] = None, extra_grad_fn: Optional[Callable] = None):
    """The Adam loop: (final params, losses of the steps run).

    `checkpoint_every > 0` writes the whole optimizer state to
    `checkpoint_path` every that many steps; `resume` restarts from such a
    file, so the steps after it equal those of an uninterrupted run.
    """
    init, step_fn = make_inverse_step(scene, target, spp, max_bounces, learning_rate, param_mask,
                                      radiance_lr=radiance_lr, extra_grad_fn=extra_grad_fn)
    state = init(init_params)
    if resume:
        state = checkpoint_load_inverse(resume, state)
    key = prng_key(seed)
    losses = []
    for i in range(state.step, steps):
        state, loss = step_fn(state, key)
        losses.append(float(loss))
        if progress is not None and (i % 25 == 0 or i == steps - 1):
            progress(i, losses[-1], state.params)
        if checkpoint_every and checkpoint_path and (i + 1) % checkpoint_every == 0:
            checkpoint_save_inverse(state, checkpoint_path)
    return state.params, losses


def dryrun_grad_step(scene: Scene, mesh=None, max_bounces: int = 3, learning_rate: float = 1e-2):
    """One sharded render -> gradient -> Adam step over a mesh
    (parallel/mesh.py; None: one process holding the whole image).

    Port of mcpt_tpu/diff/inverse.py dryrun_grad_step: tile ti renders the
    contiguous row block [ti*rows, (ti+1)*rows) with one sample a pixel
    (key 0), its loss is the block's squared radiance over W*H*3 (MSE
    against black), and the loss and the parameter gradients are
    all_reduced (summed) over the whole mesh before one Adam step, as the
    reference's psum over both axes does (spp ranks repeat their tile's
    loss). Every rank gets (loss, gradients, the parameters after the
    step)."""
    from mcpt_tpu_torch.diff.grad import apply_params, extract_params
    from mcpt_tpu_torch.render.integrator import path_tables, trace_image

    cam = scene.camera
    W, H = cam.width, cam.height
    nt, ti = (mesh.n_tiles, mesh.ti) if mesh is not None else (1, 0)
    if H % nt:
        raise ValueError(f"image height {H} is not divisible by the mesh's {nt} tiles")
    rows = H // nt
    key = prng_key(0)
    pixel_idx = ti * rows * W + torch.arange(rows * W, device=scene.device)

    def local_loss(params):
        sc = apply_params(scene, params)
        rad = trace_image(sc, sc.camera, key, pixel_idx, max_bounces, path_tables(sc))
        return torch.sum(rad ** 2) / (W * H * 3)

    loss, grads = value_and_grad(local_loss, extract_params(scene))
    if mesh is not None:
        from mcpt_tpu_torch.parallel.mesh import all_reduce

        for x in (loss, *grads.tensors().values()):
            all_reduce(x, mesh, mesh.group)
    if not float(loss) >= 0.0:
        raise RuntimeError(f"dry-run loss {float(loss)} is not a non-negative number")
    leaves = {k: v.detach().clone() for k, v in extract_params(scene).tensors().items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=learning_rate, betas=BETAS, eps=EPS)
    with torch.no_grad():
        for name, x in leaves.items():
            x.grad = getattr(grads, name).clone()
        opt.step()
    return loss, grads, dataclasses.replace(grads, **leaves)
