"""Run a kernel family through its plain versions, to hold the kernel
route's results, gradients included, against the plain route's on the
card bit for bit (chip_smoke.py phases 16-17, tests/test_torch_cuda.py).

    with deterministic(), plain_route(woop, WOOP_PLAIN):
        loss, grads = loss_and_grad(...)
"""
from __future__ import annotations

import contextlib

import torch

# kernel wrapper -> its plain version, for each family on the gradient path
WOOP_PLAIN = {"closest_hit_woop_kernel": "closest_hit_woop_plain", "any_hit_woop_kernel": "any_hit_woop_plain"}
TRAVERSE_PLAIN = {"closest_hit_traverse_kernel": "closest_hit_ordered_plain",
                  "any_hit_traverse_kernel": "any_hit_ordered_plain"}


@contextlib.contextmanager
def plain_route(mod, swaps):
    """Inside the block the module's kernel wrappers run their plain
    versions (swaps: wrapper name -> plain version's name)."""
    saved = {k: getattr(mod, k) for k in swaps}
    for k, v in swaps.items():
        setattr(mod, k, getattr(mod, v))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms: the backward of an index gather
    sums with atomics on the card otherwise, in an order that changes from
    run to run."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
