"""Functional optimizers on nested dicts of tensors — the port of
`repro/optim/optimizers.py` (optax-style (init, update) pairs).

States are dicts of tensors; the step counter is an int32 0-dim tensor and
the learning rate an f32 0-dim tensor, so every update runs the JAX
package's f32 arithmetic in the same operation order (`p + (-lr * m)`).
Updates build new tensors: nothing is written in place, so a tree handed
to `update` is never changed under its caller.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)


def _step0(params) -> torch.Tensor:
    leaf = tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mom": mom}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
            updates = tree_map(lambda m: -lr_t * m, mom)
            return updates, {"step": step, "mom": mom}
        updates = tree_map(lambda g: -lr_t * g, grads)
        return updates, {"step": step, "mom": None}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                      state["nu"], grads)
        sf = step.float()
        c1 = 1 - torch.pow(torch.tensor(b1, device=sf.device), sf)
        c2 = 1 - torch.pow(torch.tensor(b2, device=sf.device), sf)

        def upd(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return -lr_t * u

        updates = tree_map(upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm
