"""Phase-1 client self-update: local-loss updates (SFPrompt Sec. 3.2,
Eq. (1)) — the port of `repro/core/local_update.py`.

The client connects W_h directly to W_t (body skipped) and runs U local
epochs updating only (W_t, prompt) — the head stays frozen. This phase
costs ZERO server communication.

Functions operate on ONE client; the protocol loops over the cohort. A
Python loop replaces both of the JAX package's `lax.scan`s. Batches are
unshuffled, `x[:nb * bs]`, as there. The pass is differentiated, so its
attention runs the plain version (`differentiable=True`) and its CE the
plain materialized form; gradients reach only the (tail, prompt) leaves
through `torch.autograd.grad`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import losses
from repro_torch.core.split import SplitModel
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_map_with_path)


def local_loss_fn(model: SplitModel, head_p, trainable, batch):
    """L_C(x; (W_h, W_t); p): loss of the head->tail local model."""
    tail_p, prompt = trainable["tail"], trainable["prompt"]
    ho = model.head_fwd(head_p, prompt, batch, mode="train",
                        differentiable=True)
    to = model.tail_fwd(tail_p, ho["smashed"], ho, batch)
    out = {"logits": to["logits"], "n_prefix": to.get("n_prefix", 0),
           "aux": ho["aux"] + to["aux"]}
    return losses.task_loss(model.cfg, out, batch)


def value_and_grad(loss_fn, trainable, *args):
    """(loss, aux, grads) of `loss_fn(trainable, *args) -> (loss, aux)`
    with respect to every leaf of `trainable` (a dict tree); a leaf the
    loss does not depend on gets zeros."""
    leaves = tree_leaves(trainable)
    with torch.enable_grad():
        live = [x.detach().requires_grad_(True) for x in leaves]
        it = iter(live)
        tr = tree_map(lambda _: next(it), trainable)
        loss, aux = loss_fn(tr, *args)
        # a leaf the loss never reads (zamba2's shared-attention position
        # placeholder) gets a zero gradient, as `jax.grad` gives it
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            live, torch.autograd.grad(loss, live, allow_unused=True))]
    it = iter(grads)
    return loss.detach(), aux, tree_map(lambda _: next(it), trainable)


def batches(data: Dict[str, torch.Tensor], batch_size: int):
    """The full batches of `data` in order: x[:nb * bs] in nb slices
    (at least one, as in the JAX package)."""
    n = tree_leaves(data)[0].shape[0]
    nb = max(1, n // batch_size)
    return [tree_map(lambda x: x[i * batch_size:(i + 1) * batch_size], data)
            for i in range(nb)]


def local_epochs(model: SplitModel, head_p, trainable, opt: Optimizer,
                 opt_state, data: Dict[str, torch.Tensor], *,
                 batch_size: int, n_epochs: int):
    """U epochs of local-loss SGD over one client's full dataset.
    Returns (trainable, opt_state, mean_loss)."""
    bs = batches(data, batch_size)
    acc = torch.zeros((), dtype=torch.float32,
                      device=tree_leaves(trainable)[0].device)
    for _ in range(n_epochs):
        for batch in bs:
            loss, _, grads = value_and_grad(
                lambda tr, b: local_loss_fn(model, head_p, tr, b),
                trainable, batch)
            updates, opt_state = opt.update(grads, opt_state, trainable)
            trainable = apply_updates(trainable, updates)
            acc = acc + loss
    return trainable, opt_state, acc / (n_epochs * len(bs))


def dp_clip_and_noise(trainable, reference,
                      noise: Callable[[Tuple[str, ...], Tuple[int, ...]],
                                      torch.Tensor], *,
                      l2_clip: float, noise_multiplier: float):
    """DP-SGD on ONE client's round update (the protocol loops over the
    cohort, like everything above).

    The privatized quantity is the client's DELTA against the broadcast
    pre-round globals. Scale the delta to global L2 norm <= l2_clip, add
    N(0, (noise_multiplier * l2_clip)^2) per coordinate, and rebuild the
    params the client uploads. `noise(leaf_path, shape)` gives the unit
    normals of each leaf, called in `jax.tree` order (the protocol's
    default draws them from a per-(round, client) generator; tests hand
    in the JAX package's own draws). Returns (privatized trainable,
    pre-clip delta norm for diagnostics)."""
    # lazy like aggregation.get_aggregator: the core layer only touches
    # the privacy subsystem when the DP path is actually taken
    from repro_torch.privacy.dp import clip_tree
    delta = tree_map(lambda a, b: a.float() - b.float(), trainable,
                     reference)
    delta, norm = clip_tree(delta, l2_clip)
    stddev = noise_multiplier * l2_clip
    deltas = dict(tree_flatten(delta))
    draws = {path: stddev * noise(path, tuple(d.shape)).to(d.device)
             for path, d in deltas.items()}
    return tree_map_with_path(
        lambda p, ref: (ref.float() + deltas[p] + draws[p]).to(ref.dtype),
        reference), norm
