"""Production steps for the launchers and the card — the port of
`repro/launch/steps.py`.

train_step  — SFPrompt steady state: one phase-2 split minibatch per client
              (a loop over the K clients and their microbatches, gradient
              accumulation, frozen head/body, grads only for (tail,
              prompt)) followed by the phase-3 FedAvg with unit weights.
serve_step  — split-inference prefill / decode against the KV cache.

Loss modes:
  'logits' — paper-faithful: materialize logits, CE on top (baseline).
  'fused'  — hidden @ W_head in the activation dtype, then the CE by the
             one-pass softmax identity (`kernels/el2n/ref.py::
             fused_scores`), without the materialized probabilities.

Eager PyTorch has no `jit`, `vmap` or `scan`: the JAX factories'
`remat`, `unroll`, `impl` and `donate_cache` are accepted with the JAX
signatures and mean what each docstring says. `impl` "chunked" and
"analysis" (the dry-run's) run the scans' chunked forms wherever a plain
scan runs (the CPU, differentiated passes), as the JAX ops' do; a `meta`
tensor takes those forms whatever the impl, and a CUDA tensor in a
forward pass launches its kernel whatever the impl. Every other impl
changes nothing: the device picks the path. The split loss runs under
autograd, so its attention, scans and CE run their plain versions on every
device (the kernel wrappers refuse grad), as JAX's gradient runs through
XLA; the prefill and decode steps run under `torch.no_grad()` and launch
the kernels on a CUDA tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.aggregation import broadcast_to_clients, fedavg
from repro_torch.core.local_update import value_and_grad
from repro_torch.core.protocol import xla_sum
from repro_torch.core.split import SplitModel
from repro_torch.kernels.el2n import ref as el2n_ref
from repro_torch.models import layers as L
from repro_torch.optim import Optimizer, apply_updates, sgd
from repro_torch.sharding import parallel
from repro_torch.sharding.rules import client_axes
from repro_torch.tree import tree_leaves, tree_map

ACT_DTYPE = torch.bfloat16

IMPLS = ("auto", "ref", "pallas", "interpret", "chunked", "analysis")


def _check_impl(impl: str) -> bool:
    """Refuse an impl JAX does not know; True where the scans' chunked
    forms are asked for."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl in ("chunked", "analysis")


def _fused_lm_loss(hidden, head_w, tokens, n_prefix, softcap=None):
    """CE without the materialized softmax: contract per position in the
    activation dtype, reduce the statistics in f32 by the one-pass
    identity."""
    lg = hidden[:, n_prefix:-1, :] @ head_w.to(hidden.dtype)
    if softcap:
        lg = softcap * torch.tanh(lg / softcap)
    V = lg.shape[-1]
    _, ce = el2n_ref.fused_scores(lg.reshape(-1, V).float(),
                                  tokens[:, 1:].reshape(-1))
    return ce.mean()


def make_split_loss(model: SplitModel, *, impl="ref", remat=True,
                    loss_mode="logits", unroll=False):
    """Phase-2 loss with both cut points crossing the model's wire
    boundaries (codec'd activations forward, codec'd gradients backward,
    through the codec's autograd roundtrip). Activations run at the
    module's `ACT_DTYPE`, read when the loss is called.

    `split_loss(trainable, frozen, batch, generator=None)`: `generator`
    draws a stochastic codec's rounding noise; None rounds to nearest.

    `impl`: the port picks the path by device and by autograd; this loss
    is differentiated and runs plain, its scans chunked under "chunked"
    and "analysis" (and on `meta`). `remat`: accepted; eager autograd
    keeps the forward activations (no rematerialization). `unroll`:
    accepted; layers already run in a Python loop."""
    chunked = _check_impl(impl)
    if loss_mode not in ("logits", "fused"):
        raise ValueError(f"loss_mode must be 'logits' or 'fused', got "
                         f"{loss_mode!r}")
    cfg = model.cfg

    def split_loss(trainable, frozen, batch, generator=None):
        ho = model.head_fwd(frozen["head"], trainable["prompt"], batch,
                            mode="train", dtype=ACT_DTYPE,
                            differentiable=True, chunked=chunked)
        x_hb, _ = model.wire.head_body.transmit(ho["smashed"],
                                                generator=generator)
        bo = model.body_fwd(frozen["body"], x_hb, ho)
        x_bt, _ = model.wire.body_tail.transmit(bo["smashed"],
                                                generator=generator)
        if loss_mode == "fused" and not cfg.num_classes:
            x, aux_t, _ = model._seg_fwd(trainable["tail"], x_bt,
                                         model._ctx_from(ho), None)
            hidden = L.apply_norm(trainable["tail"]["final_norm"], x,
                                  cfg.norm)
            loss = _fused_lm_loss(hidden, trainable["tail"]["head"]["w"],
                                  batch["tokens"], ho["n_prefix"],
                                  cfg.final_logit_softcap)
            return loss + ho["aux"] + bo["aux"] + aux_t
        to = model.tail_fwd(trainable["tail"], x_bt, ho, batch)
        out = {"logits": to["logits"].float(),
               "n_prefix": to.get("n_prefix", 0),
               "aux": ho["aux"] + bo["aux"] + to["aux"]}
        loss, _ = losses.task_loss(cfg, out, batch)
        return loss

    return split_loss


def _client(tree, k):
    return tree_map(lambda x: None if x is None else x[k], tree)


def _stack(trees):
    return tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs),
                    *trees)


def init_opt_states(opt: Optimizer, trainable_k):
    """The K clients' optimizer states stacked on a leading client axis
    (the JAX package's `jax.vmap(opt.init)(trainable_k)`)."""
    n = tree_leaves(trainable_k)[0].shape[0]
    return _stack([opt.init(_client(trainable_k, k)) for k in range(n)])


def make_train_step(model: SplitModel, *, n_clients: int,
                    microbatches: int = 1, lr: float = 1e-2,
                    impl: str = "ref", loss_mode: str = "logits",
                    remat: bool = True, unroll: bool = False):
    """Returns (train_step, opt). `train_step(frozen, trainable_k,
    opt_state_k, batch_k) -> (trainable_k, opt_state_k, loss)`: every
    `_k` tree carries a leading client axis K (`init_opt_states` builds
    `opt_state_k`). Each client in turn accumulates its microbatches'
    gradients (summed from zero, then divided by `microbatches`) and takes
    one SGD step with momentum 0.9; FedAvg with unit weights then gives
    every client the same (tail, prompt). The frozen segments are one
    shared copy, never K. `impl`, `remat` and `unroll` as in
    `make_split_loss`.

    On a model `on_mesh` with a client plane ('pod', 'data') of P > 1
    ranks, `n_clients` is this rank's block of the cohort: the FedAvg
    mean and the loss are then summed over the plane and divided by P
    (one all-reduce each, as the JAX step's mean over its sharded client
    axis)."""
    opt = sgd(lr, momentum=0.9)
    plane = None if model.mesh is None else client_axes(model.mesh)
    planes = parallel.axis_size(model.mesh, plane) if plane else 1
    split_loss = make_split_loss(model, impl=impl, remat=remat,
                                 loss_mode=loss_mode, unroll=unroll)

    def per_client(frozen, trainable, opt_state, batch):
        b = tree_leaves(batch)[0].shape[0]
        mb = b // microbatches
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(trainable)[0].device)
        g_acc = tree_map(torch.zeros_like, trainable)
        for i in range(microbatches):
            mbatch = tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
            loss, _, g = value_and_grad(
                lambda tr, bch: (split_loss(tr, frozen, bch), None),
                trainable, mbatch)
            loss_acc = loss_acc + loss
            g_acc = tree_map(torch.add, g_acc, g)
        grads = tree_map(lambda g: g / microbatches, g_acc)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        return (apply_updates(trainable, updates), opt_state,
                loss_acc / microbatches)

    def train_step(frozen, trainable_k, opt_state_k, batch_k):
        trs, states, losses_k = [], [], []
        for k in range(n_clients):
            tr, st, loss = per_client(frozen, _client(trainable_k, k),
                                      _client(opt_state_k, k),
                                      _client(batch_k, k))
            trs.append(tr)
            states.append(st)
            losses_k.append(loss)
        # each list is dropped once stacked: at LM widths the tail holds
        # the vocabulary head, one copy of it a client
        trainable_k = _stack(trs)
        del trs
        opt_state_k = _stack(states)
        del states
        # phase-3 aggregation: the protocol's signature collective
        agg = fedavg(trainable_k, torch.ones(n_clients))
        loss = xla_sum(losses_k, torch.zeros_like(losses_k[0])) * float(
            np.float32(1.0 / n_clients))
        if planes > 1:
            # the other ranks' client blocks: the mean of equal blocks'
            # means is the cohort's mean
            agg = tree_map(lambda x: parallel.reduce_sum(
                x.clone(), model.mesh, plane) / planes, agg)
            loss = parallel.reduce_sum(loss.clone(), model.mesh,
                                       plane) / planes
        trainable_k = broadcast_to_clients(agg, n_clients)
        return trainable_k, opt_state_k, loss

    return train_step, opt


def make_prefill_step(model: SplitModel, *, impl: str = "ref",
                      unroll: bool = False, with_wire_bytes: bool = False,
                      dtype=ACT_DTYPE, donate_cache: bool = False):
    """Prefill crosses both wire boundaries once (forward only, under
    `torch.no_grad()`: the kernels launch on a CUDA tensor); with
    `with_wire_bytes` the step also returns the measured per-link bytes.
    `dtype` is the activation dtype (bf16 by default; the logit-parity
    tests run f32). `prefill_step(params, batch, cache) -> (last logits,
    cache[, wire_bytes])`. The cache is written in place and returned, so
    `donate_cache` (the JAX package's buffer donation) is accepted and
    changes nothing; `impl` and `unroll` as in `make_split_loss`."""
    chunked = _check_impl(impl)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        out = model.forward(params, batch, route="split", mode="prefill",
                            cache=cache, dtype=dtype, chunked=chunked)
        if with_wire_bytes:
            return out["logits"][:, -1, :], out["cache"], out["wire_bytes"]
        return out["logits"][:, -1, :], out["cache"]
    return prefill_step


def make_decode_step(model: SplitModel, *, impl: str = "ref",
                     unroll: bool = False, with_wire_bytes: bool = False,
                     dtype=ACT_DTYPE, donate_cache: bool = False):
    """One greedy decode token against the KV cache: `decode_step(params,
    batch, cache) -> (next_tok int32, logits, cache[, wire_bytes])`, with
    `batch = {"tokens": (B, 1), "pos": (B,)}`. The arguments as in
    `make_prefill_step` (the cache is updated in place)."""
    chunked = _check_impl(impl)

    @torch.no_grad()
    def decode_step(params, batch, cache):
        out = model.forward(params, batch, route="split", mode="decode",
                            cache=cache, dtype=dtype, chunked=chunked)
        logits = out["logits"][:, 0, :]
        next_tok = torch.argmax(logits, -1).to(torch.int32)
        if with_wire_bytes:
            return next_tok, logits, out["cache"], out["wire_bytes"]
        return next_tok, logits, out["cache"]
    return decode_step
