"""Baselines the paper compares against (Sec. 4.1) — the port of
`repro/core/baselines.py`.

  FL          — FedAvg full fine-tuning: every client trains the ENTIRE
                model locally for U epochs; all parameters aggregate.
  SFL+FF      — SplitFed [Thapa et al. 2022] with full fine-tuning: client
                parts (head+tail) train per-client, the server body trains
                on the mean gradient across the parallel clients.
  SFL+Linear  — SplitFed, only the final linear (task head) trains.

Every gradient pass is the split route composed segment by segment, as
`SFPromptTrainer._split_loss` composes phase 2: `head_fwd(differentiable=
True)`, the head->body wire, `body_fwd`, the body->tail wire, `tail_fwd`,
`losses.task_loss`. So attention and the cross-entropy run their plain
versions on every device (the JAX baselines' `impl="ref"`), and the int8
wire's quantize/dequantize kernels run on the card, forward and in the
backward codec roundtrip. The wire rounds to nearest (the JAX baselines
pass no wire key). FL has no prompt: a prompt of zero rows, as JAX's.

Python loops over the K clients replace the JAX package's cohort `vmap`s.
In an SFL step every client takes its gradients against the same body,
then the body takes one optimizer step on their mean, summed in XLA's
order (`cohort_mean`). `BaselineConfig` has no `impl` field (the port
dispatches by device), like the port's `ProtocolConfig`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.aggregation import fedavg
from repro_torch.core.local_update import batches, value_and_grad
from repro_torch.core.protocol import xla_sum
from repro_torch.core.split import SplitModel, resolve_device
from repro_torch.optim import apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


@dataclass(frozen=True)
class BaselineConfig:
    local_epochs: int = 10       # U (FL); SFL interacts per batch anyway
    batch_size: int = 16
    lr: float = 1e-2
    momentum: float = 0.9


def cohort_mean(xs: List[torch.Tensor]) -> torch.Tensor:
    """`jnp.mean(stacked, axis=0)` of the K per-client tensors `xs` as XLA
    computes it on the CPU: `xla_sum` times the f32 reciprocal of K (its
    simplifier turns the division by a constant into that product)."""
    return xla_sum(xs, torch.zeros_like(xs[0])) * float(
        np.float32(1.0 / len(xs)))


def split_loss(model: SplitModel, params: Params, batch) -> torch.Tensor:
    """The task loss of `params` over the split route, differentiable in
    every segment: both cut points cross the wire (codec'd forward
    activations and backward gradients, rounded to nearest). The baselines
    train no prompt: it has zero rows, whatever `params` holds."""
    prompt = torch.zeros((0, model.cfg.d_model), dtype=torch.float32,
                         device=tree_leaves(params["head"])[0].device)
    ho = model.head_fwd(params["head"], prompt, batch, mode="train",
                        differentiable=True)
    x, _ = model.wire.head_body.transmit(ho["smashed"], train=True)
    bo = model.body_fwd(params["body"], x, ho)
    x, _ = model.wire.body_tail.transmit(bo["smashed"], train=True)
    to = model.tail_fwd(params["tail"], x, ho, batch)
    out = {"logits": to["logits"], "n_prefix": to.get("n_prefix", 0),
           "aux": ho["aux"] + bo["aux"] + to["aux"]}
    return losses.task_loss(model.cfg, out, batch)[0]


class _Baseline:
    """Shared state handling: a trainer that runs its cohort synchronously
    (no `supports_partial`: the engine ignores the straggler plan)."""

    def __init__(self, model: SplitModel, bcfg: BaselineConfig, *,
                 device="cuda"):
        self.model, self.bcfg = model, bcfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Params:
        return {"params": self.model.init(generator, device=self.device),
                "round": 0}

    def _cohort(self, client_data):
        client_data = tree_map(
            lambda x: torch.as_tensor(x, device=self.device), client_data)
        K, n = tree_leaves(client_data)[0].shape[:2]
        return [tree_map(lambda x: x[k], client_data) for k in range(K)], n

    def round(self, state: Params, client_data) -> Any:
        """One global round on a cohort with leading (K, n, ...) axes
        (numpy arrays or tensors). Returns (state, {"train_loss": float})."""
        state, metrics = self._round(state, client_data)
        return state, {k: float(np.float32(v.item())) for k, v in
                       metrics.items()}


class FLTrainer(_Baseline):
    """FedAvg full fine-tuning (no prompts, no split execution benefit)."""

    def __init__(self, model: SplitModel, bcfg: BaselineConfig, *,
                 device="cuda"):
        super().__init__(model, bcfg, device=device)
        self.opt = sgd(bcfg.lr, momentum=bcfg.momentum)

    def _local(self, trainable, data):
        bcfg = self.bcfg
        opt_state = self.opt.init(trainable)
        bs = batches(data, bcfg.batch_size)
        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(bcfg.local_epochs):
            for batch in bs:
                loss, _, g = value_and_grad(
                    lambda tr, b: (split_loss(self.model, tr, b), None),
                    trainable, batch)
                upd, opt_state = self.opt.update(g, opt_state, trainable)
                trainable = apply_updates(trainable, upd)
                acc = acc + loss
        return trainable, acc / (bcfg.local_epochs * len(bs))

    def _round(self, state, client_data):
        params = state["params"]
        data, n = self._cohort(client_data)
        full = {k: params[k] for k in ("head", "body", "tail")}
        trained, loss = zip(*[self._local(full, d) for d in data])
        K = len(data)
        stacked = tree_map(lambda *xs: torch.stack(xs), *trained)
        agg = fedavg(stacked, torch.full((K,), float(n), device=self.device))
        new = dict(params)
        new.update({k: agg[k] for k in ("head", "body", "tail")})
        return ({"params": new, "round": int(state["round"]) + 1},
                {"train_loss": cohort_mean(list(loss))})


class SFLTrainer(_Baseline):
    """SplitFed [Thapa et al. 2022]. mode='ff' trains head+tail (per-client)
    + body (server, mean gradient); mode='linear' trains only the task head."""

    def __init__(self, model: SplitModel, bcfg: BaselineConfig,
                 mode: str = "ff", *, device="cuda"):
        if mode not in ("ff", "linear"):
            raise ValueError(f"SFL mode must be 'ff' or 'linear', got "
                             f"{mode!r}")
        super().__init__(model, bcfg, device=device)
        self.mode = mode
        self.opt_client = sgd(bcfg.lr, momentum=bcfg.momentum)
        self.opt_server = sgd(bcfg.lr, momentum=bcfg.momentum)

    def _client_trainable(self, params):
        if self.mode == "linear":
            return {"tail": {"head": params["tail"]["head"]}}
        return {"head": params["head"], "tail": params["tail"]}

    def _merge(self, params, client_tr):
        new = dict(params)
        if self.mode == "linear":
            tail = dict(params["tail"])
            tail["head"] = client_tr["tail"]["head"]
            new["tail"] = tail
        else:
            new["head"] = client_tr["head"]
            new["tail"] = client_tr["tail"]
        return new

    def _loss(self, params, body, client_tr, batch):
        merged = self._merge(params, client_tr)
        merged["body"] = body
        return split_loss(self.model, merged, batch)

    def _round(self, state, client_data):
        bcfg = self.bcfg
        params = state["params"]
        data, n = self._cohort(client_data)
        K = len(data)
        client_tr = [self._client_trainable(params) for _ in range(K)]
        client_os = [self.opt_client.init(tr) for tr in client_tr]
        body = params["body"]
        train_body = self.mode == "ff"
        body_os = self.opt_server.init(body) if train_body else None
        per_client = [batches(d, bcfg.batch_size) for d in data]
        nb = len(per_client[0])

        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(bcfg.local_epochs):
            for i in range(nb):
                step_loss, body_grads = [], []
                # every client's gradients against the same body
                for k in range(K):
                    tr = {"client": client_tr[k]}
                    if train_body:
                        tr["body"] = body
                    loss, _, g = value_and_grad(
                        lambda t, b: (self._loss(params, t.get("body", body),
                                                 t["client"], b), None),
                        tr, per_client[k][i])
                    if train_body:
                        body_grads.append(g["body"])
                    upd, client_os[k] = self.opt_client.update(
                        g["client"], client_os[k], client_tr[k])
                    client_tr[k] = apply_updates(client_tr[k], upd)
                    step_loss.append(loss)
                if train_body:
                    # one server step on the mean body gradient
                    gb_mean = tree_map(lambda *gs: cohort_mean(list(gs)),
                                       *body_grads)
                    bupd, body_os = self.opt_server.update(gb_mean, body_os,
                                                           body)
                    body = apply_updates(body, bupd)
                acc = acc + cohort_mean(step_loss)

        stacked = tree_map(lambda *xs: torch.stack(xs), *client_tr)
        agg = fedavg(stacked, torch.full((K,), float(n), device=self.device))
        new = self._merge(params, agg)
        new["body"] = body
        return ({"params": new, "round": int(state["round"]) + 1},
                {"train_loss": acc / (bcfg.local_epochs * nb)})
