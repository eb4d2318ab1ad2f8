"""Task losses + EL2N scoring glue — the port of `repro/core/losses.py`.

For LM-style archs the loss region excludes the prompt/patch prefix
(``n_prefix``); EL2N for a sequence is the mean over next-token positions of
||softmax(logits) - onehot||_2 (the classifier Eq. (2) applied per
position).

The differentiated cross-entropy (`classifier_loss`, `lm_loss`) calls the
plain materialized `kernels/el2n/ref.py::el2n_scores` directly on every
device, as the JAX package hard-codes `impl="ref"` there: the kernel has no
backward. The scoring functions (`classifier_el2n`, `lm_el2n`,
`task_el2n`) go through the op, which launches the CUDA kernel on a CUDA
tensor; they run under `torch.no_grad()` in phase 1b.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.el2n import ref as el2n_ref
from repro_torch.kernels.el2n.ops import el2n_scores


def accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The share of `pred == target` as the JAX package's jitted
    `jnp.mean(... .astype(float32))` computes it on the CPU: the exact
    count times the float32 reciprocal of the size (XLA turns the division
    by a constant into that product)."""
    hits = (pred == target).sum().float()
    return hits * float(np.float32(1.0 / target.numel()))


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            n_prefix: int) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE on the text region. logits (B, T, V); tokens (B, S)."""
    V = logits.shape[-1]
    lg = logits[:, n_prefix:-1, :]                    # predicts tokens[1:]
    tg = tokens[:, 1:]
    _, ce = el2n_ref.el2n_scores(lg.reshape(-1, V), tg.reshape(-1))
    loss = ce.mean()
    acc = accuracy(lg.argmax(-1), tg)
    return loss, {"ce": loss, "acc": acc}


def lm_el2n(logits: torch.Tensor, tokens: torch.Tensor,
            n_prefix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence EL2N score + CE. Returns (el2n (B,), ce (B,))."""
    B, _, V = logits.shape
    lg = logits[:, n_prefix:-1, :]
    tg = tokens[:, 1:]
    n = tg.shape[1]
    el2n, ce = el2n_scores(lg.reshape(-1, V), tg.reshape(-1))
    return el2n.reshape(B, n).mean(-1), ce.reshape(B, n).mean(-1)


def classifier_loss(logits: torch.Tensor,
                    labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """logits (B, C), integer labels (B,)."""
    _, ce = el2n_ref.el2n_scores(logits, labels)
    loss = ce.mean()
    acc = accuracy(logits.argmax(-1), labels)
    return loss, {"ce": loss, "acc": acc}


def classifier_el2n(logits: torch.Tensor, labels: torch.Tensor):
    """SFPrompt Eq. (2) exactly: per-sample ||softmax - onehot||_2."""
    return el2n_scores(logits, labels)


def task_loss(cfg, out: Dict, batch: Dict, *, mtp_weight: float = 0.3):
    """Dispatch on arch type; adds the MoE aux loss and the DeepSeek MTP
    term: plain CE of `mtp_logits[:, :-1]` against `tokens[:, 2:]` (MTP
    predicts token t + 2 from position t), weighted by `mtp_weight`."""
    if cfg.num_classes:
        loss, metrics = classifier_loss(out["logits"], batch["labels"])
    else:
        loss, metrics = lm_loss(out["logits"], batch["tokens"],
                                out.get("n_prefix", 0))
        if "mtp_logits" in out:
            mlg = out["mtp_logits"][:, :-1, :]
            mtg = batch["tokens"][:, 2:]
            V = mlg.shape[-1]
            _, mce = el2n_ref.el2n_scores(mlg.reshape(-1, V),
                                          mtg.reshape(-1))
            metrics["mtp_ce"] = mce.mean()
            loss = loss + mtp_weight * mce.mean()
    loss = loss + out.get("aux", out.get("aux_loss", 0.0))
    metrics["loss"] = loss
    return loss, metrics


def task_el2n(cfg, out: Dict, batch: Dict) -> torch.Tensor:
    if cfg.num_classes:
        return classifier_el2n(out["logits"], batch["labels"])[0]
    return lm_el2n(out["logits"], batch["tokens"], out.get("n_prefix", 0))[0]
