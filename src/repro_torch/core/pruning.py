"""Phase-1 local dataset pruning via EL2N (SFPrompt Sec. 3.2, Eq. (2)) —
the port of `repro/core/pruning.py`.

The client links W_h -> W_t (the body is skipped — no server traffic),
scores every local sample with the error-vector L2 norm, and keeps the
highest-scoring (1 - gamma) fraction. Only surviving samples ever produce
smashed-data traffic in phase 2.

As in the JAX package, the text's "retain the examples with higher EL2N
scores" is followed (not the Algorithm 1 box, which would keep the lowest).

Scoring is forward-only and runs under `torch.no_grad()`, so on the card it
launches the kernels: the prefill attention of every layer and the EL2N
kernel per batch. This matches the JAX round's scoring with
`ProtocolConfig(impl="auto")`, not with its default `impl="ref"`, which
scores through plain code on every backend: the scores then differ from
the JAX default round's by kernel rounding (about 1e-5), enough to move a
sample whose score ties the cut. On the CPU the port scores plain, as the default
JAX round does. Ranking uses a STABLE descending sort
(`argsort(-scores, stable=True)`), as `jnp.argsort` is stable: EL2N scores
clamped to zero tie, and the kept set must not depend on the sort.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import losses
from repro_torch.core.split import SplitModel
from repro_torch.tree import tree_leaves, tree_map


def pruned_keep_count(n_local: int, prune_gamma: float,
                      batch_size: int) -> int:
    """How many of a client's `n_local` samples survive phase-1 pruning
    AND actually train in phase 2: max(batch_size, n - floor(gamma * n))
    rounded DOWN to a batch multiple (phase 2 consumes full batches only).
    One definition for the protocol and the analytical cost model."""
    keep = max(batch_size, n_local - int(prune_gamma * n_local))
    return keep - keep % batch_size


@torch.no_grad()
def score_client_data(model: SplitModel, head_p, tail_p, prompt,
                      data: Dict[str, torch.Tensor], *,
                      batch_size: int) -> torch.Tensor:
    """EL2N score for EVERY sample of one client's dataset (n, ...).
    Runs the LOCAL route (head -> tail), batched. When n is not a multiple
    of batch_size the final batch is padded by wrapping to the dataset's
    start and the padding's scores are dropped, so all n samples are
    ranked."""
    n = tree_leaves(data)[0].shape[0]
    nb = -(-n // batch_size)            # ceil: the last batch may be padded
    if nb * batch_size != n:
        idx = torch.arange(nb * batch_size,
                           device=tree_leaves(data)[0].device) % n
        data = tree_map(lambda x: x[idx], data)
    scores = []
    for i in range(nb):
        batch = tree_map(lambda x: x[i * batch_size:(i + 1) * batch_size],
                         data)
        ho = model.head_fwd(head_p, prompt, batch, mode="train")
        to = model.tail_fwd(tail_p, ho["smashed"], ho, batch)
        out = {"logits": to["logits"], "n_prefix": to.get("n_prefix", 0)}
        scores.append(losses.task_el2n(model.cfg, out, batch))
    return torch.cat(scores)[:n]


def rank_descending(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Indices that sort `scores` high to low, ties in index order."""
    return torch.argsort(-scores, dim=dim, stable=True)


def prune_indices(scores: torch.Tensor, gamma: float) -> torch.Tensor:
    """Indices of the kept subset (static size): top (1-gamma) by EL2N."""
    n = scores.shape[0]
    keep = max(1, n - int(gamma * n))
    return rank_descending(scores)[:keep]


def prune_client_data(data: Dict[str, torch.Tensor], scores: torch.Tensor,
                      gamma: float) -> Tuple[Dict[str, torch.Tensor], int]:
    idx = prune_indices(scores, gamma)
    return tree_map(lambda x: x[idx], data), idx.shape[0]
