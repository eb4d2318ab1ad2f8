"""Phase-3 parameter aggregation (SFPrompt Sec. 3.4, Eq. (3)) — the port of
`repro/core/aggregation.py`.

Sample-count-weighted FedAvg of the tail model and prompt parameters across
the K selected clients. Client trees carry a leading client axis K on
every leaf, as in the JAX package. Hierarchical (edge -> global)
aggregation is slice E; asking for it raises.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def fedavg(client_trees, weights: torch.Tensor, fallback=None):
    """client_trees: tree with leading client axis K on every leaf.
    weights: (K,) sample counts n_k; normalized internally. An all-zero
    weight vector has no defined mean: with `fallback` (a tree without the
    client axis) it is returned, without one this raises."""
    w = torch.as_tensor(weights).float()
    if fallback is not None:
        return fedavg_partial(client_trees, w, fallback)
    total = w.sum()
    if float(total) <= 0:
        raise ValueError(
            "fedavg weights sum to 0 (every client weightless) — the mean "
            "is undefined; pass fallback= to return pre-round params instead")
    w = w / torch.clamp_min(total, 1e-9)

    def mean(x):
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return (wb * x.float()).sum(0).to(x.dtype)

    return tree_map(mean, client_trees)


def fedavg_partial(client_trees, weights: torch.Tensor, fallback):
    """FedAvg over a PARTIALLY participating cohort: clients at weight 0
    are excluded and the mean renormalizes over the survivors. If every
    client dropped, `fallback` (the pre-round globals, no client axis) is
    returned unchanged."""
    w = torch.as_tensor(weights).float()
    total = w.sum()
    safe = torch.clamp_min(total, 1e-9)

    def mean(x, fb):
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        avg = (wb * x.float()).sum(0) / safe.to(x.device)
        return torch.where(total.to(x.device) > 0, avg.to(x.dtype), fb)

    return tree_map(mean, client_trees, fallback)


def broadcast_to_clients(tree, k: int):
    """Replicate aggregated params to K per-client copies (expanded views;
    per-client updates build new tensors, so the copies never alias a
    write)."""
    if k <= 0:
        raise ValueError(
            f"broadcast_to_clients needs a positive cohort size, got k={k}")
    return tree_map(lambda x: x[None].expand((k,) + tuple(x.shape)), tree)


def get_aggregator(secure: bool = False, *, n_edges: int = 0,
                   cohort_size: int = 0, **kw):
    """The phase-3 aggregation path as a pluggable object: clear FedAvg, or
    masked secure aggregation (`secure=True`, options such as `seed=` and
    `frac_bits=` pass through). The hierarchical edge topology waits for
    slice E."""
    if n_edges > 0:
        raise NotImplementedError(
            "hierarchical (edge -> global) aggregation is not ported yet "
            "(slice E)")
    # lazy: the core layer touches the privacy subsystem only when asked
    from repro_torch.privacy.secure_agg import (ClearAggregator,
                                                SecureAggregator)
    if secure:
        return SecureAggregator(**kw)
    if kw:
        raise ValueError(f"clear aggregation takes no options, got {kw}")
    return ClearAggregator()
