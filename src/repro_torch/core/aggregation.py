"""Phase-3 parameter aggregation (SFPrompt Sec. 3.4, Eq. (3)) — the port of
`repro/core/aggregation.py`.

Sample-count-weighted FedAvg of the tail model and prompt parameters across
the K selected clients. Client trees carry a leading client axis K on
every leaf, as in the JAX package. `hierarchical_fedavg` is the two-tier
(edge -> global) form; `get_aggregator(n_edges=E)` builds the
`fed.topology.HierarchicalAggregator` that runs it through per-edge clear
or secure aggregators.
"""
from __future__ import annotations

import numpy as np
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


def hierarchical_fedavg(client_trees, weights: torch.Tensor, fallback,
                        assignment, n_edges: int):
    """Two-tier (edge -> global) weighted FedAvg.

    assignment: (K,) int — the edge each client reports to (from
    `fed.topology.EdgeTopology`). Tier 1 reduces each edge's survivors to a
    per-edge mean (survivor-renormalized exactly like `fedavg_partial`);
    tier 2 FedAvgs the edge means weighted by each edge's surviving weight
    mass W_e. Because sum_e W_e * (S_e / W_e) / sum_e W_e == sum_k w_k x_k
    / sum_k w_k, the result equals the flat weighted mean up to float
    reassociation — an edge whose clients ALL dropped has W_e = 0 and is
    excluded; when every edge drops, `fallback` is returned. The JAX
    package's `segment_sum` is an `index_add_` over the assignment."""
    w = torch.as_tensor(weights).float()
    seg = torch.as_tensor(np.asarray(assignment), dtype=torch.int64)
    w_edge = torch.zeros((n_edges,), dtype=torch.float32,
                         device=w.device).index_add_(0, seg.to(w.device), w)
    total = w_edge.sum()
    safe_e = torch.clamp_min(w_edge, 1e-9)
    safe_t = torch.clamp_min(total, 1e-9)

    def mean(x, fb):
        dev = x.device
        shape = (-1,) + (1,) * (x.dim() - 1)
        wb = w.to(dev).reshape(shape)
        sums = torch.zeros((n_edges,) + tuple(x.shape[1:]),
                           dtype=torch.float32, device=dev).index_add_(
            0, seg.to(dev), wb * x.float())
        edge_means = sums / safe_e.to(dev).reshape(shape)
        we = w_edge.to(dev).reshape(shape)
        avg = (we * edge_means).sum(0) / safe_t.to(dev)
        return torch.where(total.to(dev) > 0, avg.to(x.dtype), fb)

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
    `frac_bits=` pass through). n_edges > 0 -> the hierarchical (edge ->
    global) topology of `fed/topology.py` wrapping per-edge clear or secure
    aggregators; it needs cohort_size (K) to lay out the edges. Imported
    lazily: the core layer touches the privacy and fed subsystems only when
    asked."""
    if n_edges > 0:
        from repro_torch.fed.topology import (EdgeTopology,
                                              HierarchicalAggregator)
        return HierarchicalAggregator(
            EdgeTopology(cohort_size, n_edges), secure=secure, **kw)
    from repro_torch.privacy.secure_agg import (ClearAggregator,
                                                SecureAggregator)
    if secure:
        return SecureAggregator(**kw)
    if kw:
        raise ValueError(f"clear aggregation takes no options, got {kw}")
    return ClearAggregator()
