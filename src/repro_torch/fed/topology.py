"""Edge topology for hierarchical (client -> edge -> global) aggregation —
the port of `repro/fed/topology.py`.

A cohort of K clients does not report to one server: clients attach to E
edge aggregators (cell towers, campus gateways), each edge reduces its
own sub-cohort first, and only the E edge means cross the backhaul to the
global server. Per-edge reduction composes with the privacy engine — each
edge runs its OWN masked `SecureAggregator` instance (pairwise masks only
among that edge's clients, so key agreement costs sum(k_e^2) pubkeys
instead of K^2) — and with `fedavg_partial`'s survivor renormalization: an
edge whose clients all dropped contributes weight 0 and is excluded at the
global tier; when every edge drops, the round falls back to the pre-round
globals exactly like the flat path.

Trust boundary: the edge sees its sub-cohort's AGGREGATE (never an
individual client's update under secure aggregation — masks cancel only in
the sum), and the global server sees only edge means. Edge means travel
the backhaul in clear fp32 — the `edge_global` TrafficMeter stream meters
exactly (E + live_edges) * param_bytes per round, the analytical
counterpart being `core.comm.hierarchical_edge_breakdown`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import fedavg_partial
from repro_torch.runtime.boundary import Boundary
from repro_torch.runtime.codec import get_codec
from repro_torch.runtime.meter import EDGE
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


class EdgeTopology:
    """Static position -> edge assignment for a K-cohort.

    Edges are contiguous equal-size blocks of the cohort axis (K % E == 0),
    as in the JAX package, where every per-edge slice must be static under
    jit."""

    def __init__(self, k: int, n_edges: int):
        if k <= 0 or n_edges <= 0:
            raise ValueError(
                f"EdgeTopology needs positive sizes, got K={k}, "
                f"n_edges={n_edges}")
        if n_edges > k:
            raise ValueError(
                f"more edges ({n_edges}) than clients (K={k}) — every edge "
                "needs at least one client")
        if k % n_edges != 0:
            raise ValueError(
                f"K={k} not divisible by n_edges={n_edges}: edges are "
                "contiguous equal blocks so per-edge slices stay static "
                "under jit")
        self.k = k
        self.n_edges = n_edges
        self.edge_size = k // n_edges
        self.assignment = np.repeat(np.arange(n_edges), self.edge_size)

    def members(self, e: int) -> slice:
        """Cohort-position slice of edge e (contiguous by construction)."""
        return slice(e * self.edge_size, (e + 1) * self.edge_size)

    def describe(self) -> str:
        return f"edges={self.n_edges}x{self.edge_size}"


class HierarchicalAggregator:
    """Two-tier aggregation behind the pluggable phase-3 contract.

    Tier 1: each edge reduces its sub-cohort through its own inner
    aggregator (clear `fedavg_partial` or a per-edge `SecureAggregator`
    seeded seed+e so no two edges share a mask stream; on the card each
    secure edge launches the masked-encode kernel once per member, plus
    one recovery launch when a member dropped). Tier 2: the E edge means
    FedAvg with weights W_e = the edge's surviving weight mass —
    algebraically the flat survivor-weighted mean, so the flat and
    hierarchical rounds agree up to float reassociation.

    Wire dict: `params_up` sums the per-edge client uplinks (secure path
    only — the clear path keeps the protocol's seed-exact accounting),
    `secure` sums per-edge key agreement + escrow reveals, and
    `edge_global` meters the backhaul: each LIVE edge uploads its fp32
    mean, and the new globals broadcast down to all E edges. Byte counts
    are float32 scalars summed in the JAX package's order."""

    name = "hierarchical"

    def __init__(self, topology: EdgeTopology, *, secure: bool = False,
                 **kw):
        from repro_torch.privacy.secure_agg import (ClearAggregator,
                                                    SecureAggregator)
        self.topology = topology
        self.secure = secure
        if secure:
            seed = kw.pop("seed", 0)
            self.edge_aggs = [SecureAggregator(seed=seed + e, **kw)
                              for e in range(topology.n_edges)]
        else:
            if kw:
                raise ValueError(
                    f"clear hierarchical aggregation takes no options "
                    f"beyond the topology, got {kw}")
            self.edge_aggs = [ClearAggregator()
                              for _ in range(topology.n_edges)]
        self.edge_boundary = Boundary(EDGE, get_codec("raw"))

    def describe(self) -> str:
        return (f"hier({self.topology.describe()}; "
                f"edge={self.edge_aggs[0].describe()})")

    def aggregate(self, client_trees, weights: torch.Tensor, fallback,
                  round_idx) -> Tuple[Any, Dict[str, np.float32]]:
        topo = self.topology
        k = tree_leaves(client_trees)[0].shape[0]
        if k != topo.k:
            raise ValueError(
                f"cohort of {k} clients under a {topo.describe()} topology "
                f"laid out for K={topo.k}")
        w = torch.as_tensor(weights).float()

        edge_means, edge_weights = [], []
        wire: Dict[str, np.float32] = {}
        for e, agg in enumerate(self.edge_aggs):
            sl = topo.members(e)
            sub = tree_map(lambda x: x[sl], client_trees)
            mean_e, wire_e = agg.aggregate(sub, w[sl], fallback, round_idx)
            edge_means.append(mean_e)
            edge_weights.append(w[sl].sum())
            for name, b in wire_e.items():
                wire[name] = np.float32(wire.get(name, np.float32(0.0)) + b)

        stacked = tree_map(lambda *xs: torch.stack(xs), *edge_means)
        w_edge = torch.stack(edge_weights)
        out = fedavg_partial(stacked, w_edge, fallback)

        # ---- backhaul metering: live edges upload their fp32 mean, the
        # new globals go down to every edge (live or not — an edge must
        # serve next round's cohort either way)
        live = np.float32(int((w_edge > 0).sum()))
        flat_mean = torch.cat([x.reshape(-1).float()
                               for _, x in tree_flatten(edge_means[0])])
        _, b_up_one = self.edge_boundary.transmit(flat_mean[None, :],
                                                  train=False)
        wire[EDGE] = (live + np.float32(topo.n_edges)) * b_up_one
        return out, wire
