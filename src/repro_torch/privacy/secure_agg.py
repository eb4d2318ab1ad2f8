"""Pluggable phase-3 aggregators — the port of the clear path of
`repro/privacy/secure_agg.py`.

The contract the protocol calls:

    aggregate(client_trees, weights, fallback, round_idx)
        -> (aggregated tree, wire bytes dict)

`ClearAggregator` is `fedavg_partial`. `SecureAggregator` (masked uint32
ring aggregation with the `secure_mask` kernel) is slice D.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.aggregation import fedavg_partial


class ClearAggregator:
    """`fedavg_partial` behind the pluggable-aggregator contract. The
    empty wire dict tells the protocol to keep its (K + n_up) *
    param_bytes accounting."""

    name = "clear"

    def describe(self) -> str:
        return "clear"

    def aggregate(self, client_trees, weights: torch.Tensor, fallback,
                  round_idx) -> Tuple[Any, Dict[str, float]]:
        return fedavg_partial(client_trees, weights, fallback), {}
