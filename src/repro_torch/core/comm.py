"""Analytical serving wire bytes — `repro/core/comm.py::serve_comm_breakdown`.

Only this function of the cost model is ported so far: the serving slice
cross-checks its metered bytes against it.
"""
from __future__ import annotations

from typing import Dict


def serve_comm_breakdown(wire, *, d_model: int, soft_prompt_len: int,
                         requests) -> Dict[str, float]:
    """Analytical SERVING wire bytes per boundary for a request trace.

    `requests` is a sequence of (prompt_tokens, new_tokens) pairs. Each
    request crosses each boundary once at prefill with its full
    (prompt + soft prompt) smashed tensor, then once per additional decode
    step with a single token's activation — the first generated token
    comes out of the prefill itself, so a request generating m tokens pays
    m - 1 decode crossings. Byte sizes come from the boundary codec's
    `payload_nbytes` of the REAL payload shapes (per-row int8 scales
    included), making this the exact counterpart of the ServeEngine's
    TrafficMeter. Serving is forward-only: no gradient crossings.
    """
    out: Dict[str, float] = {}
    for b in wire.boundaries:
        total = 0.0
        for prompt_tokens, new_tokens in requests:
            total += b.codec.payload_nbytes(
                (1, prompt_tokens + soft_prompt_len, d_model))
            total += max(0, new_tokens - 1) * b.codec.payload_nbytes(
                (1, 1, d_model))
        out[b.name] = float(total)
    return out
