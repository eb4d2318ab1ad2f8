"""Deterministic synthetic serving workload.

Poisson arrivals (exponential inter-arrival gaps in engine-step units),
mixed prompt/output lengths drawn from small choice sets (so the prefill
step compiles once per distinct prompt length, not per request), and a
tenant id per request. The whole trace is a PURE FUNCTION of the seed via
one `np.random.default_rng(seed)` stream — the benchmark suite and the CI
smoke job replay byte-identical workloads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class Request:
    """One serving request: `tokens` is the user prompt; the tenant's soft
    prompt is prepended inside the model. `arrival` is the engine step at
    which the request reaches the queue."""
    rid: int
    tenant: int
    tokens: np.ndarray                 # (L,) int32
    max_new: int                       # tokens to generate (incl. the
    #                                    one the prefill itself yields)
    arrival: int = 0


@dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 16
    mean_interarrival: float = 1.0     # engine steps; Poisson process
    prompt_choices: Tuple[int, ...] = (8, 16, 32)
    new_token_choices: Tuple[int, ...] = (4, 8, 16)
    n_tenants: int = 4
    vocab_size: int = 512
    seed: int = 0


def synthetic_requests(cfg: WorkloadConfig) -> List[Request]:
    """The full request trace, deterministically from cfg.seed."""
    rng = np.random.default_rng(cfg.seed)
    t = 0.0
    out: List[Request] = []
    for rid in range(cfg.n_requests):
        t += rng.exponential(cfg.mean_interarrival)
        length = int(rng.choice(cfg.prompt_choices))
        new = int(rng.choice(cfg.new_token_choices))
        tenant = int(rng.integers(cfg.n_tenants))
        tokens = rng.integers(0, cfg.vocab_size, length).astype(np.int32)
        out.append(Request(rid=rid, tenant=tenant, tokens=tokens,
                           max_new=new, arrival=int(t)))
    return out
