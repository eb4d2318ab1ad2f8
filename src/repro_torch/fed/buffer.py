"""Bounded delta buffer + staleness ledger for the async federated runtime
— the port of `repro/fed/buffer.py`.

FedBuff-style buffered aggregation decouples the server's update cadence
from the slowest client: sampled clients stream their (tail, prompt)
contributions as their own simulated clocks finish, the server appends
each arrival to a bounded `DeltaBuffer`, and every `buffer_size` arrivals
the buffer FLUSHES — one staleness-weighted aggregation over exactly the
buffered cohort. The flush is the aggregation unit: it is what the
pluggable aggregators (clear / masked secure) see, what the params wire
stream bills, and what the checkpoint serializes.

Staleness of a contribution is the number of flushes the server applied
between the client's dispatch and its arrival; the weight

    staleness_weight(s) = alpha / (1 + s) ** beta

down-weights stale contributions smoothly (s = 0 => alpha, so with the
default alpha = 1 a zero-staleness flush is weight-identical to the
synchronous round).

Ordering invariant: `stacked()` sorts entries by dispatch order
(dispatch_idx, position-in-group), NOT arrival order, so the flushed
float sum is invariant to how arrivals interleaved — and bit-identical
to the synchronous round when the buffer holds exactly one zero-staleness
dispatch group.

Contributions are the engine's device tensors; the weights and the
ledger stay numpy float64, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.tree import tree_map


def staleness_weight(staleness, *, alpha: float = 1.0,
                     beta: float = 0.5):
    """alpha / (1 + s)^beta — monotonically non-increasing in s for
    beta >= 0, strictly decreasing for beta > 0. Accepts scalars or
    arrays; s must be >= 0 (a contribution cannot arrive before its own
    dispatch)."""
    s = np.asarray(staleness, dtype=np.float64)
    if (s < 0).any():
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    return alpha / np.power(1.0 + s, beta)


@dataclass
class BufferEntry:
    """One streamed client contribution awaiting the next flush."""
    client_id: int
    dispatch_idx: int        # which dispatch group produced it
    position: int            # row within that group's cohort
    version: int             # server version (flush count) at dispatch
    size: int                # true pre-padding sample count (FedAvg n_k)
    keep: int                # post-pruning samples that trained phase 2
    contribution: Any        # (tail, prompt) tree of device tensors
    arrival_t: float = 0.0   # simulated wall clock of the arrival
    dropped: bool = False    # died after upload: weight 0, mask recovery

    def order_key(self):
        return (self.dispatch_idx, self.position)


@dataclass
class DeltaBuffer:
    """Bounded arrival buffer; `full` triggers the engine's flush.

    `tracer` (optional, a repro_torch.obs Tracer) records append/drain as
    step-level events on the SIMULATED clock (each entry's arrival_t) —
    set by the owning engine, never checkpointed."""
    buffer_size: int
    entries: List[BufferEntry] = field(default_factory=list)
    tracer: Any = None

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size}")

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def full(self) -> bool:
        # dropped rows ride along for mask recovery but do not count
        # toward the flush trigger — only genuine arrivals fill the buffer
        return self.n_live >= self.buffer_size

    @property
    def n_live(self) -> int:
        return sum(not e.dropped for e in self.entries)

    def append(self, entry: BufferEntry) -> None:
        self.entries.append(entry)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event_at(
                "buffer.append", entry.arrival_t, level=2,
                client=entry.client_id, group=entry.dispatch_idx,
                version=entry.version, dropped=entry.dropped,
                fill=self.n_live)

    def drain(self) -> List[BufferEntry]:
        """Pop every entry in DISPATCH order (see module docstring)."""
        out = sorted(self.entries, key=BufferEntry.order_key)
        self.entries = []
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("buffer.drain", level=2, n=len(out),
                              n_live=sum(not e.dropped for e in out))
        return out

    @staticmethod
    def stacked(entries: List[BufferEntry]):
        """Stack the drained entries' contributions into one tree with a
        leading cohort axis — the exact layout `fedavg_partial` and the
        secure aggregator consume."""
        if not entries:
            raise ValueError("cannot stack an empty flush cohort")
        return tree_map(lambda *xs: torch.stack(xs),
                        *[e.contribution for e in entries])


class StalenessLedger:
    """Per-run staleness bookkeeping, checkpointed with the engine.

    Tracks how many contributions were applied at each staleness, the
    running staleness sum (for the mean), and each client's last applied
    staleness — part of the byte-identical resume contract (a restored
    run's ledger continues exactly where the killed run's was).
    """

    def __init__(self, n_clients: int):
        self.n_clients = int(n_clients)
        self.applied = 0
        self.staleness_sum = 0.0
        self.max_staleness = 0
        self.last_staleness = np.full((self.n_clients,), -1, dtype=np.int64)

    def record(self, client_id: int, staleness: int) -> None:
        self.applied += 1
        self.staleness_sum += float(staleness)
        self.max_staleness = max(self.max_staleness, int(staleness))
        self.last_staleness[int(client_id)] = int(staleness)

    def mean_staleness(self) -> float:
        return self.staleness_sum / max(1, self.applied)

    # ------------------------------------------------------------- resume
    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"n_clients": np.int64(self.n_clients),
                "applied": np.int64(self.applied),
                "staleness_sum": np.float64(self.staleness_sum),
                "max_staleness": np.int64(self.max_staleness),
                "last_staleness": self.last_staleness.copy()}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        if int(state["n_clients"]) != self.n_clients:
            raise ValueError(
                f"staleness ledger mismatch on resume: checkpoint covers "
                f"{int(state['n_clients'])} clients, engine has "
                f"{self.n_clients}")
        self.applied = int(state["applied"])
        self.staleness_sum = float(state["staleness_sum"])
        self.max_staleness = int(state["max_staleness"])
        self.last_staleness = np.asarray(state["last_staleness"],
                                         dtype=np.int64).copy()


def flush_weights(entries: List[BufferEntry], *, alpha: float,
                  beta: float, version: int) -> np.ndarray:
    """The (B,) aggregation weight vector of one flush cohort:

        w_i = keep_i * size_i * staleness_weight(version - version_i)

    `keep * size` mirrors the synchronous round's weighting exactly (the
    engine folds true sample counts into `aggregate`, the protocol
    multiplies by the post-pruning keep count), so a zero-staleness flush
    at alpha = 1 hands `fedavg_partial` the SAME weight vector as the
    synchronous barrier. Computed in float64, then cast to float32 (that
    cast is what makes the two vectors equal). Dropped rows
    (mask-recovery passengers) are forced to 0."""
    s = np.array([version - e.version for e in entries], dtype=np.float64)
    w = np.array([e.keep * e.size for e in entries], dtype=np.float64)
    w = w * staleness_weight(s, alpha=alpha, beta=beta)
    w[[e.dropped for e in entries]] = 0.0
    return w.astype(np.float32)
