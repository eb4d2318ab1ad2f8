"""Cohort sampling: which K of the N-client population train this round.

Every strategy is a pure function of (seed, round_idx) — there is no hidden
mutable PRNG. That is the property that makes a killed run resumable
byte-identically: the sampler's entire "position" is the integer round
counter the engine checkpoints, and replaying round r after a restart
re-derives exactly the cohort the uninterrupted run would have drawn.

Strategies:
  uniform     — without-replacement uniform draw per round.
  weighted    — without-replacement draw proportional to per-client weights
                (typically the TRUE pre-padding sample counts from the
                Dirichlet partition, so data-rich clients are seen more).
  round_robin — a fixed seed-derived permutation walked K clients at a
                time; every client is visited once per N/K rounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

SAMPLER_KINDS = ("uniform", "weighted", "round_robin")


# RNG domain tags. SeedSequence drops trailing zero entropy words, so a
# bare (seed, round) stream would COLLIDE with the scheduler's
# (seed, 7, cid=0) / (seed, 11, round=0) streams at round 7 / 11 — every
# fed RNG domain therefore gets its own non-zero tag in the SECOND word:
# sampler rounds = 3, round-robin permutation = 5, scheduler client
# factors = 7, scheduler round stream = 11.
_DOMAIN_ROUND = 3
_DOMAIN_PERM = 5


def _round_rng(seed: int, round_idx: int) -> np.random.Generator:
    """Independent stream per (seed, round): SeedSequence hashes the
    tagged tuple, so nearby rounds — and the scheduler's streams — are
    uncorrelated."""
    return np.random.default_rng(
        np.random.SeedSequence((seed & 0xFFFFFFFF, _DOMAIN_ROUND,
                                round_idx)))


@dataclass
class ClientSampler:
    n_clients: int
    k: int
    kind: str = "uniform"
    seed: int = 0
    weights: Optional[np.ndarray] = None   # (N,) for kind="weighted"

    def __post_init__(self):
        if self.kind not in SAMPLER_KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}; "
                             f"expected one of {SAMPLER_KINDS}")
        if self.k > self.n_clients:
            raise ValueError(f"k={self.k} > population {self.n_clients}")
        if self.kind == "weighted":
            if self.weights is None:
                raise ValueError("kind='weighted' needs per-client weights")
            w = np.asarray(self.weights, dtype=np.float64)
            if w.shape != (self.n_clients,) or (w < 0).any() or w.sum() <= 0:
                raise ValueError("weights must be (N,) non-negative with "
                                 "positive sum")
            self.weights = w
        if self.kind == "round_robin":
            # one fixed shuffle of the population; the cursor is derived
            # from round_idx so it needs no state of its own
            self._order = np.random.default_rng(
                np.random.SeedSequence(
                    (self.seed & 0xFFFFFFFF, _DOMAIN_PERM))).permutation(
                    self.n_clients)

    # ----------------------------------------------------------- sampling
    def sample(self, round_idx: int) -> np.ndarray:
        """-> (K,) distinct client ids for this round."""
        if self.kind == "round_robin":
            start = (round_idx * self.k) % self.n_clients
            pos = (start + np.arange(self.k)) % self.n_clients
            return np.asarray(self._order[pos], dtype=np.int64)
        rng = _round_rng(self.seed, round_idx)
        if self.kind == "weighted":
            p = self.weights / self.weights.sum()
            return np.asarray(
                rng.choice(self.n_clients, size=self.k, replace=False, p=p),
                dtype=np.int64)
        return np.asarray(
            rng.choice(self.n_clients, size=self.k, replace=False),
            dtype=np.int64)

    # ------------------------------------------------------------- resume
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Everything needed to re-derive every future draw. The engine
        checkpoints this next to params and meter totals."""
        return {"seed": np.int64(self.seed),
                "n_clients": np.int64(self.n_clients),
                "k": np.int64(self.k),
                "kind_id": np.int64(SAMPLER_KINDS.index(self.kind))}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        got = (int(state["n_clients"]), int(state["k"]),
               SAMPLER_KINDS[int(state["kind_id"])])
        want = (self.n_clients, self.k, self.kind)
        if got != want:
            raise ValueError(
                f"sampler mismatch: checkpoint has (N, K, kind)={got}, "
                f"engine was built with {want}")
        self.seed = int(state["seed"])
        if self.kind == "round_robin":
            self.__post_init__()   # rebuild the seed-derived order
