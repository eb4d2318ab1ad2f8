"""RoundScheduler: stragglers, dropouts, and deadline-bounded rounds.

Real federated cohorts are not synchronous: devices differ in compute and
link rate by orders of magnitude (persistent heterogeneity), each round adds
transient jitter, and some devices die mid-round. The scheduler turns a
sampled cohort into a `RoundPlan` the protocol can consume without leaving
its jitted, vmapped K-axis:

  transmit[k]  in [0, 1] — fraction of client k's phase-2 wire traffic that
               actually crossed the boundaries before it finished, dropped,
               or hit the deadline.  The protocol scales measured per-client
               bytes by this, so the TrafficMeter absorbs exactly the
               partial-cohort traffic.
  aggregate[k] >= 0      — client k's inclusion weight in phase-3 FedAvg
               (1 on-time, 0 dropped, `partial_weight` for late clients
               under late_mode="partial" — paper-Table-1 FedAvg corrected
               for partial participation in `core/aggregation.py`).

Latencies come from the same per-round cost model as the Table-1 analysis
(`core/comm.py`): comm at the regime link rate + client compute at the
regime FLOP rate, scaled by a per-client persistent speed factor and
per-round lognormal jitter. `LINK_REGIMES` is the single source of truth
for the regime constants; `benchmarks/latency_model.py` imports it.

Everything is a pure function of (seed, round_idx, cohort) — resumable runs
replay identical plans. RNG domain tags 7 (per-client factors) and 11
(per-round stream) keep these streams disjoint from the sampler's
(tags 3/5 — see fed/sampler.py on SeedSequence trailing-zero dropping).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

# Link-rate / compute regimes (bytes/s, FLOP/s) used across the Table-1
# latency analysis and the straggler simulation.  R is the shared uplink;
# P_C / P_S are client / server compute rates.  NOTE: resume encodes the
# regime as an index into sorted(LINK_REGIMES), so new regimes must sort
# AFTER the existing three (datacenter, edge_wan, fiber) or old
# checkpoints mis-map — "wan" does.
LINK_REGIMES: Dict[str, Dict[str, float]] = {
    "edge_wan": dict(R=12.5e6, P_C=5e12, P_S=500e12),      # 100 Mbps
    "fiber": dict(R=125e6, P_C=5e12, P_S=500e12),          # 1 Gbps
    "datacenter": dict(R=12.5e9, P_C=50e12, P_S=5000e12),
    "wan": dict(R=3.125e6, P_C=5e12, P_S=500e12),          # 25 Mbps consumer
}

LATE_MODES = ("drop", "partial")


@dataclass(frozen=True)
class StragglerConfig:
    regime: str = "fiber"          # key into LINK_REGIMES
    deadline_factor: float = 1.5   # deadline = factor * cohort median latency
    dropout_rate: float = 0.0      # P(device dies mid-round), iid per client
    speed_sigma: float = 0.4       # lognormal sigma of PERSISTENT compute speed
    link_sigma: float = 0.8        # lognormal sigma of PERSISTENT link rate
    #   (links vary more than silicon: the same fleet spans fiber and 3G)
    jitter_sigma: float = 0.15     # lognormal sigma of per-ROUND jitter
    late_mode: str = "drop"        # what happens past the deadline
    partial_weight: float = 0.5    # FedAvg weight of late clients (partial)
    min_survivors: int = 1         # fastest clients forced on-time if needed

    def __post_init__(self):
        if self.regime not in LINK_REGIMES:
            raise ValueError(f"unknown regime {self.regime!r}; expected one "
                             f"of {sorted(LINK_REGIMES)}")
        if self.late_mode not in LATE_MODES:
            raise ValueError(f"unknown late_mode {self.late_mode!r}")


@dataclass
class RoundPlan:
    cohort: np.ndarray       # (K,) client ids
    latency_s: np.ndarray    # (K,) simulated wall time to finish the round
    deadline_s: float
    transmit: np.ndarray     # (K,) float32, fraction of wire bytes sent
    aggregate: np.ndarray    # (K,) float32, FedAvg inclusion weight
    dropped: np.ndarray      # (K,) bool — died mid-round
    late: np.ndarray         # (K,) bool — finished after the deadline

    @property
    def n_active(self) -> int:
        return int((self.aggregate > 0).sum())

    def participation(self) -> Dict[str, np.ndarray]:
        """The two arrays `SFPromptTrainer.round` consumes."""
        return {"transmit": self.transmit.astype(np.float32),
                "aggregate": self.aggregate.astype(np.float32)}


class RoundScheduler:
    """Simulates one deadline-bounded round over a sampled cohort."""

    def __init__(self, cfg: StragglerConfig = StragglerConfig(), *,
                 seed: int = 0,
                 round_bytes_per_client: float = 1e6,
                 round_flops_per_client: float = 1e12):
        self.cfg = cfg
        self.seed = seed
        self.round_bytes = float(round_bytes_per_client)
        self.round_flops = float(round_flops_per_client)

    # ------------------------------------------------------------ latency
    def client_factors(self, client_ids: np.ndarray):
        """Persistent per-client (link_slowdown, compute_slowdown) — median
        1, the same device is slow in every round it is sampled. Link and
        compute draw INDEPENDENTLY, so which devices straggle depends on
        the regime's comm-vs-compute mix: on edge_wan the slow-link devices
        miss deadlines, in a datacenter the slow-compute ones do."""
        link = np.empty(len(client_ids), dtype=np.float64)
        comp = np.empty(len(client_ids), dtype=np.float64)
        for i, cid in enumerate(np.asarray(client_ids, dtype=np.int64)):
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    (self.seed & 0xFFFFFFFF, 7, int(cid))))
            link[i] = np.exp(rng.normal(0.0, self.cfg.link_sigma))
            comp[i] = np.exp(rng.normal(0.0, self.cfg.speed_sigma))
        return link, comp

    def client_latency_parts(self, client_ids: np.ndarray):
        """(wire_s, compute_s) per client BEFORE jitter — the two addends
        of `client_latency`, kept separate so the async runtime can bill
        wire time and client compute time into the TrafficMeter's
        wall-clock overlap streams independently."""
        regime = LINK_REGIMES[self.cfg.regime]
        t_comm = self.round_bytes / regime["R"]
        t_comp = self.round_flops / regime["P_C"]
        link, comp = self.client_factors(client_ids)
        return t_comm * link, t_comp * comp

    def client_latency(self, client_ids: np.ndarray) -> np.ndarray:
        """Expected round latency per client (no jitter): the Table-1 cost
        split — bytes over the regime link rate plus FLOPs over the regime
        client compute — scaled by that client's persistent factors."""
        wire, comp = self.client_latency_parts(client_ids)
        return wire + comp

    # --------------------------------------------------------------- plan
    def plan(self, cohort: Sequence[int], round_idx: int) -> RoundPlan:
        cfg = self.cfg
        cohort = np.asarray(cohort, dtype=np.int64)
        k = len(cohort)
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed & 0xFFFFFFFF, 11, round_idx)))

        jitter = np.exp(rng.normal(0.0, cfg.jitter_sigma, size=k))
        latency = self.client_latency(cohort) * jitter
        deadline = cfg.deadline_factor * float(np.median(latency))

        dropped = rng.random(k) < cfg.dropout_rate
        # a dying device stops at a uniform point of its own round
        died_at = rng.random(k) * latency
        late = (~dropped) & (latency > deadline)

        # min_survivors: force the fastest clients through (re-transmission
        # in a real system; keeps FedAvg well-defined here)
        ok = (~dropped) & (~late)
        need = max(0, min(cfg.min_survivors, k) - int(ok.sum()))
        if need > 0:
            for idx in np.argsort(latency):
                if ok[idx]:
                    continue
                dropped[idx] = late[idx] = False
                ok[idx] = True
                need -= 1
                if need == 0:
                    break

        transmit = np.ones(k)
        aggregate = np.ones(k)
        # dropped: sent the fraction of phase-2 traffic reached when it died
        transmit[dropped] = np.clip(died_at[dropped] / latency[dropped],
                                    0.0, 1.0)
        aggregate[dropped] = 0.0
        if cfg.late_mode == "drop":
            # late clients finished transmitting up to the deadline cut-off
            transmit[late] = np.clip(deadline / latency[late], 0.0, 1.0)
            aggregate[late] = 0.0
        else:
            aggregate[late] = cfg.partial_weight   # sent everything, late
        return RoundPlan(cohort=cohort, latency_s=latency,
                         deadline_s=deadline,
                         transmit=transmit.astype(np.float32),
                         aggregate=aggregate.astype(np.float32),
                         dropped=dropped, late=late)

    # ------------------------------------------------------------- resume
    def state_dict(self) -> Dict[str, float]:
        """Everything a replayed plan depends on. Checkpointed so a resume
        with different straggler flags fails loudly instead of silently
        diverging from the uninterrupted run."""
        cfg = self.cfg
        return {"seed": float(self.seed),
                "regime_id": float(sorted(LINK_REGIMES).index(cfg.regime)),
                "deadline_factor": cfg.deadline_factor,
                "dropout_rate": cfg.dropout_rate,
                "speed_sigma": cfg.speed_sigma,
                "link_sigma": cfg.link_sigma,
                "jitter_sigma": cfg.jitter_sigma,
                "late_mode_id": float(LATE_MODES.index(cfg.late_mode)),
                "partial_weight": cfg.partial_weight,
                "min_survivors": float(cfg.min_survivors),
                "round_bytes": self.round_bytes,
                "round_flops": self.round_flops}

    def load_state_dict(self, state: Dict[str, float]) -> None:
        got = {k: float(np.asarray(v)) for k, v in state.items()}
        want = self.state_dict()
        diff = {k: (got.get(k), want[k]) for k in want
                if got.get(k) != want[k]}
        if diff:
            raise ValueError(
                f"scheduler mismatch on resume: checkpoint vs engine "
                f"differ on {diff} — rebuild the engine with the original "
                f"straggler flags")


class FullParticipationScheduler(RoundScheduler):
    """Every client on time — the seed repo's implicit assumption."""

    def __init__(self, *, seed: int = 0):
        super().__init__(StragglerConfig(dropout_rate=0.0,
                                         deadline_factor=1e9), seed=seed)

    def plan(self, cohort: Sequence[int], round_idx: int) -> RoundPlan:
        cohort = np.asarray(cohort, dtype=np.int64)
        k = len(cohort)
        ones = np.ones(k, dtype=np.float32)
        return RoundPlan(cohort=cohort, latency_s=np.zeros(k),
                         deadline_s=float("inf"), transmit=ones.copy(),
                         aggregate=ones.copy(),
                         dropped=np.zeros(k, dtype=bool),
                         late=np.zeros(k, dtype=bool))
