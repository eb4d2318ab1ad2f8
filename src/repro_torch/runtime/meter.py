"""TrafficMeter: measured bytes per boundary per round.

Byte counts originate in `Boundary.transmit` as traced f32 scalars (from
the actual payload shapes that crossed the wire) and ride through the
protocol's jit/scan carries; `absorb()` folds a round's counters into
host-side Python floats, and `report()`/`as_dict()` pretty-print them —
benchmarks/comm_cost.py compares them against the analytical model.

Under partial participation (fed.RoundScheduler) a round's counters are
already straggler-scaled by the protocol; `absorb(counts, clients=k)`
additionally records how many clients actually aggregated, so
`per_client_round()` normalizes by ACTIVE client-rounds, not by cohort
size — the honest per-device cost under dropouts.

The meter is part of the resumable run state: `state_dict()` /
`load_state_dict()` round-trip its totals exactly (floats, no re-metering),
so a killed-and-restarted run reports the same cumulative traffic as an
uninterrupted one.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

from repro_torch.runtime.boundary import BOUNDARY_NAMES

PARAMS = "params"       # phase-3 (tail, prompt) up+down traffic
SECURE = "secure"       # secure-agg key agreement + escrow-reveal traffic
EDGE = "edge_global"    # hierarchical tier-2: edge-mean up + global down
MB = 2 ** 20

# wall-clock overlap streams (simulated seconds, not bytes): how much
# server aggregation work, client compute, and wire time the run
# accumulated vs the simulated span it all fit into.  Under a synchronous
# barrier span ~= sum of per-round maxima; under the async buffered
# runtime client/wire time OVERLAPS, so their sums exceed the span — the
# overlap() ratios make that win measurable (analytical twin:
# core/comm.py async_vs_sync_round_time).
WALL_STREAMS = ("server_busy_s", "client_compute_s", "wire_s", "span_s")


class TrafficMeter:
    def __init__(self,
                 names: Iterable[str] = BOUNDARY_NAMES + (PARAMS, SECURE,
                                                          EDGE)):
        self.names = tuple(names)
        self.totals: Dict[str, float] = {n: 0.0 for n in self.names}
        self.rounds = 0
        self.client_rounds = 0.0   # sum over rounds of active clients
        self.wall: Dict[str, float] = {n: 0.0 for n in WALL_STREAMS}
        # flight-recorder hook (repro_torch.obs): when attached, every absorb
        # emits a `meter.absorb` event carrying the SAME host floats it
        # adds to `totals`, so a trace's per-stream event sums equal the
        # meter totals float-exactly (tools/trace_check.py enforces it).
        # None (the default) keeps the meter observation-free.
        self.tracer = None

    def attach_tracer(self, tracer) -> None:
        self.tracer = tracer if (tracer is not None
                                 and tracer.enabled) else None

    def absorb(self, counts: Mapping[str, float], *,
               clients: Optional[float] = None) -> None:
        """Fold one round's counters (traced scalars or floats) in.
        `clients`: how many clients' traffic the round actually carried
        (active cohort under dropouts); defaults to unknown -> 0 added."""
        folded: Dict[str, float] = {}
        for name, v in counts.items():
            if name in self.totals:
                fv = float(v)
                self.totals[name] += fv
                folded[name] = fv
        self.rounds += 1
        if clients is not None:
            self.client_rounds += float(clients)
        if self.tracer is not None:
            self.tracer.event("meter.absorb", round=self.rounds, **folded)

    def absorb_wall(self, *, server_busy_s: float = 0.0,
                    client_compute_s: float = 0.0, wire_s: float = 0.0,
                    span_s: float = 0.0) -> None:
        """Fold simulated wall-clock increments in. `span_s` is the
        advance of the run's single simulated clock; the other three are
        work sums that may legitimately exceed it (overlap)."""
        self.wall["server_busy_s"] += float(server_busy_s)
        self.wall["client_compute_s"] += float(client_compute_s)
        self.wall["wire_s"] += float(wire_s)
        self.wall["span_s"] += float(span_s)
        if self.tracer is not None:
            self.tracer.event("meter.wall", level=2,
                              server_busy_s=float(server_busy_s),
                              client_compute_s=float(client_compute_s),
                              wire_s=float(wire_s), span_s=float(span_s))

    def overlap(self) -> Dict[str, float]:
        """Wall-clock utilization ratios: work-seconds per span-second
        for each stream, plus their sum (`parallelism` — 1.0 means the
        run was fully serial, > 1 means client compute and wire time
        overlapped across clients / with the server)."""
        span = max(self.wall["span_s"], 1e-12)
        out = {k: v / span for k, v in self.wall.items() if k != "span_s"}
        out["parallelism"] = sum(out.values())
        return out

    def total_bytes(self) -> float:
        return sum(self.totals.values())

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals, total=self.total_bytes())

    def per_round(self) -> Dict[str, float]:
        r = max(1, self.rounds)
        return {n: v / r for n, v in self.as_dict().items()}

    def per_client_round(self) -> Dict[str, float]:
        """Bytes per ACTIVE client-round — the per-device cost a real
        deployment bills, unchanged by how many stragglers were dropped."""
        cr = max(1.0, self.client_rounds)
        return {n: v / cr for n, v in self.as_dict().items()}

    def per_token(self, n_tokens: float) -> Dict[str, float]:
        """Bytes per generated token — the serving analogue of
        `per_client_round`; `n_tokens` comes from the engine's counter
        (the meter itself has no notion of tokens)."""
        t = max(1.0, float(n_tokens))
        return {n: v / t for n, v in self.as_dict().items()}

    # ------------------------------------------------------------- resume
    def state_dict(self) -> Dict[str, float]:
        state = {f"totals/{n}": v for n, v in self.totals.items()}
        state["rounds"] = float(self.rounds)
        state["client_rounds"] = self.client_rounds
        for n, v in self.wall.items():
            state[f"wall/{n}"] = v
        return state

    def load_state_dict(self, state: Mapping[str, float]) -> None:
        for n in self.totals:
            key = f"totals/{n}"
            if key in state:
                self.totals[n] = float(state[key])
        self.rounds = int(state["rounds"])
        self.client_rounds = float(state["client_rounds"])
        for n in self.wall:
            # absent in pre-async checkpoints: zero, not an error
            self.wall[n] = float(state.get(f"wall/{n}", 0.0))

    def report(self) -> str:
        lines = [f"wire traffic over {self.rounds} round(s):"]
        for n, v in self.as_dict().items():
            lines.append(f"  {n:>10}: {v / MB:10.3f} MB")
        if self.client_rounds > 0:
            per = self.per_client_round()["total"]
            lines.append(f"  ({self.client_rounds:.0f} active "
                         f"client-rounds, {per / MB:.3f} MB each)")
        if self.wall["span_s"] > 0:
            ov = self.overlap()
            lines.append(
                f"wall clock over {self.wall['span_s']:.1f} simulated s: "
                f"server {self.wall['server_busy_s']:.1f}s, client "
                f"compute {self.wall['client_compute_s']:.1f}s, wire "
                f"{self.wall['wire_s']:.1f}s "
                f"(parallelism {ov['parallelism']:.2f}x)")
        return "\n".join(lines)
