"""AsyncRoundEngine: buffered asynchronous federated runtime — the port of
`repro/fed/async_engine.py`.

The synchronous `FederatedEngine` runs a barrier per round: the server
waits for the whole cohort (minus dropouts) before aggregating, so one
slow WAN client stalls everyone. This engine removes the barrier,
FedBuff-style (Nguyen et al., AISTATS'22):

    dispatch groups of clients on their own simulated clocks
    ->  each finishes its phase-2/3 update after its own latency
        (wire + compute, from the SAME per-client persistent factors the
        RoundScheduler uses)
    ->  its (tail, prompt) delta lands in a bounded `DeltaBuffer`
    ->  every `buffer_size` arrivals the server FLUSHES: one
        staleness-weighted `fedavg_partial` (or secure-agg cohort) over
        the buffered contributions, producing the next model version.

Staleness: a contribution computed against version v and applied at
version V has staleness s = V - v, weighted alpha / (1 + s)^beta
(`fed.buffer.staleness_weight`). The flush is the aggregation unit —
secure aggregation (on the card: one masked-encode launch per buffered
entry, dropped passengers included, plus one recovery launch when a
passenger rides along), DP metering, and FedAvg weighting all see one
flush exactly as they would see one synchronous round.

Bit-identity contract (test-pinned): with `buffer_size == K` (one
dispatch group fills the buffer), `concurrency=1` and `staleness_beta=0`
every contribution has staleness 0 and the flush reproduces the
synchronous round's aggregated params AND metered bytes bit-exactly.
This works because dispatch runs the SAME `SFPromptTrainer` round
(`client_updates` — all-zero aggregate weights), the flush drains in
dispatch order (not arrival order, so the float-sum order matches the
synchronous round's stack), and the flush weight `keep * size * 1.0`
equals the synchronous `float32(keep) * aggregate` weight vector
element-for-element.

Clock-only mode (`trainer=None`) is numpy alone: dispatch, arrival and
flush advance the simulated clock and the meter's wall streams, equal to
the JAX engine's bit for bit.

Contributions stay on the trainer's device, in flight and in the buffer;
`save()` moves them to numpy and `restore()` back to the device.

Resume: `save()`/`restore()` checkpoint the buffer contents, every
in-flight client's computed contribution and absolute finish time, the
staleness ledger, and the simulated clock — a killed-and-restarted run
replays every subsequent arrival, flush, and metered byte byte-identically
(contributions are stored, not recomputed, so no RNG replay is needed).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import load_latest
from repro_torch.core.aggregation import get_aggregator
from repro_torch.fed.buffer import (BufferEntry, DeltaBuffer,
                                    StalenessLedger, flush_weights)
from repro_torch.fed.engine import (_flatten_numeric, rank_params,
                                    trainer_fingerprint, whole_params,
                                    write_run)
from repro_torch.fed.population import Population
from repro_torch.fed.sampler import ClientSampler
from repro_torch.fed.scheduler import (LINK_REGIMES,
                                       FullParticipationScheduler,
                                       RoundScheduler)
from repro_torch.obs.trace import NOOP
from repro_torch.runtime.meter import EDGE, PARAMS, SECURE, TrafficMeter
from repro_torch.tree import tree_leaves, tree_map

# RNG domain tag for async dispatch jitter/dropout draws — disjoint from
# the sampler's (3, 5) and the scheduler's (7, 11); see fed/sampler.py on
# SeedSequence trailing-zero dropping (tags must be non-zero).
ASYNC_TAG = 13


@dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the buffered async runtime.

    buffer_size        — arrivals per flush (the aggregation cohort K').
    concurrency        — dispatch groups in flight at once; 1 degenerates
                         to "one group computes while none queue", >= 2
                         overlaps client compute across groups (the
                         async win).
    group_size         — clients per dispatch group; defaults to the
                         sampler's cohort size when 0.
    staleness_alpha/beta — flush weight alpha / (1+s)^beta. beta=0 turns
                         staleness discounting off (pure FedBuff-with-
                         uniform-weights; required for the bit-identity
                         test).
    server_flops_per_param — aggregation cost model for the meter's
                         server_busy_s stream: flushing E entries over
                         n_trainable params costs E * n * this / P_S
                         seconds at the regime's server FLOP rate.
    """
    buffer_size: int = 5
    concurrency: int = 2
    group_size: int = 0
    staleness_alpha: float = 1.0
    staleness_beta: float = 0.5
    server_flops_per_param: float = 6.0

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got "
                             f"{self.buffer_size}")
        if self.concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got "
                             f"{self.concurrency}")
        if self.group_size < 0:
            raise ValueError(f"group_size must be >= 0, got "
                             f"{self.group_size}")
        if self.staleness_alpha <= 0:
            raise ValueError("staleness_alpha must be > 0")
        if self.staleness_beta < 0:
            raise ValueError("staleness_beta must be >= 0")


@dataclass
class _InFlight:
    """One dispatched client whose (already computed) contribution has not
    yet arrived at the server, keyed by its simulated finish time."""
    client_id: int
    dispatch_idx: int
    position: int          # slot within the dispatch group's K-axis
    version: int           # model version the contribution was computed on
    finish_t: float        # absolute simulated arrival time
    dropped: bool          # died mid-round -> zero-weight passenger row
    transmit_frac: float   # fraction of its uplink bytes that made it
    size: float            # true local sample count (FedAvg weight)
    keep: int              # post-pruning trained sample count
    contribution: Any      # {"tail", "prompt"} tree of device tensors

    def order_key(self) -> Tuple[int, int]:
        return (self.dispatch_idx, self.position)


class AsyncRoundEngine:
    """Event-driven buffered-async driver. See module docstring.

    `trainer=None` enables CLOCK-ONLY mode: no model, no contributions —
    dispatch/arrival/flush advance the simulated clock and the meter's
    wall streams only.
    """

    def __init__(self, trainer, population: Optional[Population],
                 sampler: ClientSampler,
                 scheduler: Optional[RoundScheduler] = None,
                 acfg: AsyncConfig = AsyncConfig(), *,
                 aggregator=None, tracer=None):
        self.trainer = trainer
        self.population = population
        self.sampler = sampler
        self.acfg = acfg
        self.scheduler = scheduler or FullParticipationScheduler(
            seed=sampler.seed)
        if population is not None and (
                sampler.n_clients != population.n_clients):
            raise ValueError(
                f"sampler over {sampler.n_clients} clients but population "
                f"has {population.n_clients}")
        if acfg.group_size > sampler.k:
            raise ValueError(
                f"group_size={acfg.group_size} exceeds the sampler's "
                f"cohort size k={sampler.k}")
        if trainer is not None:
            if not getattr(trainer, "supports_partial", False):
                raise ValueError(
                    f"{type(trainer).__name__} cannot run async dispatch — "
                    "it has no participation-weight path (FL/SFL baselines "
                    "are synchronous by construction)")
            if not getattr(trainer.pcfg, "return_client_trainable", False):
                raise ValueError(
                    "async dispatch needs ProtocolConfig("
                    "return_client_trainable=True): the engine aggregates "
                    "at flush time, from per-client (tail, prompt) updates")
            if population is None:
                raise ValueError("a trainer needs a population to gather "
                                 "client data from")
            inner = getattr(trainer, "aggregator", None)
            if inner is not None and inner.name != "clear":
                raise ValueError(
                    "build the trainer with the CLEAR aggregator and pass "
                    "secure aggregation to AsyncRoundEngine(aggregator=...) "
                    "— the flush, not the dispatch round, is the secure-agg "
                    "cohort")
        # flush-time aggregator; the cohort is the buffer's entry count
        self.aggregator = aggregator or get_aggregator(
            cohort_size=acfg.buffer_size)
        # a metered flush aggregator (secure) bills its own uplink (masked
        # ring tensors) at flush time; the clear path bills plain f32
        # bytes at each arrival — mirrors the sync protocol's agg_wire
        # branch
        self._flush_metered = self.aggregator.name != "clear"
        # clock-only mode owns its meter; otherwise bill the trainer's
        self.meter = (getattr(trainer, "meter", None)
                      or TrafficMeter()) if trainer is not None \
            else TrafficMeter()
        # flight recorder: async records ride the SIMULATED clock
        # (event_at/span_at with t_sim) — a wall-clock trace of a
        # simulation would be meaningless. Inherit the trainer's tracer
        # unless one is passed explicitly.
        if tracer is None and trainer is not None:
            tracer = getattr(trainer, "tracer", None)
        self.tracer = tracer if tracer is not None else NOOP
        self.meter.attach_tracer(self.tracer)

        self.state: Optional[Dict[str, Any]] = None
        self.version = 0           # flush count == model version
        self.dispatch_idx = 0      # dispatch groups launched so far
        self.t_sim = 0.0           # simulated wall clock (seconds)
        self.arrivals = 0          # live contributions received, ever
        self.buffer = DeltaBuffer(buffer_size=acfg.buffer_size,
                                  tracer=self.tracer)
        self.in_flight: List[_InFlight] = []
        self.ledger = StalenessLedger(sampler.n_clients)
        self.flush_history: list = []   # (version, n_live, mean_staleness)
        self._span_mark = 0.0      # t_sim at last wall absorb

    # --------------------------------------------------------------- state
    def init(self, generator: Optional[torch.Generator]) -> None:
        if self.trainer is not None:
            self.state = self.trainer.init(generator)
        else:
            self.state = {"round": 0}
        self.version = 0
        self.dispatch_idx = 0
        self.t_sim = 0.0
        self.arrivals = 0
        self._span_mark = 0.0

    @property
    def params(self):
        return self.state["params"] if self.trainer is not None else None

    def _group_size(self) -> int:
        return self.acfg.group_size or self.sampler.k

    # ------------------------------------------------------------ dispatch
    def _dispatch_rng(self, d: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            (self.sampler.seed & 0xFFFFFFFF, ASYNC_TAG, d)))

    def dispatch_group(self, **round_kw) -> None:
        """Launch one group: sample clients, run their phase-1/2 updates
        against the CURRENT params (version v), and queue the resulting
        contributions with per-client simulated finish times. The server
        does not wait — the group's arrivals interleave with other
        groups' and with flushes. `round_kw` (`wire_noise=`, `dp_noise=`)
        passes through to the trainer's round."""
        d = self.dispatch_idx
        cohort = np.asarray(self.sampler.sample(d), dtype=np.int64)
        # group_size < sampler.k: dispatch a prefix of the sampled cohort
        cohort = cohort[:self._group_size()]
        k = len(cohort)
        rng = self._dispatch_rng(d)
        cfg = self.scheduler.cfg

        jitter = np.exp(rng.normal(0.0, cfg.jitter_sigma, size=k))
        wire, comp = self.scheduler.client_latency_parts(cohort)
        latency = (wire + comp) * jitter
        dropped = rng.random(k) < cfg.dropout_rate
        died_frac = rng.random(k)     # where in its round a dying client is
        # min_survivors: the fastest clients always deliver (mirrors
        # RoundScheduler.plan — keeps every flush non-degenerate)
        need = max(0, min(cfg.min_survivors, k) - int((~dropped).sum()))
        if need > 0:
            for idx in np.argsort(latency):
                if not dropped[idx]:
                    continue
                dropped[idx] = False
                need -= 1
                if need == 0:
                    break
        transmit = np.ones(k, dtype=np.float32)
        transmit[dropped] = np.clip(died_frac[dropped], 0.0, 1.0)
        finish = self.t_sim + np.where(dropped, died_frac * latency, latency)

        sizes = (self.population.cohort_sizes(cohort).astype(np.float64)
                 if self.population is not None
                 else np.ones(k, dtype=np.float64))

        contributions = [None] * k
        keep = 0
        if self.trainer is not None:
            data = self.population.gather(cohort)
            n_local = tree_leaves(data)[0].shape[1]
            keep = self.trainer.phase2_keep(n_local)
            # the dispatch group runs the synchronous trainer's round with
            # all-zero AGGREGATE weights: params stay untouched
            # (fedavg_partial falls back exactly), per-client updates come
            # back on the K-axis, and only the downlink is billed
            # (transmit carries the straggler-scaled phase-2 bytes)
            per_client, metrics = self.trainer.client_updates(
                dict(self.state, round=d), data, transmit, **round_kw)
            self.last_dispatch_metrics = metrics
            # each client's own copy on the device: the K-stacked tree is
            # freed once the group is queued
            contributions = [tree_map(lambda x: x[i].clone(), per_client)
                             for i in range(k)]
        else:
            # clock-only: bill the downlink the protocol would have
            self.meter.absorb({PARAMS: k * self._param_bytes()},
                              clients=0)

        tracer = self.tracer
        if tracer.enabled:
            tracer.event_at("async.dispatch", self.t_sim, group=d,
                            cohort=k, version=self.version)
        for i in range(k):
            self.in_flight.append(_InFlight(
                client_id=int(cohort[i]), dispatch_idx=d, position=i,
                version=self.version, finish_t=float(finish[i]),
                dropped=bool(dropped[i]),
                transmit_frac=float(transmit[i]),
                size=float(sizes[i]), keep=int(keep),
                contribution=contributions[i]))
            if tracer.enabled:
                # one sim-clock span per in-flight client, laned by client
                # id so overlapping flights stack in the Chrome trace
                tracer.span_at("async.client", self.t_sim,
                               float(finish[i]), level=2,
                               lane=int(cohort[i]), group=d,
                               version=self.version,
                               dropped=bool(dropped[i]))
        # wall accounting: the group's client compute and wire time happen
        # regardless of when the server looks at the results; dying
        # clients only burn their fraction
        frac = np.where(dropped, died_frac, 1.0)
        self.meter.absorb_wall(
            client_compute_s=float((comp * jitter * frac).sum()),
            wire_s=float((wire * jitter * frac).sum()))
        self.dispatch_idx = d + 1

    def _param_bytes(self) -> float:
        """Downlink/uplink bytes of one (tail, prompt) transfer. With a
        trainer this is metered by the protocol itself; clock-only mode
        approximates it from the scheduler's per-client round bytes."""
        return float(self.scheduler.round_bytes)

    # --------------------------------------------------------------- event
    def _pump(self, **round_kw) -> None:
        """Keep `concurrency` dispatch groups in flight."""
        while True:
            groups = {f.dispatch_idx for f in self.in_flight}
            if len(groups) >= self.acfg.concurrency:
                return
            self.dispatch_group(**round_kw)

    def step_event(self, **round_kw) -> bool:
        """Advance the simulated clock to the next arrival, move that
        contribution into the buffer (dropped clients become zero-weight
        passenger rows), flush if full. Returns True when a flush
        happened."""
        self._pump(**round_kw)
        # earliest finish; ties broken by dispatch order for determinism
        nxt = min(self.in_flight,
                  key=lambda f: (f.finish_t,) + f.order_key())
        self.in_flight.remove(nxt)
        self.t_sim = max(self.t_sim, nxt.finish_t)
        if self.tracer.enabled:
            self.tracer.event_at(
                "async.arrival", self.t_sim, client=nxt.client_id,
                group=nxt.dispatch_idx, version=nxt.version,
                staleness=self.version - nxt.version, dropped=nxt.dropped)
        self.buffer.append(BufferEntry(
            client_id=nxt.client_id, dispatch_idx=nxt.dispatch_idx,
            position=nxt.position, version=nxt.version, size=nxt.size,
            keep=nxt.keep, contribution=nxt.contribution,
            arrival_t=self.t_sim, dropped=nxt.dropped))
        if not nxt.dropped:
            self.arrivals += 1
            if not self._flush_metered:
                # uplink lands NOW — the dispatch round billed downlink
                # only (aggregate weights were all zero), so sync and
                # async meter identical `params` totals: (K + n_up) * pb
                self.meter.absorb(
                    {PARAMS: nxt.transmit_frac * self._up_bytes()},
                    clients=1)
            else:
                # secure flushes meter their own uplink (masked ring
                # tensors) in _flush; only count the client
                self.meter.absorb({}, clients=1)
        if self.buffer.full:
            self._flush()
            return True
        return False

    def _up_bytes(self) -> float:
        """One client's phase-3 uplink as the sync protocol meters it:
        the byte size of the (tail, prompt) globals."""
        if self.trainer is None:
            return self._param_bytes()
        return float(sum(
            x.numel() * x.element_size() for x in tree_leaves(
                {"tail": self.state["params"]["tail"],
                 "prompt": self.state["params"]["prompt"]})))

    # --------------------------------------------------------------- flush
    def _flush(self) -> None:
        acfg = self.acfg
        entries = self.buffer.drain()    # dispatch order, NOT arrival order
        live = [e for e in entries if not e.dropped]
        weights = flush_weights(entries, alpha=acfg.staleness_alpha,
                                beta=acfg.staleness_beta,
                                version=self.version)
        if self.trainer is not None:
            stacked = DeltaBuffer.stacked(entries)
            fallback = {k: self.state["params"][k] for k in stacked}
            new_globals, wire = self.aggregator.aggregate(
                stacked, torch.from_numpy(weights).to(self.trainer.device),
                fallback, self.version)
            params = dict(self.state["params"])
            params.update(new_globals)
            self.state = dict(self.state, params=params)
            if wire:
                # metered aggregator: the masked uplink plus key-agreement
                # / escrow-reveal overhead (arrivals did not bill params
                # when _flush_metered — see step_event)
                counts = {PARAMS: float(wire.get("params_up", 0.0))}
                for stream in (SECURE, EDGE):
                    if stream in wire:
                        counts[stream] = float(wire[stream])
                self.meter.absorb(counts, clients=0)
            if self.population is not None:
                ids = np.asarray([e.client_id for e in live],
                                 dtype=np.int64)
                self.population.record_participation(ids, self.version)
        # staleness bookkeeping + server busy time
        for e in live:
            self.ledger.record(e.client_id, self.version - e.version)
        stale = [self.version - e.version for e in live]
        self.flush_history.append(
            (self.version, len(live),
             float(np.mean(stale)) if stale else 0.0))
        regime = LINK_REGIMES[self.scheduler.cfg.regime]
        n_param = (self._up_bytes() / 4.0 if self.trainer is not None
                   else self._param_bytes() / 4.0)
        busy = (acfg.server_flops_per_param * n_param * len(entries)
                / regime["P_S"])
        span = self.t_sim - self._span_mark
        self._span_mark = self.t_sim
        self.meter.absorb_wall(server_busy_s=busy, span_s=span)
        if self.tracer.enabled:
            self.tracer.event_at(
                "async.flush", self.t_sim, version=self.version,
                n_entries=len(entries), n_live=len(live),
                mean_staleness=float(np.mean(stale)) if stale else 0.0,
                server_busy_s=busy)
        self.version += 1

    def run_flushes(self, n_flushes: int, **round_kw) -> Dict[str, float]:
        """Advance the event loop until `n_flushes` more flushes land.
        Returns summary metrics of the span just simulated. `round_kw`
        passes through to every dispatch round."""
        if self.state is None:
            raise RuntimeError("call init(generator) or restore(ckpt_dir) "
                               "first")
        t0, v0, a0 = self.t_sim, self.version, self.arrivals
        while self.version < v0 + n_flushes:
            self.step_event(**round_kw)
        dt = max(self.t_sim - t0, 1e-12)
        return {"flushes": float(self.version - v0),
                "arrivals": float(self.arrivals - a0),
                "sim_seconds": self.t_sim - t0,
                "flushes_per_s": (self.version - v0) / dt,
                "mean_staleness": self.ledger.mean_staleness(),
                "max_staleness": float(self.ledger.max_staleness)}

    # ------------------------------------------------------------- resume
    def _pack_flight(self, recs: Sequence[Any]) -> Dict[str, Any]:
        """BufferEntry/_InFlight lists -> nested npz-able dict. Keys are
        zero-padded indices so checkpoint.io's sorted '/'-flattening
        restores the original order."""
        out: Dict[str, Any] = {}
        for i, r in enumerate(recs):
            rec: Dict[str, Any] = {
                "client_id": np.int64(r.client_id),
                "dispatch_idx": np.int64(r.dispatch_idx),
                "position": np.int64(r.position),
                "version": np.int64(r.version),
                "size": np.float64(r.size),
                "keep": np.int64(r.keep),
                "dropped": np.int64(int(r.dropped)),
            }
            if isinstance(r, BufferEntry):
                rec["arrival_t"] = np.float64(r.arrival_t)
            else:
                rec["finish_t"] = np.float64(r.finish_t)
                rec["transmit_frac"] = np.float64(r.transmit_frac)
            if r.contribution is not None:
                rec["contribution"] = tree_map(
                    lambda x: x.detach().cpu().numpy(), r.contribution)
            out[f"{i:05d}"] = rec
        return out

    def _acfg_state(self) -> Dict[str, np.float64]:
        return {"buffer_size": np.float64(self.acfg.buffer_size),
                "concurrency": np.float64(self.acfg.concurrency),
                "group_size": np.float64(self.acfg.group_size),
                "staleness_alpha": np.float64(self.acfg.staleness_alpha),
                "staleness_beta": np.float64(self.acfg.staleness_beta),
                "server_flops_per_param":
                    np.float64(self.acfg.server_flops_per_param)}

    def _run_state(self) -> Dict[str, Any]:
        # the round rides as int32, the JAX package's layout
        trainer_state: Dict[str, Any] = {
            "round": np.int32(self.state["round"])}
        if self.trainer is not None:
            trainer_state["params"] = whole_params(self.trainer,
                                                   self.state["params"])
        state: Dict[str, Any] = {
            "trainer": trainer_state,
            "version": np.int64(self.version),
            "dispatch_idx": np.int64(self.dispatch_idx),
            "t_sim": np.float64(self.t_sim),
            "arrivals": np.int64(self.arrivals),
            "span_mark": np.float64(self._span_mark),
            "acfg": self._acfg_state(),
            "sampler": self.sampler.state_dict(),
            "scheduler": {k: np.float64(v) for k, v in
                          self.scheduler.state_dict().items()},
            "ledger": self.ledger.state_dict(),
            "meter": self.meter.state_dict(),
            "buffer": self._pack_flight(self.buffer.entries),
            "in_flight": self._pack_flight(
                sorted(self.in_flight, key=_InFlight.order_key)),
            "agg_crc": np.int64(zlib.crc32(
                self.aggregator.describe().encode())),
        }
        if self.trainer is not None:
            state["trainer_fingerprint"] = trainer_fingerprint(self.trainer)
        if self.population is not None:
            state["population"] = self.population.state_dict()
        return state

    def save(self, ckpt_dir: str, *, keep_last: Optional[int] = 3) -> str:
        """Atomic full-run checkpoint INCLUDING the buffer and in-flight
        clients — resume replays arrivals/flushes byte-identically."""
        return write_run(self.trainer, ckpt_dir, self._run_state(),
                         step=self.version, keep_last=keep_last)

    def restore(self, ckpt_dir: str) -> bool:
        """Resume from the newest checkpoint in `ckpt_dir`. Returns False
        (engine untouched) when the directory holds none."""
        run = load_latest(ckpt_dir)
        if run is None:
            return False
        saved_acfg = {k: float(np.asarray(v))
                      for k, v in run["acfg"].items()}
        diff = {k: (saved_acfg.get(k), float(v))
                for k, v in self._acfg_state().items()
                if saved_acfg.get(k) != float(v)}
        if diff:
            raise ValueError(
                f"async config mismatch on resume: checkpoint vs engine "
                f"differ on {diff} — rebuild with the original async flags")
        if "trainer_fingerprint" in run:
            if self.trainer is None:
                raise ValueError("checkpoint was written with a trainer; "
                                 "this engine is clock-only")
            if int(run["trainer_fingerprint"]) != int(
                    trainer_fingerprint(self.trainer)):
                raise ValueError(
                    "trainer mismatch on resume: the checkpoint was "
                    "written with different hyperparameters — rebuild the "
                    "trainer with the original flags")
        elif self.trainer is not None:
            raise ValueError("clock-only checkpoint resumed with a "
                             "trainer — params would be uninitialized")
        if int(run["agg_crc"]) != zlib.crc32(
                self.aggregator.describe().encode()):
            raise ValueError(
                "flush aggregator mismatch on resume (clear vs secure, or "
                "different masking params) — replayed flushes would "
                "diverge")
        device = self.trainer.device if self.trainer is not None else None

        def to_device(tree):
            # npz round-trips dtypes exactly: restored tensors are
            # bit-identical to the saved ones
            return tree_map(lambda x: torch.from_numpy(np.array(x)).to(
                device), tree)

        self.state = {"round": int(run["trainer"]["round"])}
        if self.trainer is not None:
            self.state["params"] = rank_params(
                self.trainer, to_device(run["trainer"]["params"]))
        self.version = int(run["version"])
        self.dispatch_idx = int(run["dispatch_idx"])
        self.t_sim = float(run["t_sim"])
        self.arrivals = int(run["arrivals"])
        self._span_mark = float(run["span_mark"])
        self.sampler.load_state_dict(run["sampler"])
        self.scheduler.load_state_dict(run["scheduler"])
        self.ledger.load_state_dict(run["ledger"])
        self.meter.load_state_dict(_flatten_numeric(run["meter"]))
        if self.population is not None and "population" in run:
            self.population.load_state_dict(run["population"])

        def _unpack(packed, cls):
            recs = []
            # empty dicts vanish in npz flattening: absent key == empty
            for _, rec in sorted((packed or {}).items()):
                contrib = rec.get("contribution")
                if contrib is not None:
                    contrib = to_device(contrib)
                common = dict(
                    client_id=int(rec["client_id"]),
                    dispatch_idx=int(rec["dispatch_idx"]),
                    position=int(rec["position"]),
                    version=int(rec["version"]),
                    size=float(rec["size"]), keep=int(rec["keep"]),
                    dropped=bool(int(rec["dropped"])),
                    contribution=contrib)
                if cls is BufferEntry:
                    recs.append(BufferEntry(
                        arrival_t=float(rec["arrival_t"]), **common))
                else:
                    recs.append(_InFlight(
                        finish_t=float(rec["finish_t"]),
                        transmit_frac=float(rec["transmit_frac"]),
                        **common))
            return recs

        self.buffer = DeltaBuffer(buffer_size=self.acfg.buffer_size,
                                  entries=_unpack(run.get("buffer"),
                                                  BufferEntry),
                                  tracer=self.tracer)
        self.in_flight = _unpack(run.get("in_flight"), _InFlight)
        self.flush_history = []
        return True
