"""Flight recorder: nested host-side spans + structured events.

The tracer is a RING BUFFER of structured records — "what just happened,
in order, with the numbers attached" — threaded through the protocol
round, the async runtime, and the serve engines. Design contract (the
hard part, pinned by tests/test_obs.py):

* **No-op when disabled.** Every instrumented component defaults to the
  shared `NOOP` tracer whose methods do nothing and whose `enabled` is
  False; hot loops guard attribute construction behind `tracer.enabled`.
  With tracing off, engine outputs, round params, and metered bytes are
  BIT-IDENTICAL to an un-instrumented build — tracing is observation,
  never participation (it forces no extra device syncs: byte attributes
  are recorded at the points the host already materializes them).
* **Exact byte accounting.** `TrafficMeter.absorb` emits one
  `meter.absorb` event per fold with the SAME host floats it adds to its
  totals, so summing the events per stream in record order reproduces
  the meter totals float-exactly (tools/trace_check.py verifies this
  against the `meter.final` record the exporters append).
* **Deterministic modulo wall time.** Record order, names, depths, and
  attribute values are pure functions of the run's seed/config; only
  `t_ns`/`dur_ns` carry host wall time. Strip those and two same-seed
  traces compare equal (`strip_times`).

Two clocks coexist: host spans stamp `time.perf_counter_ns()`; the async
runtime's records instead carry the engine's SIMULATED clock (`t_sim` /
`dur_sim`, seconds) via `event_at`/`span_at` — the Chrome-trace exporter
lays them out as a separate process track.

Levels: ``off`` (0) records nothing, ``round`` (1) the lifecycle
(rounds, flushes, admissions, retirements, meter folds), ``step`` (2)
adds per-dispatch detail (decode steps, page-pool churn, buffer traffic).
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

LEVEL_OFF = 0
LEVEL_ROUND = 1
LEVEL_STEP = 2
LEVELS = {"off": LEVEL_OFF, "round": LEVEL_ROUND, "step": LEVEL_STEP}

# record keys that carry host wall time — the only nondeterminism a
# same-seed trace is allowed (strip them before comparing traces)
TIME_KEYS = ("t_ns", "dur_ns")


class _NoopSpan:
    """Reusable null context: `with NOOP.span(...) as sp: sp.set(...)`
    costs two attribute lookups and nothing else."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """The disabled tracer: every hook is a no-op, `enabled` is False so
    hot paths can skip attribute construction entirely."""
    __slots__ = ()
    enabled = False
    level = LEVEL_OFF

    def span(self, name: str, level: int = LEVEL_ROUND, **attrs):
        return _NOOP_SPAN

    def event(self, name: str, level: int = LEVEL_ROUND, **attrs) -> None:
        pass

    def event_at(self, name: str, t_sim: float,
                 level: int = LEVEL_ROUND, **attrs) -> None:
        pass

    def span_at(self, name: str, t0_sim: float, t1_sim: float,
                level: int = LEVEL_ROUND, lane: int = 0, **attrs) -> None:
        pass

    def records(self) -> Tuple:
        return ()

    def annotate(self, name: str):
        from contextlib import nullcontext
        return nullcontext()


NOOP = NoopTracer()


class _Span:
    """Open span handle; records one complete record at exit."""
    __slots__ = ("_tracer", "name", "level", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, level: int,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.level = level
        self.attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        self._tracer._depth += 1
        return self

    def set(self, **attrs) -> None:
        """Attach attributes discovered while the span is open (byte
        counters, cohort sizes) — they land on the closing record."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        tr = self._tracer
        tr._depth -= 1
        t1 = time.perf_counter_ns()
        tr._push({"seq": next(tr._seq), "kind": "span", "name": self.name,
                  "depth": tr._depth, "t_ns": self._t0,
                  "dur_ns": t1 - self._t0, "attrs": self.attrs})
        return False


class Tracer:
    """Span/event flight recorder over a bounded ring buffer.

    `capacity` bounds host memory: the buffer keeps the NEWEST records
    (old ones fall off the front), so a long run's tail is always
    exportable. `records()` returns the live contents in seq order;
    `drain()` additionally empties the buffer.
    """

    def __init__(self, level: int = LEVEL_ROUND, *,
                 capacity: int = 1 << 16, profiler: bool = False):
        if isinstance(level, str):
            level = LEVELS[level]
        self.level = int(level)
        self.profiler = profiler
        self._buf: deque = deque(maxlen=capacity)
        self._seq = itertools.count()
        self._depth = 0
        self.dropped = 0   # records that fell off the ring

    @property
    def enabled(self) -> bool:
        return self.level > LEVEL_OFF

    def _push(self, rec: Dict[str, Any]) -> None:
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._buf.append(rec)

    # ------------------------------------------------------------ recording
    def span(self, name: str, level: int = LEVEL_ROUND, **attrs):
        """Nested host-clock span (context manager). The record is pushed
        at EXIT, so a child's record precedes its parent's; `depth` (the
        nesting depth at entry) recovers the tree."""
        if level > self.level:
            return _NOOP_SPAN
        return _Span(self, name, level, attrs)

    def event(self, name: str, level: int = LEVEL_ROUND, **attrs) -> None:
        """Instant host-clock event."""
        if level > self.level:
            return
        self._push({"seq": next(self._seq), "kind": "event", "name": name,
                    "depth": self._depth, "t_ns": time.perf_counter_ns(),
                    "attrs": attrs})

    def event_at(self, name: str, t_sim: float,
                 level: int = LEVEL_ROUND, **attrs) -> None:
        """Instant event on a SIMULATED clock (async runtime seconds)."""
        if level > self.level:
            return
        self._push({"seq": next(self._seq), "kind": "event", "name": name,
                    "depth": self._depth, "t_ns": time.perf_counter_ns(),
                    "t_sim": float(t_sim), "attrs": attrs})

    def span_at(self, name: str, t0_sim: float, t1_sim: float,
                level: int = LEVEL_ROUND, lane: int = 0, **attrs) -> None:
        """Complete span on the simulated clock — e.g. one async client's
        compute+wire interval [dispatch, arrival]. `lane` keys the
        Chrome-trace track (overlapping sim spans need distinct lanes)."""
        if level > self.level:
            return
        self._push({"seq": next(self._seq), "kind": "span", "name": name,
                    "depth": self._depth, "t_ns": time.perf_counter_ns(),
                    "t_sim": float(t0_sim),
                    "dur_sim": float(t1_sim) - float(t0_sim),
                    "lane": int(lane), "attrs": attrs})

    def annotate(self, name: str):
        """Opt-in `torch.profiler.record_function` around a device step —
        shows up in torch profiler timelines; a no-op nullcontext unless
        the tracer was built with profiler=True."""
        if not self.profiler:
            from contextlib import nullcontext
            return nullcontext()
        import torch.profiler
        return torch.profiler.record_function(name)

    # ------------------------------------------------------------- reading
    def records(self) -> List[Dict[str, Any]]:
        return list(self._buf)

    def drain(self) -> List[Dict[str, Any]]:
        out = list(self._buf)
        self._buf.clear()
        return out


def make_tracer(level: Any = "off", *, capacity: int = 1 << 16,
                profiler: bool = False):
    """`NOOP` for "off"/0/None, a live `Tracer` otherwise — the one
    constructor launchers need."""
    if level in (None, "off", LEVEL_OFF, False):
        return NOOP
    return Tracer(level, capacity=capacity, profiler=profiler)


# ----------------------------------------------------------------- helpers
def strip_times(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Records minus the host wall-time keys — the determinism view two
    same-seed runs must agree on exactly."""
    return [{k: v for k, v in rec.items() if k not in TIME_KEYS}
            for rec in records]


def sum_stream(records: Iterable[Dict[str, Any]], name: str,
               stream: str) -> float:
    """Fold one byte stream over the named records IN ORDER — the same
    left-to-right float addition `TrafficMeter` performs, so the result
    is comparable to the meter total with ==, not allclose."""
    total = 0.0
    for rec in records:
        if rec.get("name") == name:
            v = rec.get("attrs", {}).get(stream)
            if v is not None:
                total += float(v)
    return total


def to_jsonl(records: Iterable[Dict[str, Any]]) -> str:
    return "".join(json.dumps(rec, sort_keys=True) + "\n"
                   for rec in records)


def span_tree(records: Iterable[Dict[str, Any]]
              ) -> List[Tuple[int, str, Optional[float]]]:
    """(depth, name, dur_ns) per span record, in record order — a cheap
    textual view of the nesting for summaries and tests."""
    return [(rec.get("depth", 0), rec["name"], rec.get("dur_ns"))
            for rec in records if rec.get("kind") == "span"]
