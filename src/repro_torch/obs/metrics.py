"""Unified metrics registry: one `snapshot()` over scattered runtime state.

Before this module, the numbers lived in five places with five shapes:
`TrafficMeter.totals`/`report()`, `ServeEngine.stats()`,
`PagedServeEngine`'s pool/prefix counters, `StalenessLedger.summary()`,
and the sharding-fallback record list. The registry gives them a common
vocabulary — counters, gauges, histograms, all label-capable — plus
lazy *sources*: a registered callable is polled at `snapshot()` time, so
attaching an engine costs nothing per token (the engine keeps mutating
its own counters; the registry reads them on demand).

Values are whatever the owner already computed — the registry never
forces a device sync of its own (`ServeEngine.stats()` keeps its
one-sync-per-call contract; the registry just calls it when *you* ask
for a snapshot).
"""
from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


def _labels(labels: Optional[Mapping[str, Any]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_suffix(ls: LabelSet) -> str:
    if not ls:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in ls) + "}"


class Counter:
    """Monotone sum per label set."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v: Dict[LabelSet, float] = {}

    def inc(self, amount: float = 1.0,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        ls = _labels(labels)
        self._v[ls] = self._v.get(ls, 0.0) + float(amount)

    def value(self, labels: Optional[Mapping[str, Any]] = None) -> float:
        return self._v.get(_labels(labels), 0.0)

    def collect(self) -> Dict[str, float]:
        return {self.name + _label_suffix(ls): v
                for ls, v in sorted(self._v.items())}


class Gauge:
    """Last-set value per label set; `set_fn` makes it lazy (polled at
    collect time — the idiom for "mirror this live attribute")."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v: Dict[LabelSet, Any] = {}

    def set(self, value: float,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        self._v[_labels(labels)] = float(value)

    def set_fn(self, fn: Callable[[], float],
               labels: Optional[Mapping[str, Any]] = None) -> None:
        self._v[_labels(labels)] = fn

    def value(self, labels: Optional[Mapping[str, Any]] = None) -> float:
        v = self._v.get(_labels(labels), 0.0)
        return float(v()) if callable(v) else v

    def collect(self) -> Dict[str, float]:
        return {self.name + _label_suffix(ls): (float(v()) if callable(v)
                                                else v)
                for ls, v in sorted(self._v.items())}


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style) with
    sum/count — enough for latency/size distributions without keeping
    every observation."""

    DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1e3,
                       1e4, 1e5, 1e6)

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._counts: Dict[LabelSet, List[int]] = {}
        self._sum: Dict[LabelSet, float] = {}
        self._n: Dict[LabelSet, int] = {}

    def observe(self, value: float,
                labels: Optional[Mapping[str, Any]] = None) -> None:
        ls = _labels(labels)
        if ls not in self._counts:
            self._counts[ls] = [0] * (len(self.buckets) + 1)
            self._sum[ls] = 0.0
            self._n[ls] = 0
        v = float(value)
        self._counts[ls][bisect.bisect_left(self.buckets, v)] += 1
        self._sum[ls] += v
        self._n[ls] += 1

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for ls in sorted(self._counts):
            cum = 0
            for edge, c in zip(self.buckets, self._counts[ls]):
                cum += c
                le = _labels(dict(dict(ls), le=repr(edge)))
                out[f"{self.name}_bucket" + _label_suffix(le)] = cum
            inf = _labels(dict(dict(ls), le="+Inf"))
            out[f"{self.name}_bucket" + _label_suffix(inf)] = self._n[ls]
            out[f"{self.name}_sum" + _label_suffix(ls)] = self._sum[ls]
            out[f"{self.name}_count" + _label_suffix(ls)] = self._n[ls]
        return out


class MetricsRegistry:
    """Namespace of instruments + lazy snapshot sources.

    `register_source(name, fn)` hooks a zero-arg callable returning a
    flat `{metric: value}` mapping; `snapshot()` merges every
    instrument's `collect()` with every source's poll, prefixing source
    keys with `<name>/`. Sources are how existing state joins without
    migrating: `bind_*` helpers below wrap a TrafficMeter, serve engine,
    page pool, or staleness ledger as a source in one line.
    """

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._sources: Dict[str, Callable[[], Mapping[str, Any]]] = {}

    def _get(self, name: str, kind):
        """Idempotent by (name, kind): re-registering the same name
        returns the live instrument; a cross-kind clash is a bug."""
        got = self._instruments.get(name)
        if got is not None and not isinstance(got, kind):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(got).__name__}, not {kind.__name__}")
        return got

    def counter(self, name: str, help: str = "") -> Counter:
        got = self._get(name, Counter)
        if got is None:
            got = self._instruments[name] = Counter(name, help)
        return got

    def gauge(self, name: str, help: str = "") -> Gauge:
        got = self._get(name, Gauge)
        if got is None:
            got = self._instruments[name] = Gauge(name, help)
        return got

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        got = self._get(name, Histogram)
        if got is None:
            got = self._instruments[name] = Histogram(name, help, buckets)
        return got

    def register_source(self, name: str,
                        fn: Callable[[], Mapping[str, Any]]) -> None:
        self._sources[name] = fn

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for inst in self._instruments.values():
            out.update(inst.collect())
        for name, fn in self._sources.items():
            for k, v in dict(fn()).items():
                out[f"{name}/{k}"] = v
        return out

    # ------------------------------------------------------ source binders
    def bind_meter(self, meter, name: str = "meter") -> None:
        """TrafficMeter totals + wall streams + round counts."""
        def poll():
            out = dict(meter.state_dict())
            out["total_bytes"] = meter.total_bytes()
            return out
        self.register_source(name, poll)

    def bind_engine(self, engine, name: str = "serve") -> None:
        """ServeEngine/PagedServeEngine `live_stats()` — token/step
        counters, last-flush wire bytes, and (paged) pool/prefix counters
        — flattened one level."""
        def poll():
            out: Dict[str, Any] = {}
            for k, v in engine.live_stats().items():
                if isinstance(v, Mapping):
                    for kk, vv in v.items():
                        out[f"{k}/{kk}"] = vv
                else:
                    out[k] = v
            return out
        self.register_source(name, poll)

    def bind_ledger(self, ledger, name: str = "staleness") -> None:
        """Async runtime's StalenessLedger: applied count, mean/max."""
        def poll():
            return {"applied": ledger.applied,
                    "mean": ledger.mean_staleness(),
                    "max": ledger.max_staleness}
        self.register_source(name, poll)

    def bind_pool(self, pool, name: str = "pages") -> None:
        """PagePool occupancy: total/free/used pages (used excludes the
        two reserved ids)."""
        def poll():
            return {"n_pages": pool.n_pages, "page_size": pool.page_size,
                    "n_free": pool.n_free, "n_used": pool.n_used}
        self.register_source(name, poll)
