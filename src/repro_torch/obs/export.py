"""Exporters: JSONL event log, Chrome-trace JSON, Prometheus text.

All three consume the flight recorder's raw records (`Tracer.records()`)
— the JSONL file is the ground truth `tools/trace_check.py` validates,
the Chrome trace is the same data laid out for `chrome://tracing` /
Perfetto ("Open trace file"), and the Prometheus dump renders a
`MetricsRegistry.snapshot()` for scrape-style ingestion.

Clock layout in the Chrome trace: host-clock records render under
``pid 0`` ("host"), simulated-clock records (async runtime: `t_sim` /
`dur_sim` in seconds) under ``pid 1`` ("sim") with one tid per `lane`
(client id), so overlapping in-flight clients stack as parallel tracks
instead of overwriting each other.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional

PID_HOST = 0
PID_SIM = 1


def meter_final_record(meter, seq: int) -> Dict[str, Any]:
    """The closing `meter.final` record: authoritative per-stream totals
    at export time. trace_check verifies the running `meter.absorb` sums
    equal these floats EXACTLY (same left-to-right addition order)."""
    return {"seq": seq, "kind": "event", "name": "meter.final", "depth": 0,
            "attrs": {**{k: float(v) for k, v in meter.totals.items()},
                      "rounds": meter.rounds}}


def _finalize(records: Iterable[Mapping[str, Any]],
              meter=None) -> List[Dict[str, Any]]:
    recs = [dict(r) for r in records]
    if meter is not None:
        recs.append(meter_final_record(
            meter, recs[-1]["seq"] + 1 if recs else 0))
    return recs


def write_jsonl(path: str, records: Iterable[Mapping[str, Any]],
                meter=None) -> int:
    """One record per line, sorted keys (deterministic bytes modulo the
    wall-time fields). Appends the `meter.final` record when a meter is
    given. Returns the number of records written."""
    recs = _finalize(records, meter)
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return len(recs)


def chrome_trace(records: Iterable[Mapping[str, Any]],
                 meter=None) -> Dict[str, Any]:
    """Records → Chrome trace-event JSON (the `traceEvents` envelope).

    Host spans become complete ("X") events with ts/dur in µs from
    `t_ns`; sim-clock spans use `t_sim` seconds → µs on the sim process.
    Events become instants ("i"). Metadata ("M") events name the two
    processes and the sim lanes.
    """
    recs = _finalize(records, meter)
    events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": PID_HOST, "name": "process_name",
         "args": {"name": "host"}},
        {"ph": "M", "pid": PID_SIM, "name": "process_name",
         "args": {"name": "sim"}},
    ]
    named_lanes = set()
    t0 = min((r["t_ns"] for r in recs if "t_ns" in r), default=0)
    for rec in recs:
        args = dict(rec.get("attrs", {}))
        if "t_sim" in rec:
            pid, tid = PID_SIM, rec.get("lane", 0)
            ts = rec["t_sim"] * 1e6
            dur = rec.get("dur_sim", 0.0) * 1e6
            if tid not in named_lanes:
                named_lanes.add(tid)
                events.append({"ph": "M", "pid": PID_SIM, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": f"lane {tid}"}})
        else:
            pid, tid = PID_HOST, 0
            ts = (rec.get("t_ns", t0) - t0) / 1e3
            dur = rec.get("dur_ns", 0) / 1e3
        if rec.get("kind") == "span":
            events.append({"ph": "X", "pid": pid, "tid": tid,
                           "name": rec["name"], "ts": ts, "dur": dur,
                           "args": args})
        else:
            events.append({"ph": "i", "pid": pid, "tid": tid, "s": "t",
                           "name": rec["name"], "ts": ts, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, records: Iterable[Mapping[str, Any]],
                       meter=None) -> int:
    doc = chrome_trace(records, meter)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True)
    return len(doc["traceEvents"])


def prometheus_text(snapshot: Mapping[str, Any]) -> str:
    """A `MetricsRegistry.snapshot()` as Prometheus text exposition.
    Metric names are sanitized (`/`, `-`, `.` → `_`); label suffixes
    produced by the registry pass through untouched. Non-numeric values
    are skipped (exposition is numbers-only)."""
    lines = []
    for key in sorted(snapshot):
        v = snapshot[key]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name, brace, labels = key.partition("{")
        name = (name.replace("/", "_").replace("-", "_")
                .replace(".", "_"))
        lines.append(f"{name}{brace}{labels} {float(v)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, snapshot: Mapping[str, Any]) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(snapshot))


def export_all(tracer, base: str, *, meter=None,
               registry=None) -> Dict[str, str]:
    """Write every applicable format next to `base` (a path prefix):
    `<base>.jsonl`, `<base>.trace.json`, and `<base>.prom` when a
    registry is supplied. Returns {format: path} for logging."""
    recs = tracer.records()
    out: Dict[str, str] = {}
    jsonl = base + ".jsonl"
    write_jsonl(jsonl, recs, meter)
    out["jsonl"] = jsonl
    chrome = base + ".trace.json"
    write_chrome_trace(chrome, recs, meter)
    out["chrome"] = chrome
    if registry is not None:
        prom = base + ".prom"
        write_prometheus(prom, registry.snapshot())
        out["prom"] = prom
    return out
