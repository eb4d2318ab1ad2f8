"""Observability: the flight recorder (a copy of `repro/obs/trace.py`,
with `Tracer.annotate` on `torch.profiler.record_function`)."""
from repro_torch.obs.trace import (  # noqa: F401
    LEVEL_OFF, LEVEL_ROUND, LEVEL_STEP, LEVELS, NOOP,
    NoopTracer, Tracer, make_tracer, span_tree, strip_times, sum_stream,
    to_jsonl,
)
