"""Observability: the flight recorder (a copy of `repro/obs/trace.py`,
with `Tracer.annotate` on `torch.profiler.record_function`), the metrics
registry and the exporters (byte-for-byte copies of `repro/obs/metrics.py`
and `repro/obs/export.py`, which import only the standard library).

Pure observation: attaching a tracer changes no output, no metered byte
and no random draw (tests/test_torch_obs.py)."""
from repro_torch.obs.trace import (  # noqa: F401
    LEVEL_OFF, LEVEL_ROUND, LEVEL_STEP, LEVELS, NOOP,
    NoopTracer, Tracer, make_tracer, span_tree, strip_times, sum_stream,
    to_jsonl,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
)
from repro_torch.obs.export import (  # noqa: F401
    chrome_trace, export_all, meter_final_record, prometheus_text,
    write_chrome_trace, write_jsonl, write_prometheus,
)
