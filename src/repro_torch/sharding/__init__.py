"""Partition rules (`rules.py`) and the collectives that run a model on
its local shards (`parallel.py`)."""
from repro_torch.sharding.rules import (  # noqa: F401
    P, batch_pspec, cache_pspecs, cohort_pspecs, params_pspecs,
    guard_divisibility, format_sharding_fallbacks, placements,
    pop_sharding_fallbacks, report_fallbacks)
