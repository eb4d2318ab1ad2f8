"""Privacy engine, ported so far: the clear aggregator of the pluggable
phase-3 contract (`secure_agg.ClearAggregator`). Masked secure aggregation,
fixed-point encoding and DP accounting are slice D."""
from repro_torch.privacy.secure_agg import ClearAggregator  # noqa: F401
