"""Multi-tenant continuous-batching split-serving engine (dense slot cache).

The paged engine (`PagedServeEngine`) is ported with a later slice.
"""
from repro_torch.serve.bank import TenantBank
from repro_torch.serve.engine import Finished, ServeConfig, ServeEngine
from repro_torch.serve.steps import (make_batched_decode_step,
                                     make_multi_decode_step,
                                     make_tenant_prefill_step)
from repro_torch.serve.workload import Request, WorkloadConfig, synthetic_requests

__all__ = [
    "TenantBank", "ServeConfig", "ServeEngine", "Finished",
    "make_batched_decode_step", "make_multi_decode_step",
    "make_tenant_prefill_step",
    "Request", "WorkloadConfig", "synthetic_requests",
]
