"""Multi-tenant continuous-batching split-serving engines: the dense slot
cache (`ServeEngine`) and the paged pool with copy-on-write shared prefixes
and chunked prefill (`PagedServeEngine`)."""
from repro_torch.serve.bank import TenantBank
from repro_torch.serve.engine import Finished, ServeConfig, ServeEngine
from repro_torch.serve.paged_engine import PagedServeConfig, PagedServeEngine
from repro_torch.serve.paging import PagePool, PagePoolExhausted, PrefixEntry
from repro_torch.serve.steps import (make_batched_decode_step,
                                     make_chunk_continue_step,
                                     make_multi_decode_step,
                                     make_paged_decode_step,
                                     make_paged_multi_decode_step,
                                     make_tenant_prefill_step)
from repro_torch.serve.workload import Request, WorkloadConfig, synthetic_requests

__all__ = [
    "TenantBank", "ServeConfig", "ServeEngine", "Finished",
    "PagedServeConfig", "PagedServeEngine",
    "PagePool", "PagePoolExhausted", "PrefixEntry",
    "make_batched_decode_step", "make_multi_decode_step",
    "make_tenant_prefill_step", "make_paged_decode_step",
    "make_paged_multi_decode_step", "make_chunk_continue_step",
    "Request", "WorkloadConfig", "synthetic_requests",
]
