"""Public RWKV-6 scan op, dispatched by device — the port of
`repro/kernels/rwkv6_scan/ops.py`.

A tensor on the CPU runs the plain sequential recurrence (`ref.py`); a
CUDA tensor launches a kernel (`kernel.py`: the step or the chunked one,
by shape) or raises — there is no third path and no `impl` switch. The
JAX op's `"chunked"` and `"analysis"` impls are XLA-side alternatives for
dry-run cost accounting and are not ported; the chunked kernel's own
decomposition is a plain version (`ref.rwkv6_subchunked`) for tests and
`chip_smoke.py`, never on the path. Differentiated passes call
`ref.rwkv6_scan` directly (`models/layers.py`), as the JAX package runs
them with `impl="ref"`.

`state_out=` takes the final state in place (the JAX op returns a new
array): the kernels write it there, the CPU path copies into it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.rwkv6_scan import ref
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def rwkv6_scan(
    r: torch.Tensor,      # (B, T, H, K)
    k: torch.Tensor,
    v: torch.Tensor,      # (B, T, H, V)
    w: torch.Tensor,      # (B, T, H, K) log-decay (negative)
    u: torch.Tensor,      # (H, K)
    state: Optional[torch.Tensor] = None,  # (B, H, K, V)
    *,
    state_out: Optional[torch.Tensor] = None,  # (B, H, K, V) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, H, V) in r.dtype, final state (B, H, K, V) f32: the
    `state_out` tensor when given, which may be `state` itself)."""
    if not on_cuda(r):
        y, S = ref.rwkv6_scan(r, k, v, w, u, state)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    return rwkv6_fwd(_unit_last(r), _unit_last(k), _unit_last(v),
                     _unit_last(w), u.contiguous(),
                     None if state is None else state.contiguous(),
                     state_out=state_out)
