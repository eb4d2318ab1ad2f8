"""Public RWKV-6 scan op, dispatched by device — the port of
`repro/kernels/rwkv6_scan/ops.py`.

A tensor on the CPU runs the plain sequential recurrence (`ref.py`); a
CUDA tensor launches a kernel (`kernel.py`: the step or the chunked one,
by shape) or raises; a `meta` tensor (the dry-run) takes the loop-free
chunked GLA form `ref.rwkv6_chunked`, the JAX op's `"analysis"` form.
`chunked=True` (the JAX op's `impl="chunked"`) takes that form where a
plain version would run: on the CPU, and in differentiated passes
(`plain_scan`); a CUDA tensor in a forward pass launches the kernel all
the same. The chunked kernel's own decomposition is a plain version too
(`ref.rwkv6_subchunked`), for tests and `chip_smoke.py`.

`state_out=` takes the final state in place (the JAX op returns a new
array): the kernels write it there, the other paths copy into it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import route
from repro_torch.kernels.rwkv6_scan import ref
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def plain_scan(r, k, v, w, u, state=None, *, chunked: bool = False,
               chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain form on any device (differentiable): the chunked one when
    asked or on `meta`, else the sequential recurrence."""
    if chunked or r.is_meta:
        return ref.rwkv6_chunked(r, k, v, w, u, state,
                                 chunk=min(chunk, r.shape[1]))
    return ref.rwkv6_scan(r, k, v, w, u, state)


def rwkv6_scan(
    r: torch.Tensor,      # (B, T, H, K)
    k: torch.Tensor,
    v: torch.Tensor,      # (B, T, H, V)
    w: torch.Tensor,      # (B, T, H, K) log-decay (negative)
    u: torch.Tensor,      # (H, K)
    state: Optional[torch.Tensor] = None,  # (B, H, K, V)
    *,
    state_out: Optional[torch.Tensor] = None,  # (B, H, K, V) f32
    chunked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, H, V) in r.dtype, final state (B, H, K, V) f32: the
    `state_out` tensor when given, which may be `state` itself)."""
    if route(r) != "kernel":
        y, S = plain_scan(r, k, v, w, u, state, chunked=chunked)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    return rwkv6_fwd(_unit_last(r), _unit_last(k), _unit_last(v),
                     _unit_last(w), u.contiguous(),
                     None if state is None else state.contiguous(),
                     state_out=state_out)
