"""Public Mamba-2 SSD scan op, dispatched by device — the port of
`repro/kernels/mamba2_scan/ops.py`.

A tensor on the CPU runs the plain sequential recurrence (`ref.py`); a
CUDA tensor launches a kernel (`kernel.py`: the step or the chunked one,
by shape) or raises; a `meta` tensor (the dry-run) takes the loop-free
chunked form `ref.mamba2_chunked`, the JAX op's `"analysis"` form.
`chunked=True` (the JAX op's `impl="chunked"`, passed down from
`launch/steps.py`) takes the chunked form where a plain version would run:
on the CPU, and in differentiated passes (`plain_scan`); a CUDA tensor in
a forward pass launches the kernel all the same. Differentiated passes
call `plain_scan` (`models/layers.py`), as the JAX package runs them with
`impl="ref"`.

`state_out=` takes the final state in place (the JAX op returns a new
array): the kernels write it there, the other paths copy into it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import route
from repro_torch.kernels.mamba2_scan import ref
from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def plain_scan(x, dt, A, Bm, Cm, state=None, *, chunked: bool = False,
               chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain form on any device (differentiable): the chunked one when
    asked or on `meta`, else the sequential recurrence."""
    if chunked or x.is_meta:
        return ref.mamba2_chunked(x, dt, A, Bm, Cm, state,
                                  chunk=min(chunk, x.shape[1]))
    return ref.mamba2_scan(x, dt, A, Bm, Cm, state)


def mamba2_scan(
    x: torch.Tensor,     # (B, T, H, P)
    dt: torch.Tensor,    # (B, T, H)
    A: torch.Tensor,     # (H,)
    Bm: torch.Tensor,    # (B, T, G, N)
    Cm: torch.Tensor,    # (B, T, G, N)
    state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    *,
    state_out: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    chunked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, H, P) in x.dtype, final state (B, H, P, N) f32: the
    `state_out` tensor when given, which may be `state` itself)."""
    if route(x) != "kernel":
        y, h = plain_scan(x, dt, A, Bm, Cm, state, chunked=chunked)
        if state_out is None:
            return y, h
        return y, state_out.copy_(h)
    return mamba2_fwd(_unit_last(x), dt, A.contiguous(), _unit_last(Bm),
                      _unit_last(Cm),
                      None if state is None else state.contiguous(),
                      state_out=state_out)
