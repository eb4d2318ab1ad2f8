"""Public Mamba-2 SSD scan op, dispatched by device — the port of
`repro/kernels/mamba2_scan/ops.py`.

A tensor on the CPU runs the plain sequential recurrence (`ref.py`); a
CUDA tensor launches a kernel (`kernel.py`: the step or the chunked one,
by shape) or raises — there is no third path and no `impl` switch. The
JAX op's `"chunked"` and `"analysis"` impls are XLA-side alternatives for
dry-run cost accounting; the chunked form is ported as a plain version
(`ref.mamba2_chunked`, the algorithm of the chunked kernel) for tests and
`chip_smoke.py`, never on the path. Differentiated passes call
`ref.mamba2_scan` directly (`models/layers.py`), as the JAX package runs
them with `impl="ref"`.

`state_out=` takes the final state in place (the JAX op returns a new
array): the kernels write it there, the CPU path copies into it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.mamba2_scan import ref
from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def mamba2_scan(
    x: torch.Tensor,     # (B, T, H, P)
    dt: torch.Tensor,    # (B, T, H)
    A: torch.Tensor,     # (H,)
    Bm: torch.Tensor,    # (B, T, G, N)
    Cm: torch.Tensor,    # (B, T, G, N)
    state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    *,
    state_out: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, H, P) in x.dtype, final state (B, H, P, N) f32: the
    `state_out` tensor when given, which may be `state` itself)."""
    if not on_cuda(x):
        y, h = ref.mamba2_scan(x, dt, A, Bm, Cm, state)
        if state_out is None:
            return y, h
        return y, state_out.copy_(h)
    return mamba2_fwd(_unit_last(x), dt, A.contiguous(), _unit_last(Bm),
                      _unit_last(Cm),
                      None if state is None else state.contiguous(),
                      state_out=state_out)
