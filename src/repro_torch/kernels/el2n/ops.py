"""Public fused EL2N/CE op, dispatched by device.

A tensor on the CPU runs the plain materialized version (`ref.py`); a CUDA
tensor launches the kernel (`kernel.py`) or raises — there is no third
path. Scoring (phase 1b) calls this op under `torch.no_grad()`; the
differentiated cross-entropy calls `ref.el2n_scores` directly, as the JAX
package hard-codes `impl="ref"` there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.el2n import ref
from repro_torch.kernels.el2n.kernel import el2n_fwd


def el2n_scores(logits: torch.Tensor, labels: torch.Tensor):
    """EL2N score + cross-entropy per row. logits (N, V) float; labels (N,)
    int. Returns (el2n (N,), ce (N,)) in float32."""
    if not on_cuda(logits):
        return ref.el2n_scores(logits, labels)
    return el2n_fwd(logits, labels.to(torch.int32).contiguous())
