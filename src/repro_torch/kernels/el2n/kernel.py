"""Launch wrapper of the fused EL2N/CE CUDA kernel.

Replaces the TPU kernel `repro/kernels/el2n/kernel.py::el2n_fwd` with
`csrc/el2n.cu`: one block per row streams the row once (16-byte loads
where the row pointer allows them) and merges per-thread online-softmax
statistics, so no (N, V) probability tensor is ever written. The TPU
wrapper's padding of V to `block_v` and its LANES-wide outputs are TPU
layout only: this takes (N, V) logits through their row stride and gives
(N,) outputs. It reads f32, bf16 or f16 logits itself (a 16-bit value
widened on load, as the TPU kernel's astype(f32)); the outputs are f32.
See the note in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library


def el2n_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """logits (N, V) f32, bf16 or f16 CUDA with unit column stride (any row
    stride); labels (N,) int32 contiguous on the same device. Returns
    (el2n (N,), ce (N,)) f32; a label outside [0, V) gives NaN."""
    refuse_grad("el2n_fwd", logits)
    code = dtype_code("el2n_fwd: logits", logits.dtype)
    if not logits.is_cuda or logits.dim() != 2:
        raise ValueError(f"el2n_fwd takes 2-D CUDA logits, got "
                         f"{logits.dtype} {tuple(logits.shape)} on "
                         f"{logits.device}")
    N, V = logits.shape
    if V < 1 or (logits.stride(1) != 1 and V > 1):
        raise ValueError(f"el2n_fwd needs V >= 1 and unit column stride, got "
                         f"shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if labels.device != logits.device or labels.dtype != torch.int32 \
            or tuple(labels.shape) != (N,) or not labels.is_contiguous():
        raise ValueError(f"el2n_fwd: labels must be contiguous int32 ({N},) "
                         f"on {logits.device}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")
    el2n = torch.empty((N,), dtype=torch.float32, device=logits.device)
    ce = torch.empty((N,), dtype=torch.float32, device=logits.device)
    check(library().sfp_el2n_fwd(
        logits.data_ptr(), code, logits.stride(0), labels.data_ptr(),
        el2n.data_ptr(), ce.data_ptr(), N, V, current_stream()),
        "sfp_el2n_fwd")
    el2n_fwd.launches += 1
    return el2n, ce


el2n_fwd.launches = 0
