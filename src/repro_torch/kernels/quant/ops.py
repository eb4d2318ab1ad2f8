"""Public int8 wire quantize/dequantize ops, dispatched by device.

A tensor on the CPU runs the plain version (`ref.py`); a CUDA tensor
launches the kernel (`kernel.py`) or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.quant import ref
from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd


def quantize_int8(x: torch.Tensor, u):
    """Row-wise symmetric int8 quantization with stochastic rounding.

    x: (N, D) float; u: uniform noise in [0,1) broadcastable to (N, D)
    (pass 0.5 for deterministic round-to-nearest).
    Returns (values (N, D) int8, scales (N, 1) f32).

    On the card a Python number or a 0-dim host tensor `u` reaches the
    kernel by value: no tensor is made and nothing is copied to the card.
    """
    if not on_cuda(x):
        return ref.quantize(x, u)
    if x.stride(-1) != 1:
        # e.g. a gradient that autograd hands over as a broadcast view
        x = x.contiguous()
    if not isinstance(u, torch.Tensor) or (u.dim() == 0 and not u.is_cuda):
        return quantize_fwd(x, float(u))
    u = torch.as_tensor(u, dtype=torch.float32, device=x.device)
    return quantize_fwd(x, u.expand(x.shape))


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, *,
                    dtype=torch.float32):
    """values (N, D) int8, scales (N, 1) f32 -> (N, D) dtype (the kernel
    writes f32, bf16 or f16)."""
    if not on_cuda(values):
        return ref.dequantize(values, scales, dtype)
    return dequantize_fwd(values, scales, dtype)
