"""Launch wrappers of the int8 wire quantize/dequantize CUDA kernels.

Replaces the TPU kernels `repro/kernels/quant/kernel.py::quantize_fwd` and
`::dequantize_fwd` with `csrc/quant.cu` (see the note there: both are bound
by device memory, one coalesced pass each way). The 128-lane padding of D
and the 128-wide scale output of the TPU version are TPU layout only; these
take and give the op contract directly: (N, D) int8 values and (N, 1) f32
scales. x is read in f32, bf16 or f16 and dequantized values are written in f32
or bf16, by the kernels themselves, as the TPU kernels take them.

Each wrapper checks what the kernel takes, allocates its outputs, launches
on the current stream and counts the launch in its `launches` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library


def quantize_fwd(x: torch.Tensor, u: torch.Tensor):
    """x (N, D) f32, bf16 or f16 CUDA with unit column stride; u f32 on the
    same device, (N, D) through any strides — a broadcast scalar has both
    strides 0. Returns (values (N, D) int8, scales (N, 1) f32)."""
    refuse_grad("quantize_fwd", x, u)
    x_dtype = dtype_code("quantize_fwd: x", x.dtype)
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f"quantize_fwd takes a 2-D CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("quantize_fwd needs x rows contiguous (stride 1)")
    if u.device != x.device or u.dtype != torch.float32 \
            or u.shape != x.shape:
        raise ValueError(f"quantize_fwd: u must be f32 {tuple(x.shape)} on "
                         f"{x.device}, got {u.dtype} {tuple(u.shape)} on "
                         f"{u.device}")
    N, D = x.shape
    values = torch.empty((N, D), dtype=torch.int8, device=x.device)
    scales = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    check(library().sfp_quantize_int8(
        x.data_ptr(), x_dtype, x.stride(0), u.data_ptr(), u.stride(0),
        u.stride(1), values.data_ptr(), scales.data_ptr(), N, D,
        current_stream()), "sfp_quantize_int8")
    quantize_fwd.launches += 1
    return values, scales


quantize_fwd.launches = 0


def dequantize_fwd(values: torch.Tensor, scales: torch.Tensor,
                   dtype=torch.float32):
    """values (N, D) int8 contiguous CUDA, scales (N, 1) f32 contiguous
    -> (N, D) `dtype` (f32, bf16 or f16: the f32 product rounded once)."""
    refuse_grad("dequantize_fwd", values, scales)
    out_dtype = dtype_code("dequantize_fwd: dtype", dtype)
    if not values.is_cuda or values.dtype != torch.int8 or values.dim() != 2:
        raise ValueError(f"dequantize_fwd takes 2-D int8 CUDA values, got "
                         f"{values.dtype} {tuple(values.shape)} on "
                         f"{values.device}")
    N, D = values.shape
    if scales.device != values.device or scales.dtype != torch.float32 \
            or scales.shape != (N, 1):
        raise ValueError(f"dequantize_fwd: scales must be f32 ({N}, 1) on "
                         f"{values.device}")
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_fwd needs contiguous values and scales")
    out = torch.empty((N, D), dtype=dtype, device=values.device)
    check(library().sfp_dequantize_int8(
        values.data_ptr(), scales.data_ptr(), out.data_ptr(), out_dtype, N,
        D, current_stream()), "sfp_dequantize_int8")
    dequantize_fwd.launches += 1
    return out


dequantize_fwd.launches = 0
