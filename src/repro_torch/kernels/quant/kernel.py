"""Launch wrappers of the int8 wire quantize/dequantize CUDA kernels.

Replaces the TPU kernels `repro/kernels/quant/kernel.py::quantize_fwd` and
`::dequantize_fwd` with `csrc/quant.cu` (see the note there: the row held
in registers, one read of x, 16-byte loads and packed stores). The 128-lane
padding of D and the 128-wide scale output of the TPU version are TPU
layout only; these take and give the op contract directly: (N, D) int8
values and (N, 1) f32 scales. x is read in f32, bf16 or f16 and dequantized
values are written in f32, bf16 or f16, by the kernels themselves, as the
TPU kernels take them.

Each wrapper checks what the kernel takes, allocates its outputs, launches
on the current stream and counts the launch in its `launches` attribute.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

THREADS = 256                        # a block, in every layout
ROW_VALUES = 32                      # values of a row a thread holds
WARP_MAX_D = 32 * ROW_VALUES         # 1024: a warp a row
BLOCK_MAX_D = THREADS * ROW_VALUES   # 8192: a block a row (or a cluster
#                                      block's share)
MAX_CLUSTER = 8                      # the portable thread-block cluster size
MAX_D = MAX_CLUSTER * BLOCK_MAX_D    # 65536
LAYOUTS = {"warp": 0, "block": 1, "cluster": 2}   # csrc/quant.cu's codes

Plan = Tuple[str, int, int]


def quantize_plan(N: int, D: int, itemsize: int) -> Plan:
    """(layout, blocks a row, threads a block) of the quantize kernel for
    N rows of D values of `itemsize` bytes: a warp a row up to D 1024, a
    block a row up to 8192, else a cluster of ceil(D / 8192) blocks (at
    most 8, so D <= 65536; above that it raises). A function of shapes
    alone, so choosing it needs no device sync.

    N and itemsize would pick a cluster for rows that fit one block where
    that is at least 10% faster on the device; chip_smoke.py's sweep
    (`quant_cluster_sweep`: 2, 4 and 8 blocks at N 8 and 16, D 2560-5120,
    f32 and bf16, NVIDIA H100 80GB HBM3) found none, so today neither
    changes the plan."""
    if D > MAX_D:
        raise ValueError(
            f"quantize_int8 takes rows of at most {MAX_D} values (a cluster "
            f"of {MAX_CLUSTER} blocks of {BLOCK_MAX_D}), got D = {D}")
    if D <= WARP_MAX_D:
        return "warp", 1, THREADS
    if D > BLOCK_MAX_D:
        return "cluster", -(-D // BLOCK_MAX_D), THREADS
    return "block", 1, THREADS


def check_plan(plan: Plan, D: int) -> None:
    """Raise unless `plan` can hold rows of D values: a warp holds 1024, a
    block threads x 32, a cluster of C blocks C times that."""
    layout, C, threads = plan
    if layout not in LAYOUTS or threads % 32 or not 32 <= threads <= THREADS:
        raise ValueError(f"quantize_fwd: no such plan {plan}")
    if layout == "cluster" and not 2 <= C <= MAX_CLUSTER:
        raise ValueError(f"quantize_fwd: a cluster has 2 to {MAX_CLUSTER} "
                         f"blocks, got {C}")
    cap = {"warp": WARP_MAX_D, "block": threads * ROW_VALUES,
           "cluster": C * threads * ROW_VALUES}[layout]
    if D > cap:
        raise ValueError(f"quantize_fwd: plan {plan} holds rows of at most "
                         f"{cap} values, got D = {D}")


def quantize_fwd(x: torch.Tensor, u, plan: Optional[Plan] = None):
    """x (N, D) f32, bf16 or f16 CUDA with unit column stride (any row
    stride, 0 included); u a Python float (passed by value: no tensor, no
    copy) or an f32 tensor on x's device, 0-dim or (N, D) through any
    strides. `plan` overrides `quantize_plan` (the card's sweeps). Returns
    (values (N, D) int8, scales (N, 1) f32)."""
    u_is_tensor = isinstance(u, torch.Tensor)
    refuse_grad("quantize_fwd", x, *([u] if u_is_tensor else []))
    x_dtype = dtype_code("quantize_fwd: x", x.dtype)
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f"quantize_fwd takes a 2-D CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("quantize_fwd needs x rows contiguous (stride 1)")
    N, D = x.shape
    if u_is_tensor:
        if u.dim() == 0:
            u = u.expand(N, D)
        if u.device != x.device or u.dtype != torch.float32 \
                or u.shape != x.shape:
            raise ValueError(f"quantize_fwd: u must be a float or f32 "
                             f"{tuple(x.shape)} on {x.device}, got {u.dtype} "
                             f"{tuple(u.shape)} on {u.device}")
        u_args = (u.data_ptr(), u.stride(0), u.stride(1), 0.0)
    else:
        u_args = (None, 0, 0, float(u))
    if plan is None:
        plan = quantize_plan(N, D, x.element_size())
    check_plan(plan, D)
    layout, cluster, threads = plan
    values = torch.empty((N, D), dtype=torch.int8, device=x.device)
    scales = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    check(library().sfp_quantize_int8(
        x.data_ptr(), x_dtype, x.stride(0), *u_args, values.data_ptr(),
        scales.data_ptr(), N, D, LAYOUTS[layout], cluster, threads,
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
