"""Hand-written Hopper kernels of the port, one per TPU kernel on its path.

Each kernel lives in its own subpackage, mirroring `repro/kernels/`:
  <name>/ref.py     — the plain PyTorch version (CPU tests, card checks)
  <name>/kernel.py  — the launch wrapper of the CUDA kernel in csrc/,
                      with a `launches` counter
  <name>/ops.py     — the public op: plain version for a CPU tensor, the
                      kernel for a CUDA tensor, the accounting form for a
                      `meta` tensor, and nothing else

Kernels (csrc/, built by `build.py` into one shared library at first use):
  quant            — int8 wire quantize / dequantize      (quant.cu)
  flash_attention  — causal GQA prefill attention          (flash_attention.cu)
                     slot-cache decode attention           (decode_attention.cu)
                     paged decode attention      (paged_decode_attention.cu)
  el2n             — fused EL2N score + cross-entropy      (el2n.cu)
  secure_mask      — fixed-point encode + pairwise masks   (secure_mask.cu)
  mamba2_scan      — Mamba-2 SSD recurrence                (mamba2_scan.cu)
  rwkv6_scan       — RWKV-6 time-mix recurrence            (rwkv6_scan.cu)

Every kernel reads f32, bf16 and f16 itself (widening a 16-bit value to
f32 on load, exactly, as each JAX kernel reads its inputs with
`.astype(f32)`), computes in f32 and writes its output in the dtype the
JAX kernel writes; a wrapper passes each floating tensor's `dtype_code`
beside its pointer and refuses every other dtype (f64 too: JAX without
x64 never holds it). No wrapper converts an input or an output.

No kernel has a backward, and a launch wrapper passes raw pointers, so its
output carries no `grad_fn`: every wrapper refuses (`refuse_grad`) an input
that requires grad while grad mode is on, instead of silently cutting the
gradient path. Differentiated passes run the plain versions
(`models.layers.Ctx.differentiable`, `core.losses`).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


# ops a `meta` tensor took the accounting form of: the kernel launches a
# card would make for the same step (`launch/hlo.py` reads them as
# "custom-call")
accounted_ops = 0


def route(x: torch.Tensor) -> str:
    """The device alone picks an op's path: "kernel" for a CUDA tensor,
    "plain" for a CPU one, "accounting" for a `meta` one (the dry-run:
    shapes only; the scans take their loop-free chunked forms, every other
    op its plain version, whose FLOPs and bytes depend on shapes alone).
    Any other device raises; nothing falls back."""
    global accounted_ops
    if x.is_cuda:
        return "kernel"
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "meta":
        accounted_ops += 1
        return "accounting"
    raise ValueError(f"no kernel or plain version for device {x.device}")


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU or
    `meta` one (the plain version); anything else raises (`route`)."""
    return route(x) == "kernel"


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(name: str, dtype: torch.dtype) -> int:
    """The C entry points' code of a tensor's dtype (csrc/dtype.cuh: kF32
    0, kBF16 1, kF16 2); any other dtype raises, naming the input."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name} must be float32, bfloat16 or float16, "
                         f"got {dtype}")
    return DTYPE_CODES[dtype]


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when a kernel would be launched on an input that requires grad
    while grad mode is on: its output would have no `grad_fn`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no backward "
            f"and its output would cut the gradient path; run the plain "
            f"version in differentiated passes, or call under torch.no_grad()")


def wrappers() -> Dict[str, Callable]:
    """The launch wrappers of every ported kernel, by kernel name."""
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    return {"quantize_int8": quantize_fwd, "dequantize_int8": dequantize_fwd,
            "flash_attention_prefill": flash_attention_fwd,
            "decode_attention": decode_attention_fwd,
            "paged_decode_attention": paged_decode_attention_fwd,
            "el2n": el2n_fwd, "secure_masked_encode": masked_encode_fwd,
            "mamba2_scan": mamba2_fwd, "rwkv6_scan": rwkv6_fwd}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        if getattr(fn, "shapes", None) is not None:
            fn.shapes.clear()   # launches by shape, where a caller counts
