"""Hand-written Hopper kernels of the port, one per TPU kernel on its path.

Each kernel lives in its own subpackage, mirroring `repro/kernels/`:
  <name>/ref.py     — the plain PyTorch version (CPU tests, card checks)
  <name>/kernel.py  — the launch wrapper of the CUDA kernel in csrc/,
                      with a `launches` counter
  <name>/ops.py     — the public op: plain version for a CPU tensor, the
                      kernel for a CUDA tensor, and nothing else

Kernels (csrc/, built by `build.py` into one shared library at first use):
  quant            — int8 wire quantize / dequantize      (quant.cu)
  flash_attention  — causal GQA prefill attention          (flash_attention.cu)
                     slot-cache decode attention           (decode_attention.cu)
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises.
    The device alone picks the kernel or the plain version."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def wrappers() -> Dict[str, Callable]:
    """The launch wrappers on the serving path, by kernel name."""
    from repro_torch.kernels.flash_attention.decode import decode_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    return {"quantize_int8": quantize_fwd, "dequantize_int8": dequantize_fwd,
            "flash_attention_prefill": flash_attention_fwd,
            "decode_attention": decode_attention_fwd}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
