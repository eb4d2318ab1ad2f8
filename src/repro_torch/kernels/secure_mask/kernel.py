"""Launch wrapper of the fused masked-encode CUDA kernel.

Replaces the TPU kernel `repro/kernels/secure_mask/kernel.py::
masked_encode_fwd` with `csrc/secure_mask.cu`: each thread encodes four
consecutive elements into the uint32 ring and folds in every pairwise mask
stream, generated in registers as the JAX reference's threefry stream of
the element index (so no launch geometry enters the bits). The TPU
wrapper's (N, 128) row blocks are TPU layout only: this takes the flat
(n,) upload. x is f32, bf16 or f16, read by the kernel itself (a 16-bit
value widened on load, as the TPU kernel's astype(f32)). See the note in
the source.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library


def masked_encode_fwd(x: Optional[torch.Tensor], seeds: torch.Tensor,
                      signs: torch.Tensor, *, n: int,
                      frac_bits: int) -> torch.Tensor:
    """x (n,) f32, bf16 or f16 contiguous CUDA, aligned to four of its
    values (16 bytes f32, 8 bf16 or f16), or None to encode zero (the
    recovery stream); seeds (J,) int32 holding the uint32 seeds and signs
    (J,) int32 in {-1, 0, 1}, contiguous on the same device. n % 4 == 0.
    Returns the (n,) int32 ring tensor (uint32 bit patterns)."""
    device = seeds.device
    code = 0
    if x is not None:
        refuse_grad("masked_encode_fwd", x)
        code = dtype_code("masked_encode_fwd: x", x.dtype)
        if not x.is_cuda or tuple(x.shape) != (n,) \
                or not x.is_contiguous() \
                or x.data_ptr() % (4 * x.element_size()):
            raise ValueError(f"masked_encode_fwd takes a contiguous ({n},) "
                             f"CUDA x aligned to four values, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        device = x.device
    if n % 4:
        raise ValueError(f"masked_encode_fwd needs n % 4 == 0, got n={n}")
    J = seeds.shape[0]
    for name, t in (("seeds", seeds), ("signs", signs)):
        if not t.is_cuda or t.device != device or t.dtype != torch.int32 \
                or tuple(t.shape) != (J,) or not t.is_contiguous():
            raise ValueError(f"masked_encode_fwd: {name} must be contiguous "
                             f"int32 ({J},) on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((n,), dtype=torch.int32, device=device)
    check(library().sfp_masked_encode(
        0 if x is None else x.data_ptr(), code, seeds.data_ptr(),
        signs.data_ptr(), J, float(2.0 ** frac_bits), out.data_ptr(), n,
        current_stream()),
        "sfp_masked_encode")
    masked_encode_fwd.launches += 1
    return out


masked_encode_fwd.launches = 0
