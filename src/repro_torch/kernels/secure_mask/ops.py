"""Public fused masked-encode ops, dispatched by device — the port of
`repro/kernels/secure_mask/ops.py`.

A tensor on the CPU runs the plain version (`ref.py`); a CUDA tensor
launches the kernel (`kernel.py`) or raises — there is no third path and
no `impl` switch. Both compute the JAX reference's threefry stream, so
uploads and recovery streams are the same bits on every device: the
contract the aggregator needs (the masks a client folded in are exactly
the ones the server regenerates) holds across devices too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.secure_mask import ref
from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
from repro_torch.kernels.secure_mask.ref import (FRAC_BITS, decode,  # noqa: F401
                                                 encode)

LANES = 128


def ring_size(n: int) -> int:
    """Flattened uploads are padded to a LANES multiple, as in the JAX
    package; the pad rides the wire too (masks cover it), so both the
    meter and the analytical model count the PADDED length."""
    return n + (-n) % LANES


def _pairs(seeds, signs, device):
    """Seeds (any int type holding uint32 values) and signs as the
    kernel's contiguous int32 tensors on `device`."""
    seeds = ref.to_ring(torch.as_tensor(seeds, dtype=torch.int64) & ref.MASK32)
    signs = torch.as_tensor(signs).to(torch.int32)
    return seeds.to(device).contiguous(), signs.to(device).contiguous()


def masked_encode(x: torch.Tensor, seeds, signs, *,
                  frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """One client's secure upload: encode(x) + sum_j sign_j * PRG(seed_j).

    x: (n,) f32, bf16 or f16 with n % LANES == 0 (see ring_size); seeds
    (J,) uint32 values, signs (J,) in {-1, 0, +1}. Returns (n,) int32
    ring."""
    if not on_cuda(x):
        return ref.masked_encode(x, seeds, signs, frac_bits)
    seeds, signs = _pairs(seeds, signs, x.device)
    x = x.contiguous()
    if x.data_ptr() % (4 * x.element_size()):
        x = x.clone()   # a view at an odd offset: the kernel loads 4 values
    return masked_encode_fwd(x, seeds, signs,
                             n=x.shape[0], frac_bits=frac_bits)


def summed_mask(seeds, signs, n: int, *, device,
                frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """The pure mask stream (encode of zero) — the server's dropout-recovery
    reconstruction, on `device` (required: no op of the port picks a device
    for its caller)."""
    device = torch.device(device)
    if device.type == "cpu":
        return ref.summed_mask(seeds, signs, n)
    if device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {device}")
    seeds, signs = _pairs(seeds, signs, device)
    return masked_encode_fwd(None, seeds, signs, n=n, frac_bits=frac_bits)
