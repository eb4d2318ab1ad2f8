"""Plain PyTorch version of the int8 wire quantizer.

Per-row symmetric quantization over the last axis (one fp32 scale per
token-row of the smashed activation):

    scale = max|x_row| / 127          (clamped away from zero)
    q     = clip(floor(x/scale + u), -127, 127)   as int8

`u` is uniform noise in [0, 1): stochastic rounding (unbiased,
E[dequant(q)] = x).  `u = 0.5` reduces to round-to-nearest — the
deterministic mode used for eval/serving.  Dequantization is q * scale.

Bit-exact arithmetic: XLA compiles the reference's `amax / 127` as a
multiply by the f32 constant 1/127 in every jitted JAX path (the jnp
reference under jit and the Pallas kernel alike), so the scale here is
`amax * f32(1/127)` too — a true division sits one ulp away in about one
row in twenty and can flip an int8 payload value. `x / scale` is a true
IEEE division in both packages. The constants are 0-dim tensors on the
input's device, so no backend rewrites the arithmetic around a Python
scalar.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8
QMAX = 127.0
INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))   # f32(1/127), exact


def quantize(x: torch.Tensor, u) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) float; u broadcastable to x.shape in [0, 1).
    Returns (values int8 (..., D), scales f32 (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scales = torch.clamp_min(amax * amax.new_full((), INV_QMAX),
                             amax.new_full((), EPS))
    u = torch.as_tensor(u, dtype=torch.float32, device=x.device)
    q = torch.floor(xf / scales + u)
    values = torch.clamp(q, -QMAX, QMAX).to(torch.int8)
    return values, scales


def dequantize(values: torch.Tensor, scales: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (values.float() * scales).to(dtype)
