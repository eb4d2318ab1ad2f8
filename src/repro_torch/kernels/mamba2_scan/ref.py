"""Plain PyTorch version of the Mamba-2 SSD recurrence, the counterpart of
`repro/kernels/mamba2_scan/ref.py::mamba2_scan` [arXiv:2405.21060-style,
as used by zamba2, arXiv:2411.15242].

Per head h with scalar log-decay rate A_h < 0, state h in R^{P x N}:

    a_t  = exp(dt_t * A)
    h_t  = a_t * h_{t-1} + (dt_t * x_t) B_t^T     (outer product, (P,N))
    y_t  = h_t C_t                                 ((P,N) @ (N,) -> (P,))

A Python loop over T in f32, with B and C repeated from G groups to H
heads. The JAX package's chunked form (`mamba2_chunked`) is an XLA-side
alternative for dry-run cost accounting and is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def mamba2_scan(
    x: torch.Tensor,     # (B, T, H, P)
    dt: torch.Tensor,    # (B, T, H) positive
    A: torch.Tensor,     # (H,) negative log-decay rate
    Bm: torch.Tensor,    # (B, T, G, N) input matrix (G groups, H % G == 0)
    Cm: torch.Tensor,    # (B, T, G, N) output matrix
    state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, H, P) in x.dtype, final state (B, H, P, N) f32)."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x_, dt_, Bm_, Cm_ = (t.float() for t in (x, dt, Bm, Cm))
    Bh = Bm_.repeat_interleave(rep, dim=2)   # (B, T, H, N)
    Ch = Cm_.repeat_interleave(rep, dim=2)
    Af = A.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for t in range(T):
        dtt = dt_[:, t]                                       # (B, H)
        a = torch.exp(dtt * Af)[..., None, None]              # (B, H, 1, 1)
        h = a * h + (dtt[..., None] * x_[:, t])[..., None] \
            * Bh[:, t][..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h
