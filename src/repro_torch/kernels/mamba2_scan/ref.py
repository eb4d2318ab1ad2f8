"""Plain PyTorch version of the Mamba-2 SSD recurrence, the counterpart of
`repro/kernels/mamba2_scan/ref.py::mamba2_scan` [arXiv:2405.21060-style,
as used by zamba2, arXiv:2411.15242].

Per head h with scalar log-decay rate A_h < 0, state h in R^{P x N}:

    a_t  = exp(dt_t * A)
    h_t  = a_t * h_{t-1} + (dt_t * x_t) B_t^T     (outer product, (P,N))
    y_t  = h_t C_t                                 ((P,N) @ (N,) -> (P,))

A Python loop over T in f32, with B and C repeated from G groups to H
heads. `mamba2_chunked` is the port of the JAX package's chunked form, the
algorithm the chunked CUDA kernel runs (tests and `chip_smoke.py` hold the
two against each other), and the accounting form of the `meta` device and
of `impl="chunked"` (`ops.plain_scan`); no serving or training path on the
CPU or the card runs it.
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


def mamba2_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, state: Optional[torch.Tensor] = None, *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked-matmul form (`repro/kernels/mamba2_scan/ref.py::
    mamba2_chunked`): T padded to a multiple of `chunk` with zero rows
    (dt 0: a decay of 1 and no input), then per chunk, with acum the
    inclusive cumsum of dt A and L[t, s] = exp(min(acum_t - acum_s, 0))
    for s <= t, else 0,

        y  = (L o C B^T) (dt x) + exp(acum_t) C h^T
        h <- exp(acum_last) h + (dt x)^T (B o exp(acum_last - acum)).

    Exact and f32-stable for A <= 0 (every exponent <= 0)."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if state is None else state.float())
    Af = A.float()
    pad = (-T) % chunk
    x_, dt_, Bm_, Cm_ = (
        torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        for t in (x, dt, Bm, Cm))
    Bh = Bm_.repeat_interleave(rep, dim=2)   # (B, Tp, H, N)
    Ch = Cm_.repeat_interleave(rep, dim=2)
    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    ys = []
    for s0 in range(0, T + pad, chunk):
        xc = x_[:, s0:s0 + chunk]                 # (B, c, H, P)
        dtc = dt_[:, s0:s0 + chunk]               # (B, c, H)
        bc = Bh[:, s0:s0 + chunk]                 # (B, c, H, N)
        cc = Ch[:, s0:s0 + chunk]
        acum = torch.cumsum(dtc * Af, dim=1)      # (B, c, H)
        diff = acum[:, :, None] - acum[:, None, :]            # (B, t, s, H)
        L = torch.where(tri[None, :, :, None],
                        torch.exp(torch.clamp(diff, max=0.0)),
                        torch.zeros((), dtype=f32, device=x.device))
        L = L.permute(0, 3, 1, 2)                 # (B, H, t, s)
        dtx = dtc[..., None] * xc
        cb = torch.einsum("bthn,bshn->bhts", cc, bc)
        y = torch.einsum("bhts,bshp->bthp", L * cb, dtx)
        y = y + torch.exp(acum)[..., None] * torch.einsum(
            "bthn,bhpn->bthp", cc, h)
        ys.append(y)
        total = acum[:, -1]                       # (B, H)
        wgt = torch.exp(total[:, None] - acum)    # (B, c, H)
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bshp,bshn->bhpn", dtx * wgt[..., None], bc)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(x.dtype), h
