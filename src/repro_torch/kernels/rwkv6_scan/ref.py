"""Plain PyTorch version of the RWKV-6 (Finch) time-mix recurrence, the
counterpart of `repro/kernels/rwkv6_scan/ref.py::rwkv6_scan`.

Per head with state S in R^{K x V}, data-dependent log-decay w_t < 0
[arXiv:2404.05892]:

    y_t = r_t^T S_{t-1} + (r_t . (u o k_t)) v_t
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T

A Python loop over T in f32, stepped exactly (no exp(-cumsum) factor, so
strong decays stay finite). The JAX package's chunked GLA form
(`rwkv6_chunked`) is an XLA-side alternative and is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_scan(
    r: torch.Tensor,      # (B, T, H, K) receptance
    k: torch.Tensor,      # (B, T, H, K)
    v: torch.Tensor,      # (B, T, H, V)
    w: torch.Tensor,      # (B, T, H, K) log-decay (negative)
    u: torch.Tensor,      # (H, K) per-head bonus
    state: Optional[torch.Tensor] = None,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, H, V) in r.dtype, final state (B, H, K, V) f32)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    r_, k_, v_, w_ = (t.float() for t in (r, k, v, w))
    uf = u.float()
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r_[:, t], k_[:, t], v_[:, t], w_[:, t]
        bonus = torch.einsum("bhk,hk,bhk->bh", rt, uf, kt)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S)
                  + bonus[..., None] * vt)
        S = torch.exp(wt)[..., None] * S + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, 1).to(r.dtype), S
