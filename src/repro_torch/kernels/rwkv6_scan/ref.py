"""Plain PyTorch version of the RWKV-6 (Finch) time-mix recurrence, the
counterpart of `repro/kernels/rwkv6_scan/ref.py::rwkv6_scan`.

Per head with state S in R^{K x V}, data-dependent log-decay w_t < 0
[arXiv:2404.05892]:

    y_t = r_t^T S_{t-1} + (r_t . (u o k_t)) v_t
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T

`rwkv6_scan` is a Python loop over T in f32, stepped exactly (no
exp(-cumsum) factor, so strong decays stay finite): the plain version the
kernels are held to. `rwkv6_subchunked` is the chunked kernel's own
decomposition in plain PyTorch, for the tests and `chip_smoke.py`; nothing
on the serving path calls it. `rwkv6_chunked` is the JAX package's
chunked GLA form, loop-free within a chunk: the accounting form of the
`meta` device and of `impl="chunked"` (`launch/steps.py`).
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


SUB = 16   # steps a sub-chunk (csrc/rwkv6_scan.cu: kSub)


def rwkv6_subchunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm (`csrc/rwkv6_scan.cu`): T padded to a
    multiple of `chunk` (a multiple of 16) with zero rows (no input, a
    decay of 1), then per chunk, in sub-chunks of 16, with P_t (Q_s) the
    sum of w over the steps of t's (s's) sub-chunk before t (after s) and
    tot_i the sum over sub-chunk i, all restarted at each sub-chunk
    boundary:

        y_t = (r_t o exp(P_t + sum_{m < i} tot_m))^T S
            + sum_{s in j < i} (r~_t . k~_s o exp(sum_{j < m < i} tot_m)) v_s
            + sum_{s < t in i} (sum_k r_t k_s prod_{s < q < t} exp(w_q)) v_s
            + (r_t . (u o k_t)) v_t
        S  <- exp(sum_m tot_m) o S
              + sum_s (k_s o exp(Q_s + sum_{m > j} tot_m)) v_s^T

    with r~ = r o exp(P), k~ = k o exp(Q). Every exponent is a sum of w's
    (one sign), never the difference of two cumsums, so w = -12 stays
    finite and the rounding of a long cumsum never enters exp."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if chunk % SUB:
        raise ValueError(f"chunk must be a multiple of {SUB}, got {chunk}")
    ns = chunk // SUB
    f32 = torch.float32
    S = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state is None else state.float())
    uf = u.float()
    pad = (-T) % chunk
    r_, k_, v_, w_ = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                      for t in (r, k, v, w))
    ys = []
    for c0 in range(0, T + pad, chunk):
        # (B, ns, 16, H, .) views of the chunk, by sub-chunk
        rc, kc, vc, wc = (t[:, c0:c0 + chunk].reshape(B, ns, SUB, H, -1)
                          for t in (r_, k_, v_, w_))
        # sums restarted at each sub-chunk boundary, in step order: P the
        # exclusive prefix, Q the exclusive suffix
        P = torch.cat([torch.zeros_like(wc[:, :, :1]),
                       torch.cumsum(wc[:, :, :-1], dim=2)], dim=2)  # exclusive
        Q = torch.flip(torch.cat(
            [torch.zeros_like(wc[:, :, :1]),
             torch.cumsum(torch.flip(wc, [2])[:, :, :-1], dim=2)], dim=2),
            [2])
        tot = wc.sum(dim=2)                       # (B, ns, H, K)
        before = torch.cat([torch.zeros_like(tot[:, :1]),
                            torch.cumsum(tot, dim=1)[:, :-1]], dim=1)
        after = torch.flip(torch.cat(
            [torch.zeros_like(tot[:, :1]),
             torch.cumsum(torch.flip(tot, [1])[:, :-1], dim=1)], dim=1),
            [1])
        rt = rc * torch.exp(P)
        kt = kc * torch.exp(Q)
        kS = kc * torch.exp(Q + after[:, :, None])
        # the inter-chunk term
        y = torch.einsum("bnthk,bhkv->bnthv",
                         rt * torch.exp(before)[:, :, None], S)
        # A, (B, H, chunk, chunk), lower-triangular with the bonus on the
        # diagonal
        A = torch.zeros((B, H, chunk, chunk), dtype=f32, device=r.device)
        for i in range(ns):
            for j in range(i):
                mid = tot[:, j + 1:i].sum(dim=1)  # (B, H, K)
                A[:, :, SUB * i:SUB * (i + 1), SUB * j:SUB * (j + 1)] = \
                    torch.einsum("bthk,bshk->bhts", rt[:, i],
                                 kt[:, j] * torch.exp(mid)[:, None])
            ew = torch.exp(wc[:, i])              # (B, 16, H, K)
            for t in range(SUB):
                d = torch.ones_like(ew[:, 0])
                for s in range(t - 1, -1, -1):
                    A[:, :, SUB * i + t, SUB * i + s] = torch.einsum(
                        "bhk,bhk->bh", rc[:, i, t] * kc[:, i, s], d)
                    d = d * ew[:, s]
                A[:, :, SUB * i + t, SUB * i + t] = torch.einsum(
                    "bhk,hk,bhk->bh", rc[:, i, t], uf, kc[:, i, t])
        y = y.reshape(B, chunk, H, V) + torch.einsum(
            "bhts,bshv->bthv", A, vc.reshape(B, chunk, H, V))
        ys.append(y)
        S = torch.exp(tot.sum(dim=1))[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kS.reshape(B, chunk, H, K),
            vc.reshape(B, chunk, H, V))
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), S


def rwkv6_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA form (`repro/kernels/rwkv6_scan/ref.py::rwkv6_chunked`):
    T zero-padded to a multiple of `chunk` (no input, a decay of 1), then
    per chunk, with cw the inclusive and cwe the exclusive cumsum of w,

        A[t, s] = sum_k r_t k_s exp(min(cwe_t - cw_s, 0))    (s < t)
        y_t = sum_s A[t, s] v_s + (r_t . (u o k_t)) v_t
              + (r_t o exp(cwe_t))^T S
        S <- diag(exp(cw_last)) S + sum_s (exp(cw_last - cw_s) o k_s) v_s^T

    through the pairwise-difference tensor (every retained exponent <= 0)
    and the carried state. The same math as the sequential recurrence."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    S = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state is None else state.float())
    uf = u.float()
    pad = (-T) % chunk
    r_, k_, v_, w_ = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0,
                                                          pad))
                      for t in (r, k, v, w))
    idx = torch.arange(chunk, device=r.device)
    tri = idx[:, None] > idx[None, :]
    zero = torch.zeros((), dtype=f32, device=r.device)
    ys = []
    for s0 in range(0, T + pad, chunk):
        rc, kc, vc, wc = (t[:, s0:s0 + chunk] for t in (r_, k_, v_, w_))
        cw = torch.cumsum(wc, dim=1)                   # inclusive
        cwe = cw - wc                                  # exclusive
        diff = cwe[:, :, None] - cw[:, None, :]        # (B, t, s, H, K)
        diff = torch.where(tri[None, :, :, None, None], diff, zero)
        A = torch.einsum("bthk,bshk,btshk->bhts", rc, kc,
                         torch.exp(torch.clamp(diff, max=0.0)))
        A = torch.where(tri[None, None], A, zero)
        diag = torch.einsum("bthk,hk,bthk->bth", rc, uf, kc)
        y = torch.einsum("bhts,bshv->bthv", A, vc) + diag[..., None] * vc
        y = y + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cwe), S)
        ys.append(y)
        total = cw[:, -1]                              # (B, H, K)
        wgt = torch.exp(total[:, None] - cw)           # (B, c, H, K), <= 1
        S = torch.exp(total)[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kc * wgt, vc)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), S
