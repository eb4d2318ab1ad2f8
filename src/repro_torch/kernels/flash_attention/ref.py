"""Plain PyTorch version of attention (the counterpart of
`repro/kernels/flash_attention/ref.py::attention`).

Supports GQA (n_q_heads a multiple of n_kv_heads), causal masking with a
query position offset (prefill continuation / decode), sliding windows, logit
softcapping (gemma-2), and explicit kv position/validity arrays (ring-buffer
decode caches pass non-contiguous kv slot positions).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # finite large-negative: avoids NaNs for fully-masked rows


def attention(
    q: torch.Tensor,              # (B, Sq, Hq, Dh)
    k: torch.Tensor,              # (B, Skv, Hkv, Dh)
    v: torch.Tensor,              # (B, Skv, Hkv, Dv)
    *,
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,   # (B,) absolute position of q[:,0]
    kv_positions: Optional[torch.Tensor] = None,  # (B, Skv) absolute pos, -1 = empty
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    group = Hq // Hkv
    if scale is None:
        scale = Dh ** -0.5
    dev = q.device

    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    q_pos = q_offset[:, None] + torch.arange(Sq, dtype=torch.int32,
                                             device=dev)[None, :]  # (B,Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32,
                                    device=dev)[None, :].expand(B, Skv)

    # (B, Sq, Skv) mask
    valid = kv_positions[:, None, :] >= 0
    if causal:
        valid = valid & (kv_positions[:, None, :] <= q_pos[:, :, None])
    if sliding_window is not None:
        valid = valid & (kv_positions[:, None, :]
                         > q_pos[:, :, None] - sliding_window)

    kg = torch.repeat_interleave(k, group, dim=2)  # (B, Skv, Hq, Dh)
    vg = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, None, :, :], logits,
                         logits.new_full((), NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    p = p / torch.clamp_min(denom, 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vg.float())
    return out.to(q.dtype)


def split_attention(
    q: torch.Tensor,              # (B, Sq, Hq, Dh)
    k: torch.Tensor,              # (B, Skv, Hkv, Dh)
    v: torch.Tensor,              # (B, Skv, Hkv, Dv)
    *,
    rows: int,
    splits: int,
    group: int = 1,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    tile: int = 32,
) -> torch.Tensor:
    """The narrow f32 prefill kernel's key split, in plain PyTorch: query
    blocks of rows // group positions (csrc/flash_attention.cu::
    flash_narrow_kernel), each block's key range as the kernel walks it
    (from the window's start to kv_len or the causal diagonal; every key
    when a row of the block is fully masked) cut into `splits` contiguous
    shares of `tile`-key tiles, each share's unnormalised (m, l, acc) of
    every row over its keys (masked keys at NEG_INF, keys outside the share
    absent; an empty share l = 0), merged as decode_combine_kernel
    (csrc/decode_common.cuh) merges them. Equals `attention` over keys
    0..kv_len-1 up to rounding."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    kv_len = Skv if kv_len is None else kv_len
    scale = Dh ** -0.5 if scale is None else scale
    W = sliding_window or 0
    dev = q.device
    kg = torch.repeat_interleave(k.float(), G, dim=2)
    vg = torch.repeat_interleave(v.float(), G, dim=2)
    m_all = torch.full((B, Hq, Sq, splits), NEG_INF, device=dev)
    l_all = torch.zeros((B, Hq, Sq, splits), device=dev)
    acc_all = torch.zeros((B, Hq, Sq, splits, Dv), device=dev)
    QR = rows // group
    for q0 in range(0, Sq, QR):
        q_last = min(q0 + QR, Sq) - 1
        kv_begin = max(0, q0 - W + 1) if W else 0
        kv_end = min(kv_len, q_last + 1) if causal else kv_len
        if W and q_last >= kv_len + W - 1:
            kv_begin, kv_end = 0, kv_len   # a fully masked row: every key
        n_all = -(-(kv_end - kv_begin) // tile)
        pos = torch.arange(q0, q_last + 1, device=dev)
        for s in range(splits):
            lo = kv_begin + s * n_all // splits * tile
            hi = min(kv_end, kv_begin + (s + 1) * n_all // splits * tile)
            if hi <= lo:
                continue
            keys = torch.arange(lo, hi, device=dev)
            logits = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q_last + 1]
                                  .float(), kg[:, lo:hi]) * scale
            if softcap is not None:
                logits = softcap * torch.tanh(logits / softcap)
            valid = torch.ones((len(pos), len(keys)), dtype=torch.bool,
                               device=dev)
            if causal:
                valid &= keys[None] <= pos[:, None]
            if W:
                valid &= keys[None] > pos[:, None] - W
            logits = torch.where(valid, logits, logits.new_full((), NEG_INF))
            m = logits.amax(-1)
            p = torch.exp(logits - m[..., None])
            m_all[:, :, q0:q_last + 1, s] = m
            l_all[:, :, q0:q_last + 1, s] = p.sum(-1)
            acc_all[:, :, q0:q_last + 1, s] = torch.einsum(
                "bhqk,bkhd->bhqd", p, vg[:, lo:hi])
    has = l_all > 0
    mx = torch.where(has, m_all, m_all.new_full((), -float("inf"))).amax(-1)
    f = torch.where(has, torch.exp(m_all - mx[..., None]), 0.0)
    denom = (f * l_all).sum(-1)
    out = (f[..., None] * acc_all).sum(-2) / torch.clamp_min(
        denom, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
