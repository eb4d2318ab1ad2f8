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
