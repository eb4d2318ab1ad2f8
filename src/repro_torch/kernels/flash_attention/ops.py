"""Public attention op, dispatched by call shape and device.

Single-query cache reads (Sq=1 with q_offset / explicit kv_positions — the
decode hot path, including ring-buffer caches) go to `decode.py`'s
`decode_attention`. Calls without positions (prefill from position 0) go to
the prefill kernel on a CUDA tensor and to the plain `ref.attention` on a
CPU one.

Multi-query calls WITH positions (the paged engine's chunked-prefill
continuation) run the plain `ref.attention` on every device. That is what
the JAX package does on every backend, the TPU included
(`repro/kernels/flash_attention/ops.py:91-95`): no Pallas kernel computes
this call, so no TPU kernel is replaced here. A kernel of the port's own
for it is later work.

Decode against a PAGE POOL (per-slot block tables instead of per-slot
caches) is `decode.paged_decode_attention`, re-exported here: its callers
hold a pool and block tables, so it never routes through `flash_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.decode import (
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd

__all__ = ["flash_attention", "prefill_attention", "decode_attention",
           "paged_decode_attention"]


def prefill_attention(q, k, v, *, causal=True, sliding_window=None,
                      softcap=None, scale=None, kv_len=None):
    """Attention of q (B, Sq, Hq, Dh) over keys 0..kv_len-1 of k, v
    (B, Skv, Hkv, D), query i at position i; keys past kv_len are absent."""
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_cuda(q):
        return ref.attention(q, k[:, :kv_len], v[:, :kv_len], causal=causal,
                             sliding_window=sliding_window, softcap=softcap,
                             scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               softcap=softcap, scale=scale, kv_len=kv_len)


def flash_attention(
    q: torch.Tensor,              # (B, Sq, Hq, Dh)
    k: torch.Tensor,              # (B, Skv, Hkv, Dh)
    v: torch.Tensor,              # (B, Skv, Hkv, Dv)
    *,
    q_offset: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    needs_pos = q_offset is not None or kv_positions is not None
    if needs_pos and causal and q.shape[1] == 1:
        B, Skv = k.shape[0], k.shape[1]
        q_positions = (torch.zeros((B,), dtype=torch.int32, device=q.device)
                       if q_offset is None else q_offset)
        kvp = (torch.arange(Skv, dtype=torch.int32,
                            device=q.device)[None].expand(B, Skv)
               if kv_positions is None else kv_positions)
        return decode_attention(
            q, k, v, q_positions=q_positions, kv_positions=kvp,
            sliding_window=sliding_window, softcap=softcap, scale=scale)
    if needs_pos:
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_positions=kv_positions,
                             sliding_window=sliding_window, softcap=softcap,
                             scale=scale)
    return prefill_attention(q, k, v, causal=causal,
                             sliding_window=sliding_window, softcap=softcap,
                             scale=scale)
