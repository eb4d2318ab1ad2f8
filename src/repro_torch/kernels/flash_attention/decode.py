"""Decode attention: one query token per slot against its KV cache.

The serving hot path. Every decode step attends a single query token per
slot to that slot's ring-buffer cache. Two versions of the same function:

  `decode_attention_fwd` — the launch wrapper of `csrc/decode_attention.cu`,
      the Hopper kernel that replaces the TPU kernel
      `repro/kernels/flash_attention/decode.py::decode_attention_fwd`. It is
      bound by reading the cache; one block per (slot, kv head) reads that
      head's tiles once for the whole GQA group, straight from the model's
      (B, W, Hkv, Dh) layout — no moveaxis or pad copy of the cache per
      call. See the note in the source.
  `grouped_decode` — the plain version (the counterpart of `_xla_decode`):
      the (B, W, Hkv) cache contracted against (B, Hkv, G) query rows with
      no materialized head repeat.

`decode_attention` picks by device: the plain version for CPU tensors, the
kernel for CUDA tensors. Masking is wholly data-driven (kv validity +
position vs the slot's query position), so ragged per-slot lengths and
ring-buffer layouts need no host-side bookkeeping.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.build import check, current_stream, library
from repro_torch.kernels.flash_attention.kernel import D_MAX

MASK_VALUE = -2.0 ** 30
MAX_GROUP = 8    # csrc/decode_attention.cu: kMaxGroup


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor,
                         kv_positions: torch.Tensor, *, scale: float,
                         sliding_window: Optional[int],
                         softcap: Optional[float]) -> torch.Tensor:
    """q (B, 1, Hq, Dh), k (B, W, Hkv, Dh), v (B, W, Hkv, Dv) f32 CUDA with
    unit stride on head_dim; q_positions (B,) and kv_positions (B, W)
    int32 on the same device. Returns (B, 1, Hq, Dv) f32."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 4:
            raise ValueError(f"decode_attention_fwd: {name} must be a 4-D f32"
                             f" CUDA tensor, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"decode_attention_fwd: {name} needs unit "
                             f"stride on head_dim")
    B, Sq, Hq, Dh = q.shape
    _, W, Hkv, Dv = v.shape
    if Sq != 1 or k.shape != (B, W, Hkv, Dh) or v.shape[:3] != (B, W, Hkv):
        raise ValueError(f"decode_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP or Dh > D_MAX or Dv > D_MAX:
        raise ValueError(f"decode_attention_fwd takes a GQA group <= "
                         f"{MAX_GROUP} and head_dim <= {D_MAX}, got Hq={Hq} "
                         f"Hkv={Hkv} Dh={Dh} Dv={Dv}")
    for name, t, shape in (("q_positions", q_positions, (B,)),
                           ("kv_positions", kv_positions, (B, W))):
        if t.dtype != torch.int32 or t.device != q.device \
                or tuple(t.shape) != shape:
            raise ValueError(f"decode_attention_fwd: {name} must be int32 "
                             f"{shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("decode_attention_fwd: q, k, v on different devices")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty((B, 1, Hq, Dv), dtype=torch.float32, device=q.device)
    check(library().sfp_decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(), B, W, Hq, Hkv, Dh, Dv,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), q_positions.stride(0),
        kv_positions.stride(0), kv_positions.stride(1), out.stride(0),
        out.stride(2), int(sliding_window or 0), float(softcap or 0.0),
        float(scale), current_stream()), "sfp_decode_attention_fwd")
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0


def grouped_decode(q, k, v, q_positions, kv_positions, *, scale,
                   sliding_window, softcap):
    """Grouped single-query attention without the GQA head repeat: the
    (B, W, Hkv) cache is contracted directly against (B, Hkv, G) query rows,
    so memory traffic stays at the KV-cache footprint instead of group x."""
    B, Sq, Hq, Dh = q.shape
    _, W, Hkv, Dv = v.shape
    G = Hq // Hkv
    qg = q[:, 0].reshape(B, Hkv, G, Dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_positions[:, None]
    valid = (kv_positions >= 0) & (kv_positions <= qp)
    if sliding_window is not None:
        valid = valid & (kv_positions > qp - sliding_window)
    s = torch.where(valid[:, None, None, :], s, s.new_full((), MASK_VALUE))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, 1, Hq, Dh) — ONE token per slot
    k: torch.Tensor,              # (B, W, Hkv, Dh) — the slot's KV cache
    v: torch.Tensor,              # (B, W, Hkv, Dv)
    *,
    q_positions: torch.Tensor,    # (B,) absolute position of the query
    kv_positions: torch.Tensor,   # (B, W) absolute positions, -1 = empty
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-query cache-read attention for the decode hot path.
    `causal=False` is rejected: decode attention is causal by construction."""
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention is single-query, got {q.shape}")
    if not causal:
        raise ValueError("decode attention is causal by construction")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_cuda(q):
        return grouped_decode(q, k, v, q_positions, kv_positions, scale=scale,
                              sliding_window=sliding_window, softcap=softcap)
    return decode_attention_fwd(
        q, k, v, q_positions.to(torch.int32), kv_positions.to(torch.int32),
        scale=scale, sliding_window=sliding_window, softcap=softcap)
