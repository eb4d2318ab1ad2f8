"""Launch wrapper of the causal GQA prefill attention CUDA kernel.

Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
flash_attention_fwd` with `csrc/flash_attention.cu`. That kernel is bound by
arithmetic (fp32, no tensor cores yet); it reads q, k and v in the model's
(B, S, H, Dh) layout through strides, so none of the TPU wrapper's
transpose, reshape and pad copies exist, and it masks the ragged Sq/Skv
edge itself. See the note in the source for the tiling.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import check, current_stream, library

D_MAX = 128   # csrc/attention_common.cuh: kDMax


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, sliding_window: Optional[int],
                        softcap: Optional[float], scale: float,
                        kv_len: int) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k (B, Skv, Hkv, Dh), v (B, Skv, Hkv, Dv): f32 CUDA
    tensors with unit stride on the last axis; keys at or past `kv_len`
    are absent. Returns (B, Sq, Hq, Dv) f32."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be a 4-D f32 "
                             f"CUDA tensor, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_fwd: {name} needs unit stride "
                             f"on head_dim")
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    if k.shape != (B, Skv, Hkv, Dh) or v.shape[:3] != (B, Skv, Hkv) \
            or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if Hq % Hkv or Dh > D_MAX or Dv > D_MAX:
        raise ValueError(f"flash_attention_fwd takes Hq % Hkv == 0 and "
                         f"head_dim <= {D_MAX}, got Hq={Hq} Hkv={Hkv} "
                         f"Dh={Dh} Dv={Dv}")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"flash_attention_fwd: kv_len {kv_len} outside "
                         f"[1, {Skv}]")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty((B, Sq, Hq, Dv), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    check(library().sfp_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, Dh, Dv, *strides, int(causal),
        int(sliding_window or 0), float(softcap or 0.0), float(scale),
        int(kv_len), current_stream()), "sfp_flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
