"""Launch wrapper of the RWKV-6 time-mix scan CUDA kernel.

Replaces the TPU kernel `repro/kernels/rwkv6_scan/kernel.py::rwkv6_fwd`
with `csrc/rwkv6_scan.cu`: one block per (batch, head), one thread per
state column holding its K values in registers, stepping the recurrence
exactly over T. It reads r, k, v and w in the op's (B, T, H, ·) layout
through strides, so the TPU wrapper's moveaxis to (BH, T, ·), its padding
of T to a multiple of the chunk and its per-chunk grid axis do not exist
here. Each of r, k, v, w, u and the state is read in f32, bf16 or f16 by the
kernel itself (as the TPU kernel's astype(f32)); y comes out in r's dtype,
the final state in f32. See the note in the source for the bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

K_MAX = 64           # csrc/rwkv6_scan.cu: kMaxK, state rows a thread holds
V_MAX = 1024         # one thread per state column


def rwkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None):
    """r, k, w (B, T, H, K), v (B, T, H, V), u (H, K), state (B, H, K, V) or
    None (zeros): CUDA tensors, each f32, bf16 or f16, r/k/v/w with unit stride
    on the last axis, u and state contiguous. Returns (y (B, T, H, V) in
    r's dtype, final state (B, H, K, V) f32), both contiguous."""
    tensors = [("r", r, 4), ("k", k, 4), ("v", v, 4), ("w", w, 4),
               ("u", u, 2)]
    if state is not None:
        tensors.append(("state", state, 4))
    refuse_grad("rwkv6_fwd", *(t for _, t, _ in tensors))
    codes = {name: dtype_code(f"rwkv6_fwd: {name}", t.dtype)
             for name, t, _ in tensors}
    for name, t, dim in tensors:
        if not t.is_cuda or t.dim() != dim or t.device != r.device:
            raise ValueError(f"rwkv6_fwd: {name} must be a {dim}-D CUDA "
                             f"tensor on r's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape != (B, T, H, V) \
            or u.shape != (H, K) \
            or (state is not None and state.shape != (B, H, K, V)):
        raise ValueError(
            f"rwkv6_fwd: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} w {tuple(w.shape)} u {tuple(u.shape)} "
            f"state {None if state is None else tuple(state.shape)} disagree")
    if any(t.stride(3) != 1 and t.shape[3] > 1 for t in (r, k, v, w)) \
            or not u.is_contiguous() \
            or (state is not None and not state.is_contiguous()):
        raise ValueError("rwkv6_fwd needs unit stride on the last axis of r, "
                         "k, v and w, and a contiguous u and state")
    if not (1 <= K <= K_MAX and 1 <= V <= V_MAX):
        raise ValueError(f"rwkv6_fwd takes K <= {K_MAX} and V <= {V_MAX}, "
                         f"got K={K} V={V}")
    y = torch.empty((B, T, H, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    strides = [s for t in (r, k, v, w) for s in t.stride()[:3]]
    inputs = [a for name, t, _ in tensors for a in (t.data_ptr(), codes[name])]
    if state is None:
        inputs += [0, 0]
    check(library().sfp_rwkv6_scan_fwd(
        *inputs, y.data_ptr(), s_out.data_ptr(), B, T, H, K, V, *strides,
        current_stream()), "sfp_rwkv6_scan_fwd")
    rwkv6_fwd.launches += 1
    return y, s_out


rwkv6_fwd.launches = 0
