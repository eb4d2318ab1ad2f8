"""Launch wrapper of the RWKV-6 time-mix scan CUDA kernels.

Replaces the TPU kernel `repro/kernels/rwkv6_scan/kernel.py::rwkv6_fwd`
with `csrc/rwkv6_scan.cu`, two kernels behind one entry point, picked by
shape: for T up to `STEP_MAX_T` (every decode step) the step kernel, which
streams the (B, H, K, V) state through once in 16-byte accesses; above it
the chunked kernel, the sub-chunk-stabilised chunked form (the inter-chunk
term, the off-diagonal sub-blocks, A v and the state update on 3xTF32
tensor cores, the diagonal sub-blocks on CUDA cores; blocks of `COLS`
state columns). Both read r, k, v and w in the op's (B, T, H, ·) layout
through strides, so the TPU wrapper's moveaxis to (BH, T, ·), its padding
of T to a multiple of the chunk and its per-chunk grid axis do not exist
here. r, k, v, w, u and the state each have their own dtype, f32, bf16 or
f16, read by the kernels themselves (as the TPU kernel's astype(f32)); y
comes out in r's dtype, the final state in f32, written into `state_out`
when the caller gives one (it may be the input state: the serving caches
update in place). See the note in the source for the bounds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

K_MAX = 64           # csrc/rwkv6_scan.cu: kMaxK, state rows
V_MAX = 1024
# The crossover: T at or below it takes the step kernel, above it the
# chunked one. chip_smoke.py's sweep at rwkv6-3b's heads (device ms, NVIDIA
# H100 80GB HBM3, 700 W): at 1 slot step 0.0069 against chunked 0.0089 at
# T 4, 0.0114 against 0.0089 at T 8; at 8 slots the step kernel wins up to
# T 16 (0.0252 against 0.0421). Serving runs T 1 and prompts of 36-132.
STEP_MAX_T = 4
# The chunked kernel's shape (csrc/rwkv6_scan.cu: kDefNS, kDefNV): steps a
# chunk and state columns a block. chip_smoke.py's sweep at batch-1 prefill
# (T 132, device ms): chunks of 32 with 32 columns 0.0321, of 64 0.0366,
# 16 columns a block 0.0547 and 0.0617. The other shapes take f32 inputs
# only.
CHUNK = 32
COLS = 32


def uses_step_kernel(T: int) -> bool:
    return T <= STEP_MAX_T


def rwkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None, *,
              state_out: Optional[torch.Tensor] = None):
    """r, k, w (B, T, H, K), v (B, T, H, V), u (H, K), state (B, H, K, V) or
    None (zeros): CUDA tensors, each f32, bf16 or f16, r/k/v/w with unit
    stride on the last axis, u and state contiguous. `state_out`: a
    contiguous f32 (B, H, K, V) tensor that receives the final state, the
    input state itself or one that does not overlap it; None allocates
    one. Returns (y (B, T, H, V) in r's dtype, contiguous; the final
    state)."""
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
    if state_out is None:
        state_out = torch.empty((B, H, K, V), dtype=torch.float32,
                                device=r.device)
    elif state_out.shape != (B, H, K, V) \
            or state_out.dtype != torch.float32 \
            or state_out.device != r.device \
            or not state_out.is_contiguous():
        raise ValueError(f"rwkv6_fwd: state_out must be a contiguous "
                         f"float32 {(B, H, K, V)} tensor on r's device, got "
                         f"{state_out.dtype} {tuple(state_out.shape)} on "
                         f"{state_out.device}")
    y = torch.empty((B, T, H, V), dtype=r.dtype, device=r.device)
    strides = [s for t in (r, k, v, w) for s in t.stride()[:3]]
    inputs = [a for name, t, _ in tensors for a in (t.data_ptr(), codes[name])]
    if state is None:
        inputs += [0, 0]
    check(library().sfp_rwkv6_scan_fwd(
        *inputs, y.data_ptr(), state_out.data_ptr(), B, T, H, K, V,
        int(uses_step_kernel(T)), CHUNK, COLS, *strides, current_stream()),
        "sfp_rwkv6_scan_fwd")
    rwkv6_fwd.launches += 1
    return y, state_out


rwkv6_fwd.launches = 0
