"""Launch wrapper of the Mamba-2 SSD scan CUDA kernel.

Replaces the TPU kernel `repro/kernels/mamba2_scan/kernel.py::mamba2_fwd`
with `csrc/mamba2_scan.cu`: one block per (batch, head) holds the (P, N)
state in registers and steps the recurrence over T in order. It reads x,
dt, B and C in the op's (B, T, H|G, ·) layout through strides, so the TPU
wrapper's moveaxis to (BH, T, ·), its padding of T to a multiple of the
chunk and its per-chunk grid axis do not exist here. Each of x, dt, A, B,
C and the state is read in f32 or bf16 by the kernel itself (as the TPU
kernel's astype(f32)); y comes out in x's dtype, the final state in f32.
See the note in the source for the bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

PER_THREAD = 16      # csrc/mamba2_scan.cu: kPer, state values a thread
MAX_THREADS = 1024


def threads_per_row(N: int) -> int:
    """Threads that share one row p of the state: the least power of two
    that leaves each at most PER_THREAD of the N columns."""
    tpp = 1
    while tpp * PER_THREAD < N:
        tpp *= 2
    return tpp


def mamba2_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor,
               state: Optional[torch.Tensor] = None):
    """x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, G, N), state
    (B, H, P, N) or None (zeros): CUDA tensors, each f32 or bf16, x/Bm/Cm
    with unit stride on the last axis, state contiguous. Returns (y (B, T,
    H, P) in x's dtype, final state (B, H, P, N) f32), both contiguous."""
    tensors = [("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("Bm", Bm, 4),
               ("Cm", Cm, 4)]
    if state is not None:
        tensors.append(("state", state, 4))
    refuse_grad("mamba2_fwd", *(t for _, t, _ in tensors))
    codes = {name: dtype_code(f"mamba2_fwd: {name}", t.dtype)
             for name, t, _ in tensors}
    for name, t, dim in tensors:
        if not t.is_cuda or t.dim() != dim or t.device != x.device:
            raise ValueError(f"mamba2_fwd: {name} must be a {dim}-D CUDA "
                             f"tensor on x's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (B, T, H) or A.shape != (H,) \
            or Bm.shape != (B, T, G, N) or Cm.shape != (B, T, G, N) \
            or (state is not None and state.shape != (B, H, P, N)) \
            or G < 1 or H % G:
        raise ValueError(
            f"mamba2_fwd: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"A {tuple(A.shape)} Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
            f"state {None if state is None else tuple(state.shape)} "
            f"disagree (G must divide H)")
    if (x.stride(3) != 1 and P > 1) or (Bm.stride(3) != 1 and N > 1) \
            or (Cm.stride(3) != 1 and N > 1) or (A.stride(0) != 1 and H > 1) \
            or (state is not None and not state.is_contiguous()):
        raise ValueError("mamba2_fwd needs unit stride on the last axis of "
                         "x, Bm, Cm and A, and a contiguous state")
    tpp = threads_per_row(N)
    if tpp > 32 or P * tpp > MAX_THREADS:
        raise ValueError(f"mamba2_fwd takes N <= {32 * PER_THREAD} and "
                         f"P * threads_per_row(N) <= {MAX_THREADS}, got "
                         f"P={P} N={N}")
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = [s for t in (x, dt, Bm, Cm) for s in t.stride()[:3]]
    inputs = [a for name, t, _ in tensors for a in (t.data_ptr(), codes[name])]
    if state is None:
        inputs += [0, 0]
    check(library().sfp_mamba2_scan_fwd(
        *inputs, y.data_ptr(), h_out.data_ptr(), B, T, H, G, P, N, tpp,
        *strides, current_stream()), "sfp_mamba2_scan_fwd")
    mamba2_fwd.launches += 1
    return y, h_out


mamba2_fwd.launches = 0
