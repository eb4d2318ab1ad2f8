"""Launch wrapper of the Mamba-2 SSD scan CUDA kernel.

Replaces the TPU kernel `repro/kernels/mamba2_scan/kernel.py::mamba2_fwd`
with `csrc/mamba2_scan.cu`: one block per (batch, head) holds the (P, N)
state in registers and steps the recurrence over T in order. It reads x,
dt, B and C in the op's (B, T, H|G, ·) layout through strides, so the TPU
wrapper's moveaxis to (BH, T, ·), its padding of T to a multiple of the
chunk and its per-chunk grid axis do not exist here. See the note in the
source for the bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
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
    (B, H, P, N) or None (zeros): f32 CUDA tensors, x/Bm/Cm with unit stride
    on the last axis, state contiguous. Returns (y (B, T, H, P), final state
    (B, H, P, N)), both f32 and contiguous."""
    tensors = [("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("Bm", Bm, 4),
               ("Cm", Cm, 4)]
    if state is not None:
        tensors.append(("state", state, 4))
    refuse_grad("mamba2_fwd", *(t for _, t, _ in tensors))
    for name, t, dim in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != dim \
                or t.device != x.device:
            raise ValueError(f"mamba2_fwd: {name} must be a {dim}-D f32 "
                             f"tensor on {x.device}, got {t.dtype} "
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
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = [s for t in (x, dt, Bm, Cm) for s in t.stride()[:3]]
    check(library().sfp_mamba2_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), 0 if state is None else state.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), B, T, H, G, P, N, tpp, *strides,
        current_stream()), "sfp_mamba2_scan_fwd")
    mamba2_fwd.launches += 1
    return y, h_out


mamba2_fwd.launches = 0
