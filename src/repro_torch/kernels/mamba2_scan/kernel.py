"""Launch wrapper of the Mamba-2 SSD scan CUDA kernels.

Replaces the TPU kernel `repro/kernels/mamba2_scan/kernel.py::mamba2_fwd`
with `csrc/mamba2_scan.cu`, two kernels behind one entry point, picked by
shape: for T up to `STEP_MAX_T` (every decode step) the step kernel, which
streams the (B, H, P, N) state through once in 16-byte accesses; above it
the chunked kernel, the SSD form the TPU kernel computes (three products a
chunk on 3xTF32 tensor cores, blocks of 32 state rows). Both read x, dt, B
and C in the op's (B, T, H|G, ·) layout through strides, so the TPU
wrapper's moveaxis to (BH, T, ·) and its padding of T to a multiple of the
chunk do not exist here. x, B, C, dt, A and the state each have their own
dtype, f32, bf16 or f16, read by the kernels themselves (as the TPU
kernel's astype(f32)); y comes out in x's dtype, the final state in
f32, written into `state_out` when the caller gives one (it may be the
input state: the serving caches update in place). See the note in the
source for the bounds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

# The crossover: T at or below it takes the step kernel, above it the
# chunked one. chip_smoke.py's sweep at zamba2's heads (device ms, NVIDIA
# H100 80GB HBM3, 700 W): at 1 slot the two meet at T 4 (0.0135 step,
# 0.0137 chunked), at 8 slots at T 8-16; T 4 splits the difference
STEP_MAX_T = 4
STEP_MAX_N = 128     # the step kernel's 32 lanes of 4 columns a row
CHUNK = 32           # csrc/mamba2_scan.cu: kC, steps a chunk
CHUNK_MAX_N = 568    # the largest N whose chunked block fits the 227 KB of
#                      shared memory a block may have with one stage of
#                      inputs (chunk_smem_floats; two stages up to N 328)


def uses_step_kernel(T: int, N: int) -> bool:
    return T <= STEP_MAX_T and N <= STEP_MAX_N


def mamba2_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor,
               state: Optional[torch.Tensor] = None, *,
               state_out: Optional[torch.Tensor] = None):
    """x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, G, N), state
    (B, H, P, N) or None (zeros): CUDA tensors, each f32, bf16 or f16, x,
    Bm and Cm with unit stride on the last axis, state contiguous.
    `state_out`: a contiguous f32 (B, H, P, N) tensor that receives the
    final state, the input state itself or one that does not overlap it;
    None allocates one. Returns (y (B, T, H, P) in x's dtype, contiguous;
    the final state)."""
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
    if state_out is None:
        state_out = torch.empty((B, H, P, N), dtype=torch.float32,
                                device=x.device)
    elif state_out.shape != (B, H, P, N) or state_out.dtype != torch.float32 \
            or state_out.device != x.device \
            or not state_out.is_contiguous():
        raise ValueError(f"mamba2_fwd: state_out must be a contiguous "
                         f"float32 {(B, H, P, N)} tensor on x's device, got "
                         f"{state_out.dtype} {tuple(state_out.shape)} on "
                         f"{state_out.device}")
    step = uses_step_kernel(T, N)
    if not step and N > CHUNK_MAX_N:
        raise ValueError(f"mamba2_fwd takes N <= {CHUNK_MAX_N} above T "
                         f"{STEP_MAX_T} or N {STEP_MAX_N} (the chunked "
                         f"kernel's shared memory), got N={N}")
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    strides = [s for t in (x, dt, Bm, Cm) for s in t.stride()[:3]]
    h0 = (state.data_ptr(), codes["state"]) if state is not None else (0, 0)
    check(library().sfp_mamba2_scan_fwd(
        x.data_ptr(), codes["x"], Bm.data_ptr(), codes["Bm"],
        Cm.data_ptr(), codes["Cm"], dt.data_ptr(), codes["dt"],
        A.data_ptr(), codes["A"], *h0,
        y.data_ptr(), state_out.data_ptr(), B, T, H, G, P, N, int(step),
        *strides, current_stream()), "sfp_mamba2_scan_fwd")
    mamba2_fwd.launches += 1
    return y, state_out


mamba2_fwd.launches = 0
