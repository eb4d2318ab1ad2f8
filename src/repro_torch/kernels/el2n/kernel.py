"""Launch wrapper of the fused EL2N/CE CUDA kernel.

Replaces the TPU kernel `repro/kernels/el2n/kernel.py::el2n_fwd` with
`csrc/el2n.cu` (see the note there): a warp a row with the row in
registers for V up to 1024, else a block a row that streams the row once.
No (N, V) probability tensor is ever written. The TPU wrapper's padding of
V to `block_v` and its LANES-wide outputs are TPU layout only: this takes
(N, V) logits through their row stride and gives (N,) outputs. It reads
f32, bf16 or f16 logits itself (a 16-bit value widened on load, as the TPU
kernel's astype(f32)); the outputs are f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

THREADS = 128                        # the warp layout's block: 4 rows
FEW_ROWS_THREADS = 512               # a block a row, below one block an SM
MANY_ROWS_THREADS = 256              # a block a row, from one block an SM
MAX_THREADS = 512                    # csrc/el2n.cu's launch bound
ROW_VALUES = 32                      # values of a row a lane holds (warp)
WARP_MAX_V = 32 * ROW_VALUES         # 1024: a warp a row
LAYOUTS = {"warp": 0, "block": 1}    # csrc/el2n.cu's codes

Plan = Tuple[str, int]


def el2n_plan(N: int, V: int, sms: int) -> Plan:
    """(layout, threads a block) of the EL2N kernel for N rows of V logits
    on a card of `sms` SMs: a warp a row up to V 1024 (4 rows a 128-thread
    block), else a block a row, of 512 threads below `sms` rows (each block
    alone on its SM: more loads in flight; (16, 152064) f32 14.8 us against
    22.4 at 256) and of 256 from `sms` rows on ((512, 152064) bf16 54.6 us
    against 56.1 at 512; `tools/time_el2n.py`, NVIDIA H100 80GB HBM3,
    700 W). A function of its arguments alone, so choosing it needs no
    device sync; no V is refused."""
    if V <= WARP_MAX_V:
        return "warp", THREADS
    return "block", MANY_ROWS_THREADS if N >= sms else FEW_ROWS_THREADS


def check_plan(plan: Plan, V: int) -> None:
    """Raise unless `plan` can score rows of V logits: the warp layout
    holds 1024 values, a block any V."""
    layout, threads = plan
    if layout not in LAYOUTS or threads % 32 or \
            not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"el2n_fwd: no such plan {plan}")
    if layout == "warp" and V > WARP_MAX_V:
        raise ValueError(f"el2n_fwd: plan {plan} holds rows of at most "
                         f"{WARP_MAX_V} values, got V = {V}")


def el2n_fwd(logits: torch.Tensor, labels: torch.Tensor,
             plan: Optional[Plan] = None):
    """logits (N, V) f32, bf16 or f16 CUDA with unit column stride (any row
    stride); labels (N,) int32 contiguous on the same device. `plan`
    overrides `el2n_plan` (the card's sweeps). Returns (el2n (N,), ce (N,))
    f32; a label outside [0, V) gives NaN."""
    refuse_grad("el2n_fwd", logits)
    code = dtype_code("el2n_fwd: logits", logits.dtype)
    if not logits.is_cuda or logits.dim() != 2:
        raise ValueError(f"el2n_fwd takes 2-D CUDA logits, got "
                         f"{logits.dtype} {tuple(logits.shape)} on "
                         f"{logits.device}")
    N, V = logits.shape
    if V < 1 or (logits.stride(1) != 1 and V > 1):
        raise ValueError(f"el2n_fwd needs V >= 1 and unit column stride, got "
                         f"shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if labels.device != logits.device or labels.dtype != torch.int32 \
            or tuple(labels.shape) != (N,) or not labels.is_contiguous():
        raise ValueError(f"el2n_fwd: labels must be contiguous int32 ({N},) "
                         f"on {logits.device}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")
    if plan is None:
        plan = el2n_plan(N, V, torch.cuda.get_device_properties(
            logits.device).multi_processor_count)
    check_plan(plan, V)
    layout, threads = plan
    el2n = torch.empty((N,), dtype=torch.float32, device=logits.device)
    ce = torch.empty((N,), dtype=torch.float32, device=logits.device)
    check(library().sfp_el2n_fwd(
        logits.data_ptr(), code, logits.stride(0), labels.data_ptr(),
        el2n.data_ptr(), ce.data_ptr(), N, V, LAYOUTS[layout], threads,
        current_stream()), "sfp_el2n_fwd")
    el2n_fwd.launches += 1
    return el2n, ce


el2n_fwd.launches = 0
