"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled for Hopper (`sm_90a`) by its own
`nvcc -c` — all started together — and the objects are linked into ONE
shared library with a plain C interface, loaded with `ctypes`. Nothing
includes PyTorch's headers, so a cold build takes seconds.

The library lands in `build/repro_torch_kernels/` at the repository root
(git-ignored), named by a digest of the sources and flags: an edited source
rebuilds, an unchanged one loads the cached `.so`. `-Xptxas=-v` is always
on and its report (registers, shared memory, spills per kernel) is kept in
`build.log` beside the library.

No `--use_fast_math`: the int8 quantizer must match its plain version bit
for bit, which needs IEEE `x / scale` and `floorf`.

Importing this module needs neither `nvcc` nor a GPU; `library()` builds
on first use and raises if the toolkit is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes. Every function returns cudaGetLastError().
# A floating tensor's pointer is followed (or, for attention, preceded) by
# its dtype code (`kernels.dtype_code`: 0 f32, 1 bf16, 2 f16).
SIGNATURES = {
    "sfp_quantize_int8": [_P, _I, _L, _P, _L, _L, _F, _P, _P, _I, _I,
                          _I, _I, _I, _P],
    #                     x, x dtype, x row stride, u (or null), u strides,
    #                     u's value (when null), values, scales, N, D,
    #                     layout, blocks a row, threads a block (the
    #                     plan of kernels/quant/kernel.py::quantize_plan),
    #                     stream
    "sfp_dequantize_int8": [_P, _P, _P, _I, _I, _I, _P],
    #                       values, scales, out, out dtype, N, D, stream
    "sfp_flash_attention_fwd": (
        [_P, _P, _P, _P, _I]                  # q, k, v, out, their dtype
        + [_I] * 7                            # B, Sq, Skv, Hq, Hkv, Dh, Dv
        + [_L] * 12                           # (b, s, h) strides of q, k, v, out
        + [_I, _I, _F, _F, _I, _I, _I, _I, _P, _P]),
    #                                           causal, window, softcap, scale,
    #                                           kv_len; prefill_plan's rows a
    #                                           block, splits and group;
    #                                           workspace (B, Sq, Hq, splits,
    #                                           Dv + 2) or null; stream
    "sfp_decode_attention_fwd": (
        [_P, _I, _P, _P, _I]                  # q, its dtype (the output's);
        #                                       k, v, their dtype
        + [_P] * 4                            # q_pos, kv_pos, out, workspace
        #                                       (B, Hq, S, Dv + 2) or null
        + [_I] * 7                            # B, W, Hq, Hkv, Dh, Dv, S
        + [_L] * 13                           # q (b, h); k, v (b, w, h);
        #                                       q_pos (b); kv_pos (b, w); out (b, h)
        + [_I, _F, _F, _P]),                  # window, softcap, scale, stream
    "sfp_paged_decode_attention_fwd": (
        [_P, _I, _P, _P, _I]                  # q, its dtype (the output's);
        #                                       k_pool, v_pool, their dtype
        + [_P] * 5                            # tables, q_pos, kv_pos, out,
        #                                       workspace (B, Hq, S, Dv + 2)
        #                                       or null
        + [_I] * 8                            # B, nb, page, Hq, Hkv, Dh, Dv,
        #                                       S (splits of each row)
        + [_L] * 15                           # q (b, h); k, v pools (p, o, h);
        #                                       tables (b, n); q_pos (b);
        #                                       kv_pos (p, o); out (b, h)
        + [_I, _F, _F, _P]),                  # window, softcap, scale, stream
    "sfp_el2n_fwd": (
        [_P, _I, _L, _P, _P, _P]              # logits, dtype, row stride,
        #                                       labels, el2n, ce
        + [_I] * 4                            # N, V, layout, threads a
        #                                       block (the plan of
        #                                       kernels/el2n/kernel.py::
        #                                       el2n_plan)
        + [_P]),                              # stream
    "sfp_masked_encode": (
        [_P, _I, _P, _P, _I, _F, _P, _L, _P]),  # x (or null), x dtype,
    #                                           seeds, signs, J, scale, out,
    #                                           n, stream
    "sfp_mamba2_scan_fwd": (
        [_P, _I] * 6                          # x, Bm, Cm, dt, A, h0 (or
        #                                       null), each with its dtype
        + [_P, _P]                            # y (x's dtype), h_out (f32,
        #                                       may be h0)
        + [_I] * 7                            # B, T, H, G, P, N, step (the
        #                                       step kernel, else chunked)
        + [_L] * 12                           # (b, t, h|g) strides of x, dt,
        #                                       Bm, Cm
        + [_P]),                              # stream
    "sfp_rwkv6_scan_fwd": (
        [_P, _I] * 6                          # r, k, v, w, u, s0 (or null),
        #                                       each with its dtype
        + [_P, _P]                            # y (r's dtype), s_out (f32,
        #                                       may be s0)
        + [_I] * 8                            # B, T, H, K, V, step (the step
        #                                       kernel, else chunked), chunk,
        #                                       cols (the chunked kernel's
        #                                       steps a chunk, columns a block)
        + [_L] * 12                           # (b, t, h) strides of r, k, v, w
        + [_P]),                              # stream
    "sfp_mma_probe": [_P, _I, _I, _I, _P],    # out, blocks, warps a block,
    #                                           iterations, stream
}

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of the CUDA compiler; raises where the toolkit is missing."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from src/repro_torch/csrc at first use")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsfprompt_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link one shared library;
    a no-op when the digest-named library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    tag = out.stem.rsplit("_", 1)[1]
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        procs.append((src, obj, subprocess.Popen(
            [cc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [cc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's argtypes declared so pointers are passed as 64-bit values."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def current_stream() -> int:
    """PyTorch's current CUDA stream as the raw handle the kernels take."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def timed_build() -> float:
    """Build (or find) the library and load it; returns seconds taken."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0
