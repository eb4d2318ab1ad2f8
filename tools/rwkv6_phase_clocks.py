#!/usr/bin/env python3
"""Where the RWKV-6 chunked kernel's time goes: cycles a call in each of
its phases, read by clock64() in block 0's first thread from a copy of a
checkout's sources with timers patched in, at rwkv6-3b's heads (H 40, K =
V = 64) for batch-1 prefill at T 132 and T 36.

    python3 tools/rwkv6_phase_clocks.py [CHECKOUT] [--coded]

The phases: the prologue (the state's columns, u, the first chunk's
copies issued), then summed over the chunks: the next chunk's copies and
the wait for this one's, 2a (the partial sums), 2b (the exp factors),
(a) + (b) as warp 0 runs them (the inter-chunk y term and A's
off-diagonal sub-blocks), the rest of phase 3 (the diagonal sub-blocks,
and the wait at its barrier), and phase 4 (A v, y, the state update).
With --coded the copy's entry point takes the coded instantiation for
every dtype mix (k, v and w read through their dtype codes), so the two
builds can be compared on the serving path's f32 inputs. The copy builds
into its own directory under the checkout's `build/`; the checkout itself
is not modified.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

PHASES = ("prologue", "copies + wait", "2a", "2b", "3 rest (+ wait)", "4",
          "3 (a)+(b), warp 0")


def patched_copy(checkout: Path, coded: bool) -> Path:
    var = checkout / "build" / ("rwkv6_phase_clocks" + "_coded" * coded)
    if var.exists():
        shutil.rmtree(var)
    shutil.copytree(checkout / "src", var / "src")
    p = var / "src" / "repro_torch" / "csrc" / "rwkv6_scan.cu"
    s = p.read_text()

    def put(anchor: str, text: str, before: bool = False) -> None:
        nonlocal s
        if anchor not in s:
            sys.exit(f"rwkv6_phase_clocks: anchor not found: {anchor!r}")
        s = s.replace(anchor, text + anchor if before else anchor + text, 1)

    put("namespace {\n\nusing namespace sfp;\n",
        "#define CLK(i) if (blockIdx.x == 0 && blockIdx.y == 0 && "
        "blockIdx.z == 0 && threadIdx.x == 0) { const long long n_ = "
        "clock64(); g_clk[i] += n_ - last_; last_ = n_; }\n")
    put("namespace {\n\nusing namespace sfp;",
        "__device__ long long g_clk[16];\n", before=True)
    put("  if (n_chunks > 0) issue(0);\n", "  long long last_ = clock64();\n",
        before=True)
    put("  for (int c = 0; c < n_chunks; ++c) {\n", "  CLK(0)\n", before=True)
    for i, tag in enumerate(("    // 2a.", "    // 2b.", "    // 3. (a)",
                             "    // 4. (d)"), 1):
        put(tag, f"    CLK({i})\n", before=True)
    put("    {\n      // rows qa and 15 - qa", "    CLK(6)\n", before=True)
    put("    __syncthreads();\n  }\n\n  // the block's columns of the final",
        "    CLK(5)\n", before=True)
    s = s.replace("    CLK(5)\n    __syncthreads();\n  }\n",
                  "    __syncthreads();\n    CLK(5)\n  }\n", 1)
    if coded:
        put("  const bool typed = ", "false && ")
    s += ('\nextern "C" int sfp_rwkv6_clocks(long long* out) {\n'
          "  cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * 16);\n"
          "  long long z[16] = {0};\n"
          "  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n}\n")
    p.write_text(s)
    return var


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--coded"]
    coded = "--coded" in sys.argv[1:]
    checkout = Path(args[0] if args else
                    Path(__file__).resolve().parents[1]).resolve()
    var = patched_copy(checkout, coded)
    sys.path.insert(0, str(var / "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    build.BUILD_DIR = var / "build"
    clocks = build.library().sfp_rwkv6_clocks
    clocks.argtypes = [ctypes.c_void_p]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = (ctypes.c_longlong * 16)()
    for B, T in ((1, 132), (1, 36)):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        args = (rand(B, T, 40, 64), rand(B, T, 40, 64), rand(B, T, 40, 64),
                -torch.exp(rand(B, T, 40, 64) - 1.0), rand(40, 64),
                rand(B, 40, 64, 64))
        for _ in range(3):
            rwkv6_fwd(*args)
        torch.cuda.synchronize()
        clocks(buf)
        n = 20
        for _ in range(n):
            rwkv6_fwd(*args)
        torch.cuda.synchronize()
        clocks(buf)
        total = sum(buf[i] for i in range(len(PHASES)))
        print(f"{'coded' if coded else 'typed'} B {B} T {T}: cycles a "
              f"call: " + ", ".join(
            f"{name} {buf[i] / n:.0f}" for i, name in enumerate(PHASES))
            + f"; total {total / n:.0f}", flush=True)


if __name__ == "__main__":
    main()
