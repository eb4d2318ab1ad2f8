#!/usr/bin/env python3
"""Where the f32 prefill kernel's wide layout spends its time: clock64()
stamps of the longest block's first thread (block (0, 0, 0) of a causal
call: head 0's last query rows, every key tile), read from a copy of a
checkout's sources with the stamps patched in, at gemma2-9b's heads (16 /
8 x 256, softcap 50) with 16 and 32 rows a block, and deepseek-v3's MLA
(q/k 192, v 128, G 1) at 64 and 128 heads, S 132; then that copy's device
ms at gemma2-9b's heads at S 1, 16, 37 and 132 beside f32 SDPA's, which
shows what a call costs before its tiles.

    python3 tools/prefill_wide_phase_clocks.py [CHECKOUT]

Stamps, cycles since the block started, of its first thread: the
prologue (Q landed and in registers as TF32 halves), then for each K/V
tile: synced (its copies waited for, the block's barrier passed), issued
(the next tile's copies issued), qk (this warp's QK^T products issued),
partials (the four warps' partial scores exchanged: the products'
results waited for, the row tile's barrier passed), finished (the
finished scores exchanged: the sum, scale, softcap and masks of one n8
tile and the second barrier), softmax (the online softmax), pv (P V's
products issued, the loop's end); then the loop's end and the output
written. The copy builds into its own directory
under the checkout's `build/`; the checkout itself is not modified.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_TILES = 12
STEPS = ("synced", "issued", "qk", "partials", "finished", "softmax", "pv")


def patched_copy(checkout: Path) -> Path:
    var = checkout / "build" / "prefill_wide_phase_clocks"
    if var.exists():
        shutil.rmtree(var)
    shutil.copytree(checkout / "src", var / "src")
    p = var / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    s = p.read_text()

    def put(anchor: str, text: str, before: bool = False) -> None:
        nonlocal s
        if s.count(anchor) != 1:
            sys.exit(f"prefill_wide_phase_clocks: anchor found "
                     f"{s.count(anchor)} times: {anchor!r}")
        s = s.replace(anchor, text + anchor if before else anchor + text, 1)

    put("namespace {\n\nusing namespace sfp;",
        "__device__ unsigned long long g_clk[128];\n"
        "extern \"C\" int sfp_fa32w_clocks(void* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n"
        "}\n"
        "extern \"C\" int sfp_fa32w_clocks_clear() {\n"
        "  static const unsigned long long zero[128] = {};\n"
        "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n"
        "}\n"
        "#define STAMP(i) if (clk_ && (i) < 128) g_clk[i] = clock64()\n\n",
        before=True)
    put("  // row tile rg's four warps run on the four schedulers\n",
        "  const bool clk_ = blockIdx.x == 0 && blockIdx.y == 0 && "
        "blockIdx.z == 0 && tid == 0;\n  STAMP(0);\n", before=True)
    put("  float o[2 * NGW][4];\n", "  STAMP(1);\n", before=True)
    put("    // tile `it` has landed; every warp is done with tile it - 1 and "
        "with\n    // its exchange\n    __syncthreads();\n",
        "    STAMP(2 + 8 * it);\n")
    put("    // a causal tile past the row tile's last row holds only masked "
        "keys,\n", "    STAMP(3 + 8 * it);\n", before=True)
    put("    // The partials meet:", "    STAMP(4 + 8 * it);\n", before=True)
    put("    float4 x = part[w * 32 + lane];\n", "    STAMP(5 + 8 * it);\n",
        before=True)
    put("    float sc[4][4];\n", "    STAMP(6 + 8 * it);\n", before=True)
    put("    // O += P V over this warp's groups", "    STAMP(7 + 8 * it);\n",
        before=True)
    put("  }\n  cp_async_wait<0>();\n  if (!active) return;\n",
        "    STAMP(8 + 8 * it);\n", before=True)
    put("  cp_async_wait<0>();\n  if (!active) return;\n\n#pragma unroll\n"
        "  for (int off = 1; off <= 2; off <<= 1) {\n"
        "    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);",
        f"  STAMP({8 * MAX_TILES + 7});\n", before=True)
    put("      put_out(16 * m + 4 * t + 2 + j, 2 * i + j, 1);\n    }\n  }\n",
        f"  STAMP({8 * MAX_TILES + 8});\n")
    p.write_text(s)
    return var


def main() -> None:
    checkout = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    var = patched_copy(checkout)
    sys.path[:0] = [str(var / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, Hq, Hkv, Dh, Dv, softcap, rows in (
            ("gemma2-9b, 16 rows", 16, 8, 256, 256, 50.0, 16),
            ("gemma2-9b, 32 rows", 16, 8, 256, 256, 50.0, 32),
            ("deepseek-v3 MLA 64 heads", 64, 64, 192, 128, None, 16),
            ("deepseek-v3 MLA 128 heads", 128, 128, 192, 128, None, 16)):
        S = 132
        q, k, v = (torch.randn((1, S, h, d), generator=gen, device="cuda")
                   for h, d in ((Hq, Dh), (Hkv, Dh), (Hkv, Dv)))
        plan = prefill_plan(1, S, Hq, Dh, Dv, 4)._replace(rows=rows)
        buf = (ctypes.c_ulonglong * 128)()
        for _ in range(3):   # the last of three calls
            lib.sfp_fa32w_clocks_clear()
            flash_attention_fwd(q, k, v, causal=True, sliding_window=None,
                                softcap=softcap, scale=Dh ** -0.5, kv_len=S,
                                plan=plan)
            torch.cuda.synchronize()
        lib.sfp_fa32w_clocks(ctypes.byref(buf))
        c = list(buf)
        tiles = [dict(zip(STEPS, (c[2 + 8 * it + j] - c[0]
                                  for j in range(len(STEPS)))))
                 for it in range(MAX_TILES) if c[2 + 8 * it] > c[0]]
        out[label] = dict(prologue=c[1] - c[0], tiles=tiles,
                          loop_end=c[8 * MAX_TILES + 7] - c[0],
                          written=c[8 * MAX_TILES + 8] - c[0])
        print(f"{label}: prologue {out[label]['prologue']}")
        for it, t in enumerate(tiles):
            print(f"  tile {it}: " + " ".join(f"{k} {v}" for k, v in t.items()))
        print(f"  loop end {out[label]['loop_end']} written "
              f"{out[label]['written']}")
    # device ms of this stamped copy (the stamps cost one block's first
    # thread a few stores) and f32 SDPA at short lengths at gemma2-9b's
    # heads: what a call costs before its tiles
    cases = {}
    for S in (1, 16, 37, 132):
        sets = [tuple(torch.randn((1, S, h, 256), generator=gen,
                                  device="cuda") for h in (16, 8, 8))
                for _ in range(cs.n_copies(S * 32 * 256 * 4))]
        kw = dict(causal=True, sliding_window=None, softcap=None,
                  scale=256 ** -0.5, kv_len=S)
        cases[f"kernel S {S}"] = [lambda s=s, kw=kw: flash_attention_fwd(
            *s, **kw) for s in sets]
        lib_sets = [(q.transpose(1, 2).contiguous(),
                     k.repeat_interleave(2, 2).transpose(1, 2).contiguous(),
                     v.repeat_interleave(2, 2).transpose(1, 2).contiguous())
                    for q, k, v in sets]
        cases[f"sdpa S {S}"] = [lambda s=s: F.scaled_dot_product_attention(
            *s, is_causal=True, scale=256 ** -0.5) for s in lib_sets]
    ms = cs.device_ms_cases(cases)
    out["device_ms_gemma2_f32"] = ms
    print("device ms (the stamped copy): " + json.dumps(
        {k: round(v, 5) for k, v in ms.items()}))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "prefill_wide_phase_clocks.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
