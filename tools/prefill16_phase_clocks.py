#!/usr/bin/env python3
"""Where the 16-bit prefill kernel's time goes: clock64() stamps of the
longest block's first thread (block 0 of a causal call: the last query
rows, every key tile), read from a copy of a checkout's sources with the
stamps patched in, at Qwen2.5-14B's (40 / 8 x 128), gemma2-9b's (16 / 8 x
256) heads at S 132 and Qwen2.5-14B's at S 528, bf16; then that copy's
device ms at Qwen2.5-14B's heads at S 1, 32 and 132 beside bf16 SDPA's,
which shows what a call costs before any tile.

    python3 tools/prefill16_phase_clocks.py [CHECKOUT]

Stamps, cycles since the block started: the prologue (Q and the first
tiles' copies issued), then for each K/V tile: synced (its copies waited
for, the block's barrier passed), issued (the next tile's copies issued),
qk (QK^T's products issued), masked (scale, softcap and masks applied: the
products' results waited for), softmax (the online softmax and P's
terms); then the loop's end and the epilogue (the key halves merged). The
copy builds into its own directory under the checkout's `build/`; the
checkout itself is not modified.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_TILES = 12


def patched_copy(checkout: Path) -> Path:
    var = checkout / "build" / "prefill16_phase_clocks"
    if var.exists():
        shutil.rmtree(var)
    shutil.copytree(checkout / "src", var / "src")
    p = var / "src" / "repro_torch" / "csrc" / "flash_attention_16.cu"
    s = p.read_text()

    def put(anchor: str, text: str, before: bool = False) -> None:
        nonlocal s
        if anchor not in s:
            sys.exit(f"prefill16_phase_clocks: anchor not found: {anchor!r}")
        s = s.replace(anchor, text + anchor if before else anchor + text, 1)

    put("namespace {\n\nusing namespace sfp;",
        "__device__ unsigned long long g_clk[128];\n"
        "extern \"C\" int sfp_fa16_clocks(void* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n"
        "}\n"
        "extern \"C\" int sfp_fa16_clocks_clear() {\n"
        "  static const unsigned long long zero[128] = {};\n"
        "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));\n"
        "}\n"
        "#define STAMP(i) if (clk_ && (i) < 128) g_clk[i] = clock64()\n",
        before=True)
    put("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
        "  const bool clk_ = blockIdx.x == 0 && blockIdx.y == 0 && "
        "blockIdx.z == 0 && tid == 0;\n  STAMP(0);\n")
    put("  // rows g and g + 8 of the warp's 16-row tile\n", "  STAMP(1);\n",
        before=True)
    put("    __syncthreads();  // tile `it` has landed; every warp is done "
        "with it - 1\n", "    STAMP(2 + 8 * it);\n")
    put("    if (it + NST - 1 < n_tiles) load_kv(it + NST - 1);  // into "
        "it - 1's slot\n    cp_async_commit();\n", "    STAMP(3 + 8 * it);\n")
    put("    // scale, softcap and (on edge halves only) masks\n",
        "    STAMP(4 + 8 * it);\n", before=True)
    put("    // online softmax on the fragments\n", "    STAMP(5 + 8 * it);\n",
        before=True)
    put("    constexpr int KT = kTerms<T>;\n", "    STAMP(6 + 8 * it);\n",
        before=True)
    put("  cp_async_wait<0>();\n\n  if constexpr (!S::kWide) {",
        f"  STAMP({8 * MAX_TILES + 7});\n", before=True)
    put("  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);",
        f"  STAMP({8 * MAX_TILES + 8});\n", before=True)
    # the pinned block bytes stay the source's; the patched copy needs none
    s = "\n".join(ln for ln in s.splitlines()
                  if not (ln.startswith("static_assert(block_bytes16<")
                          and ln.endswith(");")))
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
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    lib = build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, Hq, Hkv, Dh, S in (("Qwen2.5-14B S 132", 40, 8, 128, 132),
                                  ("gemma2-9b S 132", 16, 8, 256, 132),
                                  ("Qwen2.5-14B S 528", 40, 8, 128, 528)):
        q, k, v = (torch.randn((1, S, h, Dh), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        buf = (ctypes.c_ulonglong * 128)()
        for _ in range(3):   # the last of three calls
            lib.sfp_fa16_clocks_clear()
            flash_attention_fwd(q, k, v, causal=True, sliding_window=None,
                                softcap=None, scale=Dh ** -0.5, kv_len=S)
            torch.cuda.synchronize()
        lib.sfp_fa16_clocks(ctypes.byref(buf))
        c = list(buf)
        tiles = [[c[2 + 8 * it + j] - c[0] for j in range(5)]
                 for it in range(MAX_TILES) if c[2 + 8 * it] > c[0]]
        out[label] = dict(prologue=c[1] - c[0], tiles=tiles,
                          loop_end=c[8 * MAX_TILES + 7] - c[0],
                          epilogue=c[8 * MAX_TILES + 8] - c[0])
        print(f"{label}: prologue {out[label]['prologue']}")
        for it, t in enumerate(tiles):
            print(f"  tile {it}: synced {t[0]} issued {t[1]} qk {t[2]} "
                  f"masked {t[3]} softmax {t[4]}")
        print(f"  loop end {out[label]['loop_end']} epilogue "
              f"{out[label]['epilogue']}")
    # device ms of the kernel (this stamped copy: the stamps cost one
    # block's first thread a few stores) and SDPA at short lengths: what a
    # call costs before its tiles
    cases = {}
    for S in (1, 32, 132):
        sets = [tuple(torch.randn((1, S, h, 128), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for h in (40, 8, 8))
                for _ in range(cs.n_copies(S * 112 * 128 * 2))]
        kw = dict(causal=True, sliding_window=None, softcap=None,
                  scale=128 ** -0.5, kv_len=S)
        cases[f"kernel S {S}"] = [lambda s=s, kw=kw: flash_attention_fwd(
            *s, **kw) for s in sets]
        lib_sets = [(q.transpose(1, 2).contiguous(),
                     k.repeat_interleave(5, 2).transpose(1, 2).contiguous(),
                     v.repeat_interleave(5, 2).transpose(1, 2).contiguous())
                    for q, k, v in sets]
        cases[f"sdpa S {S}"] = [lambda s=s: F.scaled_dot_product_attention(
            *s, is_causal=True, scale=128 ** -0.5) for s in lib_sets]
    ms = cs.device_ms_cases(cases)
    out["device_ms_qwen_bf16"] = ms
    print("device ms (the stamped copy): " + json.dumps(
        {k: round(v, 5) for k, v in ms.items()}))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "prefill16_phase_clocks.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
