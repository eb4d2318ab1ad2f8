#!/usr/bin/env python3
"""Time the prefill attention kernel at 16 bits for one or more checkouts
on the card, in alternating order, so a parent and a change are measured
on one machine.

    python3 tools/time_prefill.py CHECKOUT [CHECKOUT ...] [--rounds N] [--replays]

Per run: the prefill kernel with all-bf16 and all-f16 q, k and v at the
batch-1 serving shapes (causal, S 132 = a 128-token prompt and 4 soft
prompt tokens): Qwen2.5-14B 40 / 8 x 128, zamba2 32 x 80, gemma2-9b 16 / 8
x 256, stablelm-12b 32 / 8 x 160, nemotron-4-340b 96 / 8 x 192; and the
f32 kernel at gemma2-9b's and nemotron-4-340b's shapes, aligned and one
value off (its wide instantiations, for drift). Device ms
(chip_smoke.device_ms_cases: the kernels' time under torch.profiler, one
session for every case) over input copies past the L2, beside SDPA at the
same dtype on the same values (K/V repeated over the group) and the bound
(bytes at 2 B a value against 3.35 TB/s; operations at 989 TFLOP/s). With
--replays, then the bf16 dense and paged paths of chip_smoke.py phases 12
and 13 (Qwen2.5-14B widths at 3 layers) with their profiled replays:
tok/s, busy share, and the prefill kernel's launches and device us a
launch.

Each run is a process of its own that imports the checkout's `src/` (and
builds its library into the checkout's `build/` on first use) and this
tree's `chip_smoke.py` functions. A round runs the checkouts in order,
then in reverse; the card's name and power limit come first, and every
run's record also goes to chiprun_out/time_prefill.json.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("Qwen2.5-14B", 40, 8, 128), ("zamba2", 32, 32, 80),
          ("gemma2-9b", 16, 8, 256), ("stablelm-12b", 32, 8, 160),
          ("nemotron-4-340b", 96, 8, 192))
S = 132


def child(checkout: str, replays: bool) -> None:
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    torch.backends.cuda.matmul.allow_tf32 = False
    build.timed_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, bounds = {}, {}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        for label, Hq, Hkv, Dh in SHAPES:
            per = (S * (Hq + 2 * Hkv) * Dh + S * Hq * Dh) * 2
            sets = [tuple(torch.randn((1, S, h, Dh), generator=gen,
                                      device="cuda").to(dtype)
                          for h in (Hq, Hkv, Hkv))
                    for _ in range(cs.n_copies(per))]
            kw = dict(causal=True, sliding_window=None, softcap=None,
                      scale=Dh ** -0.5, kv_len=S)
            case = f"{label} {name}"
            cases[f"kernel {case}"] = [
                lambda s=s, kw=kw: flash_attention_fwd(*s, **kw)
                for s in sets]
            G = Hq // Hkv
            lib = [(q.transpose(1, 2).contiguous(),
                    k.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                    v.repeat_interleave(G, 2).transpose(1, 2).contiguous())
                   for q, k, v in sets]
            cases[f"sdpa {case}"] = [
                lambda s=s, sc=Dh ** -0.5: F.scaled_dot_product_attention(
                    *s, is_causal=True, scale=sc) for s in lib]
            bounds[case] = cs.bound(
                per, cs._prefill_pairs(S, S, None) * Hq * 4 * Dh,
                cs.BF16_FLOPS)
    # the f32 kernel's wide instantiations at gemma2-9b's and
    # nemotron-4-340b's shapes, 16-byte copies and (one value off) 4-byte
    # ones: the same code in both builds, read for drift
    for label, Hq, Hkv, Dh in SHAPES[2::2]:
        for off in (0, 1):
            sets = []
            for _ in range(cs.n_copies(S * (2 * Hq + 2 * Hkv) * Dh * 4)):
                qkv = [torch.randn(S * h * Dh + off, generator=gen,
                                   device="cuda")[off:].view(1, S, h, Dh)
                       for h in (Hq, Hkv, Hkv)]
                sets.append(tuple(qkv))
            kw = dict(causal=True, sliding_window=None, softcap=None,
                      scale=Dh ** -0.5, kv_len=S)
            cases[f"kernel {label} float32{' off 1' if off else ''}"] = [
                lambda s=s, kw=kw: flash_attention_fwd(*s, **kw)
                for s in sets]
    out = {"device_ms": cs.device_ms_cases(cases),
           "bound_ms": {c: b[0] for c, b in bounds.items()},
           "bound_by": {c: b[1] for c, b in bounds.items()}}
    del cases
    if replays:
        fw = cs.full_width_model(torch)
        for path, run in (("dense_bf16", cs.full_width),
                          ("paged_bf16", cs.full_width_paged)):
            _, summary = run(torch, fw, path, torch.bfloat16)
            p = summary["profile"]
            us, n = p["port_kernel_us_per_launch"], p["port_kernel_launches"]
            out[path] = {
                "tok_per_s": summary["tok_per_s"],
                "busy": p["device_busy_share"],
                "device_ms": p["device_kernel_s"] * 1e3,
                "prefill_launches": {k: v for k, v in n.items()
                                     if "flash" in k},
                "prefill_us": {k: v for k, v in us.items() if "flash" in k}}
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--replays", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.replays)
        return
    if not args.checkouts:
        ap.error("name at least one checkout")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for _ in range(args.rounds):
        for c in args.checkouts + args.checkouts[::-1]:
            r = subprocess.run(
                [sys.executable, __file__, "--child", c]
                + ["--replays"] * args.replays, capture_output=True,
                text=True)
            if r.returncode:
                err = r.stderr
                sys.exit(f"{c}: exit {r.returncode}\n"
                         + (err if len(err) < 8000 else
                            err[:4000] + "\n...\n" + err[-4000:]))
            rec = json.loads(r.stdout.strip().splitlines()[-1])
            runs.append({"checkout": c, **rec})
            print(f"{c}: {json.dumps(rec)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_prefill.json").write_text(json.dumps(
        {"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
