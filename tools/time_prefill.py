#!/usr/bin/env python3
"""Time the prefill attention kernel for one or more checkouts on the card,
in alternating order, so a parent and a change are measured on one
machine.

    python3 tools/time_prefill.py CHECKOUT [CHECKOUT ...] [--rounds N]
        [--only 16bit|f32wide|f32narrow] [--lengths 132,37] [--replays]
        [--f32-replays]

Per run, 16bit: the prefill kernel with all-bf16 and all-f16 q, k and v
at the batch-1 serving shapes (causal, S 132 = a 128-token prompt and 4
soft prompt tokens): Qwen2.5-14B 40 / 8 x 128, zamba2 32 x 80, gemma2-9b
16 / 8 x 256, stablelm-12b 32 / 8 x 160, nemotron-4-340b 96 / 8 x 192,
beside SDPA at the same dtype on the same values (K/V repeated over the
group) and the bound (bytes at 2 B a value against 3.35 TB/s; operations
at 989 TFLOP/s). f32wide: the f32 kernel's wide layout (head dims 192 and
256) at S 132 and 37 (--lengths): gemma2-9b (softcap 50; SDPA without), deepseek-v3's
MLA prefill at a rank's 64 heads and at all 128 (q/k 192, v 128, G 1),
nemotron-4-340b, and gemma2-9b and nemotron-4-340b with every tensor one
value off 16 bytes (4-byte copies); beside f32 SDPA and the bound (bytes
at 4 B a value; operations at 3xTF32's 165 TFLOP/s), the plan's rows and
blocks, every row count the checkout's plan can choose forced in turn
(`rows_ms`), and the wide kernel's registers and spills from the
checkout's ptxas report. f32narrow: the f32 kernel's narrow layout (head
dims up to 160) at the paths' shapes (F32_NARROW_SHAPES: whisper-base's
cross-attention at 1 and 64 queries over 1500 frames, its encoder and its
decoder's self-attention prefill, qwen2-vl-72b, Qwen2.5-14B and a tensor
rank of it, ViT-Base and a rank of it, stablelm-12b, zamba2, phi3.5-moe
and a head dim of 96), beside f32 SDPA and the bound, the plan's rows,
splits, group, blocks and blocks an SM, where the checkout's plan has
them every row count, split count and group forced in turn (cases
`kernel <shape> rows R splits S group G`), the split cases' ms by kernel
(`device_ms_by_kernel`), and the narrow kernel's registers and spills.
Device ms (chip_smoke.device_ms_cases: the kernels' time under
torch.profiler, one session for every case) over input copies past the
L2. With --replays, then the bf16 dense and paged
paths of chip_smoke.py phases 12 and 13 (Qwen2.5-14B widths at 3 layers)
with their profiled replays: tok/s, busy share, and the prefill kernel's
launches and device us a launch. With --f32-replays, the f32 paths
whose prefill takes the layout timed, with their profiled replays and the
same numbers: wide, gemma2-9b at 6 layers through the dense engine (phase
14) and deepseek-v3 (MLA, 128 heads) at phase 20's cut; narrow, phase 5's
dense Qwen2.5-14B serving, phase 21's whisper-base (generation and a
round, profiled whole) and phase 8's ViT-Base round (its profiled round).

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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("Qwen2.5-14B", 40, 8, 128), ("zamba2", 32, 32, 80),
          ("gemma2-9b", 16, 8, 256), ("stablelm-12b", 32, 8, 160),
          ("nemotron-4-340b", 96, 8, 192))
S = 132
# the f32 wide layout's shapes: (label, Hq, Hkv, Dh, Dv, softcap)
F32_WIDE_SHAPES = (("gemma2-9b", 16, 8, 256, 256, 50.0),
                   ("deepseek-v3 MLA 64 heads", 64, 64, 192, 128, None),
                   ("nemotron-4-340b", 96, 8, 192, 192, None),
                   ("deepseek-v3 MLA 128 heads", 128, 128, 192, 128, None))


def f32_wide(torch, F, cs, gen, cases, out, lengths):
    """Add the f32 wide layout's cases at each of `lengths` to `cases`;
    their bounds, plans and the wide kernel's registers to `out`."""
    from repro_torch.kernels.flash_attention import kernel as fk
    sweep = getattr(fk, "ROWS_F32_WIDE", ())   # () before the redesign
    for Sq in lengths:
        for label, Hq, Hkv, Dh, Dv, softcap in F32_WIDE_SHAPES:
            for off in ((0, 1) if Sq == S and Hq != Hkv else (0,)):
                per = Sq * (Hq + Hkv) * (Dh + Dv) * 4
                sets = [tuple(torch.randn(Sq * h * d + off, generator=gen,
                                          device="cuda")[off:]
                              .view(1, Sq, h, d)
                              for h, d in ((Hq, Dh), (Hkv, Dh), (Hkv, Dv)))
                        for _ in range(cs.n_copies(per))]
                kw = dict(causal=True, sliding_window=None, softcap=softcap,
                          scale=Dh ** -0.5, kv_len=Sq)
                case = f"{label} float32 S {Sq}{' off 1' if off else ''}"
                cases[f"kernel {case}"] = [
                    lambda s=s, kw=kw: fk.flash_attention_fwd(*s, **kw)
                    for s in sets]
                plan = fk.prefill_plan(1, Sq, Hq, Dh, Dv, 4, cs.SMS)
                out["plan"][case] = dict(
                    rows=plan.rows, blocks=-(-Sq // plan.rows) * Hq,
                    blocks_per_sm=plan.blocks_per_sm)
                out["bound_ms"][case], out["bound_by"][case] = cs.bound(
                    per, cs._prefill_pairs(Sq, Sq, None) * Hq * 2
                    * (Dh + Dv), cs.TF32X3_FLOPS)
                if off:
                    continue
                for r in sweep:
                    pr = plan._replace(rows=r)
                    cases[f"kernel {case} rows {r}"] = [
                        lambda s=s, kw=kw, pr=pr: fk.flash_attention_fwd(
                            *s, plan=pr, **kw) for s in sets]
                G = Hq // Hkv
                lib = [(q.transpose(1, 2).contiguous(),
                        k.repeat_interleave(G, 2).transpose(1, 2)
                        .contiguous(),
                        v.repeat_interleave(G, 2).transpose(1, 2)
                        .contiguous()) for q, k, v in sets]
                cases[f"sdpa {case}"] = [
                    lambda s=s, sc=Dh ** -0.5: F.scaled_dot_product_attention(
                        *s, is_causal=True, scale=sc) for s in lib]
    out["registers"].update({name: r for name, r in
                             cs.ptxas_report().items()
                             if "wide_kernel" in name})

# the f32 narrow layout's shapes: (label, B, Sq, Skv, Hq, Hkv, Dh, causal);
# keys and values of one width, values over the first kv_len = Skv keys
F32_NARROW_SHAPES = (
    ("whisper-base cross-attention Sq 1", 4, 1, 1500, 8, 8, 64, False),
    ("whisper-base cross-attention Sq 64", 4, 64, 1500, 8, 8, 64, False),
    ("whisper-base encoder", 4, 1500, 1500, 8, 8, 64, False),
    ("whisper-base decoder self-attention", 4, 68, 68, 8, 8, 64, True),
    ("qwen2-vl-72b", 2, 132, 132, 64, 8, 128, True),
    ("Qwen2.5-14B", 1, 132, 132, 40, 8, 128, True),
    ("Qwen2.5-14B a rank of 2", 1, 132, 132, 20, 4, 128, True),
    ("ViT-Base a rank of 2", 16, 213, 213, 6, 6, 64, False),
    ("ViT-Base", 16, 213, 213, 12, 12, 64, False),
    ("stablelm-12b", 1, 132, 132, 32, 8, 160, True),
    ("zamba2", 1, 132, 132, 32, 32, 80, True),
    ("phi3.5-moe", 1, 132, 132, 32, 8, 128, True),
    ("head dim 96, 32 / 8", 1, 132, 132, 32, 8, 96, True))
# forced split counts where the keys run to many tiles
SPLIT_SWEEP = (1, 2, 4, 6, 8)


def f32_narrow(torch, F, cs, gen, cases, out):
    """Add the f32 narrow layout's cases to `cases`; their bounds, plans
    and the narrow kernel's registers to `out`."""
    from repro_torch.kernels.flash_attention import kernel as fk
    sweep = hasattr(fk, "narrow_f32_plan")   # False before the redesign
    for label, B, Sq, Skv, Hq, Hkv, Dh, causal in F32_NARROW_SHAPES:
        per = (B * Sq * Hq + 2 * B * Skv * Hkv) * Dh * 4   # q, k, v
        sets = [tuple(torch.randn(shape, generator=gen, device="cuda")
                      for shape in ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh),
                                    (B, Skv, Hkv, Dh)))
                for _ in range(cs.n_copies(per))]
        kw = dict(causal=causal, sliding_window=None, softcap=None,
                  scale=Dh ** -0.5, kv_len=Skv)
        case = f"{label} float32"
        cases[f"kernel {case}"] = [
            lambda s=s, kw=kw: fk.flash_attention_fwd(*s, **kw)
            for s in sets]
        G = Hq // Hkv
        if sweep:
            plan = fk.prefill_plan(B, Sq, Hq, Dh, Dh, 4, cs.SMS, Hkv=Hkv,
                                   kv_len=Skv)
            rec = dict(rows=plan.rows, splits=plan.splits, group=plan.group,
                       blocks=-(-Sq // (plan.rows // plan.group))
                       * (Hq // plan.group) * B * plan.splits,
                       blocks_per_sm=plan.blocks_per_sm)
            splits = SPLIT_SWEEP if Skv >= 16 * fk.TILE_KEYS else (1,)
            for r in fk.F32_ROWS:
                for n in splits:
                    for g in sorted({1, G}):
                        pr = plan._replace(rows=r, splits=n, group=g)
                        cases[f"kernel {case} rows {r} splits {n} group "
                              f"{g}"] = [
                            lambda s=s, kw=kw, pr=pr: fk.flash_attention_fwd(
                                *s, plan=pr, **kw) for s in sets]
        else:
            plan = fk.prefill_plan(B, Sq, Hq, Dh, Dh, 4, cs.SMS)
            rec = dict(rows=plan.rows, splits=1, group=1,
                       blocks=-(-Sq // plan.rows) * Hq * B,
                       blocks_per_sm=plan.blocks_per_sm)
        out["plan"][case] = rec
        pairs = cs._prefill_pairs(Sq, Skv, None) if causal else Sq * Skv
        out["bound_ms"][case], out["bound_by"][case] = cs.bound(
            per + B * Sq * Hq * Dh * 4, pairs * B * Hq * 4 * Dh,
            cs.TF32X3_FLOPS)
        lib = [(q.transpose(1, 2).contiguous(),
                k.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                v.repeat_interleave(G, 2).transpose(1, 2).contiguous())
               for q, k, v in sets]
        cases[f"sdpa {case}"] = [
            lambda s=s, c=causal, sc=Dh ** -0.5:
            F.scaled_dot_product_attention(*s, is_causal=c, scale=sc)
            for s in lib]
    out["registers"].update(
        {name: r for name, r in cs.ptxas_report().items()
         if "flash_narrow_kernel" in name or "flash_fwd_kernel" in name})


def narrow_replays(torch, cs, out):
    """The f32 paths whose prefill takes the narrow layout: phase 5's dense
    serving (Qwen2.5-14B widths, 3 layers) with its profiled replay,
    phase 21's whisper-base (generation and a round) under one profiler,
    and phase 8's ViT-Base training with its profiled round."""
    from torch.profiler import ProfilerActivity, profile
    fw = cs.full_width_model(torch)
    _, summary = cs.full_width(torch, fw, "dense")
    out["dense"] = replay_record(summary)
    del fw
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, summary = cs.g2_full_width(torch, "whisper-base", "whisper")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    g = summary["generate"]
    out["whisper"] = replay_record(dict(
        tok_per_s=g["tok_per_s"], profile=cs.device_summary(prof, wall)))
    out["whisper"].update(prefill_s=g["prefill_s"], decode_s=g["decode_s"],
                          round_s=summary["round"]["round_s"])
    torch.cuda.empty_cache()
    _, summary = cs.full_width_train(torch)
    out["train"] = replay_record(dict(tok_per_s=None,
                                      profile=summary["profile"]))
    out["train"].update(round_s=[r["wall_s"] for r in summary["rounds"]],
                        profiled_round_s=summary["profile"]["wall_s"])


def replay_record(summary) -> dict:
    """tok/s, busy share, device ms and the prefill kernels' launches and
    device us a launch of a path's profiled replay."""
    p = summary["profile"]
    us, n = p["port_kernel_us_per_launch"], p["port_kernel_launches"]
    keep = ("flash", "combine")
    return {"tok_per_s": summary["tok_per_s"],
            "busy": p["device_busy_share"],
            "device_ms": p["device_kernel_s"] * 1e3,
            "prefill_launches": {k: v for k, v in n.items()
                                 if any(x in k for x in keep)},
            "prefill_us": {k: v for k, v in us.items()
                           if any(x in k for x in keep)}}


def child(checkout: str, replays: bool, f32_replays: bool, only: str,
          lengths) -> None:
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
    wide = {"plan": {}, "bound_ms": {}, "bound_by": {}, "registers": {}}
    if only in ("", "f32wide"):
        f32_wide(torch, F, cs, gen, cases, wide, lengths)
    if only in ("", "f32narrow"):
        f32_narrow(torch, F, cs, gen, cases, wide)
    for dtype in ((torch.bfloat16, torch.float16) if only in ("", "16bit")
                  else ()):
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
    by_name = {}
    out = {"device_ms": cs.device_ms_cases(cases, by_name=by_name),
           # the narrow layout's cases at their plans, by kernel (the
           # narrow kernel, and the combine where the plan splits)
           "device_ms_by_kernel": {
               c: ms for c, ms in by_name.items()
               if c.startswith("kernel ") and " rows " not in c
               and len(ms) > 1},
           "bound_ms": {c: b[0] for c, b in bounds.items()},
           "bound_by": {c: b[1] for c, b in bounds.items()}}
    for key in ("bound_ms", "bound_by"):
        out[key].update(wide[key])
    if only != "16bit":
        out["plan"], out["registers"] = wide["plan"], wide["registers"]
    del cases
    if replays:
        fw = cs.full_width_model(torch)
        for path, run in (("dense_bf16", cs.full_width),
                          ("paged_bf16", cs.full_width_paged)):
            _, summary = run(torch, fw, path, torch.bfloat16)
            out[path] = replay_record(summary)
        del fw
    if f32_replays and only in ("", "f32narrow"):
        torch.cuda.empty_cache()
        narrow_replays(torch, cs, out)
    if f32_replays and only in ("", "f32wide"):
        torch.cuda.empty_cache()
        fw = cs.full_width_model(torch, "gemma2-9b", 6)
        _, summary = cs.full_width(torch, fw, "gemma2")
        out["gemma2"] = replay_record(summary)
        del fw
        torch.cuda.empty_cache()
        _, summary = cs.full_width_moe(torch, "deepseek-v3-671b", "mla")
        out["mla"] = replay_record(summary)
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", choices=("16bit", "f32wide", "f32narrow"))
    ap.add_argument("--replays", action="store_true")
    ap.add_argument("--f32-replays", action="store_true")
    ap.add_argument("--lengths", default=f"{S},37",
                    help="f32wide: the sequence lengths, comma-separated")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.replays, args.f32_replays, args.only or "",
              [int(x) for x in args.lengths.split(",")])
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
                + ["--replays"] * args.replays
                + ["--f32-replays"] * args.f32_replays
                + ["--lengths", args.lengths]
                + (["--only", args.only] if args.only else []),
                capture_output=True,
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
