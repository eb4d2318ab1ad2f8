#!/usr/bin/env python3
"""Time the int8 wire pair of one or more checkouts on the card, in
alternating order, so a parent and a change are measured on one machine.

    python3 tools/time_quant.py CHECKOUT [CHECKOUT ...] [--rounds N] [--replays]

Per run: the quantize and dequantize kernels at chip_smoke.py's
QUANT_SHAPES (decode 8 and 16 x 5120, prefill 132 x 5120, training
3408 x 768) at f32, bf16 and f16, device ms (chip_smoke.device_ms_cases:
the kernels' time under torch.profiler, one session a shape) over input
copies past the L2. u goes
in as the 0-dim tensor 0.5 broadcast (strides (0, 0), which every
checkout's wrapper takes), as the float 0.5 where the wrapper takes it by
value, and as a dense random tensor (the training shape's only form).
With --replays, then the dense and paged paths of chip_smoke.py phases 5
and 6 (Qwen2.5-14B widths at 6 layers) with their profiled replays: tok/s,
busy share, the pair's launches and device us a launch, and the fill
kernels.

Each run is a process of its own that imports the checkout's `src/` (and
builds its library into the checkout's `build/` on first use) and this
tree's `chip_smoke.py` functions. A round runs the checkouts in order,
then in reverse; the card's name and power limit come first, and every
run's record also goes to chiprun_out/time_quant.json.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(checkout: str, replays: bool) -> None:
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    torch.backends.cuda.matmul.allow_tf32 = False
    build.timed_build()
    by_value = "plan" in inspect.signature(quantize_fwd).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)
    pair = {}
    for name in cs.QUANT_DTYPES:
        dt = getattr(torch, name)
        for label, N, D in cs.QUANT_SHAPES:
            xs = [(torch.randn((N, D), generator=gen, device="cuda") * 3.0
                   ).to(dt) for _ in range(cs.n_copies(N * D * 9))]
            half = torch.full((), 0.5, device="cuda").expand(N, D)
            forms = {"dense u": [torch.rand((N, D), generator=gen,
                                            device="cuda") for _ in xs]}
            if label != "train":
                forms["u (0, 0)"] = [half] * len(xs)
                if by_value:
                    forms["u 0.5 float"] = [0.5] * len(xs)
            cases = {f"quantize {name} ({N}, {D}) {form}":
                     [lambda x=x, u=u: quantize_fwd(x, u)
                      for x, u in zip(xs, us)] for form, us in forms.items()}
            pays = [quantize_fwd(x, half) for x in xs]
            cases[f"dequantize {name} ({N}, {D})"] = [
                lambda p=p: dequantize_fwd(*p, dt) for p in pays]
            pair.update(cs.device_ms_cases(cases))
            del xs, forms, pays, cases
    out = {"pair_device_ms": pair}
    if replays:
        fw = cs.full_width_model(torch)
        for path, run in (("dense", cs.full_width),
                          ("paged", cs.full_width_paged)):
            _, summary = run(torch, fw, path)
            p = summary["profile"]
            us, n = p["port_kernel_us_per_launch"], p["port_kernel_launches"]
            out[path] = {
                "tok_per_s": summary["tok_per_s"],
                "busy": p["device_busy_share"],
                "device_ms": p["device_kernel_s"] * 1e3,
                "fill_launches": p["fill_launches"],
                **{f"{k}_{v}": d.get(k) for k in ("quantize_kernel",
                                                   "dequantize_kernel")
                   for v, d in (("launches", n), ("us", us))}}
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
    (out / "time_quant.json").write_text(json.dumps(
        {"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
