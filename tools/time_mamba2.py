#!/usr/bin/env python3
"""Time the Mamba-2 scan kernels of one or more checkouts on the card, in
alternating order, at zamba2-2.7b's heads (H 80, P = N = 64, G 1): decode
(8 slots, T 1: the step kernel) and prefill (batch 1, T 132: the chunked
kernel), f32, each call writing its final state over its input state as
the serving path does. Device time of one call: the kernel's mean event
time under torch.profiler, over input copies that exceed the L2.

    python3 tools/time_mamba2.py CHECKOUT [CHECKOUT ...] [--rounds N]

Each run is a process of its own that imports the checkout's `src/` (and
builds its library into the checkout's `build/` on first use). A round
runs the checkouts in order, then in reverse; prints the card's name and
power limit, one line a run, and each checkout's median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = {"decode": (8, 1), "prefill": (1, 132)}
H, P, N, G = 80, 64, 64, 1
L2_BYTES = 50 * 2 ** 20


def child(checkout: str) -> None:
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (B, T) in SHAPES.items():
        per = 4 * (2 * B * T * H * P + 2 * B * T * G * N + B * T * H
                   + 2 * B * H * P * N)
        sets = []
        for _ in range(max(2, -(-4 * L2_BYTES // per))):
            def rand(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            sets.append((rand(B, T, H, P), F.softplus(rand(B, T, H)),
                         -torch.linspace(1.0, 16.0, H, device="cuda"),
                         rand(B, T, G, N), rand(B, T, G, N),
                         rand(B, H, P, N)))
        calls = [lambda s=s: mamba2_fwd(*s, state_out=s[5]) for s in sets]
        for call in calls[:3]:
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(200):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if "mamba2" in e.key]
        total = sum(getattr(e, "device_time_total", None)
                    or e.cuda_time_total for e in events)
        out[name] = dict(kernels=sorted(e.key for e in events),
                         ms=total / sum(e.count for e in events) / 1e3)
        del sets, calls
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    if not args.checkouts:
        ap.error("name at least one checkout")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = {c: [] for c in args.checkouts}
    for _ in range(args.rounds):
        for c in args.checkouts + args.checkouts[::-1]:
            r = subprocess.run([sys.executable, __file__, "--child", c],
                               capture_output=True, text=True)
            if r.returncode:
                err = r.stderr
                sys.exit(f"{c}: exit {r.returncode}\n"
                         + (err if len(err) < 8000 else
                            err[:4000] + "\n...\n" + err[-4000:]))
            got = json.loads(r.stdout.strip().splitlines()[-1])
            runs[c].append(got)
            print(f"{c}: " + "; ".join(
                f"{k} {v['ms']:.5f} ms ({', '.join(v['kernels'])})"
                for k, v in got.items()), flush=True)
    for c, rs in runs.items():
        print(f"median {c}: " + "; ".join(
            f"{k} {statistics.median(r[k]['ms'] for r in rs):.5f} ms"
            for k in SHAPES), flush=True)


if __name__ == "__main__":
    main()
