#!/usr/bin/env python3
"""Run chip_smoke.py's phase 11 (the rwkv path: rwkv6-3b widths at 8
layers through the dense engine, phase 5's traffic, with its profiled
replay) for one or more checkouts on the card, in alternating order, and
print each run's tokens/s, device busy share, device time by kind and the
port kernels' launches and device us a launch.

    python3 tools/time_rwkv_path.py CHECKOUT [CHECKOUT ...] [--rounds N]

Each run is a process of its own that imports the checkout's `src/` (and
builds its library into the checkout's `build/` on first use) and this
tree's `chip_smoke.py` functions, so every checkout is measured the same
way. A round runs the checkouts in order, then in reverse; the card's name
and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(checkout: str) -> None:
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    # an older checkout's single RWKV-6 kernel counts as a port kernel too
    cs.PORT_KERNELS = cs.PORT_KERNELS + ("rwkv6_scan_kernel",)
    cs.PATHS["rwkv_any"] = cs.PATHS["rwkv"]
    build.timed_build()
    fw = cs.full_width_model(torch, "rwkv6-3b", 8)
    _, summary = cs.full_width(torch, fw, "rwkv_any")
    p = summary["profile"]
    print(json.dumps({
        "tok_per_s": summary["tok_per_s"], "busy": p["device_busy_share"],
        "device_ms": p["device_kernel_s"] * 1e3, "wall_s": p["wall_s"],
        "by_kind": p["device_ms_by_kind"],
        "port_launches": p["port_kernel_launches"],
        "port_us": p["port_kernel_us_per_launch"]}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
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
    for _ in range(args.rounds):
        for c in args.checkouts + args.checkouts[::-1]:
            r = subprocess.run([sys.executable, __file__, "--child", c],
                               capture_output=True, text=True)
            if r.returncode:
                err = r.stderr
                sys.exit(f"{c}: exit {r.returncode}\n"
                         + (err if len(err) < 8000 else
                            err[:4000] + "\n...\n" + err[-4000:]))
            print(f"{c}: {r.stdout.strip().splitlines()[-1]}", flush=True)


if __name__ == "__main__":
    main()
