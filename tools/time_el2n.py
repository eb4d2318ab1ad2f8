#!/usr/bin/env python3
"""Time the EL2N kernel of one or more checkouts on the card, in
alternating order, so a parent and a change are measured on one machine;
then sweep this tree's threads a block.

    python3 tools/time_el2n.py [CHECKOUT ...] [--replays] [--threads]

Per run: the kernel at chip_smoke.py's EL2N_SHAPES ((16, 100), the ViT
path's scoring batch; (512, 152064), an LM batch; (16, 152064) and
(64, 152064), few rows of an LM vocabulary) at f32 and bf16, device ms
(chip_smoke.device_ms_cases: the kernels' time under torch.profiler, one
session for all shapes) over dense input copies past the L2, beside each
shape's bound. With --replays, then chip_smoke.py phase 8 (ViT-Base at full
width, two SFPrompt rounds and a profiled one): the EL2N kernel's launches
and device us a launch in the profiled round, and the rounds' wall times.

With --threads, one more run of this tree: device ms of each layout at
each threads a block it may take, at the shapes whose plan it is (the
warp layout at (16, 100); a block a row at (512, 152064), (16, 152064)
and (64, 152064)), f32 and bf16, one profiler session a shape, beside the
plan `el2n_plan` picks on this card.

Each run is a process of its own that imports the checkout's `src/` (and
builds its library into the checkout's `build/` on first use) and this
tree's `chip_smoke.py` functions. The checkouts run in order, then in
reverse; the card's name and power limit come first, and every run's
record also goes to chiprun_out/time_el2n.json. Make a parent checkout
with `git archive` into the git-ignored `build/`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (layout, N, V, threads a block swept)
THREAD_CASES = (("warp", 16, 100, (64, 128, 256)),
                ("block", 512, 152064, (128, 256, 512)),
                ("block", 16, 152064, (128, 256, 512)),
                ("block", 64, 152064, (128, 256, 512)))


def _setup(checkout: str):
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    build.timed_build()
    return torch, cs, torch.Generator(device="cuda").manual_seed(0)


def _sets(torch, cs, gen, N, V, dt):
    return [(lg.to(dt), lb) for lg, lb in (
        cs.el2n_case(torch, gen, N, V, pad=0)
        for _ in range(cs.n_copies(N * V * dt.itemsize)))]


def child(checkout: str, replays: bool) -> None:
    torch, cs, gen = _setup(checkout)
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    cases, bounds = {}, {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for N, V in cs.EL2N_SHAPES:
            sets = _sets(torch, cs, gen, N, V, dt)
            label = f"{name} ({N}, {V})"
            cases[label] = [lambda s=s: el2n_fwd(*s) for s in sets]
            bounds[label] = cs.bound(N * V * dt.itemsize + 3 * N * 4,
                                     5 * N * V)[0]
    dev = cs.device_ms_cases(cases)
    out = {"device_ms": dev, "bound_share": {k: bounds[k] / t
                                            for k, t in dev.items()}}
    del cases
    if replays:
        torch.cuda.empty_cache()
        _, summary = cs.full_width_train(torch)
        p = summary["profile"]
        us, n = p["port_kernel_us_per_launch"], p["port_kernel_launches"]
        out["phase8"] = {
            "round_s": [r["wall_s"] for r in summary["rounds"]],
            "profiled_round_s": p["wall_s"],
            "el2n_launches": {k: v for k, v in n.items() if "el2n" in k},
            "el2n_us_per_launch": {k: v for k, v in us.items()
                                   if "el2n" in k}}
    print(json.dumps(out))


def threads_sweep() -> None:
    torch, cs, gen = _setup(str(ROOT))
    from repro_torch.kernels.el2n.kernel import el2n_fwd, el2n_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, lines = {}, []
    for layout, N, V, ts in THREAD_CASES:
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            sets = _sets(torch, cs, gen, N, V, dt)
            dev = cs.device_ms_cases({T: [
                lambda s=s, T=T: el2n_fwd(*s, (layout, T)) for s in sets]
                for T in ts})
            key = f"{layout} {name} ({N}, {V})"
            threads[key] = dict(device_ms=dev, plan=el2n_plan(N, V, sms))
            lines.append(f"  {key}: " + ", ".join(
                f"{T} threads {t:.5f}" for T, t in dev.items())
                + f"; plan {el2n_plan(N, V, sms)}")
            del sets
    print("el2n threads sweep (device ms):\n" + "\n".join(lines),
          flush=True)
    print(json.dumps({"threads_sweep": threads}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--replays", action="store_true")
    ap.add_argument("--threads", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--threads-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.replays)
        return
    if args.threads_child:
        threads_sweep()
        return
    if not (args.checkouts or args.threads):
        ap.error("name at least one checkout, or --threads")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)

    def run(argv, label):
        r = subprocess.run([sys.executable, __file__] + argv,
                           capture_output=True, text=True)
        if r.returncode:
            err = r.stderr
            sys.exit(f"{label}: exit {r.returncode}\n"
                     + (err if len(err) < 8000 else
                        err[:4000] + "\n...\n" + err[-4000:]))
        lines = r.stdout.strip().splitlines()
        # the child's own lines; chip_smoke's long JSON summaries stay out
        print("\n".join(ln for ln in lines[:-1] if len(ln) < 2000),
              flush=True)
        return json.loads(lines[-1])

    runs, record = [], {"card": card}
    for c in args.checkouts + args.checkouts[::-1]:
        rec = run(["--child", c] + ["--replays"] * args.replays, c)
        runs.append({"checkout": c, **rec})
        print(f"{c}: {json.dumps(rec)}", flush=True)
    record["runs"] = runs
    if args.threads:
        record.update(run(["--threads-child"], "threads sweep"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_el2n.json").write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
