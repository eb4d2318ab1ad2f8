#!/usr/bin/env python3
"""Measure the memory of chip_smoke.py phase 23's qwen2-vl-72b round on
(data 1, model 2) at the published vocabulary of 152064 rows, which the
phase cuts to 32768: two ranks on the one card over gloo, as phase 23
runs them, each on the fp32 wire, printing its peak allocated GB and the
card's use after its setup and after its round, or the out-of-memory
error it hit and where.

    python3 tools/tp2_vlm_memory.py

The card's name and power limit come first. Exits nonzero where a rank
ran out of memory (the other rank is then stopped).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def rank() -> dict:
    """One rank: the phase's round setup at the published vocabulary, then
    the round, with the peak and the card's use after each step."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    arch = cs.G2_ARCHS[1]
    vocab = get_config(arch).vocab_size
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(cs.TP_RANKS, model=cs.TP_RANKS)
    rec = {"rank": dist.get_rank(), "vocab": vocab, "wire": "fp32"}

    def note(step):
        free, total = torch.cuda.mem_get_info()
        rec[f"{step}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec[f"{step}_card_used_gb"] = (total - free) / 1e9

    step = "setup"
    try:
        setup = cs.tp2_round_setup(torch, arch, "cuda", False, "fp32",
                                   vocab)
        note(step)
        step = "round"
        rec["round_s"] = cs.tp2_round(torch, setup, mesh, "cuda")["seconds"]
        note(step)
    except torch.cuda.OutOfMemoryError as e:
        note("oom")
        rec["oom_in"] = step
        rec["oom"] = str(e).splitlines()[0][:400]
    print("rank " + json.dumps(rec, sort_keys=True), flush=True)
    if "oom" in rec:
        raise RuntimeError(f"rank {rec['rank']} ran out of memory in {step}")
    return rec


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks
    build.timed_build()
    try:
        ranks = spawn_ranks(rank, cs.TP_RANKS, threads=2)
    except Exception as e:  # a rank's out-of-memory error, with its trace
        print(f"failed: {str(e).strip().splitlines()[-1]}", flush=True)
        sys.exit(1)
    print(json.dumps({"ranks": ranks}, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
