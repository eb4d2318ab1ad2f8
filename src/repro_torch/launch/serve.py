"""Continuous-batching split-serving launcher (dense engine).

The port of `repro/launch/serve.py`: runs the `serve.ServeEngine` — slot-
based shared KV cache, interleaved prefill/decode so requests join
in-flight batches, per-tenant (tail, prompt) from a `TenantBank` — against
the deterministic synthetic workload (a pure function of --seed). Reports
tokens/s, p50/p99 latency, slot occupancy, and the measured smashed-tensor
wire traffic next to the analytical per-token model, in the JAX launcher's
report lines.

Runs on the GPU unless asked for the CPU (--device cpu):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --requests 16 --slots 8 --tenants 4 --wire int8

The paged engine (--page-size > 0, --shared-prefix, --prefill-chunk),
tensor-parallel serving (--mesh-model > 1), checkpoint loading (--params)
and the trace exporters (--trace-out, --metrics-every) belong to later
slices of the port; those flags exit with a message naming the slice.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core import SplitConfig, SplitModel
from repro_torch.core.comm import serve_comm_breakdown
from repro_torch.core.split import resolve_device
from repro_torch.obs.trace import LEVELS, make_tracer
from repro_torch.runtime import WireSpec
from repro_torch.runtime.meter import MB
from repro_torch.serve import (ServeConfig, ServeEngine, TenantBank,
                               WorkloadConfig, synthetic_requests)
from repro_torch.tree import tree_leaves


def personalized_bank(model: SplitModel, params, n_tenants: int,
                      *, jitter: float = 0.05, seed: int = 101) -> TenantBank:
    """A demo TenantBank: tenant 0 serves the global (tail, prompt); every
    other tenant gets a deterministically perturbed copy (jitter drawn from
    a `torch.Generator` seeded with `seed`), standing in for the per-client
    tails a federation run stores. The tenants' copies are written in place
    into the stacked bank, so no per-tenant list is ever held beside it."""
    bank = TenantBank.replicate(params["tail"], params["prompt"], n_tenants)
    if jitter == 0.0:
        return bank
    device = params["prompt"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    for t in range(1, n_tenants):
        for leaf in tree_leaves(bank.tails) + [bank.prompts]:
            if leaf.is_floating_point():
                leaf[t].add_(jitter * torch.randn(
                    leaf.shape[1:], generator=gen, device=device,
                    dtype=leaf.dtype))
    return bank


def _later_slice(args) -> str:
    if args.page_size > 0 or args.shared_prefix or args.prefill_chunk:
        return ("the paged engine (--page-size, --shared-prefix, "
                "--prefill-chunk) is ported with the paged-serving slice")
    if args.mesh_model > 1:
        return "--mesh-model > 1 is ported with the multi-device slice"
    if args.params:
        return "--params (checkpoint loading) is ported with the checkpoint slice"
    if args.trace_out or args.metrics_every:
        return ("--trace-out / --metrics-every (exporters, metrics registry) "
                "are ported with the observability slice")
    return ""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="CPU-sized same-family config (on by default)")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic workload length")
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent sequences in the shared KV cache")
    ap.add_argument("--tenants", type=int, default=4,
                    help="distinct (tail, prompt) pairs in the TenantBank")
    ap.add_argument("--max-seq", type=int, default=128,
                    help="KV-cache capacity per slot (prompt + new tokens)")
    ap.add_argument("--mean-interarrival", type=float, default=1.0,
                    help="Poisson arrival gap in engine steps")
    ap.add_argument("--prompt-choices", type=int, nargs="+",
                    default=[8, 16, 32],
                    help="prompt lengths the workload draws from")
    ap.add_argument("--new-token-choices", type=int, nargs="+",
                    default=[4, 8, 16],
                    help="output lengths the workload draws from")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens per decode dispatch (1 = per-token)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged engine (later slice); 0 keeps the dense "
                         "slot cache")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size (paged engine, later slice)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared prefix tokens (paged engine, later slice)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill (paged engine, later slice)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel serving (later slice); 1 = "
                         "single-device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params", default=None,
                    help="checkpoint to serve (later slice)")
    ap.add_argument("--wire", default="fp32", choices=("fp32", "bf16", "int8"),
                    help="codec for the smashed tensors on both boundaries")
    ap.add_argument("--trace-out", default=None,
                    help="flight-recorder export (later slice)")
    ap.add_argument("--trace-level", default="off", choices=list(LEVELS),
                    help="flight-recorder detail: off = zero-overhead noop, "
                         "round = admission/prefill/retire spans + meter "
                         "bytes, step = decode steps too")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="metrics-registry snapshots (later slice)")
    ap.add_argument("--trace-profiler", action="store_true",
                    help="wrap traced device dispatches in "
                         "torch.profiler.record_function ranges")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    reason = _later_slice(args)
    if reason:
        raise SystemExit(reason)

    cfg = get_config(args.arch)
    if args.reduced:
        # at least 3 layer-pattern cycles so head/body/tail are all non-empty
        cfg = cfg.reduced(n_layers=3 * len(cfg.layer_pattern))
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    wire = WireSpec.make(args.wire)
    model = SplitModel(cfg, split, wire)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)

    tracer = make_tracer(args.trace_level, profiler=args.trace_profiler)
    bank = personalized_bank(model, params, args.tenants)
    engine = ServeEngine(model, params, bank,
                         ServeConfig(n_slots=args.slots, max_seq=args.max_seq,
                                     decode_block=args.decode_block),
                         tracer=tracer, device=device)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=args.requests,
        mean_interarrival=args.mean_interarrival,
        prompt_choices=tuple(args.prompt_choices),
        new_token_choices=tuple(args.new_token_choices),
        n_tenants=args.tenants, vocab_size=cfg.vocab_size,
        seed=args.seed))
    stats = engine.run(reqs)

    print(f"{cfg.name}: {stats['n_finished']} requests over "
          f"{args.tenants} tenants | {stats['tokens_out']} tokens in "
          f"{stats['wall_s']:.2f}s = {stats['tok_per_s']:.1f} tok/s "
          f"(incl. compile)")
    print(f"latency p50 {stats['p50_latency_s'] * 1e3:.0f} ms | "
          f"p99 {stats['p99_latency_s'] * 1e3:.0f} ms | "
          f"occupancy {stats['occupancy']:.2f} | "
          f"{stats['prefills']} prefills / {stats['decode_steps']} "
          f"decode steps | rejected {stats['rejected']}")
    measured = stats["wire_bytes"]
    # compare against what was actually SERVED — admission control may
    # have rejected part of the trace
    analytical = serve_comm_breakdown(
        wire, d_model=cfg.d_model, soft_prompt_len=split.prompt_len,
        requests=[(len(f.req.tokens), f.req.max_new)
                  for f in stats["finished"]])
    print(f"wire [{wire.describe()}]: {measured['total'] / MB:.3f} MB "
          f"measured ({measured['head_body'] / MB:.3f} head_body + "
          f"{measured['body_tail'] / MB:.3f} body_tail) vs "
          f"{sum(analytical.values()) / MB:.3f} MB analytical")
    if tracer.enabled:
        print(json.dumps({"metrics": engine.live_stats(),
                          "trace_records": len(tracer.records())},
                         sort_keys=True, default=str), flush=True)
    return stats


if __name__ == "__main__":
    main()
