"""Continuous-batching split-serving launcher.

The port of `repro/launch/serve.py`: runs the `serve.ServeEngine` — slot-
based shared KV cache, interleaved prefill/decode so requests join
in-flight batches, per-tenant (tail, prompt) from a `TenantBank` — against
the deterministic synthetic workload (a pure function of --seed). Reports
tokens/s, p50/p99 latency, slot occupancy, and the measured smashed-tensor
wire traffic next to the analytical per-token model, in the JAX launcher's
report lines.

Paged engine knobs: `--page-size N` (N > 0) swaps in the
`PagedServeEngine` — page-pool KV with per-slot block tables — with
`--n-pages` sizing the pool (default: one full window per slot),
`--shared-prefix K` prepending K deterministic common-prefix tokens to
every request with copy-on-write page sharing across same-tenant
requests, and `--prefill-chunk C` streaming prompts in C-token pieces.
Paging never changes the wire protocol; a prefix HIT meters fewer prefill
bytes, so measured <= analytical when sharing kicks in.

Runs on the GPU unless asked for the CPU (--device cpu):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --requests 16 --slots 8 --tenants 4 --wire int8
  PYTHONPATH=src python -m repro_torch.launch.serve --page-size 16 \\
      --shared-prefix 24 --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b

`--arch zamba2-2.7b` (Mamba-2 + one shared attention block) and
`--arch rwkv6-3b` serve recurrent-state families through the dense
engine; the paged engine refuses them (recurrent state has no pages).

`--params PATH` serves the weights of an npz checkpoint (a training run's
`final.npz`, written by either package) instead of a fresh init; a
missing, extra or misshapen leaf raises.

Observability: `--trace-level {round,step}` records the engine's spans
and the meter's byte events; `--trace-out BASE` (which implies `round`)
writes BASE.jsonl, BASE.trace.json (Chrome/Perfetto) and BASE.prom at the
end; `--metrics-every N` prints a metrics-registry snapshot every N
engine steps; `--trace-profiler` wraps the traced dispatches in
`torch.profiler.record_function` ranges. `python tools/trace_check.py
BASE.jsonl` validates the export (traced bytes == the meter's).

Serving on a mesh: `--mesh-devices N` starts N host ranks (a gloo group,
spawned by the launcher) that serve the same trace on
`make_host_mesh(N, model=T)` with T = `--mesh-model`: the frozen head and
body cut over 'model', the dense cache's slots over 'data' = N / T (each
rank decodes its block of slots; the next tokens are gathered), the
paged pool replicated over 'data'. `--mesh-devices` defaults to
`--mesh-model`, so `--mesh-model T` alone serves on (data 1, model T),
the counterpart of the JAX launcher's mesh over every visible device.
Rank 0 prints. On the card every rank shares the one GPU, so its rate is
that of gloo through host memory, not of a mesh. Every token family runs
(MoE expert-parallel; MLA, Mamba-2 and RWKV-6 on a rank's heads):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mesh-model 2 --requests 4 --wire int8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mesh-devices 4 --mesh-model 2 --requests 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import warnings

import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import SplitConfig, SplitModel
from repro_torch.core.comm import serve_comm_breakdown
from repro_torch.core.split import resolve_device
from repro_torch.launch.mesh import (check_host_mesh, is_lead,
                                     make_host_mesh, spawn_ranks)
from repro_torch.obs import MetricsRegistry, export_all, make_tracer
from repro_torch.obs.trace import LEVELS
from repro_torch.runtime import WireSpec
from repro_torch.runtime.meter import MB
from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                               ServeConfig, ServeEngine, TenantBank,
                               WorkloadConfig, synthetic_requests)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


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


def shared_prefix_tokens(n: int, vocab_size: int):
    """The deterministic synthetic shared prefix (a pure function of its
    length, standing in for a common system prompt), by the JAX launcher's
    formula."""
    return tuple(int(1 + (i * 13) % (vocab_size - 1)) for i in range(n))


def load_params(model: SplitModel, path: str, device) -> dict:
    """The params of the npz checkpoint at `path` on `device`. Every leaf
    must be one of `model`'s, with its shape and dtype: a missing, extra or
    misshapen leaf raises ValueError (nothing falls back to a fresh
    init)."""
    want = dict(tree_flatten(model.init(torch.Generator(), device="meta")))
    loaded = load_checkpoint(path)
    got = dict(tree_flatten(loaded))
    problems = [f"missing {'/'.join(k)}" for k in want if k not in got]
    problems += [f"unexpected {'/'.join(k)}" for k in got if k not in want]
    for k in want.keys() & got.keys():
        w, g = want[k], got[k]
        if tuple(g.shape) != tuple(w.shape) or \
                torch.as_tensor(g).dtype != w.dtype:
            problems.append(f"{'/'.join(k)}: {g.dtype}{list(g.shape)} in "
                            f"the file, {w.dtype}{list(w.shape)} in "
                            f"{model.cfg.name}")
    if problems:
        raise ValueError(f"--params {path} does not fit {model.cfg.name}: "
                         + "; ".join(sorted(problems)))
    return tree_map(lambda x: torch.as_tensor(x).to(device), loaded)


def _parse(argv):
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
                    help="tokens per KV page; > 0 serves with the paged "
                         "engine, 0 (default) keeps the dense slot cache")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size incl. the 2 reserved pages "
                         "(default: one full window per slot)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many deterministic common-prefix "
                         "tokens to every request, shared copy-on-write "
                         "across same-tenant requests (paged engine only)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="stream prompts in pieces of this many tokens "
                         "(paged engine only; default: monolithic)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks on the mesh's 'model' axis (frozen body "
                         "sharded, KV kv-heads sharded; 1 = none)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="serve on a (data, model) host mesh of this many "
                         "ranks, spawned by the launcher; 'data' = this / "
                         "--mesh-model holds the dense cache's slots "
                         "(default: --mesh-model; 1 = one process)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params", default=None,
                    help="checkpoint to serve (e.g. a training run's "
                         "final.npz); default: fresh random init")
    ap.add_argument("--wire", default="fp32", choices=("fp32", "bf16", "int8"),
                    help="codec for the smashed tensors on both boundaries")
    ap.add_argument("--trace-out", default=None,
                    help="flight-recorder export basename: writes "
                         "<base>.jsonl, <base>.trace.json (Chrome/Perfetto) "
                         "and <base>.prom; implies --trace-level round")
    ap.add_argument("--trace-level", default="off", choices=list(LEVELS),
                    help="flight-recorder detail: off = zero-overhead noop, "
                         "round = admission/prefill/retire spans + meter "
                         "bytes, step = decode steps and page churn too")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print a metrics-registry snapshot every N engine "
                         "steps (0 = only at the end when tracing is on)")
    ap.add_argument("--trace-profiler", action="store_true",
                    help="wrap traced device dispatches in "
                         "torch.profiler.record_function ranges")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    return ap.parse_args(argv)


def _model_cfg(args):
    cfg = get_config(args.arch)
    if args.reduced:
        # at least 3 layer-pattern cycles so head/body/tail are all non-empty
        cfg = cfg.reduced(n_layers=3 * len(cfg.layer_pattern))
    return cfg


def main(argv=None):
    """Serve the synthetic trace; returns the engine's stats (on a mesh,
    rank 0's)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse(argv)
    n = _mesh_devices(args)
    if n <= 1:
        return _serve(args, None)
    check_host_mesh(n, n, args.mesh_model)
    resolve_device(args.device)
    return spawn_ranks(_rank_main, n, argv)[0]


def _mesh_devices(args) -> int:
    return (args.mesh_model if args.mesh_devices is None
            else args.mesh_devices)


def _rank_main(argv):
    """One host rank of a `--mesh-devices` run; only rank 0 prints."""
    args = _parse(argv)
    mesh = make_host_mesh(_mesh_devices(args), model=args.mesh_model)
    if is_lead(mesh):
        return _serve(args, mesh)
    warnings.simplefilter("ignore")
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        _serve(args, mesh)


def _serve(args, mesh):
    cfg = _model_cfg(args)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    wire = WireSpec.make(args.wire)
    model = SplitModel(cfg, split, wire)
    device = resolve_device(args.device)
    if args.params:
        params = load_params(model, args.params, device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init(gen, device=device)

    trace_level = args.trace_level
    if args.trace_out and trace_level == "off":
        trace_level = "round"
    tracer = make_tracer(trace_level, profiler=args.trace_profiler)
    bank = personalized_bank(model, params, args.tenants)
    if args.page_size > 0:
        engine = PagedServeEngine(
            model, params, bank,
            PagedServeConfig(n_slots=args.slots, max_seq=args.max_seq,
                             decode_block=args.decode_block,
                             page_size=args.page_size,
                             n_pages=args.n_pages,
                             shared_prefix=shared_prefix_tokens(
                                 args.shared_prefix, cfg.vocab_size) or None,
                             prefill_chunk=args.prefill_chunk),
            mesh=mesh, tracer=tracer, device=device)
    else:
        if args.shared_prefix or args.prefill_chunk:
            raise SystemExit("--shared-prefix/--prefill-chunk need the "
                             "paged engine: pass --page-size N")
        engine = ServeEngine(model, params, bank,
                             ServeConfig(n_slots=args.slots,
                                         max_seq=args.max_seq,
                                         decode_block=args.decode_block),
                             mesh=mesh, tracer=tracer, device=device)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=args.requests,
        mean_interarrival=args.mean_interarrival,
        prompt_choices=tuple(args.prompt_choices),
        new_token_choices=tuple(args.new_token_choices),
        n_tenants=args.tenants, vocab_size=cfg.vocab_size,
        seed=args.seed))

    registry = MetricsRegistry()
    registry.bind_engine(engine)
    if args.page_size > 0:
        registry.bind_pool(engine.pool_alloc)

    on_step = None
    if args.metrics_every:
        def on_step(step_idx, _every=args.metrics_every):
            if step_idx % _every == 0:
                print(json.dumps({"step": step_idx,
                                  "metrics": registry.snapshot()},
                                 sort_keys=True, default=str), flush=True)
    stats = engine.run(reqs, on_step=on_step)

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
    # have rejected part of the trace. A shared prefix counts toward every
    # served request's prompt here; prefix HITS skip re-transmitting those
    # activations, so the measured total dips below analytical as the hit
    # ratio climbs.
    prefix_n = args.shared_prefix if args.page_size > 0 else 0
    analytical = serve_comm_breakdown(
        wire, d_model=cfg.d_model, soft_prompt_len=split.prompt_len,
        requests=[(len(f.req.tokens) + prefix_n, f.req.max_new)
                  for f in stats["finished"]])
    print(f"wire [{wire.describe()}]: {measured['total'] / MB:.3f} MB "
          f"measured ({measured['head_body'] / MB:.3f} head_body + "
          f"{measured['body_tail'] / MB:.3f} body_tail) vs "
          f"{sum(analytical.values()) / MB:.3f} MB analytical")
    if args.page_size > 0:
        print(f"pages: {stats['n_pages']} x {stats['page_size']} tok | "
              f"peak {stats['peak_pages']} | "
              f"in use {stats['pages_in_use']} | "
              f"COW copies {stats['page_copies']} | "
              f"prefix hits {stats['prefix_hits']}/"
              f"{stats['prefix_hits'] + stats['prefix_misses']} "
              f"(ratio {stats['prefix_hit_ratio']:.2f}) | "
              f"prefill chunks {stats['prefill_chunks']}")
    if tracer.enabled and args.trace_out and is_lead(mesh):
        paths = export_all(tracer, args.trace_out, meter=engine.meter,
                           registry=registry)
        for fmt, p in sorted(paths.items()):
            print(f"trace [{fmt}]: {p}", flush=True)
    elif tracer.enabled:
        print(json.dumps({"metrics": registry.snapshot()}, sort_keys=True,
                         default=str), flush=True)
    return stats


if __name__ == "__main__":
    main()
