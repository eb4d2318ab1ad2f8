"""SFPrompt training launcher — the port of `repro/launch/train.py`.

Rounds run through the federated population engine: an N-client
`Population` (N can be >> K), a deterministic `ClientSampler`, and a
`RoundScheduler` that simulates stragglers/dropouts. Runs checkpoint the
full round state (params, meter totals, sampler position, privacy ledger)
every `--ckpt-every` rounds; `--resume` restarts a killed run
byte-identically — including, in async mode, the delta buffer and the
in-flight clients. Each round appends one JSONL record (the JAX
launcher's keys) and is followed by `evaluate` where the trainer has one.

Two runtimes:
  * synchronous barrier (default) — `FederatedEngine`: every round waits
    for its whole surviving cohort before aggregating;
  * buffered async (`--async-buffer N`) — `AsyncRoundEngine`: sampled
    clients stream updates on their own simulated clocks, the server
    aggregates every N arrivals with staleness weights
    alpha / (1 + s)^beta (`--staleness-alpha/--staleness-beta`);
    `--async-concurrency` dispatch groups overlap, `--rounds` counts
    FLUSHES. Composes with `--secure-agg` (the flush is the secure-agg
    cohort) and `--dp-epsilon` (noise rides each client's update).

Aggregation and privacy knobs (sfprompt methods):
  * `--edges E` aggregates hierarchically (client -> edge -> global; K
    must divide into E equal blocks), each edge with its own secure
    aggregator under `--secure-agg`;
  * `--secure-agg` masks uploads (Bonawitz-style, uint32 ring, through the
    CUDA masked-encode kernel on the card);
  * `--dp-epsilon/--dp-delta/--dp-clip` run DP-SGD on client deltas with a
    zCDP ledger calibrated over `--rounds`.
`--wire {fp32,bf16,int8}` picks the codec of both cut points (the JAX
launcher always uses fp32).

Runs on the GPU unless asked for the CPU (--device cpu):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --layers 3 --clients 8 --k 3 --samples 96 --image-hw 32 \\
      --batch-size 8 --local-epochs 1 --rounds 2 --secure-agg \\
      --dp-epsilon 8 --dropout-rate 0.3 --ckpt-every 1 --out /tmp/r
  # buffered async over consumer WAN links, secure flushes
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --layers 3 --clients 8 --k 3 --samples 96 --image-hw 32 \\
      --batch-size 8 --local-epochs 1 --regime wan --async-buffer 3 \\
      --secure-agg --dropout-rate 0.2 --rounds 2 --out /tmp/a
  # after a crash / preemption: identical continuation
  PYTHONPATH=src python -m repro_torch.launch.train ... --resume

Methods: sfprompt (default), sfprompt-nolocal (the Fig-6 ablation arm),
fl, sfl-ff and sfl-linear. The baselines train their cohort synchronously
(the straggler plan only applies to SFPrompt's partial aggregation), have
no `evaluate` and no meter, and refuse the sfprompt-only flags as the JAX
launcher does: `--personalize-tails`, `--dropout-rate`/`--straggle`,
`--secure-agg`/`--dp-epsilon`, and the async, edge and mesh flags:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --method sfl-ff --reduced --layers 3 --dataset cifar10-syn \\
      --clients 4 --k 2 --samples 64 --image-hw 32 --batch-size 8 \\
      --local-epochs 1 --rounds 1 --out /tmp/b

Observability: `--trace-level {round,step}` records the round spans and
the meter's byte events (`step` adds the dispatch event and one span per
protocol phase, each closed after a device sync); `--trace-out BASE`
(which implies `round`) writes BASE.jsonl, BASE.trace.json
(Chrome/Perfetto) and BASE.prom at the end; `--metrics-every N` prints a
metrics-registry snapshot (the meter's totals) every N rounds;
`--trace-profiler` wraps the traced dispatches in
`torch.profiler.record_function` ranges. `python tools/trace_check.py
BASE.jsonl` validates the export (traced bytes == the meter's).

Mesh: `--mesh-devices N` starts N host ranks (a gloo group, spawned by
the launcher itself) that run the same rounds on an ('data',) mesh, each
training its block of the cohort; `--mesh-model M` folds it to
('data', 'model') with the frozen body tensor-parallel over M ranks;
`--fsdp` stores large frozen leaves sharded over 'data'. Rank 0 prints
and writes the log and checkpoints. On the card every rank shares the one
GPU. Every family runs tensor-parallel (MoE expert-parallel; MLA,
Mamba-2 and RWKV-6 on a rank's heads):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --layers 3 --dataset cifar10-syn --clients 8 --k 4 \\
      --samples 64 --image-hw 32 --batch-size 4 --local-epochs 1 \\
      --rounds 1 --mesh-devices 4 --mesh-model 2 --fsdp --out /tmp/m
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import warnings

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import (BaselineConfig, FLTrainer, ProtocolConfig,
                              SFLTrainer, SFPromptTrainer, SplitConfig,
                              SplitModel)
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.comm import (cost_inputs_from, sfprompt_comm,
                                   sfprompt_compute)
from repro_torch.core.split import resolve_device
from repro_torch.data import (DATASETS, synthetic_image_dataset,
                              synthetic_lm_dataset)
from repro_torch.fed import (AsyncConfig, AsyncRoundEngine, ClientSampler,
                             FederatedEngine, Population, RoundScheduler,
                             StragglerConfig)
from repro_torch.fed.engine import rank_params, whole_params
from repro_torch.fed.scheduler import LINK_REGIMES
from repro_torch.launch.mesh import (check_host_mesh, is_lead,
                                     make_host_mesh, spawn_ranks)
from repro_torch.obs import MetricsRegistry, export_all, make_tracer
from repro_torch.obs.trace import LEVELS
from repro_torch.privacy.dp import calibrate_noise
from repro_torch.runtime import WireSpec
from repro_torch.tree import tree_map

METHODS = ["sfprompt", "sfprompt-nolocal", "fl", "sfl-ff", "sfl-linear"]


def build_data(args, cfg):
    if args.dataset == "lm-syn":
        data = synthetic_lm_dataset(args.samples, args.seq_len,
                                    cfg.vocab_size, seed=args.seed)
        test = synthetic_lm_dataset(max(64, args.samples // 8), args.seq_len,
                                    cfg.vocab_size, seed=args.seed + 1)
    else:
        spec = DATASETS[args.dataset]
        data = synthetic_image_dataset(spec, args.samples, seed=args.seed,
                                       image_hw=args.image_hw)
        test = synthetic_image_dataset(spec, max(128, args.samples // 8),
                                       seed=args.seed + 1,
                                       image_hw=args.image_hw)
    scheme = "dirichlet" if (args.non_iid and "labels" in data) else "iid"
    population = Population.from_partition(data, args.clients, scheme=scheme,
                                           alpha=0.1, seed=args.seed)
    return population, test


def build_mesh(args):
    """The host mesh of this rank (--mesh-devices; None without it):
    ('data',), or ('data', 'model') with --mesh-model > 1."""
    if not args.mesh_devices:
        return None
    return make_host_mesh(args.mesh_devices, model=max(1, args.mesh_model))


def build_trainer(args, model, device, tracer=None, mesh=None):
    if not args.method.startswith("sfprompt"):
        bcfg = BaselineConfig(local_epochs=args.local_epochs,
                              batch_size=args.batch_size, lr=args.lr)
        if args.method == "fl":
            trainer = FLTrainer(model, bcfg, device=device)
        else:
            trainer = SFLTrainer(model, bcfg, mode=args.method.split("-")[1],
                                 device=device)
        # baselines have no tracer plumbing; a meter, where one exists,
        # still emits its byte events into the flight recorder
        meter = getattr(trainer, "meter", None)
        if meter is not None and tracer is not None:
            meter.attach_tracer(tracer)
        return trainer
    dp_noise = 0.0
    if args.dp_epsilon > 0:
        # budget the target (eps, delta) evenly across the full run
        dp_noise = calibrate_noise(args.dp_epsilon, args.dp_delta,
                                   args.rounds)
        print(f"DP: eps={args.dp_epsilon} delta={args.dp_delta} over "
              f"{args.rounds} round(s) -> noise multiplier "
              f"z={dp_noise:.3f} at clip C={args.dp_clip}", flush=True)
    pcfg = ProtocolConfig(
        clients_per_round=args.k, local_epochs=args.local_epochs,
        batch_size=args.batch_size, lr_local=args.lr, lr_split=args.lr,
        use_local_loss=(args.method == "sfprompt"),
        # async dispatch aggregates at flush time, from the per-client
        # trees the round returns — same flag personalized tails use
        return_client_trainable=(args.personalize_tails
                                 or args.async_buffer > 0),
        dp_clip=(args.dp_clip if args.dp_epsilon > 0 else 0.0),
        dp_noise_multiplier=dp_noise, dp_delta=args.dp_delta)
    if args.async_buffer > 0:
        # the trainer stays CLEAR under async: the flush, not the dispatch
        # round, is the (possibly secure) aggregation unit
        aggregator = None
    elif args.edges > 0:
        # hierarchical (client -> edge -> global) aggregation; on the
        # secure path each edge runs its own masked aggregator
        kw = {"seed": args.seed} if args.secure_agg else {}
        aggregator = get_aggregator(secure=args.secure_agg,
                                    n_edges=args.edges, cohort_size=args.k,
                                    **kw)
    elif args.secure_agg:
        aggregator = get_aggregator(secure=True, seed=args.seed)
    else:
        aggregator = None
    return SFPromptTrainer(model, pcfg, aggregator, mesh=mesh,
                           fsdp=args.fsdp, tracer=tracer, device=device)


def build_scheduler(args, population, model):
    """Per-client round cost from the Table-1 model bound to THIS
    model/split — the regime's comm-vs-compute mix then decides whether
    slow-link or slow-compute devices miss the deadline (sync) or arrive
    stale (async)."""
    toks = (args.seq_len if args.dataset == "lm-syn"
            else (args.image_hw // 16) ** 2 + 1)
    ci = cost_inputs_from(model.cfg, model.split, tokens_per_sample=toks,
                          D=population.n_local, K=args.k,
                          U=args.local_epochs, model=model)
    return RoundScheduler(
        StragglerConfig(regime=args.regime,
                        deadline_factor=args.deadline_factor,
                        dropout_rate=args.dropout_rate,
                        late_mode=args.late_mode),
        seed=args.seed,
        round_bytes_per_client=sfprompt_comm(ci) / args.k,
        round_flops_per_client=sfprompt_compute(ci))


def build_engine(args, trainer, population, model):
    sampler = ClientSampler(
        population.n_clients, args.k, kind=args.sampler, seed=args.seed,
        weights=(population.sizes.astype(float)
                 if args.sampler == "weighted" else None))
    if args.async_buffer > 0:
        # async always needs the latency model — arrival order IS the
        # runtime's semantics, not an optional failure simulation
        acfg = AsyncConfig(buffer_size=args.async_buffer,
                           concurrency=args.async_concurrency,
                           staleness_alpha=args.staleness_alpha,
                           staleness_beta=args.staleness_beta)
        aggregator = (get_aggregator(secure=True, seed=args.seed)
                      if args.secure_agg else None)
        return AsyncRoundEngine(trainer, population, sampler,
                                build_scheduler(args, population, model),
                                acfg, aggregator=aggregator)
    scheduler = None
    if args.dropout_rate > 0 or args.straggle:
        scheduler = build_scheduler(args, population, model)
    return FederatedEngine(trainer, population, sampler, scheduler,
                           personalize_tails=args.personalize_tails)


def _refuse_for_baselines(ap, args) -> None:
    """The JAX launcher's refusals of sfprompt-only flags under a baseline
    method, with its messages."""
    if args.method.startswith("sfprompt"):
        return
    if args.personalize_tails:
        ap.error("--personalize-tails needs an sfprompt method")
    if args.dropout_rate > 0 or args.straggle:
        ap.error("straggler simulation (--dropout-rate/--straggle) needs an "
                 "sfprompt method — FL/SFL baselines train their cohort "
                 "synchronously")
    if args.secure_agg or args.dp_epsilon > 0:
        ap.error("--secure-agg/--dp-epsilon need an sfprompt method — the "
                 "privacy engine plugs into the SFPrompt phase-3 "
                 "aggregation path")
    if args.mesh_devices or args.edges or args.fsdp:
        ap.error("--mesh-devices/--edges/--fsdp need an sfprompt method — "
                 "only the SFPrompt trainer dispatches sharded cohorts "
                 "and hierarchical aggregation")
    if args.async_buffer > 0:
        ap.error("--async-buffer needs an sfprompt method — only the "
                 "SFPrompt trainer exposes per-client updates for "
                 "flush-time aggregation")


def _refuse_runtime_mixes(ap, args) -> None:
    """The JAX launcher's refusals of edge layouts and async mixes, with
    its messages."""
    if args.mesh_model > 1 and not args.mesh_devices:
        ap.error("--mesh-model needs --mesh-devices: the 'model' axis is "
                 "carved out of the host mesh")
    if args.mesh_devices < 0:
        ap.error("--mesh-devices takes the number of host ranks to start "
                 "(the port has no visible-device count to default to)")
    if args.edges > 0 and args.k % args.edges != 0:
        ap.error(f"--k {args.k} must divide evenly into --edges "
                 f"{args.edges} contiguous blocks")
    if args.async_buffer > 0:
        if args.personalize_tails:
            ap.error("--async-buffer and --personalize-tails are mutually "
                     "exclusive (personalized tails ride the synchronous "
                     "engine's cohort write-back)")
        if args.edges > 0:
            ap.error("--async-buffer with --edges is not supported: the "
                     "flush cohort is the buffer, not an edge layout")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="vit-base")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=4,
                    help="layer count for --reduced (must exceed "
                         "head+tail cycles)")
    ap.add_argument("--method", default="sfprompt", choices=METHODS)
    ap.add_argument("--dataset", default="cifar100-syn",
                    choices=list(DATASETS) + ["lm-syn"])
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=50,
                    help="population size N (sampled K per round)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "weighted", "round_robin"])
    ap.add_argument("--straggle", action="store_true",
                    help="simulate stragglers even with --dropout-rate 0")
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--regime", default="fiber", choices=list(LINK_REGIMES))
    ap.add_argument("--deadline-factor", type=float, default=1.5)
    ap.add_argument("--late-mode", default="drop",
                    choices=["drop", "partial"])
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="buffered-async runtime: aggregate every N "
                         "arrivals instead of at a cohort barrier (0 = "
                         "synchronous). --rounds then counts flushes")
    ap.add_argument("--async-concurrency", type=int, default=2,
                    help="dispatch groups in flight at once under "
                         "--async-buffer (>= 2 overlaps client compute)")
    ap.add_argument("--staleness-alpha", type=float, default=1.0,
                    help="async flush weight numerator: alpha/(1+s)^beta")
    ap.add_argument("--staleness-beta", type=float, default=0.5,
                    help="async staleness decay exponent (0 = uniform "
                         "weights regardless of staleness)")
    ap.add_argument("--personalize-tails", action="store_true",
                    help="keep each sampled client's post-round tail in "
                         "the population")
    ap.add_argument("--edges", type=int, default=0,
                    help="hierarchical aggregation over this many edge "
                         "aggregators (0 = flat); K must divide evenly")
    ap.add_argument("--secure-agg", action="store_true",
                    help="masked secure aggregation: the server sums "
                         "blinded uint32 ring uploads it cannot invert")
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="target total DP epsilon over --rounds (0 = DP "
                         "off); calibrates the per-round Gaussian noise "
                         "via the zCDP ledger")
    ap.add_argument("--dp-delta", type=float, default=1e-5)
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="per-client L2 clip on the round delta (DP-SGD "
                         "sensitivity; used when --dp-epsilon > 0)")
    ap.add_argument("--local-epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--image-hw", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gamma", type=float, default=0.5)
    ap.add_argument("--head-cycles", type=int, default=1)
    ap.add_argument("--tail-cycles", type=int, default=1)
    ap.add_argument("--wire", default="fp32", choices=["fp32", "bf16", "int8"],
                    help="codec of both cut points")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the full run state every N rounds "
                         "(0 = only at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint under --out")
    ap.add_argument("--init-params", default=None,
                    help="checkpoint to warm-start from (pretrained backbone)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; nothing falls back")
    ap.add_argument("--trace-out", default=None,
                    help="flight-recorder export basename: writes "
                         "<base>.jsonl, <base>.trace.json (Chrome/Perfetto) "
                         "and <base>.prom; implies --trace-level round")
    ap.add_argument("--trace-level", default="off", choices=list(LEVELS),
                    help="flight-recorder detail: off = zero-overhead noop, "
                         "round = round spans + meter bytes, step = the "
                         "dispatch event and per-phase spans too")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print a metrics-registry snapshot every N rounds "
                         "(0 = only at the end when tracing is on)")
    ap.add_argument("--trace-profiler", action="store_true",
                    help="wrap traced device dispatches in "
                         "torch.profiler.record_function ranges")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="run the rounds on a host mesh of this many ranks "
                         "(spawned by the launcher; 0 = one process)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel size of the mesh's 'model' axis "
                         "(must divide --mesh-devices): the frozen body "
                         "computes sharded — attention head-parallel, MLP "
                         "d_ff-parallel (1 = data-only mesh)")
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP-shard large frozen params over the mesh's "
                         "data axis instead of replicating them")
    args = ap.parse_args(argv)
    _refuse_for_baselines(ap, args)
    _refuse_runtime_mixes(ap, args)
    return ap, args


def _model_cfg(args):
    cfg = get_config(args.arch)
    return cfg.reduced(n_layers=args.layers) if args.reduced else cfg


def _rank_main(argv) -> None:
    """One host rank of a `--mesh-devices` run: the launcher's rounds on
    this rank's mesh; only the lead rank prints."""
    ap, args = parse_args(argv)
    mesh = build_mesh(args)
    if is_lead(mesh):
        _run(ap, args, mesh)
        return
    warnings.simplefilter("ignore")
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        _run(ap, args, mesh)


def main(argv=None):
    """Run the launcher with `argv` (default: the command line). Returns
    the engine (`FederatedEngine`, or `AsyncRoundEngine` under
    `--async-buffer`) after the last round; with `--mesh-devices` the
    launcher starts the ranks, waits for them and returns None."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap, args = parse_args(argv)
    if not args.mesh_devices:
        return _run(ap, args, None)
    resolve_device(args.device)
    try:
        check_host_mesh(args.mesh_devices, args.mesh_devices,
                        args.mesh_model)
    except ValueError as e:
        ap.error(str(e))
    spawn_ranks(_rank_main, args.mesh_devices, argv)
    return None


def _run(ap, args, mesh):
    device = resolve_device(args.device)
    cfg = _model_cfg(args)
    split = SplitConfig(head_cycles=args.head_cycles,
                        tail_cycles=args.tail_cycles,
                        prompt_len=args.prompt_len, prune_gamma=args.gamma,
                        local_epochs=args.local_epochs)
    model = SplitModel(cfg, split, WireSpec.make(args.wire))
    population, test = build_data(args, cfg)
    if population.n_local < args.batch_size:
        ap.error(
            f"--batch-size {args.batch_size} exceeds the per-client shard "
            f"of {population.n_local} samples (= --samples {args.samples} "
            f"// --clients {args.clients}); lower --batch-size or raise "
            f"--samples")

    trace_level = args.trace_level
    if args.trace_out and trace_level == "off":
        trace_level = "round"
    tracer = make_tracer(trace_level, profiler=args.trace_profiler)

    trainer = build_trainer(args, model, device, tracer=tracer, mesh=mesh)
    engine = build_engine(args, trainer, population, model)
    lead = is_lead(mesh)
    ckpt_dir = os.path.join(args.out, "ckpt")

    registry = MetricsRegistry()
    meter = getattr(trainer, "meter", None)
    if meter is not None:
        registry.bind_meter(meter)
    if getattr(engine, "ledger", None) is not None:
        registry.bind_ledger(engine.ledger)

    is_async = args.async_buffer > 0

    def progress():
        return engine.version if is_async else engine.round_idx

    resumed = args.resume and engine.restore(ckpt_dir)
    if resumed:
        print(f"resumed from {'flush' if is_async else 'round'} "
              f"{progress()} ({ckpt_dir})", flush=True)
    else:
        engine.init(torch.Generator(device=device).manual_seed(args.seed))
        if args.init_params:
            warm = load_checkpoint(args.init_params)
            params = dict(whole_params(trainer, engine.state["params"]))
            for seg in ("head", "body", "tail"):
                if seg in warm:
                    params[seg] = tree_map(
                        lambda x: torch.as_tensor(x).to(device), warm[seg])
            engine.state = dict(engine.state,
                                params=rank_params(trainer, params))

    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(
        args.out, f"{args.arch}_{args.method}_{args.dataset}"
        f"{'_noniid' if args.non_iid else ''}.jsonl")
    if resumed and lead and os.path.exists(log_path):
        # drop records from rounds after the restored checkpoint — they are
        # about to be replayed and would otherwise appear twice in the log
        with open(log_path) as f:
            kept = []
            for line in f:
                try:
                    if json.loads(line).get("round", -1) < progress():
                        kept.append(line)
                except json.JSONDecodeError:
                    pass   # torn tail line from the kill
        with open(log_path, "w") as f:
            f.writelines(kept)
    # the lead rank keeps the log; every rank runs the rounds
    with open(log_path if lead else os.devnull,
              "a" if resumed else "w") as log:
        t0 = time.time()
        while progress() < args.rounds:
            r = progress()
            if is_async:
                metrics = engine.run_flushes(1)
                metrics["t_sim"] = engine.t_sim
                rec = {"round": r, "wall_s": round(time.time() - t0, 1),
                       **metrics}
            else:
                plan, metrics = engine.run_round()
                rec = {"round": r, "wall_s": round(time.time() - t0, 1),
                       "cohort": plan.cohort.tolist(), **metrics}
            if hasattr(trainer, "evaluate"):
                ev = trainer.evaluate(engine.params, test,
                                      batch_size=args.batch_size)
                rec.update({f"eval_{k}": v for k, v in ev.items()})
            log.write(json.dumps(rec) + "\n")
            log.flush()
            print(rec, flush=True)
            if args.metrics_every and (r + 1) % args.metrics_every == 0:
                print(json.dumps({"metrics": registry.snapshot()},
                                 sort_keys=True), flush=True)
            if args.ckpt_every and (r + 1) % args.ckpt_every == 0:
                engine.save(ckpt_dir)

    engine.save(ckpt_dir)
    final = whole_params(trainer, engine.params)
    if lead:
        save_checkpoint(os.path.join(args.out, "final.npz"), final)
    print("saved", os.path.join(args.out, "final.npz"), "log:", log_path)
    if meter is not None:
        print(meter.report())
    if tracer.enabled and args.trace_out and lead:
        paths = export_all(tracer, args.trace_out, meter=meter,
                           registry=registry)
        for fmt, p in sorted(paths.items()):
            print(f"trace [{fmt}]: {p}", flush=True)
    elif tracer.enabled:
        print(json.dumps({"metrics": registry.snapshot()}, sort_keys=True),
              flush=True)
    if is_async:
        print(f"async: {engine.version} flush(es) over {engine.t_sim:.1f} "
              f"simulated s, staleness mean "
              f"{engine.ledger.mean_staleness():.2f} "
              f"max {engine.ledger.max_staleness}")
    if getattr(trainer, "accountant", None) is not None:
        print(trainer.accountant.report())
    return engine


if __name__ == "__main__":
    main()
