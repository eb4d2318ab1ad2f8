"""Production-mesh dry-run on the `meta` device — the port of
`repro/launch/dryrun.py`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep   # 10 x 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --multi-pod

Per combination the SFPrompt step (phase-2 split training step + phase-3
aggregation for train_4k; split-inference prefill / decode for the
serving shapes) runs on `meta` tensors as rank 0 of the production mesh
(`launch.mesh.make_production_mesh`, a `parallel.AccountingMesh`: JAX's
axis names and sizes, no process group): its client block, its shards of
the frozen head and body under the port's rules (FSDP by JAX's 4 GB
rule), its block of the batch and of the cache's slots, the tail whole.
Nothing is allocated and nothing runs on a card; the numbers are
accounting, not measurement:

* `memory.argument_size_in_bytes`: rank 0's bytes of params, optimizer
  state, batch and cache; `memory.temp_size_in_bytes`: the peak of the
  bytes its step's ops allocated and held at once (`hlo.OpAccount`);
  `memory.per_device_total_gb` their sum (a rank's already: no division
  by the chips, unlike JAX's whole-module figures);
* `collective_bytes` and `op_counts_full` from the production pass (the
  collective log, `hlo.py`);
* `hlo_flops` / `hlo_bytes`: rank 0's FLOPs (XLA's convention,
  `hlo.OpAccount`) and op bytes in the analysis pass; `hlo_flops_global`
  / `hlo_bytes_global` the same for the unsharded step (whole params; a
  train step's K clients counted as K times one client's step of the
  same shape, the FedAvg's K-fold weighting and sum included) on
  `meta`;
* `roofline` by the card's constants (`launch.mesh`), `bottleneck`,
  `model_flops` (JAX's formula) and `useful_flops_frac`.

Both passes run `impl="analysis"`: the scans take their loop-free chunked
forms (on `meta` they do in any case). The production pass of train_4k
uses JAX's `MICROBATCHES` and the analysis pass one microbatch, as
`lower_one` does; a serving shape has no microbatches, so one pass serves
both there (the two would run the same ops on the same inputs). Eager
PyTorch has no rematerialization, so `remat` changes nothing. A Python
loop over layers runs every call, so nothing needs JAX's trip-count
correction.

Results go as JSON to the git-ignored `build/dryrun/`
(<arch>__<shape>__<mesh>[__tag].json). A failing combination is listed
and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.split import SplitConfig, SplitModel
from repro_torch.launch import hlo as hlo_util
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     data_parallel_size,
                                     make_production_mesh)
from repro_torch.launch.specs import (SHAPES, ShapeSpec, batch_specs,
                                      cache_specs, param_specs,
                                      stack_client_axis)
from repro_torch.sharding import parallel
from repro_torch.sharding.rules import params_pspecs, report_fallbacks
from repro_torch.tree import tree_leaves, tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../build/dryrun")

# microbatch count for phase-2 gradient accumulation, by rough model scale
MICROBATCHES = {
    "nemotron-4-340b": 8, "deepseek-v3-671b": 16, "qwen2-vl-72b": 4,
    "phi3.5-moe-42b-a6.6b": 4, "zamba2-2.7b": 4,
}
DEFAULT_SPLIT = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=16,
                            prune_gamma=0.5, local_epochs=10)


def default_split_for(cfg) -> SplitConfig:
    return DEFAULT_SPLIT


def _model_flops(cfg, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D=new
    tokens only. Forward-only shapes use 2*N*D."""
    n_params = cfg.param_count()
    if cfg.moe is not None:
        e = cfg.moe
        dense_like = cfg.param_count() - cfg.n_cycles * (
            (e.n_experts - e.top_k) * 3 * cfg.d_model * e.d_ff_expert)
        n_params = dense_like
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq
        return 2.0 * n_params * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_params * tokens


FSDP_THRESHOLD_GB = 4.0  # per-rank frozen bytes above which the body is
#                           additionally data-sharded (JAX's rule)


def _needs_fsdp(model: SplitModel, mesh) -> bool:
    shapes = model.init(torch.Generator(), device="meta")
    frozen_bytes = sum(s.numel() * 2  # bf16
                       for seg in ("head", "body")
                       for s in tree_leaves(shapes[seg]))
    per_device = frozen_bytes / mesh.shape["model"]
    return per_device > FSDP_THRESHOLD_GB * 2**30


def _nbytes(tree) -> int:
    """Bytes a rank holds of a tuple of trees of tensors (an FSDP leaf's
    block)."""
    total = 0
    for x in tree_leaves(dict(enumerate(tree))):
        if x is None:
            continue
        x = x.local if isinstance(x, parallel.DataSharded) else x
        total += x.numel() * x.element_size()
    return total


def _build(model: SplitModel, shape: ShapeSpec, prod_mesh, mesh, *,
           loss_mode: str, microbatches: int, impl: str, fsdp: bool,
           clients: Optional[int] = None):
    """(step, args) of rank 0's step on `mesh` (the accounting mesh), or
    of the unsharded step with `mesh` None; every tensor on `meta`.
    `clients` replaces the number of clients a train step runs."""
    cfg = model.cfg
    train = shape.kind == "train"
    planes = 1 if mesh is None else data_parallel_size(mesh)
    pspecs = param_specs(model, trainable_dtype=(
        torch.float32 if train else torch.bfloat16))
    frozen = {"head": pspecs["head"], "body": pspecs["body"]}
    if mesh is not None:
        specs = params_pspecs(frozen, mesh, fsdp=fsdp)
        report_fallbacks(f"{cfg.name}/{shape.name}")
        frozen = tree_map(lambda x, s: parallel.cut_leaf(x, s, mesh),
                          frozen, specs)
        model = model.on_mesh(mesh)
    if train:
        K = data_parallel_size(prod_mesh)
        b = shape.global_batch // K
        n = clients or K // planes
        step, opt = steps_lib.make_train_step(
            model, n_clients=n, microbatches=min(microbatches, b),
            loss_mode=loss_mode, impl=impl)
        trainable = stack_client_axis(
            {"tail": pspecs["tail"], "prompt": pspecs["prompt"]}, n)
        opt_state = steps_lib.init_opt_states(opt, trainable)
        batch = stack_client_axis(batch_specs(cfg, shape, leading=(b,)), n)
        return step, (frozen, trainable, opt_state, batch)
    B = shape.global_batch
    rows = B // planes if B % planes == 0 else B
    params = dict(frozen, tail=pspecs["tail"], prompt=pspecs["prompt"])
    batch = batch_specs(cfg, shape, leading=(rows,))
    cache = cache_specs(model, shape, batch=rows)
    make = (steps_lib.make_prefill_step if shape.kind == "prefill"
            else steps_lib.make_decode_step)
    return make(model, impl=impl), (params, batch, cache)


def _run(step, args, live: bool = True):
    """One meta pass: (OpAccount, collective log, seconds); `live` tracks
    the peak of live bytes."""
    t0 = time.time()
    with parallel.collective_log() as log, \
            hlo_util.OpAccount(live=live) as acc:
        out = step(*args)
        del out
    return acc, log, time.time() - t0


def account_one(arch: str, shape_name: str, *, multi_pod: bool = False,
                loss_mode: str = "logits",
                microbatches: Optional[int] = None, remat: bool = True,
                tag: str = "", analysis: bool = True, fsdp=None,
                cfg=None, mesh=None) -> Dict[str, Any]:
    """The accounting of one (arch, shape, mesh) combination, under JAX's
    result keys where their meaning carries over. `cfg` replaces the
    arch's config and `mesh` the production mesh (an `AccountingMesh`;
    a reduced config on a small mesh, in the tests)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    model = SplitModel(cfg, default_split_for(cfg))
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mb = microbatches or MICROBATCHES.get(arch, 1)
    if fsdp is None:
        fsdp = _needs_fsdp(model, mesh)
    kw = dict(loss_mode=loss_mode, impl="analysis", fsdp=fsdp)

    step, args = _build(model, shape, mesh, mesh, microbatches=mb, **kw)
    acc, log, full_s = _run(step, args, live=True)
    n_chips = mesh.size
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name,
        "kind": shape.kind, "n_chips": n_chips, "loss_mode": loss_mode,
        "microbatches": mb, "fsdp": fsdp, "full_pass_s": round(full_s, 1),
        "tag": tag,
    }
    args_b, temp_b = _nbytes(args), acc.peak_bytes
    result["memory"] = {
        "argument_size_in_bytes": args_b, "temp_size_in_bytes": temp_b,
        "per_device_total_gb": round((args_b + temp_b) / 2**30, 3)}
    result["op_counts_full"] = hlo_util.count_ops(acc, log)
    coll = hlo_util.collective_bytes(log)
    result["collective_bytes"] = coll
    del args, step

    if analysis:
        t1 = time.time()
        if shape.kind == "train" and min(mb, shape.global_batch) > 1:
            step, args = _build(model, shape, mesh, mesh, microbatches=1,
                                **kw)
            acc, _, _ = _run(step, args, live=False)
            del args, step
        result["hlo_flops"] = float(acc.flops)
        result["hlo_bytes"] = float(acc.bytes)
        # the unsharded train step is K clients' work of one shape (each
        # its local step; the FedAvg's weighting and sum are K-fold too):
        # K times one client's step, which takes 1/K of the time on `meta`
        k = data_parallel_size(mesh) if shape.kind == "train" else 1
        step, args = _build(model, shape, mesh, None, microbatches=1,
                            clients=1 if k > 1 else None, **kw)
        whole, _, _ = _run(step, args, live=False)
        del args, step
        result["hlo_flops_global"] = float(whole.flops) * k
        result["hlo_bytes_global"] = float(whole.bytes) * k
        result["analysis_pass_s"] = round(time.time() - t1, 1)
    else:
        result["hlo_flops"] = result["hlo_bytes"] = 0.0
        result["hlo_flops_global"] = result["hlo_bytes_global"] = 0.0

    flops, bytes_acc = result["hlo_flops"], result["hlo_bytes"]
    result["roofline"] = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll.get("total", 0) / LINK_BW,
    }
    terms = result["roofline"]
    result["bottleneck"] = max(terms, key=terms.get)
    mf = _model_flops(cfg, shape)
    result["model_flops"] = mf
    result["useful_flops_frac"] = mf / (flops * n_chips) if flops else 0.0
    return result


def _result_path(arch, shape, mesh_name, tag) -> str:
    tag = f"__{tag}" if tag else ""
    name = re.sub(r"[^A-Za-z0-9_.\-]", "_",
                  f"{arch}__{shape}__{mesh_name}{tag}.json")
    return os.path.join(RESULTS_DIR, name)


def save_result(res: Dict[str, Any]) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = _result_path(res["arch"], res["shape"], res["mesh"], res["tag"])
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="all assigned archs x shapes")
    ap.add_argument("--loss-mode", default="logits",
                    choices=["logits", "fused"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true",
                    help="accepted for JAX's flags: eager PyTorch has no "
                         "rematerialization")
    ap.add_argument("--force-fsdp", action="store_true",
                    help="always 2D-shard the frozen body")
    ap.add_argument("--no-analysis", action="store_true",
                    help="the production pass only")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.sweep or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.sweep or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                out = _result_path(arch, shape, mesh_name, args.tag)
                if args.skip_existing and os.path.exists(out):
                    print(f"[skip] {arch} x {shape} x {mesh_name}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                      flush=True)
                try:
                    res = account_one(
                        arch, shape, multi_pod=mp, loss_mode=args.loss_mode,
                        microbatches=args.microbatches,
                        remat=not args.no_remat, tag=args.tag,
                        analysis=not args.no_analysis,
                        fsdp=(True if args.force_fsdp else None))
                    path = save_result(res)
                    r = res["roofline"]
                    print(f"  ok: {res['full_pass_s']}s "
                          f"bottleneck={res['bottleneck']} "
                          f"compute={r['compute_s']:.3e}s "
                          f"mem={r['memory_s']:.3e}s "
                          f"coll={r['collective_s']:.3e}s "
                          f"rank={res['memory']['per_device_total_gb']}GB "
                          f"-> {path}", flush=True)
                except Exception as e:
                    failures.append((arch, shape, mesh_name, repr(e)))
                    print(f"  FAIL: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-runs accounted OK")


if __name__ == "__main__":
    main()
