"""FederatedEngine: population-scale driver for the SFPrompt protocol — the
port of the synchronous `repro/fed/engine.py`.

One object owns the full loop:

    sample cohort (ClientSampler)  ->  gather data (Population)
    ->  simulate stragglers (RoundScheduler)  ->  train the cohort
    (SFPromptTrainer.round)  ->  write back per-client state  ->  checkpoint.

and makes it RESUMABLE: `save()` writes params, the round counter, the
TrafficMeter totals, the sampler and scheduler state, the population's
per-client state and the privacy ledger into one atomic npz (the JAX
package's layout); `restore()` brings a killed run back to a state from
which every later round — cohort, straggler plan, parameter update,
metered bytes, epsilon — is byte-identical to the uninterrupted run
(samplers, schedulers and the trainer's noise generators are pure
functions of (seed, round), so the round counter IS their position).

A trainer without `supports_partial` (the FL and SFL baselines) trains its
cohort synchronously: the straggler plan is ignored for it, as in the JAX
package.

The trainer fingerprint covers the trainer's hyperparameter reprs; the
port's `ProtocolConfig` has no `impl` field, so a checkpoint written by the
JAX package's engine fails the check here rather than resuming silently.

On a mesh (an `SFPromptTrainer(mesh=...)`) every rank runs the same
engine: the samplers and schedulers are pure functions of their seeds, so
every rank draws the same cohort and plan. A checkpoint holds the params
gathered whole; the lead rank alone writes it, and a restore cuts each
rank's shards again.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import load_latest, save_checkpoint
from repro_torch.fed.population import Population
from repro_torch.fed.sampler import ClientSampler
from repro_torch.fed.scheduler import (FullParticipationScheduler, RoundPlan,
                                       RoundScheduler)
from repro_torch.launch.mesh import is_lead
from repro_torch.tree import tree_map


def whole_params(trainer, params):
    """The params a checkpoint holds: on a mesh the trainer's local shards
    gathered whole (a collective: every rank calls it)."""
    full = getattr(trainer, "full_params", None)
    return params if full is None else full(params)


def rank_params(trainer, params):
    """Restored whole params cut to this rank's shards (identity without
    a mesh)."""
    shard = getattr(trainer, "shard_params", None)
    return params if shard is None else shard(params)


def write_run(trainer, ckpt_dir: str, state, *, step: int,
              keep_last: Optional[int]) -> str:
    """`save_checkpoint` on the lead rank alone; on a mesh every rank then
    waits for the file, so a restore that follows reads it. Returns the
    checkpoint's path."""
    mesh = getattr(trainer, "mesh", None)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    if is_lead(mesh):
        path = save_checkpoint(ckpt_dir, state, step=step,
                               keep_last=keep_last)
    if mesh is not None:
        dist.barrier()
    return path


def trainer_fingerprint(trainer) -> np.int64:
    """CRC of the trainer's hyperparameter dataclasses (ProtocolConfig,
    SplitConfig, ModelConfig reprs, wire + aggregator descriptors) —
    checkpointed so a resume with changed flags fails loudly. The port's
    copy of `repro/fed/async_engine.py::trainer_fingerprint`."""
    parts = []
    for attr in ("pcfg", "bcfg"):
        if hasattr(trainer, attr):
            parts.append(repr(getattr(trainer, attr)))
    model = getattr(trainer, "model", None)
    if model is not None:
        parts.append(repr(getattr(model, "split", None)))
        parts.append(repr(getattr(model, "cfg", None)))
        parts.append(model.wire.describe())
    aggregator = getattr(trainer, "aggregator", None)
    if aggregator is not None:
        parts.append(aggregator.describe())
    return np.int64(zlib.crc32("|".join(parts).encode()))


class FederatedEngine:
    def __init__(self, trainer, population: Population,
                 sampler: ClientSampler,
                 scheduler: Optional[RoundScheduler] = None, *,
                 personalize_tails: bool = False):
        if sampler.n_clients != population.n_clients:
            raise ValueError(
                f"sampler over {sampler.n_clients} clients but population "
                f"has {population.n_clients}")
        self.trainer = trainer
        self.population = population
        self.sampler = sampler
        if scheduler is not None and not getattr(
                trainer, "supports_partial", False):
            raise ValueError(
                f"{type(trainer).__name__} trains its cohort synchronously "
                "and cannot honor a straggler plan — omit the scheduler")
        self.scheduler = scheduler or FullParticipationScheduler(
            seed=sampler.seed)
        if personalize_tails and not getattr(
                getattr(trainer, "pcfg", None), "return_client_trainable",
                False):
            raise ValueError(
                "personalize_tails=True needs a trainer built with "
                "ProtocolConfig(return_client_trainable=True) so per-client "
                "tails survive the round")
        self.personalize_tails = personalize_tails
        self.round_idx = 0
        self.state: Optional[Dict[str, Any]] = None
        self.cohort_history: list = []   # per-round sampled ids (this run)

    # --------------------------------------------------------------- state
    def init(self, generator: torch.Generator) -> None:
        self.state = self.trainer.init(generator)
        self.round_idx = 0

    @property
    def params(self):
        return self.state["params"]

    # --------------------------------------------------------------- round
    def run_round(self, **round_kw) -> Tuple[RoundPlan, Dict[str, float]]:
        """Sample -> gather -> schedule -> train -> write back. Returns the
        straggler plan and the trainer metrics for the round. `round_kw`
        (e.g. `wire_noise=`, `dp_noise=`) passes through to the trainer."""
        if self.state is None:
            raise RuntimeError("call init(generator) or restore(ckpt_dir) "
                               "first")
        r = self.round_idx
        cohort = self.sampler.sample(r)
        plan = self.scheduler.plan(cohort, r)
        data = self.population.gather(cohort)

        if getattr(self.trainer, "supports_partial", False):
            part = plan.participation()
            # paper Eq. 3: FedAvg weighted by TRUE per-client sample counts
            # (pre-padding Dirichlet sizes), folded into the participation
            # weight — fedavg_partial normalizes, so only ratios matter
            part["aggregate"] = (part["aggregate"] *
                                 self.population.cohort_sizes(cohort)
                                 .astype(np.float32))
            init_tails = None
            if self.personalize_tails:
                # each sampled client resumes from its OWN last tail
                # (global tail for the never-sampled); FedAvg still feeds
                # the shared global tail every round
                per_client = self.population.get_tails(
                    cohort, self.state["params"]["tail"])
                if per_client is not None:
                    init_tails = tree_map(
                        lambda *xs: torch.stack(
                            [torch.as_tensor(x).to(self.trainer.device)
                             for x in xs]), *per_client)
            self.state, metrics = self.trainer.round(
                self.state, data, part, init_tails, **round_kw)
        else:
            # baselines (FL / SFL) predate partial participation: they run
            # the cohort synchronously and ignore the straggler plan
            self.state, metrics = self.trainer.round(self.state, data,
                                                     **round_kw)

        if self.personalize_tails:
            per_client = getattr(self.trainer, "last_client_trainable", None)
            if per_client is not None:
                # survivors keep their own post-round tail (pre-FedAvg)
                active_ids = cohort[plan.aggregate > 0]
                pos = np.flatnonzero(plan.aggregate > 0)
                tails = tree_map(lambda x: x.detach().cpu().numpy()[pos],
                                 per_client["tail"])
                self.population.set_tails(active_ids, tails)

        active = plan.aggregate > 0
        self.population.record_participation(cohort[active], r)
        metrics["cohort/sampled"] = float(len(cohort))
        metrics["cohort/dropped"] = float(plan.dropped.sum())
        metrics["cohort/late"] = float(plan.late.sum())
        self.cohort_history.append(np.asarray(cohort))
        self.round_idx = r + 1
        return plan, metrics

    # ------------------------------------------------------------- resume
    def _run_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            # the round rides as int32, the JAX package's layout
            "trainer": {"params": whole_params(self.trainer,
                                               self.state["params"]),
                        "round": np.int32(self.state["round"])},
            "round_idx": np.int64(self.round_idx),
            "sampler": self.sampler.state_dict(),
            "scheduler": {k: np.float64(v) for k, v in
                          self.scheduler.state_dict().items()},
            "personalize_tails": np.int64(int(self.personalize_tails)),
            "trainer_fingerprint": trainer_fingerprint(self.trainer),
            "population": self.population.state_dict(),
        }
        meter = getattr(self.trainer, "meter", None)
        if meter is not None:
            state["meter"] = meter.state_dict()
        accountant = getattr(self.trainer, "accountant", None)
        if accountant is not None:
            # the zCDP ledger rides the checkpoint as float64 scalars —
            # npz round-trips them byte-identically
            state["privacy"] = accountant.state_dict()
        return state

    def save(self, ckpt_dir: str, *, keep_last: Optional[int] = 3) -> str:
        """Atomic full-run checkpoint; safe to call every round. On a mesh
        every rank calls it and the lead rank writes."""
        return write_run(self.trainer, ckpt_dir, self._run_state(),
                         step=self.round_idx, keep_last=keep_last)

    def restore(self, ckpt_dir: str) -> bool:
        """Resume from the newest checkpoint in `ckpt_dir`. Returns False
        (engine untouched) when the directory holds none."""
        run = load_latest(ckpt_dir)
        if run is None:
            return False
        if "trainer_fingerprint" in run:
            saved_fp = int(run["trainer_fingerprint"])
            if saved_fp != int(trainer_fingerprint(self.trainer)):
                raise ValueError(
                    "trainer mismatch on resume: the checkpoint was "
                    "written with different hyperparameters (protocol / "
                    "split / model config or wire codec) — rebuild the "
                    "trainer with the original flags")
        if "personalize_tails" in run:
            saved = bool(int(run["personalize_tails"]))
            if saved != self.personalize_tails:
                raise ValueError(
                    f"personalize_tails mismatch on resume: checkpoint was "
                    f"written with {saved}, engine built with "
                    f"{self.personalize_tails} — the replayed rounds would "
                    f"silently diverge")
        accountant = getattr(self.trainer, "accountant", None)
        if accountant is not None and "privacy" not in run:
            raise ValueError(
                "DP trainer resumed from a checkpoint with no privacy "
                "ledger — the pre-checkpoint releases would be "
                "unaccounted; resume with the original DP flags")
        device = self.trainer.device
        # npz round-trips dtypes exactly: the restored params are
        # bit-identical to the saved ones
        params = tree_map(lambda x: torch.from_numpy(np.array(x)).to(device),
                          run["trainer"]["params"])
        self.state = {"params": rank_params(self.trainer, params),
                      "round": int(run["trainer"]["round"])}
        self.round_idx = int(run["round_idx"])
        self.sampler.load_state_dict(run["sampler"])
        if "scheduler" in run:
            self.scheduler.load_state_dict(run["scheduler"])
        self.population.load_state_dict(run["population"])
        if self.personalize_tails:
            self.population.restore_tails(params["tail"])
        meter = getattr(self.trainer, "meter", None)
        if meter is not None and "meter" in run:
            meter.load_state_dict(_flatten_numeric(run["meter"]))
        if accountant is not None:
            accountant.load_state_dict(run["privacy"])
        self.cohort_history = []
        return True


def _flatten_numeric(tree: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    """checkpoint.io round-trips nested dicts; the meter's state_dict is
    flat with '/'-keys — re-flatten what load produced."""
    out: Dict[str, float] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_numeric(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = float(np.asarray(v))
    return out
