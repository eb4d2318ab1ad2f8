"""Per-client split heterogeneity: different cut points in one round — the
port of `repro/runtime/hetero.py`.

Resource-limited fleets are not uniform — a phone holds one transformer
cycle per client segment, a workstation three. `ClientPlan` groups clients
by their `SplitConfig`; each group trains through its own `SplitModel`
(same backbone config, different head/tail cycle counts, same wire codecs)
and its own `SFPromptTrainer`, and the round ends with a cross-group
FedAvg of the soft prompt — the one trainable tensor whose shape is
split-invariant. Tails stay personalized per group (their layer counts
differ), in the style of flexible personalized split FL (Yuan et al.,
arXiv:2508.10349).

Wire traffic from every group lands in one shared `TrafficMeter`, so the
comm accounting stays honest under heterogeneity. Import this module
directly (`repro_torch.runtime` does not): it depends on `core`, which
depends on `runtime`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.protocol import (ProtocolConfig, SFPromptTrainer,
                                       WireNoise)
from repro_torch.core.split import SplitConfig, SplitModel, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.boundary import WireSpec
from repro_torch.runtime.meter import TrafficMeter


@dataclass(frozen=True)
class ClientPlan:
    """One homogeneous group: `n_clients` devices sharing a cut point."""
    split: SplitConfig
    n_clients: int
    name: str = ""


def group_seed(seed: int, group: int) -> int:
    """Seed of group `group`'s init generator, derived from `seed`."""
    return (seed * 1_000_003 + group) % (2 ** 63)


class HeteroSFPromptTrainer:
    """Runs one SFPrompt round across groups with different cut points."""

    def __init__(self, cfg: ModelConfig, plans: Sequence[ClientPlan],
                 pcfg: ProtocolConfig, wire: Optional[WireSpec] = None, *,
                 device="cuda"):
        if not plans:
            raise ValueError("need at least one ClientPlan")
        p_lens = {p.split.prompt_len for p in plans}
        if len(p_lens) != 1:
            raise ValueError(
                f"prompt_len must match across plans for cross-group "
                f"aggregation; got {sorted(p_lens)}")
        self.cfg = cfg
        self.plans = list(plans)
        self.device = resolve_device(device)
        self.trainers: List[SFPromptTrainer] = [
            SFPromptTrainer(SplitModel(cfg, p.split, wire), pcfg,
                            device=self.device)
            for p in plans]
        self.meter = TrafficMeter()

    # ------------------------------------------------------------- state
    def init(self, generator: torch.Generator) -> List[Dict]:
        """Per-group states, each drawn from a generator seeded with
        `group_seed(generator.initial_seed(), group)` (the counterpart of
        JAX's `fold_in(key, i)`)."""
        seed = generator.initial_seed()
        return [t.init(torch.Generator(device=self.device).manual_seed(
            group_seed(seed, i))) for i, t in enumerate(self.trainers)]

    # ------------------------------------------------------------- round
    def round(self, states: List[Dict], group_data: Sequence, *,
              wire_noise: Optional[WireNoise] = None
              ) -> Tuple[List[Dict], Dict]:
        """group_data[i]: a cohort with leading (plans[i].n_clients, n, ...)
        axes. Returns (new per-group states with the globally-averaged
        prompt written back, merged metrics). `wire_noise` goes to every
        group's trainer."""
        new_states, metrics = [], {}
        wire_totals: Dict[str, float] = {}
        for i, (tr, st, data) in enumerate(
                zip(self.trainers, states, group_data)):
            st, m = tr.round(st, data, wire_noise=wire_noise)
            new_states.append(st)
            tag = self.plans[i].name or f"g{i}"
            for k, v in m.items():
                if k.startswith("wire/"):
                    wire_totals[k] = wire_totals.get(k, 0.0) + v
                metrics[f"{tag}/{k}"] = v

        # cross-group prompt FedAvg (client-count weighted, normalized in
        # f32 and summed in group order from 0); tails stay personalized
        # per group — their shapes differ across cut points
        w = torch.tensor([p.n_clients for p in self.plans],
                         dtype=torch.float32, device=self.device)
        w = w / w.sum()
        prompt = sum(wi * st["params"]["prompt"]
                     for wi, st in zip(w, new_states))
        for st in new_states:
            st["params"] = dict(st["params"], prompt=prompt)

        metrics.update(wire_totals)
        self.meter.absorb({k.removeprefix("wire/").removesuffix("_bytes"): v
                           for k, v in wire_totals.items()})
        return new_states, metrics

    # ------------------------------------------------------------- eval
    def evaluate(self, states: List[Dict], data, *,
                 batch_size: int = 32) -> Dict:
        """Client-count-weighted mean of each group's `evaluate`, plus the
        groups' own results under "per_group"."""
        per_group = [t.evaluate(s["params"], data, batch_size=batch_size)
                     for t, s in zip(self.trainers, states)]
        w = [p.n_clients for p in self.plans]
        tot = sum(w)
        out = {k: sum(wi * g[k] for wi, g in zip(w, per_group)) / tot
               for k in per_group[0]}
        out["per_group"] = per_group
        return out
