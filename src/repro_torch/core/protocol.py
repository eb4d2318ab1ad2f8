"""The SFPrompt three-phase protocol (Sec. 3, Fig. 3, Algorithms 1-2) — the
port of `repro/core/protocol.py`.

Per global round r:
  Phase 1a — client self-update: U local-loss epochs on (W_t, p) with the
             body skipped (zero server traffic);
  Phase 1b — EL2N scoring of each client's data and pruning to the top
             (1 - gamma) fraction;
  Phase 2  — split training over the pruned subset: head (client, frozen)
             -> body (server, frozen) -> tail (client, trainable), both cut
             points crossing the metered wire; the prompt's gradient flows
             back through the frozen body and both wire boundaries (with
             int8, the backward gradients are quantized too);
  Phase 3  — sample-count-weighted FedAvg of (W_t, p).

A Python loop over the K cohort clients replaces the JAX package's cohort
`vmap`; the frozen head and body are ONE shared copy (plain tensors that do
not require grad), never K copies. Gradients come from
`torch.autograd.grad` on the (tail, prompt) leaves alone.

The differentiated passes (phases 1a and 2) run attention and the
cross-entropy through their plain versions on every device, as the JAX
round runs with `impl="ref"`; the forward-only passes (phase 1b scoring
and `evaluate`) run under `torch.no_grad()` and launch the kernels on the
card: prefill attention in every layer, the int8 wire, and EL2N. So on the
card, scoring and evaluation are those of the JAX round with
`ProtocolConfig(impl="auto")`, not of its default `impl="ref"`, which runs
them plain on every backend (a deliberate difference, see `pruning.py`);
on the CPU the port matches the default.

Wire noise: with a stochastic codec (int8) every phase-2 crossing draws
stochastic-rounding uniforms from a per-client `torch.Generator` seeded
from WIRE_SEED, the round and the client, unless `round(wire_noise=...)`
hands them in (tests feed the exact uniforms of the JAX key derivation).
DP noise likewise: with `dp_clip > 0` each client's delta is clipped and
noised with unit normals from a per-(round, client) generator seeded from
DP_SEED, unless `round(dp_noise=...)` hands them in.

Phase 3 goes through the pluggable aggregator (clear FedAvg, the masked
secure aggregation of `privacy/secure_agg.py`, or the edge topology of
`fed/topology.py`; a metered aggregator bills its own uplink, key
agreement and backhaul). The zCDP accountant spends one release per round
when the noise multiplier is positive. `client_updates` is the async
runtime's dispatch: the round with an all-zero aggregate.

On a mesh (`mesh=`, a `launch.mesh.make_host_mesh` DeviceMesh, every rank
running the same calls): the frozen head and body are cut to this rank's
local shards by `sharding.rules.params_pspecs` and run tensor-parallel
over 'model' (`core/split.py`); with `fsdp=True` frozen leaves of at least
`fsdp_threshold` elements are also stored sharded over 'data' and
gathered a layer at a time. The tail and prompt, trainable, stay whole on
every rank. Each 'data' rank trains the contiguous block of clients that
`cohort_pspecs` gives it (all K where K does not divide the plane), with
the wire and DP noise of each client's GLOBAL index, so a client draws the
same numbers on any layout. The blocks' scores, trained (tail, prompt)
and per-client metrics are then assembled on every rank by all-reduces
over 'data', and the aggregator (clear, secure or edge) and every metric
run replicated, in the unsharded round's order: on a data-only mesh the
round is bit-equal to the unsharded one. Every family runs on a 'model'
axis > 1: MoE expert-parallel, MLA, Mamba-2 and RWKV-6 on a rank's heads,
Whisper's encoder and cross-attention and Qwen2-VL as attention does
(`models/layers.py`).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import losses, pruning
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.local_update import (batches, dp_clip_and_noise,
                                           local_epochs, value_and_grad)
from repro_torch.core.split import SplitModel, resolve_device
from repro_torch.obs.trace import LEVEL_STEP, NOOP
from repro_torch.optim import Optimizer, adamw, apply_updates, sgd
from repro_torch.privacy.dp import DP_SEED, PrivacyAccountant
from repro_torch.runtime.meter import EDGE, SECURE, TrafficMeter
from repro_torch.sharding import parallel
from repro_torch.sharding.rules import params_pspecs, report_fallbacks
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

Params = Dict[str, Any]
# (client, step, boundary name, shape) -> (u_fwd, u_bwd)
WireNoise = Callable[[int, int, str, Tuple[int, ...]],
                     Tuple[torch.Tensor, torch.Tensor]]
# (client, leaf path, shape) -> unit normals of that leaf's DP noise
DPNoise = Callable[[int, Tuple[str, ...], Tuple[int, ...]], torch.Tensor]

WIRE_SEED = 23   # base seed of the stochastic wire-rounding streams


@dataclass(frozen=True)
class ProtocolConfig:
    clients_per_round: int = 5       # K
    local_epochs: int = 10           # U (phase 1)
    split_epochs: int = 1            # passes over pruned data (phase 2)
    batch_size: int = 16
    lr_local: float = 1e-2
    lr_split: float = 1e-2
    optimizer: str = "sgd"           # sgd | adamw
    momentum: float = 0.9
    use_pruning: bool = True
    use_local_loss: bool = True      # False => the Fig-6 ablation arm
    return_client_trainable: bool = False
    # ^ also keep each client's post-round (tail, prompt) BEFORE FedAvg
    #   (`last_client_trainable`) — the fed engine stores these as
    #   personalized tails in the Population
    dp_clip: float = 0.0             # DP-SGD L2 clip on the client's round
    #   delta (0 disables the DP path entirely)
    dp_noise_multiplier: float = 0.0  # Gaussian noise as a multiple of the
    #   clip; > 0 activates the zCDP accountant
    dp_delta: float = 1e-5           # delta of the reported (eps, delta)


def make_optimizer(pcfg: ProtocolConfig, lr: float) -> Optimizer:
    if pcfg.optimizer == "adamw":
        return adamw(lr)
    return sgd(lr, momentum=pcfg.momentum)


def wire_seed(round_idx: int, client: int) -> int:
    """Seed of client `client`'s wire-noise generator in round
    `round_idx`."""
    return (WIRE_SEED * 1_000_003 + round_idx) * 1_000_003 + client


def _fma32(a, b, c) -> np.float32:
    """a * b + c in float32, rounded once (a fused multiply-add): exact
    rational arithmetic, then round-to-odd to float64, which rounds to
    float32 without a double-rounding error."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    x = float(exact)
    if Fraction(x) != exact and not np.float64(x).view(np.int64) & 1:
        x = float(np.nextafter(x, np.inf if exact > x else -np.inf))
    return np.float32(x)


def xla_sum(values, zero):
    """`values` summed as XLA's CPU reduction over their leading axis sums
    them, starting from `zero` (a float32 zero of their type: a numpy
    scalar or a tensor): in order up to 32 values; above, padded to n = 32
    * ceil(len / 32) with (n - len) // 2 zeros in front and the rest
    behind, each window of 32 summed in order and the window partials
    reduced the same way (its tree reduction)."""
    n = len(values)
    if n <= 32:
        acc = zero
        for v in values:
            acc = acc + v
        return acc
    m = 32 * -(-n // 32)
    lo = (m - n) // 2
    padded = [zero] * lo + list(values) + [zero] * (m - n - lo)
    return xla_sum([xla_sum(padded[i:i + 32], zero)
                    for i in range(0, m, 32)], zero)


def cohort_sum(per_client, scale) -> np.float32:
    """sum_k per_client[k] * scale[k] in float32 as the JAX round's jitted
    `(per_client * transmit).sum()` computes it on the CPU.

    Up to 32 clients XLA fuses the product into the sum: one fused
    multiply-add per client, in cohort order. Above 32 the optimized HLO
    (`--xla_dump_to`, `*.cpu_after_optimizations.txt`, of the round
    itself at K = 33) has a separate `multiply`, so each product is
    rounded to float32 on its own, then a `reduce-window` with
    `window={size=32 stride=32 pad=lo_hi}` (lo = (n - K) // 2 zeros in
    front, n = 32 * ceil(K / 32)) and a `reduce` of the window partials:
    `xla_sum`. In the round the per-client bytes are a constant
    broadcast and the multiply is a fusion of its own, as in a standalone
    jit of `(a * b).sum()`, so the standalone form holds there."""
    if len(per_client) <= 32:
        acc = np.float32(0.0)
        for a, b in zip(per_client, scale):
            acc = _fma32(a, b, acc)
        return acc
    return xla_sum([np.float32(np.float32(a) * np.float32(b))
                    for a, b in zip(per_client, scale)], np.float32(0.0))


def dp_seed(round_idx: int, client: int) -> int:
    """Seed of client `client`'s DP-noise generator in round `round_idx`."""
    return (DP_SEED * 1_000_003 + round_idx) * 1_000_003 + client


class SFPromptTrainer:
    supports_partial = True   # round() accepts a participation dict

    def __init__(self, model: SplitModel, pcfg: ProtocolConfig,
                 aggregator=None, *, mesh=None, fsdp: bool = False,
                 fsdp_threshold: int = 1 << 21, tracer=None, device="cuda"):
        if pcfg.dp_noise_multiplier > 0 and pcfg.dp_clip <= 0:
            raise ValueError(
                "dp_noise_multiplier > 0 needs dp_clip > 0: the Gaussian "
                "noise is calibrated to the clip (sensitivity)")
        if mesh is not None:
            model = model.on_mesh(mesh)
        self.mesh = mesh
        self.fsdp = fsdp
        self.fsdp_threshold = fsdp_threshold
        self._param_specs = None      # the specs `shard_params` cut by
        self.model = model
        self.pcfg = pcfg
        self.device = resolve_device(device)
        # flight recorder: the default NOOP records nothing. A tracer at
        # level "step" also records the `round.dispatch` event (as the JAX
        # round does) and one span per phase, closed after a device sync
        # so it covers the phase's device work
        self.tracer = tracer if tracer is not None else NOOP
        self.opt_local = make_optimizer(pcfg, pcfg.lr_local)
        self.opt_split = make_optimizer(pcfg, pcfg.lr_split)
        self.aggregator = aggregator or get_aggregator()
        # zCDP ledger across rounds — only a noised mechanism has a
        # finite epsilon to account for
        self.accountant = (
            PrivacyAccountant(noise_multiplier=pcfg.dp_noise_multiplier,
                              l2_clip=pcfg.dp_clip, delta=pcfg.dp_delta)
            if pcfg.dp_noise_multiplier > 0 else None)
        self.meter = TrafficMeter()   # measured bytes across rounds
        self.meter.attach_tracer(self.tracer)
        # per-client (tail, prompt) of the most recent round (K-stacked),
        # kept iff pcfg.return_client_trainable
        self.last_client_trainable = None
        # the last round's phase-1b EL2N scores (K, n_local) and the kept
        # sample indices (K, keep), in rank order
        self.last_scores = self.last_kept = None

    # ------------------------------------------------------------- state
    def init(self, generator: torch.Generator) -> Params:
        """Random params from `generator`; on a mesh every rank draws the
        whole tree from the same seed and keeps its shards."""
        params = self.model.init(generator, device=self.device)
        return {"params": self.shard_params(params), "round": 0}

    def shard_params(self, params: Params) -> Params:
        """Whole params -> this rank's: the frozen head and body cut to
        local shards by `params_pspecs` (leaves FSDP stores over 'data'
        become `parallel.DataSharded`), the tail and prompt whole. The
        specs are built over the whole tree, so the fallbacks reported
        (once, as `protocol.mesh`) are the JAX round's. Identity without a
        mesh."""
        if self.mesh is None:
            return params
        specs = params_pspecs(params, self.mesh, fsdp=self.fsdp,
                              fsdp_threshold=self.fsdp_threshold)
        report_fallbacks("protocol.mesh", self.tracer)
        self._param_specs = specs
        out = dict(params)
        for seg in ("head", "body"):
            out[seg] = tree_map(
                lambda x, spec: parallel.cut_leaf(x, spec, self.mesh),
                params[seg], specs[seg])
        return out

    def full_params(self, params: Params) -> Params:
        """The inverse of `shard_params`: every leaf gathered whole (a
        collective: every rank calls it). Identity without a mesh."""
        if self.mesh is None:
            return params
        mesh = self.mesh

        def whole(x, spec):
            if isinstance(x, parallel.DataSharded):
                x = x.gather(mesh)
            for d, e in enumerate(spec):
                if e == "model":
                    x = parallel.gather_axis(x.contiguous(), d, mesh,
                                             "model")
            return x

        out = dict(params)
        for seg in ("head", "body"):
            out[seg] = tree_map(whole, params[seg],
                                self._param_specs[seg])
        return out

    def phase2_keep(self, n_local: int) -> int:
        """Samples per client that train phase 2 — `n_local` shrunk by EL2N
        pruning when it is active."""
        if self.pcfg.use_pruning and self.model.split.prune_gamma > 0:
            return pruning.pruned_keep_count(
                n_local, self.model.split.prune_gamma, self.pcfg.batch_size)
        return n_local

    @contextmanager
    def _phase(self, name: str):
        with self.tracer.span(name, level=LEVEL_STEP) as sp:
            yield sp
            if self.tracer.level >= LEVEL_STEP and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _generator_noise(self, round_idx: int) -> WireNoise:
        """The default wire noise: each client's uniforms drawn in order
        from its own generator (forward, then backward, per crossing)."""
        gens = {}

        def noise(client, step, name, shape):
            if client not in gens:
                gens[client] = torch.Generator(device=self.device)
                gens[client].manual_seed(wire_seed(round_idx, client))
            g = gens[client]
            return (torch.rand(shape, generator=g, device=self.device),
                    torch.rand(shape, generator=g, device=self.device))
        return noise

    def _generator_dp_noise(self, round_idx: int) -> DPNoise:
        """The default DP noise: each client's unit normals drawn leaf by
        leaf, in `jax.tree` order, from its own generator."""
        gens = {}

        def noise(client, path, shape):
            if client not in gens:
                gens[client] = torch.Generator(device=self.device)
                gens[client].manual_seed(dp_seed(round_idx, client))
            return torch.randn(shape, generator=gens[client],
                               device=self.device)
        return noise

    # ------------------------------------------------------------- phase 2
    def _split_loss(self, frozen, trainable, batch, noise):
        """Phase-2 loss with the head->body and body->tail hops crossing the
        real wire: codec'd forward activations, codec'd backward gradients
        (the codec's autograd roundtrip), measured bytes in the aux.
        `noise(name, shape)` gives a stochastic codec's uniforms."""
        model = self.model
        ho = model.head_fwd(frozen["head"], trainable["prompt"], batch,
                            mode="train", differentiable=True)
        hb, bt = model.wire.head_body, model.wire.body_tail
        x = ho["smashed"]
        x_hb, b_hb = hb.transmit(x, train=True, noise=(
            noise(hb.name, tuple(x.shape)) if hb.codec.stochastic else None))
        bo = model.body_fwd(frozen["body"], x_hb, ho)
        x = bo["smashed"]
        x_bt, b_bt = bt.transmit(x, train=True, noise=(
            noise(bt.name, tuple(x.shape)) if bt.codec.stochastic else None))
        to = model.tail_fwd(trainable["tail"], x_bt, ho, batch)
        out = {"logits": to["logits"], "n_prefix": to.get("n_prefix", 0),
               "aux": ho["aux"] + bo["aux"] + to["aux"]}
        loss, _ = losses.task_loss(model.cfg, out, batch)
        return loss, {"wire": {hb.name: b_hb, bt.name: b_bt}}

    def _split_epochs(self, frozen, trainable, opt_state, data, noise,
                      client: int):
        """split_epochs passes over one client's pruned data. Returns
        (trainable, opt_state, mean loss, {boundary: f32 bytes})."""
        pcfg = self.pcfg
        bs = batches(data, pcfg.batch_size)
        wire = {b.name: np.float32(0.0) for b in self.model.wire.boundaries}
        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        step = 0
        for _ in range(pcfg.split_epochs):
            for batch in bs:
                loss, aux, grads = value_and_grad(
                    lambda tr, b, s=step: self._split_loss(
                        frozen, tr, b,
                        lambda name, shape: noise(client, s, name, shape)),
                    trainable, batch)
                updates, opt_state = self.opt_split.update(grads, opt_state,
                                                           trainable)
                trainable = apply_updates(trainable, updates)
                wire = {k: np.float32(wire[k] + aux["wire"][k]) for k in wire}
                acc = acc + loss
                step += 1
        return (trainable, opt_state, acc / (pcfg.split_epochs * len(bs)),
                wire)

    # ------------------------------------------------------------- round
    def _round(self, state: Params, client_data, participation, init_tails,
               wire_noise: Optional[WireNoise], dp_noise: Optional[DPNoise]):
        model, pcfg, dev = self.model, self.pcfg, self.device
        params = state["params"]
        client_data = tree_map(lambda x: torch.as_tensor(x, device=dev),
                               client_data)
        K, n_local = tree_leaves(client_data)[0].shape[:2]
        # this rank's block of the cohort (all K without a mesh)
        lo, hi = parallel.client_block(K, self.mesh)
        mine = range(lo, hi)
        data = [tree_map(lambda x: x[k], client_data) for k in range(K)]
        trainable = [{"tail": params["tail"], "prompt": params["prompt"]}
                     for _ in range(K)]
        if init_tails is not None:
            tails = tree_map(lambda x: torch.as_tensor(x, device=dev),
                             init_tails)
            for k in range(K):
                trainable[k]["tail"] = tree_map(lambda x: x[k], tails)
        head = params["head"]
        frozen = {"head": head, "body": params["body"]}
        metrics: Dict[str, Any] = {}
        local = [None] * K

        # ---- Phase 1a: local-loss self-update, client by client
        if pcfg.use_local_loss and pcfg.local_epochs > 0:
            with self._phase("phase1a"):
                for k in mine:
                    trainable[k], _, local[k] = local_epochs(
                        model, head, trainable[k], self.opt_local,
                        self.opt_local.init(trainable[k]), data[k],
                        batch_size=pcfg.batch_size,
                        n_epochs=pcfg.local_epochs)

        # ---- Phase 1b: EL2N scoring and pruning
        keep = self.phase2_keep(n_local)
        if pcfg.use_pruning and model.split.prune_gamma > 0:
            with self._phase("phase1b"):
                rows = [pruning.score_client_data(
                    model, head, trainable[k]["tail"], trainable[k]["prompt"],
                    data[k], batch_size=pcfg.batch_size) if k in mine
                    else None for k in range(K)]
                scores = parallel.assemble_clients(rows, self.mesh, dev)
                order = pruning.rank_descending(scores, dim=1)[:, :keep]
                self.last_scores, self.last_kept = scores, order
                pruned = [tree_map(lambda x: x[order[k]], data[k])
                          for k in range(K)]
                metrics["el2n_mean"] = scores.mean()
                metrics["kept_frac"] = keep / n_local
        else:
            pruned = data

        # ---- Phase 2: split training, client by client over the one
        # shared frozen {head, body}
        noise = wire_noise or self._generator_noise(int(state["round"]))
        split_loss, wire = [None] * K, [None] * K
        with self._phase("phase2"):
            for k in mine:
                trainable[k], _, split_loss[k], wire[k] = self._split_epochs(
                    frozen, trainable[k], self.opt_split.init(trainable[k]),
                    pruned[k], noise, k)

        # ---- DP-SGD on the client update: clip the round delta against
        # the broadcast globals, add calibrated Gaussian noise — BEFORE the
        # server (or the masked aggregator) ever sees the upload
        norms = [None] * K
        if pcfg.dp_clip > 0:
            reference = {"tail": params["tail"], "prompt": params["prompt"]}
            dp_noise = dp_noise or self._generator_dp_noise(
                int(state["round"]))
            for k in mine:
                trainable[k], norms[k] = dp_clip_and_noise(
                    trainable[k], reference,
                    lambda path, shape, k=k: dp_noise(k, path, shape),
                    l2_clip=pcfg.dp_clip,
                    noise_multiplier=pcfg.dp_noise_multiplier)
        if len(mine) < K:
            self._assemble(mine, trainable, local, split_loss, wire, norms)

        if local[0] is not None:
            # first, where the unsharded round puts it
            metrics = {"local_loss": torch.stack(local).mean(), **metrics}
        metrics["split_loss"] = torch.stack(split_loss).mean()
        transmit = np.asarray(participation["transmit"], np.float32)
        for b in model.wire.boundaries:
            # a straggler only sent a fraction of its phase-2 traffic
            per_client = np.array([w[b.name] for w in wire], np.float32)
            metrics[f"wire/{b.name}_bytes"] = cohort_sum(per_client,
                                                          transmit)

        if pcfg.dp_clip > 0:
            metrics["dp/delta_norm"] = torch.stack(norms).mean()

        # ---- Phase 3: participation-corrected weighted FedAvg of
        # (tail, prompt) through the pluggable aggregator
        with self._phase("phase3"):
            aggregate = np.asarray(participation["aggregate"], np.float32)
            weights = torch.from_numpy(np.float32(keep) * aggregate).to(dev)
            stacked = tree_map(lambda *xs: torch.stack(xs), *trainable)
            fallback = {"tail": params["tail"], "prompt": params["prompt"]}
            agg, agg_wire = self.aggregator.aggregate(
                stacked, weights, fallback, state["round"])
        self.last_client_trainable = (
            stacked if pcfg.return_client_trainable else None)
        new_params = dict(params, tail=agg["tail"], prompt=agg["prompt"])
        n_up = int((aggregate > 0).sum())
        param_bytes = np.float32(sum(x.numel() * x.element_size()
                                     for x in tree_leaves(fallback)))
        if agg_wire:
            # metered aggregator: fp32 broadcast down to all K; the uplink
            # is whatever the aggregator metered (masked ring uploads on
            # the secure path) or the clear survivors-only default; key
            # agreement / escrow reveals and the hierarchical edge->global
            # backhaul ride their own streams
            up = agg_wire.get("params_up", np.float32(n_up) * param_bytes)
            metrics["wire/params_bytes"] = np.float32(K) * param_bytes + up
            if SECURE in agg_wire:
                metrics[f"wire/{SECURE}_bytes"] = agg_wire[SECURE]
            if EDGE in agg_wire:
                metrics[f"wire/{EDGE}_bytes"] = agg_wire[EDGE]
        else:
            # clear path: (tail, prompt) travel server->client for all K
            # at round start and client->server only for the survivors
            metrics["wire/params_bytes"] = np.float32(K + n_up) * param_bytes
        metrics["cohort/active"] = n_up
        metrics["cohort/transmit_sum"] = cohort_sum(transmit,
                                                    np.ones_like(transmit))
        return ({"params": new_params, "round": int(state["round"]) + 1},
                metrics)

    def _assemble(self, mine, trainable, local, split_loss, wire, norms):
        """Fill the other ranks' clients into the per-client lists, in
        place: each client's trained (tail, prompt) and metrics packed into
        one float32 row, this rank's rows written into zeros, one
        all-reduce over 'data'."""
        k0 = mine[0]
        names = sorted(wire[k0])

        def values(k):
            return ([x for _, x in tree_flatten(trainable[k])]
                    + [v for v in (local[k], split_loss[k], norms[k])
                       if v is not None] + [wire[k][b] for b in names])

        _, layout = parallel.pack(values(k0), self.device)
        rows = [parallel.pack(values(k), self.device)[0] if k in mine
                else None for k in range(len(trainable))]
        full = parallel.assemble_clients(rows, self.mesh, self.device)
        paths = [p for p, _ in tree_flatten(trainable[k0])]
        for k in range(len(trainable)):
            if k in mine:
                continue
            vals = parallel.unpack(full[k], layout)
            leaves = dict(zip(paths, vals))
            trainable[k] = tree_map(lambda _: None, trainable[k0])
            for path, leaf in leaves.items():
                node = trainable[k]
                for key in path[:-1]:
                    node = node[key]
                node[path[-1]] = leaf
            rest = vals[len(paths):]
            for seq in (local, split_loss, norms):
                if seq[k0] is not None:
                    seq[k], rest = rest[0], rest[1:]
            wire[k] = {b: np.float32(v) for b, v in zip(names, rest)}

    def round(self, state: Params, client_data,
              participation: Optional[Dict[str, Any]] = None,
              init_tails=None, *,
              wire_noise: Optional[WireNoise] = None,
              dp_noise: Optional[DPNoise] = None
              ) -> Tuple[Params, Dict]:
        """Run one global round on a sampled cohort: `client_data` has
        leading (K, n_local, ...) axes (numpy arrays or tensors).
        `participation` = {"transmit": (K,), "aggregate": (K,)}; None means
        every client is on time. `init_tails` (K-stacked) starts each
        client from its own tail. `wire_noise(client, step, boundary,
        shape) -> (u_fwd, u_bwd)` replaces the default per-client
        generators' stochastic-rounding noise, and `dp_noise(client,
        leaf_path, shape) -> unit normals` the DP noise's."""
        K = tree_leaves(client_data)[0].shape[0]
        if participation is None:
            ones = np.ones((K,), np.float32)
            participation = {"transmit": ones, "aggregate": ones}
        tracer = self.tracer
        with tracer.span("round") as sp:
            if tracer.enabled:
                tracer.event("round.dispatch", level=LEVEL_STEP, cohort=K,
                             personalized_tails=init_tails is not None)
            with tracer.annotate("sfprompt.round"):
                state, metrics = self._round(
                    state, client_data, participation, init_tails,
                    wire_noise, dp_noise)
            metrics = {k: float(np.float32(v.item() if torch.is_tensor(v)
                                           else v))
                       for k, v in metrics.items()}
            if self.accountant is not None:
                # one Gaussian release of each sampled client's update per
                # round — the per-client (local-model) view
                self.accountant.spend()
                metrics["dp/epsilon"] = self.accountant.epsilon()
            wire = {k.removeprefix("wire/").removesuffix("_bytes"): v
                    for k, v in metrics.items() if k.startswith("wire/")}
            self.meter.absorb(wire, clients=metrics.get("cohort/active"))
            if tracer.enabled:
                sp.set(round=self.meter.rounds, cohort=K,
                       active=metrics.get("cohort/active"), **wire)
        return state, metrics

    def client_updates(self, state: Params, client_data, transmit=None,
                       **round_kw) -> Tuple[Any, Dict]:
        """Phases 1-2 (+ the per-client DP step) for a dispatched cohort
        WITHOUT phase-3 aggregation — the async runtime's dispatch
        primitive. Returns (K-stacked (tail, prompt) contributions,
        round metrics); the global params are untouched.

        It is the ordinary round with an all-zero `aggregate` vector:
        `fedavg_partial` then returns the pre-round globals exactly, so the
        same code path serves both the synchronous barrier and async
        dispatch (the bit identity the async tests pin depends on it). The
        metered `params` stream carries only the K-client downlink;
        uploads are billed when each delta reaches the server's buffer.
        `transmit` (K,) scales phase-2 wire bytes for clients that die
        mid-flight (fraction sent before death). `round_kw` (`wire_noise=`,
        `dp_noise=`) passes through to `round`. The contributions come back
        detached: nothing of the round's autograd survives in them.
        Requires ProtocolConfig(return_client_trainable=True)."""
        if not self.pcfg.return_client_trainable:
            raise ValueError(
                "client_updates needs ProtocolConfig("
                "return_client_trainable=True) — without it the jitted "
                "round aggregates and discards the per-client trees")
        K = tree_leaves(client_data)[0].shape[0]
        if transmit is None:
            transmit = np.ones((K,), np.float32)
        participation = {"transmit": np.asarray(transmit, np.float32),
                         "aggregate": np.zeros((K,), np.float32)}
        _, metrics = self.round(state, client_data, participation,
                                **round_kw)
        return (tree_map(lambda x: x.detach(), self.last_client_trainable),
                metrics)

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, params: Params, data, *, batch_size: int = 32) -> Dict:
        """Mean CE and accuracy over the full batches of `data`, through the
        split route (round-to-nearest wire)."""
        data = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                        data)
        ce, acc = [], []
        for batch in batches(data, batch_size):
            out = self.model.forward(params, batch, route="split",
                                     mode="train")
            _, m = losses.task_loss(self.model.cfg, out, batch)
            ce.append(m["ce"])
            acc.append(m["acc"])
        # the batch means' mean as the JAX round's jitted `.mean()` of its
        # scan outputs: summed in order, times the f32 reciprocal
        inv = float(np.float32(1.0 / len(ce)))
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return {"ce": float(xla_sum(ce, zero) * inv),
                "acc": float(xla_sum(acc, zero) * inv)}
