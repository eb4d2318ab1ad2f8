"""Analytical cost model — SFPrompt Table 1 (Sec. 3.5), the port of the
communication half of `repro/core/comm.py`.

Symbols (paper's):
  |W|   total parameters;  alpha = |W_h|/|W|;  tau = |W_b|/|W|
  |D|   local samples per client;  gamma_keep = kept fraction after pruning
  q     cut-layer size (floats per SAMPLE per direction)
  p     prompt parameters;  U local epochs;  K selected clients

Conventions, as in the JAX package:
  * FL transmits the model twice per round per client: 2|W|K.
  * SFL transmits smashed data + gradients for every sample of every local
    epoch (4q|D|U), plus the client submodel twice: 2(1-tau)|W|K.
  * SFPrompt transmits smashed traffic only for the pruned subset and only
    for the split_epochs (E) phase-2 passes — local-loss epochs are free —
    plus only (tail + prompt) twice: (4q*gamma_keep*|D|*E + 2((1-a-t)|W|+p))K.
  * 2 cut points exist (head->body and body->tail), hence 4q per sample
    per pass (2 activations forward + 2 gradients backward).

`measured_cost_inputs` binds the model to what an actual round of a
`SplitModel` runs (segment sizes from its init, the codec's real bytes per
float), so `sfprompt_comm_breakdown` is the exact counterpart of the
trainer's TrafficMeter. `serve_comm_breakdown` is the serving slice's,
`secure_agg_breakdown` the masked secure aggregation's. The client
compute and latency models of FL, SFL and SFPrompt and `summarize` (the
paper's Table-1 comparison) keep the JAX package's order of operations, so
their floats are equal bit for bit, as do the hierarchical (edge) breakdowns
and the async round-time twin `async_vs_sync_round_time`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.split import SplitConfig, SplitModel
from repro_torch.models.config import ModelConfig


@dataclass
class CostInputs:
    W: float                  # total params
    alpha: float              # head fraction
    tau: float                # body fraction
    q: float                  # cut width: floats per sample per direction
    D: int                    # local samples per client
    U: int = 10               # local epochs
    E: int = 1                # split-training passes (SFPrompt phase 2)
    K: int = 5                # clients per round
    p: float = 0.0            # prompt params
    gamma_keep: float = 1.0   # kept fraction after pruning
    R: float = 100e6          # link bytes/s
    P_C: float = 1e12         # client FLOP/s
    P_S: float = 100e12       # server FLOP/s
    beta: float = 1.0 / 3.0   # forward fraction of one training step
    bytes_smashed: float = 4  # bytes/float for cut-layer traffic (1 = int8)
    bytes_param: float = 4

    @property
    def Wc(self) -> float:     # client submodel (head + tail)
        return (1 - self.tau) * self.W

    @property
    def Wt(self) -> float:     # tail only
        return (1 - self.alpha - self.tau) * self.W


# --------------------------------------------------------- communication
def fl_comm(c: CostInputs) -> float:
    """Bytes per global round."""
    return 2 * c.W * c.K * c.bytes_param


def sfl_comm(c: CostInputs) -> float:
    smashed = 4 * c.q * c.D * c.U          # per client, all epochs interact
    return (smashed * c.bytes_smashed + 2 * c.Wc * c.bytes_param) * c.K


def sfprompt_comm(c: CostInputs) -> float:
    smashed = 4 * c.q * c.gamma_keep * c.D * c.E
    return (smashed * c.bytes_smashed
            + 2 * (c.Wt + c.p) * c.bytes_param) * c.K


def sfprompt_comm_breakdown(c: CostInputs) -> Dict[str, float]:
    """sfprompt_comm split by physical link, keyed like the TrafficMeter:
    each cut point carries q floats forward + q backward per sample per
    phase-2 pass; (tail + prompt) travel up + down once per round."""
    per_boundary = 2 * c.q * c.gamma_keep * c.D * c.E * c.bytes_smashed * c.K
    return {"head_body": per_boundary, "body_tail": per_boundary,
            "params": 2 * (c.Wt + c.p) * c.bytes_param * c.K}


def sfprompt_comm_breakdown_partial(c: CostInputs, *, transmit_sum: float,
                                    n_uploads: float,
                                    k_down: Optional[float] = None,
                                    ) -> Dict[str, float]:
    """`sfprompt_comm_breakdown` corrected for a partially-participating
    cohort: each boundary carries the per-client full traffic times the
    sum of transmit fractions; (tail + prompt) go DOWN to all `k_down`
    sampled clients but UP only from the `n_uploads` survivors. With
    transmit_sum = n_uploads = k_down = K this is the synchronous
    breakdown."""
    per_boundary_client = 2 * c.q * c.gamma_keep * c.D * c.E * c.bytes_smashed
    params_each = (c.Wt + c.p) * c.bytes_param
    k_down = c.K if k_down is None else k_down
    return {"head_body": per_boundary_client * transmit_sum,
            "body_tail": per_boundary_client * transmit_sum,
            "params": params_each * (k_down + n_uploads)}


def secure_agg_breakdown(*, n_trainable: int, param_nbytes: float, K: int,
                         n_uploads: float,
                         n_dropped: Optional[float] = None,
                         ) -> Dict[str, float]:
    """Analytical wire bytes of one masked-secure-aggregation round, keyed
    like the TrafficMeter — the exact counterpart of what
    `privacy.SecureAggregator` pushes through its runtime Boundaries.

      params: the fp32 (tail + prompt) broadcast DOWN to all K sampled
              clients, plus each SURVIVOR's uint32 ring upload — the
              flattened trainable count padded to the mask kernel's lane
              multiple (`ring_size`), 4 bytes per ring element.
      secure: simulated-DH key agreement (K^2 * PK_BYTES total) plus
              dropout recovery (each survivor reveals its escrowed pair
              seed with each dropped client: n_up * n_drop seeds).

    `n_trainable` is the UNPADDED flattened (tail + prompt) element count;
    `param_nbytes` the fp32 byte size of that tree (the downlink payload).
    """
    from repro_torch.kernels.secure_mask.ops import ring_size
    from repro_torch.privacy.fixed_point import RING_BYTES
    from repro_torch.privacy.masking import PK_BYTES, SEED_BYTES
    n_pad = ring_size(n_trainable)
    if n_dropped is None:
        n_dropped = K - n_uploads
    return {
        "params": K * param_nbytes + n_uploads * n_pad * RING_BYTES,
        "secure": (K * K * PK_BYTES
                   + n_uploads * n_dropped * SEED_BYTES),
    }


def hierarchical_edge_breakdown(*, param_nbytes: float, n_edges: int,
                                live_edges: float) -> Dict[str, float]:
    """Analytical backhaul bytes of one hierarchical round's tier 2, keyed
    like the TrafficMeter's `edge_global` stream: each LIVE edge (one with
    at least one surviving client) uploads its fp32 edge mean, and the new
    globals broadcast down to all `n_edges` edges."""
    return {"edge_global": (n_edges + live_edges) * param_nbytes}


def hierarchical_secure_agg_breakdown(*, n_trainable: int,
                                      param_nbytes: float,
                                      edge_sizes, edge_uploads,
                                      ) -> Dict[str, float]:
    """Analytical wire bytes of one hierarchical SECURE round — the
    per-edge sum of `secure_agg_breakdown` plus the tier-2 backhaul.

    edge_sizes: per-edge sub-cohort sizes k_e (sum = K); edge_uploads: how
    many of each edge's clients survived to upload. Key agreement costs
    sum(k_e^2) pubkeys — the hierarchical win over the flat K^2 — and
    escrow reveals pair each edge's survivors with ITS dropped clients
    only. `params` keeps the flat shape: the fp32 downlink reaches all K
    clients and every survivor uploads one padded ring tensor; `edge_global`
    follows `hierarchical_edge_breakdown` with an all-dropped edge not
    uploading its mean."""
    totals = {"params": 0.0, "secure": 0.0}
    live = 0.0
    for k_e, up_e in zip(edge_sizes, edge_uploads):
        part = secure_agg_breakdown(
            n_trainable=n_trainable, param_nbytes=param_nbytes, K=int(k_e),
            n_uploads=float(up_e))
        totals["params"] += part["params"]
        totals["secure"] += part["secure"]
        live += float(up_e > 0)
    totals.update(hierarchical_edge_breakdown(
        param_nbytes=param_nbytes, n_edges=len(list(edge_sizes)),
        live_edges=live))
    return totals


def serve_comm_breakdown(wire, *, d_model: int, soft_prompt_len: int,
                         requests) -> Dict[str, float]:
    """Analytical SERVING wire bytes per boundary for a request trace.

    `requests` is a sequence of (prompt_tokens, new_tokens) pairs. Each
    request crosses each boundary once at prefill with its full
    (prompt + soft prompt) smashed tensor, then once per additional decode
    step with a single token's activation — the first generated token
    comes out of the prefill itself, so a request generating m tokens pays
    m - 1 decode crossings. Byte sizes come from the boundary codec's
    `payload_nbytes` of the REAL payload shapes (per-row int8 scales
    included), making this the exact counterpart of the ServeEngine's
    TrafficMeter. Serving is forward-only: no gradient crossings.
    """
    out: Dict[str, float] = {}
    for b in wire.boundaries:
        total = 0.0
        for prompt_tokens, new_tokens in requests:
            total += b.codec.payload_nbytes(
                (1, prompt_tokens + soft_prompt_len, d_model))
            total += max(0, new_tokens - 1) * b.codec.payload_nbytes(
                (1, 1, d_model))
        out[b.name] = float(total)
    return out


def crosscheck(measured: Dict[str, float], c: CostInputs,
               analytical: Optional[Dict[str, float]] = None,
               ) -> Dict[str, Dict]:
    """Measured TrafficMeter bytes vs the analytical model, per link.
    Returns {link: {measured, analytical, err_pct}}. Pass `analytical`
    explicitly (e.g. `sfprompt_comm_breakdown_partial`) to check a
    partial-participation round; default is the synchronous breakdown."""
    if analytical is None:
        analytical = sfprompt_comm_breakdown(c)
    out = {}
    for name, ref in analytical.items():
        if name not in measured:
            continue
        got = measured[name]
        out[name] = {"measured": got, "analytical": ref,
                     "err_pct": 100.0 * (got - ref) / max(ref, 1e-12)}
    return out


# --------------------------------------------------------- client compute
def sfprompt_compute(c: CostInputs) -> float:
    """FLOPs per client per round: U local-loss epochs over (head + tail),
    E split passes over the pruned subset for the client share (head fwd +
    tail fwd/bwd)."""
    local = 6 * (1 - c.tau) * c.D * c.W * c.U
    split = 6 * (1 - c.tau) * c.gamma_keep * c.D * c.W * c.E
    return local + split


def fl_compute(c: CostInputs) -> float:
    """FLOPs per client per round (6 * params * tokens convention folded
    into |D||W| as in the paper: one epoch touches |D||W| work units)."""
    return 6 * c.D * c.W * c.U


def sfl_compute(c: CostInputs) -> float:
    return 6 * (1 - c.tau) * c.D * c.W * c.U


def sfprompt_compute_paper(c: CostInputs) -> float:
    """The paper's Table-1 entry (1-tau)*gamma*|D||W| — phase-2 only."""
    return 6 * (1 - c.tau) * c.gamma_keep * c.D * c.W * c.E


# --------------------------------------------------------- latency
def fl_latency(c: CostInputs) -> float:
    comm = fl_comm(c) / c.R
    comp = fl_compute(c) / c.P_C
    return comm + comp


def sfl_latency(c: CostInputs) -> float:
    comm = sfl_comm(c) / c.R
    client = 6 * (1 - c.tau) * c.D * c.W * c.U / c.P_C
    server = 6 * c.tau * c.D * c.W * c.U * c.K / c.P_S
    return comm + client + server


def sfprompt_latency(c: CostInputs) -> float:
    comm = sfprompt_comm(c) / c.R
    # phase 1 (client only, parallel across clients)
    phase1 = 6 * (1 - c.tau) * c.D * c.W * c.U / c.P_C
    # phase 2: client head fwd + tail, server body — pipelined; take max
    client2 = 6 * (1 - c.tau) * c.gamma_keep * c.D * c.W * c.E / c.P_C
    server2 = 6 * c.tau * c.gamma_keep * c.D * c.W * c.E * c.K / c.P_S
    return comm + phase1 + max(client2, server2)


# ------------------------------------------- async round-time twin
def _lognormal_moments(t_comm: float, t_comp: float, link_sigma: float,
                       speed_sigma: float, jitter_sigma: float):
    """Fenton-Wilkinson fit of one client's round latency to a single
    lognormal(mu, sigma). The simulated latency (fed/scheduler.py) is
    (t_comm * L + t_comp * C) * J with L, C, J independent lognormals of
    median 1 — moment-match the sum, then fold the jitter in exactly
    (products of lognormals add mus and sigma^2s)."""
    import math

    def mv(scale, s):
        mean = scale * math.exp(s * s / 2.0)
        var = scale * scale * (math.exp(s * s) - 1.0) * math.exp(s * s)
        return mean, var

    m_l, v_l = mv(t_comm, link_sigma)
    m_c, v_c = mv(t_comp, speed_sigma)
    mean, var = m_l + m_c, v_l + v_c
    sigma2 = math.log(1.0 + var / (mean * mean))
    mu = math.log(mean) - sigma2 / 2.0
    return mu, math.sqrt(sigma2 + jitter_sigma * jitter_sigma)


def _expected_max_lognormal(n: int, mu: float, sigma: float) -> float:
    """E[max of n iid lognormal(mu, sigma)] via the order-statistic
    quantile approximation exp(mu + sigma * Phi^-1(n/(n+1))) — stdlib
    only (statistics.NormalDist), no scipy."""
    import math
    from statistics import NormalDist

    if n <= 1:
        return math.exp(mu + sigma * sigma / 2.0)
    return math.exp(mu + sigma * NormalDist().inv_cdf(n / (n + 1.0)))


def async_vs_sync_round_time(*, t_comm: float, t_comp: float, K: int,
                             buffer_size: int, concurrency: int,
                             group_size: int = 0,
                             link_sigma: float = 0.8,
                             speed_sigma: float = 0.4,
                             jitter_sigma: float = 0.15,
                             ) -> Dict[str, float]:
    """Analytical twin of the async engine's simulated clock
    (`fed/async_engine.py`): contributions/s of the synchronous barrier vs
    the buffered-async runtime, from the same latency distribution the
    simulated engines draw from.

    Sync: every round waits for the slowest of its K sampled clients, so
    it lands K contributions per E[max_K T] seconds. Async: `concurrency`
    dispatch groups of `group_size` clients run independently; each group
    cycles in E[max_g T] (the engine refills a group when its last member
    lands), so arrivals stream at concurrency * g / E[max_g] per second —
    the straggler tail is paid per GROUP, not per cohort, and groups
    overlap. The ratio is the throughput speedup of async over sync (the
    JAX package's `benchmarks/async_rounds.py --check` holds its simulated
    clock against this)."""
    g = group_size or K
    mu, sigma = _lognormal_moments(t_comm, t_comp, link_sigma,
                                   speed_sigma, jitter_sigma)
    t_sync = _expected_max_lognormal(K, mu, sigma)
    t_group = _expected_max_lognormal(g, mu, sigma)
    sync_rate = K / t_sync
    async_rate = concurrency * g / t_group
    return {"sync_round_s": t_sync, "async_group_s": t_group,
            "sync_contrib_per_s": sync_rate,
            "async_contrib_per_s": async_rate,
            "async_flush_interval_s": buffer_size / async_rate,
            "throughput_speedup": async_rate / sync_rate}


def summarize(c: CostInputs) -> Dict[str, Dict[str, float]]:
    """The Table-1 comparison: per-round bytes, client FLOPs and latency of
    FL, SFL and SFPrompt."""
    return {
        "FL": {"comm_bytes": fl_comm(c), "client_flops": fl_compute(c),
               "latency_s": fl_latency(c)},
        "SFL": {"comm_bytes": sfl_comm(c), "client_flops": sfl_compute(c),
                "latency_s": sfl_latency(c)},
        "SFPrompt": {"comm_bytes": sfprompt_comm(c),
                     "client_flops": sfprompt_compute_paper(c),
                     "latency_s": sfprompt_latency(c)},
    }


# --------------------------------------------------------- model binding
def measured_cost_inputs(model: SplitModel, *, tokens_per_sample: int,
                         n_local: int, batch_size: int, K: int,
                         U: int = 1, E: int = 1) -> CostInputs:
    """CostInputs matched to what an ACTUAL round of `model` runs:
    segment sizes from the real init (counted on the `meta` device), the
    protocol's pruning `keep` with its batch-multiple rounding, and
    bytes_smashed from the wire codec's real payload."""
    from repro_torch.core.pruning import pruned_keep_count
    split, cfg = model.split, model.cfg
    keep = pruned_keep_count(n_local, split.prune_gamma, batch_size)
    h, b, t = (model._segment_params_count(s)
               for s in ("head", "body", "tail"))
    W = h + b + t
    ci = CostInputs(W=W, alpha=h / W, tau=b / W,
                    q=(tokens_per_sample + split.prompt_len) * cfg.d_model,
                    D=n_local, U=U, E=E, K=K,
                    p=split.prompt_len * cfg.d_model,
                    gamma_keep=keep / n_local)
    ci.bytes_smashed = model.wire.head_body.codec.bytes_per_float(
        (batch_size, tokens_per_sample + split.prompt_len, cfg.d_model))
    return ci


def cost_inputs_from(cfg: ModelConfig, split: SplitConfig, *,
                     tokens_per_sample: int, D: int, K: int = 5,
                     U: int = 10, E: int = 1,
                     model: Optional[SplitModel] = None,
                     **kw) -> CostInputs:
    """Derive (alpha, tau, q, p) from an actual split model instance."""
    model = model or SplitModel(cfg, split)
    alpha, tau = model.segment_fractions()
    q = cfg.d_model * (tokens_per_sample + split.prompt_len)
    return CostInputs(
        W=cfg.param_count(), alpha=alpha, tau=tau, q=q, D=D, K=K, U=U, E=E,
        p=split.prompt_len * cfg.d_model,
        gamma_keep=1.0 - split.prune_gamma, **kw)
