"""Three-way model split W = [W_h | W_b | W_t] (SFPrompt Sec. 3.1).

The head (embedding frontend + the first layers) and the tail (last layers +
final norm + task head) live on the CLIENT; the body (everything between)
lives on the SERVER. Split points land on layer-pattern cycle boundaries.

The head->body and body->tail cut points are real wire boundaries: a
`runtime.boundary.WireSpec` (default raw fp32) owns a codec per link, and
`forward(route="split")` pushes every smashed activation through it,
reporting the measured bytes in `out["wire_bytes"]`.

This is the port of `repro/core/split.py` for token models with attention
layers: the serving path's subset (caches, slots, segments, forward).
Params and caches are nested dicts of tensors keyed as the JAX pytrees;
caches are written in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_block, init_stack, run_stack, \
    stack_cache
from repro_torch.runtime.boundary import WireSpec
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is
    none raises: nothing quietly runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


@dataclass(frozen=True)
class SplitConfig:
    head_cycles: int = 1          # cycles of the layer pattern in W_h
    tail_cycles: int = 1          # cycles in W_t
    prompt_len: int = 16          # p — soft prompt tokens (VPT-style)
    prune_gamma: float = 0.5      # fraction of local data PRUNED away
    local_epochs: int = 10        # U — phase-1 self-update epochs
    capacity_note: str = ""


class SplitModel:
    def __init__(self, cfg: ModelConfig, split: SplitConfig,
                 wire: Optional[WireSpec] = None):
        if split.head_cycles + split.tail_cycles >= cfg.n_cycles:
            raise ValueError(
                f"{cfg.name}: head({split.head_cycles}) + tail"
                f"({split.tail_cycles}) cycles must leave a non-empty body"
                f" out of {cfg.n_cycles}")
        self.cfg = cfg
        self.split = split
        self.wire = wire if wire is not None else WireSpec.make("fp32")
        self.body_cycles = cfg.n_cycles - split.head_cycles - split.tail_cycles
        cyc = len(cfg.layer_pattern)
        self.n_head_layers = cfg.n_dense_layers + split.head_cycles * cyc
        self.n_tail_layers = split.tail_cycles * cyc
        self.n_body_layers = self.body_cycles * cyc
        self._has_shared = "shared_attn" in cfg.layer_pattern

    def _check_ported(self):
        cfg = self.cfg
        if cfg.arch_type == "vit" or cfg.encoder is not None \
                or cfg.n_dense_layers or cfg.mtp:
            raise NotImplementedError(
                f"{cfg.name}: only token models without encoder, dense "
                f"prefix or MTP head are ported yet")

    # -------------------------------------------------------------- init
    def init(self, generator: torch.Generator, *, device="cuda") -> Params:
        """Random params drawn from `generator` (which must live on
        `device`), keyed as the JAX package's `SplitModel.init`."""
        self._check_ported()
        device = resolve_device(device)
        cfg, g = self.cfg, generator
        head: Params = {"embed": {"tok": 0.02 * torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=g, device=device)}}
        head["stack"] = self._init_cycles(g, self.split.head_cycles, device)
        body: Params = {"stack": self._init_cycles(g, self.body_cycles,
                                                   device)}
        tail: Params = {"stack": self._init_cycles(g, self.split.tail_cycles,
                                                   device)}
        tail["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, device)
        out_dim = cfg.num_classes or cfg.vocab_size
        tail["head"] = L.dense_init(g, cfg.d_model, out_dim, device=device)
        if self._has_shared:
            sh = init_block(g, cfg, "shared_attn", device=device)
            for seg in (head, body, tail):
                seg["shared_attn"] = tree_map(torch.clone, sh)
        prompt = 0.02 * torch.randn((self.split.prompt_len, cfg.d_model),
                                    generator=g, device=device)
        return {"head": head, "body": body, "tail": tail, "prompt": prompt}

    def _init_cycles(self, g, n_cycles: int, device) -> Params:
        out = {}
        for i, kind in enumerate(self.cfg.layer_pattern):
            if kind == "shared_attn":
                out[f"pos{i}"] = {"_": torch.zeros((n_cycles,),
                                                   device=device)}
            else:
                out[f"pos{i}"] = init_stack(g, self.cfg, kind, n_cycles,
                                            device=device)
        return out

    # -------------------------------------------------------------- caches
    def init_cache(self, batch: int, seq_len: int, dtype=torch.float32,
                   window=None, *, device="cuda") -> Params:
        self._check_ported()
        device = resolve_device(device)
        cfg = self.cfg

        def seg_cache(n_cycles):
            return {f"pos{i}": stack_cache(cfg, kind, n_cycles, batch,
                                           seq_len, dtype, window=window,
                                           device=device)
                    for i, kind in enumerate(cfg.layer_pattern)}

        return {
            "head": {"stack": seg_cache(self.split.head_cycles)},
            "body": {"stack": seg_cache(self.body_cycles)},
            "tail": {"stack": seg_cache(self.split.tail_cycles)},
        }

    # ------------------------------------------------- slotted allocation
    # A serving engine's shared KV cache is `init_cache(n_slots, ...)`:
    # every batch row is a SLOT that one in-flight request owns. Every cache
    # leaf carries the slot axis at 1, after the stacked-layer axis.

    def blank_slot_cache(self, seq_len: int, dtype=torch.float32,
                         window=None, *, device="cuda") -> Params:
        """A fresh batch=1 cache — the state of one unoccupied slot."""
        return self.init_cache(1, seq_len, dtype, window=window,
                               device=device)

    @staticmethod
    def cache_write_slot(shared: Params, single: Params, slot: int) -> Params:
        """Copy a batch=1 cache into slot `slot` of the shared n-slot cache,
        in place. Overwrites every leaf of that slot — positions included —
        so a newly allocated slot never sees a previous tenant's KV state."""
        tree_map(lambda s, one: s.select(1, slot).copy_(one.select(1, 0)),
                 shared, single)
        return shared

    @staticmethod
    def cache_read_slot(shared: Params, slot: int) -> Params:
        """A copy of slot `slot` of the shared cache as a batch=1 cache."""
        return tree_map(lambda s: s.narrow(1, slot, 1).clone(), shared)

    # -------------------------------------------------------------- embed
    def _embed(self, head_p, batch, mode, prompt, dtype):
        emb = head_p["embed"]
        toks = batch["tokens"]
        B, S = toks.shape
        x = emb["tok"].to(dtype)[toks.long()]
        n_prefix = 0
        if prompt is not None and mode != "decode":
            pr = prompt[None].expand((B,) + tuple(prompt.shape))
            x = torch.cat([pr.to(dtype), x], dim=1)
            n_prefix += prompt.shape[0]
        T = x.shape[1]
        if mode == "decode":
            base = batch["pos"][:, None]
        else:
            base = torch.arange(T, dtype=torch.int32,
                                device=x.device)[None].expand(B, T)
        base = base.to(torch.int32)
        return x, base, base, n_prefix

    # -------------------------------------------------------------- segments
    def _seg_fwd(self, seg_p, x, ctx, cache):
        caches = cache["stack"] if cache is not None else None
        x, aux, _ = run_stack(self.cfg, seg_p["stack"], self.cfg.layer_pattern,
                              x, ctx, caches, shared=seg_p.get("shared_attn"))
        return x, aux, cache

    def head_fwd(self, head_p, prompt, batch, *, mode="train", cache=None,
                 dtype=torch.float32) -> Dict[str, Any]:
        """Client-side: embed (+prompts) -> head layers. Output `smashed` is
        the cut-layer activation sent to the server."""
        x, positions, seq_pos, n_prefix = self._embed(
            head_p, batch, mode, prompt, dtype)
        ctx = L.Ctx(mode=mode, positions=positions, seq_pos=seq_pos,
                    causal=True)
        x, aux, new_cache = self._seg_fwd(head_p, x, ctx, cache)
        return {"smashed": x, "positions": positions, "seq_pos": seq_pos,
                "n_prefix": n_prefix, "aux": aux, "cache": new_cache,
                "mode": mode}

    def _ctx_from(self, head_out) -> L.Ctx:
        return L.Ctx(mode=head_out["mode"], positions=head_out["positions"],
                     seq_pos=head_out["seq_pos"], causal=True)

    def body_fwd(self, body_p, smashed, head_out, *, cache=None):
        """Server-side: frozen body over the smashed activations."""
        x, aux, new_cache = self._seg_fwd(body_p, smashed,
                                          self._ctx_from(head_out), cache)
        return {"smashed": x, "aux": aux, "cache": new_cache}

    def tail_fwd(self, tail_p, x, head_out, batch=None, *, cache=None,
                 last_only: bool = False):
        """Client-side: tail layers -> final norm -> task head.
        last_only=True computes logits for the final position only — the
        production prefill semantics."""
        cfg = self.cfg
        x, aux, new_cache = self._seg_fwd(tail_p, x, self._ctx_from(head_out),
                                          cache)
        hidden = L.apply_norm(tail_p["final_norm"], x, cfg.norm)
        out: Dict[str, Any] = {"aux": aux, "cache": new_cache,
                               "hidden": hidden}
        if last_only:
            hidden = hidden[:, -1:, :]
        logits = hidden @ tail_p["head"]["w"].to(hidden.dtype)
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        out["logits"] = logits
        out["n_prefix"] = head_out["n_prefix"]
        return out

    # -------------------------------------------------------------- routes
    def forward(self, params, batch, *, route="split", mode="train",
                cache=None, dtype=torch.float32, prompt=None, last_only=True,
                wire_generator: Optional[torch.Generator] = None):
        """route='split': head -> body -> tail, every smashed tensor
        crossing the head_body / body_tail wire boundaries through their
        codecs; out['wire_bytes'] holds the measured bytes per link.
        route='local': head -> tail directly (zero server communication).
        `wire_generator` draws stochastic-rounding noise (training); None
        rounds to nearest."""
        prompt = params["prompt"] if prompt is None else prompt
        hc = cache["head"] if cache is not None else None
        ho = self.head_fwd(params["head"], prompt, batch, mode=mode,
                           cache=hc, dtype=dtype)
        x, aux = ho["smashed"], ho["aux"]
        new_cache = {"head": ho["cache"]} if cache is not None else None
        wire_bytes = {}
        train = mode == "train"
        if route == "split":
            x, wire_bytes["head_body"] = self.wire.head_body.transmit(
                x, generator=wire_generator, train=train)
            bo = self.body_fwd(params["body"], x, ho,
                               cache=cache["body"] if cache else None)
            x = bo["smashed"]
            aux = aux + bo["aux"]
            if cache is not None:
                new_cache["body"] = bo["cache"]
            x, wire_bytes["body_tail"] = self.wire.body_tail.transmit(
                x, generator=wire_generator, train=train)
        to = self.tail_fwd(params["tail"], x, ho, batch,
                           cache=cache["tail"] if cache else None,
                           last_only=(mode == "prefill" and last_only))
        out = dict(to)
        out["aux"] = aux + to["aux"]
        out["wire_bytes"] = wire_bytes
        if cache is not None:
            new_cache["tail"] = to["cache"]
            out["cache"] = new_cache
        return out
