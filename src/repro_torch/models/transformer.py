"""Transformer stacks and the unsplit model: the self-attention kinds
(MLA included), the MoE block, Mamba-2 and RWKV-6.

The layer stack is grouped by the config's layer-pattern cycle. Each cycle
position holds its n layers' params STACKED on a leading layer axis, keyed
as the JAX pytree, and a Python loop over that axis takes the place of the
JAX package's `lax.scan` (`repro/models/transformer.py:101-126`). Decode
caches are stacked the same way; each layer sees views of its cache rows,
so in-place cache writes land in the stacked tensors. A `shared_attn`
position runs the segment's one shared block (zamba2) at every cycle, each
with its own cache site.

`Transformer` is the unsplit model (`repro/models/transformer.py:137-391`):
`init`, `init_cache` and `apply` in modes

  train   — full-sequence forward, no cache
  prefill — full-sequence forward, fills a (possibly ring-buffer) cache
  decode  — one token per call against the cache

with the ViT CLS head, tied embeddings, the final logit softcap,
DeepSeek's dense prefix layers and its multi-token-prediction logits.
Cross-attention, the encoder and audio are slice G item 5 of ROADMAP.md;
the VLM frontend and M-RoPE are item 6.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_SELF_ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")
# what later items of ROADMAP slice G bring
_LATER = {"cross_attn": "slice G item 5 (cross-attention and Whisper)",
          "audio": "slice G item 5 (cross-attention and Whisper)",
          "encoder": "slice G item 5 (cross-attention and Whisper)",
          "vlm": "slice G item 6 (M-RoPE and the VLM path)"}


def _unported(kind: str):
    if kind in _LATER:
        return NotImplementedError(f"block kind {kind!r} is not ported yet: "
                                   f"it comes with {_LATER[kind]}")
    return ValueError(kind)


def unported_reason(cfg: ModelConfig) -> Optional[str]:
    """None when the port runs `cfg`; otherwise the later item that brings
    what it lacks."""
    if cfg.arch_type in ("audio", "vlm"):
        return (f"arch_type {cfg.arch_type!r} comes with "
                f"{_LATER[cfg.arch_type]}")
    if cfg.encoder is not None:
        return f"the encoder comes with {_LATER['encoder']}"
    if "cross_attn" in cfg.layer_pattern:
        return f"cross-attention comes with {_LATER['cross_attn']}"
    return None


# ------------------------------------------------------------------ blocks
def init_block(gen, cfg: ModelConfig, kind: str, *, device="cuda") -> Params:
    if kind in _SELF_ATTN_KINDS:
        return {"attn": L.init_attention(gen, cfg, device=device),
                "mlp": L.init_mlp(gen, cfg, device=device)}
    if kind == "mamba2":
        return {"mamba": L.init_mamba2(gen, cfg, device=device)}
    if kind == "moe":
        return {"attn": L.init_attention(gen, cfg, device=device),
                "moe": L.init_moe(gen, cfg, device=device)}
    if kind == "rwkv6":
        return {"rwkv": L.init_rwkv6(gen, cfg, device=device)}
    raise _unported(kind)


def apply_block(params: Params, cfg: ModelConfig, kind: str, x, ctx: L.Ctx,
                cache):
    """-> (x, new_cache, aux_loss): aux_loss the MoE block's float32
    load-balance loss, 0.0 for the other kinds."""
    if kind in _SELF_ATTN_KINDS or kind == "moe":
        delta, new_cache = L.apply_attention(params["attn"], cfg, x, ctx,
                                             cache, kind=kind)
        x = x + delta
        if kind == "moe":
            delta, aux = L.apply_moe(params["moe"], cfg, x)
            return x + delta, new_cache, aux
        x = x + L.apply_mlp(params["mlp"], cfg, x)
        return x, new_cache, 0.0
    if kind == "mamba2":
        delta, new_cache = L.apply_mamba2(params["mamba"], cfg, x, ctx, cache)
        return x + delta, new_cache, 0.0
    if kind == "rwkv6":
        delta, new_cache = L.apply_rwkv6(params["rwkv"], cfg, x, ctx, cache)
        return x + delta, new_cache, 0.0
    raise _unported(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype=torch.float32, window=None, *, device="cuda"):
    """window: optional ring-buffer cap; local-attention layers additionally
    cap at their sliding window — their cache never needs to be larger.
    Recurrent kinds keep a fixed-size state whatever seq_len is."""
    if kind == "mamba2":
        return L.init_mamba2_cache(cfg, batch, dtype, device=device)
    if kind == "rwkv6":
        return L.init_rwkv6_cache(cfg, batch, dtype, device=device)
    if kind not in ATTN_KINDS + ("moe",) or kind == "cross_attn":
        raise _unported(kind)
    att = cfg.attention
    eff = seq_len if window is None else min(seq_len, window)
    if kind == "attn_local" and att.sliding_window:
        eff = min(eff, att.sliding_window)
    return L.init_attn_cache(cfg, batch, max(eff, 1), dtype, device=device)


# ---------------------------------------------------- reusable stack runner
def init_stack(gen, cfg: ModelConfig, kind: str, n: int, *,
               device="cuda") -> Params:
    """Stacked params for n layers of one kind (leading dim n)."""
    per = [init_block(gen, cfg, kind, device=device) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *per)


def _n_layers(stacked: Params) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def run_stack(cfg: ModelConfig, stacked: Params, kinds, x, ctx: L.Ctx,
              caches=None, shared: Optional[Params] = None):
    """Run a stacked layer group, layer by layer. `stacked` maps 'pos{i}' ->
    stacked params for cycle position i; `caches` mirrors that layout (or
    None) and is written in place. Returns (x, aux_loss, caches): the
    MoE layers' aux losses summed in layer order into a float32 scalar, as
    the JAX scan carries it; 0.0 (no tensor, no device work) for a stack
    without MoE layers."""
    aux = 0.0
    n = _n_layers(stacked)
    for layer in range(n):
        for i, kind in enumerate(kinds):
            p = (shared if kind == "shared_attn"
                 else tree_map(lambda a: a[layer], stacked[f"pos{i}"]))
            c = (tree_map(lambda a: a[layer], caches[f"pos{i}"])
                 if caches is not None else None)
            x, _, a = apply_block(p, cfg, kind, x, ctx, c)
            aux = aux + a
    return x, aux, caches


def stack_cache(cfg: ModelConfig, kind: str, n: int, batch: int,
                seq_len: int, dtype=torch.float32, window=None, *,
                device="cuda"):
    one = init_block_cache(cfg, kind, batch, seq_len, dtype, window=window,
                           device=device)
    return tree_map(lambda x: x[None].repeat((n,) + (1,) * x.dim()), one)


# ------------------------------------------------ embedding and MTP head
def init_embed(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    """The embedding frontend: a ViT's patch projection, CLS token and
    position rows, or a token table."""
    if cfg.arch_type == "vit":
        return {"patch": L.dense_init(gen, 16 * 16 * 3, cfg.d_model,
                                      device=device),
                "cls": 0.02 * torch.randn((1, cfg.d_model), generator=gen,
                                          device=device),
                "pos": 0.02 * torch.randn((cfg.max_seq_len, cfg.d_model),
                                          generator=gen, device=device)}
    return {"tok": 0.02 * torch.randn((cfg.vocab_size, cfg.d_model),
                                      generator=gen, device=device)}


def init_mtp(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    """DeepSeek-V3's multi-token-prediction head: a projection of
    (h_t, emb(tok_{t+1})), one attention block and a norm."""
    return {"proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                 device=device),
            "block": init_block(gen, cfg, "attn", device=device),
            "norm": L.norm_init(cfg.d_model, cfg.norm, device)}


def embed(cfg: ModelConfig, emb: Params, batch, mode: str, prompt, dtype,
          chunk_start=None):
    """The embedding frontend's forward -> (x, positions, n_prefix).

    ViT: [CLS | soft prompt | patches] plus the first T position rows.
    Tokens: the soft prompt (outside decode and continuations) prepended
    to the gathered rows, n_prefix its length; positions 0..T-1, the
    decode step's `batch["pos"]`, or from `chunk_start` (B,) for a
    chunked-prefill continuation, which prepends no prompt (it went in
    with the first chunk)."""
    if cfg.arch_type == "vit":
        patches = batch["patches"]
        B = patches.shape[0]
        x = L.dense(emb["patch"], patches.to(dtype))
        cls = emb["cls"][None].expand(B, 1, cfg.d_model)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
        if prompt is not None:
            pr = prompt[None].expand((B,) + tuple(prompt.shape))
            x = torch.cat([x[:, :1], pr.to(x.dtype), x[:, 1:]], dim=1)
        x = x + emb["pos"][: x.shape[1]].to(x.dtype)
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None].expand(B, x.shape[1])
        return x, pos, 0
    toks = batch["tokens"]
    B = toks.shape[0]
    # gather the rows, then cast them: the same values as casting the
    # whole table first, without a copy of the table at `dtype`
    x = emb["tok"][toks.long()].to(dtype)
    n_prefix = 0
    if prompt is not None and mode != "decode" and chunk_start is None:
        pr = prompt[None].expand((B,) + tuple(prompt.shape))
        x = torch.cat([pr.to(dtype), x], dim=1)
        n_prefix += prompt.shape[0]
    T = x.shape[1]
    if mode == "decode":
        base = batch["pos"][:, None]
    elif chunk_start is not None:
        base = chunk_start[:, None] + torch.arange(
            T, dtype=torch.int32, device=x.device)[None]
    else:
        base = torch.arange(T, dtype=torch.int32,
                            device=x.device)[None].expand(B, T)
    return x, base.to(torch.int32), n_prefix


# ------------------------------------------------------------------ model
class Transformer:
    """The unsplit model, keyed as the JAX package's: `embed`,
    `dense_stack/pos0` (DeepSeek's dense prefix), `cycle/pos{i}`,
    `shared_attn` (zamba2), `final_norm`, `head` (absent when the
    embeddings are tied), `mtp/{proj,block,norm}` (DeepSeek)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _check_ported(self):
        reason = unported_reason(self.cfg)
        if reason is not None:
            raise NotImplementedError(f"{self.cfg.name}: {reason}")

    # ---------------- init
    def init(self, generator: torch.Generator, *, device="cuda") -> Params:
        """Random params drawn from `generator` (which must live on
        `device`)."""
        from repro_torch.core.split import resolve_device
        self._check_ported()
        device = resolve_device(device)
        cfg, g = self.cfg, generator
        params: Params = {"embed": init_embed(g, cfg, device=device)}
        if cfg.n_dense_layers:
            params["dense_stack"] = {"pos0": init_stack(
                g, cfg, "attn", cfg.n_dense_layers, device=device)}
        params["cycle"] = {
            f"pos{i}": init_stack(g, cfg, kind, cfg.n_cycles, device=device)
            for i, kind in enumerate(cfg.layer_pattern)
            if kind != "shared_attn"}   # shared weights: one block below
        if "shared_attn" in cfg.layer_pattern:
            params["shared_attn"] = init_block(g, cfg, "shared_attn",
                                               device=device)
        params["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, device)
        if not cfg.tie_embeddings or cfg.num_classes:
            params["head"] = L.dense_init(
                g, cfg.d_model, cfg.num_classes or cfg.vocab_size,
                device=device)
        if cfg.mtp:
            params["mtp"] = init_mtp(g, cfg, device=device)
        return params

    # ---------------- caches
    def init_cache(self, batch: int, seq_len: int, dtype=torch.float32,
                   window=None, *, device="cuda") -> Params:
        from repro_torch.core.split import resolve_device
        self._check_ported()
        device = resolve_device(device)
        cfg = self.cfg

        def stack(kind, n):
            return stack_cache(cfg, kind, n, batch, seq_len, dtype,
                               window=window, device=device)

        cache: Params = {"cycle": {f"pos{i}": stack(kind, cfg.n_cycles)
                                   for i, kind in
                                   enumerate(cfg.layer_pattern)}}
        if cfg.n_dense_layers:
            cache["dense_stack"] = {"pos0": stack("attn",
                                                  cfg.n_dense_layers)}
        return cache

    # ---------------- public apply
    def apply(self, params: Params, batch: Dict[str, torch.Tensor], *,
              mode: str = "train", cache: Optional[Params] = None,
              prompts: Optional[torch.Tensor] = None, dtype=torch.float32,
              differentiable: bool = False) -> Dict[str, Any]:
        """The forward in `mode`; `cache` (from `init_cache`) is written in
        place and returned as out["cache"]. Returns logits, hidden,
        aux_loss (the MoE layers' float32 sum; 0.0 without MoE layers) and,
        for token models, n_prefix; in train mode DeepSeek's mtp_logits
        too (token t + 2 from position t). `differentiable` marks a pass
        autograd goes through: attention and the scans run their plain
        versions on every device."""
        self._check_ported()
        cfg = self.cfg
        x, positions, n_prefix = embed(cfg, params["embed"], batch, mode,
                                       prompts, dtype)
        ctx = L.Ctx(mode=mode, positions=positions, seq_pos=positions,
                    causal=cfg.arch_type != "vit",
                    differentiable=differentiable)
        aux = 0.0
        if cfg.n_dense_layers:
            x, a, _ = run_stack(cfg, params["dense_stack"], ("attn",), x, ctx,
                                cache["dense_stack"] if cache else None)
            aux = aux + a
        stacked = dict(params["cycle"])
        for i, kind in enumerate(cfg.layer_pattern):
            if kind == "shared_attn":
                # the stack runner counts layers on a placeholder here; the
                # shared block's weights come from `shared`
                stacked[f"pos{i}"] = {"_": torch.empty((cfg.n_cycles,),
                                                       device="meta")}
        x, a, _ = run_stack(cfg, stacked, cfg.layer_pattern, x, ctx,
                            cache["cycle"] if cache else None,
                            shared=params.get("shared_attn"))
        aux = aux + a
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        out: Dict[str, Any] = {"hidden": x, "aux_loss": aux}
        if cfg.arch_type == "vit":
            out["logits"] = L.dense(params["head"], x[:, 0])   # cls token
            return out
        out["n_prefix"] = n_prefix
        head_w = (params["head"]["w"] if "head" in params
                  else params["embed"]["tok"].T)
        logits = x @ head_w.to(x.dtype)
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        out["logits"] = logits
        if cfg.mtp and mode == "train":
            # DeepSeek-V3 MTP: predict token t+2 from (h_t, emb(tok_{t+1}))
            toks = batch["tokens"]
            emb_next = params["embed"]["tok"][toks[:, 1:].long()].to(x.dtype)
            h_txt = x[:, n_prefix:, :]
            hm = L.dense(params["mtp"]["proj"],
                         torch.cat([h_txt[:, :-1], emb_next], dim=-1))
            mpos = positions[:, n_prefix:-1]
            mctx = L.Ctx(mode="train", positions=mpos, seq_pos=mpos,
                         differentiable=differentiable)
            hm, _, _ = apply_block(params["mtp"]["block"], cfg, "attn", hm,
                                   mctx, None)
            hm = L.apply_norm(params["mtp"]["norm"], hm, cfg.norm)
            out["mtp_logits"] = hm @ head_w.to(hm.dtype)
        if cache is not None:
            out["cache"] = cache
        return out
