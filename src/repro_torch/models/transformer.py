"""Transformer stacks and the unsplit model: the self-attention kinds
(MLA included), Whisper's cross-attention decoder block, the MoE block,
Mamba-2 and RWKV-6.

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
DeepSeek's dense prefix layers and its multi-token-prediction logits,
Whisper's encoder (the batch's `frames` plus sinusoidal positions through
non-causal attention layers; its output kept in the cache at prefill and
read back at decode) and sinusoidal decoder positions, and Qwen2-VL's
patch prefix (`patch_embeds`) with its M-RoPE grid positions
(`mrope_positions`, stored client-axis-first as (B, 3, Np)).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.sharding import parallel
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_SELF_ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")


# ------------------------------------------------------------------ blocks
def init_block(gen, cfg: ModelConfig, kind: str, *, device="cuda") -> Params:
    if kind in _SELF_ATTN_KINDS:
        return {"attn": L.init_attention(gen, cfg, device=device),
                "mlp": L.init_mlp(gen, cfg, device=device)}
    if kind == "cross_attn":
        attn = L.init_attention(gen, cfg, cross=True, device=device)
        attn.update(L.init_cross_attention_extra(gen, cfg, device=device))
        return {"attn": attn, "mlp": L.init_mlp(gen, cfg, device=device)}
    if kind == "mamba2":
        return {"mamba": L.init_mamba2(gen, cfg, device=device)}
    if kind == "moe":
        return {"attn": L.init_attention(gen, cfg, device=device),
                "moe": L.init_moe(gen, cfg, device=device)}
    if kind == "rwkv6":
        return {"rwkv": L.init_rwkv6(gen, cfg, device=device)}
    raise ValueError(kind)


def apply_block(params: Params, cfg: ModelConfig, kind: str, x, ctx: L.Ctx,
                cache):
    """-> (x, new_cache, aux_loss): aux_loss the MoE block's float32
    load-balance loss, 0.0 for the other kinds. A `cross_attn` block runs
    causal self-attention, then cross-attention to ctx.encoder_out, then
    the MLP, each adding to the residual stream."""
    if kind in _SELF_ATTN_KINDS or kind in ("cross_attn", "moe"):
        delta, new_cache = L.apply_attention(params["attn"], cfg, x, ctx,
                                             cache, kind=kind)
        x = x + delta
        if kind == "cross_attn":
            x = x + L.apply_cross_attention(params["attn"], cfg, x, ctx)
        if kind == "moe":
            delta, aux = L.apply_moe(params["moe"], cfg, x, ctx.mesh)
            return x + delta, new_cache, aux
        x = x + L.apply_mlp(params["mlp"], cfg, x, ctx.mesh)
        return x, new_cache, 0.0
    if kind == "mamba2":
        delta, new_cache = L.apply_mamba2(params["mamba"], cfg, x, ctx, cache)
        return x + delta, new_cache, 0.0
    if kind == "rwkv6":
        delta, new_cache = L.apply_rwkv6(params["rwkv"], cfg, x, ctx, cache)
        return x + delta, new_cache, 0.0
    raise ValueError(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype=torch.float32, window=None, *, device="cuda"):
    """window: optional ring-buffer cap; local-attention layers additionally
    cap at their sliding window — their cache never needs to be larger.
    Recurrent kinds keep a fixed-size state whatever seq_len is."""
    if kind == "mamba2":
        return L.init_mamba2_cache(cfg, batch, dtype, device=device)
    if kind == "rwkv6":
        return L.init_rwkv6_cache(cfg, batch, dtype, device=device)
    if kind not in ATTN_KINDS + ("moe",):
        raise ValueError(kind)
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
    without MoE layers. A leaf that FSDP stores sharded over 'data'
    (`parallel.DataSharded`) is gathered one layer at a time, just before
    that layer runs."""
    aux = 0.0
    n = _n_layers(stacked)
    if shared is not None:
        shared = parallel.materialize(shared, ctx.mesh)
    for layer in range(n):
        for i, kind in enumerate(kinds):
            p = (shared if kind == "shared_attn"
                 else tree_map(lambda a: parallel.take_layer(a, layer,
                                                             ctx.mesh),
                               stacked[f"pos{i}"]))
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


def init_encoder(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    """Whisper's encoder: `encoder.n_layers` self-attention layers (run
    non-causally, no RoPE) and a final norm."""
    return {"cycle": {"pos0": init_stack(gen, cfg, "attn",
                                         cfg.encoder.n_layers,
                                         device=device)},
            "final_norm": L.norm_init(cfg.d_model, cfg.norm, device)}


def encoder_out(cfg: ModelConfig, enc_p: Params, batch, mode: str, cache,
                dtype, differentiable: bool = False,
                mesh=None) -> torch.Tensor:
    """Whisper's encoder output (B, F, D) for a call in `mode`: decode
    reads it from `cache["encoder_out"]`; the other modes run the batch's
    frames (B, F, D) plus sinusoidal positions through the encoder layers,
    non-causal, then the final norm, and a prefill writes the result into
    the cache. The modality frontend (mel + conv) is a stub: the batch
    brings the frame embeddings."""
    if mode == "decode":
        return cache["encoder_out"]
    frames = batch["frames"].to(dtype)
    B, F_, _ = frames.shape
    fpos = torch.arange(F_, dtype=torch.int32,
                        device=frames.device)[None].expand(B, F_)
    h = frames + L.sinusoidal_embedding(fpos, cfg.d_model).to(dtype)
    ectx = L.Ctx(mode="train", positions=fpos, seq_pos=fpos, causal=False,
                 differentiable=differentiable, mesh=mesh)
    h, _, _ = run_stack(cfg, enc_p["cycle"], ("attn",), h, ectx)
    out = L.apply_norm(parallel.materialize(enc_p["final_norm"], mesh), h,
                       cfg.norm)
    if cache is not None:
        cache["encoder_out"].copy_(out)
    return out


def embed(cfg: ModelConfig, emb: Params, batch, mode: str, prompt, dtype,
          chunk_start=None, mesh=None):
    """The embedding frontend's forward -> (x, positions, seq_pos,
    n_prefix), as the JAX package's `_embed`s.

    ViT: [CLS | soft prompt | patches] plus the first T position rows.
    Tokens: [soft prompt | patch_embeds (VLM) | tokens], the prompt left
    out in decode and continuations, n_prefix the prompt and patch rows;
    Whisper's tokens add sinusoidal positions of their own index (decode:
    `batch["pos"]`). seq_pos runs 0..T-1, is the decode step's
    `batch["pos"]`, or starts at `chunk_start` (B,) for a chunked-prefill
    continuation, which prepends no prompt (it went in with the first
    chunk). positions is seq_pos, except under M-RoPE: (3, B, T), the
    patches' grid positions (`mrope_positions`, (B, 3, Np)) offset by the
    prompt length and every other row's sequence index on all three
    streams (not Qwen2-VL's "largest grid position + 1"; the JAX package's
    layout).

    A token table cut into vocab rows over 'model' (`mesh`) is looked up
    vocab-parallel: each rank gathers the rows it holds, zeros elsewhere,
    and the rows are summed over 'model' (exact: one rank holds each)."""
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
        return x, pos, pos, 0
    toks = batch["tokens"]
    B, S = toks.shape
    # gather the rows, then cast them: the same values as casting the
    # whole table first, without a copy of the table at `dtype`
    table = emb["tok"]
    if table.shape[0] < cfg.vocab_size:
        lo = parallel.axis_index(mesh, "model") * table.shape[0]
        local = toks.long() - lo
        held = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
        x = parallel.reduce_sum(x * held[..., None].to(dtype), mesh, "model")
    else:
        x = table[toks.long()].to(dtype)
    n_prefix = 0
    if cfg.arch_type == "audio":
        # Whisper's decoder: absolute positions, no RoPE
        apos = (batch["pos"][:, None] if mode == "decode" else
                torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S))
        x = x + L.sinusoidal_embedding(apos, cfg.d_model).to(dtype)
    if cfg.arch_type == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(dtype)                 # (B, Np, D)
        x = torch.cat([pe, x], dim=1)
        n_prefix += pe.shape[1]
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
    base = base.to(torch.int32)
    att = cfg.attention
    if att is None or att.mrope_sections is None:
        return x, base, base, n_prefix
    b3 = base[None].expand((3,) + tuple(base.shape))
    if mode != "decode" and "mrope_positions" in batch:
        # stored client-axis-first as (B, 3, Np); the model wants (3, B, Np)
        grid = batch["mrope_positions"].transpose(0, 1).to(torch.int32)
        npz = grid.shape[-1]
        npr = n_prefix - npz
        pos = torch.cat([b3[:, :, :npr], grid + npr, b3[:, :, npr + npz:]],
                        dim=-1)
        return x, pos, base, n_prefix
    return x, b3, base, n_prefix


# ------------------------------------------------------------------ model
class Transformer:
    """The unsplit model, keyed as the JAX package's: `embed`,
    `dense_stack/pos0` (DeepSeek's dense prefix), `cycle/pos{i}`,
    `shared_attn` (zamba2), `final_norm`, `head` (absent when the
    embeddings are tied), `encoder/{cycle,final_norm}` (Whisper),
    `mtp/{proj,block,norm}` (DeepSeek)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---------------- init
    def init(self, generator: torch.Generator, *, device="cuda") -> Params:
        """Random params drawn from `generator` (which must live on
        `device`)."""
        from repro_torch.core.split import resolve_device
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
        if cfg.encoder is not None:
            params["encoder"] = init_encoder(g, cfg, device=device)
        if cfg.mtp:
            params["mtp"] = init_mtp(g, cfg, device=device)
        return params

    # ---------------- caches
    def init_cache(self, batch: int, seq_len: int, dtype=torch.float32,
                   window=None, *, device="cuda") -> Params:
        """Stacked per-layer caches; Whisper's also holds `encoder_out`
        (batch, n_frames, D), written at prefill and read at decode."""
        from repro_torch.core.split import resolve_device
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
        if cfg.encoder is not None:
            cache["encoder_out"] = torch.zeros(
                (batch, cfg.encoder.n_frames, cfg.d_model), dtype=dtype,
                device=device)
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
        cfg = self.cfg
        enc = (encoder_out(cfg, params["encoder"], batch, mode, cache, dtype,
                           differentiable)
               if cfg.encoder is not None else None)
        x, positions, seq_pos, n_prefix = embed(
            cfg, params["embed"], batch, mode, prompts, dtype)
        ctx = L.Ctx(mode=mode, positions=positions, seq_pos=seq_pos,
                    causal=cfg.arch_type != "vit", encoder_out=enc,
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
            mpos = positions[..., n_prefix:-1]
            mctx = L.Ctx(mode="train", positions=mpos,
                         seq_pos=seq_pos[:, n_prefix:-1],
                         differentiable=differentiable)
            hm, _, _ = apply_block(params["mtp"]["block"], cfg, "attn", hm,
                                   mctx, None)
            hm = L.apply_norm(params["mtp"]["norm"], hm, cfg.norm)
            out["mtp_logits"] = hm @ head_w.to(hm.dtype)
        if cache is not None:
            out["cache"] = cache
        return out
