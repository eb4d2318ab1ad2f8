"""Layer library: attention (with DeepSeek's Multi-head Latent Attention,
Qwen2-VL's M-RoPE and Whisper's cross-attention), MLP, the token-choice
MoE, Mamba-2 and RWKV-6 blocks.

Functional style, as in `repro/models/layers.py`: each block kind has
``init_<kind>(generator, cfg, device) -> params`` and
``apply_<kind>(params, cfg, x, ctx, cache) -> (delta, cache)``. Params are
nested dicts of tensors keyed exactly as the JAX pytrees; dense weights are
(d_in, d_out).

Caches are updated IN PLACE: the decode ring write, the paged pool write,
the prefill ring fill and the chunked-prefill write assign into the cache
tensors they are given (views of the stacked per-layer cache or page pool)
and return the same dict; the recurrent blocks `copy_` their new conv,
SSM, token-shift and RWKV states into their cache views. The JAX package
returns fresh arrays instead; the values written are the same.

Attention and the two scans in a differentiated pass (`Ctx.differentiable`,
set by the training round's two losses) run their plain versions on every
device, so autograd flows through PyTorch ops: no kernel has a backward,
and the JAX round likewise runs every pass with `impl="ref"`. Forward-only
passes (EL2N scoring, evaluation, serving) keep the device dispatch and
launch the kernels on the card. On the `meta` device (the dry-run) the
scans take their loop-free chunked forms, and `Ctx.chunked` (JAX's
`impl="chunked"`) asks for them wherever a plain scan runs.

The MoE block runs its grouped expert products as plain `torch.matmul`s
over each expert's row range on every device (`jax.lax.ragged_dot` is an
XLA op, not a Pallas kernel), differentiated by autograd. Its group sizes
come to the host once a call (`moe_host_syncs` counts them).

Cross-attention (Whisper's decoder) attends the encoder's output with no
positions and no mask; it goes through the same dispatch as self-attention
(`_gqa_attend`), so a forward-only pass on the card launches the prefill
kernel non-causally, at Sq 1 in decode. The encoder's K and V are projected
again at every call, as the JAX block does: no cross-attention cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ref as attention_ref
from repro_torch.kernels.flash_attention.decode import (
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan
from repro_torch.kernels.mamba2_scan.ops import plain_scan as mamba2_plain
from repro_torch.kernels.rwkv6_scan.ops import plain_scan as rwkv6_plain
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.models.config import AttentionConfig, ModelConfig
from repro_torch.sharding import parallel

Params = Dict[str, Any]

# group-size reads from the device (one an `apply_moe` call)
moe_host_syncs = 0


# ---------------------------------------------------------------- helpers
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float = 0.02,
               device="cuda") -> Params:
    p = {"w": scale * torch.randn((d_in, d_out), generator=gen,
                                  device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(d: int, kind: str, device="cuda") -> Params:
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, rot_dim/2)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, D); cos/sin (B, S, D/2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_cos_sin(positions: torch.Tensor, sections: Tuple[int, int, int],
                  rot_dim: int, theta: float):
    """Qwen2-VL M-RoPE [arXiv:2409.12191]: positions (3, B, S) for
    (temporal, height, width); the frequency bands are split across the
    three position streams by `sections` (in half-dim units, sum =
    rot_dim/2). Returns cos/sin (B, S, rot_dim/2)."""
    if sum(sections) != rot_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"{rot_dim // 2}")
    cos3, sin3 = rope_cos_sin(positions, rot_dim, theta)  # (3, B, S, rot/2)

    def bands(t):   # band i from position stream i
        return torch.cat([c[i] for i, c in enumerate(
            t.split(list(sections), dim=-1))], dim=-1)
    return bands(cos3), bands(sin3)


def sinusoidal_embedding(positions: torch.Tensor, d: int):
    """Whisper's absolute positions: positions (...,) -> (..., d), sines of
    the first d/2 angles then their cosines, frequencies 10000^(-i/(d/2-1)).
    At 1500 frames an angle reaches 1499 rad, so one ulp of a frequency
    moves it by about 1e-4; the JAX package's own eager and jitted forms
    differ by that much there."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * i / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- context
@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""
    mode: str                                   # train | prefill | decode
    positions: torch.Tensor                     # RoPE positions: (B, S) or
    #                                             (3, B, S) for M-RoPE
    seq_pos: Optional[torch.Tensor] = None      # (B, S) sequence indices for
    #                                             masking & cache slots (only
    #                                             differs from positions for
    #                                             M-RoPE sequences)
    causal: bool = True                         # False: ViT / Whisper encoder
    encoder_out: Optional[torch.Tensor] = None  # (B, F, D) for cross-attn
    has_context: bool = False                   # prefill continuation (paged
    #                                             engine's chunked prefill)
    differentiable: bool = False                # a pass autograd goes through:
    #                                             attention runs plain
    mesh: Any = None                            # the DeviceMesh whose 'model'
    #                                             axis a block's local weight
    #                                             shards are cut over
    chunked: bool = False                       # the scans' plain versions
    #                                             take their chunked forms
    #                                             (JAX's impl="chunked")

    @property
    def decoding(self) -> bool:
        return self.mode == "decode"


def _pos2d(ctx: Ctx) -> torch.Tensor:
    return ctx.positions[0] if ctx.positions.dim() == 3 else ctx.positions


def _seq_pos(ctx: Ctx) -> torch.Tensor:
    return ctx.seq_pos if ctx.seq_pos is not None else _pos2d(ctx)


# ---------------------------------------------------------------- attention
def init_attention(gen, cfg: ModelConfig, *, cross: bool = False,
                   device="cuda") -> Params:
    """Self-attention params; `cross` adds the cross-attention half's norm
    `ln_cross` (its projections come from `init_cross_attention_extra`)."""
    att = cfg.attention
    D = cfg.d_model
    p: Params = {"ln": norm_init(D, cfg.norm, device)}
    if cross:
        p["ln_cross"] = norm_init(D, cfg.norm, device)
    if att.mla is not None:
        m = att.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        p["q_a"] = dense_init(gen, D, m.q_lora_rank, device=device)
        p["q_a_ln"] = norm_init(m.q_lora_rank, "rmsnorm", device)
        p["q_b"] = dense_init(gen, m.q_lora_rank, att.n_heads * qk,
                              device=device)
        p["kv_a"] = dense_init(gen, D, m.kv_lora_rank + m.qk_rope_head_dim,
                               device=device)
        p["kv_a_ln"] = norm_init(m.kv_lora_rank, "rmsnorm", device)
        p["kv_b"] = dense_init(
            gen, m.kv_lora_rank,
            att.n_heads * (m.qk_nope_head_dim + m.v_head_dim), device=device)
        p["o"] = dense_init(gen, att.n_heads * m.v_head_dim, D,
                            device=device)
        return p
    p["q"] = dense_init(gen, D, att.n_heads * att.head_dim,
                        bias=att.qkv_bias, device=device)
    p["k"] = dense_init(gen, D, att.n_kv_heads * att.head_dim,
                        bias=att.qkv_bias, device=device)
    p["v"] = dense_init(gen, D, att.n_kv_heads * att.head_dim,
                        bias=att.qkv_bias, device=device)
    p["o"] = dense_init(gen, att.n_heads * att.head_dim, D, device=device)
    return p


def init_attn_cache(cfg: ModelConfig, batch: int, window: int,
                    dtype=torch.float32, device="cuda") -> Params:
    """A ring of `window` positions a row; MLA keeps only the compressed
    latent `ckv` (B, W, kv_lora) and the shared rotary key `kr`
    (B, W, rope)."""
    att = cfg.attention
    positions = torch.full((batch, window), -1, dtype=torch.int32,
                           device=device)
    if att.mla is not None:
        m = att.mla
        return {
            "ckv": torch.zeros((batch, window, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, window, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
            "positions": positions,
        }
    shape = (batch, window, att.n_kv_heads, att.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "positions": positions,
    }


def _cache_write(cache: Params, names: Tuple[str, ...], values,
                 pos: torch.Tensor):
    """Ring-buffer write of one decode step at absolute position `pos` (B,),
    in place."""
    window = cache["positions"].shape[1]
    slot = (pos % window).long()                         # (B,)
    b_idx = torch.arange(pos.shape[0], device=pos.device)
    for name, val in zip(names, values):
        # val (B, 1, ...) -> write into slot per batch row
        cache[name][b_idx, slot] = val[:, 0].to(cache[name].dtype)
    cache["positions"][b_idx, slot] = pos.to(torch.int32)
    return cache


def _ring_fill(cache: Params, names: Tuple[str, ...], values,
               sp: torch.Tensor):
    """Prefill's cache write, in place: the last min(W, S) tokens of each
    row's `values` (B, S, ...) at slots pos % W (the ring layout), with
    their positions."""
    w = cache["positions"].shape[1]
    S = sp.shape[1]
    keep = min(w, S)
    tail_pos = sp[:, S - keep:]
    slot = (tail_pos % w).long()
    b_idx = torch.arange(sp.shape[0], device=sp.device)[:, None]
    for name, val in zip(names, values):
        cache[name][b_idx, slot] = val[:, S - keep:].to(cache[name].dtype)
    cache["positions"][b_idx, slot] = tail_pos.to(torch.int32)


def _paged_cache_write(cache: Params, names: Tuple[str, ...], values,
                       pos: torch.Tensor):
    """One decode token into a paged pool, in place: slot b's token at
    absolute position `pos[b]` lands at offset pos % page_size of physical
    page block_tables[b, pos // page_size]. Idle slots' tables point every
    block at the scratch page, so their (discarded) writes never touch a
    live page; duplicate scratch writes are fine because scratch is never
    read for a live slot."""
    bt = cache["block_tables"]                           # (S, n_blocks)
    page_len = cache["positions"].shape[1]
    pos = pos.long()
    b_idx = torch.arange(pos.shape[0], device=pos.device)
    page = bt[b_idx, pos // page_len].long()             # (B,)
    off = pos % page_len
    for name, val in zip(names, values):
        cache[name][page, off] = val[:, 0].to(cache[name].dtype)
    cache["positions"][page, off] = pos.to(torch.int32)
    return cache


def _gqa_attend(q, k, v, ctx: Ctx, att: AttentionConfig, *, window, softcap,
                kv_positions=None, q_offset=None, causal=True, scale=None):
    if ctx.differentiable:
        return attention_ref.attention(
            q, k, v, causal=causal, q_offset=q_offset,
            kv_positions=kv_positions, sliding_window=window,
            softcap=softcap, scale=scale)
    return flash_attention(
        q, k, v, causal=causal, q_offset=q_offset, kv_positions=kv_positions,
        sliding_window=window, softcap=softcap, scale=scale)


def _column(p: Params, h: torch.Tensor, full: int, mesh) -> torch.Tensor:
    """h @ w (+ b) for a column-parallel product whose whole output has
    `full` columns: with a shard of the columns, the bias (replicated by
    the rules) is cut to the same columns."""
    w = p["w"]
    y = h @ w.to(h.dtype)
    if "b" in p:
        b = p["b"]
        if w.shape[-1] < full and b.shape[-1] == full:
            b = parallel.model_slice(b, w.shape[-1], mesh)
        y = y + b.to(h.dtype)
    return y


def _row(p: Params, x: torch.Tensor, full: int, mesh) -> torch.Tensor:
    """x @ w (+ b) for a row-parallel product over `full` input rows: a
    shard of the rows gives a partial sum, summed over 'model' before the
    bias."""
    w = p["w"]
    y = x @ w.to(x.dtype)
    if w.shape[0] < full:
        y = parallel.reduce_from_model(y, mesh)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                    cache: Optional[Params], *, kind: str = "attn"):
    """Self-attention block half (pre-norm). Returns (residual_delta, cache).
    With M-RoPE sections and (3, B, S) positions the rotary angles come
    from `mrope_cos_sin`; otherwise from the first position stream.

    Tensor-parallel on local shards (`ctx.mesh`): q/k/v are column shards
    and o a row shard over 'model', so the head counts come from the local
    weights. Where the shards hold whole heads (a multiple of head_dim, q
    and kv split alike, so each rank's query heads find their GQA group's
    kv heads locally) the rank attends its own heads against a cache of
    its own kv heads. Where they do not — half a head a rank (2 heads on
    'model' 4, JAX's own test mesh) — q, k and v are gathered over 'model'
    and every rank attends all heads against a whole-head cache (the
    rules then replicate the cache's kv-heads dim), keeping its own
    columns for the row-parallel `o`. The partial sums of `o` are summed
    over 'model'."""
    att = cfg.attention
    B, S, D = x.shape
    h = apply_norm(p["ln"], x, cfg.norm)
    window = att.sliding_window if kind == "attn_local" else None
    if att.mla is not None:
        return _apply_mla(p, cfg, x, h, ctx, cache, window)
    sp = _seq_pos(ctx)
    dh, mesh = att.head_dim, ctx.mesh
    q_full, kv_full = att.n_heads * dh, att.n_kv_heads * dh
    qc, kc = p["q"]["w"].shape[-1], p["k"]["w"].shape[-1]
    tp = qc < q_full or kc < kv_full
    if tp:
        if not (qc < q_full and kc < kv_full):
            raise NotImplementedError(
                f"q sharded to {qc} of {q_full} columns but k to {kc} of "
                f"{kv_full}: one is replicated")
        h = parallel.copy_to_model(h, mesh)
    q = _column(p["q"], h, q_full, mesh)
    k = _column(p["k"], h, kv_full, mesh)
    v = _column(p["v"], h, kv_full, mesh)
    whole = qc % dh == 0 and kc % dh == 0
    if tp and not whole:
        q, k, v = (parallel.gather_model(t, mesh) for t in (q, k, v))
    Hq, Hkv = q.shape[-1] // dh, k.shape[-1] // dh
    q = q.reshape(B, S, Hq, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)

    if att.use_rope:
        if att.mrope_sections is not None and ctx.positions.dim() == 3:
            cos, sin = mrope_cos_sin(ctx.positions, att.mrope_sections,
                                     att.head_dim, att.rope_theta)
        else:
            cos, sin = rope_cos_sin(_pos2d(ctx), att.head_dim,
                                    att.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if ctx.mode == "decode" and "block_tables" in cache:
        # paged decode: write through the block table, then attend the
        # slot's pages (gathered on the CPU, read in place by the kernel)
        _paged_cache_write(cache, ("k", "v"), (k, v), sp[:, 0])
        out = paged_decode_attention(
            q, cache["k"], cache["v"], block_tables=cache["block_tables"],
            q_positions=sp[:, 0], kv_positions=cache["positions"],
            sliding_window=window, softcap=att.attn_logit_softcap)
    elif ctx.mode == "decode":
        # decode fast path: single-query cache-read kernel, never the
        # full flash machinery (see kernels/flash_attention/decode.py)
        _cache_write(cache, ("k", "v"), (k, v), sp[:, 0])
        out = decode_attention(
            q, cache["k"], cache["v"], q_positions=sp[:, 0],
            kv_positions=cache["positions"], sliding_window=window,
            softcap=att.attn_logit_softcap)
    elif ctx.has_context and cache is not None:
        # chunked-prefill continuation: land this chunk's K/V in the cache
        # first, then attend over everything cached so far (earlier chunks
        # + this one) with absolute query positions
        w = cache["positions"].shape[1]
        slot = (sp % w).long()
        b_idx = torch.arange(B, device=x.device)[:, None]
        cache["k"][b_idx, slot] = k.to(cache["k"].dtype)
        cache["v"][b_idx, slot] = v.to(cache["v"].dtype)
        cache["positions"][b_idx, slot] = sp.to(torch.int32)
        out = _gqa_attend(q, cache["k"], cache["v"], ctx, att,
                          window=window, softcap=att.attn_logit_softcap,
                          kv_positions=cache["positions"], q_offset=sp[:, 0])
    else:
        out = _gqa_attend(q, k, v, ctx, att, window=window,
                          softcap=att.attn_logit_softcap, causal=ctx.causal)
        if ctx.mode == "prefill" and cache is not None:
            _ring_fill(cache, ("k", "v"), (k, v), sp)

    out = out.reshape(B, S, Hq * dh)
    if tp and not whole:
        out = parallel.model_slice(out, qc, mesh)
    return _row(p["o"], out, q_full, mesh), cache


def _apply_mla(p: Params, cfg: ModelConfig, x, h, ctx: Ctx, cache, window):
    """DeepSeek-V3 Multi-head Latent Attention. The decode cache holds only
    the compressed latent (kv_lora + rope dims). Decode writes the step's
    latent into the ring, then decompresses the WHOLE window through
    `kv_b` every step (as the JAX block does) and attends with query and
    key dims nope + rope (192 at DeepSeek-V3's widths) and value dim v
    (128), every head its own kv head (G 1). Prefill is always causal. k
    is built by `torch.cat`, so the kernels read it with a unit last-axis
    stride.

    Tensor-parallel on local shards (`ctx.mesh`): the rules cut q_a, kv_a,
    q_b and kv_b by columns and o by rows over 'model'. The two
    down-projections' column shards cut through the latents, so their
    outputs are gathered over 'model' and every rank normalizes the whole
    latents, writes the same (replicated) latent cache and decompresses
    through its own columns of q_b and kv_b, which are its heads; o's
    partial sums are summed over 'model'. Where the shards of q_b or kv_b
    are not whole heads, their outputs are gathered too, every rank
    attends every head and keeps its own columns for o."""
    att = cfg.attention
    m = att.mla
    if cache is not None and "block_tables" in cache:
        raise NotImplementedError(
            "paged KV cache does not support MLA latent caches")
    B, S, D = x.shape
    H, nope, rope = att.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    sp, mesh = _seq_pos(ctx), ctx.mesh
    qk, kvw = nope + rope, nope + m.v_head_dim
    widths = {"q_a": m.q_lora_rank, "kv_a": m.kv_lora_rank + rope,
              "q_b": H * qk, "kv_b": H * kvw}
    tp = p["o"]["w"].shape[0] < H * m.v_head_dim
    if not tp and any(p[n]["w"].shape[-1] < w for n, w in widths.items()):
        raise NotImplementedError(
            "MLA with o replicated but a projection sharded over 'model'")
    if tp:
        h = parallel.copy_to_model(h, mesh)

    def down(name):
        # a down-projection's columns gathered whole over 'model'
        y = dense(p[name], h)
        return (parallel.gather_model(y, mesh) if y.shape[-1] < widths[name]
                else y)

    def up(name, z):
        # an up-projection: this rank's heads, or every head gathered where
        # the shard is not whole heads
        y = dense(p[name], z)
        if y.shape[-1] < widths[name] and y.shape[-1] % (widths[name] // H):
            y = parallel.gather_model(y, mesh)
        return y

    q_lat = apply_norm(p["q_a_ln"], down("q_a"), "rmsnorm")
    q = up("q_b", q_lat)
    Hq = q.shape[-1] // qk
    q = q.reshape(B, S, Hq, qk)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = down("kv_a")
    ckv = apply_norm(p["kv_a_ln"], kv_a[..., :m.kv_lora_rank], "rmsnorm")
    k_rope = kv_a[..., m.kv_lora_rank:]                     # (B, S, rope)

    cos, sin = rope_cos_sin(_pos2d(ctx), rope, att.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)    # (B, S, 1, rope)
    qfull = torch.cat([q_nope, q_rope], dim=-1)

    def decompress(ckv_seq):
        kv = up("kv_b", ckv_seq)
        kv = kv.reshape(*ckv_seq.shape[:-1], Hq, kvw)
        return kv[..., :nope], kv[..., nope:]

    scale = qk ** -0.5
    if ctx.mode == "decode":
        _cache_write(cache, ("ckv", "kr"), (ckv, k_rope[:, :, 0]), sp[:, 0])
        k_nope, v = decompress(cache["ckv"])                # (B, W, H, ·)
        kr = cache["kr"][:, :, None, :].to(k_nope.dtype)
        k = torch.cat([k_nope, kr.expand(-1, -1, Hq, -1)], dim=-1)
        out = decode_attention(
            qfull, k, v, q_positions=sp[:, 0],
            kv_positions=cache["positions"], sliding_window=window,
            softcap=att.attn_logit_softcap, scale=scale)
    else:
        k_nope, v = decompress(ckv)
        k = torch.cat([k_nope, k_rope.expand(-1, -1, Hq, -1)], dim=-1)
        out = _gqa_attend(qfull, k, v, ctx, att, window=window,
                          softcap=att.attn_logit_softcap, causal=True,
                          scale=scale)
        if ctx.mode == "prefill" and cache is not None:
            _ring_fill(cache, ("ckv", "kr"), (ckv, k_rope[:, :, 0]), sp)

    out = out.reshape(B, S, Hq * m.v_head_dim)
    rows = p["o"]["w"].shape[0]
    if out.shape[-1] > rows:
        out = parallel.model_slice(out, rows, mesh)
    return _row(p["o"], out, H * m.v_head_dim, mesh), cache


def init_cross_attention_extra(gen, cfg: ModelConfig, *,
                               device="cuda") -> Params:
    """Extra q/k/v/o for the cross-attention half of a decoder block."""
    att = cfg.attention
    D = cfg.d_model
    return {
        "cq": dense_init(gen, D, att.n_heads * att.head_dim, device=device),
        "ck": dense_init(gen, D, att.n_kv_heads * att.head_dim,
                         device=device),
        "cv": dense_init(gen, D, att.n_kv_heads * att.head_dim,
                         device=device),
        "co": dense_init(gen, att.n_heads * att.head_dim, D, device=device),
    }


def apply_cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          ctx: Ctx) -> torch.Tensor:
    """Cross-attention to ctx.encoder_out (Whisper's decoder): every query
    over every frame, no positions, no mask. Returns the residual delta.

    Tensor-parallel on local shards (`ctx.mesh`) as `apply_attention`:
    cq/ck/cv column shards (their inputs, the normed stream and the
    encoder output, through `copy_to_model`) and co a row shard summed
    over 'model'. Where the shards are not whole heads (whisper-base's 8
    heads on 'model' 16), q, k and v are gathered over 'model', every rank
    attends all heads and keeps its own columns for co, as
    `apply_attention` does."""
    att = cfg.attention
    B, S, D = x.shape
    h = apply_norm(p["ln_cross"], x, cfg.norm)
    enc, mesh, dh = ctx.encoder_out, ctx.mesh, att.head_dim
    F_ = enc.shape[1]
    q_full, kv_full = att.n_heads * dh, att.n_kv_heads * dh
    qc, kc = p["cq"]["w"].shape[-1], p["ck"]["w"].shape[-1]
    tp = qc < q_full
    if tp:
        h = parallel.copy_to_model(h, mesh)
        enc = parallel.copy_to_model(enc, mesh)
    q = _column(p["cq"], h, q_full, mesh)
    k = _column(p["ck"], enc, kv_full, mesh)
    v = _column(p["cv"], enc, kv_full, mesh)
    split = tp and (qc % dh or kc % dh)
    if split:
        q, k, v = (parallel.gather_model(t, mesh) for t in (q, k, v))
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, F_, -1, dh)
    v = v.reshape(B, F_, -1, dh)
    out = _gqa_attend(q, k, v, ctx, att, window=None, softcap=None,
                      causal=False).reshape(B, S, -1)
    if split:
        out = parallel.model_slice(out, qc, mesh)
    return _row(p["co"], out, q_full, mesh)


# ---------------------------------------------------------------- MLP
def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, *,
             device="cuda") -> Params:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    p = {"ln": norm_init(D, cfg.norm, device)}
    p["up"] = dense_init(gen, D, Fd, device=device)
    if cfg.mlp_activation.endswith("_glu"):
        p["gate"] = dense_init(gen, D, Fd, device=device)
    p["down"] = dense_init(gen, Fd, D, device=device)
    return p


def _act(x, kind: str):
    if kind.startswith("gelu"):
        return F.gelu(x, approximate="tanh")
    if kind.startswith("silu"):
        return F.silu(x)
    if kind == "relu2":  # nemotron-4 squared ReLU [arXiv:2402.16819]
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """Pre-norm MLP. On local shards (`mesh`): up/gate are column shards
    and down a row shard of d_ff over 'model', summed over 'model'."""
    h = apply_norm(p["ln"], x, cfg.norm)
    full = p["down"]["w"].shape[0]
    if p["up"]["w"].shape[-1] < cfg.d_ff and mesh is not None:
        full = cfg.d_ff
        h = parallel.copy_to_model(h, mesh)
    if cfg.mlp_activation.endswith("_glu"):
        h = _act(dense(p["gate"], h), cfg.mlp_activation) * dense(p["up"], h)
    else:
        h = _act(dense(p["up"], h), cfg.mlp_activation)
    return _row(p["down"], h, full, mesh)


# ---------------------------------------------------------------- MoE
def init_moe(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    e = cfg.moe
    D, Fe, E = cfg.d_model, e.d_ff_expert, e.n_experts

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device=device)

    p = {
        "ln": norm_init(D, cfg.norm, device),
        "router": dense_init(gen, D, E, device=device),
        "experts": {"up": normal(E, D, Fe), "gate": normal(E, D, Fe),
                    "down": normal(E, Fe, D)},
    }
    if e.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=Fe * e.n_shared_experts,
                               device=device)
        del p["shared"]["ln"]  # share the block norm
    return p


def _route(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """The block norm and the f32 router: (h, flat (N, D), probs (N, E),
    probs sorted descending (N, E), their expert ids). The sort is stable,
    so among equal probabilities the lower expert comes first, as
    `jax.lax.top_k` orders them."""
    h = apply_norm(p["ln"], x, cfg.norm)
    flat = h.reshape(-1, h.shape[-1])
    probs = torch.softmax(dense(p["router"], flat).float(), dim=-1)
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    return h, flat, probs, sorted_p, sorted_e


@torch.no_grad()
def router_margin(p: Params, cfg: ModelConfig, x: torch.Tensor) -> float:
    """The smallest gap between the k-th and the (k+1)-th router
    probability over the tokens of x: how far the block's expert choice is
    from a tie that rounding could flip (inf when every expert is
    chosen)."""
    k = cfg.moe.top_k
    sorted_p = _route(p, cfg, x)[3]
    if k >= sorted_p.shape[-1]:
        return math.inf
    return float((sorted_p[:, k - 1] - sorted_p[:, k]).min())


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh=None):
    """Token-choice top-k MoE with DROPLESS sort-based dispatch, the port of
    `repro/models/layers.py:469-527`. Returns (delta, aux), aux the
    Switch-style load-balance loss as a float32 scalar.

    The (token, choice) pairs are sorted by expert (a stable argsort, as
    `jnp.argsort` is), each expert's gate, up and down products run as
    one `torch.matmul` over its row range, and the outputs, weighted by
    the renormalized router probabilities, are scatter-added back to
    their tokens. No token is ever dropped, so a row's result does not
    depend on the other rows in the batch: the decode step may run a
    tenant's tail on its rows alone. The group sizes come to the host
    (one device sync a call, counted in `moe_host_syncs`); on the `meta`
    device, which holds no values, equal groups stand in, which gives the
    exact FLOP count of the unsharded expert products (they scale with the
    N*k rows, whatever their split among experts, as JAX's
    `_ragged_dot`).

    Expert-parallel on local shards (`mesh`): a rank holding E/T of the
    experts (the rules cut them over 'model') runs only their row ranges,
    at global expert offset rank * E/T, scatter-adds them into zeros and
    sums the partial outputs over 'model' (with the shared expert's
    row-parallel partials, in one all-reduce). The routing and the aux
    loss are computed replicated, from the replicated residual stream, so
    they are the same on every rank and their gradient counts once; the
    rows the local experts take and their weights pass through
    `copy_to_model`, whose backward sums the ranks' partial gradients.
    Where E does not divide 'model' the rules replicate the experts and
    every rank runs all of them, with nothing to sum."""
    e = cfg.moe
    B, S, D = x.shape
    N, k = B * S, e.top_k
    h, flat, probs, sorted_p, sorted_e = _route(p, cfg, x)
    top_p, top_e = sorted_p[:, :k], sorted_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch-style)
    flat_e = top_e.reshape(-1)                                 # (N*k,)
    if x.is_meta:
        # the dry-run: no values to count, so equal groups (N*k / E each,
        # the remainder to the lowest experts) stand in; the FLOPs of the
        # expert products and the bytes of their rows depend only on the
        # N*k rows in all, so the unsharded count is exact (an
        # expert-parallel rank's is its experts' share of even routing)
        density = probs.new_zeros((e.n_experts,)).scatter_add_(
            0, top_e[:, 0], probs.new_ones((N,))) / N
        q, rem = divmod(N * k, e.n_experts)
        sizes = [q + (i < rem) for i in range(e.n_experts)]
    else:
        density = torch.bincount(top_e[:, 0],
                                 minlength=e.n_experts).float() / N
        sizes = torch.bincount(flat_e, minlength=e.n_experts).tolist()
        global moe_host_syncs
        moe_host_syncs += 1
    aux = e.load_balance_coef * e.n_experts * (density * probs.mean(0)).sum()

    order = torch.argsort(flat_e, stable=True)
    tok = order // k                                           # token a row
    we = p["experts"]
    n_local = we["up"].shape[0]
    ep = n_local < e.n_experts
    first = parallel.axis_index(mesh, "model") * n_local if ep else 0
    lo = sum(sizes[:first])
    hi = lo + sum(sizes[first:first + n_local])
    if ep:
        flat = parallel.copy_to_model(flat, mesh)
        top_p = parallel.copy_to_model(top_p, mesh)
    mine = tok[lo:hi]
    xs = flat[mine]                                            # (rows, D)
    outs, start = [], 0
    for expert in range(n_local):
        n = sizes[first + expert]
        if n:
            rows = xs[start:start + n]
            gate = rows @ we["gate"][expert].to(h.dtype)
            up = rows @ we["up"][expert].to(h.dtype)
            outs.append((_act(gate, "silu_glu") * up)
                        @ we["down"][expert].to(h.dtype))
            start += n
    y = torch.zeros((N, D), dtype=h.dtype, device=x.device)
    if outs:
        gathered = torch.cat(outs) * top_p.reshape(-1)[order[lo:hi]][
            :, None].to(h.dtype)
        y = y.index_add(0, mine, gathered)
    y = y.reshape(B, S, D)

    partial, whole = ([y], []) if ep else ([], [y])
    if "shared" in p:
        # column-parallel gate/up and row-parallel down, as `apply_mlp`
        sh = p["shared"]
        sh_tp = sh["up"]["w"].shape[-1] < e.d_ff_expert * e.n_shared_experts
        hs = parallel.copy_to_model(h, mesh) if sh_tp else h
        hshared = _act(dense(sh["gate"], hs), "silu_glu") * dense(sh["up"],
                                                                  hs)
        (partial if sh_tp else whole).append(dense(sh["down"], hshared))
    out = None
    if partial:
        out = parallel.reduce_from_model(sum(partial[1:], partial[0]), mesh)
    for t in whole:
        out = t if out is None else out + t
    return out, aux


# ---------------------------------------------------------------- Mamba-2
def init_mamba2(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    m = cfg.mamba2
    D = cfg.d_model
    di = m.d_inner(D)
    H = m.n_heads(D)
    G = 1
    conv_dim = di + 2 * G * m.d_state
    return {
        "ln": norm_init(D, cfg.norm, device),
        "in_proj": dense_init(gen, D, 2 * di + 2 * G * m.d_state + H,
                              device=device),
        "conv_w": 0.02 * torch.randn((m.d_conv, conv_dim), generator=gen,
                                     device=device),
        "conv_b": torch.zeros((conv_dim,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), device=device),
        "dt_bias": torch.log(torch.expm1(0.01 * torch.ones((H,),
                                                           device=device))),
        "norm": norm_init(di, "rmsnorm", device),
        "out_proj": dense_init(gen, di, D, device=device),
    }


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device="cuda") -> Params:
    m = cfg.mamba2
    di = m.d_inner(cfg.d_model)
    H = m.n_heads(cfg.d_model)
    conv_dim = di + 2 * m.d_state
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, m.head_dim, m.d_state),
                           dtype=torch.float32, device=device),
    }


def _causal_conv1d(x, w, b, prev=None):
    """x (B, T, C); w (K, C) depthwise; prev (B, K-1, C) carried state.
    Returns (out, new_prev), new_prev a view of the padded input."""
    K = w.shape[0]
    B, T, C = x.shape
    if prev is None:
        prev = x.new_zeros((B, K - 1, C))
    xp = torch.cat([prev, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype), xp[:, T:]


def apply_mamba2(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                 cache: Optional[Params]):
    """Mamba-2 block (pre-norm): in_proj -> causal depthwise conv + SiLU ->
    SSD scan -> D skip, SiLU(z) gate, RMSNorm -> out_proj. Returns
    (residual_delta, cache). `F.softplus` returns x above 20 where
    `jax.nn.softplus` is logaddexp(x, 0); the two agree to f32 rounding
    there.

    Tensor-parallel on local shards (`ctx.mesh`): the rules cut in_proj's
    columns (the concatenation [z | x | B | C | dt], cut inside x) and
    out_proj's rows (d_inner) over 'model' and replicate the conv, A_log,
    D, dt_bias and the gated norm. The in_proj output is gathered over
    'model' and the conv runs on every channel, so the replicated conv
    cache is the same on every rank; a rank then scans the heads whose
    d_inner rows its out_proj holds (H/T of them, with its slice of the
    `ssm` cache), gathers the gated output for the norm over the whole
    d_inner and keeps its own columns for out_proj, whose partial sums
    are summed over 'model'. Shards that are not whole heads (H not
    divisible by 'model') are refused."""
    m = cfg.mamba2
    B, S, D = x.shape
    di = m.d_inner(D)
    H = m.n_heads(D)
    G, N = 1, m.d_state
    mesh = ctx.mesh
    h = apply_norm(p["ln"], x, cfg.norm)
    rows = p["out_proj"]["w"].shape[0]
    tp = rows < di
    if tp and H % (di // rows):
        raise NotImplementedError(
            f"Mamba-2 with {H} heads over a 'model' axis of {di // rows}: "
            f"the shards are not whole heads")
    if tp:
        h = parallel.copy_to_model(h, mesh)
    zxbcdt = dense(p["in_proj"], h)
    if zxbcdt.shape[-1] < 2 * di + 2 * G * N + H:
        zxbcdt = parallel.gather_model(zxbcdt, mesh)
    z, xin, BC, dt = torch.split(zxbcdt, [di, di, 2 * G * N, H], dim=-1)
    conv_in = torch.cat([xin, BC], dim=-1)
    prev = cache["conv"] if cache is not None else None
    conv_out, new_prev = _causal_conv1d(conv_in, p["conv_w"], p["conv_b"],
                                        prev)
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    A_log, Dskip, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    if tp:
        # this rank's heads: those of its out_proj rows
        hl = rows // m.head_dim
        i = parallel.axis_index(mesh, "model")
        heads = slice(i * hl, (i + 1) * hl)
        xin = parallel.model_slice(xin, rows, mesh)
        z = parallel.model_slice(z, rows, mesh)
        dt, A_log, Dskip, dt_bias = (t[..., heads] for t in
                                     (dt, A_log, Dskip, dt_bias))
    Hl = dt.shape[-1]
    dt = F.softplus(dt.float() + dt_bias)                       # (B, S, Hl)
    A = -torch.exp(A_log)

    xh = xin.reshape(B, S, Hl, m.head_dim)
    # the scan writes the final state into the cache in place (the
    # differentiated plain version returns it and the cache takes a copy)
    ssm = cache["ssm"] if cache is not None else None
    scan_in = (xh, dt, A, Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N),
               ssm)
    if ctx.differentiable:
        y, new_ssm = mamba2_plain(*scan_in, chunked=ctx.chunked)
        if ssm is not None:
            ssm.copy_(new_ssm)
    else:
        y, _ = mamba2_scan(*scan_in, state_out=ssm, chunked=ctx.chunked)
    y = y + Dskip.to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, Hl * m.head_dim) * F.silu(z)
    if tp:
        y = parallel.model_slice(apply_norm(
            p["norm"], parallel.gather_model(y, mesh), "rmsnorm"), rows, mesh)
    else:
        y = apply_norm(p["norm"], y, "rmsnorm")
    if cache is not None:
        cache["conv"].copy_(new_prev)
    return _row(p["out_proj"], y, di, mesh), cache


# ---------------------------------------------------------------- RWKV-6
def init_rwkv6(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    r6 = cfg.rwkv6
    D = cfg.d_model
    H = D // r6.head_size

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device=device)

    return {
        "ln_t": norm_init(D, "layernorm", device),
        "mu": normal(5, D),                      # r, k, v, w, g lerps
        "w_lora_a": normal(D, r6.decay_lora_rank),
        "w_lora_b": normal(r6.decay_lora_rank, D),
        "w0": torch.zeros((D,), device=device),
        "r": dense_init(gen, D, D, device=device),
        "k": dense_init(gen, D, D, device=device),
        "v": dense_init(gen, D, D, device=device),
        "g": dense_init(gen, D, D, device=device),
        "u": normal(H, r6.head_size),
        "gn": {"scale": torch.ones((D,), device=device),
               "bias": torch.zeros((D,), device=device)},
        "o": dense_init(gen, D, D, device=device),
        # channel mix
        "ln_c": norm_init(D, "layernorm", device),
        "mu_c": normal(2, D),
        "ck": dense_init(gen, D, cfg.d_ff, device=device),
        "cv": dense_init(gen, cfg.d_ff, D, device=device),
        "cr": dense_init(gen, D, D, device=device),
    }


def init_rwkv6_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> Params:
    r6 = cfg.rwkv6
    D = cfg.d_model
    H = D // r6.head_size
    return {
        "shift_t": torch.zeros((batch, D), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, D), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, r6.head_size, r6.head_size),
                             dtype=torch.float32, device=device),
    }


def _token_shift(x, prev):
    """xx_t = x_{t-1}; the first position takes the carried `prev` (B, D)
    or zeros."""
    if prev is None:
        prev = x.new_zeros((x.shape[0], x.shape[2]))
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def apply_rwkv6(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                cache: Optional[Params]):
    """RWKV-6 block = time-mix (data-dependent decay recurrence) +
    channel-mix, each with token-shift [arXiv:2404.05892]. Returns
    (tdelta + cdelta, cache): the caller adds it to the residual stream,
    and the channel mix reads x + tdelta. The per-head group norm takes eps
    1e-5, as the JAX block does (not `apply_norm`'s 1e-6).

    Tensor-parallel on local shards (`ctx.mesh`): the rules cut r, k, v, g
    by columns and o by rows (attention's rules), ck by columns over d_ff,
    and cv and cr — which the attention rule's names match — by columns
    over D; u, w0, the decay LoRA, the lerps and the group norm are
    replicated. The time mix scans this rank's heads (those of its r/k/v
    columns, with its slice of the `state` cache; the decay from the
    replicated LoRA and u, w0 and the group norm cut to the same heads)
    and sums o's partial outputs over 'model'. The channel mix gathers
    ck's output over 'model' before cv, and its D/T columns of the delta
    are gathered into the replicated residual stream by
    `gather_replicated`, whose backward keeps this rank's slice. The
    token-shift caches stay whole. Where the heads do not divide 'model',
    r, k, v and g are gathered and every rank scans every head, keeping
    its own columns for o. A channel mix with only one of ck and cv
    sharded is refused."""
    r6 = cfg.rwkv6
    B, S, D = x.shape
    H, K = D // r6.head_size, r6.head_size
    mesh = ctx.mesh

    # ---- time mix
    h = apply_norm(p["ln_t"], x, "layernorm")
    cols = p["r"]["w"].shape[-1]
    tp = cols < D
    ctp = p["cv"]["w"].shape[-1] < D
    if ctp != (p["ck"]["w"].shape[-1] < cfg.d_ff):
        raise NotImplementedError(
            "RWKV-6's channel mix with one of ck and cv sharded over "
            "'model' and the other whole")
    hm = parallel.copy_to_model(h, mesh) if tp else h
    xx = _token_shift(hm, cache["shift_t"] if cache is not None else None)
    mr, mk, mv, mw, mg = (hm + (xx - hm) * p["mu"][i].to(h.dtype)
                          for i in range(5))
    r, k, v, g = (dense(p[n], t) for n, t in
                  (("r", mr), ("k", mk), ("v", mv), ("g", mg)))
    # data-dependent decay (Finch): w = w0 + tanh(mw A) B, log-decay -exp(w)
    wdd = p["w0"] + torch.tanh(mw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    u, gn = p["u"], p["gn"]
    local = tp and H % (D // cols) == 0
    if local:
        # this rank's heads: those of its r/k/v/g columns and o rows
        i = parallel.axis_index(mesh, "model")
        wdd = parallel.model_slice(wdd, cols, mesh)
        u = u[i * (cols // K):(i + 1) * (cols // K)]
        gn = {n: parallel.model_slice(t, cols, mesh) for n, t in gn.items()}
    elif tp:
        r, k, v, g = (parallel.gather_model(t, mesh) for t in (r, k, v, g))
    Hl = r.shape[-1] // K
    r, k, v = (t.reshape(B, S, Hl, K) for t in (r, k, v))
    g = F.silu(g)
    w = -torch.exp(wdd).reshape(B, S, Hl, K)

    # the scan writes the final state into the cache in place (the
    # differentiated plain version returns it and the cache takes a copy)
    state = cache["state"] if cache is not None else None
    if ctx.differentiable:
        y, new_state = rwkv6_plain(r, k, v, w, u, state,
                                   chunked=ctx.chunked)
        if state is not None:
            state.copy_(new_state)
    else:
        y, _ = rwkv6_scan(r, k, v, w, u, state, state_out=state,
                          chunked=ctx.chunked)
    # per-head group norm
    yg = y.reshape(B, S, Hl, K).float()
    mu = yg.mean(-1, keepdim=True)
    var = ((yg - mu) ** 2).mean(-1, keepdim=True)
    yg = ((yg - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, Hl * K)
    y = (yg * gn["scale"] + gn["bias"]).to(x.dtype) * g
    if tp and not local:
        y = parallel.model_slice(y, p["o"]["w"].shape[0], mesh)
    tdelta = _row(p["o"], y, D, mesh)
    x = x + tdelta

    # ---- channel mix
    hc = apply_norm(p["ln_c"], x, "layernorm")
    hcm = parallel.copy_to_model(hc, mesh) if ctp else hc
    xxc = _token_shift(hcm, cache["shift_c"] if cache is not None else None)
    mkc = hcm + (xxc - hcm) * p["mu_c"][0].to(hc.dtype)
    mrc = hcm + (xxc - hcm) * p["mu_c"][1].to(hc.dtype)
    kk = F.relu(dense(p["ck"], mkc))
    if ctp:
        # cv's column shards leave kk's gradient partial a rank
        kk = parallel.gather_model(kk, mesh)
    cdelta = torch.sigmoid(dense(p["cr"], mrc)) * dense(p["cv"], kk * kk)
    if ctp:
        cdelta = parallel.gather_replicated(cdelta, mesh)

    if cache is not None:
        cache["shift_t"].copy_(h[:, -1])
        cache["shift_c"].copy_(hc[:, -1])
    return tdelta + cdelta, cache
