"""Layer library, the subset the dense serving path runs.

Functional style, as in `repro/models/layers.py`: each block kind has
``init_<kind>(generator, cfg, device) -> params`` and
``apply_<kind>(params, cfg, x, ctx, cache) -> (delta, cache)``. Params are
nested dicts of tensors keyed exactly as the JAX pytrees; dense weights are
(d_in, d_out).

Caches are updated IN PLACE: the decode ring write and the prefill ring
fill assign into the cache tensors they are given (views of the stacked
per-layer cache) and return the same dict. The JAX package returns fresh
arrays instead; the values written are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.decode import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import AttentionConfig, ModelConfig

Params = Dict[str, Any]


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


# ---------------------------------------------------------------- context
@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""
    mode: str                                   # train | prefill | decode
    positions: torch.Tensor                     # RoPE positions (B, S)
    seq_pos: Optional[torch.Tensor] = None      # (B, S) sequence indices for
    #                                             masking & cache slots
    causal: bool = True
    has_context: bool = False                   # prefill continuation (paged
    #                                             engine's chunked prefill)

    @property
    def decoding(self) -> bool:
        return self.mode == "decode"


def _seq_pos(ctx: Ctx) -> torch.Tensor:
    return ctx.seq_pos if ctx.seq_pos is not None else ctx.positions


# ---------------------------------------------------------------- attention
def init_attention(gen, cfg: ModelConfig, *, device="cuda") -> Params:
    att = cfg.attention
    if att.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    D = cfg.d_model
    return {
        "ln": norm_init(D, cfg.norm, device),
        "q": dense_init(gen, D, att.n_heads * att.head_dim,
                        bias=att.qkv_bias, device=device),
        "k": dense_init(gen, D, att.n_kv_heads * att.head_dim,
                        bias=att.qkv_bias, device=device),
        "v": dense_init(gen, D, att.n_kv_heads * att.head_dim,
                        bias=att.qkv_bias, device=device),
        "o": dense_init(gen, att.n_heads * att.head_dim, D, device=device),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, window: int,
                    dtype=torch.float32, device="cuda") -> Params:
    att = cfg.attention
    if att.mla is not None:
        raise NotImplementedError("MLA latent caches are not ported yet")
    shape = (batch, window, att.n_kv_heads, att.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "positions": torch.full((batch, window), -1, dtype=torch.int32,
                                device=device),
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


def _gqa_attend(q, k, v, ctx: Ctx, att: AttentionConfig, *, window, softcap,
                kv_positions=None, q_offset=None, causal=True, scale=None):
    return flash_attention(
        q, k, v, causal=causal, q_offset=q_offset, kv_positions=kv_positions,
        sliding_window=window, softcap=softcap, scale=scale)


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                    cache: Optional[Params], *, kind: str = "attn"):
    """Self-attention block half (pre-norm). Returns (residual_delta, cache)."""
    att = cfg.attention
    if att.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    if att.mrope_sections is not None and ctx.positions.dim() == 3:
        raise NotImplementedError("M-RoPE is not ported yet")
    if cache is not None and "block_tables" in cache:
        raise NotImplementedError(
            "paged KV caches are the paged engine's; ported with that slice")
    if ctx.has_context:
        raise NotImplementedError(
            "chunked-prefill continuation is the paged engine's; ported "
            "with that slice")
    B, S, D = x.shape
    h = apply_norm(p["ln"], x, cfg.norm)
    window = att.sliding_window if kind == "attn_local" else None
    sp = _seq_pos(ctx)

    q = dense(p["q"], h).reshape(B, S, att.n_heads, att.head_dim)
    k = dense(p["k"], h).reshape(B, S, att.n_kv_heads, att.head_dim)
    v = dense(p["v"], h).reshape(B, S, att.n_kv_heads, att.head_dim)

    if att.use_rope:
        cos, sin = rope_cos_sin(ctx.positions, att.head_dim, att.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if ctx.mode == "decode":
        # decode fast path: single-query cache-read kernel, never the
        # full flash machinery (see kernels/flash_attention/decode.py)
        _cache_write(cache, ("k", "v"), (k, v), sp[:, 0])
        out = decode_attention(
            q, cache["k"], cache["v"], q_positions=sp[:, 0],
            kv_positions=cache["positions"], sliding_window=window,
            softcap=att.attn_logit_softcap)
    else:
        out = _gqa_attend(q, k, v, ctx, att, window=window,
                          softcap=att.attn_logit_softcap, causal=ctx.causal)
        if ctx.mode == "prefill" and cache is not None:
            w = cache["positions"].shape[1]
            keep = min(w, S)
            # store last `keep` tokens at slots pos % w (ring layout)
            tail_pos = sp[:, S - keep:]
            slot = (tail_pos % w).long()
            b_idx = torch.arange(B, device=x.device)[:, None]
            cache["k"][b_idx, slot] = k[:, S - keep:].to(cache["k"].dtype)
            cache["v"][b_idx, slot] = v[:, S - keep:].to(cache["v"].dtype)
            cache["positions"][b_idx, slot] = tail_pos.to(torch.int32)

    out = out.reshape(B, S, att.n_heads * att.head_dim)
    return dense(p["o"], out), cache


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


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p["ln"], x, cfg.norm)
    if cfg.mlp_activation.endswith("_glu"):
        h = _act(dense(p["gate"], h), cfg.mlp_activation) * dense(p["up"], h)
    else:
        h = _act(dense(p["up"], h), cfg.mlp_activation)
    return dense(p["down"], h)
