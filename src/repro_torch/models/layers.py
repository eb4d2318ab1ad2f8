"""Layer library, the subset the serving paths and the ViT training round
run: attention, MLP, Mamba-2 and RWKV-6 blocks.

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
launch the kernels on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ref as attention_ref
from repro_torch.kernels.flash_attention.decode import (
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba2_scan import ref as mamba2_ref
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan
from repro_torch.kernels.rwkv6_scan import ref as rwkv6_ref
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
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
    differentiable: bool = False                # a pass autograd goes through:
    #                                             attention runs plain

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


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                    cache: Optional[Params], *, kind: str = "attn"):
    """Self-attention block half (pre-norm). Returns (residual_delta, cache)."""
    att = cfg.attention
    if att.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    if att.mrope_sections is not None and ctx.positions.dim() == 3:
        raise NotImplementedError("M-RoPE is not ported yet")
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
    there."""
    m = cfg.mamba2
    B, S, D = x.shape
    di = m.d_inner(D)
    H = m.n_heads(D)
    G, N = 1, m.d_state
    h = apply_norm(p["ln"], x, cfg.norm)
    zxbcdt = dense(p["in_proj"], h)
    z, xin, BC, dt = torch.split(zxbcdt, [di, di, 2 * G * N, H], dim=-1)
    conv_in = torch.cat([xin, BC], dim=-1)
    prev = cache["conv"] if cache is not None else None
    conv_out, new_prev = _causal_conv1d(conv_in, p["conv_w"], p["conv_b"],
                                        prev)
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, S, H)
    A = -torch.exp(p["A_log"])

    xh = xin.reshape(B, S, H, m.head_dim)
    # the scan writes the final state into the cache in place (the
    # differentiated plain version returns it and the cache takes a copy)
    ssm = cache["ssm"] if cache is not None else None
    scan_in = (xh, dt, A, Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N),
               ssm)
    if ctx.differentiable:
        y, new_ssm = mamba2_ref.mamba2_scan(*scan_in)
        if ssm is not None:
            ssm.copy_(new_ssm)
    else:
        y, _ = mamba2_scan(*scan_in, state_out=ssm)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, di) * F.silu(z)
    y = apply_norm(p["norm"], y, "rmsnorm")
    if cache is not None:
        cache["conv"].copy_(new_prev)
    return dense(p["out_proj"], y), cache


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
    1e-5, as the JAX block does (not `apply_norm`'s 1e-6)."""
    r6 = cfg.rwkv6
    B, S, D = x.shape
    H, K = D // r6.head_size, r6.head_size

    # ---- time mix
    h = apply_norm(p["ln_t"], x, "layernorm")
    xx = _token_shift(h, cache["shift_t"] if cache is not None else None)
    mr, mk, mv, mw, mg = (h + (xx - h) * p["mu"][i].to(h.dtype)
                          for i in range(5))
    r = dense(p["r"], mr).reshape(B, S, H, K)
    k = dense(p["k"], mk).reshape(B, S, H, K)
    v = dense(p["v"], mv).reshape(B, S, H, K)
    g = F.silu(dense(p["g"], mg))
    # data-dependent decay (Finch): w = w0 + tanh(mw A) B, log-decay -exp(w)
    wdd = p["w0"] + torch.tanh(mw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    w = -torch.exp(wdd).reshape(B, S, H, K)

    # the scan writes the final state into the cache in place (the
    # differentiated plain version returns it and the cache takes a copy)
    state = cache["state"] if cache is not None else None
    if ctx.differentiable:
        y, new_state = rwkv6_ref.rwkv6_scan(r, k, v, w, p["u"], state)
        if state is not None:
            state.copy_(new_state)
    else:
        y, _ = rwkv6_scan(r, k, v, w, p["u"], state, state_out=state)
    # per-head group norm
    yg = y.reshape(B, S, H, K).float()
    mu = yg.mean(-1, keepdim=True)
    var = ((yg - mu) ** 2).mean(-1, keepdim=True)
    yg = ((yg - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, D)
    y = (yg * p["gn"]["scale"] + p["gn"]["bias"]).to(x.dtype) * g
    tdelta = dense(p["o"], y)
    x = x + tdelta

    # ---- channel mix
    hc = apply_norm(p["ln_c"], x, "layernorm")
    xxc = _token_shift(hc, cache["shift_c"] if cache is not None else None)
    mkc = hc + (xxc - hc) * p["mu_c"][0].to(hc.dtype)
    mrc = hc + (xxc - hc) * p["mu_c"][1].to(hc.dtype)
    kk = F.relu(dense(p["ck"], mkc))
    cdelta = torch.sigmoid(dense(p["cr"], mrc)) * dense(p["cv"], kk * kk)

    if cache is not None:
        cache["shift_t"].copy_(h[:, -1])
        cache["shift_c"].copy_(hc[:, -1])
    return tdelta + cdelta, cache
