"""Transformer stacks, the attention kinds only.

The layer stack is grouped by the config's layer-pattern cycle. Each cycle
position holds its n layers' params STACKED on a leading layer axis, keyed
as the JAX pytree, and a Python loop over that axis takes the place of the
JAX package's `lax.scan` (`repro/models/transformer.py:101-126`). Decode
caches are stacked the same way; each layer sees views of its cache rows,
so in-place cache writes land in the stacked tensors.

Modes:
  train   — full-sequence forward, no cache
  prefill — full-sequence forward, fills a (possibly ring-buffer) cache
  decode  — one token per call against the cache
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_SELF_ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")


def _unported(kind: str):
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (attention kinds only)")


# ------------------------------------------------------------------ blocks
def init_block(gen, cfg: ModelConfig, kind: str, *, device="cuda") -> Params:
    if kind in _SELF_ATTN_KINDS:
        return {"attn": L.init_attention(gen, cfg, device=device),
                "mlp": L.init_mlp(gen, cfg, device=device)}
    raise _unported(kind)


def apply_block(params: Params, cfg: ModelConfig, kind: str, x, ctx: L.Ctx,
                cache):
    """-> (x, new_cache, aux_loss)"""
    if kind not in _SELF_ATTN_KINDS:
        raise _unported(kind)
    delta, new_cache = L.apply_attention(params["attn"], cfg, x, ctx, cache,
                                         kind=kind)
    x = x + delta
    x = x + L.apply_mlp(params["mlp"], cfg, x)
    return x, new_cache, 0.0


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype=torch.float32, window=None, *, device="cuda"):
    """window: optional ring-buffer cap; local-attention layers additionally
    cap at their sliding window — their cache never needs to be larger."""
    if kind not in ATTN_KINDS or kind == "cross_attn":
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
    None) and is written in place. Returns (x, aux_loss, caches)."""
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
