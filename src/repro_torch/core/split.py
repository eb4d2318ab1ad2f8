"""Three-way model split W = [W_h | W_b | W_t] (SFPrompt Sec. 3.1).

The head (embedding frontend + the first layers) and the tail (last layers +
final norm + task head) live on the CLIENT; the body (everything between)
lives on the SERVER. Split points land on layer-pattern cycle boundaries.

The head->body and body->tail cut points are real wire boundaries: a
`runtime.boundary.WireSpec` (default raw fp32) owns a codec per link, and
`forward(route="split")` pushes every smashed activation through it,
reporting the measured bytes in `out["wire_bytes"]`.

This is the port of `repro/core/split.py`: token models with attention
(MLA included), MoE, Mamba-2 and RWKV-6 layers (zamba2's shared attention
block is copied into each segment, as in the JAX package; DeepSeek's dense
prefix layers belong to the head, its MTP head to the tail), the ViT
classifier the training round splits (patch embedding, CLS token and soft
prompt, non-causal attention, logits from the CLS row), Whisper (its
encoder is client-side feature extraction in the head segment; its output
reaches body and tail in the head's output, as in the JAX package, never
crossing a metered wire) and Qwen2-VL (the patch prefix and M-RoPE grid
positions, `models/transformer.py::embed`). Caches, slots, page pools,
segments and the forward with chunked-prefill continuation serve the
engines.
Params and caches are nested dicts of tensors keyed as the JAX pytrees;
caches and page pools are written in place.

`head_fwd(differentiable=True)` marks a pass that autograd goes through;
its attention and scans then run the plain versions on every device
(`models/layers.py`), as the JAX training round runs with `impl="ref"`.

On a mesh (`on_mesh`) the frozen head and body run on this rank's local
shards, tensor-parallel over 'model' (`sharding/parallel.py`), their
caches holding the rank's kv heads, Mamba-2 heads and RWKV-6 heads; the tail,
a client's trainable segment (a tenant's, in serving), runs whole on
every rank. The activations that cross the wire come out of an
all-reduce, so every 'model' rank holds the same rows and meters and
codes them alike; the bytes of a crossing are counted once, by the
trainer or engine, whatever the number of ranks.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (embed, encoder_out,
                                            init_block, init_embed,
                                            init_encoder, init_mtp,
                                            init_stack, run_stack,
                                            stack_cache)
from repro_torch.runtime.boundary import WireSpec
from repro_torch.sharding import parallel
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_map_with_path)

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
        self.mesh = None

    def on_mesh(self, mesh) -> "SplitModel":
        """A copy of this model whose forwards run the head and body on
        local shards over `mesh` (params cut by `sharding.rules`)."""
        out = copy.copy(self)
        out.mesh = mesh
        return out

    def _cache_cfg(self) -> ModelConfig:
        """The config the head's and body's caches are shaped by: on a
        'model' axis that divides the kv heads, a rank caches its own."""
        t = parallel.axis_size(self.mesh, "model")
        att = self.cfg.attention
        if t == 1 or att is None or att.n_kv_heads % t:
            return self.cfg
        return dataclasses.replace(self.cfg, attention=dataclasses.replace(
            att, n_kv_heads=att.n_kv_heads // t))

    def _local_state_heads(self, stacks: Params) -> Params:
        """The head's and body's recurrent states at this rank's heads, in
        place of the whole ones: on a 'model' axis that divides them, the
        Mamba-2 `ssm` and RWKV-6 `state` leaves (n, B, H, ., .) hold H/T
        heads, as `cache_pspecs` shards them; conv and token-shift states
        stay whole."""
        t = parallel.axis_size(self.mesh, "model")
        for stack in stacks.values():
            for name in ("ssm", "state"):
                leaf = stack.get(name)
                if t > 1 and leaf is not None and leaf.shape[2] % t == 0:
                    shape = list(leaf.shape)
                    shape[2] //= t
                    stack[name] = leaf.new_zeros(shape)
        return stacks

    # -------------------------------------------------------------- sizes
    def segment_fractions(self):
        """(alpha, tau) parameter fractions of |W| in head and body — feeds
        the Table-1 cost model."""
        total = self.cfg.param_count()
        h = self._segment_params_count("head")
        b = self._segment_params_count("body")
        return h / total, b / total

    def _segment_params_count(self, seg: str) -> int:
        """Parameters of one segment, counted on an init on the `meta`
        device (shapes only, nothing allocated)."""
        params = self.init(torch.Generator(), device="meta")
        return sum(x.numel() for x in tree_leaves(params[seg]))

    # -------------------------------------------------------------- init
    def init(self, generator: torch.Generator, *, device="cuda") -> Params:
        """Random params drawn from `generator` (which must live on
        `device`), keyed as the JAX package's `SplitModel.init`."""
        device = resolve_device(device)
        cfg, g = self.cfg, generator
        head: Params = {"embed": init_embed(g, cfg, device=device)}
        if cfg.encoder is not None:
            head["encoder"] = init_encoder(g, cfg, device=device)
        if cfg.n_dense_layers:
            head["dense_stack"] = {"pos0": init_stack(
                g, cfg, "attn", cfg.n_dense_layers, device=device)}
        head["stack"] = self._init_cycles(g, self.split.head_cycles, device)
        body: Params = {"stack": self._init_cycles(g, self.body_cycles,
                                                   device)}
        tail: Params = {"stack": self._init_cycles(g, self.split.tail_cycles,
                                                   device)}
        tail["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, device)
        out_dim = cfg.num_classes or cfg.vocab_size
        tail["head"] = L.dense_init(g, cfg.d_model, out_dim, device=device)
        if cfg.mtp:
            # the split forward never runs it; it is part of the tail a
            # client holds and uploads
            tail["mtp"] = init_mtp(g, cfg, device=device)
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
        """Stacked caches of each segment; Whisper's head also holds
        `encoder_out` (batch, n_frames, D), batch axis first."""
        device = resolve_device(device)
        cfg, local = self.cfg, self._cache_cfg()

        def seg_cache(n_cycles, c=cfg):
            return {f"pos{i}": stack_cache(c, kind, n_cycles, batch,
                                           seq_len, dtype, window=window,
                                           device=device)
                    for i, kind in enumerate(cfg.layer_pattern)}

        # on a mesh the head and body caches hold this rank's kv heads and
        # recurrent-state heads; the tail runs whole, and so does its cache
        cache: Params = {
            "head": {"stack": self._local_state_heads(
                seg_cache(self.split.head_cycles, local))},
            "body": {"stack": self._local_state_heads(
                seg_cache(self.body_cycles, local))},
            "tail": {"stack": seg_cache(self.split.tail_cycles)},
        }
        if cfg.n_dense_layers:
            cache["head"]["dense_stack"] = {"pos0": stack_cache(
                cfg, "attn", cfg.n_dense_layers, batch, seq_len, dtype,
                window=window, device=device)}
        if cfg.encoder is not None:
            cache["head"]["encoder_out"] = torch.zeros(
                (batch, cfg.encoder.n_frames, cfg.d_model), dtype=dtype,
                device=device)
        return cache

    # ------------------------------------------------- slotted allocation
    # A serving engine's shared KV cache is `init_cache(n_slots, ...)`:
    # every batch row is a SLOT that one in-flight request owns. Every cache
    # leaf carries the slot axis at 1, after the stacked-layer axis: the
    # attention k/v/positions and the recurrent conv (n, B, d_conv-1, C),
    # ssm (n, B, H, P, N), shift_t/shift_c (n, B, D) and state
    # (n, B, H, K, V) alike; the head's `encoder_out` (B, F, D) alone has
    # it at 0.

    @staticmethod
    def _slot_axis(path) -> int:
        return 0 if "encoder_out" in path else 1

    def blank_slot_cache(self, seq_len: int, dtype=torch.float32,
                         window=None, *, device="cuda") -> Params:
        """A fresh batch=1 cache — the state of one unoccupied slot."""
        return self.init_cache(1, seq_len, dtype, window=window,
                               device=device)

    @staticmethod
    def _slot_count(shared: Params) -> int:
        path, leaf = tree_flatten(shared)[0]
        return leaf.shape[SplitModel._slot_axis(path)]

    @staticmethod
    def cache_write_slot(shared: Params, single: Params, slot: int, *,
                         first: int = 0) -> Params:
        """Copy a batch=1 cache into slot `slot` of the shared n-slot cache,
        in place. Overwrites every leaf of that slot — positions included —
        so a newly allocated slot never sees a previous tenant's KV state.
        `first`: `shared` holds a rank's block of slots from global slot
        `first` on ('data'-sharded serving); a slot outside the block is
        another rank's, and nothing is written."""
        local = slot - first
        if not 0 <= local < SplitModel._slot_count(shared):
            return shared
        for (path, s), (_, one) in zip(tree_flatten(shared),
                                       tree_flatten(single)):
            ax = SplitModel._slot_axis(path)
            s.select(ax, local).copy_(one.select(ax, 0))
        return shared

    @staticmethod
    def cache_read_slot(shared: Params, slot: int, *,
                        first: int = 0) -> Params:
        """A copy of slot `slot` of the shared cache as a batch=1 cache;
        `first` as in `cache_write_slot` (a slot outside the block
        raises)."""
        local = slot - first
        if not 0 <= local < SplitModel._slot_count(shared):
            raise ValueError(f"slot {slot} is not in this block of "
                             f"{SplitModel._slot_count(shared)} slots from "
                             f"{first}")
        return tree_map_with_path(
            lambda path, s: s.narrow(SplitModel._slot_axis(path), local,
                                     1).clone(), shared)

    # ------------------------------------------------- paged allocation
    # The paged serving cache replaces the dense (slot, window) pair with a
    # PAGE POOL: every attention-cache leaf becomes (n_cycles, n_pages,
    # page_size, ...) and a per-slot BLOCK TABLE of physical page ids maps a
    # slot's logical blocks onto pool pages (serve/paged_engine.py owns the
    # host-side allocator). A pool is literally `init_cache(n_pages,
    # page_size)` — batch axis = page axis — so the page axis is uniformly
    # axis 1 of every leaf, after the stacked-layer axis. The ops below
    # write the pool in place.

    def paged_cache_unsupported(self) -> Optional[str]:
        """None when this model can serve from a paged pool; otherwise the
        reason it cannot. Paging assumes every cached layer is a uniform
        full-window attention cache (one ring layout shared by all leaves);
        recurrent state (mamba/rwkv), MLA latents, local-attention windows,
        encoder outputs and dense prefix stacks keep per-slot state the
        block tables cannot express yet."""
        cfg = self.cfg
        if cfg.arch_type in ("vit", "audio", "vlm"):
            return f"arch_type {cfg.arch_type!r} has no token decode loop"
        if any(kind != "attn" for kind in cfg.layer_pattern):
            return (f"layer pattern {cfg.layer_pattern} has non-'attn' "
                    f"layers")
        if cfg.attention is not None and cfg.attention.mla is not None:
            return "MLA latent caches are not paged yet"
        if cfg.n_dense_layers:
            return f"{cfg.n_dense_layers} dense prefix layers are not paged"
        if cfg.encoder is not None:
            return "encoder models have no token decode loop"
        return None

    def init_paged_cache(self, n_pages: int, page_size: int,
                         dtype=torch.float32, *, device="cuda") -> Params:
        """The device-side page pool: one page axis shared by head, body
        and tail stacks (a page id is valid in every layer's pool)."""
        reason = self.paged_cache_unsupported()
        if reason is not None:
            raise ValueError(f"{self.cfg.name}: paged cache unsupported — "
                             f"{reason}")
        return self.init_cache(n_pages, page_size, dtype, device=device)

    @staticmethod
    def paged_seg_view(seg_cache: Params, tables: torch.Tensor) -> Params:
        """Inject the (S, n_blocks) block tables into every stacked layer
        group of one segment's pool (expanded over the cycle axis, so each
        layer sees them); `apply_attention` detects the key and takes the
        paged decode path. The pool leaves are shared, not copied: writes
        through the view land in the pool."""
        stacks = {}
        for name, stack in seg_cache["stack"].items():
            n = stack["positions"].shape[0]
            stacks[name] = dict(stack, block_tables=tables[None].expand(
                (n,) + tuple(tables.shape)))
        return {"stack": stacks}

    @staticmethod
    def strip_paged_view(seg_cache: Params) -> Params:
        """Drop the injected block tables, leaving the bare pool tree."""
        return {"stack": {name: {k: v for k, v in stack.items()
                                 if k != "block_tables"}
                          for name, stack in seg_cache["stack"].items()}}

    @staticmethod
    def paged_gather(pool: Params, tables: torch.Tensor) -> Params:
        """Gather per-slot dense cache views out of a pool: leaf
        (n, P, page, ...) + tables (S, nb) -> (n, S, nb*page, ...), laid out
        exactly like a dense `init_cache(S, nb*page)` slot cache (block j
        covers width indices [j*page, (j+1)*page)). The result is a copy."""
        S, nb = tables.shape
        idx = tables.long()

        def g(leaf):
            out = leaf[:, idx]                       # (n, S, nb, page, ...)
            return out.reshape(leaf.shape[0], S, nb * leaf.shape[2],
                               *leaf.shape[3:])
        return tree_map(g, pool)

    @staticmethod
    def paged_scatter_token(pool: Params, dense: Params,
                            tables: torch.Tensor,
                            pos: torch.Tensor) -> Params:
        """Write back the single token each slot just wrote at width index
        `pos` (S,) of its dense view (the decode-step inverse of
        `paged_gather` — everything else in the dense view is unchanged
        pool content), in place."""
        S = tables.shape[0]
        s_idx = torch.arange(S, device=tables.device)
        pos = pos.long()

        def sc(pool_leaf, dense_leaf):
            page_len = pool_leaf.shape[2]
            page = tables[s_idx, pos // page_len].long()     # (S,)
            off = pos % page_len
            vals = dense_leaf[:, s_idx, pos]                 # (n, S, ...)
            pool_leaf[:, page, off] = vals.to(pool_leaf.dtype)
        tree_map(sc, pool, dense)
        return pool

    @staticmethod
    def paged_scatter_slot(pool: Params, single: Params,
                           table_row: torch.Tensor, write_mask: torch.Tensor,
                           scratch_page: int) -> Params:
        """Scatter one slot's batch=1 dense cache (width nb*page) into its
        pages, in place. `write_mask` (nb,) bool selects the blocks to land;
        masked blocks (shared prefix pages, unallocated entries) are
        redirected to the scratch page, which is never read for a live
        slot."""
        nb = table_row.shape[0]
        dest = torch.where(write_mask, table_row,
                           torch.full_like(table_row, scratch_page)).long()

        def sc(pool_leaf, dense_leaf):
            page_len = pool_leaf.shape[2]
            r = dense_leaf[:, 0].reshape(dense_leaf.shape[0], nb, page_len,
                                         *dense_leaf.shape[3:])
            pool_leaf[:, dest] = r.to(pool_leaf.dtype)
        tree_map(sc, pool, single)
        return pool

    @staticmethod
    def paged_copy_page(pool: Params, src: int, dst: int) -> Params:
        """Copy one physical page across every layer's pool, in place — the
        COW divergence copy for a shared boundary page."""
        tree_map(lambda a: a[:, dst].copy_(a[:, src]), pool)
        return pool

    # -------------------------------------------------------------- segments
    def _seg_fwd(self, seg_p, x, ctx, cache):
        caches = cache["stack"] if cache is not None else None
        x, aux, _ = run_stack(self.cfg, seg_p["stack"], self.cfg.layer_pattern,
                              x, ctx, caches, shared=seg_p.get("shared_attn"))
        return x, aux, cache

    def head_fwd(self, head_p, prompt, batch, *, mode="train", cache=None,
                 dtype=torch.float32, chunk_start=None,
                 differentiable: bool = False,
                 chunked: bool = False) -> Dict[str, Any]:
        """Client-side: embed (+prompts, + Whisper's encoder) -> head
        layers. Output `smashed` is the cut-layer activation sent to the
        server. `chunk_start` (B,) marks a chunked-prefill continuation: the
        batch's tokens extend a partially-filled prefill cache starting at
        those positions (attention then runs write-then-attend over the full
        cache, like decode, instead of chunk-local causal). `differentiable`
        marks a pass autograd goes through, `chunked` one whose plain
        scans take their chunked forms (JAX's `impl="chunked"`); body_fwd
        and tail_fwd inherit both. Whisper's encoder output rides in the
        returned dict to body and tail (the JAX package's `head_out`);
        prefill writes it into the head's cache, decode reads it from
        there."""
        cfg, mesh = self.cfg, self.mesh
        enc = (encoder_out(cfg, head_p["encoder"], batch, mode, cache, dtype,
                           differentiable, mesh)
               if cfg.encoder is not None else None)
        x, positions, seq_pos, n_prefix = embed(
            cfg, parallel.materialize(head_p["embed"], mesh), batch, mode,
            prompt, dtype, chunk_start, mesh)
        ho = {"positions": positions, "seq_pos": seq_pos, "mode": mode,
              "encoder_out": enc,
              "has_context": chunk_start is not None,
              "differentiable": differentiable, "chunked": chunked}
        ctx = self._ctx_from(ho)
        aux = 0.0
        if cfg.n_dense_layers:
            # DeepSeek's dense prefix layers run before the head cycles
            x, aux, _ = run_stack(
                cfg, head_p["dense_stack"], ("attn",), x, ctx,
                cache["dense_stack"] if cache is not None else None)
        x, a, new_cache = self._seg_fwd(head_p, x, ctx, cache)
        return dict(ho, smashed=x, n_prefix=n_prefix, aux=aux + a,
                    cache=new_cache)

    def _ctx_from(self, head_out) -> L.Ctx:
        return L.Ctx(mode=head_out["mode"], positions=head_out["positions"],
                     seq_pos=head_out["seq_pos"],
                     causal=self.cfg.arch_type != "vit",
                     encoder_out=head_out.get("encoder_out"),
                     has_context=head_out.get("has_context", False),
                     differentiable=head_out.get("differentiable", False),
                     mesh=self.mesh, chunked=head_out.get("chunked", False))

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
        if cfg.arch_type == "vit":
            out["logits"] = L.dense(tail_p["head"], hidden[:, 0])
            return out
        if last_only:
            hidden = hidden[:, -1:, :]
        logits = hidden @ tail_p["head"]["w"].to(hidden.dtype)
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        out["logits"] = logits
        out["n_prefix"] = head_out["n_prefix"]
        if cfg.mtp and head_out["mode"] == "train" and batch is not None:
            # the MTP head needs the embedding, which lives in the head
            # segment; the client holds both, so it is local (no extra
            # communication)
            out["mtp_hidden_ready"] = True
        return out

    # -------------------------------------------------------------- routes
    def forward(self, params, batch, *, route="split", mode="train",
                cache=None, dtype=torch.float32, prompt=None, last_only=True,
                wire_generator: Optional[torch.Generator] = None,
                chunk_start=None, chunked: bool = False):
        """route='split': head -> body -> tail, every smashed tensor
        crossing the head_body / body_tail wire boundaries through their
        codecs; out['wire_bytes'] holds the measured bytes per link.
        route='local': head -> tail directly (zero server communication).
        `wire_generator` draws stochastic-rounding noise (training); None
        rounds to nearest. `chunk_start` (B,) runs a chunked-prefill
        continuation (see `head_fwd`); the soft prompt went in with the
        first chunk, so none is prepended here. `chunked` as in
        `head_fwd`."""
        if chunk_start is not None:
            prompt = None
        else:
            prompt = params["prompt"] if prompt is None else prompt
        hc = cache["head"] if cache is not None else None
        ho = self.head_fwd(params["head"], prompt, batch, mode=mode,
                           cache=hc, dtype=dtype, chunk_start=chunk_start,
                           chunked=chunked)
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
