"""Steps of the continuous-batching split-serving engines.

The port of `repro/serve/steps.py:65-290`. Every step crosses the two wire
boundaries:

* `make_tenant_prefill_step` — one request joins: head (+ the tenant's soft
  prompt) -> body -> the tenant's tail, at batch=1 against a blank slot
  cache. The engine copies the resulting cache into the request's slot of
  the shared KV cache, so the join never drains the in-flight batch.
* `make_batched_decode_step` — one token for every occupied slot: the
  frozen head and body run the whole slot batch (shared parameters), then
  the tail runs PER TENANT: the active slots are grouped by tenant and each
  present tenant's tail runs once on its rows. No per-slot copy of a tail
  is ever gathered (at Qwen2.5-14B width one tail with its LM head is
  4.2 GB of fp32). Idle or retired rows skip the tail; their logits are 0
  and the engine discards them. Recurrent state (Mamba-2, RWKV-6) rides
  the same row gather and scatter; idle rows advance it with garbage in
  the head and body, and admission overwrites the whole slot.
* `make_multi_decode_step` — `n_steps` tokens for every slot in a Python
  loop over the same per-token body (the JAX package's `lax.scan`). Slot
  retirement is deferred to loop exit; a slot's wire bytes stop counting
  the moment it retires, via the per-step `remaining > t` activity mask.
* `make_paged_decode_step` / `make_paged_multi_decode_step` — the same over
  a PAGE POOL with per-slot block tables (serve/paged_engine.py). Head,
  body and each present tenant's tail attend through the tables
  (`paged_decode_attention`) and write their token into the pool in place.
  The JAX step gathers the tail pool densely and scatters one token back,
  because its vmapped tail cannot write a shared pool; grouped by tenant,
  the port's tail writes through its rows' tables directly. The math per
  row is the same.
* `make_chunk_continue_step` — a chunked-prefill continuation: the chunk's
  tokens extend a partially filled batch=1 cache at absolute positions.
* `forced_logits` — one request teacher-forced through the prefill and
  decode steps on given tokens, so that two runs whose greedy tokens part
  (bf16 against f32, one device against another) compare step by step.

Wire accounting: prefill transmits exactly the request's smashed tensor;
decode transmits per OCCUPIED row (`Boundary.transmit(rows=n_active)`).
Byte counts are f32 scalars added in the same order as the JAX steps', so
metered totals are equal.

Host-side step inputs (`tenant_ids`, `active`, `remaining`) are numpy
arrays: grouping slots by tenant never waits on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.split import SplitModel
from repro_torch.runtime.boundary import BOUNDARY_NAMES
from repro_torch.sharding import parallel
from repro_torch.sharding.rules import P, cache_pspecs, params_pspecs
from repro_torch.tree import tree_map


def make_step_shardings(mesh, shared, *, cache=None, blank=None, pool=None):
    """The `P` spec trees of the serve steps' operands on a (data, model)
    mesh, as the JAX package's `make_step_shardings` builds its
    NamedSharding trees: the frozen head/body by `params_pspecs`
    (attention head-parallel, MLP d_ff-parallel, vocab-parallel token
    table), KV caches by `cache_pspecs` (slot dim over the client plane,
    kv heads over 'model'), page pools with paged=True (the page axis
    replicated), `blank` the batch=1 scratch cache, `repl` the replicated
    spec. The trees hold whole shapes (leaves anything with `.shape`,
    such as a cache built on the `meta` device); the engines cut their
    local shards by them: the dense cache's slot axis over 'data', the
    pool's kv heads alone (its pages replicated over 'data', so every
    'data' row runs the whole paged batch, as JAX's paged steps take
    every other operand replicated)."""
    out = {"repl": P(), "shared": params_pspecs(shared, mesh)}
    if cache is not None:
        out["cache"] = cache_pspecs(cache, mesh)
    if blank is not None:
        out["blank"] = cache_pspecs(blank, mesh)
    if pool is not None:
        out["pool"] = cache_pspecs(pool, mesh, paged=True)
    return out


def make_tenant_prefill_step(model: SplitModel, *, dtype=torch.float32):
    """prefill_step(shared, tail, prompt, batch, cache) ->
    (next_tok (1,), last_logits (1, V), cache, wire_bytes)."""
    def prefill_step(shared, tail, prompt, batch, cache):
        params = {"head": shared["head"], "body": shared["body"],
                  "tail": tail, "prompt": prompt}
        out = model.forward(params, batch, route="split", mode="prefill",
                            cache=cache, dtype=dtype, prompt=prompt)
        logits = out["logits"][:, -1, :].float()
        next_tok = logits.argmax(-1).to(torch.int32)
        return next_tok, logits, out["cache"], out["wire_bytes"]
    return prefill_step


def make_batched_decode_step(model: SplitModel, *, dtype=torch.float32,
                             slots=None, with_logits: bool = True):
    """decode_step(shared, bank, tenant_ids, tokens, pos, active, cache) ->
    (next_tok (S,), logits (S, V), cache, wire_bytes).

    `tokens`/`pos` are per-slot (S,) device tensors; `tenant_ids` (S,) and
    `active` (S,) bool are host arrays. Idle slots ride through the head
    and body for shape stability (their cache rows are wholly overwritten
    at the next allocation) and contribute zero wire bytes.

    `slots` = (lo, hi): `cache` holds this rank's block [lo, hi) of the S
    slots ('data'-sharded serving, `model.mesh`). The step then runs those
    rows alone and gathers the next tokens, and with `with_logits` the
    logits (else None), over 'data'; the wire bytes still count every
    active row of the whole batch, as the JAX step meters them."""
    wire = model.wire

    def decode_step(shared, bank, tenant_ids, tokens, pos, active, cache):
        S_all = len(active)
        lo, hi = slots or (0, S_all)
        n_active = np.float32(np.count_nonzero(active))
        if hi - lo < S_all:
            tokens, pos = tokens[lo:hi], pos[lo:hi]
            tenant_ids, active = tenant_ids[lo:hi], active[lo:hi]
        batch = {"tokens": tokens[:, None], "pos": pos}
        ho = model.head_fwd(shared["head"], None, batch, mode="decode",
                            cache=cache["head"], dtype=dtype)
        x, b_hb = wire.head_body.transmit(ho["smashed"], train=False,
                                          rows=n_active)
        bo = model.body_fwd(shared["body"], x, ho, cache=cache["body"])
        x, b_bt = wire.body_tail.transmit(bo["smashed"], train=False,
                                          rows=n_active)
        S = x.shape[0]
        logits = x.new_zeros((S, model.cfg.num_classes
                              or model.cfg.vocab_size), dtype=torch.float32)
        tail_stack = cache["tail"]["stack"]
        for tenant in np.unique(tenant_ids[active]):
            rows = np.flatnonzero(active & (tenant_ids == tenant))
            idx = torch.as_tensor(rows, device=x.device)
            p_rows = pos[idx][:, None]
            head_out = {"mode": "decode", "positions": p_rows,
                        "seq_pos": p_rows, "n_prefix": 0}
            sub = {"stack": tree_map(lambda c: c.index_select(1, idx),
                                     tail_stack)}
            to = model.tail_fwd(bank.tail(int(tenant)), x[idx], head_out,
                                cache=sub)
            logits[idx] = to["logits"][:, 0].float()
            tree_map(lambda c, new: c.index_copy_(1, idx, new), tail_stack,
                     sub["stack"])
        next_tok = logits.argmax(-1).to(torch.int32)
        if hi - lo < S_all:
            # token ids below 2^24 survive the f32 sum exactly
            next_tok = parallel.gather_axis(
                next_tok.float(), 0, model.mesh, "data").to(torch.int32)
            logits = (parallel.gather_axis(logits, 0, model.mesh, "data")
                      if with_logits else None)
        return next_tok, logits, cache, {"head_body": b_hb,
                                         "body_tail": b_bt}
    return decode_step


def make_multi_decode_step(model: SplitModel, n_steps: int, *,
                           dtype=torch.float32, with_logits: bool = True,
                           slots=None):
    """multi_decode_step(shared, bank, tenant_ids, tokens, pos, remaining,
    cache) -> (toks (n_steps, S), logits (n_steps, S, V) or None, cache,
    wire_bytes).

    Runs `n_steps` greedy decode tokens for every slot through the EXACT
    per-token body `make_batched_decode_step` builds. `remaining` (S,) is
    each slot's outstanding token budget (0 for idle slots): slot i is
    wire-active for the first remaining[i] steps and skipped after — the
    engine discards its trailing tokens and retires it at loop exit.
    `with_logits=False` keeps the (n_steps, S, V) logits out of the
    result. `slots` as in `make_batched_decode_step`."""
    decode_step = make_batched_decode_step(model, dtype=dtype, slots=slots,
                                           with_logits=with_logits)

    def multi_decode_step(shared, bank, tenant_ids, tokens, pos, remaining,
                          cache):
        acc = {name: np.float32(0.0) for name in BOUNDARY_NAMES}
        toks, all_logits = [], []
        for t in range(n_steps):
            tok, logits, cache, wb = decode_step(
                shared, bank, tenant_ids, tokens, pos, remaining > t, cache)
            acc = {k: np.float32(acc[k] + wb[k]) for k in acc}
            toks.append(tok)
            if with_logits:
                all_logits.append(logits)
            tokens, pos = tok, pos + 1
        logits = torch.stack(all_logits) if with_logits else None
        return torch.stack(toks), logits, cache, acc
    return multi_decode_step


# ------------------------------------------------------------- paged steps
def make_paged_decode_step(model: SplitModel, *, dtype=torch.float32):
    """paged_decode_step(shared, bank, tenant_ids, tokens, pos, active,
    pool, tables) -> (next_tok (S,), logits (S, V), pool, wire_bytes).

    The paged twin of `make_batched_decode_step`: the shared KV cache is a
    page pool, written in place, and `tables` (S, n_blocks) int32 on the
    pool's device maps each slot's logical blocks to physical pages.
    Retired slots' table rows point every block at the scratch page, so
    their (discarded) writes never touch a live page. Wire accounting is
    identical to the dense step — paging is memory-only."""
    wire = model.wire

    def paged_decode_step(shared, bank, tenant_ids, tokens, pos, active,
                          pool, tables):
        batch = {"tokens": tokens[:, None], "pos": pos}
        ho = model.head_fwd(shared["head"], None, batch, mode="decode",
                            cache=model.paged_seg_view(pool["head"], tables),
                            dtype=dtype)
        n_active = np.float32(np.count_nonzero(active))
        x, b_hb = wire.head_body.transmit(ho["smashed"], train=False,
                                          rows=n_active)
        bo = model.body_fwd(shared["body"], x, ho,
                            cache=model.paged_seg_view(pool["body"], tables))
        x, b_bt = wire.body_tail.transmit(bo["smashed"], train=False,
                                          rows=n_active)
        S = x.shape[0]
        logits = x.new_zeros((S, model.cfg.num_classes
                              or model.cfg.vocab_size), dtype=torch.float32)
        for tenant in np.unique(tenant_ids[active]):
            rows = np.flatnonzero(active & (tenant_ids == tenant))
            idx = torch.as_tensor(rows, device=x.device)
            p_rows = pos[idx][:, None]
            head_out = {"mode": "decode", "positions": p_rows,
                        "seq_pos": p_rows, "n_prefix": 0}
            to = model.tail_fwd(
                bank.tail(int(tenant)), x[idx], head_out,
                cache=model.paged_seg_view(pool["tail"], tables[idx]))
            logits[idx] = to["logits"][:, 0].float()
        next_tok = logits.argmax(-1).to(torch.int32)
        return next_tok, logits, pool, {"head_body": b_hb,
                                        "body_tail": b_bt}
    return paged_decode_step


def make_paged_multi_decode_step(model: SplitModel, n_steps: int, *,
                                 dtype=torch.float32,
                                 with_logits: bool = True):
    """`make_multi_decode_step` over the page pool: n_steps greedy tokens
    per slot through the paged per-token body. The block tables are loop
    constants — pages are preallocated for a request's whole lifetime at
    admission, so no table changes mid-dispatch.

    A slot that retires mid-loop keeps riding through the head and body,
    but its position FREEZES (`pos + (remaining > t + 1)`): advancing past
    the request's total would walk its write pointer off its allocated
    pages into NULL table entries (a dense ring just wraps; pages
    cannot)."""
    decode_step = make_paged_decode_step(model, dtype=dtype)

    def paged_multi_decode_step(shared, bank, tenant_ids, tokens, pos,
                                remaining, pool, tables):
        acc = {name: np.float32(0.0) for name in BOUNDARY_NAMES}
        toks, all_logits = [], []
        for t in range(n_steps):
            tok, logits, pool, wb = decode_step(
                shared, bank, tenant_ids, tokens, pos, remaining > t, pool,
                tables)
            acc = {k: np.float32(acc[k] + wb[k]) for k in acc}
            toks.append(tok)
            if with_logits:
                all_logits.append(logits)
            advance = torch.as_tensor((remaining > t + 1).astype(np.int32),
                                      device=pos.device)
            tokens, pos = tok, pos + advance
        logits = torch.stack(all_logits) if with_logits else None
        return torch.stack(toks), logits, pool, acc
    return paged_multi_decode_step


def make_chunk_continue_step(model: SplitModel, *, dtype=torch.float32):
    """chunk_step(shared, tail, batch, cache, chunk_start) ->
    (next_tok (1,), last_logits (1, V), cache, wire_bytes).

    A chunked-prefill CONTINUATION: `batch["tokens"]` (1, T) extends a
    partially filled batch=1 prefill cache, in place, starting at absolute
    position `chunk_start` (1,). The soft prompt went in with the first
    chunk, so none is prepended; attention runs write-then-attend over the
    full cache. Wire bytes are the chunk's smashed tensors — summed over
    chunks they equal the monolithic prefill's (the payload is linear in
    rows)."""
    def chunk_step(shared, tail, batch, cache, chunk_start):
        params = {"head": shared["head"], "body": shared["body"],
                  "tail": tail}
        out = model.forward(params, batch, route="split", mode="prefill",
                            cache=cache, dtype=dtype,
                            chunk_start=chunk_start)
        logits = out["logits"][:, -1, :].float()
        next_tok = logits.argmax(-1).to(torch.int32)
        return next_tok, logits, out["cache"], out["wire_bytes"]
    return chunk_step


@torch.no_grad()
def forced_logits(model: SplitModel, shared, bank, req, tokens, *,
                  dtype=torch.float32, max_seq: int, device) -> np.ndarray:
    """Serve `req` alone, teacher-forced: its prefill, then a decode step
    fed each of tokens[:-1] in turn (the tokens of a reference run), at
    batch 1 through the engine's step functions. Returns the (len(tokens),
    V) f32 logits of the prefill's last position and of every step."""
    prefill = make_tenant_prefill_step(model, dtype=dtype)
    decode = make_batched_decode_step(model, dtype=dtype)
    prompt = torch.as_tensor(np.asarray(req.tokens, np.int32)[None],
                             device=device)
    _, logits, cache, _ = prefill(
        shared, bank.tail(req.tenant), bank.prompt(req.tenant),
        {"tokens": prompt}, model.blank_slot_cache(max_seq, device=device))
    rows = [logits[0]]
    pos = len(req.tokens) + model.split.prompt_len
    tenant, active = np.array([req.tenant]), np.array([True])
    for tok in tokens[:-1]:
        _, logits, cache, _ = decode(
            shared, bank, tenant,
            torch.tensor([tok], dtype=torch.int32, device=device),
            torch.tensor([pos], dtype=torch.int32, device=device), active,
            cache)
        rows.append(logits[0])
        pos += 1
    return torch.stack(rows).cpu().numpy()
