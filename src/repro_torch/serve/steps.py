"""Steps of the continuous-batching split-serving engine.

The port of `repro/serve/steps.py:65-170`. Every step crosses the two wire
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
  and the engine discards them.
* `make_multi_decode_step` — `n_steps` tokens for every slot in a Python
  loop over the same per-token body (the JAX package's `lax.scan`). Slot
  retirement is deferred to loop exit; a slot's wire bytes stop counting
  the moment it retires, via the per-step `remaining > t` activity mask.

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
from repro_torch.tree import tree_map


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


def make_batched_decode_step(model: SplitModel, *, dtype=torch.float32):
    """decode_step(shared, bank, tenant_ids, tokens, pos, active, cache) ->
    (next_tok (S,), logits (S, V), cache, wire_bytes).

    `tokens`/`pos` are per-slot (S,) device tensors; `tenant_ids` (S,) and
    `active` (S,) bool are host arrays. Idle slots ride through the head
    and body for shape stability (their cache rows are wholly overwritten
    at the next allocation) and contribute zero wire bytes."""
    wire = model.wire

    def decode_step(shared, bank, tenant_ids, tokens, pos, active, cache):
        batch = {"tokens": tokens[:, None], "pos": pos}
        ho = model.head_fwd(shared["head"], None, batch, mode="decode",
                            cache=cache["head"], dtype=dtype)
        n_active = np.float32(np.count_nonzero(active))
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
        return next_tok, logits, cache, {"head_body": b_hb,
                                         "body_tail": b_bt}
    return decode_step


def make_multi_decode_step(model: SplitModel, n_steps: int, *,
                           dtype=torch.float32, with_logits: bool = True):
    """multi_decode_step(shared, bank, tenant_ids, tokens, pos, remaining,
    cache) -> (toks (n_steps, S), logits (n_steps, S, V) or None, cache,
    wire_bytes).

    Runs `n_steps` greedy decode tokens for every slot through the EXACT
    per-token body `make_batched_decode_step` builds. `remaining` (S,) is
    each slot's outstanding token budget (0 for idle slots): slot i is
    wire-active for the first remaining[i] steps and skipped after — the
    engine discards its trailing tokens and retires it at loop exit.
    `with_logits=False` keeps the (n_steps, S, V) logits out of the
    result."""
    decode_step = make_batched_decode_step(model, dtype=dtype)

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
