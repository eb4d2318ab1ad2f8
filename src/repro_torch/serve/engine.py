"""ServeEngine: multi-tenant continuous-batching engine for split inference.

The port of `repro/serve/engine.py`. Slot lifecycle:

    queue ──admit──> FREE slot ──prefill──> ACTIVE ──max_new reached──> FREE
      ^                (batch=1, tenant         (joins the batched
      └ admission       tail+prompt, cache       decode every step)
        control         copied into the
        (max_queue)     slot's cache rows)

The shared KV cache is `SplitModel.init_cache(n_slots, ...)`: batch row i
IS slot i, owned by at most one in-flight request. Each `step()` admits up
to `prefills_per_step` queued requests into free slots (a batch=1 prefill
each, copied in with `cache_write_slot`), then runs ONE batched decode
dispatch over all slots — requests join and leave mid-flight without ever
draining the batch.

Differences from the JAX engine, none of which changes a token or a byte:
  * no mesh (multi-device serving comes with a later slice);
  * the shared KV cache is updated in place instead of donated; a prefill
    fills a fresh blank slot cache, and admission overwrites every leaf of
    the slot with it (positions reset to -1 included), so a reused slot
    never sees the previous tenant's KV;
  * the decode tail runs per present tenant, never per slot (serve/steps.py);
  * wire bytes accumulate in f32 on the host — every count is known there —
    with the JAX engine's f32 adds in the same order, and fold into the
    meter in `stats()` / `reset_stats()`.

Per-tenant personalization: every request carries a tenant id; prefill
injects the tenant's soft prompt and tail. The frozen head/body are shared.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.split import SplitModel, resolve_device
from repro_torch.obs.trace import NOOP
from repro_torch.runtime.boundary import BOUNDARY_NAMES
from repro_torch.runtime.meter import TrafficMeter
from repro_torch.serve.bank import TenantBank
from repro_torch.serve.steps import (make_batched_decode_step,
                                     make_multi_decode_step,
                                     make_tenant_prefill_step)
from repro_torch.serve.workload import Request
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class ServeConfig:
    n_slots: int = 8          # concurrent requests (shared-cache batch)
    max_seq: int = 128        # per-slot KV window (prompt + soft prompt
    #                           + generated tokens must fit)
    max_queue: int = 64       # admission control: pending-request cap
    prefills_per_step: int = 2  # joins per engine step (prefill/decode mix)
    decode_block: int = 1     # tokens per decode dispatch (power-of-two
    #                           buckets, as in the JAX engine); 1 = per-token
    dtype: Any = torch.float32


@dataclass
class _SlotState:
    req: Request
    next_pos: int             # absolute position of the next decode token
    tokens: List[int] = field(default_factory=list)
    logits: List[np.ndarray] = field(default_factory=list)
    t_submit: float = 0.0


@dataclass
class Finished:
    req: Request
    tokens: np.ndarray                      # (max_new,) generated ids
    latency_s: float
    logits: Optional[np.ndarray] = None     # (max_new, V) if collected


class ServeEngine:
    def __init__(self, model: SplitModel, shared_params, bank: TenantBank,
                 cfg: ServeConfig, *, collect_logits: bool = False,
                 tracer=None, device="cuda"):
        if model.cfg.arch_type in ("vit", "audio", "vlm") \
                or model.cfg.encoder is not None:
            raise ValueError(
                f"{model.cfg.name}: the serving engine decodes token "
                f"streams; arch_type {model.cfg.arch_type!r} has no "
                f"token decode loop")
        self.device = resolve_device(device)
        self.shared = {"head": shared_params["head"],
                       "body": shared_params["body"]}
        for leaf in tree_leaves(self.shared) + tree_leaves(bank.tails):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params on {leaf.device}, engine on "
                                 f"{self.device}")
        self.model = model
        self.bank = bank
        self.cfg = cfg
        self.collect_logits = collect_logits
        # flight recorder: observation only — the default NOOP records
        # nothing; byte-carrying records appear only at the meter flush
        self.tracer = tracer if tracer is not None else NOOP
        self.meter = TrafficMeter()
        self.meter.attach_tracer(self.tracer)

        S = cfg.n_slots
        self.cache = model.init_cache(S, seq_len=cfg.max_seq,
                                      dtype=torch.float32, device=self.device)
        self._tokens = np.zeros((S,), np.int32)     # next input per slot
        self._pos = np.zeros((S,), np.int32)
        self._tenants = np.zeros((S,), np.int32)
        self._slots: List[Optional[_SlotState]] = [None] * S
        self._free: List[int] = list(range(S))      # free-list (LIFO)
        self._queue: List[Request] = []
        self._t_enqueue: Dict[int, float] = {}      # rid -> submit time

        self._prefill = make_tenant_prefill_step(model, dtype=cfg.dtype)
        self._decode = make_batched_decode_step(model, dtype=cfg.dtype)
        self._multi: Dict[int, Any] = {}    # decode_block bucket -> step
        self._wire_acc = self._zero_wire()

        # step accounting
        self.step_idx = 0
        self.decode_steps = 0
        self.prefill_count = 0
        self.rejected = 0
        self.tokens_out = 0
        self._occupancy_sum = 0.0

    # -------------------------------------------------------------- wire
    @staticmethod
    def _zero_wire() -> Dict[str, np.float32]:
        return {name: np.float32(0.0) for name in BOUNDARY_NAMES}

    def _absorb_wire(self, wb) -> None:
        self._wire_acc = {k: np.float32(self._wire_acc[k] + wb[k])
                          for k in self._wire_acc}

    def _flush_wire(self) -> None:
        """Fold the f32 accumulator into the meter (stats()/reset_stats())."""
        vals = {k: float(v) for k, v in self._wire_acc.items()}
        if any(vals.values()):
            self.meter.absorb(vals)
        self._wire_acc = self._zero_wire()

    # ------------------------------------------------------------- intake
    def _window_check(self, req: Request) -> None:
        total = len(req.tokens) + self.model.split.prompt_len + req.max_new
        if total > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt({len(req.tokens)}) + soft "
                f"prompt({self.model.split.prompt_len}) + "
                f"new({req.max_new}) = {total} exceeds the slot window "
                f"{self.cfg.max_seq}")

    def submit(self, req: Request) -> bool:
        """Admission control: False (rejected) once the queue is full."""
        self._window_check(req)
        if req.tenant >= self.bank.n_tenants:
            raise ValueError(f"request {req.rid}: unknown tenant "
                             f"{req.tenant} (bank has {self.bank.n_tenants})")
        if len(self._queue) >= self.cfg.max_queue:
            self.rejected += 1
            self.tracer.event("serve.reject", level=2, rid=req.rid,
                              tenant=req.tenant)
            return False
        self._t_enqueue[req.rid] = time.perf_counter()
        self._queue.append(req)
        self.tracer.event("serve.submit", level=2, rid=req.rid,
                          tenant=req.tenant, prompt_len=len(req.tokens),
                          max_new=req.max_new)
        return True

    @property
    def n_active(self) -> int:
        return self.cfg.n_slots - len(self._free)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and not self._queue

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def _admit_one(self, req: Request) -> Optional[Finished]:
        slot = self._free.pop()
        tokens = torch.tensor(np.asarray(req.tokens, np.int32)[None],
                              device=self.device)
        tail = self.bank.tail(req.tenant)
        prompt = self.bank.prompt(req.tenant)
        blank = self.model.blank_slot_cache(self.cfg.max_seq,
                                            dtype=torch.float32,
                                            device=self.device)
        with self.tracer.span("serve.prefill", rid=req.rid,
                              tenant=req.tenant, slot=slot,
                              prompt_len=len(req.tokens)):
            with self.tracer.annotate("serve.prefill"):
                tok, logits, slot_cache, wb = self._prefill(
                    self.shared, tail, prompt, {"tokens": tokens}, blank)
            self.model.cache_write_slot(self.cache, slot_cache, slot)
        self._absorb_wire(wb)
        self.prefill_count += 1
        self.tokens_out += 1

        st = _SlotState(req=req,
                        t_submit=self._t_enqueue.pop(
                            req.rid, time.perf_counter()),
                        next_pos=len(req.tokens)
                        + self.model.split.prompt_len)
        st.tokens.append(int(tok[0]))
        if self.collect_logits:
            st.logits.append(logits[0].cpu().numpy())
        if req.max_new <= 1:
            self._release_slot(slot)
            return self._finish(st)
        self._slots[slot] = st
        self._tokens[slot] = st.tokens[-1]
        self._pos[slot] = st.next_pos
        self._tenants[slot] = req.tenant
        return None

    def _finish(self, st: _SlotState) -> Finished:
        # retirement attrs stay deterministic — token COUNTS, never the
        # wall-clock latency (same-seed traces must compare equal)
        self.tracer.event("serve.retire", rid=st.req.rid,
                          tenant=st.req.tenant, n_tokens=len(st.tokens))
        return Finished(
            req=st.req, tokens=np.asarray(st.tokens, np.int32),
            latency_s=time.perf_counter() - st.t_submit,
            logits=(np.stack(st.logits) if st.logits else None))

    # -------------------------------------------------------------- step
    def _decode_bucket(self, max_remaining: int) -> int:
        """Tokens to decode in one dispatch: the largest power of two <=
        min(decode_block, max slot budget)."""
        n = min(self.cfg.decode_block, max_remaining)
        return 1 << (max(1, n).bit_length() - 1)

    def _get_multi(self, n_steps: int):
        fn = self._multi.get(n_steps)
        if fn is None:
            fn = make_multi_decode_step(self.model, n_steps,
                                        dtype=self.cfg.dtype,
                                        with_logits=self.collect_logits)
            self._multi[n_steps] = fn
        return fn

    def _admit_from_queue(self, done: List[Finished]) -> None:
        admitted = 0
        while (self._queue and self._free
               and admitted < self.cfg.prefills_per_step):
            fin = self._admit_one(self._queue.pop(0))
            admitted += 1
            if fin is not None:
                done.append(fin)

    @torch.no_grad()
    def _dispatch_decode(self, remaining: np.ndarray, n_eff: int):
        """One decode dispatch over the slot batch; returns ((n_eff, S)
        tokens, (n_eff, S, V) logits or None, wire bytes)."""
        tokens = torch.tensor(self._tokens, device=self.device)
        pos = torch.tensor(self._pos, device=self.device)
        if n_eff <= 1:
            toks, logits, self.cache, wb = self._decode(
                self.shared, self.bank, self._tenants, tokens, pos,
                remaining > 0, self.cache)
            return toks[None], logits[None], wb
        toks, logits, self.cache, wb = self._get_multi(n_eff)(
            self.shared, self.bank, self._tenants, tokens, pos, remaining,
            self.cache)
        return toks, logits, wb

    def _release_slot(self, slot: int) -> None:
        self._free.append(slot)

    def step(self) -> List[Finished]:
        """One engine step: admit up to `prefills_per_step` queued requests
        into free slots, then one batched decode over every occupied slot —
        a single token, or up to `decode_block` tokens in one dispatch, with
        retirement deferred to its end. Returns the requests that completed
        during this step."""
        done: List[Finished] = []
        self._admit_from_queue(done)

        remaining = np.array(
            [0 if s is None else s.req.max_new - len(s.tokens)
             for s in self._slots], np.int32)
        if not remaining.any():
            self.step_idx += 1
            return done
        n_eff = self._decode_bucket(int(remaining.max()))
        with self.tracer.span("serve.decode", level=2, step=self.step_idx,
                              n_tokens=n_eff,
                              active=int((remaining > 0).sum())):
            with self.tracer.annotate("serve.decode"):
                toks, logits, wb = self._dispatch_decode(remaining, n_eff)
        self._absorb_wire(wb)
        self.decode_steps += n_eff
        for t in range(n_eff):
            self._occupancy_sum += ((remaining > t).sum()
                                    / self.cfg.n_slots)
        tok_np = toks.cpu().numpy()
        logits_np = logits.cpu().numpy() if self.collect_logits else None
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            take = min(n_eff, int(remaining[slot]))
            for t in range(take):
                st.tokens.append(int(tok_np[t, slot]))
                if self.collect_logits:
                    st.logits.append(logits_np[t, slot])
                st.next_pos += 1
            self.tokens_out += take
            self._tokens[slot] = tok_np[take - 1, slot]
            self._pos[slot] = st.next_pos
            if len(st.tokens) >= st.req.max_new:
                done.append(self._finish(st))
                self._slots[slot] = None
                self._release_slot(slot)
        self.step_idx += n_eff
        return done

    # ------------------------------------------------------------- reset
    def reset_stats(self) -> None:
        """Zero the run counters and the meter (engine must be idle): one
        engine can then serve several measured traces without cross-run
        accumulation."""
        if not self.idle:
            raise RuntimeError("reset_stats with requests in flight")
        self.meter = TrafficMeter()
        self.meter.attach_tracer(self.tracer)
        self._wire_acc = self._zero_wire()
        self.step_idx = 0
        self.decode_steps = 0
        self.prefill_count = 0
        self.rejected = 0
        self.tokens_out = 0
        self._occupancy_sum = 0.0

    # ------------------------------------------------------------ driver
    def run(self, requests: Sequence[Request], *,
            max_steps: int = 100_000,
            on_step=None) -> Dict[str, Any]:
        """Drive a full (arrival-sorted) request trace to completion.
        Deterministic in (engine state, trace): scheduling decisions depend
        only on arrival steps and queue/slot order. `on_step`
        (engine_step_idx -> None) fires after every step."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        finished: List[Finished] = []
        t0 = time.perf_counter()
        i = 0
        while (i < len(pending) or not self.idle):
            while i < len(pending) and pending[i].arrival <= self.step_idx:
                self.submit(pending[i])
                i += 1
            finished.extend(self.step())
            if on_step is not None:
                on_step(self.step_idx)
            if self.step_idx > max_steps:
                raise RuntimeError(f"workload did not drain in "
                                   f"{max_steps} engine steps")
        wall = time.perf_counter() - t0
        return self.stats(finished, wall)

    def live_stats(self) -> Dict[str, Any]:
        """Counters for mid-run polling; the wire numbers reflect the last
        flush, not the in-flight accumulator."""
        return {
            "step_idx": self.step_idx,
            "rejected": self.rejected,
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
            "prefills": self.prefill_count,
            "occupancy": self._occupancy_sum / max(1, self.decode_steps),
            "wire_bytes": self.meter.as_dict(),
        }

    def stats(self, finished: List[Finished], wall_s: float,
              ) -> Dict[str, Any]:
        self._flush_wire()
        lat = sorted(f.latency_s for f in finished) or [0.0]

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "finished": finished,
            "n_finished": len(finished),
            "rejected": self.rejected,
            "tokens_out": self.tokens_out,
            "wall_s": wall_s,
            "tok_per_s": self.tokens_out / max(wall_s, 1e-9),
            "p50_latency_s": pct(0.50),
            "p99_latency_s": pct(0.99),
            "occupancy": (self._occupancy_sum
                          / max(1, self.decode_steps)),
            "decode_steps": self.decode_steps,
            "prefills": self.prefill_count,
            "wire_bytes": self.meter.as_dict(),
            "wire_per_token": self.meter.per_token(self.tokens_out),
        }
