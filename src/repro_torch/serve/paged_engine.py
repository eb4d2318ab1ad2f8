"""PagedServeEngine: the paged-KV-cache serving engine.

The port of `repro/serve/paged_engine.py`. The dense `ServeEngine` gives
every slot a full `max_seq` KV window up front, so concurrent slots cap out
on device memory long before compute does. This engine replaces the
(slot, window) cache with a PAGE POOL (`SplitModel.init_paged_cache`):
physical pages of `page_size` tokens, a host-side refcounting allocator
(`paging.PagePool`), and a per-slot BLOCK TABLE mapping logical blocks to
physical pages. Decode attends through the tables
(`paged_decode_attention`: the plain gather on the CPU, the Hopper kernel on
the card); prefill stays dense — a request prefills into a batch=1 scratch
cache and only its pages are scattered into the pool.

Three features stack on the tables:

* **Page-granular admission** — a request needs ceil(total/page_size) pages,
  not a whole window; `_window_check` rounds up to `capacity =
  n_blocks_max * page_size >= max_seq`, and `_can_admit` holds the queue's
  head (without dropping it) while the pool lacks pages.
* **Copy-on-write shared prefixes** — with `shared_prefix` tokens
  configured, the common [soft prompt | shared prefix] KV is prefilled ONCE
  per tenant (the soft prompt makes prefix KV tenant-specific) and its
  fully-covered pages are refcount-shared into every sharer's table. The
  partially-covered boundary page is a read-only master: a joining slot
  copies it into a private page before writing past the prefix — exactly
  one page copy per join. When the last sharer retires, the entry is
  evicted and its pages cascade back to the pool.
* **Chunked prefill** — `prefill_chunk` streams long prompts in pieces: the
  first chunk embeds the soft prompt (`make_tenant_prefill_step`), every
  later chunk runs write-then-attend at absolute positions
  (`make_chunk_continue_step`).

Paging is MEMORY-ONLY: wire accounting is identical to the dense engine
step for step, except that a shared prefix honestly meters FEWER prefill
bytes — its smashed tensors cross the wire once per tenant instead of once
per request.

Safety invariants (see paging.py): retired slots' table rows are scrubbed
to the scratch page so their in-flight (discarded) decode writes never
touch a live page; unallocated table entries point at the null page whose
positions stay -1, masking exactly like empty cache slots.

On a mesh (see `ServeEngine`) the pool's kv heads are sharded over
'model' (`cache_pspecs(paged=True)`: the page axis stays replicated over
'data', as any table may point at any page), and copy-on-write copies,
slot gathers and scatters run on every rank's local pool alike. With
'data' > 1 every 'data' row holds the whole pool and runs the whole
batch, as the JAX engine's paged steps take every operand but the pool
replicated; no page is mapped to a rank.

Differences from the JAX engine, none of which changes a token or a byte:
the pool is written in place by the steps and the helpers below
(the JAX engine donates it into jitted functions); every prefill fills a
fresh blank scratch cache, because the port's prefill writes its cache in
place; the block tables go to the device once per decode dispatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.split import SplitModel
from repro_torch.serve.bank import TenantBank
from repro_torch.serve.engine import (Finished, ServeConfig, ServeEngine,
                                      _SlotState)
from repro_torch.serve.paging import PagePool, PrefixEntry
from repro_torch.serve.steps import (make_chunk_continue_step,
                                     make_paged_decode_step,
                                     make_paged_multi_decode_step,
                                     make_step_shardings)
from repro_torch.serve.workload import Request


@dataclass(frozen=True)
class PagedServeConfig(ServeConfig):
    page_size: int = 16         # tokens per physical KV page
    n_pages: Optional[int] = None   # pool size incl. the 2 reserved pages;
    #                                 None = n_slots full windows (dense-
    #                                 equivalent memory, for identity tests;
    #                                 serving shrinks it)
    shared_prefix: Optional[Tuple[int, ...]] = None   # common base-prompt
    #                                 token ids prepended to every request;
    #                                 None/() disables prefix sharing
    prefill_chunk: Optional[int] = None   # stream prompts in pieces of this
    #                                 many tokens; None = monolithic prefill

    @property
    def prefix_tokens(self) -> Tuple[int, ...]:
        return tuple(self.shared_prefix or ())


class PagedServeEngine(ServeEngine):
    def __init__(self, model: SplitModel, shared_params, bank: TenantBank,
                 cfg: PagedServeConfig, *, collect_logits: bool = False,
                 mesh=None, tracer=None, device="cuda"):
        reason = model.paged_cache_unsupported()
        if reason is not None:
            raise ValueError(f"{model.cfg.name}: paged serving unsupported "
                             f"— {reason}")
        if cfg.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {cfg.page_size}")
        if cfg.prefill_chunk is not None and cfg.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {cfg.prefill_chunk}")
        ps = cfg.page_size
        self.nb_max = -(-cfg.max_seq // ps)         # blocks per slot table
        self.capacity = self.nb_max * ps            # page-rounded window
        self.n_pages = (cfg.n_pages if cfg.n_pages is not None
                        else cfg.n_slots * self.nb_max + PagePool.N_RESERVED)
        super().__init__(model, shared_params, bank, cfg,
                         collect_logits=collect_logits, mesh=mesh,
                         tracer=tracer, device=device)
        model = self.model
        self.pool_alloc = PagePool(self.n_pages, ps, tracer=self.tracer)
        self.pool = model.init_paged_cache(self.n_pages, ps,
                                           dtype=torch.float32,
                                           device=self.device)
        # idle rows point every block at the SCRATCH page: idle slots keep
        # decoding for shape stability and their (discarded) writes must
        # never land on NULL — that page's positions stay -1 forever so
        # active slots' unallocated table entries read as empty
        self._tables = np.full((cfg.n_slots, self.nb_max),
                               PagePool.SCRATCH_PAGE, np.int32)
        self._prefix: Dict[int, PrefixEntry] = {}   # tenant -> entry
        self._slot_shared: Dict[int, int] = {}      # slot -> sharing tenant

        self._paged_decode = make_paged_decode_step(model, dtype=cfg.dtype)
        self._paged_multi: Dict[int, Any] = {}
        self._continue = make_chunk_continue_step(model, dtype=cfg.dtype)

        # paged accounting
        self.page_copies = 0        # COW boundary-page copies
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefill_chunks = 0     # continuation-chunk dispatches
        self.prefill_step_calls = 0  # first-chunk/monolithic prefill calls
        self.peak_pages = 0

    def _alloc_cache(self):
        return None   # the page pool replaces the dense shared cache

    def _mesh_specs(self, model, whole):
        return make_step_shardings(
            self.mesh, whole,
            blank=model.blank_slot_cache(self.capacity, device="meta"),
            pool=model.init_paged_cache(self.n_pages, self.cfg.page_size,
                                        device="meta"))

    # ------------------------------------------------------ pool helpers
    def _blank(self):
        """A fresh capacity-wide batch=1 scratch cache (prefill writes it
        in place, so every prefill takes a new one)."""
        return self.model.blank_slot_cache(self.capacity,
                                           dtype=torch.float32,
                                           device=self.device)

    def _gather_slot(self, table_row: np.ndarray, valid_len: int):
        """One slot's pages as a dense batch=1 cache (width = capacity),
        with positions beyond `valid_len` cleaned to -1 — freshly allocated
        pages carry STALE positions from their previous owner, and a stale
        valid-looking position would unmask garbage KV."""
        dense = self.model.paged_gather(
            self.pool, torch.as_tensor(table_row[None], device=self.device))
        for seg in dense.values():
            for stack in seg["stack"].values():
                stack["positions"][..., valid_len:] = -1
        return dense

    def _scatter_slot(self, single, table_row: np.ndarray,
                      write_mask: np.ndarray) -> None:
        """Masked write-back of a slot's dense cache into its pages; masked
        blocks (shared prefix pages, unallocated entries) land on the
        scratch page."""
        self.model.paged_scatter_slot(
            self.pool, single, torch.as_tensor(table_row, device=self.device),
            torch.as_tensor(write_mask, device=self.device),
            PagePool.SCRATCH_PAGE)

    # ----------------------------------------------------------- sizing
    def _prefix_len(self) -> int:
        """Soft prompt + shared prefix tokens (0 when sharing is off)."""
        F = self.cfg.prefix_tokens
        if not F:
            return 0
        return self.model.split.prompt_len + len(F)

    def _total_len(self, req: Request) -> int:
        base = len(req.tokens) + self.model.split.prompt_len + req.max_new
        return base + len(self.cfg.prefix_tokens)

    def _n_blocks(self, req: Request) -> int:
        return -(-self._total_len(req) // self.cfg.page_size)

    def _window_check(self, req: Request) -> None:
        """Page-granular admission: a request fits iff its total length
        fits `capacity` = nb_max * page_size, which ROUNDS `max_seq` UP to
        whole pages — a request the dense window rejects by a few tokens is
        admissible when those tokens fit the last page's slack."""
        total = self._total_len(req)
        if total > self.capacity:
            raise ValueError(
                f"request {req.rid}: prompt({len(req.tokens)}) + soft "
                f"prompt({self.model.split.prompt_len}) + shared "
                f"prefix({len(self.cfg.prefix_tokens)}) + "
                f"new({req.max_new}) = {total} exceeds the paged capacity "
                f"{self.capacity} ({self.nb_max} pages x "
                f"{self.cfg.page_size})")

    def _pages_needed(self, req: Request) -> int:
        """Free pages the head-of-line request needs to admit NOW."""
        nb_total = self._n_blocks(req)
        L_pre = self._prefix_len()
        if not L_pre:
            return nb_total
        n_full = L_pre // self.cfg.page_size
        boundary = 1 if L_pre % self.cfg.page_size else 0
        entry = self._prefix.get(req.tenant)
        if entry is None:          # miss: the entry's own pages too
            return nb_total + boundary
        return nb_total - n_full   # hit: share full pages, alloc the rest

    def _can_admit(self, req: Request) -> bool:
        return self.pool_alloc.n_free >= self._pages_needed(req)

    def _note_alloc(self) -> None:
        self.peak_pages = max(self.peak_pages, self.pool_alloc.n_used)

    # ----------------------------------------------------------- prefill
    def _run_chunks(self, tail, tokens_np, cache, start: int):
        """Continuation-prefill `tokens_np` into `cache` beginning at
        absolute position `start`, in `prefill_chunk`-sized pieces."""
        c = self.cfg.prefill_chunk or len(tokens_np)
        tok = logits = None
        for i in range(0, len(tokens_np), c):
            chunk = tokens_np[i:i + c]
            with self.tracer.span("serve.chunk", level=2,
                                  start=start + i, n_tokens=len(chunk)):
                tok, logits, cache, wb = self._continue(
                    self.shared, tail,
                    {"tokens": torch.as_tensor(chunk[None],
                                               device=self.device)},
                    cache, torch.tensor([start + i], dtype=torch.int32,
                                        device=self.device))
            self._absorb_wire(wb)
            self.prefill_chunks += 1
        return tok, logits, cache

    def _run_prefill(self, tail, prompt, tokens_np):
        """Full prefill of `tokens_np` (soft prompt embedded) into a blank
        capacity-wide scratch cache, chunked if configured. Returns
        (next_tok, last_logits, cache)."""
        c = self.cfg.prefill_chunk
        p = self.model.split.prompt_len
        first = tokens_np if (c is None or c >= len(tokens_np)) \
            else tokens_np[:c]
        self.prefill_step_calls += 1
        tok, logits, cache, wb = self._prefill(
            self.shared, tail, prompt,
            {"tokens": torch.as_tensor(first[None], device=self.device)},
            self._blank())
        self._absorb_wire(wb)
        if len(first) == len(tokens_np):
            return tok, logits, cache
        self.prefill_chunks += 1     # the first chunk counts as a chunk
        return self._run_chunks(tail, tokens_np[len(first):], cache,
                                p + len(first))

    def _build_prefix_entry(self, tenant: int) -> PrefixEntry:
        """MISS: prefill [soft prompt | shared prefix] once for this tenant
        into entry-owned pages. The scratch cache starts blank, so the
        boundary page's positions beyond the prefix are -1 by construction
        — the master needs no sanitizing before sharers copy it."""
        ps = self.cfg.page_size
        F = np.asarray(self.cfg.prefix_tokens, np.int32)
        L_pre = self._prefix_len()
        n_full, rem = divmod(L_pre, ps)
        _, _, cache = self._run_prefill(
            self.bank.tail(tenant), self.bank.prompt(tenant), F)
        n_entry = n_full + (1 if rem else 0)
        pages = self.pool_alloc.alloc_many(n_entry)
        self._note_alloc()
        table = np.full((self.nb_max,), PagePool.NULL_PAGE, np.int32)
        table[:n_entry] = pages
        mask = np.zeros((self.nb_max,), bool)
        mask[:n_entry] = True
        self._scatter_slot(cache, table, mask)
        entry = PrefixEntry(full_pages=pages[:n_full],
                            boundary_page=pages[n_full] if rem else None,
                            prefix_len=L_pre)
        self._prefix[tenant] = entry
        return entry

    # ---------------------------------------------------------- admission
    @torch.no_grad()
    def _admit_one(self, req: Request) -> Optional[Finished]:
        nb_total = self._n_blocks(req)
        tail = self.bank.tail(req.tenant)
        prompt = self.bank.prompt(req.tenant)
        tokens_np = np.asarray(req.tokens, np.int32)
        slot = self._free.pop()
        table = np.full((self.nb_max,), PagePool.NULL_PAGE, np.int32)
        mask = np.zeros((self.nb_max,), bool)
        L_pre = self._prefix_len()

        if not L_pre:
            # plain paged admission: private pages for the whole lifetime,
            # dense prefill into blank scratch, scatter every block
            pages = self.pool_alloc.alloc_many(nb_total)
            self._note_alloc()
            table[:nb_total] = pages
            mask[:nb_total] = True
            tok, logits, cache = self._run_prefill(tail, prompt, tokens_np)
            next_pos = len(req.tokens) + self.model.split.prompt_len
        else:
            entry = self._prefix.get(req.tenant)
            if entry is None:
                entry = self._build_prefix_entry(req.tenant)
                self.prefix_misses += 1
                self.tracer.event("serve.prefix_miss", level=2,
                                  tenant=req.tenant,
                                  prefix_len=entry.prefix_len)
            else:
                self.prefix_hits += 1
                entry.hits += 1
                self.tracer.event("serve.prefix_hit", level=2,
                                  tenant=req.tenant, hits=entry.hits)
            n_full = len(entry.full_pages)
            for j, pg in enumerate(entry.full_pages):
                table[j] = self.pool_alloc.share(pg)
            priv = self.pool_alloc.alloc_many(nb_total - n_full)
            self._note_alloc()
            table[n_full:nb_total] = priv
            mask[n_full:nb_total] = True     # shared full pages stay masked
            if entry.boundary_page is not None:
                # COW divergence: the sharer's first writable page starts
                # as a copy of the read-only boundary master
                self.model.paged_copy_page(self.pool, entry.boundary_page,
                                           priv[0])
                self.page_copies += 1
                self.tracer.event("page.cow_copy", level=2,
                                  src=int(entry.boundary_page),
                                  dst=int(priv[0]), tenant=req.tenant)
            entry.sharers += 1
            self._slot_shared[slot] = req.tenant
            cache = self._gather_slot(table, L_pre)
            tok, logits, cache = self._run_chunks(tail, tokens_np, cache,
                                                  L_pre)
            next_pos = L_pre + len(req.tokens)

        self._tables[slot] = table
        self._scatter_slot(cache, table, mask)
        self.prefill_count += 1
        self.tokens_out += 1
        self.tracer.event("serve.admit", rid=req.rid, tenant=req.tenant,
                          slot=slot, n_blocks=nb_total,
                          pages_in_use=self.pool_alloc.n_used)

        st = _SlotState(req=req,
                        t_submit=self._t_enqueue.pop(
                            req.rid, time.perf_counter()),
                        next_pos=next_pos)
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

    # ---------------------------------------------------------- lifecycle
    def _release_slot(self, slot: int) -> None:
        """Retire a slot: drop one reference per owned page (shared prefix
        pages survive while other sharers hold them), evict the tenant's
        prefix entry when its last sharer leaves, and scrub the table row
        to the scratch page so the slot's in-flight decode writes (it keeps
        computing for shape stability) land in garbage, never a live or
        freshly reallocated page."""
        for pid in self._tables[slot]:
            if int(pid) >= PagePool.N_RESERVED:
                self.pool_alloc.free(int(pid))
        tenant = self._slot_shared.pop(slot, None)
        if tenant is not None:
            entry = self._prefix[tenant]
            entry.sharers -= 1
            if entry.sharers == 0:
                for pg in entry.full_pages:
                    self.pool_alloc.free(pg)
                if entry.boundary_page is not None:
                    self.pool_alloc.free(entry.boundary_page)
                del self._prefix[tenant]
        self._tables[slot] = PagePool.SCRATCH_PAGE
        self._tokens[slot] = 0
        self._pos[slot] = 0
        self._free.append(slot)

    # ------------------------------------------------------------- decode
    def _get_paged_multi(self, n_steps: int):
        fn = self._paged_multi.get(n_steps)
        if fn is None:
            fn = make_paged_multi_decode_step(
                self.model, n_steps, dtype=self.cfg.dtype,
                with_logits=self.collect_logits)
            self._paged_multi[n_steps] = fn
        return fn

    @torch.no_grad()
    def _dispatch_decode(self, remaining: np.ndarray, n_eff: int):
        tables = torch.as_tensor(self._tables, device=self.device)
        tokens = torch.tensor(self._tokens, device=self.device)
        pos = torch.tensor(self._pos, device=self.device)
        if n_eff <= 1:
            toks, logits, self.pool, wb = self._paged_decode(
                self.shared, self.bank, self._tenants, tokens, pos,
                remaining > 0, self.pool, tables)
            return toks[None], logits[None], wb
        toks, logits, self.pool, wb = self._get_paged_multi(n_eff)(
            self.shared, self.bank, self._tenants, tokens, pos, remaining,
            self.pool, tables)
        return toks, logits, wb

    # -------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        super().reset_stats()
        self.page_copies = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefill_chunks = 0
        self.prefill_step_calls = 0
        self.peak_pages = 0

    def live_stats(self) -> Dict[str, Any]:
        out = super().live_stats()
        out.update(self._page_stats())
        return out

    def stats(self, finished: List[Finished], wall_s: float,
              ) -> Dict[str, Any]:
        out = super().stats(finished, wall_s)
        out.update(self._page_stats())
        return out

    def _page_stats(self) -> Dict[str, Any]:
        joins = self.prefix_hits + self.prefix_misses
        return {
            "page_size": self.cfg.page_size,
            "n_pages": self.pool_alloc.n_pages,
            "pages_in_use": self.pool_alloc.n_used,
            "peak_pages": self.peak_pages,
            "page_copies": self.page_copies,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_ratio": self.prefix_hits / joins if joins else 0.0,
            "prefill_chunks": self.prefill_chunks,
        }
