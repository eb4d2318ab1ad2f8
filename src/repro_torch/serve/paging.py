"""Host-side page-pool bookkeeping for the paged serving engine.

The device side of paging is a pool pytree (`SplitModel.init_paged_cache`)
whose page axis replaces the dense cache's (slot, window) pair; this module
owns the HOST side: which physical page belongs to whom.

`PagePool` is a refcounting free-list allocator over page ids. Two ids are
reserved and never allocated:

  * ``NULL_PAGE`` (0) — the target of every *unallocated* block-table entry.
    Its positions row stays -1 forever, so gathers through it read "empty"
    and attention masks it out. Nothing ever writes it.
  * ``SCRATCH_PAGE`` (1) — the garbage dump. Idle slots' decode writes and
    masked scatter blocks are redirected here so the jitted steps stay
    shape-stable without ever touching a live page. Nothing ever reads it
    (only idle slots, whose outputs the engine discards).

Invariants (property-tested in tests/test_paged_alloc.py):
  * a page is free XOR allocated; alloc/free in reverse order restores the
    free-list exactly (LIFO);
  * refcount(page) > 1 only for shared-prefix pages (`share`); a private
    page's refcount is exactly 1;
  * refcount hits zero iff the page returns to the free list;
  * exhaustion raises `PagePoolExhausted` loudly — pages are never aliased.

`PrefixEntry` tracks one tenant's shared-prefix pages: the fully-covered
pages are refcount-shared across every slot serving that tenant, and the
partially-covered boundary page (if the prefix length is not page-aligned)
is kept as a read-only master that sharers copy-on-write. The entry holds
one reference per page of its own; when the last sharer retires, the entry
is evicted and its references drop, cascading the pages back to the pool.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


class PagePoolExhausted(RuntimeError):
    """The pool has no free pages — raised instead of aliasing a live one."""


class PagePool:
    NULL_PAGE = 0
    SCRATCH_PAGE = 1
    N_RESERVED = 2

    def __init__(self, n_pages: int, page_size: int, *, tracer=None):
        if n_pages < self.N_RESERVED + 1:
            raise ValueError(f"pool needs > {self.N_RESERVED} pages "
                             f"(2 reserved), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free-list: low page ids are handed out first
        self._free: List[int] = list(range(n_pages - 1, self.N_RESERVED - 1,
                                           -1))
        self._refcount = [0] * n_pages
        # flight-recorder hook (repro.obs): step-level page.alloc/share/
        # free events when attached; pure bookkeeping, never device state
        self.tracer = tracer

    # ------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - self.N_RESERVED - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._refcount[pid]

    def free_list(self) -> List[int]:
        return list(self._free)

    # ----------------------------------------------------------- mutation
    def alloc(self) -> int:
        """One fresh private page (refcount 1)."""
        if not self._free:
            raise PagePoolExhausted(
                f"page pool exhausted: {self.n_used} pages live, none free")
        pid = self._free.pop()
        self._refcount[pid] = 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("page.alloc", level=2, page=pid,
                              n_free=len(self._free))
        return pid

    def alloc_many(self, n: int) -> List[int]:
        """n pages, all-or-nothing: exhaustion allocates none."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted: need {n} pages, {self.n_free} free")
        return [self.alloc() for _ in range(n)]

    def share(self, pid: int) -> int:
        """One more owner for an allocated (shared-prefix) page."""
        if self._refcount[pid] <= 0:
            raise ValueError(f"share of unallocated page {pid}")
        self._refcount[pid] += 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("page.share", level=2, page=pid,
                              refcount=self._refcount[pid])
        return pid

    def free(self, pid: int) -> bool:
        """Drop one reference; the page returns to the pool iff the count
        hits zero. Returns True when the page was actually released."""
        if pid < self.N_RESERVED:
            raise ValueError(f"free of reserved page {pid}")
        if self._refcount[pid] <= 0:
            raise ValueError(f"double free of page {pid}")
        self._refcount[pid] -= 1
        released = self._refcount[pid] == 0
        if released:
            self._free.append(pid)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("page.free", level=2, page=pid,
                              released=released,
                              n_free=len(self._free))
        return released


@dataclass
class PrefixEntry:
    """One tenant's cached shared-prefix pages (soft prompt + base prompt).

    `full_pages` cover whole pages of prefix KV and are refcount-shared into
    every sharer's block table. `boundary_page` holds the partial last page
    (prefix length not page-aligned) as a read-only master: each sharer
    copies it into a private page before writing past the prefix (the COW
    divergence copy). The entry itself holds one reference per page; it is
    evicted — references dropped, pages released — when `sharers` returns
    to zero."""
    full_pages: List[int]
    boundary_page: Optional[int]
    prefix_len: int                      # soft prompt + prefix tokens
    sharers: int = 0
    hits: int = field(default=0)
