"""Paged block-table KV cache: the host-side page allocator.

The contiguous serving cache gives every decode slot a full ``max_seq``
region, so device memory — not compute — caps the concurrent-request
count. The paged layout replaces the per-slot regions with one shared
pool of fixed-size PAGES per layer: ``(n_pages, page_size, Hkv, hd)``
instead of ``(n_slots, max_seq, Hkv, hd)``. Each request owns just
enough pages for its own budget (``prompt_len + max_new`` tokens), a
block table maps its logical positions to physical pages, and pages
return to the free list the moment the request retires (eos / max_new).
``max_seq`` becomes a per-request *budget* instead of a per-slot
*allocation*: at equal cache memory the pool admits
``~max_seq / mean_request_budget`` times more live requests.

Page id 0 is the NULL page. It is never handed out: block-table rows of
free slots are all-zero, and writes from dead rows / tail-pad tokens are
steered into it, so the device-side scatter needs no branches. Reads
through unmapped table entries gather the null page and are masked by
position validity (``index <= pos``) exactly like stale contiguous-cache
rows were.

The allocator enforces its ownership invariants DEFENSIVELY: freeing a
slot that owns nothing and handing out a page that is already owned both
raise :class:`AllocatorError` instead of silently corrupting the free
list — a double-free that re-lists an owned page would hand the same
physical page to two requests and cross-contaminate their K/V.

This module is pure host-side bookkeeping (plain Python ints), the
port's own copy of ``repro.serving.paged_cache``: the same LIFO free list,
so both packages hand out the same page ids, and the same raises. The
device-side gather/scatter lives in ``models/attention.py`` and the engine
hands the block tables to the serving steps as ``(n_slots, max_blocks)``
operands.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

NULL_PAGE = 0


class AllocatorError(RuntimeError):
    """Page-ownership invariant violation (double free, double ownership,
    free of an empty slot). Raised *before* the free list is corrupted."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache rows (ceil division)."""
    return -(-max(0, n_tokens) // page_size)


@dataclasses.dataclass
class PagedCacheConfig:
    """Geometry of the shared pool. ``max_blocks`` bounds one request's
    block table (= max_seq / page_size); ``n_pages`` includes the null
    page, so the allocatable budget is ``n_pages - 1``."""
    n_pages: int
    page_size: int
    max_blocks: int

    @property
    def capacity_tokens(self) -> int:
        return (self.n_pages - 1) * self.page_size


class BlockAllocator:
    """Free-list page allocator with per-slot ownership.

    Allocation is all-at-once at admission (the request's full
    ``prompt + max_new`` budget), so a live request can never starve
    mid-decode; reclaim is all-at-once at retire. A LIFO free list keeps
    reuse hot and makes fragmentation a non-issue — pages are fixed-size
    and fungible, any free page serves any block-table entry.

    Every mutation checks the ownership invariant (``used + free ==
    n_pages - 1``, no page owned twice, the null page never leaves) and
    raises :class:`AllocatorError` on violation rather than corrupting
    the free list silently.
    """

    def __init__(self, n_pages: int, page_size: int, max_blocks: int):
        # real exceptions, not asserts: the serving loop must keep these
        # invariants even under python -O
        if n_pages < 2:
            raise ValueError("need at least the null page + one real page")
        if page_size < 1 or max_blocks < 1:
            raise ValueError(f"page_size={page_size}, "
                             f"max_blocks={max_blocks} must be >= 1")
        self.cfg = PagedCacheConfig(n_pages, page_size, max_blocks)
        # page 0 reserved as the null page
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}
        self._owner: Dict[int, int] = {}          # page -> owning slot

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return sum(len(v) for v in self._owned.values())

    def pages_needed(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.cfg.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        """Whether a request with an ``n_tokens`` budget fits right now:
        enough free pages AND within one block table's reach."""
        need = self.pages_needed(n_tokens)
        return 0 < need <= min(self.free_pages, self.cfg.max_blocks)

    def owns(self, slot: int) -> bool:
        return slot in self._owned

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, []))

    # -- mutation -----------------------------------------------------------

    def allocate(self, slot: int, n_tokens: int) -> List[int]:
        """Claim the full page budget for ``slot``; returns the page ids in
        block-table order. Raises if the slot already owns pages or the
        budget does not fit (callers gate on ``can_admit``)."""
        if slot in self._owned:
            raise AllocatorError(f"slot {slot} already owns pages")
        need = self.pages_needed(n_tokens)
        if need > self.cfg.max_blocks:
            raise ValueError(
                f"budget {n_tokens} tokens needs {need} pages "
                f"> max_blocks {self.cfg.max_blocks}")
        if need > self.free_pages:
            raise ValueError(
                f"budget {n_tokens} tokens needs {need} pages, "
                f"only {self.free_pages} free")
        pages = []
        for _ in range(need):
            p = self._free.pop()
            if p == NULL_PAGE or p in self._owner:
                # a corrupted free list (double-listed / null page) must
                # surface before the page is handed to a second request
                self._free.extend(reversed(pages))
                raise AllocatorError(
                    f"free list corrupt: page {p} "
                    f"{'is the null page' if p == NULL_PAGE else 'already owned by slot %d' % self._owner.get(p, -1)}")
            self._owner[p] = slot
            pages.append(p)
        self._owned[slot] = pages
        return pages

    def free_slot(self, slot: int) -> int:
        """Reclaim every page ``slot`` owns (slot free / eos); returns how
        many were reclaimed. Freeing a slot that owns nothing raises
        :class:`AllocatorError` — it is always a double free or a stale
        slot id, and silently ignoring it is how ownership bugs hide."""
        if slot not in self._owned:
            raise AllocatorError(
                f"free_slot({slot}): slot owns no pages (double free or "
                f"stale slot id)")
        pages = self._owned.pop(slot)
        for p in pages:
            if self._owner.get(p) != slot:
                raise AllocatorError(
                    f"free_slot({slot}): page {p} owner map disagrees "
                    f"(owned by {self._owner.get(p)})")
            del self._owner[p]
        self._free.extend(pages)
        return len(pages)

    # -- migration (disaggregated prefill/decode handoff) -------------------

    def export_pages(self, slot: int) -> List[int]:
        """Detach ``slot``'s pages for MIGRATION to another pool: returns
        the page ids in block-table order and reclaims them (they join this
        pool's free list immediately, so the exporting worker's capacity is
        back the moment the handoff leaves). The caller must copy the page
        CONTENTS out of the device pool *before* calling this — after it
        returns, the ids may be handed straight to the next admission."""
        if slot not in self._owned:
            raise AllocatorError(
                f"export_pages({slot}): slot owns no pages "
                f"(double export or stale slot id)")
        pages = list(self._owned[slot])
        self.free_slot(slot)
        return pages

    def import_pages(self, slot: int, pages: Sequence[int],
                     block_table: Sequence[int]) -> List[int]:
        """Admit a migrated request into THIS pool: allocate one fresh
        destination page per exported source id, owned by ``slot``. The
        handoff carries the request's FULL ``prompt + max_new`` budget
        (that is what the exporting pool allocated at admission), so the
        all-at-once admission invariant — a live request can never starve
        mid-decode — survives the migration. ``pages`` and ``block_table``
        both come from the exporting pool; the table's non-null prefix
        must equal ``pages``, so a torn handoff (metadata stitched from
        two different exports) fails HERE, before any page content lands.
        Returns the destination ids positionally matched to ``pages``; the
        caller copies page contents src→dst and writes its own table row.
        """
        pages = [int(p) for p in pages]
        table = [int(p) for p in list(block_table)]
        if not pages:
            raise AllocatorError(f"import_pages({slot}): empty page list")
        if NULL_PAGE in pages:
            raise AllocatorError(
                f"import_pages({slot}): null page in the handoff")
        if table[:len(pages)] != pages or \
                any(p != NULL_PAGE for p in table[len(pages):]):
            raise AllocatorError(
                f"import_pages({slot}): block table {table} does not "
                f"describe exported pages {pages} (torn handoff)")
        return self.allocate(slot, len(pages) * self.cfg.page_size)

    # -- invariants / snapshot ---------------------------------------------

    def check(self):
        """Assert the full ownership invariant; raises AllocatorError."""
        total = self.cfg.n_pages - 1
        if self.used_pages + self.free_pages != total:
            raise AllocatorError(
                f"used {self.used_pages} + free {self.free_pages} "
                f"!= total {total}")
        seen: Dict[int, str] = {}
        for p in self._free:
            if p == NULL_PAGE:
                raise AllocatorError("null page on the free list")
            if p in seen:
                raise AllocatorError(f"page {p} listed free twice")
            seen[p] = "free"
        for slot, pages in self._owned.items():
            for p in pages:
                if p == NULL_PAGE:
                    raise AllocatorError(f"null page owned by slot {slot}")
                if p in seen:
                    raise AllocatorError(
                        f"page {p} owned by slot {slot} but also {seen[p]}")
                if self._owner.get(p) != slot:
                    raise AllocatorError(f"owner map stale for page {p}")
                seen[p] = f"owned by {slot}"

    def snapshot_state(self) -> Dict:
        """JSON-serializable state for the engine's crash snapshots."""
        return {"free": list(self._free),
                "owned": {str(s): list(p) for s, p in self._owned.items()}}

    def restore_state(self, state: Dict):
        """Rebuild free list + ownership from :meth:`snapshot_state`."""
        self._free = [int(p) for p in state["free"]]
        self._owned = {int(s): [int(p) for p in pages]
                       for s, pages in state["owned"].items()}
        self._owner = {p: s for s, pages in self._owned.items()
                       for p in pages}
        self.check()
