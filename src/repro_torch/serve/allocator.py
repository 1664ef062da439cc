"""Free-list page allocator for the paged KV cache (port of
``repro/serve/allocator.py``, pure Python, unchanged).

Pure host-side bookkeeping: physical pages live in device pools
(``repro_torch.serve.runner.init_pages``); this class decides who owns which page
index.  Page **0 is reserved as the trash page** — it is never handed out,
so block-table slots of inactive/padded decode rows can all point at it:
their (masked, never-read) writes land somewhere harmless and can never
clobber a live sequence's KV.

Pages are ref-counted so prefix pages can be shared between sequences
(``share`` bumps, ``free`` decrements and only returns a page to the free
list at refcount 0).  The hypothesis property tests in
``tests/test_torch_serve.py`` pin conservation: every page is allocated at most
once at a time, block tables stay disjoint (modulo sharing), and
``free + live == capacity`` after any alloc/free interleaving.
"""
from __future__ import annotations

TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """Raised when an allocation cannot be satisfied."""


class PageAllocator:
    """Free-list allocator over ``num_pages`` physical pages of
    ``page_size`` tokens each (page 0 reserved)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently freed pages are re-used first (warm)
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs = {}                       # page -> refcount (allocated)

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._refs)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (at least one)."""
        return max(1, -(-n_tokens // self.page_size))

    # ----------------------------------------------------------- mutation
    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` pages (refcount 1 each) or raise :class:`OutOfPages`."""
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"of {self.num_pages - 1} allocatable")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: list[int]) -> list[int]:
        """Bump refcounts on already-allocated pages (shared prefix).

        Atomic: an unknown page raises :class:`KeyError` **before** any
        refcount moves, so a bad call can never half-apply."""
        missing = sorted({p for p in pages if p not in self._refs})
        if missing:
            raise KeyError(
                f"cannot share unallocated page(s) {missing}: sharing a "
                "page nobody owns would hand out dangling KV")
        for p in pages:
            self._refs[p] += 1
        return list(pages)

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; return refcount-0 pages to the pool.

        Atomic: a double free or unknown page raises :class:`KeyError`
        **before** the ledger is touched — duplicates inside one call are
        counted against the refcount too, so ``free([p, p])`` of a
        singly-referenced page cannot corrupt the free list."""
        drops: dict[int, int] = {}
        for p in pages:
            drops[p] = drops.get(p, 0) + 1
        bad = sorted(p for p, n in drops.items()
                     if self._refs.get(p, 0) < n)
        if bad:
            raise KeyError(
                f"double free / unknown page(s) {bad}: freeing more "
                "references than exist would corrupt the refcount ledger")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
