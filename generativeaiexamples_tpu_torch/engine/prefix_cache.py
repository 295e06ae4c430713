"""Host-side prefix caching over the paged KV pool.

Port of ``generativeaiexamples_tpu/engine/prefix_cache.py``. Every RAG
request re-sends the same chat template and system prompt, and repeated
queries re-send the same retrieved chunks, so re-prefilling from token 0
wastes exactly the tokens the cache can skip.

Design (page-granular, immutable, no copy-on-write), as there:

  * **Unit of sharing = one full physical page.** A page's KV is a pure
    function of the token prefix up to its end, so a **chain hash**
    ``h_i = H(h_{i-1}, tokens[i*ps:(i+1)*ps])`` identifies it. Only fully
    covered pages are shared: the page decode appends to is always private,
    so shared pages are immutable and a diverging request simply stops
    matching the chain one page earlier.
  * **Refcounts, not ownership.** ``free`` drops one owner; a cached page
    at refcount 0 parks in an LRU of evictable pages, still valid for the
    next matching admission, and is reclaimed only when the free list runs
    dry. A never-inserted page at refcount 0 returns to the free list.
  * **Write-before-share is dispatch order.** The scheduler inserts a page
    only after the dispatch that writes it was issued; the engine issues on
    one CUDA stream, so any later reader runs after the write.
  * ``seed`` namespaces the chain (``"{epoch}|{adapter}"``): KV depends on
    the weights that produced it.

``chain_hashes`` is byte-identical to the reference's (blake2b-128 over
4-byte little-endian ids, seeded by ``str(seed)``), so the two packages
name the same pages alike. The allocator counts ``prefix_evictions`` and
``prefix_inserted_pages`` into ``core/metrics.REGISTRY``, as there, and
into its integer attributes ``evictions`` and ``inserted_pages``, which
the scheduler folds into its stats.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Sequence

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY


def chain_hashes(ids: Sequence[int], page_size: int, seed=0) -> List[bytes]:
    """Chain hash per fully covered page of ``ids``: h_i commits to every
    token in pages 0..i, so equal h_i means equal token prefix. blake2b-128,
    not Python's ``hash``: a collision would serve another request's KV as
    this prompt's prefix."""
    out: List[bytes] = []
    h = hashlib.blake2b(str(seed).encode(), digest_size=16).digest()
    for i in range(len(ids) // page_size):
        page = ids[i * page_size:(i + 1) * page_size]
        buf = b"".join(int(t).to_bytes(4, "little", signed=True)
                       for t in page)
        h = hashlib.blake2b(h + buf, digest_size=16).digest()
        out.append(h)
    return out


class CachingAllocator:
    """Drop-in for :class:`kv_cache.PageAllocator` with prefix reuse:
    ``alloc``/``free``/``available`` keep the free-list contract (``free``
    means "this owner is done"); ``match`` + ``acquire`` share a cached
    chain at admission, ``insert`` publishes written pages."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: deque = deque(range(1, num_pages))
        self._refs: Dict[int, int] = {}            # page -> live owners (>0)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_to_hash: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref 0, cached
        self.evictions = 0          # cached pages reclaimed by alloc
        self.inserted_pages = 0     # pages published by insert

    @property
    def available(self) -> int:
        """Pages an ``alloc`` could hand out right now (free + evictable)."""
        return len(self._free) + len(self._lru)

    @property
    def cached_pages(self) -> int:
        return len(self._hash_to_page)

    def live_refs(self) -> int:
        return sum(self._refs.values())

    def can_serve(self, n: int, acquired: Sequence[int] = ()) -> bool:
        """Could ``acquire(acquired)`` then ``alloc(n)`` succeed now?
        Acquiring an evictable page takes it out of the LRU, so it stops
        counting toward alloc headroom."""
        in_lru = sum(1 for p in acquired if p in self._lru)
        return len(self._free) + len(self._lru) - in_lru >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n fresh pages (refcount 1 each), evicting the oldest
        LRU-cached pages when the free list runs dry; None (and no change)
        if impossible."""
        if n > len(self._free) + len(self._lru):
            return None
        out: List[int] = []
        for _ in range(n):
            if self._free:
                p = self._free.popleft()
            else:
                p, _ = self._lru.popitem(last=False)
                h = self._page_to_hash.pop(p)
                del self._hash_to_page[h]
                self.evictions += 1
                REGISTRY.counter("prefix_evictions").inc()
            self._refs[p] = 1
            out.append(p)
        return out

    def acquire(self, pages: Iterable[int]) -> None:
        """Add an owner to each page (an admission sharing a matched chain).
        Validates every page before changing any, so a raise leaves no
        half-taken refs."""
        pages = list(pages)
        for p in pages:
            if self._refs.get(p, 0) == 0 and p not in self._lru:
                raise ValueError(f"acquire of unallocated page {p}")
        for p in pages:
            r = self._refs.get(p, 0)
            if r == 0:
                del self._lru[p]
            self._refs[p] = r + 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one owner per page; orphaned cached pages become evictable,
        orphaned uncached pages return to the free list."""
        for p in pages:
            r = self._refs.get(p)
            if r is None:
                raise ValueError(f"freeing unowned page {p}")
            if r > 1:
                self._refs[p] = r - 1
                continue
            del self._refs[p]
            if p in self._page_to_hash:
                self._lru[p] = None
                self._lru.move_to_end(p)
            else:
                self._free.append(p)

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Pages of the longest cached prefix of the chain (no ref taken:
        ``acquire`` the slice actually used, in the same scheduler tick)."""
        pages: List[int] = []
        for h in hashes:
            p = self._hash_to_page.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def insert(self, hashes: Sequence[bytes], pages: Sequence[int]) -> None:
        """Publish written pages under their chain hashes. Idempotent; a
        hash already cached keeps its first page (the duplicate stays
        private and frees normally). Call only after the writing dispatch
        was issued."""
        for h, p in zip(hashes, pages):
            if h in self._hash_to_page:
                continue
            if p in self._page_to_hash:     # page re-used under a new chain
                old = self._page_to_hash.pop(p)
                self._hash_to_page.pop(old, None)
            if self._refs.get(p, 0) == 0 and p not in self._lru:
                raise ValueError(f"insert of unallocated page {p}")
            self._hash_to_page[h] = p
            self._page_to_hash[p] = h
            self.inserted_pages += 1
            REGISTRY.counter("prefix_inserted_pages").inc()
