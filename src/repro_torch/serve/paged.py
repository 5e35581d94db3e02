"""Host-side bookkeeping for the block-paged KV cache, copied from
``repro/serve/paged.py`` (numpy and hashlib only, so the port keeps its own
copy instead of importing the reference). Keys are byte-equal to the
reference's for the same prompt.

The device side (models/attention.py, kernels/flash_paged.py) only sees
a page POOL per cache leaf plus a ``(B, max_pages)`` int32 page table; this
module owns everything that decides WHAT those tables contain:

* :class:`PageAllocator` — a refcounted free list over the pool. A page is
  held by every sequence whose table references it plus (optionally) the
  prefix index, and returns to the free list when the last reference drops.
* :func:`page_keys` / :func:`partial_key` — rolling (chained) hashes of full
  prompt-token pages. Chaining makes a page's key depend on its entire
  prefix, so equal keys imply equal KV content and a lookup can only match a
  page whose WHOLE history matches — matching is a simple walk that stops at
  the first miss.
* :class:`PrefixIndex` — hash -> page id map with LRU eviction. The index
  holds its own reference on every registered page, so a prefix page
  outlives the request that computed it until memory pressure evicts it.

Copy-on-write lives in the batcher (it owns the device cache): a shared page
is never written through — a writer holding a page with refcount > 1 copies
it to a fresh page first (``BatchServer._ensure_pages``).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional

import numpy as np


class PageAllocator:
    """Refcounted fixed-pool page allocator (host side, O(1) ops).

    Invariants (tests/test_torch_paged.py churns these):
      * ``free_count + in_use == num_pages``
      * every allocated page has refcount >= 1; free pages have refcount 0
      * ``alloc`` never returns a page that is still referenced
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs = np.zeros((num_pages,), np.int32)
        self.peak_in_use = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted")
        page = self._free.pop()
        assert self._refs[page] == 0, f"free page {page} had references"
        self._refs[page] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return page

    def incref(self, page: int):
        assert self._refs[page] > 0, f"incref on unallocated page {page}"
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True if the page was freed."""
        assert self._refs[page] > 0, f"decref on unallocated page {page}"
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        return False


def _tok_bytes(tokens) -> bytes:
    return np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes()


def page_keys(prompt, page_size: int) -> List[bytes]:
    """Chained digest per FULL prompt page: key_i commits to tokens [0,
    (i+1)*page_size), so two prompts share key_i iff their first i+1 pages
    of tokens are identical."""
    keys = []
    prev = b""
    n_full = len(prompt) // page_size
    for i in range(n_full):
        page = prompt[i * page_size:(i + 1) * page_size]
        prev = hashlib.sha1(prev + _tok_bytes(page)).digest()
        keys.append(prev)
    return keys


def partial_key(prompt, page_size: int) -> Optional[bytes]:
    """Key of the terminal PARTIAL page (None if the prompt is page-aligned).
    Commits to the full-page chain, the tail length, and the tail tokens —
    only an exact whole-prompt match can hit it."""
    n = len(prompt)
    tail = n % page_size
    if tail == 0:
        return None
    prev = page_keys(prompt, page_size)
    prev = prev[-1] if prev else b""
    return hashlib.sha1(prev + b"partial:%d:" % tail
                        + _tok_bytes(prompt[n - tail:])).digest()


class PrefixIndex:
    """LRU map from chained page keys to pool page ids.

    Holds one allocator reference per registered page. Eviction only drops
    the INDEX's reference — sequences currently using the page are
    unaffected; the page is freed once the last of them finishes.
    """

    def __init__(self, allocator: PageAllocator):
        self._alloc = allocator
        self._by_key: "OrderedDict[bytes, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._by_key)

    def get(self, key: bytes) -> Optional[int]:
        page = self._by_key.get(key)
        if page is not None:
            self._by_key.move_to_end(key)
        return page

    def register(self, key: bytes, page: int):
        """Idempotent: a key that is already registered keeps its existing
        page (the content is identical by construction of the chained key)."""
        if key in self._by_key:
            self._by_key.move_to_end(key)
            return
        self._alloc.incref(page)
        self._by_key[key] = page

    def evict_lru(self, n: int = 1) -> int:
        """Drop the n least-recently-used entries; returns pages FREED (an
        entry whose page is still referenced elsewhere frees nothing now)."""
        freed = 0
        for _ in range(min(n, len(self._by_key))):
            _, page = self._by_key.popitem(last=False)
            freed += bool(self._alloc.decref(page))
        return freed
