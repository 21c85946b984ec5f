"""Content-addressed shared-prefix index over the paged KV pool — the port's
copy of the reference's ``engine/prefix_cache.py`` (pure host policy).

RAG chat traffic repeats the system prompt in every request and the whole
prior conversation in every follow-up turn. This index lets admission map
those tokens' KV pages read-only instead of recomputing them (block-level
KV reuse as in vLLM's prefix caching and SGLang's RadixAttention):

- **Block hashing.** The prompt is hashed in page-sized blocks, each
  block's hash chained through its parent's, so one hash names the whole
  prefix up to and including its block, and the dict below is an
  implicit trie: walking ``hashes[0..k]`` in order is the descent.
- **Refcounted pages.** Each cached block maps to one pool page and the
  count of live requests that map it. Pages at refcount 0 stay resident
  (warm for the next turn) and are reclaimed leaf-first in LRU order
  only under pool pressure; the pool stays the one capacity budget.
- **Copy-on-write demotion.** A request must prefill at least one token
  to sample its first output, and chunks start on page boundaries, so a
  prompt covered wholly by cached blocks maps all but its last block:
  that block gets a private page and is recomputed into it
  (``usable_prefix_tokens``).

The engine's serve thread is the only one that mutates the cache.
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

BlockHash = bytes


def hash_blocks(token_ids: Sequence[int], page_size: int) -> list[BlockHash]:
    """Chained content hashes of the stream's full page-sized blocks.

    Block i's hash covers tokens [0, (i + 1) * page) through the parent
    chain; the trailing partial block is not hashed. blake2b with 16-byte
    digests over little-endian int32 tokens, as the reference computes
    them: a collision would serve another conversation's KV, so the hash
    is cryptographic."""
    out: list[BlockHash] = []
    parent = b""
    n_full = len(token_ids) // page_size
    if not n_full:
        return out
    raw = np.asarray(token_ids[:n_full * page_size], dtype="<i4").tobytes()
    stride = 4 * page_size
    for i in range(n_full):
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(raw[i * stride:(i + 1) * stride])
        parent = h.digest()
        out.append(parent)
    return out


def usable_prefix_tokens(matched_blocks: int, n_tokens: int,
                         page_size: int) -> int:
    """Prompt tokens a match of ``matched_blocks`` blocks lets admission
    skip: page-aligned and always < ``n_tokens`` (a full-cover match is
    capped one block short, the COW demotion)."""
    start = min(matched_blocks * page_size, n_tokens)
    if start >= n_tokens:
        start = ((n_tokens - 1) // page_size) * page_size
    return start


@dataclass
class _Entry:
    page: int
    parent: Optional[BlockHash]
    refcount: int = 0
    children: int = 0     # live child entries (chain integrity for eviction)
    tick: int = 0         # LRU recency, bumped on release


@dataclass
class CacheStats:
    hit_tokens: int = 0
    lookup_tokens: int = 0
    hits: int = 0          # lookups that matched >= 1 block
    lookups: int = 0
    evicted_pages: int = 0
    inserted_pages: int = 0

    def snapshot(self) -> dict:
        return {
            "prefix_cache_hit_tokens": self.hit_tokens,
            "prefix_cache_lookup_tokens": self.lookup_tokens,
            "prefix_cache_hits": self.hits,
            "prefix_cache_lookups": self.lookups,
            "prefix_cache_evicted_pages": self.evicted_pages,
            "prefix_cache_hit_rate": (
                self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0),
        }


@dataclass
class PrefixCache:
    """Block-chain hash -> pool page map with refcounts and LRU reclaim."""

    page_size: int
    _entries: dict[BlockHash, _Entry] = field(default_factory=dict)
    _pages: dict[int, BlockHash] = field(default_factory=dict)  # reverse map
    _tick: int = 0
    # Min-heap of (tick, hash) over evictable leaves, kept incrementally:
    # an entry is pushed when it becomes evictable (released to refcount 0
    # with no children, or its last child goes) and re-checked when
    # popped, so eviction never rescans every entry.
    _heap: list = field(default_factory=list)
    _idle: int = 0        # entries at refcount 0
    stats: CacheStats = field(default_factory=CacheStats)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_pages(self) -> int:
        return len(self._pages)

    @property
    def idle_pages(self) -> int:
        """Cached pages no live request maps (refcount 0): every one of
        them can be reclaimed by ``evict`` (a live request refs its whole
        chain, so an idle entry's descendants are idle too). A counter,
        so other threads may read it while the serve thread works."""
        return self._idle

    def page_of(self, h: BlockHash) -> Optional[int]:
        """The pool page holding a cached block, or None (the KV tier's
        export probe: a cached page holds prompt KV only and does not
        change while resident)."""
        e = self._entries.get(h)
        return e.page if e is not None else None

    def match(self, hashes: Sequence[BlockHash]) -> int:
        """Longest cached prefix, in blocks; the first miss ends every
        longer chain too."""
        n = 0
        for h in hashes:
            if h not in self._entries:
                break
            n += 1
        return n

    def acquire(self, hashes: Sequence[BlockHash]) -> list[int]:
        """Ref every block of a matched chain prefix and return their
        pages in logical order. The caller later ``release``s the same
        hashes once."""
        pages = []
        for h in hashes:
            e = self._entries[h]
            self._idle -= e.refcount == 0
            e.refcount += 1
            pages.append(e.page)
        return pages

    def _push_if_evictable(self, h: BlockHash, e: _Entry) -> None:
        if e.refcount == 0 and e.children == 0:
            heapq.heappush(self._heap, (e.tick, h))

    def release(self, hashes: Sequence[BlockHash]) -> None:
        """Drop one ref per hash (request retire). Refcount-0 entries stay
        resident with their LRU recency bumped to now."""
        self._tick += 1
        for h in hashes:
            e = self._entries[h]
            e.refcount -= 1
            e.tick = self._tick
            if e.refcount < 0:
                raise AssertionError("prefix cache refcount underflow")
            self._idle += e.refcount == 0
            self._push_if_evictable(h, e)

    def insert(self, h: BlockHash, parent: Optional[BlockHash],
               page: int) -> bool:
        """Register a freshly prefilled block. True when the cache took
        ``page`` (entry created, one ref held by the registering request);
        False when the hash is already cached (e.g. the COW-demoted tail
        block), in which case the page stays private."""
        if h in self._entries:
            return False
        if parent is not None:
            self._entries[parent].children += 1
        self._entries[h] = _Entry(page=page, parent=parent, refcount=1)
        self._pages[page] = h
        self.stats.inserted_pages += 1
        return True

    def _unlink(self, h: BlockHash, victim: _Entry) -> None:
        if victim.parent is not None:
            parent = self._entries[victim.parent]
            parent.children -= 1
            self._push_if_evictable(victim.parent, parent)
        del self._entries[h]
        del self._pages[victim.page]
        self._idle -= 1

    def evict(self, n_pages: int,
              sink: Optional[Callable[[BlockHash, _Entry], None]] = None
              ) -> list[int]:
        """Reclaim up to ``n_pages`` refcount-0 pages, LRU first and
        leaf-first (a parent becomes evictable only once its children are
        gone, so every resident chain stays walkable). Returns the freed
        pages. ``sink`` sees each ``(hash, entry)`` just before removal."""
        freed: list[int] = []
        while self._heap and len(freed) < n_pages:
            tick, h = heapq.heappop(self._heap)
            victim = self._entries.get(h)
            if victim is None or victim.refcount or victim.children \
                    or victim.tick != tick:
                continue  # stale: re-acquired, re-released, or removed
            if sink is not None:
                sink(h, victim)
            self._unlink(h, victim)
            freed.append(victim.page)
        self.stats.evicted_pages += len(freed)
        return freed

    def remove(self, h: BlockHash) -> Optional[int]:
        """Demote one block (a session suspend): drop the entry and
        return its page, only when it is reclaimable now (refcount 0, no
        resident children); else None. Callers walk chains leaf first, so
        shared interior blocks stay. Not counted as an eviction."""
        e = self._entries.get(h)
        if e is None or e.refcount or e.children:
            return None
        self._unlink(h, e)
        return e.page
