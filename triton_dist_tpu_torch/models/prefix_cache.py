"""Shared-prefix KV cache: radix-tree page reuse with refcounts,
copy-on-write, and LRU eviction.

Counterpart of triton_dist_tpu/models/prefix_cache.py (`PoolExhausted`,
`RefcountedPages`, `RadixPrefixTree`, `PrefixCache`), host-side numpy
code copied so that matches, page ids and evictions are the JAX
package's on the same sequence of operations:

- `RefcountedPages`: refcounts over the `PageAllocator` free list. A
  physical page may back many slots' page tables and many tree nodes
  at once; it returns to the free list only at refcount zero. Pages are
  handed out in [Hkv] GROUPS (one page per kv-head stream of a logical
  tile), because one page id means the same row in every layer's pool
  (`PagedSlotCache`): a group is the sharing unit.
- `RadixPrefixTree`: a token-keyed radix tree whose nodes carry the page
  groups backing their span. Matching a prompt returns the longest
  cached prefix and the groups to map read-only into the slot's table;
  when the match ends mid-page the last group is only partly valid and
  the admission copy-on-writes it. Retired sequences (prompt +
  generated) are inserted back, donating the slot's pages to the tree.
- LRU eviction: when an admission would exhaust the pool, the least
  recently matched leaves are dropped until enough pages are free.
  Dropping a node only drops the TREE's refs; pages still mapped by
  in-flight slots live until those slots retire.

Sequence-parallel pools (`shards=`, the sp mesh size): the allocator
splits the page-id space into per-shard blocks and rotates fresh groups
across them (kernels/paged_kv.py PageAllocator); the tree stays
id-blind, and the pool reports per-shard residency
(`sp_pages_resident{shard=}`). Not ported yet: the host-RAM tier (the
scheduler refuses `host_pool_pages > 0`).
Policy changes page TABLES (data), never the device programs.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from triton_dist_tpu_torch.kernels.paged_kv import PageAllocator
from triton_dist_tpu_torch.runtime.telemetry import Telemetry


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PoolExhausted(ValueError):
    """A paged admission could not get pages even after LRU eviction:
    RECOVERABLE pressure (the scheduler preempts a victim slot and
    retries), unlike the hard rejections no preemption can fix."""


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    L = min(len(a), len(b))
    if L == 0:
        return 0
    neq = np.nonzero(a[:L] != b[:L])[0]
    return int(neq[0]) if len(neq) else L


class RefcountedPages:
    """Refcounts over the PageAllocator free list. The trash page is
    reserved at construction (page 0, the first handed out) and never
    refcounted: it is the write sink for retired slots, not storage."""

    def __init__(self, num_pages: int, n_kv_heads: int, shards: int = 1):
        self._alloc = PageAllocator(num_pages, shards=shards)
        self.n_kv_heads = n_kv_heads
        self._ref: Dict[int, int] = {}
        # shard 0 allocates first: the trash is page 0 whatever the shards
        self.trash = self._alloc.alloc(1)[0]

    @property
    def num_pages(self) -> int:
        return self._alloc.num_pages

    @property
    def shards(self) -> int:
        return self._alloc.shards

    @property
    def pages_per_shard(self) -> int:
        return self._alloc.pages_per_shard

    @property
    def available_by_shard(self) -> List[int]:
        return self._alloc.available_by_shard

    @property
    def outstanding_by_shard(self) -> List[int]:
        return self._alloc.outstanding_by_shard

    @property
    def pages_in_use_by_shard(self) -> List[int]:
        """Refcounted (slot- or tree-referenced) pages per shard: 0 on every
        shard at idle with the prefix cache off is the per-shard zero
        leak."""
        out = [0] * self._alloc.shards
        for p in self._ref:
            out[self._alloc.shard_of(p)] += 1
        return out

    @property
    def available(self) -> int:
        return self._alloc.available

    @property
    def pages_in_use(self) -> int:
        return len(self._ref)

    @property
    def outstanding(self) -> int:
        """Pages held out of the free list (refcounted pages + the trash
        page): `available + outstanding == num_pages` after any
        sequence of operations."""
        return self._alloc.outstanding

    def alloc_group(self) -> np.ndarray:
        """One fresh writable group ([Hkv] page ids at refcount 1)."""
        g = np.asarray(self._alloc.alloc(self.n_kv_heads), np.int32)
        for p in g:
            self._ref[int(p)] = 1
        return g

    def retain(self, group) -> None:
        for p in group:
            p = int(p)
            if p not in self._ref:
                raise ValueError(
                    f"retain of unreferenced page {p}: only pages live from "
                    f"alloc_group (refcount >= 1) can gain refs")
            self._ref[p] += 1

    def release(self, group) -> None:
        """Drop one ref per page of the group; pages at zero go back to
        the free list. A release past zero raises before touching the
        pool."""
        freed = []
        for p in group:
            p = int(p)
            if p not in self._ref:
                raise ValueError(f"refcount underflow: release of page {p} at "
                                 f"refcount 0 (some holder released a group twice)")
            c = self._ref[p] - 1
            if c:
                self._ref[p] = c
            else:
                del self._ref[p]
                freed.append(p)
        if freed:
            self._alloc.free(freed)

    def refcount(self, page) -> int:
        return self._ref.get(int(page), 0)


class _Node:
    """One radix-tree edge: tokens `key` spanning absolute positions
    [start, start + len(key)), backed by `groups`, one [Hkv] page group
    per page index floor(start/page) .. ceil(end/page)-1. When start is
    mid-page the first group is a page shared in span with the parent's
    last group (the same physical page after a split, or the diverging
    request's copy-on-write page)."""

    __slots__ = ("parent", "children", "start", "key", "groups", "last_use")

    def __init__(self, parent: Optional["_Node"], start: int, key: np.ndarray,
                 groups: List[np.ndarray]):
        self.parent = parent
        self.children: Dict[int, "_Node"] = {}
        self.start = start
        self.key = key
        self.groups = groups
        self.last_use = 0


class RadixPrefixTree:
    """Token-keyed radix tree over the refcounted page pool. Each node
    holds one pool ref per group it references; matching never touches
    refcounts (callers retain what they map)."""

    def __init__(self, pool: RefcountedPages, page: int):
        self.pool = pool
        self.page = page
        self.root = _Node(None, 0, np.zeros((0,), np.int32), [])
        self._tick = 0
        self.evictions = 0

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_use = self._tick

    def match(self, tokens, cap: Optional[int] = None
              ) -> Tuple[int, List[np.ndarray]]:
        """Longest cached prefix of `tokens` (<= cap): returns (m, groups)
        with groups covering page indices 0 .. ceil(m/page)-1. When m is
        mid-page the last group is only partly valid — the caller must
        copy-on-write it before the slot writes anything. Touches the
        matched path for LRU."""
        tokens = np.asarray(tokens, np.int32)
        node = self.root
        m = 0
        groups: List[np.ndarray] = []
        while m < len(tokens):
            child = node.children.get(int(tokens[m]))
            if child is None:
                break
            L = _common_prefix(child.key, tokens[m:m + len(child.key)])
            if child.start % self.page:
                # the child's first group is its own complete version of
                # the boundary page — it overrides the parent's
                groups.pop()
            first_pg = child.start // self.page
            n_pg = _ceil_div(child.start + L, self.page) - first_pg
            groups.extend(child.groups[:n_pg])
            m += L
            self._touch(child)
            if L < len(child.key):
                break
            node = child
        if cap is not None and m > cap:
            m = cap
            groups = groups[:_ceil_div(m, self.page)]
        return m, groups

    def insert(self, tokens, groups_by_page: List[np.ndarray]) -> int:
        """Insert a finished sequence: walk the matched path, split a
        node where the sequence diverges inside it, and attach the
        unmatched suffix as a new leaf whose groups are the caller's
        pages for that span (the tree RETAINS them; the caller keeps its
        own refs). Returns the number of newly cached tokens."""
        tokens = np.asarray(tokens, np.int32)
        node = self.root
        m = 0
        while m < len(tokens):
            child = node.children.get(int(tokens[m]))
            if child is None:
                leaf_groups = [
                    np.asarray(g, np.int32).copy()
                    for g in groups_by_page[m // self.page:
                                            _ceil_div(len(tokens), self.page)]]
                leaf = _Node(node, m, tokens[m:].copy(), leaf_groups)
                for g in leaf_groups:
                    self.pool.retain(g)
                node.children[int(tokens[m])] = leaf
                self._touch(leaf)
                return len(tokens) - m
            L = _common_prefix(child.key, tokens[m:m + len(child.key)])
            self._touch(child)
            if L < len(child.key):
                if m + L == len(tokens):
                    return 0          # the sequence ends inside the node
                child = self._split(child, L)
            m += L
            node = child
        return 0

    def _split(self, child: _Node, L: int) -> _Node:
        """Split `child` at key offset L into head + tail: the tail keeps
        the node object (its children stay wired), the head takes its
        place under the parent. A mid-page split leaves the boundary page
        referenced by BOTH nodes, so it gains one pool ref."""
        s = child.start
        cut = s + L
        first_pg = s // self.page
        head = _Node(child.parent, s, child.key[:L],
                     child.groups[:_ceil_div(cut, self.page) - first_pg])
        head.last_use = child.last_use
        child.parent.children[int(child.key[0])] = head
        child.groups = child.groups[cut // self.page - first_pg:]
        child.start = cut
        child.key = child.key[L:]
        child.parent = head
        head.children[int(child.key[0])] = child
        if cut % self.page:
            self.pool.retain(head.groups[-1])
        return head

    def evict_until(self, pages_needed: int) -> bool:
        """Drop least-recently-matched leaves until the allocator has
        `pages_needed` free pages (False when nothing evictable remains:
        the admission's rejection signal). A parent becomes a candidate
        the moment its last child is dropped."""
        if self.pool.available >= pages_needed:
            return True
        heap = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd is not self.root and not nd.children:
                heap.append((nd.last_use, len(heap), nd))
        heapq.heapify(heap)
        seq = len(heap)
        while self.pool.available < pages_needed and heap:
            _, _, nd = heapq.heappop(heap)
            parent = nd.parent
            for g in nd.groups:
                self.pool.release(g)
            del parent.children[int(nd.key[0])]
            self.evictions += 1
            if parent is not self.root and not parent.children:
                heapq.heappush(heap, (parent.last_use, seq, parent))
                seq += 1
        return self.pool.available >= pages_needed

    def nodes(self) -> List[_Node]:
        out = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            if nd is not self.root:
                out.append(nd)
            stack.extend(nd.children.values())
        return out


class PrefixCache:
    """The serving-facing facade: pool + tree + hit/skip counters in the
    scheduler's metrics registry. `enabled=False` keeps the identical
    pool/alloc path but never matches or inserts: the cache-off
    configuration runs the same device programs, which is what makes the
    bitwise cache-on/off comparison meaningful."""

    def __init__(self, num_pages: int, n_kv_heads: int, page: int, *,
                 enabled: bool = True, telemetry: Optional[Telemetry] = None,
                 shards: int = 1):
        """shards: the sp mesh size of a sequence-parallel pool (the
        allocator's per-shard id blocks; stats() then adds per-shard
        residency)."""
        self.pool = RefcountedPages(num_pages, n_kv_heads, shards=shards)
        self.page = page
        self.enabled = enabled
        self.tele = telemetry if telemetry is not None else Telemetry()
        self.tree = RadixPrefixTree(self.pool, page)
        reg = self.tele.registry
        self.admissions = reg.counter("admissions", "successful paged admissions")
        self.hits = reg.counter("hits", "admissions with a non-empty prefix match")
        self.prompt_tokens = reg.counter("prompt_tokens",
                                         "prompt tokens across admissions")
        self.prefill_tokens_skipped = reg.counter(
            "prefill_tokens_skipped", "prompt tokens served from cached prefixes")
        self.tokens_inserted = reg.counter("tokens_inserted",
                                           "new tokens donated to the radix tree")

    def lookup(self, prompt) -> Tuple[int, List[np.ndarray]]:
        """Longest cached prefix for an admission, capped to n-1: the last
        prompt token is always recomputed so the slot gets fresh
        next-token logits."""
        if not self.enabled:
            return 0, []
        return self.tree.match(prompt, cap=max(len(prompt) - 1, 0))

    def record(self, n_prompt: int, n_matched: int) -> None:
        """Count one SUCCESSFUL admission."""
        self.admissions.inc()
        self.prompt_tokens.inc(n_prompt)
        self.prefill_tokens_skipped.inc(n_matched)
        self.hits.inc(int(bool(n_matched)))

    def insert(self, tokens, groups_by_page) -> int:
        if not self.enabled:
            return 0
        new = self.tree.insert(tokens, groups_by_page)
        self.tokens_inserted.inc(new)
        return new

    def ensure_pages(self, n_pages: int) -> bool:
        """Free-list headroom for an admission: evict LRU leaves when
        short. False = not satisfiable."""
        if self.pool.available >= n_pages:
            return True
        if not self.enabled:
            return False
        return self.tree.evict_until(n_pages)

    def stats(self) -> dict:
        """Hit/skip counters and the pool's occupancy, refreshed into
        registry gauges so a snapshot right after is one cut."""
        reg = self.tele.registry
        with reg.lock:
            reg.gauge("pages_in_use").set(self.pool.pages_in_use)
            reg.gauge("pages_free").set(self.pool.available)
            reg.gauge("pages_outstanding").set(self.pool.outstanding)
            reg.gauge("evictions").set(self.tree.evictions)
            if self.pool.shards > 1:
                for sh, npg in enumerate(self.pool.pages_in_use_by_shard):
                    reg.gauge("sp_pages_resident", "refcounted pages per sp shard",
                              labels={"shard": str(sh)}).set(npg)
        out = {
            "enabled": self.enabled,
            "admissions": self.admissions.value,
            "hits": self.hits.value,
            "hit_rate": self.hits.value / max(self.admissions.value, 1),
            "prompt_tokens": self.prompt_tokens.value,
            "prefill_tokens_skipped": self.prefill_tokens_skipped.value,
            "prefill_skip_frac": (self.prefill_tokens_skipped.value
                                  / max(self.prompt_tokens.value, 1)),
            "evictions": self.tree.evictions,
            "pages_in_use": self.pool.pages_in_use,
            "pages_free": self.pool.available,
            "pages_outstanding": self.pool.outstanding,
        }
        if self.pool.shards > 1:
            out["sp_pages_resident"] = self.pool.pages_in_use_by_shard
            out["sp_pages_free_by_shard"] = self.pool.available_by_shard
        return out
