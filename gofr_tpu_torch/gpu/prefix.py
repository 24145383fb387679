"""Automatic prefix caching for the paged KV pool, in two tiers
(counterpart of gofr_tpu/tpu/prefix.py: ``chain_key`` :72, ``chain_keys``
:87, ``_Node`` :104, ``PrefixCache`` :120).

Full KV pages of prompts the engine has prefilled stay in a token-addressed
chain, and a later prompt that shares the prefix starts with those pages in
its block table; prefill then runs on the rest through the chunked path's
offsets.

Two tiers (prefix.py:12-20): a node's page lives in the device pool
(``page_id >= 0``, one pool reference) or, once pool pressure would have
dropped it, as a host copy of its K/V (``page_id == -1`` and a ``host``
payload), the copies bounded by ``host_budget_bytes``; a budget of 0 turns
the host tier off and leaves the single-tier cache exactly. A chain may
interleave the tiers. The engine owns every device access: it copies a page
out at spill time (``spill_lru``, then ``commit_spill``) and back in at hit
time (``promote``, an upload on the engine's in-flight queue, then
``settle`` at its fold).

Invariants (the engine keeps them):

- Only FULL pages are cached, and a hit is capped at ``(len - 1) // page``
  pages, so the last prompt token's logits are always recomputed and the
  first sampled token is the same with or without a hit.
- Cached pages are never written again: decode and prefill write at
  positions at or past the hit, which lie in pages the slot owns alone.
- Pages carry pool refcounts (engine ``_page_refs``): a page returns to the
  free list only when no slot uses it AND the cache no longer holds it on
  the device tier. A host node holds no pool reference.
- A node promoted while its upload is in flight is ``pending``: spill and
  eviction skip it until ``settle``, since its device content is not valid
  before the upload lands.

Keys are blake2b digests (8 bytes) over the parent key and the page's
tokens as **int32** little-endian bytes, so they equal the JAX package's
keys and the router's shard keys for the same tokens; the port's prompts
are int64, and are cast before hashing.
"""

from __future__ import annotations

import hashlib
import heapq

import numpy as np

_ROOT = 0


def chain_key(parent_key: int, tokens: bytes) -> int:
    """Chain key of the page holding ``tokens`` under ``parent_key``:
    blake2b over the parent key's 8 little-endian bytes and the page's
    token bytes, 8-byte digest (process-independent, unlike ``hash``)."""
    h = hashlib.blake2b(parent_key.to_bytes(8, "little"), digest_size=8)
    h.update(tokens)
    return int.from_bytes(h.digest(), "little")


def _page_bytes(toks, page_size: int) -> np.ndarray:
    """One contiguous int32 copy of the full-page region of ``toks``."""
    arr = np.asarray(toks)
    n_full = int(arr.shape[0]) // page_size
    return np.ascontiguousarray(arr[: n_full * page_size], dtype=np.int32)


def chain_keys(toks, page_size: int) -> list[int]:
    """Chain keys of every FULL page of ``toks``: the walk ``lookup`` and
    ``insert`` make, for a router to shard on."""
    p = int(page_size)
    buf = _page_bytes(toks, p)
    keys: list[int] = []
    key = _ROOT
    for i in range(buf.shape[0] // p):
        key = chain_key(key, buf[i * p:(i + 1) * p].tobytes())
        keys.append(key)
    return keys


class _Node:
    __slots__ = ("parent_key", "tokens", "page_id", "children", "dev_children", "last_used",
                 "host", "host_nbytes", "pending")

    def __init__(self, parent_key: int, tokens: bytes, page_id: int, last_used: int):
        self.parent_key = parent_key
        self.tokens = tokens      # the page's token bytes (int32 little-endian)
        self.page_id = page_id    # the pool page holding its K/V, or -1 on the host tier
        self.children = 0         # children in either tier
        self.dev_children = 0     # children on the device tier (spill eligibility)
        self.last_used = last_used
        self.host = None          # the host payload: one copy per pool plane
        self.host_nbytes = 0
        self.pending = False      # promoted, its upload not yet folded


class PrefixCache:
    """Token-addressed chain of cached full KV pages, in two tiers.

    The cache keeps bookkeeping and the host tier's payloads: device pages'
    contents stay in the engine's pool, and the engine owns the refcounts,
    calling in from its device thread under its state lock.

    Eviction is a lazy min-heap of ``(last_used, key)`` candidates per tier:
    every touch or creation of an eligible node pushes an entry, and the pop
    side skips stale ones (node gone, tier changed, grew children, touched
    since, upload pending), so eviction under pressure costs O(log n) a
    page."""

    def __init__(self, page_size: int, host_budget_bytes: int = 0):
        self.page_size = page_size
        self.host_budget = max(0, int(host_budget_bytes))
        self.host_bytes = 0
        self._nodes: dict[int, _Node] = {}
        self._dev_count = 0
        self._host_count = 0
        self._clock = 0
        self._heap: list[tuple[int, int]] = []   # device tier (last_used, key)
        self._hheap: list[tuple[int, int]] = []  # host tier (last_used, key)

    def __len__(self) -> int:
        """Pages the cache holds on the device tier (one pool reference
        each)."""
        return self._dev_count

    @property
    def host_pages(self) -> int:
        return self._host_count

    def pages(self) -> list[int]:
        """The pool pages the cache holds (the device tier)."""
        return [n.page_id for n in self._nodes.values() if n.page_id >= 0]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _push(self, key: int, node: _Node) -> None:
        heapq.heappush(self._heap, (node.last_used, key))
        # lazy deletion leaves one stale entry per touch: compact when stale
        # entries dominate (amortised O(1) a push)
        if len(self._heap) > 4 * self._dev_count + 16:
            self._heap = [(n.last_used, k) for k, n in self._nodes.items()
                          if n.page_id >= 0 and n.dev_children == 0 and not n.pending]
            heapq.heapify(self._heap)

    def _hpush(self, key: int, node: _Node) -> None:
        heapq.heappush(self._hheap, (node.last_used, key))
        if len(self._hheap) > 4 * self._host_count + 16:
            self._hheap = [(n.last_used, k) for k, n in self._nodes.items()
                           if n.page_id < 0 and n.children == 0]
            heapq.heapify(self._hheap)

    def _touch(self, key: int, node: _Node) -> None:
        node.last_used = self._tick()
        if node.page_id >= 0:
            if node.dev_children == 0:
                self._push(key, node)
        elif node.children == 0:
            self._hpush(key, node)

    def _get(self, parent_key: int, key: int, page_toks: bytes) -> _Node | None:
        """The node for ``key``, or None on a miss or a digest collision:
        both the tokens and the parent must match."""
        node = self._nodes.get(key)
        if node is not None and (node.tokens != page_toks or node.parent_key != parent_key):
            return None
        return node

    def _walk(self, toks, limit: int | None = None):
        """(parent key, key, page token bytes, index) of each full page of
        ``toks``, the first ``limit`` of them."""
        key = _ROOT
        p = self.page_size
        buf = _page_bytes(toks, p)
        n = buf.shape[0] // p if limit is None else min(buf.shape[0] // p, limit)
        for i in range(n):
            page_toks = buf[i * p:(i + 1) * p].tobytes()
            parent, key = key, chain_key(key, page_toks)
            yield parent, key, page_toks, i

    def lookup_tiered(self, toks) -> list[tuple[int, _Node]]:
        """``(key, node)`` for the longest cached full-page prefix of
        ``toks`` across both tiers. Touches the LRU clocks and takes no
        references: the caller refs the device pages it uses, claims pages
        for and ``promote``s the host nodes it swaps in, and caps the hit
        below ``len(toks)``."""
        chain: list[tuple[int, _Node]] = []
        for parent, key, page_toks, _ in self._walk(toks):
            node = self._get(parent, key, page_toks)
            if node is None:
                break
            self._touch(key, node)
            chain.append((key, node))
        return chain

    def lookup(self, toks) -> list[int]:
        """Page ids of the longest cached full-page prefix of ``toks`` on
        the device tier (the walk stops at the first host node)."""
        pages: list[int] = []
        for _, node in self.lookup_tiered(toks):
            if node.page_id < 0:
                break
            pages.append(node.page_id)
        return pages

    def insert(self, toks, pages: list[int]) -> list[int]:
        """Register ``pages`` (a slot's own, in chain order) as the full
        pages of ``toks``. Returns the page ids newly retained: the caller
        takes one pool reference for each. A chain position cached on the
        device is skipped (its page holds the same K/V); one cached on the
        host is promoted onto the slot's page, which just computed the same
        content, so no upload is owed."""
        new: list[int] = []
        for parent, key, page_toks, i in self._walk(toks, len(pages)):
            node = self._get(parent, key, page_toks)
            if node is None:
                if key in self._nodes:
                    break  # a digest collision with another chain: stop extending
                node = _Node(parent, page_toks, pages[i], self._tick())
                self._nodes[key] = node
                self._dev_count += 1
                pnode = self._nodes.get(parent)
                if pnode is not None:
                    pnode.children += 1
                    pnode.dev_children += 1
                self._push(key, node)
                new.append(pages[i])
            elif node.page_id < 0:
                self._promote(key, node, pages[i], pending=False)
                new.append(pages[i])
        return new

    def insert_host(self, toks, payloads, nbytes_each: int) -> int:
        """Register page payloads (chain order, one per full page of
        ``toks``) as host nodes (prefix.py:283, the import side of a
        handoff). A position cached in either tier is touched and skipped.
        Keeps the host budget as ``commit_spill`` does. Returns the nodes
        added (0 with the host tier off)."""
        if self.host_budget <= 0:
            return 0
        added = 0
        for parent, key, page_toks, i in self._walk(toks, len(payloads)):
            node = self._get(parent, key, page_toks)
            if node is not None:
                self._touch(key, node)
                continue
            if key in self._nodes:
                break  # a digest collision with another chain: stop extending
            node = _Node(parent, page_toks, -1, self._tick())
            node.host = payloads[i]
            node.host_nbytes = int(nbytes_each)
            self._nodes[key] = node
            self._host_count += 1
            self.host_bytes += node.host_nbytes
            pnode = self._nodes.get(parent)
            if pnode is not None:
                pnode.children += 1
            self._hpush(key, node)
            added += 1
        while self.host_bytes > self.host_budget:
            if self._drop_host_lru() is None:
                break  # only interior host nodes left: a passing overshoot
        return added

    # -- device tier: eviction and spill -------------------------------------------

    def _pop_dev_lru(self) -> tuple[int, _Node] | None:
        """Pop the live least-recently-used device node with no device
        children (a chain's descendants leave the device first, or they
        would become unreachable while still holding pages)."""
        while self._heap:
            last_used, key = heapq.heappop(self._heap)
            node = self._nodes.get(key)
            if (node is None or node.page_id < 0 or node.dev_children != 0 or node.pending
                    or node.last_used != last_used):
                continue  # stale: evicted, spilled, grew children, touched, or pending
            return key, node
        return None

    def _unlink(self, node: _Node) -> None:
        """Parent bookkeeping for a node removed from the chain."""
        parent = self._nodes.get(node.parent_key)
        if parent is None:
            return
        parent.children -= 1
        if node.page_id >= 0:
            parent.dev_children -= 1
        if parent.page_id >= 0:
            if parent.dev_children == 0:
                self._push(node.parent_key, parent)
        elif parent.children == 0:
            self._hpush(node.parent_key, parent)

    def evict_lru(self) -> int | None:
        """Remove the least-recently-used device leaf and return its page id
        for the caller to release (the host tier off); None when nothing is
        evictable."""
        popped = self._pop_dev_lru()
        if popped is None:
            return None
        key, node = popped
        del self._nodes[key]
        self._dev_count -= 1
        self._unlink(node)
        return node.page_id

    def spill_lru(self) -> tuple[int, int] | None:
        """``(key, page_id)`` of the node ``evict_lru`` would take, left in
        place: the engine copies the page's K/V out and then calls
        ``commit_spill(key, ...)`` before selecting again. None when nothing
        is spillable."""
        popped = self._pop_dev_lru()
        if popped is None:
            return None
        key, node = popped
        return key, node.page_id

    def commit_spill(self, key: int, payload, nbytes: int) -> int:
        """Move the node ``spill_lru`` chose to the host tier, holding
        ``payload`` (its K/V, ``nbytes`` in all). The host budget is kept by
        dropping least-recently-used host leaves (an interior node stays, or
        the chain below it would become unreachable); returns how many were
        dropped. The caller then releases the cache's reference on the
        page."""
        node = self._nodes[key]
        node.page_id = -1
        node.host = payload
        node.host_nbytes = int(nbytes)
        node.pending = False
        self._dev_count -= 1
        self._host_count += 1
        self.host_bytes += node.host_nbytes
        parent = self._nodes.get(node.parent_key)
        if parent is not None:
            parent.dev_children -= 1
            if parent.page_id >= 0 and parent.dev_children == 0:
                self._push(node.parent_key, parent)
        if node.children == 0:
            self._hpush(key, node)
        dropped = 0
        while self.host_bytes > self.host_budget:
            if self._drop_host_lru() is None:
                break  # only interior host nodes left: a passing overshoot
            dropped += 1
        return dropped

    def replace_host_payload(self, key: int, payload) -> None:
        """Swap a host node's payload in place: the engine stages a spill as
        a device copy under its lock and moves it to host memory outside it.
        No-op if the node was dropped or promoted in between."""
        node = self._nodes.get(key)
        if node is not None and node.page_id < 0 and node.host is not None:
            node.host = payload

    def _drop_host_lru(self) -> int | None:
        """Remove the least-recently-used host leaf; its key, or None when
        no host node can be dropped."""
        while self._hheap:
            last_used, key = heapq.heappop(self._hheap)
            node = self._nodes.get(key)
            if (node is None or node.page_id >= 0 or node.children != 0
                    or node.last_used != last_used):
                continue
            del self._nodes[key]
            self._host_count -= 1
            self.host_bytes -= node.host_nbytes
            self._unlink(node)
            return key
        return None

    # -- host tier: promotion (swap-in) ----------------------------------------------

    def _promote(self, key: int, node: _Node, page_id: int, pending: bool) -> None:
        node.page_id = page_id
        node.host = None
        self.host_bytes -= node.host_nbytes
        node.host_nbytes = 0
        node.pending = pending
        self._host_count -= 1
        self._dev_count += 1
        parent = self._nodes.get(node.parent_key)
        if parent is not None:
            parent.dev_children += 1
        node.last_used = self._tick()
        if not pending and node.dev_children == 0:
            self._push(key, node)

    def promote(self, key: int, page_id: int) -> None:
        """Move a host node back to the device tier at ``page_id`` (the
        engine claimed the page and takes the cache's reference; the host
        payload goes). The node is ``pending`` until ``settle``."""
        self._promote(key, self._nodes[key], page_id, pending=True)

    def settle(self, key: int) -> None:
        """The upload's fold: the node's device content is valid, and it can
        be spilled or evicted again."""
        node = self._nodes.get(key)
        if node is None or node.page_id < 0 or not node.pending:
            return
        node.pending = False
        if node.dev_children == 0:
            self._push(key, node)

    def clear(self) -> list[int]:
        """Drop both tiers; returns the device page ids that were held (host
        payloads hold no pool reference)."""
        pages = self.pages()
        self._nodes.clear()
        self._heap.clear()
        self._hheap.clear()
        self._dev_count = 0
        self._host_count = 0
        self.host_bytes = 0
        return pages
