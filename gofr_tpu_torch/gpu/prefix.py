"""Automatic prefix caching for the paged KV pool, device tier (counterpart
of gofr_tpu/tpu/prefix.py: ``chain_key`` :72, ``chain_keys`` :87, ``_Node``
:106, ``PrefixCache`` :120).

Full KV pages of prompts the engine has prefilled stay in a token-addressed
chain, one pool reference per cached page, and a later prompt that shares
the prefix starts with those pages in its block table; prefill then runs on
the rest through the chunked path's offsets.

Invariants (the engine keeps them):

- Only FULL pages are cached, and a hit is capped at ``(len - 1) // page``
  pages, so the last prompt token's logits are always recomputed and the
  first sampled token is the same with or without a hit.
- Cached pages are never written again: decode and prefill write at
  positions at or past the hit, which lie in pages the slot owns alone.
- Pages carry pool refcounts (engine ``_page_refs``): a page returns to the
  free list only when no slot uses it AND the cache no longer holds it.

Keys are blake2b digests (8 bytes) over the parent key and the page's
tokens as **int32** little-endian bytes, so they equal the JAX package's
keys and the router's shard keys for the same tokens; the port's prompts
are int64, and are cast before hashing.

This module holds the device tier only. The JAX cache's host tier
(``insert_host``, ``spill_lru``, ``commit_spill``, ``promote``, ``settle``,
``_drop_host_lru``, ``replace_host_payload``: pages spilled to host memory
under pool pressure and swapped back on a hit) is not ported yet; under
pressure the port evicts, as the JAX engine does with the host tier off
(its default).
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
    __slots__ = ("parent_key", "tokens", "page_id", "children", "last_used")

    def __init__(self, parent_key: int, tokens: bytes, page_id: int, last_used: int):
        self.parent_key = parent_key
        self.tokens = tokens      # the page's token bytes (int32 little-endian)
        self.page_id = page_id    # the pool page holding its K/V
        self.children = 0
        self.last_used = last_used


class PrefixCache:
    """Token-addressed chain of cached full KV pages in the pool.

    The cache keeps bookkeeping only: the pages' contents stay in the
    engine's pool, and the engine owns the refcounts, calling ``lookup`` /
    ``insert`` / ``evict_lru`` from its device thread.

    Eviction is a lazy min-heap of ``(last_used, key)`` candidates: every
    touch or creation of a leaf pushes an entry, and the pop side skips
    stale ones (node gone, grew children, touched since), so eviction under
    pressure costs O(log n) a page."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._nodes: dict[int, _Node] = {}
        self._clock = 0
        self._heap: list[tuple[int, int]] = []

    def __len__(self) -> int:
        """Pages the cache holds (one pool reference each)."""
        return len(self._nodes)

    def pages(self) -> list[int]:
        """The pool pages the cache holds."""
        return [n.page_id for n in self._nodes.values()]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _push(self, key: int, node: _Node) -> None:
        heapq.heappush(self._heap, (node.last_used, key))
        # lazy deletion leaves one stale entry per touch: compact when stale
        # entries dominate (amortised O(1) a push)
        if len(self._heap) > 4 * len(self._nodes) + 16:
            self._heap = [(n.last_used, k) for k, n in self._nodes.items() if n.children == 0]
            heapq.heapify(self._heap)

    def _touch(self, key: int, node: _Node) -> None:
        node.last_used = self._tick()
        if node.children == 0:
            self._push(key, node)

    def _get(self, parent_key: int, key: int, page_toks: bytes) -> _Node | None:
        """The node for ``key``, or None on a miss or a digest collision:
        both the tokens and the parent must match."""
        node = self._nodes.get(key)
        if node is not None and (node.tokens != page_toks or node.parent_key != parent_key):
            return None
        return node

    def lookup_tiered(self, toks) -> list[tuple[int, _Node]]:
        """``(key, node)`` for the longest cached full-page prefix of
        ``toks``. Touches the LRU clocks and takes no references: the caller
        refs the pages it uses and caps the hit below ``len(toks)``. (The
        name is the JAX cache's; here every node lies in the one tier.)"""
        chain: list[tuple[int, _Node]] = []
        key = _ROOT
        p = self.page_size
        buf = _page_bytes(toks, p)
        for i in range(buf.shape[0] // p):
            page_toks = buf[i * p:(i + 1) * p].tobytes()
            parent, key = key, chain_key(key, page_toks)
            node = self._get(parent, key, page_toks)
            if node is None:
                break
            self._touch(key, node)
            chain.append((key, node))
        return chain

    def lookup(self, toks) -> list[int]:
        """Page ids of the longest cached full-page prefix of ``toks``."""
        return [node.page_id for _, node in self.lookup_tiered(toks)]

    def insert(self, toks, pages: list[int]) -> list[int]:
        """Register ``pages`` (a slot's own, in chain order) as the full
        pages of ``toks``. Returns the page ids newly retained: the caller
        takes one pool reference for each. A chain position already cached
        is skipped (its page holds the same K/V)."""
        new: list[int] = []
        key = _ROOT
        p = self.page_size
        buf = _page_bytes(toks, p)
        for i in range(min(buf.shape[0] // p, len(pages))):
            page_toks = buf[i * p:(i + 1) * p].tobytes()
            parent, key = key, chain_key(key, page_toks)
            if self._get(parent, key, page_toks) is not None:
                continue
            if key in self._nodes:
                break  # a digest collision with another chain: stop extending
            node = _Node(parent, page_toks, pages[i], self._tick())
            self._nodes[key] = node
            pnode = self._nodes.get(parent)
            if pnode is not None:
                pnode.children += 1
            self._push(key, node)
            new.append(pages[i])
        return new

    def _pop_dev_lru(self) -> tuple[int, _Node] | None:
        """Pop the live least-recently-used node with no children (a chain's
        descendants leave first, or they would become unreachable while
        still holding pages)."""
        while self._heap:
            last_used, key = heapq.heappop(self._heap)
            node = self._nodes.get(key)
            if node is None or node.children != 0 or node.last_used != last_used:
                continue  # stale: evicted, grew children, or touched since
            return key, node
        return None

    def _unlink(self, node: _Node) -> None:
        """Parent bookkeeping for a node removed from the chain."""
        parent = self._nodes.get(node.parent_key)
        if parent is None:
            return
        parent.children -= 1
        if parent.children == 0:
            self._push(node.parent_key, parent)

    def evict_lru(self) -> int | None:
        """Remove the least-recently-used leaf and return its page id for the
        caller to release; None when nothing is left to evict."""
        popped = self._pop_dev_lru()
        if popped is None:
            return None
        key, node = popped
        del self._nodes[key]
        self._unlink(node)
        return node.page_id

    def clear(self) -> list[int]:
        """Drop everything; returns the page ids that were held."""
        pages = self.pages()
        self._nodes.clear()
        self._heap.clear()
        return pages
