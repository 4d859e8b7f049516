"""Prefix index for cross-request KV reuse (counterpart of
``deepspeed_tpu/inference/prefix_cache.py``; pure host code).

A physical page holding the K/V of tokens ``[i*page, (i+1)*page)`` of some
prefix is valid for every request whose prompt starts with that exact token
prefix: K/V at position ``t`` is a function of tokens ``0..t`` only.
:class:`PrefixIndex` maps page-aligned token chunks to the physical page
holding their K/V, keyed by a rolling (chained) hash over the whole prefix:

- **full chunks**: ``key_i = hash((key_{i-1}, chunk_i_tokens))``.  Lookup
  walks chunk by chunk from token 0 and compares the stored tokens exactly
  at every step, so a hash collision degrades to a miss, never to wrong
  tokens.  Only pages wholly inside a prompt (immutable) are published.
- **partial boundary chunks**: a prompt that ends mid-page publishes its
  boundary page under ``("p", prev_key, partial_tokens)``.  Its owner keeps
  appending to it, so a matching request copies it into a private page
  (copy-on-write) and overwrites every row past the matched prefix itself.
- **divergence inside a full chunk**: the full entries chained under the
  matched prefix are longest-common-prefix COW candidates too.

The index owns no device memory: it hands page ids back to the engine,
which holds one refcount per live entry.  Entries are LRU-ordered;
:meth:`evict` releases the oldest so the engine can reclaim cached-but-idle
pages under pool pressure.

Not ported (ROADMAP queue 1, item 7): the host-RAM tier's demote / promote
/ adopt half and the fleet residency digest; and the weight-epoch stamps
(item 11), since the port's serving engine refuses live weight updates.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["PrefixIndex", "PrefixMatch", "chain_keys"]

# chain-root seed (arbitrary odd 64-bit constant): the hash "prefix" of the
# empty token sequence, so chunk 0 keys differ from raw tuple hashes
_ROOT = 0x9E3779B97F4A7C15


def _salted_root(salt: int) -> int:
    """Chain root for a salted namespace (per-tenant isolation): ``salt``
    folds into the root so every key of the chain lands in a disjoint
    namespace.  Salt 0 is the unsalted (base-model) namespace."""
    s = int(salt)
    return _ROOT if s == 0 else hash((_ROOT, s))


def chain_keys(ids, page_size: int, limit: Optional[int] = None,
               salt: int = 0) -> List[int]:
    """The chain-key sequence of ``ids``'s page-aligned full chunks: the
    schedule :class:`PrefixIndex` files full entries under.  Keys are
    content-derived (int tuples hash deterministically across processes)."""
    if limit is not None:
        ids = ids[:max(0, int(limit))]
    tup = tuple(int(t) for t in ids)
    ps = int(page_size)
    h, out, n = _salted_root(salt), [], 0
    while n + ps <= len(tup):
        h = PrefixIndex._chain(h, tup[n:n + ps])
        out.append(h)
        n += ps
    return out


@dataclasses.dataclass
class PrefixMatch:
    """Result of a :meth:`PrefixIndex.lookup`.

    ``pages`` are fully-shared immutable pages to map read-only (the caller
    takes a refcount on each).  ``cow_src`` (when set) is a partially valid
    boundary page whose first ``cow_valid`` rows match the prompt: the
    caller snapshots it into a private page before writing.  ``n_tokens ==
    len(pages) * page_size + cow_valid`` is how much prefill the match
    saves."""
    pages: List[int]
    n_tokens: int
    cow_src: Optional[int] = None
    cow_valid: int = 0
    keys: List[object] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Entry:
    page: int
    tokens: Tuple[int, ...]   # this chunk's tokens (len == page_size if full)
    prev: int                 # chain key of the preceding prefix
    full: bool


class PrefixIndex:
    """Chained-hash prefix index: page-aligned token chunks -> physical
    page.  One physical page holds at most one entry at a time (the
    engine's refcount pins it while the entry lives)."""

    def __init__(self, page_size: int, max_entries: int = 4096):
        self.page_size = int(page_size)
        self.max_entries = int(max_entries)
        if self.max_entries < 1:
            raise ValueError(f"max_entries={max_entries} must be >= 1")
        self._entries: "OrderedDict[object, _Entry]" = OrderedDict()
        # prev chain key -> keys of partial boundary entries under it
        self._children: Dict[int, Set[object]] = {}
        # prev chain key -> keys of full entries under it (mid-page
        # divergence COW candidates, and the subtree walk)
        self._full_children: Dict[int, Set[object]] = {}
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _chain(prev: int, chunk: Tuple[int, ...]) -> int:
        return hash((prev, chunk))

    # ----------------------------------------------------------- lookup

    def lookup(self, ids, limit: int, salt: int = 0) -> PrefixMatch:
        """Longest resident prefix of ``ids[:limit]`` (the engine passes
        ``len(prompt) - 1`` so at least one token always goes through
        prefill).  Matched entries are LRU-touched.  Exact: every matched
        chunk's stored tokens are compared verbatim."""
        tup = tuple(int(t) for t in ids[:max(0, int(limit))])
        ps = self.page_size
        h = _salted_root(salt)
        pages: List[int] = []
        keys: List[object] = []
        n = 0
        while n + ps <= len(tup):
            chunk = tup[n:n + ps]
            key = self._chain(h, chunk)
            e = self._entries.get(key)
            if e is None or not e.full or e.prev != h or e.tokens != chunk:
                break
            pages.append(e.page)
            keys.append(key)
            self._entries.move_to_end(key)
            h, n = key, n + ps
        # boundary: the entry under this chain with the longest common
        # prefix against the remaining tokens (partial boundary entries and
        # full entries the prompt diverges inside)
        rem = tup[n:]
        best_j, best_key, best_page = 0, None, None
        for kids in (self._children.get(h, ()), self._full_children.get(h, ())):
            for ck in kids:
                e = self._entries.get(ck)
                if e is None:
                    continue
                j = 0
                for a, b in zip(e.tokens, rem):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best_j, best_key, best_page = j, ck, e.page
        if best_key is not None:
            self._entries.move_to_end(best_key)
            return PrefixMatch(pages=pages, n_tokens=n + best_j,
                               cow_src=best_page, cow_valid=best_j, keys=keys)
        return PrefixMatch(pages=pages, n_tokens=n, keys=keys)

    # ---------------------------------------------------------- publish

    def publish(self, ids, pages: List[int],
                salt: int = 0) -> Tuple[List[int], List[int]]:
        """Register the prompt ``ids`` whose logical pages are ``pages``
        (the slot's page-table row).  Full chunks register under their
        chain key; a trailing partial chunk registers as a COW boundary
        entry.  Existing identical entries are LRU-touched, not replaced.
        Returns ``(newly, released)``: the engine takes one refcount per
        ``newly`` page and drops one per ``released`` page (collision
        replacements and LRU-cap evictions)."""
        tup = tuple(int(t) for t in ids)
        ps = self.page_size
        newly: List[int] = []
        released: List[int] = []
        h = _salted_root(salt)
        i = 0
        while (i + 1) * ps <= len(tup):
            chunk = tup[i * ps:(i + 1) * ps]
            key = self._chain(h, chunk)
            e = self._entries.get(key)
            if e is not None and e.prev == h and e.tokens == chunk:
                self._entries.move_to_end(key)
            else:
                if e is not None:
                    # chain-hash collision: replace outright, with every
                    # entry chained under the collided key (left reachable,
                    # they would map K/V computed under another prefix)
                    released.extend(self._remove_subtree(key))
                self._entries[key] = _Entry(page=pages[i], tokens=chunk,
                                            prev=h, full=True)
                self._full_children.setdefault(h, set()).add(key)
                newly.append(pages[i])
            h, i = key, i + 1
        part = tup[i * ps:]
        if part:
            pk = ("p", h, part)
            if pk in self._entries:
                self._entries.move_to_end(pk)
            else:
                self._entries[pk] = _Entry(page=pages[i], tokens=part, prev=h,
                                           full=False)
                self._children.setdefault(h, set()).add(pk)
                newly.append(pages[i])
        while len(self._entries) > self.max_entries:
            released.extend(self.evict(1))
        return newly, released

    # ----------------------------------------------------------- evict

    def _remove(self, key) -> int:
        e = self._entries.pop(key)
        table = self._children if not e.full else self._full_children
        kids = table.get(e.prev)
        if kids is not None:
            kids.discard(key)
            if not kids:
                del table[e.prev]
        return e.page

    def _remove_subtree(self, key) -> List[int]:
        """Remove the entry at ``key`` plus every descendant chained under
        it; returns their pages (the collision-replacement path)."""
        pages = [self._remove(key)]
        stack = [key]
        while stack:
            h = stack.pop()
            for pk in list(self._children.get(h, ())):
                pages.append(self._remove(pk))
            kids = list(self._full_children.get(h, ()))
            for k in kids:
                pages.append(self._remove(k))
            stack.extend(kids)
        return pages

    def evict(self, n: int = 1) -> List[int]:
        """Drop the ``n`` least-recently-used entries; returns their pages
        (one engine refcount each to release).  A released page becomes
        reusable only once every other reference (a slot still decoding
        through it) is gone: the engine's refcount arbitrates."""
        released: List[int] = []
        for _ in range(min(n, len(self._entries))):
            released.append(self._remove(next(iter(self._entries))))
            self.evictions += 1
        return released
