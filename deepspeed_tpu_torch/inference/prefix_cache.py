"""Prefix index for cross-request KV reuse (counterpart of
``deepspeed_tpu/inference/prefix_cache.py``; pure host code, copied: the
JAX package's module is framework-free but its package imports jax).

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
- **host-RAM tiering**: a full entry may be demoted (its device page
  released, its K/V parked in a :class:`~.kv_tiering.HostTier`) and
  promoted back on a hit; a demoted entry matches with page ``-1``.
  ``on_drop_host`` (set by the engine) fires whenever a demoted entry is
  removed, so its host buffer is never stranded.
- **weight epochs**: entries are stamped with the index's ``epoch``;
  lookup treats another epoch's entry as a miss and :meth:`flush` drops the
  whole index when the serving weights move.
- **salts**: each tenant adapter's chains start from a salted root, so two
  tenants' identical prompts never share a page.

The index owns no device memory: it hands page ids back to the engine,
which holds one refcount per live device entry.  Entries are LRU-ordered;
:meth:`evict` releases the oldest so the engine can reclaim cached-but-idle
pages under pool pressure.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

__all__ = ["PrefixIndex", "PrefixMatch", "chain_keys"]

# chain-root seed (arbitrary odd 64-bit constant): the hash "prefix" of the
# empty token sequence, so chunk 0 keys differ from raw tuple hashes
_ROOT = 0x9E3779B97F4A7C15


def _salted_root(salt: int) -> int:
    """Chain root for a salted namespace (multi-tenant adapter serving,
    docs/SERVING.md): ``salt`` folds into the root so EVERY key of the
    chain — full chunks and the ``("p", h, part)`` boundary keys alike —
    lands in a disjoint namespace per salt.  Tenant A's system prompt can
    then never prefix-hit or COW into tenant B's stream, because their
    chains never share a single key.  Salt 0 is the unsalted (base-model)
    namespace, bit-identical to the pre-adapter behaviour."""
    s = int(salt)
    return _ROOT if s == 0 else hash((_ROOT, s))


def chain_keys(ids, page_size: int, limit: Optional[int] = None,
               salt: int = 0) -> List[int]:
    """The chain-key sequence of ``ids``'s page-aligned full chunks — the
    SAME schedule :class:`PrefixIndex` files full entries under, exposed so
    a fleet router can compute a request's keys without an index and match
    them against per-engine residency digests (``inference/fleet.py``).
    Keys are content-derived (ints and int tuples hash deterministically
    across processes — PYTHONHASHSEED only perturbs str/bytes), so two
    engines that cached the same prefix publish the same keys.  ``salt``
    must itself be process-independent (the engine derives it from the
    adapter id via crc32, never Python ``hash`` of the string)."""
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
    takes a refcount on each); a ``-1`` marks a chunk whose entry is
    DEMOTED to the host tier — the caller must promote it into a free
    device page (via the entry key in ``keys``, parallel to ``pages``)
    before mapping.  ``cow_src`` (when set) is a partially-valid boundary
    page — a mutable partial page OR a full donor page the prompt diverges
    inside — whose first ``cow_valid`` rows match the prompt: the caller
    snapshots it into a private page before writing.
    ``n_tokens == len(pages) * page_size + cow_valid`` is how much prefill
    the match saves."""
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
    tier: str = "hbm"         # "hbm" | "host" (demoted; page == -1)
    # weight epoch the chunk's K/V was computed under (docs/HYBRID.md):
    # lookup refuses entries from any other epoch — stale K/V is a miss,
    # never a served page
    epoch: int = 0


class PrefixIndex:
    """Chained-hash prefix index: page-aligned token chunks → physical page.

    Pure host-side bookkeeping (no device state).  One physical page holds
    at most one entry at a time: a page is published once, during its
    owner's prefill, and cannot be recycled while the entry lives (the
    engine's refcount pins it), so entry↔page is one-to-one over the HBM
    entries; demoted entries hold no page at all.
    """

    def __init__(self, page_size: int, max_entries: int = 4096):
        self.page_size = int(page_size)
        self.max_entries = int(max_entries)
        if self.max_entries < 1:
            raise ValueError(f"max_entries={max_entries} must be >= 1")
        self._entries: "OrderedDict[object, _Entry]" = OrderedDict()
        # prev chain key -> keys of partial boundary entries published under
        # it (candidates for the longest-common-prefix boundary match)
        self._children: Dict[int, Set[object]] = {}
        # prev chain key -> keys of FULL entries published under it: the
        # mid-page-divergence COW candidates, and the O(1) subtree walk
        self._full_children: Dict[int, Set[object]] = {}
        self.evictions = 0
        self.invalidations = 0    # entries dropped by weight-epoch flushes
        self.demoted = 0          # entries currently on the host tier
        # current weight epoch (docs/HYBRID.md): the engine advances it on
        # every live param update; entries publish stamped with it and
        # lookup refuses any other stamp
        self.epoch = 0
        # engine hook: fired with the entry key whenever a DEMOTED entry is
        # removed, so the host tier can drop the orphaned buffer in the
        # same step (never strand a slab)
        self.on_drop_host: Optional[Callable[[object], None]] = None

    def __len__(self) -> int:
        return len(self._entries)

    def hbm_entries(self) -> int:
        """Entries holding a device page (the 'cached' accounting term)."""
        return len(self._entries) - self.demoted

    def pages(self) -> List[int]:
        """All physical pages currently pinned by HBM index entries (each
        holds one engine refcount) — the 'cached' component of the pool
        invariant.  Demoted entries hold no device page and are absent."""
        return [e.page for e in self._entries.values() if e.tier == "hbm"]

    @staticmethod
    def _chain(prev: int, chunk: Tuple[int, ...]) -> int:
        return hash((prev, chunk))

    # ----------------------------------------------------------- lookup

    def lookup(self, ids, limit: int, salt: int = 0) -> PrefixMatch:
        """Longest resident prefix of ``ids[:limit]``.

        ``limit`` caps the match (the engine passes ``len(prompt) - 1`` so
        at least one token always goes through prefill — the first
        generated token is read off the last real prefill position).
        Matched entries are LRU-touched.  Exact: every matched chunk's
        stored tokens are compared verbatim, so a chain-hash collision is a
        miss, never a wrong page.  Demoted full chunks match with page
        ``-1`` (the caller promotes before mapping).  ``salt`` scopes the
        walk to that namespace's chain root (per-adapter isolation): a
        lookup under salt S can only ever reach entries published under S."""
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
            if e is None or not e.full or e.prev != h or e.tokens != chunk \
                    or e.epoch != self.epoch:
                # an epoch mismatch is K/V computed under retired weights
                # (docs/HYBRID.md) — a MISS by contract, exactly like a
                # hash collision degrading to a miss
                break
            pages.append(e.page if e.tier == "hbm" else -1)
            keys.append(key)
            self._entries.move_to_end(key)
            h, n = key, n + ps
        # boundary: the entry under this chain with the longest common
        # prefix against the remaining tokens — partial boundary entries
        # AND full entries the prompt diverges inside are both COW
        # candidates (demoted full entries are skipped: their page is on
        # the host tier and a COW source must be a live device page)
        rem = tup[n:]
        best_j, best_key, best_page = 0, None, None
        for pk in self._children.get(h, ()):
            e = self._entries.get(pk)
            if e is None or e.epoch != self.epoch:
                continue
            j = 0
            for a, b in zip(e.tokens, rem):
                if a != b:
                    break
                j += 1
            if j > best_j:
                best_j, best_key, best_page = j, pk, e.page
        for fk in self._full_children.get(h, ()):
            e = self._entries.get(fk)
            if e is None or e.tier != "hbm" or e.epoch != self.epoch:
                continue
            j = 0
            for a, b in zip(e.tokens, rem):
                if a != b:
                    break
                j += 1
            # j == len(rem) < page_size is fine (prompt ends mid-donor-
            # page); j == page_size cannot happen — the exact walk above
            # would have consumed the chunk
            if j > best_j:
                best_j, best_key, best_page = j, fk, e.page
        if best_key is not None:
            self._entries.move_to_end(best_key)
            return PrefixMatch(pages=pages, n_tokens=n + best_j,
                               cow_src=best_page, cow_valid=best_j,
                               keys=keys)
        return PrefixMatch(pages=pages, n_tokens=n, keys=keys)

    # ---------------------------------------------------------- publish

    def publish(self, ids, pages: List[int],
                salt: int = 0) -> Tuple[List[int], List[int]]:
        """Register the prompt ``ids`` whose logical pages are ``pages``
        (physical ids, chunk order — the slot's page-table row).

        Full chunks (entirely inside the prompt → immutable) register under
        their chain key; a trailing partial chunk registers as a COW
        boundary entry.  Existing identical entries are LRU-touched, not
        replaced (their page already serves lookups; churning refs for an
        equal mapping buys nothing) — EXCEPT a demoted identical entry,
        which is rehydrated in place: the publisher's own freshly-prefilled
        page becomes the entry's device page (one new engine ref) and the
        host slab is dropped.  Returns ``(newly, released)`` page lists:
        the engine acquires one refcount per ``newly`` page and drops one
        per ``released`` page (collision replacements and LRU-cap
        evictions).  ``salt`` files every entry under that namespace's
        chain root (same contract as :meth:`lookup`)."""
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
            if e is not None and e.prev == h and e.tokens == chunk \
                    and e.epoch == self.epoch:
                if e.tier == "host":
                    # rehydrate: the publisher just recomputed this exact
                    # chunk's K/V into pages[i] — point the entry at it
                    # instead of keeping a host slab for content that is
                    # hot again (the buffer drops via on_drop_host)
                    e.tier, e.page = "hbm", pages[i]
                    self.demoted -= 1
                    if self.on_drop_host is not None:
                        self.on_drop_host(key)
                    newly.append(pages[i])
                self._entries.move_to_end(key)
            else:
                if e is not None:
                    # chain-hash collision — or a same-content entry from a
                    # RETIRED weight epoch: replace outright, INCLUDING
                    # every entry published under the collided key's chain
                    # (deeper full chunks and partial boundary children).
                    # A collision describes a DIFFERENT prefix; left
                    # reachable, the new chain would verify their per-chunk
                    # tokens yet map K/V computed under the old prefix — the
                    # one way a collision could serve wrong pages instead of
                    # a miss.  A stale epoch is the same hazard from the
                    # other direction: same tokens, OLD weights.
                    released.extend(self._remove_subtree(key))
                self._entries[key] = _Entry(page=pages[i], tokens=chunk,
                                            prev=h, full=True,
                                            epoch=self.epoch)
                self._full_children.setdefault(h, set()).add(key)
                newly.append(pages[i])
            h, i = key, i + 1
        part = tup[i * ps:]
        if part:
            pk = ("p", h, part)
            pe = self._entries.get(pk)
            if pe is not None and pe.epoch != self.epoch:
                # stale-epoch boundary page: the publisher recomputed this
                # partial chunk under the live weights — replace the entry
                p = self._remove(pk)
                if p is not None:
                    released.append(p)
                pe = None
            if pe is not None:
                self._entries.move_to_end(pk)
            else:
                self._entries[pk] = _Entry(page=pages[i], tokens=part,
                                           prev=h, full=False,
                                           epoch=self.epoch)
                self._children.setdefault(h, set()).add(pk)
                newly.append(pages[i])
        while len(self._entries) > self.max_entries:
            released.extend(self.evict(1))
        return newly, released

    # --------------------------------------------------------- tiering

    def reclaim_candidate(self) -> Optional[Tuple[object, _Entry]]:
        """LRU-most entry still holding a device page — what pool pressure
        should demote (full) or evict (partial) next; ``None`` when every
        remaining entry is already on the host tier."""
        for key, e in self._entries.items():
            if e.tier == "hbm":
                return key, e
        return None

    def entry(self, key) -> Optional[_Entry]:
        return self._entries.get(key)

    def demote(self, key) -> int:
        """Flip a full HBM entry to the host tier (the engine already
        parked its slab); returns the device page to release."""
        e = self._entries[key]
        if not e.full or e.tier != "hbm":
            raise ValueError(f"entry {key!r} is not a demotable full HBM "
                             f"chunk (full={e.full}, tier={e.tier})")
        page, e.page, e.tier = e.page, -1, "host"
        self.demoted += 1
        return page

    def promote(self, key, page: int) -> None:
        """Flip a demoted entry back to HBM at ``page`` (the engine just
        injected its slab there and holds the index's reference)."""
        e = self._entries[key]
        if e.tier != "host":
            raise ValueError(f"entry {key!r} is not demoted")
        e.tier, e.page = "hbm", int(page)
        self.demoted -= 1
        self._entries.move_to_end(key)

    def evict_key(self, key) -> Optional[int]:
        """Remove one specific entry (any tier); returns its device page
        when it held one, ``None`` otherwise (absent, or demoted — the
        host buffer drops via ``on_drop_host``)."""
        if key not in self._entries:
            return None
        self.evictions += 1
        return self._remove(key)

    def digest(self, cap: int = 1024) -> List[Tuple[int, int]]:
        """Compact residency digest: ``(chain_key, tier)`` per full entry,
        MRU first, capped at ``cap`` — what a fleet member publishes
        through the coordination store so the router can route
        shared-prefix requests to the engine already holding the prefix
        (tier 0 = HBM/hot, 1 = host/demoted; docs/FLEET.md)."""
        out: List[Tuple[int, int]] = []
        for key, e in reversed(self._entries.items()):
            if not e.full:
                continue
            out.append((int(key), 0 if e.tier == "hbm" else 1))
            if len(out) >= cap:
                break
        return out

    def adopt_demoted(self, other: "PrefixIndex") -> List[object]:
        """Re-register another index's DEMOTED full entries here (warm
        restart / recycle carry): host slabs outlive the dead engine's
        device pool, so the replacement can keep serving promotions from
        them.  HBM entries died with the pool and are skipped; chain keys
        are content-derived, so adopted entries re-chain correctly and
        temporarily-orphaned ones behave exactly like eviction orphans.
        Returns the adopted keys (the engine moves their buffers)."""
        if other.epoch != self.epoch:
            # a cross-epoch carry would adopt K/V computed under retired
            # weights (docs/HYBRID.md) — the caller syncs epochs BEFORE
            # adopting (ServingSupervisor does); a mismatch here means the
            # donor's entries are stale by contract, so adopt nothing
            return []
        demoted = [(k, e) for k, e in other._entries.items()
                   if e.full and e.tier == "host" and k not in self._entries
                   and e.epoch == other.epoch]
        adopted: List[object] = []
        budget = self.max_entries - len(self._entries)
        if budget <= 0:
            return adopted      # full index adopts nothing (lst[-0:] trap)
        for key, e in demoted[-budget:]:           # keep the MRU-most
            self._entries[key] = _Entry(page=-1, tokens=e.tokens,
                                        prev=e.prev, full=True, tier="host",
                                        epoch=self.epoch)
            self._full_children.setdefault(e.prev, set()).add(key)
            self.demoted += 1
            adopted.append(key)
        return adopted

    # ----------------------------------------------------------- evict

    def _remove(self, key) -> Optional[int]:
        e = self._entries.pop(key)
        kids = (self._children if not e.full
                else self._full_children).get(e.prev)
        if kids is not None:
            kids.discard(key)
            if not kids:
                del (self._children if not e.full
                     else self._full_children)[e.prev]
        if e.tier == "host":
            self.demoted -= 1
            if self.on_drop_host is not None:
                self.on_drop_host(key)
            return None
        return e.page

    def _remove_subtree(self, key) -> List[int]:
        """Remove the entry at ``key`` plus every descendant chained under
        it (deeper full chunks and partial boundary children); returns
        their device pages (demoted descendants release host buffers via
        ``on_drop_host`` instead).  Only the collision-replacement path
        calls this."""
        pages = []
        p = self._remove(key)
        if p is not None:
            pages.append(p)
        stack = [key]
        while stack:
            h = stack.pop()
            for pk in list(self._children.get(h, ())):
                p = self._remove(pk)
                if p is not None:
                    pages.append(p)
            kids = list(self._full_children.get(h, ()))
            for k in kids:
                p = self._remove(k)
                if p is not None:
                    pages.append(p)
            stack.extend(kids)
        return pages

    def flush(self) -> List[int]:
        """Drop EVERY entry — the weight-epoch flip (docs/HYBRID.md): all
        cached K/V describes retired weights the moment the live params
        move, so the engine flushes the whole index in one step (demoted
        entries release their host buffers via ``on_drop_host``).  Returns
        the device pages released (one engine refcount each).  Counted as
        ``invalidations``, not ``evictions`` — these are correctness
        invalidations, not capacity pressure."""
        released: List[int] = []
        for key in list(self._entries):
            if key not in self._entries:   # removed as part of a subtree
                continue
            self.invalidations += 1
            p = self._remove(key)
            if p is not None:
                released.append(p)
        return released

    def evict(self, n: int = 1) -> List[int]:
        """Drop the ``n`` least-recently-used entries; returns their device
        pages (one engine refcount each to release — demoted entries
        contribute none; their host buffers drop via ``on_drop_host``).  A
        released page only becomes reusable once every OTHER reference (a
        slot still decoding through it) is gone — the engine's refcount
        arbitrates."""
        released: List[int] = []
        for _ in range(min(n, len(self._entries))):
            key = next(iter(self._entries))
            p = self._remove(key)
            if p is not None:
                released.append(p)
            self.evictions += 1
        return released
