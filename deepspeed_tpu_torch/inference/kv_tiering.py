"""KV-page tiering: a host-RAM tier behind the paged KV pool (counterpart
of ``deepspeed_tpu/inference/kv_tiering.py``).

Under pool pressure a cold *full* prefix page is **demoted** instead of
evicted: its slabs (``[L, page, Hkv, hd]`` k and v, plus an int8 pool's
``[L, page]`` scale rows) are copied to pinned host tensors, the device
page returns to the free list, and the :class:`~.prefix_cache.PrefixIndex`
entry stays matchable with ``tier="host"``.  A later prefix hit
**promotes** the page: the slabs are copied into a freshly allocated
device page and admission maps it like any resident page.  The moves are
the executor's (``MeshExecutor.extract``/``inject``): the device-to-host
copy is asynchronous on the current stream with an event recorded after
it, and :meth:`HostTier.get` waits for that event before the host reads
the slab; the host-to-device copy of a promote is issued on the stream the
decode graph replays on, so it is ordered before the next replay.  Under
a mesh each rank moves its own KV heads' slab.

Contracts (as in the JAX package): the device-pool invariant ``free +
quarantined + referenced == num_pages - 1`` is untouched (a demoted entry
holds no device page) and extends with the demoted ledger (the index's
demoted entries == the tier's slabs); the round trip is a byte copy, so a
promoted prefix decodes exactly as a never-demoted one.  Only full chunks
demote (a partial boundary page is still mutable).  The speculative draft
pool is not tiered: a promoted page's draft side is whatever that physical
page holds, which costs draft acceptance, never correctness.

:class:`HostTier` is plain LRU storage with a page-count cap; the engine
owns the policy.  Host slabs outlive a dead engine's device pool, so a
supervisor's replacement engine adopts them
(``ServingEngine.adopt_host_tier``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["HostTier", "extract_pool_page", "inject_pool_page"]


def _nbytes(s) -> int:
    if isinstance(s, torch.Tensor):
        return s.numel() * s.element_size()
    return int(np.asarray(s).nbytes)


def extract_pool_page(pools, src: int, pin: bool = False):
    """Physical page ``src`` of every pool tensor, copied to host tensors in
    canonical pool order: ``[L, page, Hkv, hd]`` for k/v, ``[L, page]`` for
    an int8 pool's scale planes (int8 pages move as raw codes and scales,
    never re-expanded).  From a card the copies are asynchronous into
    pinned memory (``pin``): returns ``(slabs, event)``, the event recorded
    after the copies on the current stream (None on the CPU).  The pool is
    only read."""
    slabs = []
    for a in pools:
        page = a[:, src]
        if a.device.type == "cpu":
            slabs.append(page.clone())
            continue
        out = torch.empty(page.shape, dtype=page.dtype, pin_memory=pin)
        out.copy_(page, non_blocking=pin)
        slabs.append(out)
    event = None
    if pools and pools[0].device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(pools[0].device))
    return tuple(slabs), event


def inject_pool_page(pools, slabs, dst: int):
    """Write one page's host slabs into physical page ``dst`` of the pools,
    in place (the promote half).  From pinned slabs the copies are
    asynchronous on the current stream, ordered before whatever that stream
    runs next (the decode graph's replay)."""
    for a, s in zip(pools, slabs):
        t = s if isinstance(s, torch.Tensor) else torch.from_numpy(np.asarray(s))
        a[:, dst].copy_(t, non_blocking=t.is_pinned())
    return tuple(pools)


class HostTier:
    """LRU store of demoted KV pages: index chain key -> host slab tuple.

    Pure host-side storage (CPU tensors, pinned when the pool is on a
    card; numpy arrays are taken too).  The serving engine owns the
    policy — what demotes, when capacity evicts, and the demoted ledger;
    the tier only holds buffers and their LRU order.  ``max_pages`` caps
    the buffer count; ``page_bytes`` (k+v bytes of one page, constant for
    the pool's lifetime) prices the ``host_tier_bytes`` gauge without
    touching the buffers.
    """

    def __init__(self, max_pages: int, page_bytes: int = 0):
        self.max_pages = int(max_pages)
        if self.max_pages < 1:
            raise ValueError(f"max_pages={max_pages} must be >= 1")
        self.page_bytes = int(page_bytes)
        # slab TUPLES in canonical pool order: (hk, hv) for a full-precision
        # pool, (hk, hv, hk_scale, hv_scale) for an int8 one — byte
        # accounting sums every member, so the scale planes are priced in
        self._buffers: "OrderedDict[object, Tuple[np.ndarray, ...]]" \
            = OrderedDict()
        # weight epoch each slab was extracted under (docs/HYBRID.md):
        # get(epoch=...) refuses a slab from any other epoch, so even a
        # stranded pre-update slab can never be injected after a live
        # param update — the engine's flush is the primary mechanism, the
        # stamp is the proof
        self._epochs: Dict[object, int] = {}
        # the copy event of each slab still in flight from the device
        self._ready: Dict[object, object] = {}
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._buffers)

    def __contains__(self, key) -> bool:
        return key in self._buffers

    def bytes(self) -> int:
        """Host RAM currently held by demoted pages (actual buffer bytes)."""
        return self._bytes

    def full(self) -> bool:
        return len(self._buffers) >= self.max_pages

    def oldest_key(self):
        """LRU-most key (the capacity-eviction victim), or None."""
        return next(iter(self._buffers)) if self._buffers else None

    def keys(self) -> Iterable:
        return self._buffers.keys()

    def put(self, key, *slabs, epoch: int = 0, ready=None) -> None:
        """Store one demoted page's slab tuple (the caller made room
        first), stamped with the weight ``epoch`` it was extracted under.
        ``ready`` is the copy's CUDA event when the slabs are still being
        written from the device: :meth:`get` waits for it before a host
        read.  A re-demotion of a key replaces the old slabs (same content:
        chain keys are content-derived, so the bytes just re-account)."""
        old = self._buffers.pop(key, None)
        if old is not None:
            self._bytes -= sum(_nbytes(s) for s in old)
        self._buffers[key] = tuple(slabs)
        self._epochs[key] = int(epoch)
        if ready is not None:
            self._ready[key] = ready
        else:
            self._ready.pop(key, None)
        self._bytes += sum(_nbytes(s) for s in slabs)

    def get(self, key, touch: bool = True, epoch: Optional[int] = None):
        """The slab for ``key``, its device copy complete; or ``None`` when
        absent, or when ``epoch`` is given and the slab was extracted under
        a DIFFERENT weight epoch (stale K/V must never be injected)."""
        data = self._buffers.get(key)
        if data is None:
            return None
        if epoch is not None and self._epochs.get(key, 0) != int(epoch):
            return None
        ready = self._ready.pop(key, None)
        if ready is not None:
            ready.synchronize()
        if touch:
            self._buffers.move_to_end(key)
        return data

    def epoch_of(self, key) -> Optional[int]:
        """Weight epoch the stored slab was extracted under (None=absent)."""
        return self._epochs.get(key) if key in self._buffers else None

    def touch(self, key) -> None:
        if key in self._buffers:
            self._buffers.move_to_end(key)

    def pop(self, key):
        data = self._buffers.pop(key, None)
        self._epochs.pop(key, None)
        ready = self._ready.pop(key, None)
        if ready is not None:
            ready.synchronize()
        if data is not None:
            self._bytes -= sum(_nbytes(s) for s in data)
        return data

    def discard(self, key) -> None:
        """Idempotent removal — the ``PrefixIndex.on_drop_host`` hook, so
        an entry removed from the index (eviction, collision subtree,
        LRU cap) can never strand its host buffer."""
        self.pop(key)

    def adopt(self, other: "HostTier",
              keys: Optional[Iterable] = None) -> List:
        """Move buffers from a dead engine's tier into this one (LRU order
        preserved, capacity respected — oldest surplus dropped).  Returns
        the keys actually adopted; ``keys`` restricts the carry to entries
        the new prefix index re-registered."""
        wanted = set(keys) if keys is not None else None
        items = [(k, d) for k, d in other._buffers.items()
                 if wanted is None or k in wanted]
        free = self.max_pages - len(self._buffers)
        if free <= 0:
            return []
        adopted = []
        # slice BEFORE inserting so a pre-populated tier keeps the donor's
        # MRU-most surplus, not its LRU-most (order inside the keep is
        # still LRU→MRU, preserving recency here)
        for k, slabs in items[-free:]:
            self.put(k, *slabs, epoch=other._epochs.get(k, 0),
                     ready=other._ready.get(k))
            adopted.append(k)
        return adopted
