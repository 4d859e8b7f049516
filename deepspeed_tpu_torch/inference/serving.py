"""Continuous-batching serving engine: slot-based decode over a paged KV
pool (counterpart of ``deepspeed_tpu/inference/serving.py``).

:class:`ServingEngine` keeps a fixed fleet of ``b_slots`` decode slots over
ONE paged KV pool (``models.transformer.init_paged_cache``: physical page 0
is the trash page).  Each :meth:`~ServingEngine.step` retires finished
slots, admits queued requests into free slots through bucketed ``[1,
S_pad]`` prefills that write straight into the pool, and runs ONE decode
step over all slots (inactive slots ride along masked).  On CUDA the decode
step is one CUDA graph replay (``execution.py``), whose attention is the
hand-written K4 kernel, launched once per layer.

Scheduling (as in the JAX package): FIFO admission with head-of-line
blocking; pages for the whole request (prompt + max_new) are reserved at
admission, so a running slot never runs out of pages.  Pages are
refcounted and immutable once full; a prefix index
(``prefix_cache.PrefixIndex``) lets a request whose prompt prefix is
resident map the shared pages and prefill only its tail, copying a partial
boundary page (copy-on-write).  The pool invariant is ``free + quarantined
+ referenced == num_pages - 1`` (:meth:`~ServingEngine.page_accounting`).
Per-request deadlines, a bounded queue with load shedding, slot quarantine
after ``quarantine_limit`` consecutive prefill failures, :meth:`health` and
:meth:`drain` follow the JAX engine.  Sampled requests use per-slot lanes
with counter-based generators (``sampling.position_generator``), so a
served stream equals ``InferenceEngine.generate(sampling=...)`` on the same
logits.

Tensor-parallel serving (``mesh=``, from
``parallel.mesh.initialize_serving_mesh``): one process per device, each
running this engine on the same request stream; the executor holds the
rank's model-axis shards and KV heads.  Every host decision must then
agree across the ranks, or a collective of the decode step waits forever:
admission, page accounting, sampling (the same gathered logits and lane
seeds) and shedding follow from the shared stream, and the one wall-clock
input, the scheduler's ``now`` (arrivals, deadlines), is rank 0's,
broadcast on each tick that reads it (or the caller's ``step(now=)``,
which every rank passes alike).

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item (queue 1): the host-RAM KV tier, speculative decoding,
per-request adapters, int8 pages and the serving supervisor's probe (item
7); live weight updates (item 11); the monitor, watchdog, SLO rules,
per-program statistics and fault-injection sites (item 12).  Trace ids
stay None.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from ..models.transformer import PAGE_SIZE
from ..utils.logging import log_dist, logger
from .execution import MeshExecutor
from .prefix_cache import PrefixIndex, PrefixMatch
from .sampling import SamplingParams, as_lanes

# a COW boundary match must save at least this much prefill to be worth a
# cross-layer page snapshot
MIN_COW_TOKENS = 2


def _bucket(n: int) -> int:
    """Prompt-length bucket (next power of two >= 16), as generate()'s."""
    b = 16
    while b < n:
        b *= 2
    return b


def _refused(option: str, item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option}: {what} is not ported yet (ROADMAP queue 1, item {item})")


class ServeTimeout(RuntimeError):
    """``run``/``drain`` exceeded its ``max_ticks`` budget."""


class SlotPrefillError(RuntimeError):
    """A prefill failed in a way attributable to one slot/request; the
    reservation was unwound and the request re-queued."""

    def __init__(self, msg: str, slot: int, rid: Any, quarantined: bool):
        super().__init__(msg)
        self.slot = slot
        self.rid = rid
        self.quarantined = quarantined


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival_time`` is seconds relative to the
    start of :meth:`ServingEngine.run` (0 = available immediately);
    ``deadline_s`` is a serving budget measured from arrival."""
    rid: Any
    input_ids: np.ndarray
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    arrival_time: float = 0.0
    deadline_s: Optional[float] = None
    arrival_epoch_s: Optional[float] = None
    # per-request sampling lane (None = greedy)
    sampling: Optional[SamplingParams] = None
    trace_id: Optional[str] = None
    adapter_id: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    rid: Any
    input_ids: np.ndarray
    output_ids: np.ndarray          # generated tokens (incl. eos when hit)
    finish_reason: str              # "eos" | "length" | "deadline" | "shed"
    prefill_bucket: int
    # absolute time.monotonic() stamps (arrival = admission availability)
    arrival_s: float = 0.0
    admit_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    retry_after_s: Optional[float] = None
    # decode steps that fed this request (the prefill token is not one)
    decode_ticks: int = 0
    replays: int = 0
    shared_prefix_tokens: int = 0   # prompt tokens served from the index
    failovers: int = 0
    resumed_tokens: int = 0
    trace_id: Optional[str] = None
    adapter_id: Optional[str] = None
    # ordered (event, t, engine incarnation) tuples:
    # queued -> admit -> [prefix_match/cow] -> prefill -> first_token -> finish
    lifecycle: List = dataclasses.field(default_factory=list)

    @property
    def ttft_s(self) -> float:
        """Time to first token, from arrival (includes queueing)."""
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queued_s(self) -> float:
        return self.admit_s - self.arrival_s


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: List[int]            # shared prefix pages first, then private
    tokens: List[int]
    bucket: int
    arrival_s: float
    admit_s: float
    first_token_s: float
    shared_tokens: int = 0
    decode_ticks: int = 0
    lifecycle: List = dataclasses.field(default_factory=list)


class ServingEngine:
    """Iteration-level scheduler over a fixed slot fleet + paged KV pool.

    ``model`` must expose the paged decode contract (``init_paged_cache`` /
    ``apply_paged``, see ``models.CausalLM``); ``params`` are used as given
    (:meth:`InferenceEngine.serving` shares the engine's).  ``device``
    defaults to the accelerator's (CUDA)."""

    def __init__(self, model, params, b_slots: int = 4,
                 page_size: int = PAGE_SIZE, num_pages: Optional[int] = None,
                 max_model_len: Optional[int] = None, monitor=None,
                 watchdog=None, dtype=None, kv_dtype=None, mesh=None,
                 max_queue: Optional[int] = None, quarantine_limit: int = 2,
                 probe_after_ticks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefix_index_entries: int = 4096,
                 host_tier_pages: Optional[int] = None,
                 speculative=None, program_stats_sample_every: int = 0,
                 slo_rules=None, adapters=None, device=None):
        for option, value, item, what in (
                ("monitor", monitor, 12, "the serve/* gauges"),
                ("watchdog", watchdog, 12, "the hang watchdog"),
                ("slo_rules", slo_rules or None, 12, "SLO evaluation"),
                ("program_stats_sample_every", program_stats_sample_every or None,
                 12, "per-program statistics"),
                ("probe_after_ticks", probe_after_ticks, 7,
                 "the quarantine canary probe (serving supervisor)"),
                ("host_tier_pages", host_tier_pages, 7, "the host-RAM KV tier"),
                ("speculative", speculative, 7, "speculative decoding"),
                ("adapters", adapters, 7, "multi-tenant adapter serving")):
            if value is not None:
                raise _refused(option, item, what)
        if not hasattr(model, "apply_paged"):
            raise ValueError(
                "ServingEngine needs a model with the paged decode contract "
                "(init_paged_cache/apply_paged); see models.CausalLM")
        self.model = model
        self.b_slots = int(b_slots)
        self.page_size = int(page_size)
        self.max_model_len = int(max_model_len or model.config.max_seq_len)
        if self.max_model_len > model.config.max_seq_len:
            raise ValueError(
                f"max_model_len={self.max_model_len} exceeds the model's "
                f"max_seq_len={model.config.max_seq_len}")
        self.pages_per_slot = -(-self.max_model_len // self.page_size)
        # +1: physical page 0 is the reserved trash page
        full = 1 + self.b_slots * self.pages_per_slot
        self.num_pages = int(num_pages) if num_pages is not None else full
        if self.num_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold one full slot "
                f"({self.pages_per_slot} pages of {self.page_size} tokens "
                f"+ the trash page)")
        self.max_queue = int(max_queue) if max_queue is not None else None
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")
        self.quarantine_limit = int(quarantine_limit)
        if self.quarantine_limit < 1:
            raise ValueError(
                f"quarantine_limit={self.quarantine_limit} must be >= 1")
        self._exec = MeshExecutor(model, params, self.num_pages,
                                  self.page_size, self.b_slots,
                                  self.pages_per_slot, dtype=dtype,
                                  kv_dtype=kv_dtype, mesh=mesh,
                                  prefix_cache=prefix_cache, device=device)
        self.params = self._exec.params   # the rank's shards on a mesh
        self._free_pages: List[int] = list(range(self.num_pages - 1, 0, -1))
        # per-page refcounts (page 0, the trash page, is never counted)
        self._refcount = np.zeros((self.num_pages,), np.int64)
        self._prefix = (PrefixIndex(self.page_size,
                                    max_entries=prefix_index_entries)
                        if prefix_cache else None)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_shared_tokens = 0
        self.prefix_pages_shared = 0
        self.cow_copies = 0
        self._pages_hwm = 0
        self._page_table = np.zeros((self.b_slots, self.pages_per_slot),
                                    np.int32)
        self._lengths = np.zeros((self.b_slots,), np.int32)
        self._last_tok = np.zeros((self.b_slots,), np.int32)
        self._active = np.zeros((self.b_slots,), bool)
        # per-slot sampling lanes; greedy is the temperature <= 0 lane value
        self._lane_temp = np.zeros((self.b_slots,), np.float32)
        self._lane_top_k = np.zeros((self.b_slots,), np.int32)
        self._lane_top_p = np.ones((self.b_slots,), np.float32)
        self._lane_seed = np.zeros((self.b_slots,), np.int64)
        self.sampled_admissions = 0
        self._slots: List[Optional[_Slot]] = [None] * self.b_slots
        self._queue: Deque[Request] = deque()
        self._pending: List[Request] = []   # arrival-gated, sorted by time
        self._live_rids: set = set()
        self.engine_incarnation = 0
        self._lifecycle_pending: Dict[Any, List] = {}
        self._results: Dict[Any, RequestResult] = {}
        self._finished_order: List[Any] = []
        self._tick = 0
        self._tokens_out = 0
        self._t0 = time.monotonic()
        self._quarantined = np.zeros((self.b_slots,), bool)
        self._quarantined_pages: List[int] = []
        self._slot_failures = np.zeros((self.b_slots,), np.int64)
        self._last_failure_tick = 0
        self._draining = False
        self._waiting_deadlines = 0
        self.shed_count = 0
        self.deadline_count = 0
        self._ema_service_s: Optional[float] = None
        log_dist(f"serving engine ready: b_slots={self.b_slots} "
                 f"pages={self.num_pages}x{self.page_size} "
                 f"(max_model_len={self.max_model_len}) "
                 f"device={self._exec.device}", ranks=[0])

    def program_inventory(self) -> Dict[str, Any]:
        """One decode step + one prefill per prompt bucket (+ the COW page
        copy with prefix caching).  Constant at steady state: admission
        never grows it beyond the bucket set, and the decode step is
        captured once (``captures`` counts CUDA-graph captures; 0 on the
        CPU, where decode runs eagerly)."""
        inv = self._exec.program_inventory()
        inv["captures"] = self._exec.captures
        return inv

    def close(self) -> None:
        """Release the device half (the decode graph, the pool); the
        engine serves no more.  On a mesh of several ranks every rank calls
        it before ``comm.destroy_process_group()``."""
        self._exec.close()

    def update_params(self, params, draft_params=None, epoch=None):
        raise _refused("update_params", 11, "live weight updates (weight epochs)")

    def fuse_adapter(self, adapter_id=None, epoch=None):
        raise _refused("fuse_adapter", 7, "multi-tenant adapter serving")

    # ---------------------------------------------------------- scheduling

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.input_ids) + req.max_new_tokens) // self.page_size)

    def _alloc_pages(self, n: int) -> List[int]:
        """Pop ``n`` free pages and take the first reference on each."""
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        occupied = (self.num_pages - 1) - len(self._free_pages)
        self._pages_hwm = max(self._pages_hwm, occupied)
        return pages

    def _share_page(self, p: int) -> None:
        self._refcount[p] += 1

    def _drop_page(self, p: int) -> None:
        """Release one reference; the last reference frees the page."""
        c = int(self._refcount[p]) - 1
        if c < 0:
            raise RuntimeError(
                f"page {p} dropped below zero references: double free "
                "(page accounting is corrupt; rebuild the engine)")
        self._refcount[p] = c
        if c == 0:
            self._free_pages.append(p)

    def _leak_pages(self, pages: List[int]) -> None:
        """Quarantine: zero the refs without freeing (suspect contents are
        leaked-and-accounted, never recycled)."""
        for p in pages:
            self._refcount[p] = 0
        self._quarantined_pages.extend(pages)

    def page_accounting(self) -> Dict[str, Any]:
        """The refcount pool invariant: every page but the trash page is
        exactly one of free, quarantined or referenced (by slots and/or the
        prefix index; ``cached`` counts the index's, a subset)."""
        referenced = int((self._refcount[1:] > 0).sum())
        free = len(self._free_pages)
        quarantined = len(self._quarantined_pages)
        return {
            "free": free,
            "quarantined": quarantined,
            "referenced": referenced,
            "cached": len(self._prefix) if self._prefix is not None else 0,
            "demoted": 0,
            "host_tier_bytes": 0,
            "total": self.num_pages - 1,
            "balanced": free + quarantined + referenced == self.num_pages - 1,
        }

    def _prefix_lookup(self, req: Request) -> PrefixMatch:
        """Longest resident prefix for ``req``, capped at prompt-1 so at
        least one token always goes through prefill."""
        if self._prefix is None or len(self._prefix) == 0:
            return PrefixMatch(pages=[], n_tokens=0)
        m = self._prefix.lookup(req.input_ids, limit=len(req.input_ids) - 1)
        if m.cow_src is not None and m.cow_valid < MIN_COW_TOKENS:
            # not worth a page snapshot: keep the full-page share
            return PrefixMatch(pages=m.pages,
                               n_tokens=len(m.pages) * self.page_size,
                               keys=m.keys)
        return m

    def _reclaim_cached(self, n_pages: int) -> None:
        """Pool pressure: evict cached-but-idle prefix pages, LRU first,
        until ``n_pages`` more pages are actually free or nothing is left
        to evict."""
        freed = 0
        while freed < n_pages and self._prefix is not None \
                and len(self._prefix):
            before = len(self._free_pages)
            for p in self._prefix.evict(1):
                self._drop_page(p)
            freed += len(self._free_pages) - before

    def _arrival_abs(self, req: Request) -> float:
        if req.arrival_epoch_s is not None:
            return req.arrival_epoch_s
        return self._t0 + req.arrival_time

    def _usable_slots(self) -> int:
        return int(self.b_slots - self._quarantined.sum())

    def _retry_after_hint(self) -> float:
        """Waves of requests ahead times the EMA of observed service time."""
        per_req = self._ema_service_s if self._ema_service_s else 0.25
        backlog = (len(self._queue) + len(self._pending)
                   + int(self._active.sum()))
        lanes = max(1, self._usable_slots())
        waves = max(1, -(-max(backlog, 1) // lanes))
        return round(per_req * waves, 4)

    def _shed(self, request: Request, why: str) -> Any:
        t = time.monotonic()
        hint = self._retry_after_hint()
        lc = self._lifecycle_pending.pop(request.rid, [])
        lc.append(("shed", t, self.engine_incarnation))
        self._results[request.rid] = RequestResult(
            rid=request.rid, input_ids=request.input_ids,
            output_ids=np.zeros((0,), np.int32), finish_reason="shed",
            prefill_bucket=0, arrival_s=t, admit_s=t, first_token_s=t,
            finish_s=t, retry_after_s=hint, trace_id=request.trace_id,
            lifecycle=lc)
        self._finished_order.append(request.rid)
        self._live_rids.add(request.rid)
        self.shed_count += 1
        logger.warning("serve: shed request %r (%s); retry_after=%.3fs",
                       request.rid, why, hint)
        return request.rid

    def _expire(self, now: float) -> None:
        """Finish every request whose deadline has passed: queued ones
        with an empty "deadline" result, in-flight ones with the tokens so
        far (their slot and pages come back this tick)."""
        if self._queue and self._waiting_deadlines:
            keep: Deque[Request] = deque()
            for req in self._queue:
                if (req.deadline_s is not None
                        and now >= req.arrival_time + req.deadline_s):
                    self._waiting_deadlines -= 1
                    t = time.monotonic()
                    lc = self._lifecycle_pending.pop(req.rid, [])
                    lc.append(("deadline", t, self.engine_incarnation))
                    self._results[req.rid] = RequestResult(
                        rid=req.rid, input_ids=req.input_ids,
                        output_ids=np.zeros((0,), np.int32),
                        finish_reason="deadline", prefill_bucket=0,
                        arrival_s=self._arrival_abs(req), admit_s=t,
                        first_token_s=t, finish_s=t,
                        retry_after_s=self._retry_after_hint(),
                        trace_id=req.trace_id, lifecycle=lc)
                    self._finished_order.append(req.rid)
                    self.deadline_count += 1
                    logger.warning("serve: request %r expired in queue "
                                   "(deadline %.3fs)", req.rid, req.deadline_s)
                else:
                    keep.append(req)
            self._queue = keep
        for slot in np.flatnonzero(self._active):
            req = self._slots[slot].request
            if (req.deadline_s is not None
                    and now >= req.arrival_time + req.deadline_s):
                logger.warning("serve: request %r expired in flight after "
                               "%d token(s) (deadline %.3fs)", req.rid,
                               len(self._slots[slot].tokens), req.deadline_s)
                self._finish(slot, "deadline")

    def submit(self, request: Request) -> Any:
        """Queue a request (FIFO) after checking that it can ever be
        served.  While draining, or with ``max_queue`` waiting requests,
        the request is shed with a terminal "shed" result instead."""
        ids = np.asarray(request.input_ids, np.int32).reshape(-1)
        request = dataclasses.replace(request, input_ids=ids)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = ids.size + request.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {request.rid!r}: prompt {ids.size} + max_new "
                f"{request.max_new_tokens} exceeds max_model_len "
                f"{self.max_model_len}")
        if self._pages_needed(request) > self.num_pages - 1:
            raise ValueError(
                f"request {request.rid!r} needs {self._pages_needed(request)} "
                f"pages but the pool holds {self.num_pages - 1}")
        if request.deadline_s is not None and request.deadline_s <= 0:
            raise ValueError(
                f"request {request.rid!r}: deadline_s={request.deadline_s} "
                "must be > 0 (measured from arrival)")
        if request.sampling is not None:
            request.sampling.validate()
        if request.adapter_id is not None:
            raise _refused("Request.adapter_id", 7, "multi-tenant adapter serving")
        rid = request.rid
        if rid in self._live_rids:
            raise ValueError(
                f"request id {rid!r} is already queued, in flight, or has "
                f"an unclaimed result; rids must be unique")
        backlog = len(self._queue) + len(self._pending)
        if self._draining or (self.max_queue is not None
                              and backlog >= self.max_queue):
            return self._shed(request,
                              "draining" if self._draining else "queue full")
        self._live_rids.add(rid)
        self._lifecycle_pending[rid] = [
            ("queued", time.monotonic(), self.engine_incarnation)]
        if request.deadline_s is not None:
            self._waiting_deadlines += 1
        if request.arrival_time > 0:
            bisect.insort(self._pending, request,
                          key=lambda r: r.arrival_time)
        else:
            self._queue.append(request)
        return request.rid

    def _admit(self, now: float) -> None:
        k = bisect.bisect_right(self._pending, now,
                                key=lambda r: r.arrival_time)
        if k:
            self._queue.extend(self._pending[:k])
            del self._pending[:k]
        while self._queue:
            req = self._queue[0]
            free_slots = [i for i in range(self.b_slots)
                          if not self._active[i] and not self._quarantined[i]]
            if not free_slots:
                break
            slot = free_slots[0]
            admitted = freed_pins = False
            match = self._prefix_lookup(req)
            # pin the matched pages (and the COW source) for this
            # admission: reclaim below must never free a page it is about
            # to map
            pinned = list(match.pages)
            if match.cow_src is not None:
                pinned.append(match.cow_src)
            for p in pinned:
                self._share_page(p)
            try:
                need = self._pages_needed(req) - len(match.pages)
                if len(self._free_pages) < need:
                    self._reclaim_cached(need - len(self._free_pages))
                if len(self._free_pages) >= need:
                    self._admit_one(req, slot, match, need, now)
                    admitted = True
            finally:
                if not admitted:
                    freed_pins = any(self._refcount[p] == 1 for p in pinned)
                for p in pinned:
                    self._drop_page(p)
            if admitted:
                continue
            if freed_pins:
                # reclaim evicted the head's own matched entries and the
                # pages came free as the pins dropped: retry with a fresh
                # lookup (each retry means the index strictly shrank)
                continue
            break   # head-of-line: wait for retirements

    def _admit_one(self, req: Request, slot: int, match: PrefixMatch,
                   need: int, now: float) -> None:
        """Pop the queue head into ``slot`` and prefill its unshared tail:
        one reference per shared page, a fresh allocation for the rest."""
        self._queue.popleft()
        self._lifecycle_pending.setdefault(req.rid, []).append(
            ("admit", time.monotonic(), self.engine_incarnation))
        if req.deadline_s is not None:
            self._waiting_deadlines -= 1
        shared = list(match.pages)
        for p in shared:
            self._share_page(p)
        pages = self._alloc_pages(need)
        try:
            self._prefill(slot, req, shared, pages, match, now)
        except BaseException as e:
            # unwind: the request goes back to the head and the failure
            # counts against the slot; quarantine_limit consecutive
            # failures fence it, leaking this attempt's private pages into
            # the quarantine account (shared pages only drop their refs)
            if self._slots[slot] is None:
                self._page_table[slot, :] = 0
                self._queue.appendleft(req)
                if req.deadline_s is not None:
                    self._waiting_deadlines += 1
                for p in shared:
                    self._drop_page(p)
                if not isinstance(e, Exception):
                    for p in pages:
                        self._drop_page(p)
                    raise
                self._slot_failures[slot] += 1
                self._last_failure_tick = self._tick
                fails = int(self._slot_failures[slot])
                fenced = fails >= self.quarantine_limit
                if fenced:
                    self._quarantined[slot] = True
                    self._leak_pages(pages)
                    logger.error(
                        "serve: slot %d quarantined after %d consecutive "
                        "prefill failures; %d page(s) leaked-and-"
                        "accounted, %d slot(s) remain", slot, fails,
                        len(pages), self._usable_slots())
                else:
                    for p in pages:
                        self._drop_page(p)
                raise SlotPrefillError(
                    f"prefill failed in slot {slot} for request "
                    f"{req.rid!r} (failure {fails}/{self.quarantine_limit}"
                    f"{', slot quarantined' if fenced else ''}): {e}",
                    slot=slot, rid=req.rid, quarantined=fenced) from e
            raise

    def _prefill(self, slot: int, req: Request, shared: List[int],
                 private: List[int], match: PrefixMatch, now: float) -> None:
        """Prefill ``req`` into ``slot``: the page-table row maps the shared
        prefix pages first, then the private allocation; only the unshared
        tail runs through the prefill (``start`` = shared token count).
        When the match ends mid-page, the donor's boundary page is first
        snapshotted into this slot's own boundary page (copy-on-write)."""
        S = len(req.input_ids)
        n_shared = match.n_tokens
        pages = shared + private
        tail = req.input_ids[n_shared:]
        S_tail = len(tail)   # >= 1: lookup is capped at prompt-1
        s_pad = _bucket(S_tail)
        self._page_table[slot, :] = 0
        self._page_table[slot, :len(pages)] = pages
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :S_tail] = tail
        lane_t, lane_k, lane_p, lane_s = as_lanes(req.sampling)
        if match.cow_src is not None:
            # private[0] is the boundary logical page; rows past cow_valid
            # are donor rows the tail prefill overwrites before causality
            # can expose them
            self._exec.cow(match.cow_src, private[0])
            self.cow_copies += 1
        tok = self._exec.prefill(s_pad, self._page_table[slot:slot + 1], toks,
                                 S_tail, n_shared, lane_t, lane_k, lane_p,
                                 lane_s)
        t = time.monotonic()
        self._slot_failures[slot] = 0   # quarantine counts consecutive fails
        lc = self._lifecycle_pending.pop(req.rid, [])
        inc = self.engine_incarnation
        if n_shared > 0:
            lc.append(("prefix_match", t, inc))
        if match.cow_src is not None:
            lc.append(("cow", t, inc))
        lc.append(("prefill", t, inc))
        lc.append(("first_token", t, inc))
        self._slots[slot] = _Slot(
            request=req, pages=pages, tokens=[tok], bucket=s_pad,
            arrival_s=self._arrival_abs(req), admit_s=self._t0 + now,
            first_token_s=t, shared_tokens=n_shared, lifecycle=lc)
        self._lengths[slot] = S
        self._last_tok[slot] = tok
        self._active[slot] = True
        self._lane_temp[slot] = lane_t
        self._lane_top_k[slot] = lane_k
        self._lane_top_p[slot] = lane_p
        self._lane_seed[slot] = lane_s
        self._exec.invalidate_lanes()
        if req.sampling is not None and not req.sampling.greedy:
            self.sampled_admissions += 1
        self._tokens_out += 1
        if self._prefix is not None:
            if n_shared > 0:
                self.prefix_hits += 1
                self.prefix_shared_tokens += n_shared
                self.prefix_pages_shared += len(shared)
            else:
                self.prefix_misses += 1
            # publish this prompt's chunks (the index takes one reference
            # per new entry)
            newly, released = self._prefix.publish(req.input_ids, pages)
            for p in newly:
                self._share_page(p)
            for p in released:
                self._drop_page(p)
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(slot, "eos")
        elif req.max_new_tokens == 1:
            self._finish(slot, "length")

    def _lanes(self):
        return self._exec.lanes(self._lane_temp, self._lane_top_k,
                                self._lane_top_p, self._lane_seed)

    def _decode_tick(self) -> None:
        nxt = self._exec.decode(self._page_table, self._lengths,
                                self._last_tok, self._active, self._lanes())
        for slot in np.flatnonzero(self._active):
            st = self._slots[slot]
            req = st.request
            tok = int(nxt[slot])
            st.tokens.append(tok)
            st.decode_ticks += 1
            self._lengths[slot] += 1
            self._last_tok[slot] = tok
            self._tokens_out += 1
            if req.eos_token_id is not None and tok == req.eos_token_id:
                self._finish(slot, "eos")
            elif len(st.tokens) >= req.max_new_tokens:
                self._finish(slot, "length")

    def _finish(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
        finish_t = time.monotonic()
        st.lifecycle.append(("finish", finish_t, self.engine_incarnation))
        result = RequestResult(
            rid=st.request.rid, input_ids=st.request.input_ids,
            output_ids=np.asarray(st.tokens, np.int32),
            finish_reason=reason, prefill_bucket=st.bucket,
            arrival_s=st.arrival_s, admit_s=st.admit_s,
            first_token_s=st.first_token_s, finish_s=finish_t,
            decode_ticks=st.decode_ticks,
            shared_prefix_tokens=st.shared_tokens,
            trace_id=st.request.trace_id, lifecycle=st.lifecycle)
        if reason == "deadline":
            self.deadline_count += 1
        else:
            dt = max(result.finish_s - result.admit_s, 1e-6)
            self._ema_service_s = (dt if self._ema_service_s is None
                                   else 0.8 * self._ema_service_s + 0.2 * dt)
        self._results[st.request.rid] = result
        self._finished_order.append(st.request.rid)
        # one reference per page: shared pages stay for their other readers
        for p in st.pages:
            self._drop_page(p)
        self._slots[slot] = None
        self._active[slot] = False
        self._lengths[slot] = 0
        self._last_tok[slot] = 0
        self._page_table[slot, :] = 0
        self._lane_temp[slot] = 0.0
        self._lane_top_k[slot] = 0
        self._lane_top_p[slot] = 1.0
        self._lane_seed[slot] = 0
        self._exec.invalidate_lanes()

    # ------------------------------------------------------------ the loop

    def _reads_clock(self) -> bool:
        """Whether this tick's decisions read ``now``: a request waits for
        its arrival time or carries a deadline (the same answer on every
        rank, whose scheduler states are equal)."""
        return bool(self._pending) or self._waiting_deadlines > 0 or any(
            self._slots[s].request.deadline_s is not None
            for s in np.flatnonzero(self._active))

    def step(self, now: Optional[float] = None) -> int:
        """One scheduler tick: expire dead deadlines, admit into free
        slots, ONE decode step over all slots, then refill the slots that
        step retired.  Returns the number of requests still in flight or
        queued.  On a mesh of several ranks the clock is rank 0's."""
        self._tick += 1
        if now is None:
            now = time.monotonic() - self._t0
            if self._exec.ranks > 1 and self._reads_clock():
                now = self._exec.agree(now)
        self._expire(now)
        if not self._draining:
            self._admit(now)
        if self._active.any():
            self._decode_tick()
            if not self._draining:
                self._admit(now)
        return (int(self._active.sum()) + len(self._queue)
                + len(self._pending))

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: Optional[int] = None,
            resume: bool = False) -> List[RequestResult]:
        """Serve ``requests`` (plus anything already submitted) to
        completion; returns results in completion order.  ``arrival_time``
        offsets gate admission against the wall clock measured from this
        call (``resume=True`` keeps the previous run's clock)."""
        if not resume:
            self._t0 = time.monotonic()
            self._tokens_out = 0
        start_tick = self._tick
        for req in requests or []:
            self.submit(req)
        while True:
            pending = self.step()
            if pending == 0:
                break
            if max_ticks is not None and self._tick - start_tick >= max_ticks:
                raise ServeTimeout(
                    f"serve loop exceeded max_ticks={max_ticks} with "
                    f"{pending} request(s) outstanding")
            if not self._active.any():
                if self._draining:
                    raise RuntimeError(
                        "engine is draining: admission is closed and "
                        f"{len(self._queue) + len(self._pending)} "
                        "request(s) remain unserved; call drain() to "
                        "finish in-flight work and hand them back")
                if self._pending and not self._queue:
                    wait = (self._pending[0].arrival_time
                            - (time.monotonic() - self._t0))
                    if wait > 0:
                        time.sleep(wait)
                elif self._queue:
                    if self._usable_slots() == 0:
                        raise RuntimeError(
                            f"all {self.b_slots} slots quarantined with "
                            f"{len(self._queue)} request(s) queued; rebuild "
                            "the engine")
                    req = self._queue[0]
                    acct = self.page_accounting()
                    raise RuntimeError(
                        f"admission deadlock: request {req.rid!r} needs "
                        f"{self._pages_needed(req)} pages, "
                        f"{acct['free']} free ({acct['quarantined']} "
                        f"quarantined, {acct['referenced']} referenced) "
                        f"with no slot active")
        return self.take_results()

    def take_results(self) -> List[RequestResult]:
        """Claim every finished result (completion order) and release their
        rids for reuse."""
        order, self._finished_order = self._finished_order, []
        self._live_rids.difference_update(order)
        return [self._results.pop(rid) for rid in order]

    # ------------------------------------------------------- health / drain

    def _oldest_age_s(self, now_abs: float) -> float:
        arrivals = [st.arrival_s for st in self._slots if st is not None]
        if self._queue:
            arrivals.append(self._arrival_abs(self._queue[0]))
        if self._pending:
            arrivals.append(self._arrival_abs(self._pending[0]))
        return max(0.0, now_abs - min(arrivals)) if arrivals else 0.0

    def health(self) -> Dict[str, Any]:
        """One-call snapshot of the loop: queue, slots, pages, prefix cache
        and resilience counters (the JAX engine's keys whose features are
        ported)."""
        now = time.monotonic()
        acct = self.page_accounting()
        pb = self._exec.pool_bytes
        info = self._exec.mesh_info()
        return {
            "tick": self._tick,
            "mesh_devices": info["mesh_devices"],
            "mesh_axes": info["mesh_axes"],
            "kv_pool_bytes_total": pb["total"],
            "kv_pool_bytes_per_device": pb["per_device"],
            "kv_dtype": None,
            "draining": self._draining,
            "queue_depth": len(self._queue) + len(self._pending),
            "active_slots": int(self._active.sum()),
            "usable_slots": self._usable_slots(),
            "quarantined_slots": int(self._quarantined.sum()),
            "free_pages": acct["free"],
            "quarantined_pages": acct["quarantined"],
            "referenced_pages": acct["referenced"],
            "cached_pages": acct["cached"],
            "pages_hwm": self._pages_hwm,
            "shed_total": self.shed_count,
            "deadline_expired_total": self.deadline_count,
            "prefix_hits_total": self.prefix_hits,
            "prefix_misses_total": self.prefix_misses,
            "prefix_shared_tokens_total": self.prefix_shared_tokens,
            "prefix_pages_shared_total": self.prefix_pages_shared,
            "prefix_evictions_total": (self._prefix.evictions
                                       if self._prefix is not None else 0),
            "prefix_index_entries": (len(self._prefix)
                                     if self._prefix is not None else 0),
            "cow_copies_total": self.cow_copies,
            "sampled_admissions_total": self.sampled_admissions,
            "decode_graph_captures": self._exec.captures,
            "decode_graph_replays": self._exec.replays,
            "oldest_request_age_s": round(self._oldest_age_s(now), 4),
            "retry_after_hint_s": self._retry_after_hint(),
            "unclaimed_results": len(self._finished_order),
        }

    def drain(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Stop admission, finish in-flight work, hand back the unserved
        queue (admission order).  Later ``submit()`` calls are shed."""
        self._draining = True
        start = self._tick
        while self._active.any():
            self.step()
            if max_ticks is not None and self._tick - start >= max_ticks:
                raise ServeTimeout(
                    f"drain exceeded max_ticks={max_ticks} with "
                    f"{int(self._active.sum())} slot(s) still decoding")
        unserved = list(self._queue)
        unserved.extend(self._pending)
        self._queue.clear()
        self._pending.clear()
        self._waiting_deadlines = 0
        self._live_rids.difference_update(r.rid for r in unserved)
        for r in unserved:
            self._lifecycle_pending.pop(r.rid, None)
        log_dist(f"serve: drained, {len(unserved)} unserved request(s) "
                 f"handed back, {len(self._finished_order)} result(s) "
                 "claimable", ranks=[0])
        return unserved
