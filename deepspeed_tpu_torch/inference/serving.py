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
after ``quarantine_limit`` consecutive prefill failures (with
``probe_after_ticks``, a canary prefill after that many clean ticks
unfences the slot and hands its pages back), :meth:`health` and
:meth:`drain` follow the JAX engine.  Sampled requests use per-slot lanes
with counter-based generators (``sampling.position_generator``), so a
served stream equals ``InferenceEngine.generate(sampling=...)`` on the same
logits.

The serving extras, as in the JAX package:

- ``kv_dtype="int8"``: int8 pages with one fp32 scale per token row, read
  by K4's int8 mode (twice the tokens in the pool's bytes);
- ``host_tier_pages=N``: under pool pressure cold full prefix pages demote
  to pinned host memory (``kv_tiering.HostTier``) instead of being evicted,
  and a prefix hit promotes them back; the demoted ledger joins the page
  accounting;
- ``speculative=SpeculativeConfig(...)``: a draft model over a mirrored
  pool proposes ``k`` tokens a tick and the target verifies them in one
  pass (``speculative.py``); greedy output is token-exact with plain
  decoding;
- ``adapters=AdapterRegistry(...)``: per-request LoRA adapters
  (``Request.adapter_id``) as per-slot factors, each tenant's prefix
  chains under its own salt; :meth:`~ServingEngine.fuse_adapter` serves one
  hot tenant from fused weights;
- :meth:`~ServingEngine.update_params` swaps the live weights in place and
  advances the weight epoch, flushing every cached page and host slab;
- the fault-injection sites ``serve.tick``/``serve.admit``/
  ``serve.prefill``/``serve.decode`` and the ``serve.*`` spans of the
  tracer; ``serving_supervisor.ServingSupervisor`` turns a failed tick into
  a warm restart with an exact replay.

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
ROADMAP item (queue 1, item 12): the monitor, the watchdog, SLO rules and
per-program statistics.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from ..models.transformer import PAGE_SIZE
from ..observability.trace import (get_tracer, new_trace_id, trace_context,
                                   trace_count, trace_span)
from ..resilience.fault_injection import (SITE_SERVE_ADMIT, SITE_SERVE_DECODE,
                                          SITE_SERVE_PREFILL, SITE_SERVE_TICK,
                                          maybe_fire)
from ..utils.logging import log_dist, logger
from .adapters import AdapterRegistry
from .execution import MeshExecutor
from .kv_tiering import HostTier
from .prefix_cache import PrefixIndex, PrefixMatch
from .sampling import SamplingParams, as_lanes
from .speculative import SpeculativeConfig, SpeculativeDecoder

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
    """``run``/``drain`` exceeded its ``max_ticks`` budget (never retried by
    the supervisor: a tick budget is a caller's bound, not a fault)."""


class PoolConsumedError(RuntimeError):
    """The engine's device half is gone (its KV pool was released after a
    failure): the engine cannot continue and must be rebuilt
    (``ServingSupervisor`` does this, replaying queue and in-flight
    requests)."""


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
    # decode steps that fed this slot (a speculative verify tick emits
    # 1..k tokens, so it can be fewer than len(tokens) - 1)
    decode_ticks: int = 0
    lifecycle: List = dataclasses.field(default_factory=list)


class ServingEngine:
    """Iteration-level scheduler over a fixed slot fleet + paged KV pool.

    ``model`` must expose the paged decode contract (``init_paged_cache`` /
    ``apply_paged``, see ``models.CausalLM``); ``params`` are read as given
    and never written (:meth:`InferenceEngine.serving` shares the engine's:
    the first weight swap moves this engine onto its own copy).  ``device``
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
                 speculative: Optional[SpeculativeConfig] = None,
                 program_stats_sample_every: int = 0,
                 slo_rules=None, adapters: Optional[AdapterRegistry] = None,
                 device=None):
        for option, value, what in (
                ("monitor", monitor, "the serve/* gauges"),
                ("watchdog", watchdog, "the hang watchdog"),
                ("slo_rules", slo_rules or None, "SLO evaluation"),
                ("program_stats_sample_every", program_stats_sample_every or None,
                 "per-program statistics")):
            if value is not None:
                raise _refused(option, 12, what)
        if not hasattr(model, "apply_paged"):
            raise ValueError(
                "ServingEngine needs a model with the paged decode contract "
                "(init_paged_cache/apply_paged); see models.CausalLM")
        self.model = model
        self.monitor = None
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
        if host_tier_pages is not None:
            if not prefix_cache:
                raise ValueError(
                    "host_tier_pages requires prefix_cache=True: the host "
                    "tier parks demoted prefix pages")
            if int(host_tier_pages) < 1:
                raise ValueError(
                    f"host_tier_pages={host_tier_pages} must be >= 1")
        self.probe_after_ticks = (int(probe_after_ticks)
                                  if probe_after_ticks is not None else None)
        if self.probe_after_ticks is not None and self.probe_after_ticks < 1:
            raise ValueError(
                f"probe_after_ticks={self.probe_after_ticks} must be >= 1")
        self.mesh = mesh
        self._exec = MeshExecutor(model, params, self.num_pages,
                                  self.page_size, self.b_slots,
                                  self.pages_per_slot, dtype=dtype,
                                  kv_dtype=kv_dtype, mesh=mesh,
                                  prefix_cache=prefix_cache,
                                  host_tier=host_tier_pages is not None,
                                  adapters=adapters, device=device)
        self.params = self._exec.params   # the rank's shards on a mesh
        self.kv_dtype = self._exec.kv_dtype
        # ---- multi-tenant adapters: host stacks (numpy, the registry's
        # layout) mirrored into the executor's device stacks a slot at a time
        self.adapters = adapters
        self._adapter_stacks = (adapters.make_slot_stacks(self.b_slots)
                                if adapters is not None else None)
        # fused view of one hot tenant: its id, and the base leaves the
        # fused weights overwrote (restored by fuse_adapter(None))
        self.fused_adapter_id: Optional[str] = None
        self._base_copy: Optional[Dict[str, Any]] = None
        self.adapter_admissions = 0
        self._adapter_admit_by_id: Dict[str, int] = {}
        self._adapter_tokens_by_id: Dict[str, int] = {}
        self._free_pages: List[int] = list(range(self.num_pages - 1, 0, -1))
        # per-page refcounts (page 0, the trash page, is never counted)
        self._refcount = np.zeros((self.num_pages,), np.int64)
        self._prefix = (PrefixIndex(self.page_size,
                                    max_entries=prefix_index_entries)
                        if prefix_cache else None)
        # ---- the host-RAM tier
        self.host_tier_pages = (int(host_tier_pages)
                                if host_tier_pages is not None else None)
        self._tier: Optional[HostTier] = None
        if self.host_tier_pages is not None:
            page_bytes = self._exec.pool_bytes["per_device"] // self.num_pages
            self._tier = HostTier(self.host_tier_pages, page_bytes=page_bytes)
            # an index entry's removal drops its host slab in the same step
            self._prefix.on_drop_host = self._tier.discard
        self.demotions = 0
        self.promotions = 0
        self._demoted_hwm = 0
        self._promote_lat_s: Deque[float] = deque(maxlen=2048)
        self._demote_lat_s: Deque[float] = deque(maxlen=2048)
        # ---- weight epochs: update_params() advances the epoch and flushes
        # every cached page and host slab; pages are stamped at allocation
        self._weight_epoch = 0
        self.weight_updates = 0
        self.kv_flushed_pages = 0
        self.kv_flushed_slabs = 0
        self._refresh_lat_s: Deque[float] = deque(maxlen=2048)
        self._page_epoch = np.zeros((self.num_pages,), np.int64)
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
        self._quarantine_pages_by_slot: Dict[int, List[int]] = {}
        self._fence_tick: Dict[int, int] = {}
        self._last_failure_tick = 0
        self.probe_count = 0
        self.unfence_count = 0
        self._draining = False
        self._waiting_deadlines = 0
        self.shed_count = 0
        self.deadline_count = 0
        self._ema_service_s: Optional[float] = None
        # ---- speculative decoding: a draft model over its own pool with the
        # same page geometry, indexed by the same page tables
        self._spec: Optional[SpeculativeDecoder] = None
        if speculative is not None:
            self._spec = SpeculativeDecoder(speculative, self._exec,
                                            self.max_model_len)
        log_dist(f"serving engine ready: b_slots={self.b_slots} "
                 f"pages={self.num_pages}x{self.page_size} "
                 f"(max_model_len={self.max_model_len}) "
                 f"kv_dtype={self.kv_dtype} device={self._exec.device}", ranks=[0])

    def program_inventory(self) -> Dict[str, Any]:
        """One decode step + one prefill per prompt bucket (+ the COW page
        copy with prefix caching, the tier movers with a host tier, the
        draft and verify steps with speculation).  Constant at steady
        state: admission never grows it beyond the bucket set, and the
        decode step is captured once (``captures`` counts the engine's
        CUDA-graph captures: the decode step's, plus the draft step's and
        the verify block's; 0 on the CPU, where every step runs eagerly)."""
        inv = self._exec.program_inventory()
        inv["captures"] = self._exec.captures
        if self._spec is not None:
            inv["speculative"] = self._spec.program_inventory()
            inv["captures"] += self._spec.captures
        return inv

    def adapter_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant admission/token counters, keyed by adapter id (empty
        without a registry)."""
        if self.adapters is None:
            return {}
        return {aid: {"admissions": self._adapter_admit_by_id.get(aid, 0),
                      "tokens": self._adapter_tokens_by_id.get(aid, 0)}
                for aid in self.adapters.loaded()}

    def close(self) -> None:
        """Release the device half (the graphs, the pools); the engine
        serves no more.  On a mesh of several ranks every rank calls it
        before ``comm.destroy_process_group()``."""
        self._exec.close()
        if self._spec is not None:
            self._spec.close()

    # ---------------------------------------------------------- scheduling

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.input_ids) + req.max_new_tokens) // self.page_size)

    def _alloc_pages(self, n: int) -> List[int]:
        """Pop ``n`` free pages and take the first reference on each,
        stamping each with the current weight epoch."""
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
            self._page_epoch[p] = self._weight_epoch
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
        prefix index; ``cached`` counts the index's device pages, a
        subset), and with a host tier every demoted index entry holds
        exactly one host slab (``demoted`` == the tier's size)."""
        referenced = int((self._refcount[1:] > 0).sum())
        free = len(self._free_pages)
        quarantined = len(self._quarantined_pages)
        demoted = self._prefix.demoted if self._prefix is not None else 0
        return {
            "free": free,
            "quarantined": quarantined,
            "referenced": referenced,
            "cached": self._prefix.hbm_entries() if self._prefix is not None else 0,
            "demoted": demoted,
            "host_tier_bytes": self._tier.bytes() if self._tier is not None else 0,
            "total": self.num_pages - 1,
            "balanced": (free + quarantined + referenced == self.num_pages - 1
                         and demoted == (len(self._tier) if self._tier is not None
                                         else 0)),
        }

    def _adapter_salt(self, req: Request) -> int:
        """The request's prefix namespace: its tenant's salt (0 for the base
        model and for registry-less engines)."""
        if self.adapters is None:
            return 0
        return self.adapters.salt(req.adapter_id)

    def _prefix_lookup(self, req: Request) -> PrefixMatch:
        """Longest resident prefix for ``req``, capped at prompt-1 so at
        least one token always goes through prefill."""
        if self._prefix is None or len(self._prefix) == 0:
            return PrefixMatch(pages=[], n_tokens=0)
        with trace_span("serve.prefix_match", rid=req.rid):
            m = self._prefix.lookup(req.input_ids, limit=len(req.input_ids) - 1,
                                    salt=self._adapter_salt(req))
        if m.cow_src is not None and m.cow_valid < MIN_COW_TOKENS:
            # not worth a page snapshot: keep the full-page share
            return PrefixMatch(pages=m.pages,
                               n_tokens=len(m.pages) * self.page_size,
                               keys=m.keys)
        return m

    def _reclaim_cached(self, n_pages: int) -> None:
        """Pool pressure: reclaim cached-but-idle prefix pages, LRU first,
        until ``n_pages`` more pages are actually free or nothing is left to
        reclaim.  With a host tier cold full pages demote instead of being
        evicted (partial boundary pages are mutable and evict)."""
        freed = 0
        while freed < n_pages and self._prefix is not None \
                and len(self._prefix):
            before = len(self._free_pages)
            if self._tier is not None:
                if not self._demote_lru_entry():
                    break   # every remaining entry is on the host already
            else:
                for p in self._prefix.evict(1):
                    self._drop_page(p)
            freed += len(self._free_pages) - before

    # ------------------------------------------------------ KV-page tiering

    def _demote_lru_entry(self) -> bool:
        """One reclaim step under tiering: demote the LRU full device entry
        (its page's slabs to the host tier, the device page freed) or evict
        the LRU partial one.  False when no entry holds a device page."""
        cand = self._prefix.reclaim_candidate()
        if cand is None:
            return False
        key, e = cand
        if not e.full:
            p = self._prefix.evict_key(key)
            if p is not None:
                self._drop_page(p)
            return True
        self._tier_make_room()
        with trace_span("serve.demote", page=int(e.page)):
            t0 = time.monotonic()
            slabs, ready = self._exec.extract(int(e.page))
            self._tier.put(key, *slabs, epoch=self._weight_epoch, ready=ready)
            page = self._prefix.demote(key)
            self._drop_page(page)
            self._demote_lat_s.append(time.monotonic() - t0)
        self.demotions += 1
        self._demoted_hwm = max(self._demoted_hwm, self._prefix.demoted)
        return True

    def _tier_make_room(self) -> None:
        """Host-tier capacity: a full tier evicts its LRU slabs for real
        (the prefix entry dies with its only copy)."""
        while self._tier.full():
            key = self._tier.oldest_key()
            if key is None:   # pragma: no cover - defensive
                return
            self._prefix.evict_key(key)   # drops the slab through the hook
            self._tier.discard(key)

    def _promote_match(self, match: PrefixMatch) -> bool:
        """Promote every demoted chunk of ``match`` into free device pages
        (the caller checked the free count) and patch the match in place.
        False when a host slab vanished (or is of another weight epoch): the
        caller retries the head with a fresh, smaller lookup."""
        for i, p in enumerate(match.pages):
            if p >= 0:
                continue
            key = match.keys[i]
            data = self._tier.get(key, epoch=self._weight_epoch)
            if data is None:
                self._prefix.evict_key(key)
                self._tier.discard(key)
                return False
            with trace_span("serve.promote"):
                t0 = time.monotonic()
                (dst,) = self._alloc_pages(1)
                try:
                    self._exec.inject(data, dst)
                except BaseException:
                    self._drop_page(dst)
                    raise
                self._prefix.promote(key, dst)
                self._tier.pop(key)
                self._promote_lat_s.append(time.monotonic() - t0)
            match.pages[i] = dst
            self.promotions += 1
        return True

    def tier_latencies(self) -> Dict[str, List[float]]:
        """Recent demote/promote wall times in seconds (host clock around
        the move's issue; a demote's copy completes asynchronously)."""
        return {"promote_s": list(self._promote_lat_s),
                "demote_s": list(self._demote_lat_s)}

    def residency_digest(self, cap: int = 1024) -> List:
        """``(chain_key, tier)`` per full cached chunk, MRU first (what a
        fleet member would advertise)."""
        if self._prefix is None:
            return []
        return self._prefix.digest(cap)

    def adopt_host_tier(self, old: "ServingEngine") -> int:
        """Warm-restart carry: adopt the dead engine's demoted prefix
        entries and their host slabs (host memory survives the dead pool;
        K/V is a function of tokens and weights, and the replacement serves
        the same weights).  Returns the entries carried."""
        if (self._tier is None or old._tier is None or self._prefix is None
                or old._prefix is None):
            return 0
        keys = self._prefix.adopt_demoted(old._prefix)
        adopted = self._tier.adopt(old._tier, keys=keys)
        if len(adopted) < len(keys):
            for key in set(keys) - set(adopted):
                self._prefix.evict_key(key)
        self._demoted_hwm = max(self._demoted_hwm, self._prefix.demoted)
        return len(adopted)

    # ------------------------------------------------- live weight updates

    @property
    def weight_epoch(self) -> int:
        """The live-weight generation this engine serves; advanced by
        :meth:`update_params`.  Setting it re-stamps the prefix index."""
        return self._weight_epoch

    @weight_epoch.setter
    def weight_epoch(self, value: int) -> None:
        self._weight_epoch = int(value)
        if self._prefix is not None:
            self._prefix.epoch = self._weight_epoch

    def update_params(self, params, draft_params=None,
                      epoch: Optional[int] = None, adopt: bool = False) -> Dict[str, Any]:
        """Serve new weights from the next admission on and advance the
        weight epoch.  The swap is this engine's alone, as in the JAX
        package: the first one moves it onto its own copy of ``params``
        (the tensors it was built over, an ``InferenceEngine``'s and its
        other servers', are never written) and recaptures its graphs over
        it; later ones copy in place, so the graphs stay valid.  ``adopt``:
        keep ``params``' own tensors instead of a copy (the caller gives
        them up).  Every cached K/V page and host slab describes the old
        weights: all are flushed, and pages are epoch-stamped so a stale
        one could not be mapped.  Requires no slot in flight.
        ``draft_params`` refreshes a speculative draft's weights; ``epoch``
        overrides the new epoch (default +1).  Returns the new epoch, the
        flushed pages and slabs, the refresh time and the accounting
        verdict."""
        if self._active.any():
            raise RuntimeError(
                f"update_params with {int(self._active.sum())} slot(s) in "
                "flight: a live stream's K/V would straddle two weight "
                "epochs; drain or finish the tick loop first")
        t0 = time.monotonic()
        with trace_span("serve.weight_update", epoch=self._weight_epoch + 1):
            # the draft first: a rejected target swap then leaves a correct
            # engine (a stale draft costs acceptance only)
            moved = (draft_params is not None and self._spec is not None
                     and self._spec.update_params(draft_params))
            moved |= self._exec.update_params(params, adopt=adopt)
            if moved and self._spec is not None:
                self._spec.recapture()   # the verify block reads the target's
            self.params = self._exec.params
            # the new weights are the serving base: any fused view is over
            self._base_copy = None
            self.fused_adapter_id = None
            flushed_pages, flushed_slabs = self._flush_cached_kv()
            self.weight_epoch = (int(epoch) if epoch is not None
                                 else self._weight_epoch + 1)
        self.weight_updates += 1
        dt = time.monotonic() - t0
        self._refresh_lat_s.append(dt)
        acct = self.page_accounting()
        if not acct["balanced"]:   # pragma: no cover - defensive
            raise RuntimeError(f"page accounting unbalanced after the weight "
                               f"epoch flip: {acct}")
        log_dist(f"serve: weight epoch -> {self._weight_epoch} ({flushed_pages} "
                 f"cached page(s) + {flushed_slabs} host slab(s) flushed, "
                 f"refresh {dt * 1e3:.1f} ms)", ranks=[0])
        return {"weight_epoch": self._weight_epoch,
                "flushed_hbm_pages": flushed_pages,
                "flushed_host_slabs": flushed_slabs,
                "refresh_s": dt, "balanced": acct["balanced"]}

    def _flush_cached_kv(self) -> tuple:
        """Release every prefix-cached page and host slab (slots are idle,
        so afterwards only quarantined pages are not free)."""
        flushed_pages = flushed_slabs = 0
        if self._prefix is not None:
            flushed_slabs = self._prefix.demoted
            for p in self._prefix.flush():
                self._drop_page(p)
                flushed_pages += 1
        if self._tier is not None and len(self._tier):
            raise RuntimeError(
                f"host tier holds {len(self._tier)} slab(s) after the prefix "
                "flush: stranded buffers (ledger torn)")
        self.kv_flushed_pages += flushed_pages
        self.kv_flushed_slabs += flushed_slabs
        return flushed_pages, flushed_slabs

    def refresh_latencies(self) -> List[float]:
        """Recent ``update_params`` wall times in seconds."""
        return list(self._refresh_lat_s)

    def fuse_adapter(self, adapter_id: Optional[str] = None,
                     epoch: Optional[int] = None) -> Dict[str, Any]:
        """Serve one hot tenant from fused weights ``base + A @ B * scale``
        through :meth:`update_params` (an epoch flip: every cached page of
        the previous weights is flushed; the fused weights are this
        engine's alone).  While fused, only this tenant's requests are
        admissible and its slots ride zero factors (the weights carry the
        delta).  The base leaves the view overwrites are kept (the shared
        tensors themselves before the first swap, which nothing writes,
        else copies); ``fuse_adapter(None)`` copies them back and reopens
        mixed admission.  Requires idle slots."""
        if self.adapters is None:
            raise RuntimeError(
                "fuse_adapter requires an AdapterRegistry: build the engine "
                "with adapters=")
        base_copy = dict(self._base_copy or {})
        layers = self.params["layers"]
        shared = not self._exec.owns_params
        if adapter_id is not None:
            ad = self.adapters.resolve(adapter_id)   # loud UnknownAdapter
            for k in ad.factors:
                if k not in base_copy:
                    base_copy[k] = layers[k] if shared else layers[k].detach().clone()
        base = dict(self.params)
        base["layers"] = dict(layers, **base_copy)
        view = (base if adapter_id is None else
                self.adapters.fuse(base, adapter_id, shard=self._exec.fuse_shard))
        stats = self.update_params(view, epoch=epoch)
        # update_params made the view the base; keep the true base's copies
        self._base_copy = base_copy if adapter_id is not None else None
        self.fused_adapter_id = adapter_id
        stats["fused_adapter_id"] = adapter_id
        log_dist("serve: fused view " + ("restored to the base"
                                         if adapter_id is None else
                                         f"of adapter {adapter_id!r}")
                 + f" at weight epoch {self._weight_epoch}", ranks=[0])
        return stats

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
            adapter_id=request.adapter_id, lifecycle=lc)
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
                        trace_id=req.trace_id, adapter_id=req.adapter_id,
                        lifecycle=lc)
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
        the request is shed with a terminal "shed" result instead.  An
        adapter id is resolved here: an unknown tenant is refused at the
        door (``UnknownAdapter``)."""
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
            if self.adapters is None:
                raise ValueError(
                    f"request {request.rid!r} names adapter "
                    f"{request.adapter_id!r} but this engine has no "
                    "AdapterRegistry: build it with adapters=")
            with trace_span("serve.adapter_resolve", rid=request.rid,
                            adapter=request.adapter_id):
                self.adapters.resolve(request.adapter_id)   # UnknownAdapter
        if (self.fused_adapter_id is not None
                and request.adapter_id != self.fused_adapter_id):
            raise ValueError(
                f"request {request.rid!r} (adapter {request.adapter_id!r}) "
                f"rejected: the engine is serving a FUSED view of adapter "
                f"{self.fused_adapter_id!r}; only that tenant is admissible "
                "until fuse_adapter(None) restores the shared base")
        rid = request.rid
        if rid in self._live_rids:
            raise ValueError(
                f"request id {rid!r} is already queued, in flight, or has "
                f"an unclaimed result; rids must be unique")
        if request.trace_id is None:
            request = dataclasses.replace(request, trace_id=new_trace_id())
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
            admitted = freed_pins = promote_retry = False
            with trace_context(req.trace_id, req.rid):
                match = self._prefix_lookup(req)
                # pin the matched device pages (and the COW source) for this
                # admission: reclaim below must never free a page it is
                # about to map.  Demoted chunks (-1) have no device page;
                # their host slabs are LRU-touched instead.
                pinned = [p for p in match.pages if p >= 0]
                if match.cow_src is not None:
                    pinned.append(match.cow_src)
                for p in pinned:
                    self._share_page(p)
                n_demoted = sum(1 for p in match.pages if p < 0)
                if n_demoted and self._tier is not None:
                    for i, p in enumerate(match.pages):
                        if p < 0:
                            self._tier.touch(match.keys[i])
                try:
                    # each demoted chunk needs a free page for its promotion
                    need = self._pages_needed(req) - len(match.pages)
                    if len(self._free_pages) < need + n_demoted:
                        self._reclaim_cached(need + n_demoted
                                             - len(self._free_pages))
                    if len(self._free_pages) >= need + n_demoted:
                        if n_demoted and not self._promote_match(match):
                            promote_retry = True
                        else:
                            with trace_span("serve.admit", rid=req.rid, slot=slot):
                                self._admit_one(req, slot, match, need, now)
                            admitted = True
                finally:
                    if not admitted:
                        freed_pins = any(self._refcount[p] == 1 for p in pinned)
                    for p in pinned:
                        self._drop_page(p)
            if admitted:
                continue
            if freed_pins or promote_retry:
                # reclaim evicted the head's own matched entries (or a host
                # slab vanished): retry with a fresh lookup (each retry means
                # the index strictly shrank)
                continue
            break   # head-of-line: wait for retirements

    def _admit_one(self, req: Request, slot: int, match: PrefixMatch,
                   need: int, now: float) -> None:
        """Pop the queue head into ``slot`` and prefill its unshared tail:
        one reference per shared page, a fresh allocation for the rest."""
        # fire before the pop: an injected raise leaves the request queued
        maybe_fire(SITE_SERVE_ADMIT, rid=req.rid, slot=slot)
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
                    # a later canary probe hands exactly these pages back
                    self._quarantine_pages_by_slot[slot] = list(pages)
                    self._fence_tick[slot] = self._tick
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
        snapshotted into this slot's own boundary page (copy-on-write), in
        the draft pool too under speculation."""
        S = len(req.input_ids)
        n_shared = match.n_tokens
        pages = shared + private
        # a mapped page (or COW donor) must hold K/V of the current weights
        suspects = shared + ([match.cow_src] if match.cow_src is not None else [])
        stale = [p for p in suspects if self._page_epoch[p] != self._weight_epoch]
        if stale:
            raise RuntimeError(
                f"weight-epoch invariant violated: request {req.rid!r} would "
                f"map page(s) {stale} stamped "
                f"{[int(self._page_epoch[p]) for p in stale]} at weight epoch "
                f"{self._weight_epoch}")
        tail = req.input_ids[n_shared:]
        S_tail = len(tail)   # >= 1: lookup is capped at prompt-1
        s_pad = _bucket(S_tail)
        self._page_table[slot, :] = 0
        self._page_table[slot, :len(pages)] = pages
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :S_tail] = tail
        lane_t, lane_k, lane_p, lane_s = as_lanes(req.sampling)
        if self.adapters is not None:
            # the tenant's factors into this slot (zeros for the base model
            # and under a fused view, whose weights carry the delta)
            ad = (None if self.fused_adapter_id is not None
                  else self.adapters.resolve(req.adapter_id))
            self.adapters.write_slot(self._adapter_stacks, slot, ad)
            self._exec.write_adapter_slot(self._adapter_stacks, slot)
        with trace_span("serve.prefill", rid=req.rid, slot=slot, bucket=s_pad,
                        shared_tokens=n_shared):
            maybe_fire(SITE_SERVE_PREFILL, rid=req.rid, slot=slot)
            if match.cow_src is not None:
                # private[0] is the boundary logical page; rows past
                # cow_valid are donor rows the tail prefill overwrites
                # before causality can expose them
                self._exec.cow(match.cow_src, private[0])
                self.cow_copies += 1
                if self._spec is not None:
                    self._spec.cow(self._exec._cow_prog, match.cow_src, private[0])
            pt_row = self._page_table[slot:slot + 1]
            tok = self._exec.prefill(s_pad, pt_row, toks, S_tail, n_shared,
                                     lane_t, lane_k, lane_p, lane_s, slot=slot)
            if self._spec is not None:
                self._spec.prefill(s_pad, pt_row, toks, S_tail, n_shared)
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
        if req.adapter_id is not None:
            self.adapter_admissions += 1
            aid = req.adapter_id
            self._adapter_admit_by_id[aid] = self._adapter_admit_by_id.get(aid, 0) + 1
            self._adapter_tokens_by_id[aid] = self._adapter_tokens_by_id.get(aid, 0) + 1
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
            newly, released = self._prefix.publish(
                req.input_ids, pages, salt=self._adapter_salt(req))
            for p in newly:
                self._share_page(p)
            for p in released:
                self._drop_page(p)
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(slot, "eos")
        elif req.max_new_tokens == 1:
            self._finish(slot, "length")

    def _slot_rid_map(self) -> Dict[str, str]:
        """Active slot -> rid (only built while tracing is enabled)."""
        return {str(int(s)): str(self._slots[s].request.rid)
                for s in np.flatnonzero(self._active)}

    def _lanes(self):
        return self._exec.lanes(self._lane_temp, self._lane_top_k,
                                self._lane_top_p, self._lane_seed)

    def _count_adapter_tokens(self, req: Request, n: int) -> None:
        if req.adapter_id is not None and n:
            aid = req.adapter_id
            self._adapter_tokens_by_id[aid] = self._adapter_tokens_by_id.get(aid, 0) + n

    def _decode_tick(self, rid_map: Optional[Dict[str, str]] = None) -> None:
        if self._spec is not None:
            self._spec_tick(rid_map)
            return
        lanes = self._lanes()
        with trace_span("serve.decode", tick=self._tick) as sp:
            if rid_map is not None:
                sp.set(slot_rids=rid_map)
            maybe_fire(SITE_SERVE_DECODE, tick=self._tick)
            nxt = self._exec.decode(self._page_table, self._lengths,
                                    self._last_tok, self._active, lanes)
        active_slots = np.flatnonzero(self._active)
        trace_count("serve.tokens", float(len(active_slots)))
        for slot in active_slots:
            st = self._slots[slot]
            req = st.request
            tok = int(nxt[slot])
            st.tokens.append(tok)
            st.decode_ticks += 1
            self._lengths[slot] += 1
            self._last_tok[slot] = tok
            self._tokens_out += 1
            self._count_adapter_tokens(req, 1)
            if req.eos_token_id is not None and tok == req.eos_token_id:
                self._finish(slot, "eos")
            elif len(st.tokens) >= req.max_new_tokens:
                self._finish(slot, "length")

    def _spec_tick(self, rid_map: Optional[Dict[str, str]] = None) -> None:
        """Speculative tick: k draft proposals + one verify pass, then each
        slot consumes 1..k emitted tokens (cut by its own eos / budget;
        rejected or unconsumed positions are causally invisible garbage the
        next tick overwrites)."""
        with trace_span("serve.decode", tick=self._tick,
                        speculative=self._spec.k) as sp:
            if rid_map is not None:
                sp.set(slot_rids=rid_map)
            maybe_fire(SITE_SERVE_DECODE, tick=self._tick)
            emitted, n_emit = self._spec.tick(
                self._page_table, self._lengths, self._last_tok, self._active,
                self._lanes(), sampled=self._lane_temp > 0.0)
        total = 0
        for slot in np.flatnonzero(self._active):
            st = self._slots[slot]
            req = st.request
            consumed = 0
            finish = None
            for j in range(int(n_emit[slot])):
                tok = int(emitted[slot, j])
                st.tokens.append(tok)
                consumed += 1
                self._tokens_out += 1
                if req.eos_token_id is not None and tok == req.eos_token_id:
                    finish = "eos"
                    break
                if len(st.tokens) >= req.max_new_tokens:
                    finish = "length"
                    break
            st.decode_ticks += 1
            total += consumed
            self._count_adapter_tokens(req, consumed)
            self._spec.emitted_tokens += consumed
            self._lengths[slot] += consumed
            self._last_tok[slot] = st.tokens[-1]
            if finish is not None:
                self._finish(slot, finish)
        trace_count("serve.tokens", float(total))

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
            trace_id=st.request.trace_id, adapter_id=st.request.adapter_id,
            lifecycle=st.lifecycle)
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
        if self.adapters is not None and st.request.adapter_id is not None:
            # a later base admission must decode against zeros
            self.adapters.clear_slot(self._adapter_stacks, slot)
            self._exec.write_adapter_slot(self._adapter_stacks, slot)

    # ----------------------------------------------------- probe / unfence

    def _probe_quarantined(self) -> None:
        """For each fenced slot, once ``probe_after_ticks`` ticks have
        passed with no slot-attributable failure anywhere, one canary
        prefill on the slot's own quarantined pages: success restores the
        slot and hands its pages back to the free list."""
        for slot in np.flatnonzero(self._quarantined):
            slot = int(slot)
            since = self._tick - max(self._fence_tick.get(slot, 0),
                                     self._last_failure_tick)
            if since >= self.probe_after_ticks:
                self._probe_slot(slot)

    def _probe_slot(self, slot: int) -> None:
        pages = self._quarantine_pages_by_slot.get(slot)
        if not pages:
            return   # fenced without a page record: stay fenced
        self.probe_count += 1
        s_pad = _bucket(1)
        toks = np.zeros((1, s_pad), np.int32)
        self._page_table[slot, :] = 0
        self._page_table[slot, :len(pages)] = pages
        try:
            with trace_span("serve.probe", slot=slot):
                maybe_fire(SITE_SERVE_PREFILL, rid="__canary__", slot=slot)
                self._exec.prefill(s_pad, self._page_table[slot:slot + 1], toks,
                                   1, 0, 0.0, 0, 1.0, 0)
        except BaseException as e:
            self._page_table[slot, :] = 0
            self._fence_tick[slot] = self._tick
            self._last_failure_tick = self._tick
            if not isinstance(e, Exception):
                raise   # an operator interrupt, not a probe verdict
            logger.warning(
                "serve: canary probe of quarantined slot %d failed (%s: %s); "
                "slot stays fenced", slot, type(e).__name__, e)
            if not self.pool_alive():
                raise PoolConsumedError(
                    f"KV pool gone after the failed canary probe of quarantined "
                    f"slot {slot}; rebuild the engine") from e
            return
        self._page_table[slot, :] = 0
        self._quarantined[slot] = False
        self._slot_failures[slot] = 0
        self._fence_tick.pop(slot, None)
        self._quarantine_pages_by_slot.pop(slot, None)
        for p in pages:
            self._quarantined_pages.remove(p)
        self._free_pages.extend(pages)
        self.unfence_count += 1
        logger.info("serve: slot %d passed its canary probe after quarantine; "
                    "restored with %d page(s) (%d slot(s) usable)", slot,
                    len(pages), self._usable_slots())

    # ------------------------------------------------------------ the loop

    def pool_alive(self) -> bool:
        """False once the device half was released (``close``): the engine
        can no longer decode and must be rebuilt."""
        if not self._exec.pool_alive():
            return False
        return self._spec is None or self._spec.pool_alive()

    def _reads_clock(self) -> bool:
        """Whether this tick's decisions read ``now``: a request waits for
        its arrival time or carries a deadline (the same answer on every
        rank, whose scheduler states are equal)."""
        return bool(self._pending) or self._waiting_deadlines > 0 or any(
            self._slots[s].request.deadline_s is not None
            for s in np.flatnonzero(self._active))

    def step(self, now: Optional[float] = None) -> int:
        """One scheduler tick: expire dead deadlines, probe fenced slots,
        admit into free slots, ONE decode step over all slots, then refill
        the slots that step retired.  Returns the number of requests still
        in flight or queued.  On a mesh of several ranks the clock is rank
        0's."""
        if not self.pool_alive():
            raise PoolConsumedError(
                "the KV pool was released; rebuild the ServingEngine and "
                "resubmit (ServingSupervisor automates the rebuild and replays "
                "in-flight work)")
        self._tick += 1
        with trace_span("serve.tick", tick=self._tick) as sp:
            maybe_fire(SITE_SERVE_TICK, tick=self._tick)
            if now is None:
                now = time.monotonic() - self._t0
                if self._exec.ranks > 1 and self._reads_clock():
                    now = self._exec.agree(now)
            self._expire(now)
            if (self.probe_after_ticks is not None and not self._draining
                    and self._quarantined.any()):
                self._probe_quarantined()
            if not self._draining:
                self._admit(now)
            if self._active.any():
                rid_map = self._slot_rid_map() if get_tracer().enabled else None
                if rid_map is not None:
                    sp.set(slot_rids=rid_map)
                self._decode_tick(rid_map)
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
                            "the engine (ServingSupervisor restarts and "
                            "replays)")
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
        """One-call snapshot of the loop: queue, slots, pages, prefix cache,
        host tier, weight epochs, adapters, speculation and resilience
        counters (the JAX engine's keys; ``program_stats``, ``alerts`` and
        ``metrics_port`` stay empty until item 12 is ported)."""
        now = time.monotonic()
        acct = self.page_accounting()
        pb = self._exec.pool_bytes
        info = self._exec.mesh_info()
        spec = self._spec
        reg = self.adapters
        return {
            "tick": self._tick,
            "pool_alive": self.pool_alive(),
            "mesh_devices": info["mesh_devices"],
            "mesh_axes": info["mesh_axes"],
            "kv_pool_bytes_total": pb["total"],
            "kv_pool_bytes_per_device": pb["per_device"],
            "kv_dtype": self.kv_dtype,
            "draft_pool_bytes_per_device": (spec.pool_bytes["per_device"]
                                            if spec is not None else 0),
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
            "probes_total": self.probe_count,
            "unfenced_total": self.unfence_count,
            "prefix_hits_total": self.prefix_hits,
            "prefix_misses_total": self.prefix_misses,
            "prefix_shared_tokens_total": self.prefix_shared_tokens,
            "prefix_pages_shared_total": self.prefix_pages_shared,
            "prefix_evictions_total": (self._prefix.evictions
                                       if self._prefix is not None else 0),
            "prefix_index_entries": (len(self._prefix)
                                     if self._prefix is not None else 0),
            "cow_copies_total": self.cow_copies,
            "demoted_pages": acct["demoted"],
            "host_tier_bytes": acct["host_tier_bytes"],
            "host_tier_capacity_pages": self.host_tier_pages or 0,
            "demotions_total": self.demotions,
            "promotions_total": self.promotions,
            "demoted_pages_hwm": self._demoted_hwm,
            "weight_epoch": self._weight_epoch,
            "weight_updates_total": self.weight_updates,
            "kv_flushed_pages_total": self.kv_flushed_pages,
            "kv_flushed_slabs_total": self.kv_flushed_slabs,
            "sampled_admissions_total": self.sampled_admissions,
            "adapters_loaded": reg.loaded() if reg is not None else [],
            "adapter_admissions_total": self.adapter_admissions,
            "adapter_resolve_total": reg.resolve_total if reg is not None else 0,
            "adapter_resolve_miss_total": (reg.resolve_miss_total
                                           if reg is not None else 0),
            "adapter_bytes": reg.nbytes() if reg is not None else 0,
            "fused_adapter_id": self.fused_adapter_id,
            "speculative_k": spec.k if spec is not None else 0,
            "spec_verify_slot_ticks_total": (spec.verify_slot_ticks
                                             if spec is not None else 0),
            "spec_emitted_tokens_total": (spec.emitted_tokens
                                          if spec is not None else 0),
            "spec_drafted_tokens_total": (spec.drafted_tokens
                                          if spec is not None else 0),
            "spec_mean_accepted_len": (round(spec.mean_accepted_len(), 4)
                                       if spec is not None else 0.0),
            "decode_graph_captures": self.program_inventory()["captures"],
            "decode_graph_replays": self._exec.replays,
            "oldest_request_age_s": round(self._oldest_age_s(now), 4),
            "retry_after_hint_s": self._retry_after_hint(),
            "unclaimed_results": len(self._finished_order),
            "program_stats": {},
            "alerts": [],
            "metrics_port": None,
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
