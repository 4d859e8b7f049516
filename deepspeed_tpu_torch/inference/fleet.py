"""Serving fleet tier: leased engines, coordinator election, request
failover (counterpart of ``deepspeed_tpu/inference/fleet.py``, copied: it
drives engines through their host-side surface and imports no framework
but numpy).

One :class:`~.serving_supervisor.ServingSupervisor`-wrapped engine
warm-restarts through pool poisonings and slot quarantines, but it is still
a single point of failure: lose the process and every queued and in-flight
request is gone.  This module closes that gap with the
:class:`~..elasticity.coordination.CoordinationStore` the pod tier already
trusts for leases, generations and compare-and-swap:

- :class:`FleetMember` — one supervised engine of the fleet.  It renews a
  heartbeat lease under ``fleet/heartbeat/<engine_id>`` and advertises its
  ``health()`` snapshot under ``fleet/engines/<engine_id>``.  Faults inside
  the engine stay the member's business (the supervisor warm-restarts and
  replays token-exactly); a member whose restart budget exhausts stops
  renewing and writes a durable ``fleet/dead`` marker as a dying breath.
- :class:`FleetRouter` — the fleet front-end, elected by CAS on
  ``fleet/coordinator``.  The coordinator admits each request to the
  least-loaded live engine, sheds by fleet-wide queue depth with a typed
  ``"shed"`` result, journals every assignment under ``fleet/requests/``
  and scans member leases every round.  A lapsed lease (or a dead marker)
  fails the engine's queued and in-flight requests over to survivors with
  ``arrival_epoch_s`` preserved; failed-over results carry
  ``RequestResult.failovers``.
- **Token journaling / mid-stream resume** — every ``journal_every_k``
  rounds (or ``journal_flush_ms`` of store-clock time) the coordinator
  CAS-appends each in-flight stream's tokens into its journal entry,
  capped at ``max_journal_tokens``.  Failover re-prefills ``prompt +
  journaled tokens`` on a survivor (the prefill rebuilds the K/V) and resumes
  decoding after the last journaled token; only the un-flushed tail is
  re-decoded, and a journal holding the whole stream finishes it with no
  decode at all (``RequestResult.resumed_tokens``).  With nothing
  journaled the failover re-prefills the original prompt.  Both paths are
  token-exact for greedy and sampled streams: the journal carries the
  sampling lane (params, seed, ``lane_counter``), and the port's lanes are
  counter-based (``sampling.position_generator(seed, position)``), so the
  survivor draws the same token at every continuation position.
- **Coordinator failover** — a standby router polls the same election;
  when the leader's lease lapses it takes the next term, bumps the fleet
  generation (a CAS loop) and adopts the request journal.
- **Prefix residency routing** — each member publishes a digest of its
  prefix index (``fleet/residency/<engine_id>``: content-derived chunk
  keys, ``prefix_cache.chain_keys``, with their tier), and admission
  prefers the engine already holding a request's leading chunks, bounded
  by ``affinity_load_slack``; adapter-tagged requests prefer members that
  hold their adapter and never land on a member fused to another tenant.
- **Sharded admission, weight-epoch flips, rolling restarts** — follower
  routers claim rid-hash partitions and journal-create admissions for the
  coordinator to adopt; ``begin_epoch_flip`` holds admission until every
  live member serves the new weights; :meth:`FleetRouter.rolling_restart`
  drains and recycles one engine at a time.

The in-process harness (tests) drives members cooperatively — one
``pump()`` per router round — so kill schedules stay deterministic; one
member per process (``fleet_daemon.FleetMemberDaemon``, the
``fleet_member`` entry point) couples to the router through the store
alone.  The store keys and every journal and channel document are the JAX
package's, byte for byte, so clients of both packages can share one store
directory.  Fleet rollup gauges (``fleet/engines_live``,
``fleet/queue_depth``, ``fleet/failovers_total``, ...) land on the
router's monitor and therefore on ``/metrics``.  See docs/FLEET.md.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import re
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from collections import deque

from ..elasticity.coordination import (CoordinationStore, StoreRetryPolicy,
                                       StoreUnavailable, beat,
                                       bump_generation, clear_dead, dead_set,
                                       dedup_drop_totals,
                                       default_retry_policy,
                                       elect_coordinator,
                                       lease_table, process_src,
                                       publish_residency, read_generation,
                                       record_dead, store_retries_total)
from ..observability.slo import SloEvaluator, SloRule
from ..observability.trace import (get_tracer, new_trace_id, trace_span,
                                   trace_tags)
from ..utils.logging import log_dist, logger
from .adapters import adapter_salt
from .prefix_cache import chain_keys
from .sampling import SamplingParams
from .serving import Request, RequestResult, ServeTimeout, SlotPrefillError
from .serving_supervisor import RestartBudgetExhausted, ServingSupervisor

__all__ = ["EngineDead", "FleetMember", "FleetRouter", "FleetUnrecoverable",
           "FleetWrongPartition", "partition_of", "request_to_doc",
           "request_from_doc", "result_to_doc", "result_from_doc"]

# store namespaces of the fleet tier (the pod tier keeps heartbeat/, dead/,
# generation — one store can carry both without key collisions)
FLEET_HEARTBEAT_PREFIX = "fleet/heartbeat"
FLEET_DEAD_PREFIX = "fleet/dead"
FLEET_ENGINES_PREFIX = "fleet/engines"
FLEET_REQUESTS_PREFIX = "fleet/requests"
FLEET_RESIDENCY_PREFIX = "fleet/residency"
# per-engine adapter-registry digest (docs/FLEET.md "Adapter residency
# routing"): what each member can serve, published on the beat cadence so
# a router can tell "no member anywhere has this adapter" (typed shed with
# a retry hint) apart from "the resident member is busy" (queue)
FLEET_ADAPTERS_PREFIX = "fleet/adapters"
FLEET_TRACE_PREFIX = "fleet/trace"
FLEET_COORDINATOR_KEY = "fleet/coordinator"
FLEET_GENERATION_KEY = "fleet/generation"
# member-daemon channels (docs/FLEET.md "Member daemons"): per-engine
# CAS-appended message documents — the ONLY coupling between a router and
# a member running in its own OS process (inference/fleet_daemon.py)
FLEET_ASSIGN_PREFIX = "fleet/assign"
FLEET_RESULTS_PREFIX = "fleet/results"
FLEET_CONTROL_PREFIX = "fleet/control"
FLEET_PROGRESS_PREFIX = "fleet/progress"
# sharded admission (docs/FLEET.md "Sharded admission"): follower routers
# lease under router_heartbeat/ and claim rid-hash partitions by CAS
FLEET_ROUTER_HEARTBEAT_PREFIX = "fleet/router_heartbeat"
FLEET_ROUTER_DEAD_PREFIX = "fleet/router_dead"
FLEET_PARTITION_PREFIX = "fleet/partition"
# fleet-wide weight-epoch barrier (docs/FLEET.md, docs/HYBRID.md): the
# committed epoch, the in-progress flip document, and per-member prepare
# marks — every member flips before any router admits at the new epoch
FLEET_EPOCH_KEY = "fleet/epoch/current"
FLEET_EPOCH_FLIP_KEY = "fleet/epoch/flip"
FLEET_EPOCH_PREPARE_PREFIX = "fleet/epoch/prepare"


def partition_of(rid: Any, n_partitions: int) -> int:
    """Stable rid-hash -> admission-partition map: process-independent
    (crc32, never Python ``hash``) so every router of a fleet computes
    the same owner for a rid (docs/FLEET.md "Sharded admission")."""
    raw = f"{'i' if isinstance(rid, int) else 's'}{rid}".encode()
    return zlib.crc32(raw) % max(1, int(n_partitions))


class EngineDead(RuntimeError):
    """The member's engine process is gone (simulated kill, or a restart
    budget exhausted) — its host-side state is unreachable and recovery is
    the ROUTER's job (lease-lapse failover), not the supervisor's."""


class FleetUnrecoverable(RuntimeError):
    """No live engine remains to fail requests over to."""


class FleetWrongPartition(ValueError):
    """The rid hashes to an admission partition this router does not own
    (docs/FLEET.md "Sharded admission") — resubmit to the owner."""


def _rid_key(rid: Any) -> str:
    """Store-key-safe encoding of a request id (journal entries live at
    ``fleet/requests/<key>``).  Type-prefixed so int 7 and str "7" cannot
    collide; non-key-safe or long rids get a stable content hash suffix."""
    raw = f"{'i' if isinstance(rid, int) else 's'}{rid}"
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", raw)
    if safe != raw or len(safe) > 80 or ".lock" in safe or ".tmp." in safe \
            or safe.endswith(".tomb"):
        # ".lock"/".tmp."/".tomb" would collide with the store's
        # write-protocol artifacts (CAS locks, atomic-write temps,
        # compare-delete tombstones) and be FILTERED from list() — a
        # journal entry a successor coordinator could never see
        safe = re.sub(r"[^A-Za-z0-9_-]", "_", safe[:64])
        safe = f"{safe}-{hashlib.sha1(raw.encode()).hexdigest()[:10]}"
    return safe


def _doc_bytes(doc: Dict[str, Any]) -> int:
    """Serialized size of a journal document — feeds the
    ``fleet/journal_bytes`` gauge without re-reading the store."""
    try:
        return len(json.dumps(doc))
    except (TypeError, ValueError):   # pragma: no cover - defensive
        return 0


def request_to_doc(req: Request) -> Dict[str, Any]:
    """JSON-serializable form of a :class:`Request` — the assignment-
    channel payload between a router and a member daemon.  The monotonic
    ``arrival_time`` is NOT carried (it is meaningless across processes):
    the daemon re-stamps arrival on its own clock at receipt, while
    ``arrival_epoch_s``/``deadline_s`` keep the true-arrival accounting."""
    return {
        "rid": req.rid,
        "input_ids": [int(x) for x in np.asarray(req.input_ids).reshape(-1)],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_token_id": (int(req.eos_token_id)
                         if req.eos_token_id is not None else None),
        "deadline_s": req.deadline_s,
        "arrival_epoch_s": req.arrival_epoch_s,
        "sampling": (dataclasses.asdict(req.sampling)
                     if req.sampling is not None else None),
        "trace_id": req.trace_id,
        "adapter_id": req.adapter_id,
    }


def request_from_doc(doc: Dict[str, Any]) -> Request:
    return Request(
        rid=doc["rid"],
        input_ids=np.asarray(doc["input_ids"], np.int32),
        max_new_tokens=int(doc["max_new_tokens"]),
        eos_token_id=doc.get("eos_token_id"),
        arrival_time=0.0,
        deadline_s=doc.get("deadline_s"),
        arrival_epoch_s=doc.get("arrival_epoch_s"),
        sampling=(SamplingParams(**doc["sampling"])
                  if doc.get("sampling") else None),
        trace_id=doc.get("trace_id"),
        adapter_id=doc.get("adapter_id"))


def result_to_doc(res: RequestResult) -> Dict[str, Any]:
    """JSON-serializable form of a :class:`RequestResult` — the results-
    channel payload a member daemon publishes back to the router."""
    return {
        "rid": res.rid,
        "input_ids": [int(x) for x in np.asarray(res.input_ids).reshape(-1)],
        "output_ids": [int(x)
                       for x in np.asarray(res.output_ids).reshape(-1)],
        "finish_reason": res.finish_reason,
        "prefill_bucket": int(res.prefill_bucket),
        "arrival_s": res.arrival_s,
        "admit_s": res.admit_s,
        "first_token_s": res.first_token_s,
        "finish_s": res.finish_s,
        "retry_after_s": res.retry_after_s,
        "decode_ticks": int(res.decode_ticks),
        "replays": int(res.replays),
        "shared_prefix_tokens": int(res.shared_prefix_tokens),
        "failovers": int(res.failovers),
        "resumed_tokens": int(res.resumed_tokens),
        "trace_id": res.trace_id,
        "adapter_id": res.adapter_id,
        "lifecycle": [list(e) for e in res.lifecycle],
    }


def result_from_doc(doc: Dict[str, Any]) -> RequestResult:
    return RequestResult(
        rid=doc["rid"],
        input_ids=np.asarray(doc["input_ids"], np.int32),
        output_ids=np.asarray(doc["output_ids"], np.int32),
        finish_reason=doc["finish_reason"],
        prefill_bucket=int(doc.get("prefill_bucket") or 0),
        arrival_s=float(doc.get("arrival_s") or 0.0),
        admit_s=float(doc.get("admit_s") or 0.0),
        first_token_s=float(doc.get("first_token_s") or 0.0),
        finish_s=float(doc.get("finish_s") or 0.0),
        retry_after_s=doc.get("retry_after_s"),
        decode_ticks=int(doc.get("decode_ticks") or 0),
        replays=int(doc.get("replays") or 0),
        shared_prefix_tokens=int(doc.get("shared_prefix_tokens") or 0),
        failovers=int(doc.get("failovers") or 0),
        resumed_tokens=int(doc.get("resumed_tokens") or 0),
        trace_id=doc.get("trace_id"),
        adapter_id=doc.get("adapter_id"),
        lifecycle=[tuple(e) for e in doc.get("lifecycle") or []])


class FleetMember:
    """One leased engine of the fleet: a :class:`ServingSupervisor` plus
    the store-facing lease/advertisement surface.

    ``metrics_port`` (optional) starts a per-member /metrics endpoint on
    the member's monitor — pass ``0`` for an ephemeral bind so N members
    on one host never collide; a taken FIXED port also falls back to
    ephemeral instead of failing the member (the advertisement carries the
    ACTUAL bound port either way).
    """

    def __init__(self, engine_id: str, supervisor: ServingSupervisor,
                 store: CoordinationStore, lease_s: float = 5.0,
                 metrics_port: Optional[int] = None):
        self.engine_id = str(engine_id)
        self.sup = supervisor
        self.store = store
        self.lease_s = float(lease_s)
        self.generation = 0          # stamped by the router before each beat
        self.alive = True
        self.routable = True         # False while a rolling restart drains it
        self.death_cause: Optional[BaseException] = None
        self.last_advert: Optional[Dict[str, Any]] = None
        self.last_residency: Optional[Dict[str, Any]] = None
        self._last_beat_t: Optional[float] = None   # store clock
        # distributed-tracing segment publisher (docs/OBSERVABILITY.md
        # "Distributed tracing"): built lazily on the first beat with the
        # tracer enabled; publishes this member's completed spans (the
        # ones tagged engine=<id> by pump()'s ambient tag context) under
        # fleet/trace/<engine> so trace_assembly.assemble_fleet_trace can
        # merge the fleet timeline.  None while tracing is off — zero store traffic.
        self._trace_pub = None
        # publisher rate limit on the host monotonic clock (beats are
        # already store-clock rate-limited; this additionally bounds real
        # store writes when an injected test clock makes beats cheap).
        # Soaks set 0 so every beat publishes deterministically.
        self.trace_publish_interval_s = 0.25
        self.metrics_server = None
        if metrics_port is not None:
            # N engines sharing a host with one configured port: the shared
            # fallback policy binds the latecomers ephemerally instead of
            # crashing them at init (export.bind_metrics_server)
            from ..observability.export import bind_metrics_server

            self.metrics_server = bind_metrics_server(
                int(metrics_port), monitor=supervisor.monitor,
                label=f"fleet[{self.engine_id}] metrics endpoint")

    @property
    def metrics_port(self) -> Optional[int]:
        """The member's OWN endpoint when it runs one, else the engine's
        env-gated process-global port (both None = no endpoint)."""
        if self.metrics_server is not None:
            return self.metrics_server.port
        return self.sup.engine.metrics_port

    def outstanding(self) -> int:
        eng = self.sup.engine
        return int(eng._active.sum()) + len(eng._queue) + len(eng._pending)

    def backlog(self) -> int:
        """Waiting (not yet decoding) requests — the shed/routing signal."""
        eng = self.sup.engine
        return len(eng._queue) + len(eng._pending)

    def submit(self, request: Request) -> Any:
        return self.sup.submit(request)

    def take_results(self) -> List[RequestResult]:
        if not self.alive:
            return []   # a dead process's unclaimed results are gone
        return self.sup.take_results()

    def stream_progress(self) -> Dict[Any, List[int]]:
        """rid -> tokens generated so far on THIS member (across its
        warm-restart incarnations) — what the router's token journal
        flushes.  A dead member reports nothing: its host-side state is
        unreachable, which is exactly why the journal exists."""
        if not self.alive:
            return {}
        return self.sup.inflight_progress()

    def residency_digest(self, cap: int = 1024) -> List:
        """The engine's live prefix-residency digest — ``(chain_key,
        tier)`` per cached full chunk, MRU first.  A dead member reports
        nothing (its index died with it)."""
        if not self.alive:
            return []
        return self.sup.engine.residency_digest(cap)

    # ------------------------------------------------- lease + advertisement

    def advertisement(self) -> Dict[str, Any]:
        """The health snapshot the router reads back through the store —
        routing load, capacity, the bound /metrics port, and the
        observability drop counters each process keeps (the router
        rolls them up fleet-wide)."""
        h = self.sup.health()
        mon = self.sup.monitor
        src = process_src()
        return {
            "engine_id": self.engine_id,
            "generation": int(self.generation),
            "t": self.store.now(),
            "queue_depth": h["queue_depth"],
            "active_slots": h["active_slots"],
            "usable_slots": h["usable_slots"],
            "free_pages": h["free_pages"],
            "draining": h["draining"],
            "restarts": h["restarts"],
            "shed_total": h["shed_total"],
            "deadline_expired_total": h["deadline_expired_total"],
            "oldest_request_age_s": h["oldest_request_age_s"],
            "metrics_port": self.metrics_port,
            # per-engine flight-dump aggregation keys: the ring and monitor
            # drop counts this process would otherwise only expose locally.
            # The source ids scope each counter to its PROCESS-level object
            # — the tracer ring is a process singleton and in-process fleet
            # members may share a monitor, so a rollup summing N identical
            # advertisements would overcount N-fold without them.
            "flight_dropped": int(get_tracer().recorder.dropped),
            "flight_src": src,
            "monitor_dropped": int(getattr(mon, "dropped_events", 0) or 0),
            "monitor_src": f"{src}.{id(mon)}",
            "last_restart_cause": h["last_restart_cause"],
            # the engine's weight epoch: the router's stale-weight
            # admission guard reads this for members it holds no live
            # handle to (docs/FLEET.md "Weight-epoch barrier")
            "weight_epoch": int(self.sup.engine.weight_epoch),
            # KV-page tiering rollup keys (docs/FLEET.md): the router sums
            # these fleet-wide into the fleet/residency_* gauges
            "page_size": int(self.sup.engine.page_size),
            "residency_entries": h["prefix_index_entries"],
            "demoted_pages": h["demoted_pages"],
            "host_tier_bytes": h["host_tier_bytes"],
            "promotions_total": h["promotions_total"],
            "demotions_total": h["demotions_total"],
            # multi-tenant adapter residency (docs/FLEET.md "Adapter
            # residency routing"): the adapter ids this engine can serve —
            # the router prefers members already holding a request's
            # adapter, and refuses to dispatch one nobody has loaded
            "adapters_loaded": list(h.get("adapters_loaded", [])),
            "fused_adapter_id": h.get("fused_adapter_id"),
            # SLO firing states (docs/OBSERVABILITY.md "SLOs and alerts"):
            # rule names currently firing on this engine — the router
            # rolls the fleet-wide count up as fleet/alerts_firing
            "alerts_firing": list(h.get("alerts", [])),
            # distributed-tracing segment accounting: spans this member
            # published under fleet/trace/<engine> and segment-cap drops —
            # the router rolls them up into the fleet/trace_* gauges
            "trace_spans_published": (self._trace_pub.published_total
                                      if self._trace_pub is not None else 0),
            "trace_dropped": (self._trace_pub.dropped_total
                              if self._trace_pub is not None else 0),
        }

    def beat(self, force: bool = False) -> None:
        """Renew the engine lease and refresh the advertisement (a dead
        member renews nothing — that silence IS the failure signal).
        Renewals are rate-limited to a third of the lease on the store
        clock: the router calls this every scheduler tick, and a per-tick
        write pair per engine would hammer a network-filesystem store for
        leases that only need renewal every ``lease_s/3``.  ``force``
        bypasses the limit (first beat after a recycle, takeover)."""
        if not self.alive:
            return
        now = self.store.now()
        if not force and self._last_beat_t is not None \
                and now - self._last_beat_t < self.lease_s / 3.0:
            return
        self._last_beat_t = now
        beat(self.store, self.engine_id, self.generation, self.lease_s,
             prefix=FLEET_HEARTBEAT_PREFIX, backlog=self.backlog())
        ad = self.advertisement()
        self.store.put(f"{FLEET_ENGINES_PREFIX}/{self.engine_id}", ad)
        # in-process readers (the router's gauge rollup) reuse what was
        # just written instead of re-reading the file every tick
        self.last_advert = ad
        # prefix residency digest, same cadence as the advertisement: the
        # store copy is the cross-process transport (a router with no live
        # handle to this member reads it); an in-process router prefers the
        # engine's live index (docs/FLEET.md "Prefix residency routing")
        self.last_residency = publish_residency(
            self.store, self.engine_id, self.residency_digest(),
            prefix=FLEET_RESIDENCY_PREFIX, generation=int(self.generation))
        # adapter-registry digest, same cadence: the store copy is how a
        # router with no live handle learns what this member can serve
        # (fleet-wide-unknown adapter_ids shed typed instead of queueing)
        self.store.put(f"{FLEET_ADAPTERS_PREFIX}/{self.engine_id}", {
            "engine_id": self.engine_id,
            "generation": int(self.generation),
            "adapters_loaded": list(ad.get("adapters_loaded") or ()),
            "fused_adapter_id": ad.get("fused_adapter_id"),
            "t": now,
        })
        # completed-span segment publish rides the beat cadence (already
        # rate-limited to lease_s/3) — a no-op while tracing is disabled
        self.publish_trace_segments()

    def publish_trace_segments(self, force: bool = False) -> int:
        """Publish this member's newly completed spans (the ones pump()'s
        ambient ``engine=<id>`` tag attributed to it) as a CAS-appended,
        size-capped segment under ``fleet/trace/<engine>`` with a
        monotonic↔epoch clock anchor (docs/OBSERVABILITY.md "Distributed
        tracing").  Returns the spans published (0 with tracing off)."""
        tracer = get_tracer()
        if not tracer.enabled:
            return 0
        if self._trace_pub is None:
            from ..observability.trace_assembly import TraceSegmentPublisher

            eid = self.engine_id
            self._trace_pub = TraceSegmentPublisher(
                self.store, eid, prefix=FLEET_TRACE_PREFIX,
                span_filter=lambda s: ((s.attrs or {}).get("engine") == eid
                                       and not s.name.startswith("fleet.")),
                min_interval_s=self.trace_publish_interval_s)
        with trace_span("fleet.trace_publish", engine=self.engine_id):
            return self._trace_pub.publish(tracer, force=force)

    # --------------------------------------------------------------- pumping

    def pump(self) -> int:
        """One engine scheduler tick under the warm-restart contract (the
        cooperative-harness equivalent of the supervisor's run loop):
        slot-attributable prefill failures with a live pool keep serving,
        anything else warm-restarts with token-exact replay, and an
        exhausted restart budget kills the member."""
        if not self.alive:
            raise EngineDead(f"engine {self.engine_id} is dead")
        sup = self.sup
        # ambient engine tag: every span this member's tick (or recovery)
        # opens carries engine=<id>, which is what attributes spans to
        # members when N in-process members share one tracer ring — and
        # names the engine in production per-process rings too
        with trace_tags(engine=self.engine_id):
            try:
                return sup.engine.step()
            except (KeyboardInterrupt, ServeTimeout):
                raise
            except SlotPrefillError as e:
                if sup.engine.pool_alive():
                    logger.warning("fleet[%s]: continuing past %s",
                                   self.engine_id, e)
                    return self.outstanding()
                return self._recover(e)
            except Exception as e:
                return self._recover(e)

    def _recover(self, cause: BaseException) -> int:
        try:
            self.sup._safe_restart(cause)
        except RestartBudgetExhausted as e:
            # the member process would crash here.  Dying breath: a durable
            # CAS-written dead marker so the router fails over NOW instead
            # of waiting out the lease (a hard kill still relies on lapse).
            self.alive = False
            self.death_cause = e
            try:
                record_dead(self.store, self.engine_id, self.generation,
                            self.engine_id, prefix=FLEET_DEAD_PREFIX)
            except Exception:   # pragma: no cover - the store died with us
                pass
            raise EngineDead(
                f"engine {self.engine_id} exhausted its restart budget: "
                f"{e}") from e
        return self.outstanding()

    def recycle(self) -> bool:
        """Rolling-restart hand-off: fresh engine, no budget spent."""
        return self.sup.recycle()

    def weight_epoch(self) -> int:
        """The engine's live weight epoch (the stale-weight admission
        guard reads it; a store-proxied member reads its advertisement)."""
        return int(self.sup.engine.weight_epoch)

    def prepare_epoch(self, params, epoch: int) -> bool:
        """Fleet epoch-barrier PREPARE (docs/FLEET.md "Weight-epoch
        barrier"): once this member has nothing in flight, flip its engine
        to ``params`` at ``epoch`` and write the durable prepare mark
        under ``fleet/epoch/prepare/<engine_id>``.  Returns whether the
        flip landed — ``False`` means still busy (the router keeps
        pumping; admission is gated, so the backlog only drains).

        ``params=None`` re-stamps the CURRENT weights at the new epoch
        (cache flushed, epoch advanced): the successor-coordinator path,
        which adopts an orphaned flip without the dead coordinator's
        param tree — each member's own weight source is authoritative
        (a daemon's ``params_provider``)."""
        if not self.alive or self.outstanding() > 0:
            return False
        self.sup.engine.update_params(
            params if params is not None else self.sup.engine.params,
            epoch=int(epoch))
        self.store.put(f"{FLEET_EPOCH_PREPARE_PREFIX}/{self.engine_id}",
                       {"engine": self.engine_id, "epoch": int(epoch),
                        "t": self.store.now()})
        return True

    def kill(self) -> None:
        """Test/chaos hook simulating process death: the lease silently
        stops renewing and the engine's host-side state (queue, slots,
        unclaimed results) becomes unreachable.  Detection is the ROUTER's
        lease scan — nothing is drained or handed back."""
        self.alive = False


class FleetRouter:
    """The elected fleet front-end (see the module docstring).

    One router instance is one COORDINATOR CANDIDATE: every :meth:`step`
    polls the election, and only the current leader drives the fleet —
    standbys idle until the leader's lease lapses, then take over with the
    journal.  ``store.now()`` is the lease/election clock (injectable for
    deterministic chaos); engine scheduling stays on the host monotonic
    clock.
    """

    def __init__(self, store: CoordinationStore,
                 members: List[FleetMember], router_id: str = "router0",
                 lease_s: float = 5.0, miss_limit: int = 3,
                 max_fleet_queue: Optional[int] = None, monitor=None,
                 election_key: str = FLEET_COORDINATOR_KEY,
                 generation_key: str = FLEET_GENERATION_KEY,
                 journal_every_k: Optional[int] = 8,
                 journal_flush_ms: Optional[float] = None,
                 max_journal_tokens: int = 4096,
                 prefix_affinity: bool = True,
                 affinity_load_slack: int = 2,
                 slo_rules: Optional[List[SloRule]] = None,
                 admission_partitions: Optional[int] = None):
        self.store = store
        self.members: Dict[str, FleetMember] = {}
        for m in members:
            if m.engine_id in self.members:
                raise ValueError(f"duplicate engine_id {m.engine_id!r}")
            self.members[m.engine_id] = m
        self.router_id = str(router_id)
        self.lease_s = float(lease_s)
        self.miss_limit = int(miss_limit)
        self.max_fleet_queue = (int(max_fleet_queue)
                                if max_fleet_queue is not None else None)
        if self.max_fleet_queue is not None and self.max_fleet_queue < 1:
            raise ValueError(
                f"max_fleet_queue={self.max_fleet_queue} must be >= 1")
        self.monitor = monitor
        self.election_key = election_key
        self.generation_key = generation_key
        self.generation = read_generation(store, key=generation_key)
        self.alive = True
        self.is_coordinator = False
        self.term = 0                    # the term this router leads under
        self._tick = 0
        self._t0 = time.monotonic()
        self._later: List[Request] = []  # router-gated future arrivals
        self._requests: Dict[Any, Request] = {}   # rid -> ORIGINAL request
        self._owner: Dict[Any, str] = {}          # rid -> engine_id
        self._failed_over: Dict[Any, int] = {}
        # ---- token journaling (mid-stream durability).  journal_every_k:
        # router rounds between token flushes (None disables mid-stream
        # appends — an assignment-only journal); max_journal_tokens
        # caps the per-request token list so one very long stream cannot
        # grow its store document unboundedly (the tail past the cap is
        # re-decoded on failover — bounded, documented loss).
        self.journal_every_k = (int(journal_every_k)
                                if journal_every_k is not None else None)
        if self.journal_every_k is not None and self.journal_every_k < 1:
            raise ValueError(
                f"journal_every_k={self.journal_every_k} must be >= 1")
        # time-based flush alternative: flush whenever
        # journal_flush_ms of STORE-clock time passed since the last flush
        # — the cadence an operator tunes against the store's real write
        # latency (journal_cas_latencies() holds the per-flush CAS times).  Composes with journal_every_k: either trigger
        # flushes; None+None disables mid-stream appends entirely.
        self.journal_flush_ms = (float(journal_flush_ms)
                                 if journal_flush_ms is not None else None)
        if self.journal_flush_ms is not None and self.journal_flush_ms <= 0:
            raise ValueError(
                f"journal_flush_ms={self.journal_flush_ms} must be > 0")
        self._last_flush_t: Optional[float] = None     # store clock
        self.journal_flushes_total = 0
        # per-CAS wall latency of journal writes (bounded window): the
        # flush-cadence tuning signal (fleet/journal_cas_* in the bench)
        self._journal_cas_lat_s = deque(maxlen=4096)
        self.max_journal_tokens = int(max_journal_tokens)
        if self.max_journal_tokens < 0:
            raise ValueError(
                f"max_journal_tokens={self.max_journal_tokens} must be >= 0")
        # rid -> tokens RESUMED from the journal at the last failover: they
        # are baked into the live assignment's prompt (KV reconstruction),
        # so collected outputs are stitched back behind them
        self._resumed: Dict[Any, List[int]] = {}
        # rid -> router-recorded lifecycle events (failover/resume markers,
        # src = the engine id involved) — journaled alongside the tokens so
        # a successor coordinator stitches the same record the dispatching
        # router would have (docs/OBSERVABILITY.md "Distributed tracing")
        self._lifecycle: Dict[Any, List] = {}
        # router-side SLO evaluation over the fleet rollup gauges
        # (docs/FLEET.md "Router-side SLOs"): same SloRule/SloEvaluator the
        # engines run, evaluated once per coordinator round AFTER the gauge
        # write so e.g. "fleet/journal_bytes < N" sees this round's value;
        # firing states land on health()["router_alerts"] and — via the
        # alert{rule=...} gauges — as dstpu_alert on the router's /metrics
        self._slo = SloEvaluator(slo_rules) if slo_rules else None
        # router-half trace-segment publisher (fleet.* spans); lazy like
        # the member half, inert while tracing is disabled
        self._trace_pub = None
        self.trace_publish_interval_s = 0.25
        # rid -> the journal document as last written/read by THIS router:
        # the CAS `expected` for the next append, and the byte-accounting
        # source for the fleet/journal_bytes gauge
        self._journal_docs: Dict[Any, Dict[str, Any]] = {}
        self._journal_sizes: Dict[Any, int] = {}
        self.resumed_tokens_total = 0
        self._failed_engines: set = set()
        self._last_scan_t: Optional[float] = None   # store clock
        self._lead_since: Optional[float] = None    # store clock, takeover
        self._results: Dict[Any, RequestResult] = {}
        self._order: List[Any] = []
        self.failovers_total = 0
        self.shed_total = 0
        self.elections_total = 0
        self.rolling_restarts_total = 0
        # prefix-affinity routing (docs/FLEET.md "Prefix residency
        # routing"): when on, admission prefers the engine whose residency
        # digest already holds the request's leading prefix chunks (hot
        # counts double vs demoted), as long as that engine's load is
        # within `affinity_load_slack` of the least-loaded one — affinity
        # must never turn into a hot-spot amplifier.
        self.prefix_affinity = bool(prefix_affinity)
        self.affinity_load_slack = int(affinity_load_slack)
        self.affinity_routes_total = 0
        # adapter-residency routing (docs/FLEET.md "Adapter residency
        # routing"): adapter-tagged dispatches that landed on a member
        # with the adapter already loaded (same slack bound as prefix
        # affinity — residency must not amplify a tenant hot-spot either)
        self.adapter_routes_total = 0
        # fleet-wide-unknown adapter_ids shed typed (finish_reason
        # "adapter_unknown") instead of queueing against members that can
        # never serve them (docs/FLEET.md "Adapter residency routing")
        self.adapter_unknown_total = 0
        # per-round memo of each member's digest as a {chain_key: tier}
        # map: scoring walks the full index otherwise, and a dispatch
        # burst would rebuild it per member per request on the admission
        # hot path (at most one round stale — the beat cadence is coarser)
        self._affinity_tiers: Dict[str, Dict[int, int]] = {}
        self._affinity_tiers_tick = -1
        self.tokens_by_engine: Dict[str, int] = {
            m.engine_id: 0 for m in members}
        # ---- sharded admission (docs/FLEET.md "Sharded admission"): N
        # routers under ONE election — followers CAS-claim rid-hash
        # partitions and journal-create accepted requests (engine=None);
        # the coordinator adopts and serves them.  None disables the
        # partition table entirely (the classic single-router fleet).
        self.admission_partitions = (int(admission_partitions)
                                     if admission_partitions is not None
                                     else None)
        if self.admission_partitions is not None \
                and self.admission_partitions < 1:
            raise ValueError(
                f"admission_partitions={self.admission_partitions} "
                "must be >= 1")
        self._my_partitions: set = set()
        self.partition_admissions_total = 0
        self.adopted_admissions_total = 0
        self._last_router_beat_t: Optional[float] = None   # store clock
        self._last_adopt_scan_t: Optional[float] = None    # store clock
        # ---- fleet-wide weight-epoch barrier (docs/FLEET.md,
        # docs/HYBRID.md): the in-progress flip document mirror, the
        # params being flipped to, and dispatches parked until commit
        self._flip: Optional[Dict[str, Any]] = None
        self._flip_params = None
        self._flip_hold: List[Tuple[Request, bool]] = []
        self.epoch_flips_total = 0
        # ---- store-partition tolerance (docs/FLEET.md "Store brownouts
        # and partitions").  self_fenced: this router believes it leads
        # but its own lease renewal has not succeeded within lease_s —
        # it must go QUIET (no dispatch, no journal flush, no GC) until a
        # successful election poll re-reads its leadership, because a
        # successor may already be serving the journal it still mirrors.
        # _renewal_ok_t: store-clock stamp of the last successful own-
        # lease renewal (the fence deadline's anchor).  _parked: requests
        # admission accepted but could not durably journal/dispatch while
        # the store was dark — retried every healthy coordinator round.
        # _pending_gc: journal entries whose terminal result landed but
        # whose fenced compare-delete could not reach the store.
        self.self_fenced = False
        self._renewal_ok_t: Optional[float] = None   # store clock
        self._parked: deque = deque()
        self._pending_gc: set = set()
        self.parked_total = 0
        self.fences_total = 0
        self.dispatches_total = 0
        self.store_unavailable_total = 0
        epoch_doc = store.get(FLEET_EPOCH_KEY)
        self.fleet_epoch = int((epoch_doc or {}).get("epoch") or 0)

    # ------------------------------------------------------------ admission

    def fleet_queue_depth(self) -> int:
        """Fleet-wide WAITING depth: every live engine's queue + pending,
        plus arrivals the router has not dispatched yet."""
        depth = len(self._later)
        for m in self.members.values():
            if m.alive:
                depth += m.backlog()
        return depth

    def submit(self, request: Request) -> Any:
        """Accept a request into the fleet.  Arrival offsets are measured
        from the ROUTER clock (the router owns admission gating so routing
        decisions see the load at dispatch time, not submission time); the
        absolute arrival epoch is stamped here and preserved across every
        failover.  Rids must be JSON scalars — the journal is how a
        successor coordinator reconstructs the request."""
        ids = np.asarray(request.input_ids, np.int32).reshape(-1)
        request = dataclasses.replace(request, input_ids=ids)
        rid = request.rid
        if not isinstance(rid, (str, int)) or isinstance(rid, bool):
            raise ValueError(
                f"fleet request ids must be str or int (got {type(rid)}): "
                "the store journal must reconstruct them on coordinator "
                "failover")
        if rid in self._requests or rid in self._results:
            raise ValueError(
                f"request id {rid!r} is already tracked by the fleet — "
                "rids must be unique")
        if request.arrival_epoch_s is None:
            request = dataclasses.replace(
                request,
                arrival_epoch_s=self._t0 + max(0.0, request.arrival_time))
        if request.trace_id is None:
            # the router is the request's first hop: assign the fleet-wide
            # trace id here so every dispatch, journal entry and failover
            # reconstruction carries the SAME id (docs/OBSERVABILITY.md)
            request = dataclasses.replace(request, trace_id=new_trace_id())
        self._requests[rid] = request
        if request.arrival_time > 0:
            # journal BEFORE parking (engine=None: accepted, not yet
            # dispatched) — a future arrival must survive coordinator
            # death like any dispatched request, or the standby would
            # adopt an empty journal and silently drop it
            try:
                self._journal(rid, request, None, create=True)
            except (StoreUnavailable, OSError) as e:
                # degraded acceptance (docs/FLEET.md "Store brownouts and
                # partitions"): the arrival is tracked and will be
                # journaled at dispatch (the route-time create heals it),
                # but a coordinator death before then loses it — logged,
                # never silent
                self.store_unavailable_total += 1
                logger.warning(
                    "fleet: accepted %r without a durable journal entry "
                    "(store unavailable: %s); it will be journaled at "
                    "dispatch", rid, e)
            bisect.insort(self._later, request, key=lambda r: r.arrival_time)
            return rid
        self._route(request)
        return rid

    # --------------------------------------------------- sharded admission

    def owns_partition(self, rid: Any) -> bool:
        """Whether THIS router owns the admission partition ``rid`` hashes
        to (always True when partitioning is disabled)."""
        if self.admission_partitions is None:
            return True
        return (partition_of(rid, self.admission_partitions)
                in self._my_partitions)

    def admit(self, request: Request) -> Any:
        """Sharded admission (docs/FLEET.md "Sharded admission"): accept a
        request on a FOLLOWER router by journal-creating its entry
        (``engine=None`` — accepted, not yet dispatched) straight on the
        store.  The elected coordinator adopts and serves it; results are
        claimed from the coordinator.  This is how N routers break the
        one-process admission bound: validation + the journal-create write
        shard by rid hash, while membership, failover and GC stay with the
        single coordinator.  Requires ownership of the rid's partition
        (:class:`FleetWrongPartition` otherwise).  On the coordinator —
        or with partitioning disabled — this is a plain :meth:`submit`."""
        if self.admission_partitions is None or self.is_coordinator:
            return self.submit(request)
        ids = np.asarray(request.input_ids, np.int32).reshape(-1)
        request = dataclasses.replace(request, input_ids=ids)
        rid = request.rid
        if not isinstance(rid, (str, int)) or isinstance(rid, bool):
            raise ValueError(
                f"fleet request ids must be str or int (got {type(rid)}): "
                "the store journal must reconstruct them on adoption")
        part = partition_of(rid, self.admission_partitions)
        if part not in self._my_partitions:
            raise FleetWrongPartition(
                f"rid {rid!r} hashes to partition {part}, which router "
                f"{self.router_id} does not own "
                f"(owned: {sorted(self._my_partitions)})")
        if request.arrival_epoch_s is None:
            request = dataclasses.replace(
                request, arrival_epoch_s=time.monotonic())
        if request.trace_id is None:
            request = dataclasses.replace(request, trace_id=new_trace_id())
        with trace_tags(router=self.router_id), \
                trace_span("fleet.admit", rid=rid, partition=part):
            doc = {
                "rid": rid,
                "engine": None,
                "input_ids": [int(x) for x in request.input_ids],
                "max_new_tokens": int(request.max_new_tokens),
                "eos_token_id": (int(request.eos_token_id)
                                 if request.eos_token_id is not None
                                 else None),
                "deadline_s": request.deadline_s,
                "arrival_epoch_s": request.arrival_epoch_s,
                "failovers": 0,
                "tokens": [],
                "resumed": 0,
                "sampling": (dataclasses.asdict(request.sampling)
                             if request.sampling is not None else None),
                "lane_counter": len(request.input_ids),
                "trace_id": request.trace_id,
                "lifecycle": [],
                # admission stamp, not ownership: the coordinator
                # re-stamps owner/term when it adopts the entry
                "owner": self.router_id,
                "term": 0,
                "t": self.store.now()}
            key = f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rid)}"

            # same create-retry shape as the coordinator's submission-time
            # journal write: a pre-existing document for a rid this router
            # just accepted can only be an orphan of a previous run.  The
            # retry loop rides StoreRetryPolicy, so a store that stays
            # dark surfaces as a typed StoreUnavailable to the admission
            # caller (honest backpressure) instead of spinning forever.
            def _attempt():
                cur = self.store.get(key)
                if self.store.compare_and_swap(key, cur, doc):
                    if cur is not None:
                        logger.warning(
                            "fleet: admission entry for %r was an orphan "
                            "of a previous run; overwritten", rid)
                    return True
                if cur is None and self.store.get(key) is None:
                    # a compare-delete tombstone of a COLLECTED previous
                    # stream with this rid blocks the create: a fresh
                    # admission is a new stream by contract — clear it
                    self.store.clear_tombstone(key)
                return StoreRetryPolicy.RETRY

            default_retry_policy().run(f"admit({rid!r})", _attempt)
        self.partition_admissions_total += 1
        return rid

    def _partition_key(self, i: int) -> str:
        return f"{FLEET_PARTITION_PREFIX}/{int(i)}"

    def claim_partitions(self, max_new: int = 1) -> set:
        """Renew this router's partition claims and CAS-claim vacant ones
        (at most ``max_new`` new claims per call, so N starting routers
        spread the table instead of one grabbing everything).  A claim the
        coordinator force-released from a dead router (its compare-delete
        leaves a tombstone) is cleared here and claimed on the NEXT round
        — one round of backoff keeps rival claimers from spinning on the
        clear/create race.  Returns the owned partition set."""
        if self.admission_partitions is None:
            return set()
        now = self.store.now()
        new_claims = 0
        for i in range(self.admission_partitions):
            key = self._partition_key(i)
            doc = self.store.get(key)
            claim = {"partition": i, "router": self.router_id, "t": now}
            if doc is not None and doc.get("router") == self.router_id:
                if self.store.compare_and_swap(key, doc, claim):
                    self._my_partitions.add(i)
                else:
                    # reassigned under us (the coordinator declared this
                    # router dead and freed the claim): stop admitting it
                    self._my_partitions.discard(i)
            elif doc is None and new_claims < int(max_new):
                if self.store.compare_and_swap(key, None, claim):
                    self._my_partitions.add(i)
                    new_claims += 1
                elif self.store.get(key) is None:
                    self.store.clear_tombstone(key)
            elif doc is not None:
                self._my_partitions.discard(i)
        return set(self._my_partitions)

    def _beat_router(self) -> None:
        """Renew this ROUTER's lease (``fleet/router_heartbeat/<id>``) —
        the liveness signal partition reassignment keys off.  Same
        rate-limit discipline as the member beats."""
        now = self.store.now()
        if self._last_router_beat_t is not None \
                and now - self._last_router_beat_t < self.lease_s / 3.0:
            return
        self._last_router_beat_t = now
        beat(self.store, self.router_id, self.generation, self.lease_s,
             prefix=FLEET_ROUTER_HEARTBEAT_PREFIX,
             partitions=sorted(self._my_partitions),
             is_coordinator=self.is_coordinator)
        # the lease is truth; the dead marker is a scan artifact.  A router
        # wrongly marked dead (e.g. a stop-the-world pause lapsed its lease)
        # re-admits itself the moment it beats again — otherwise
        # _scan_router_leases would release its partition claims forever
        # even though the lease is fresh (permanent-marker livelock).
        clear_dead(self.store, self.router_id,
                   prefix=FLEET_ROUTER_DEAD_PREFIX)

    def _scan_router_leases(self) -> None:
        """Coordinator side of partition reassignment: a partition whose
        claiming router's lease lapsed ``miss_limit`` periods (or which
        carries a dead marker) is force-released with a FENCED
        compare-delete — a claimant that was merely stalled renews by CAS
        against its own claim document and loses cleanly.  The tombstone
        is cleared right away: the fence against the stale RENEWAL is the
        expected-document mismatch, and fresh claims must land."""
        if self.admission_partitions is None:
            return
        now = self.store.now()
        table = lease_table(self.store,
                            prefix=FLEET_ROUTER_HEARTBEAT_PREFIX)
        marked = set(dead_set(self.store, prefix=FLEET_ROUTER_DEAD_PREFIX))
        for i in range(self.admission_partitions):
            key = self._partition_key(i)
            doc = self.store.get(key)
            if doc is None:
                continue
            owner = str(doc.get("router"))
            if owner == self.router_id:
                continue
            lease = table.get(owner)
            lapsed = (lease is None
                      or lease.missed(now) >= self.miss_limit)
            if not lapsed and owner not in marked:
                continue
            if self.store.compare_and_delete(key, doc):
                self.store.clear_tombstone(key)
                record_dead(self.store, owner, self.generation,
                            self.router_id,
                            prefix=FLEET_ROUTER_DEAD_PREFIX)
                log_dist(
                    f"fleet: released admission partition {i} from dead "
                    f"router {owner} (lease "
                    f"{'lapsed' if lapsed else 'marked dead'})", ranks=[0])

    def _adopt_new_admissions(self) -> None:
        """Coordinator pickup of follower-admitted requests: scan the
        journal for entries this router does not track and adopt them
        (the same adoption path a takeover runs).  Rate-limited to a
        third of the election lease on the store clock — admission
        latency is bounded by the scan period, which is the price of
        store-only coupling between routers."""
        if self.admission_partitions is None:
            return
        now = self.store.now()
        if self._last_adopt_scan_t is not None \
                and now - self._last_adopt_scan_t < self.lease_s / 3.0:
            return
        self._last_adopt_scan_t = now
        for name in self.store.list(FLEET_REQUESTS_PREFIX):
            rec = self.store.get(f"{FLEET_REQUESTS_PREFIX}/{name}")
            if rec is None:
                continue
            rid = rec["rid"]
            if rid in self._requests or rid in self._results:
                continue
            self._adopt_entry(rec)
            self.adopted_admissions_total += 1

    # ------------------------------------------------- weight-epoch barrier

    def begin_epoch_flip(self, params, epoch: Optional[int] = None) -> int:
        """Start a fleet-wide two-phase weight flip (docs/FLEET.md
        "Weight-epoch barrier"; closes the docs/HYBRID.md caller-sequenced
        limitation).  Phase 1 (prepare): routing is HELD — every new or
        failed-over request parks at the router — while each live member
        drains its in-flight work and flips to ``params`` at the target
        epoch, writing a durable ``fleet/epoch/prepare/<engine>`` mark.
        Phase 2 (commit): once every LIVE member's mark is at the target,
        the coordinator CAS-commits ``fleet/epoch/current`` and releases
        the held requests — so no request is ever admitted against stale
        weights, on any member.  Members whose lease lapses mid-prepare
        are excluded by the same lease scan that fails their work over
        (the failover re-route parks with everything else until the
        commit).  Coordinator action; the flip itself advances inside
        :meth:`step` (see :meth:`flip_weight_epoch` for the synchronous
        wrapper)."""
        if not self.is_coordinator:
            raise RuntimeError(
                "begin_epoch_flip is a coordinator action — step() until "
                "this router holds the lease")
        if self._flip is not None:
            raise RuntimeError(
                f"weight-epoch flip to {self._flip['epoch']} is already "
                "in progress")
        target = int(epoch) if epoch is not None else self.fleet_epoch + 1
        if target <= self.fleet_epoch:
            raise ValueError(
                f"epoch must advance: target {target} <= committed "
                f"{self.fleet_epoch}")
        doc = {"epoch": target, "coordinator": self.router_id,
               "term": int(self.term), "t": self.store.now()}
        def _attempt():
            cur = self.store.get(FLEET_EPOCH_FLIP_KEY)
            if self.store.compare_and_swap(FLEET_EPOCH_FLIP_KEY, cur, doc):
                return True
            if cur is None and self.store.get(FLEET_EPOCH_FLIP_KEY) is None:
                self.store.clear_tombstone(FLEET_EPOCH_FLIP_KEY)
            return StoreRetryPolicy.RETRY

        default_retry_policy().run("begin_epoch_flip", _attempt)
        self._flip = doc
        self._flip_params = params
        log_dist(f"fleet: weight-epoch flip to {target} started "
                 f"(coordinator {self.router_id}, term {self.term})",
                 ranks=[0])
        return target

    def _advance_epoch_flip(self) -> None:
        """One prepare/commit round of an in-progress flip — runs every
        coordinator tick after the lease scan, so members that died
        mid-prepare have already been excluded (and their work parked)."""
        if self._flip is None:
            return
        target = int(self._flip["epoch"])
        with trace_span("fleet.epoch_flip", epoch=target,
                        router=self.router_id):
            pending = []
            for eid in sorted(self.members):
                m = self.members[eid]
                if not m.alive:
                    continue   # lapsed mid-prepare: excluded by the scan
                mark = self.store.get(f"{FLEET_EPOCH_PREPARE_PREFIX}/{eid}")
                if mark is not None and int(mark.get("epoch") or -1) \
                        >= target:
                    continue   # durable prepare mark already at target
                if not m.prepare_epoch(self._flip_params, target):
                    pending.append(eid)
            if pending:
                return   # still draining; routing stays held
            commit = {"epoch": target, "coordinator": self.router_id,
                      "term": int(self.term), "t": self.store.now()}

            def _attempt():
                cur = self.store.get(FLEET_EPOCH_KEY)
                if cur is not None and int(cur.get("epoch") or 0) >= target:
                    return True   # a racing coordinator committed past us
                if self.store.compare_and_swap(FLEET_EPOCH_KEY, cur,
                                               commit):
                    return True
                return StoreRetryPolicy.RETRY

            default_retry_policy().run("commit_epoch", _attempt)
        if self.store.compare_and_delete(FLEET_EPOCH_FLIP_KEY, self._flip):
            # the tombstone fenced the dead coordinator's stale flip doc,
            # not future flips — clear it so the next begin_ can create
            self.store.clear_tombstone(FLEET_EPOCH_FLIP_KEY)
        self.fleet_epoch = target
        self.epoch_flips_total += 1
        self._flip = None
        self._flip_params = None
        held, self._flip_hold = self._flip_hold, []
        log_dist(f"fleet: weight-epoch {target} committed fleet-wide; "
                 f"releasing {len(held)} held request(s)", ranks=[0])
        for req, requeue in held:
            self._route(req, requeue=requeue)

    def flip_weight_epoch(self, params, epoch: Optional[int] = None,
                          max_ticks: int = 500, on_tick=None) -> int:
        """Synchronous fleet-wide weight flip: begin, then step the fleet
        until the commit lands.  Returns the committed epoch.  This is
        what :meth:`RolloutEngine.publish_weights_fleet` drives between
        rollout rounds."""
        target = self.begin_epoch_flip(params, epoch=epoch)
        rounds = 0
        while self._flip is not None:
            self.step()
            rounds += 1
            if on_tick is not None:
                on_tick(self, rounds)
            if rounds >= max_ticks:
                raise ServeTimeout(
                    f"weight-epoch flip to {target} did not commit within "
                    f"max_ticks={max_ticks} (members still draining?)")
        return self.fleet_epoch

    def _remaining_deadline(self, req: Request) -> Optional[float]:
        """Deadline budget left, measured from the TRUE arrival epoch —
        idempotent across failovers (always derived from the original
        deadline, never from a previously-reduced copy), and floored at an
        epsilon so an already-dead request still flows through the
        engine's typed expiry path."""
        if req.deadline_s is None:
            return None
        elapsed = max(0.0, time.monotonic() - req.arrival_epoch_s)
        return max(1e-6, req.deadline_s - elapsed)

    def _pick_engine(self, request: Optional[Request] = None
                     ) -> Optional[str]:
        """Least-loaded live routable engine (waiting + decoding count)
        with a prefix-affinity term: when ``request`` is given and its
        leading prefix chunks are resident on some engine (hot or
        demoted, per the residency digests), that engine wins admission
        as long as its load is within ``affinity_load_slack`` of the
        minimum — a shared-prefix request lands where the K/V already
        lives instead of on the least-loaded stranger (docs/FLEET.md
        "Prefix residency routing").  Loads read from the live member
        handle — the store advertisement carries the SAME numbers for
        cross-process consumers, but it is refreshed once per round and
        several dispatches can land within one, so routing must see each
        dispatch it just made.  engine_id breaks ties deterministically.

        Multi-tenant requests add two terms (docs/FLEET.md "Adapter
        residency routing").  A HARD one: a member serving a fused
        adapter view (``fused_adapter_id`` set) only admits that tenant,
        so every other request skips it — routing there would bounce at
        the engine's fused-exclusive submit guard.  And a SOFT one: an
        adapter-tagged request prefers the least-loaded member that has
        its adapter registered (live registry for in-process members,
        ``adapters_loaded`` advertisement — at most one beat stale — for
        cross-process ones) under the same ``affinity_load_slack``
        bound, counted by ``adapter_routes_total``; prefix affinity then
        refines the pick AMONG adapter-resident candidates using the
        tenant-salted chain keys.  With no resident member in slack the
        request falls back to least-loaded (an engine without the
        registration sheds it typed at submit — registry sync across a
        heterogeneous fleet is the operator's job)."""
        want = (getattr(request, "adapter_id", None)
                if request is not None else None)
        best = None
        best_load = None
        loads: Dict[str, int] = {}
        resident: Dict[str, bool] = {}
        for eid in sorted(self.members):
            m = self.members[eid]
            if not (m.alive and m.routable):
                continue
            if self.fleet_epoch and m.weight_epoch() < self.fleet_epoch:
                # weight-epoch invariant (docs/FLEET.md "Weight-epoch
                # barrier"): a member still serving pre-flip weights is
                # not an admission target — no request is ever admitted
                # against stale weights
                continue
            if request is not None:
                loaded, fused = self._member_adapter_state(m)
                if fused is not None and fused != want:
                    # fused-exclusive member: only its own tenant lands
                    continue
                resident[eid] = want is not None and (want in loaded
                                                      or fused == want)
            loads[eid] = m.outstanding()
            if best_load is None or loads[eid] < best_load:
                best, best_load = eid, loads[eid]
        if best is None or request is None:
            return best
        cand = loads
        floor = best
        if want is not None:
            rset = [eid for eid in sorted(loads) if resident.get(eid)]
            ad_best = min(rset, key=lambda e: loads[e], default=None)
            if ad_best is None or \
                    loads[ad_best] - best_load > self.affinity_load_slack:
                return best
            if ad_best != best:
                logger.info(
                    "fleet: routing %r to %s on adapter residency "
                    "(%r loaded, load %d vs min %d)", request.rid, ad_best,
                    want, loads[ad_best], best_load)
            self.adapter_routes_total += 1
            # prefix affinity below only refines among the members that
            # can actually serve this tenant, inside the same slack
            cand = {eid: loads[eid] for eid in rset
                    if loads[eid] - best_load <= self.affinity_load_slack}
            floor = ad_best
        if not self.prefix_affinity:
            return floor
        aff_best, aff_score = None, 0
        salt = adapter_salt(want)
        key_memo: Dict[int, List[int]] = {}
        for eid in sorted(cand):
            m = self.members[eid]
            ps = int(m.sup.engine.page_size) if m.alive else 0
            if ps <= 0:
                continue
            keys = key_memo.get(ps)
            if keys is None:
                # the same cap as the engine's own lookup: the last prompt
                # token always prefills, so it can never be resident
                # tenant-salted schedule: an adapter-tagged request's
                # resident chunks live under its salted namespace, and a
                # base request can never false-hit a tenant's chunks
                keys = key_memo[ps] = chain_keys(
                    request.input_ids, ps,
                    limit=len(request.input_ids) - 1, salt=salt)
            score = self._affinity_score(keys, m)
            if score > aff_score:
                aff_best, aff_score = eid, score
        if aff_best is not None \
                and loads[aff_best] - best_load <= self.affinity_load_slack:
            if aff_best != best:
                logger.info(
                    "fleet: routing %r to %s on prefix affinity "
                    "(score %d, load %d vs min %d)", request.rid, aff_best,
                    aff_score, loads[aff_best], best_load)
            self.affinity_routes_total += 1
            return aff_best
        return floor

    def _member_adapter_state(self, member: FleetMember
                              ) -> Tuple[set, Optional[str]]:
        """(loaded adapter ids, fused adapter id) for routing.  A live
        in-process member answers from its engine's registry — routing
        must see a registration made since the last beat — otherwise the
        last advertisement serves (the cross-process transport, at most
        one beat stale).  No registry anywhere reads as (empty, None):
        such a member admits base traffic only."""
        if member.alive:
            eng = getattr(member.sup, "engine", None)
            reg = getattr(eng, "adapters", None)
            if reg is not None:
                return (set(reg.loaded()),
                        getattr(eng, "fused_adapter_id", None))
        ad = member.last_advert or {}
        return (set(ad.get("adapters_loaded") or ()),
                ad.get("fused_adapter_id"))

    def _adapter_known_fleetwide(self, adapter_id: str) -> bool:
        """Whether ANY member of the fleet can serve ``adapter_id``: live
        registries for in-process members, the store-backed digest
        (``fleet/adapters/<engine>``, one beat stale at most, with the
        advertisement as a fallback transport) for everyone else.  Fails
        OPEN on a dark store — shedding on missing information would turn
        a brownout into typed request loss."""
        for eid in sorted(self.members):
            m = self.members[eid]
            if m.alive:
                loaded, fused = self._member_adapter_state(m)
            else:
                ad = m.last_advert
                if ad is None:
                    try:
                        ad = (self.store.get(
                            f"{FLEET_ADAPTERS_PREFIX}/{eid}")
                            or self.store.get(
                                f"{FLEET_ENGINES_PREFIX}/{eid}"))
                    except (StoreUnavailable, OSError):
                        return True   # fail open: never shed on no data
                loaded = set((ad or {}).get("adapters_loaded") or ())
                fused = (ad or {}).get("fused_adapter_id")
            if adapter_id in loaded or fused == adapter_id:
                return True
        return False

    def _affinity_score(self, keys: List[int], member: FleetMember) -> int:
        """Leading prefix chunks of ``keys`` resident on ``member``: 2 per
        hot (device) chunk, 1 per demoted one, stopping at the first miss
        (a non-leading hit saves nothing — admission maps prefixes from
        token 0).  An in-process live member is scored off its engine's
        index (memoized per router round); otherwise the last
        store-published digest serves (the cross-process transport)."""
        if self._affinity_tiers_tick != self._tick:
            self._affinity_tiers = {}
            self._affinity_tiers_tick = self._tick
        tiers = self._affinity_tiers.get(member.engine_id)
        if tiers is None:
            digest = None
            if member.alive:
                try:
                    digest = member.residency_digest()
                except Exception:   # pragma: no cover - defensive
                    digest = None
            if digest is None:
                doc = (member.last_residency
                       or self.store.get(
                           f"{FLEET_RESIDENCY_PREFIX}/{member.engine_id}"))
                digest = (doc or {}).get("digest") or []
            tiers = {int(k): int(t) for k, t in digest}
            self._affinity_tiers[member.engine_id] = tiers
        score = 0
        for k in keys:
            tier = tiers.get(k)
            if tier is None:
                break
            score += 2 if tier == 0 else 1
        return score

    def _route(self, request: Request, requeue: bool = False) -> None:
        """Dispatch to the least-loaded engine (or shed).  ``requeue`` is
        the failover/redistribution path: work the fleet ALREADY accepted
        is never shed by its own recovery — the same contract the serving
        supervisor holds for replays."""
        rid = request.rid
        if self.self_fenced:
            # fence first, flip-hold second: a fenced router must not
            # dispatch AT ALL — a successor may own this very rid —
            # so the request parks until a successful election poll
            # re-reads leadership (docs/FLEET.md "Store brownouts")
            self._park(request, requeue, "self-fenced")
            return
        if self._flip is not None:
            # weight-epoch admission gate: nothing dispatches while the
            # fleet flips (members must drain to flip, and a dispatch
            # here would land on pre-flip weights) — parked, dispatched
            # the round the flip commits.  Shedding is gated too:
            # dropping work the fleet can serve seconds later is worse
            # than holding it.
            self._flip_hold.append((request, requeue))
            return
        if not requeue and self.max_fleet_queue is not None \
                and self.fleet_queue_depth() >= self.max_fleet_queue:
            self._shed(request, "fleet queue full")
            return
        want = getattr(request, "adapter_id", None)
        if not requeue and want is not None \
                and not self._adapter_known_fleetwide(want):
            # queueing would park the request against a member that can
            # never serve it; the typed reason + retry hint tell the
            # client to re-submit after registering (or to a fleet that
            # has) the adapter.  Requeued work is exempt — the fleet
            # already accepted it, and its member served it once.
            self.adapter_unknown_total += 1
            self._shed(request,
                       f"adapter {want!r} unknown fleet-wide",
                       finish_reason="adapter_unknown")
            return
        target = self._pick_engine(request)
        if target is None:
            if requeue:
                raise FleetUnrecoverable(
                    f"no live engine remains to fail request {rid!r} over "
                    "to — the whole fleet is dead")
            self._shed(request, "no live engines")
            return
        member = self.members[target]
        resumed = self._resumed.get(rid) or []
        sub_ids = request.input_ids
        if resumed:
            # mid-stream resume: the journaled tokens ride the PROMPT (pure
            # KV reconstruction — the prefill recomputes their K/V, emits
            # nothing) and the new-token budget shrinks by exactly the
            # resumed count, so decoding continues AFTER the last journaled
            # token and no journaled token is ever re-emitted
            sub_ids = np.concatenate(
                [np.asarray(request.input_ids, np.int32),
                 np.asarray(resumed, np.int32)])
        sub = dataclasses.replace(
            request,
            input_ids=sub_ids,
            max_new_tokens=request.max_new_tokens - len(resumed),
            # engine-relative arrival: "now" on the target's clock, so its
            # deadline/queued-age math starts at dispatch while the epoch
            # stamp keeps reporting anchored to the true arrival
            arrival_time=max(0.0,
                             time.monotonic() - member.sup.engine._t0),
            deadline_s=self._remaining_deadline(request))
        if resumed:
            # lifecycle resume marker (src = the engine continuing the
            # stream) — recorded BEFORE the journal write below so the
            # entry a successor adopts carries it too
            self._lifecycle.setdefault(rid, []).append(
                ("resume", time.monotonic(), target))
        # journal BEFORE dispatch: a failover/redistribution write that
        # loses its CAS means a successor coordinator owns this request —
        # submitting it here anyway would re-serve a stream the successor
        # is already completing (duplicate terminal result).  Only a
        # non-requeue dispatch (fresh submission / adopted parked arrival)
        # may CREATE the journal entry.
        try:
            owned = self._journal(rid, request, target, create=not requeue)
        except (StoreUnavailable, OSError) as e:
            # the store is dark: dispatching WITHOUT the durable record
            # would make this stream invisible to any successor (lost on
            # the next failover) — park it and retry when the store heals
            self.store_unavailable_total += 1
            self._park(request, requeue, f"store unavailable: {e}")
            return
        if not owned:
            logger.warning(
                "fleet: skipping dispatch of %r — journal ownership lost "
                "to a successor coordinator, which now drives it", rid)
            return
        member.submit(sub)
        self._owner[rid] = target
        self.dispatches_total += 1

    def _park(self, request: Request, requeue: bool, why: str) -> None:
        """Park admission instead of crashing (or worse, dispatching
        un-journaled): the request stays tracked in ``_requests`` and is
        re-routed on the next healthy, un-fenced coordinator round."""
        self._parked.append((request, requeue))
        self.parked_total += 1
        logger.warning("fleet: parking %r (%s); %d parked",
                       request.rid, why, len(self._parked))

    def _shed(self, request: Request, why: str,
              finish_reason: str = "shed") -> None:
        t = time.monotonic()
        target = self._pick_engine()
        hint = (self.members[target].sup.engine._retry_after_hint()
                if target is not None else 1.0)
        rid = request.rid
        lc = self._lifecycle.pop(rid, [])
        lc.append(("shed", t, self.router_id))
        self._results[rid] = RequestResult(
            rid=rid, input_ids=request.input_ids,
            output_ids=np.zeros((0,), np.int32),
            finish_reason=finish_reason,
            prefill_bucket=0,
            arrival_s=request.arrival_epoch_s or t, admit_s=t,
            first_token_s=t, finish_s=t, retry_after_s=hint,
            trace_id=request.trace_id, lifecycle=lc)
        self._order.append(rid)
        self._requests.pop(rid, None)
        # a shed request may have been journaled at submit (future
        # arrival): its terminal result is decided here, so the journal
        # entry must not outlive it (delete is idempotent)
        self._journal_delete(rid)
        self.shed_total += 1
        logger.warning("fleet: shed request %r (%s); retry_after=%.3fs",
                       rid, why, hint)

    def _journal(self, rid: Any, request: Request,
                 engine_id: Optional[str], create: bool = False) -> bool:
        """Durable assignment record: everything a SUCCESSOR coordinator
        needs to re-own (and, if the engine dies, resume or re-prefill)
        the request.  ``engine_id=None`` = accepted but not yet dispatched
        (a future arrival parked at the router).  ``tokens`` holds the
        journaled stream so far (grown by :meth:`_flush_token_journal`);
        ``resumed`` counts how many of them are baked into the CURRENT
        assignment's prompt, so a successor can stitch collected outputs
        without having watched the dispatch.  Deleted when the result is
        collected (or the request is shed).

        The write is a compare-and-swap against this router's mirror of
        the entry (``None`` = creating a fresh submission), NOT a blind
        put: a deposed leader stalled mid-step can reach here after its
        successor already collected the result and GC'd the entry, and a
        put would resurrect the finished request for the next takeover to
        re-serve.  Losing the CAS means we are no longer the journal's
        owner — drop the mirror and stand down on this entry.  Returns
        whether OUR document landed (False = ownership lost; the caller
        must not dispatch the request either)."""
        resumed = self._resumed.get(rid) or []
        doc = {
            "rid": rid,
            "engine": engine_id,
            "input_ids": [int(x) for x in request.input_ids],
            "max_new_tokens": int(request.max_new_tokens),
            "eos_token_id": (int(request.eos_token_id)
                             if request.eos_token_id is not None else None),
            "deadline_s": request.deadline_s,
            "arrival_epoch_s": request.arrival_epoch_s,
            "failovers": self._failed_over.get(rid, 0),
            "tokens": [int(t) for t in resumed],
            "resumed": len(resumed),
            # RNG lane state (docs/FLEET.md): the sampling params (seed
            # included) plus the lane counter — the stream position of the
            # next token, prompt + journaled.  Keys are counter-based
            # (position_generator(seed, position)), so a successor that
            # re-prefills prompt+journaled re-derives the lane at exactly
            # this counter and the resumed sampled stream is token-exact.
            "sampling": (dataclasses.asdict(request.sampling)
                         if request.sampling is not None else None),
            "lane_counter": len(request.input_ids) + len(resumed),
            # multi-tenant serving (docs/SERVING.md): the tenant identity
            # rides the journal so a failover resume re-prefills under
            # the SAME adapter — prompt+journaled reconstruction with the
            # wrong (or no) delta would be silently non-token-exact
            "adapter_id": request.adapter_id,
            # distributed tracing (docs/OBSERVABILITY.md): the trace id —
            # a failover reconstruction continues the SAME trace on the
            # new engine — plus the router-recorded lifecycle markers
            # (failover/resume) so a successor stitches the same record
            "trace_id": request.trace_id,
            "lifecycle": [list(e) for e in self._lifecycle.get(rid, ())],
            # ownership stamp: which router wrote this document under
            # which election term.  A takeover RE-stamps every adopted
            # entry, so a deposed leader's mirror goes stale the moment a
            # successor owns the journal — its compare-delete and CAS
            # appends then lose by construction (docs/FLEET.md
            # "Journal GC").
            "owner": self.router_id,
            "term": int(self.term),
            "t": self.store.now()}
        key = f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rid)}"
        expected = self._journal_docs.get(rid)
        if expected is None and create:
            # SUBMISSION-time write of a rid this router just accepted
            # from the caller: no successor can know it, so a pre-existing
            # document can only be an orphan of a crashed previous run —
            # adopting it (or giving up) would poison a later resume with
            # a foreign stream's tokens or leave an accepted request
            # un-journaled (flush never creates).  Retry the create
            # against each freshly read value until our document lands
            # (same loop shape as bump_generation; contention here can
            # only be the dying orphan writer's last flushes).  The loop
            # rides StoreRetryPolicy: a dark store surfaces as a typed
            # StoreUnavailable at its deadline, which _route turns into a
            # parked request instead of a crash.
            def _attempt():
                cur = self.store.get(key)
                if self.store.compare_and_swap(key, cur, doc):
                    if cur is not None:
                        logger.warning(
                            "fleet: journal entry for %r was an orphan of "
                            "a previous run; overwritten with the fresh "
                            "submission", rid)
                    self._journal_docs[rid] = doc
                    self._journal_sizes[rid] = _doc_bytes(doc)
                    return True
                if cur is None and self.store.get(key) is None:
                    # the create lost to nothing visible: a live GC
                    # tombstone from a just-collected previous request
                    # under the same rid.  Legitimate rid reuse — clear
                    # the tombstone and retry (a racing deposed leader's
                    # stale append still has a non-None expected and
                    # cannot slip through this gap).
                    self.store.clear_tombstone(key)
                return StoreRetryPolicy.RETRY

            return default_retry_policy().run(
                f"journal_create({rid!r})", _attempt)
        if expected is None:
            # DISPATCH-time write (failover/redistribution) with no
            # mirror: this router lost journal ownership earlier (a lost
            # CAS dropped the mirror).  Writing anything here would either
            # resurrect a GC'd entry (key absent) or clobber a successor's
            # appends (key rewritten) — the exact fence the create path is
            # scoped to preserve.  Re-sync the mirror and stand down.
            cur = self.store.get(key)
        elif self.store.compare_and_swap(key, expected, doc):
            self._journal_docs[rid] = doc
            self._journal_sizes[rid] = _doc_bytes(doc)
            return True
        else:
            # stale mirror: this router journaled the rid before and lost
            # ownership mid-stream — re-sync to whatever the successor
            # left, or forget a GC'd entry entirely
            cur = self.store.get(key)
        if cur is None:
            self._journal_docs.pop(rid, None)
            self._journal_sizes.pop(rid, None)
        else:
            self._journal_docs[rid] = cur
            self._journal_sizes[rid] = _doc_bytes(cur)
        logger.warning(
            "fleet: journal write for %r lost its CAS (a successor "
            "coordinator owns the entry now); standing down on it", rid)
        return False

    def _journal_delete(self, rid: Any) -> None:
        """GC one journal entry (idempotent): the store document AND this
        router's mirrors — runs for every terminal result, including ones
        collected by a freshly elected standby that never dispatched the
        request.

        The delete is FENCED (``compare_and_delete`` against the same
        mirror the CAS'd writes use), closing what used to be the
        one-stalled-step duplicate-serve window: a leader that confirms
        its lease at the top of step(), stalls past the election lease
        MID-step, and reaches this delete after a successor adopted (and
        re-stamped) the entry now LOSES the compare — the successor's
        document survives and the request is re-served exactly once by
        the owner that adopted it.  With no mirror we fall back to a
        store read, but stand down entirely if the document carries a
        different router's ownership stamp."""
        if self.self_fenced:
            # defense in depth on top of the fenced step(): a fenced
            # ex-leader must not GC — the successor may still be serving
            # this rid, and even a LOSING compare-delete round-trips the
            # store it has no business writing to.  Deferred; the
            # un-fenced retry path picks it up.
            self._pending_gc.add(rid)
            return
        key = f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rid)}"
        expected = self._journal_docs.get(rid)
        try:
            if expected is None:
                expected = self.store.get(key)
                if expected is not None and expected.get("owner") not in (
                        None, self.router_id):
                    logger.warning(
                        "fleet: journal GC for %r stood down — entry is "
                        "owned by %r now (we were deposed)", rid,
                        expected.get("owner"))
                    expected = None
            if expected is not None:
                if not self.store.compare_and_delete(key, expected):
                    logger.warning(
                        "fleet: journal GC for %r lost its compare-delete "
                        "(a successor re-stamped the entry); standing "
                        "down", rid)
        except (StoreUnavailable, OSError) as e:
            # the terminal result is already local — only the GC write is
            # owed.  Defer it (mirror kept: it is the fenced compare-
            # delete's expected document) and retry on a healthy round.
            self.store_unavailable_total += 1
            self._pending_gc.add(rid)
            logger.warning(
                "fleet: journal GC for %r deferred — store unavailable "
                "(%s)", rid, e)
            return
        self._pending_gc.discard(rid)
        self._journal_docs.pop(rid, None)
        self._journal_sizes.pop(rid, None)
        self._resumed.pop(rid, None)
        self._lifecycle.pop(rid, None)

    def journal_bytes(self) -> int:
        """Approximate bytes of journal entries this coordinator currently
        maintains on the store (serialized-document sizes; the
        ``fleet/journal_bytes`` gauge)."""
        return sum(self._journal_sizes.values())

    def journal_cas_latencies(self) -> List[float]:
        """Recent per-append journal CAS wall times in seconds (bounded
        window) — what ``journal_every_k`` / ``journal_flush_ms`` should
        be tuned against on a real store."""
        return list(self._journal_cas_lat_s)

    def _journaled_tokens(self, rid: Any) -> List[int]:
        """The durably journaled stream for ``rid`` — the router's mirror,
        falling back to a store read for an entry adopted but never
        re-written by this router."""
        doc = self._journal_docs.get(rid)
        if doc is None:
            doc = self.store.get(f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rid)}")
        return [int(t) for t in (doc or {}).get("tokens") or []]

    def _flush_token_journal(self) -> None:
        """Batched token append: fold every live member's in-flight stream
        progress into the journal.  Each append is ONE compare-and-swap
        against the document this router last saw — a takeover mid-append
        is safe: the successor rewrote the document, our stale ``expected``
        loses, and we drop the mirror so the next flush re-reads instead of
        fighting.  Appends never CREATE an entry (a missing document means
        the request was collected or shed — recreating it would resurrect
        a finished request on the next takeover)."""
        if self.self_fenced:
            # defense in depth: a fenced ex-leader's appends would lose
            # their CAS anyway once the successor re-stamps, but before
            # adoption they would WIN against entries nobody owns —
            # racing the successor's takeover scan.  Quiet means quiet.
            return
        for eid in sorted(self.members):
            m = self.members[eid]
            if not m.alive:
                continue
            for rid, toks in m.stream_progress().items():
                if rid not in self._requests:
                    continue   # already terminal (unclaimed result)
                base = self._resumed.get(rid) or []
                total = ([int(t) for t in base] + [int(t) for t in toks])
                total = total[:self.max_journal_tokens]
                key = f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rid)}"
                cur = self._journal_docs.get(rid)
                if cur is None:
                    cur = self.store.get(key)
                    if cur is None:
                        continue   # collected/shed elsewhere: never recreate
                    if cur.get("owner") not in (None, self.router_id):
                        # a successor re-stamped this entry: it owns the
                        # stream's journal now, and an append from here —
                        # however fresh the tokens — would race its GC's
                        # compare-delete into a leak.  Deposed: stand down.
                        continue
                    # re-cache what we just read: without this, an entry
                    # whose mirror was dropped (lost CAS) pays a store read
                    # EVERY flush for the rest of its stream, and falls out
                    # of the journal_bytes gauge while still on the store
                    self._journal_docs[rid] = cur
                    self._journal_sizes[rid] = _doc_bytes(cur)
                if len(cur.get("tokens") or ()) >= len(total):
                    continue       # nothing new to make durable
                new = dict(cur)
                new["tokens"] = total
                new["resumed"] = len(base)
                # the lane counter advances with the journaled stream: the
                # position of the NEXT token a resume would decode
                new["lane_counter"] = (len(cur.get("input_ids") or ())
                                       + len(total))
                new["t"] = self.store.now()
                t0 = time.perf_counter()
                won = self.store.compare_and_swap(key, cur, new)
                # per-append CAS wall time: the number journal_flush_ms is
                # tuned against
                self._journal_cas_lat_s.append(time.perf_counter() - t0)
                if won:
                    self._journal_docs[rid] = new
                    self._journal_sizes[rid] = _doc_bytes(new)
                else:
                    # a successor (or concurrent writer) owns the entry
                    # now; stand down on this rid until we re-read it
                    self._journal_docs.pop(rid, None)
                    self._journal_sizes.pop(rid, None)

    # ------------------------------------------------------------- the loop

    def step(self) -> int:
        """One fleet round: poll the election; as coordinator, renew
        member leases + advertisements, promote due arrivals, pump every
        live engine one tick, harvest results, scan for lapsed leases /
        dead markers (failover), and write the fleet gauges.  A standby
        router does nothing but poll.  Returns the outstanding request
        count this router tracks."""
        if not self.alive:
            raise RuntimeError(f"router {self.router_id} is dead")
        try:
            lease = elect_coordinator(self.store, self.router_id,
                                      self.lease_s, key=self.election_key)
        except (StoreUnavailable, OSError) as e:
            # the store said NOTHING about our leadership this round —
            # neither renewed nor deposed.  The data plane keeps moving
            # (degraded step); the control plane waits, and once the
            # silence outlasts lease_s we must assume a successor exists
            # and self-fence (docs/FLEET.md "Store brownouts and
            # partitions").
            self.store_unavailable_total += 1
            logger.warning("fleet: election poll failed (%s: %s)",
                           type(e).__name__, e)
            return self._degraded_step()
        if lease is None:
            if self.is_coordinator or self.self_fenced:
                log_dist(
                    f"fleet: router {self.router_id} "
                    f"{'un-fenced and ' if self.self_fenced else ''}"
                    f"deposed from term {self.term} — standing down to "
                    "standby", ranks=[0])
            self.is_coordinator = False
            self.self_fenced = False
            self._renewal_ok_t = None
            if self.admission_partitions is not None:
                # follower routers stay useful: renew the router lease the
                # coordinator's partition scan keys off, and keep/claim
                # admission partitions so admit() has somewhere to land
                try:
                    self._beat_router()
                    self.claim_partitions()
                except (StoreUnavailable, OSError) as e:
                    self.store_unavailable_total += 1
                    logger.warning(
                        "fleet: follower beat/claim failed (store "
                        "unavailable: %s)", e)
            return self.outstanding()
        # a successful poll IS the leadership re-read: our lease renewed
        # under this term, so the fence (if any) lifts here and only here
        self._renewal_ok_t = self.store.now()
        if self.self_fenced:
            self.self_fenced = False
            log_dist(
                f"fleet: router {self.router_id} un-fenced — lease "
                f"renewal confirmed leadership of term {lease.term}",
                ranks=[0])
        if not self.is_coordinator or lease.term != self.term:
            try:
                self._take_over(lease)
            except (StoreUnavailable, OSError) as e:
                # takeover aborted mid-adoption: stand down and re-run the
                # WHOLE takeover next round (is_coordinator stays False so
                # the journal scan repeats; adoption is idempotent)
                self.store_unavailable_total += 1
                self.is_coordinator = False
                logger.warning(
                    "fleet: takeover for term %d aborted (store "
                    "unavailable: %s); retrying next round",
                    lease.term, e)
                return self.outstanding()
        self._tick += 1
        # ambient router tag (mirrors the member's engine tag): attributes
        # fleet.* spans to THIS router when standbys share a process ring
        with trace_tags(router=self.router_id), \
                trace_span("fleet.tick", tick=self._tick):
            for eid in sorted(self.members):
                m = self.members[eid]
                if m.alive:
                    m.generation = self.generation
                    self._guarded(f"beat({eid})", m.beat)
            if self.admission_partitions is not None:
                self._guarded("router beat", self._beat_router)
                self._guarded("admission adopt", self._adopt_new_admissions)
                self._guarded("router lease scan", self._scan_router_leases)
            if self._parked:
                # retry parked admissions FIRST: they were accepted
                # strictly before anything promoted this round, and the
                # store just proved reachable (the election poll).  A
                # re-park on a mid-round relapse is harmless — the swap
                # below makes the retry single-shot per round.
                parked, self._parked = list(self._parked), deque()
                logger.info("fleet: retrying %d parked request(s)",
                            len(parked))
                for req, requeue in parked:
                    self._route(req, requeue=requeue)
            now = time.monotonic() - self._t0
            k = bisect.bisect_right(self._later, now,
                                    key=lambda r: r.arrival_time)
            for req in self._later[:k]:
                self._route(req)
            del self._later[:k]
            for eid in sorted(self.members):
                m = self.members[eid]
                if not m.alive:
                    continue
                try:
                    m.pump()
                except EngineDead:
                    # handled below: the dead marker / lapsed lease is the
                    # router-visible form of this death
                    pass
                self._guarded(f"collect({eid})",
                              lambda m=m: self._collect(m))
            for rid in list(self._pending_gc):
                # journal GC owed from a brownout round: the terminal
                # results are long since local, only the delete is owed
                self._journal_delete(rid)
            due = (self.journal_every_k is not None
                   and self._tick % self.journal_every_k == 0)
            if not due and self.journal_flush_ms is not None:
                now_store = self.store.now()
                due = (self._last_flush_t is None
                       or (now_store - self._last_flush_t) * 1000.0
                       >= self.journal_flush_ms)
            if due:
                # flush BEFORE the lease scan: tokens decoded this round go
                # durable before any failover decision can need them.  A
                # flush the store fails stays DUE — _last_flush_t only
                # advances on success
                if self._guarded("journal flush",
                                 self._flush_token_journal):
                    self._last_flush_t = self.store.now()
                    self.journal_flushes_total += 1
            self._guarded("lease scan", self._scan_leases)
            self._guarded("epoch flip", self._advance_epoch_flip)
            self._guarded("gauges", self._write_gauges)
            if self._slo is not None:
                # router-side SLOs (docs/FLEET.md): evaluated AFTER the
                # gauge write so rules over fleet/* rollups see this
                # round's values; firing states ride the monitor as
                # alert{rule=...} -> dstpu_alert on the router's /metrics
                self._slo.evaluate(monitor=self.monitor,
                                   tracer=get_tracer())
                if self.monitor is not None:
                    self.monitor.write_events(
                        self._slo.gauge_events(self._tick))
            self._guarded("trace publish", self.publish_trace_segments)
        return self.outstanding()

    def _guarded(self, what: str, fn) -> bool:
        """Run one control-plane block, absorbing store unavailability: a
        brownout DEGRADES the round (the block is skipped — or half-done
        and naturally retried next round; every block is idempotent)
        instead of crashing the router.  Engine/data-plane exceptions
        still propagate.  Returns whether the block completed."""
        try:
            fn()
            return True
        except (StoreUnavailable, OSError) as e:
            self.store_unavailable_total += 1
            logger.warning("fleet: %s skipped — store unavailable (%s: %s)",
                           what, type(e).__name__, e)
            return False

    def _degraded_step(self) -> int:
        """A round in which the election poll could not reach the store.
        The DATA plane keeps moving — live engines are pumped, so decode
        never blocks on the control plane — but nothing store-coupled
        runs: no dispatch, no journal flush, no lease scan (a failed scan
        must never declare peers dead), no GC — and no result collection
        either.  Collecting a result whose journal entry cannot be GC'd
        leaves that entry open for a successor to adopt and re-serve
        (the compare-delete fence would then protect the SUCCESSOR's
        re-stamp from our stale delete, not us from the duplicate), so
        results stay queued on the member (or its daemon outbox) until a
        healthy round collects-then-GCs as one unit.  A standby just
        waits for the store.  Once the silence outlasts ``lease_s``
        since the last successful renewal the coordinator SELF-FENCES: a
        successor may legitimately lead by now."""
        if not self.is_coordinator:
            return self.outstanding()
        if not self.self_fenced and (
                self._renewal_ok_t is None
                or self.store.now() - self._renewal_ok_t >= self.lease_s):
            self.self_fenced = True
            self.fences_total += 1
            log_dist(
                f"fleet: router {self.router_id} SELF-FENCED — no "
                f"successful lease renewal within lease_s={self.lease_s}s "
                "(store partitioned?); dispatch, journal flush and GC "
                "stay parked until a successful election poll re-reads "
                "leadership", ranks=[0])
        self._tick += 1
        with trace_tags(router=self.router_id), \
                trace_span("fleet.tick", tick=self._tick, degraded=True):
            for eid in sorted(self.members):
                m = self.members[eid]
                if not m.alive:
                    continue
                try:
                    m.pump()
                except EngineDead:
                    pass   # declared by the lease scan on a healthy round
            self._guarded("gauges", self._write_gauges)
        return self.outstanding()

    def router_alerts(self) -> List[str]:
        """Names of router-side SLO rules currently firing (empty when no
        ``slo_rules`` are configured)."""
        return self._slo.firing() if self._slo is not None else []

    def publish_trace_segments(self, force: bool = False) -> int:
        """Publish the router half of the fleet trace — the ``fleet.*``
        spans (tick, election, failover, rolling_restart) — under
        ``fleet/trace/<router_id>``.  A no-op while tracing is off."""
        tracer = get_tracer()
        if not tracer.enabled:
            return 0
        if self._trace_pub is None:
            from ..observability.trace_assembly import TraceSegmentPublisher

            rid_ = self.router_id
            self._trace_pub = TraceSegmentPublisher(
                self.store, rid_, prefix=FLEET_TRACE_PREFIX,
                span_filter=lambda s: (s.name.startswith("fleet.")
                                       and (s.attrs or {}).get("router")
                                       == rid_),
                min_interval_s=self.trace_publish_interval_s)
        return self._trace_pub.publish(tracer, force=force,
                                       attrs={"term": int(self.term)})

    def outstanding(self) -> int:
        return len(self._requests)

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: Optional[int] = None,
            on_tick=None) -> List[RequestResult]:
        """Serve ``requests`` (plus anything already tracked) to terminal
        results.  ``on_tick(router, round)`` runs after every round — the
        chaos harness uses it to advance injected store clocks and land
        kills at exact rounds.  ``max_ticks`` bounds the LOOP (election
        polls included), raising :class:`~.serving.ServeTimeout` like the
        engine's own run()."""
        for req in requests or []:
            self.submit(req)
        rounds = 0
        while True:
            pending = self.step()
            rounds += 1
            if on_tick is not None:
                on_tick(self, rounds)
            if pending == 0:
                # a STANDBY tracks nothing until it wins the election and
                # adopts the journal — it must keep polling while journaled
                # work exists on the store (either the live coordinator
                # finishes it, emptying the journal, or its lease lapses
                # and this router takes over); exiting here would abandon
                # requests a dead coordinator dispatched.  A PARTITIONED
                # coordinator has the same obligation: a follower may have
                # journal-created an admission it has not adopted yet, so
                # "tracking nothing" only means done once the journal is
                # empty too.
                try:
                    done = ((self.is_coordinator
                             and not self.self_fenced
                             and self.admission_partitions is None)
                            or not self.store.list(FLEET_REQUESTS_PREFIX))
                except (StoreUnavailable, OSError):
                    # the journal is unknowable while the store is dark —
                    # exiting now could abandon journaled work.  Keep
                    # polling until a healthy round answers.
                    self.store_unavailable_total += 1
                    done = False
                if done:
                    return self.take_results()
                if self.is_coordinator:
                    # idle with journaled work outstanding: the adopt-scan
                    # rate limit only bounds scan COST while serving — an
                    # idle coordinator should pick follower admissions up
                    # next round, not after lease_s/3
                    self._last_adopt_scan_t = None
            if max_ticks is not None and rounds >= max_ticks:
                raise ServeTimeout(
                    f"fleet loop exceeded max_ticks={max_ticks} with "
                    f"{pending} request(s) outstanding "
                    f"(coordinator={self.is_coordinator})")

    def take_results(self) -> List[RequestResult]:
        """Claim collected results (completion order; shed results appear
        where they were decided)."""
        order, self._order = self._order, []
        return [self._results.pop(rid) for rid in order]

    def _collect(self, member: FleetMember) -> None:
        for res in member.take_results():
            rid = res.rid
            fo = self._failed_over.pop(rid, 0)
            resumed = self._resumed.get(rid) or []
            if resumed:
                # the member served prompt+resumed and its output is the
                # continuation: stitch the caller-facing result back to the
                # ORIGINAL request's frame.  Resumed tokens were journaled
                # decode output, never re-emitted — they are prepended, not
                # counted as this engine's decode ticks.
                orig = self._requests.get(rid)
                res = dataclasses.replace(
                    res,
                    input_ids=(orig.input_ids if orig is not None
                               else res.input_ids[:len(res.input_ids)
                                                  - len(resumed)]),
                    output_ids=np.concatenate(
                        [np.asarray(resumed, np.int32), res.output_ids]),
                    resumed_tokens=len(resumed))
            if fo:
                res = dataclasses.replace(res, failovers=fo)
            lc = self._lifecycle.pop(rid, None)
            if lc:
                # router-recorded failover/resume markers lead into the
                # finishing engine's own record: t is monotonic per
                # process, so within one process the merged record reads
                # in order; cross-process ordering is the trace assembly's
                # job (clock anchors), not the lifecycle's
                res = dataclasses.replace(res,
                                          lifecycle=lc + res.lifecycle)
            self._results[rid] = res
            self._order.append(rid)
            self._owner.pop(rid, None)
            self._requests.pop(rid, None)
            # per-engine credit counts tokens THIS engine decoded: resumed
            # tokens were decoded by the dead engine and merely re-prefilled
            # here (resumed_tokens_total tracks them fleet-wide)
            self.tokens_by_engine[member.engine_id] = (
                self.tokens_by_engine.get(member.engine_id, 0)
                + len(res.output_ids) - res.resumed_tokens)
            self._journal_delete(rid)

    # ------------------------------------------------------------- failover

    def _scan_leases(self) -> None:
        """Detect dead engines: a durable ``fleet/dead`` marker (dying
        breath of a budget-exhausted member) fails over immediately; a
        silently-killed member is declared once its lease has lapsed
        ``miss_limit`` periods on the store clock; a member that died
        BEFORE its first beat (no lease at all) is caught via the local
        ``alive`` flag or, cross-process, after the same grace a lease
        expiry would get.  Store reads are rate-limited to a third of the
        shortest member lease — scanning every scheduler tick buys no
        detection latency (the threshold is ``miss_limit * lease_s``) —
        EXCEPT when this process already knows a member died and owes it a
        failover."""
        now = self.store.now()
        urgent = any(not m.alive and eid not in self._failed_engines
                     for eid, m in self.members.items())
        min_lease = min((m.lease_s for m in self.members.values()),
                        default=self.lease_s)
        if not urgent and self._last_scan_t is not None \
                and now - self._last_scan_t < min_lease / 3.0:
            return
        self._last_scan_t = now
        table = lease_table(self.store, prefix=FLEET_HEARTBEAT_PREFIX)
        marked = set(dead_set(self.store, prefix=FLEET_DEAD_PREFIX))
        for eid in sorted(self.members):
            if eid in self._failed_engines:
                continue
            m = self.members[eid]
            lease = table.get(eid)
            if lease is None:
                lapsed = (not m.alive
                          or (self._lead_since is not None
                              and now - self._lead_since
                              >= self.miss_limit * m.lease_s))
                desc = "never leased"
            else:
                lapsed = lease.missed(now) >= self.miss_limit
                desc = f"lease lapsed {lease.missed(now):.1f}x"
            if eid in marked or lapsed:
                self._failover(eid, "dead marker" if eid in marked else desc)

    def _failover(self, engine_id: str, why: str) -> None:
        # tagged here, not only in step(): benches/tests trigger failover
        # from on_tick hooks outside the step tag, and the failover spans
        # must still attribute to THIS router's trace segment
        with trace_tags(router=self.router_id):
            self._failover_tagged(engine_id, why)

    def _failover_tagged(self, engine_id: str, why: str) -> None:
        m = self.members.get(engine_id)
        if m is not None:
            m.alive = False
            # harvest DURABLE results first: a store-proxied member's
            # published results outlive its process (the results channel
            # is on the store), and re-routing a request whose terminal
            # result already landed would serve it twice.  An in-process
            # dead member reports nothing here — its results died with it.
            self._collect(m)
        self._failed_engines.add(engine_id)
        record_dead(self.store, engine_id, self.generation, self.router_id,
                    prefix=FLEET_DEAD_PREFIX)
        victims = [rid for rid, owner in self._owner.items()
                   if owner == engine_id]
        log_dist(
            f"fleet: engine {engine_id} declared dead ({why}); failing "
            f"{len(victims)} request(s) over to "
            f"{sum(mm.alive for mm in self.members.values())} survivor(s)",
            ranks=[0])
        for rid in victims:
            req = self._requests[rid]
            self._owner.pop(rid)
            self.failovers_total += 1
            self._failed_over[rid] = self._failed_over.get(rid, 0) + 1
            self._lifecycle.setdefault(rid, []).append(
                ("failover", time.monotonic(), engine_id))
            journaled = self._journaled_tokens(rid)
            with trace_span("fleet.failover", rid=rid,
                            from_engine=engine_id,
                            journaled=len(journaled)):
                # the dead engine's KV pages are gone with its process, but
                # journaled tokens are DURABLE decode output: resume the
                # stream after the last journaled token (prompt+journaled
                # re-prefilled as pure KV reconstruction) instead of
                # re-decoding it.  Only the un-flushed tail (< K ticks) is
                # re-decoded; with nothing journaled this is the
                # re-prefill-from-original-prompt path.  Greedy decode
                # keeps either path token-exact, and the preserved epoch
                # keeps deadline/TTFT accounting honest.
                if journaled:
                    self._seed_resumed(rid, journaled)
                    if self._maybe_finish_from_journal(rid, req, journaled):
                        continue
                self._route(req, requeue=True)

    def _seed_resumed(self, rid: Any, journaled: List[int]) -> None:
        """Adopt ``journaled`` as the rid's resume state.  The counter
        advances by the NEWLY-durable tokens only — a request failing over
        twice resumes the same prefix twice but those tokens were saved
        from re-decode once, and the gauge exists to measure exactly that
        saving."""
        have = len(self._resumed.get(rid) or [])
        if len(journaled) > have:
            self.resumed_tokens_total += len(journaled) - have
            self._resumed[rid] = journaled

    def _maybe_finish_from_journal(self, rid: Any, req: Request,
                                   journaled: List[int]) -> bool:
        """When the journal already holds the WHOLE stream (the engine
        finished between its last flush and its death, the result
        unclaimed), short-circuit to a terminal result — zero decode
        work.  Returns whether the request was finished."""
        done_eos = (req.eos_token_id is not None and journaled
                    and journaled[-1] == req.eos_token_id)
        if not journaled or not (done_eos
                                 or len(journaled) >= req.max_new_tokens):
            return False
        self._finish_from_journal(rid, req, journaled,
                                  "eos" if done_eos else "length")
        return True

    def _finish_from_journal(self, rid: Any, req: Request,
                             journaled: List[int], reason: str) -> None:
        t = time.monotonic()
        lc = self._lifecycle.pop(rid, [])
        lc.append(("finish", t, "journal"))
        self._results[rid] = RequestResult(
            rid=rid, input_ids=req.input_ids,
            output_ids=np.asarray(journaled, np.int32),
            finish_reason=reason, prefill_bucket=0,
            arrival_s=req.arrival_epoch_s or t, admit_s=t,
            first_token_s=t, finish_s=t,
            resumed_tokens=len(journaled),
            failovers=self._failed_over.pop(rid, 0),
            trace_id=req.trace_id, lifecycle=lc)
        self._order.append(rid)
        self._requests.pop(rid, None)
        self._journal_delete(rid)
        logger.info("fleet: request %r finished straight from the journal "
                    "(%d token(s), %s) — its engine died with the stream "
                    "already complete", rid, len(journaled), reason)

    # ----------------------------------------------------- coordinator side

    def _restamp(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """CAS-rewrite an adopted journal document with THIS router's
        ownership stamp.  This is the fencing half of the compare-delete
        story: the moment the stamp lands, a deposed leader's mirror (and
        therefore its compare-delete and CAS appends) is stale and loses
        by construction.  On CAS loss — a concurrent writer got there
        first — re-read and use the store's truth; the next write from
        this router re-syncs or stands down normally."""
        key = f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rec['rid'])}"
        stamped = dict(rec, owner=self.router_id, term=int(self.term),
                       t=self.store.now())
        if self.store.compare_and_swap(key, rec, stamped):
            return stamped
        cur = self.store.get(key)
        return cur if cur is not None else rec

    def _adopt_entry(self, rec: Dict[str, Any]) -> None:
        """Adopt one journal document this router has never tracked:
        re-stamp ownership, rebuild the Request (RNG lane, trace id,
        failover/lifecycle history), mirror the token-journal state, and
        either park/route it (undispatched) or record its owner engine.
        Shared by coordinator takeover and by the admission-adoption scan
        that picks up entries journaled by follower routers."""
        rec = self._restamp(rec)
        rid = rec["rid"]
        req = Request(
            rid=rid,
            input_ids=np.asarray(rec["input_ids"], np.int32),
            max_new_tokens=int(rec["max_new_tokens"]),
            eos_token_id=rec["eos_token_id"],
            deadline_s=rec["deadline_s"],
            arrival_epoch_s=rec["arrival_epoch_s"],
            # re-derive the RNG lane from the journaled seed/params
            # — counter-based keys make the adopted stream's
            # continuation token-exact (the counter is implicit in
            # prompt + journaled length; `lane_counter` documents
            # it for operators and cross-implementations)
            sampling=(SamplingParams(**rec["sampling"])
                      if rec.get("sampling") else None),
            # the journaled trace id: the adopted request stays
            # ONE trace across coordinator takeovers too
            trace_id=rec.get("trace_id"),
            # the journaled tenant: adoption re-routes by adapter
            # residency and any later resume re-prefills under it
            adapter_id=rec.get("adapter_id"))
        self._requests[rid] = req
        if rec.get("failovers"):
            self._failed_over[rid] = int(rec["failovers"])
        if rec.get("lifecycle"):
            self._lifecycle[rid] = [tuple(e)
                                    for e in rec["lifecycle"]]
        # adopt the token-journal state: the document is the CAS
        # base for this router's future appends, and `resumed`
        # tokens are baked into the LIVE assignment's prompt — the
        # successor must stitch collected outputs exactly as the
        # dispatching router would have
        self._journal_docs[rid] = rec
        self._journal_sizes[rid] = _doc_bytes(rec)
        if rec.get("resumed"):
            self._resumed[rid] = [
                int(t) for t in
                (rec.get("tokens") or [])[:int(rec["resumed"])]]
        if rec["engine"] is None:
            # accepted but never dispatched (a future arrival
            # parked at the dead coordinator): keep the remaining
            # delay on OUR clock, or route now when already due
            remaining = max(0.0, (req.arrival_epoch_s or 0.0)
                            - time.monotonic())
            if remaining > 0:
                req = dataclasses.replace(
                    req, arrival_time=(time.monotonic() - self._t0
                                       + remaining))
                self._requests[rid] = req
                bisect.insort(self._later, req,
                              key=lambda r: r.arrival_time)
            else:
                self._route(req)
        else:
            self._owner[rid] = rec["engine"]

    def _take_over(self, lease) -> None:
        """This router just became (or re-confirmed as) the leader: bump
        the fleet generation (CAS — a deposed leader racing its successor
        cannot tear or double-apply it) and adopt the request journal, so
        work dispatched by the previous coordinator is tracked, failed
        over and completed by this one."""
        with trace_tags(router=self.router_id), \
                trace_span("fleet.election", router=self.router_id,
                           term=lease.term):
            self.is_coordinator = True
            self.term = lease.term
            self.elections_total += 1
            self._lead_since = self.store.now()
            self.generation = bump_generation(self.store,
                                              key=self.generation_key)
            # adopt the fleet weight epoch — and any IN-PROGRESS flip the
            # dead coordinator left behind.  The successor has no access
            # to the dead process's param tree, so the adopted flip runs
            # with params=None: each member re-stamps its own weights at
            # the target epoch (a daemon pulls from its params_provider).
            # Completing the flip (rather than abandoning it) is what
            # keeps members that already prepared from diverging from the
            # committed epoch forever.
            committed = self.store.get(FLEET_EPOCH_KEY)
            if committed is not None:
                self.fleet_epoch = max(self.fleet_epoch,
                                       int(committed.get("epoch") or 0))
            flip = self.store.get(FLEET_EPOCH_FLIP_KEY)
            if flip is not None and self._flip is None:
                if int(flip.get("epoch") or 0) > self.fleet_epoch:
                    self._flip = flip
                    self._flip_params = None
                    log_dist(
                        f"fleet: adopted in-progress weight-epoch flip to "
                        f"{flip.get('epoch')} from deposed coordinator "
                        f"{flip.get('coordinator')}", ranks=[0])
                elif self.store.compare_and_delete(FLEET_EPOCH_FLIP_KEY,
                                                   flip):
                    # stale flip doc at or below the committed epoch
                    self.store.clear_tombstone(FLEET_EPOCH_FLIP_KEY)
            adopted = 0
            for name in self.store.list(FLEET_REQUESTS_PREFIX):
                rec = self.store.get(f"{FLEET_REQUESTS_PREFIX}/{name}")
                if rec is None:
                    continue
                rid = rec["rid"]
                if rid in self._results:
                    continue   # terminal here; the caller will claim it
                if rid in self._requests:
                    # deposed-and-RE-elected: a successor may have failed
                    # this rid over while we were stalled — rewriting its
                    # tokens/resumed/engine.  Re-sync every mirror to the
                    # store's truth, or collect-time stitching would use
                    # our stale pre-deposition state (e.g. dropping the
                    # successor's resumed prefix from the output).  The
                    # re-stamp re-fences the entry under OUR new term.
                    rec = self._restamp(rec)
                    self._journal_docs[rid] = rec
                    self._journal_sizes[rid] = _doc_bytes(rec)
                    if rec.get("resumed"):
                        self._resumed[rid] = [
                            int(t) for t in
                            (rec.get("tokens") or [])[:int(rec["resumed"])]]
                    else:
                        self._resumed.pop(rid, None)
                    if rec.get("lifecycle"):
                        self._lifecycle[rid] = [
                            tuple(e) for e in rec["lifecycle"]]
                    if rec.get("failovers"):
                        self._failed_over[rid] = int(rec["failovers"])
                    if rec["engine"] is not None:
                        self._owner[rid] = rec["engine"]
                    continue
                self._adopt_entry(rec)
                adopted += 1
            log_dist(
                f"fleet: router {self.router_id} leads term {self.term} "
                f"(generation {self.generation}, adopted {adopted} "
                f"journaled request(s))", ranks=[0])

    def kill(self) -> None:
        """Test/chaos hook simulating coordinator process death: the
        election lease stops renewing and this router never steps again —
        a standby takes the next term once the lease lapses."""
        self.alive = False

    # ------------------------------------------------------ rolling restart

    def rolling_restart(self, max_ticks: Optional[int] = None) -> List[str]:
        """Restart the fleet one engine at a time, never dropping a
        request: stop routing to the engine, ``drain()`` it (in-flight
        work finishes, token-exact even across a mid-drain fault),
        redistribute the unserved hand-back across the rest of the fleet,
        and :meth:`~FleetMember.recycle` a fresh engine.  The fleet keeps
        serving on the other engines throughout.  Returns the engine ids
        restarted."""
        if not self.is_coordinator:
            raise RuntimeError(
                "rolling_restart is a coordinator action — step() until "
                "this router holds the lease")
        restarted = []
        for eid in sorted(self.members):
            m = self.members[eid]
            if not m.alive:
                continue
            m.routable = False
            unserved: List[Request] = []
            try:
                with trace_tags(router=self.router_id), \
                        trace_span("fleet.rolling_restart", engine=eid), \
                        trace_tags(engine=eid):
                    # ambient tag: the drain/recycle serve.* spans belong
                    # to the member being restarted, not the router
                    unserved = m.sup.drain(max_ticks=max_ticks)
                    self._collect(m)
                    m.recycle()
            finally:
                m.routable = True
                # redistribute AFTER the member is routable again: on a
                # single-engine fleet the recycled member itself is the
                # only legal target — draining it must never read as
                # "whole fleet dead" (and the hand-back must re-enter an
                # engine even when recycle() raised)
                for req in unserved:
                    orig = self._requests.get(req.rid, req)
                    self._owner.pop(req.rid, None)
                    # a handed-back request can carry journaled progress
                    # its drained engine never re-admitted (a warm-restart
                    # replay still queued when admission closed): seed the
                    # resume state from the journal, exactly as failover
                    # does, so the target continues after the last
                    # journaled token instead of re-decoding it
                    self._seed_resumed(req.rid,
                                       self._journaled_tokens(req.rid))
                    res_toks = self._resumed.get(req.rid) or []
                    if self._maybe_finish_from_journal(req.rid, orig,
                                                       res_toks):
                        continue   # defensive: should have been collected
                    self._route(orig, requeue=True)
            m.beat(force=True)   # advertise the FRESH engine immediately
            self.rolling_restarts_total += 1
            restarted.append(eid)
            log_dist(f"fleet: rolling restart of {eid} complete "
                     f"({len(restarted)}/{sum(mm.alive for mm in self.members.values())})",
                     ranks=[0])
        return restarted

    # -------------------------------------------------------- health/gauges

    def health(self) -> Dict[str, Any]:
        """Fleet rollup + per-engine advertisements (as last written to
        the store) — what an external balancer or dashboard polls."""
        # a health probe must answer even through a store brownout: the
        # advertisement mirror degrades to empty, the router-local state
        # (fencing, parked admissions, counters) is always reportable
        try:
            ads = {eid: self.store.get(f"{FLEET_ENGINES_PREFIX}/{eid}")
                   for eid in sorted(self.members)}
        except (StoreUnavailable, OSError):
            ads = {eid: None for eid in sorted(self.members)}
        live = [eid for eid, m in self.members.items() if m.alive]
        return {
            "router_id": self.router_id,
            "is_coordinator": self.is_coordinator,
            "term": self.term,
            "generation": self.generation,
            "tick": self._tick,
            "engines_total": len(self.members),
            "engines_live": len(live),
            "queue_depth": self.fleet_queue_depth(),
            "outstanding": self.outstanding(),
            "failovers_total": self.failovers_total,
            "shed_total": self.shed_total,
            "elections_total": self.elections_total,
            "rolling_restarts_total": self.rolling_restarts_total,
            "resumed_tokens_total": self.resumed_tokens_total,
            "journal_entries": len(self._journal_sizes),
            "journal_bytes": self.journal_bytes(),
            "journal_flushes_total": self.journal_flushes_total,
            "affinity_routes_total": self.affinity_routes_total,
            "adapter_routes_total": self.adapter_routes_total,
            "adapter_unknown_total": self.adapter_unknown_total,
            "residency": self._residency_rollup(ads),
            # fleet-wide SLO rollup: every (engine, rule) currently firing
            # anywhere on the fleet, from the member advertisements
            "alerts_firing": self._alerts_rollup(ads),
            # router-side SLO rules currently firing (docs/FLEET.md
            # "Router-side SLOs") + their full per-rule states
            "router_alerts": self.router_alerts(),
            "router_slo_states": (self._slo.states()
                                  if self._slo is not None else {}),
            "tokens_by_engine": dict(self.tokens_by_engine),
            # host-scale fleet (docs/FLEET.md): sharded-admission and
            # weight-epoch-barrier state
            "fleet_epoch": self.fleet_epoch,
            "epoch_flip_in_progress": (int(self._flip["epoch"])
                                       if self._flip is not None else None),
            "epoch_flips_total": self.epoch_flips_total,
            "admission_partitions": self.admission_partitions,
            "my_partitions": sorted(self._my_partitions),
            "partition_admissions_total": self.partition_admissions_total,
            "adopted_admissions_total": self.adopted_admissions_total,
            # store-partition tolerance (docs/FLEET.md "Store brownouts
            # and partitions"): fencing + degradation state
            "self_fenced": self.self_fenced,
            "fences_total": self.fences_total,
            "parked_admissions": len(self._parked),
            "parked_total": self.parked_total,
            "pending_gc": len(self._pending_gc),
            "dispatches_total": self.dispatches_total,
            "store_unavailable_total": self.store_unavailable_total,
            "store_retries_total": store_retries_total(),
            "engines": ads,
        }

    @staticmethod
    def _alerts_rollup(ads: Dict[str, Optional[Dict[str, Any]]]
                       ) -> List[Tuple[str, str]]:
        """Every firing (engine_id, rule) pair across the advertised
        fleet — the fleet/alerts_firing gauge counts these."""
        out: List[Tuple[str, str]] = []
        for eid in sorted(ads):
            ad = ads[eid]
            if not ad:
                continue
            for rule in ad.get("alerts_firing", []) or []:
                out.append((eid, str(rule)))
        return out

    @staticmethod
    def _residency_rollup(ads: Dict[str, Optional[Dict[str, Any]]]
                          ) -> Dict[str, int]:
        """Fleet-wide KV-tiering totals folded from the member
        advertisements (the fleet/residency_* gauges)."""
        out = {"entries": 0, "demoted_pages": 0, "host_tier_bytes": 0,
               "promotions_total": 0, "demotions_total": 0}
        for ad in ads.values():
            if not ad:
                continue
            out["entries"] += int(ad.get("residency_entries", 0) or 0)
            out["demoted_pages"] += int(ad.get("demoted_pages", 0) or 0)
            out["host_tier_bytes"] += int(ad.get("host_tier_bytes", 0) or 0)
            out["promotions_total"] += int(ad.get("promotions_total", 0)
                                           or 0)
            out["demotions_total"] += int(ad.get("demotions_total", 0) or 0)
        return out

    def _write_gauges(self) -> None:
        if self.monitor is None:
            return
        live = sum(m.alive for m in self.members.values())
        # drop counters are per SOURCE (process ring / monitor object), not
        # per member: members sharing a source advertise the same value and
        # must be counted once, or an in-process fleet overcounts N-fold
        # (dedup_drop_totals is the one shared fold — the pod watchdog
        # rollup uses the same implementation)
        ads: Dict[str, Dict[str, Any]] = {}
        for eid, m in self.members.items():
            # the beat this same round stashed what it wrote; fall back to
            # the store only for a member this router never beat (e.g.
            # adopted after a takeover, before its first beat here)
            ad = (m.last_advert if m.last_advert is not None
                  else self.store.get(f"{FLEET_ENGINES_PREFIX}/{eid}"))
            if ad is not None:
                ads[eid] = ad
        flight, monitor_drops = dedup_drop_totals(ads)
        res = self._residency_rollup(ads)
        self.monitor.write_events([
            ("fleet/engines_live", float(live), self._tick),
            ("fleet/queue_depth", float(self.fleet_queue_depth()),
             self._tick),
            ("fleet/outstanding", float(self.outstanding()), self._tick),
            ("fleet/failovers_total", float(self.failovers_total),
             self._tick),
            ("fleet/shed_total", float(self.shed_total), self._tick),
            ("fleet/elections_total", float(self.elections_total),
             self._tick),
            ("fleet/rolling_restarts_total",
             float(self.rolling_restarts_total), self._tick),
            ("fleet/generation", float(self.generation), self._tick),
            ("fleet/flight_dropped_total", float(flight), self._tick),
            ("fleet/monitor_dropped_total", float(monitor_drops),
             self._tick),
            ("fleet/journal_bytes", float(self.journal_bytes()),
             self._tick),
            ("fleet/resumed_tokens_total", float(self.resumed_tokens_total),
             self._tick),
            # KV-page tiering + residency routing (docs/FLEET.md,
            # docs/OBSERVABILITY.md): fleet-wide tier footprint and how
            # often affinity picked the admission target
            ("fleet/residency_entries", float(res["entries"]), self._tick),
            ("fleet/residency_demoted_pages", float(res["demoted_pages"]),
             self._tick),
            ("fleet/residency_host_bytes", float(res["host_tier_bytes"]),
             self._tick),
            ("fleet/residency_promotions_total",
             float(res["promotions_total"]), self._tick),
            ("fleet/residency_demotions_total",
             float(res["demotions_total"]), self._tick),
            ("fleet/affinity_routes_total",
             float(self.affinity_routes_total), self._tick),
            # multi-tenant adapter serving (docs/SERVING.md): dispatches
            # that landed by adapter residency
            ("fleet/adapter_routes_total",
             float(self.adapter_routes_total), self._tick),
            # requests shed typed because no member anywhere serves their
            # adapter_id (store-backed digest under fleet/adapters/)
            ("fleet/adapter_unknown_total",
             float(self.adapter_unknown_total), self._tick),
            # SLO rollup (docs/OBSERVABILITY.md "SLOs and alerts"): count
            # of (engine, rule) pairs firing anywhere on the fleet — one
            # scrape of the router's endpoint answers "is any member
            # breaching its objectives"
            ("fleet/alerts_firing", float(len(self._alerts_rollup(ads))),
             self._tick),
            # distributed-tracing segment accounting (docs/OBSERVABILITY
            # "Distributed tracing"): spans published to fleet/trace/* by
            # the members (advertised) plus this router's own publisher,
            # and segment-cap drops — a nonzero drop count means the
            # fleet trace is windowed, not complete
            ("fleet/trace_spans_published_total",
             float(sum(int(ad.get("trace_spans_published", 0) or 0)
                       for ad in ads.values())
                   + (self._trace_pub.published_total
                      if self._trace_pub is not None else 0)), self._tick),
            ("fleet/trace_dropped_total",
             float(sum(int(ad.get("trace_dropped", 0) or 0)
                       for ad in ads.values())
                   + (self._trace_pub.dropped_total
                      if self._trace_pub is not None else 0)), self._tick),
            # host-scale fleet (docs/FLEET.md "Host-scale deployment"):
            # store CAS contention, the committed weight epoch + flips,
            # sharded-admission volume, and store-channel drop accounting
            # summed across store-proxied members
            ("fleet/store_cas_contended_total",
             float(getattr(self.store, "cas_contended_total", 0) or 0),
             self._tick),
            ("fleet/weight_epoch", float(self.fleet_epoch), self._tick),
            ("fleet/epoch_flips_total", float(self.epoch_flips_total),
             self._tick),
            ("fleet/partition_admissions_total",
             float(self.partition_admissions_total), self._tick),
            ("fleet/adopted_admissions_total",
             float(self.adopted_admissions_total), self._tick),
            ("fleet/channel_dropped_total",
             float(sum(int(getattr(m, "channel_dropped_total", 0) or 0)
                       for m in self.members.values())), self._tick),
            # store-partition tolerance (docs/FLEET.md "Store brownouts
            # and partitions"): the fence state, parked admissions owed a
            # healthy round, unified CAS-retry volume across every store
            # protocol, and documents the backend quarantined as corrupt
            ("fleet/self_fenced", 1.0 if self.self_fenced else 0.0,
             self._tick),
            ("fleet/parked_admissions", float(len(self._parked)),
             self._tick),
            ("fleet/store_retries_total", float(store_retries_total()),
             self._tick),
            ("fleet/store_unavailable_total",
             float(self.store_unavailable_total), self._tick),
            ("store/corrupt_docs_total",
             float(getattr(self.store, "corrupt_docs_total", 0) or 0),
             self._tick),
        ])
