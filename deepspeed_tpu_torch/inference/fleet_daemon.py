"""Per-process fleet member daemon + the router-side store proxy
(counterpart of ``deepspeed_tpu/inference/fleet_daemon.py``, copied: it
imports no framework).

This is the host-scale half of the fleet tier (docs/FLEET.md "Member
daemons"): a :class:`~.fleet.FleetMember` running in its OWN OS process
(:class:`FleetMemberDaemon`, started by ``python -m
deepspeed_tpu_torch.inference.fleet_member`` or the launcher's
``--fleet_daemon`` flag), coupled to the router by NOTHING but
the coordination store.  Assignments, results and control verbs travel as
size-capped serialized documents over the store channels
(:func:`~..elasticity.coordination.channel_append` /
``channel_consume`` — CAS-appended sequence numbers, drop accounting), so
a SIGKILLed member is indistinguishable from a lease-lapsed one: the
router sees a silent lease either way, fails the member's work over from
the journal, and already-published results stay durably claimable on the
results channel (no duplicate serve).

Router side, :class:`StoreMemberProxy` is duck-typed to the
``FleetMember`` surface the :class:`~.fleet.FleetRouter` drives — the
router code does not know (or care) whether a member is a live in-process
object or a store handle to a daemon three processes away.  The proxy's
failure semantics are the member contract verbatim: ``take_results`` works
even on a dead proxy (the channel outlives the process), while
``stream_progress``/``residency_digest`` go silent (host state died with
the process — exactly why the journal exists).

Keyspace (all under the fleet prefix, docs/FLEET.md "Store keyspace"):

=============================  =========================================
``fleet/assign/<engine>``      router -> daemon request channel
``fleet/results/<engine>``     daemon -> router terminal-result channel
``fleet/control/<engine>``     router -> daemon verb channel (``drain``,
                               ``recycle``, ``shutdown``,
                               ``update_params``)
``fleet/progress/<engine>``    daemon-published mid-stream token progress
                               (what the coordinator's token journal
                               flushes for store-proxied members)
=============================  =========================================
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..elasticity.coordination import (CoordinationStore, StoreUnavailable,
                                       channel_append, channel_consume,
                                       channel_stats, read_generation)
from ..utils.logging import logger
from .fleet import (FLEET_ASSIGN_PREFIX, FLEET_CONTROL_PREFIX,
                    FLEET_ENGINES_PREFIX, FLEET_GENERATION_KEY,
                    FLEET_PROGRESS_PREFIX, FLEET_REQUESTS_PREFIX,
                    FLEET_RESIDENCY_PREFIX,
                    FLEET_RESULTS_PREFIX, EngineDead, FleetMember,
                    _rid_key, request_from_doc, request_to_doc,
                    result_from_doc, result_to_doc)
from .serving import Request, RequestResult

__all__ = ["FleetMemberDaemon", "StoreMemberProxy"]


# ---------------------------------------------------------------- router side

class _ProxyEngine:
    """The few engine attributes the router's routing/shed math touches,
    served from the daemon's advertisement instead of a live object."""

    def __init__(self, proxy: "StoreMemberProxy"):
        self._proxy = proxy
        self._t0 = time.monotonic()

    @property
    def page_size(self) -> int:
        return int((self._proxy.last_advert or {}).get("page_size") or 0)

    @property
    def weight_epoch(self) -> int:
        return int((self._proxy.last_advert or {}).get("weight_epoch") or 0)

    def _retry_after_hint(self) -> float:
        ad = self._proxy.last_advert or {}
        # the same shape the engine derives live: roughly one queue-drain
        # interval; without an advertisement, a second is an honest guess
        depth = int(ad.get("queue_depth") or 0)
        return max(0.25, 0.25 * depth) if ad else 1.0


class _ProxySupervisor:
    """``member.sup`` shim: the router only touches ``.engine`` and
    (rolling restarts) ``.drain``."""

    def __init__(self, proxy: "StoreMemberProxy"):
        self._proxy = proxy
        self.engine = _ProxyEngine(proxy)

    def drain(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Cross-process drain: send the verb; the daemon finishes its
        in-flight work and publishes every result to the channel.  There
        is no synchronous hand-back — the unserved list is always empty
        and the router collects results on later ticks."""
        self._proxy.send_control("drain", max_ticks=max_ticks)
        return []


class StoreMemberProxy:
    """Router-side handle to a member daemon: the ``FleetMember`` surface,
    store-only.  One proxy tracks its own dispatches (``_inflight``) so
    routing load reflects every submit the router just made — the
    advertisement alone is a round stale."""

    def __init__(self, engine_id: str, store: CoordinationStore,
                 router_id: str = "router0", lease_s: float = 5.0):
        self.engine_id = str(engine_id)
        self.store = store
        self.router_id = str(router_id)
        self.lease_s = float(lease_s)
        self.generation = 0
        self.alive = True
        self.routable = True
        self.death_cause = None
        self.last_advert: Optional[Dict[str, Any]] = None
        self.last_residency: Optional[Dict[str, Any]] = None
        self.sup = _ProxySupervisor(self)
        self._inflight: set = set()
        self._prepared_epoch: Optional[int] = None

    # ------------------------------------------------------------- channels

    def _key(self, prefix: str) -> str:
        return f"{prefix}/{self.engine_id}"

    def send_control(self, op: str, **kw) -> int:
        return channel_append(self.store, self._key(FLEET_CONTROL_PREFIX),
                              {"op": str(op), **kw}, self.router_id)

    @property
    def channel_dropped_total(self) -> int:
        """Capped-out drops across this member's channels (the
        fleet/channel_dropped_total gauge rollup)."""
        return sum(channel_stats(self.store, self._key(p))["dropped"]
                   for p in (FLEET_ASSIGN_PREFIX, FLEET_RESULTS_PREFIX,
                             FLEET_CONTROL_PREFIX))

    # ------------------------------------------------------- member surface

    def outstanding(self) -> int:
        return len(self._inflight)

    def backlog(self) -> int:
        return len(self._inflight)

    def submit(self, request: Request) -> Any:
        channel_append(self.store, self._key(FLEET_ASSIGN_PREFIX),
                       request_to_doc(request), self.router_id)
        self._inflight.add(request.rid)
        return request.rid

    def take_results(self) -> List[RequestResult]:
        """Durable even when the daemon is dead: results it published
        before dying stay claimable — collecting them FIRST is what keeps
        failover from re-serving a finished stream."""
        out = []
        for _seq, doc in channel_consume(
                self.store, self._key(FLEET_RESULTS_PREFIX),
                self.router_id):
            res = result_from_doc(doc)
            self._inflight.discard(res.rid)
            out.append(res)
        return out

    def stream_progress(self) -> Dict[Any, List[int]]:
        if not self.alive:
            return {}
        doc = self.store.get(self._key(FLEET_PROGRESS_PREFIX)) or {}
        return {rid: [int(t) for t in toks]
                for rid, toks in (doc.get("streams") or [])}

    def residency_digest(self, cap: int = 1024) -> List:
        if not self.alive:
            return []
        doc = self.store.get(self._key(FLEET_RESIDENCY_PREFIX)) or {}
        return [tuple(e) for e in (doc.get("digest") or [])][:cap]

    def beat(self, force: bool = False) -> None:
        """The DAEMON renews its own lease; the router-side beat just
        refreshes the advertisement/residency mirrors the gauge rollup
        and affinity scoring read."""
        if not self.alive:
            return
        ad = self.store.get(self._key(FLEET_ENGINES_PREFIX))
        if ad is not None:
            self.last_advert = ad
        self.last_residency = self.store.get(
            self._key(FLEET_RESIDENCY_PREFIX))

    def publish_trace_segments(self, force: bool = False) -> int:
        return 0   # the daemon publishes its own segments

    def pump(self) -> int:
        """The daemon pumps its own engine; the router-side pump is just
        the liveness check the in-process member makes on entry."""
        if not self.alive:
            raise EngineDead(f"engine {self.engine_id} is dead")
        return self.outstanding()

    def weight_epoch(self) -> int:
        return self.sup.engine.weight_epoch

    def prepare_epoch(self, params, epoch: int) -> bool:
        """Epoch-barrier prepare, store-proxied: send ``update_params``
        once per target epoch and report not-landed — the coordinator's
        flip round trusts only the daemon's durable prepare mark
        (``fleet/epoch/prepare/<engine>``), written after the daemon
        actually drained and flipped.  ``params`` does not cross the
        process boundary: the daemon's own ``params_provider`` is the
        weight source (docs/FLEET.md "Weight-epoch barrier")."""
        if not self.alive:
            return False
        if self._prepared_epoch != int(epoch):
            self.send_control("update_params", epoch=int(epoch))
            self._prepared_epoch = int(epoch)
        return False

    def recycle(self) -> bool:
        self.send_control("recycle")
        return True

    def kill(self) -> None:
        self.alive = False


# ---------------------------------------------------------------- daemon side

class FleetMemberDaemon:
    """The member-process main loop: drain control verbs, accept
    assignments, pump the engine, publish results/progress, beat the
    lease.  Everything the router needs crosses the store; nothing else
    does.

    ``params_provider(epoch) -> params`` is the member's own weight source
    for epoch flips (a checkpoint read in production, the live tree in
    tests); ``None`` re-stamps the current weights at the new epoch —
    the barrier's ordering contract is the daemon's to keep either way.
    """

    def __init__(self, member: FleetMember, store: CoordinationStore,
                 params_provider=None, idle_sleep_s: float = 0.0,
                 outbox_cap: int = 256, min_store_poll_s: float = 0.0):
        self.member = member
        self.store = store
        self.params_provider = params_provider
        self.idle_sleep_s = float(idle_sleep_s)
        self.shutdown = False
        self._pending_epoch: Optional[int] = None
        self._draining = False
        # ---- store-brownout tolerance (docs/FLEET.md "Store brownouts
        # and partitions").  The DATA plane (pump/decode) never blocks on
        # the control plane: when the store is dark, results buffer in a
        # bounded outbox (oldest dropped at the cap, with accounting) and
        # republish on heal — after a staleness check against the journal,
        # because a stream that failed over while this member was
        # partitioned is being re-served elsewhere and publishing our copy
        # would serve it twice.  ``min_store_poll_s`` bounds store-op
        # volume per wall second on the HOST clock (0 = poll every round,
        # the deterministic-test default).
        self.outbox_cap = int(outbox_cap)
        if self.outbox_cap < 1:
            raise ValueError(f"outbox_cap={outbox_cap} must be >= 1")
        self.min_store_poll_s = float(min_store_poll_s)
        self._last_store_poll_t: Optional[float] = None   # host monotonic
        self._outbox: deque = deque()
        self._store_dark = False
        self.outbox_dropped_total = 0
        self.outbox_stale_dropped_total = 0
        self.outbox_republished_total = 0
        self.store_unavailable_total = 0

    def _key(self, prefix: str) -> str:
        return f"{prefix}/{self.member.engine_id}"

    def _apply_control(self, op: Dict[str, Any]) -> None:
        verb = op.get("op")
        if verb == "shutdown":
            self.shutdown = True
        elif verb == "drain":
            self._draining = True
        elif verb == "recycle":
            self._draining = True
            self._pending_recycle = True
        elif verb == "update_params":
            self._pending_epoch = int(op.get("epoch") or 0)
        else:
            logger.warning("fleet daemon[%s]: unknown control verb %r",
                           self.member.engine_id, verb)

    def _store_due(self) -> bool:
        """Host-monotonic rate limit on the round's STORE half: consumes,
        outbox flush, progress and beats happen at most once per
        ``min_store_poll_s`` while pump runs every round — the bound that
        keeps store-op volume per wall second independent of the tick
        rate (and of per-op store latency)."""
        if self.min_store_poll_s <= 0:
            return True
        now = time.monotonic()
        if self._last_store_poll_t is None \
                or now - self._last_store_poll_t >= self.min_store_poll_s:
            self._last_store_poll_t = now
            return True
        return False

    def _enqueue_result(self, doc: Dict[str, Any]) -> None:
        if len(self._outbox) >= self.outbox_cap:
            dropped = self._outbox.popleft()
            self.outbox_dropped_total += 1
            logger.warning(
                "fleet daemon[%s]: outbox full (cap %d) — dropped oldest "
                "buffered result %r (%d dropped so far; the router's "
                "journal failover re-serves it)", self.member.engine_id,
                self.outbox_cap, dropped.get("rid"),
                self.outbox_dropped_total)
        self._outbox.append(doc)

    def _flush_outbox(self) -> bool:
        """Publish buffered results to the results channel.  On a
        republish after a dark spell (``_store_dark``), each doc first
        passes a staleness check against the journal: an entry that is
        gone (stream already terminal) or re-stamped to another engine
        (failed over while we were partitioned) means OUR copy must be
        dropped — the fleet serves every stream exactly once.  Returns
        False when the store went dark mid-flush (the rest stays
        queued)."""
        m = self.member
        eid = m.engine_id
        check_stale = self._store_dark
        republished = 0
        while self._outbox:
            doc = self._outbox.popleft()
            try:
                if check_stale:
                    rid = doc.get("rid")
                    entry = self.store.get(
                        f"{FLEET_REQUESTS_PREFIX}/{_rid_key(rid)}")
                    if entry is None or entry.get("engine") != eid:
                        self.outbox_stale_dropped_total += 1
                        logger.warning(
                            "fleet daemon[%s]: dropped stale buffered "
                            "result %r after heal (%s)", eid, rid,
                            "journal entry gone — stream already terminal"
                            if entry is None else
                            f"failed over to {entry.get('engine')!r}")
                        continue
                channel_append(self.store,
                               self._key(FLEET_RESULTS_PREFIX), doc, eid)
                if check_stale:
                    republished += 1
            except (StoreUnavailable, OSError) as e:
                self._outbox.appendleft(doc)
                self.store_unavailable_total += 1
                logger.warning(
                    "fleet daemon[%s]: outbox flush interrupted — store "
                    "unavailable (%s); %d result(s) stay buffered", eid, e,
                    len(self._outbox))
                return False
        if republished:
            self.outbox_republished_total += republished
            logger.info(
                "fleet daemon[%s]: republished %d buffered result(s) "
                "after store heal (%d stale-dropped, %d cap-dropped "
                "total)", eid, republished,
                self.outbox_stale_dropped_total, self.outbox_dropped_total)
        return True

    def poll_once(self) -> int:
        """One daemon round.  Returns the member's outstanding count (the
        loop's idle signal).  The store half degrades, never crashes: a
        dark store means no NEW work arrives and nothing publishes —
        decode of accepted work continues regardless, results buffer in
        the outbox, and the member's lease simply stops renewing (which
        is exactly the signal the router's grace window interprets)."""
        m = self.member
        eid = m.engine_id
        store_due = self._store_due()
        dark = self._store_dark and not store_due
        if store_due:
            dark = False
            try:
                for _seq, op in channel_consume(
                        self.store, self._key(FLEET_CONTROL_PREFIX), eid):
                    self._apply_control(op)
                if not self._draining:
                    for _seq, doc in channel_consume(
                            self.store, self._key(FLEET_ASSIGN_PREFIX),
                            eid):
                        try:
                            m.submit(request_from_doc(doc))
                        except Exception as e:
                            logger.warning(
                                "fleet daemon[%s]: rejected assignment "
                                "%r: %s", eid, doc.get("rid"), e)
            except (StoreUnavailable, OSError) as e:
                dark = True
                self.store_unavailable_total += 1
                logger.warning(
                    "fleet daemon[%s]: store unavailable on consume (%s: "
                    "%s) — decoding continues, publishes buffer", eid,
                    type(e).__name__, e)
        # ---- DATA PLANE: runs every round, dark or not
        if m.alive:
            try:
                m.pump()
            except EngineDead as e:
                # the dying breath (durable dead marker) already landed in
                # _recover; publish what completed, then fall through to
                # the shutdown path — the router fails the rest over
                logger.warning("fleet daemon[%s]: engine dead: %s", eid, e)
                self.shutdown = True
        for res in m.take_results() if m.alive else []:
            self._enqueue_result(result_to_doc(res))
        # ---- store publishes: skipped while dark (buffered instead)
        if store_due and not dark:
            if self._outbox:
                dark = not self._flush_outbox()
            if m.alive and not dark:
                try:
                    self.store.put(
                        self._key(FLEET_PROGRESS_PREFIX),
                        {"streams": [
                            [rid, [int(t) for t in toks]]
                            for rid, toks in m.stream_progress().items()],
                         "t": self.store.now()})
                except (StoreUnavailable, OSError) as e:
                    dark = True
                    self.store_unavailable_total += 1
                    logger.warning(
                        "fleet daemon[%s]: progress publish skipped — "
                        "store unavailable (%s)", eid, e)
        if self._draining and m.alive and m.outstanding() == 0:
            self._draining = False
            if getattr(self, "_pending_recycle", False):
                self._pending_recycle = False
                m.recycle()
                try:
                    m.beat(force=True)
                except (StoreUnavailable, OSError):
                    dark = True
                    self.store_unavailable_total += 1
        if self._pending_epoch is not None and m.alive \
                and m.outstanding() == 0 and store_due and not dark:
            epoch = self._pending_epoch
            params = (self.params_provider(epoch)
                      if self.params_provider is not None else None)
            try:
                if m.prepare_epoch(params, epoch):
                    self._pending_epoch = None
                    logger.info(
                        "fleet daemon[%s]: prepared weight epoch %d",
                        eid, epoch)
            except (StoreUnavailable, OSError) as e:
                dark = True
                self.store_unavailable_total += 1
                logger.warning(
                    "fleet daemon[%s]: epoch prepare deferred — store "
                    "unavailable (%s)", eid, e)
        if m.alive and store_due and not dark:
            # the coordinator bumps the fleet generation through the
            # store; the daemon stamps its lease with whatever is current.
            # A dark store means the lease does NOT renew — the honest
            # signal: the router's miss_limit grace decides whether this
            # member is partitioned-but-decoding or gone.
            try:
                m.generation = read_generation(self.store,
                                               key=FLEET_GENERATION_KEY)
                m.beat()
            except (StoreUnavailable, OSError) as e:
                dark = True
                self.store_unavailable_total += 1
                logger.warning(
                    "fleet daemon[%s]: lease beat failed — store "
                    "unavailable (%s)", eid, e)
        if store_due:
            if self._store_dark and not dark:
                logger.info("fleet daemon[%s]: store reachable again", eid)
            self._store_dark = dark
        return m.outstanding() if m.alive else 0

    def run(self, max_ticks: Optional[int] = None) -> int:
        """Loop until a ``shutdown`` verb (or engine death / tick budget).
        Returns the rounds run."""
        rounds = 0
        while not self.shutdown:
            pending = self.poll_once()
            rounds += 1
            if max_ticks is not None and rounds >= max_ticks:
                break
            if pending == 0 and self.idle_sleep_s > 0:
                time.sleep(self.idle_sleep_s)
        return rounds
