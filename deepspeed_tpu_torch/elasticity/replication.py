"""Checkpoint-free pod recovery: buddy-replicated host state (counterpart
of ``deepspeed_tpu/elasticity/replication.py``).

Pod failover is otherwise checkpoint-grained: after a host death the next
round rolls back to the last *pod-committed* tag.  This layer keeps
in-memory redundancy instead:

- every ``replica_every_k`` steps each host snapshots its state to host
  RAM (``engine.replica_snapshot()``) and **seals** it into a size-capped
  CAS document under ``pod/replica/<host>``, the store-coupled stand-in
  for pushing the slab to the host's ring **buddy** (the next host in
  sorted order);
- after a peer death the next round's survivors try **live adoption**:
  the newest step at which *every* previous member holds a sealed,
  checksum-verified, generation-fenced slab (the consistent cut), one
  CAS claim ``pod/adopt/gen<g>/<victim>`` per victim, the state ingested
  (``engine.replica_ingest``), training resumed at the cut + 1;
- any missing slab, dead buddy, failed checksum, generation fence or a
  slab that does not fit the engine aborts adoption LOUDLY
  (:class:`ReplicaAdoptionError`): the caller falls back to the
  checkpoint restart.

Two limits of the port.  A slab is one rank's ZeRO shards, so it ingests
only at the data-parallel world that sealed it; after a world change
adoption raises and falls back.  And the coordination tier is not an
object store: a slab over :data:`REPLICA_MAX_BYTES` is refused, and the
port's :class:`HostReplicator` checks the size FIRST (``slab_bytes_fn``,
else the snapshot's length), so a refused slab costs no checksum or
base64 encoding of gigabytes; the refusal is counted in
``publish_failures`` and adoption later falls back loudly.
"""
from __future__ import annotations

import base64
import hashlib
import threading
from typing import Callable, Dict, Optional, Sequence

from .coordination import (CoordinationStore, StoreRetryPolicy,
                           StoreUnavailable, default_retry_policy)
from ..observability.trace import trace_span
from ..resilience.fault_injection import (SITE_POD_ADOPT, SITE_REPLICA_SEAL,
                                          maybe_fire)
from ..utils.logging import log_dist, logger

POD_REPLICA_PREFIX = "pod/replica"
POD_REPLICA_ROUND_PREFIX = "pod/replica_round"
POD_ADOPT_PREFIX = "pod/adopt"

# newest-first entries kept per host slab.  Sizing: adoption needs a cut
# COMMON to every previous member, and a silent death surfaces at the
# next pod-commit barrier (the commit timeout names every missing host
# at once — lease expiry may lag it).  Between a victim's last landed
# seal and that barrier the survivors can seal every boundary of the
# checkpoint interval — ceil(ckpt_every / k) of them, plus the one a
# mid-seal kill tears off the victim's slab.  4 keeps the shared cut
# adoptable through both at the shipped cadences (k=2, ckpt_every=5).
REPLICA_KEEP = 4
# size cap per slab document (the file store moves whole JSON docs; a
# state too big for the cap must replicate through a real object store,
# not the coordination tier)
REPLICA_MAX_BYTES = 64 << 20


class ReplicaIntegrityError(RuntimeError):
    """A sealed slab entry failed its checksum — the payload is torn."""


class ReplicaAdoptionError(RuntimeError):
    """Live-state adoption cannot proceed (missing slab, dead buddy,
    generation fence, no verifiable consistent cut).  The caller must
    fall back to checkpoint restart — loudly."""


# module counters surfaced as pod/replica_* gauges by the supervisor
_TOTALS_LOCK = threading.Lock()
_ADOPTIONS_TOTAL = 0
_FALLBACKS_TOTAL = 0


def replica_adoptions_total() -> int:
    with _TOTALS_LOCK:
        return _ADOPTIONS_TOTAL


def replica_fallbacks_total() -> int:
    with _TOTALS_LOCK:
        return _FALLBACKS_TOTAL


def note_adoption_fallback() -> None:
    """Count a loud adoption→checkpoint fallback (the agent calls this
    right before re-entering the durable restore walk)."""
    global _FALLBACKS_TOTAL
    with _TOTALS_LOCK:
        _FALLBACKS_TOTAL += 1


# ------------------------------------------------------------- buddy ring

def buddy_ring(hosts: Sequence[str]) -> Dict[str, str]:
    """Ring buddy assignment over the (healthy) membership: each host's
    buddy is the next host in sorted order, wrapping.  A single-host pod
    has nobody to replicate to ({})."""
    ring = sorted(hosts)
    if len(ring) < 2:
        return {}
    return {h: ring[(i + 1) % len(ring)] for i, h in enumerate(ring)}


# ---------------------------------------------------------- seal / verify

def seal_entry(payload: bytes, step: int, generation: int) -> Dict:
    """One sealed slab entry: step-stamped, generation-fenced,
    checksummed, payload carried base64 (store docs are JSON)."""
    return {
        "step": int(step),
        "generation": int(generation),
        "sha256": hashlib.sha256(payload).hexdigest(),
        "bytes": len(payload),
        "payload": base64.b64encode(payload).decode("ascii"),
    }


def verify_entry(entry: Dict) -> bytes:
    """Decode + checksum-verify one entry; returns the payload bytes."""
    try:
        payload = base64.b64decode(entry["payload"])
    except Exception as e:
        raise ReplicaIntegrityError(
            f"replica entry for step {entry.get('step')} is not decodable: "
            f"{e}") from e
    digest = hashlib.sha256(payload).hexdigest()
    if digest != entry.get("sha256"):
        raise ReplicaIntegrityError(
            f"replica entry for step {entry.get('step')} failed its "
            f"checksum ({digest[:12]}… != {str(entry.get('sha256'))[:12]}…)")
    if len(payload) != int(entry.get("bytes", -1)):
        raise ReplicaIntegrityError(
            f"replica entry for step {entry.get('step')} is truncated: "
            f"{len(payload)} bytes, sealed as {entry.get('bytes')}")
    return payload


# -------------------------------------------------------- publish / read

def publish_replica(store: CoordinationStore, host: str, entry: Dict,
                    buddy: Optional[str] = None,
                    keep: int = REPLICA_KEEP) -> Dict:
    """CAS-append ``entry`` (newest first) onto ``pod/replica/<host>``,
    keeping the newest ``keep`` entries — the same size-capped CAS-doc
    idiom as the fleet channels.  Returns the document as written."""
    if int(entry.get("bytes", 0)) > REPLICA_MAX_BYTES:
        raise ValueError(
            f"replica slab for {host!r} is {entry['bytes']} bytes, over "
            f"the {REPLICA_MAX_BYTES}-byte coordination-store cap")
    key = f"{POD_REPLICA_PREFIX}/{host}"
    maybe_fire(SITE_REPLICA_SEAL, host=host, step=entry.get("step"))
    out: Dict = {}

    def attempt():
        cur = store.get(key)
        entries = [e for e in (cur or {}).get("entries", ())
                   if int(e.get("step", -1)) != int(entry["step"])]
        entries.insert(0, entry)
        doc = {
            "host": host,
            "buddy": buddy,
            "generation": int(entry["generation"]),
            "seq": int((cur or {}).get("seq", 0)) + 1,
            "entries": entries[:keep],
            "t": store.now(),
        }
        if store.compare_and_swap(key, cur, doc):
            out.update(doc)
            return doc
        return StoreRetryPolicy.RETRY

    return default_retry_policy().run(f"publish_replica({host!r})", attempt)


def read_replica(store: CoordinationStore, host: str) -> Optional[Dict]:
    return store.get(f"{POD_REPLICA_PREFIX}/{host}")


def announce_replica_round(store: CoordinationStore, generation: int,
                           step: int) -> None:
    """Coordinator-side announcement that the pod seals at ``step``:
    hosts that do not drive the step loop themselves (simulated peers,
    protocol-only processes) poll this instead of guessing boundaries —
    the replica analogue of :func:`~.pod_agent.pending_commit`."""
    store.put(f"{POD_REPLICA_ROUND_PREFIX}/gen{int(generation)}",
              {"step": int(step), "t": store.now()})


def pending_replica_round(store: CoordinationStore,
                          generation: int) -> Optional[int]:
    doc = store.get(f"{POD_REPLICA_ROUND_PREFIX}/gen{int(generation)}")
    return int(doc["step"]) if doc else None


# ---------------------------------------------------------- host replicator

class HostReplicator:
    """Per-host replica pump: snapshot on the step path (device→host copy
    only), seal + publish on a background worker thread — the same
    off-step-path shape as the async-checkpoint finalize thread
    (runtime/checkpoint_engine/async_engine.py), coalescing so a slow
    store never queues more than the newest pending slab.

    ``snapshot_fn() -> bytes`` produces this host's shard payload (the
    engine host uses ``engine.replica_snapshot()``; simulated peers
    return synthetic shard bytes).  ``replica_every_k == 0`` disables the
    layer entirely: :meth:`maybe_replicate` is a single compare-and-return
    (the zero-step-time-regression contract).

    A slab over :data:`REPLICA_MAX_BYTES` is refused before any checksum
    or encoding.  When ``snapshot_fn`` is a bound method of an object with
    ``replica_nbytes()`` (``engine.replica_snapshot``), that size is read
    first and an over-cap slab is not even built: the engine's slab is
    its whole flat state, gigabytes at real widths.
    """

    def __init__(self, store: CoordinationStore, host_id: str,
                 generation: int, hosts: Sequence[str],
                 snapshot_fn: Callable[[], bytes],
                 replica_every_k: int = 0, monitor=None,
                 on_sealed: Optional[Callable[[int], None]] = None):
        self.store = store
        # the engine's slab size, known before the slab is built
        self.slab_bytes_fn = getattr(getattr(snapshot_fn, "__self__", None),
                                     "replica_nbytes", None)
        self.host_id = host_id
        self.generation = int(generation)
        self.buddy = buddy_ring(hosts).get(host_id)
        self.snapshot_fn = snapshot_fn
        self.replica_every_k = int(replica_every_k)
        self.monitor = monitor
        self.on_sealed = on_sealed
        self.seals_total = 0
        self.bytes_published = 0
        self.last_step = -1
        self.publish_failures = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: Optional[Dict] = None
        self._stopping = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ step path

    def maybe_replicate(self, step: int) -> bool:
        """Called once per completed step.  Off-boundary (and disabled)
        calls return immediately; on a boundary the snapshot runs here
        (the device→host copy must see the step's state before the next
        step mutates it) and the seal/publish is handed to the worker."""
        if self.replica_every_k <= 0:
            return False
        if step % self.replica_every_k != 0:
            return False
        payload = self._snapshot(step)
        if payload is None:
            return False
        entry = seal_entry(payload, step, self.generation)
        with self._cv:
            # coalesce: a publish still in flight is superseded — the
            # newest slab is the only one adoption will ever want
            self._pending = entry
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"pod-replica-{self.host_id}")
                self._thread.start()
            self._cv.notify()
        return True

    def seal_now(self, step: int) -> bool:
        """Synchronous best-effort seal + publish — the preemption path
        (SIGTERM latched): a planned preemption must never cost more than
        the in-flight step, so the exiting host pushes its state to its
        buddy before the save/exit sequence runs.  Failures are logged,
        never raised (the durable preemption checkpoint still runs)."""
        if self.replica_every_k <= 0:
            return False
        try:
            payload = self._snapshot(step)
            if payload is None:
                return False
            self._publish(seal_entry(payload, step, self.generation))
            return True
        except Exception as e:   # best-effort by contract
            with self._lock:
                self.publish_failures += 1
            logger.error(
                "pod replicate: preemption-path seal of %s at step %d "
                "failed (%s: %s); the durable checkpoint is the fallback",
                self.host_id, step, type(e).__name__, e)
            return False

    def _snapshot(self, step: int):
        """The slab of ``step``, or None when it is over the cap: refused
        before any checksum or encoding and counted, as a refused publish
        is."""
        payload = None if self.slab_bytes_fn else self.snapshot_fn()
        size = int(self.slab_bytes_fn()) if self.slab_bytes_fn else len(payload)
        if size > REPLICA_MAX_BYTES:
            with self._lock:
                self.publish_failures += 1
            logger.warning(
                "pod replicate: the slab of %s at step %d is %d bytes, over the "
                "%d-byte coordination-store cap; not sealed (adoption will fall "
                "back to the checkpoint)", self.host_id, step, size, REPLICA_MAX_BYTES)
            return None
        return self.snapshot_fn() if payload is None else payload

    # ---------------------------------------------------------- worker side

    def _worker(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stopping:
                    self._cv.wait()
                if self._pending is None and self._stopping:
                    return
                entry, self._pending = self._pending, None
            try:
                self._publish(entry)
            except Exception as e:
                with self._lock:
                    self.publish_failures += 1
                logger.warning(
                    "pod replicate: publish of %s step %s failed "
                    "(%s: %s); the slab stays at its previous seal",
                    self.host_id, entry.get("step"), type(e).__name__, e)

    def _publish(self, entry: Dict) -> None:
        with trace_span("pod.replicate", host=self.host_id,
                        step=entry["step"], bytes=entry["bytes"]):
            publish_replica(self.store, self.host_id, entry,
                            buddy=self.buddy)
        with self._lock:   # _publish runs on the worker AND seal_now paths
            self.seals_total += 1
            self.bytes_published += int(entry["bytes"])
            self.last_step = int(entry["step"])
            seals, published, last = (self.seals_total,
                                      self.bytes_published, self.last_step)
        if self.monitor is not None:
            self.monitor.write_events([
                ("pod/replica_seals_total", float(seals), entry["step"]),
                ("pod/replica_bytes_total", float(published),
                 entry["step"]),
                ("pod/replica_last_step", float(last), entry["step"]),
            ])
        if self.on_sealed is not None:
            self.on_sealed(int(entry["step"]))

    def stop(self, timeout_s: float = 30.0) -> None:
        """Drain the pending publish (bounded) and stop the worker —
        called at round exit so the final slab is durable-on-store before
        the next round plans its adoption cut."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        self._thread = None


# --------------------------------------------------------------- adoption

def plan_adoption(store: CoordinationStore, prev_hosts: Sequence[str],
                  dead: Sequence[str],
                  dead_prefix: str = "dead") -> Dict:
    """The consistent cut: the newest step at which EVERY previous member
    holds a sealed, checksum-verified slab entry of one generation, with
    every victim's entry generation-fenced against its dead marker and
    every victim's ring buddy still alive (the buddy is the host
    answering for the replica; buddy-and-victim double-kill therefore
    falls back to the durable checkpoint by design).

    Returns ``{"step", "generation", "victims": {victim: buddy},
    "entries": {host: entry}}``; raises :class:`ReplicaAdoptionError` on
    any reason adoption must not proceed."""
    prev = sorted(prev_hosts)
    victims = sorted(set(dead) & set(prev))
    if not victims:
        raise ReplicaAdoptionError("no victim among the previous "
                                   "membership — nothing to adopt")
    survivors = [h for h in prev if h not in set(dead)]
    ring = buddy_ring(prev)
    fence = 0
    buddies: Dict[str, str] = {}
    for v in victims:
        buddy = ring.get(v)
        if buddy is None or buddy in set(dead):
            raise ReplicaAdoptionError(
                f"victim {v!r}'s ring buddy {buddy!r} is dead too — its "
                "replica RAM died with it (double-kill)")
        buddies[v] = buddy
        marker = store.get(f"{dead_prefix}/{v}")
        if marker is not None:
            fence = max(fence, int(marker.get("generation", 0)))
    if not survivors:
        raise ReplicaAdoptionError("no survivor remains to adopt")
    docs: Dict[str, Dict] = {}
    for h in prev:
        doc = read_replica(store, h)
        if doc is None or not doc.get("entries"):
            raise ReplicaAdoptionError(
                f"host {h!r} has no published replica slab — the pod "
                "never sealed (or the store lost the doc)")
        docs[h] = doc
    # verified (step, generation) candidates per host, fence applied
    verified: Dict[str, Dict[int, Dict]] = {}
    for h, doc in docs.items():
        ok: Dict[int, Dict] = {}
        for e in doc.get("entries", ()):
            if int(e.get("generation", -1)) < fence:
                continue   # slab of a pre-death incarnation: fenced out
            try:
                verify_entry(e)
            except ReplicaIntegrityError as ie:
                logger.warning(
                    "pod adopt: %s slab entry at step %s fails "
                    "verification (%s); trying an older seal", h,
                    e.get("step"), ie)
                continue
            ok[int(e["step"])] = e
        verified[h] = ok
    common = set.intersection(*(set(v) for v in verified.values())) \
        if verified else set()
    cuts = sorted(common, reverse=True)
    for step in cuts:
        gens = {int(verified[h][step]["generation"]) for h in prev}
        if len(gens) == 1:
            return {"step": step, "generation": gens.pop(),
                    "victims": buddies,
                    "entries": {h: verified[h][step] for h in prev}}
    raise ReplicaAdoptionError(
        "no consistent cut: no step is sealed+verified by every previous "
        f"member within the generation fence (fence {fence}; per-host "
        f"steps: { {h: sorted(v) for h, v in verified.items()} })")


def claim_adoption(store: CoordinationStore, generation: int, victim: str,
                   adopter: str, step: int, slab_generation: int,
                   dead_prefix: str = "dead") -> bool:
    """CAS-create ``pod/adopt/gen<g>/<victim>`` — the at-most-one-adopter
    fence: exactly one survivor wins the right to reconstruct a victim's
    shards in a round (checked after the fact by tools/store_check.py's
    replica rules).  Returns False when another adopter already holds
    the claim for this round."""
    marker = store.get(f"{dead_prefix}/{victim}")
    key = f"{POD_ADOPT_PREFIX}/gen{int(generation)}/{victim}"
    doc = {
        "victim": victim,
        "adopter": adopter,
        "step": int(step),
        "slab_generation": int(slab_generation),
        "dead_generation": int((marker or {}).get("generation", 0)),
        "t": store.now(),
    }
    maybe_fire(SITE_POD_ADOPT, victim=victim, adopter=adopter, step=step)

    def attempt():
        cur = store.get(key)
        if cur is not None:
            return bool(cur.get("adopter") == adopter)
        if store.compare_and_swap(key, None, doc):
            return True
        return StoreRetryPolicy.RETRY

    return bool(default_retry_policy().run(
        f"claim_adoption({victim!r})", attempt))


def adopt_replicas(store: CoordinationStore, engine,
                   prev_hosts: Sequence[str], dead: Sequence[str],
                   generation: int, host_id: str,
                   dead_prefix: str = "dead") -> int:
    """The live-adoption path, end to end: plan the consistent cut, claim
    every victim for its buddy, re-ingest this host's own slab into the
    engine, and return the step training resumes FROM (the cut; the next
    trained step is cut+1).  Raises :class:`ReplicaAdoptionError` when
    any stage says the replicas cannot carry the round — the caller falls
    back loudly to the checkpoint walk."""
    global _ADOPTIONS_TOTAL
    with trace_span("pod.adopt", host=host_id, generation=int(generation)):
        try:
            plan = plan_adoption(store, prev_hosts, dead,
                                 dead_prefix=dead_prefix)
        except (StoreUnavailable, OSError) as e:
            raise ReplicaAdoptionError(
                f"store unreachable while planning adoption: {e}") from e
        for victim, buddy in sorted(plan["victims"].items()):
            try:
                claimed = claim_adoption(store, generation, victim, buddy,
                                         plan["step"], plan["generation"],
                                         dead_prefix=dead_prefix)
            except (StoreUnavailable, OSError) as e:
                raise ReplicaAdoptionError(
                    f"store unreachable while claiming {victim!r}: "
                    f"{e}") from e
            if not claimed:
                raise ReplicaAdoptionError(
                    f"victim {victim!r} is already claimed by another "
                    f"adopter this round (generation {generation})")
        own = plan["entries"].get(host_id)
        if own is None:
            raise ReplicaAdoptionError(
                f"host {host_id!r} holds no slab at the cut step "
                f"{plan['step']}")
        payload = verify_entry(own)
        try:
            resumed = int(engine.replica_ingest(payload))
        except Exception as e:
            raise ReplicaAdoptionError(
                f"re-ingest of the step-{plan['step']} slab failed "
                f"({type(e).__name__}: {e})") from e
        if resumed != int(plan["step"]):
            raise ReplicaAdoptionError(
                f"slab claimed step {plan['step']} but ingested state is "
                f"at step {resumed}")
        with _TOTALS_LOCK:
            _ADOPTIONS_TOTAL += 1
        log_dist(
            f"pod adopt: live-state adoption at step {plan['step']} "
            f"(generation {generation}; victims "
            f"{sorted(plan['victims'])}, buddies serve the replicas) — "
            "zero checkpoint rollback", ranks=[0])
        return resumed
