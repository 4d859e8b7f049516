"""Pod coordination: heartbeat leases, generation counter, rendezvous
(counterpart of ``deepspeed_tpu/elasticity/coordination.py``, copied: it
imports no framework).

A host that dies mid-collective leaves its peers wedged in NCCL with no
exception, and the launcher's supervisor cannot tell a transient crash from
a permanently lost host.  This module is that side channel, in the spirit
of Bamboo (NSDI '23) and Oobleck (SOSP '23)-style elastic recovery, built
on one small abstraction:

:class:`CoordinationStore`
    A namespaced key -> JSON-document store with atomic replace and an
    atomic :meth:`~CoordinationStore.compare_and_swap`.  Deployments back
    it with storage every host already shares (the checkpoint filesystem,
    a coordinator-host export); tests use :class:`FileCoordinationStore`
    on a tmpdir.  Its on-disk format is the JAX package's byte for byte
    (key paths, ``<key>.lock`` files, ``<key>.tomb`` tombstones,
    ``<key>.corrupt[.N]`` quarantines, the JSON of each document), so a
    client of either package can share one directory.  Nothing here
    imports torch: the launcher uses it before any device runtime exists.

On top of it, four protocols:

- **Heartbeats with leases** (:func:`beat` / :func:`lease_table` /
  :func:`dead_hosts`): a host whose newest beat is older than
  ``miss_limit`` lease periods is *dead by lease*;
  :class:`HeartbeatWatchdog` runs the renew/scan loop on a daemon thread
  and exits the process with :data:`RC_POD_PEER_LOST` (``os._exit``, which
  also breaks a wedged collective) when a peer is declared dead.  With one
  process per GPU, a host's ``LOCAL_RANK`` 0 renews the lease and every
  rank scans (``renew=False``), so every rank of a surviving host exits on
  its own.
- **Pod generation** (:func:`read_generation` / :func:`bump_generation`):
  a monotonic CAS-bumped integer naming one membership epoch.
- **Rendezvous** (:func:`rendezvous`).
- **Coordinator election** (:func:`elect_coordinator` /
  :func:`read_coordinator`): a lease-based leader lock, CAS on one key.

The lease/dead-marker helpers take a ``prefix`` so tiers share one
implementation without sharing a namespace: pods lease under
``heartbeat/`` + ``dead/``, the serving fleet (``inference/fleet.py``) under
``fleet/heartbeat`` + ``fleet/dead``; its channels, residency digests and
trace segments live here too.  Fault sites ``pod.heartbeat``,
``pod.rendezvous`` and ``fleet.channel_append`` hook the live paths.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..resilience.fault_injection import (SITE_FLEET_CHANNEL,
                                          SITE_POD_HEARTBEAT,
                                          SITE_POD_RENDEZVOUS, maybe_fire)
from ..resilience.integrity import _atomic_write_doc
from ..utils.logging import logger

# exit code a host uses when the heartbeat watchdog declares a peer dead:
# distinct from RC_HANG (85, watchdog) so the supervisor can tell "my own
# step wedged" from "a peer's lease expired and I exited to re-form"
RC_POD_PEER_LOST = 87


class PodCoordinationError(RuntimeError):
    """Base error for the pod coordination layer."""


class PodRendezvousTimeout(PodCoordinationError):
    """Rendezvous did not reach the expected membership in time."""


class StoreUnavailable(PodCoordinationError):
    """The coordination store is unreachable for THIS client — a
    blackout/partition, or a retry discipline that exhausted its
    deadline.  The graceful-degradation signal, not a retry signal:
    clients catch it and degrade (a member daemon buffers its outbox
    and keeps decoding, a router parks admission, a watchdog counts a
    failed scan instead of declaring peers dead) rather than spinning
    against a store that is gone.  :class:`StoreRetryPolicy` NEVER
    retries it — transient flakiness is ``OSError``; this is "stop
    asking" (docs/FLEET.md "Store brownouts and partitions")."""


class CoordinationStore:
    """Namespaced key -> JSON document store with atomic replace.

    Keys are ``/``-separated paths (``heartbeat/host3``,
    ``rendezvous/gen2/host0``).  Semantics the protocols rely on:

    - :meth:`put` replaces atomically — a reader never observes a torn
      document;
    - :meth:`compare_and_swap` replaces atomically ONLY when the current
      document equals ``expected`` (``None`` = key absent) — the primitive
      the generation bump, dead markers and coordinator election build on;
    - :meth:`list` returns the child names directly under a prefix;
    - there is no watch/subscribe: every consumer polls, which keeps the
      file backend honest and the test clock injectable.
    """

    def put(self, key: str, value: Dict) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[Dict]:
        raise NotImplementedError

    def compare_and_swap(self, key: str, expected: Optional[Dict],
                         new: Dict) -> bool:
        """Write ``new`` iff the current document equals ``expected``
        (``None`` = the key must be absent); returns whether the swap won.
        This base implementation is a plain read-compare-write — correct
        only under a single writer.  Real backends MUST override it with
        an atomic version (``FileCoordinationStore`` locks per key); it
        exists so a minimal duck-typed store still runs the protocols."""
        if self.get(key) != expected:
            return False
        self.put(key, new)
        return True

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def compare_and_delete(self, key: str, expected: Dict) -> bool:
        """Delete ``key`` iff the current document equals ``expected``,
        leaving a TOMBSTONE that blocks a later create
        (``compare_and_swap(key, None, ...)``) until it is cleared or
        expires — the fenced GC primitive (docs/FLEET.md "Journal GC"):
        a leader stalled past its election lease holds a stale
        ``expected`` and can never delete an entry its successor
        re-stamped, and its stale appends cannot resurrect an entry the
        live owner already collected.  ``expected`` must not be ``None``
        (deleting an absent key is a plain :meth:`delete`).

        This base implementation is read-compare-delete with no lock and
        no tombstone — correct only under a single writer, exactly like
        the base :meth:`compare_and_swap` it mirrors.  Real backends MUST
        override it atomically (``FileCoordinationStore`` serializes
        through the same per-key lock file its CAS uses)."""
        if expected is None:
            raise ValueError(
                "compare_and_delete: expected must be a document, not None")
        if self.get(key) != expected:
            return False
        self.delete(key)
        return True

    def clear_tombstone(self, key: str) -> None:
        """Drop the tombstone a :meth:`compare_and_delete` left on
        ``key`` so a create can land again — the escape hatch for a
        caller that KNOWS the key's next writer is legitimate (e.g. a
        fresh submission reusing a collected rid).  Base stores keep no
        tombstones; this is a no-op there."""

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def now(self) -> float:
        """The store clock — ``time.time`` by default so stamps are
        comparable across hosts sharing the backend; tests inject a fake
        clock for deterministic lease-expiry coverage."""
        return time.time()


class FileCoordinationStore(CoordinationStore):
    """File-backed store: one JSON file per key under ``root``.

    Deployment target is storage all hosts of the pod already mount (the
    checkpoint filesystem or a coordinator-host export); tests point it at
    a tmpdir.  Atomicity is write-to-tmp + ``os.replace`` — the same
    discipline as the checkpoint manifests.  The tmp name carries pid and
    thread id so concurrent writers (simulated hosts are threads) never
    collide on it.

    :meth:`compare_and_swap` serializes writers through a per-key
    ``<key>.lock`` file created ``O_CREAT|O_EXCL`` — atomic on every
    filesystem the store targets, across threads AND processes.  A lock
    orphaned by a writer that died mid-CAS is broken after
    ``lock_stale_s`` (the readers-never-block property is preserved:
    ``get``/``list`` ignore locks entirely).
    """

    def __init__(self, root: str, clock: Optional[Callable[[], float]] = None,
                 cas_timeout_s: float = 10.0, lock_stale_s: float = 5.0,
                 tombstone_ttl_s: float = 300.0):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._clock = clock
        # the CAS wait must be able to OUTLIVE the stale-lock window, or a
        # lock orphaned by a SIGKILLed writer turns every later CAS on the
        # key into a timeout error instead of one stolen lock (the breaker
        # would be unreachable within a single call)
        self.cas_timeout_s = max(float(cas_timeout_s),
                                 float(lock_stale_s) + 1.0)
        self.lock_stale_s = float(lock_stale_s)
        # tombstones left by compare_and_delete expire after this long
        # (wall clock, like the stale-lock breaker): fencing windows are
        # election-lease-sized, so a tombstone old enough to outlive every
        # deposed writer is pure debris
        self.tombstone_ttl_s = float(tombstone_ttl_s)
        # CAS acquisitions that found the per-key lock held at least once
        # (the fleet/store_cas_contended_total gauge): N routers racing
        # one key show up here long before latency does
        self.cas_contended_total = 0
        # torn/corrupt documents quarantined aside by get() (the
        # store/corrupt_docs_total gauge): every one of these is a
        # writer that bypassed the tmp+rename discipline (or storage
        # corruption) — it must be visible, never silently "absent"
        self.corrupt_docs_total = 0

    def _path(self, key: str) -> str:
        key = key.strip("/")
        if not key or ".." in key.split("/"):
            raise ValueError(f"bad coordination key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, value: Dict) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write_doc(path, value)

    def get(self, key: str) -> Optional[Dict]:
        path = self._path(key)   # key validation errors must not be eaten
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except ValueError as e:
            # TORN/CORRUPT document (our own writes are tmp+atomic-rename,
            # so this is a foreign writer that skipped the discipline, or
            # real storage corruption).  Silently reading it as "absent"
            # used to let a CAS create clobber whatever the key held and
            # made torn-write-recovered indistinguishable from lost —
            # quarantine the bytes aside (numbered, never clobbering an
            # earlier quarantine), count it, and ONLY then report absent:
            # the checker and the gauge can now tell the two apart.
            self.corrupt_docs_total += 1
            quarantined = self._quarantine_corrupt(path)
            logger.error(
                "coordination store: corrupt document at key %s (%s); "
                "quarantined to %s", key, e, quarantined or "<unmovable>")
            return None
        except OSError as e:
            # the backend itself failed (not "no such key"): this client
            # cannot tell what the key holds, and "absent" would be a
            # LIE that cascades — a lease scan would declare live peers
            # dead, a CAS create would fence-break.  Degrade typed.
            raise StoreUnavailable(
                f"coordination store: backend read of {key!r} failed "
                f"({e})") from e

    @staticmethod
    def _quarantine_corrupt(path: str) -> Optional[str]:
        """Move a corrupt document aside as ``<path>.corrupt[.N]`` (the
        numbered-collision discipline of ``integrity.quarantine_tag``);
        returns the quarantine path, or None when the rename failed."""
        dst = path + ".corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{path}.corrupt.{n}"
        try:
            os.replace(path, dst)
            return dst
        except OSError:   # pragma: no cover - racing quarantines
            return None

    def _acquire_lock(self, key: str, path: str,
                      what: str) -> Tuple[int, int, str]:
        """Take the per-key ``<key>.lock`` (O_CREAT|O_EXCL — atomic across
        threads AND processes), spinning with jittered exponential backoff
        under contention: N routers racing one hot key (the admission
        partition table, the election key) must degrade into staggered
        retries, not a synchronized hot-spin that keeps re-colliding at
        the same instants.  Returns ``(fd, inode, lock_path)``; the caller
        must release via :meth:`_release_lock`."""
        lock = path + ".lock"
        deadline = time.monotonic() + self.cas_timeout_s
        attempt = 0
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                return fd, os.fstat(fd).st_ino, lock
            except FileExistsError:
                if attempt == 0:
                    # counted once per contended ACQUISITION, not per spin:
                    # the gauge answers "how often do writers collide", not
                    # "how long did they wait"
                    self.cas_contended_total += 1
                attempt += 1
                try:
                    # break a lock orphaned by a writer that died holding
                    # it (wall-clock mtime: the injectable store clock must
                    # not make a live lock look ancient).  The steal is an
                    # atomic RENAME to a waiter-unique name: of N waiters
                    # that all observed the same stale lock, exactly one
                    # rename succeeds — a bare remove here would let a
                    # second waiter delete the FIRST waiter's freshly
                    # re-created lock and put two writers inside the
                    # critical section (split-brain CAS).
                    if time.time() - os.path.getmtime(lock) > self.lock_stale_s:
                        stolen = (f"{lock}.stale.{os.getpid()}"
                                  f".{threading.get_ident()}")
                        os.rename(lock, stolen)
                        os.remove(stolen)
                        continue
                except OSError:
                    pass   # the holder released it (or another waiter
                           # stole it) between the two calls
                if time.monotonic() >= deadline:
                    raise PodCoordinationError(
                        f"{what}({key!r}): lock {lock} held for "
                        f"over {self.cas_timeout_s:.1f}s — a writer is "
                        "wedged or the stale-lock breaker is disabled")
                # full jitter on an exponentially growing ceiling (capped
                # well under the lease scale): waiters desynchronize, and
                # the first retry stays ~instant for the common
                # two-writers-once case
                cap = min(0.02, 0.0005 * (1 << min(attempt, 6)))
                time.sleep(random.uniform(0.0001, cap))

    @staticmethod
    def _release_lock(fd: int, my_ino: int, lock: str) -> None:
        os.close(fd)
        try:
            # ownership-checked release: if a waiter stale-stole OUR
            # lock (we stalled past lock_stale_s inside this critical
            # section), the file at `lock` is now the stealer's —
            # removing it blindly would admit yet another writer.  The
            # stale threshold (seconds) vs the ms-long critical section
            # makes a steal-from-live vanishingly rare, but the release
            # must not widen it into a cascade.
            if os.stat(lock).st_ino == my_ino:
                os.remove(lock)
        except OSError:   # pragma: no cover - breaker raced us
            pass

    def _tomb_path(self, path: str) -> str:
        return path + ".tomb"

    def _tombstone_blocks(self, path: str) -> bool:
        """Whether a LIVE tombstone sits on ``path`` (expired ones are
        reaped in passing — debris, not a fence; the TTL is wall-clock
        like the stale-lock breaker, and far beyond any election lease)."""
        tomb = self._tomb_path(path)
        try:
            if time.time() - os.path.getmtime(tomb) <= self.tombstone_ttl_s:
                return True
            os.remove(tomb)
        except OSError:
            pass
        return False

    def compare_and_swap(self, key: str, expected: Optional[Dict],
                         new: Dict) -> bool:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, my_ino, lock = self._acquire_lock(key, path, "compare_and_swap")
        try:
            if self.get(key) != expected:
                return False
            if expected is None and self._tombstone_blocks(path):
                # a compare_and_delete fenced this key: a create here is by
                # definition a writer that did not see the delete (the
                # deposed leader's stale append / create retry) — blocked
                # until clear_tombstone or the TTL says no deposed writer
                # can still be alive
                return False
            _atomic_write_doc(path, new)
            return True
        finally:
            self._release_lock(fd, my_ino, lock)

    def compare_and_delete(self, key: str, expected: Dict) -> bool:
        if expected is None:
            raise ValueError(
                "compare_and_delete: expected must be a document, not None")
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, my_ino, lock = self._acquire_lock(key, path, "compare_and_delete")
        try:
            if self.get(key) != expected:
                return False
            # tombstone FIRST, then remove: a crash between the two leaves
            # the key both present and fenced — the next compare_and_delete
            # with the same expected finishes the job, and no create can
            # slip into the gap
            with open(self._tomb_path(path), "w", encoding="utf-8") as fh:
                json.dump({"t": self.now()}, fh)
            try:
                os.remove(path)
            except FileNotFoundError:   # pragma: no cover - defensive
                pass
            return True
        finally:
            self._release_lock(fd, my_ino, lock)

    def clear_tombstone(self, key: str) -> None:
        try:
            os.remove(self._tomb_path(self._path(key)))
        except OSError:
            pass

    def list(self, prefix: str) -> List[str]:
        try:
            names = os.listdir(self._path(prefix))
        except (FileNotFoundError, NotADirectoryError):
            return []
        # tmp siblings, CAS lock files (incl. `<key>.lock.stale.*`
        # rename-steal remnants of a waiter that died mid-steal),
        # compare-delete tombstones and quarantined corrupt documents
        # (`<key>.corrupt[.N]`) are write-protocol artifacts, never
        # documents.  Match the exact artifact shapes, not a bare ".lock"
        # substring — a legitimate id like "db.lockhart-3" must stay
        # visible to lease/dead scans.
        return sorted(n for n in names
                      if ".tmp." not in n and not n.endswith(".lock")
                      and ".lock.stale." not in n
                      and not n.endswith(".tomb")
                      and not n.endswith(".corrupt")
                      and ".corrupt." not in n)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def now(self) -> float:
        return self._clock() if self._clock is not None else time.time()


# ------------------------------------------------------------- retry policy

# process-wide count of store-op retries taken through StoreRetryPolicy
# (CAS losses re-attempted + transient errors absorbed) — the single
# number behind the fleet/store_retries_total gauge, whatever mix of
# policy instances a process runs
_STORE_RETRIES_LOCK = threading.Lock()
_STORE_RETRIES_TOTAL = 0


def store_retries_total() -> int:
    """Process-wide retries taken by every :class:`StoreRetryPolicy`
    (the ``fleet/store_retries_total`` gauge reads this)."""
    return _STORE_RETRIES_TOTAL


class StoreRetryPolicy:
    """The one retry discipline for store protocol loops: jittered
    exponential backoff under a wall-clock deadline, store-agnostic.

    Replaces the ad-hoc bare ``while True`` CAS loops that used to live
    in :func:`bump_generation`, :func:`channel_append`, the journal
    flush and the partition claims — each of which would spin forever
    (and hot) against a store that stopped answering.  Two retryable
    outcomes, one terminal one:

    - the attempt returns :data:`RETRY` (a lost CAS: re-read, try
      again) — retried with backoff;
    - the attempt raises ``OSError`` (transient backend flakiness,
      injected or real) — retried with backoff;
    - the attempt raises :class:`StoreUnavailable` (blackout/partition)
      — **propagated immediately**: a dark store must fail FAST into
      the caller's degradation path (outbox, parked admission), not
      stall it for the full deadline.

    Past ``deadline_s`` of wall time the policy raises
    :class:`StoreUnavailable` itself — the per-op deadline wrapper the
    degradation contracts are written against.  Every retry counts into
    :func:`store_retries_total` and the instance's ``retries_total``.
    """

    RETRY = object()   # sentinel an attempt returns to request another try

    def __init__(self, deadline_s: float = 10.0, base_s: float = 0.0005,
                 cap_s: float = 0.02, seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.deadline_s = float(deadline_s)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.retries_total = 0
        self._rng = random.Random(seed)
        self._sleep = sleep

    def run(self, what: str, attempt: Callable[[], object]):
        """Call ``attempt()`` until it returns a non-:data:`RETRY` value
        (returned), raising :class:`StoreUnavailable` at the deadline."""
        global _STORE_RETRIES_TOTAL
        deadline = time.monotonic() + self.deadline_s
        attempts = 0
        err: Optional[BaseException] = None
        while True:
            try:
                out = attempt()
                if out is not StoreRetryPolicy.RETRY:
                    return out
            except StoreUnavailable:
                raise
            except OSError as e:
                err = e
            attempts += 1
            self.retries_total += 1
            with _STORE_RETRIES_LOCK:
                _STORE_RETRIES_TOTAL += 1
            if time.monotonic() >= deadline:
                raise StoreUnavailable(
                    f"{what}: no successful store op within "
                    f"{self.deadline_s:.1f}s ({attempts} attempt(s); "
                    f"last error: {err!r})") from err
            # full jitter on an exponentially growing ceiling — the same
            # shape as the file store's lock spin, but store-agnostic
            cap = min(self.cap_s, self.base_s * (1 << min(attempts, 6)))
            self._sleep(self._rng.uniform(0.0, cap))


_DEFAULT_RETRY: Optional[StoreRetryPolicy] = None


def default_retry_policy() -> StoreRetryPolicy:
    """The module-shared policy behind :func:`bump_generation`,
    :func:`record_dead`, :func:`channel_append` and friends — one
    instance, so the protocol helpers stay zero-config."""
    global _DEFAULT_RETRY
    if _DEFAULT_RETRY is None:
        _DEFAULT_RETRY = StoreRetryPolicy()
    return _DEFAULT_RETRY


# --------------------------------------------------------------- heartbeats

@dataclass(frozen=True)
class HostLease:
    """One host's newest heartbeat as seen through the store."""
    host_id: str
    generation: int
    beat_t: float          # store-clock stamp of the newest beat
    lease_s: float         # the period the host promised to renew within
    attrs: Dict

    def age(self, now: float) -> float:
        return max(0.0, now - self.beat_t)

    def missed(self, now: float) -> float:
        """Lease periods elapsed since the newest beat (0.0 = fresh)."""
        return self.age(now) / self.lease_s if self.lease_s > 0 else 0.0


def beat(store: CoordinationStore, host_id: str, generation: int,
         lease_s: float, prefix: str = "heartbeat", **attrs) -> None:
    """Renew ``host_id``'s lease for ``generation``.  ``attrs`` ride along
    (e.g. ``step=`` so peers and the supervisor can observe progress).
    ``prefix`` namespaces the lease tier (pods default to ``heartbeat``;
    serving-fleet engines lease under ``fleet/heartbeat``)."""
    maybe_fire(SITE_POD_HEARTBEAT, host=host_id, generation=generation)
    store.put(f"{prefix}/{host_id}", {
        "host_id": host_id, "generation": int(generation),
        "beat_t": store.now(), "lease_s": float(lease_s), "attrs": attrs})


def lease_table(store: CoordinationStore,
                prefix: str = "heartbeat") -> Dict[str, HostLease]:
    """Every host's newest lease, regardless of generation or freshness."""
    out: Dict[str, HostLease] = {}
    for name in store.list(prefix):
        doc = store.get(f"{prefix}/{name}")
        if doc is None:
            continue
        out[doc["host_id"]] = HostLease(
            host_id=doc["host_id"], generation=int(doc["generation"]),
            beat_t=float(doc["beat_t"]), lease_s=float(doc["lease_s"]),
            attrs=doc.get("attrs", {}))
    return out


def dead_hosts(store: CoordinationStore, generation: int, miss_limit: int,
               expected: Optional[List[str]] = None,
               prefix: str = "heartbeat") -> List[str]:
    """Hosts of ``generation`` whose lease has lapsed ``miss_limit`` times
    — plus, when ``expected`` is given, hosts that never reached this
    generation at all (no lease, or one stuck at an OLDER generation: a
    host that died before its first renewal is just as dead).  A lease
    from a NEWER generation is proof of life, never death — a stale
    watchdog still scanning for its old generation must not dead-mark the
    healthy hosts that re-formed without it."""
    now = store.now()
    table = lease_table(store, prefix=prefix)
    dead = []
    for host, lease in table.items():
        if lease.generation == generation and lease.missed(now) >= miss_limit:
            dead.append(host)
    for host in expected or []:
        lease = table.get(host)
        if lease is None or lease.generation < generation:
            dead.append(host)
    return sorted(set(dead))


def record_dead(store: CoordinationStore, host_id: str, generation: int,
                reported_by: str, prefix: str = "dead") -> None:
    """Durable dead-host marker: once ANY peer declares a host dead for a
    generation, every later supervisor round excludes it until an operator
    (or a re-registering host) clears the marker.  CAS-written so racing
    reporters commit exactly one marker per generation — the FIRST
    reporter wins, and a marker from an equal-or-newer generation is never
    clobbered by a stale scanner still looking at an old epoch."""
    key = f"{prefix}/{host_id}"
    doc = {"host_id": host_id, "generation": int(generation),
           "reported_by": reported_by, "t": store.now()}

    def attempt():
        cur = store.get(key)
        if cur is not None \
                and int(cur.get("generation", -1)) >= int(generation):
            return None
        if store.compare_and_swap(key, cur, doc):
            return None
        return StoreRetryPolicy.RETRY

    default_retry_policy().run(f"record_dead({host_id!r})", attempt)


def dead_set(store: CoordinationStore, prefix: str = "dead") -> List[str]:
    return [name for name in store.list(prefix)
            if store.get(f"{prefix}/{name}") is not None]


def clear_dead(store: CoordinationStore, host_id: str,
               prefix: str = "dead") -> None:
    """A replaced/recovered host re-admits itself by clearing its marker
    (the next supervisor round then counts it healthy again)."""
    store.delete(f"{prefix}/{host_id}")


# ------------------------------------------------------ host advertisements

# pod-side analogue of the serving fleet's ``fleet/engines`` advertisements
# (inference/fleet.py): each host publishes its per-process observability
# counters so any host (or an external scraper) gets ONE cross-host view
# through the store instead of N per-process /metrics endpoints
POD_HOSTS_PREFIX = "pod/hosts"


_PROCESS_SRC: Optional[str] = None


def process_src() -> str:
    """Machine-unique PROCESS identity for advertisement dedup keys.  A
    bare pid is not unique across the machines of a real pod (containers
    commonly all run as pid 1, which would silently merge distinct hosts'
    counters in a rollup), so the hostname rides along; simulated hosts
    (threads of one process) still share one src and dedup to a single
    count, which is the point of the key.  Cached — it sits on every
    heartbeat/advertisement path and cannot change within a process."""
    global _PROCESS_SRC
    if _PROCESS_SRC is None:
        import socket

        _PROCESS_SRC = f"{socket.gethostname()}.{os.getpid()}"
    return _PROCESS_SRC


def advertise_host(store: CoordinationStore, host_id: str, generation: int,
                   monitor=None, prefix: str = POD_HOSTS_PREFIX,
                   **attrs) -> Dict:
    """Publish this host's observability snapshot under
    ``pod/hosts/<host_id>``: the flight-recorder ring's drop counter and
    the monitor ring's drop counter (both per-process), plus caller
    attrs (``step=`` etc.).  The ``*_src`` ids scope each counter to its
    process-level object — the tracer ring is a process singleton and
    simulated hosts (threads) share a process, so a rollup summing N
    identical advertisements would overcount N-fold without them (same
    contract as the fleet advertisements)."""
    from ..observability.trace import get_tracer

    src = process_src()
    ad = {
        "host_id": str(host_id),
        "generation": int(generation),
        "t": store.now(),
        "flight_dropped": int(get_tracer().recorder.dropped),
        "flight_src": src,
        "monitor_dropped": int(getattr(monitor, "dropped_events", 0) or 0),
        "monitor_src": f"{src}.{id(monitor)}",
        "attrs": attrs,
    }
    store.put(f"{prefix}/{host_id}", ad)
    return ad


def host_advertisements(store: CoordinationStore,
                        prefix: str = POD_HOSTS_PREFIX) -> Dict[str, Dict]:
    """host_id -> newest advertisement (the cross-host /metrics view)."""
    out: Dict[str, Dict] = {}
    for name in store.list(prefix):
        doc = store.get(f"{prefix}/{name}")
        if doc is not None:
            out[str(doc.get("host_id", name))] = doc
    return out


def dedup_drop_totals(ads: Dict[str, Dict]) -> Tuple[int, int]:
    """Fold advertisements into (flight_dropped, monitor_dropped) totals,
    deduplicated by source id: advertisers sharing a process ring (the
    ``*_src`` keys) are counted once, not once per advertisement.  The ONE
    implementation of the fold — the pod watchdog rollup and the fleet
    router's gauge rollup (inference/fleet.py) both call it, so the dedup
    contract cannot drift between tiers."""
    flight_by_src: Dict[str, int] = {}
    monitor_by_src: Dict[str, int] = {}
    for key, ad in ads.items():
        # max, not last-iterated: advertisers sharing a src write on
        # independent cadences, and the counters are monotonic — a stale
        # advertisement must never mask a fresher, higher count (listing
        # order is arbitrary)
        fsrc = str(ad.get("flight_src", key))
        flight_by_src[fsrc] = max(flight_by_src.get(fsrc, 0),
                                  int(ad.get("flight_dropped", 0)))
        msrc = str(ad.get("monitor_src", key))
        monitor_by_src[msrc] = max(monitor_by_src.get(msrc, 0),
                                   int(ad.get("monitor_dropped", 0)))
    return sum(flight_by_src.values()), sum(monitor_by_src.values())


def rollup_host_gauges(store: CoordinationStore, monitor, tick: int = 0,
                       prefix: str = POD_HOSTS_PREFIX,
                       max_age_s: Optional[float] = None) -> Dict[str, float]:
    """Fold every host's advertisement into pod-scope monitor gauges
    (``pod/flight_dropped_total``, ``pod/monitor_dropped_total``,
    ``pod/hosts_advertised``) — deduplicated by source id, so hosts
    sharing a process ring are counted once.  ``max_age_s`` drops
    advertisements older than that on the store clock (advertisements are
    never deleted, so without an age bound a permanently dead host's last
    snapshot would inflate the gauges forever — the watchdog passes its
    own dead-by-lease threshold).  Returns the gauge values; writes them
    when ``monitor`` is not None (they then reach the Prometheus
    exposition like every other gauge)."""
    ads = host_advertisements(store, prefix=prefix)
    if max_age_s is not None:
        now = store.now()
        ads = {h: ad for h, ad in ads.items()
               if now - float(ad.get("t", 0.0)) <= max_age_s}
    flight, monitor_drops = dedup_drop_totals(ads)
    gauges = {
        "pod/flight_dropped_total": float(flight),
        "pod/monitor_dropped_total": float(monitor_drops),
        "pod/hosts_advertised": float(len(ads)),
    }
    if monitor is not None:
        monitor.write_events([(name, val, tick)
                              for name, val in sorted(gauges.items())])
    return gauges


# ----------------------------------------------------- residency digests

def publish_residency(store: CoordinationStore, owner_id: str, digest,
                      prefix: str = "residency", **attrs) -> Dict:
    """Publish a compact prefix-residency digest under
    ``<prefix>/<owner_id>``: ``[[chain_key, tier], ...]`` pairs (tier 0 =
    device-resident/hot, 1 = host-tier/demoted), MRU first.  Chain keys
    are content-derived (``inference/prefix_cache.chain_keys``), so any
    reader that can hash the same token chunks can match against the
    digest without sharing Python objects with the owner — the serving
    fleet router uses this (prefix ``fleet/residency``) to route
    shared-prefix requests to the engine already holding the prefix
    (docs/FLEET.md "Prefix residency routing")."""
    doc = {"owner_id": str(owner_id), "t": store.now(),
           "digest": [[int(k), int(t)] for k, t in digest],
           "attrs": attrs}
    store.put(f"{prefix}/{owner_id}", doc)
    return doc


def read_residency(store: CoordinationStore,
                   prefix: str = "residency") -> Dict[str, Dict]:
    """owner_id -> newest residency digest document under ``prefix``."""
    out: Dict[str, Dict] = {}
    for name in store.list(prefix):
        doc = store.get(f"{prefix}/{name}")
        if doc is not None:
            out[str(doc.get("owner_id", name))] = doc
    return out


# ------------------------------------------------------------ trace segments

def append_trace_segment(store: CoordinationStore, owner_id: str,
                         spans: List[Dict], prefix: str = "trace",
                         max_spans: int = 2048,
                         attrs: Optional[Dict] = None) -> Dict:
    """CAS-append completed-span records under ``<prefix>/<owner_id>``
    (the serving fleet uses ``fleet/trace/<engine>`` — docs/FLEET.md
    keyspace table).  The document is size-capped like the request
    journal: past ``max_spans`` the OLDEST records drop and the ``dropped``
    counter grows, so one chatty process can never grow its store document
    unboundedly — truncation is visible, never silent.

    Every append stamps a fresh **clock anchor** pairing the writing
    process's ``time.monotonic()`` with ``time.time()``: span records
    stamp monotonic t0s (immune to wall steps but process-local), and the
    anchor is what lets ``observability/trace_assembly.py`` place every
    process's spans on ONE shared epoch timeline with per-process skew
    correction.  The write retries through :class:`StoreRetryPolicy`
    (single writer per owner in practice — contention can only be a
    dying predecessor's last append), mirroring
    ``record_dead``/``bump_generation``."""
    key = f"{prefix}/{owner_id}"

    def attempt():
        cur = store.get(key)
        merged = list((cur or {}).get("spans") or ())
        merged.extend(spans)
        dropped = int((cur or {}).get("dropped") or 0)
        if len(merged) > int(max_spans):
            dropped += len(merged) - int(max_spans)
            merged = merged[-int(max_spans):]
        doc = {"owner_id": str(owner_id),
               "anchor": {"mono": time.monotonic(), "epoch": time.time()},
               "spans": merged,
               "dropped": dropped,
               "attrs": dict(attrs or {}),
               "t": store.now()}
        if store.compare_and_swap(key, cur, doc):
            return doc
        return StoreRetryPolicy.RETRY

    return default_retry_policy().run(
        f"append_trace_segment({owner_id!r})", attempt)


def read_trace_segments(store: CoordinationStore,
                        prefix: str = "trace") -> Dict[str, Dict]:
    """owner_id -> newest trace-segment document under ``prefix`` — the
    input ``trace_assembly.assemble_fleet_trace`` merges."""
    out: Dict[str, Dict] = {}
    for name in store.list(prefix):
        doc = store.get(f"{prefix}/{name}")
        if doc is not None:
            out[str(doc.get("owner_id", name))] = doc
    return out


# ----------------------------------------------------------------- channels
#
# Store-mediated message channels: how a fleet router and a MEMBER DAEMON
# in another OS process exchange assignments, results and control verbs
# with no coupling beyond the store (docs/FLEET.md "Member daemons").  One
# channel is one size-capped document; every payload gets a CAS-assigned,
# strictly increasing sequence number, so a consumer detects capped-out
# drops as sequence gaps (truncation is visible, never silent — the same
# contract as the trace segments and the request journal).  Consumption is
# a CAS truncation: of N racing consumers (a deposed router and its
# successor both draining a results channel), exactly one claims each item.

def channel_append(store: CoordinationStore, key: str, payload: Dict,
                   owner_id: str, max_items: int = 256,
                   max_bytes: int = 262144) -> int:
    """Append ``payload`` to the channel at ``key`` and return its
    sequence number.  Past ``max_items`` entries (or ``max_bytes`` of
    serialized items) the OLDEST entries drop and the ``dropped`` counter
    grows — one wedged consumer can never grow a producer's document
    unboundedly.  Retries through :class:`StoreRetryPolicy`, mirroring
    :func:`append_trace_segment`."""
    maybe_fire(SITE_FLEET_CHANNEL, key=key)

    def attempt():
        cur = store.get(key)
        items = [list(e) for e in ((cur or {}).get("items") or ())]
        seq = int((cur or {}).get("seq") or 0) + 1
        items.append([seq, payload])
        dropped = int((cur or {}).get("dropped") or 0)
        if len(items) > int(max_items):
            dropped += len(items) - int(max_items)
            items = items[-int(max_items):]
        while len(items) > 1 and len(json.dumps(items)) > int(max_bytes):
            items.pop(0)
            dropped += 1
        doc = {"owner": str(owner_id), "seq": seq, "items": items,
               "dropped": dropped, "t": store.now()}
        if store.compare_and_swap(key, cur, doc):
            return seq
        return StoreRetryPolicy.RETRY

    return default_retry_policy().run(f"channel_append({key!r})", attempt)


def channel_consume(store: CoordinationStore, key: str,
                    consumer_id: str) -> List[Tuple[int, Dict]]:
    """Claim every pending ``(seq, payload)`` on the channel at ``key``
    (ascending seq) and truncate it — atomically, via CAS: a concurrent
    producer append or a RACING CONSUMER makes the truncation lose, and
    the loop re-reads.  Each item is claimed by exactly one consumer;
    ``consumer_id`` is stamped on the truncated document so an operator
    can see who drained it last."""
    def attempt():
        cur = store.get(key)
        if cur is None or not cur.get("items"):
            return []
        new = {"owner": cur.get("owner"), "seq": int(cur.get("seq") or 0),
               "items": [], "dropped": int(cur.get("dropped") or 0),
               "consumer": str(consumer_id), "t": store.now()}
        if store.compare_and_swap(key, cur, new):
            return [(int(s), p) for s, p in cur["items"]]
        return StoreRetryPolicy.RETRY

    return default_retry_policy().run(f"channel_consume({key!r})", attempt)


def channel_stats(store: CoordinationStore, key: str) -> Dict[str, int]:
    """``{"seq", "pending", "dropped"}`` for the channel at ``key`` —
    the drop accounting the fleet gauges roll up (all zero when the
    channel was never written)."""
    doc = store.get(key) or {}
    return {"seq": int(doc.get("seq") or 0),
            "pending": len(doc.get("items") or ()),
            "dropped": int(doc.get("dropped") or 0)}


# --------------------------------------------------------------- generation

def read_generation(store: CoordinationStore, key: str = "generation") -> int:
    doc = store.get(key)
    return int(doc["generation"]) if doc else 0


def bump_generation(store: CoordinationStore, key: str = "generation") -> int:
    """Advance the generation and return the value THIS caller committed.
    A retried CAS (:class:`StoreRetryPolicy`): each concurrent bumper
    wins exactly one distinct round — two supervisor processes racing
    (or a deposed coordinator racing its successor) can no longer lose
    an update or tear the counter.  The returned value is strictly
    monotonic across all winners."""
    def attempt():
        doc = store.get(key)
        gen = int(doc["generation"]) if doc else 0
        if store.compare_and_swap(key, doc,
                                  {"generation": gen + 1,
                                   "t": store.now()}):
            return gen + 1
        return StoreRetryPolicy.RETRY

    return default_retry_policy().run(f"bump_generation({key!r})", attempt)


# ----------------------------------------------------- coordinator election

@dataclass(frozen=True)
class CoordinatorLease:
    """The coordinator lock document: who leads, under which term, renewed
    when.  ``term`` increments on every leadership CHANGE (never on a
    renewal), so any two leaders are ordered and a fenced-out old leader
    can recognize its own deposition."""
    leader_id: str
    term: int
    t: float               # store-clock stamp of the newest acquire/renewal
    lease_s: float

    def age(self, now: float) -> float:
        return max(0.0, now - self.t)

    def expired(self, now: float) -> bool:
        return self.age(now) >= self.lease_s


def _coordinator_doc(doc: Optional[Dict]) -> Optional[CoordinatorLease]:
    if doc is None:
        return None
    return CoordinatorLease(
        leader_id=doc["leader_id"], term=int(doc["term"]),
        t=float(doc["t"]), lease_s=float(doc["lease_s"]))


def read_coordinator(store: CoordinationStore,
                     key: str = "coordinator") -> Optional[CoordinatorLease]:
    return _coordinator_doc(store.get(key))


def elect_coordinator(store: CoordinationStore, candidate_id: str,
                      lease_s: float,
                      key: str = "coordinator") -> Optional[CoordinatorLease]:
    """One election round for ``candidate_id``: returns the lease it holds
    after this call, or ``None`` when someone else leads.

    Exactly one CAS attempt — callers poll this every scheduler round, so
    a lost race just retries on the next poll:

    - vacant key  -> acquire at term 1;
    - own lease   -> renew (same term, fresh stamp);
    - LAPSED peer -> take over at ``term + 1`` (re-elect on lease lapse);
    - live peer   -> ``None`` (a healthy leader is never stolen from).

    The CAS is what makes a split-brain impossible: two standbys seeing
    the same lapsed lease both attempt ``term + 1``, and the store admits
    exactly one — the loser observes the new document and stands down.
    """
    doc = store.get(key)
    now = store.now()
    if doc is None:
        new = {"leader_id": candidate_id, "term": 1, "t": now,
               "lease_s": float(lease_s)}
        return _coordinator_doc(new) \
            if store.compare_and_swap(key, None, new) else None
    cur = _coordinator_doc(doc)
    if cur.leader_id == candidate_id:
        new = {"leader_id": candidate_id, "term": cur.term, "t": now,
               "lease_s": float(lease_s)}
        # a failed renewal means a standby deposed us between our beats —
        # report not-leader so the caller stops driving immediately
        return _coordinator_doc(new) \
            if store.compare_and_swap(key, doc, new) else None
    if cur.expired(now):
        new = {"leader_id": candidate_id, "term": cur.term + 1, "t": now,
               "lease_s": float(lease_s)}
        if store.compare_and_swap(key, doc, new):
            logger.info("coordinator election: %r takes term %d from "
                        "lapsed %r (lease age %.3fs)", candidate_id,
                        cur.term + 1, cur.leader_id, cur.age(now))
            return _coordinator_doc(new)
    return None


def resign_coordinator(store: CoordinationStore, candidate_id: str,
                       key: str = "coordinator") -> bool:
    """Voluntarily lapse the candidate's own lease (planned hand-off: the
    next ``elect_coordinator`` poll by any standby wins immediately
    instead of waiting out the lease).  CAS-guarded so resigning can never
    clobber a successor that already took over."""
    doc = store.get(key)
    cur = _coordinator_doc(doc)
    if cur is None or cur.leader_id != candidate_id:
        return False
    lapsed = {"leader_id": candidate_id, "term": cur.term,
              "t": cur.t - cur.lease_s, "lease_s": cur.lease_s}
    return store.compare_and_swap(key, doc, lapsed)


# --------------------------------------------------------------- rendezvous

def rendezvous(store: CoordinationStore, host_id: str, generation: int,
               expected_hosts: List[str], timeout_s: float = 60.0,
               poll_s: float = 0.02) -> List[str]:
    """Register for ``generation`` and wait until every expected host has.

    Returns the sorted member list (rank = index of ``host_id`` in it).
    Registration is idempotent; a stale registration from a previous
    generation is invisible (records are keyed by generation).  Raises
    :class:`PodRendezvousTimeout` with the missing hosts after
    ``timeout_s`` — the supervisor treats that as a failed round and
    re-plans against the hosts that did show up.
    """
    maybe_fire(SITE_POD_RENDEZVOUS, host=host_id, generation=generation)
    store.put(f"rendezvous/gen{generation}/{host_id}",
              {"host_id": host_id, "t": store.now()})
    expected = sorted(set(expected_hosts))
    deadline = time.monotonic() + timeout_s
    while True:
        present = set(store.list(f"rendezvous/gen{generation}"))
        if all(h in present for h in expected):
            return expected
        if time.monotonic() >= deadline:
            missing = sorted(set(expected) - present)
            raise PodRendezvousTimeout(
                f"rendezvous gen{generation}: host {host_id!r} waited "
                f"{timeout_s:.1f}s; missing {missing} "
                f"(present: {sorted(present)})")
        time.sleep(poll_s)


# ----------------------------------------------------------- the watchdog

class HeartbeatWatchdog:
    """Daemon thread that renews this host's lease and scans its peers.

    The first peer whose lease lapses ``miss_limit`` periods (or that never
    beat at all once ``grace_beats`` of our own renewals have happened) is
    recorded in the store (:func:`record_dead`) and reported through
    ``on_peer_dead(host_id)``.  The default action exits the process with
    :data:`RC_POD_PEER_LOST` via ``os._exit`` — the same rationale as the
    hang watchdog: this thread may be the only one NOT wedged inside a
    native collective, so a clean exception cannot be relied on to
    propagate.  Tests pass an ``on_peer_dead`` observer instead.

    One watchdog per host per generation; scanning stops after the first
    detection (``dead`` keeps the list) so a cascade of expiring peers —
    everyone else exiting after the same detection — produces one exit
    cause, not ``n`` races.

    ``renew=False`` makes a scanning-only watchdog: the other ranks of a
    host whose ``LOCAL_RANK`` 0 renews the lease.  It writes nothing to the
    store but dead markers, and counts its rounds in ``beats`` so the
    never-beat grace holds for it too.
    """

    def __init__(self, store: CoordinationStore, host_id: str,
                 generation: int, peers: List[str], lease_s: float = 5.0,
                 miss_limit: int = 3,
                 on_peer_dead: Optional[Callable[[str], None]] = None,
                 monitor=None, grace_beats: int = 3,
                 renew_s: Optional[float] = None, advertise: bool = True,
                 store_fail_grace: int = 3, renew: bool = True):
        self.store = store
        self.renew = bool(renew)
        self.host_id = host_id
        self.generation = int(generation)
        self.peers = [p for p in peers if p != host_id]
        self.lease_s = float(lease_s)
        self.miss_limit = int(miss_limit)
        self.on_peer_dead = on_peer_dead
        self.monitor = monitor
        self.grace_beats = int(grace_beats)
        # wall-clock renew cadence; defaults to a third of the lease.  Kept
        # separate so stores with an injected (test) clock can renew on real
        # time while lease expiry is judged on the store clock.
        self.renew_s = (float(renew_s) if renew_s is not None
                        else max(self.lease_s / 3.0, 1e-3))
        # publish a pod/hosts/<host> observability advertisement with every
        # renewal (flight-recorder + monitor drop counters; see
        # advertise_host) so the pod has one cross-host /metrics view
        self.advertise = bool(advertise)
        self._last_rollup_t: Optional[float] = None   # store clock
        self._last_advert_t: Optional[float] = None   # store clock
        self.dead: List[str] = []
        self.beats = 0
        # store-failure escalation (docs/FLEET.md "Store brownouts and
        # partitions"): consecutive renew/scan rounds that failed on the
        # STORE (not on a peer).  Below `store_fail_grace` it is a logged
        # brownout; at the grace it escalates to the
        # pod/store_unreachable gauge + a flight-recorder note.  Peers
        # are NEVER declared dead from a failed scan — "my store view is
        # broken" and "that host stopped beating" are different facts —
        # and after a heal one clean scan runs declaration-free (the
        # peers' beats may have been dark through the same partition).
        self.store_fail_grace = int(store_fail_grace)
        self.store_fail_streak = 0
        self.store_failures_total = 0
        self.store_unreachable = False
        self._attrs: Dict = {}
        self._started_at: Optional[float] = None   # store clock, at start()
        # beat_once() runs on BOTH the renew daemon and the training step
        # loop (piggybacked attrs); `beats += 1` and the advert rate-limit
        # check-then-set are read-modify-write, so without the lock two
        # concurrent renewals lose a beat — and `beats` gates the _scan
        # grace window, so lost beats extend the dead-host grace period
        self._beat_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def set_attrs(self, **attrs) -> None:
        """Attach attributes to the next beats (e.g. ``step=N`` so peers
        and the supervisor can watch progress through the store)."""
        self._attrs.update(attrs)

    def start(self) -> "HeartbeatWatchdog":
        if self.renew:   # the first lease lands before start() returns
            beat(self.store, self.host_id, self.generation, self.lease_s,
                 **self._attrs)
        with self._beat_lock:
            self.beats = 1
        self._started_at = self.store.now()
        self._thread = threading.Thread(
            target=self._loop, name=f"pod-heartbeat[{self.host_id}]",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def beat_once(self) -> None:
        """Renew synchronously (the thread also renews on its own cadence;
        call this from the step loop to piggyback fresh attrs)."""
        if self.renew:
            beat(self.store, self.host_id, self.generation, self.lease_s,
                 **self._attrs)
        should_advertise = False
        with self._beat_lock:
            self.beats += 1
            if self.advertise and self.renew:
                # once per lease, not per renewal: the advertisement's only
                # consumer (rollup_host_gauges) is itself rate-limited to
                # once per lease, so renewing it 3x as often just doubles
                # the store's write volume for an identical cross-host view
                now = self.store.now()
                if self._last_advert_t is None \
                        or now - self._last_advert_t >= self.lease_s:
                    self._last_advert_t = now
                    should_advertise = True
        if should_advertise:   # store write outside the lock
            advertise_host(self.store, self.host_id, self.generation,
                           monitor=self.monitor, **self._attrs)

    def _loop(self) -> None:
        # renew well inside the lease so one slow write never costs it
        while not self._stop.wait(self.renew_s):
            self.tick_once()

    def tick_once(self) -> None:
        """One renew+scan round with the store-failure escalation —
        factored off the daemon loop so deterministic tests (and
        cooperative harnesses) can drive it without threads."""
        try:
            healed = self.store_fail_streak > 0
            self.beat_once()
            if not self.dead:
                # the first clean scan after a heal observes but does
                # not declare: peers whose beats were dark through the
                # same partition get one round to land a fresh lease
                self._scan(declare=not healed)
            self._note_store_ok(healed)
        except (StoreUnavailable, OSError, PodCoordinationError) as e:
            # the STORE failed this round, not a peer: count toward the
            # escalation grace, never toward any dead declaration
            self._note_store_failure(e)
        except Exception as e:   # the watchdog must outlive flaky storage
            logger.warning("pod heartbeat: %s: %s", type(e).__name__, e)

    def _note_store_ok(self, healed: bool) -> None:
        if not healed and not self.store_unreachable:
            return
        if healed:
            logger.info(
                "pod heartbeat[%s]: store reachable again after %d "
                "failed round(s)", self.host_id, self.store_fail_streak)
        self.store_fail_streak = 0
        if self.store_unreachable:
            self.store_unreachable = False
            if self.monitor is not None:
                self.monitor.write_events([
                    ("pod/store_unreachable", 0.0, self.beats)])

    def _note_store_failure(self, err: BaseException) -> None:
        self.store_fail_streak += 1
        self.store_failures_total += 1
        logger.warning(
            "pod heartbeat[%s]: store op failed (%s: %s) — streak %d/%d; "
            "no peer is declared dead from a failed scan", self.host_id,
            type(err).__name__, err, self.store_fail_streak,
            self.store_fail_grace)
        if self.store_fail_streak < self.store_fail_grace \
                or self.store_unreachable:
            return
        self.store_unreachable = True
        if self.monitor is not None:
            self.monitor.write_events([
                ("pod/store_unreachable", 1.0, self.beats)])
        from ..observability.trace import trace_count

        # flight-recorder note: the escalation shows up in crash dumps
        # and trace exports even when no scraper watches the gauge
        trace_count("pod.store_unreachable", 1.0, host=self.host_id,
                    streak=self.store_fail_streak)
        logger.error(
            "pod heartbeat[%s]: %d consecutive store failures — this "
            "host's STORE VIEW is unreachable (escalating the "
            "pod/store_unreachable gauge); peer liveness is unknown, "
            "not absent", self.host_id, self.store_fail_streak)

    def _scan(self, declare: bool = True) -> None:
        # the "never beat at all" check needs BOTH grace gates: our own
        # renewal count AND miss_limit lease periods of STORE-CLOCK time
        # since start() — a peer still inside device init (its watchdog not
        # started yet) must get the same allowance a lease expiry would,
        # or a fast starter would durably dead-mark a healthy slow one
        elapsed = (self.store.now() - self._started_at
                   if self._started_at is not None else 0.0)
        expected = (self.peers
                    if (self.beats >= self.grace_beats
                        and elapsed >= self.miss_limit * self.lease_s)
                    else None)
        dead = dead_hosts(self.store, self.generation, self.miss_limit,
                          expected=expected)
        dead = [h for h in dead if h in self.peers]
        if self.monitor is not None:
            # emitted on the detection scan too: the drop from full
            # membership is exactly the transition this gauge exists for
            self.monitor.write_events([
                ("pod/live_hosts",
                 float(len(self.peers) + 1 - len(dead)), self.beats),
                ("pod/generation", float(self.generation), self.beats)])
            if self.advertise:
                # fold every host's pod/hosts advertisement into pod-scope
                # gauges so THIS host's /metrics shows the cross-host view
                # (staleness bound = our own dead-by-lease threshold, so a
                # lost host ages out of the rollup when it ages out of the
                # pod).  Rate-limited to once per lease on the store clock:
                # the rollup reads every host's advertisement, and N hosts
                # doing that every scan would put O(N^2) reads per renew
                # interval on the store for byte-identical gauge values.
                now = self.store.now()
                if self._last_rollup_t is None \
                        or now - self._last_rollup_t >= self.lease_s:
                    self._last_rollup_t = now
                    rollup_host_gauges(
                        self.store, self.monitor, tick=self.beats,
                        max_age_s=self.miss_limit * self.lease_s)
        if not dead:
            return
        if not declare:
            # post-heal observation round: the peers' beats may have been
            # dark through the SAME partition we just recovered from, so
            # what looks lapsed gets one renew interval to land a fresh
            # lease before any durable declaration
            logger.warning(
                "pod heartbeat[%s]: host(s) %s look lapsed on the first "
                "scan after a store heal — withholding declaration for "
                "one round", self.host_id, dead)
            return
        for host in dead:
            record_dead(self.store, host, self.generation, self.host_id)
        # published only once the markers are durable: a step loop that
        # sees `dead` may exit the process at once, and the next round
        # must find the markers to leave the dead host out
        self.dead = dead
        logger.error(
            "pod heartbeat: host(s) %s missed %d lease(s) of %.3fs in "
            "generation %d — declaring dead; peers should exit %d and let "
            "the pod supervisor re-form at the healthy slice",
            dead, self.miss_limit, self.lease_s, self.generation,
            RC_POD_PEER_LOST)
        if self.monitor is not None:
            self.monitor.write_events([
                ("pod/dead_hosts", float(len(dead)), self.beats)])
        if self.on_peer_dead is not None:
            self.on_peer_dead(dead[0])
        else:   # pragma: no cover - exercised only in real pod deployments
            os._exit(RC_POD_PEER_LOST)
