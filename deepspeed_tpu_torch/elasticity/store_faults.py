"""Store fault injection: deterministic brownouts, partitions, torn writes
(counterpart of ``deepspeed_tpu/elasticity/store_faults.py``, copied: it
imports no framework).

:class:`FaultyStore` wraps ANY :class:`~.coordination.CoordinationStore`
with seeded, per-op-class fault programs:

- **latency** — a real ``time.sleep`` before the op;
- **error** — raise :class:`InjectedStoreFault` (an ``OSError``:
  transient, what :class:`~.coordination.StoreRetryPolicy` absorbs);
- **timeout** — optional delay, then :class:`InjectedStoreTimeout`;
- **stale_read** — serve a PREVIOUSLY observed document for the key;
- **torn_write** — leave a truncated document at the key by writing the
  file directly (no tmp + rename), then raise: what
  ``FileCoordinationStore.get``'s quarantine recovers from;
- **blackout** — raise :class:`~.coordination.StoreUnavailable` for a
  store-clock window (``from_t``/``until_t``), or while
  :attr:`FaultyStore.partitioned` is set.

Faults are PER CLIENT: each process wraps the shared backend in its own
proxy.  Rules carry their own seeded PRNG (``random.Random(seed)``, as the
JAX package's), so one seed and one op sequence fire the same faults in
both packages.  :func:`maybe_faulty` wraps a store when
:data:`STORE_FAULTS_ENV` holds a JSON rule list; every proxied op also
fires :func:`~..resilience.fault_injection.maybe_fire` at a ``store.*``
site.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..resilience.fault_injection import maybe_fire
from ..utils.logging import logger
from .coordination import CoordinationStore, StoreUnavailable

__all__ = ["FaultyStore", "InjectedStoreFault", "InjectedStoreTimeout",
           "OP_CLASSES", "STORE_FAULTS_ENV", "SITE_STORE_CAS",
           "SITE_STORE_COMPARE_DELETE", "SITE_STORE_DELETE",
           "SITE_STORE_GET", "SITE_STORE_LIST", "SITE_STORE_PUT",
           "StoreFaultRule", "maybe_faulty", "rules_from_env"]

# env var holding a JSON list of rule specs (see StoreFaultRule.from_spec)
# — the store-op analogue of resilience/fault_injection.FAULTS_ENV
STORE_FAULTS_ENV = "DS_TPU_STORE_FAULTS"

# generic-injector sites (docs/RESILIENCE.md registry): every proxied op
# class fires one, so DS_TPU_FAULTS rules can hit store traffic without
# a FaultyStore in the stack
SITE_STORE_GET = "store.get"
SITE_STORE_PUT = "store.put"
SITE_STORE_CAS = "store.cas"
SITE_STORE_DELETE = "store.delete"
SITE_STORE_COMPARE_DELETE = "store.compare_delete"
SITE_STORE_LIST = "store.list"

# op classes a rule can target.  compare_and_swap is "cas" and
# compare_and_delete is "compare_delete"; clear_tombstone rides the
# "delete" class (it is a removal on the same write path).
OP_CLASSES = ("get", "put", "cas", "delete", "compare_delete", "list")

_OP_SITES = {
    "get": SITE_STORE_GET,
    "put": SITE_STORE_PUT,
    "cas": SITE_STORE_CAS,
    "delete": SITE_STORE_DELETE,
    "compare_delete": SITE_STORE_COMPARE_DELETE,
    "list": SITE_STORE_LIST,
}

KINDS = ("latency", "error", "timeout", "stale_read", "torn_write",
         "blackout")


class InjectedStoreFault(OSError):
    """A deterministic injected store failure.  An ``OSError`` on
    purpose: it is TRANSIENT by contract — the same class of failure a
    real flaky backend raises — and every client-side retry discipline
    (:class:`~.coordination.StoreRetryPolicy`) absorbs it.  Contrast
    :class:`~.coordination.StoreUnavailable`, which means "stop
    retrying and degrade"."""


class InjectedStoreTimeout(InjectedStoreFault):
    """An injected operation timeout (optionally after a real delay)."""


@dataclass
class StoreFaultRule:
    """One seeded fault program over an op class (see module docstring
    for the kinds).  Trigger selection mirrors
    ``resilience/fault_injection.FaultRule``: ``at_call`` (1-based Nth
    MATCHING call), ``every`` (every Nth), ``probability`` (per-rule
    seeded PRNG), or — with none of those — every matching call, which
    is what windowed blackouts and flat latency programs want.
    ``max_fires`` caps total fires; ``key_prefix`` scopes to a key
    namespace; ``client`` scopes to one proxy's client id;
    ``from_t``/``until_t`` gate on the STORE clock (injectable in
    soaks, so windows land at exact rounds)."""
    ops: Tuple[str, ...] = OP_CLASSES
    kind: str = "error"
    key_prefix: Optional[str] = None
    client: Optional[str] = None
    at_call: Optional[int] = None
    every: Optional[int] = None
    probability: Optional[float] = None
    max_fires: Optional[int] = None
    delay_s: float = 0.0
    from_t: Optional[float] = None
    until_t: Optional[float] = None
    seed: int = 0
    calls: int = field(default=0, init=False)
    fires: int = field(default=0, init=False)

    def __post_init__(self):
        if isinstance(self.ops, str):
            self.ops = OP_CLASSES if self.ops == "*" else (self.ops,)
        self.ops = tuple(self.ops)
        for op in self.ops:
            if op not in OP_CLASSES:
                raise ValueError(
                    f"store fault rule: unknown op {op!r} "
                    f"(one of {OP_CLASSES})")
        if self.kind not in KINDS:
            raise ValueError(
                f"store fault rule: unknown kind {self.kind!r} "
                f"(one of {KINDS})")
        self._rng = random.Random(self.seed)

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "StoreFaultRule":
        """Build a rule from one JSON spec dict (the DS_TPU_STORE_FAULTS
        payload is a list of these)."""
        known = {"ops", "kind", "key_prefix", "client", "at_call", "every",
                 "probability", "max_fires", "delay_s", "from_t", "until_t",
                 "seed"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"store fault rule: unknown field(s) {sorted(unknown)}")
        return cls(**spec)

    def matches(self, op: str, key: str, client: str, now: float) -> bool:
        if op not in self.ops:
            return False
        if self.key_prefix is not None \
                and not key.startswith(self.key_prefix):
            return False
        if self.client is not None and self.client != client:
            return False
        if self.from_t is not None and now < self.from_t:
            return False
        if self.until_t is not None and now >= self.until_t:
            return False
        return True

    def triggers(self) -> bool:
        """Count one matching call and decide whether this rule fires on
        it — deterministic per (seed, call sequence)."""
        self.calls += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.at_call is not None:
            fire = self.calls == int(self.at_call)
        elif self.every is not None:
            fire = self.calls % int(self.every) == 0
        elif self.probability is not None:
            fire = self._rng.random() < float(self.probability)
        else:
            fire = True
        if fire:
            self.fires += 1
        return fire


class _Stale:
    """Sentinel carrying a stale document past the real read."""
    __slots__ = ("doc",)

    def __init__(self, doc):
        self.doc = doc


class FaultyStore(CoordinationStore):
    """Per-client fault-injecting proxy over any coordination store.

    Delegates every op to ``inner`` after running the fault program
    (see the module docstring).  Unknown attributes delegate too, so
    backend surface like ``cas_contended_total``, ``corrupt_docs_total``
    or ``_path`` stays reachable through the proxy.  Per-op wall
    latencies are recorded in bounded windows
    (:meth:`op_latency_percentiles`) — the measurement surface of
    ``serve_bench --store_latency_ms``."""

    def __init__(self, inner: CoordinationStore, client: str = "client",
                 rules: Optional[List[StoreFaultRule]] = None,
                 latency_window: int = 4096):
        self.inner = inner
        self.client = str(client)
        self.rules: List[StoreFaultRule] = list(rules or ())
        # manual asymmetric-partition toggle: while set, EVERY op raises
        # StoreUnavailable for this client only — the soak's scheduled
        # partitions flip it at exact rounds
        self.partitioned = False
        self.ops_total = 0
        self.faults_total = 0
        self.faults_by_kind: Dict[str, int] = {}
        self._lat: Dict[str, deque] = {
            op: deque(maxlen=int(latency_window)) for op in OP_CLASSES}
        # key -> up to the last two DISTINCT observed documents (oldest
        # first): what a stale read serves
        self._seen: Dict[str, List[Optional[Dict]]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------ fault program

    def _count(self, kind: str) -> None:
        with self._lock:
            self.faults_total += 1
            self.faults_by_kind[kind] = self.faults_by_kind.get(kind, 0) + 1

    def _apply(self, op: str, key: str,
               value: Optional[Dict] = None) -> Optional[_Stale]:
        """Run the fault program for one op.  Returns a :class:`_Stale`
        sentinel (get only) when a stale read replaces the real one;
        raises for error/timeout/blackout kinds; sleeps for latency."""
        maybe_fire(_OP_SITES[op], key=key, client=self.client)
        with self._lock:
            self.ops_total += 1
        if self.partitioned:
            self._count("blackout")
            raise StoreUnavailable(
                f"store blackout: client {self.client!r} is partitioned "
                f"from the store ({op} {key!r})")
        now = self.inner.now()
        stale: Optional[_Stale] = None
        for rule in self.rules:
            if not rule.matches(op, key, self.client, now):
                continue
            if not rule.triggers():
                continue
            kind = rule.kind
            if kind == "latency":
                if rule.delay_s > 0:
                    time.sleep(rule.delay_s)
                continue   # latency composes with any later rule
            self._count(kind)
            if kind == "error":
                raise InjectedStoreFault(
                    f"injected store fault: {op} {key!r} "
                    f"(client {self.client!r})")
            if kind == "timeout":
                if rule.delay_s > 0:
                    time.sleep(rule.delay_s)
                raise InjectedStoreTimeout(
                    f"injected store timeout: {op} {key!r} "
                    f"(client {self.client!r})")
            if kind == "blackout":
                raise StoreUnavailable(
                    f"store blackout window: {op} {key!r} "
                    f"(client {self.client!r}, t={now:.3f})")
            if kind == "stale_read" and op == "get":
                hist = self._seen.get(key) or []
                stale = _Stale(hist[0] if hist else None)
            if kind == "torn_write" and op in ("put", "cas") \
                    and value is not None:
                self._tear(key, value)
                raise InjectedStoreFault(
                    f"injected torn write: {op} {key!r} crashed between "
                    f"lock and rename (client {self.client!r})")
        return stale

    def _tear(self, key: str, value: Dict) -> None:
        """Leave a truncated document at ``key`` by writing the backing
        file DIRECTLY — no tmp, no atomic rename: the torn state a
        writer crash mid-write leaves on storage without the
        write-to-tmp discipline.  File backends only (a backend without
        ``_path`` just gets the transient error)."""
        path_fn = getattr(self.inner, "_path", None)
        if path_fn is None:
            return
        try:
            path = path_fn(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            data = json.dumps(value)
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(data[:max(1, len(data) // 2)])
        except OSError:   # pragma: no cover - defensive
            pass

    def _remember(self, key: str, doc: Optional[Dict]) -> None:
        hist = self._seen.setdefault(key, [])
        if not hist or hist[-1] != doc:
            hist.append(doc)
            del hist[:-2]

    def _timed(self, op: str, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self._lat[op].append(time.perf_counter() - t0)

    # -------------------------------------------------------- the surface

    # _timed wraps the WHOLE op — fault application (where latency rules
    # sleep) plus the inner call — so op_latency_percentiles() reports
    # what a caller actually waited, injected delay included

    def get(self, key: str) -> Optional[Dict]:
        def _op():
            stale = self._apply("get", key)
            if stale is not None:
                return stale.doc
            doc = self.inner.get(key)
            self._remember(key, doc)
            return doc
        return self._timed("get", _op)

    def put(self, key: str, value: Dict) -> None:
        def _op():
            self._apply("put", key, value=value)
            self.inner.put(key, value)
            self._remember(key, value)
        self._timed("put", _op)

    def compare_and_swap(self, key: str, expected: Optional[Dict],
                         new: Dict) -> bool:
        def _op():
            self._apply("cas", key, value=new)
            won = self.inner.compare_and_swap(key, expected, new)
            if won:
                self._remember(key, new)
            return won
        return self._timed("cas", _op)

    def delete(self, key: str) -> None:
        def _op():
            self._apply("delete", key)
            self.inner.delete(key)
            self._remember(key, None)
        self._timed("delete", _op)

    def compare_and_delete(self, key: str, expected: Dict) -> bool:
        def _op():
            self._apply("compare_delete", key)
            won = self.inner.compare_and_delete(key, expected)
            if won:
                self._remember(key, None)
            return won
        return self._timed("compare_delete", _op)

    def clear_tombstone(self, key: str) -> None:
        def _op():
            self._apply("delete", key)
            self.inner.clear_tombstone(key)
        self._timed("delete", _op)

    def list(self, prefix: str) -> List[str]:
        def _op():
            self._apply("list", prefix)
            return self.inner.list(prefix)
        return self._timed("list", _op)

    def now(self) -> float:
        # never faulted: the clock is process-local state, not a store
        # round trip — and blacking it out would freeze lease math on
        # exactly the client whose lease is supposed to LAPSE
        return self.inner.now()

    def __getattr__(self, name: str):
        # backend surface (cas_contended_total, corrupt_docs_total,
        # _path, root, ...) stays reachable through the proxy
        return getattr(self.inner, name)

    # ------------------------------------------------------- measurement

    def op_latencies(self, op: str) -> List[float]:
        """Recent wall seconds per ``op`` (bounded window), injected
        latency included — what the bench computes percentiles over."""
        return list(self._lat[op])

    def op_latency_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Per-op-class ``{"p50", "p99", "n"}`` over the recorded
        windows (ops with no samples are omitted)."""
        out: Dict[str, Dict[str, float]] = {}
        for op, window in self._lat.items():
            if not window:
                continue
            lat = sorted(window)
            out[op] = {
                "p50": lat[len(lat) // 2],
                "p99": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                "n": float(len(lat)),
            }
        return out


def rules_from_env(env: Optional[str] = None) -> List[StoreFaultRule]:
    """Parse the :data:`STORE_FAULTS_ENV` JSON rule list (``env``
    overrides the environment for tests).  Returns ``[]`` when unset.
    A malformed spec raises — a chaos schedule that silently parses to
    nothing would report a clean soak that injected no faults."""
    raw = (env if env is not None
           else os.environ.get(STORE_FAULTS_ENV, "")).strip()
    if not raw:
        return []
    specs = json.loads(raw)
    if not isinstance(specs, list):
        raise ValueError(
            f"{STORE_FAULTS_ENV} must hold a JSON LIST of rule specs, "
            f"got {type(specs).__name__}")
    return [StoreFaultRule.from_spec(s) for s in specs]


def maybe_faulty(store: CoordinationStore, client: str,
                 env: Optional[str] = None) -> CoordinationStore:
    """Wrap ``store`` in a :class:`FaultyStore` when
    :data:`STORE_FAULTS_ENV` is armed (else return it unchanged) — the
    one hook every store-building entrypoint calls so daemons join a
    fault schedule by environment alone (``tools/fleet_member.py``)."""
    rules = rules_from_env(env)
    if not rules:
        return store
    logger.warning("store faults armed for client %r: %d rule(s) from %s",
                   client, len(rules), STORE_FAULTS_ENV)
    return FaultyStore(store, client=client, rules=rules)
