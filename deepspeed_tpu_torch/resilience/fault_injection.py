"""Deterministic fault injection (counterpart of
``deepspeed_tpu/resilience/fault_injection.py``, copied: framework-free).

A :class:`FaultInjector` holds an ordered list of :class:`FaultRule`s.  The
production code calls :func:`maybe_fire` at named hook points (sites);
with no injector installed the call is a dict lookup and a ``None`` check.
Sites wired into the port:

- ``ckpt.save``: entry of ``save_engine_checkpoint``, before any file is
  written (``path`` = the tag directory);
- ``ckpt.publish_latest``: immediately before the ``latest`` pointer is
  written (the synchronous and the background commit);
- ``ckpt.load``: entry of ``load_engine_checkpoint`` (``path`` = the tag
  directory about to be read), before its verification;
- ``train.step``: entry of ``DeepSpeedEngine.train_batch``, inside the
  watchdog's window;
- ``serve.tick`` (top of every ``ServingEngine.step``), ``serve.admit``
  (before a queued request is popped for admission), ``serve.prefill``
  (immediately before the prefill's device work, slot-attributable; the
  canary probe too), ``serve.decode`` (immediately before the decode
  tick's device work, fleet-wide) and ``serve.replay``
  (``ServingSupervisor``, before each in-flight request is re-submitted);
- ``supervisor.attempt`` (each round of the elastic supervisor);
- the pod sites: ``pod.heartbeat`` (each lease renewal), ``pod.rendezvous``,
  ``ckpt.shard_commit`` (before a host manifest lands), ``pod.replica_seal``
  and ``pod.adopt`` (``elasticity/``), and the ``store.*`` sites of every
  op through a ``FaultyStore``.

The fleet's ``fleet.channel_append`` fires in the store's channels (the
assignment, result and control channels of ``inference/fleet_daemon.py``).

Fault kinds: ``raise`` (raise :class:`InjectedFault`), ``delay`` (sleep
``delay_s``), ``corrupt`` (flip bytes in ``target``, resolved against the
site's ``path``), ``sigterm`` (deliver ``signum`` to this process).  Rules
fire deterministically: ``at_call`` counts matching invocations of the
site (1-based), ``every`` fires periodically, ``probability`` draws from
the rule's own seeded PRNG; each rule fires at most ``max_fires`` times.
Configuration is programmatic (:func:`install_injector`) or the
``DS_TPU_FAULTS`` environment variable (a JSON list of rule dicts).
"""
from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional

from ..utils.logging import logger

SITE_CKPT_SAVE = "ckpt.save"
SITE_CKPT_LOAD = "ckpt.load"
SITE_LATEST_PUBLISH = "ckpt.publish_latest"
SITE_TRAIN_STEP = "train.step"
SITE_SUPERVISOR_ATTEMPT = "supervisor.attempt"
SITE_SERVE_TICK = "serve.tick"
SITE_SERVE_ADMIT = "serve.admit"
SITE_SERVE_PREFILL = "serve.prefill"
SITE_SERVE_DECODE = "serve.decode"
SITE_SERVE_REPLAY = "serve.replay"
SITE_POD_HEARTBEAT = "pod.heartbeat"
SITE_POD_RENDEZVOUS = "pod.rendezvous"
SITE_SHARD_COMMIT = "ckpt.shard_commit"
SITE_FLEET_CHANNEL = "fleet.channel_append"
SITE_REPLICA_SEAL = "pod.replica_seal"
SITE_POD_ADOPT = "pod.adopt"

SITES = (SITE_CKPT_SAVE, SITE_CKPT_LOAD, SITE_LATEST_PUBLISH,
         SITE_TRAIN_STEP, SITE_SUPERVISOR_ATTEMPT, SITE_SERVE_TICK,
         SITE_SERVE_ADMIT, SITE_SERVE_PREFILL, SITE_SERVE_DECODE,
         SITE_SERVE_REPLAY, SITE_POD_HEARTBEAT, SITE_POD_RENDEZVOUS,
         SITE_SHARD_COMMIT, SITE_FLEET_CHANNEL, SITE_REPLICA_SEAL,
         SITE_POD_ADOPT,
         # coordination-store op sites, fired by the FaultyStore proxy
         # on every proxied op (elasticity/store_faults.py; canonical
         # SITE_STORE_* spellings live there to keep this module free of
         # an elasticity import)
         "store.get", "store.put", "store.cas", "store.delete",
         "store.compare_delete", "store.list")
KINDS = ("raise", "delay", "corrupt", "sigterm")

FAULTS_ENV = "DS_TPU_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by a ``raise`` rule — distinguishable from organic failures so
    tests can assert the recovery path, not the fault itself."""


@dataclass
class FaultRule:
    site: str
    kind: str
    at_call: Optional[int] = None   # fire on the Nth matching call (1-based)
    every: Optional[int] = None     # fire on every Nth call
    probability: float = 1.0        # drawn from this rule's seeded PRNG
    max_fires: int = 1              # 0 = unlimited
    delay_s: float = 0.0            # kind == delay
    signum: int = int(signal.SIGTERM)  # kind == sigterm
    target: Optional[str] = None    # kind == corrupt: file, relative to the
                                    # site's `path` context when present
    seed: int = 0
    calls: int = field(default=0, compare=False)
    fires: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.kind == "corrupt" and not self.target:
            raise ValueError("corrupt rule needs a `target` file")
        self._rng = Random(self.seed)

    def should_fire(self) -> bool:
        self.calls += 1
        if self.max_fires and self.fires >= self.max_fires:
            return False
        if self.at_call is not None and self.calls != self.at_call:
            return False
        if self.every is not None and self.calls % self.every != 0:
            return False
        if self.probability < 1.0 and self._rng.random() >= self.probability:
            return False
        return True


def corrupt_file(path: str, seed: int = 0, nbytes: int = 16) -> None:
    """Flip ``nbytes`` bytes at deterministic offsets — a torn/bit-rotted
    write.  Zero-length or missing files are truncated-torn already."""
    size = os.path.getsize(path)
    if size == 0:
        return
    rng = Random(seed)
    with open(path, "r+b") as f:
        for _ in range(min(nbytes, size)):
            off = rng.randrange(size)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))


class FaultInjector:
    """Ordered rule set + per-site dispatch.  Deterministic given the rule
    seeds and the (deterministic) sequence of site calls."""

    def __init__(self, rules: Optional[List[FaultRule]] = None):
        self.rules: List[FaultRule] = list(rules or [])
        self.log: List[Dict] = []   # (site, kind, call#) of every fired rule

    @classmethod
    def from_specs(cls, specs: List[Dict]) -> "FaultInjector":
        return cls([FaultRule(**spec) for spec in specs])

    def add(self, **spec) -> FaultRule:
        rule = FaultRule(**spec)
        self.rules.append(rule)
        return rule

    def fire(self, site: str, path: Optional[str] = None, **ctx) -> None:
        for rule in self.rules:
            if rule.site != site or not rule.should_fire():
                continue
            rule.fires += 1
            self.log.append({"site": site, "kind": rule.kind,
                             "call": rule.calls, **ctx})
            logger.warning("fault injection: %s at %s (call %d) ctx=%s",
                           rule.kind, site, rule.calls, ctx)
            if rule.kind == "raise":
                raise InjectedFault(f"injected fault at {site} "
                                    f"(call {rule.calls})")
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif rule.kind == "sigterm":
                os.kill(os.getpid(), rule.signum)
            elif rule.kind == "corrupt":
                tgt = (os.path.join(path, rule.target)
                       if path and not os.path.isabs(rule.target)
                       else rule.target)
                if os.path.exists(tgt):
                    corrupt_file(tgt, seed=rule.seed)
                else:
                    logger.warning("fault injection: corrupt target %s "
                                   "missing; skipped", tgt)


# ---------------------------------------------------------------- global hook
_ACTIVE: Optional[FaultInjector] = None
_ENV_CHECKED = False


def install_injector(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = injector
    return injector


def clear_injector() -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = False


def get_injector() -> Optional[FaultInjector]:
    """The installed injector, lazily configured from ``DS_TPU_FAULTS``."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(FAULTS_ENV)
        if spec:
            try:
                _ACTIVE = FaultInjector.from_specs(json.loads(spec))
                logger.warning("fault injection: %d rule(s) loaded from $%s",
                               len(_ACTIVE.rules), FAULTS_ENV)
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                raise ValueError(f"bad ${FAULTS_ENV}: {e}") from e
    return _ACTIVE


def maybe_fire(site: str, path: Optional[str] = None, **ctx) -> None:
    """Production-side hook: no-op unless an injector is installed."""
    inj = get_injector()
    if inj is not None:
        inj.fire(site, path=path, **ctx)
