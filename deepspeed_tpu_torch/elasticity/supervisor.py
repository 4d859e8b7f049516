"""Elastic restart supervisor (counterpart of
``deepspeed_tpu/elasticity/supervisor.py``; reference
``deepspeed/elasticity/elastic_agent.py:28`` ``DSElasticAgent`` and
``launcher/launch.py:255-313``): torch-elastic restarts worker groups on a
membership change; here the launcher relaunches the JOB at the resources
it discovers again, and the checkpoint's resharding absorbs a change of
world size.

This is the wrapper contract ``ElasticAgent.run`` documents: the training
processes checkpoint on preemption and exit nonzero while work remains; the
supervisor discovers the resources again and relaunches until the job exits
0 (complete) or the restart budget is spent.  Because discovery runs again
every round, a restart after a resize launches at the NEW world size —
``ElasticAgent.restore_if_present`` and the config's elastic plan rebuild
the schedule there.

Hardening:

- **jittered exponential backoff**: the delay grows ``backoff_s *
  backoff_mult**(n-1)`` capped at ``backoff_max_s``, with a jitter drawn
  from ``Random(seed)`` so a preempted job's hosts do not stampede storage
  in lockstep;
- **progress-aware restart budget**: with a ``progress_fn`` (see
  ``resilience.checkpoint_progress_fn``), a failed round that still
  advanced the committed checkpoint refreshes the budget, while
  ``zero_progress_limit`` consecutive rounds with no progress trip a
  circuit breaker with a terminal diagnosis instead of crash-looping on a
  poisoned state.
"""
from __future__ import annotations

import time
from random import Random
from typing import Callable, Optional, Sequence

from ..resilience.fault_injection import SITE_SUPERVISOR_ATTEMPT, maybe_fire
from ..utils.logging import logger

# exit codes that must NOT trigger a relaunch
RC_COMPLETE = 0          # training finished
RC_INTERRUPT = 130       # operator ^C through the launcher


class SupervisorStandDown(Exception):
    """An attempt determined this supervisor should stop cleanly WITHOUT
    consuming restart budget or backoff: it is not the driver and never
    will be within its wait bound (e.g. an elected standby pod supervisor
    whose leader stayed healthy past ``standby_max_wait_s``).  ``rc`` is
    what :meth:`Supervisor.run` returns — standing down is not a failed
    round, so the default is success."""

    def __init__(self, reason: str, rc: int = RC_COMPLETE):
        super().__init__(reason)
        self.reason = reason
        self.rc = int(rc)


class Supervisor:
    """Relaunch loop around a launch attempt.

    ``attempt(round_idx) -> int`` performs one full discovery + launch and
    returns the job's exit code.  The supervisor relaunches on any failure
    exit until ``max_restarts`` is spent; interrupts are terminal.

    ``progress_fn() -> int`` (optional) reports monotonically comparable
    progress (newest committed checkpoint step); ``zero_progress_limit`` of
    K > 0 trips the circuit breaker after K consecutive failed rounds that
    made no progress.  After the run, ``breaker_tripped`` / ``diagnosis``
    describe a terminal failure.

    ``monitor`` (optional): every failed round ships a flight-recorder
    dump through ``monitor.write_report`` when tracing is enabled, so a
    crash-looping job's restart log carries the spans of each failed
    attempt (``observability.trace.flight_dump``); the most recent dump also stays
    readable on ``last_flight_dump``.
    """

    def __init__(self, attempt: Callable[[int], int], max_restarts: int = 10,
                 backoff_s: float = 3.0,
                 on_round: Optional[Callable[[int, int], None]] = None,
                 backoff_mult: float = 2.0, backoff_max_s: float = 60.0,
                 jitter: float = 0.25,
                 progress_fn: Optional[Callable[[], int]] = None,
                 zero_progress_limit: int = 0, seed: int = 0, monitor=None,
                 terminal_rcs: Sequence[int] = ()):
        self.attempt = attempt
        # exit codes that are PERMANENT no matter the budget (e.g. the pod
        # supervisor's "healthy slice below the elastic floor") — relaunching
        # cannot change them, so retrying only burns the backoff schedule
        self.terminal_rcs = frozenset(terminal_rcs)
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.on_round = on_round
        self.backoff_mult = backoff_mult
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.progress_fn = progress_fn
        self.zero_progress_limit = zero_progress_limit
        self._rng = Random(seed)
        self.breaker_tripped = False
        self.diagnosis: Optional[str] = None
        self.monitor = monitor
        self.last_flight_dump: Optional[str] = None

    def backoff_delay(self, consecutive_failures: int) -> float:
        """Exponential in the *consecutive* failure count (a productive
        restart resets it), capped, with ±jitter."""
        base = self.backoff_s * self.backoff_mult ** max(
            0, consecutive_failures - 1)
        base = min(base, self.backoff_max_s)
        if self.jitter > 0 and base > 0:
            base *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return base

    def run(self) -> int:
        restarts = 0          # spent against max_restarts; refreshed on progress
        consecutive = 0       # consecutive failures, drives backoff + breaker
        rounds = 0
        last_progress = self.progress_fn() if self.progress_fn else None
        while True:
            try:
                maybe_fire(SITE_SUPERVISOR_ATTEMPT, round=rounds)
                rc = self.attempt(restarts)
            except KeyboardInterrupt:
                raise
            except SupervisorStandDown as e:
                # not a failed round: another supervisor is (and stays) the
                # driver — exit without burning budget or backoff
                self.diagnosis = f"stand-down: {e.reason}"
                logger.info("elastic supervisor: %s", self.diagnosis)
                return e.rc
            except Exception as e:
                # a transient discovery failure (e.g. pod metadata absent
                # WHILE the preempted slice is being recreated) must consume
                # a restart, not crash the supervisor in exactly the window
                # elastic restarts exist to survive
                logger.warning("elastic supervisor: attempt raised %s: %s; "
                               "treating as failed round", type(e).__name__, e)
                rc = 1
            rounds += 1
            if self.on_round is not None:
                self.on_round(restarts, rc)
            if rc == RC_COMPLETE:
                if restarts or rounds > 1:
                    logger.info("elastic supervisor: job complete after "
                                "%d round(s)", rounds)
                return 0
            if rc == RC_INTERRUPT:
                logger.info("elastic supervisor: interrupted; not restarting")
                return rc
            if rc in self.terminal_rcs:
                if self.diagnosis is None:
                    self.diagnosis = (f"terminal exit code {rc}: the failure "
                                      "is permanent by contract; not "
                                      "relaunching")
                logger.error("elastic supervisor: %s", self.diagnosis)
                return rc
            consecutive += 1
            # failed round: capture the attempt's span history before the
            # next attempt overwrites the ring (None when tracing is off)
            try:
                from ..observability.trace import (dump_window_s,
                                                   flight_dump)

                self.last_flight_dump = flight_dump(
                    f"supervisor.round[{rounds}] rc={rc}",
                    monitor=self.monitor, last_s=dump_window_s())
            except Exception as e:
                logger.warning("elastic supervisor: flight dump failed "
                               "(%s: %s)", type(e).__name__, e)
                self.last_flight_dump = None
            if self.progress_fn is not None:
                cur = self.progress_fn()
                if last_progress is None or cur > last_progress:
                    # the failed round still committed new checkpoints —
                    # productive preemption churn, not a crash loop
                    logger.info(
                        "elastic supervisor: round failed (rc=%d) but "
                        "progress advanced %s -> %s; refreshing restart "
                        "budget", rc, last_progress, cur)
                    last_progress = cur
                    restarts = 0
                    # the productive round itself must not count toward the
                    # zero-progress streak: consecutive resets to 0, so the
                    # breaker needs zero_progress_limit FURTHER barren
                    # rounds (1 here tripped it one round early)
                    consecutive = 0
                elif cur < last_progress:
                    # the committed frontier REGRESSED (newest generation
                    # quarantined on restore): re-anchor, or genuine forward
                    # progress from the fallback generation would keep
                    # comparing against the dead high-water mark and read
                    # as a crash loop
                    logger.warning(
                        "elastic supervisor: committed progress regressed "
                        "%s -> %s (generation quarantined?); re-anchoring",
                        last_progress, cur)
                    last_progress = cur
                elif self.zero_progress_limit and \
                        consecutive >= self.zero_progress_limit:
                    self.breaker_tripped = True
                    self.diagnosis = (
                        f"circuit breaker: {consecutive} consecutive "
                        f"failed rounds with no checkpoint progress "
                        f"(stuck at step {cur}, last rc={rc}) — the job is "
                        "crash-looping on a non-transient fault (poisoned "
                        "state, incompatible config, or unrecoverable "
                        "corruption); NOT relaunching. Inspect the newest "
                        "*.corrupt quarantine dirs and the last failure "
                        "log before restarting manually.")
                    logger.error("elastic supervisor: %s", self.diagnosis)
                    return rc
            if restarts >= self.max_restarts:
                logger.error(
                    "elastic supervisor: rc=%d with restart budget exhausted "
                    "(%d); giving up", rc, self.max_restarts)
                return rc
            restarts += 1
            delay = self.backoff_delay(consecutive)
            logger.warning(
                "elastic supervisor: job exited rc=%d; relaunching "
                "(restart %d/%d) after %.1fs — resources are re-discovered, "
                "so a resized slice relaunches at the new world size",
                rc, restarts, self.max_restarts, delay)
            if delay > 0:
                time.sleep(delay)
