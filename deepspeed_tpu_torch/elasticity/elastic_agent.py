"""Elastic run loop: survive preemption and resizes through checkpoints
(counterpart of ``deepspeed_tpu/elasticity/elastic_agent.py``; reference
``deepspeed/elasticity/elastic_agent.py:28``, ``DSElasticAgent``).

The job is stopped (preemption, resize) and started again, possibly at
another world size, by the launcher's supervisor (``launcher --
elastic_restarts N``); the agent makes that lossless:

- a signal handler turns SIGTERM (the platform's preemption notice) into a
  save-and-exit at the next step boundary.  With one process per GPU the
  notice reaches the ranks at different moments while the save is
  collective, so at a world above 1 the ranks agree on the stop step: one
  MAX all-reduce of the latched flag at each boundary, a host tensor (the
  gloo half of the port's ``cpu:gloo,cuda:nccl`` group);
- on start it restores the newest checkpoint that verifies and loads,
  whatever world size wrote it (DCP reshards ZeRO's shards), and the config
  has already taken its batch triad from the elastic plan at this world
  (``resolve_plan_for_current_world``).

Exit contract: a training script exits ``RC_PREEMPTED`` (or any other
nonzero code) while work remains and 0 once ``run`` reached
``total_steps``; ``exit_code`` gives the right one.
"""
from __future__ import annotations

import os
import shutil
import signal
import time
from typing import Callable, Optional

import torch

from .elasticity import ElasticPlan, compute_elastic_config
from ..resilience.integrity import (LATEST_FILE, MANIFEST_FILE,
                                    CheckpointIntegrityError, candidate_tags,
                                    quarantine_tag)
from ..utils.logging import log_dist, logger

# a preempted run's exit while work remains: EX_TEMPFAIL of sysexits.h
# ("temporary failure, the user is invited to retry"); apart from the hang
# watchdog's RC_HANG (85) and an interrupt's 130
RC_PREEMPTED = 75


def _group_world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _max_over_ranks(value: int) -> int:
    """The MAX of ``value`` over the default group (every rank calls it at
    the same point): a host tensor takes the gloo half of
    "cpu:gloo,cuda:nccl"; a group of NCCL alone needs one on the card."""
    import torch.distributed as dist

    device = ("cuda" if str(dist.get_backend()) == "nccl" else "cpu")
    flag = torch.tensor([int(value)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return int(flag.item())


def _is_rank0() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class PreemptionGuard:
    """Latches termination signals so training exits at a step boundary.

    Usage::

        guard = PreemptionGuard.install()
        while training:
            engine.train_batch(...)
            if guard.should_stop:
                engine.save_checkpoint(ckpt_dir)
                break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self.should_stop = False
        self.received: Optional[int] = None

    def _handler(self, signum, frame):
        self.should_stop = True
        self.received = signum
        logger.warning(f"preemption signal {signum} latched; will checkpoint "
                       "and exit at the next step boundary")

    @classmethod
    def install(cls, signals=(signal.SIGTERM, signal.SIGINT)) -> "PreemptionGuard":
        guard = cls(signals)
        for s in signals:
            guard._previous[s] = signal.signal(s, guard._handler)
        return guard

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous = {}


class ElasticAgent:
    """Drives an elastic training session across restarts.

    ``train_step_fn(engine, step)`` runs one training step; the agent owns
    the restore on entry, periodic and preemption checkpoints, and the stop
    decision.  ``timings`` records the seconds of the restore and of the
    preemption save (keys ``restore_s``, ``save_s``).
    """

    def __init__(self, engine, ckpt_dir: str, ckpt_every: int = 0,
                 tag: Optional[str] = None, keep: int = 3):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        # tag=None -> per-step generation tags (global_stepN): a corrupt
        # newest generation falls back to the previous one.  A fixed tag
        # keeps one overwritten slot (no fallback depth).
        self.tag = tag
        self.keep = keep
        self.guard = PreemptionGuard.install()
        self.resumed_step = 0
        self.resumed_tag: Optional[str] = None
        self.timings = {}

    def restore_if_present(self) -> int:
        """Load the newest checkpoint that verifies and loads (any earlier
        world size); returns the step training resumes from.

        Walks committed tags newest to oldest.  A tag that fails manifest
        verification (``load_checkpoint`` verifies before touching state) or
        errors during the restore is quarantined (renamed ``<tag>.corrupt``)
        and the walk falls back one generation; an error that is not a
        proven corruption is retried once first (a storage blip).  Every
        rank walks alike against shared storage; rank 0 alone renames and
        re-points ``latest``."""
        t0 = time.perf_counter()
        if not (os.path.isdir(self.ckpt_dir) and os.listdir(self.ckpt_dir)):
            return self.resumed_step
        for tag in candidate_tags(self.ckpt_dir):
            tag_dir = os.path.join(self.ckpt_dir, tag)
            try:
                # subclass hook (the pod agent): verification of the
                # commit's scope before any engine state is touched; a
                # failure quarantines and falls back like a failed load
                self._pre_load_verify(tag_dir)
                try:
                    self.engine.load_checkpoint(self.ckpt_dir, tag=tag)
                except KeyboardInterrupt:
                    raise
                except CheckpointIntegrityError:
                    raise   # proven corruption: no point retrying
                except Exception as e:
                    logger.warning(
                        "elastic restore: load of %s raised %s: %s; "
                        "retrying once before quarantining",
                        tag_dir, type(e).__name__, e)
                    self.engine.load_checkpoint(self.ckpt_dir, tag=tag)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                logger.error(
                    "elastic restore: checkpoint %s unusable (%s: %s); "
                    "quarantining and falling back one generation",
                    tag_dir, type(e).__name__, e)
                if _is_rank0():
                    try:
                        quarantine_tag(self.ckpt_dir, tag)
                    except OSError as qe:   # storage flaking mid-quarantine
                        logger.error("elastic restore: quarantine of %s "
                                     "failed (%s); skipping tag", tag_dir, qe)
                continue
            self.resumed_step = int(self.engine.global_steps)
            self.resumed_tag = tag
            # re-point `latest` at the generation that loaded, so the next
            # writer and reader agree on the committed frontier
            if _is_rank0():
                with open(os.path.join(self.ckpt_dir, LATEST_FILE), "w") as f:
                    f.write(str(tag))
            log_dist(f"elastic resume from step {self.resumed_step} "
                     f"(tag {tag}) on {self.engine.dp_world} data-parallel "
                     "ranks", ranks=[0])
            break
        else:
            logger.warning("elastic restore: no usable checkpoint under %s; "
                           "starting fresh", self.ckpt_dir)
        self.timings["restore_s"] = time.perf_counter() - t0
        return self.resumed_step

    def stop_agreed(self) -> bool:
        """Whether any rank latched a stop: at a world above 1, one MAX
        all-reduce of the flag over the group (every rank calls it at the
        same boundary), so every rank saves and exits at the same step."""
        if _group_world() <= 1:
            return self.guard.should_stop
        # the reduced flag, never the live one: a signal landing during the
        # all-reduce latches here only, and the ranks stop together at the
        # next boundary
        agreed = bool(_max_over_ranks(int(self.guard.should_stop)))
        if agreed and not self.guard.should_stop:
            self.guard.should_stop = True
            log_dist("elastic stop: a peer rank latched a preemption signal",
                     ranks=None)
        return agreed

    def run(self, train_step_fn: Callable, total_steps: int) -> int:
        """Run to ``total_steps`` or preemption; returns the last global step
        completed.  Exit nonzero while the returned step < total_steps
        (``exit_code``): the supervisor (``elasticity/supervisor.py``,
        ``launcher --elastic_restarts N``) relaunches on a failure exit,
        discovering the resources again, and the new run resumes here from
        the last committed checkpoint at its own world size."""
        start = self.restore_if_present()
        saved_at = -1
        for step in range(start, total_steps):
            train_step_fn(self.engine, step)
            stop = self.stop_agreed()
            at_interval = self.ckpt_every and (step + 1) % self.ckpt_every == 0
            if at_interval or stop:
                t0 = time.perf_counter()
                try:
                    self._save()
                    if stop:
                        # about to exit: an async save's commit runs on a
                        # daemon thread that dies with the process — join it
                        # or the preemption checkpoint is torn and lost
                        self._join_pending_save()
                    saved_at = step + 1
                    self._prune_generations()
                except Exception as e:
                    if not stop:
                        raise
                    # the stop is latched: the save failed, but the exit
                    # contract below must still run so the supervisor sees
                    # a failure exit and relaunches from the last COMMITTED
                    # generation — raising here would skip it
                    logger.error(
                        "elastic exit: preemption-path checkpoint save "
                        "failed (%s: %s); exiting without a new generation "
                        "— restart resumes from the previous committed tag",
                        type(e).__name__, e)
                if stop:
                    self.timings["save_s"] = time.perf_counter() - t0
            if stop:
                log_dist(f"elastic exit at step {step + 1} "
                         f"(signal {self.guard.received})", ranks=[0])
                return step + 1
        if saved_at != total_steps:
            self._save()
            self._join_pending_save()
            self._prune_generations()
        else:
            self._join_pending_save()
        return total_steps

    @staticmethod
    def exit_code(last_step: int, total_steps: int) -> int:
        """The process's exit code after ``run``: 0 once the work is done,
        ``RC_PREEMPTED`` while it remains."""
        return 0 if last_step >= total_steps else RC_PREEMPTED

    def _save(self) -> None:
        """One save at the agent's tag policy; the pod agent overrides it
        with the pod-scope commit."""
        self.engine.save_checkpoint(self.ckpt_dir, tag=self.tag)

    def _pre_load_verify(self, tag_dir: str) -> None:
        """Verification of a tag's commit scope before it is loaded (the
        base agent relies on the engine's manifest check)."""

    def _join_pending_save(self) -> None:
        """Commit barrier before the process may exit (a no-op after a
        synchronous save): joins the async commit thread, bounded, and
        re-raises a failed save."""
        wait = getattr(self.engine, "wait_for_checkpoint", None)
        if wait is not None:
            wait()

    def _prune_generations(self) -> None:
        """Keep the newest ``keep`` COMMITTED generations (rank 0).  Only
        manifest-bearing tags are candidates: an async save in flight has no
        manifest yet and must never be removed under its writer; torn tags
        are left for quarantine, ``*.corrupt`` ones for the operator."""
        if self.tag is not None or self.keep <= 0 or not _is_rank0():
            return
        committed = [t for t in candidate_tags(self.ckpt_dir)
                     if self._tag_committed(os.path.join(self.ckpt_dir, t))]
        for old in committed[self.keep:]:
            shutil.rmtree(os.path.join(self.ckpt_dir, old), ignore_errors=True)

    def _tag_committed(self, tag_dir: str) -> bool:
        """The commit test of pruning and its keep count; the pod agent
        tightens it to pod-committed, so a torn pod tag is neither deleted
        under a late writer nor counted against the kept generations."""
        return os.path.exists(os.path.join(tag_dir, MANIFEST_FILE))


def resolve_plan_for_current_world(config, dp_world_size: int,
                                   node_size: int = 1,
                                   model_parallel_size: int = 1) -> ElasticPlan:
    """The elastic plan bound to this run's data-parallel world size (the
    runtime config's call)."""
    plan = compute_elastic_config(config, dp_world_size, node_size,
                                  model_parallel_size)
    log_dist(
        f"elasticity: batch={plan.train_batch_size} micro="
        f"{plan.micro_batch_per_device} gas={plan.gradient_accumulation_steps} "
        f"valid device counts={list(plan.valid_device_counts)}", ranks=[0])
    return plan
