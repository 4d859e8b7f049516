"""Elastic training: one global batch that survives device-count changes
(counterpart of ``deepspeed_tpu/elasticity/elasticity.py``; reference
``deepspeed/elasticity/elasticity.py:27-233``).

Pick ONE global batch size that (a) stays under a ceiling and (b) is
reachable from an allowed micro-batch at as many device counts as possible,
so a job stopped on one set of GPUs resumes on another with the same
effective hyperparameters.  The search is the JAX package's exact one:
every feasible global batch is ``mb * k`` for an allowed ``mb``, and each
candidate is scored by the device counts it admits (the divisors of its
slot count).  Raw divisor counts favour highly composite batches; set
``min_gpus`` to the smallest job you will actually run so the score only
counts reachable device counts.

``DeepSpeedConfig`` calls ``compute_elastic_config`` when
``elasticity.enabled`` and takes the batch triad from the plan at the
engine's data-parallel world; ``ensure_immutable_elastic_config`` refuses a
runtime envelope that disagrees with the scheduler's snapshot in
``DEEPSPEED_ELASTICITY_CONFIG`` (reference :204-224).  Pure Python.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"


class ElasticityError(Exception):
    """Base error for the elasticity subsystem."""


class ElasticityConfigError(ElasticityError):
    """Elastic config is malformed or inconsistent with the scheduler's."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """The current device count cannot run the planned elastic batch."""


def _divisors(n: int) -> List[int]:
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return small + large[::-1]


def valid_device_counts(batch_size: int, micro_batches: Sequence[int],
                        min_devices: int = 1,
                        max_devices: Optional[int] = None) -> List[int]:
    """All device counts that can train ``batch_size`` exactly: ``d`` works
    if some allowed micro-batch ``mb`` divides the batch and ``d`` divides
    the slot count ``batch_size // mb`` (the rest is gradient
    accumulation)."""
    max_devices = max_devices or batch_size
    counts = set()
    for mb in micro_batches:
        if mb <= 0 or batch_size % mb:
            continue
        slots = batch_size // mb  # = devices x gradient_accumulation_steps
        for d in _divisors(slots):
            if min_devices <= d <= max_devices:
                counts.add(d)
    return sorted(counts)


def plan_elastic_batch(micro_batches: Sequence[int],
                       max_batch_size: int,
                       min_devices: int = 1,
                       max_devices: Optional[int] = None,
                       prefer_larger: bool = True) -> Tuple[int, List[int]]:
    """The global batch size with the most compatible device counts, ties
    broken toward the larger (or smaller) batch.  Returns (batch_size,
    sorted device counts)."""
    micro_batches = sorted(set(int(m) for m in micro_batches))
    if not micro_batches:
        raise ElasticityConfigError("micro_batch_sizes must be non-empty")
    if any(m <= 0 for m in micro_batches):
        raise ElasticityConfigError(
            f"micro_batch_sizes must be positive, got {micro_batches}")
    if micro_batches[0] > max_batch_size:
        raise ElasticityConfigError(
            f"smallest micro-batch {micro_batches[0]} exceeds "
            f"max_train_batch_size {max_batch_size}")
    candidates = set()
    for mb in micro_batches:
        candidates.update(mb * k for k in range(1, max_batch_size // mb + 1))

    best: Tuple[int, int, List[int]] = (-1, 0, [])
    for batch in candidates:
        counts = valid_device_counts(batch, micro_batches, min_devices,
                                     max_devices)
        if not counts:
            continue
        key = (len(counts), batch if prefer_larger else -batch)
        if key > (best[0], best[1]):
            best = (len(counts), batch if prefer_larger else -batch, counts)
    if best[0] < 0:
        raise ElasticityConfigError(
            f"no batch size ≤ {max_batch_size} admits a device count in "
            f"[{min_devices}, {max_devices}] with micro-batches {micro_batches}")
    batch = best[1] if prefer_larger else -best[1]
    return batch, best[2]


def pick_micro_batch(batch_size: int, micro_batches: Sequence[int],
                     dp_world_size: int, prefer_larger: bool = True) -> int:
    """Micro-batch for the current world size: the per-device slot count
    ``batch_size / dp`` must be a multiple of it (the rest is gradient
    accumulation)."""
    if batch_size % dp_world_size:
        raise ElasticityIncompatibleWorldSize(
            f"world size {dp_world_size} does not divide the elastic batch "
            f"size {batch_size}")
    per_device = batch_size // dp_world_size
    fits = [mb for mb in micro_batches if per_device % mb == 0]
    if not fits:
        raise ElasticityIncompatibleWorldSize(
            f"no allowed micro-batch divides batch/world = {per_device} "
            f"(micro_batches={list(micro_batches)})")
    return max(fits) if prefer_larger else min(fits)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """The resolved elastic schedule for one (config, world size) pair."""
    train_batch_size: int
    micro_batch_per_device: int
    gradient_accumulation_steps: int
    valid_device_counts: Tuple[int, ...]

    def as_triad(self) -> Tuple[int, int, int]:
        return (self.train_batch_size, self.micro_batch_per_device,
                self.gradient_accumulation_steps)


def compute_elastic_config(elastic_config, dp_world_size: int = 0,
                           node_size: int = 1,
                           model_parallel_size: int = 1) -> ElasticPlan:
    """Resolve the elastic plan (reference ``compute_elastic_config``:233).

    ``elastic_config`` is the ``elasticity`` block
    (``runtime.config.ElasticityConfig``).  With ``version >= 0.2`` the plan
    is computed at node granularity: device counts step by whole hosts of
    ``node_size`` GPUs and the data-parallel degree per node is ``node_size
    / model_parallel_size`` (reference ``_get_compatible_gpus_v02``).
    ``dp_world_size == 0`` plans without binding to a world size (the
    scheduler's use)."""
    ec = elastic_config
    if not ec.enabled:
        raise ElasticityConfigError("elasticity is not enabled in the config")
    if ec.max_gpus < ec.min_gpus or ec.min_gpus < 1:
        raise ElasticityConfigError(
            f"bad device range [{ec.min_gpus}, {ec.max_gpus}]")

    if ec.version >= 0.2:
        if node_size % model_parallel_size:
            raise ElasticityConfigError(
                f"node size {node_size} must be divisible by model-parallel "
                f"size {model_parallel_size}")
        dp_per_node = node_size // model_parallel_size
        per_node_batch, node_counts = plan_elastic_batch(
            ec.micro_batch_sizes,
            max(1, ec.max_train_batch_size // dp_per_node),
            max(1, -(-ec.min_gpus // node_size)),  # ceil: never under the floor
            max(1, ec.max_gpus // node_size),
            ec.prefer_larger_batch)
        batch = per_node_batch * dp_per_node
        counts = [c * dp_per_node for c in node_counts]
    else:
        batch, counts = plan_elastic_batch(
            ec.micro_batch_sizes, ec.max_train_batch_size,
            ec.min_gpus, ec.max_gpus, ec.prefer_larger_batch)

    if dp_world_size <= 0:
        return ElasticPlan(batch, 0, 0, tuple(counts))

    if dp_world_size not in counts:
        raise ElasticityIncompatibleWorldSize(
            f"current data-parallel world size {dp_world_size} is not among "
            f"the elastic-compatible counts {counts} for batch {batch}")
    micro = pick_micro_batch(batch, ec.micro_batch_sizes, dp_world_size,
                             ec.prefer_larger_batch)
    gas = batch // (micro * dp_world_size)
    return ElasticPlan(batch, micro, gas, tuple(counts))


def elasticity_enabled(ds_config: Dict) -> bool:
    return bool(ds_config.get("elasticity", {}).get("enabled", False))


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict) -> None:
    """The resource scheduler snapshots the elastic envelope into
    ``DEEPSPEED_ELASTICITY_CONFIG``; the runtime's copy must agree on the
    fields that determine the batch plan, else a resumed job silently trains
    with another effective batch (reference :204-224)."""
    raw = os.environ.get(DEEPSPEED_ELASTICITY_CONFIG)
    if raw is None:
        return
    sched = json.loads(raw)
    for key in ("max_train_batch_size", "micro_batch_sizes", "version"):
        if key in sched and key in runtime_elastic_config_dict and \
                sched[key] != runtime_elastic_config_dict[key]:
            raise ElasticityConfigError(
                f"elastic config mismatch between scheduler and runtime on "
                f"'{key}': {sched[key]} != {runtime_elastic_config_dict[key]}")
