"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``;
reference ``runtime/lr_schedules.py``).

The reference's ``LRRangeTest``, ``OneCycle``, ``WarmupLR`` and
``WarmupDecayLR`` plus ``CosineAnnealing``, as plain ``step -> lr``
functions of a Python int (the JAX package evaluates the same formulas on
fp32 arrays inside its jitted step).  ``get_lr_scheduler`` mirrors the
config-driven construction.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

Schedule = Callable[[int], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
COSINE_ANNEALING = "CosineAnnealing"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      COSINE_ANNEALING]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    """Increase LR over time to find a good range (reference LRRangeTest)."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


def one_cycle(cycle_min_lr: float = 0.0, cycle_max_lr: float = 1e-3,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> Schedule:
    """Triangular one-cycle LR with optional post-cycle decay (reference
    OneCycle; its momentum leg is not part of the LR schedule)."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        if step < cycle_first_step_size:
            frac = _clip(step / cycle_first_step_size, 0.0, 1.0)
            cyc_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        else:
            frac = _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
            cyc_lr = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        if step <= total_cycle:
            return cyc_lr
        if decay_step_size > 0:
            decay_steps = max(step - total_cycle, 0.0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return cycle_min_lr

    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    """Warmup then hold (reference WarmupLR; log or linear ramp)."""

    def schedule(step):
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            gamma = _clip(math.log(step + 1.0) / math.log(max(warmup_num_steps, 2)),
                          0.0, 1.0)
        else:
            gamma = _clip((step + 1.0) / max(warmup_num_steps, 1), 1e-8, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    """Warmup then linear decay to zero over total_num_steps (reference
    WarmupDecayLR)."""
    wl = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        if step < warmup_num_steps:
            return wl(step)
        decay = _clip((total_num_steps - step)
                      / max(float(total_num_steps - warmup_num_steps), 1.0),
                      0.0, 1.0)
        return warmup_max_lr * decay

    return schedule


def cosine_annealing(total_num_steps: int, warmup_num_steps: int = 0,
                     warmup_max_lr: float = 1e-3, warmup_min_lr: float = 0.0,
                     cosine_min_ratio: float = 0.1, **_) -> Schedule:
    def schedule(step):
        if step < warmup_num_steps:
            return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _clip(
                step / max(warmup_num_steps, 1), 0.0, 1.0)
        prog = _clip((step - warmup_num_steps)
                     / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        floor = warmup_max_lr * cosine_min_ratio
        return floor + (warmup_max_lr - floor) * 0.5 * (1.0 + math.cos(math.pi * prog))

    return schedule


_REGISTRY: Dict[str, Callable[..., Schedule]] = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    COSINE_ANNEALING: cosine_annealing,
}


def get_lr_scheduler(type_name: str, params: Optional[Dict] = None) -> Schedule:
    if type_name not in _REGISTRY:
        raise ValueError(f"unknown scheduler {type_name!r}; valid: {VALID_LR_SCHEDULES}")
    return _REGISTRY[type_name](**(params or {}))


def constant_lr(lr: float) -> Schedule:
    return lambda step: lr
