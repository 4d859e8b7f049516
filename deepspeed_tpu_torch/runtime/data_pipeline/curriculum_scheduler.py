"""Curriculum-learning difficulty scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``; reference
``runtime/data_pipeline/curriculum_scheduler.py:11``).

Maps global step -> difficulty (typically sequence length).  Schedules:
``fixed_linear``, ``fixed_root``, ``fixed_discrete``, ``custom``; the
values are the JAX package's, step for step.  ``difficulty_step`` rounds
the difficulty down to a multiple: for a seqlen curriculum on the card, a
multiple of 128 keeps each truncated sequence on the flash kernels.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    def __init__(self, config: Dict[str, Any]):
        for key in ("curriculum_type", "min_difficulty", "max_difficulty",
                    "schedule_type"):
            if key not in config:
                raise ValueError(f"curriculum config missing {key!r}")
        self.state = {
            "min_difficulty": config["min_difficulty"],
            "max_difficulty": config["max_difficulty"],
            "current_difficulty": config["min_difficulty"],
            "schedule_type": config["schedule_type"],
        }
        sched = config.get("schedule_config", {})
        st = config["schedule_type"]
        if st == FIXED_LINEAR:
            for k in ("total_curriculum_step", "difficulty_step"):
                if k not in sched:
                    raise ValueError(f"{st} schedule requires {k!r}")
        elif st == FIXED_ROOT:
            for k in ("total_curriculum_step", "difficulty_step", "root_degree"):
                if k not in sched:
                    raise ValueError(f"{st} schedule requires {k!r}")
        elif st == FIXED_DISCRETE:
            for k in ("difficulty", "max_step"):
                if k not in sched:
                    raise ValueError(f"{st} schedule requires {k!r}")
            if len(sched["max_step"]) != len(sched["difficulty"]) - 1:
                raise ValueError("fixed_discrete: len(max_step) must be "
                                 "len(difficulty) - 1")
        elif st != CUSTOM:
            raise ValueError(f"unknown schedule_type {st!r}")
        self.state["schedule"] = dict(sched)
        self._custom: Callable[[int], int] = None

    # -- reference API ---------------------------------------------------
    def get_current_difficulty(self) -> int:
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty: int) -> None:
        self.state["current_difficulty"] = difficulty

    def set_custom_get_difficulty(self, fn: Callable[[int], int]) -> None:
        self._custom = fn

    def get_state(self):
        return self.state

    def set_state(self, state) -> None:
        self.state = state

    def get_difficulty(self, global_steps: int) -> int:
        st = self.state["schedule_type"]
        if st == FIXED_DISCRETE:
            return self._discrete(global_steps)
        if st == FIXED_LINEAR:
            return self._root(global_steps, degree=1)
        if st == FIXED_ROOT:
            return self._root(global_steps,
                              degree=self.state["schedule"]["root_degree"])
        if self._custom is None:
            raise RuntimeError("custom schedule requires "
                               "set_custom_get_difficulty()")
        return self._custom(global_steps)

    def update_difficulty(self, global_steps: int) -> int:
        if self.state["current_difficulty"] < self.state["max_difficulty"]:
            self.state["current_difficulty"] = self.get_difficulty(global_steps)
        return self.state["current_difficulty"]

    # -- schedules -------------------------------------------------------
    def _discrete(self, step: int) -> int:
        s = self.state["schedule"]
        for level, max_step in zip(s["difficulty"], s["max_step"]):
            if step <= max_step:
                return level
        return s["difficulty"][-1]

    def _root(self, step: int, degree: float) -> int:
        s = self.state["schedule"]
        frac = min(1.0, step / s["total_curriculum_step"]) ** (1.0 / degree)
        span = self.state["max_difficulty"] - self.state["min_difficulty"]
        diff = frac * span + self.state["min_difficulty"]
        # quantize to difficulty_step (the recompile knob) and clamp
        q = s["difficulty_step"]
        diff = int(math.floor(diff / q) * q)
        diff = max(diff, self.state["min_difficulty"])
        return min(diff, self.state["max_difficulty"])
