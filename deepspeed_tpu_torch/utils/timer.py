"""The throughput timer (counterpart of ``ThroughputTimer`` in
``deepspeed_tpu/utils/timer.py``; reference ``deepspeed/utils/timer.py``).

PyTorch returns before the card finishes, so the timer's stop calls
``torch.cuda.synchronize()`` first when a card is in use; on the CPU there
is nothing in flight.  The named ``SynchronizedWallClockTimer`` waits for
a caller (``wall_clock_breakdown``, ROADMAP queue 1 item 1).
"""
from __future__ import annotations

import time

import torch

from .logging import logger


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ThroughputTimer:
    """Samples/sec tracker (reference ThroughputTimer, timer.py:153); the
    first ``start_step`` steps are left out of the average."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 logging_fn=None):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or logger.info
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._window_steps = 0
        self._start = 0.0
        self.started = False

    def start(self) -> None:
        self._start = time.perf_counter()
        self.started = True

    def stop(self, global_step: bool = True, report_speed: bool = True) -> None:
        if not self.started:
            return
        _sync()
        self.started = False
        if global_step:
            self.global_step_count += 1
        duration = time.perf_counter() - self._start
        if self.global_step_count > self.start_step:
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            self._window_steps += 1
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"step={self.global_step_count}, "
                    f"samples/sec (avg): {self.avg_samples_per_sec():.2f}, "
                    f"samples/sec (window): {self._window_samples_per_sec():.2f}")
                self.step_elapsed_time = 0.0
                self._window_steps = 0

    def _window_samples_per_sec(self) -> float:
        if self.step_elapsed_time == 0.0 or self._window_steps == 0:
            return 0.0
        return self._window_steps * self.batch_size / self.step_elapsed_time

    def avg_samples_per_sec(self) -> float:
        effective = self.global_step_count - self.start_step
        if effective <= 0 or self.total_elapsed_time == 0.0:
            return 0.0
        return effective * self.batch_size / self.total_elapsed_time
