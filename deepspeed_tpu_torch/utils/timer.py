"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``; reference ``deepspeed/utils/timer.py``).

PyTorch returns before the card finishes.  ``SynchronizedWallClockTimer``
(reference :33) times each named region with a pair of CUDA events on the
current stream when it runs on a card, and reads them only when asked
(``elapsed``/``mean``/``log``), so timing a region adds no host wait; on
the CPU it reads the host clock.  ``ThroughputTimer``'s stop calls
``torch.cuda.synchronize()`` first when a card is in use.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import logger


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    """One named region: ``start``/``stop`` pairs, summed.  On a card each
    pair is two CUDA events, resolved at the next read."""

    def __init__(self, name: str, cuda: bool):
        self.name = name
        self.cuda = cuda
        self.started = False
        self.count = 0
        self._start = None
        self._pending: List[tuple] = []
        self._elapsed = 0.0

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        if self.started:
            raise RuntimeError(f"timer {self.name} already started")
        self._start = self._now()
        self.started = True

    def stop(self, reset: bool = False) -> None:
        if not self.started:
            raise RuntimeError(f"timer {self.name} not started")
        if reset:
            self._pending, self._elapsed = [], 0.0
        self._pending.append((self._start, self._now()))
        self.count += 1
        self.started = False

    def _resolve(self) -> None:
        for begin, end in self._pending:
            self._elapsed += self._interval(begin, end, self.cuda)
        self._pending = []

    def elapsed(self, reset: bool = True) -> float:
        """Seconds summed over the stopped intervals (and the running one);
        ``reset`` starts the sum again (a running interval restarts now)."""
        self._resolve()
        total = self._elapsed
        if self.started:
            total += self._interval(self._start, self._now(), self.cuda)
            if reset:
                self._start = self._now()
        if reset:
            self._elapsed = 0.0
        return total

    @staticmethod
    def _interval(begin, end, cuda: bool) -> float:
        if cuda:
            end.synchronize()
            return begin.elapsed_time(end) / 1e3
        return end - begin

    def mean(self) -> float:
        """Seconds per stopped interval since the last reset."""
        self._resolve()
        return self._elapsed / max(self.count, 1)

    def reset(self) -> None:
        self.started = False
        self.count = 0
        self._pending, self._elapsed = [], 0.0


def _memory_line() -> str:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return ""
    g = 1024 ** 3
    return (f" | mem allocated: {torch.cuda.memory_allocated() / g:.2f} GB, "
            f"peak: {torch.cuda.max_memory_allocated() / g:.2f} GB, "
            f"reserved: {torch.cuda.memory_reserved() / g:.2f} GB")


class SynchronizedWallClockTimer:
    """Named timers (``timers("name").start()`` / ``.stop()``); ``log()``
    prints "name: ms" lines like the reference.  ``device`` picks CUDA
    events (a CUDA device) or the host clock (anything else; by default
    CUDA events when a card is initialised)."""

    def __init__(self, device=None):
        if device is None:
            self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        else:
            self.cuda = torch.device(device).type == "cuda"
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.cuda)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: Optional[List[str]] = None, normalizer: float = 1.0,
            reset: bool = True, memory_breakdown: bool = False) -> str:
        """Log (and return) "time (ms) | name: ms ..." over ``names`` (every
        timer by default), each divided by ``normalizer``; with
        ``memory_breakdown`` the card's allocated, peak and reserved
        memory follow."""
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be > 0, got {normalizer}")
        names = names if names is not None else list(self.timers)
        line = "time (ms)"
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                line += f" | {name}: {ms:.2f}"
        if memory_breakdown:
            line += _memory_line()
        logger.info(line)
        return line

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        """Milliseconds per interval of each named timer."""
        return {name: self.timers[name].mean() * 1000.0 / normalizer
                for name in names if name in self.timers}


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
