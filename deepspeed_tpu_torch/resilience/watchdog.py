"""Hang watchdog: a wedged step or checkpoint becomes a diagnosable
restart instead of a silent forever-hang (counterpart of
``deepspeed_tpu/resilience/watchdog.py``, copied: framework-free).

A hung collective is the nastiest multi-device failure: one rank drops out
of an all-reduce and every other rank blocks inside NCCL with no Python
frame ever returning.  The watchdog is a daemon thread armed around the
places the runtime can block indefinitely (``train_batch``, async-checkpoint
finalization, and the serving engine's device calls with their host
fetches).  If a guarded section overruns its deadline the watchdog dumps
every thread's stack through the monitor layer (so the report lands next to
the metrics) and hard-exits with a dedicated code, which a supervisor treats
like any other failed round.  The daemon thread runs while the main thread
waits in CUDA because those waits release the GIL
(``torch.cuda.synchronize``, a device-to-host copy, an NCCL wait).

``os._exit`` is deliberate: the main thread is wedged in native code and
will never run ``sys.exit`` cleanup, and a daemon-thread ``raise`` cannot
cross into it.  Tests set ``on_hang`` to observe the report instead.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Callable, Optional

from ..utils.logging import logger

# distinct from RC_INTERRUPT(130) and shell conventions; the supervisor
# relaunches on it like any failure exit
RC_HANG = 85


def format_stack_report(label: str, timeout_s: float) -> str:
    """All-thread stack dump, hung section first."""
    lines = [f"HANG WATCHDOG: {label!r} exceeded {timeout_s:.1f}s deadline",
             f"pid={os.getpid()} threads={threading.active_count()}", ""]
    frames = sys._current_frames()
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        lines.append(f"--- thread {t.name} (ident={t.ident}, "
                     f"daemon={t.daemon}) ---")
        if frame is not None:
            lines.extend(l.rstrip() for l in traceback.format_stack(frame))
        else:
            lines.append("  <no frame>")
        lines.append("")
    return "\n".join(lines)


class HangWatchdog:
    """Deadline monitor for sections that may block in native code.

    ::

        wd = HangWatchdog(timeout_s=600)
        with wd.armed("train_batch step 42"):
            engine.train_batch(...)

    On expiry: stack report via ``monitor.write_report`` (or the logger),
    then ``os._exit(exit_code)`` — unless ``on_hang`` is set, in which case
    it is called with the report and the process lives (test hook)."""

    def __init__(self, timeout_s: float = 600.0, exit_code: int = RC_HANG,
                 monitor=None, on_hang: Optional[Callable[[str], None]] = None,
                 poll_s: float = 0.05):
        self.timeout_s = float(timeout_s)
        self.exit_code = exit_code
        self.monitor = monitor
        self.on_hang = on_hang
        self.poll_s = poll_s
        self.fired = False
        self._label: Optional[str] = None
        self._armed_timeout = self.timeout_s
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def arm(self, label: str, timeout_s: Optional[float] = None) -> None:
        with self._lock:
            self._label = label
            self._armed_timeout = timeout_s or self.timeout_s
            self._deadline = time.monotonic() + self._armed_timeout
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._watch, name="hang-watchdog", daemon=True)
                self._thread.start()

    def disarm(self) -> None:
        with self._lock:
            self._label = None
            self._deadline = None

    @contextmanager
    def armed(self, label: str, timeout_s: Optional[float] = None):
        self.arm(label, timeout_s)
        try:
            yield
        finally:
            self.disarm()

    def stop(self) -> None:
        """Shut the monitor thread down (tests / engine teardown)."""
        self.disarm()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                deadline, label = self._deadline, self._label
                timeout = self._armed_timeout
            if deadline is None or time.monotonic() < deadline:
                continue
            self.fired = True
            report = format_stack_report(label or "<unlabelled>", timeout)
            # append the flight recorder (when tracing is on): the stack
            # says WHERE the hang is, the span history says what the last
            # N seconds were doing — and the hung section itself shows up
            # as an open span
            try:
                from ..observability.trace import (dump_window_s,
                                                   flight_dump)

                fr = flight_dump(f"watchdog {label or '<unlabelled>'}",
                                 last_s=dump_window_s())
            except Exception as e:
                logger.warning("watchdog: flight dump failed (%s: %s)",
                               type(e).__name__, e)
                fr = None
            if fr:
                report = report + "\n" + fr
            logger.error(report)
            try:
                if self.monitor is not None:
                    self.monitor.write_report("watchdog/hang", report)
            except Exception as e:   # the report must not mask the exit
                logger.error("watchdog: monitor report failed: %s", e)
            if self.on_hang is not None:
                self.disarm()   # test hook observed the hang; stand down
                self.on_hang(report)
                continue
            logger.error("watchdog: exiting %d so the supervisor can "
                         "relaunch from the last committed checkpoint",
                         self.exit_code)
            os._exit(self.exit_code)
