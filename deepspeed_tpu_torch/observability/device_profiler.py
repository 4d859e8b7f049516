"""Device-trace correlation: windowed ``torch.profiler`` captures with span
annotation (counterpart of ``deepspeed_tpu/observability/device_profiler.py``,
which windows ``jax.profiler``).

The span tracer is host-side: it stamps host clocks around device calls
but cannot say where inside a step the device spent its time.  This module
is the device half:

- :class:`DeviceTraceCapture` — a window of ``torch.profiler.profile``
  (CPU activity, and CUDA activity when a card is present).  A capture is
  bounded by a unit budget (``n_units`` train steps / working serving
  ticks; the loops call :func:`device_trace_unit` at each boundary) or by
  an explicit :func:`stop_device_trace`.  Unbounded always-on device
  tracing is not offered: the profiler perturbs the run and its traces
  are large, so the tool is a window around the region under study.  On
  stop the window is written as one Chrome trace, ``<log_dir>/
  <host>_<pid>.<n>.pt.trace.json`` (Perfetto or TensorBoard's profiler
  plugin read it).
- **Correlation**: while a capture is active, every ``trace_span`` also
  enters a ``torch.profiler.record_function`` of the same name, so the host
  spans (``train.batch``, ``serve.decode``, ``serve.prefill``...) appear as
  named ranges on the CPU timeline and, for the kernels launched inside
  them, on the GPU timeline.  The hook is installed only for the window
  (one module-global check per span when off) and works with the host
  tracer disabled.

Opt-in surfaces:

- ``DS_TPU_DEVICE_TRACE=<dir>`` (+ ``DS_TPU_DEVICE_TRACE_UNITS``, default
  16): the first training or serving engine in the process arms one
  capture of N units into ``<dir>``;
- ``capture_device_trace(log_dir, n_units=...)``.

Every failure to start or write a capture degrades to a warning (and
``failed`` on the capture): observability never gates the product.  A
kernel that fails inside an open window still raises.
"""
from __future__ import annotations

import os
import socket
import threading
from typing import Any, Optional

from ..utils.logging import logger

DEVICE_TRACE_ENV = "DS_TPU_DEVICE_TRACE"
DEVICE_TRACE_UNITS_ENV = "DS_TPU_DEVICE_TRACE_UNITS"
DEFAULT_CAPTURE_UNITS = 16

__all__ = ["DeviceTraceCapture", "capture_device_trace",
           "device_capture_active", "device_trace_unit",
           "stop_device_trace", "maybe_capture_from_env",
           "DEVICE_TRACE_ENV", "DEVICE_TRACE_UNITS_ENV"]

_SEQ = 0   # capture number within the process (the trace file's suffix)


class DeviceTraceCapture:
    """One windowed ``torch.profiler`` capture.  Constructed armed and
    started; :meth:`unit` counts the window down (``n_units=None`` = until
    an explicit :meth:`stop`).  ``annotations`` counts the span
    annotations entered while active; ``trace_path`` is the written trace
    (``None`` until a successful stop)."""

    def __init__(self, log_dir: str, n_units: Optional[int] = None):
        if n_units is not None and int(n_units) < 1:
            raise ValueError(f"n_units={n_units} must be >= 1 (or None "
                             "for an explicit stop)")
        self.log_dir = str(log_dir)
        self.remaining = int(n_units) if n_units is not None else None
        self.active = False
        self.failed: Optional[str] = None
        self.annotations = 0
        self.trace_path: Optional[str] = None
        self._prof = None
        self._lock = threading.Lock()
        self._start()

    # ------------------------------------------------------------ lifecycle

    def _start(self) -> None:
        global _SEQ
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.log_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        except Exception as e:   # profiler unavailable / already profiling
            self.failed = f"{type(e).__name__}: {e}"
            logger.warning("device trace capture into %s failed to start "
                           "(%s); continuing without", self.log_dir, e)
            return
        self._prof = prof
        _SEQ += 1
        self._seq = _SEQ
        self.active = True
        from . import trace as trace_mod

        trace_mod._set_device_annotation_factory(self._annotation)
        logger.info("device trace capture started into %s (%s)",
                    self.log_dir,
                    f"{self.remaining} units" if self.remaining is not None
                    else "until stopped")

    def _annotation(self, name: str) -> Any:
        """The factory ``trace_span`` calls while this capture is active: a
        ``torch.profiler.record_function`` named like the host span."""
        import torch

        self.annotations += 1
        return torch.profiler.record_function(name)

    def unit(self) -> None:
        """One step/tick boundary passed; stop when the window is spent."""
        if not self.active or self.remaining is None:
            return
        stop = False
        with self._lock:
            self.remaining -= 1
            if self.remaining <= 0:
                stop = True
        if stop:
            self.stop()

    def stop(self) -> Optional[str]:
        """Stop the capture, detach the span-annotation hook and write the
        trace; returns the log dir (``None`` when the capture never started
        or its trace could not be written).  Idempotent — the unit
        countdown and an explicit stop may race benignly."""
        with self._lock:
            if not self.active:
                return None
            self.active = False
        from . import trace as trace_mod

        trace_mod._set_device_annotation_factory(None)
        prof, self._prof = self._prof, None
        path = os.path.join(self.log_dir, f"{socket.gethostname()}_{os.getpid()}."
                            f"{self._seq}.pt.trace.json")
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
        except Exception as e:
            self.failed = f"{type(e).__name__}: {e}"
            logger.warning("device trace stop failed (%s); no trace under %s",
                           e, self.log_dir)
            return None
        self.trace_path = path
        logger.info("device trace capture written to %s (view: "
                    "https://ui.perfetto.dev)", path)
        return self.log_dir


_CAPTURE: Optional[DeviceTraceCapture] = None
_ENV_ARMED = False


def capture_device_trace(log_dir: Optional[str] = None,
                         n_units: Optional[int] = None
                         ) -> Optional[DeviceTraceCapture]:
    """Arm and start a windowed device capture (the process-global one the
    train/serving loops count down).  ``log_dir`` defaults to
    ``$DS_TPU_DEVICE_TRACE``; ``n_units`` bounds the window in loop units,
    ``None`` means until :func:`stop_device_trace`.  A capture already
    running wins (the caller gets it back unchanged); a failed profiler
    start returns ``None``."""
    global _CAPTURE
    if _CAPTURE is not None and _CAPTURE.active:
        return _CAPTURE
    if log_dir is None:
        log_dir = os.environ.get(DEVICE_TRACE_ENV, "").strip()
        if not log_dir:
            raise ValueError(
                "capture_device_trace needs a log_dir (or set "
                f"${DEVICE_TRACE_ENV})")
    cap = DeviceTraceCapture(log_dir, n_units=n_units)
    if cap.failed is not None:
        return None
    _CAPTURE = cap
    return cap


def device_capture_active() -> bool:
    cap = _CAPTURE
    return cap is not None and cap.active


def device_trace_unit() -> None:
    """Step/tick boundary hook: one global ``None`` check when no capture
    is armed — the loops call this unconditionally every unit."""
    cap = _CAPTURE
    if cap is not None and cap.active:
        cap.unit()


def stop_device_trace() -> Optional[str]:
    """Stop the process-global capture (if any); returns the log dir."""
    cap = _CAPTURE
    if cap is None:
        return None
    return cap.stop()


def maybe_capture_from_env() -> Optional[DeviceTraceCapture]:
    """Arm the env-configured capture once per process: with
    ``DS_TPU_DEVICE_TRACE=<dir>`` set, the first engine init starts a
    capture of ``DS_TPU_DEVICE_TRACE_UNITS`` (default 16) loop units into
    ``<dir>``.  Later calls (more engines, warm-restart replacements) are
    no-ops — one windowed capture per process, not one per engine."""
    global _ENV_ARMED
    raw = os.environ.get(DEVICE_TRACE_ENV, "").strip()
    if not raw or _ENV_ARMED:
        return None
    _ENV_ARMED = True
    units_raw = os.environ.get(DEVICE_TRACE_UNITS_ENV, "").strip()
    units = DEFAULT_CAPTURE_UNITS
    if units_raw:
        try:
            units = int(units_raw)
        except ValueError:
            logger.warning("ignoring malformed $%s=%r (want an int)",
                           DEVICE_TRACE_UNITS_ENV, units_raw)
    try:
        return capture_device_trace(raw, n_units=units)
    except Exception as e:   # pragma: no cover - defensive
        logger.warning("env-armed device trace failed (%s); continuing "
                       "without", e)
        return None
