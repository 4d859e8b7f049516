"""Bounded flight recorder: the last N spans/counters, always available
(counterpart of ``deepspeed_tpu/observability/flight_recorder.py``,
copied: framework-free).

The tracer feeds every completed span and counter event into a bounded
ring; when something dies (a serving warm restart) the crash path calls
:meth:`FlightRecorder.dump`, so the restart log carries the last seconds of
scheduler history instead of a bare stack trace.  Bounded (``capacity``
records, evictions counted as ``dropped``), thread-safe (one lock around
the ring) and cheap (one deque append per completed span; the tracer's
disabled fast path never reaches it).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, NamedTuple, Optional


class CounterEvent(NamedTuple):
    """A point-in-time counter sample (tokens emitted, requests shed...)."""

    name: str
    t: float          # time.monotonic() stamp
    value: float
    tid: int
    attrs: Optional[dict]


DEFAULT_CAPACITY = 8192


class FlightRecorder:
    """Ring buffer of completed spans + counter events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0   # records evicted by the bound, for the dump header

    def add(self, record: Any) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(record)

    def record_count(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self, last_s: Optional[float] = None) -> List[Any]:
        """Copy of the ring in record order; ``last_s`` keeps only records
        whose stamp falls in the trailing window (spans stamp at entry)."""
        with self._lock:
            records = list(self._ring)
        if last_s is None:
            return records
        cutoff = time.monotonic() - last_s
        return [r for r in records
                if (r.t0 if hasattr(r, "t0") else r.t) >= cutoff]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # -------------------------------------------------------------- dumping

    def dump(self, reason: str, last_s: Optional[float] = None,
             open_spans: Optional[List[Any]] = None) -> str:
        """Human-readable dump: header, the recorded window oldest-first,
        then every still-open span (the hung/poisoned section is usually
        here).  Timestamps print relative to the newest record so the tail
        of the timeline reads as "how long before the crash"."""
        records = self.snapshot(last_s=last_s)
        open_spans = open_spans or []
        now = time.monotonic()
        anchor = max((r.t0 if hasattr(r, "t0") else r.t) for r in records) \
            if records else now
        lines = [
            f"FLIGHT RECORDER DUMP: {reason}",
            f"records={len(records)}/{self.capacity} dropped={self.dropped} "
            f"window={'%.1fs' % last_s if last_s is not None else 'all'} "
            f"open_spans={len(open_spans)}",
            "",
            "  t_rel      dur        span/counter",
        ]
        for r in records:
            if hasattr(r, "t0"):   # Span
                rel = r.t0 - anchor
                dur = (f"{r.dur_s * 1e3:9.3f}ms" if r.dur_s is not None
                       else "     open")
                tail = "" if r.attrs is None else f"  {r.attrs}"
                err = f"  !{r.error}" if r.error else ""
                lines.append(f"  {rel:+9.3f}s {dur}  "
                             f"{'  ' * r.depth}{r.name}"
                             f" [{r.thread}]{tail}{err}")
            else:                  # CounterEvent
                rel = r.t - anchor
                tail = "" if r.attrs is None else f"  {r.attrs}"
                lines.append(f"  {rel:+9.3f}s {'':>11}  "
                             f"#{r.name}={r.value:g}{tail}")
        if open_spans:
            lines.append("")
            lines.append("  open spans at dump time (outermost first):")
            for sp in open_spans:
                tail = "" if sp.attrs is None else f"  {sp.attrs}"
                lines.append(
                    f"    {'  ' * sp.depth}{sp.name} [{sp.thread}] "
                    f"open {max(0.0, now - sp.t0):.3f}s{tail}")
        return "\n".join(lines)
