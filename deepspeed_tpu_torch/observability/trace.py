"""Low-overhead structured span tracer (counterpart of
``deepspeed_tpu/observability/trace.py``, copied; the sync point waits on
CUDA tensors).

Spans are nested per thread, stamped with monotonic clocks and fed on
completion into a bounded :class:`~.flight_recorder.FlightRecorder` ring.
A disabled tracer's ``span()`` is one attribute check returning a shared
no-op context.  A span that unwinds on an exception is still recorded,
carrying the exception type, so a flight-recorder dump after a fault covers
the poisoned tick.  Span contexts accept an optional sync point
(:meth:`_SpanCtx.sync`): on exit the tracer synchronises the devices of the
registered tensors before the end stamp (only while tracing is enabled).

The process-global tracer (:func:`get_tracer` / :func:`configure_tracer` /
:func:`trace_span` / :func:`trace_count`) is the instrumentation surface.
``DS_TPU_TRACE=1`` enables it at import; ``DS_TPU_TRACE=/path/out.json``
also writes a Chrome/Perfetto trace at interpreter exit (``export.py``;
``DS_TPU_TRACE_CAPACITY`` sizes the ring).
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .flight_recorder import CounterEvent, FlightRecorder
from .slo import LogBucketHistogram


def _synchronize(tree: Any) -> None:
    """Wait for the device work behind every CUDA tensor in ``tree``."""
    import torch

    stack, devices = [tree], set()
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
            devices.add(x.device)
    for d in devices:
        torch.cuda.synchronize(d)

# a callable name -> context manager every span enters alongside its host
# bookkeeping (a device profiler's named regions); None unless one is
# installed, so the hot path pays one module-global load.
_DEVICE_ANNOTATION = None


def _set_device_annotation_factory(factory) -> None:
    global _DEVICE_ANNOTATION
    _DEVICE_ANNOTATION = factory


# --------------------------------------------------------------- trace context
#
# Request-scoped tracing (docs/OBSERVABILITY.md "Distributed tracing"): a
# thread-local stack of TAG dicts.  `trace_context(trace_id, rid)` pushes
# the request identity; `trace_tags(engine=...)` pushes ambient tags (the
# fleet member's engine id, a rollout round's sequence id).  Every span
# opened under an active context inherits the merged tags into its attrs,
# so the flight ring, the Chrome/Perfetto export (`args`) and the published
# fleet trace segments all carry the request identity with zero plumbing.
# The stack holds PRE-MERGED dicts (child = parent ∪ own at push time), so
# the per-span cost is one thread-local read; with the tracer disabled the
# context manager body is skipped entirely and trace_span's ~280ns
# disabled-callsite gate is untouched (disabled spans record nothing, so
# tags would have nowhere to land anyway).

_CTX = threading.local()


def new_trace_id() -> str:
    """A fresh fleet-unique trace id (one per request; every hop —
    router, engines, failover replacements — propagates it verbatim)."""
    return uuid.uuid4().hex[:16]


class trace_context:
    """Context manager activating a request trace context on this thread.

    ``trace_context(trace_id, rid)`` tags every span opened under it with
    ``trace_id``/``rid``; extra keyword tags ride along.  Contexts nest
    (inner tags shadow outer ones) and are strictly thread-local.  When
    the global tracer is disabled the manager is inert — no allocation,
    no thread-local mutation."""

    __slots__ = ("_tags", "_pushed")

    def __init__(self, trace_id: Optional[str] = None, rid: Any = None,
                 **tags):
        if trace_id is not None:
            tags["trace_id"] = trace_id
        if rid is not None:
            tags["rid"] = rid
        self._tags = tags
        self._pushed = False

    def __enter__(self):
        if not _GLOBAL.enabled or not self._tags:
            return self
        stack = getattr(_CTX, "stack", None)
        if stack is None:
            stack = _CTX.stack = []
        merged = dict(stack[-1], **self._tags) if stack else self._tags
        stack.append(merged)
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._pushed:
            _CTX.stack.pop()
            self._pushed = False
        return False


def trace_tags(**tags) -> trace_context:
    """Ambient-tag context: like :class:`trace_context` but with no
    request identity — e.g. ``trace_tags(engine="engine0")`` around a
    fleet member's tick so every span it opens is attributable to that
    member even when N in-process members share one tracer ring."""
    return trace_context(None, None, **tags)


def current_trace_tags() -> Optional[Dict[str, Any]]:
    """The merged tag dict of this thread's active trace context, or
    ``None`` — what every span opened right now would inherit."""
    stack = getattr(_CTX, "stack", None)
    return stack[-1] if stack else None


class Span:
    """One completed (or still-open) traced section.

    ``t0`` is ``time.monotonic()`` at entry; ``dur_s`` is ``None`` while the
    span is open.  ``depth``/``parent`` come from the owning thread's span
    stack; ``error`` is the exception type name when the section unwound."""

    __slots__ = ("name", "t0", "dur_s", "tid", "thread", "depth", "parent",
                 "attrs", "error")

    def __init__(self, name: str, t0: float, tid: int, thread: str,
                 depth: int, parent: Optional[str],
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.t0 = t0
        self.dur_s: Optional[float] = None
        self.tid = tid
        self.thread = thread
        self.depth = depth
        self.parent = parent
        self.attrs = attrs
        self.error: Optional[str] = None

    def __repr__(self):
        dur = f"{self.dur_s * 1e3:.3f}ms" if self.dur_s is not None else "open"
        return (f"Span({self.name!r}, {dur}, depth={self.depth}"
                + (f", error={self.error}" if self.error else "") + ")")


class _NullSpan:
    """Shared do-nothing context returned by a disabled tracer.  ``sync``
    and ``set`` are no-ops so instrumentation sites never branch on the
    tracer state themselves."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def sync(self, tree: Any) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _AnnotationSpan:
    """Annotation-only span: what ``trace_span`` returns while a device
    capture is active but the HOST tracer is disabled — the profiler's
    timeline still gets the named region, with no host recording cost.  ``sync``
    and ``set`` are no-ops like the null span's.  A profiler hiccup must
    never fail the instrumented section, so every annotation call is
    guarded."""

    __slots__ = ("_annot",)

    def __init__(self, name: str, factory):
        try:
            self._annot = factory(name)
        except Exception:
            self._annot = None

    def __enter__(self):
        if self._annot is not None:
            try:
                self._annot.__enter__()
            except Exception:
                self._annot = None
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        return False

    def sync(self, tree: Any) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


class _SpanCtx:
    """Live span context: pushes onto the owning thread's stack on enter,
    stamps duration (after an optional device sync point) and
    feeds the recorder on exit — including exception unwinds."""

    __slots__ = ("_tracer", "_span", "_sync_tree", "_annot")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._sync_tree = None
        self._annot = None
        # active trace context (docs/OBSERVABILITY.md "Distributed
        # tracing"): merge its tags under the explicit attrs — the span
        # inherits trace_id/rid/ambient tags with explicit attrs winning
        ctx = getattr(_CTX, "stack", None)
        if ctx:
            attrs = dict(ctx[-1], **attrs) if attrs else dict(ctx[-1])
        stack = tracer._thread_stack()
        parent = stack[-1].name if stack else None
        self._span = Span(name, 0.0, threading.get_ident(),
                          threading.current_thread().name, len(stack),
                          parent, attrs)

    def sync(self, tree: Any) -> None:
        """Register tensors whose device work must finish before the end
        stamp (a CUDA synchronisation, only while tracing is enabled)."""
        self._sync_tree = tree

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. tokens decoded)."""
        if self._span.attrs is None:
            self._span.attrs = attrs
        else:
            self._span.attrs.update(attrs)

    def __enter__(self):
        self._tracer._thread_stack().append(self._span)
        fac = _DEVICE_ANNOTATION
        if fac is not None:
            # device capture active: mirror this span as a named region on
            # the profiler's timeline (torch.profiler.record_function).  Never let a profiler
            # hiccup fail the instrumented section itself.
            try:
                annot = fac(self._span.name)
                annot.__enter__()
                self._annot = annot
            except Exception:
                self._annot = None
        self._span.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sync_tree is not None:
            try:
                _synchronize(self._sync_tree)
            except Exception:   # a poisoned tree must not mask the real exc
                pass
        if self._annot is not None:
            # close AFTER the sync so the blocked device wait is attributed
            # inside the annotated region on the profiler timeline
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        sp = self._span
        sp.dur_s = time.monotonic() - sp.t0
        if exc_type is not None:
            sp.error = exc_type.__name__
        stack = self._tracer._thread_stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:   # unbalanced exit (generator abandoned mid-span): best effort
            try:
                stack.remove(sp)
            except ValueError:
                pass
        self._tracer._record(sp)
        return False


class Tracer:
    """Span tracer + counter sink over a :class:`FlightRecorder` ring.

    ::

        tracer = Tracer(enabled=True)
        with tracer.span("serve.tick", tick=7):
            with tracer.span("serve.decode") as sp:
                out = decode_program(...)
                sp.sync(out)          # stamp AFTER the device finishes
        tracer.count("serve.tokens", 4)

    Thread model: span nesting is tracked per thread (thread-local stacks);
    completion feeds one shared recorder.  The per-thread stacks are also
    registered in a process-wide map so :meth:`open_spans` (and through it
    the flight-recorder dump) can show what every thread was *inside* at
    dump time — the hung section is exactly the span that never completed.
    """

    def __init__(self, enabled: bool = False,
                 recorder: Optional[FlightRecorder] = None):
        self.enabled = bool(enabled)
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self._tls = threading.local()
        # tid -> (thread name, live stack).  The lock guards only REGISTRY
        # mutation (once per thread) and the open_spans snapshot — never the
        # per-span hot path; it keeps the crash-dump read safe against a
        # brand-new thread registering mid-dump (and free-threaded builds).
        self._open: Dict[int, Tuple[str, List[Span]]] = {}
        self._open_lock = threading.Lock()
        self._agg: Dict[str, List[float]] = {}   # name -> [count, total_s]
        # per-span-name duration histograms (observability/slo.py): live
        # quantiles without replaying the ring — count+sum alone cannot
        # answer "serve.tick p99"
        self._hist: Dict[str, LogBucketHistogram] = {}
        self._agg_lock = threading.Lock()

    # ------------------------------------------------------------ recording

    def span(self, name: str, **attrs) -> Any:
        """Context manager for one traced section.  Disabled: returns the
        shared null span (no allocation, no clock read)."""
        if not self.enabled:
            fac = _DEVICE_ANNOTATION
            if fac is not None:
                return _AnnotationSpan(name, fac)
            return _NULL_SPAN
        return _SpanCtx(self, name, attrs or None)

    def count(self, name: str, value: float = 1.0, **attrs) -> None:
        """Record a counter event (monotonic-stamped) into the recorder."""
        if not self.enabled:
            return
        self.recorder.add(CounterEvent(name, time.monotonic(), float(value),
                                       threading.get_ident(), attrs or None))

    def _thread_stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
            with self._open_lock:
                self._open[threading.get_ident()] = (
                    threading.current_thread().name, stack)
        return stack

    def _record(self, span: Span) -> None:
        self.recorder.add(span)
        with self._agg_lock:
            agg = self._agg.get(span.name)
            if agg is None:
                self._agg[span.name] = [1.0, span.dur_s]
            else:
                agg[0] += 1.0
                agg[1] += span.dur_s
            hist = self._hist.get(span.name)
            if hist is None:
                hist = self._hist[span.name] = LogBucketHistogram()
            hist.observe(span.dur_s)

    # ----------------------------------------------------------- inspection

    def aggregates(self) -> Dict[str, Tuple[int, float]]:
        """name -> (completed count, total seconds), since construction /
        :meth:`reset` — retention-independent (survives ring eviction)."""
        with self._agg_lock:
            return {k: (int(v[0]), v[1]) for k, v in self._agg.items()}

    def histograms(self) -> Dict[str, Dict[str, Any]]:
        """Per-span-name duration histogram snapshots (cumulative bucket
        counts per ``le`` bound + count/sum) — what the Prometheus
        exposition renders as real histogram families."""
        with self._agg_lock:
            return {name: h.snapshot() for name, h in self._hist.items()}

    def span_quantile(self, name: str, q: float) -> Optional[float]:
        """The ``q``-quantile of ``name``'s completed-span durations, or
        ``None`` when that span was never recorded — live, bounded memory,
        retention-independent (observability/slo.py feeds SLO rules from
        this)."""
        with self._agg_lock:
            hist = self._hist.get(name)
            return hist.quantile(q) if hist is not None else None

    def open_spans(self) -> List[Span]:
        """Spans currently on ANY thread's stack, outermost first — what
        each thread is inside right now (``dur_s`` still ``None``).  Also
        prunes registry entries of exited threads with empty stacks, so
        thousands of short-lived traced threads (async-checkpoint commits)
        cannot grow the map unboundedly; a dead thread that ABANDONED an
        open span is kept — that is exactly what a dump should show."""
        with self._open_lock:
            live = {t.ident for t in threading.enumerate()}
            for tid in [tid for tid, (_n, st) in self._open.items()
                        if not st and tid not in live]:
                del self._open[tid]
            stacks = list(self._open.values())
        out: List[Span] = []
        for _name, stack in stacks:
            out.extend(list(stack))
        return out

    def flight_dump(self, reason: str, last_s: Optional[float] = None) -> str:
        """Formatted flight-recorder dump: completed spans + counters from
        the ring (optionally only the trailing ``last_s`` seconds) plus an
        open-spans section per thread.  See ``FlightRecorder.dump``."""
        return self.recorder.dump(reason, last_s=last_s,
                                  open_spans=self.open_spans())

    def reset(self) -> None:
        """Drop recorded history + aggregates (open stacks are untouched —
        they belong to live ``with`` blocks)."""
        self.recorder.clear()
        with self._agg_lock:
            self._agg.clear()
            self._hist.clear()


# --------------------------------------------------------------- global hook
#
# Instrumentation sites reach the tracer through these module functions —
# no handle plumbing, and the disabled fast path stays one attribute check.

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def configure_tracer(enabled: Optional[bool] = None,
                     capacity: Optional[int] = None) -> Tracer:
    """Reconfigure the process-global tracer in place (the instance is
    shared by reference, so instrumentation sites see the change
    immediately).  ``capacity`` rebuilds the ring, dropping history."""
    if capacity is not None:
        _GLOBAL.recorder = FlightRecorder(capacity=capacity)
    if enabled is not None:
        _GLOBAL.enabled = bool(enabled)
    return _GLOBAL


def trace_span(name: str, **attrs) -> Any:
    """``get_tracer().span(...)`` — the one-liner instrumentation sites use."""
    if not _GLOBAL.enabled:
        fac = _DEVICE_ANNOTATION
        if fac is not None:
            # device capture active with the host tracer off: the
            # profiler's timeline still gets the named region
            # (device_profiler.py)
            return _AnnotationSpan(name, fac)
        return _NULL_SPAN
    return _SpanCtx(_GLOBAL, name, attrs or None)


def trace_count(name: str, value: float = 1.0, **attrs) -> None:
    if _GLOBAL.enabled:
        _GLOBAL.count(name, value, **attrs)


# trailing window crash paths dump by default: bounds a dump to the recent
# past even when the ring is configured huge (chaos soak uses 1<<17 records
# — serializing all of it per failed round would swamp the report stream)
DEFAULT_DUMP_WINDOW_S = 60.0
DUMP_WINDOW_ENV = "DS_TPU_DUMP_WINDOW_S"


def dump_window_s() -> float:
    """The trailing window (seconds) crash-path dumps keep.  Defaults to
    :data:`DEFAULT_DUMP_WINDOW_S`; ``DS_TPU_DUMP_WINDOW_S`` widens it for
    long pod rounds whose post-mortem needs more than the last minute
    (read per call so a supervisor can be re-windowed without a restart).
    Malformed or non-positive values degrade to the default — a typo in an
    env var must never break a crash path."""
    raw = os.environ.get(DUMP_WINDOW_ENV, "").strip()
    if raw:
        try:
            v = float(raw)
            if v > 0:
                return v
        except ValueError:
            pass
        import logging

        logging.getLogger(__name__).warning(
            "ignoring malformed $%s=%r (want a positive number of seconds)",
            DUMP_WINDOW_ENV, raw)
    return DEFAULT_DUMP_WINDOW_S


def flight_dump(reason: str, monitor=None,
                last_s: Optional[float] = None) -> Optional[str]:
    """Dump the global tracer's flight recorder, or ``None`` when there is
    nothing to show (tracer never enabled / nothing recorded) — callers on
    crash paths can unconditionally call this and skip on ``None``.

    With ``monitor``, the dump is also shipped through
    ``monitor.write_report("flight_recorder/<reason>", text)`` so it lands
    next to the training/serving metrics (csv backends persist it;
    ``InMemoryMonitor`` captures it for tests).

    Requires the tracer to be CURRENTLY enabled: a crash after tracing was
    switched off must not ship a stale ring from an unrelated earlier
    traced pass as its post-mortem (call ``Tracer.flight_dump`` directly to
    dump retained history explicitly)."""
    t = _GLOBAL
    if not t.enabled:
        return None
    if not t.recorder.record_count() and not t.open_spans():
        return None
    text = t.flight_dump(reason, last_s=last_s)
    if monitor is not None:
        try:
            monitor.write_report(f"flight_recorder/{reason}", text)
        except Exception:
            pass   # a dump must never mask the fault being diagnosed
    return text


# env hook: DS_TPU_TRACE=1 enables; DS_TPU_TRACE=/path.json also registers
# an atexit Chrome-trace export; DS_TPU_TRACE_CAPACITY sizes the ring
TRACE_ENV = "DS_TPU_TRACE"
TRACE_CAPACITY_ENV = "DS_TPU_TRACE_CAPACITY"

_env_spec = os.environ.get(TRACE_ENV, "").strip()
if _env_spec and _env_spec.lower() not in ("0", "false", "off", "no"):
    _cap = os.environ.get(TRACE_CAPACITY_ENV)
    try:
        _cap_n = int(_cap) if _cap else None
    except ValueError:
        # a malformed capacity must degrade, not make the library
        # unimportable — observability never gates the product
        import logging

        logging.getLogger(__name__).warning(
            "ignoring malformed $%s=%r (want an int)",
            TRACE_CAPACITY_ENV, _cap)
        _cap_n = None
    configure_tracer(enabled=True, capacity=_cap_n)
    if _env_spec.lower() not in ("1", "true", "on", "yes"):
        import atexit

        def _export_at_exit(path=_env_spec):
            from .export import write_chrome_trace

            try:
                write_chrome_trace(path)
            except Exception:
                pass

        atexit.register(_export_at_exit)
