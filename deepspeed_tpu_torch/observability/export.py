"""Trace exporters: Chrome/Perfetto trace-event JSON and Prometheus text
(counterpart of ``deepspeed_tpu/observability/export.py``, copied:
framework-free).

Two render targets for the same recorded data:

- :func:`chrome_trace_events` / :func:`write_chrome_trace` — the Trace Event
  Format (``chrome://tracing`` / https://ui.perfetto.dev): each completed
  span becomes one ``"ph": "X"`` complete event (µs timestamps on the
  process monotonic clock), each counter a ``"ph": "C"`` event, plus ``M``
  metadata naming threads.  ``DS_TPU_TRACE=/path/out.json`` writes one at
  interpreter exit.
- :func:`prometheus_text` — the Prometheus exposition format: the latest
  value of every monitor gauge (anything with an ``events`` stream of
  ``(name, value, step)``, e.g. :class:`~..monitor.InMemoryMonitor`) plus
  the tracer's span aggregates as ``_count``/``_seconds_total`` pairs and
  duration histograms, served by :class:`MetricsServer` on ``/metrics``
  (``DS_TPU_METRICS_PORT`` starts one per process).

Exporters read; they never mutate recorder state, so exporting mid-run is
safe (the snapshot is taken under the recorder lock).
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional


def chrome_trace_events(records: List[Any],
                        process_name: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Render recorder records (spans + counters) as trace-event dicts.
    ``process_name`` additionally emits a ``process_name`` metadata event
    (engine id, router term, supervisor incarnation — whatever names this
    process) so a trace merged with others stays readable in Perfetto
    without a pid decoder ring."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    if process_name:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": str(process_name)}})
    threads: Dict[int, str] = {}
    for r in records:
        if hasattr(r, "t0"):      # Span
            if r.dur_s is None:   # open span: renderable as a zero-dur mark
                continue
            # overwrite, not setdefault: a counter event seen first leaves
            # "" for this tid and must not block the thread_name metadata
            threads[r.tid] = r.thread
            ev: Dict[str, Any] = {
                "name": r.name,
                "cat": r.name.split(".", 1)[0],
                "ph": "X",
                "ts": r.t0 * 1e6,
                "dur": r.dur_s * 1e6,
                "pid": pid,
                "tid": r.tid,
            }
            args = dict(r.attrs) if r.attrs else {}
            if r.error:
                args["error"] = r.error
            if args:
                ev["args"] = args
            events.append(ev)
        else:                     # CounterEvent
            threads.setdefault(r.tid, "")
            events.append({
                "name": r.name,
                "ph": "C",
                "ts": r.t * 1e6,
                "pid": pid,
                "tid": r.tid,
                "args": {"value": r.value},
            })
    for tid, name in threads.items():
        if name:
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})
    return events


def write_chrome_trace(path: str, records: Optional[List[Any]] = None,
                       metadata: Optional[Dict[str, Any]] = None,
                       process_name: Optional[str] = None) -> str:
    """Write a complete Chrome/Perfetto trace JSON.  ``records`` defaults
    to the global tracer's full recorder snapshot; ``process_name`` names
    this process's track (see :func:`chrome_trace_events`)."""
    if records is None:
        from .trace import get_tracer

        records = get_tracer().recorder.snapshot()
    doc: Dict[str, Any] = {
        "traceEvents": chrome_trace_events(records,
                                           process_name=process_name),
        "displayTimeUnit": "ms",
    }
    if metadata:
        doc["otherData"] = metadata
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)   # a torn trace file is worse than none
    return path


# ------------------------------------------------------------- prometheus
#
# Exposition-format conformance (validated by a minimal parser in
# the tests against a live scrape): every
# family carries # HELP and # TYPE lines, label values are escaped per the
# spec (backslash, double-quote, newline), and ALL metric/label-name
# sanitization funnels through _prom_name/_prom_label_key below — the one
# place the `/` -> `_` mapping lives.

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, prefix: str = "dstpu_") -> str:
    n = prefix + _PROM_BAD.sub("_", name)
    return "_" + n if n[0].isdigit() else n


def _prom_label_key(key: str) -> str:
    k = _PROM_LABEL_BAD.sub("_", key) or "_"
    return "_" + k if k[0].isdigit() else k


def _prom_label_value(value: str) -> str:
    """Escape a label value per the exposition format: backslash, double
    quote, and literal newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _split_labels(name: str):
    """Split a monitor event name of the form ``base{k=v,k2=v2}`` into
    ``(base, [(k, v), ...])``.  This is how label-carrying gauges ride the
    flat ``(name, value, step)`` monitor stream: the serving engine writes
    e.g. ``serve/program_flops{program=decode}`` and the exposition
    renders ``dstpu_serve_program_flops{program="decode"}``.  A name with
    no (or malformed) label suffix is a plain gauge."""
    if not name.endswith("}"):
        return name, []
    i = name.find("{")
    if i <= 0:
        return name, []
    base, inner = name[:i], name[i + 1:-1]
    labels = []
    for part in inner.split(","):
        k, sep, v = part.partition("=")
        if not sep or not k.strip():
            return name, []   # not the label grammar: treat as a flat name
        labels.append((k.strip(), v))
    return base, labels


def _render_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_label_key(k)}="{_prom_label_value(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


# HELP strings for the families this tree emits; anything else gets the
# generic fallback (HELP is documentation, not schema — unknown names must
# still expose cleanly)
_PROM_HELP = {
    "dstpu_span_count": "Completed spans per span name (tracer aggregate).",
    "dstpu_span_seconds_total":
        "Total seconds spent in completed spans per span name.",
    "dstpu_span_duration_seconds":
        "Log-bucketed duration histogram of completed spans per span name.",
    "dstpu_monitor_dropped_events_total":
        "Monitor ring evictions (bounded InMemoryMonitor).",
    "dstpu_flight_recorder_dropped_total":
        "Flight-recorder ring evictions (bounded span/counter ring).",
    "dstpu_alert":
        "SLO rule firing state per rule (1 = firing; observability/slo.py).",
}


def _help_for(pname: str) -> str:
    return _PROM_HELP.get(pname, f"deepspeed-tpu gauge {pname}")


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else f"{bound:g}"


def prometheus_text(monitor=None, tracer=None) -> str:
    """Prometheus exposition of monitor gauges + tracer span aggregates
    and duration histograms.

    ``monitor`` contributes the latest value per distinct event name (its
    ``events`` stream holds ``(name, value, step)`` — ``serve/*`` gauges,
    ``Train/Samples/*``; names may carry a ``{label=value}`` suffix, see
    :func:`_split_labels`); ``tracer`` (default: the global one)
    contributes ``dstpu_span_count`` / ``dstpu_span_seconds_total`` per
    span name, ``dstpu_span_duration_seconds`` histogram families, and
    ring-drop accounting."""
    lines: List[str] = []

    def family(pname: str, kind: str) -> None:
        lines.append(f"# HELP {pname} {_help_for(pname)}")
        lines.append(f"# TYPE {pname} {kind}")

    if monitor is not None:
        # prefer the monitor's write-maintained latest map: the event ring
        # is bounded, so deriving "latest per name" from it would drop
        # once-at-init gauges (mesh topology, pool bytes) as soon as
        # per-tick traffic rotates them out.  Duck-typed monitors without
        # the map fall back to scanning a locked snapshot of the ring.
        latest: Optional[Dict[str, float]] = None
        latest_fn = getattr(monitor, "latest_map", None)
        if latest_fn is not None:
            latest = latest_fn()
        else:
            snap_fn = getattr(monitor, "events_snapshot", None)
            events = snap_fn() if snap_fn is not None else getattr(
                monitor, "events", None)
            if events is not None:
                latest = {}
                for name, value, _step in list(events):
                    latest[name] = value
        if latest is not None:
            # group label-carrying samples under one family so # TYPE is
            # emitted once per family, not once per label set
            families: Dict[str, List[str]] = {}
            for name in sorted(latest):
                base, labels = _split_labels(name)
                pname = _prom_name(base)
                families.setdefault(pname, []).append(
                    f"{pname}{_render_labels(labels)} {latest[name]:g}")
            for pname in sorted(families):
                family(pname, "gauge")
                lines.extend(families[pname])
        dropped = getattr(monitor, "dropped_events", None)
        if dropped is not None:
            family("dstpu_monitor_dropped_events_total", "counter")
            lines.append(f"dstpu_monitor_dropped_events_total {dropped}")
    if tracer is None:
        from .trace import get_tracer

        tracer = get_tracer()
    agg = tracer.aggregates()
    if agg:
        count_lines, total_lines = [], []
        for name in sorted(agg):
            count, total = agg[name]
            label = _prom_label_value(name)
            count_lines.append(f'dstpu_span_count{{span="{label}"}} {count}')
            total_lines.append(
                f'dstpu_span_seconds_total{{span="{label}"}} {total:.9f}')
        family("dstpu_span_count", "counter")
        lines.extend(count_lines)
        family("dstpu_span_seconds_total", "counter")
        lines.extend(total_lines)
    # span duration histograms (observability/slo.py): REAL prometheus
    # histograms — cumulative buckets per le bound + _sum/_count — so an
    # external prometheus can histogram_quantile() over scrapes instead of
    # trusting our in-process quantiles
    hists = tracer.histograms() if hasattr(tracer, "histograms") else {}
    if hists:
        family("dstpu_span_duration_seconds", "histogram")
        for name in sorted(hists):
            snap = hists[name]
            label = _prom_label_value(name)
            for bound, cum in snap["buckets"]:
                lines.append(
                    f'dstpu_span_duration_seconds_bucket{{span="{label}"'
                    f',le="{_fmt_le(bound)}"}} {cum}')
            lines.append(f'dstpu_span_duration_seconds_sum{{span="{label}"}}'
                         f' {snap["sum"]:.9f}')
            lines.append(
                f'dstpu_span_duration_seconds_count{{span="{label}"}}'
                f' {snap["count"]}')
    family("dstpu_flight_recorder_dropped_total", "counter")
    lines.append(
        f"dstpu_flight_recorder_dropped_total {tracer.recorder.dropped}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- /metrics endpoint

METRICS_PORT_ENV = "DS_TPU_METRICS_PORT"
# bind address for the env-gated endpoint; default reaches an external
# prometheus, set 127.0.0.1 to keep the gauges loopback-only
METRICS_HOST_ENV = "DS_TPU_METRICS_HOST"


class MetricsServer:
    """Serve :func:`prometheus_text` from a stdlib ``/metrics`` endpoint.

    A daemon-threaded ``ThreadingHTTPServer`` — no dependency beyond the
    standard library, cheap enough to leave running for the lifetime of a
    pod host so every scrape sees the live monitor gauges (``serve/*``,
    ``pod/*``, ``Train/*``) and span aggregates.  The handler renders at
    request time; the exporters only read under their own locks, so a
    scrape mid-run is safe.  ``port=0`` binds an ephemeral port (tests),
    readable on :attr:`port` after construction.
    """

    def __init__(self, port: int = 0, monitor=None, tracer=None,
                 host: str = "0.0.0.0"):
        import http.server
        import threading

        self.monitor = monitor
        self.tracer = tracer
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib handler contract)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = prometheus_text(monitor=server.monitor,
                                           tracer=server.tracer).encode()
                except Exception as e:   # a scrape must never crash the job
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not log events
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, int(port)),
                                                      Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dstpu-metrics", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


_METRICS_SERVER: Optional[MetricsServer] = None


def start_metrics_server(port: int = 0, monitor=None,
                         tracer=None) -> MetricsServer:
    """Explicitly start a /metrics endpoint (caller owns ``close()``)."""
    return MetricsServer(port=port, monitor=monitor, tracer=tracer)


def bind_metrics_server(port: int, monitor=None, tracer=None,
                        host: str = "0.0.0.0",
                        label: str = "metrics endpoint"
                        ) -> Optional[MetricsServer]:
    """Bind a /metrics server with the shared fallback policy: a taken
    FIXED port degrades to an ephemeral bind (the Nth engine on a host
    must neither crash at init nor silently lose its endpoint — the bound
    port is advertised, not assumed), and ``None`` is returned only when
    even the ephemeral bind fails.  One implementation for the env-gated
    process server AND per-fleet-member endpoints, so the policy cannot
    drift between them."""
    from ..utils.logging import logger

    try:
        return MetricsServer(port=int(port), monitor=monitor, tracer=tracer,
                             host=host)
    except OSError as e:
        if int(port) == 0:
            logger.warning("%s on %s (ephemeral) unavailable (%s); "
                           "continuing without", label, host, e)
            return None
        logger.warning("%s port %d taken (%s); binding an ephemeral port "
                       "instead", label, int(port), e)
        try:
            return MetricsServer(port=0, monitor=monitor, tracer=tracer,
                                 host=host)
        except OSError as e2:   # pragma: no cover - no ports at all
            logger.warning("%s on %s unavailable (%s); continuing without",
                           label, host, e2)
            return None


def maybe_start_metrics_server(monitor=None) -> Optional[MetricsServer]:
    """Opt-in process-global endpoint: starts once when
    ``DS_TPU_METRICS_PORT`` is set (``0`` = ephemeral), else ``None``.
    Later calls return the running server, re-pointing it at the newest
    ``monitor`` (latest wins: after an in-process engine rebuild the
    scrape must show the LIVE engine's gauges, not the dead one's) — the
    engine calls this at init so a pod run is scrapeable with nothing but
    the env var."""
    global _METRICS_SERVER
    raw = os.environ.get(METRICS_PORT_ENV, "").strip()
    if not raw:
        return None
    if _METRICS_SERVER is not None:
        if monitor is not None:
            _METRICS_SERVER.monitor = monitor
        return _METRICS_SERVER
    from ..utils.logging import logger

    try:
        port = int(raw)
    except ValueError:
        logger.warning("ignoring malformed $%s=%r (want an int port)",
                       METRICS_PORT_ENV, raw)
        return None
    host = os.environ.get(METRICS_HOST_ENV, "").strip() or "0.0.0.0"
    # observability never gates the job: a taken port falls back to an
    # ephemeral bind (the ACTUAL port is advertised via
    # ServingEngine.health()), and total failure degrades to a warning
    _METRICS_SERVER = bind_metrics_server(port, monitor=monitor, host=host)
    if _METRICS_SERVER is None:
        return None
    logger.info("metrics endpoint serving on %s:%d/metrics", host,
                _METRICS_SERVER.port)
    return _METRICS_SERVER


def get_metrics_server() -> Optional[MetricsServer]:
    """The process-global env-gated server, if one is running."""
    return _METRICS_SERVER
