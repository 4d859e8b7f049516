"""Cross-process trace assembly: span segments of several processes merged
into one Perfetto file (counterpart of
``deepspeed_tpu/observability/trace_assembly.py``; copied: framework-free).

- :func:`span_record` — one completed span as a JSON-safe segment record
  (``t0``/``dur`` on the recording process's monotonic clock).
- :class:`TraceSegmentPublisher` — drains newly completed spans from a
  tracer ring (optionally filtered) and CAS-appends them as bounded
  segments under a coordination-store key (``fleet/trace/<owner>``,
  ``elasticity.coordination.append_trace_segment``), each with the writing
  process's monotonic/epoch clock anchor; :func:`load_segments` reads them
  back.
- :func:`clock_offsets` / :func:`assemble_fleet_trace` — merge per-owner
  segment documents (``{"owner_id", "anchor": {"epoch", "mono"}, "attrs",
  "spans": [record, ...], "dropped"}``) into ONE Chrome/Perfetto trace:
  one ``pid`` track per owner named by ``process_name`` metadata, each
  span's monotonic ``t0`` corrected onto the shared epoch timeline through
  its owner's clock anchor, span tags (``trace_id``/``rid``) as ``args``.
- :func:`events_for_trace` — one request's complete-span events in
  corrected-timestamp order.

Within one host ``time.time()`` is shared, so anchor-based correction is
exact up to the anchor read jitter; across hosts it inherits the hosts'
wall-clock agreement.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .trace import Span, Tracer, get_tracer

__all__ = ["TraceSegmentPublisher", "assemble_fleet_trace", "clock_offsets",
           "events_for_trace", "load_segments", "span_record"]


def _json_value(v: Any) -> Any:
    """Tag values must survive JSON round-trips: primitives pass, small
    dicts of primitives pass (the slot→rid map), anything else stringifies
    — a publish must never fail on an exotic attr value."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_value(x) for k, x in v.items()}
    return str(v)


def span_record(span: Span) -> Dict[str, Any]:
    """One completed span as a JSON-safe segment record.  ``t0``/``dur``
    stay on the recording process's monotonic clock — the segment's clock
    anchor, not the record, carries the epoch mapping."""
    return {
        "name": span.name,
        "t0": span.t0,
        "dur": span.dur_s,
        "tid": span.tid,
        "thread": span.thread,
        "depth": span.depth,
        "tags": {str(k): _json_value(v)
                 for k, v in (span.attrs or {}).items()},
        "error": span.error,
    }


class TraceSegmentPublisher:
    """Incremental publisher of one owner's completed spans to the store.

    ``span_filter(span) -> bool`` selects which ring spans belong to this
    owner (fleet members filter on their ambient ``engine`` tag; the
    router takes the ``fleet.*`` spans) — necessary because in-process
    harnesses share ONE tracer ring between N simulated processes, and
    harmless in production where the filter passes everything the process
    recorded.  A watermark on span END time makes publishes incremental:
    each call ships only spans that completed since the previous one.

    ``min_interval_s`` rate-limits non-forced publishes on the host
    monotonic clock (members additionally ride the beat cadence);
    ``publish(force=True)`` bypasses it — the final flush of a bench/soak.
    """

    def __init__(self, store, owner_id: str, prefix: str = "fleet/trace",
                 max_spans: int = 2048,
                 span_filter: Optional[Callable[[Span], bool]] = None,
                 min_interval_s: float = 0.25):
        self.store = store
        self.owner_id = str(owner_id)
        self.prefix = str(prefix)
        self.max_spans = int(max_spans)
        self.span_filter = span_filter
        self.min_interval_s = float(min_interval_s)
        self._published_until = float("-inf")   # watermark on span END
        self._last_publish_t: Optional[float] = None
        self.published_total = 0
        self.dropped_total = 0
        self.publishes_total = 0
        # per-publish store CAS wall time (bounded window): what
        # serve_bench --collect_traces reports p50/p99 over
        self._cas_lat_s: deque = deque(maxlen=2048)

    def pending(self, tracer: Optional[Tracer] = None) -> List[Span]:
        """Completed ring spans past the watermark that pass the filter
        (read-only — publish() is what advances the watermark)."""
        tracer = tracer if tracer is not None else get_tracer()
        out: List[Span] = []
        for r in tracer.recorder.snapshot():
            if not hasattr(r, "t0") or r.dur_s is None:
                continue   # counters and still-open spans never publish
            if r.t0 + r.dur_s <= self._published_until:
                continue
            if self.span_filter is not None and not self.span_filter(r):
                continue
            out.append(r)
        return out

    def publish(self, tracer: Optional[Tracer] = None, force: bool = False,
                attrs: Optional[Dict] = None) -> int:
        """Ship newly completed spans as one CAS-appended segment; returns
        the number published (0 when rate-limited, disabled, or idle)."""
        tracer = tracer if tracer is not None else get_tracer()
        if not tracer.enabled:
            return 0
        now = time.monotonic()
        if not force and self._last_publish_t is not None \
                and now - self._last_publish_t < self.min_interval_s:
            return 0
        spans = self.pending(tracer)
        self._last_publish_t = now
        if not spans:
            return 0
        from ..elasticity.coordination import append_trace_segment

        records = [span_record(s) for s in spans]
        t0 = time.perf_counter()
        doc = append_trace_segment(self.store, self.owner_id, records,
                                   prefix=self.prefix,
                                   max_spans=self.max_spans, attrs=attrs)
        self._cas_lat_s.append(time.perf_counter() - t0)
        self._published_until = max(s.t0 + s.dur_s for s in spans)
        self.published_total += len(records)
        self.dropped_total = int(doc.get("dropped") or 0)
        self.publishes_total += 1
        return len(records)

    def cas_latencies(self) -> List[float]:
        """Recent per-publish store CAS wall times in seconds."""
        return list(self._cas_lat_s)


# ----------------------------------------------------------------- assembly

def load_segments(store, prefix: str = "fleet/trace") -> Dict[str, Dict]:
    """owner_id -> newest segment document (thin wrapper so assembly-side
    callers never import the coordination module directly)."""
    from ..elasticity.coordination import read_trace_segments

    return read_trace_segments(store, prefix=prefix)


def clock_offsets(segments: Dict[str, Dict]) -> Dict[str, float]:
    """Per-owner monotonic→epoch offset from each segment's clock anchor
    (``epoch - mono``) — adding it to a span's monotonic ``t0`` places it
    on the shared epoch timeline.  Owners missing an anchor fall back to
    offset 0 (their track renders, uncorrected, rather than vanishing)."""
    out: Dict[str, float] = {}
    for owner, doc in segments.items():
        anchor = doc.get("anchor") or {}
        try:
            out[owner] = float(anchor["epoch"]) - float(anchor["mono"])
        except (KeyError, TypeError, ValueError):
            out[owner] = 0.0
    return out


def assemble_fleet_trace(segments: Dict[str, Dict],
                         out_path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-owner span segments into ONE Chrome/Perfetto trace doc.

    Each owner becomes one ``pid`` track named by ``process_name``
    metadata (owner id plus any segment attrs, e.g. the router's ``term``)
    with its threads named; every span's monotonic ``t0`` is skew-corrected
    onto the shared epoch timeline via the owner's clock anchor, and span
    tags (``trace_id``/``rid``/``slot_rids``/...) ride as ``args`` so
    Perfetto can filter one request across every track.  Events are sorted
    by corrected timestamp — a mid-stream failover reads as one
    ``trace_id`` leaving engine A's track and continuing on engine B's,
    causally ordered."""
    offsets = clock_offsets(segments)
    meta: List[Dict[str, Any]] = []
    spans: List[Dict[str, Any]] = []
    owners = sorted(segments)
    for pid, owner in enumerate(owners, start=1):
        doc = segments[owner]
        attrs = doc.get("attrs") or {}
        label = str(doc.get("owner_id", owner))
        if attrs:
            label += " (" + ", ".join(f"{k}={v}" for k, v
                                      in sorted(attrs.items())) + ")"
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": label}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "args": {"sort_index": pid}})
        threads: Dict[int, str] = {}
        off = offsets.get(owner, 0.0)
        for rec in doc.get("spans") or ():
            tid = int(rec.get("tid") or 0)
            if rec.get("thread"):
                threads[tid] = str(rec["thread"])
            ev: Dict[str, Any] = {
                "name": rec["name"],
                "cat": str(rec["name"]).split(".", 1)[0],
                "ph": "X",
                "ts": (float(rec["t0"]) + off) * 1e6,
                "dur": float(rec.get("dur") or 0.0) * 1e6,
                "pid": pid,
                "tid": tid,
            }
            args = dict(rec.get("tags") or {})
            if rec.get("error"):
                args["error"] = rec["error"]
            if args:
                ev["args"] = args
            spans.append(ev)
        for tid, tname in sorted(threads.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
    spans.sort(key=lambda e: e["ts"])
    doc = {
        "traceEvents": meta + spans,
        "displayTimeUnit": "ms",
        "otherData": {
            "assembler": "deepspeed_tpu_torch.observability.trace_assembly",
            "owners": owners,
            "clock_offsets": {o: offsets.get(o, 0.0) for o in owners},
            "dropped_by_owner": {o: int(segments[o].get("dropped") or 0)
                                 for o in owners},
        },
    }
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)   # a torn trace file is worse than none
    return doc


def events_for_trace(doc: Dict[str, Any],
                     trace_id: str) -> List[Dict[str, Any]]:
    """Every complete-span event of one request, corrected-timestamp
    order — what the chaos tests assert causal ordering over."""
    out = [e for e in doc.get("traceEvents", ())
           if e.get("ph") == "X"
           and (e.get("args") or {}).get("trace_id") == trace_id]
    out.sort(key=lambda e: e["ts"])
    return out
