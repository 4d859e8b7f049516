"""Cross-process trace assembly: span segments of several processes merged
into one Perfetto file (counterpart of
``deepspeed_tpu/observability/trace_assembly.py``, the half that needs no
coordination store; copied: framework-free).

- :func:`span_record` — one completed span as a JSON-safe segment record
  (``t0``/``dur`` on the recording process's monotonic clock).
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
wall-clock agreement.  Publishing segments to a coordination store
(``TraceSegmentPublisher``) and reading them back (``load_segments``) need
the store of ``elasticity/coordination.py``: ROADMAP queue 1, item 13.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .trace import Span

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
    """Publishes an owner's completed spans to the coordination store: not
    ported yet, it needs ``elasticity/coordination.py`` (ROADMAP queue 1,
    item 13)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TraceSegmentPublisher: publishing trace segments to a "
            "coordination store is not ported yet (ROADMAP queue 1, item 13)")


def load_segments(store, prefix: str = "fleet/trace") -> Dict[str, Dict]:
    """owner_id -> newest segment document from the coordination store:
    not ported yet (ROADMAP queue 1, item 13)."""
    raise NotImplementedError(
        "load_segments: reading trace segments from a coordination store is "
        "not ported yet (ROADMAP queue 1, item 13)")


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
