"""Observability (counterpart of ``deepspeed_tpu/observability/``): the span
tracer, its flight recorder and the duration histograms the serving
supervisor's post-mortems read.  The exporters, device profiler,
per-program statistics and SLO rules are not ported yet (ROADMAP queue 1,
item 12)."""
from .flight_recorder import CounterEvent, DEFAULT_CAPACITY, FlightRecorder
from .slo import LogBucketHistogram
from .trace import (DUMP_WINDOW_ENV, Span, TRACE_CAPACITY_ENV, TRACE_ENV, Tracer,
                    configure_tracer, current_trace_tags, dump_window_s, flight_dump,
                    get_tracer, new_trace_id, trace_context, trace_count, trace_span,
                    trace_tags)

__all__ = ["CounterEvent", "DEFAULT_CAPACITY", "FlightRecorder", "LogBucketHistogram",
           "DUMP_WINDOW_ENV", "Span", "TRACE_CAPACITY_ENV", "TRACE_ENV", "Tracer",
           "configure_tracer", "current_trace_tags", "dump_window_s", "flight_dump",
           "get_tracer", "new_trace_id", "trace_context", "trace_count", "trace_span",
           "trace_tags"]
