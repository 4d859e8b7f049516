"""Observability (counterpart of ``deepspeed_tpu/observability/``): the span
tracer, its flight recorder, the exporters, the device-trace window,
per-program statistics and the SLO layer.

- :mod:`.trace` — nested-span tracer with thread-local context, monotonic
  clocks and optional device sync points; a process-global instance the
  instrumentation sites reach without plumbing.
- :mod:`.flight_recorder` — bounded ring of completed spans and counter
  events; crash paths (``HangWatchdog``, ``ServingSupervisor``) dump it.
- :mod:`.export` — Chrome/Perfetto trace-event JSON and the Prometheus text
  exposition of monitor gauges and span aggregates/histograms, served on
  ``/metrics`` (``DS_TPU_METRICS_PORT``).
- :mod:`.device_profiler` — windowed ``torch.profiler`` captures
  (``DS_TPU_DEVICE_TRACE``) with span-name ``record_function`` correlation.
- :mod:`.program_stats` — per-program FLOPs/invocation/device-time ledger
  (``ProgramCatalog``) feeding MFU estimates.
- :mod:`.slo` — span duration histograms and declarative ``SloRule``
  alerts (``dstpu_alert{rule=...}`` on /metrics, ``health()["alerts"]``).
- :mod:`.trace_assembly` — several processes' span segments merged into
  one Perfetto trace.

Instrumented sites: ``train.batch``/``train.step``/``train.forward``/
``train.backward``, ``ckpt.save``/``ckpt.load``/``ckpt.finalize``,
``serve.tick``/``serve.admit``/``serve.prefill``/``serve.decode``,
``serve.restart``/``serve.replay``.
"""
from .flight_recorder import CounterEvent, DEFAULT_CAPACITY, FlightRecorder
from .trace import (DUMP_WINDOW_ENV, Span, TRACE_CAPACITY_ENV, TRACE_ENV, Tracer,
                    configure_tracer, current_trace_tags, dump_window_s, flight_dump,
                    get_tracer, new_trace_id, trace_context, trace_count, trace_span,
                    trace_tags)
from .trace_assembly import (TraceSegmentPublisher, assemble_fleet_trace,
                             events_for_trace, load_segments)
from .export import (METRICS_PORT_ENV, MetricsServer, chrome_trace_events,
                     get_metrics_server, maybe_start_metrics_server, prometheus_text,
                     start_metrics_server, write_chrome_trace)
from .device_profiler import (DEVICE_TRACE_ENV, DeviceTraceCapture, capture_device_trace,
                              device_capture_active, device_trace_unit,
                              maybe_capture_from_env, stop_device_trace)
from .program_stats import PEAK_TFLOPS_ENV, ProgramCatalog, peak_flops_per_sec
from .slo import LogBucketHistogram, SloEvaluator, SloRule

__all__ = ["CounterEvent", "DEFAULT_CAPACITY", "FlightRecorder", "LogBucketHistogram",
           "DUMP_WINDOW_ENV", "Span", "TRACE_CAPACITY_ENV", "TRACE_ENV", "Tracer",
           "configure_tracer", "current_trace_tags", "dump_window_s", "flight_dump",
           "get_tracer", "new_trace_id", "trace_context", "trace_count", "trace_span",
           "trace_tags", "TraceSegmentPublisher", "assemble_fleet_trace",
           "events_for_trace", "load_segments", "METRICS_PORT_ENV", "MetricsServer",
           "chrome_trace_events", "get_metrics_server", "maybe_start_metrics_server",
           "prometheus_text", "start_metrics_server", "write_chrome_trace",
           "DEVICE_TRACE_ENV", "DeviceTraceCapture", "capture_device_trace",
           "device_capture_active", "device_trace_unit", "maybe_capture_from_env",
           "stop_device_trace", "PEAK_TFLOPS_ENV", "ProgramCatalog",
           "peak_flops_per_sec", "SloEvaluator", "SloRule"]
