"""Runtime telemetry: span tracing, metrics registry, drift tracking (the
port of ``autodist_tpu/telemetry``, with the same exports).

- :mod:`~autodist_tpu_torch.telemetry.spans` — the thread-safe
  ring-buffer :class:`TraceRecorder` and the ``span()``/``counter_add()``
  helpers the hot paths are instrumented with (near-zero cost when
  ``ADT_TRACE=0``);
- :mod:`~autodist_tpu_torch.telemetry.export` — Chrome-trace/Perfetto
  JSON, Prometheus ``metrics_text()``, and cross-process publish/scrape
  over the coordination service;
- :mod:`~autodist_tpu_torch.telemetry.drift` — measured-vs-predicted
  drift reports feeding ``simulator/calibration.py``;
- :mod:`~autodist_tpu_torch.telemetry.cluster` — NTP-style clock-offset
  handshake over the coordination service (step-aligned merged
  timelines) + the fleet-coordinated profiling flag;
- :mod:`~autodist_tpu_torch.telemetry.goodput` — attributed wall-time
  decomposition (compute / collective-wait / PS-wire / host-input /
  readback / checkpoint / rollback-replay), cross-worker skew, straggler
  flagging;
- :mod:`~autodist_tpu_torch.telemetry.blackbox` — the always-on bounded
  flight recorder, dumped atomically on divergence/rollback/breaker-open
  and fatal signals;
- ``python -m autodist_tpu_torch.telemetry`` — inspect/merge/diff/validate
  trace files, print drift/goodput tables, read blackbox dumps, post
  fleet profiling windows.
"""
from autodist_tpu_torch.telemetry.spans import (  # noqa: F401
    TraceRecorder, configure, counter_add, counters, current_span_id,
    gauge_set, get_recorder, instant, reset, span, tracing_enabled)
from autodist_tpu_torch.telemetry.export import (  # noqa: F401
    chrome_trace, merge_traces, metrics_text, publish_telemetry,
    scrape_cluster, validate_chrome_trace, write_trace)
from autodist_tpu_torch.telemetry.drift import (  # noqa: F401
    DriftReport, build_report, fit_calibration, report_for_runner)
from autodist_tpu_torch.telemetry.cluster import (  # noqa: F401
    ClockOffset, ClockSyncResponder, estimate_clock_offset,
    request_profile, step_alignment, sync_recorder_clock)
from autodist_tpu_torch.telemetry.goodput import (  # noqa: F401
    GoodputReport, StragglerEwma, cluster_goodput)
from autodist_tpu_torch.telemetry.goodput import (  # noqa: F401
    build_report as build_goodput_report)
from autodist_tpu_torch.telemetry.blackbox import (  # noqa: F401
    FlightRecorder, get_flight_recorder)

__all__ = [
    "TraceRecorder", "configure", "counter_add", "counters",
    "current_span_id", "gauge_set", "get_recorder", "instant", "reset",
    "span", "tracing_enabled",
    "chrome_trace", "merge_traces", "metrics_text", "publish_telemetry",
    "scrape_cluster", "validate_chrome_trace", "write_trace",
    "DriftReport", "build_report", "fit_calibration", "report_for_runner",
    "ClockOffset", "ClockSyncResponder", "estimate_clock_offset",
    "request_profile", "step_alignment", "sync_recorder_clock",
    "GoodputReport", "StragglerEwma", "cluster_goodput",
    "build_goodput_report",
    "FlightRecorder", "get_flight_recorder",
]
