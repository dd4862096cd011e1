"""Telemetry: spans, instants and metrics routed to pluggable sinks, the
Chrome trace_event export and model-vs-measured drift tracking (the port
of ``repro.obs``).  Code handed no ``Telemetry`` records through the
module-level helpers, no-ops until ``configure(...)`` installs an enabled
global one:

    from repro_torch import obs

    obs.configure(sinks=[obs.RingBufferSink()])
    with obs.span("train.step", step=i):
        ...
    obs.counter("train.host_fetches")
"""

from repro_torch.obs.chrome import (
    chrome_trace,
    schedule_lane_events,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.core import (
    Telemetry,
    configure,
    counter,
    gauge,
    get_telemetry,
    histogram,
    instant,
    set_telemetry,
    span,
)
from repro_torch.obs.drift import SPAN_PHASES, DriftTracker
from repro_torch.obs.sinks import JsonlSink, RingBufferSink, Sink

__all__ = [
    "DriftTracker", "JsonlSink", "RingBufferSink", "SPAN_PHASES", "Sink", "Telemetry",
    "chrome_trace", "configure", "counter", "gauge", "get_telemetry", "histogram",
    "instant", "schedule_lane_events", "set_telemetry", "span", "validate_chrome_trace",
    "write_chrome_trace",
]
