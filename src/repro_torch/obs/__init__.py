"""Telemetry: spans and instants routed to pluggable sinks, the Chrome
trace_event export and model-vs-measured drift tracking (the parts of
``repro.obs`` the port's engine, trainer and launchers use)."""

from repro_torch.obs.chrome import (
    chrome_trace,
    schedule_lane_events,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.core import Telemetry
from repro_torch.obs.drift import SPAN_PHASES, DriftTracker
from repro_torch.obs.sinks import JsonlSink, RingBufferSink

__all__ = [
    "DriftTracker", "JsonlSink", "RingBufferSink", "SPAN_PHASES", "Telemetry",
    "chrome_trace", "schedule_lane_events", "validate_chrome_trace",
    "write_chrome_trace",
]
