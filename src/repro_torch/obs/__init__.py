"""Telemetry: spans and instants routed to pluggable sinks (the part of
``repro.obs`` the serving engine uses)."""

from repro_torch.obs.core import Telemetry
from repro_torch.obs.sinks import RingBufferSink

__all__ = ["RingBufferSink", "Telemetry"]
