"""Telemetry sinks: anything with ``emit(event: dict)`` and ``close()``."""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional


class RingBufferSink:
    """Keep the last ``capacity`` events in memory (all of them when
    ``capacity`` is None).  The serving engine's deterministic trace is a
    view over one of these."""

    def __init__(self, capacity: Optional[int] = None):
        self.buf: deque = deque(maxlen=capacity)

    def emit(self, event: Dict[str, Any]) -> None:
        self.buf.append(event)

    def events(self) -> List[Dict[str, Any]]:
        return list(self.buf)

    def close(self) -> None:
        pass
