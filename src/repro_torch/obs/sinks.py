"""Telemetry sinks: anything with ``emit(event: dict)`` and ``close()``."""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Sink", "RingBufferSink", "JsonlSink"]


class Sink:
    """The sink interface; ``Telemetry`` calls ``emit`` under its lock, so
    a sink needs no lock of its own."""

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class RingBufferSink(Sink):
    """Keep the last ``capacity`` events in memory (all of them when
    ``capacity`` is None).  The serving engine's deterministic trace and
    the launchers' end-of-run drift and Chrome reports read one of these."""

    def __init__(self, capacity: Optional[int] = None):
        self.buf: deque = deque(maxlen=capacity)

    def emit(self, event: Dict[str, Any]) -> None:
        self.buf.append(event)

    def events(self) -> List[Dict[str, Any]]:
        return list(self.buf)

    def __len__(self) -> int:
        return len(self.buf)

    def clear(self) -> None:
        self.buf.clear()


class JsonlSink(Sink):
    """One JSON object per line, append-only, as ``repro.obs.JsonlSink``
    writes them.  ``--metrics-out`` on the launchers points here."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "w")

    def emit(self, event: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(event, default=_jsonable) + "\n")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def _jsonable(obj):
    """Fallback encoder: tuples and sets arrive via event attrs (e.g. a
    decode step's request ids); tensor and numpy scalars via metrics."""
    if isinstance(obj, (tuple, set)):
        return list(obj)
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)
