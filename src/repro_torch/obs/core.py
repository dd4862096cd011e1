"""Structured telemetry: spans, instants, gauges and histograms fanned out
to sinks.

The port's copy of what the serving engine and the trainer use of
``repro.obs.core``.  Events are plain JSON-ready dicts, one schema for
every sink:

    {"name": str, "kind": "span"|"instant"|"gauge"|"hist",
     "ts": float seconds since the Telemetry epoch,
     "dur": float seconds (spans only),
     "value": float (gauges and histograms only),
     "tid": int python thread id,
     "depth": int, "parent": str|None, "attrs": {str: json-able}}

A disabled ``Telemetry`` hands out one shared do-nothing span, so
instrumented code costs next to nothing when recording is off.

Thread-safe: the checkpoint manager's writer thread emits ``ckpt.save``
while the trainer emits ``train.step`` from the main thread.  Sink
emission and histogram accumulation hold a lock; the span stack (depth
and parent) is per thread, so concurrent spans never see each other as
parents.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """Records host wall time between enter and exit and emits one
    ``kind="span"`` event on exit (with an ``error`` attr if it raised)."""

    __slots__ = ("_tel", "name", "attrs", "t0", "depth", "parent")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.depth = 0
        self.parent: Optional[str] = None

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = self._tel._stack()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        stack = self._tel._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tel._emit({
            "name": self.name, "kind": "span", "ts": self.t0 - self._tel.epoch,
            "dur": t1 - self.t0, "tid": threading.get_ident(), "depth": self.depth,
            "parent": self.parent, "attrs": self.attrs,
        })
        return False


class Telemetry:
    """Event router: timestamps events and fans them out to ``sinks``
    under a lock.  ``hists`` keeps every histogram value by name."""

    def __init__(self, enabled: bool = True, sinks: Optional[List] = None):
        self.enabled = enabled
        self.sinks = list(sinks) if sinks else []
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self.hists: Dict[str, List[float]] = {}

    def _stack(self) -> List[_Span]:
        """This thread's stack of open spans."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            for sink in self.sinks:
                sink.emit(event)

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def _point(self, name: str, kind: str, attrs, **fields) -> None:
        stack = self._stack()
        self._emit({
            "name": name, "kind": kind,
            "ts": time.perf_counter() - self.epoch, **fields,
            "tid": threading.get_ident(), "depth": len(stack),
            "parent": stack[-1].name if stack else None,
            "attrs": attrs,
        })

    def instant(self, name: str, **attrs) -> None:
        if self.enabled:
            self._point(name, "instant", attrs)

    def gauge(self, name: str, value: float, **attrs) -> None:
        """The current value of a quantity (e.g. the logged loss)."""
        if self.enabled:
            self._point(name, "gauge", attrs, value=float(value))

    def histogram(self, name: str, value: float, **attrs) -> None:
        """One sample of a distribution (e.g. a step's seconds)."""
        if self.enabled:
            with self._lock:
                self.hists.setdefault(name, []).append(float(value))
            self._point(name, "hist", attrs, value=float(value))

    def close(self) -> None:
        with self._lock:
            for sink in self.sinks:
                sink.close()
