"""Structured telemetry: spans, instants, counters, gauges and histograms
fanned out to sinks.

The port's copy of ``repro.obs.core``.  Events are plain JSON-ready dicts,
one schema for every sink:

    {"name": str, "kind": "span"|"instant"|"counter"|"gauge"|"hist",
     "ts": float seconds since the Telemetry epoch,
     "dur": float seconds (spans only),
     "value": float (counters, gauges and histograms),
     "total": float (counters only: the running total),
     "tid": int python thread id,
     "depth": int, "parent": str|None (spans and instants only),
     "attrs": {str: json-able}}

Besides explicit ``Telemetry`` objects there is one process-global
telemetry, disabled until :func:`configure` or :func:`set_telemetry`
installs an enabled one; the module-level :func:`span`, :func:`instant`,
:func:`counter`, :func:`gauge` and :func:`histogram` record on it.

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
    under a lock.  ``hists`` keeps every histogram value by name,
    ``counters`` every counter's running total."""

    def __init__(self, enabled: bool = True, sinks: Optional[List] = None):
        self.enabled = enabled
        self.sinks = list(sinks) if sinks else []
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self.hists: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}

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

    def _value(self, name: str, kind: str, attrs, **fields) -> None:
        """A value event: no depth or parent, as the reference's."""
        self._emit({"name": name, "kind": kind, "ts": time.perf_counter() - self.epoch,
                    "tid": threading.get_ident(), **fields, "attrs": attrs})

    def record_span(self, name: str, dur_s: float, **attrs) -> None:
        """A span of an externally measured duration (a micro-benchmark's
        seconds a call): the timed region itself stays unobserved; the
        event's ts marks when it was recorded."""
        if self.enabled:
            self._point(name, "span", attrs, dur=float(dur_s))

    def instant(self, name: str, **attrs) -> None:
        if self.enabled:
            self._point(name, "instant", attrs)

    def counter(self, name: str, inc: float = 1.0, **attrs) -> None:
        """Add ``inc`` to a running total (e.g. the trainer's host
        fetches); the event carries both."""
        if not self.enabled:
            return
        with self._lock:
            total = self.counters.get(name, 0.0) + inc
            self.counters[name] = total
        self._value(name, "counter", attrs, value=inc, total=total)

    def gauge(self, name: str, value: float, **attrs) -> None:
        """The current value of a quantity (e.g. the logged loss)."""
        if self.enabled:
            self._value(name, "gauge", attrs, value=float(value))

    def histogram(self, name: str, value: float, **attrs) -> None:
        """One sample of a distribution (e.g. a step's seconds)."""
        if self.enabled:
            with self._lock:
                self.hists.setdefault(name, []).append(float(value))
            self._value(name, "hist", attrs, value=float(value))

    def hist_summary(self, name: str) -> Optional[Dict[str, float]]:
        """n / min / max / mean over every recorded ``histogram(name, ...)``;
        None before the first."""
        with self._lock:
            vals = list(self.hists.get(name, ()))
        if not vals:
            return None
        return {"n": len(vals), "min": min(vals), "max": max(vals),
                "mean": sum(vals) / len(vals)}

    def close(self) -> None:
        """Close the sinks; a closed telemetry records nothing more (a
        launcher's trainer outlives it: its fetches count on)."""
        with self._lock:
            self.enabled = False
            for sink in self.sinks:
                sink.close()


# -- process-global telemetry (disabled by default) ------------------------

_GLOBAL = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(tel: Telemetry) -> Telemetry:
    """Install ``tel`` as the process-global telemetry; returns the
    previous one, so that a caller can put it back."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tel
    return prev


def configure(enabled: bool = True, sinks: Optional[List] = None) -> Telemetry:
    """Build and install a fresh global ``Telemetry``: everything recorded
    through the module-level helpers goes to ``sinks`` from then on."""
    tel = Telemetry(enabled=enabled, sinks=sinks)
    set_telemetry(tel)
    return tel


def span(name: str, **attrs):
    return _GLOBAL.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    _GLOBAL.instant(name, **attrs)


def counter(name: str, inc: float = 1.0, **attrs) -> None:
    _GLOBAL.counter(name, inc, **attrs)


def gauge(name: str, value: float, **attrs) -> None:
    _GLOBAL.gauge(name, value, **attrs)


def histogram(name: str, value: float, **attrs) -> None:
    _GLOBAL.histogram(name, value, **attrs)
