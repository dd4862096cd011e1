"""Chrome ``trace_event`` export: open telemetry in Perfetto / chrome://tracing.

Two producers share the format:

- ``chrome_trace(events)`` converts structured telemetry events (from a
  ``RingBufferSink`` or a parsed JSONL metrics log) into trace events —
  spans become ``ph="X"`` complete events, instants ``ph="i"``,
  counters/gauges ``ph="C"``.
- ``schedule_lane_events(sched, tick_s)`` renders a schedule-IR object
  (``core.schedules.Schedule``) as one lane per pipeline stage: every
  non-idle ``(kind, mb, vstage)`` op becomes a complete event named
  ``F3``/``B1``/``Bw2`` on the stage's thread, and a per-stage
  ``occupancy`` counter series mirrors ``Schedule.occupancy_trace()``
  value-for-value — what Perfetto draws *is* the IR's residual-slot
  account, not a re-derivation.  Overlap schedules additionally get one
  *comm* lane per stage (``SendF2``/``RecvB0``/``A2A1`` point ops plus a
  ``dwell`` span over each in-flight window) and a per-stage
  ``comm_inflight`` counter equal to ``Schedule.comm_trace()``.

All timestamps/durations are microseconds (the trace_event unit).

The port's copy of ``repro.obs.chrome``.  The train launcher's
pipelined runs (``--pipeline``) write their schedule's lanes, one a stage,
beside the telemetry of rank 0.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "chrome_trace",
    "schedule_lane_events",
    "validate_chrome_trace",
    "write_chrome_trace",
]

_US = 1e6  # seconds -> microseconds


def chrome_trace(
    events: Iterable[Dict[str, Any]],
    pid: int = 1,
    process_name: str = "repro",
) -> Dict[str, Any]:
    """Structured telemetry events -> a trace_event JSON object."""
    out: List[Dict[str, Any]] = [
        _meta("process_name", pid, 0, {"name": process_name})
    ]
    tids: Dict[int, int] = {}
    for ev in events:
        tid = tids.setdefault(ev.get("tid", 0), len(tids))
        kind = ev.get("kind")
        base = {"pid": pid, "tid": tid, "ts": ev["ts"] * _US}
        attrs = ev.get("attrs", {})
        if kind == "span":
            out.append(
                {
                    **base,
                    "ph": "X",
                    "name": ev["name"],
                    "dur": ev["dur"] * _US,
                    "args": dict(attrs),
                }
            )
        elif kind == "instant":
            out.append(
                {
                    **base,
                    "ph": "i",
                    "s": "t",
                    "name": ev["name"],
                    "args": dict(attrs),
                }
            )
        elif kind in ("counter", "gauge", "hist"):
            value = ev.get("total", ev.get("value", 0.0))
            out.append(
                {**base, "ph": "C", "name": ev["name"],
                 "args": {"value": value}}
            )
    for raw_tid, tid in tids.items():
        out.append(_meta("thread_name", pid, tid, {"name": f"tid {raw_tid}"}))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def schedule_lane_events(
    sched,
    tick_s: float,
    t0_s: float = 0.0,
    pid: int = 2,
) -> List[Dict[str, Any]]:
    """Render a ``Schedule`` as per-stage Perfetto lanes.

    One thread (lane) per pipeline stage; each non-None
    ``sched.ops[stage][tick]`` becomes a ``ph="X"`` event of duration
    ``tick_s`` with args ``{kind, mb, vstage, tick}``, and each stage gets
    an ``occupancy`` counter stream equal to
    ``sched.occupancy_trace()[stage]`` at every tick boundary.

    When the schedule carries a comm lane (``sched.has_comm``), stage
    ``s`` gets a second thread ``tid = PP + s`` ("stage s comm") holding
    every comm op as a tick-long ``X`` event, a ``dwell`` span over each
    in-flight window ``(send+1, recv)`` of its received payloads, and a
    ``comm_inflight`` counter stream equal value-for-value to
    ``sched.comm_trace()[s]`` — Perfetto draws the IR's in-flight
    comm-buffer account, not a re-derivation.
    """
    occ = sched.occupancy_trace()
    out: List[Dict[str, Any]] = [
        _meta("process_name", pid, 0,
              {"name": f"pipeline {sched.name} PP={sched.PP} M={sched.M}"})
    ]
    for stage in range(sched.PP):
        out.append(_meta("thread_name", pid, stage, {"name": f"stage {stage}"}))
        for tick in range(sched.num_ticks):
            op = sched.ops[stage][tick]
            ts = (t0_s + tick * tick_s) * _US
            if op is not None:
                kind, mb, vs = op
                out.append(
                    {
                        "ph": "X",
                        "pid": pid,
                        "tid": stage,
                        "ts": ts,
                        "dur": tick_s * _US,
                        "name": f"{kind}{mb}",
                        "args": {"kind": kind, "mb": mb, "vstage": vs,
                                 "tick": tick},
                    }
                )
            out.append(
                {
                    "ph": "C",
                    "pid": pid,
                    "tid": stage,
                    "ts": ts,
                    "name": f"occupancy stage{stage}",
                    "args": {"value": int(occ[stage, tick])},
                }
            )
    if sched.has_comm:
        ctrace = sched.comm_trace()
        for stage in range(sched.PP):
            tid = sched.PP + stage
            out.append(
                _meta("thread_name", pid, tid, {"name": f"stage {stage} comm"})
            )
            for tick in range(sched.num_ticks):
                ts = (t0_s + tick * tick_s) * _US
                for ckind, mb, vs in sched.comm[stage][tick]:
                    out.append(
                        {
                            "ph": "X",
                            "pid": pid,
                            "tid": tid,
                            "ts": ts,
                            "dur": tick_s * _US,
                            "name": f"{ckind}{mb}",
                            "args": {"kind": ckind, "mb": mb, "vstage": vs,
                                     "tick": tick},
                        }
                    )
                out.append(
                    {
                        "ph": "C",
                        "pid": pid,
                        "tid": tid,
                        "ts": ts,
                        "name": f"comm_inflight stage{stage}",
                        "args": {"value": int(ctrace[stage, tick])},
                    }
                )
        for direction, (rs, rv, mb), t_send, t_recv in sched.comm_edges():
            if t_recv <= t_send + 1:
                continue  # zero dwell: never enters the comm buffer
            out.append(
                {
                    "ph": "X",
                    "pid": pid,
                    "tid": sched.PP + rs,
                    "ts": (t0_s + (t_send + 1) * tick_s) * _US,
                    "dur": (t_recv - t_send - 1) * tick_s * _US,
                    "name": f"dwell {direction} mb{mb}",
                    "args": {"direction": direction, "mb": mb, "vstage": rv,
                             "send_tick": t_send, "recv_tick": t_recv},
                }
            )
    return out


def write_chrome_trace(
    path,
    events: Iterable[Dict[str, Any]],
    schedule=None,
    tick_s: float = 1e-3,
    process_name: str = "repro",
) -> Dict[str, Any]:
    """Convert + (optionally) append schedule lanes + write to ``path``.
    Returns the trace object (already validated)."""
    trace = chrome_trace(events, process_name=process_name)
    if schedule is not None:
        trace["traceEvents"].extend(schedule_lane_events(schedule, tick_s))
    validate_chrome_trace(trace)
    with open(str(path), "w") as fh:
        json.dump(trace, fh)
    return trace


_PH_REQUIRED = {
    "X": ("name", "ts", "dur", "pid", "tid"),
    "i": ("name", "ts", "pid", "tid", "s"),
    "C": ("name", "ts", "pid", "tid", "args"),
    "M": ("name", "pid", "tid", "args"),
}


def validate_chrome_trace(obj: Dict[str, Any]) -> None:
    """Structural check of the trace_event JSON-object format; raises
    ``ValueError`` with the first offending event."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _PH_REQUIRED:
            raise ValueError(f"traceEvents[{i}] has unsupported ph={ph!r}")
        for key in _PH_REQUIRED[ph]:
            if key not in ev:
                raise ValueError(
                    f"traceEvents[{i}] (ph={ph}) missing key {key!r}"
                )
        for key in ("ts", "dur"):
            if key in ev and not isinstance(ev[key], (int, float)):
                raise ValueError(f"traceEvents[{i}][{key!r}] is not numeric")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"traceEvents[{i}]['args'] is not an object")


def _meta(name: str, pid: int, tid: int, args: Dict[str, Any]) -> Dict[str, Any]:
    return {"ph": "M", "pid": pid, "tid": tid, "name": name, "args": args}
