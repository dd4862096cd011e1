"""Discrete-event simulator over the schedule IR (GPipe / 1F1B /
interleaved 1F1B / zero-bubble ZB-H1).

The port's copy of ``repro.core.schedule_sim``'s ``simulate``: the
resource model replays comm-lane schedules through it to price their
exposed hand-offs; and its named entry points (``gpipe``, ``one_f_one_b``,
``one_f_one_b_overlap``, ``interleaved_1f1b``, ``zb_h1``, ``BY_NAME``),
which take full-stage times.

Validates the paper's pipeline analysis (Eq 3–5): peak in-flight microbatch
(chunk) activations per stage, bubble fraction, and step makespan.  Used by
tests (cross-check against ``core.resource_model`` and the SPMD executor)
and by the schedule benchmark.

The op *order* comes from ``core.schedules`` — the same vstage-aware
tick-table IR the executor interprets — so simulator and executor can never
drift apart.  The simulator replays each stage's IR op sequence with real
durations: ``t_fwd`` / ``t_bwd`` are PER OP, i.e. per virtual-stage chunk
(backward ~2x forward by default).  For interleaved schedules a chunk holds
1/V of a stage's layers, so callers model equal total work by passing
``t_fwd / V`` — the reference's named entry points do this — which is exactly how
interleaving shrinks the fill/drain bubble from ``(PP-1)/(M+PP-1)`` to
``(PP-1)/(V*M+PP-1)``.  Split-backward schedules charge Bw ops ``t_bw``
(default ``t_bwd / 2``) and Bi ops the remaining ``t_bwd - t_bw``, so a
ZB-H1 replay does the same total work as 1F1B and the makespan difference
IS the recovered drain bubble (``(PP-1)(t_F + t_B - 2 t_Bw)`` per stage).
Stage-to-stage hand-off is immediate in the base replay (``makespan``,
``bubble_fraction`` and the peaks are pure compute quantities, unchanged
by comm costs).  Communication is priced by EXPOSURE, on a separate comm
lane: pass per-hop ``t_p2p`` and/or per-op ``t_a2a`` and the result
carries ``exposed_p2p`` / ``exposed_a2a`` — the makespan increase that
the schedule cannot hide.  For comm-lane (``has_comm``) schedules such as
``1f1b_overlap`` this is a dependency replay through ``list_schedule``
with ``p2p_delay`` on cross-stage edges (send at the producer tick, recv
at the consumer tick, transfer in flight in between), so everything the
intervening compute covers costs nothing; a2a brackets hide under their
host compute op (effective duration ``max(t_op, t_a2a)``).  For legacy
schedules (no comm lane) the executor issues each hand-off synchronously
on its tick edge, so the replay additionally BLOCKS the producer for the
transfer (``p2p_sync``) and charges the a2a serially inside its host op
(``t_op + t_a2a``).  The async replay is the same DAG minus the
blocking, so overlap exposure is never larger than its non-overlap
twin's — and strictly smaller whenever the dependency chain can absorb
any of it.  (The resource model's flat ``2·M·V·t_p2p`` Eq reference is a
lower bound of the synchronous replay: it counts the steady-state
hand-offs but not the fill/drain ones.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core import schedules as sched_lib
from repro_torch.core.schedules import Schedule


@dataclass(frozen=True)
class Op:
    stage: int
    mb: int
    vs: int  # virtual stage (model chunk) on the stage
    kind: str  # "F" | "B" | "Bi" | "Bw"
    start: float
    end: float


@dataclass
class ScheduleResult:
    schedule: Schedule
    ops: List[Op]
    makespan: float
    bubble_fraction: float  # idle time / (stages * makespan)
    peak_in_flight: List[int]  # per stage: max live fwd chunk activations
    peak_wstash: List[int] = None  # per stage: max deferred weight grads
    # Comm exposure (0.0 unless t_p2p / t_a2a passed to simulate): the
    # makespan increase the schedule cannot hide — async comm-lane replay
    # for has_comm schedules, synchronous (producer-blocking) replay for
    # legacy ones.
    exposed_p2p: float = 0.0
    exposed_a2a: float = 0.0
    peak_comm_inflight: List[int] = None  # per stage: max dwelling payloads


def _replay_makespan(
    sched: Schedule, t_fwd, t_bwd, t_bw, p2p_delay=0.0, p2p_sync=False
):
    placed = sched_lib.list_schedule(
        [sched.stage_order(s) for s in range(sched.PP)],
        t_fwd=t_fwd,
        t_bwd=t_bwd,
        V=sched.V,
        t_bw=t_bw,
        p2p_delay=p2p_delay,
        p2p_sync=p2p_sync,
    )
    return placed, max(end for _, _, _, end in placed)


def simulate(
    sched: Schedule,
    t_fwd: float = 1.0,
    t_bwd: float = 2.0,
    t_bw: float = None,
    t_p2p: float = 0.0,
    t_a2a: float = 0.0,
) -> ScheduleResult:
    """Replay the IR's per-stage op order with real per-chunk fwd/bwd
    durations — through the same ``schedules.list_schedule`` dependency
    resolver that built the IR, so the two cannot drift.  ``t_bwd`` is the
    FULL backward; split schedules charge Bw ops ``t_bw`` (default
    ``t_bwd / 2``) and Bi ops the rest.

    ``t_p2p`` (per cross-stage hop) and ``t_a2a`` (per expert-layer op)
    price communication as EXPOSURE without touching ``makespan`` — see
    the module docstring for the comm-lane vs serial accounting."""
    PP = sched.PP
    placed, base_makespan = _replay_makespan(sched, t_fwd, t_bwd, t_bw)
    ops = [Op(s, mb, vs, kind, start, end)
           for s, (kind, mb, vs), start, end in placed]
    # Peak residencies in start order per stage: residuals (+1 per F, -1
    # per cotangent-producing B/Bi) and the split W-stash (+1 Bi, -1 Bw).
    in_flight = [0] * PP
    peak = [0] * PP
    wstash = [0] * PP
    wpeak = [0] * PP
    for o in sorted(ops, key=lambda o: o.start):
        if o.kind == "F":
            in_flight[o.stage] += 1
            peak[o.stage] = max(peak[o.stage], in_flight[o.stage])
        elif o.kind in sched_lib.COT_KINDS:
            in_flight[o.stage] -= 1
            if o.kind == "Bi":
                wstash[o.stage] += 1
                wpeak[o.stage] = max(wpeak[o.stage], wstash[o.stage])
        else:  # Bw
            wstash[o.stage] -= 1
    makespan = max(o.end for o in ops)
    busy = sum(o.end - o.start for o in ops)
    bubble = 1.0 - busy / (PP * makespan)

    exposed_p2p = exposed_a2a = 0.0
    peak_comm = [0] * PP
    # Resolve the Bw split before inflating t_bwd for a2a pricing: the
    # weight-grad op has no a2a, so only the Bi share absorbs it.
    t_bw_r = t_bwd / 2.0 if t_bw is None else t_bw
    if sched.has_comm:
        trace = sched.comm_trace()
        peak_comm = [int(trace[s].max()) for s in range(PP)]
        if t_p2p > 0.0:
            # Dependency replay with the hop latency on cross-stage edges:
            # only transfers the intervening compute cannot cover extend
            # the critical path.
            _, ms = _replay_makespan(sched, t_fwd, t_bwd, t_bw, t_p2p)
            exposed_p2p = ms - base_makespan
        if t_a2a > 0.0:
            # A2A brackets sit at the same tick as their host compute op
            # (all current overlap builders are fused-backward), so each
            # op's effective duration is max(compute, a2a).
            _, ms = _replay_makespan(
                sched, max(t_fwd, t_a2a), max(t_bwd, t_a2a), t_bw_r
            )
            exposed_a2a = ms - base_makespan
    else:
        # No comm lane: hand-offs are synchronous — the transfer sits on
        # the tick edge, blocking the producer AND gating the consumer —
        # and the a2a is charged serially inside its host op (dur + t_a2a,
        # nothing hides).  Both replayed through the same resolver.
        if t_p2p > 0.0 and PP > 1:
            _, ms = _replay_makespan(
                sched, t_fwd, t_bwd, t_bw, t_p2p, p2p_sync=True
            )
            exposed_p2p = ms - base_makespan
        if t_a2a > 0.0:
            _, ms = _replay_makespan(
                sched, t_fwd + t_a2a, t_bwd + t_a2a, t_bw_r
            )
            exposed_a2a = ms - base_makespan
    return ScheduleResult(
        sched, ops, makespan, bubble, peak, wpeak,
        exposed_p2p=exposed_p2p,
        exposed_a2a=exposed_a2a,
        peak_comm_inflight=peak_comm,
    )


def gpipe(PP: int, M: int, t_fwd: float = 1.0, t_bwd: float = 2.0) -> ScheduleResult:
    """All forwards, then all backwards."""
    return simulate(sched_lib.build("gpipe", PP, M), t_fwd, t_bwd)


def one_f_one_b(PP: int, M: int, t_fwd: float = 1.0, t_bwd: float = 2.0) -> ScheduleResult:
    """1F1B (PipeDream-flush)."""
    return simulate(sched_lib.build("1f1b", PP, M), t_fwd, t_bwd)


def one_f_one_b_overlap(PP: int, M: int, t_fwd: float = 1.0, t_bwd: float = 2.0,
                        t_p2p: float = 0.0, t_a2a: float = 0.0) -> ScheduleResult:
    """1F1B with the comm lane: :func:`one_f_one_b`'s compute table,
    residual slots and makespan, with p2p and a2a priced by exposure
    (the fill staircase is the only p2p that cannot hide)."""
    return simulate(sched_lib.build("1f1b_overlap", PP, M), t_fwd, t_bwd,
                    t_p2p=t_p2p, t_a2a=t_a2a)


def interleaved_1f1b(PP: int, M: int, V: int = 2, t_fwd: float = 1.0,
                     t_bwd: float = 2.0) -> ScheduleResult:
    """Interleaved 1F1B over V virtual stages.  ``t_fwd`` / ``t_bwd`` are
    the FULL-stage durations; each chunk takes 1/V of them, so makespans
    compare with :func:`one_f_one_b` at equal total work."""
    return simulate(sched_lib.build("interleaved_1f1b", PP, M, V), t_fwd / V, t_bwd / V)


def zb_h1(PP: int, M: int, t_fwd: float = 1.0, t_bwd: float = 2.0,
          t_bw: Optional[float] = None) -> ScheduleResult:
    """Zero-bubble ZB-H1: 1F1B with the backward split into Bi + Bw.
    ``t_bwd`` is the FULL backward (Bw takes ``t_bw``, default half; Bi
    the rest), so makespans compare with :func:`one_f_one_b` at equal
    total work."""
    return simulate(sched_lib.build("zb_h1", PP, M), t_fwd, t_bwd, t_bw)


BY_NAME = {
    "gpipe": gpipe,
    "1f1b": one_f_one_b,
    "1f1b_overlap": one_f_one_b_overlap,
    "interleaved_1f1b": interleaved_1f1b,
    "zb_h1": zb_h1,
}
