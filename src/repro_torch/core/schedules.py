"""Static schedule IR for pipeline parallelism (paper §III, Eq 3–5).

The port's copy of ``repro.core.schedules`` (pure Python and numpy;
``tests/test_torch_planner.py`` holds its tick tables equal to the
reference's).  The resource model and the planner read it, and
``core.pipeline`` executes it over ``torch.distributed`` ranks; where the
text below speaks of the SPMD executor it means the reference's, whose
masked ops the port's executor does not run.

A :class:`Schedule` is a per-stage, per-tick op table: at global clock tick
``t``, stage ``s`` executes exactly one of

* ``("F", mb, vs)`` — forward of microbatch ``mb`` through the stage's
  virtual stage (model chunk) ``vs``;
* ``("B", mb, vs)`` — fused backward of microbatch ``mb`` through chunk
  ``vs`` (consumes the residual saved by the matching F and the cotangent
  handed back by the next chunk, emitting input AND weight grads);
* ``("Bi", mb, vs)`` — activation-grad backward only: consumes the residual
  + cotangent like B and hands the input cotangent upstream, but DEFERS the
  weight grads — it stashes what the weight pullback needs (the stage input
  and the output cotangent) into a W-stash slot;
* ``("Bw", mb, vs)`` — deferred weight-grad backward: drains the W-stash
  slot its Bi filled into parameter grads.  No hand-off (weight grads are
  local), so Bw ops are free to float into bubble ticks;
* ``None``          — idle (a bubble tick).

``B ≡ Bi + Bw``: a fused-backward schedule and a split-backward schedule of
the same (F, cotangent-producer) placement compute identical gradients; the
split buys schedule freedom — zero-bubble schedules (ZB-H1, Qi et al.) fill
the 1F1B drain bubble with the deferred Bw's.

The IR is the **single source of truth** for pipeline schedules: the
discrete-event simulator (``core.schedule_sim``) replays it with real
per-vstage fwd/bwd durations to get makespan / bubble / peak-memory
numbers, and the SPMD executor (``core.pipeline``) interprets the very same
table tick by tick on the device mesh.  New schedules are added as pure
builders here and both consumers pick them up unchanged.

Virtual stages (Megatron-style interleaving): the layer stack is split into
``PP * V`` chunks; chunk ``c = vs * PP + stage`` lives on physical stage
``stage`` as its virtual stage ``vs``.  A microbatch's forward visits the
chunks in ``c`` order, so the chunk graph is a ring walk over the stages:
after stage ``PP-1`` finishes chunk ``(PP-1, vs)`` the activation wraps
around to stage 0's chunk ``(0, vs+1)``; cotangents walk the ring backwards.
``V = 1`` reproduces the flat tables bit-for-bit (one chunk per stage,
``vs == 0`` everywhere).  Interleaving trades bubble for memory and wire:
the bubble fraction drops from ``(PP-1)/(M+PP-1)`` to
``(PP-1)/(V*M+PP-1)`` (each fill/drain hop now costs one *chunk*, 1/V of a
stage), at the price of ~V× residual-slot depth per stage and V× p2p
hand-offs — exactly the trade ``core.resource_model`` prices and
``core.planner`` ranks.

Tick semantics match the executor's communication model: an op's outputs
are ``lax.ppermute``-d at the END of its tick and become visible to the
neighbor at the START of tick ``t+1``.  The wrap-around hand-offs
(``PP-1 -> 0`` forward, ``0 -> PP-1`` backward) are ring edges of the same
ppermute and cost the same one tick.  The builders therefore place ops by
list-scheduling the canonical per-stage op orders with unit-time ops, which
yields integral start ticks that respect

    F(chunk, mb)  at tick  >  F(prev_chunk, mb)     (activation hand-off)
    B(chunk, mb)  at tick  >  B(next_chunk, mb)     (cotangent hand-off)
    B(chunk, mb)  at tick  >  F(chunk, mb)          (residual exists)

where prev/next walk the ``c = vs * PP + stage`` chunk order.

Residual slots: each (stage, vs, mb) is assigned a fixed buffer slot for
its whole residency — from the tick its input activation *arrives*
(prev-chunk F tick plus one; own F tick for the first chunk (0, 0)) until
its B — or, under a split backward, its Bi — op frees it.
``Schedule.num_slots`` is the buffer depth the executor must allocate; for
1F1B it is ``PP`` independent of M (the paper's Eq 4 point), for GPipe it
is ``M``, for interleaved 1F1B it grows to ``~2(PP-1) + (V-1)PP + 1`` on
stage 0 — the Eq-4-style depth per stage — and for ZB-H1 it EQUALS 1F1B's
(Bi frees the same slot at the same cadence B would).

W-stash slots (split-backward schedules only): each split (stage, vs, mb)
additionally gets a fixed W-stash slot for the [Bi, Bw] deferral window —
the executor parks the stage input + output cotangent there between the
two backward phases.  ``Schedule.num_wslots`` is that buffer's depth
(``min(PP, M)`` for ZB-H1 — the price of filling the drain, reported
separately by the resource model); 0 for fused-backward schedules.

The ``zb_h1`` builder realizes the zero-bubble ZB-H1 decomposition at
1F1B-equal residual memory: Bi ops keep 1F1B's warmup depth and B-cadence
(same Eq-4 in-flight peaks, same ``num_slots``), while the M Bw ops float
into the drain stalls and the tail.  At unit op cost the makespan drops to
``3M + PP - 1`` ticks (1F1B's F+B work is 2 unit ops, so its table is
``2(M + PP - 1)`` ticks over the same work-per-op) — per-stage idle shrinks
from ``2(PP-1)`` ticks to ``PP-1``, the paper-style
``(PP-1)(t_F + t_B - 2 t_Bw)`` bubble with ``t_Bi = t_Bw = t_B / 2``.

Every built schedule passes :func:`check_invariants` — the universal,
builder-agnostic validity harness (one op per (stage, tick), hand-off
ordering across stages *and* vstages, every (mb, vs) F'd exactly once and
backward-completed exactly once — fused B, or a Bi-then-Bw pair —
slot-lifetime disjointness in both buffers, and ``num_slots`` /
``num_wslots`` equal to the peaks of their residency traces) — so new
builders are validated by construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SCHEDULES

Op = Tuple[str, int, int]  # ("F"|"B"|"Bi"|"Bw", mb, vstage)
CommOp = Tuple[str, int, int]  # ("SendF"|"RecvF"|"SendB"|"RecvB"|"A2A", mb, vs)


@dataclass(frozen=True)
class OpKindSpec:
    """One row of the op-kind registry: integer lowering code, residual-
    occupancy delta, and whether the kind produces/hands-off a cotangent
    (the "B" role).  EVERY lowering site (``KIND_CODE``, ``OCC_DELTA``,
    ``describe()``, ``occupancy_trace()``, ``tick_tables()``) derives from
    this one table, so adding an op kind cannot silently miss a site."""

    code: int
    occ_delta: int
    cotangent: bool


# The single source of truth for compute op kinds.  F parks a chunk input;
# the cotangent-producing backward — fused B or split Bi — frees it; Bw only
# touches the W-stash.
OP_KINDS: Dict[str, OpKindSpec] = {
    "F": OpKindSpec(code=1, occ_delta=+1, cotangent=False),
    "B": OpKindSpec(code=2, occ_delta=-1, cotangent=True),
    "Bi": OpKindSpec(code=3, occ_delta=-1, cotangent=True),
    "Bw": OpKindSpec(code=4, occ_delta=0, cotangent=False),
}
OP_IDLE = 0
OP_F, OP_B, OP_BI, OP_BW = (OP_KINDS[k].code for k in ("F", "B", "Bi", "Bw"))
# Derived views kept for importers; the registry above is the source.
KIND_CODE = {k: spec.code for k, spec in OP_KINDS.items()}
OCC_DELTA = {k: spec.occ_delta for k, spec in OP_KINDS.items()}
# Cotangent producers: the ops that consume the residual and ppermute the
# input gradient upstream (the "B" role in the hand-off ordering rules).
COT_KINDS = tuple(k for k, spec in OP_KINDS.items() if spec.cotangent)

# Communication op kinds (first-class comm lane of the IR): the stage P2P
# hand-off pairs — a SendF on the producing stage at (or after) its F tick
# with the matching RecvF on the consuming stage at (or before) its consumer
# tick, plus the backward-cotangent pair — and A2A brackets marking the
# expert all-to-all overlapped with a compute op.  Codes are disjoint from
# nothing (comm ops live on their own lane) but centralized here so every
# comm lowering site shares one table.
COMM_SEND_F, COMM_RECV_F, COMM_SEND_B, COMM_RECV_B, COMM_A2A = 1, 2, 3, 4, 5
COMM_KIND_CODE: Dict[str, int] = {
    "SendF": COMM_SEND_F,
    "RecvF": COMM_RECV_F,
    "SendB": COMM_SEND_B,
    "RecvB": COMM_RECV_B,
    "A2A": COMM_A2A,
}
# Overlap builder variants: same compute table as the base schedule, plus
# an explicit comm lane (send at the producer tick, recv at the consumer
# tick, the in-flight window double-buffered in comm slots).
OVERLAP_BASE: Dict[str, str] = {"1f1b_overlap": "1f1b"}


def _kind_code(kind: str) -> int:
    try:
        return OP_KINDS[kind].code
    except KeyError:
        raise ValueError(
            f"unknown op kind {kind!r}; known: {sorted(OP_KINDS)}"
        ) from None


def _occ_delta(kind: str) -> int:
    try:
        return OP_KINDS[kind].occ_delta
    except KeyError:
        raise ValueError(
            f"unknown op kind {kind!r}; known: {sorted(OP_KINDS)}"
        ) from None


def _comm_kind_code(kind: str) -> int:
    try:
        return COMM_KIND_CODE[kind]
    except KeyError:
        raise ValueError(
            f"unknown comm op kind {kind!r}; known: {sorted(COMM_KIND_CODE)}"
        ) from None


class InvariantViolation(AssertionError):
    """A schedule table breaks one of the IR invariants (see
    :func:`check_invariants`)."""


# ---------------------------------------------------------------------------
# Chunk topology (the ring walk of virtual stages)
# ---------------------------------------------------------------------------


def prev_chunk(stage: int, vs: int, PP: int, V: int) -> Optional[Tuple[int, int]]:
    """The chunk a forward activation arrives FROM (None: raw input)."""
    if stage > 0:
        return (stage - 1, vs)
    if vs > 0:
        return (PP - 1, vs - 1)  # wrap-around ring edge
    return None


def next_chunk(stage: int, vs: int, PP: int, V: int) -> Optional[Tuple[int, int]]:
    """The chunk a forward activation is handed TO (None: loss head)."""
    if stage < PP - 1:
        return (stage + 1, vs)
    if vs < V - 1:
        return (0, vs + 1)  # wrap-around ring edge
    return None


# ---------------------------------------------------------------------------
# Canonical per-stage op orders
# ---------------------------------------------------------------------------


def gpipe_order(PP: int, M: int, stage: int) -> List[Op]:
    """GPipe: all forwards, then all backwards (V = 1)."""
    return [("F", m, 0) for m in range(M)] + [("B", m, 0) for m in range(M)]


def one_f_one_b_order(PP: int, M: int, stage: int) -> List[Op]:
    """1F1B (PipeDream-flush): stage ``s`` warms up with ``PP - s``
    forwards, then alternates 1B/1F, then drains the remaining backwards
    (V = 1)."""
    warmup = min(PP - stage, M)
    seq: List[Op] = [("F", m, 0) for m in range(warmup)]
    f_next, b_next = warmup, 0
    while b_next < M:
        seq.append(("B", b_next, 0))
        b_next += 1
        if f_next < M:
            seq.append(("F", f_next, 0))
            f_next += 1
    return seq


def interleaved_1f1b_order(PP: int, M: int, V: int, stage: int) -> List[Op]:
    """Megatron-style interleaved 1F1B over ``V`` virtual stages.

    Work units are (mb, chunk) pairs processed in groups of PP
    microbatches: forwards walk group 0 through chunks 0..V-1, then group 1,
    ...; backwards walk the chunks in reverse.  Stage ``s`` warms up with
    ``2(PP-s-1) + (V-1)PP`` forward units (the 2x depth is what keeps the
    steady state bubble-free across the chunk ring), then alternates
    1F/1B, then drains.  Requires ``M % PP == 0`` (Megatron's constraint);
    ``V = 1`` reduces exactly to :func:`one_f_one_b_order`.
    """
    if V == 1:
        return one_f_one_b_order(PP, M, stage)
    assert M % PP == 0, (M, PP)
    total = M * V
    group = PP * V

    def f_unit(i: int) -> Op:
        g, pos = divmod(i, group)
        return ("F", g * PP + pos % PP, pos // PP)

    def b_unit(j: int) -> Op:
        g, pos = divmod(j, group)
        return ("B", g * PP + pos % PP, V - 1 - pos // PP)

    warmup = min(2 * (PP - stage - 1) + (V - 1) * PP, total)
    seq = [f_unit(i) for i in range(warmup)]
    for i in range(warmup, total):  # steady state: 1F then 1B
        seq.append(f_unit(i))
        seq.append(b_unit(i - warmup))
    seq += [b_unit(j) for j in range(total - warmup, total)]
    return seq


@lru_cache(maxsize=None)
def _zb_h1_orders(PP: int, M: int) -> Tuple[Tuple[Op, ...], ...]:
    """Per-stage op orders of the ZB-H1 zero-bubble schedule (V = 1).

    Built by a global tick-level greedy over all stages at unit op cost —
    the same clock the executor runs — with three rules per stage per tick,
    in priority order:

    1. run the next **Bi** (ascending mb) when its own F is done and the
       downstream cotangent has arrived (1F1B's B rule — Bi keeps B's
       cadence and critical path, so hand-off ordering and the Eq-4
       residual profile are unchanged);
    2. when more than ``PP - 1`` weight grads are pending, run the oldest
       **Bw** — the deferral ceiling: the stash must bank enough Bw's to
       fill the drain stalls (the last stage provably needs PP pending at
       its final Bi) but no more, which caps ``num_wslots`` at
       ``min(PP, M)`` instead of letting deferred work pile up to M;
    3. run the next **F** under 1F1B's in-flight cap ``min(PP - s, M)``
       (Eq-4 memory discipline);
    4. otherwise fill the stall with the oldest pending **Bw**.

    For ``M >= PP`` the result is tick-optimal: makespan ``3M + PP - 1``
    (asserted in tests), per-stage idle ``PP - 1`` unit ops vs 1F1B's
    ``2(PP - 1)`` — the ``(PP-1)(t_F + t_B - 2 t_Bw)`` ZB-H1 bubble.
    """
    f_next = [0] * PP
    bi_next = [0] * PP
    bw_next = [0] * PP
    f_tick: Dict[Tuple[int, int], int] = {}
    bi_tick: Dict[Tuple[int, int], int] = {}
    cap = [min(PP - s, M) for s in range(PP)]
    ceiling = PP - 1  # max deferred weight grads before Bw preempts F
    orders: List[List[Op]] = [[] for _ in range(PP)]
    t, done, total = 0, 0, 3 * M * PP
    while done < total:
        picks: List[Optional[Op]] = []
        for s in range(PP):
            op: Optional[Op] = None
            m = bi_next[s]
            if (
                m < M
                and f_tick.get((s, m), t) < t
                and (s == PP - 1 or bi_tick.get((s + 1, m), t) < t)
            ):
                op = ("Bi", m, 0)
            if op is None and bi_next[s] - bw_next[s] > ceiling:
                op = ("Bw", bw_next[s], 0)
            if op is None:
                m = f_next[s]
                if (
                    m < M
                    and f_next[s] - bi_next[s] < cap[s]
                    and (s == 0 or f_tick.get((s - 1, m), t) < t)
                ):
                    op = ("F", m, 0)
            if op is None and bw_next[s] < bi_next[s]:
                op = ("Bw", bw_next[s], 0)
            picks.append(op)
        for s, op in enumerate(picks):
            if op is None:
                continue
            kind, m, _ = op
            if kind == "F":
                f_tick[(s, m)] = t
                f_next[s] += 1
            elif kind == "Bi":
                bi_tick[(s, m)] = t
                bi_next[s] += 1
            else:
                bw_next[s] += 1
            orders[s].append(op)
            done += 1
        t += 1
        assert t <= 3 * total + 2 * PP + 4, (
            f"zb_h1 greedy deadlocked at PP={PP}, M={M}"
        )
    return tuple(tuple(o) for o in orders)


def zb_h1_order(PP: int, M: int, stage: int) -> List[Op]:
    """ZB-H1 (zero bubble, Qi et al.): 1F1B with the backward split into
    Bi (activation grad, on 1F1B's B cadence) and Bw (weight grad, deferred
    into the drain stalls and the tail).  See :func:`_zb_h1_orders`."""
    return list(_zb_h1_orders(PP, M)[stage])


_ORDERS = {
    "gpipe": gpipe_order,
    "1f1b": one_f_one_b_order,
    # Overlap variant: 1F1B's compute table verbatim; build() attaches the
    # explicit comm lane (send at the producer tick, recv at the consumer
    # tick) and the in-flight comm-slot geometry.
    "1f1b_overlap": one_f_one_b_order,
    "interleaved_1f1b": interleaved_1f1b_order,
    "zb_h1": zb_h1_order,
}
assert set(_ORDERS) == set(SCHEDULES), "configs.base.SCHEDULES drifted"
assert set(OVERLAP_BASE) <= set(_ORDERS) and all(
    base in _ORDERS for base in OVERLAP_BASE.values()
), "OVERLAP_BASE drifted from the registered builders"


def _stage_orders(name: str, PP: int, M: int, V: int) -> List[List[Op]]:
    if name == "interleaved_1f1b":
        return [interleaved_1f1b_order(PP, M, V, s) for s in range(PP)]
    return [_ORDERS[name](PP, M, s) for s in range(PP)]


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Schedule:
    """Immutable tick-table IR (see module docstring)."""

    name: str
    PP: int
    M: int
    V: int  # virtual stages (model chunks) per physical stage
    num_ticks: int
    # ops[stage][tick] -> ("F"|"B"|"Bi"|"Bw", mb, vs) or None (idle)
    ops: Tuple[Tuple[Optional[Op], ...], ...]
    # max simultaneously-live (F-done, B-pending) chunk activations per stage
    peak_in_flight: Tuple[int, ...]
    # residual-buffer geometry: fixed slot per (stage, vs, mb), depth
    # num_slots
    slots: Tuple[Tuple[Tuple[int, ...], ...], ...]  # slots[stage][vs][mb]
    num_slots: int
    # W-stash geometry (split-backward schedules): fixed slot per split
    # (stage, vs, mb) covering the [Bi, Bw] deferral window; -1 for fused
    # entries, depth num_wslots (0 when the whole table is fused).
    wslots: Tuple[Tuple[Tuple[int, ...], ...], ...] = ()
    num_wslots: int = 0
    # Comm lane (overlap schedules): comm[stage][tick] -> tuple of CommOps.
    # A fwd hand-off edge chunk c -> c' appears as a SendF(mb, vs_of_c) on
    # c's stage and a RecvF(mb, vs_of_c') on c''s stage; the backward
    # cotangent edge as SendB/RecvB; A2A(mb, vs) brackets the expert
    # all-to-all overlapped with the same tick's compute op.  Empty for
    # legacy schedules (implicit send-at-tick-end wire model).
    comm: Tuple[Tuple[Tuple[CommOp, ...], ...], ...] = ()
    # In-flight comm-slot geometry, receiver-side: cslots_fwd[stage][vs][mb]
    # is the comm-buffer slot the fwd payload of the RECEIVING chunk
    # (stage, vs, mb) dwells in over (send_tick, recv_tick), -1 when the
    # payload is consumed the tick it lands (zero dwell) or never arrives.
    # cslots_bwd is the cotangent mirror.  Depths are the per-direction
    # double-buffer sizes (exactly the peak in-flight count).
    cslots_fwd: Tuple[Tuple[Tuple[int, ...], ...], ...] = ()
    cslots_bwd: Tuple[Tuple[Tuple[int, ...], ...], ...] = ()
    num_cslots_fwd: int = 0
    num_cslots_bwd: int = 0

    # -- views --------------------------------------------------------------

    def stage_order(self, stage: int) -> List[Op]:
        """Execution order of a stage's ops (idle ticks dropped)."""
        return [op for op in self.ops[stage] if op is not None]

    def op_ticks(self, kind: str) -> Dict[Tuple[int, int, int], int]:
        """{(stage, vs, mb): tick} for every op of ``kind``."""
        return {
            (s, op[2], op[1]): t
            for s, row in enumerate(self.ops)
            for t, op in enumerate(row)
            if op is not None and op[0] == kind
        }

    def cot_ticks(self) -> Dict[Tuple[int, int, int], int]:
        """{(stage, vs, mb): tick} of the residual-consuming, cotangent-
        producing backward — the fused B or the split Bi (the "B" role in
        hand-off ordering and slot lifetimes)."""
        out = self.op_ticks("B")
        out.update(self.op_ticks("Bi"))
        return out

    def occupancy_trace(self) -> np.ndarray:
        """(PP, num_ticks) int32: live (F-done, B-pending) chunk activations
        per stage AFTER each tick — the executor must reproduce this
        exactly.  Kinds map through the explicit OCC_DELTA table (F parks,
        B/Bi frees, Bw leaves residuals untouched); unknown kinds raise."""
        out = np.zeros((self.PP, self.num_ticks), np.int32)
        for s, row in enumerate(self.ops):
            live = 0
            for t, op in enumerate(row):
                if op is not None:
                    live += _occ_delta(op[0])
                out[s, t] = live
        return out

    def wstash_trace(self) -> np.ndarray:
        """(PP, num_ticks) int32: pending deferred weight grads per stage
        AFTER each tick (+1 at Bi, -1 at Bw) — the executed W-stash
        occupancy the split executor must reproduce.  All zeros for fused
        tables."""
        out = np.zeros((self.PP, self.num_ticks), np.int32)
        for s, row in enumerate(self.ops):
            live = 0
            for t, op in enumerate(row):
                if op is not None:
                    live += 1 if op[0] == "Bi" else -1 if op[0] == "Bw" else 0
                out[s, t] = live
        return out

    @property
    def has_comm(self) -> bool:
        """True when the schedule carries an explicit comm lane."""
        return any(cell for row in self.comm for cell in row)

    def comm_op_ticks(self, kind: str) -> Dict[Tuple[int, int, int], int]:
        """{(stage, vs, mb): tick} for every comm op of ``kind``."""
        return _comm_ticks(self.comm, kind)

    def comm_edges(self) -> List[Tuple[str, Tuple[int, int, int], int, int]]:
        """The comm lane as matched hand-off edges:
        [(direction, (recv_stage, recv_vs, mb), send_tick, recv_tick)] with
        direction in {"fwd", "bwd"}, keyed by the RECEIVING chunk.  Raises
        on unmatched Send/Recv pairs (use check_invariants for diagnosis)."""
        return _comm_edge_table(self.comm, self.PP, self.V)

    def comm_trace(self) -> np.ndarray:
        """(PP, num_ticks) int32: in-flight comm-buffer payloads per
        RECEIVING stage AFTER each tick — a payload dwells over ticks
        (send_tick, recv_tick) exclusive; zero-dwell hand-offs (consumed
        the tick they land) never enter the buffer.  All zeros for legacy
        schedules — the executor must reproduce this exactly."""
        out = np.zeros((self.PP, self.num_ticks), np.int32)
        for _direction, (s, _vs, _mb), ts, tr in self.comm_edges():
            out[s, ts + 1:tr] += 1
        return out

    def p2p_events(self) -> int:
        """Wire hand-offs the executor performs: one per F with a next
        chunk plus one per cotangent-producing backward (B or Bi) with a
        prev chunk (interleaving multiplies these ~V×; Bw ops emit weight
        grads only — no wire)."""
        n = 0
        for s, row in enumerate(self.ops):
            for op in row:
                if op is None:
                    continue
                k, _m, vs = op
                if k == "F" and next_chunk(s, vs, self.PP, self.V):
                    n += 1
                if k in COT_KINDS and prev_chunk(s, vs, self.PP, self.V):
                    n += 1
        return n

    def describe(self) -> str:
        wide = any(
            op is not None and len(op[0]) > 1
            for row in self.ops
            for op in row
        )
        rows = []
        for s, row in enumerate(self.ops):
            cells = []
            for op in row:
                if op is not None:
                    _kind_code(op[0])  # raise uniformly on unknown kinds
                if op is None:
                    pad = " " if wide else ""
                    cells.append(
                        f"    .{pad}  " if self.V > 1 else f"   .{pad} "
                    )
                elif self.V > 1:
                    cells.append(f"{op[0]:<{3 if wide else 1}s}"
                                 f"{op[2]}.{op[1]:<3d} ")
                else:
                    cells.append(f"{op[0]:<{2 if wide else 1}s}"
                                 f"{op[1]:<3d} ")
            rows.append(f"stage {s}: " + "".join(cells))
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# Builder: list-schedule an op order into the tick table
# ---------------------------------------------------------------------------


def list_schedule(
    stage_orders: List[List[Op]],
    t_fwd: float = 1.0,
    t_bwd: float = 2.0,
    V: int = 1,
    t_bw: Optional[float] = None,
    p2p_delay: float = 0.0,
    p2p_sync: bool = False,
) -> List[Tuple[int, Op, float, float]]:
    """Greedy dependency-resolving list scheduler over per-stage op orders.

    The ONE place the pipeline dependency rules live (both the IR builder —
    with unit durations, so starts become integral ticks — and the
    discrete-event simulator call this):

        F(chunk, mb) waits on F(prev_chunk, mb);  B/Bi(chunk, mb) waits on
        F(chunk, mb) and, below the last chunk, on B/Bi(next_chunk, mb)
        (Bi plays B's role in the cotangent hand-off chain);
        Bw(chunk, mb) waits only on its own Bi(chunk, mb) — weight grads
        are local, so Bw floats freely within its stage's sequence;
        each stage is sequential.  Durations are PER OP, i.e. per chunk
        (callers model interleaving by passing per-vstage durations).

    ``t_bwd`` is the FULL backward duration; split schedules charge Bw ops
    ``t_bw`` (default ``t_bwd / 2``) and Bi ops the remaining
    ``t_bwd - t_bw``, so fused and split orders are comparable at equal
    total work.

    ``p2p_delay`` adds a transfer latency to every CROSS-STAGE dependency
    edge (fwd activation hand-offs and bwd cotangent hand-offs): the
    consumer may start no earlier than producer end + delay, but the
    producing and consuming stages stay free in between — i.e. the
    transfer happens on a background comm lane, and only the part that
    the dependency chain cannot hide extends the makespan.  This is the
    replay model for comm-lane (``has_comm``) schedules; the default 0.0
    keeps legacy behavior bit-identical.

    ``p2p_sync=True`` additionally BLOCKS the producing stage for
    ``p2p_delay`` after every op whose output crosses a stage edge — the
    synchronous hand-off semantics of schedules without a comm lane,
    where the transfer sits on the tick edge and the sender cannot start
    its next op until the collective completes.  The async comm-lane
    replay is the same DAG minus that blocking, so its makespan is never
    larger: the overlap saving is exactly the blocking time the
    dependency chain can absorb.

    Returns [(stage, op, start, end)] or raises on a deadlocked order.
    """
    PP = len(stage_orders)
    t_w = t_bwd / 2.0 if t_bw is None else t_bw
    dur = {"F": t_fwd, "B": t_bwd, "Bi": t_bwd - t_w, "Bw": t_w}
    pending = {s: list(stage_orders[s]) for s in range(PP)}
    done_f: Dict[Tuple[int, int, int], float] = {}
    done_b: Dict[Tuple[int, int, int], float] = {}  # B and Bi (cot producers)
    t_stage = [0.0] * PP
    placed: List[Tuple[int, Op, float, float]] = []

    progressed = True
    while progressed and any(pending.values()):
        progressed = False
        for s in range(PP):
            while pending[s]:
                kind, mb, vs = pending[s][0]
                if kind not in dur:
                    raise ValueError(
                        f"unknown op kind {kind!r}; known: {sorted(dur)}"
                    )
                if kind == "F":
                    prv = prev_chunk(s, vs, PP, V)
                    dep = 0.0 if prv is None else done_f.get(prv + (mb,))
                    if dep is not None and prv is not None and prv[0] != s:
                        dep += p2p_delay
                elif kind == "Bw":
                    dep = done_b.get((s, vs, mb))  # own Bi only
                else:  # fused B or split Bi: residual + downstream cotangent
                    nxt = next_chunk(s, vs, PP, V)
                    dep = (
                        done_f.get((s, vs, mb))
                        if nxt is None
                        else done_b.get(nxt + (mb,))
                    )
                    if dep is not None and nxt is not None and nxt[0] != s:
                        dep += p2p_delay
                    if dep is not None and done_f.get((s, vs, mb)) is None:
                        dep = None
                if dep is None:
                    break
                start = max(t_stage[s], dep)
                end = start + dur[kind]
                t_stage[s] = end
                if kind == "F":
                    done_f[(s, vs, mb)] = end
                    out_edge = next_chunk(s, vs, PP, V)
                elif kind in COT_KINDS:
                    done_b[(s, vs, mb)] = end
                    out_edge = prev_chunk(s, vs, PP, V)
                else:
                    out_edge = None
                if (
                    p2p_sync
                    and out_edge is not None
                    and out_edge[0] != s
                ):
                    t_stage[s] = end + p2p_delay
                placed.append((s, (kind, mb, vs), start, end))
                pending[s].pop(0)
                progressed = True
    assert not any(pending.values()), "deadlocked op order"
    return placed


def _place_ops(
    name: str, PP: int, M: int, V: int
) -> List[List[Optional[Op]]]:
    """Unit-time list scheduling of the canonical per-stage orders: every
    op costs one tick (split orders pass t_bwd=2/t_bw=1 so Bi and Bw are
    each a unit op; fused orders charge the whole backward one tick)."""
    orders = _stage_orders(name, PP, M, V)
    split = any(op[0] == "Bw" for order in orders for op in order)
    placed = list_schedule(
        orders,
        t_fwd=1.0,
        t_bwd=2.0 if split else 1.0,
        V=V,
        t_bw=1.0 if split else None,
    )
    T = int(max(end for _, _, _, end in placed))
    table: List[List[Optional[Op]]] = [[None] * T for _ in range(PP)]
    for s, op, start, _end in placed:
        t = int(start)
        assert t == start and table[s][t] is None
        table[s][t] = op
    return table


def _residency(
    f: Dict[Tuple[int, int, int], int],
    b: Dict[Tuple[int, int, int], int],
    stage: int,
    PP: int,
    V: int,
    M: int,
) -> List[Tuple[int, int, Tuple[int, int]]]:
    """[(alloc_tick, free_tick, (vs, mb))] residual residencies of a stage:
    a chunk input lives from the tick it ARRIVES (prev-chunk F + 1; own F
    tick for the raw-input chunk (0, 0)) until its B — or, split, its Bi —
    op frees it (``b`` is the cotangent-producer tick map)."""
    out = []
    for vs in range(V):
        for mb in range(M):
            prv = prev_chunk(stage, vs, PP, V)
            alloc = (
                f[(stage, vs, mb)] if prv is None else f[prv + (mb,)] + 1
            )
            out.append((alloc, b[(stage, vs, mb)], (vs, mb)))
    return out


def _assign_slots(
    table: List[List[Optional[Op]]], PP: int, M: int, V: int
) -> Tuple[Tuple[Tuple[Tuple[int, ...], ...], ...], int]:
    """Fixed residual slot per (stage, vs, mb): smallest free slot over the
    arrival→backward lifetime (greedy over sorted arrivals — optimal depth
    for interval graphs, so ``num_slots`` equals the peak residency).  The
    freeing op is the cotangent producer: fused B or split Bi."""
    f = {
        (s, op[2], op[1]): t
        for s, row in enumerate(table)
        for t, op in enumerate(row)
        if op and op[0] == "F"
    }
    b = {
        (s, op[2], op[1]): t
        for s, row in enumerate(table)
        for t, op in enumerate(row)
        if op and op[0] in COT_KINDS
    }
    slots: List[Tuple[Tuple[int, ...], ...]] = []
    depth = 0
    for s in range(PP):
        free_at: List[int] = []  # free_at[slot] = first tick slot is free
        stage_slots = [[0] * M for _ in range(V)]
        for alloc, free, (vs, mb) in sorted(_residency(f, b, s, PP, V, M)):
            for i, fa in enumerate(free_at):
                if fa <= alloc:
                    stage_slots[vs][mb] = i
                    free_at[i] = free + 1
                    break
            else:
                stage_slots[vs][mb] = len(free_at)
                free_at.append(free + 1)
        slots.append(tuple(tuple(row) for row in stage_slots))
        depth = max(depth, len(free_at))
    return tuple(slots), depth


def _wstash_residency(
    bi: Dict[Tuple[int, int, int], int],
    bw: Dict[Tuple[int, int, int], int],
    stage: int,
) -> List[Tuple[int, int, Tuple[int, int]]]:
    """[(bi_tick, bw_tick, (vs, mb))] W-stash residencies of a stage: the
    deferred weight-grad inputs live from the Bi that stashed them until
    the Bw that drains them."""
    return [
        (t_bi, bw[key], (key[1], key[2]))
        for key, t_bi in bi.items()
        if key[0] == stage and key in bw
    ]


def _assign_wslots(
    table: List[List[Optional[Op]]], PP: int, M: int, V: int
) -> Tuple[Tuple[Tuple[Tuple[int, ...], ...], ...], int]:
    """Fixed W-stash slot per split (stage, vs, mb): smallest free slot
    over the Bi→Bw deferral window (same greedy interval coloring as the
    residual slots, so ``num_wslots`` equals the peak number of deferred
    weight grads).  Fused entries get slot -1; a fully-fused table has
    depth 0."""
    bi = {
        (s, op[2], op[1]): t
        for s, row in enumerate(table)
        for t, op in enumerate(row)
        if op and op[0] == "Bi"
    }
    bw = {
        (s, op[2], op[1]): t
        for s, row in enumerate(table)
        for t, op in enumerate(row)
        if op and op[0] == "Bw"
    }
    wslots: List[Tuple[Tuple[int, ...], ...]] = []
    depth = 0
    for s in range(PP):
        free_at: List[int] = []
        stage_slots = [[-1] * M for _ in range(V)]
        for alloc, free, (vs, mb) in sorted(_wstash_residency(bi, bw, s)):
            for i, fa in enumerate(free_at):
                if fa <= alloc:
                    stage_slots[vs][mb] = i
                    free_at[i] = free + 1
                    break
            else:
                stage_slots[vs][mb] = len(free_at)
                free_at.append(free + 1)
        wslots.append(tuple(tuple(row) for row in stage_slots))
        depth = max(depth, len(free_at))
    return tuple(wslots), depth


def _synthesize_comm(
    table: List[List[Optional[Op]]], PP: int, M: int, V: int
) -> Tuple[Tuple[Tuple[CommOp, ...], ...], ...]:
    """Explicit comm lane for an overlap schedule: every hand-off edge of
    the compute table gets a Send on the producer AT its compute tick (the
    payload exists at tick end — the earliest legal issue) and a Recv on
    the consumer AT its consuming tick (the latest legal arrival), so the
    transfer window spans every intervening tick and the in-flight payload
    double-buffers in a comm slot while both stages keep computing.  A2A
    brackets ride every F and cotangent op: the expert all-to-all of that
    microbatch overlapped with its own compute (the chunked double-buffered
    loop of docs/a2a.md, made schedule-visible so the simulator can price
    its exposure per tick)."""
    T = len(table[0])
    comm: List[List[List[CommOp]]] = [[[] for _ in range(T)] for _ in range(PP)]
    f = {
        (s, op[2], op[1]): t
        for s, row in enumerate(table)
        for t, op in enumerate(row)
        if op and op[0] == "F"
    }
    b = {
        (s, op[2], op[1]): t
        for s, row in enumerate(table)
        for t, op in enumerate(row)
        if op and op[0] in COT_KINDS
    }
    for (s, vs, mb), t in f.items():
        nxt = next_chunk(s, vs, PP, V)
        if nxt is not None:
            ns, nv = nxt
            comm[s][t].append(("SendF", mb, vs))
            comm[ns][f[(ns, nv, mb)]].append(("RecvF", mb, nv))
    for (s, vs, mb), t in b.items():
        prv = prev_chunk(s, vs, PP, V)
        if prv is not None:
            ps, pv = prv
            comm[s][t].append(("SendB", mb, vs))
            comm[ps][b[(ps, pv, mb)]].append(("RecvB", mb, pv))
    for s, row in enumerate(table):
        for t, op in enumerate(row):
            if op and (op[0] == "F" or op[0] in COT_KINDS):
                comm[s][t].append(("A2A", op[1], op[2]))
    return tuple(tuple(tuple(cell) for cell in row) for row in comm)


def _comm_ticks(
    comm: Tuple[Tuple[Tuple[CommOp, ...], ...], ...], kind: str
) -> Dict[Tuple[int, int, int], int]:
    _comm_kind_code(kind)
    return {
        (s, op[2], op[1]): t
        for s, row in enumerate(comm)
        for t, cell in enumerate(row)
        for op in cell
        if op[0] == kind
    }


def _comm_edge_table(
    comm: Tuple[Tuple[Tuple[CommOp, ...], ...], ...], PP: int, V: int
) -> List[Tuple[str, Tuple[int, int, int], int, int]]:
    """Matched Send/Recv pairs of a comm lane, keyed by the RECEIVING
    chunk: [(direction, (stage, vs, mb), send_tick, recv_tick)].  Asserts
    on unmatched pairs — check_invariants gives the diagnosable error."""
    out = []
    for direction, skind, rkind in (
        ("fwd", "SendF", "RecvF"), ("bwd", "SendB", "RecvB"),
    ):
        sends = _comm_ticks(comm, skind)
        for (s, vs, mb), tr in _comm_ticks(comm, rkind).items():
            src = (
                prev_chunk(s, vs, PP, V)
                if direction == "fwd"
                else next_chunk(s, vs, PP, V)
            )
            assert src is not None, ("recv with no source chunk", s, vs)
            ts = sends.get(src + (mb,))
            assert ts is not None, ("orphan recv", direction, s, vs, mb)
            out.append((direction, (s, vs, mb), ts, tr))
    return out


def _assign_cslots(
    comm: Tuple[Tuple[Tuple[CommOp, ...], ...], ...], PP: int, M: int, V: int
) -> Tuple[
    Tuple[Tuple[Tuple[Tuple[int, ...], ...], ...], int],
    Tuple[Tuple[Tuple[Tuple[int, ...], ...], ...], int],
]:
    """Fixed in-flight comm slot per received payload: greedy interval
    coloring of the (send_tick, recv_tick)-exclusive dwell windows per
    receiving stage and direction (same scheme as the residual slots, so
    the depth equals the peak in-flight count — the double-buffer size).
    Zero-dwell payloads (consumed the tick they land) never buffer: -1."""
    edges = _comm_edge_table(comm, PP, V)
    out = []
    for direction in ("fwd", "bwd"):
        by_stage: Dict[int, List[Tuple[int, int, Tuple[int, int]]]] = {
            s: [] for s in range(PP)
        }
        for d, (s, vs, mb), ts, tr in edges:
            if d == direction and tr > ts + 1:
                by_stage[s].append((ts + 1, tr - 1, (vs, mb)))
        slots: List[Tuple[Tuple[int, ...], ...]] = []
        depth = 0
        for s in range(PP):
            free_at: List[int] = []
            stage_slots = [[-1] * M for _ in range(V)]
            for alloc, free, (vs, mb) in sorted(by_stage[s]):
                for i, fa in enumerate(free_at):
                    if fa <= alloc:
                        stage_slots[vs][mb] = i
                        free_at[i] = free + 1
                        break
                else:
                    stage_slots[vs][mb] = len(free_at)
                    free_at.append(free + 1)
            slots.append(tuple(tuple(row) for row in stage_slots))
            depth = max(depth, len(free_at))
        out.append((tuple(slots), depth))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# The universal schedule-invariant harness
# ---------------------------------------------------------------------------


def _require(cond: bool, sched: "Schedule", what: str, *ctx) -> None:
    if not cond:
        raise InvariantViolation(
            f"{sched.name}(PP={sched.PP}, M={sched.M}, V={sched.V}): {what}"
            + (f" {ctx}" if ctx else "")
        )


def check_invariants(sched: Schedule) -> None:
    """Validate a schedule table against the IR contract — builder-agnostic,
    so ANY new schedule is checked by construction.  Raises
    :class:`InvariantViolation` on the first failure.  Covered:

    1. table shape: PP rows of num_ticks cells, at most one well-formed op
       per (stage, tick), kinds drawn from KIND_CODE;
    2. completeness: every (stage, vs, mb) is F'd exactly once and
       backward-completed exactly once — EITHER one fused B, OR a split
       Bi + Bw pair (never both forms, never a dangling half);
    3. residual exists: B/Bi(chunk, mb) after F(chunk, mb), and
       Bi-before-Bw per (stage, vs, mb) — the weight grad drains a stash
       its Bi must have filled;
    4. hand-off ordering across stages AND vstages: F(chunk) strictly after
       F(prev_chunk), B/Bi(chunk) strictly after B/Bi(next_chunk) — one
       ppermute tick per (possibly wrap-around) edge (Bw has no hand-off);
    5. slot geometry: slots shaped (PP, V, M), ids < num_slots, and no two
       residencies (arrival → B/Bi) overlap in the same (stage, slot);
    6. num_slots == the max of the residency occupancy trace (the depth is
       minimal, not just sufficient);
    7. W-stash geometry: wslots shaped (PP, V, M) with a valid slot id for
       every split key (-1 for fused keys), no two [Bi, Bw] deferral
       windows overlap in the same (stage, wslot), and num_wslots == the
       peak of the W-stash residency trace (no stash over-allocation);
    8. peak_in_flight == per-stage max of the F-minus-B/Bi occupancy
       trace, which drains to zero; the W-stash trace drains too;
    9. comm lane (overlap schedules): well-formed comm ops, every hand-off
       edge of the compute table covered by exactly one Send + one Recv
       (no orphan, missing, or duplicate sends/recvs), send at/after the
       payload-producing op and strictly before the recv, recv at/before
       the consuming op (send-before-recv across every (stage, vstage)
       edge incl. wrap), A2A brackets pinned to a matching compute op,
       in-flight comm-slot windows disjoint per (stage, direction, slot)
       with num_cslots == the peak in-flight count (bounded buffers), and
       the in-flight trace drains to zero.
    """
    PP, M, V, T = sched.PP, sched.M, sched.V, sched.num_ticks

    # 1. shape + well-formed ops
    _require(len(sched.ops) == PP, sched, "ops must have PP rows")
    for s, row in enumerate(sched.ops):
        _require(len(row) == T, sched, "row length != num_ticks", s)
        for t, op in enumerate(row):
            if op is None:
                continue
            _require(
                len(op) == 3
                and op[0] in KIND_CODE
                and 0 <= op[1] < M
                and 0 <= op[2] < V,
                sched, "malformed op", s, t, op,
            )

    # 2. completeness: one F; one fused B xor one (Bi, Bw) pair
    f = sched.op_ticks("F")
    b_fused = sched.op_ticks("B")
    bi = sched.op_ticks("Bi")
    bw = sched.op_ticks("Bw")
    want = {(s, vs, mb) for s in range(PP) for vs in range(V) for mb in range(M)}
    _require(set(f) == want, sched, "every (stage, vs, mb) F'd exactly once")
    _require(
        not (set(b_fused) & (set(bi) | set(bw))), sched,
        "fused B and split Bi/Bw for the same (stage, vs, mb)",
    )
    _require(
        set(bi) == set(bw), sched,
        "split keys must have BOTH a Bi and a Bw (dangling half)",
    )
    _require(
        (set(b_fused) | set(bi)) == want, sched,
        "every (stage, vs, mb) B'd exactly once",
    )
    n_ops = sum(1 for row in sched.ops for op in row if op is not None)
    _require(
        n_ops == len(f) + len(b_fused) + len(bi) + len(bw),
        sched, "duplicate ops in the table",
    )

    # 3 + 4. residual + Bi-before-Bw + hand-off ordering over the chunk ring
    b = dict(b_fused)
    b.update(bi)  # the cotangent producer per key (B role)
    for s in range(PP):
        for vs in range(V):
            for mb in range(M):
                c = (s, vs, mb)
                _require(b[c] > f[c], sched, "B before its F", c)
                if c in bw:
                    _require(
                        bw[c] > bi[c], sched, "Bw not after its Bi", c,
                    )
                prv = prev_chunk(s, vs, PP, V)
                if prv is not None:
                    _require(
                        f[c] > f[prv + (mb,)], sched,
                        "F hand-off not strictly later", c,
                    )
                nxt = next_chunk(s, vs, PP, V)
                if nxt is not None:
                    _require(
                        b[c] > b[nxt + (mb,)], sched,
                        "B hand-off not strictly later", c,
                    )

    # 5 + 6. slot geometry and minimal depth
    _require(
        len(sched.slots) == PP
        and all(len(sv) == V and all(len(row) == M for row in sv)
                for sv in sched.slots),
        sched, "slots must be shaped (PP, V, M)",
    )
    max_resident = 0
    for s in range(PP):
        res = _residency(f, b, s, PP, V, M)
        by_slot: Dict[int, List[Tuple[int, int]]] = {}
        events = []
        for alloc, free, (vs, mb) in res:
            slot = sched.slots[s][vs][mb]
            _require(
                0 <= slot < sched.num_slots, sched, "slot id out of range",
                s, vs, mb, slot,
            )
            by_slot.setdefault(slot, []).append((alloc, free))
            events.append((alloc, free))
        for slot, intervals in by_slot.items():
            intervals.sort()
            for (a0, f0), (a1, _) in zip(intervals, intervals[1:]):
                _require(
                    f0 < a1, sched, "overlapping residencies in one slot",
                    s, slot, (a0, f0), a1,
                )
        # peak simultaneous residencies of the stage (sweep line)
        for t in {a for a, _ in events}:
            live = sum(1 for a, fr in events if a <= t <= fr)
            max_resident = max(max_resident, live)
    _require(
        sched.num_slots == max_resident, sched,
        "num_slots != max of the residency occupancy trace",
        sched.num_slots, max_resident,
    )

    # 7. W-stash geometry and minimal depth (split-backward schedules)
    _require(
        len(sched.wslots) == PP
        and all(len(sv) == V and all(len(row) == M for row in sv)
                for sv in sched.wslots),
        sched, "wslots must be shaped (PP, V, M)",
    )
    max_stash = 0
    for s in range(PP):
        wres = _wstash_residency(bi, bw, s)
        by_wslot: Dict[int, List[Tuple[int, int]]] = {}
        for alloc, free, (vs, mb) in wres:
            wslot = sched.wslots[s][vs][mb]
            _require(
                0 <= wslot < sched.num_wslots, sched,
                "W-stash slot id out of range", s, vs, mb, wslot,
            )
            by_wslot.setdefault(wslot, []).append((alloc, free))
        for vs in range(V):
            for mb in range(M):
                if (s, vs, mb) not in bi:
                    _require(
                        sched.wslots[s][vs][mb] == -1, sched,
                        "fused key must carry W-stash slot -1", s, vs, mb,
                    )
        for wslot, intervals in by_wslot.items():
            intervals.sort()
            for (a0, f0), (a1, _) in zip(intervals, intervals[1:]):
                _require(
                    f0 < a1, sched,
                    "overlapping deferral windows in one W-stash slot",
                    s, wslot, (a0, f0), a1,
                )
        for t in {a for a, _, _ in wres}:
            live = sum(1 for a, fr, _ in wres if a <= t <= fr)
            max_stash = max(max_stash, live)
    _require(
        sched.num_wslots == max_stash, sched,
        "num_wslots != max of the W-stash residency trace (stash "
        "over- or under-allocated)", sched.num_wslots, max_stash,
    )

    # 8. occupancy traces: peaks match, drain to zero, never negative
    occ = sched.occupancy_trace()
    _require(
        tuple(int(x) for x in occ.max(axis=1)) == tuple(sched.peak_in_flight),
        sched, "peak_in_flight != occupancy-trace maxima",
    )
    _require(bool((occ[:, -1] == 0).all()), sched, "schedule does not drain")
    _require(bool((occ >= 0).all()), sched, "negative occupancy (B before F)")
    wocc = sched.wstash_trace()
    _require(
        bool((wocc[:, -1] == 0).all()), sched,
        "W-stash does not drain (missing Bw)",
    )
    _require(
        bool((wocc >= 0).all()), sched, "negative W-stash (Bw before Bi)",
    )

    # 9. comm lane (overlap schedules only)
    if sched.comm:
        _require(
            len(sched.comm) == PP
            and all(len(row) == T for row in sched.comm),
            sched, "comm must be shaped (PP, num_ticks)",
        )
        counts = {k: 0 for k in COMM_KIND_CODE}
        for s, row in enumerate(sched.comm):
            for t, cell in enumerate(row):
                for cop in cell:
                    _require(
                        len(cop) == 3
                        and cop[0] in COMM_KIND_CODE
                        and 0 <= cop[1] < M
                        and 0 <= cop[2] < V,
                        sched, "malformed comm op", s, t, cop,
                    )
                    counts[cop[0]] += 1
    if sched.has_comm:
        # Pairing + completeness: the comm lane must cover EVERY hand-off
        # edge of the compute table, exactly once per endpoint.
        sf, rf = sched.comm_op_ticks("SendF"), sched.comm_op_ticks("RecvF")
        sb, rb = sched.comm_op_ticks("SendB"), sched.comm_op_ticks("RecvB")
        senders_f = {c for c in f if next_chunk(c[0], c[1], PP, V)}
        receivers_f = {c for c in f if prev_chunk(c[0], c[1], PP, V)}
        senders_b = {c for c in b if prev_chunk(c[0], c[1], PP, V)}
        receivers_b = {c for c in b if next_chunk(c[0], c[1], PP, V)}
        for kind, have, want in (
            ("SendF", sf, senders_f), ("RecvF", rf, receivers_f),
            ("SendB", sb, senders_b), ("RecvB", rb, receivers_b),
        ):
            _require(
                set(have) == want, sched,
                f"comm lane must cover every hand-off edge with one {kind} "
                f"(orphan or missing)",
                sorted(set(have) ^ want)[:4],
            )
            _require(
                counts[kind] == len(have), sched,
                f"duplicate {kind} ops in the comm lane",
            )
        # Ordering per edge: the payload exists before its send, the send
        # strictly precedes the recv (one in-flight tick minimum), and the
        # recv lands by the consuming op's tick — wrap edges included.
        for direction, recvs, sends, produce, consume in (
            ("fwd", rf, sf, f, f), ("bwd", rb, sb, b, b),
        ):
            for (s, vs, mb), tr in recvs.items():
                src = (
                    prev_chunk(s, vs, PP, V)
                    if direction == "fwd"
                    else next_chunk(s, vs, PP, V)
                )
                _require(
                    src is not None, sched,
                    "recv on a chunk with no source edge", direction, s, vs,
                )
                ts = sends[src + (mb,)]
                _require(
                    ts >= produce[src + (mb,)], sched,
                    "send before its payload-producing op",
                    direction, src, mb, ts,
                )
                _require(
                    tr > ts, sched, "recv not strictly after its send",
                    direction, s, vs, mb, ts, tr,
                )
                _require(
                    tr <= consume[(s, vs, mb)], sched,
                    "recv after its consuming op", direction, s, vs, mb,
                )
        # A2A brackets must ride a matching compute op (same stage, tick,
        # microbatch, vstage; F or a cotangent producer).
        for s, row in enumerate(sched.comm):
            for t, cell in enumerate(row):
                for cop in cell:
                    if cop[0] != "A2A":
                        continue
                    host = sched.ops[s][t]
                    _require(
                        host is not None
                        and (host[0] == "F" or host[0] in COT_KINDS)
                        and host[1] == cop[1]
                        and host[2] == cop[2],
                        sched, "A2A bracket without a matching compute op",
                        s, t, cop, host,
                    )
        # Comm-slot geometry: dwell windows disjoint per (stage, slot),
        # depth == peak in-flight (bounded, minimal), trace drains.
        edges = sched.comm_edges()
        for direction, cslots, depth in (
            ("fwd", sched.cslots_fwd, sched.num_cslots_fwd),
            ("bwd", sched.cslots_bwd, sched.num_cslots_bwd),
        ):
            _require(
                len(cslots) == PP
                and all(len(sv) == V and all(len(r) == M for r in sv)
                        for sv in cslots),
                sched, f"cslots_{direction} must be shaped (PP, V, M)",
            )
            max_inflight = 0
            for stage in range(PP):
                windows = [
                    (ts + 1, tr - 1, key[1], key[2])
                    for d, key, ts, tr in edges
                    if d == direction and key[0] == stage and tr > ts + 1
                ]
                keyed = {(vs, mb) for _, _, vs, mb in windows}
                for vs in range(V):
                    for mb in range(M):
                        cs = cslots[stage][vs][mb]
                        if (vs, mb) in keyed:
                            _require(
                                0 <= cs < depth, sched,
                                "comm slot id out of range",
                                direction, stage, vs, mb, cs,
                            )
                        else:
                            _require(
                                cs == -1, sched,
                                "zero-dwell payload must carry comm slot -1",
                                direction, stage, vs, mb, cs,
                            )
                by_cslot: Dict[int, List[Tuple[int, int]]] = {}
                for alloc, free, vs, mb in windows:
                    by_cslot.setdefault(
                        cslots[stage][vs][mb], []
                    ).append((alloc, free))
                for cs, intervals in by_cslot.items():
                    intervals.sort()
                    for (a0, f0), (a1, _) in zip(intervals, intervals[1:]):
                        _require(
                            f0 < a1, sched,
                            "overlapping in-flight windows in one comm slot",
                            direction, stage, cs, (a0, f0), a1,
                        )
                for t in {a for a, _, _, _ in windows}:
                    live = sum(
                        1 for a, fr, _, _ in windows if a <= t <= fr
                    )
                    max_inflight = max(max_inflight, live)
            _require(
                depth == max_inflight, sched,
                f"num_cslots_{direction} != peak in-flight count "
                f"(comm buffer over- or under-allocated)",
                depth, max_inflight,
            )
        ctrace = sched.comm_trace()
        _require(
            bool((ctrace[:, -1] == 0).all()), sched,
            "comm in-flight trace does not drain to zero",
        )
    else:
        _require(
            sched.num_cslots_fwd == 0 and sched.num_cslots_bwd == 0,
            sched, "comm slots without a comm lane",
        )


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def build(name: str, PP: int, M: int, V: int = 1) -> Schedule:
    """Build (and cache) the tick-table IR for a named schedule.

    ``V`` is part of the cache key: interleaved tables for different
    virtual-stage counts are distinct schedules (a V-less key would alias
    them).  ``V > 1`` is only meaningful for ``interleaved_1f1b`` and
    requires ``M % PP == 0``; callers binding a model must additionally
    ensure ``V`` divides the layers-per-stage count (the executor asserts
    it)."""
    if name not in _ORDERS:
        raise ValueError(
            f"unknown schedule {name!r}; available: {sorted(_ORDERS)}"
        )
    assert PP >= 1 and M >= 1, (PP, M)
    if V < 1:
        raise ValueError(f"vstages must be >= 1, got {V}")
    if V > 1 and name != "interleaved_1f1b":
        raise ValueError(
            f"schedule {name!r} has no virtual-stage form; use "
            f"'interleaved_1f1b' for V={V} > 1"
        )
    if V > 1 and M % PP:
        raise ValueError(
            f"interleaved_1f1b requires M % PP == 0 (Megatron's "
            f"constraint), got M={M}, PP={PP}"
        )
    table = _place_ops(name, PP, M, V)
    occupancy = []
    for s in range(PP):
        live = peak = 0
        for op in table[s]:
            if op:
                live += _occ_delta(op[0])
                peak = max(peak, live)
        occupancy.append(peak)
    slots, depth = _assign_slots(table, PP, M, V)
    wslots, wdepth = _assign_wslots(table, PP, M, V)
    comm: Tuple = ()
    cslots_f: Tuple = ()
    cslots_b: Tuple = ()
    ncf = ncb = 0
    if name in OVERLAP_BASE:
        comm = _synthesize_comm(table, PP, M, V)
        (cslots_f, ncf), (cslots_b, ncb) = _assign_cslots(comm, PP, M, V)
    sched = Schedule(
        name=name,
        PP=PP,
        M=M,
        V=V,
        num_ticks=len(table[0]),
        ops=tuple(tuple(row) for row in table),
        peak_in_flight=tuple(occupancy),
        slots=slots,
        num_slots=depth,
        wslots=wslots,
        num_wslots=wdepth,
        comm=comm,
        cslots_fwd=cslots_f,
        cslots_bwd=cslots_b,
        num_cslots_fwd=ncf,
        num_cslots_bwd=ncb,
    )
    check_invariants(sched)
    return sched


# ---------------------------------------------------------------------------
# Executor tables
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TickTables:
    """The IR lowered to dense int32 arrays the SPMD executor indexes with
    ``[stage, tick]`` inside its clock scan.

    ``arrive_fwd``/``arrive_bwd`` give the residual-buffer slot into which a
    wire payload arriving at the START of a tick must be stored (-1: no
    arrival): the activation ppermuted by the prev chunk's F at ``t-1``, and
    the cotangent ppermuted by the next chunk's B (or Bi) at ``t-1``,
    respectively.  With virtual stages the chunk ring's wrap-around edges
    make stage 0 a forward receiver (from stage PP-1) and stage PP-1 a
    backward receiver (from stage 0); each stage still receives at most one
    payload per direction per tick, because each sender ppermutes one
    payload per tick.

    ``wslot`` is the W-stash slot of the tick's op for split-backward
    schedules: the slot a Bi op STORES its deferred weight-grad inputs
    into, and the slot the matching Bw op later DRAINS (-1 when the op has
    no stash interaction — F, fused B, idle).
    """

    kind: np.ndarray  # (PP, T) in {OP_IDLE, OP_F, OP_B, OP_BI, OP_BW}
    mb: np.ndarray  # (PP, T) microbatch of the op (0 when idle)
    vs: np.ndarray  # (PP, T) virtual stage (chunk) of the op (0 when idle)
    slot: np.ndarray  # (PP, T) residual slot of the op's (vs, mb) (0 idle)
    arrive_fwd: np.ndarray  # (PP, T) slot to store arriving activation, -1
    arrive_fwd_mb: np.ndarray  # (PP, T) arriving microbatch id, -1
    arrive_bwd: np.ndarray  # (PP, T) slot to store arriving cotangent, -1
    wslot: np.ndarray = None  # (PP, T) W-stash slot of a Bi/Bw op, -1
    # Comm-lane routing (overlap schedules; None for legacy tables).  A
    # payload whose explicit Recv tick is LATER than the tick after its
    # Send dwells in the in-flight comm buffer: ``store_*`` gives the comm
    # slot the wire payload landing at the start of a tick is stored into
    # (-1: no dwell — either no arrival or it is consumed directly), and
    # ``src_*`` gives the comm slot a Recv tick's payload is read FROM
    # when parking it into its residual slot (-1: park the wire payload
    # directly, the legacy zero-dwell path).
    store_fwd: np.ndarray = None  # (PP, T) comm slot to store recv_h, -1
    src_fwd: np.ndarray = None  # (PP, T) comm slot feeding arrive_fwd, -1
    store_bwd: np.ndarray = None  # (PP, T) comm slot to store recv_g, -1
    src_bwd: np.ndarray = None  # (PP, T) comm slot feeding arrive_bwd, -1


def tick_tables(sched: Schedule) -> TickTables:
    PP, T, V = sched.PP, sched.num_ticks, sched.V
    kind = np.zeros((PP, T), np.int32)
    mb = np.zeros((PP, T), np.int32)
    vs = np.zeros((PP, T), np.int32)
    slot = np.zeros((PP, T), np.int32)
    arrive_fwd = np.full((PP, T), -1, np.int32)
    arrive_fwd_mb = np.full((PP, T), -1, np.int32)
    arrive_bwd = np.full((PP, T), -1, np.int32)
    wslot = np.full((PP, T), -1, np.int32)
    for s in range(PP):
        for t, op in enumerate(sched.ops[s]):
            if op is None:
                continue
            k, m, v = op
            # Explicit kind -> code map; raises on an unknown kind so a new
            # op kind can never be silently mis-encoded as OP_B.
            kind[s, t] = _kind_code(k)
            mb[s, t] = m
            vs[s, t] = v
            if k in ("Bi", "Bw"):
                wslot[s, t] = sched.wslots[s][v][m]
                assert wslot[s, t] >= 0, ("split op without a W-stash slot",
                                          s, t, op)
            # A Bw op reads the stash, not the residual buffer: its slot
            # cell stays 0 (unused by the executor).
            if k != "Bw":
                slot[s, t] = sched.slots[s][v][m]
            if not sched.has_comm:
                # Legacy implicit wire model: the payload ppermuted at the
                # END of the producing tick parks at the START of t + 1.
                if k == "F":
                    nxt = next_chunk(s, v, PP, V)
                    if nxt is not None and t + 1 < T:
                        ns, nv = nxt
                        assert arrive_fwd[ns, t + 1] == -1, "fwd arrival clash"
                        arrive_fwd[ns, t + 1] = sched.slots[ns][nv][m]
                        arrive_fwd_mb[ns, t + 1] = m
                if k in COT_KINDS:
                    prv = prev_chunk(s, v, PP, V)
                    if prv is not None and t + 1 < T:
                        ps, pv = prv
                        assert arrive_bwd[ps, t + 1] == -1, "bwd arrival clash"
                        arrive_bwd[ps, t + 1] = sched.slots[ps][pv][m]
    store_fwd = src_fwd = store_bwd = src_bwd = None
    if sched.has_comm:
        # Explicit comm lane: the wire payload still lands the tick after
        # its Send (the executor ppermutes once per tick edge), but it
        # parks into its residual slot only at its Recv tick — dwelling in
        # the in-flight comm buffer in between, so the transfer crosses
        # whole compute ticks the latency-hiding scheduler can overlap.
        store_fwd = np.full((PP, T), -1, np.int32)
        src_fwd = np.full((PP, T), -1, np.int32)
        store_bwd = np.full((PP, T), -1, np.int32)
        src_bwd = np.full((PP, T), -1, np.int32)
        for direction, (s, v, m), ts, tr in sched.comm_edges():
            if direction == "fwd":
                assert arrive_fwd[s, tr] == -1, "fwd arrival clash"
                arrive_fwd[s, tr] = sched.slots[s][v][m]
                arrive_fwd_mb[s, tr] = m
                if tr > ts + 1:
                    c = sched.cslots_fwd[s][v][m]
                    assert c >= 0, ("dwelling payload without a comm slot",
                                    s, v, m)
                    assert store_fwd[s, ts + 1] == -1, "comm store clash"
                    store_fwd[s, ts + 1] = c
                    src_fwd[s, tr] = c
            else:
                assert arrive_bwd[s, tr] == -1, "bwd arrival clash"
                arrive_bwd[s, tr] = sched.slots[s][v][m]
                if tr > ts + 1:
                    c = sched.cslots_bwd[s][v][m]
                    assert c >= 0, ("dwelling cotangent without a comm slot",
                                    s, v, m)
                    assert store_bwd[s, ts + 1] == -1, "comm store clash"
                    store_bwd[s, ts + 1] = c
                    src_bwd[s, tr] = c
    return TickTables(
        kind, mb, vs, slot, arrive_fwd, arrive_fwd_mb, arrive_bwd, wslot,
        store_fwd, src_fwd, store_bwd, src_bwd,
    )


def forward_tick_tables(PP: int, M: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """F-projection of the IR for the forward-only executor: masks/microbatch
    ids over the first ``M + PP - 1`` ticks (every flat schedule's F ops
    occupy the same warmup-free prefix; the IR is validated to agree).

    Returns (valid (PP, Tf) bool, mb (PP, Tf) int32, Tf).
    """
    sched = build("gpipe", PP, M)
    Tf = M + PP - 1
    valid = np.zeros((PP, Tf), bool)
    mb = np.zeros((PP, Tf), np.int32)
    for (s, _vs, m), t in sched.op_ticks("F").items():
        assert t < Tf and t == s + m, (
            "gpipe F-projection must be the canonical staircase"
        )
        valid[s, t] = True
        mb[s, t] = m
    return valid, mb, Tf


@dataclass(frozen=True)
class ForwardTables:
    """F-projection of a schedule for the forward-only executor: per-tick
    validity/microbatch/vstage tables over the compacted forward makespan
    (backward ticks removed, F ops re-list-scheduled under the same
    chunk-ring dependencies).  ``slot``/``arrive``/``num_slots`` give the
    input-parking geometry: the chunk ring's wrap edges mean an interior
    stage can receive several activations before consuming them (arrivals
    park in ``arrive[s, t]``; the op at (s, t) reads ``slot[s, t]``).
    V=1 compacts to the classic staircase with ``num_slots == 1``
    (every arrival is consumed the tick it lands)."""

    valid: np.ndarray  # (PP, Tf) bool
    mb: np.ndarray  # (PP, Tf) int32
    vs: np.ndarray  # (PP, Tf) int32
    slot: np.ndarray  # (PP, Tf) int32: input slot of the tick's op
    arrive: np.ndarray  # (PP, Tf) int32: slot of the arriving payload, -1
    num_slots: int
    Tf: int
    out_ticks: Tuple[int, ...]  # tick of F(PP-1, V-1, mb) for each mb


def forward_tick_tables_v(PP: int, M: int, V: int) -> ForwardTables:
    """Vstage F-projection of the interleaved IR (V=1: the flat staircase).

    Projects the F ops of ``build("interleaved_1f1b", PP, M, V)`` out of
    the full table and re-list-schedules them under the same chunk-ring
    dependencies — dropping the B-induced stalls, which is exactly what a
    forward-only (loss-eval) pipeline can do.  The compacted makespan is
    ``V*M + PP - 1`` chunk ticks: the same ``V*M`` work ticks as the flat
    table's ``M`` stage-fulls, but a fill staircase of ``PP - 1`` *chunk*
    ticks (each 1/V of a stage) instead of stage-fulls — the fill-bubble
    fraction drops from ``(PP-1)/(M+PP-1)`` to ``(PP-1)/(V·M+PP-1)``, the
    ROADMAP follow-up.

    Asserted against the IR trace: the per-stage F op order equals the
    full schedule's F order (the projection is faithful), every chunk-ring
    hand-off stays strictly later than its producer, and the compacted
    makespan never exceeds the full schedule's.
    """
    name = "interleaved_1f1b" if V > 1 else "gpipe"
    sched = build(name, PP, M, V)
    f_orders = [
        [op for op in sched.stage_order(s) if op[0] == "F"]
        for s in range(PP)
    ]
    placed = list_schedule(f_orders, t_fwd=1.0, t_bwd=1.0, V=V)
    Tf = int(max(end for _, _, _, end in placed))
    assert Tf <= sched.num_ticks, (Tf, sched.num_ticks)
    valid = np.zeros((PP, Tf), bool)
    mb = np.zeros((PP, Tf), np.int32)
    vs = np.zeros((PP, Tf), np.int32)
    f_tick: Dict[Tuple[int, int, int], int] = {}
    for s, op, start, _end in placed:
        t = int(start)
        assert t == start and not valid[s, t], (s, t)
        valid[s, t] = True
        mb[s, t] = op[1]
        vs[s, t] = op[2]
        f_tick[(s, op[2], op[1])] = t
    # Occupancy assertion against the IR trace: per-stage projected F order
    # == the schedule's F order, and hand-offs respect the chunk ring.
    for s in range(PP):
        proj = [
            (int(mb[s, t]), int(vs[s, t])) for t in range(Tf) if valid[s, t]
        ]
        want = [(op[1], op[2]) for op in f_orders[s]]
        assert proj == want, (s, proj, want)
        for vs_i in range(V):
            for m_i in range(M):
                prv = prev_chunk(s, vs_i, PP, V)
                if prv is not None:
                    assert (
                        f_tick[(s, vs_i, m_i)] > f_tick[prv + (m_i,)]
                    ), (s, vs_i, m_i)
    out_ticks = tuple(f_tick[(PP - 1, V - 1, m_i)] for m_i in range(M))

    # Input-parking geometry (greedy interval coloring, same scheme as
    # _assign_slots): a chunk input lives from its arrival (producer's F
    # tick + 1; own tick for the raw-input chunk) to its consumption.
    slot = np.zeros((PP, Tf), np.int32)
    arrive = np.full((PP, Tf), -1, np.int32)
    num_slots = 1
    for s in range(PP):
        res = []
        for vs_i in range(V):
            for m_i in range(M):
                prv = prev_chunk(s, vs_i, PP, V)
                use = f_tick[(s, vs_i, m_i)]
                alloc = use if prv is None else f_tick[prv + (m_i,)] + 1
                assert alloc <= use, (s, vs_i, m_i)
                res.append((alloc, use, (vs_i, m_i), prv is not None))
        free_at: List[int] = []
        for alloc, use, (vs_i, m_i), parked in sorted(res):
            for i, fa in enumerate(free_at):
                if fa <= alloc:
                    sl = i
                    free_at[i] = use + 1
                    break
            else:
                sl = len(free_at)
                free_at.append(use + 1)
            slot[s, f_tick[(s, vs_i, m_i)]] = sl
            if parked:
                assert arrive[s, alloc] == -1, "arrival clash"
                arrive[s, alloc] = sl
        num_slots = max(num_slots, len(free_at))
    return ForwardTables(
        valid=valid, mb=mb, vs=vs, slot=slot, arrive=arrive,
        num_slots=num_slots, Tf=Tf, out_ticks=out_ticks,
    )


def peak_activations_1f1b(PP: int) -> List[int]:
    """Paper Eq 4: stage i holds (PP - i) in-flight microbatches at peak."""
    return [PP - i for i in range(PP)]


def peak_wstash_zb_h1(PP: int, M: int) -> int:
    """Closed-form W-stash depth of the ZB-H1 builder: ``min(PP, M)``
    deferred weight grads — the greedy's ``PP - 1`` deferral ceiling plus
    the one Bw the final-drain Bi banks before the tail.  The pleasing
    symmetry with 1F1B's Eq-4 residual depth (also ``min(PP, M)``) is not
    an accident: the drain has ``PP - s`` stalls to fill on stage ``s``
    exactly where 1F1B holds ``PP - s`` residuals.  Pinned against the
    real IR's ``num_wslots`` by tests/test_schedule_invariants.py."""
    return min(PP, M)


def peak_activations_interleaved(PP: int, M: int, V: int) -> List[int]:
    """Eq-4 analogue for interleaved 1F1B: stage ``s`` peaks at
    ``2(PP-s-1) + (V-1)PP + 1`` in-flight CHUNK activations (each 1/V of a
    stage's layers), capped by the V*M total.  V=1 reduces to Eq 4."""
    if V == 1:
        return [min(PP - s, M) for s in range(PP)]
    return [
        min(2 * (PP - s - 1) + (V - 1) * PP + 1, V * M) for s in range(PP)
    ]
