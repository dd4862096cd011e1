"""Schedule-driven pipelined execution over ``torch.distributed`` ranks
(paper §III, Eq 3-5): the port of ``repro.core.pipeline``.

The layer stack is cut into ``PP * V`` chunks, chunk ``c = v * PP + s`` on
pipeline stage ``s`` as its virtual stage ``v`` (``convert.shard_params``
gives each rank its stage's chunks).  Each stage runs on the ranks of its
stage group; the rank at (s, d, e, t) hands its (b_l, s_l, d) block of
every microbatch to (s +- 1, d, e, t) over the pp group, so collectives
(the EP all-to-all, the MoE metric sums, the sequence gathers) stay inside
a stage and only point-to-point hand-offs cross the pod axis.  Microbatch
mb of the global batch is its rows ``[mb * b_mu, (mb + 1) * b_mu)``; each
rank of a stage holds ``b_l = b_mu / D`` of its rows and its sequence
slice of ``s_l = s / (ep * tp)`` positions (``training.shard_batch``, the
reference's ``P(dp, sp, None)`` activations).

Two executors interpret the schedule IR of ``core.schedules``:

* :func:`pipelined_stack_forward`, the differentiable forward: the IR's F
  projection (``forward_tick_tables_v``; the flat staircase at V = 1), the
  embedding inside stage 0.  Each tick boundary's hand-offs are one
  autograd node (:class:`_HandOff`) whose backward sends the cotangents
  the other way; the nodes of a rank are chained in tick order (the chain
  starting at a parameter), so the backward runs them all, in reverse tick
  order on every rank, which cannot deadlock.  Autograd through it is the GPipe-ordered backward: the
  oracle of the reference's tests, and ``LanguageModel.loss`` under a
  pipeline plan; without autograd, ``LanguageModel.forward`` under one.
* :func:`pipelined_step`, the schedule-executing train step: it interprets
  ``tick_tables(build(schedule, PP, M, V))`` tick by tick.  **F** runs the
  tick's chunk without autograd; its input stays parked in one of the
  IR's ``num_slots`` residual slots.  **B** recomputes the chunk from its
  slot and applies the cotangent, handed back by the next chunk or, on
  chunk (PP - 1, V - 1), seeded by the per-microbatch loss head
  (``1 / (b s)``, the global token count; ``1 / M`` for the aux and z
  losses), taking the
  gradients of the input, the chunk's parameters and the embedding.
  **Bi** takes the input gradient alone and parks (input, cotangent) in
  one of ``num_wslots`` W-stash slots; **Bw** drains one, recomputes the
  chunk and takes the parameter and embedding gradients.  Comm-lane
  schedules (``1f1b_overlap``) dwell their payloads in ``num_cslots_*``
  comm slots.  Gradients accumulate in fp32 in ascending microbatch
  order; aux, z and the expert loads on F ticks.  It returns the executed
  residual, W-stash and comm traces, which equal the IR's.

Unlike the reference, which runs one SPMD program on every stage and masks
the ops a stage was not assigned (a tick there costs a forward, a backward
and the loss head on every stage), a rank here runs the op the IR gives
it and nothing else, and sends a hand-off only where the IR has the
receiver take one: at the end of tick t, a stage sends what a neighbour
parks (``arrive_*``) or stores (``store_*``) at t + 1.  Both sides derive
that list from the same tables, and each tick boundary's sends and
receives are posted together (``dist.batch_isend_irecv``), so no order of
them can deadlock.  With ``MeshPlan.compress_p2p`` a hand-off is its int8
payload and fp32 block scales (``core.compression``), dequantised by the
receiver to the payload's dtype; the forward executor's backward sends the
cotangent compressed too (straight through the rounding).  gloo takes CPU
tensors for point-to-point: a CUDA payload is staged through the host.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import _unstage_chunks, stage_vstages
from repro_torch.core import compression
from repro_torch.core import schedules as sched_lib
from repro_torch.core.schedules import OP_B, OP_BI, OP_BW, OP_F
from repro_torch.models import transformer
from repro_torch.models.model import LanguageModel, map_tree, tree_paths

# Point-to-point tags: a tick boundary may carry a forward and a backward
# payload between the same two ranks (a two-stage ring), each with its
# scales when compressed.
_TAG = {("fwd", 0): 0, ("fwd", 1): 1, ("bwd", 0): 2, ("bwd", 1): 3}


def bubble_fraction(PP: int, M: int) -> float:
    """GPipe / 1F1B bubble: (PP-1)/(M+PP-1) of ticks are idle."""
    return (PP - 1) / (M + PP - 1)


def resolve_schedule(plan, schedule: Optional[str] = None,
                     vstages: Optional[int] = None) -> Tuple[str, int]:
    """(schedule, V) of a call: the plan's unless overridden; the plan's
    vstage depth belongs to its schedule, so a flat override runs at V = 1.
    The stage's weights are cut for the plan's V (``convert.shard_params``):
    an override to another depth is refused."""
    name = schedule or plan.schedule
    if vstages is not None:
        V = vstages
    else:
        V = plan.vstages if name == "interleaved_1f1b" else 1
    if V != stage_vstages(plan):
        raise ValueError(f"{name} at V={V}: this rank holds its stage's chunks for "
                         f"V={stage_vstages(plan)} (the plan's {plan.schedule!r})")
    return name, V


class Wire:
    """The hand-offs of one rank: point-to-point exchanges with its
    neighbours in the pp group, int8 with ``plan.compress_p2p``, staged
    through the host for gloo.  Counts what it sends (``sent``: hand-offs;
    ``sent_bytes``: bytes on the wire)."""

    def __init__(self, plan, dtype: torch.dtype, device: torch.device):
        self.plan, self.dtype, self.device = plan, dtype, device
        self.compress = plan.compress_p2p
        self.host = (device.type == "cuda"
                     and dist.get_backend(plan.pp_group or dist.group.WORLD) == "gloo")
        self.sent = 0
        self.sent_bytes = 0

    def _parts(self, t: torch.Tensor) -> List[torch.Tensor]:
        if not self.compress:
            return [t.to(self.dtype).contiguous()]
        q, scale = compression.quantize_int8(t)
        return [q, scale]

    def _empty(self, shape) -> List[torch.Tensor]:
        dev = "cpu" if self.host else self.device
        if not self.compress:
            return [torch.empty(shape, dtype=self.dtype, device=dev)]
        nb = -(-math.prod(shape) // compression.BLOCK)
        return [torch.empty(shape, dtype=torch.int8, device=dev),
                torch.empty((nb,), dtype=torch.float32, device=dev)]

    def exchange(self, sends, recvs) -> List[torch.Tensor]:
        """``sends``: [(direction, peer, tensor)]; ``recvs``: [(direction,
        peer, shape)].  Posts them all at once, waits, and returns the
        received payloads in ``recvs`` order (``self.dtype``, on the
        device)."""
        ops, bufs = [], []
        for direction, peer, t in sends:
            for i, part in enumerate(self._parts(t)):
                self.sent_bytes += part.numel() * part.element_size()
                ops.append(dist.P2POp(dist.isend, part.cpu() if self.host else part,
                                      self.plan.stage_peer(peer), tag=_TAG[direction, i]))
            self.sent += 1
        for direction, peer, shape in recvs:
            parts = self._empty(shape)
            for i, part in enumerate(parts):
                ops.append(dist.P2POp(dist.irecv, part, self.plan.stage_peer(peer),
                                      tag=_TAG[direction, i]))
            bufs.append(parts)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = []
        for parts in bufs:
            parts = [p.to(self.device) for p in parts]
            out.append(compression.dequantize_int8(parts[0], parts[1], dtype=self.dtype)
                       if self.compress else parts[0])
        return out


def _neighbours(PP: int, s: int, V: int) -> Tuple[Optional[int], Optional[int]]:
    """(previous, next) stage of ``s``: a line at V = 1, a ring above."""
    if V > 1:
        return (s - 1) % PP, (s + 1) % PP
    return (s - 1 if s > 0 else None), (s + 1 if s < PP - 1 else None)


# ---------------------------------------------------------------------------
# Forward executor (differentiable; IR F-projection)
# ---------------------------------------------------------------------------


class _HandOff(torch.autograd.Function):
    """One tick boundary's hand-offs of the forward executor.  Forward:
    send ``payloads`` (to ``sends``' peers) and receive the tensors of
    ``recvs``; returns (chain, *received).  Backward: the cotangent of
    each received tensor goes back to its sender while the cotangent of
    each sent payload comes back from its receiver, in one exchange.
    ``chain`` (an empty tensor) orders a rank's nodes: node k's output
    chain is node k + 1's input, and the rank's loss term adds the last,
    so the backward visits the nodes in reverse tick order."""

    @staticmethod
    def forward(ctx, wire, sends, recvs, chain, *payloads):
        ctx.wire, ctx.sends, ctx.recvs = wire, sends, recvs
        ctx.shapes = [p.shape for p in payloads]
        got = wire.exchange([(d, peer, p) for (d, peer), p in zip(sends, payloads)],
                            [(d, peer, shape) for d, peer, shape in recvs])
        return (chain.new_empty(0),) + tuple(got)

    @staticmethod
    def backward(ctx, _g_chain, *g_got):
        back = {"fwd": "bwd", "bwd": "fwd"}
        wire = ctx.wire
        g_sends = [(back[d], peer, g if g is not None
                    else torch.zeros(shape, dtype=wire.dtype, device=wire.device))
                   for (d, peer, shape), g in zip(ctx.recvs, g_got)]
        g_recvs = [(back[d], peer, shape) for (d, peer), shape in zip(ctx.sends, ctx.shapes)]
        g_payloads = wire.exchange(g_sends, g_recvs)
        return (None, None, None, torch.zeros(0, device=wire.device)) + tuple(g_payloads)


def pipelined_stack_forward(block_params, inputs: torch.Tensor, arch: ArchConfig, plan, *,
                            embed_fn: Optional[Callable], embed_params,
                            vstages: Optional[int] = None, train: bool = True,
                            telemetry=None):
    """The differentiable pipelined stack (module docstring) on this rank's
    block ``inputs`` of every microbatch: token ids (M * b_l, s_l) that stage 0
    embeds with ``embed_fn(embed_params, tokens)``, or, with ``embed_fn``
    None, precomputed (M * b_l, s, d) embeddings (a frontend's ``embeds``;
    the wire then carries their dtype, as the reference's), and its stage's chunks
    ``block_params`` (V * rpc, ...), each layer on its training path, or
    with ``train=False`` on its serving path (the flash-attention and
    expert kernels; ``LanguageModel.forward``, under ``torch.no_grad``).
    Returns (y, aux, z, loads): y (M * b_l,
    s, d), the model output, on the last stage and None elsewhere; aux and
    z this rank's terms of the losses' global values (the stage's F sums
    over ``M * stage_size``, so the terms of all ranks sum to them, with
    the hand-off chain folded in); loads the (reps, n_moe_positions, E)
    expert counts summed over microbatches, gathered over the pp group."""
    PP, s = plan.pp, plan.pp_rank
    _, V = resolve_schedule(plan, None, vstages)
    M = plan.num_microbatches
    n, S = inputs.shape[:2]
    if n % M:
        raise ValueError(f"{n} rows do not split into {M} microbatches")
    bl = n // M
    ft = sched_lib.forward_tick_tables_v(PP, M, V)
    rpc = transformer.num_reps(block_params) // V
    chunks = [_chunk(block_params, v, rpc) for v in range(V)]
    positions = LanguageModel._positions(bl, S, inputs.device, plan.seq_offset(S))
    prev, nxt = _neighbours(PP, s, V)
    act = _act_dtype(block_params) if embed_fn is not None else inputs.dtype
    wire = Wire(plan, act, inputs.device)
    d = arch.d_model
    slots: List[Optional[torch.Tensor]] = [None] * ft.num_slots
    # The chain starts as an empty view of the stage's smallest parameter,
    # so that every hand-off node lies on a path to the parameters: autograd
    # skips a node that leads to no input it was asked for, and a stage
    # that only receives would then never send its cotangents back.
    smallest = min((t for t in _leaves(block_params) if t.is_floating_point()),
                   key=lambda t: t.numel())
    chain = smallest.reshape(-1)[:0]
    aux = z = torch.zeros((), device=inputs.device)
    loads = None
    outs: Dict[int, torch.Tensor] = {}
    y_prev = None  # this rank's F output of the previous tick
    for t in range(ft.Tf):
        # 1. the boundary before tick t: this rank's sends and receives
        sends, payloads, recvs = [], [], []
        if t > 0 and nxt is not None and ft.arrive[nxt, t] >= 0:
            sends.append(("fwd", nxt))
            payloads.append(y_prev)
        if prev is not None and ft.arrive[s, t] >= 0:
            recvs.append(("fwd", prev, (bl, S, d)))
        if sends or recvs:
            chain, *got = _HandOff.apply(wire, sends, recvs, chain, *payloads)
            if recvs:
                slots[ft.arrive[s, t]] = got[0]
        # 2. the tick's F op
        y_prev = None
        if not ft.valid[s, t]:
            continue
        mb, v = int(ft.mb[s, t]), int(ft.vs[s, t])
        if s == 0 and v == 0:
            h = inputs[mb * bl:(mb + 1) * bl]
            if embed_fn is not None:
                h = embed_fn(embed_params, h)
        else:
            h, slots[ft.slot[s, t]] = slots[ft.slot[s, t]], None
        y, mets, ld = transformer.stack_forward(chunks[v], h, arch, positions=positions,
                                                train=train, plan=plan, telemetry=telemetry)
        aux = aux + mets["moe_aux_loss"]
        z = z + mets["moe_z_loss"]
        if ld is not None:
            if loads is None:
                loads = ld.new_zeros((V * rpc,) + ld.shape[1:])
            loads[v * rpc:(v + 1) * rpc] += ld.detach()
        if s == PP - 1 and v == V - 1:
            outs[mb] = y
        y_prev = y
    G = plan.stage_size
    y = torch.cat([outs[m] for m in range(M)]) if outs else None
    aux = aux / (M * G) + chain.sum()
    z = z / (M * G)
    if loads is not None:
        loads = _unstage_chunks(loads, plan)
    return y, aux, z, loads


def _chunk(block_params, v: int, rpc: int):
    """Virtual stage v's reps ``[v * rpc, (v + 1) * rpc)`` of a stage's
    (V * rpc, ...) block tree, as views."""
    sl = slice(v * rpc, (v + 1) * rpc)
    return map_tree(lambda t: t[sl], block_params)


def _leaves(tree) -> List[torch.Tensor]:
    return list(tree_paths(tree).values())


def _act_dtype(block_params) -> torch.dtype:
    for t in _leaves(block_params):
        if t.is_floating_point():
            return t.dtype
    raise ValueError("no floating block parameter")


# ---------------------------------------------------------------------------
# Schedule-executing train step
# ---------------------------------------------------------------------------


def _grad_leaf(t: torch.Tensor, want: bool) -> torch.Tensor:
    return t.detach().requires_grad_(want) if t.is_floating_point() else t


def pipelined_step(block_params, inputs: torch.Tensor, labels: torch.Tensor,
                   arch: ArchConfig, plan, *, head_fn: Callable, head_params,
                   embed_fn: Optional[Callable], embed_params,
                   schedule: Optional[str] = None, vstages: Optional[int] = None,
                   telemetry=None):
    """Execute one training step's forward and backward under a schedule
    IR (module docstring) on this rank's rows ``inputs``/``labels`` (M *
    b_l, s) and its stage's chunks ``block_params`` (V * rpc, ...).

    ``head_fn(head_params, embed, y, labels)`` is the per-microbatch CE
    sum; ``embed_fn(embed, tokens)`` the stage-0 embedding of token ids
    ``inputs``, or None when ``inputs`` are precomputed (M * b_l, s, d)
    embeddings (the wire and buffers then in their dtype, and the
    embedding's gradient comes from a tied head alone).  Returns
    (terms, grads, traces, stats): ``terms`` this rank's (ce sum, aux, z)
    before any reduction (aux and z the stage's sums over its F ops, their
    backward seeded with ``1 / (M * stage_size)``), ``grads`` {"blocks":
    fp32 in ``block_params``' layout (None for integer tables), "embed",
    "head"} this rank's partial sums, ``traces`` the executed (T,)
    residual, W-stash and comm in-flight counts of this stage, and
    ``stats`` {"loads" (V * rpc, n_moe_positions, E) or None, "sent",
    "sent_bytes", "slot_bytes", "schedule"}.  The caller reduces them
    (``LanguageModel.loss_and_grads``)."""
    PP, s = plan.pp, plan.pp_rank
    name, V = resolve_schedule(plan, schedule, vstages)
    M = plan.num_microbatches
    n, S = inputs.shape[:2]
    if n % M:
        raise ValueError(f"{n} rows do not split into {M} microbatches")
    bl = n // M
    G = plan.stage_size
    b = n * G  # the global batch
    with (telemetry.span("pipeline.build_schedule", schedule=name, PP=PP, M=M, V=V)
          if telemetry is not None else contextlib.nullcontext()):
        sched = sched_lib.build(name, PP, M, V)
        tt = sched_lib.tick_tables(sched)
    if telemetry is not None:
        telemetry.instant("pipeline.schedule", schedule=name, PP=PP, M=M, V=V,
                          num_ticks=sched.num_ticks, slots=sched.num_slots,
                          wslots=sched.num_wslots,
                          cslots=sched.num_cslots_fwd + sched.num_cslots_bwd)
    T = sched.num_ticks
    has_comm = sched.has_comm
    dev = inputs.device
    rpc = transformer.num_reps(block_params) // V
    chunks = [_chunk(block_params, v, rpc) for v in range(V)]
    positions = LanguageModel._positions(bl, S, dev, plan.seq_offset(S))
    prev, nxt = _neighbours(PP, s, V)
    act = _act_dtype(block_params) if embed_fn is not None else inputs.dtype
    wire = Wire(plan, act, dev)
    d = arch.d_model
    inv_m = 1.0 / (M * G)

    def wire_fwd(st: int, t: int) -> bool:
        """Stage ``st`` takes a forward payload off the wire at tick t."""
        if has_comm and tt.store_fwd[st, t] >= 0:
            return True
        return tt.arrive_fwd[st, t] >= 0 and not (has_comm and tt.src_fwd[st, t] >= 0)

    def wire_bwd(st: int, t: int) -> bool:
        if has_comm and tt.store_bwd[st, t] >= 0:
            return True
        return tt.arrive_bwd[st, t] >= 0 and not (has_comm and tt.src_bwd[st, t] >= 0)

    in_buf: List[Optional[torch.Tensor]] = [None] * sched.num_slots
    cot_buf: List[Optional[torch.Tensor]] = [None] * sched.num_slots
    wstash: List[Optional[Tuple]] = [None] * sched.num_wslots
    cbuf_f: List[Optional[torch.Tensor]] = [None] * sched.num_cslots_fwd
    cbuf_b: List[Optional[torch.Tensor]] = [None] * sched.num_cslots_bwd

    gacc = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
            for t in _leaves(block_params) if t.is_floating_point()]
    gemb = torch.zeros(embed_params.shape, dtype=torch.float32, device=dev)
    ghead = map_tree(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=dev),
                     head_params)
    ce = torch.zeros((), dtype=torch.float32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    loads = None
    live = live_w = live_c = 0
    occ = torch.zeros(T, dtype=torch.int32)
    wocc = torch.zeros(T, dtype=torch.int32)
    cocc = torch.zeros(T, dtype=torch.int32)

    def first(v: int) -> bool:
        return s == 0 and v == 0

    def rows(x, mb):
        return x[mb * bl:(mb + 1) * bl]

    def run(v: int, mb: int, h_in, *, want_input: bool, want_params: bool):
        """Chunk v on microbatch mb: (y, aux, z, loads, input leaf, param
        leaves, embed leaf), with autograd on what is wanted."""
        chunk = map_tree(lambda t: _grad_leaf(t, want_params), chunks[v])
        emb = None
        if first(v) and embed_fn is None:
            inp = rows(inputs, mb)
        elif first(v):
            emb = _grad_leaf(embed_params, want_params)
            inp = embed_fn(emb, rows(inputs, mb))
        else:
            inp = h_in.detach().requires_grad_(want_input)
        y, mets, ld = transformer.stack_forward(chunk, inp, arch, positions=positions,
                                                train=True, plan=plan, telemetry=telemetry)
        return y, mets["moe_aux_loss"], mets["moe_z_loss"], ld, inp, chunk, emb

    def accumulate(v: int, g_params) -> None:
        for acc, g in zip(gacc, g_params):
            if g is not None:
                acc[v * rpc:(v + 1) * rpc] += g.float()

    def pullback(v, mb, h_in, y_cot, *, want_input: bool, want_params: bool,
                 with_head: bool):
        """Recompute chunk v and apply its output cotangent (or, with
        ``with_head``, the loss head's seed); accumulate the parameter and
        embedding gradients when ``want_params``.  Returns (input
        gradient or None, the output cotangent applied)."""
        nonlocal ce
        y_cot_in = y_cot
        with torch.enable_grad():
            y, a, zz, _, inp, chunk, emb = run(v, mb, h_in, want_input=want_input,
                                               want_params=want_params)
            if with_head:
                yd = y.detach().requires_grad_(True)
                hp = map_tree(lambda t: t.detach().requires_grad_(True), head_params)
                he = embed_params.detach().requires_grad_(True)  # the tied head's
                ce_mb = head_fn(hp, he, yd, rows(labels, mb))
                h_leaves = _leaves(hp)
                gs = torch.autograd.grad(ce_mb, h_leaves + [he, yd], grad_outputs=torch.tensor(
                    1.0 / (b * S), device=dev), allow_unused=True)
                for acc, g in zip(_leaves(ghead), gs[:len(h_leaves)]):
                    if g is not None:
                        acc += g.float()
                if gs[len(h_leaves)] is not None:
                    gemb.add_(gs[len(h_leaves)].float())
                y_cot_in = gs[-1].to(act)
                ce = ce + ce_mb.detach().float()
            outs, gouts = [y], [y_cot_in]
            for val in (a, zz):
                if val.requires_grad:
                    outs.append(val)
                    gouts.append(torch.tensor(inv_m, dtype=val.dtype, device=dev))
            p_leaves = [l for l in _leaves(chunk) if l.is_floating_point()] if want_params else []
            wrt = ([inp] if want_input and not first(v) else []) + p_leaves + (
                [emb] if want_params and emb is not None else [])
            gs = torch.autograd.grad(outs, wrt, grad_outputs=gouts, allow_unused=True)
        k = 1 if want_input and not first(v) else 0
        if want_params:
            accumulate(v, gs[k:k + len(p_leaves)])
            if emb is not None and gs[-1] is not None:
                gemb.add_(gs[-1].float())
        return (gs[0] if k else None), y_cot_in

    pending_h = pending_g = None  # this rank's F output / input grad of the last tick
    for t in range(T):
        # -- the boundary before tick t: sends of tick t-1's results and
        #    the payloads this stage takes off the wire at t
        if t > 0:
            sends, recvs = [], []
            if nxt is not None and wire_fwd(nxt, t):
                sends.append(("fwd", nxt, pending_h))
            if prev is not None and wire_bwd(prev, t):
                sends.append(("bwd", prev, pending_g))
            if prev is not None and wire_fwd(s, t):
                recvs.append(("fwd", prev, (bl, S, d)))
            if nxt is not None and wire_bwd(s, t):
                recvs.append(("bwd", nxt, (bl, S, d)))
            if any(p is None for _, _, p in sends):
                raise AssertionError(f"stage {s} tick {t}: the IR hands off a payload "
                                     f"this stage did not produce")
            got = iter(wire.exchange(sends, recvs))
            recv_h = next(got) if prev is not None and wire_fwd(s, t) else None
            recv_g = next(got) if nxt is not None and wire_bwd(s, t) else None
        else:
            recv_h = recv_g = None
        pending_h = pending_g = None
        # -- 1. park arrivals (a comm slot's consume is read before its store)
        pay_h, pay_g = recv_h, recv_g
        if has_comm:
            src_f, st_f = int(tt.src_fwd[s, t]), int(tt.store_fwd[s, t])
            if src_f >= 0:
                pay_h, cbuf_f[src_f] = cbuf_f[src_f], None
            if st_f >= 0:
                cbuf_f[st_f] = recv_h
            src_b, st_b = int(tt.src_bwd[s, t]), int(tt.store_bwd[s, t])
            if src_b >= 0:
                pay_g, cbuf_b[src_b] = cbuf_b[src_b], None
            if st_b >= 0:
                cbuf_b[st_b] = recv_g
            live_c += (st_f >= 0) + (st_b >= 0) - (src_f >= 0) - (src_b >= 0)
        if tt.arrive_fwd[s, t] >= 0:
            in_buf[tt.arrive_fwd[s, t]] = pay_h
        if tt.arrive_bwd[s, t] >= 0:
            cot_buf[tt.arrive_bwd[s, t]] = pay_g
        # -- 2. the tick's op
        kind = int(tt.kind[s, t])
        mb, v, slot = int(tt.mb[s, t]), int(tt.vs[s, t]), int(tt.slot[s, t])
        last = s == PP - 1 and v == V - 1
        if kind == OP_F:
            with torch.no_grad():
                y, a, zz, ld, *_ = run(v, mb, in_buf[slot], want_input=False,
                                       want_params=False)
            aux = aux + a.float()
            z = z + zz.float()
            if ld is not None:
                if loads is None:
                    loads = ld.new_zeros((V * rpc,) + ld.shape[1:])
                loads[v * rpc:(v + 1) * rpc] += ld
            pending_h = y.to(act)
            live += 1
        elif kind in (OP_B, OP_BI):
            h_in = in_buf[slot]
            fused = kind == OP_B
            if kind == OP_BI and first(v):
                # Nothing upstream takes this input gradient: park only.
                y_cot = cot_buf[slot]
                if last:
                    raise AssertionError("a one-chunk pipeline has no Bi")
            else:
                g_h, y_cot = pullback(v, mb, h_in, cot_buf[slot], want_input=not first(v),
                                      want_params=fused, with_head=last)
                if g_h is not None:
                    pending_g = g_h.to(act)
            if kind == OP_BI:
                wstash[int(tt.wslot[s, t])] = (h_in, y_cot)
                live_w += 1
            in_buf[slot] = cot_buf[slot] = None
            live -= 1
        elif kind == OP_BW:
            w = int(tt.wslot[s, t])
            (h_in, y_cot), wstash[w] = wstash[w], None
            pullback(v, mb, h_in, y_cot, want_input=False, want_params=True,
                     with_head=False)
            live_w -= 1
        occ[t], wocc[t], cocc[t] = live, live_w, live_c
    g_blocks = iter(gacc)
    grads_blocks = map_tree(lambda t: next(g_blocks) if t.is_floating_point() else None,
                            block_params)
    stats = {"loads": loads, "sent": wire.sent, "sent_bytes": wire.sent_bytes,
             "slot_bytes": sched.num_slots * bl * S * d * torch.finfo(act).bits // 8,
             "schedule": sched}
    return ((ce, aux, z), {"blocks": grads_blocks, "embed": gemb, "head": ghead},
            (occ, wocc, cocc), stats)
