"""Mixture-of-Experts FFN, on one rank and across expert-parallel ranks.

The port of ``repro.models.moe``: top-k routing, the load-balancing and
router z-losses, and the two dispatch modes (``MoECfg.dispatch``):

* **capacity** (GShard/Tutel): (E, C, d) zero-padded buffers with
  C = ceil(T*k/E * cf); (token, k) pairs past an expert's C slots, counted
  in flat (token, k) order, are dropped.  The expert FFN is three grouped
  GEMM launches (``kernels.moe_gemm.grouped_ffn``) when serving; training
  runs :func:`_expert_ffn` instead (see there).
* **ragged** (MegaBlocks-style, dropless): a stable argsort of the flat
  expert ids gives contiguous per-expert row segments; the fused ragged
  gate-up-SiLU kernel and one ragged down-projection run over exactly the
  occupied rows (``kernels.moe_gemm.ragged_ffn``, differentiable: its
  backward is ragged kernels too); the inverse permutation brings the rows
  back for the weighted combine.

:func:`moe_ffn` runs them across the ranks of a ``sharding.MeshPlan``
(expert-data parallelism: every rank routes its own tokens, EP rank g holds
the physical expert slots ``[g*E_l, (g+1)*E_l)``):

* token-sharded (train, prefill): dispatch -> expert FFN -> combine through
  the EP all-to-all (flat or HALO, ``core.halo``), software-pipelined over
  ``plan.a2a_chunks`` row chunks, the payload in bf16 both ways; ragged
  ships sorted rows at the capacity wire size with a counts exchange up
  front (:func:`_moe_ragged_sharded`), capacity the (ep, E_l, C, d) buffer
  (:func:`_moe_capacity_sharded`);
* weight-parallel decode (replicated tokens): each rank computes its own
  experts' rows and the partial outputs are summed over the EP group.

With a live ``replicas`` table (``MoECfg.max_replicas`` channels, the
migration planner's hot experts) the rows routed to a replicated expert
leave the all-to-all and compute on their source rank
(:func:`_replica_ffn`): the channel's weights are an owner-masked select
from the owner's shard summed over the EP group (:func:`_replica_weights`;
its backward sums every rank's replica gradient back into the owner's
slot), and in decode each replica row is computed by one rank in
round-robin order and the results summed.  The replica rows drop out of
the dispatch (ragged: off the wire, positions ranked among the other rows;
capacity: out of the buffers, their slots still consumed) and rejoin its
rows before the one weighted combine, so the layer's function is
unchanged and the combine rounds as the sentinel-table layer's does (the
reference sums two combines).

At EP = 1 it is :func:`moe_ffn_local`, the collective-free math, which
ignores the replica table as the reference does.  The router's gradient
flows through the stable-sort top-k and the combine weights; the
scatters, gathers and all-to-alls are differentiable.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.core import halo
from repro_torch.kernels.moe_gemm import ops as moe_ops


def _route(x_tokens: torch.Tensor, w_router: torch.Tensor, moe: MoECfg):
    """Top-k routing. x_tokens: (T, d) -> (weights (T,k), ids (T,k), probs,
    logits), all in fp32."""
    logits = x_tokens.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    # A stable descending sort breaks ties toward the lower expert id, as
    # lax.top_k does (torch.topk leaves tie order unspecified); ties are
    # real: a token row of zeros gives uniform probabilities.
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :moe.top_k], top_i[:, :moe.top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_i, probs, logits


def _aux_losses(probs, logits, top_i, moe: MoECfg, group=None):
    """Switch-style load-balancing aux loss + router z-loss, meaned over the
    tokens of every rank of ``group`` (None: this rank's); returns (aux, z,
    per-expert assignment counts), all global over the group.  Every rank
    of the group holds the same number of tokens."""
    T = probs.shape[0]
    E = moe.num_experts
    counts = _counts(top_i.reshape(-1), E).float()
    probs_sum = probs.sum(0)
    z_sum = torch.logsumexp(logits, dim=-1).square().sum()
    if group is not None:
        # One differentiable sum for the three (the counts carry no grad).
        red = sharding.all_reduce(torch.cat([counts, probs_sum, z_sum[None]]), group)
        counts, probs_sum, z_sum = red[:E].detach(), red[E:2 * E], red[2 * E]
        T = T * sharding.group_size(group)
    frac_tokens = counts / (T * moe.top_k)
    frac_probs = probs_sum / T
    aux = E * (frac_tokens * frac_probs).sum() * moe.aux_loss_coef
    z = z_sum / T * moe.z_loss_coef
    return aux, z, counts


def _counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Occurrences of each id in [0, E); unlike ``torch.bincount`` it needs
    no host sync on the card."""
    return torch.zeros(E, dtype=torch.long, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def _capacity(T: int, moe: MoECfg) -> int:
    """Per-rank expert slot budget C = ceil(T*k/E * cf)."""
    return int(math.ceil(T * moe.top_k / moe.num_experts * moe.capacity_factor))


def _dispatch_indices(top_i, top_w, E: int, capacity: int):
    """Slot of each (token, k) pair in its expert's buffer, by a running
    count in flat (token, k) order.  Returns (flat_e, pos, keep, flat_w)."""
    flat_e = top_i.reshape(-1)
    flat_w = top_w.reshape(-1)
    one_hot = flat_e[:, None] == torch.arange(E, device=flat_e.device)
    pos_all = one_hot.long().cumsum(dim=0) - 1  # (T*k, E)
    pos = pos_all.gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    pos = torch.where(keep, pos, 0)
    return flat_e, pos, keep, flat_w


def _scatter_to_buffers(xt, flat_e, pos, keep, E: int, capacity: int):
    """Token rows -> (E, C, d) capacity buffers (overflow contributes 0)."""
    src = xt.repeat_interleave(flat_e.shape[0] // xt.shape[0], dim=0)
    buf = xt.new_zeros((E, capacity, xt.shape[-1]))
    return buf.index_put_((flat_e, pos), src * keep[:, None].to(xt.dtype),
                          accumulate=True)


def _combine_expert_outputs(vals, flat_w, keep, T: int, k: int, d: int):
    """Weighted top-k combine of gathered expert outputs back to tokens."""
    vals = vals * (flat_w * keep.float())[:, None].to(vals.dtype)
    return vals.reshape(T, k, d).sum(dim=1)


def _merge_replica_rows(vals, keep, rep):
    """The replica path's rows put into the dispatch's (their supports are
    disjoint: (rep_row, vals_rep) = ``rep``, None for none), so one combine
    sums each token's k rows in (token, k) order as the sentinel-table
    layer does: the replica path adds no rounding of its own."""
    if rep is None:
        return vals, keep
    rep_row, vals_rep = rep
    return torch.where(rep_row[:, None], vals_rep.to(vals.dtype), vals), keep | rep_row


def _token_rows(xt: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """The (token, k) rows of ``xt`` in ``order`` (a permutation of T*k):
    xt repeated k times in flat (token, k) order, then permuted.  Its
    backward sums a token's k row gradients in (token, k) order whatever
    ``order`` is, so relabelling the expert slots (a migration) leaves the
    bits of dx alone; a gather by ``order // k`` sums them in ``order``."""
    return xt.repeat_interleave(k, dim=0)[order]


def _expert_ffn(tokens, w_up, w_gate, w_down, activation: str):
    """Capacity expert FFN for training, the twin of the JAX package's
    ``_expert_ffn``: plain products in fp32 on the (bf16-valued) operands,
    TF32 off (``device.resolve_device``), only the down-projection's result
    cast back.  The reference computes it outside any Pallas kernel because
    ``grouped_matmul_f32`` has no gradient there, so it is a plain product
    here too.  tokens: (E, C, d)."""
    f32 = torch.float32
    t = tokens.to(f32)
    if activation == "swiglu":
        h = F.silu(torch.bmm(t, w_gate.to(f32))) * torch.bmm(t, w_up.to(f32))
    else:
        h = F.gelu(torch.bmm(t, w_up.to(f32)), approximate="tanh")
    return torch.bmm(h, w_down.to(f32)).to(tokens.dtype)


def _sort_dispatch(flat_e: torch.Tensor, E: int):
    """Stable argsort of the flat expert ids into contiguous per-expert
    segments (ties keep token order).  Returns (order, inv, offsets (E+1,)
    int32)."""
    order = torch.argsort(flat_e, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    counts = _counts(flat_e, E)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return order, inv, offsets


def _moe_ragged_local(xt, top_phys, top_w, w_up, w_gate, w_down,
                      activation: str, E: int, k: int):
    """Dropless single-rank MoE: sort -> ragged FFN -> inverse permutation
    -> weighted combine over every (token, k) pair."""
    T, d = xt.shape
    flat_e = top_phys.reshape(-1)
    order, inv, offsets = _sort_dispatch(flat_e, E)
    xs = xt[torch.div(order, k, rounding_mode="floor")]  # (T*k, d) sorted
    ys = moe_ops.ragged_ffn(xs, w_up, w_gate, w_down, offsets, activation)
    keep = torch.ones_like(flat_e, dtype=torch.bool)
    return _combine_expert_outputs(ys[inv], top_w.reshape(-1), keep, T, k, d)


def moe_ffn_local(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  arch: ArchConfig, *, train: bool = False, metric_group=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Collective-free single-rank MoE sub-layer. x: (b, s, d) -> (y,
    {"moe_aux_loss", "moe_z_loss", "expert_load"}).  ``train`` selects the
    capacity path's differentiable :func:`_expert_ffn`; the ragged path is
    the same in both.  ``metric_group``: the ranks the metrics are meaned
    over (data parallelism at EP = 1; None: this rank)."""
    moe = arch.moe
    E = moe.num_experts
    b, s, d = x.shape
    T = b * s
    xt = x.reshape(T, d)
    top_w, top_i, probs, logits = _route(xt, params["w_router"], moe)
    aux, z, counts = _aux_losses(probs, logits, top_i, moe, metric_group)
    # Metrics use logical expert ids; dispatch uses physical slots through
    # the migration routing table.
    top_phys = params["assignment"].long()[top_i]
    wg = params.get("w_gate")
    if moe.dispatch == "ragged":
        y = _moe_ragged_local(xt, top_phys, top_w, params["w_up"], wg,
                              params["w_down"], arch.ffn_activation, E, moe.top_k)
    else:
        capacity = _capacity(T, moe)
        flat_e, pos, keep, flat_w = _dispatch_indices(top_phys, top_w, E, capacity)
        buf = _scatter_to_buffers(xt, flat_e, pos, keep, E, capacity)
        ffn = _expert_ffn if train else moe_ops.grouped_ffn
        y_buf = ffn(buf, params["w_up"], wg, params["w_down"], arch.ffn_activation)
        y = _combine_expert_outputs(y_buf[flat_e, pos], flat_w, keep, T,
                                    moe.top_k, d)
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z, "expert_load": counts}
    return y.reshape(b, s, d), metrics


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

# The dispatch/combine payload crosses the wire in bf16 both ways (the
# reference's ``_transport_bf16``): ``halo.issue`` casts before the
# all-to-all, and the cast's backward casts the cotangent before its
# all-to-all, so the backward's payload is bf16 too.
WIRE_DTYPE = torch.bfloat16


def _select_a2a(plan, *, counts: bool = False) -> halo.Transfer:
    """The ONE place the EP collectives are selected: the dispatch/combine
    transport (flat vs HALO, ``plan.hierarchical_a2a``) of both dispatch
    modes, and with ``counts`` the ragged path's counts exchange, which is
    always flat (one tiny (ep, E_l) transfer)."""
    return halo.Transfer(plan, halo=False) if counts else halo.Transfer(plan)


def _a2a_span(telemetry, plan, **attrs):
    """An ``a2a.layer`` span on ``telemetry`` (an ``obs.Telemetry``; the
    drift report's ``a2a`` phase), or nothing when it is None."""
    if telemetry is None:
        return contextlib.nullcontext()
    return telemetry.span("a2a.layer", ep=plan.ep, algo=plan.a2a_algo,
                          chunks=plan.a2a_chunks, **attrs)


def _ragged_rows(ids: torch.Tensor, n: int):
    """Stable sort of ``ids`` in [0, n] (n = the sentinel, sorted to the
    never-computed tail); returns (order, offsets (n+1,) int32 over ids
    < n)."""
    order = torch.argsort(ids, stable=True)
    counts = _counts(ids, n + 1)
    offsets = torch.cat([counts.new_zeros(1), counts[:n].cumsum(0)]).to(torch.int32)
    return order, offsets


def _unsort(ys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows back to their pre-sort places: out[order[i]] = ys[i]."""
    return ys.new_zeros(ys.shape).index_copy(0, order, ys)


def _ragged_send(flat_e: torch.Tensor, E: int, ep: int, S: int, rep=None):
    """The send side of :func:`_moe_ragged_sharded`'s layout: the (T*k,)
    expert ids sorted by global expert (experts contiguous per rank), each
    row's destination rank ``dest`` and its position ``posd`` ranked among
    the rows for that destination (S, the cut-off extra slot, for a row past
    the budget or a replica row: ``keep_s`` False), and the kept rows per
    (destination, local expert) as ``send_counts`` (ep, E/ep) int32.
    Returns (order, inv, dest, posd, keep_s, send_counts)."""
    Tk, E_l = flat_e.shape[0], E // ep
    order, inv, _ = _sort_dispatch(flat_e, E)
    sorted_e = flat_e[order]
    dest = torch.div(sorted_e, E_l, rounding_mode="floor")  # nondecreasing
    if rep is None:
        dcounts = _counts(dest, ep)
        pos = torch.arange(Tk, device=flat_e.device) - (dcounts.cumsum(0) - dcounts)[dest]
        keep_s = pos < S  # rank-budget overflow (sorted order)
    else:
        valid = ~rep[0][order]
        vi = valid.long()
        dcounts = torch.zeros(ep, dtype=torch.long, device=flat_e.device).index_add_(
            0, dest, vi)
        pos = vi.cumsum(0) - 1 - (dcounts.cumsum(0) - dcounts)[dest]
        keep_s = valid & (pos < S)
    posd = torch.where(keep_s, pos, S)
    lid = sorted_e - dest * E_l
    send_counts = torch.zeros((ep, E_l), dtype=torch.int32, device=flat_e.device)
    send_counts.index_put_((dest, lid), keep_s.to(torch.int32), accumulate=True)
    return order, inv, dest, posd, keep_s, send_counts


def _payload_ids(send_counts: torch.Tensor, S: int, exchange) -> torch.Tensor:
    """The receiver's (ep, S) local expert id of every slot of the payload:
    the counts exchange (``exchange``, one for all chunks) gives each
    source's rows per local expert, and source chunk i is [c_i0 rows of
    expert 0, c_i1 of expert 1, ..., sentinel E_l padding] by construction,
    so the ids are rebuilt without a host sync."""
    recv_counts = exchange(send_counts)
    ep, E_l = recv_counts.shape
    reps = torch.cat([recv_counts, S - recv_counts.sum(1, keepdim=True)], 1)
    ids = torch.arange(E_l + 1, device=send_counts.device).repeat(ep)
    return torch.repeat_interleave(ids, reps.reshape(-1).long(),
                                   output_size=ep * S).reshape(ep, S)


def _chunk_rows(recv_id: torch.Tensor, start: int, size: int, E_l: int):
    """:func:`_ragged_rows` of the payload's slots [start, start + size) of
    every source, in (source, slot) order."""
    return _ragged_rows(recv_id[:, start:start + size].reshape(-1), E_l)


def _moe_ragged_sharded(xt, top_phys, top_w, w_up, w_gate, w_down,
                        activation: str, moe: MoECfg, plan, capacity: int,
                        telemetry=None, rep=None):
    """Dropless-style EP dispatch: sorted rows as the all-to-all payload,
    their segment structure carried by a counts exchange up front.

    Rows are sorted by global expert id (experts contiguous per rank) and
    packed into a per-destination budget of S = E_l*C rows, the capacity
    wire size, each row's position ranked among the rows for its
    destination; rows past S are dropped (``keep_s``).  A tiny (ep, E_l)
    int32 all-to-all ships the kept rows per (destination, local expert),
    from which each receiver rebuilds its rows' expert ids (sentinel E_l on
    the empty tail), re-sorts each chunk by them and runs the ragged FFN
    over the occupied rows only.  ``rep`` (:func:`_merge_replica_rows`):
    the replica rows leave the wire, and positions are ranked among the
    other rows only, so each destination's rows stay contiguous."""
    T, d = xt.shape
    k, E, ep = moe.top_k, moe.num_experts, plan.ep
    E_l = E // ep
    flat_e = top_phys.reshape(-1)
    flat_w = top_w.reshape(-1)
    S = E_l * capacity
    order, inv, dest, posd, keep_s, send_counts = _ragged_send(flat_e, E, ep, S, rep)
    xs = _token_rows(xt, order, k)  # (Tk, d) expert-sorted
    send_x = xs.new_zeros((ep * (S + 1), d)).index_copy(0, dest * (S + 1) + posd, xs)
    send_x = send_x.reshape(ep, S + 1, d)[:, :S]
    xfer = _select_a2a(plan)
    with _a2a_span(telemetry, plan, part="ragged", rows=S, d=d):
        recv_id = _payload_ids(send_counts, S, _select_a2a(plan, counts=True))

        def compute(recv, start, size):
            # Per-chunk re-sort: each row's output depends only on its own
            # value and expert, so chunking is exact.
            order_c, offsets_c = _chunk_rows(recv_id, start, size, E_l)
            ys = moe_ops.ragged_ffn(recv.reshape(ep * size, d)[order_c], w_up, w_gate,
                                    w_down, offsets_c, activation)
            return _unsort(ys, order_c).reshape(ep, size, d)

        outs = halo.overlapped_a2a(
            xfer, lambda start, size: send_x[:, start:start + size], compute,
            halo.chunk_slices(S, plan.a2a_chunks), wire=WIRE_DTYPE)
    y_buf = torch.cat(outs, dim=1)  # (ep, S, d)
    vals = torch.where(keep_s[:, None], y_buf[dest, posd.clamp(max=S - 1)], 0.0)
    vals, keep = _merge_replica_rows(vals[inv], keep_s[inv], rep)
    return _combine_expert_outputs(vals, flat_w, keep, T, k, d)


def _moe_capacity_sharded(buf, w_up, w_gate, w_down, activation: str, ffn,
                          plan, capacity: int, telemetry=None):
    """Capacity-mode EP dispatch -> grouped FFN -> combine of the (E, C, d)
    buffer, chunked along C: every chunk is a valid per-expert slot range,
    so per-row results equal the monolithic transfer's."""
    E, _, d = buf.shape
    ep = plan.ep
    E_l = E // ep
    bufe = buf.reshape(ep, E_l, capacity, d)

    def get_chunk(start, size):
        return bufe[:, :, start:start + size].reshape(ep, E_l * size, d)

    def compute(recv, start, size):
        # recv[(i, e, c)] = source i's slot chunk for my expert e.
        expert_in = recv.reshape(ep, E_l, size, d).transpose(0, 1).reshape(
            E_l, ep * size, d)
        out = ffn(expert_in, w_up, w_gate, w_down, activation)
        return out.reshape(E_l, ep, size, d).transpose(0, 1).reshape(ep, E_l * size, d)

    slices = halo.chunk_slices(capacity, plan.a2a_chunks)
    with _a2a_span(telemetry, plan, part="capacity", rows=E_l * capacity, d=d):
        outs = halo.overlapped_a2a(_select_a2a(plan), get_chunk, compute, slices,
                                   wire=WIRE_DTYPE)
    y = torch.cat([o.reshape(ep, E_l, sz, d) for o, (_, sz) in zip(outs, slices)], dim=2)
    return y.reshape(E, capacity, d)


def _decode_rows(flat_e: torch.Tensor, E_l: int, ep_rank: int, rep=None):
    """:func:`_ragged_rows` of the (T*k,) expert ids by this rank's LOCAL
    expert id: other ranks' rows, and with ``rep`` the replica rows, get
    the sentinel E_l."""
    lid = flat_e - ep_rank * E_l
    local = (lid >= 0) & (lid < E_l)
    if rep is not None:
        local = local & ~rep[0]
    return _ragged_rows(torch.where(local, lid, E_l), E_l)


def _moe_ragged_decode(xt, top_phys, top_w, w_up, w_gate, w_down,
                       activation: str, moe: MoECfg, plan, rep=None):
    """Ragged weight-parallel decode: tokens are replicated over the EP
    group; each rank sorts them by LOCAL expert id (other ranks' rows get
    the sentinel E_l and sort to the never-computed tail), runs the ragged
    FFN over its own experts' rows, and the partial outputs are summed over
    the EP group (each row has exactly one owner).  ``rep``
    (:func:`_merge_replica_rows`): rows the replica path computes instead."""
    T, d = xt.shape
    k, E = moe.top_k, moe.num_experts
    E_l = E // plan.ep
    flat_e = top_phys.reshape(-1)
    order, offsets = _decode_rows(flat_e, E_l, plan.ep_rank, rep)
    xs = xt[torch.div(order, k, rounding_mode="floor")]
    ys = moe_ops.ragged_ffn(xs, w_up, w_gate, w_down, offsets, activation)
    vals = sharding.all_reduce(_unsort(ys, order), plan.ep_group)
    keep = torch.ones_like(flat_e, dtype=torch.bool)  # dropless
    vals, keep = _merge_replica_rows(vals, keep, rep)
    return _combine_expert_outputs(vals, top_w.reshape(-1), keep, T, k, d)


def _replica_rows(top_i: torch.Tensor, replicas: torch.Tensor, E: int):
    """Per flat (token, k) row: routed-to-a-replica mask and its replica
    channel (sentinel R for the other rows).  replicas: (R,) logical
    expert ids, sentinel E = free channel."""
    R = replicas.shape[0]
    rep = replicas.long()
    # Size-(E + 1) tables, so the sentinel E lands on a discarded entry.
    is_rep = torch.zeros(E + 1, dtype=torch.bool, device=rep.device)
    is_rep[rep] = True
    chan = torch.full((E + 1,), R, dtype=torch.long, device=rep.device)
    chan[rep] = torch.arange(R, device=rep.device)
    flat_i = top_i.reshape(-1)
    rep_row = is_rep[:E][flat_i]
    return rep_row, torch.where(rep_row, chan[:E][flat_i], R)


def _replica_weights(replicas, assignment, w_up, w_gate, w_down, E: int, plan):
    """The R replica channels' weights on every rank of the EP group: each
    active channel's expert lives in one rank's shard (its home slot under
    ``assignment``); an owner-masked select summed over the EP group
    broadcasts it.  The sum's backward sums every rank's replica-weight
    gradient, and the select puts it on the owner's slot, so replica
    gradients land in the one logical leaf."""
    E_l = w_up.shape[0]
    active = replicas < E
    slot = assignment.long()[replicas.long().clamp(0, E - 1)]
    owner = torch.div(slot, E_l, rounding_mode="floor")
    lrow = slot - owner * E_l
    mine = (active & (owner == plan.ep_rank))[:, None, None]

    def bcast(w):
        if w is None:
            return None
        sel = w[lrow]
        return sharding.all_reduce(torch.where(mine, sel, torch.zeros_like(sel)),
                                   plan.ep_group)

    return bcast(w_up), bcast(w_gate), bcast(w_down)


def _replica_ffn(xt, rchan, k: int, w_up, w_gate, w_down, R: int, activation: str,
                 wire: bool):
    """Ragged FFN over the (token, k) rows routed to replica channels (R
    "experts"); the other rows carry the sentinel R, sort to the
    never-computed tail and come back 0.  ``wire`` repeats the all-to-all's
    bf16 round trip of the payload both ways (token-sharded paths), so a
    replica row gets the value the wire would have given it.  Returns (T*k,
    d), zero in the other rows."""
    order, offsets = _ragged_rows(rchan, R)
    xs = _token_rows(xt, order, k)
    if wire:
        xs = xs.to(WIRE_DTYPE).to(xt.dtype)
    ys = moe_ops.ragged_ffn(xs, w_up, w_gate, w_down, offsets, activation)
    if wire:
        ys = ys.to(WIRE_DTYPE).to(xt.dtype)
    return _unsort(ys, order)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, arch: ArchConfig,
            plan: Optional["sharding.MeshPlan"], *, token_sharded: bool = True,
            train: bool = False, seq_shard: bool = False, data_split: bool = True,
            telemetry=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE sub-layer on this rank's block of a ``plan`` (None: one rank).

    ``params`` hold this rank's expert slots (``convert.shard_params``): the
    expert leaves are (E_l, ...), the router and the routing table whole.
    Under the plan's d_ff split they hold this rank's d_ff slice, gathered
    here in x's dtype before any path (``sharding.gather_ffn``): the
    replica path, the dispatch and the decode all see whole experts.
    ``token_sharded`` (train, the dense-cache prefill, whose block a
    rank holds as in training): x is this rank's own tokens,
    dispatched through its EP group's all-to-all; the metrics are meaned
    over the stage group (the world without a pipeline).  With
    ``seq_shard`` (the paged prefill) x is replicated over the EP group (and over data and the
    tp lanes, each lane computing the same) and the layer takes this rank's
    sequence shard of it and all-gathers the output back over the EP group
    (the reference's ``P(dp, ("ep", "tp"), None)``, its sequence split over
    ep alone); the metrics are meaned over the EP group.  Otherwise (decode)
    x is replicated over the EP group and the tp lanes, each rank computes
    its own experts and the outputs are summed over the EP group, never
    over tp; the metrics are meaned over the data group when
    ``data_split`` (x is this data rank's share of the batch), else not
    (x is the whole batch on every rank).  ``train``: see
    :func:`moe_ffn_local`.  ``telemetry`` (an ``obs.Telemetry``, or None)
    gets an ``a2a.layer`` span around each token-sharded dispatch/combine."""
    if plan is None or plan.world == 1:
        return moe_ffn_local(params, x, arch, train=train)
    params = sharding.gather_ffn(params, plan, x.dtype)
    if params["w_up"].shape[-1] != arch.moe.d_ff:
        raise ValueError(f"expert leaves hold d_ff {params['w_up'].shape[-1]} after the "
                         f"plan's {plan.ffn_split}-way gather, the arch {arch.moe.d_ff} "
                         f"(convert.shard_params)")
    if token_sharded and seq_shard:
        metric_group = plan.ep_group
    elif token_sharded:
        metric_group = plan.stage_group
    else:
        metric_group = plan.dp_group if data_split else None
    if plan.ep == 1:
        return moe_ffn_local(params, x, arch, train=train, metric_group=metric_group)
    if token_sharded and seq_shard:
        s = x.shape[1]
        if s % plan.ep:
            raise ValueError(f"sequence {s} does not split over ep={plan.ep} ranks")
        sl = s // plan.ep
        y, metrics = _moe_ffn_ranks(params, x[:, plan.ep_rank * sl:(plan.ep_rank + 1) * sl],
                                    arch, plan, True, train, metric_group, telemetry)
        parts = [torch.empty_like(y) for _ in range(plan.ep)]
        torch.distributed.all_gather(parts, y.contiguous(), group=plan.ep_group)
        return torch.cat(parts, dim=1), metrics
    return _moe_ffn_ranks(params, x, arch, plan, token_sharded, train, metric_group,
                          telemetry)


def _moe_ffn_ranks(params, x, arch: ArchConfig, plan, token_sharded: bool, train: bool,
                   metric_group, telemetry):
    """:func:`moe_ffn` at EP > 1 on this rank's x, the metrics meaned over
    ``metric_group``."""
    moe = arch.moe
    E_l = moe.num_experts // plan.ep
    b, s, d = x.shape
    T = b * s
    xt = x.reshape(T, d)
    top_w, top_i, probs, logits = _route(xt, params["w_router"], moe)
    aux, z, counts = _aux_losses(probs, logits, top_i, moe, metric_group)
    top_phys = params["assignment"].long()[top_i]
    w_up, w_gate, w_down = params["w_up"], params.get("w_gate"), params["w_down"]
    if w_up.shape[0] != E_l:
        raise ValueError(f"expert leaves hold {w_up.shape[0]} experts, this rank's "
                         f"shard is {E_l} (convert.shard_params)")
    act = arch.ffn_activation
    capacity = _capacity(T, moe)
    E, k = moe.num_experts, moe.top_k
    # Hot-expert replicas: their rows leave the dispatch and compute on
    # this rank, and rejoin the dispatch's rows before the combine.
    replicas = params.get("replicas")
    rep = None
    if replicas is not None and replicas.shape[0] > 0:
        R = replicas.shape[0]
        rep_row, rchan = _replica_rows(top_i, replicas, E)
        wr = _replica_weights(replicas, params["assignment"], w_up, w_gate, w_down, E, plan)
        if not token_sharded:
            # Decode: the tokens are on every rank, so each replica row is
            # computed by one of them (round robin) and the results summed.
            own = torch.arange(rchan.shape[0], device=rchan.device) % plan.ep == plan.ep_rank
            rchan = torch.where(own, rchan, R)
        vals_rep = _replica_ffn(xt, rchan, k, *wr, R, act, wire=token_sharded)
        if not token_sharded:
            vals_rep = sharding.all_reduce(vals_rep, plan.ep_group)
        rep = (rep_row, vals_rep)
    if moe.dispatch == "ragged":
        if token_sharded:
            y = _moe_ragged_sharded(xt, top_phys, top_w, w_up, w_gate, w_down, act,
                                    moe, plan, capacity, telemetry, rep=rep)
        else:
            y = _moe_ragged_decode(xt, top_phys, top_w, w_up, w_gate, w_down, act,
                                   moe, plan, rep=rep)
    else:
        flat_e, pos, keep, flat_w = _dispatch_indices(top_phys, top_w, E, capacity)
        if rep is not None:
            keep = keep & ~rep[0]  # out of the buffers; the slots stay consumed
        buf = _scatter_to_buffers(xt, flat_e, pos, keep, E, capacity)
        ffn = _expert_ffn if train else moe_ops.grouped_ffn
        if token_sharded:
            y_buf = _moe_capacity_sharded(buf, w_up, w_gate, w_down, act, ffn, plan,
                                          capacity, telemetry)
            vals = y_buf[flat_e, pos]
        else:
            # Decode: this rank's expert slice, the partial outputs summed.
            g = plan.ep_rank
            out = ffn(buf[g * E_l:(g + 1) * E_l], w_up, w_gate, w_down, act)
            y_local = torch.cat([out.new_zeros((g * E_l,) + out.shape[1:]), out,
                                 out.new_zeros((E - (g + 1) * E_l,) + out.shape[1:])])
            vals = sharding.all_reduce(y_local[flat_e, pos], plan.ep_group)
        vals, keep = _merge_replica_rows(vals, keep, rep)
        y = _combine_expert_outputs(vals, flat_w, keep, T, k, d)
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z, "expert_load": counts}
    return y.reshape(b, s, d), metrics
