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

At EP = 1 it is :func:`moe_ffn_local`, the collective-free math.  The
router's gradient flows through the stable-sort top-k and the combine
weights; the scatters, gathers and all-to-alls are differentiable.  The
reference's hot-expert replicas are not ported (ROADMAP Queue 1 item 2b).
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


def _moe_ragged_sharded(xt, top_phys, top_w, w_up, w_gate, w_down,
                        activation: str, moe: MoECfg, plan, capacity: int,
                        telemetry=None):
    """Dropless-style EP dispatch: sorted rows as the all-to-all payload,
    their segment structure carried by a counts exchange up front.

    Rows are sorted by global expert id (experts contiguous per rank) and
    packed into a per-destination budget of S = E_l*C rows, the capacity
    wire size, each row's position ranked among the rows for its
    destination; rows past S are dropped (``keep_s``).  A tiny (ep, E_l)
    int32 all-to-all ships the kept rows per (destination, local expert),
    from which each receiver rebuilds its rows' expert ids (sentinel E_l on
    the empty tail), re-sorts each chunk by them and runs the ragged FFN
    over the occupied rows only."""
    T, d = xt.shape
    k, E, ep = moe.top_k, moe.num_experts, plan.ep
    E_l = E // ep
    flat_e = top_phys.reshape(-1)
    flat_w = top_w.reshape(-1)
    Tk = flat_e.shape[0]
    order, inv, _ = _sort_dispatch(flat_e, E)
    sorted_e = flat_e[order]
    xs = xt[torch.div(order, k, rounding_mode="floor")]  # (Tk, d) expert-sorted
    S = E_l * capacity
    dest = torch.div(sorted_e, E_l, rounding_mode="floor")  # nondecreasing
    dcounts = _counts(dest, ep)
    pos = torch.arange(Tk, device=xt.device) - (dcounts.cumsum(0) - dcounts)[dest]
    keep_s = pos < S  # rank-budget overflow (sorted order)
    posd = torch.where(keep_s, pos, S)  # the extra slot S is cut off below
    send_x = xs.new_zeros((ep * (S + 1), d)).index_copy(0, dest * (S + 1) + posd, xs)
    send_x = send_x.reshape(ep, S + 1, d)[:, :S]
    lid = sorted_e - dest * E_l
    send_counts = torch.zeros((ep, E_l), dtype=torch.int32, device=xt.device)
    send_counts.index_put_((dest, lid), keep_s.to(torch.int32), accumulate=True)
    xfer = _select_a2a(plan)
    with _a2a_span(telemetry, plan, part="ragged", rows=S, d=d):
        # Counts exchange (one for all chunks): receiver-side segment
        # structure, so each chunk's expert ids are known before its rows.
        recv_counts = _select_a2a(plan, counts=True)(send_counts)
        # Source chunk i is [c_i0 rows of expert 0, c_i1 of expert 1, ...,
        # sentinel padding] by construction; rebuilt without a host sync.
        reps = torch.cat([recv_counts, S - recv_counts.sum(1, keepdim=True)], 1)
        ids = torch.arange(E_l + 1, device=xt.device).repeat(ep)
        recv_id = torch.repeat_interleave(ids, reps.reshape(-1).long(),
                                          output_size=ep * S).reshape(ep, S)

        def compute(recv, start, size):
            # Per-chunk re-sort: each row's output depends only on its own
            # value and expert, so chunking is exact.
            order_c, offsets_c = _ragged_rows(
                recv_id[:, start:start + size].reshape(-1), E_l)
            ys = moe_ops.ragged_ffn(recv.reshape(ep * size, d)[order_c], w_up, w_gate,
                                    w_down, offsets_c, activation)
            return _unsort(ys, order_c).reshape(ep, size, d)

        outs = halo.overlapped_a2a(
            xfer, lambda start, size: send_x[:, start:start + size], compute,
            halo.chunk_slices(S, plan.a2a_chunks), wire=WIRE_DTYPE)
    y_buf = torch.cat(outs, dim=1)  # (ep, S, d)
    vals = torch.where(keep_s[:, None], y_buf[dest, posd.clamp(max=S - 1)], 0.0)
    return _combine_expert_outputs(vals[inv], flat_w, keep_s[inv], T, k, d)


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


def _moe_ragged_decode(xt, top_phys, top_w, w_up, w_gate, w_down,
                       activation: str, moe: MoECfg, plan):
    """Ragged weight-parallel decode: tokens are replicated over the EP
    group; each rank sorts them by LOCAL expert id (other ranks' rows get
    the sentinel E_l and sort to the never-computed tail), runs the ragged
    FFN over its own experts' rows, and the partial outputs are summed over
    the EP group (each row has exactly one owner)."""
    T, d = xt.shape
    k, E = moe.top_k, moe.num_experts
    E_l = E // plan.ep
    flat_e = top_phys.reshape(-1)
    lid = flat_e - plan.ep_rank * E_l
    lid = torch.where((lid >= 0) & (lid < E_l), lid, E_l)
    order, offsets = _ragged_rows(lid, E_l)
    xs = xt[torch.div(order, k, rounding_mode="floor")]
    ys = moe_ops.ragged_ffn(xs, w_up, w_gate, w_down, offsets, activation)
    vals = sharding.all_reduce(_unsort(ys, order), plan.ep_group)
    keep = torch.ones_like(flat_e, dtype=torch.bool)  # dropless
    return _combine_expert_outputs(vals, top_w.reshape(-1), keep, T, k, d)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, arch: ArchConfig,
            plan: Optional["sharding.MeshPlan"], *, token_sharded: bool = True,
            train: bool = False, seq_shard: bool = False, telemetry=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE sub-layer on this rank's block of a ``plan`` (None: one rank).

    ``params`` hold this rank's expert slots (``convert.shard_params``): the
    expert leaves are (E_l, ...), the router and the routing table whole.
    ``token_sharded`` (train, prefill): x is this rank's own tokens,
    dispatched through the EP all-to-all; the metrics are meaned over the
    world.  With ``seq_shard`` x is replicated over the EP group and the
    layer takes this rank's sequence shard of it and all-gathers the output
    back (the reference's ``P(dp, ("ep", "tp"), None)``).  Otherwise
    (decode) x is replicated over the EP group, each rank computes its own
    experts and the outputs are summed over the group; the metrics are
    meaned over the data group.  ``train``: see :func:`moe_ffn_local`.
    ``telemetry`` (an ``obs.Telemetry``, or None) gets an ``a2a.layer``
    span around each token-sharded dispatch/combine."""
    if plan is None or plan.world == 1:
        return moe_ffn_local(params, x, arch, train=train)
    metric_group = plan.world_group if token_sharded else plan.dp_group
    if plan.ep == 1:
        return moe_ffn_local(params, x, arch, train=train, metric_group=metric_group)
    if token_sharded and seq_shard:
        s = x.shape[1]
        if s % plan.ep:
            raise ValueError(f"sequence {s} does not split over ep={plan.ep} ranks")
        sl = s // plan.ep
        y, metrics = moe_ffn(params, x[:, plan.ep_rank * sl:(plan.ep_rank + 1) * sl],
                             arch, plan, train=train, telemetry=telemetry)
        parts = [torch.empty_like(y) for _ in range(plan.ep)]
        torch.distributed.all_gather(parts, y.contiguous(), group=plan.ep_group)
        return torch.cat(parts, dim=1), metrics
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
    if moe.dispatch == "ragged":
        if token_sharded:
            y = _moe_ragged_sharded(xt, top_phys, top_w, w_up, w_gate, w_down, act,
                                    moe, plan, capacity, telemetry)
        else:
            y = _moe_ragged_decode(xt, top_phys, top_w, w_up, w_gate, w_down, act,
                                   moe, plan)
    else:
        E = moe.num_experts
        flat_e, pos, keep, flat_w = _dispatch_indices(top_phys, top_w, E, capacity)
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
        y = _combine_expert_outputs(vals, flat_w, keep, T, moe.top_k, d)
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z, "expert_load": counts}
    return y.reshape(b, s, d), metrics
