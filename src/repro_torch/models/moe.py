"""Mixture-of-Experts FFN on one rank (expert parallelism = 1).

The port of the single-rank math of ``repro.models.moe``: top-k routing,
the load-balancing and router z-losses, and the two dispatch modes
(``MoECfg.dispatch``):

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

The router's gradient flows through the stable-sort top-k and the combine
weights; the capacity scatter (``index_put_`` accumulate) and the gathers
are differentiable as they are.

At EP = 1 the reference's sharded ``moe_ffn`` reduces to this math in both
prefill and decode, so :func:`moe_ffn_local` serves both.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoECfg
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


def _aux_losses(probs, logits, top_i, moe: MoECfg):
    """Switch-style load-balancing aux loss + router z-loss over this
    rank's tokens; returns (aux, z, per-expert assignment counts)."""
    T = probs.shape[0]
    E = moe.num_experts
    counts = _counts(top_i.reshape(-1), E).float()
    frac_tokens = counts / (T * moe.top_k)
    frac_probs = probs.sum(0) / T
    aux = E * (frac_tokens * frac_probs).sum() * moe.aux_loss_coef
    z = torch.logsumexp(logits, dim=-1).square().sum() / T * moe.z_loss_coef
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
                  arch: ArchConfig, *, train: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Collective-free single-rank MoE sub-layer. x: (b, s, d) -> (y,
    {"moe_aux_loss", "moe_z_loss", "expert_load"}).  ``train`` selects the
    capacity path's differentiable :func:`_expert_ffn`; the ragged path is
    the same in both."""
    moe = arch.moe
    E = moe.num_experts
    b, s, d = x.shape
    T = b * s
    xt = x.reshape(T, d)
    top_w, top_i, probs, logits = _route(xt, params["w_router"], moe)
    aux, z, counts = _aux_losses(probs, logits, top_i, moe)
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
