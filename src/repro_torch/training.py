"""Train state, the train step and the dense-cache serving steps (the
port of ``repro.training``).

The step differentiates ``LanguageModel.loss`` with autograd: the fp32
master weights are cast to the compute dtype inside the graph, so autograd
carries the gradients back to fp32 through the casts; the AdamW update then
runs in place (``optim.adamw_update``).  Over the ranks of the model's
``sharding.MeshPlan`` each rank takes its block of the global batch (its
rows over data, its sequence slice over (ep, tp): :func:`shard_batch`),
differentiates its term of the global loss, and sums the gradients: a
sliced leaf's in its gather's backward (``sharding.gather_leaf``,
``sharding.gather_ffn``), the whole ones over the world, the whole-slot
expert ones over the expert-gradient group (the data ranks and tp lanes
that hold the same expert slots).  Under a pipeline plan
the step is the schedule-executing one (``LanguageModel.loss_and_grads``,
``core.pipeline``): each rank takes its block of every microbatch, and the
block gradients are summed over the rank's stage (``sharding
.reduce_grads_``).
``make_prefill_step`` / ``make_decode_step`` cast every floating leaf to
the compute dtype and run ``LanguageModel.prefill`` / ``decode_step``
without autograd, on the global batch: the prefill's block a rank as in
training, the decode's rows over data, the cache's positions over (ep,
tp) (the reference's "kv_seq" rule).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.device import resolve_device
from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
from repro_torch.optim.optimizer import (
    OptimizerConfig, adamw_init, adamw_update, global_norm, lr_schedule,
)


def init_state(lm: LanguageModel, generator: torch.Generator, device=None):
    """{"params": fp32 masters, "m", "v": moments in the plan's
    ``optimizer_dtype`` (fp32 without a plan), "step": 0-d int32 on the
    CPU}, the params drawn from ``generator`` on ``device`` (default
    ``cuda``)."""
    params = init_params(lm.arch, generator, resolve_device(device), torch.float32)
    odt = "float32" if lm.plan is None else lm.plan.optimizer_dtype
    return {"params": params, **adamw_init(params, odt)}


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A host batch array (or a tensor) on ``device``; from the host through
    pinned memory on the card, so the copy is queued behind the previous
    step's work instead of waiting for it."""
    t = torch.as_tensor(a)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _cast(params, dtype: torch.dtype, keep=()):
    """Every floating leaf in ``dtype`` (a leaf already in it is not
    copied) but those at the paths ``keep``: the leaves the plan slices,
    which a layer casts as it gathers them, so that their gradients are
    summed in fp32 (``sharding.sliced_paths``)."""
    return map_tree(lambda path, p: p.to(dtype) if p.is_floating_point() and path not in keep
                    else p, params, with_path=True)


def make_prefill_step(lm: LanguageModel, compute_dtype: torch.dtype = torch.bfloat16):
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    ``batch["tokens"]`` is a host (numpy) or torch (b, l) array, the global
    batch: over several ranks each takes its block (:func:`shard_batch`,
    the reference's prefill ``batch_specs``) and returns the whole batch's
    logits and its block of the cache (``LanguageModel.prefill``)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if lm.world > 1:
            batch = shard_batch(batch, lm.plan)
        device = params["embed"].device
        batch = {k: _to_device(v, device) for k, v in batch.items()}
        return lm.prefill(_cast(params, compute_dtype), batch)

    return prefill_step


def make_decode_step(lm: LanguageModel, compute_dtype: torch.dtype = torch.bfloat16):
    """``decode_step(params, cache, batch, index) -> (logits, cache)``, the
    cache updated in place; ``batch`` is the global (b, 1) batch, of which
    each rank decodes its rows over data where D divides b (the
    reference's decode ``batch_specs``, ``("batch", None)``) against its
    block of the cache, every rank returning the whole batch's logits
    (``LanguageModel.decode_step``)."""
    @torch.no_grad()
    def decode_step(params, cache, batch, index):
        device = params["embed"].device
        batch = {k: _to_device(v, device) for k, v in batch.items()}
        return lm.decode_step(_cast(params, compute_dtype), cache, batch, index)

    return decode_step


def batch_block(plan, b: int, s: int):
    """(rows, positions) of this rank's block of a (b, s) batch under
    ``plan`` (:func:`shard_batch`): ``b / D`` rows (``b_mu / D`` of each of
    the M microbatches under a pipeline) and ``s / (ep * tp)`` positions.
    A grid that does not divide them is refused with a ValueError, as the
    reference's ``P(dp, ("ep", "tp"))`` of ``moe_ffn`` refuses it."""
    D, n = plan.dp, plan.seq_size
    dp = " x ".join(plan.dp_axes)
    if s % n:
        raise ValueError(f"sequence {s} does not split over ep x tp = {n} ranks (the "
                         f"reference's \"seq\" rule: s % (ep * tp) != 0)")
    if plan.pp > 1:
        M = plan.num_microbatches
        if b % (M * D):
            raise ValueError(f"batch {b} does not split into {M} microbatches over "
                             f"{dp} = {D} ranks (b % (M * D) != 0)")
        return b // (M * D), s // n
    if b % D:
        raise ValueError(f"batch {b} does not split over {dp} = {D} ranks (the "
                         f"reference's \"batch\" rule: b % D != 0)")
    return b // D, s // n


def describe_block(plan, b: int, s: int) -> str:
    """This rank's block of a (b, s) batch in words: its rows (of each
    microbatch under a pipeline), its positions and its token count."""
    bl, sl = batch_block(plan, b, s)
    d, off = plan.coords[0], plan.seq_offset(sl)
    mb = f" of each of {plan.num_microbatches} microbatches" if plan.pp > 1 else ""
    n = bl * sl * (plan.num_microbatches if plan.pp > 1 else 1)
    return (f"rows [{d * bl}, {(d + 1) * bl}){mb} x positions [{off}, {off + sl}): "
            f"{n} tokens")


def shard_batch(batch, plan):
    """This rank's block of a global batch, the reference's ``batch_specs``
    layout: rows over the data axes (``plan.dp_axes``; the pod joins data
    without a pipeline), the sequence over (ep, tp) (the "seq" rule).  The
    rank at (d, e, t) takes rows ``[d * b_l, (d + 1) * b_l)``, ``b_l = b /
    D``, and positions ``[j * s_l, (j + 1) * s_l)``, ``j = e * tp + t``
    and ``s_l = s / (ep * tp)``.  Under a pipeline microbatch mb is rows
    ``[mb * b_mu, (mb + 1) * b_mu)`` (the reference's ``x.reshape(M, b_mu,
    ...)``), and the rank takes ``b_l = b_mu / D`` of its rows, ``[mb *
    b_mu + d * b_l, mb * b_mu + (d + 1) * b_l)``, and the same sequence
    slice, in microbatch order.  Every leaf (``tokens``, ``labels``,
    ``embeds``) splits alike; the labels are shifted in the data, so none
    crosses a slice.  A grid that does not divide the batch or the
    sequence is refused (:func:`batch_block`)."""
    d = plan.coords[0]
    out = {}
    for k, v in batch.items():
        b, s = v.shape[:2]
        bl, sl = batch_block(plan, b, s)
        cols = slice(plan.seq_offset(sl), plan.seq_offset(sl) + sl)
        if plan.pp > 1:
            b_mu = b // plan.num_microbatches
            rows = [v[mb * b_mu + d * bl:mb * b_mu + (d + 1) * bl, cols]
                    for mb in range(plan.num_microbatches)]
            out[k] = (torch.cat(rows) if isinstance(v, torch.Tensor)
                      else np.concatenate(rows))
        else:
            out[k] = v[d * bl:(d + 1) * bl, cols]
    return out


def loss_and_grads(lm: LanguageModel, params, batch,
                   compute_dtype: torch.dtype = torch.bfloat16, *, autograd: bool = False):
    """Differentiate ``lm.loss`` at ``params`` (this rank's shard) on
    ``batch`` (the global batch; device tensors or host arrays).  Returns
    (loss, metrics, grads) with detached metrics and ``grads`` in the
    params' tree (None for integer tables).  Over several ranks each takes
    its block (:func:`shard_batch`), and the gradients are summed in place
    into the global ones (``sharding.reduce_grads_``), the loss and "ce"
    terms likewise.  Under a pipeline plan it is the schedule-executing
    ``lm.loss_and_grads`` (its traces not gathered), unless ``autograd``:
    then autograd through the pipelined forward, the GPipe-ordered oracle
    (its "moe_aux_loss" and "moe_z_loss" terms summed too)."""
    plan = lm.plan if lm.world > 1 else None
    if plan is not None:
        batch = shard_batch(batch, plan)
    device = params["embed"].device
    batch = {k: _to_device(v, device) for k, v in batch.items()}
    keep = sharding.sliced_paths(tree_paths(params), plan)
    if lm.pipelined and not autograd:
        loss, grads, metrics = lm.loss_and_grads(_cast(params, compute_dtype, keep), batch,
                                                 gather_traces=False)
        for k in ("pipeline_occupancy", "pipeline_wstash_occupancy",
                  "pipeline_comm_inflight", "pipeline_stats"):
            metrics.pop(k)
        return loss, metrics, grads
    leaves = [p for p in tree_paths(params).values() if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = lm.loss(_cast(params, compute_dtype, keep), batch)
        # A pipeline stage uses only some leaves (the head on the last);
        # precomputed embeds leave an untied table unused (its gradient 0).
        flat_grads = iter(torch.autograd.grad(
            loss, leaves, allow_unused=lm.pipelined or lm._has_embeds(batch)))
    finally:
        for p in leaves:
            p.requires_grad_(False)

    def grad_of(p):
        if not p.is_floating_point():
            return None
        g = next(flat_grads)
        return torch.zeros_like(p) if g is None else g

    grads = map_tree(grad_of, params)
    loss = loss.detach()
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    if plan is not None:
        sharding.reduce_grads_(grads, plan)
        keys = ["loss", "ce"] + (["moe_aux_loss", "moe_z_loss"] if lm.pipelined else [])
        terms = sharding.all_reduce_(torch.stack([metrics[k] for k in keys]),
                                     plan.world_group)
        metrics.update(zip(keys, terms))
        loss = metrics["loss"]
    return loss, metrics, grads


def _squares(flat, keys) -> torch.Tensor:
    """The summed squares of the leaves ``keys`` (0 for none), in fp32."""
    if not keys:
        return torch.zeros((), dtype=torch.float32, device=next(iter(flat.values())).device)
    return torch.stack([torch.linalg.vector_norm(flat[k], dtype=torch.float32)
                        for k in keys]).square().sum()


def _sliced_squares(flat, keys, plan) -> torch.Tensor:
    """The summed squares of the sliced leaves ``keys``: each gather
    group's leaves' squares summed over that group, whose ranks hold their
    slices.  Every rank that holds the same slices sums the same values in
    the same order, so every rank gets the same bits."""
    total = _squares(flat, [])
    by_group = {}
    for k in sorted(keys):
        by_group.setdefault(sharding.zero_groups(plan, plan.layout[k])[0], []).append(k)
    for group, ks in by_group.items():
        total = total + sharding.all_reduce_(
            torch.stack([_squares(flat, [k]) for k in ks]), group).sum()
    return total


def _global_norm(grads, plan, params):
    """The global grad norm of reduced gradients: the whole leaves' squares
    once; a sliced leaf's squares summed over its gather group
    (:func:`_sliced_squares`); the expert leaves' as one sum of squares per
    expert slot, all-gathered over the EP group and added up in LOGICAL
    expert order (through the params' ``assignment``), so that an expert
    migration, which only relabels slots, leaves the norm's bits (and so
    the clip) unchanged.  Under a pipeline plan the block leaves' squares
    (a stage's chunks) are added over the pp group.  Every tp lane holds
    the same whole gradients and gathers over its own groups in the same
    order, so every rank computes the same bits and clips alike.  Under the
    d_ff split a slot's sum of squares is first summed over the
    expert-gradient group, whose ranks hold its slices.  The sliced leaves'
    sums are rounded in another order than a whole-leaf run's: the norm
    may differ from it by ulps."""
    flat = {k: g for k, g in tree_paths(grads).items() if g is not None}
    experts = sorted(sharding.expert_paths(flat))
    sliced = [k for k in flat if k in plan.layout]
    dense = [k for k in flat if k not in experts and k not in plan.layout]
    if plan.pp > 1:  # a stage's chunks here, the embedding and head on every stage
        rest = (_squares(flat, [k for k in dense if not k.startswith("blocks/")])
                + _sliced_squares(flat, [k for k in sliced if not k.startswith("blocks/")],
                                  plan))
        dense = [k for k in dense if k.startswith("blocks/")]
        sliced = [k for k in sliced if k.startswith("blocks/")]
    total = _squares(flat, dense) + _sliced_squares(flat, sliced, plan)
    if experts:
        slots = torch.stack([flat[k].float().square().sum(
            dim=tuple(range(2, flat[k].dim()))) for k in experts])  # (leaves, reps, E_l)
        if plan.ffn_split > 1:
            sharding.all_reduce_(slots, plan.expert_dp_group)
        parts = [slots]
        if plan.ep > 1:
            parts = [torch.empty_like(slots) for _ in range(plan.ep)]
            torch.distributed.all_gather(parts, slots, group=plan.ep_group)
        tables = tree_paths(params)
        assign = torch.stack([tables[k.rpartition("/")[0] + "/assignment"].long()
                              for k in experts])  # (leaves, reps, E)
        total = total + torch.cat(parts, dim=2).gather(2, assign).sum()
    if plan.pp > 1:
        total = sharding.all_reduce_(total.clone(), plan.pp_group) + rest
    return total.sqrt()


def _host(t: torch.Tensor):
    """A tensor on the host: a Python number for one element, else numpy."""
    return t.item() if t.numel() == 1 else t.detach().cpu().numpy()


def make_train_step(lm: LanguageModel, opt_cfg: OptimizerConfig,
                    gnorm_skip_cap: Optional[float] = None, *,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    fetch: Callable[[torch.Tensor], Any] = _host,
                    fetch_loads: bool = False):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    The step carries the reference's **anomaly sentinel**: a non-finite
    loss or grad norm (or, with ``gnorm_skip_cap``, a grad norm at or above
    the cap) skips the update.  The reference selects the old state inside
    its jit because its state is donated; here the verdict is read on the
    host once, through ``fetch`` (the step's one host sync), BEFORE the
    update, and the update runs in place only when it passed: the same
    semantics, with no second copy of the state.  ``metrics["skipped"]`` is
    that verdict as an int.

    With ``fetch_loads`` (the trainer's expert-load feed) the MoE layers'
    expert counts ride in that one fetch beside the verdict, and come back
    as ``metrics["expert_load_host"]``, a numpy (reps, n_moe_positions, E)
    array.

    An optional scalar ``batch["fault_scale"]`` (runtime.faults
    ``train.nonfinite``) multiplies the loss AND the gradients after they
    are computed.  ``batch`` holds host (numpy) or torch arrays.
    """
    plan = lm.plan if lm.world > 1 else None

    def train_step(state, batch):
        batch = dict(batch)
        fault_scale = batch.pop("fault_scale", None)
        params = state["params"]
        loss, metrics, grads = loss_and_grads(lm, params, batch, compute_dtype)
        if fault_scale is not None:
            fault_scale = float(np.asarray(fault_scale))
            loss = loss * fault_scale
            for g in tree_paths(grads).values():
                if g is not None:
                    g.mul_(fault_scale)
            metrics["loss"] = loss
        gnorm = (global_norm(tree_paths(grads).values()) if plan is None
                 else _global_norm(grads, plan, params))
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if gnorm_skip_cap is not None:
            ok = ok & (gnorm < gnorm_skip_cap)
        loads = metrics.get("expert_load") if fetch_loads else None
        if loads is None:
            ok = bool(fetch(ok))
        else:
            # One device->host transfer: the verdict, then the counts
            # (integers, exact in fp32).
            host = np.asarray(fetch(torch.cat([ok.to(loads.dtype).reshape(1),
                                               loads.reshape(-1)])))
            ok = bool(host[0])
            metrics["expert_load_host"] = host[1:].reshape(tuple(loads.shape))
        if ok:
            opt_metrics = adamw_update(opt_cfg, params, grads, state, grad_norm=gnorm)
        else:
            opt_metrics = {"grad_norm": gnorm,
                           "lr": lr_schedule(opt_cfg, int(state["step"]) + 1)}
        metrics.update(opt_metrics)
        if metrics.get("expert_load") is None:
            metrics.pop("expert_load", None)
        metrics["skipped"] = int(not ok)
        return state, metrics

    return train_step
