"""Train state, the train step and the dense-cache serving steps (the
port of ``repro.training``).

The step differentiates ``LanguageModel.loss`` with autograd: the fp32
master weights are cast to the compute dtype inside the graph, so autograd
carries the gradients back to fp32 through the casts; the AdamW update then
runs in place (``optim.adamw_update``).  Over the ranks of the model's
``sharding.MeshPlan`` each rank takes its own rows of the global batch,
differentiates its term of the global loss, and sums the gradients: the
replicated (non-expert) ones over the world, the expert ones over the data
group (the ranks that hold the same expert slots).
``make_prefill_step`` / ``make_decode_step`` cast every floating leaf to
the compute dtype and run ``LanguageModel.prefill`` / ``decode_step``
without autograd.
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
    """{"params": fp32 masters, "m", "v": fp32 moments, "step": 0-d int32
    on the CPU}, the params drawn from ``generator`` on ``device`` (default
    ``cuda``)."""
    params = init_params(lm.arch, generator, resolve_device(device), torch.float32)
    return {"params": params, **adamw_init(params)}


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A host batch array (or a tensor) on ``device``; from the host through
    pinned memory on the card, so the copy is queued behind the previous
    step's work instead of waiting for it."""
    t = torch.as_tensor(a)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _cast(params, dtype: torch.dtype):
    """Every floating leaf in ``dtype`` (a leaf already in it is not copied)."""
    return map_tree(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def make_prefill_step(lm: LanguageModel, compute_dtype: torch.dtype = torch.bfloat16):
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    ``batch["tokens"]`` is a host (numpy) or torch (b, l) array."""
    @torch.no_grad()
    def prefill_step(params, batch):
        device = params["embed"].device
        batch = {k: _to_device(v, device) for k, v in batch.items()}
        return lm.prefill(_cast(params, compute_dtype), batch)

    return prefill_step


def make_decode_step(lm: LanguageModel, compute_dtype: torch.dtype = torch.bfloat16):
    """``decode_step(params, cache, batch, index) -> (logits, cache)``, the
    cache updated in place."""
    @torch.no_grad()
    def decode_step(params, cache, batch, index):
        device = params["embed"].device
        batch = {k: _to_device(v, device) for k, v in batch.items()}
        return lm.decode_step(_cast(params, compute_dtype), cache, batch, index)

    return decode_step


def shard_batch(batch, plan):
    """This rank's rows of a global batch: ``b / world`` whole sequences
    (rank r takes rows ``[r * b_l, (r + 1) * b_l)``)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % plan.world:
            raise ValueError(f"batch {b} does not split over {plan.world} ranks")
        bl = b // plan.world
        out[k] = v[plan.rank * bl:(plan.rank + 1) * bl]
    return out


def loss_and_grads(lm: LanguageModel, params, batch,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """Differentiate ``lm.loss`` at ``params`` (this rank's shard) on
    ``batch`` (the global batch; device tensors or host arrays).  Returns
    (loss, metrics, grads) with detached metrics and ``grads`` in the
    params' tree (None for integer tables).  Over several ranks each takes
    its rows (:func:`shard_batch`), and the gradients are summed in place
    into the global ones (the replicated leaves over the world, the expert
    leaves over the data group), the loss and "ce" terms likewise."""
    plan = lm.plan if lm.world > 1 else None
    if plan is not None:
        batch = shard_batch(batch, plan)
    device = params["embed"].device
    batch = {k: _to_device(v, device) for k, v in batch.items()}
    leaves = [p for p in tree_paths(params).values() if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = lm.loss(_cast(params, compute_dtype), batch)
        flat_grads = iter(torch.autograd.grad(loss, leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = map_tree(lambda p: next(flat_grads) if p.is_floating_point() else None, params)
    loss = loss.detach()
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    if plan is not None:
        flat = {k: g for k, g in tree_paths(grads).items() if g is not None}
        experts = sharding.expert_paths(flat)
        sharding.sum_leaves_([g for k, g in flat.items() if k not in experts],
                             plan.world_group)
        sharding.sum_leaves_([flat[k] for k in sorted(experts)], plan.dp_group)
        terms = sharding.all_reduce_(torch.stack([loss, metrics["ce"]]), plan.world_group)
        loss, metrics["ce"] = terms[0], terms[1]
        metrics["loss"] = loss
    return loss, metrics, grads


def _global_norm(grads, plan):
    """The global grad norm of reduced gradients: the replicated leaves'
    squares once, the expert leaves' summed over the EP group."""
    flat = {k: g for k, g in tree_paths(grads).items() if g is not None}
    experts = sharding.expert_paths(flat)
    sq = [torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                       for k, g in flat.items() if (k in experts) == e]).square().sum()
          for e in (False, True)]
    return (sq[0] + sharding.all_reduce_(sq[1], plan.ep_group)).sqrt()


def make_train_step(lm: LanguageModel, opt_cfg: OptimizerConfig,
                    gnorm_skip_cap: Optional[float] = None, *,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    fetch: Callable[[torch.Tensor], Any] = torch.Tensor.item):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    The step carries the reference's **anomaly sentinel**: a non-finite
    loss or grad norm (or, with ``gnorm_skip_cap``, a grad norm at or above
    the cap) skips the update.  The reference selects the old state inside
    its jit because its state is donated; here the verdict is read on the
    host once, through ``fetch`` (the step's one host sync), BEFORE the
    update, and the update runs in place only when it passed: the same
    semantics, with no second copy of the state.  ``metrics["skipped"]`` is
    that verdict as an int.

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
                 else _global_norm(grads, plan))
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if gnorm_skip_cap is not None:
            ok = ok & (gnorm < gnorm_skip_cap)
        ok = bool(fetch(ok))
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
