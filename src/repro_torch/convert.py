"""Parameter trees, train states and dense serving caches between the JAX
package and the port, as numpy; and a whole parameter tree to and from one
expert-parallel rank's shard (:func:`shard_params`, :func:`gather_params`).

The two packages' trees have the same paths (``models.model.param_tree``):
dicts keyed alike and a tuple of per-pattern-position block dicts with
leaves stacked (reps, ...).  The JAX side is handed over as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.device import resolve_device
from repro_torch.models.model import map_tree, tree_paths


def params_from_numpy(tree, device=None, dtype=torch.float32):
    """numpy tree -> torch tree on ``device`` (default ``cuda``): float
    leaves become ``dtype``, integer tables int32."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int32)).to(device)
        return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)

    return map_tree(leaf, tree)


def params_to_numpy(tree):
    """torch tree -> numpy tree (float leaves as float32)."""

    def leaf(t):
        t = t.detach().cpu()
        return t.float().numpy() if t.is_floating_point() else t.numpy()

    return map_tree(leaf, tree)


def state_from_numpy(state, device=None):
    """numpy train state ``{"params", "m", "v", "step"}`` (the JAX
    ``training.init_state`` tree, as numpy) -> the port's: params and
    moments fp32 on ``device`` (default ``cuda``), the step a 0-d int32
    tensor on the CPU, where ``training`` keeps it."""
    return {"params": params_from_numpy(state["params"], device),
            "m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)}


def state_to_numpy(state):
    """The port's train state -> numpy, the step as an int32 scalar array."""
    return {"params": params_to_numpy(state["params"]),
            "m": params_to_numpy(state["m"]), "v": params_to_numpy(state["v"]),
            "step": np.asarray(int(state["step"]), np.int32)}


def cache_from_numpy(cache, device=None):
    """numpy dense cache (``LanguageModel.init_cache`` / ``prefill``'s
    tuple of per-pattern-position dicts, leaves stacked (reps, ...)) ->
    torch, fp32 leaves on ``device`` (default ``cuda``), contiguous and
    writable, as ``decode_step`` updates them in place."""
    device = resolve_device(device)
    return map_tree(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device), cache)


def cache_to_numpy(cache):
    """The port's dense cache -> numpy (float32 leaves)."""
    return map_tree(lambda t: t.detach().cpu().float().numpy(), cache)


def shard_params(params, plan):
    """A whole parameter tree -> this rank's: each MoE expert leaf
    (``w_up``, ``w_gate``, ``w_down``, stacked (reps, E, ...)) keeps the
    rank's physical slots ``[g * E_l, (g + 1) * E_l)`` (g its EP rank) as a
    copy; every other leaf, the router and the routing table included, is
    the same tensor."""
    if plan is None or plan.ep == 1:
        return params
    experts = sharding.expert_paths(tree_paths(params))

    def leaf(path, t):
        if path not in experts:
            return t
        E_l = t.shape[1] // plan.ep
        return t[:, plan.ep_rank * E_l:(plan.ep_rank + 1) * E_l].clone()

    return map_tree(leaf, params, with_path=True)


def gather_params(tree, plan):
    """The inverse of :func:`shard_params` on any tree of the params' shape
    (params or gradients; None leaves pass): each expert leaf gathered over
    the EP group, in EP-rank order, along its expert dim.  Collective: every
    rank of the EP group calls it."""
    if plan is None or plan.ep == 1:
        return tree
    experts = sharding.expert_paths(
        {k: v for k, v in tree_paths(tree).items() if v is not None})

    def leaf(path, t):
        if path not in experts:
            return t
        parts = [torch.empty_like(t) for _ in range(plan.ep)]
        torch.distributed.all_gather(parts, t.contiguous(), group=plan.ep_group)
        return torch.cat(parts, dim=1)

    return map_tree(leaf, tree, with_path=True)
