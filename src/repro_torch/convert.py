"""Parameter trees, train states and dense serving caches between the JAX
package and the port, as numpy; and a whole parameter tree to and from one
rank's shard (:func:`shard_params`, :func:`gather_params`): its pipeline
stage's layer chunks, its slice of every leaf the plan's rules slice, and
its expert slots.

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
    leaves become ``dtype`` (None: bf16 leaves, as ``ml_dtypes`` hands them
    over, stay bf16 and the others become fp32), integer tables (the
    routing tables ``assignment`` and ``replicas``) int32."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int32)).to(device)
        want = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(device, want)

    return map_tree(leaf, tree)


def params_to_numpy(tree):
    """torch tree -> numpy tree (float leaves as float32)."""

    def leaf(t):
        t = t.detach().cpu()
        return t.float().numpy() if t.is_floating_point() else t.numpy()

    return map_tree(leaf, tree)


def state_from_numpy(state, device=None):
    """numpy train state ``{"params", "m", "v", "step"}`` (the JAX
    ``training.init_state`` tree, as numpy) -> the port's: params fp32 and
    moments fp32 or bf16 as the arrays are, on ``device`` (default
    ``cuda``), the step a 0-d int32 tensor on the CPU, where ``training``
    keeps it."""
    return {"params": params_from_numpy(state["params"], device),
            "m": params_from_numpy(state["m"], device, None),
            "v": params_from_numpy(state["v"], device, None),
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


def stage_vstages(plan) -> int:
    """The virtual stages a stage of ``plan`` holds: its ``vstages`` under
    ``interleaved_1f1b``, else 1 (the reference's rule)."""
    return plan.vstages if plan.schedule == "interleaved_1f1b" else 1


def stage_reps(reps: int, plan) -> np.ndarray:
    """The global layer reps stage ``plan.pp_rank`` holds, in its local
    order, in the reference's chunk-major layout (``repro.core.pipeline
    ._stage_block_params``): reps = (V, PP, rpc) v-major, chunk ``c = v *
    PP + s`` holds reps ``[c * rpc, (c + 1) * rpc)``, and stage s keeps
    chunks s, PP + s, ..., (V - 1) * PP + s."""
    V, PP = stage_vstages(plan), plan.pp
    if reps % (PP * V):
        raise ValueError(f"{reps} pattern reps do not split over PP*V = {PP}*{V} chunks")
    rpc = reps // (PP * V)
    return np.arange(reps).reshape(V, PP, rpc)[:, plan.pp_rank].reshape(-1)


def _stage_chunks(t, plan):
    """Stage ``plan.pp_rank``'s chunks of a block leaf (reps, ...) (a
    tensor or a numpy array), :func:`stage_reps` along dim 0, so that the
    reps stay dim 0 and an expert leaf's slots dim 1.  A copy."""
    idx = stage_reps(t.shape[0], plan)
    return t[torch.from_numpy(idx).to(t.device)] if isinstance(t, torch.Tensor) else t[idx]


def _unstage_chunks(t: torch.Tensor, plan) -> torch.Tensor:
    """The inverse of :func:`_stage_chunks`: every stage's (V * rpc, ...)
    all-gathered over the pp group, back to (reps, ...)."""
    V, PP = stage_vstages(plan), plan.pp
    parts = [torch.empty_like(t) for _ in range(PP)]
    torch.distributed.all_gather(parts, t.contiguous(), group=plan.pp_group)
    rpc = t.shape[0] // V
    staged = torch.stack([q.reshape((V, rpc) + t.shape[1:]) for q in parts], dim=1)
    return staged.reshape((V * PP * rpc,) + t.shape[1:])


def shard_leaf(path: str, t, plan, experts):
    """This rank's part of the global leaf ``t`` at ``path`` (a tensor or a
    numpy array; ``experts``: the tree's expert paths): under a pipeline
    (``plan.pp`` > 1) a block leaf's stage chunks (:func:`_stage_chunks`),
    then a non-expert leaf's slice of every dim the plan's rules slice
    (``sharding.slice_leaf``, ``MeshPlan.layout``), or an expert leaf's
    physical slots ``[g * E_l, (g + 1) * E_l)``, g the rank's EP rank, and
    under the plan's d_ff split their slice ``plan.ffn_rank`` of
    ``plan.ffn_split`` along the d_ff (``sharding.ffn_dim``).  Any other
    leaf is ``t`` itself."""
    if getattr(plan, "pp", 1) > 1 and path.startswith("blocks/"):
        t = _stage_chunks(t, plan)
    axes = getattr(plan, "layout", {}).get(path)
    if axes is not None:
        return sharding.slice_leaf(t, axes, plan)
    if path not in experts:
        return t
    if plan.ep > 1:
        E_l = t.shape[1] // plan.ep
        t = t[:, plan.ep_rank * E_l:(plan.ep_rank + 1) * E_l]
    n = getattr(plan, "ffn_split", 1)
    if n > 1:
        dim = t.ndim + sharding.ffn_dim(path)
        f = t.shape[dim] // n
        index = [slice(None)] * t.ndim
        index[dim] = slice(plan.ffn_rank * f, (plan.ffn_rank + 1) * f)
        t = t[tuple(index)]
    return t


def shard_params(params, plan):
    """A whole parameter tree -> this rank's (:func:`shard_leaf`): a leaf no
    rule slices (the norms, the router, the routing tables ``assignment``
    and ``replicas``; the embedding under a pipeline where its d_model does
    not divide) is the same tensor on every stage without a pipeline, as
    the reference's ``P()`` in_specs put it; every sliced or sharded leaf
    is a copy."""
    split = getattr(plan, "ffn_split", 1) > 1
    layout = getattr(plan, "layout", {})
    if plan is None or (plan.ep == 1 and getattr(plan, "pp", 1) == 1 and not split
                        and not layout):
        return params
    experts = sharding.expert_paths(tree_paths(params))

    def leaf(path, t):
        out = shard_leaf(path, t, plan, experts)
        copy = path in layout or (path in experts and (plan.ep > 1 or split))
        return out.clone() if copy and out is not t else out

    return map_tree(leaf, params, with_path=True)


def gather_params(tree, plan):
    """The inverse of :func:`shard_params` on any tree of the params' shape
    (params, moments or gradients; None leaves pass): each sliced leaf
    all-gathered over its group (``sharding.gather_leaf``, no cast, no
    autograd), each expert leaf gathered along its d_ff over the
    expert-gradient group under the plan's split, then over the EP group,
    in EP-rank order, along its expert dim; then each block leaf over the
    pp group (:func:`_unstage_chunks`).  Collective: every rank calls it."""
    layout = plan.layout if plan is not None else {}
    if plan is None or (plan.ep == 1 and plan.pp == 1 and plan.ffn_split == 1
                        and not layout):
        return tree
    experts = sharding.expert_paths(
        {k: v for k, v in tree_paths(tree).items() if v is not None})

    def leaf(path, t):
        if t is None:
            return t
        if path in layout:
            with torch.no_grad():
                t = sharding.gather_leaf(t, layout[path], plan)
        if path in experts and plan.ffn_split > 1:
            parts = [torch.empty_like(t) for _ in range(plan.ffn_split)]
            torch.distributed.all_gather(parts, t.contiguous(), group=plan.expert_dp_group)
            t = torch.cat(parts, dim=t.dim() + sharding.ffn_dim(path))
        if path in experts and plan.ep > 1:
            parts = [torch.empty_like(t) for _ in range(plan.ep)]
            torch.distributed.all_gather(parts, t.contiguous(), group=plan.ep_group)
            t = torch.cat(parts, dim=1)
        if plan.pp > 1 and path.startswith("blocks/"):
            t = _unstage_chunks(t, plan)
        return t

    return map_tree(leaf, tree, with_path=True)
