"""Block composition: a repeated ``block_pattern`` tiled ``reps`` times.

Parameters for each pattern position are stacked over reps, as in the JAX
package; where it runs the stack as a ``lax.scan``, the port loops over
reps in Python.  The paged serving steps index rep ``r`` of every leaf
(:func:`rep_params`); the uncached forward and the training loss split
every leaf into its reps at once (:func:`unstack`), whose backward writes
each stacked gradient once instead of once per rep.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

# Where Mamba2 training stands (ROADMAP.md, Queue 1).
SSM_TRAINING_TODO = ("Mamba2 training is not ported yet (ROADMAP.md Queue 1, "
                     "item 5: Mamba2 training)")


def rep_params(tree, r: int):
    """Rep ``r`` of every stacked ``(reps, ...)`` leaf of a param tree."""
    if isinstance(tree, dict):
        return {k: rep_params(v, r) for k, v in tree.items()}
    return tree[r]


def unstack(tree, reps: int):
    """All reps of a stacked param tree at once: a list of ``reps`` trees of
    views (``torch.unbind``), so autograd stacks the per-rep gradients of a
    leaf in one op."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(reps)]
    return list(torch.unbind(tree, 0))


def apply_block(
    block: Tuple[str, str],
    params: Dict[str, Any],
    x: torch.Tensor,
    arch: ArchConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    write=None,
    return_cache: bool = False,
    train: bool = False,
    plan=None,
    token_sharded: bool = True,
    seq_shard: bool = False,
    data_split: bool = True,
    telemetry=None,
):
    """One (mixer, ffn) block with pre-norms and residuals.  Returns
    (x, moe metrics or {}, new cache or None): K/V for an attention mixer,
    the dense SSM/conv cache for a mamba mixer (``models.ssm``).  ``train``
    selects the differentiable attention and capacity-FFN paths; a mamba
    mixer has none yet and raises.  ``plan``, ``token_sharded``,
    ``seq_shard``, ``data_split`` and ``telemetry`` go to
    :func:`moe.moe_ffn` (the mixer needs no ranks: every rank holds whole
    sequences)."""
    mixer, ffn = block
    metrics: Dict[str, torch.Tensor] = {}
    h = L.rms_norm(x, params["norm_mixer"], arch.norm_eps)
    if mixer.startswith("attn"):
        window = arch.sliding_window if mixer == "attn_local" else None
        out, new_cache = L.attention_proj(
            params["mixer"], h, arch, positions, window=window, cache=cache,
            write=write, return_kv=return_cache and cache is None, train=train,
        )
    elif mixer == "mamba":
        if train:
            raise NotImplementedError(SSM_TRAINING_TODO)
        out, new_cache = ssm_lib.mamba_block(params["mixer"], h, arch, cache=cache,
                                             return_cache=return_cache)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    x = x + out
    if ffn != "none":
        h = L.rms_norm(x, params["norm_ffn"], arch.norm_eps)
        if ffn == "dense":
            out = L.dense_ffn(params["ffn"], h, arch.ffn_activation)
        elif ffn == "moe":
            out, metrics = moe_lib.moe_ffn(params["ffn"], h, arch, plan,
                                           token_sharded=token_sharded, train=train,
                                           seq_shard=seq_shard, data_split=data_split,
                                           telemetry=telemetry)
        else:
            raise ValueError(ffn)
        x = x + out
    return x, metrics, new_cache


def num_reps(block_params) -> int:
    """The pattern reps a stacked block tree holds: the whole stack's, or a
    pipeline stage's chunks (``convert.shard_params``)."""
    leaf = block_params[0]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def stack_forward(block_params, x: torch.Tensor, arch: ArchConfig, *,
                  positions: torch.Tensor, train: bool = False, plan=None,
                  telemetry=None):
    """Run the layer stack the leaves hold (every rep, or a pipeline
    chunk's), token-sharded over ``plan``'s ranks (``train``,
    ``telemetry``: see :func:`apply_block`).  Returns (x, {"moe_aux_loss",
    "moe_z_loss"} scalars, expert_load (reps, n_moe_positions, E) or
    None)."""
    reps = num_reps(block_params)
    per_rep = [unstack(p, reps) for p in block_params]
    aux = z = x.new_zeros((), dtype=torch.float32)
    loads = []
    for r in range(reps):
        rep_loads = []
        for pos, blk in enumerate(arch.block_pattern):
            x, metrics, _ = apply_block(blk, per_rep[pos][r], x, arch,
                                        positions=positions, train=train, plan=plan,
                                        telemetry=telemetry)
            if metrics:
                aux = aux + metrics["moe_aux_loss"]
                z = z + metrics["moe_z_loss"]
                rep_loads.append(metrics["expert_load"])
        if rep_loads:
            loads.append(torch.stack(rep_loads))
    return x, {"moe_aux_loss": aux, "moe_z_loss": z}, (
        torch.stack(loads) if loads else None)
