"""Block composition: a repeated ``block_pattern`` tiled ``reps`` times.

Parameters for each pattern position are stacked over reps, as in the JAX
package; where it runs the stack as a ``lax.scan``, the port loops over
reps in Python.  The paged serving steps index rep ``r`` of every leaf
(:func:`rep_params`); the uncached forward and the training loss split
every leaf into its reps at once (:func:`unstack`), whose backward writes
each stacked gradient once instead of once per rep.

Under autograd each rep runs under the plan's ``remat`` (the reference's
``_remat`` of its scan body): "full" keeps only the rep's inputs and
recomputes the rep in the backward (``torch.utils.checkpoint``); "dots"
keeps the outputs of the matrix products without batch dims (``aten.mm``,
``aten.addmm``: ``dots_with_no_batch_dims_saveable``) and recomputes the
rest; "none" keeps everything.  A recompute runs the rep's collectives
again (the EP all-to-all, the metric sums, the weights' gathers, the
sequence gathers: the reference's ``kv_gathered`` is recomputed too; a Mamba2
mixer's state hand-offs), on every rank
in the backward's order, so it always runs to the rep's end; its outputs
are dropped, so no metric counts twice, and its ``a2a.layer`` spans are
named ``a2a.layer.recompute``.  "dots" sees aten ops only: a kernel
called from an extension (the CUDA ragged FFN) is recomputed.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn,
    set_checkpoint_early_stop,
)

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib


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
    cache_index: Optional[int] = None,
    write=None,
    return_cache: bool = False,
    train: bool = False,
    plan=None,
    token_sharded: bool = True,
    seq_shard: bool = False,
    data_split: bool = True,
    seq=None,
    telemetry=None,
):
    """One (mixer, ffn) block with pre-norms and residuals.  Returns
    (x, moe metrics or {}, new cache or None): K/V for an attention mixer,
    the dense SSM/conv cache for a mamba mixer (``models.ssm``).  An
    attention mixer's ``cache`` is paged (``"block_table"`` in it, written
    through ``write``) or dense ({"k", "v"} written at ``cache_index``,
    ``layers.attention_proj``).  ``train`` selects the differentiable
    attention, SSD and capacity-FFN paths.  ``plan``, ``token_sharded``,
    ``seq_shard``, ``data_split`` and ``telemetry`` go to
    :func:`moe.moe_ffn`.  ``seq``: the plan whose sequence group holds the
    sequence, x this rank's slice of it (training, the uncached forward and
    the dense-cache prefill); the mixer takes what crosses slices from the
    group (``layers.attention_proj`` gathers K/V, ``ssm.mamba_block`` hands
    states and conv rows rank to rank).  With a dense
    attention ``cache``, ``seq`` says the cache is the rank's "kv_seq"
    block (``layers.kv_block_attention``).  The mixer's and a
    dense FFN's leaves that ``plan`` slices
    are gathered whole in x's dtype just before they are used
    (``sharding.gather_block``; a recompute gathers them again)."""
    mixer, ffn = block
    metrics: Dict[str, torch.Tensor] = {}
    h = L.rms_norm(x, params["norm_mixer"], arch.norm_eps)
    mp = sharding.gather_block(params, block, arch, plan, x.dtype, "mixer")
    if mixer.startswith("attn"):
        window = arch.sliding_window if mixer == "attn_local" else None
        out, new_cache = L.attention_proj(
            mp, h, arch, positions, window=window, cache=cache, cache_index=cache_index,
            write=write, return_kv=return_cache and cache is None, train=train, seq=seq,
        )
    elif mixer == "mamba":
        out, new_cache = ssm_lib.mamba_block(mp, h, arch, cache=cache,
                                             return_cache=return_cache, train=train,
                                             seq=seq)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    x = x + out
    if ffn != "none":
        h = L.rms_norm(x, params["norm_ffn"], arch.norm_eps)
        if ffn == "dense":
            out = L.dense_ffn(sharding.gather_block(params, block, arch, plan, x.dtype, "ffn"),
                              h, arch.ffn_activation)
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


# The products "dots" keeps: matrix products without batch dims.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _Recompute:
    """The telemetry of a remat recompute: its spans are named
    ``<name>.recompute``, so the drift report counts the forward's alone."""

    def __init__(self, telemetry):
        self.telemetry = telemetry

    def span(self, name: str, **attrs):
        return self.telemetry.span(name + ".recompute", **attrs)


def _rep(blocks, x, aux, z, arch: ArchConfig, *, positions, train, plan, telemetry):
    """One rep of the pattern: (x, aux, z, expert loads (n_moe_positions, E)
    or None), the aux and z losses added to the carried ones."""
    loads = []
    for pos, blk in enumerate(arch.block_pattern):
        x, metrics, _ = apply_block(blk, blocks[pos], x, arch, positions=positions,
                                    train=train, plan=plan, seq=plan, telemetry=telemetry)
        if metrics:
            aux = aux + metrics["moe_aux_loss"]
            z = z + metrics["moe_z_loss"]
            loads.append(metrics["expert_load"])
    return x, aux, z, (torch.stack(loads) if loads else None)


def _remat_rep(mode: str, blocks, x, aux, z, arch: ArchConfig, **kw):
    """:func:`_rep` under ``torch.utils.checkpoint`` (``mode`` "full" or
    "dots"); the first call is the forward, any later one a recompute."""
    calls = []

    def body(h, a, zz):
        tel = kw["telemetry"]
        if calls and tel is not None:
            tel = _Recompute(tel)
        calls.append(None)
        return _rep(blocks, h, a, zz, arch, **{**kw, "telemetry": tel})

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if mode == "dots" else noop_context_fn)
    with set_checkpoint_early_stop(False):
        return checkpoint(body, x, aux, z, use_reentrant=False, context_fn=context_fn)


def stack_forward(block_params, x: torch.Tensor, arch: ArchConfig, *,
                  positions: torch.Tensor, train: bool = False, plan=None,
                  telemetry=None):
    """Run the layer stack the leaves hold (every rep, or a pipeline
    chunk's) on this rank's block of the batch under ``plan``: its rows and
    its sequence slice, ``positions`` their global positions (``train``,
    ``telemetry``: see :func:`apply_block`), each rep under the plan's
    remat when autograd records (module docstring).  Returns (x,
    {"moe_aux_loss", "moe_z_loss"} scalars, expert_load (reps,
    n_moe_positions, E) or None)."""
    reps = num_reps(block_params)
    per_rep = [unstack(p, reps) for p in block_params]
    remat = sharding.remat_of(plan) if torch.is_grad_enabled() else "none"
    aux = z = x.new_zeros((), dtype=torch.float32)
    loads = []
    kw = dict(positions=positions, train=train, plan=plan, telemetry=telemetry)
    for r in range(reps):
        blocks = [p[r] for p in per_rep]
        if remat == "none":
            x, aux, z, ld = _rep(blocks, x, aux, z, arch, **kw)
        else:
            x, aux, z, ld = _remat_rep(remat, blocks, x, aux, z, arch, **kw)
        if ld is not None:
            loads.append(ld)
    return x, {"moe_aux_loss": aux, "moe_z_loss": z}, (
        torch.stack(loads) if loads else None)
