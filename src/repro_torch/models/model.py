"""Language model: parameter tree, init, forward, training loss, paged
serving steps (attention) and dense-cache serving steps (attention, Mamba2
and hybrid stacks).

The port of ``repro.models.model``.  The parameter tree has the JAX
package's paths and leaf shapes: ``{"embed", "blocks": (one dict per
pattern position, leaves stacked (reps, ...)), "final_norm"[, "lm_head"]}``,
so ``repro_torch.convert`` maps one onto the other leaf by leaf.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.models.layers import rms_norm, softcap
from repro_torch.serving import kv_cache as kv_lib

VOCAB_PAD_MULTIPLE = 256


# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamMeta:
    """A leaf's shape, its logical dim tags (the reference's, which
    ``sharding.MeshPlan.rules`` maps onto the mesh; None: a dim no rule
    slices) and its initializer."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | embed | zeros | ones | arange | fill | a_log | dt_bias
    fan_in: int = 0

    def stacked(self, reps: int) -> "ParamMeta":
        return ParamMeta((reps,) + self.shape, ("layers",) + self.logical, self.init,
                         self.fan_in)


def _attn_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    d, hq, hkv = a.d_model, a.q_dim, a.kv_dim
    return {
        "wq": ParamMeta((d, hq), ("embed", "model_out"), fan_in=d),
        "wk": ParamMeta((d, hkv), ("embed", "model_out"), fan_in=d),
        "wv": ParamMeta((d, hkv), ("embed", "model_out"), fan_in=d),
        "wo": ParamMeta((hq, d), ("model_out", "embed"), fan_in=hq),
    }


def _dense_ffn_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    d, f = a.d_model, a.d_ff
    t = {"w_up": ParamMeta((d, f), ("embed", "model_out"), fan_in=d),
         "w_down": ParamMeta((f, d), ("model_out", "embed"), fan_in=f)}
    if a.ffn_activation == "swiglu":
        t["w_gate"] = ParamMeta((d, f), ("embed", "model_out"), fan_in=d)
    return t


def _moe_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    m = a.moe
    d, f, E = a.d_model, m.d_ff, m.num_experts
    t = {
        "w_router": ParamMeta((d, E), (None, None), fan_in=d),
        "w_up": ParamMeta((E, d, f), ("expert", None, "expert_ffn"), fan_in=d),
        "w_down": ParamMeta((E, f, d), ("expert", "expert_ffn", None), fan_in=f),
        # logical expert -> physical slot routing table (int32)
        "assignment": ParamMeta((E,), (None,), init="arange"),
    }
    if m.max_replicas > 0:
        # Hot-expert replica channels: a logical expert id a channel,
        # sentinel E = free (fan_in holds the fill value).
        t["replicas"] = ParamMeta((m.max_replicas,), (None,), init="fill", fan_in=E)
    if a.ffn_activation == "swiglu":
        t["w_gate"] = ParamMeta((E, d, f), ("expert", None, "expert_ffn"), fan_in=d)
    return t


def _mamba_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    s = a.ssm
    d = a.d_model
    d_in = s.expand * d
    gn = s.n_groups * s.state_size
    nh = s.num_heads(d)
    w = s.conv_width
    return {
        "w_z": ParamMeta((d, d_in), ("embed", "ssm_inner"), fan_in=d),
        "w_x": ParamMeta((d, d_in), ("embed", "ssm_inner"), fan_in=d),
        "w_B": ParamMeta((d, gn), ("embed", None), fan_in=d),
        "w_C": ParamMeta((d, gn), ("embed", None), fan_in=d),
        "w_dt": ParamMeta((d, nh), ("embed", None), fan_in=d),
        "conv_x_w": ParamMeta((d_in, w), ("ssm_inner", None), fan_in=w),
        "conv_x_b": ParamMeta((d_in,), ("ssm_inner",), init="zeros"),
        "conv_B_w": ParamMeta((gn, w), (None, None), fan_in=w),
        "conv_B_b": ParamMeta((gn,), (None,), init="zeros"),
        "conv_C_w": ParamMeta((gn, w), (None, None), fan_in=w),
        "conv_C_b": ParamMeta((gn,), (None,), init="zeros"),
        "A_log": ParamMeta((nh,), (None,), init="a_log"),
        "D": ParamMeta((nh,), (None,), init="ones"),
        "dt_bias": ParamMeta((nh,), (None,), init="dt_bias"),
        "norm_scale": ParamMeta((d_in,), ("ssm_inner",), init="zeros"),
        "out_proj": ParamMeta((d_in, d), ("ssm_inner", "embed"), fan_in=d_in),
    }


def _block_tree(a: ArchConfig, block) -> Dict[str, Any]:
    mixer, ffn = block
    t: Dict[str, Any] = {"norm_mixer": ParamMeta((a.d_model,), (None,), init="zeros")}
    if mixer.startswith("attn"):
        t["mixer"] = _attn_tree(a)
    elif mixer == "mamba":
        t["mixer"] = _mamba_tree(a)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn != "none":
        t["norm_ffn"] = ParamMeta((a.d_model,), (None,), init="zeros")
        t["ffn"] = _dense_ffn_tree(a) if ffn == "dense" else _moe_tree(a)
    return t


def map_tree(fn, tree, *, with_path: bool = False, _prefix: str = ""):
    """``fn`` applied to every leaf of a nested dict/tuple tree; with
    ``with_path`` it is called as ``fn(path, leaf)``, the path spelled as
    :func:`tree_paths` spells it.  A :class:`KVBlock` maps to a KVBlock of
    the same ``cache_len``."""
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: map_tree(fn, v, with_path=with_path,
                           _prefix=f"{_prefix}/{k}" if _prefix else str(k))
               for k, v in items}
        if isinstance(tree, KVBlock):
            return KVBlock(out["k"], out["v"], tree.cache_len)
        return out if isinstance(tree, dict) else tuple(out.values())
    return fn(_prefix, tree) if with_path else fn(tree)


def param_tree(a: ArchConfig) -> Dict[str, Any]:
    reps = a.num_layers // len(a.block_pattern)
    vp = a.padded_vocab(VOCAB_PAD_MULTIPLE)
    tree: Dict[str, Any] = {
        "embed": ParamMeta((vp, a.d_model), ("vocab", "model_out"), init="embed"),
        "blocks": tuple(map_tree(lambda m: m.stacked(reps), _block_tree(a, blk))
                        for blk in a.block_pattern),
        "final_norm": ParamMeta((a.d_model,), (None,), init="zeros"),
    }
    if not a.tie_embeddings:
        tree["lm_head"] = ParamMeta((a.d_model, vp), ("model_out", "vocab"), fan_in=a.d_model)
    return tree


def logical_tags(a: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """The flat ``{path: logical tags}`` of ``a``'s parameters, paths as
    :func:`tree_paths` spells them (the reference's ``param_tree`` tags,
    ``"layers"`` first on a block leaf)."""
    return {p: m.logical for p, m in tree_paths(param_tree(a)).items()}


def _init_leaf(meta: ParamMeta, gen: torch.Generator, device, dtype):
    if meta.init == "arange":
        return torch.arange(meta.shape[-1], dtype=torch.int32,
                            device=device).expand(meta.shape).contiguous()
    if meta.init == "fill":  # an int32 table of the constant fan_in
        return torch.full(meta.shape, meta.fan_in, dtype=torch.int32, device=device)
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dtype, device=device)
    if meta.init in ("a_log", "dt_bias"):
        u = torch.empty(meta.shape, dtype=torch.float32, device=device)
        if meta.init == "a_log":  # A = -exp(A_log), |A| ~ U(1, 16)
            return u.uniform_(1.0, 16.0, generator=gen).log_().to(dtype)
        # inverse softplus of dt ~ exp U(log 1e-3, log 0.1)
        dt = u.uniform_(math.log(1e-3), math.log(0.1), generator=gen).exp_()
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    std = 0.02 if meta.init == "embed" else 1.0 / math.sqrt(max(meta.fan_in, 1))
    w = torch.randn(meta.shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def init_params(a: ArchConfig, generator: torch.Generator, device=None,
                dtype=torch.float32):
    """Random weights by the JAX package's init rules, drawn in fp32 from
    ``generator`` directly on ``device`` (default ``cuda``) and cast to
    ``dtype``; the same seed gives the same fp32 values whatever ``dtype``.
    (torch cannot reproduce ``jax.random``: parity tests convert the JAX
    package's weights with ``repro_torch.convert`` instead.)"""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on {device}")
    return map_tree(lambda m: _init_leaf(m, generator, device, dtype), param_tree(a))


# ---------------------------------------------------------------------------
# Language model
# ---------------------------------------------------------------------------


class KVBlock(dict):
    """A rank's block of a dense attention cache under the reference's
    "kv_seq" rule: {"k", "v"} (reps, b, C / n, kv_heads, head_dim), rows
    ``[j C / n, (j + 1) C / n)`` of a ``cache_len`` = C row cache
    (``sharding.MeshPlan.kv_rows``).  A dict whose ``cache_len`` says the
    whole cache's length, which the block's own shape cannot (a block of
    C / n rows and a whole cache of as many look alike); a cache that a
    plan keeps whole is a plain dict.  :func:`map_tree` keeps the type;
    a map that makes plain dicts of a block loses it, and
    :meth:`LanguageModel.decode_step` refuses a plain dict that the plan
    would have split."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, cache_len: int):
        super().__init__(k=k, v=v)
        self.cache_len = cache_len


class LanguageModel:
    """An ArchConfig's forward, training loss and serving steps (whatever
    device the params live on): paged for attention mixers, a dense
    per-layer cache for any stack (K/V for attention, the SSM state for
    mamba).

    With a ``sharding.MeshPlan`` the MoE layers run expert-parallel over its
    ranks, on params that hold this rank's expert slots and its slice of
    every leaf the plan's rules slice (``convert.shard_params``; each
    forward gathers the embedding once and each layer its own leaves,
    ``sharding.gather_leaf``): ``forward``, ``loss`` and the dense-cache
    ``prefill`` take this rank's block of the batch
    (``training.shard_batch``: its rows over data, its sequence slice over
    (ep, tp); the mixers gather what crosses slices over the sequence
    group), the dense-cache ``decode_step`` the whole batch, of which it
    decodes its rows over data against its "kv_seq" block of the cache
    (:meth:`init_cache`, :meth:`pad_cache`); the paged serving steps take
    the same requests on every rank (prefill: each rank's sequence shard of
    every MoE layer's input; decode: weight-parallel, the batch split over
    the data group when it divides it, :meth:`decode_step_paged`).
    ``plan=None`` is one rank.
    Under a pipeline plan (``plan.pp`` > 1) the params hold the rank's
    stage's chunks too, ``loss`` runs the differentiable pipelined forward,
    ``forward`` the same executor without autograd, and ``loss_and_grads``
    the schedule-executing step (``core.pipeline``), each on this rank's
    block of every microbatch (``training.shard_batch``); the serving steps
    are not pipelined.
    ``telemetry`` (an ``obs.Telemetry``) gets the MoE layers' ``a2a.layer``
    spans in ``forward`` and ``loss`` (and the pipeline's schedule span and
    instant)."""

    def __init__(self, arch: ArchConfig, plan=None, telemetry=None):
        self.arch = arch
        self.plan = plan
        self.telemetry = telemetry
        self.world = 1 if plan is None else plan.world
        self.pipelined = plan is not None and plan.pp > 1
        self.vp = arch.padded_vocab(VOCAB_PAD_MULTIPLE)
        self.reps = arch.num_layers // len(arch.block_pattern)

    # -- embedding / head ---------------------------------------------------

    def _whole(self, params):
        """``params`` with the embedding (and an untied head) gathered whole
        in the compute dtype (``final_norm``'s) where the plan slices them
        (``sharding.gather_leaf``): once a forward, so that the lookup and
        the tied head share one table and its gradient is summed once."""
        layout = {} if self.plan is None else self.plan.layout
        out = params
        for k in ("embed", "lm_head"):
            if k in layout and k in params:
                out = dict(params) if out is params else out
                out[k] = sharding.gather_leaf(params[k], layout[k], self.plan,
                                              params["final_norm"].dtype)
        return out

    def _has_embeds(self, batch) -> bool:
        """A frontend arch's batch that carries precomputed ``embeds``."""
        return self.arch.frontend is not None and "embeds" in batch

    def _embed(self, params, batch) -> torch.Tensor:
        """The stack's input: a frontend arch's precomputed ``embeds`` (b, s,
        d) cast to the compute dtype (``final_norm``'s), else the table's
        rows of ``batch["tokens"]``; either :meth:`_scaled`."""
        if self._has_embeds(batch):
            return self._scaled(batch["embeds"].to(params["final_norm"].dtype))
        return self._embed_rows(params["embed"], batch["tokens"])

    def _embed_rows(self, table, tokens) -> torch.Tensor:
        """The table's rows of ``tokens``, :meth:`_scaled`."""
        return self._scaled(table[tokens.long()])

    def _scaled(self, x) -> torch.Tensor:
        """With ``scale_embeddings`` (gemma2) ``x`` times sqrt(d_model)
        rounded to its dtype first, as the reference's
        ``jnp.asarray(math.sqrt(d_model), x.dtype)`` (59.75 in bf16 at
        d_model 3584): the product of two values of that dtype, rounded
        once."""
        if self.arch.scale_embeddings:
            x = x * torch.tensor(math.sqrt(self.arch.d_model), dtype=x.dtype).item()
        return x

    def _pipeline_inputs(self, params, batch):
        """(inputs, embed_fn) of the pipeline executors: this rank's token
        ids and the stage-0 lookup, or a frontend's precomputed embeddings
        (:meth:`_embed`, outside the pipeline as in the reference) and
        None."""
        if self._has_embeds(batch):
            return self._embed(params, batch), None
        return batch["tokens"], self._embed_rows

    def _logits(self, w, x) -> torch.Tensor:
        logits = (x @ w.to(x.dtype)).float()
        logits = softcap(logits, self.arch.final_logit_softcap)
        pad = torch.arange(self.vp, device=x.device) < self.arch.vocab_size
        return torch.where(pad, logits, -1e30)

    def _head(self, params, x) -> torch.Tensor:
        w = params["embed"].T if self.arch.tie_embeddings else params["lm_head"]
        return self._logits(w, x)

    @staticmethod
    def _positions(b: int, s: int, device, offset: int = 0) -> torch.Tensor:
        """(b, s) positions ``offset, ..., offset + s - 1`` (M-RoPE takes
        them as its three planes)."""
        return torch.arange(offset, offset + s, device=device)[None].expand(b, s)

    def _seq_positions(self, b: int, s: int, device) -> torch.Tensor:
        """:meth:`_positions` of this rank's sequence slice of ``s`` tokens
        under the plan (``sharding.MeshPlan.seq_offset``)."""
        return self._positions(b, s, device, 0 if self.plan is None
                               else self.plan.seq_offset(s))

    # -- forward ------------------------------------------------------------

    def forward(self, params, batch):
        """Uncached forward: (logits (b, s, vp) fp32, {"moe_aux_loss",
        "moe_z_loss"}, expert loads), of this rank's block of the batch
        under a plan.  Under a pipeline plan: :meth:`_pipelined_forward`."""
        if self.pipelined:
            return self._pipelined_forward(params, batch)
        params = self._whole(params)
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        x, aux, loads = transformer.stack_forward(
            params["blocks"], x, self.arch, positions=self._seq_positions(b, s, x.device),
            plan=self.plan, telemetry=self.telemetry)
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        return self._head(params, x), aux, loads

    def _pipelined_forward(self, params, batch):
        """``forward`` under a pipeline plan, the reference's ``_stack_out``
        -> ``pipelined_stack_forward``: the port's forward executor without
        autograd, every layer on its serving path (flash attention, the
        expert kernels) as in the forward at world 1, on this rank's block
        ``batch["tokens"]`` (or ``"embeds"``) of every microbatch.  The last
        stage applies the final norm and the head, and its logits reach
        every rank of its pp group (the reference's SPMD forward gives every
        device the whole array).  aux and z are their global values: the
        ranks' terms summed; the expert loads are gathered over the pp
        group."""
        from repro_torch.core import pipeline

        plan = self.plan
        with torch.no_grad():
            params = self._whole(params)
            inputs, embed_fn = self._pipeline_inputs(params, batch)
            y, aux, z, loads = pipeline.pipelined_stack_forward(
                params["blocks"], inputs, self.arch, plan, embed_fn=embed_fn,
                embed_params=params["embed"], train=False, telemetry=self.telemetry)
            if y is not None:
                logits = self._head(params, rms_norm(y, params["final_norm"],
                                                     self.arch.norm_eps))
            else:
                logits = torch.empty(inputs.shape[:2] + (self.vp,), dtype=torch.float32,
                                     device=inputs.device)
            torch.distributed.broadcast(logits, src=plan.stage_peer(plan.pp - 1),
                                        group=plan.pp_group)
            terms = sharding.all_reduce_(torch.stack([aux, z]), plan.world_group)
        return logits, {"moe_aux_loss": terms[0], "moe_z_loss": terms[1]}, loads

    # -- training loss --------------------------------------------------------

    def _loss_chunks(self, b: int, s: int) -> int:
        """Chunks of the CE loss so a rank's fp32 logits stay <= ~128 MB:
        the reference's rule, the global ``b * s`` tokens divided by the
        data and sequence shards.  The count divides the rank's sequence
        slice (``s / (ep * tp)``), which the port chunks."""
        div = 1 if self.plan is None else self.plan.dp * self.plan.seq_size
        sl = s // (1 if self.plan is None else self.plan.seq_size)
        tokens = max(b * s // div, 1)
        target_tokens = max(int(128e6 // (self.vp * 4)), 1)
        need = max(1, -(-tokens // target_tokens))
        for nc in range(need, min(sl, 256) + 1):  # a divisor of the slice, capped
            if sl % nc == 0:
                return nc
        return 1

    def _ce_sum(self, params, x, labels) -> torch.Tensor:
        """Summed token cross-entropy of final-stack activations."""
        h = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        logits = self._head(params, h)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None])[..., 0]
        return (lse - ll).sum()

    def loss(self, params, batch):
        """Causal LM loss (sequence-chunked CE) on the training path of
        every layer.  Returns (loss, {"loss", "ce", "moe_aux_loss",
        "moe_z_loss", "expert_load"}).  Each CE chunk runs under
        ``torch.utils.checkpoint``, so its (tokens, vocab) fp32 logits are
        recomputed in the backward instead of kept.

        Over W ranks, each holding its block of b rows and s positions
        (``training.shard_batch``), it is this rank's term of the global
        loss ``ce_sum / (W b s) + aux + z``: its own ``ce_sum`` over the
        global token count ``W b s`` plus ``(aux + z) / W`` (aux and z are
        global on every rank); the terms sum to the global loss, and so do
        the ranks' gradients.  "loss" and "ce" in the metrics are the
        rank's terms too (``training`` sums them).  Under a pipeline plan
        the stack is :func:`core.pipeline.pipelined_stack_forward` (the CE
        on the last stage's ranks only), and "moe_aux_loss" and
        "moe_z_loss" are the rank's terms as well."""
        if self.pipelined:
            return self._pipelined_loss(params, batch)
        params = self._whole(params)
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        x, aux, loads = transformer.stack_forward(
            params["blocks"], x, self.arch,
            positions=self._seq_positions(b, s, x.device), train=True, plan=self.plan,
            telemetry=self.telemetry)
        total_ce = self._chunked_ce(params, x, batch["labels"].long())
        w = self.world
        ce = total_ce / (b * s * w)
        total = ce + aux["moe_aux_loss"] / w + aux["moe_z_loss"] / w
        metrics = {"loss": total, "ce": ce, "moe_aux_loss": aux["moe_aux_loss"],
                   "moe_z_loss": aux["moe_z_loss"], "expert_load": loads}
        return total, metrics

    def _chunked_ce(self, params, x, labels) -> torch.Tensor:
        b, s = x.shape[:2]
        D, n = (1, 1) if self.plan is None else (self.plan.dp, self.plan.seq_size)
        nc = self._loss_chunks(b * D, s * n)
        if nc <= 1:
            return self._ce_sum(params, x, labels)
        sc = s // nc
        total_ce = x.new_zeros((), dtype=torch.float32)
        for i in range(nc):
            part = slice(i * sc, (i + 1) * sc)
            total_ce = total_ce + checkpoint(
                self._ce_sum, params, x[:, part], labels[:, part], use_reentrant=False)
        return total_ce

    # -- pipelined training (core.pipeline) -----------------------------------

    def _pipelined_loss(self, params, batch):
        """This rank's term of the pipelined loss: the CE of its block of the
        last stage's output over the global token count, plus its terms of
        aux and z (``pipelined_stack_forward``)."""
        from repro_torch.core import pipeline

        params = self._whole(params)
        inputs, embed_fn = self._pipeline_inputs(params, batch)
        y, aux, z, loads = pipeline.pipelined_stack_forward(
            params["blocks"], inputs, self.arch, self.plan, embed_fn=embed_fn,
            embed_params=params["embed"], telemetry=self.telemetry)
        n, s = inputs.shape[:2]
        b = n * self.plan.stage_size
        ce = (self._chunked_ce(params, y, batch["labels"].long()) / (b * s) if y is not None
              else aux.new_zeros(()))
        total = ce + aux + z
        return total, {"loss": total, "ce": ce, "moe_aux_loss": aux, "moe_z_loss": z,
                       "expert_load": loads}

    def _head_params(self, params):
        hp = {"final_norm": params["final_norm"]}
        if not self.arch.tie_embeddings:
            hp["lm_head"] = params["lm_head"]
        return hp

    def _make_head_fn(self):
        """The per-microbatch loss head of the schedule-executing pipeline:
        (head_params, embed, y (b_l, s, d), labels) -> summed CE (the final
        norm, the tied or untied head)."""
        def head_fn(head_params, embed, y, labels):
            return self._ce_sum({**head_params, "embed": embed}, y, labels.long())

        return head_fn

    def loss_and_grads(self, params, batch, *, schedule=None, vstages=None,
                       gather_traces: bool = True):
        """Pipelined loss AND gradients under a schedule IR
        (``plan.schedule``/``plan.vstages`` unless overridden; the stage's
        chunks are cut for the plan's depth, so an override keeps it):
        ``core.pipeline.pipelined_step`` on this rank's rows ``batch``, the
        training path for pipeline plans, whose executed op order is the
        schedule's, not autograd's.

        Returns (loss, grads, metrics): the global loss; gradients in the
        params' tree (this rank's shard, None for integer tables), summed
        over their groups (``sharding.reduce_grads_``); "ce", "moe_aux_loss",
        "moe_z_loss" global, "expert_load" (reps, n_moe_positions, E)
        gathered over the pp group, and the executed (PP, T) traces
        ``pipeline_occupancy``, ``pipeline_wstash_occupancy`` and
        ``pipeline_comm_inflight``, comparable 1:1 with the IR's
        ``occupancy_trace``, ``wstash_trace`` and ``comm_trace`` (without
        ``gather_traces``: this stage's (T,) rows, and no collective); beside
        them ``pipeline_stats`` (this rank's hand-offs sent, their wire
        bytes, the residual-slot bytes and the schedule)."""
        from repro_torch.convert import _unstage_chunks
        from repro_torch.core import pipeline

        plan = self.plan
        if not self.pipelined:
            raise ValueError("loss_and_grads needs a pipeline plan (plan.pp > 1)")
        # A sliced embedding (and head) is gathered once a step; the
        # executor sums its whole gradient over microbatches, and its
        # gather's backward runs here, once: on every rank, also where
        # precomputed ``embeds`` leave it 0 (a tied head aside).
        with torch.no_grad():
            top = self._whole(params)
            inputs, embed_fn = self._pipeline_inputs(top, batch)
        (ce, aux, z), g, traces, stats = pipeline.pipelined_step(
            params["blocks"], inputs, batch["labels"], self.arch, plan,
            head_fn=self._make_head_fn(), head_params=self._head_params(top),
            embed_fn=embed_fn, embed_params=top["embed"], schedule=schedule,
            vstages=vstages, telemetry=self.telemetry)
        grads = {"embed": g["embed"], "blocks": g["blocks"],
                 "final_norm": g["head"]["final_norm"]}
        if not self.arch.tie_embeddings:
            grads["lm_head"] = g["head"]["lm_head"]
        for k, axes in plan.layout.items():
            if k in ("embed", "lm_head") and k in grads:
                grads[k] = sharding.reduce_slice(grads[k], axes, plan)
        sharding.reduce_grads_(grads, plan)
        # aux and z are the same on every rank of a stage: one counts them.
        own = 1.0 if plan.stage_rank == 0 else 0.0
        terms = sharding.all_reduce_(torch.stack([ce, aux * own, z * own]),
                                     plan.world_group)
        M = plan.num_microbatches
        n, s = inputs.shape[:2]
        ce_mean = terms[0] / (n * plan.stage_size * s)
        loss = ce_mean + terms[1] / M + terms[2] / M
        occ = torch.stack(traces)  # (3, T) on the host
        if gather_traces:
            occ = occ.to(inputs.device)
            parts = [torch.empty_like(occ) for _ in range(plan.pp)]
            torch.distributed.all_gather(parts, occ, group=plan.pp_group)
            occ = torch.stack(parts, dim=1).cpu()  # (3, PP, T)
        occ = occ.numpy()
        loads = stats.pop("loads")
        metrics = {"loss": loss, "ce": ce_mean, "moe_aux_loss": terms[1] / M,
                   "moe_z_loss": terms[2] / M,
                   "expert_load": None if loads is None else _unstage_chunks(loads, plan),
                   "pipeline_occupancy": occ[0], "pipeline_wstash_occupancy": occ[1],
                   "pipeline_comm_inflight": occ[2], "pipeline_stats": stats}
        return loss, grads, metrics

    # -- paged serving (continuous batching) --------------------------------

    def init_paged_cache(self, layout: kv_lib.PagedLayout, dtype=torch.bfloat16,
                         device=None):
        """One {"k","v"} page pool per pattern position, each shaped
        (reps, num_blocks, block_size, kv_heads, head_dim).  SSM mixers
        have no paged form (their state is O(1) in context): they are
        refused, as in the reference."""
        device = resolve_device(device)
        a = self.arch
        for mixer, _ in a.block_pattern:
            if not mixer.startswith("attn"):
                raise NotImplementedError(
                    f"paged serving supports attention mixers only, got "
                    f"{mixer!r} in {a.name}")
        return tuple(kv_lib.init_pages(layout, self.reps, a.num_kv_heads,
                                       a.head_dim, dtype, device)
                     for _ in a.block_pattern)

    def _layers(self, params):
        for r in range(self.reps):
            for pos, blk in enumerate(self.arch.block_pattern):
                yield r, pos, blk, transformer.rep_params(params["blocks"][pos], r)

    def prefill_paged(self, params, batch, cache, block_table, lengths):
        """Prompt forward that writes K/V into the paged cache (in place).

        batch: {"tokens": (b, s_pad)} (or a frontend's {"embeds": (b, s_pad,
        d)}) right-padded prompts; lengths: (b,)
        true prompt lengths; block_table: (b, nb).  Pad rows never reach the
        pages.  Returns (last-valid-position logits (b, vp), cache).  Every
        rank of a data group runs every prompt whole and writes its pages,
        whatever b (the engine's prefill batch is one request, which the
        reference's rule replicates too), so a slot's pages are whole on the
        rank that later decodes it (:meth:`decode_step_paged`).
        """
        params = self._whole(params)
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        positions = self._positions(b, s, x.device)
        N, bs = cache[0]["k"].shape[1:3]
        write = kv_lib.write_plan(block_table, torch.zeros_like(lengths), s, N, bs,
                                  count=lengths)
        for r, pos, blk, p in self._layers(params):
            x, _, nc = transformer.apply_block(blk, p, x, self.arch,
                                               positions=positions,
                                               return_cache=True, plan=self.plan,
                                               seq_shard=True)
            kv_lib.scatter_rows(cache[pos]["k"][r], write, nc["k"])
            kv_lib.scatter_rows(cache[pos]["v"][r], write, nc["v"])
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        idx = (lengths.to(x.device).long() - 1).clamp(0, s - 1)
        xt = x[torch.arange(b, device=x.device), idx][:, None]  # (b, 1, d)
        return self._head(params, xt)[:, 0], cache

    def _data_share(self, b: int):
        """This rank's rows of a decode batch of ``b`` rows: ``b / D``
        consecutive rows of its data group when D divides b, else all of
        them (the reference's rule: the batch dim is sharded over the data
        axes when it divides them).  Returns (rows slice, whether split)."""
        plan = self.plan
        D = 1 if plan is None else plan.dp
        if D == 1 or b % D:
            return slice(0, b), False
        bl = b // D
        d = plan.coords[0]
        return slice(d * bl, (d + 1) * bl), True

    def decode_step_paged(self, params, cache, block_table, lengths, batch, *,
                          return_loads: bool = False):
        """One continuous-batching decode step over all sequence slots.

        batch: {"tokens": (b, 1)} or {"embeds": (b, 1, d)}; lengths: (b,)
        cache fills (positions of the new tokens); block_table: (b, nb).
        Inactive slots (sentinel rows) write nothing and give logits the
        engine ignores.  Returns
        (logits (b, vp), cache), the cache updated in place, and with
        ``return_loads`` the MoE layers' logical expert counts (reps,
        n_moe_positions, E) too (the serving rebalancer's load feed).

        Over a data group of D > 1 ranks that divides b, each rank decodes
        its share of the rows (:meth:`_data_share`): it writes those rows'
        K/V into its own page pool and reads them back there (a slot's
        pages are read only by the rank whose share holds the slot, and
        every rank writes a prefill's), and the logits are all-gathered
        over the data group, so every rank samples the same tokens.
        """
        rows, split = self._data_share(lengths.shape[0])
        if split:
            block_table, lengths = block_table[rows], lengths[rows]
            batch = {k: v[rows] for k, v in batch.items()}
        params = self._whole(params)
        x = self._embed(params, batch)
        positions = lengths.long()[:, None]
        N, bs = cache[0]["k"].shape[1:3]
        write = kv_lib.write_plan(block_table, lengths, 1, N, bs)
        loads = [[] for _ in range(self.reps)]
        for r, pos, blk, p in self._layers(params):
            pc = {"k_pages": cache[pos]["k"][r], "v_pages": cache[pos]["v"][r],
                  "block_table": block_table, "lengths": lengths.long()}
            x, mets, _ = transformer.apply_block(blk, p, x, self.arch,
                                                 positions=positions, cache=pc,
                                                 write=write, plan=self.plan,
                                                 token_sharded=False, data_split=split)
            if mets:
                loads[r].append(mets["expert_load"])
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        logits = self._gather_rows(self._head(params, x)[:, 0], split)
        if return_loads:
            return logits, cache, torch.stack([torch.stack(l) for l in loads])
        return logits, cache

    # -- dense-cache serving -------------------------------------------------

    def _serving_plan(self):
        """The plan of the dense-cache steps: None at world 1; a pipeline
        plan is refused (the serving steps are not pipelined)."""
        if self.pipelined:
            raise ValueError("the dense-cache serving steps are not pipelined (plan.pp > 1)")
        return self.plan if self.world > 1 else None

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16, device=None):
        """One dense cache per pattern position, leaves stacked (reps, ...):
        {"k", "v"} (reps, batch, cache_len, kv_heads, head_dim) for an
        attention mixer, {"ssm", "conv_x", "conv_B", "conv_C"} for a mamba
        mixer (whose state does not grow with ``cache_len``).  Zeros,
        allocated (``decode_step`` updates them in place).  Under a plan,
        this rank's block of the reference's ``cache_specs`` for a
        ``batch``-row decode: its rows over data where D divides ``batch``
        (:meth:`_data_share`), and an attention cache's positions over (ep,
        tp) where ep * tp divides ``cache_len`` (a :class:`KVBlock`;
        ``sharding.MeshPlan.kv_rows``), the SSM state whole over them."""
        device = resolve_device(device)
        a = self.arch
        plan = self._serving_plan()
        rows, _ = self._data_share(batch)
        b = rows.stop - rows.start
        n = cache_len if plan is None else plan.kv_rows(cache_len)[1]
        caches = []
        for mixer, _ in a.block_pattern:
            if mixer.startswith("attn"):
                shape = (self.reps, b, n, a.num_kv_heads, a.head_dim)
                k, v = (torch.zeros(shape, dtype=dtype, device=device) for _ in "kv")
                caches.append(KVBlock(k, v, cache_len) if n != cache_len else {"k": k, "v": v})
            else:
                c = ssm_lib.init_ssm_cache(a, b, dtype, device)
                caches.append({k: v[None].repeat((self.reps,) + (1,) * v.dim())
                               for k, v in c.items()})
        return tuple(caches)

    def prefill(self, params, batch):
        """Forward over a prompt (one length for the whole batch), emitting
        (last-position logits (b, vp), cache): one dict per pattern position,
        leaves stacked (reps, ...): the prompt's K/V (reps, b, s, kv, hd) for
        an attention mixer (the reference's ``return_kv``; pad it to a
        ``cache_len`` to decode on, as ``init_cache`` sizes one), the SSM
        cache for a mamba mixer.

        Under a plan ``batch`` is this rank's block of the global batch
        (``training.shard_batch``, the reference's prefill ``batch_specs``:
        its rows over data, its sequence slice over (ep, tp)), and the
        layers run as in training without autograd: attention gathers K/V
        over the sequence group and keeps q local (the flash kernel's
        ``q_offset``), a Mamba2 mixer scans its slice and takes the state
        entering it from the ranks before (``ssm.mamba_block``), the MoE
        dispatches the rank's own tokens.  The cache is the rank's
        block: its K/V slice (:meth:`pad_cache` lays it out for decode),
        the whole sequence's SSM state and conv tails.  The last position
        lives on the sequence group's last rank: its logits are broadcast
        over the group, then all-gathered over data, so every rank returns
        the whole batch's (b, vp)."""
        plan = self._serving_plan()
        params = self._whole(params)
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        positions = self._seq_positions(b, s, x.device)
        caches = [[] for _ in self.arch.block_pattern]
        for _, pos, blk, p in self._layers(params):
            x, _, nc = transformer.apply_block(blk, p, x, self.arch, positions=positions,
                                               return_cache=True, plan=self.plan, seq=plan)
            caches[pos].append(nc)
        cache = tuple({k: torch.stack([c[k] for c in per_rep]) for k in per_rep[0]}
                      for per_rep in caches)
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        if plan is None:
            return self._head(params, x[:, -1:])[:, 0], cache
        n = plan.seq_size
        if plan.seq_rank == n - 1:
            logits = self._head(params, x[:, -1:])[:, 0].contiguous()
        else:
            logits = torch.empty((b, self.vp), dtype=torch.float32, device=x.device)
        if plan.model_group is not None:
            torch.distributed.broadcast(logits, src=plan.rank - plan.seq_rank + n - 1,
                                        group=plan.model_group)
        return self._gather_rows(logits, plan.dp > 1), cache

    def _gather_rows(self, logits, split: bool):
        """The whole batch's logits from this data rank's rows: all-gathered
        over the data group where the rows are split."""
        if not split:
            return logits
        parts = [torch.empty_like(logits) for _ in range(self.plan.dp)]
        torch.distributed.all_gather(parts, logits.contiguous(), group=self.plan.dp_group)
        return torch.cat(parts)

    def pad_cache(self, cache, cache_len: int):
        """A prefill's cache made ready to decode on: each attention
        position's K/V copied into zeros of ``cache_len`` rows (the padding
        the reference's callers do by hand); mamba positions as they are.

        Under a plan whose sequence group split the prefill, each rank's
        K/V are its slice of the prompt's positions; they are all-gathered
        over the group one layer at a time (K and V in one collective, so
        one layer's whole K/V is live at once), padded, and the rank keeps
        its "kv_seq" block of the ``cache_len`` rows (:meth:`init_cache`'s
        layout: a :class:`KVBlock`, or the whole cache where ep * tp does
        not divide ``cache_len``)."""
        plan = self._serving_plan()
        n = 1 if plan is None else plan.seq_size
        out = []
        for (mixer, _), c in zip(self.arch.block_pattern, cache):
            if mixer.startswith("attn"):
                s = c["k"].shape[2] * n
                if s > cache_len:
                    raise ValueError(f"a prompt of {s} tokens does not fit {cache_len} rows")
                if n == 1:
                    c = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, cache_len - s))
                         for k, v in c.items()}
                else:
                    c = self._kv_block_of(c, s, cache_len)
            out.append(c)
        return tuple(out)

    def _kv_block_of(self, c, s: int, cache_len: int):
        """This rank's "kv_seq" block of a ``cache_len``-row cache whose
        first ``s`` rows are the prompt's K/V, of which ``c`` holds the
        rank's sequence slice (:meth:`pad_cache`)."""
        plan = self.plan
        first, rows = plan.kv_rows(cache_len)
        reps, b, _, kv, hd = c["k"].shape
        k = c["k"].new_zeros((reps, b, rows, kv, hd))
        v = torch.zeros_like(k)
        lo, hi = min(first, s), min(first + rows, s)
        for r in range(reps):
            whole = sharding.seq_gather(torch.cat([c["k"][r], c["v"][r]], dim=-1), plan)
            k[r, :, :hi - lo], v[r, :, :hi - lo] = whole[:, lo:hi].split(hd, dim=-1)
            del whole
        return KVBlock(k, v, cache_len) if rows != cache_len else {"k": k, "v": v}

    def decode_step(self, params, cache, batch, index: int):
        """One token: batch {"tokens": (b, 1)} or {"embeds": (b, 1, d)};
        ``index``: the current cache
        fill, a Python int (the new token's position: its RoPE position and
        the row each attention layer writes; it reads rows [0, index]).
        Returns (logits (b, vp), cache), the cache updated IN PLACE (the
        reference returns a new one).  An index past an attention cache's
        end raises before any layer runs (the reference clamps it and
        overwrites the last row).

        Under a plan ``batch`` is the whole batch and ``cache`` this rank's
        block (:meth:`init_cache`, :meth:`pad_cache`): the rank decodes its
        rows over data where D divides b (:meth:`_data_share`, the
        reference's decode ``batch_specs``) against its block, an attention
        layer over a :class:`KVBlock` writing the new row on the rank that
        holds it and combining the softmax over the ranks' rows over the
        sequence group (``layers.kv_block_attention``); the MoE runs
        weight-parallel as in paged decode, and the logits are all-gathered
        over data, so every rank returns the whole batch's."""
        index = operator.index(index)
        plan = self._serving_plan()
        for (mixer, _), c in zip(self.arch.block_pattern, cache):
            if not mixer.startswith("attn"):
                continue
            n = c.cache_len if isinstance(c, KVBlock) else c["k"].shape[2]
            if plan is not None and not isinstance(c, KVBlock) and plan.kv_rows(n)[1] != n:
                raise ValueError(
                    f"a whole {n}-row attention cache under a sequence group of "
                    f"{plan.seq_size}, which splits {n} rows: a KVBlock that a map made a "
                    f"plain dict? (init_cache / pad_cache / map_tree keep the layout)")
            if not 0 <= index < n:
                raise ValueError(f"decode index {index} past the cache's {n} rows")
        rows, split = self._data_share(next(iter(batch.values())).shape[0])
        held = next(iter(cache[0].values())).shape[1]
        if held != rows.stop - rows.start:
            raise ValueError(f"the cache holds {held} rows, this rank's share of the batch "
                             f"{rows.stop - rows.start} (init_cache / pad_cache of the batch)")
        if split:
            batch = {k: v[rows] for k, v in batch.items()}
        params = self._whole(params)
        x = self._embed(params, batch)
        positions = torch.full((x.shape[0], 1), index, dtype=torch.long, device=x.device)
        for r, pos, blk, p in self._layers(params):
            c = cache[pos]
            x, _, _ = transformer.apply_block(
                blk, p, x, self.arch, positions=positions,
                cache={k: v[r] for k, v in c.items()}, cache_index=index,
                plan=self.plan, token_sharded=False, data_split=split,
                seq=plan if isinstance(c, KVBlock) else None)
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        return self._gather_rows(self._head(params, x)[:, 0], split), cache


def tree_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """Flat {"a/b/0/c": leaf} view of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


__all__ = ["KVBlock", "LanguageModel", "ParamMeta", "VOCAB_PAD_MULTIPLE", "init_params",
           "logical_tags", "map_tree", "param_tree", "tree_paths"]
