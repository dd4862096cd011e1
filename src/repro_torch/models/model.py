"""Language model: parameter tree, init, forward, training loss, paged
serving steps (attention) and dense-cache serving steps (Mamba2).

The port of ``repro.models.model``.  The parameter tree has the JAX
package's paths and leaf shapes: ``{"embed", "blocks": (one dict per
pattern position, leaves stacked (reps, ...)), "final_norm"[, "lm_head"]}``,
so ``repro_torch.convert`` maps one onto the other leaf by leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.models.layers import rms_norm, softcap
from repro_torch.serving import kv_cache as kv_lib

VOCAB_PAD_MULTIPLE = 256
# Where a dense attention cache stands (ROADMAP.md, Queue 1).
DENSE_ATTN_CACHE_TODO = ("the dense cache holds mamba mixers only; attention in "
                         "it (jamba and other hybrids) is not ported yet "
                         "(ROADMAP.md Queue 1, item 5: Jamba)")


# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | embed | zeros | ones | arange | a_log | dt_bias
    fan_in: int = 0

    def stacked(self, reps: int) -> "ParamMeta":
        return ParamMeta((reps,) + self.shape, self.init, self.fan_in)


def _attn_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    d, hq, hkv = a.d_model, a.q_dim, a.kv_dim
    return {
        "wq": ParamMeta((d, hq), fan_in=d),
        "wk": ParamMeta((d, hkv), fan_in=d),
        "wv": ParamMeta((d, hkv), fan_in=d),
        "wo": ParamMeta((hq, d), fan_in=hq),
    }


def _dense_ffn_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    d, f = a.d_model, a.d_ff
    t = {"w_up": ParamMeta((d, f), fan_in=d), "w_down": ParamMeta((f, d), fan_in=f)}
    if a.ffn_activation == "swiglu":
        t["w_gate"] = ParamMeta((d, f), fan_in=d)
    return t


def _moe_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    m = a.moe
    d, f, E = a.d_model, m.d_ff, m.num_experts
    t = {
        "w_router": ParamMeta((d, E), fan_in=d),
        "w_up": ParamMeta((E, d, f), fan_in=d),
        "w_down": ParamMeta((E, f, d), fan_in=f),
        # logical expert -> physical slot routing table (int32)
        "assignment": ParamMeta((E,), init="arange"),
    }
    if a.ffn_activation == "swiglu":
        t["w_gate"] = ParamMeta((E, d, f), fan_in=d)
    return t


def _mamba_tree(a: ArchConfig) -> Dict[str, ParamMeta]:
    s = a.ssm
    d = a.d_model
    d_in = s.expand * d
    gn = s.n_groups * s.state_size
    nh = s.num_heads(d)
    w = s.conv_width
    return {
        "w_z": ParamMeta((d, d_in), fan_in=d),
        "w_x": ParamMeta((d, d_in), fan_in=d),
        "w_B": ParamMeta((d, gn), fan_in=d),
        "w_C": ParamMeta((d, gn), fan_in=d),
        "w_dt": ParamMeta((d, nh), fan_in=d),
        "conv_x_w": ParamMeta((d_in, w), fan_in=w),
        "conv_x_b": ParamMeta((d_in,), init="zeros"),
        "conv_B_w": ParamMeta((gn, w), fan_in=w),
        "conv_B_b": ParamMeta((gn,), init="zeros"),
        "conv_C_w": ParamMeta((gn, w), fan_in=w),
        "conv_C_b": ParamMeta((gn,), init="zeros"),
        "A_log": ParamMeta((nh,), init="a_log"),
        "D": ParamMeta((nh,), init="ones"),
        "dt_bias": ParamMeta((nh,), init="dt_bias"),
        "norm_scale": ParamMeta((d_in,), init="zeros"),
        "out_proj": ParamMeta((d_in, d), fan_in=d_in),
    }


def _block_tree(a: ArchConfig, block) -> Dict[str, Any]:
    mixer, ffn = block
    t: Dict[str, Any] = {"norm_mixer": ParamMeta((a.d_model,), init="zeros")}
    if mixer.startswith("attn"):
        t["mixer"] = _attn_tree(a)
    elif mixer == "mamba":
        t["mixer"] = _mamba_tree(a)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn != "none":
        t["norm_ffn"] = ParamMeta((a.d_model,), init="zeros")
        t["ffn"] = _dense_ffn_tree(a) if ffn == "dense" else _moe_tree(a)
    return t


def map_tree(fn, tree, *, with_path: bool = False, _prefix: str = ""):
    """``fn`` applied to every leaf of a nested dict/tuple tree; with
    ``with_path`` it is called as ``fn(path, leaf)``, the path spelled as
    :func:`tree_paths` spells it."""
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: map_tree(fn, v, with_path=with_path,
                           _prefix=f"{_prefix}/{k}" if _prefix else str(k))
               for k, v in items}
        return out if isinstance(tree, dict) else tuple(out.values())
    return fn(_prefix, tree) if with_path else fn(tree)


def param_tree(a: ArchConfig) -> Dict[str, Any]:
    reps = a.num_layers // len(a.block_pattern)
    vp = a.padded_vocab(VOCAB_PAD_MULTIPLE)
    tree: Dict[str, Any] = {
        "embed": ParamMeta((vp, a.d_model), init="embed"),
        "blocks": tuple(map_tree(lambda m: m.stacked(reps), _block_tree(a, blk))
                        for blk in a.block_pattern),
        "final_norm": ParamMeta((a.d_model,), init="zeros"),
    }
    if not a.tie_embeddings:
        tree["lm_head"] = ParamMeta((a.d_model, vp), fan_in=a.d_model)
    return tree


def _init_leaf(meta: ParamMeta, gen: torch.Generator, device, dtype):
    if meta.init == "arange":
        return torch.arange(meta.shape[-1], dtype=torch.int32,
                            device=device).expand(meta.shape).contiguous()
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


class LanguageModel:
    """An ArchConfig's forward, training loss and serving steps (whatever
    device the params live on): paged for attention mixers, a dense
    per-layer cache for mamba mixers.

    With a ``sharding.MeshPlan`` the MoE layers run expert-parallel over its
    ranks, on params that hold this rank's expert slots
    (``convert.shard_params``): ``forward`` and ``loss`` take this rank's
    own sequences (token-sharded), the paged serving steps take the same
    requests on every rank (prefill: each rank's sequence shard of every MoE
    layer's input; decode: weight-parallel).  ``plan=None`` is one rank.
    ``telemetry`` (an ``obs.Telemetry``) gets the MoE layers' ``a2a.layer``
    spans in ``forward`` and ``loss``."""

    def __init__(self, arch: ArchConfig, plan=None, telemetry=None):
        self.arch = arch
        self.plan = plan
        self.telemetry = telemetry
        self.world = 1 if plan is None else plan.world
        self.vp = arch.padded_vocab(VOCAB_PAD_MULTIPLE)
        self.reps = arch.num_layers // len(arch.block_pattern)

    # -- embedding / head ---------------------------------------------------

    def _embed(self, params, batch) -> torch.Tensor:
        return params["embed"][batch["tokens"].long()]

    def _logits(self, w, x) -> torch.Tensor:
        logits = (x @ w.to(x.dtype)).float()
        logits = softcap(logits, self.arch.final_logit_softcap)
        pad = torch.arange(self.vp, device=x.device) < self.arch.vocab_size
        return torch.where(pad, logits, -1e30)

    def _head(self, params, x) -> torch.Tensor:
        w = params["embed"].T if self.arch.tie_embeddings else params["lm_head"]
        return self._logits(w, x)

    @staticmethod
    def _positions(b: int, s: int, device) -> torch.Tensor:
        return torch.arange(s, device=device)[None].expand(b, s)

    # -- forward ------------------------------------------------------------

    def forward(self, params, batch):
        """Uncached forward: (logits (b, s, vp) fp32, {"moe_aux_loss",
        "moe_z_loss"}, expert loads)."""
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        x, aux, loads = transformer.stack_forward(
            params["blocks"], x, self.arch, positions=self._positions(b, s, x.device),
            plan=self.plan, telemetry=self.telemetry)
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        return self._head(params, x), aux, loads

    # -- training loss --------------------------------------------------------

    def _loss_chunks(self, b: int, s: int) -> int:
        """Chunk the CE loss so the fp32 logits stay <= ~128 MB: the
        reference's rule with one device (no data or sequence shards to
        divide the tokens by)."""
        tokens = max(b * s, 1)
        target_tokens = max(int(128e6 // (self.vp * 4)), 1)
        need = max(1, -(-tokens // target_tokens))
        for nc in range(need, min(s, 256) + 1):  # a divisor of s, capped
            if s % nc == 0:
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

        Over W ranks, each holding b whole sequences, it is this rank's term
        of the global loss ``ce_sum / (W b s) + aux + z``: its own ``ce_sum``
        over the global token count plus ``(aux + z) / W`` (aux and z are
        global on every rank); the terms sum to the global loss, and so do
        the ranks' gradients.  "loss" and "ce" in the metrics are the
        rank's terms too (``training`` sums them)."""
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        x, aux, loads = transformer.stack_forward(
            params["blocks"], x, self.arch,
            positions=self._positions(b, s, x.device), train=True, plan=self.plan,
            telemetry=self.telemetry)
        labels = batch["labels"].long()
        nc = self._loss_chunks(b, s)
        if nc <= 1:
            total_ce = self._ce_sum(params, x, labels)
        else:
            sc = s // nc
            total_ce = x.new_zeros((), dtype=torch.float32)
            for i in range(nc):
                part = slice(i * sc, (i + 1) * sc)
                total_ce = total_ce + checkpoint(
                    self._ce_sum, params, x[:, part], labels[:, part],
                    use_reentrant=False)
        w = self.world
        ce = total_ce / (b * s * w)
        total = ce + aux["moe_aux_loss"] / w + aux["moe_z_loss"] / w
        metrics = {"loss": total, "ce": ce, "moe_aux_loss": aux["moe_aux_loss"],
                   "moe_z_loss": aux["moe_z_loss"], "expert_load": loads}
        return total, metrics

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

        batch: {"tokens": (b, s_pad)} right-padded prompts; lengths: (b,)
        true prompt lengths; block_table: (b, nb).  Pad rows never reach the
        pages.  Returns (last-valid-position logits (b, vp), cache).
        """
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

    def decode_step_paged(self, params, cache, block_table, lengths, batch):
        """One continuous-batching decode step over all sequence slots.

        batch: {"tokens": (b, 1)}; lengths: (b,) cache fills (positions of
        the new tokens); block_table: (b, nb).  Inactive slots (sentinel
        rows) write nothing and give logits the engine ignores.  Returns
        (logits (b, vp), cache), the cache updated in place.
        """
        x = self._embed(params, batch)
        positions = lengths.long()[:, None]
        N, bs = cache[0]["k"].shape[1:3]
        write = kv_lib.write_plan(block_table, lengths, 1, N, bs)
        for r, pos, blk, p in self._layers(params):
            pc = {"k_pages": cache[pos]["k"][r], "v_pages": cache[pos]["v"][r],
                  "block_table": block_table, "lengths": lengths.long()}
            x, _, _ = transformer.apply_block(blk, p, x, self.arch,
                                              positions=positions, cache=pc,
                                              write=write, plan=self.plan,
                                              token_sharded=False)
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        return self._head(params, x)[:, 0], cache

    # -- dense-cache serving (mamba mixers) ----------------------------------

    def _dense_cache_only(self) -> None:
        if any(m != "mamba" for m, _ in self.arch.block_pattern):
            raise NotImplementedError(DENSE_ATTN_CACHE_TODO)

    def init_cache(self, batch: int, dtype=torch.bfloat16, device=None):
        """One dense cache per pattern position, leaves stacked (reps, ...):
        {"ssm", "conv_x", "conv_B", "conv_C"} for a mamba mixer.  Zeros,
        allocated (``decode_step`` updates them in place).  Attention
        mixers, whose cache the reference sizes by a ``cache_len``, are not
        ported and raise."""
        device = resolve_device(device)
        self._dense_cache_only()
        caches = []
        for _ in self.arch.block_pattern:
            c = ssm_lib.init_ssm_cache(self.arch, batch, dtype, device)
            caches.append({k: v[None].repeat((self.reps,) + (1,) * v.dim())
                           for k, v in c.items()})
        return tuple(caches)

    def prefill(self, params, batch):
        """Forward over a prompt (one length for the whole batch), emitting
        (last-position logits (b, vp), cache): one dict per pattern position,
        leaves stacked (reps, ...) as ``init_cache`` makes them."""
        self._dense_cache_only()
        x = self._embed(params, batch)
        caches = [[] for _ in self.arch.block_pattern]
        for _, pos, blk, p in self._layers(params):
            x, _, nc = transformer.apply_block(blk, p, x, self.arch, positions=None,
                                               return_cache=True)
            caches[pos].append(nc)
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, tuple({k: torch.stack([c[k] for c in per_rep])
                              for k in per_rep[0]} for per_rep in caches)

    def decode_step(self, params, cache, batch, index):
        """One token: batch {"tokens": (b, 1)}; ``index``: the current cache
        fill, the reference's argument (the new token's position, which
        only attention mixers read).  Returns (logits (b, vp), cache), the
        cache updated IN PLACE (the reference returns a new one)."""
        self._dense_cache_only()
        x = self._embed(params, batch)
        for r, pos, blk, p in self._layers(params):
            x, _, _ = transformer.apply_block(
                blk, p, x, self.arch, positions=None,
                cache={k: v[r] for k, v in cache[pos].items()})
        x = rms_norm(x, params["final_norm"], self.arch.norm_eps)
        return self._head(params, x)[:, 0], cache


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


__all__ = ["LanguageModel", "ParamMeta", "VOCAB_PAD_MULTIPLE", "init_params",
           "map_tree", "param_tree", "tree_paths"]
