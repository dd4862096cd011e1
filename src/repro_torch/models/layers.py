"""Core transformer layers: norms, rotary embeddings, GQA attention, FFN.

Functions of tensors; parameters are plain dicts, as in the JAX package.
Prefill attention runs the flash kernel (``kernels.flash_attention``);
decode, paged (gathering its pages) or over a dense cache, runs the eager
``attention`` here, which the JAX package likewise leaves to XLA.
Training runs the eager ``attention`` with autograd too: the flash kernel
has no backward, in the JAX package or here.
"""

from __future__ import annotations

import math
import operator
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.serving import kv_cache as kv_lib

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, h, d); positions: (b, s) int.  Split-half rotation."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> tuple:
    """Qwen2-VL M-RoPE: the d/2 rotary frequencies split into (temporal,
    height, width) sections; the published split is (16, 24, 24) at head
    dim 128, generalized proportionally for other dims."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, h, d); positions: (3, b, s) int, the (t, h, w) position
    ids.  Each frequency takes its position from its section's plane; with
    three equal planes (text) this is :func:`apply_rope` exactly."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    plane = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                       for i, n in enumerate(mrope_sections(x.shape[-1]))])  # (d/2,)
    pos = positions[plane].permute(1, 2, 0).float()  # (b, s, d/2)
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positional_embed(x, positions, rope_type: str, theta: float):
    if rope_type == "rope":
        return apply_rope(x, positions, theta)
    if rope_type == "mrope":
        return apply_mrope(x, positions[None].expand((3,) + positions.shape), theta)
    if rope_type == "none":
        return x
    raise ValueError(rope_type)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _causal_mask(s_q: int, s_k: int, *, q_offset: int, window: Optional[int],
                 device=None) -> torch.Tensor:
    """Boolean (s_q, s_k) mask; q_offset shifts query positions."""
    q_pos = torch.arange(s_q, device=device)[:, None] + q_offset
    k_pos = torch.arange(s_k, device=device)[None, :]
    m = k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def _causal_mask_batched(b: int, s_q: int, s_k: int, *, q_offset, window,
                         kv_len, device=None) -> torch.Tensor:
    """(b, s_q, s_k) mask for per-sequence offsets/lengths (continuous-
    batching decode); ``q_offset``/``kv_len`` are ints or (b,) tensors."""
    q_off = torch.as_tensor(q_offset, device=device).to(torch.int64).expand(b)
    q_pos = torch.arange(s_q, device=device)[None, :, None] + q_off[:, None, None]
    k_pos = torch.arange(s_k, device=device)[None, None, :]
    m = k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=device).to(torch.int64).expand(b)
        m &= k_pos < kl[:, None, None]
    return m


def attention(q, k, v, *, q_offset=0, window: Optional[int] = None,
              logit_softcap: Optional[float] = None, kv_len=None,
              q_chunks: int = 1) -> torch.Tensor:
    """Reference GQA attention (fp32 scores and softmax).

    q (b, s_q, hq, d), k/v (b, s_k, hkv, d).  ``kv_len`` masks cache slots
    beyond the current length during decode; ``q_offset``/``kv_len`` as
    (b,) tensors give each sequence its own fill.  ``q_chunks > 1``
    evaluates query blocks one after another (softmax is row-wise, so this
    is exact), bounding the score temp to (b, h, s_q/q_chunks, s_k).
    """
    b, s_q, hq, d = q.shape
    if q_chunks > 1 and s_q % q_chunks == 0:
        qc = s_q // q_chunks
        return torch.cat([
            attention(q[:, i * qc:(i + 1) * qc], k, v, q_offset=q_offset + i * qc,
                      window=window, logit_softcap=logit_softcap, kv_len=kv_len)
            for i in range(q_chunks)
        ], dim=1)
    hkv = k.shape[2]
    groups = hq // hkv
    qh = q.reshape(b, s_q, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float())
    scores = softcap(scores / math.sqrt(d), logit_softcap)
    per_seq = torch.is_tensor(q_offset) or torch.is_tensor(kv_len)
    if per_seq:
        mask = _causal_mask_batched(b, s_q, k.shape[1], q_offset=q_offset,
                                    window=window, kv_len=kv_len, device=q.device)
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    else:
        mask = _causal_mask(s_q, k.shape[1], q_offset=q_offset, window=window,
                            device=q.device)
        if kv_len is not None:
            mask &= (torch.arange(k.shape[1], device=q.device) < kv_len)[None, :]
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, s_q, hq, d)


def attention_proj(params, x, cfg, positions, *, window=None, cache=None,
                   cache_index=None, write=None, return_kv=False, train=False, seq=None):
    """Full attention sub-layer: QKV proj -> rope -> attention -> out proj.

    ``cache=None`` (prefill / uncached forward): the flash kernel, and with
    ``return_kv`` the freshly computed K/V come back as ``{"k", "v"}``.
    ``train=True`` (no cache): the eager ``attention`` instead, which
    autograd differentiates, q-chunked at s >= 1024 as the reference's XLA
    branch is.
    ``cache`` = {"k_pages", "v_pages", "block_table", "lengths"} (paged
    decode): the new K/V rows are written into their pages IN PLACE through
    ``write`` (a :class:`repro_torch.serving.kv_cache.WritePlan`, built here
    when not given), the prefix is gathered, and eager attention runs with
    per-sequence offsets and lengths.
    ``cache`` = {"k", "v"} (b, cache_len, kv, hd) (dense decode): the new
    rows are written at ``cache_index`` (a Python int, so no device sync)
    IN PLACE, and eager attention runs over rows ``[0, cache_index + s)``
    with ``q_offset=cache_index``.  The reference's update clamps an index
    past the end and overwrites the last row; here it raises.
    ``seq`` (no cache): a ``sharding.MeshPlan`` whose sequence group holds
    the sequence, ``x`` and ``positions`` this rank's slice of it.  In
    training K/V are gathered over the group once a layer, after RoPE
    (``sharding.seq_gather``; the reference's ``kv_gathered``, recomputed
    under remat), and q stays local with ``q_offset`` at the slice's
    start, so the causal mask, a sliding window and the softcap see global
    positions (every rank scores its queries against every key, masked,
    as each of the reference's shards does).  The serving path
    gathers q too and keeps its slice of the flash kernel's output (the
    kernel's causal mask starts at position 0).  Returns (out, new_cache).
    """
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = positional_embed(q, positions, cfg.rope_type, cfg.rope_theta)
    k = positional_embed(k, positions, cfg.rope_type, cfg.rope_theta)

    new_cache = None
    if cache is not None and "block_table" not in cache:
        idx = operator.index(cache_index)
        kv_len = idx + s
        if idx < 0 or kv_len > cache["k"].shape[1]:
            raise ValueError(f"cache_index {idx} + {s} new rows past the cache's "
                             f"{cache['k'].shape[1]} rows")
        cache["k"][:, idx:kv_len] = k
        cache["v"][:, idx:kv_len] = v
        new_cache = cache
        # Rows past kv_len are masked in the reference; here they are not read.
        out = attention(q, cache["k"][:, :kv_len], cache["v"][:, :kv_len], q_offset=idx,
                        window=window, logit_softcap=cfg.attn_logit_softcap)
    elif cache is not None:
        bt, lens = cache["block_table"], cache["lengths"]
        if write is None:
            N, bs = cache["k_pages"].shape[:2]
            write = kv_lib.write_plan(bt, lens, s, N, bs)
        kv_lib.scatter_rows(cache["k_pages"], write, k)
        kv_lib.scatter_rows(cache["v_pages"], write, v)
        new_cache = cache
        ck = kv_lib.gather_pages(cache["k_pages"], bt).to(q.dtype)
        cv = kv_lib.gather_pages(cache["v_pages"], bt).to(q.dtype)
        out = attention(q, ck, cv, q_offset=lens, window=window,
                        logit_softcap=cfg.attn_logit_softcap, kv_len=lens + s)
    else:
        split = seq is not None and seq.seq_size > 1
        off = seq.seq_offset(s) if split else 0
        if train:
            if split:  # the whole sequence's K/V
                kv = sharding.seq_gather(torch.cat([k, v], dim=-1), seq)
                k, v = kv.split(cfg.head_dim, dim=-1)
            # Bound the fp32 score temp to ~512 query rows per chunk.
            q_chunks = max(s // 512, 1) if s >= 1024 else 1
            out = attention(q, k, v, q_offset=off, window=window,
                            logit_softcap=cfg.attn_logit_softcap,
                            q_chunks=q_chunks)
        elif split:
            hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
            qkv = sharding.seq_gather(torch.cat([q.flatten(2), k.flatten(2), v.flatten(2)],
                                                dim=-1), seq)
            shape = (b, qkv.shape[1], -1, cfg.head_dim)
            qw, kw, vw = (t.reshape(shape).contiguous()
                          for t in qkv.split([hq, hkv, hkv], dim=-1))
            out = fa_ops.flash_attention(qw, kw, vw, causal=True, window=window,
                                         logit_softcap=cfg.attn_logit_softcap)[:, off:off + s]
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                         logit_softcap=cfg.attn_logit_softcap)
        if return_kv:
            new_cache = {"k": k, "v": v}
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], new_cache


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def dense_ffn(params, x, activation: str = "swiglu") -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
