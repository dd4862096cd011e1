"""Core transformer layers: norms, rotary embeddings, GQA attention, FFN.

Functions of tensors; parameters are plain dicts, as in the JAX package.
Prefill attention runs the flash kernel (``kernels.flash_attention``;
a rank holding a slice of the sequence passes its ``q_offset``); decode,
paged (gathering its pages) or over a dense cache (whole, or a rank's
"kv_seq" block combined over its sequence group), runs eagerly here, as
the JAX package leaves it to XLA.
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


def kv_block_attention(q, k, v, cache, index: int, seq, *, window: Optional[int] = None,
                       logit_softcap: Optional[float] = None) -> torch.Tensor:
    """One decode token's attention over a dense cache in the reference's
    "kv_seq" layout: ``cache`` {"k", "v"} (b, C_l, kv, hd) holds rows ``[j
    C_l, (j + 1) C_l)`` of the sequence's cache, ``j`` the rank's place in
    ``seq``'s sequence group (``sharding.MeshPlan.kv_rows``).  The rank
    whose rows hold ``index`` writes the new K/V row ``k``, ``v`` (b, 1,
    kv, hd) there, IN PLACE.  Each rank scores q (b, 1, hq, hd) against its
    own rows that the token sees (``<= index`` and inside ``window``),
    with the softcap, in fp32, and keeps its row max m_j and the sum l_j of
    exp(score - m_j); a rank that sees none of its rows keeps (-1e30, 0),
    so it adds zero weight and no NaN (the owner of ``index`` always sees
    a row, so the group's max M is finite).  One all-gather of (m_j, l_j)
    over the group gives M and the softmax's sum L = sum_j e^(m_j - M) l_j;
    each rank's probabilities e^(score - M) / L are rounded to V's dtype,
    as the reference rounds its softmax before P.V, and their fp32 product
    with its rows of V is summed over the group by an all-reduce (which
    leaves every rank the same sum), then rounded to q's dtype: the
    reference's function and its rounding, its fp32 sums in another order.
    Returns (b, 1, hq, hd)."""
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"a kv_seq cache takes one decode token, got {s}")
    c_l, hkv = cache["k"].shape[1], cache["k"].shape[2]
    first = seq.seq_rank * c_l
    if first <= index < first + c_l:
        cache["k"][:, index - first] = k[:, 0]
        cache["v"][:, index - first] = v[:, 0]
    lo = max(first, index - window + 1) if window is not None else first
    hi = min(first + c_l, index + 1)
    qh = q.reshape(b, hkv, hq // hkv, d).float()
    if hi > lo:
        ks = cache["k"][:, lo - first:hi - first].float()
        scores = softcap(torch.einsum("bhgd,bkhd->bhgk", qh, ks) / math.sqrt(d), logit_softcap)
        m = scores.amax(dim=-1, keepdim=True)
        stats = torch.cat([m, torch.exp(scores - m).sum(dim=-1, keepdim=True)], dim=-1)
    else:
        stats = torch.zeros(qh.shape[:-1] + (2,), dtype=torch.float32, device=q.device)
        stats[..., 0] = NEG_INF
    stats = _gather_stack(stats, seq.model_group)
    M = stats[..., :1].amax(dim=0)
    L = (torch.exp(stats[..., :1] - M) * stats[..., 1:]).sum(dim=0)
    if hi > lo:
        probs = (torch.exp(scores - M) / L).to(cache["v"].dtype)
        o = torch.einsum("bhgk,bkhd->bhgd", probs.float(),
                         cache["v"][:, lo - first:hi - first].float())
    else:
        o = qh.new_zeros(qh.shape)
    o = o.contiguous()
    torch.distributed.all_reduce(o, group=seq.model_group)
    return o.to(q.dtype).reshape(b, 1, hq, d)


def _gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked in rank order (one
    all-gather)."""
    parts = [torch.empty_like(t) for _ in range(sharding.group_size(group))]
    torch.distributed.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


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
    past the end and overwrites the last row; here it raises.  With
    ``seq`` the dense cache is this rank's block of the reference's
    "kv_seq" layout (:func:`kv_block_attention`).
    ``seq`` (no cache): a ``sharding.MeshPlan`` whose sequence group holds
    the sequence, ``x`` and ``positions`` this rank's slice of it.  K/V
    are gathered over the group once a layer, after RoPE
    (``sharding.seq_gather``; the reference's ``kv_gathered``, recomputed
    under remat in training), and q stays local with ``q_offset`` at the
    slice's start, so the causal mask, a sliding window and the softcap
    see global positions (every rank scores its queries against every
    key, masked, as each of the reference's shards does): the eager
    ``attention`` in training, the flash kernel's ``q_offset`` otherwise;
    ``return_kv`` returns the rank's own K/V slice.  Returns (out,
    new_cache).
    """
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = positional_embed(q, positions, cfg.rope_type, cfg.rope_theta)
    k = positional_embed(k, positions, cfg.rope_type, cfg.rope_theta)

    new_cache = None
    if cache is not None and "block_table" not in cache and seq is not None:
        out = kv_block_attention(q, k, v, cache, operator.index(cache_index), seq,
                                 window=window, logit_softcap=cfg.attn_logit_softcap)
        new_cache = cache
    elif cache is not None and "block_table" not in cache:
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
        if return_kv:
            new_cache = {"k": k, "v": v}
        if split:  # the whole sequence's K/V
            kv = sharding.seq_gather(torch.cat([k, v], dim=-1), seq)
            k, v = kv.split(cfg.head_dim, dim=-1)
        if train:
            # Bound the fp32 score temp to ~512 query rows per chunk.
            q_chunks = max(s // 512, 1) if s >= 1024 else 1
            out = attention(q, k, v, q_offset=off, window=window,
                            logit_softcap=cfg.attn_logit_softcap,
                            q_chunks=q_chunks)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                         logit_softcap=cfg.attn_logit_softcap, q_offset=off)
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
