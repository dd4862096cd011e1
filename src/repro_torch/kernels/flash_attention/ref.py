"""Plain PyTorch version of flash attention (matches models.layers.attention).

Takes the kernel's own layout, (b, h, s, d), like the JAX package's oracle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """q (b, hq, sq, d), k/v (b, hkv, skv, d) -> (b, hq, sq, d) in q.dtype;
    fp32 scores and softmax.  Query row ``i`` sits at position ``q_offset +
    i`` (the reference attention's ``q_offset``), keys at ``0 .. skv - 1``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    groups = hq // hkv
    kr = k.repeat_interleave(groups, dim=1)
    vr = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(q_offset, q_offset + sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vr)
    return out.to(q.dtype)
