"""Wrappers of the grouped and ragged expert GEMM kernels.

Two families, as in the JAX package:

* ``grouped_matmul`` / ``grouped_ffn`` — the padded capacity-dispatch path:
  (E, C, d) buffers, three grouped launches.
* ``ragged_matmul`` / ``ragged_ffn`` — the dropless path: one (T, d) matrix
  of token rows sorted by expert + per-expert ``offsets`` (E+1,) int32.
  Forward only; the backward kernels come with the training slice.

Precision contract: bf16 (or fp32) inputs, fp32 accumulation everywhere,
and the hidden activation stays fp32 *between* launches — the only cast
back to the input dtype happens after the final down-projection.

Each ``*_f32`` wrapper launches its CUDA kernel (``csrc/moe_gemm.cu``) for
CUDA tensors, takes the plain version in ``ref`` only when every input lies
on the CPU, and raises on any other device, dtype, shape or layout.  The
kernels mask ragged row and column edges themselves, so rows are never
padded to the tile height (the JAX wrapper's ``_pad_rows``); the output is
(T, N) for T input rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (
    Kernel, check_contiguous, check_cuda, dtype_code, on_cpu,
)
from repro_torch.kernels.moe_gemm import ref

_P, _I = ctypes.c_void_p, ctypes.c_int

_GROUPED = Kernel("moe_gemm", "grouped_matmul_f32",
                  [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I])
_RAGGED = Kernel("moe_gemm", "ragged_matmul_f32",
                 [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I])
_GATE_UP = Kernel("moe_gemm", "ragged_gate_up_silu_f32",
                  [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I])


def _row_block(rows_per_group: float) -> int:
    """Kernel tile height: 16 for skinny groups (decode: ~1 row per
    expert), 64 otherwise.  The CUDA source instantiates exactly these."""
    return 16 if rows_per_group <= 16 else 64


# ---------------------------------------------------------------------------
# Padded (capacity) path
# ---------------------------------------------------------------------------


def grouped_matmul_f32_launch(x: torch.Tensor, w: torch.Tensor):
    """Validate a grouped GEMM on CUDA tensors and allocate its output;
    returns (out, launch), where ``launch()`` enqueues the kernel alone."""
    check_cuda(x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul_f32: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    check_contiguous(x=x, w=w)
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    args = (x, dtype_code("x", x), w, dtype_code("w", w), out,
            E, M, K, N, _row_block(M))
    return out, (lambda: _GROUPED(*args)) if out.numel() else (lambda: None)


def grouped_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[e] = x[e] @ w[e] in fp32: x (E, M, K), w (E, K, N)."""
    if on_cpu(x, w):
        return ref.grouped_matmul_f32(x, w)
    out, launch = grouped_matmul_f32_launch(x, w)
    launch()
    return out


def grouped_matmul(x, w):
    return grouped_matmul_f32(x, w).to(x.dtype)


def grouped_ffn(tokens, w_up, w_gate: Optional[torch.Tensor], w_down,
                activation: str = "swiglu"):
    """Expert FFN over (E, C, d) capacity buffers: three grouped launches,
    the gated activation in fp32 between them."""
    if activation == "swiglu":
        h = F.silu(grouped_matmul_f32(tokens, w_gate)) * grouped_matmul_f32(
            tokens, w_up
        )
    else:
        h = ref.gelu(grouped_matmul_f32(tokens, w_up))
    return grouped_matmul_f32(h, w_down).to(tokens.dtype)


# ---------------------------------------------------------------------------
# Ragged (dropless) path
# ---------------------------------------------------------------------------


def ragged_metadata(offsets: torch.Tensor, bm: int, E: int, G: int):
    """(tile_m, grp, valid) int32 work tables of length G, built on the
    offsets' device with no host sync: the counterpart of the JAX
    ``ragged_metadata``.  Expert e owns row tiles floor(o[e]/bm) ..
    ceil(o[e+1]/bm)-1; there are at most ceil(T/bm) + E such (tile, expert)
    items, and surplus items carry valid = 0."""
    o = offsets.to(torch.int32)
    counts = o[1:] - o[:-1]
    first = torch.div(o[:-1], bm, rounding_mode="floor")
    last = torch.where(
        counts > 0, torch.div(o[1:] - 1, bm, rounding_mode="floor"), first - 1
    )
    ntiles = (last - first + 1).clamp(min=0)
    seg_end = torch.cumsum(ntiles, 0, dtype=torch.int32)
    seg_start = seg_end - ntiles
    nvalid = seg_end[-1]
    g = torch.arange(G, dtype=torch.int32, device=o.device)
    valid = (g < nvalid).to(torch.int32)
    gg = torch.minimum(g, (nvalid - 1).clamp(min=0))
    grp = torch.searchsorted(seg_end, gg, right=True).clamp(max=E - 1)
    tile_m = (first[grp] + (gg - seg_start[grp])).clamp(min=0)
    return tile_m.to(torch.int32), grp.to(torch.int32), valid


def _ragged_prepare(x, ws, offsets):
    """Validate a ragged launch; returns (T, K, N, E, bm, work tables)."""
    check_cuda(x, offsets, *ws)
    if x.dim() != 2 or any(w.dim() != 3 or w.shape != ws[0].shape for w in ws):
        raise ValueError("ragged: x must be (T, K) and weights (E, K, N)")
    T, K = x.shape
    E, K2, N = ws[0].shape
    if K2 != K or offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(
            f"ragged: x {tuple(x.shape)}, w {tuple(ws[0].shape)}, offsets "
            f"{tuple(offsets.shape)} {offsets.dtype} (need (E+1,) int32)"
        )
    check_contiguous(x=x, offsets=offsets, **{f"w{i}": w for i, w in enumerate(ws)})
    wdt = dtype_code("w", ws[0])
    if any(w.dtype != ws[0].dtype for w in ws):
        raise ValueError("ragged: weight dtypes differ")
    bm = _row_block(T / E)
    G = -(-T // bm) + E
    return T, K, N, E, bm, G, ragged_metadata(offsets, bm, E, G), wdt


def ragged_matmul_f32_launch(x, w, offsets):
    """Validate a ragged GEMM on CUDA tensors, build its work table and
    zeroed output; returns (out, launch), ``launch()`` enqueuing the kernel
    alone."""
    T, K, N, E, bm, G, (tm, gr, vl), wdt = _ragged_prepare(x, [w], offsets)
    out = torch.zeros((T, N), dtype=torch.float32, device=x.device)
    args = (x, dtype_code("x", x), w, wdt, offsets, tm,
            gr, vl, out, T, K, N, G, bm)
    return out, (lambda: _RAGGED(*args)) if out.numel() else (lambda: None)


def ragged_matmul_f32(x, w, offsets):
    """out[t] = x[t] @ w[expert(t)] in fp32 for expert-sorted rows
    x (T, K), w (E, K, N), offsets (E+1,) int32 with offsets[E] <= T; rows
    at or past offsets[E] are exactly 0."""
    if on_cpu(x, w, offsets):
        return ref.ragged_matmul_f32(x, w, offsets)
    out, launch = ragged_matmul_f32_launch(x, w, offsets)
    launch()
    return out


def ragged_gate_up_silu_f32_launch(x, w_gate, w_up, offsets):
    """As :func:`ragged_matmul_f32_launch` for the fused gate-up-SiLU
    kernel; the output is the triple (h, a_g, a_u)."""
    T, K, Fd, E, bm, G, (tm, gr, vl), wdt = _ragged_prepare(
        x, [w_gate, w_up], offsets
    )
    outs = tuple(torch.zeros((T, Fd), dtype=torch.float32, device=x.device)
                 for _ in range(3))
    args = (x, dtype_code("x", x), w_gate, w_up, wdt,
            offsets, tm, gr, vl, *outs, T, K, Fd,
            G, bm)
    return outs, (lambda: _GATE_UP(*args)) if outs[0].numel() else (lambda: None)


def ragged_gate_up_silu_f32(x, w_gate, w_up, offsets):
    """Fused ragged gate-up-SiLU: (h, a_g, a_u) = (silu(x@Wg[e]) * x@Wu[e],
    x@Wg[e], x@Wu[e]), all fp32 (T, F); the pre-activations are the
    residuals the backward slice will reuse."""
    if on_cpu(x, w_gate, w_up, offsets):
        return ref.ragged_gate_up_silu_f32(x, w_gate, w_up, offsets)
    outs, launch = ragged_gate_up_silu_f32_launch(x, w_gate, w_up, offsets)
    launch()
    return outs


def ragged_matmul(x, w, offsets):
    return ragged_matmul_f32(x, w, offsets).to(x.dtype)


def ragged_ffn(tokens, w_up, w_gate: Optional[torch.Tensor], w_down, offsets,
               activation: str = "swiglu"):
    """Dropless grouped expert FFN over expert-sorted rows (forward):
    fused gate-up-SiLU launch + one ragged down-projection; rows at or past
    offsets[E] come back 0."""
    if activation == "swiglu":
        if w_gate is None:
            raise ValueError("swiglu ragged_ffn requires w_gate")
        h, _, _ = ragged_gate_up_silu_f32(tokens, w_gate, w_up, offsets)
    else:
        h = ref.gelu(ragged_matmul_f32(tokens, w_up, offsets))
    return ragged_matmul_f32(h, w_down, offsets).to(tokens.dtype)
