"""Wrappers of the grouped and ragged expert GEMM kernels.

Two families, as in the JAX package:

* ``grouped_matmul`` / ``grouped_ffn`` — the padded capacity-dispatch path:
  (E, C, d) buffers, three grouped launches.
* ``ragged_matmul`` / ``ragged_ffn`` — the dropless path: one (T, d) matrix
  of token rows sorted by expert + per-expert ``offsets`` (E+1,) int32.
  ``ragged_ffn`` is differentiable through :class:`RaggedFFN`, whose
  backward runs as ragged kernels too (``ragged_matmul_f32`` for dh/dx,
  ``ragged_dw_f32`` for the expert weights).

Precision contract: bf16 (or fp32) inputs, fp32 accumulation everywhere,
and the hidden activation stays fp32 *between* launches — the only cast
back to the input dtype happens after the final down-projection.

Each ``*_f32`` wrapper launches its CUDA kernel for CUDA tensors, takes the
plain version in ``ref`` only when every input lies on the CPU, and raises
on any other device, dtype, shape or layout.  Kernel designs, chosen here
by dtype and rows per expert before any launch (never after a failed one):
``grouped_matmul_f32`` and ``ragged_matmul_f32`` with bf16 weights run on
the tensor cores (``csrc/moe_gemm_tc.cu``: "tc", or "skinny" for <= 16 rows
an expert), fp32 x split into three bf16 pieces; with fp32 weights on the
fp32 CUDA cores (``csrc/moe_gemm.cu``: "fma"); ``ragged_gate_up_silu_f32``
is routed as ``ragged_matmul_f32`` and runs the same tile body with gate
and up in one slab.  ``ragged_dw_f32`` runs on the tensor cores for every
operand pair ("tc"), fp32 operands in bf16 pieces.  The kernels mask
ragged row and column edges themselves, so rows are never padded to the
tile height (the JAX wrapper's ``_pad_rows``); the output is (T, N) for T
input rows.
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

_GROUPED_ARGS = [_P, _I, _P, _P, _I, _I, _I, _I, _I]
_GROUPED = {
    "tc": Kernel("moe_gemm_tc", "grouped_matmul_f32_tc", _GROUPED_ARGS,
                 ("grouped_matmul_f32", "grouped_matmul_f32/tc")),
    "skinny": Kernel("moe_gemm_tc", "grouped_matmul_f32_tc", _GROUPED_ARGS,
                     ("grouped_matmul_f32", "grouped_matmul_f32/skinny")),
    "fma": Kernel("moe_gemm", "grouped_matmul_f32_fma", [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I],
                  ("grouped_matmul_f32", "grouped_matmul_f32/fma")),
}
# Tile shapes of csrc/moe_gemm_tc.cu, in the order of its tile codes, and
# their heights (the rows of one ragged work item).
TILES = ("Tile128", "Tile64", "Tile64Split", "Skinny")
TILE_ROWS = {"Tile128": 128, "Tile64": 64, "Tile64Split": 64, "Skinny": 16}
SKINNY_ROWS = 16  # at most this many rows per expert: the weight-streaming design
_RAGGED_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
_RAGGED = {
    "tc": Kernel("moe_gemm_tc", "ragged_matmul_f32_tc", _RAGGED_ARGS,
                 ("ragged_matmul_f32", "ragged_matmul_f32/tc")),
    "skinny": Kernel("moe_gemm_tc", "ragged_matmul_f32_tc", _RAGGED_ARGS,
                     ("ragged_matmul_f32", "ragged_matmul_f32/skinny")),
    "fma": Kernel("moe_gemm", "ragged_matmul_f32",
                  [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
                  ("ragged_matmul_f32", "ragged_matmul_f32/fma")),
}
_GATE_UP_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
_GATE_UP = {
    "tc": Kernel("moe_gemm_tc", "ragged_gate_up_silu_f32_tc", _GATE_UP_ARGS,
                 ("ragged_gate_up_silu_f32", "ragged_gate_up_silu_f32/tc")),
    "skinny": Kernel("moe_gemm_tc", "ragged_gate_up_silu_f32_tc", _GATE_UP_ARGS,
                     ("ragged_gate_up_silu_f32", "ragged_gate_up_silu_f32/skinny")),
    "fma": Kernel("moe_gemm", "ragged_gate_up_silu_f32",
                  [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
                  ("ragged_gate_up_silu_f32", "ragged_gate_up_silu_f32/fma")),
}
_DW = Kernel("moe_gemm_tc", "ragged_dw_f32_tc", [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I],
             ("ragged_dw_f32", "ragged_dw_f32/tc"))


def _row_block(rows_per_group: float) -> int:
    """Tile height of the fp32 CUDA-core kernels (``csrc/moe_gemm.cu``, design
    "fma"): 16 for skinny groups (decode: ~1 row per expert), 64 otherwise.
    That source instantiates exactly these."""
    return 16 if rows_per_group <= 16 else 64


def _design(name: str, x_dtype: torch.dtype, w_dtype: torch.dtype, rows: float) -> str:
    for arg, dt in (("x", x_dtype), ("w", w_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: {arg} dtype {dt} not supported (fp32, bf16)")
    if w_dtype == torch.float32:
        return "fma"
    return "skinny" if rows <= SKINNY_ROWS else "tc"


def _check_tc_rows(name: str, x: torch.Tensor, w: torch.Tensor, K: int, N: int,
                   w_name: str = "w") -> None:
    """The tensor-core kernels copy 16-byte rows (x's of K elements, the
    second operand's of N), as the C entries' ``rows16``: refuse anything
    else."""
    kx, kw = 16 // x.element_size(), 16 // w.element_size()
    if x.data_ptr() % 16 or w.data_ptr() % 16 or K % kx or N % kw:
        raise ValueError(
            f"{name}: the tensor-core kernel needs 16-byte aligned rows (x "
            f"{tuple(x.shape)} {x.dtype}, {w_name} {tuple(w.shape)} {w.dtype}: K a multiple "
            f"of {kx}, N of {kw}, 16-byte aligned data)")


# ---------------------------------------------------------------------------
# Padded (capacity) path
# ---------------------------------------------------------------------------


def grouped_design(x_dtype: torch.dtype, w_dtype: torch.dtype, M: int) -> str:
    """The kernel design a CUDA grouped GEMM launches for x of ``x_dtype``
    with M rows per expert and weights of ``w_dtype``: bf16 weights go to
    the tensor cores, "tc" or, for M <= 16, "skinny" (the decode weight
    stream), with fp32 x split into three bf16 pieces; fp32 weights to
    "fma" (fp32 CUDA cores, no TF32)."""
    return _design("grouped_matmul_f32", x_dtype, w_dtype, M)


def grouped_tile(x_dtype: torch.dtype, M: int) -> str:
    """The tile shape (of ``TILES``) a tensor-core grouped GEMM launches
    with, tuned on the card: the 16-row weight stream for M <= 16; for more
    rows, 64 x 64 tiles for fp32 x (three bf16 pieces) and for bf16 x up to
    64 rows, 128 x 64 tiles above."""
    if M <= SKINNY_ROWS:
        return "Skinny"
    if x_dtype == torch.float32:
        return "Tile64Split"
    return "Tile128" if M > 64 else "Tile64"


def grouped_matmul_f32_launch(x: torch.Tensor, w: torch.Tensor):
    """Validate a grouped GEMM on CUDA tensors and allocate its output;
    returns (out, launch), where ``launch()`` enqueues the kernel of
    :func:`grouped_design` alone."""
    check_cuda(x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul_f32: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    check_contiguous(x=x, w=w)
    E, M, K = x.shape
    N = w.shape[2]
    kind = grouped_design(x.dtype, w.dtype, M)
    if kind != "fma":
        _check_tc_rows("grouped_matmul_f32", x, w, K, N)
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    if kind == "fma":
        args = (x, dtype_code("x", x), w, dtype_code("w", w), out, E, M, K, N, _row_block(M))
    else:
        args = (x, dtype_code("x", x), w, out, E, M, K, N, TILES.index(grouped_tile(x.dtype, M)))
    return out, (lambda: _GROUPED[kind](*args)) if out.numel() else (lambda: None)


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


def ragged_design(x_dtype: torch.dtype, w_dtype: torch.dtype, rows_per_expert: float) -> str:
    """The kernel design a CUDA ragged GEMM (``ragged_matmul_f32`` or the
    fused ``ragged_gate_up_silu_f32``) launches for x of ``x_dtype`` with
    ``rows_per_expert`` = T / E and weights of ``w_dtype``, as
    :func:`grouped_design`: bf16 weights on the tensor cores, "skinny" for
    <= 16 rows an expert (decode) and "tc" above; fp32 weights "fma"."""
    return _design("ragged_matmul_f32", x_dtype, w_dtype, rows_per_expert)


def ragged_tile(x_dtype: torch.dtype, rows_per_expert: float) -> str:
    """The tile shape (of ``TILES``) a tensor-core ragged GEMM launches with:
    the 16-row weight stream for <= 16 rows an expert; above, 64 x 64 tiles,
    fp32 x in three bf16 pieces (``Tile64Split``) or bf16 x (``Tile64``: a
    tile straddling two experts is one work item each, so taller tiles add
    more straddled rows than they save, timed on the card)."""
    if rows_per_expert <= SKINNY_ROWS:
        return "Skinny"
    return "Tile64Split" if x_dtype == torch.float32 else "Tile64"


def _ragged_prepare(x, ws, offsets):
    """Validate a ragged launch; returns (T, K, N, E)."""
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
    if any(w.dtype != ws[0].dtype for w in ws):
        raise ValueError("ragged: weight dtypes differ")
    return T, K, N, E


def _work_table(offsets, T: int, E: int, bm: int):
    """(G, (tile_m, grp, valid)) for row tiles of height ``bm``."""
    G = -(-T // bm) + E
    return G, ragged_metadata(offsets, bm, E, G)


def _ragged_launch(name, kernels, x, ws, offsets):
    """Validate a ragged launch over the weights ``ws`` on CUDA tensors, build
    its work table (at the height of :func:`ragged_tile`'s tile, or of
    ``_row_block`` for "fma") and zeroed fp32 outputs, one per ``kernels``
    output; returns (outs, launch), ``launch()`` enqueuing the kernel of
    :func:`ragged_design` alone."""
    T, K, N, E = _ragged_prepare(x, ws, offsets)
    kind = _design(name, x.dtype, ws[0].dtype, T / E)
    outs = tuple(torch.zeros((T, N), dtype=torch.float32, device=x.device)
                 for _ in range(1 if len(ws) == 1 else 3))
    if kind == "fma":
        bm = _row_block(T / E)
        wdt, last = (dtype_code("w", ws[0]),), bm
    else:
        for i, w in enumerate(ws):
            _check_tc_rows(name, x, w, K, N, f"w{i}")
        tile = ragged_tile(x.dtype, T / E)
        bm, wdt, last = TILE_ROWS[tile], (), TILES.index(tile)
    G, table = _work_table(offsets, T, E, bm)
    args = (x, dtype_code("x", x), *ws, *wdt, offsets, *table, *outs, T, K, N, G, last)
    return outs, (lambda: kernels[kind](*args)) if outs[0].numel() else (lambda: None)


def ragged_matmul_f32_launch(x, w, offsets):
    """As :func:`_ragged_launch` for one ragged GEMM; returns (out, launch)."""
    (out,), launch = _ragged_launch("ragged_matmul_f32", _RAGGED, x, [w], offsets)
    return out, launch


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
    return _ragged_launch("ragged_gate_up_silu_f32", _GATE_UP, x, [w_gate, w_up], offsets)


def ragged_gate_up_silu_f32(x, w_gate, w_up, offsets):
    """Fused ragged gate-up-SiLU: (h, a_g, a_u) = (silu(x@Wg[e]) * x@Wu[e],
    x@Wg[e], x@Wu[e]), all fp32 (T, F); the pre-activations are the
    residuals the backward slice will reuse."""
    if on_cpu(x, w_gate, w_up, offsets):
        return ref.ragged_gate_up_silu_f32(x, w_gate, w_up, offsets)
    outs, launch = ragged_gate_up_silu_f32_launch(x, w_gate, w_up, offsets)
    launch()
    return outs


def ragged_dw_f32_launch(x, g, offsets):
    """Validate a ragged dgrad on CUDA tensors and allocate its output (the
    kernel writes every element, zeros for empty experts); returns (out,
    launch), ``launch()`` enqueuing the tensor-core kernel alone (design
    "tc" for every pair of fp32 and bf16 operands)."""
    check_cuda(x, g, offsets)
    if (x.dim() != 2 or g.dim() != 2 or x.shape[0] != g.shape[0]
            or offsets.dim() != 1 or offsets.shape[0] < 2
            or offsets.dtype != torch.int32):
        raise ValueError(
            f"ragged_dw_f32: x {tuple(x.shape)}, g {tuple(g.shape)}, offsets "
            f"{tuple(offsets.shape)} {offsets.dtype} (need (T, K), (T, N), "
            f"(E+1,) int32)")
    check_contiguous(x=x, g=g, offsets=offsets)
    T, K = x.shape
    N, E = g.shape[1], offsets.shape[0] - 1
    xdt, gdt = dtype_code("x", x), dtype_code("g", g)
    _check_tc_rows("ragged_dw_f32", x, g, K, N, "g")
    out = torch.empty((E, K, N), dtype=torch.float32, device=x.device)
    args = (x, xdt, g, gdt, offsets, out, T, K, N, E)
    return out, (lambda: _DW(*args)) if out.numel() else (lambda: None)


def ragged_dw_f32(x, g, offsets):
    """Ragged dgrad dW[e] = x[o_e:o_{e+1}]^T @ g[o_e:o_{e+1}] in fp32 for
    expert-sorted rows x (T, K), g (T, N): (E, K, N), zeros for an expert
    with no rows; rows at or past offsets[E] are never read."""
    if on_cpu(x, g, offsets):
        return ref.ragged_dw_f32(x, g, offsets)
    out, launch = ragged_dw_f32_launch(x, g, offsets)
    launch()
    return out


def ragged_matmul(x, w, offsets):
    return ragged_matmul_f32(x, w, offsets).to(x.dtype)


def _transposed(w: torch.Tensor) -> torch.Tensor:
    """(E, K, N) -> contiguous (E, N, K): the ragged kernel reads a
    contiguous weight, so the backward's per-expert transposes are copies
    (three per MoE layer and step; at granite's widths 63 MB each in bf16)."""
    return w.transpose(1, 2).contiguous()


class RaggedFFN(torch.autograd.Function):
    """Differentiable dropless expert FFN over expert-sorted rows; the port
    of the JAX package's ``_make_ragged_ffn`` custom VJP.

    Forward: the fused gate-up-SiLU launch (gelu: one ragged GEMM), which
    also yields the fp32 pre-activations kept for the backward, then one
    ragged down-projection.  Returns fp32 (T, d).
    Backward: ``dy`` in fp32; h recomputed from the saved pre-activations;
    dh, dx_g, dx_u as ragged GEMMs against the transposed expert weights;
    the three weight gradients as ``ragged_dw_f32``; each gradient cast
    back to its primal's dtype.  Rows at or past offsets[E] get dx = 0:
    the ragged GEMM writes exactly 0 there.  A gradient no input asks for
    (``ctx.needs_input_grad``: the weights of a pipeline's input-only
    backward, ``core.pipeline``'s Bi op) is not computed.
    """

    @staticmethod
    def forward(ctx, x, w_up, w_gate, w_down, offsets, activation: str):
        if activation == "swiglu":
            h, a_g, a_u = ragged_gate_up_silu_f32(x, w_gate, w_up, offsets)
        else:
            a_g, a_u = None, ragged_matmul_f32(x, w_up, offsets)
            h = ref.gelu(a_u)
        ctx.activation = activation
        ctx.save_for_backward(x, w_up, w_gate, w_down, offsets, a_g, a_u)
        return ragged_matmul_f32(h, w_down, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w_up, w_gate, w_down, offsets, a_g, a_u = ctx.saved_tensors
        want_x, want_wu, want_wg, want_wd = ctx.needs_input_grad[:4]
        dy = dy.float().contiguous()
        if ctx.activation == "swiglu":
            sig = torch.sigmoid(a_g)
            silu_g = a_g * sig
            h = silu_g * a_u
        else:
            h = ref.gelu(a_u)
        dx = dwu = dwg = dwd = None
        if want_wd:
            dwd = ragged_dw_f32(h, dy, offsets).to(w_down.dtype)
        if not (want_x or want_wu or want_wg):
            return (dx, dwu, dwg, dwd, None, None)
        dh = ragged_matmul_f32(dy, _transposed(w_down), offsets)
        if ctx.activation == "swiglu":
            d_silu = sig * (1.0 + a_g * (1.0 - sig))
            da_g = dh * a_u * d_silu
            da_u = dh * silu_g
            if want_x:
                dx = ragged_matmul_f32(da_g, _transposed(w_gate), offsets)
                dx += ragged_matmul_f32(da_u, _transposed(w_up), offsets)
            if want_wg:
                dwg = ragged_dw_f32(x, da_g, offsets).to(w_gate.dtype)
        else:
            da_u = torch.ops.aten.gelu_backward(dh, a_u, approximate="tanh")
            if want_x:
                dx = ragged_matmul_f32(da_u, _transposed(w_up), offsets)
        if want_wu:
            dwu = ragged_dw_f32(x, da_u, offsets).to(w_up.dtype)
        return (None if dx is None else dx.to(x.dtype), dwu, dwg, dwd, None, None)


def ragged_ffn(tokens, w_up, w_gate: Optional[torch.Tensor], w_down, offsets,
               activation: str = "swiglu"):
    """Dropless grouped expert FFN over expert-sorted rows, differentiable
    through :class:`RaggedFFN`: fused gate-up-SiLU launch + one ragged
    down-projection forward; rows at or past offsets[E] come back 0 and get
    no gradient."""
    if activation == "swiglu" and w_gate is None:
        raise ValueError("swiglu ragged_ffn requires w_gate")
    if activation != "swiglu":
        w_gate = None
    return RaggedFFN.apply(tokens, w_up, w_gate, w_down, offsets,
                           activation).to(tokens.dtype)
