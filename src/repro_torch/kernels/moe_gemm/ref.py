"""Plain PyTorch versions of the grouped and ragged expert GEMMs.

The plain versions of the four CUDA kernels (same arguments, fp32
results): the wrappers in ``ops`` take them for CPU tensors, so ``ops``'
``grouped_ffn`` / ``ragged_ffn`` compositions are themselves the plain
FFNs there, and ``chip_smoke.py`` holds the kernels against them on the
card.  Products are formed in fp32 from fp32-widened operands, so bf16
inputs accumulate in fp32 as in the kernels.  Beside them, the
tensor-core designs' arithmetic on bf16 pieces (``grouped_matmul_bf16x3``,
``ragged_matmul_bf16x3``, ``ragged_dw_pieces``), which the CPU tests hold
against the fp32 versions and the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[e] = x[e] @ w[e] in fp32: x (E, M, K), w (E, K, N)."""
    return torch.bmm(x.float(), w.float())


def split_bf16x3(x: torch.Tensor):
    """fp32 x as three bf16 pieces (hi, mid, lo), each the bf16 rounding of
    what the pieces before it leave: hi + mid + lo == x exactly for finite x
    away from the ends of fp32's exponent range (8 + 8 + 8 significant bits
    cover fp32's 24, and every residual is exact in fp32)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def grouped_matmul_bf16x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's arithmetic for fp32 x and bf16 w: the sum of
    three products of bf16 pieces of x with w, each exact in fp32."""
    return sum(torch.bmm(p.float(), w.float()) for p in split_bf16x3(x))


def ragged_matmul_f32(x: torch.Tensor, w: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """out[t] = x[t] @ w[expert(t)] in fp32 for expert-sorted rows; rows at
    or past offsets[E] are exactly 0."""
    out = x.new_zeros((x.shape[0], w.shape[2]), dtype=torch.float32)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = x[lo:hi].float() @ w[e].float()
    return out


def ragged_matmul_bf16x3(x: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """The tensor-core ragged kernel's arithmetic for fp32 x and bf16 w: the
    sum of three ragged products of bf16 pieces of x with w, each exact in
    fp32."""
    return sum(ragged_matmul_f32(p, w, offsets) for p in split_bf16x3(x))


def ragged_gate_up_silu_f32(x, w_gate, w_up, offsets):
    """(h, a_g, a_u) = (silu(x@Wg[e]) * x@Wu[e], x@Wg[e], x@Wu[e]) in fp32."""
    a_g = ragged_matmul_f32(x, w_gate, offsets)
    a_u = ragged_matmul_f32(x, w_up, offsets)
    return F.silu(a_g) * a_u, a_g, a_u


def ragged_dw_f32(x: torch.Tensor, g: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """dW[e] = x[o_e:o_{e+1}]^T @ g[o_e:o_{e+1}] in fp32, (E, K, N); an expert
    with no rows gets zeros, and rows at or past offsets[E] are never read."""
    E = offsets.shape[0] - 1
    out = x.new_zeros((E, x.shape[1], g.shape[1]), dtype=torch.float32)
    bounds = offsets.tolist()
    for e in range(E):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[e] = x[lo:hi].float().T @ g[lo:hi].float()
    return out


def ragged_dw_pieces(x: torch.Tensor, g: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """The tensor-core dgrad's arithmetic: each fp32 operand as its three
    bf16 pieces (a bf16 one as itself), and the sum of the ragged dgrads of
    the piece pairs (i, j) with i + j below the larger piece count: three
    products for one fp32 operand, all exact; for two, the six that keep
    hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and lo.hi (the three dropped are
    below 2^-24 of |x.g|)."""
    def pieces(t):
        return split_bf16x3(t) if t.dtype == torch.float32 else (t,)

    px, pg = pieces(x), pieces(g)
    n = max(len(px), len(pg))
    return sum(ragged_dw_f32(a, b, offsets) for i, a in enumerate(px)
               for j, b in enumerate(pg) if i + j < n)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")
