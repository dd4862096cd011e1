"""Plain PyTorch version of the SSD intra-chunk term (``csrc/ssd.cu``).

The function of the Pallas kernel: every operation in fp32 on the
inputs' values, one rounding to x's dtype at the end.  In fp32 it is the
JAX package's ``kernels/ssd/ref.py`` oracle.  The cumulative sum of dA is
accumulated in fp64 and rounded once to fp32 per prefix, as the kernel does.
A prefix sum accumulated in fp32 depends on the order of its additions (the
kernel's warp scan, torch's scan on the card and a sequential sum all
differ), and at the model's scale that difference moves the output by about
the 3e-5 the kernel is held to; the fp64 sums of a chunk's <= 256 fp32
terms are exact in practice, so both sides get the same fp32 prefixes
whatever their order.  ``models/ssm.py`` takes its chunk prefixes
(``A_cs``) the same way.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.ref import split_bf16x3


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k in (j, i]} x[..., k] for i >= j, else -inf;
    the difference of fp32 prefix sums (accumulated in fp64), as the kernel
    takes it."""
    T = x.shape[-1]
    cs = torch.cumsum(x.double(), dim=-1).float()
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_intra_chunk(x, dA, B, C):
    """x: (g, cl, h, p); dA: (g, cl, h); B, C: (g, cl, h, n), any strides.
    Returns Y (g, cl, h, p) in x's dtype:
    Y[l] = sum_{s <= l} exp(cs[l] - cs[s]) * (C[l]·B[s]) * x[s]."""
    L = torch.exp(segsum(dA.float().transpose(1, 2)))  # (g, h, cl, cl)
    scores = torch.einsum("glhn,gshn->ghls", C.float(), B.float()) * L
    return torch.einsum("ghls,gshp->glhp", scores, x.float()).to(x.dtype)


def ssd_intra_chunk_pieces(x, dA, B, C):
    """The tensor-core kernel's arithmetic (``csrc/ssd_tc.cu``) for bf16
    inputs: C·Bᵀ, exact bf16 products summed in fp32, taken once per chunk
    where B and C are head-broadcast (head stride 0) and per head otherwise;
    the decay exp(cs[l] - cs[s]) on the causal pairs only; the fp32 decayed
    scores cut into three bf16 pieces (hi + mid + lo, exactly the score), each
    product with x exact in fp32 and summed in fp32; one rounding to x's
    dtype.  Shapes as :func:`ssd_intra_chunk`."""
    if B.stride(2) == 0 and C.stride(2) == 0:
        S = torch.einsum("gln,gsn->gls", C[:, :, 0].float(), B[:, :, 0].float())[:, None]
    else:
        S = torch.einsum("glhn,gshn->ghls", C.float(), B.float())
    P = S * torch.exp(segsum(dA.float().transpose(1, 2)))  # exp(-inf) = 0 above the diagonal
    y = sum(torch.einsum("ghls,gshp->glhp", p.float(), x.float()) for p in split_bf16x3(P))
    return y.to(x.dtype)
