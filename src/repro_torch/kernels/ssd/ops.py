"""Wrapper of the SSD intra-chunk kernels (``csrc/ssd_tc.cu``, ``csrc/ssd.cu``).

Takes the JAX wrapper's layout, (b, nc, cl, ...), and folds it to
(b·nc, cl, ...) as a view.  dA is cast to x's dtype first, as the Pallas
path does (in bf16 that rounding is part of the function).  For CUDA
tensors the kernel reads x, B and C through their strides (B and C may be
head-broadcast views with stride 0 on the head axis) and writes a
contiguous (b, nc, cl, h, p) output in x's dtype; only when every input
lies on the CPU does the wrapper take the plain version in ``ref``.  There
is no backward, as in the reference: inputs that require grad are refused.

Kernel designs, chosen here by dtype before any launch (never after a
failed one): bf16 runs on the tensor cores ("tc", ``csrc/ssd_tc.cu``: C·Bᵀ
once for the :func:`heads_per_block` heads of a block where B and C are
head-broadcast, the decayed scores as three bf16 pieces), fp32 on the fp32
CUDA cores ("fma", ``csrc/ssd.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, on_cpu
from repro_torch.kernels.ssd import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# x, dA, B, C, out; (tc: G, CL, H, P, N, heads a block | fma: dtype code, G,
# CL, H, P, N); the first three strides of x, B, C and dA
_SSD_ARGS = [_P] * 5 + [_I] * 6 + [_L] * 12
_SSD = {
    "tc": Kernel("ssd_tc", "ssd_intra_chunk_tc", _SSD_ARGS,
                 ("ssd_intra_chunk", "ssd_intra_chunk/tc")),
    "fma": Kernel("ssd", "ssd_intra_chunk", _SSD_ARGS, ("ssd_intra_chunk", "ssd_intra_chunk/fma")),
}
MAX_CHUNK = 256
BT = 64  # query rows of one block (and keys of one tile) in both kernels
# The tensor-core kernel puts two heads in a block only while the grid keeps
# at least this many blocks (about two waves of an H100's 132 SMs at two
# blocks each), so short prompts keep one head a block.
MIN_BLOCKS = 512


def design(dtype: torch.dtype) -> str:
    """The kernel design a CUDA call of this dtype launches: bf16 on the
    tensor cores ("tc"), fp32 on the fp32 CUDA cores ("fma")."""
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"ssd_intra_chunk: dtype {dtype} not supported (fp32, bf16)")


def heads_per_block(g: int, cl: int, h: int, p: int, shared_bc: bool) -> int:
    """Heads one tensor-core block computes, sharing their C·Bᵀ: 2 where B
    and C are head-broadcast, p <= 64 (wider tiles spilled registers at two
    heads a block), 2 divides h and the grid keeps at least ``MIN_BLOCKS``
    blocks (mamba2-370m's 4 x 2048 prefill; two heads a block were faster
    there than one or four, timed on the card); else 1 (its 1 x 200 and 4 x
    100 prompts: the first version's grid)."""
    n_qt = -(-cl // BT)
    if shared_bc and p <= 64 and h % 2 == 0 and n_qt * (h // 2) * g >= MIN_BLOCKS:
        return 2
    return 1


def _check(x, dA, B, C):
    """Shapes of a folded call, and no input that requires grad."""
    if x.dim() != 4 or dA.shape != x.shape[:3] or B.dim() != 4 or B.shape != C.shape \
            or B.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssd_intra_chunk: x {tuple(x.shape)} dA {tuple(dA.shape)} "
                         f"B {tuple(B.shape)} C {tuple(C.shape)}")
    if any(t.requires_grad for t in (x, dA, B, C)):
        raise ValueError("ssd_intra_chunk has no backward (nor has the reference's "
                         "kernel): call it on tensors that do not require grad")


def _check_tc_rows(x, B, C, p: int, n: int) -> None:
    """The tensor-core kernel copies 16-byte rows of x, B and C: p and n
    multiples of 8, every stride a multiple of 8 elements, 16-byte aligned
    data (as the C entry's checks)."""
    if (p % 8 or n % 8 or any(s % 8 for t in (x, B, C) for s in t.stride()[:3])
            or any(t.data_ptr() % 16 for t in (x, B, C))):
        raise ValueError(f"ssd_intra_chunk: the tensor-core kernel needs 16-byte aligned "
                         f"rows (p={p}, n={n} multiples of 8; strides x {x.stride()}, "
                         f"B {B.stride()}, C {C.stride()} multiples of 8)")


def ssd_intra_chunk_launch(x, dA, B, C):
    """Validate a folded call on CUDA tensors — x (g, cl, h, p), dA (g, cl,
    h) already in x's dtype, B/C (g, cl, h, n) — and allocate its output;
    returns (out, launch), where ``launch()`` enqueues the kernel of
    :func:`design` alone."""
    check_cuda(x, dA, B, C)
    _check(x, dA, B, C)
    g, cl, h, p = x.shape
    n = B.shape[-1]
    if not (x.dtype == dA.dtype == B.dtype == C.dtype):
        raise ValueError("ssd_intra_chunk: x, dA, B, C dtypes differ")
    kind = design(x.dtype)
    if min(g, cl, h, p, n) < 1 or cl > MAX_CHUNK or p > 128 or n > 256:
        raise ValueError(f"ssd_intra_chunk: g={g} h={h}, cl={cl} (<= {MAX_CHUNK}), "
                         f"p={p} (<= 128), n={n} (<= 256)")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_intra_chunk: the last dim of x, B, C must be contiguous")
    out = torch.empty((g, cl, h, p), dtype=x.dtype, device=x.device)
    strides = [s for t in (x, B, C, dA) for s in t.stride()[:3]]
    if kind == "tc":
        _check_tc_rows(x, B, C, p, n)
        hb = heads_per_block(g, cl, h, p, B.stride(2) == 0 and C.stride(2) == 0)
        args = (x, dA, B, C, out, g, cl, h, p, n, hb, *strides)
    else:
        args = (x, dA, B, C, out, dtype_code("x", x), g, cl, h, p, n, *strides)
    return out, lambda: _SSD[kind](*args)


def ssd_intra_chunk(xc, dAc, Bc, Cc):
    """xc: (b, nc, cl, h, p); dAc: (b, nc, cl, h); Bc/Cc: (b, nc, cl, h, n).
    Returns the intra-chunk output (b, nc, cl, h, p) in xc's dtype."""
    if xc.dim() != 5:
        raise ValueError(f"ssd_intra_chunk: x {tuple(xc.shape)} is not (b, nc, cl, h, p)")
    b, nc, cl, h, p = xc.shape
    # (b, nc, ...) -> (b * nc, ...): a view for every layout the model passes
    x, dA, B, C = (t.flatten(0, 1) for t in (xc, dAc.to(xc.dtype), Bc, Cc))
    if on_cpu(x, dA, B, C):
        _check(x, dA, B, C)
        y = ref.ssd_intra_chunk(x, dA, B, C)
    else:
        y, launch = ssd_intra_chunk_launch(x, dA, B, C)
        launch()
    return y.reshape(b, nc, cl, h, p)
