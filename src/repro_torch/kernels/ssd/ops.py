"""Wrapper of the SSD intra-chunk kernel (``csrc/ssd.cu``).

Takes the JAX wrapper's layout, (b, nc, cl, ...), and folds it to
(b·nc, cl, ...) as a view.  dA is cast to x's dtype first, as the Pallas
path does (in bf16 that rounding is part of the function).  For CUDA
tensors the kernel reads x, B and C through their strides (B and C may be
head-broadcast views with stride 0 on the head axis) and writes a
contiguous (b, nc, cl, h, p) output in x's dtype; only when every input
lies on the CPU does the wrapper take the plain version in ``ref``.  There
is no backward, as in the reference: inputs that require grad are refused.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, on_cpu
from repro_torch.kernels.ssd import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_SSD = Kernel("ssd", "ssd_intra_chunk", [_P] * 5 + [_I] * 6 + [_L] * 12)
MAX_CHUNK = 256


def _check(x, dA, B, C):
    """Shapes of a folded call, and no input that requires grad."""
    if x.dim() != 4 or dA.shape != x.shape[:3] or B.dim() != 4 or B.shape != C.shape \
            or B.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssd_intra_chunk: x {tuple(x.shape)} dA {tuple(dA.shape)} "
                         f"B {tuple(B.shape)} C {tuple(C.shape)}")
    if any(t.requires_grad for t in (x, dA, B, C)):
        raise ValueError("ssd_intra_chunk has no backward (nor has the reference's "
                         "kernel): call it on tensors that do not require grad")


def ssd_intra_chunk_launch(x, dA, B, C):
    """Validate a folded call on CUDA tensors — x (g, cl, h, p), dA (g, cl,
    h) already in x's dtype, B/C (g, cl, h, n) — and allocate its output;
    returns (out, launch), where ``launch()`` enqueues the kernel alone."""
    check_cuda(x, dA, B, C)
    _check(x, dA, B, C)
    g, cl, h, p = x.shape
    n = B.shape[-1]
    if not (x.dtype == dA.dtype == B.dtype == C.dtype):
        raise ValueError("ssd_intra_chunk: x, dA, B, C dtypes differ")
    if min(g, cl, h, p, n) < 1 or cl > MAX_CHUNK or p > 128 or n > 256:
        raise ValueError(f"ssd_intra_chunk: g={g} h={h}, cl={cl} (<= {MAX_CHUNK}), "
                         f"p={p} (<= 128), n={n} (<= 256)")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_intra_chunk: the last dim of x, B, C must be contiguous")
    out = torch.empty((g, cl, h, p), dtype=x.dtype, device=x.device)
    strides = [s for t in (x, B, C, dA) for s in t.stride()[:3]]
    args = (x, dA, B, C, out, dtype_code("x", x), g, cl, h, p, n, *strides)
    return out, lambda: _SSD(*args)


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
