"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Takes the model layout (b, s, h, d), as the JAX wrapper does.  For CUDA
tensors the kernel reads q/k/v through their strides (no transpose copy)
and writes a contiguous (b, s, hq, d) output in q's dtype; only when every
input lies on the CPU does the wrapper take the plain version in ``ref``.

Two designs, chosen by dtype (:func:`design`): bf16 goes to the
tensor-core kernel (``csrc/flash_attention_tc.cu``, entry point
``flash_attention_tc``, counter ``flash_attention/tc``), which needs
16-byte aligned rows; fp32 to the CUDA-core kernel
(``csrc/flash_attention.cu``, ``flash_attention_fma``,
``flash_attention/fma``), which keeps fp32 products.  Either launch also
counts once under ``flash_attention``.  Both take head dims 16 to 256
(d = 256 in a layout of its own in each source), and a query offset
``q_offset`` (the reference attention's): query row ``i`` sits at
position ``q_offset + i`` against keys ``0 .. skv - 1``, as when a rank
holds a slice of a sequence's queries and the whole sequence's keys.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Optional

import torch

from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, on_cpu
from repro_torch.kernels.flash_attention import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_ARGS = ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
         + [_L] * 9 + [_I, _I, ctypes.c_float, ctypes.c_float, _I])
_FLASH = {
    "tc": Kernel("flash_attention_tc", "flash_attention_tc", _ARGS,
                 ("flash_attention", "flash_attention/tc")),
    "fma": Kernel("flash_attention", "flash_attention_fma", _ARGS,
                  ("flash_attention", "flash_attention/fma")),
}
_HEAD_DIMS = (16, 32, 64, 128, 256)


def design(dtype: torch.dtype, d: int) -> str:
    """The kernel design a CUDA call with inputs of ``dtype`` and head dim
    ``d`` launches: "tc" (bf16 tensor cores) or "fma" (fp32 CUDA cores)."""
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"flash_attention: dtype {dtype} not supported (fp32, bf16)")


def _check_rows_aligned(**tensors: torch.Tensor) -> None:
    """16-byte aligned rows, as the tensor-core kernel's cp.async needs."""
    for name, t in tensors.items():
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) % per for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention: {name} rows are not 16-byte aligned "
                             f"(data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()})")


def _checked_offset(q_offset, sq: int, skv: int) -> int:
    """``q_offset`` as an int, its last query row inside the keys."""
    q_offset = operator.index(q_offset)
    if q_offset < 0 or q_offset + sq > skv:
        raise ValueError(f"flash_attention: q_offset {q_offset} + sq {sq} past skv {skv}")
    return q_offset


def flash_attention_launch(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None,
                           logit_softcap: Optional[float] = None, q_offset: int = 0):
    """Validate a flash-attention call on CUDA tensors and allocate its
    output; returns (out, launch), where ``launch()`` enqueues the kernel of
    :func:`design` alone."""
    check_cuda(q, k, v)
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv or d not in _HEAD_DIMS or sq == 0 or skv == 0:
        raise ValueError(f"flash_attention: hq={hq} hkv={hkv} d={d} (d in {_HEAD_DIMS})")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v dtypes differ")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"flash_attention: softcap {logit_softcap} <= 0")
    q_offset = _checked_offset(q_offset, sq, skv)
    kind = design(q.dtype, d)
    if kind == "tc":
        _check_rows_aligned(q=q, k=k, v=v)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    args = (q, k, v, out, dtype_code("q", q), b, hq, hkv, sq, skv, d, *strides,
            int(causal), window or 0, logit_softcap or 0.0, 1.0 / math.sqrt(d), q_offset)
    return out, lambda: _FLASH[kind](*args)


def flash_attention(
    q: torch.Tensor,  # (b, sq, hq, d) — model layout
    k: torch.Tensor,  # (b, skv, hkv, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if on_cpu(q, k, v):
        q_offset = _checked_offset(q_offset, q.shape[1], k.shape[1])
        return ref.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=logit_softcap, q_offset=q_offset,
        ).transpose(1, 2)
    out, launch = flash_attention_launch(q, k, v, causal=causal, window=window,
                                         logit_softcap=logit_softcap, q_offset=q_offset)
    launch()
    return out
