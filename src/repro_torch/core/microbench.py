"""Micro-benchmarking suite (paper §IV): measure the platform, feed the
resource model.

The port's twin of ``repro.core.microbench``: the expert-GEMM curve (the
paper's Fig 4, the tall-and-skinny GEMM penalty) and the attention curve
(Fig 3), in PyTorch on an explicit device, with the reference's row keys.
On a CUDA device each call is timed with CUDA events, queued behind a
busy-wait kernel so that the host's launch cost stays out; on the CPU with
the host clock.  ``chip_smoke.py`` (phase "model") runs both on the card
at granite-moe-3b-a800m's widths; ``core.platform.H100``'s ``gemm_eff``
and ``attn_eff`` are those measurements.

The all-to-all benchmarks (``a2a_bandwidth_curve``, ``a2a_overlap_layer``,
``measure_a2a_overlap``) need several ranks and wait for expert
parallelism (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve_device


def _time_fn(fn, *args, device: torch.device, iters: int = 5, warmup: int = 2) -> float:
    """Mean seconds of one ``fn(*args)`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # let the launches below queue up
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def _normal(shape, dtype, device, seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def gemm_throughput(m: int, k: int, n: int, dtype=torch.float32,
                    device="cuda") -> Tuple[float, float]:
    """Returns (seconds, GFLOP/s) for an (m,k)x(k,n) matmul."""
    dev = resolve_device(device)
    a = _normal((m, k), dtype, dev)
    b = _normal((k, n), dtype, dev, seed=1)
    sec = _time_fn(torch.matmul, a, b, device=dev)
    return sec, 2.0 * m * k * n / sec / 1e9


def expert_gemm_curve(
    d_model: int = 512, tokens: int = 4096,
    ffn_dims: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048),
    dtype=torch.float32, device="cuda",
) -> List[Dict]:
    """Fig 4 analog: throughput of the expert GEMM (tokens, d_model) x
    (d_model, d_ffn) as d_ffn shrinks (fine-grained experts) at a fixed
    token budget; ``efficiency`` is against a 2048^3 GEMM measured in the
    same call, as in the reference."""
    dev = resolve_device(device)
    peak = max(gemm_throughput(2048, 2048, 2048, dtype, dev)[1], 1e-9)
    rows = []
    for f in ffn_dims:
        sec, gflops = gemm_throughput(tokens, d_model, f, dtype, dev)
        rows.append({"d_ffn": f, "seconds": sec, "gflops": gflops,
                     "efficiency": gflops / peak})
    return rows


def attention_curve(
    d_model: int = 512, heads: int = 8,
    seq_lens: Tuple[int, ...] = (128, 256, 512, 1024),
    dtype=torch.float32, device="cuda",
) -> List[Dict]:
    """Fig 3 analog: causal attention throughput vs sequence length, one
    sequence of ``heads`` heads of ``d_model // heads``.  It times the
    attention the port's prefill runs (``models/layers.attention_proj``:
    the flash kernel, ``flash_attention/tc`` for bf16 on the card, its
    plain version on the CPU) and counts the reference's 4 s^2 d_model
    FLOPs, the full square the resource model prices."""
    from repro_torch.models.layers import fa_ops

    dev = resolve_device(device)
    hd = d_model // heads
    rows = []
    for s in seq_lens:
        q = _normal((1, s, heads, hd), dtype, dev)
        sec = _time_fn(lambda q_: fa_ops.flash_attention(q_, q_, q_, causal=True), q,
                       device=dev)
        flops = 4.0 * s * s * d_model  # QK^T + AV
        rows.append({"seq": s, "seconds": sec, "gflops": flops / sec / 1e9})
    return rows
