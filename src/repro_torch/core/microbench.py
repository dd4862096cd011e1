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
``measure_a2a_overlap``) run over a ``torch.distributed`` process group
(the EP group of a ``sharding.MeshPlan``), through the same transport and
software pipeline as ``models.moe`` (``core.halo``).  Every rank of the
group calls them together.  Over gloo a transfer of CUDA tensors stages
through the host, so its time is not the card's interconnect.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

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


def a2a_bandwidth_curve(msg_sizes: Tuple[int, ...] = (2**14, 2**17, 2**20), *,
                        group=None, device="cuda") -> List[Dict]:
    """Fig 5 analog: all-to-all time vs message size over ``group``'s
    ranks (None: one rank, a local-copy baseline).  ``gbps`` counts the
    reference's bytes: the global (n*n, rows) fp32 buffer's off-rank
    share."""
    dev = resolve_device(device)
    n = 1 if group is None else dist.get_world_size(group)
    rows = []
    for m in msg_sizes:
        if n == 1:
            x = torch.zeros((1, m // 4), dtype=torch.float32, device=dev)
            sec = _time_fn(lambda t: t + 1, x, device=dev)
            rows.append({"ranks": 1, "msg_bytes": m, "seconds": sec,
                         "gbps": m / sec / 1e9})
            continue
        rows_per = max(m // 4 // n, 1)
        x = torch.zeros((n, rows_per), dtype=torch.float32, device=dev)
        out = torch.empty_like(x)
        sec = _time_fn(lambda t: dist.all_to_all_single(out, t, group=group), x,
                       device=dev)
        bytes_moved = n * n * rows_per * 4 * (n - 1) / n
        rows.append({"ranks": n, "msg_bytes": m, "seconds": sec,
                     "gbps": bytes_moved / sec / 1e9})
    return rows


def a2a_overlap_layer(plan, rows: int, d: int, d_ff: int, chunks: int = 1,
                      part: str = "layer", device="cuda"):
    """One capacity-layout MoE layer pass over ``plan``'s EP group:
    dispatch all-to-all -> expert FFN -> combine, software-pipelined
    through ``halo.overlapped_a2a`` exactly as ``models.moe``'s chunked
    path (same transport: ``plan``'s flat or HALO; same loop) with a
    synthetic one-expert FFN, so the probe isolates the transport/compute
    pipeline.  ``part``: "layer" (the whole pipeline), "a2a" (one
    monolithic dispatch transfer) or "ffn" (the expert GEMMs only).
    Returns ``(fn, args)``; time with ``_time_fn(fn, *args)``."""
    from repro_torch.core import halo

    assert part in ("layer", "a2a", "ffn"), part
    dev = resolve_device(device)
    ep = plan.ep
    xfer = halo.Transfer(plan)
    slices = halo.chunk_slices(rows, chunks)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((ep, rows, d), generator=g, device=dev)
    wu = torch.randn((d, d_ff), generator=g, device=dev) * 0.01
    wd = torch.randn((d_ff, d), generator=g, device=dev) * 0.01

    def ffn(rx):
        h = rx.reshape(-1, d)
        return (torch.relu(h @ wu) @ wd).reshape(rx.shape)

    @torch.no_grad()
    def layer(x, wu, wd):
        if part == "a2a":
            return xfer(x)
        if part == "ffn":
            return ffn(x)
        outs = halo.overlapped_a2a(xfer, lambda start, size: x[:, start:start + size],
                                   lambda rx, start, size: ffn(rx), slices)
        return torch.cat(outs, dim=1)

    return layer, (x, wu, wd)


def measure_a2a_overlap(plan, rows: int, d: int, d_ff: int, chunks: int = 1,
                        part: str = "layer", iters: int = 3, warmup: int = 1,
                        device="cuda", telemetry: Optional[object] = None) -> float:
    """Seconds per call of one :func:`a2a_overlap_layer` configuration;
    with ``telemetry`` (an ``obs.Telemetry``) one ``a2a.layer`` span per
    measurement, recorded after the timed loop with the steady-state
    seconds a call (the number the drift tracker compares with the comm
    model)."""
    fn, args = a2a_overlap_layer(plan, rows, d, d_ff, chunks=chunks, part=part,
                                 device=device)
    t = _time_fn(fn, *args, device=resolve_device(device), iters=iters, warmup=warmup)
    if telemetry is not None:
        telemetry.record_span("a2a.layer", t, ep=plan.ep, rows=rows, d=d, d_ff=d_ff,
                              algo=plan.a2a_algo, chunks=chunks, part=part)
    return t
