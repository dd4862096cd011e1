#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card: name and power limit (nvidia-smi);
2. kernels: builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), then holds every kernel against its
   plain PyTorch version on the card, in fp32 and bf16, at the serving and
   training paths' full-width shapes of granite-moe-3b-a800m (the grouped
   GEMM at the expert capacity of every prefill bucket serving reaches, so
   at each of its tile shapes) and mamba2-370m and at the edge cases (empty expert, one expert, extreme
   skew; a chunk of 1 or 100 tokens, strong and zero decay); times the
   kernel alone (CUDA events, median), its plain version, a library call
   that computes the same function, and the card's bound for the same work
   (fp32 operands of the tensor-core designs priced as their bf16 pieces),
   naming the kernel design that ran (``flash_attention/tc`` or ``/fma``,
   ``grouped_matmul_f32``, ``ragged_matmul_f32`` and
   ``ragged_gate_up_silu_f32`` ``/tc``, ``/skinny`` or ``/fma``,
   ``ragged_dw_f32/tc``, ``ssd_intra_chunk/tc`` or ``/fma``; the checks and
   the ragged times name the tile shape too); the training step's ragged
   GEMMs and gate-up at T*k = 8192 rows too, and beside each gate-up the
   time of two ``torch._grouped_mm`` calls and a SiLU (informative: not one
   call);
2a. model: ``repro_torch.core.microbench``'s expert-GEMM curve ((4096,
   1536) x (1536, d_ffn), d_ffn 32-2048) and attention curve (24 x 64
   heads, s 512-4096, ``flash_attention/tc``) in bf16, CUDA events, each
   row beside ``core.platform.H100``'s ``gemm_efficiency`` and
   ``attn_eff``; the planner's 1-chip plan for the training phase's run
   (must fit), its production training (256 H100s) and serving (16) plans;
   fails on a non-finite or non-positive measurement;
3. small parity: the reduced model's forward, and two fp32 train steps
   (loss, grad norm, params), on the card (kernels) against the same
   weights on the CPU (plain versions), both dispatch modes; the reduced
   mamba2-370m's prefill and decode steps likewise;
4. serving: ``repro_torch.launch.serve.serve`` at full width (32 layers,
   random bf16 weights), first under capacity and then under ragged
   dispatch.  The kernels' launch counts are zeroed just before each run
   and read just after it, and every kernel of that dispatch's path must
   have been launched, its bf16 calls through the tensor-core designs and
   never through an ``/fma`` one.  Each run has ``--metrics-out``: it
   prints the planner's lines and the drift of ``decode`` and ``prefill``
   against the H100 model, and fails unless both rows have samples and the
   Chrome trace validates;
5. parity: ``repro_torch.launch.serve.decode_parity``, the fp32 ragged
   paged decode of the ragged run's first request against the uncached
   forward, held to the serve driver's bound;
6. profile: ``torch.profiler`` over one prefill and eight decode steps of
   ``Engine.step`` under each dispatch: wall time, the card's busy time and
   idle share, device activities and the top kernels; no bf16 launch may
   reach an ``/fma`` design;
7. SSM serving: ``repro_torch.training.make_prefill_step`` /
   ``make_decode_step`` on mamba2-370m at full width and depth (48 layers,
   random bf16 weights from seed 0): 4 prompts x 2048 tokens then 32
   greedy decode steps, then one 200-token prompt and 8 steps.  The launch
   counts are zeroed just before and read just after every prefill and
   every decode loop: exactly one ``ssd_intra_chunk`` launch per layer per
   prefill, each through ``/tc``, and none in decode.  Prefill ms,
   decode-step p50, tokens/s and peak memory;
8. SSM parity: fp32 at full width, a prefill of 248 tokens and 8 decode
   steps against the uncached forward over the 256 tokens, at 2e-4;
9. SSM profile: ``torch.profiler`` over one 4 x 2048 prefill and 8 decode
   steps;
10. training: ``repro_torch.launch.train.train`` at full width and depth
   (32 layers, fp32 masters and Adam moments, bf16 compute, ragged
   dispatch), batch 2 x 512 tokens, 5 steps on ``SyntheticTokens``, the
   launch counts zeroed just before and read just after: every step must
   have a finite loss and none may be skipped, and each step must launch
   the ragged kernels once per MoE layer (gate-up), four times (the
   forward down-projection and the three backward GEMMs) and three times
   (the weight gradients), none through an ``/fma`` design.  With
   ``--metrics-out`` it prints the planner's lines and the drift report,
   and fails unless the trace validates and the ``step`` row has 4
   samples; the modeled t_step and mem_stage0 are printed beside the
   measured step p50 and peak memory.  Then one more step under
   ``torch.profiler``;
11. checkpoint: ``repro_torch.runtime.trainer.Trainer`` on granite at full
   width and depth 2 (ragged, batch 2 x 512): runs A and A2, 12 steps
   each with no checkpoint (the launch counts zeroed before A and read
   after it, held per step as in phase 10); run B, checkpoints every 4
   steps, keep 2, NaN at steps 5-7 (rolled back to 4) and SIGTERM at 10
   (final save), then a fresh trainer on a state from another seed that
   resumes at 10 and ends at 12.  After each restore the live state's
   CRC32s must equal the manifest's; the resumed state and loss must equal
   A's bit for bit when A2 equals A, and otherwise lie no further from A
   than A2 does.  A byte flipped in the newest checkpoint must be
   quarantined and the restore fall back.  Prints the bytes a checkpoint,
   the snapshot, save (CRC and write), verify and restore seconds and
   GB/s, their drift against the H100 model's t_ckpt (and the full-depth
   t_ckpt; printed only), the step p50 with and without an async write in
   flight, and the peak device memory;
12. ep: expert parallelism.  (a) ``torchrun --nproc-per-node 1 -m
   repro_torch.launch.train --mesh 1,1 --backend nccl`` with the training
   phase's arguments: the NCCL process group at EP = 1, its final loss
   against phase 10's, bitwise (else 1e-6).  (b) every kernel of the EP
   path against its plain version at the shapes the two-rank run gives it
   (E_l = 20 local experts, receiver buffers of up to 65,560 rows with a
   NaN sentinel tail that must come back 0; the grouped GEMM over (20,
   2 x C, d)).  (c) two gloo ranks sharing the card (EP = 2; NCCL will not
   put two ranks of one communicator on one GPU), granite at full width
   and depth 2 with capacity factor 16: train steps under both dispatches
   at a2a chunks 1 and 2, their loss and gathered gradients against world
   1 on the same global batch at the reference's EP gates (loss 2e-3,
   gradients 2e-3, the embedding at relative 0.05) and at 0.02 of each
   leaf's largest magnitude (printed per leaf; expert gradients halved on
   purpose must fail it); one AdamW step each, its grad norm and gathered
   first moment within 0.02 of world 1's and its params within 2 lr; and
   4 served requests under both dispatches whose
   tokens must equal the world-1 engine's.  The launch counts are zeroed
   just before the two-rank runs and read just after on each rank; every
   kernel of the path must be there, none through ``/fma``.  gloo stages
   CUDA tensors through the host, so no all-to-all time is printed; the
   a2a micro-benchmarks run at world 1 and print no time either.

The last two lines are a JSON object of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository's ``src/repro_torch`` beside this file, it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# The card's rates (H100 SXM data sheet, dense, at the 700 W limit).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor, fp32 CUDA-core
ARCH = "granite-moe-3b-a800m"
# Serving workload: 8 seeded requests of 64-512 prompt tokens, 32 new tokens
# each, 4 sequences decoding together.
SERVE_ARGS = ["--arch", ARCH, "--requests", "8", "--prompt-min", "64",
              "--prompt-max", "512", "--max-new", "32", "--max-seqs", "4",
              "--block-size", "16", "--num-blocks", "256", "--seed", "0"]
GEMM_TOL = dict(rtol=2e-5, atol=1.6e-4)  # both sides: fp32 sums of exact products
# Flash attention computes in fp32 and rounds once to q's dtype; its plain
# version here runs in fp32 on the same inputs and is rounded once too, so
# bf16 outputs may differ by one bf16 step (2^-7 relative at most).
FA_TOL = {torch.float32: dict(rtol=2e-5, atol=8e-5),
          torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
RAGGED_COUNTS = [[7, 0, 83, 1, 9], [0, 0, 0, 100], [25, 25, 25, 25], [100],
                 [1, 1, 1, 1, 1, 96, 1, 1]]
SSM_ARCH = "mamba2-370m"
# ssd_intra_chunk computes in fp32 from its inputs' values and rounds once
# to x's dtype.  fp32: the reference's atol 3e-5 (tests/test_kernels.py),
# on inputs at the model's scale (x dt-scaled ~0.1, B and C ~0.5).  bf16:
# against the plain version on the same bf16 values rounded once, so the
# outputs may differ by one bf16 step (at most 2^-7 relative).
SSD_TOL = {torch.float32: dict(rtol=0.0, atol=3e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=3e-5)}
SSM_PARITY_BOUND = 2e-4  # chunked vs recurrent SSD in fp32 (tests/test_ssm.py)
# Tokens of the expert GEMMs the kernel phase times (scripts/port_kernel_ab.py
# times the same): a 512-token prefill, a decode step of 4 sequences, and a
# train step of 2 x 512 tokens.
PREFILL_TOKENS, DECODE_TOKENS, TRAIN_TOKENS = 512, 4, 1024


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` in ms: CUDA events around each
    call, all queued behind a busy-wait kernel so the card runs them back to
    back (host launch cost stays out, unless ``fn`` itself synchronizes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def bound_ms(nbytes: float, ops) -> tuple:
    """The card's least time for moving ``nbytes`` or for doing ``ops``, a
    list of (operations, operand dtype) pairs, each at its type's peak rate."""
    t_b, t_f = nbytes / HBM_BYTES_S, sum(f / PEAK_FLOPS[dt] for f, dt in ops)
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def rate_dtype(*ts):
    """The peak rate's type for a product of these operands: bf16 tensor
    cores with fp32 accumulation unless an operand is fp32."""
    return torch.float32 if any(t.dtype == torch.float32 for t in ts) else torch.bfloat16


def gemm_ops(flops: float, a: torch.dtype, b: torch.dtype) -> list:
    """A GEMM's operations for ``bound_ms`` on operands of dtypes ``a`` and
    ``b``, as the tensor-core designs do them: bf16 operands once on the
    bf16 tensor cores; one fp32 operand in three bf16 pieces (3x), two in
    six products (6x); each at the lesser time of that and the fp32
    CUDA-core rate."""
    n32 = (a == torch.float32) + (b == torch.float32)
    pieces = (1, 3, 6)[n32]
    if n32 and flops / PEAK_FLOPS[torch.float32] < pieces * flops / PEAK_FLOPS[torch.bfloat16]:
        return [(flops, torch.float32)]
    return [(pieces * flops, torch.bfloat16)]


def seeded_inputs(dev, E: int, k: int, seed: int = 0):
    """(generator, randn, routed_offsets) on ``dev`` from ``seed``:
    ``randn(*shape, scale=, dtype=)`` draws normal values times ``scale``;
    ``routed_offsets(tokens)`` gives the per-expert row offsets, (E+1,)
    int32, of ``tokens`` tokens each routed to k of E experts at random."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def routed_offsets(tokens: int):
        ids = torch.rand((tokens, E), generator=g, device=dev).argsort(dim=1)[:, :k]
        counts = torch.bincount(ids.reshape(-1), minlength=E)
        return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)

    return g, randn, routed_offsets


def expert_gemm_cases(arch, capacity) -> dict:
    """The expert GEMMs the kernel phase times, at ``arch``'s widths:
    ``grouped`` (M, K, N, tag) capacity GEMMs, M = ``capacity(tokens, moe)``
    (down projections take fp32 x); ``serve`` (tag, tokens) ragged serving
    steps, gate-up d -> f and down f -> d; ``train`` (K, N, tag) the train
    step's ragged GEMMs over ``TRAIN_TOKENS`` tokens, fp32 x; ``dw`` (x
    dtype, K, N, tag) its weight gradients against an fp32 g."""
    d, f, k = arch.d_model, arch.moe.d_ff, arch.moe.top_k
    C = capacity(PREFILL_TOKENS, arch.moe)
    return {"grouped": [(C, d, f, "prefill gate/up"), (C, f, d, "prefill down"),
                        (1, d, f, "decode gate/up"), (1, f, d, "decode down")],
            "serve": [(f"prefill T={PREFILL_TOKENS * k}", PREFILL_TOKENS),
                      (f"decode T={DECODE_TOKENS * k}", DECODE_TOKENS)],
            "train": [(f, d, "train down"), (d, f, "train dh")],
            "dw": [(torch.bfloat16, d, f, "dW_gate/up"), (torch.float32, f, d, "dW_down")]}


def check(name: str, got, want, tol) -> float:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol)
    log(f"[check] {name}: max_abs_err={err:.3e} tol(rtol={tol['rtol']:g}, "
        f"atol={tol['atol']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(dev):
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import _capacity

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {', '.join(kernels._build.SOURCES)} built in "
        f"{time.perf_counter() - t0:.1f}s (nvcc, sm_90a)")

    arch = get_arch(ARCH)
    d, f, E, k = arch.d_model, arch.moe.d_ff, arch.moe.num_experts, arch.moe.top_k
    g, randn, routed_offsets = seeded_inputs(dev, E, k)
    timed = expert_gemm_cases(arch, _capacity)

    entries = {}

    def report(name, shape, dtype, launch, plain, library, nbytes, ops, err,
               source, replaces, design=None):
        """``dtype`` labels the entry; ``ops`` prices the work for the bound
        (see ``bound_ms``); ``design`` names the kernel design the launch
        takes, counted as ``<name>/<design>``."""
        ms = device_ms(launch)
        plain_ms = device_ms(plain, reps=5, warmup=1)
        lib_ms = None
        if library is not None:
            try:
                lib_ms = device_ms(library)
            except (RuntimeError, TypeError, NotImplementedError) as e:
                log(f"[time] {name}: library call unavailable ({type(e).__name__}: {e})")
        b_ms, b_by = bound_ms(nbytes, ops)
        via = f" via {name}/{design}" if design else ""
        log(f"[time] {name} {shape} {str(dtype)[6:]}{via}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f", bound {b_ms:.4f} ms ({b_by})")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "shape": f"{shape} {str(dtype)[6:]}", "design": design, "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}

    # Down-projections take the fp32 hidden activation, as in the model.
    # -- grouped_matmul_f32 (capacity dispatch) ------------------------------
    # Expert capacity C of each prefill bucket the serving phase's 64-512
    # token prompts reach (64 .. 512): 16, 32, 64 and 128 rows, which between
    # them take every tile shape of the tensor-core kernel.
    buckets = [(_capacity(t, arch.moe), d, f, f"bucket {t} gate/up") for t in (64, 128, 256)]
    for dtype in (torch.float32, torch.bfloat16):
        for (M, K, N, tag) in (*timed["grouped"], *buckets, (100, 96, 56, "edge"),
                               (3, 64, 40, "edge"), (16, 64, 40, "edge"), (17, 96, 56, "edge")):
            xdt = torch.float32 if "down" in tag else dtype
            x, w = randn(E, M, K, dtype=xdt), randn(E, K, N, scale=K ** -0.5, dtype=dtype)
            design = mm_ops.grouped_design(x.dtype, w.dtype, M)
            via = design if design == "fma" else f"{design}/{mm_ops.grouped_tile(x.dtype, M)}"
            err = check(f"grouped_matmul_f32 {tag} ({E},{M},{K})x({K},{N}) {xdt}x{dtype} "
                        f"via {via}", mm_ops.grouped_matmul_f32(x, w),
                        mm_ref.grouped_matmul_f32(x, w), GEMM_TOL)
            if tag.split()[0] in ("edge", "bucket"):  # checked, not timed
                continue
            e = report("grouped_matmul_f32", f"{tag} ({E},{M},{K})x({K},{N})", rate_dtype(x, w),
                       mm_ops.grouped_matmul_f32_launch(x, w)[1],
                       lambda: mm_ref.grouped_matmul_f32(x, w),
                       (lambda: torch.bmm(x, w)) if x.dtype == w.dtype else None,
                       x.numel() * x.element_size() + w.numel() * w.element_size()
                       + E * M * N * 4, gemm_ops(2 * E * M * K * N, x.dtype, w.dtype), err,
                       mm_ops._GROUPED[design].path,
                       "src/repro/kernels/moe_gemm/moe_gemm.py:67", design)
            if tag == "prefill gate/up" and dtype == torch.bfloat16:
                entries["grouped_matmul_f32"] = e

    # -- ragged_matmul_f32 / ragged_gate_up_silu_f32 (ragged dispatch) --------
    grouped_mm = getattr(torch, "_grouped_mm", None)
    cases = [(tag, routed_offsets(tokens)) for tag, tokens in timed["serve"]]
    cases += [(f"edge {c}", torch.tensor([0] + np.cumsum(c).tolist(), dtype=torch.int32,
                                         device=dev)) for c in RAGGED_COUNTS]

    def ragged_via(x, w) -> str:
        """The design (and tile) the wrapper picks for this ragged GEMM."""
        design = mm_ops.ragged_design(x.dtype, w.dtype, x.shape[0] / w.shape[0])
        return design if design == "fma" else (
            f"{design}/{mm_ops.ragged_tile(x.dtype, x.shape[0] / w.shape[0])}")

    def gate_up(x, wg, wu, offs, tag, err):
        """Time the fused gate-up-SiLU (design and tile as the wrapper picks
        them), and beside it, where x is bf16, two ``torch._grouped_mm`` and
        a SiLU: the same function in three calls, so printed, not an entry's
        library time."""
        T, (Ec, K_, F_), rows = x.shape[0], wg.shape, int(offs[-1])
        design, _, tile = ragged_via(x, wg).partition("/")
        touched = int((offs[1:] > offs[:-1]).sum())
        e = report("ragged_gate_up_silu_f32",
                   f"{tag} ({T},{K_})x2({Ec},{K_},{F_}){f' {tile}' if tile else ''}",
                   rate_dtype(x, wg), mm_ops.ragged_gate_up_silu_f32_launch(x, wg, wu, offs)[1],
                   lambda: mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs), None,
                   rows * K_ * x.element_size() + 2 * touched * K_ * F_ * wg.element_size()
                   + 3 * T * F_ * 4, gemm_ops(4 * rows * K_ * F_, x.dtype, wg.dtype), err,
                   mm_ops._GATE_UP[design].path, "src/repro/kernels/moe_gemm/moe_gemm.py:253",
                   design)
        if grouped_mm and x.dtype == wg.dtype == torch.bfloat16:
            ms = device_ms(lambda: torch.nn.functional.silu(grouped_mm(x, wg, offs=offs[1:]))
                           * grouped_mm(x, wu, offs=offs[1:]))
            log(f"[time] ragged_gate_up_silu_f32 {tag}: two torch._grouped_mm + SiLU "
                f"{ms:.4f} ms (informative: three calls, bf16 out)")
        return e

    def ragged_mm(x, w, offs, tag, err):
        """Time one ragged GEMM (design and tile as the wrapper picks them),
        beside the library's grouped GEMM where x and w share a dtype."""
        T, (Ec, K_, N_), rows = x.shape[0], w.shape, int(offs[-1])
        design, _, tile = ragged_via(x, w).partition("/")
        touched = int((offs[1:] > offs[:-1]).sum())
        return report("ragged_matmul_f32",
                      f"{tag} ({T},{K_})x({Ec},{K_},{N_}){f' {tile}' if tile else ''}",
                      rate_dtype(x, w), mm_ops.ragged_matmul_f32_launch(x, w, offs)[1],
                      lambda: mm_ref.ragged_matmul_f32(x, w, offs),
                      (lambda: grouped_mm(x, w, offs=offs[1:]))
                      if grouped_mm and x.dtype == w.dtype else None,
                      rows * K_ * x.element_size() + touched * K_ * N_ * w.element_size()
                      + T * N_ * 4, gemm_ops(2 * rows * K_ * N_, x.dtype, w.dtype), err,
                      mm_ops._RAGGED[design].path, "src/repro/kernels/moe_gemm/moe_gemm.py:178",
                      design)

    for dtype in (torch.float32, torch.bfloat16):
        for tag, offs in cases:
            Ec, rows = offs.numel() - 1, int(offs[-1])
            edge = tag.startswith("edge")
            T = rows + (5 if edge else 0)  # edge cases carry tail rows
            K_, F_ = (48, 64) if edge else (d, f)
            x = randn(T, K_, dtype=dtype)
            wg, wu = (randn(Ec, K_, F_, scale=K_ ** -0.5, dtype=dtype) for _ in range(2))
            wd = randn(Ec, F_, K_, scale=F_ ** -0.5, dtype=dtype)
            h = randn(T, F_)  # fp32 hidden
            gate = mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs)
            errs = [check(f"ragged_gate_up_silu_f32 {tag} {n} {dtype} via {ragged_via(x, wg)}",
                          a, b, GEMM_TOL)
                    for n, a, b in zip(("h", "a_g", "a_u"), gate,
                                       mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs))]
            down = mm_ops.ragged_matmul_f32(h, wd, offs)
            err = check(f"ragged_matmul_f32 {tag} fp32x{dtype} via {ragged_via(h, wd)}", down,
                        mm_ref.ragged_matmul_f32(h, wd, offs), GEMM_TOL)
            if dtype == torch.bfloat16:  # the same kernel on bf16 rows
                hb = h.to(dtype)
                err_b = check(f"ragged_matmul_f32 {tag} bf16 rows via {ragged_via(hb, wd)}",
                              mm_ops.ragged_matmul_f32(hb, wd, offs),
                              mm_ref.ragged_matmul_f32(hb, wd, offs), GEMM_TOL)
            if any(not (a[rows:] == 0).all() for a in (*gate, down)):
                fail(f"ragged kernels {tag}: rows past offsets[E] are not 0")
            if edge:
                continue
            e_gu = gate_up(x, wg, wu, offs, tag, max(errs))
            e_mm = ragged_mm(h, wd, offs, tag, err)
            if dtype == torch.bfloat16:
                ragged_mm(hb, wd, offs, f"{tag} bf16 rows", err_b)
                if tag.startswith("prefill"):
                    entries["ragged_matmul_f32"] = e_mm
                    entries["ragged_gate_up_silu_f32"] = e_gu

    # The training step's ragged GEMMs at T*k = 8192 rows (batch 2 x 512
    # tokens, top-8): the forward gate-up (bf16 rows, d -> 2 x d_ff), the
    # forward down projection (fp32 h, K = 512 -> 1536) and the backward's
    # dh (fp32 dy, 1536 -> 512), bf16 weights.
    offs = routed_offsets(TRAIN_TOKENS)
    rows = int(offs[-1])
    x = randn(rows, d, dtype=torch.bfloat16)
    wg, wu = (randn(E, d, f, scale=d ** -0.5, dtype=torch.bfloat16) for _ in range(2))
    errs = [check(f"ragged_gate_up_silu_f32 train T={rows} {n} via {ragged_via(x, wg)}", a, b,
                  GEMM_TOL)
            for n, a, b in zip(("h", "a_g", "a_u"), mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs),
                               mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs))]
    gate_up(x, wg, wu, offs, f"train T={rows}", max(errs))
    for K_, N_, tag in timed["train"]:
        x, w = randn(rows, K_), randn(E, K_, N_, scale=K_ ** -0.5, dtype=torch.bfloat16)
        err = check(f"ragged_matmul_f32 {tag} T={rows} ({rows},{K_})x({E},{K_},{N_}) fp32x"
                    f"bf16 via {ragged_via(x, w)}",
                    mm_ops.ragged_matmul_f32(x, w, offs), mm_ref.ragged_matmul_f32(x, w, offs),
                    GEMM_TOL)
        ragged_mm(x, w, offs, f"{tag} T={rows}", err)

    # -- ragged_dw_f32 (training backward, ragged dispatch) -------------------
    # The two operand pairs of RaggedFFN's backward: (bf16 x, fp32 da) for
    # dW_gate / dW_up and (fp32 h, fp32 dy) for dW_down, at T*k = 8192 rows,
    # then the edge cases with NaN tail rows.
    for xdt, K_, N_, tag in timed["dw"]:
        x, gr = randn(rows, K_, dtype=xdt), randn(rows, N_, scale=1e-2)
        err = check(f"ragged_dw_f32 {tag} ({rows},{K_})x({rows},{N_}) {xdt}xfp32 via tc",
                    mm_ops.ragged_dw_f32(x, gr, offs), mm_ref.ragged_dw_f32(x, gr, offs),
                    GEMM_TOL)
        xb, gb = x.to(torch.bfloat16), gr.to(torch.bfloat16)
        e = report("ragged_dw_f32", f"{tag} T={rows} ({rows},{K_})x({rows},{N_}) fp32 g",
                   xdt, mm_ops.ragged_dw_f32_launch(x, gr, offs)[1],
                   lambda: mm_ref.ragged_dw_f32(x, gr, offs),
                   # the library's grouped GEMM with the ragged dimension as
                   # its contraction (2-D x 2-D), on bf16 operands
                   (lambda: grouped_mm(xb.t(), gb, offs=offs[1:])) if grouped_mm else None,
                   rows * K_ * x.element_size() + rows * N_ * 4 + E * K_ * N_ * 4,
                   gemm_ops(2 * rows * K_ * N_, x.dtype, gr.dtype), err, mm_ops._DW.path,
                   "src/repro/kernels/moe_gemm/moe_gemm.py:335", "tc")
        if xdt == torch.bfloat16:
            entries["ragged_dw_f32"] = e
    for xdt in (torch.float32, torch.bfloat16):
        for c in RAGGED_COUNTS + [[0, 0, 0]]:
            o = torch.tensor([0] + np.cumsum(c).tolist(), dtype=torch.int32, device=dev)
            n = int(o[-1])
            x, gr = randn(n + 5, 48, dtype=xdt), randn(n + 5, 40)
            x[n:], gr[n:] = float("nan"), float("nan")
            check(f"ragged_dw_f32 edge {c} {xdt}xfp32 via tc", mm_ops.ragged_dw_f32(x, gr, o),
                  mm_ref.ragged_dw_f32(x, gr, o), GEMM_TOL)

    # -- flash_attention (prefill) -------------------------------------------
    hq, hkv, hd_ = arch.num_heads, arch.num_kv_heads, arch.head_dim
    fa_cases = [(1, 512, hq, hkv, hd_, None, None, "prefill"),
                (1, 64, hq, hkv, hd_, None, None, "prefill"),
                (1, 100, hq, hkv, hd_, None, None, "edge"),
                (2, 96, 4, 1, 16, None, 50.0, "edge"),
                (1, 256, 8, 8, 64, 64, None, "edge"),
                (1, 64, 2, 2, 128, 32, 30.0, "edge")]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h1, h2, dh, win, cap, tag in fa_cases:
            qkv = randn(b, s, h1 + 2 * h2, dh, dtype=dtype)  # strided views, as the model's
            q, kk, v = qkv[:, :, :h1], qkv[:, :, h1:h1 + h2], qkv[:, :, h1 + h2:]
            want = fa_ref.attention(q.transpose(1, 2).float(), kk.transpose(1, 2).float(),
                                    v.transpose(1, 2).float(), window=win,
                                    softcap=cap).transpose(1, 2).to(dtype)
            got = fa_ops.flash_attention(q, kk, v, window=win, logit_softcap=cap)
            design = fa_ops.design(dtype, dh)
            err = check(f"flash_attention {tag} b={b} s={s} hq={h1} hkv={h2} d={dh} "
                        f"window={win} softcap={cap} {dtype} via {design}", got, want,
                        FA_TOL[dtype])
            if tag == "edge":
                continue
            qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, kk, v))
            sz = q.element_size()
            e = report("flash_attention", f"b={b} s={s} hq={h1} hkv={h2} d={dh}", dtype,
                       fa_ops.flash_attention_launch(q, kk, v)[1],
                       lambda: fa_ref.attention(qc, kc, vc),
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           qc, kc, vc, is_causal=True, enable_gqa=True),
                       2 * b * s * h1 * dh * sz + 2 * b * s * h2 * dh * sz,
                       [(4 * b * h1 * dh * s * (s + 1) / 2, dtype)], err,
                       fa_ops._FLASH[design].path,
                       "src/repro/kernels/flash_attention/flash_attention.py:103", design)
            if s == 512 and dtype == torch.bfloat16:
                entries["flash_attention"] = e

    entries["ssd_intra_chunk"] = ssd_kernel_checks(dev, g, report)
    return entries


def ssd_kernel_checks(dev, g, report):
    """ssd_intra_chunk against its plain version at mamba2-370m's prefill
    shapes and the edge cases, B and C as stride-0 head views (one 1 x 200
    case with per-head B and C); returns the 4 x 2048 bf16 entry.  The
    /tc rows are priced as the kernel works: C.B^T once per chunk for
    head-broadcast B and C, the fp32 decayed scores . bf16 x as three bf16
    pieces (``gemm_ops``); the first version's pricing (C.B^T per head, the
    scores . x at the fp32 rate) is printed beside it."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    s = get_arch(SSM_ARCH).ssm
    h, p, n = s.num_heads(get_arch(SSM_ARCH).d_model), s.head_dim, s.state_size
    cases = [((4, 8, 256, h, p, n), "decay", "prefill 4 x 2048"),
             ((4, 1, 100, h, p, n), "decay", "prefill 4 x 100"),
             ((1, 1, 200, h, p, n), "decay", "prefill 1 x 200"),
             ((1, 2, 32, 4, 16, 8), "decay", "edge"), ((2, 2, 64, 8, 32, 16), "decay", "edge"),
             ((2, 3, 1, 4, 16, 8), "decay", "edge cl=1"),
             ((1, 2, 100, 4, 16, 16), "decay", "edge cl=100"),
             ((1, 2, 64, h, p, n), "strong", "edge dA~-50"),
             ((1, 2, 64, h, p, n), "zero", "edge dA=0"),
             ((1, 1, 200, h, p, n), "per-head", "edge per-head B/C 1 x 200")]
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        for (b, nc, cl, hh, pp, nn), law, tag in cases:
            x = (torch.randn((b, nc, cl, hh, pp), generator=g, device=dev) * 0.1).to(dtype)
            decay = -torch.randn((b, nc, cl, hh), generator=g, device=dev).abs() * 0.1
            dA = {"strong": torch.randn((b, nc, cl, hh), generator=g, device=dev) - 50.0,
                  "zero": torch.zeros((b, nc, cl, hh), device=dev)}.get(law, decay)
            bc = (b, nc, cl, hh if law == "per-head" else 1, nn)
            B, C = ((torch.randn(bc, generator=g, device=dev) * 0.5).to(dtype).expand(
                b, nc, cl, hh, nn) for _ in range(2))
            fold = [t.flatten(0, 1) for t in (x, dA.to(dtype), B, C)]
            want = ssd_ref.ssd_intra_chunk(*(t.float() for t in fold)).to(dtype)
            got = ssd_ops.ssd_intra_chunk(x, dA, B, C).flatten(0, 1)
            design = ssd_ops.design(dtype)
            shared = B.stride(3) == 0
            via = design if design == "fma" else (
                f"tc, {ssd_ops.heads_per_block(b * nc, cl, hh, pp, shared)} heads a block")
            err = check(f"ssd_intra_chunk {tag} (g={b * nc}, cl={cl}, h={hh}, p={pp}, "
                        f"n={nn}) B/C {'stride-0 views' if shared else 'per head'} {dtype} "
                        f"via {via}", got, want, SSD_TOL[dtype])
            if tag.startswith("edge"):
                continue
            sz, G = x.element_size(), b * nc
            pairs = G * hh * cl * (cl + 1) / 2  # the causal (l, s <= l) pairs
            # bytes: x, dA and y once, B and C once per (g, l) (head-broadcast
            # views); operations as the design does them (see the docstring)
            nbytes = 2 * G * cl * hh * pp * sz + 2 * G * cl * nn * sz + G * cl * hh * sz
            first = [(pairs * 2 * nn, rate_dtype(B, C)), (pairs * 2 * pp, torch.float32)]
            ops = first if design == "fma" else [
                (pairs / hh * 2 * nn, torch.bfloat16),
                *gemm_ops(pairs * 2 * pp, torch.float32, torch.bfloat16)]
            e = report("ssd_intra_chunk", f"{tag} (g={G},cl={cl},h={hh},p={pp},n={nn})",
                       dtype, ssd_ops.ssd_intra_chunk_launch(*fold)[1],
                       lambda: ssd_ref.ssd_intra_chunk(*fold), None, nbytes, ops, err,
                       ssd_ops._SSD[design].path, "src/repro/kernels/ssd/ssd.py:51", design)
            if design == "tc":
                old_ms, old_by = bound_ms(nbytes, first)
                log(f"[time] ssd_intra_chunk {tag} bf16: the first version's pricing "
                    f"(C.B^T per head, scores . x at the fp32 rate) gives a bound of "
                    f"{old_ms:.4f} ms ({old_by}); this design's {e['bound_ms']:.4f} ms "
                    f"({e['bound_by']})")
            if tag == "prefill 4 x 2048" and dtype == torch.bfloat16:
                entry = e
    return entry


# ---------------------------------------------------------------------------
# Phase 3: the reduced model on the card against the CPU
# ---------------------------------------------------------------------------


def small_parity_phase(dev):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params, map_tree

    base = get_arch(ARCH).reduced()
    params_cpu = init_params(base, torch.Generator().manual_seed(0), "cpu")
    params_gpu = map_tree(lambda t: t.to(dev), params_cpu)
    toks = torch.randint(0, base.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    for mode in ("capacity", "ragged"):
        arch = base.replace(moe=dataclasses.replace(base.moe, dispatch=mode))
        lm = LanguageModel(arch)
        want, _, _ = lm.forward(params_cpu, {"tokens": toks})
        got, _, _ = lm.forward(params_gpu, {"tokens": toks.to(dev)})
        check(f"reduced forward logits, card vs cpu, {mode}", got.cpu(), want,
              dict(rtol=0.0, atol=1e-5))
        train_parity(lm, params_cpu, dev, mode)
    ssm_small_parity(dev)


def ssm_small_parity(dev) -> None:
    """The reduced mamba2-370m, fp32: prefill of 64 tokens (two chunks) and
    of 20 (one short chunk), then 4 decode steps, on the card (kernel)
    against the CPU (plain version): logits and every cache leaf at 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
    from repro_torch.training import make_decode_step, make_prefill_step

    arch = get_arch(SSM_ARCH).reduced()
    lm = LanguageModel(arch)
    prefill, decode = make_prefill_step(lm, torch.float32), make_decode_step(lm, torch.float32)
    params_cpu = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    params_gpu = map_tree(lambda t: t.to(dev), params_cpu)
    toks = np.random.default_rng(2).integers(0, arch.vocab_size, (2, 68))
    tol = dict(rtol=0.0, atol=1e-5)
    for l in (64, 20):
        runs = []
        for p in (params_gpu, params_cpu):
            logits, cache = prefill(p, {"tokens": toks[:, :l]})
            out = [logits]
            for i in range(l, l + 4):
                logits, cache = decode(p, cache, {"tokens": toks[:, i:i + 1]}, i)
                out.append(logits)
            runs.append((out, tree_paths(cache)))
        (got, got_c), (want, want_c) = runs
        for i, (a, b) in enumerate(zip(got, want)):
            check(f"reduced {SSM_ARCH} prefill {l} + decode step {i}, card vs cpu",
                  a.cpu(), b, tol)
        for path, t in got_c.items():
            check(f"reduced {SSM_ARCH} cache {path} after prefill {l} + 4 steps, card vs cpu",
                  t.cpu(), want_c[path], tol)


def train_parity(lm, params_cpu, dev, mode: str) -> None:
    """Two fp32 train steps of the reduced model on the card (kernels)
    against the CPU (plain versions) from the same state.  Held as the CPU
    trajectory test holds the port against the JAX package
    (tests/test_torch_training.py): loss and grad norm within 1e-5
    relative; params within 1e-4, and within 1e-6 for all but 0.1 % of
    elements (an Adam step moves a weight by ~sign(g) * lr, so gradients
    that are ~0 by cancellation may move by a part of lr)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import map_tree, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.training import make_train_step

    step = make_train_step(lm, OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                           compute_dtype=torch.float32)
    states = []
    for where in ("cpu", dev):  # copies: the update runs in place
        p = map_tree(lambda t: t.to(where, copy=True), params_cpu)
        states.append({"params": p, **adamw_init(p)})
    data = SyntheticTokens(lm.arch.vocab_size, 2, 40)
    for i in range(2):
        batch = data.batch_at(i)
        _, want = step(states[0], batch)
        _, got = step(states[1], batch)
        for k in ("loss", "grad_norm"):
            w, g = float(want[k]), float(got[k])
            ok = abs(g - w) <= 1e-5 * abs(w) and got["skipped"] == want["skipped"] == 0
            log(f"[check] reduced train step {i} {k}, card vs cpu, {mode}: {g:.7f} vs "
                f"{w:.7f} (rtol 1e-5) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"reduced train step {i} {k} disagrees between card and cpu ({mode})")
    got = tree_paths(states[1]["params"])
    n = off = 0
    worst = 0.0
    for path, w in tree_paths(states[0]["params"]).items():
        diff = (got[path].cpu().double() - w.double()).abs()
        n, off = n + diff.numel(), off + int((diff > 1e-6).sum())
        worst = max(worst, float(diff.max()))
    ok = worst <= 1e-4 and off <= 1e-3 * n
    log(f"[check] reduced params after 2 train steps, card vs cpu, {mode}: max "
        f"|dparam| {worst:.3e} (<= 1e-4), {off} of {n} beyond 1e-6 (<= 0.1%) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"reduced train trajectory disagrees between card and cpu ({mode})")


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


PATH_KERNELS = {"capacity": ("flash_attention", "grouped_matmul_f32"),
                "ragged": ("flash_attention", "ragged_gate_up_silu_f32", "ragged_matmul_f32")}
SERVE_MODES = ("capacity", "ragged")
def check_designs(counts, label: str) -> str:
    """Fail unless every launch of a kernel with several designs in
    ``counts`` went through a design for bf16 weights (or bf16 inputs:
    ``ssd_intra_chunk``), never the one the ops module picks for fp32
    (serving's and training's weights are bf16, the down projection's
    hidden rows and the backward's gradients fp32 against bf16 weights),
    and every ``ragged_dw_f32`` launch through its one design; returns the
    per-design counts for the log."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    f32 = torch.float32
    shown = []
    for name, designs, fp32_design in (
            ("flash_attention", fa_ops._FLASH, fa_ops.design(f32, 64)),
            ("grouped_matmul_f32", mm_ops._GROUPED, mm_ops.grouped_design(f32, f32, 1)),
            ("ragged_matmul_f32", mm_ops._RAGGED, mm_ops.ragged_design(f32, f32, 1)),
            ("ragged_gate_up_silu_f32", mm_ops._GATE_UP, mm_ops.ragged_design(f32, f32, 1)),
            ("ragged_dw_f32", {"tc": mm_ops._DW}, None),
            ("ssd_intra_chunk", ssd_ops._SSD, ssd_ops.design(f32))):
        per = {dz: counts[f"{name}/{dz}"] for dz in designs}
        shown.append(f"{name}: " + ", ".join(f"/{dz} {n}" for dz, n in per.items()))
        if per.get(fp32_design) or sum(per.values()) != counts[name]:
            fail(f"{label}: {name} launches {counts[name]} by design {per}: a bf16 call "
                 f"reached /{fp32_design}, or a launch no design counted")
    return "; ".join(shown)


def serving_phase():
    """Serve under each dispatch; returns each run's launch counts and the
    ragged run's parity case."""
    from repro_torch import kernels
    from repro_torch.launch import serve

    counts, case = {}, None
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    for mode in SERVE_MODES:
        args = serve.parse_args(SERVE_ARGS + ["--dispatch", mode,
                                              "--metrics-out", str(tmp / f"{mode}.jsonl")])
        kernels.reset_launch_counts()
        s, c = serve.serve(args)
        counts[mode] = kernels.launch_counts()
        check_telemetry(s, ("decode", "prefill"), f"{mode} serving")
        log(f"[serving] {mode}: {s['finished']}/{s['requests']} requests finished, "
            f"decode {s['decode_tok_s']:.1f} tok/s, decode step p50 "
            f"{s['decode_step_p50_ms']:.2f} ms, prefill mean {s['prefill_ms_mean']:.2f} ms "
            f"({s['prefill_tokens']} prompt tokens, {s['steps']} engine steps, "
            f"{s['decode_steps']} decode steps), launches {counts[mode]}")
        if s["finished"] != s["requests"]:
            fail(f"{mode}: only {s['finished']}/{s['requests']} requests finished")
        for name in PATH_KERNELS[mode]:
            if counts[mode][name] == 0:
                fail(f"{mode} serving never launched {name}")
        log(f"[serving] {mode}: designs {check_designs(counts[mode], f'{mode} serving')}")
        if mode == "ragged":
            case = c
    shutil.rmtree(tmp, ignore_errors=True)
    return counts, case


def check_telemetry(summary, phases, label: str, n=None) -> None:
    """Fail unless the launcher's Chrome trace reads back and passes
    ``validate_chrome_trace`` and its drift report has samples of each of
    ``phases`` (exactly ``n`` each when given)."""
    from repro_torch import obs

    try:
        obs.validate_chrome_trace(json.loads(Path(summary["trace"]).read_text()))
    except ValueError as e:
        fail(f"{label}: chrome trace {summary['trace']} does not validate: {e}")
    rows = {p: summary["drift"].get(p, {}) for p in phases}
    log(f"[drift] {label}: " + "; ".join(
        f"{p} n={r.get('n', 0)} mean {r.get('mean_s', float('nan')) * 1e3:.3f} ms modeled "
        f"{(r.get('modeled_s') or float('nan')) * 1e3:.3f} ms ratio {r.get('ratio', float('nan')):.3f}"
        for p, r in rows.items()) + ", trace valid")
    for p, r in rows.items():
        if not r.get("n") or (n is not None and r["n"] != n):
            fail(f"{label}: drift row {p!r} has {r.get('n', 0)} samples, want "
                 f"{n if n is not None else 'some'}")


# ---------------------------------------------------------------------------
# Phase 5: the fp32 ragged paged-decode parity probe
# ---------------------------------------------------------------------------


def parity_phase(case) -> None:
    from repro_torch.launch import serve

    err = serve.decode_parity(case, ["ragged"])["ragged"]
    ok = err <= serve.PARITY_BOUND
    log(f"[parity] ragged paged decode vs uncached forward, fp32 full width: max "
        f"|dlogits| = {err:.3e} (bound {serve.PARITY_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("ragged paged decode disagrees with the uncached forward")


# ---------------------------------------------------------------------------
# Phase 6: where a serving step's time goes (torch.profiler)
# ---------------------------------------------------------------------------


def _kernel_name(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    if name.startswith(("grouped_mm_kernel", "grouped_tc_kernel", "ragged_kernel",
                        "ragged_tc_kernel", "ragged_dw_tc_kernel", "fa_fwd_kernel",
                        "fa_tc_kernel", "ssd_intra_chunk_kernel", "ssd_tc_kernel")):
        return name.split("(")[0]  # the port's kernels, with their template args
    return name.split("<")[0].split("(")[0]


def _profiled(fn, label: str) -> None:
    """Run ``fn`` under torch.profiler and print its wall time, the card's
    busy time (union of device activity), the idle share, the number of
    device activities and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = ev.time_range
        spans.append((r.start, r.end))
        n = _kernel_name(ev.name)
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + r.elapsed_us(), c + 1)
    if not spans:
        fail(f"profile {label}: torch.profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):  # union of intervals
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"(idle {100 * (1 - busy / wall_us):.1f}%), {len(spans)} device activities")
    for n, (t, c) in top:
        log(f"[profile]   {t / 1e3:9.3f} ms {c:6d}x  {n}")


def profile_phase(dev) -> None:
    """One 512-bucket prefill and 8 decode steps over 4 running sequences at
    full width, bf16, under each dispatch, each through ``Engine.step``; no
    launch may reach an ``/fma`` design."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serving import Engine, Request, ServeConfig

    base = get_arch(ARCH)
    params = init_params(base, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    rng = np.random.default_rng(0)
    cfg = ServeConfig(max_seqs=4, block_size=16, num_blocks=256, max_blocks_per_seq=40,
                      cache_dtype="bfloat16")
    for mode in ("capacity", "ragged"):
        arch = base.replace(moe=dataclasses.replace(base.moe, dispatch=mode))
        eng = Engine(LanguageModel(arch), params, cfg)
        kernels.reset_launch_counts()
        for rid in range(6):  # 0-1: prefill only (warm-up, profiled); 2-5 decode
            eng.submit(Request(rid=rid, tokens=rng.integers(0, arch.vocab_size, 500),
                               max_new_tokens=1 if rid < 2 else 64))
        eng.step()  # rid 0 prefills and retires
        _profiled(eng.step, f"{mode} prefill (500 tokens, bucket 512), 1 engine step")
        while eng.queue:
            eng.step()
        eng.step()
        _profiled(lambda: [eng.step() for _ in range(8)],
                  f"{mode} decode, 4 sequences, 8 engine steps")
        torch.cuda.synchronize()
        log(f"[profile] {mode}: designs "
            f"{check_designs(kernels.launch_counts(), f'{mode} profile')}")
        del eng


# ---------------------------------------------------------------------------
# Phases 7-9: mamba2-370m serving at full width and depth
# ---------------------------------------------------------------------------

PATH_KERNELS["ssm"] = ("ssd_intra_chunk",)


def _ssm_model(dev, dtype):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params

    arch = get_arch(SSM_ARCH)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev, dtype)
    return arch, LanguageModel(arch), params


def ssm_serving_phase(dev):
    """Greedy generation through make_prefill_step / make_decode_step, bf16;
    returns the launch counts of the timed 4 x 2048 run (its prefill and
    decode loop, no warm-up) and (lm, params) for the profile phase."""
    from repro_torch import kernels
    from repro_torch.training import make_decode_step, make_prefill_step

    arch, lm, params = _ssm_model(dev, torch.bfloat16)
    prefill, decode = make_prefill_step(lm), make_decode_step(lm)
    n_layers = arch.num_mamba_layers
    rng = np.random.default_rng(0)

    def counted(fn, label, want_ssd, total):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        others = {k: v for k, v in c.items() if v and not k.startswith("ssd_intra_chunk")}
        if (c["ssd_intra_chunk"] != want_ssd or c["ssd_intra_chunk/tc"] != want_ssd
                or c["ssd_intra_chunk/fma"] or others):
            fail(f"{label}: launches {c}, expected ssd_intra_chunk {want_ssd}, all through "
                 f"/tc, and no other kernel")
        check_designs(c, label)
        return out

    def generate(b, l, steps, label):
        """Returns the launch counts of this prefill and decode loop."""
        toks = rng.integers(0, arch.vocab_size, (b, l))
        total = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = counted(lambda: prefill(params, {"tokens": toks}),
                                f"{label} prefill", n_layers, total)
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        step_ms = []

        def loop():
            nonlocal logits
            for i in range(steps):
                tok = logits[:, :arch.vocab_size].argmax(-1, keepdim=True)
                t = time.perf_counter()
                logits, _ = decode(params, cache, {"tokens": tok}, l + i)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
            return logits

        counted(loop, f"{label} decode", 0, total)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if logits.shape != (b, lm.vp) or not torch.isfinite(logits[:, :arch.vocab_size]).all():
            fail(f"{label}: logits {tuple(logits.shape)} not finite")
        p50 = float(np.median(step_ms))
        log(f"[ssm] {SSM_ARCH} full width ({n_layers} layers, {arch.total_params() / 1e6:.1f} M "
            f"params, bf16) {label}: prefill {prefill_ms:.2f} ms ({b * l} tokens, "
            f"{1e3 * b * l / prefill_ms:.0f} tokens/s, {n_layers} ssd_intra_chunk launches), "
            f"{steps} decode steps p50 {p50:.2f} ms ({1e3 * b / p50:.1f} tokens/s, 0 kernel "
            f"launches), peak torch.cuda.max_memory_allocated {peak:.2f} GB")
        return total

    # Each shape's first call pays cuBLAS and cuDNN set-up: warm up first.
    runs = {}
    for b, l, steps in ((4, 2048, 32), (1, 200, 8)):
        generate(b, l, 2, f"warm-up {b} x {l}")
        runs[b, l] = generate(b, l, steps, f"{b} x {l}")
    return runs[4, 2048], (lm, params)


def ssm_parity_phase(dev) -> None:
    """fp32 at full width: prefill(248) + 8 decode steps against the
    uncached forward over the 256 tokens."""
    from repro_torch.training import make_decode_step, make_prefill_step

    arch, lm, params = _ssm_model(dev, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, arch.vocab_size, (1, 256)))
    with torch.no_grad():
        full, _, _ = lm.forward(params, {"tokens": toks.to(dev)})
    logits, cache = make_prefill_step(lm, torch.float32)(params, {"tokens": toks[:, :248]})
    decode = make_decode_step(lm, torch.float32)
    err = 0.0
    for i in range(248, 256):
        err = max(err, float((logits - full[:, i - 1]).abs().max()))
        logits, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]}, i)
    err = max(err, float((logits - full[:, 255]).abs().max()))
    ok = err <= SSM_PARITY_BOUND
    log(f"[parity] {SSM_ARCH} prefill 248 + 8 decode steps vs uncached forward over 256, "
        f"fp32 full width: max |dlogits| = {err:.3e} (bound {SSM_PARITY_BOUND:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("mamba2-370m decode disagrees with the uncached forward")


def ssm_profile_phase(model) -> None:
    from repro_torch.training import make_decode_step, make_prefill_step

    lm, params = model
    prefill, decode = make_prefill_step(lm), make_decode_step(lm)
    toks = np.random.default_rng(4).integers(0, lm.arch.vocab_size, (4, 2048))
    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill(params, {"tokens": toks})

    def run_decode():
        for i in range(8):
            tok = out["logits"][:, :lm.arch.vocab_size].argmax(-1, keepdim=True)
            out["logits"], _ = decode(params, out["cache"], {"tokens": tok}, 2048 + i)

    _profiled(run_prefill, f"{SSM_ARCH} prefill 4 x 2048")
    _profiled(run_decode, f"{SSM_ARCH} decode, 4 sequences, 8 steps")


# ---------------------------------------------------------------------------
# Phase 10: training at full width and depth
# ---------------------------------------------------------------------------

# An explicit dispatch: the launch counts below must not hang on the H100
# planner's table.  --metrics-out (a temporary directory) is added per run.
TRAIN_ARGS = ["--arch", ARCH, "--steps", "5", "--batch", "2", "--seq", "512",
              "--seed", "0", "--dispatch", "ragged"]
# Launches of each kernel per MoE layer and train step under ragged dispatch:
# RaggedFFN's forward (gate-up, down) and backward (dh, dx_g, dx_u; dW x 3).
TRAIN_LAUNCHES = {"ragged_gate_up_silu_f32": 1, "ragged_matmul_f32": 4,
                  "ragged_dw_f32": 3, "flash_attention": 0, "grouped_matmul_f32": 0,
                  "ssd_intra_chunk": 0}
PATH_KERNELS["train"] = tuple(n for n, c in TRAIN_LAUNCHES.items() if c)


def training_phase():
    """Train through `repro_torch.launch.train`; returns the run's launch
    counts and its summary."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    args = train.parse_args(TRAIN_ARGS + ["--metrics-out", str(tmp / "train.jsonl")])
    kernels.reset_launch_counts()
    summary, trainer, out = train.train(args)
    counts = kernels.launch_counts()
    check_telemetry(summary, ("step",), "training", n=summary["steps"] - 1)
    shutil.rmtree(tmp, ignore_errors=True)
    m = summary["model"]
    log(f"[model] training, granite full width, 2 x 512, ragged, priced on H100: t_step "
        f"{1e3 * m['t_step_s']:.2f} ms modeled vs step p50 {summary['step_p50_ms']:.1f} ms "
        f"measured (ratio {summary['step_p50_ms'] / (1e3 * m['t_step_s']):.2f}); mem_stage0 "
        f"{m['mem_stage0_gb']:.2f} GB modeled vs peak {summary['peak_mem_gb']:.2f} GB")
    steps = summary["steps"]
    per_step = {n: c / steps for n, c in counts.items()}
    log(f"[train] {summary['arch']} full width, {summary['params'] / 1e9:.3f} B params, "
        f"batch {args.batch} x seq {args.seq}, {summary['dispatch']} dispatch: {steps} steps, "
        f"{summary['skipped']} skipped, final loss {summary['loss']:.4f}, step times "
        f"{[round(1e3 * t, 1) for t in summary['step_times_s']]} ms, step p50 "
        f"{summary['step_p50_ms']:.1f} ms (steps 2-{steps}), {summary['tokens_per_s']:.0f} "
        f"tokens/s, peak torch.cuda.max_memory_allocated {summary['peak_mem_gb']:.2f} GB")
    log(f"[train] launches per step: {per_step}")
    log(f"[train] designs {check_designs(counts, 'training')}")
    if steps != 5 or summary["skipped"] or not np.isfinite(summary["loss"]):
        fail(f"training: {steps} steps, {summary['skipped']} skipped, loss {summary['loss']}")
    n_moe = sum(1 for _, ffn in get_arch(ARCH).layers if ffn == "moe")
    for name, k in TRAIN_LAUNCHES.items():
        if counts[name] != k * n_moe * steps:
            fail(f"training launched {name} {counts[name]} times, expected "
                 f"{k} x {n_moe} MoE layers x {steps} steps")
    batch = SyntheticTokens(get_arch(ARCH).vocab_size, args.batch, args.seq).batch_at(steps)
    state = out["state"]
    _profiled(lambda: trainer.train_step(state, batch),
              f"train step (full width, batch {args.batch} x {args.seq}, ragged)")
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 11: checkpoint, rollback and preemption at full width, depth 2
# ---------------------------------------------------------------------------

CKPT_DEPTH, CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 2, 12, 4, 2
CKPT_NAN_AT, CKPT_SIGTERM_AT = 5, 10  # train.nonfinite x 3 from 5; train.sigterm at 10
PATH_KERNELS["checkpoint"] = PATH_KERNELS["train"]


def _state_on_host(state) -> dict:
    from repro_torch.models.model import tree_paths

    return {k: t.detach().cpu() for k, t in tree_paths(state).items()}


def _max_gap(a: dict, b: dict) -> dict:
    """max |a - b| over the params, m and v leaves of two host states."""
    out = {}
    for part in ("params", "m", "v"):
        keys = [k for k in a if k.startswith(part + "/") and a[k].is_floating_point()]
        out[part] = max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)
    return out


def checkpoint_phase(dev):
    """Runs A and A2 (12 uninterrupted steps each), run B (checkpoints every
    4 steps, keep 2, NaN at steps 5-7 -> rollback to 4, SIGTERM at 10 ->
    final save) and its resume on a state from another seed, then a flipped
    byte in the newest checkpoint; returns run A's launch counts."""
    import dataclasses

    from repro_torch import kernels, obs
    from repro_torch.checkpoint import checkpoint_steps, leaf_crc32s, restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    arch = get_arch(ARCH).replace(num_layers=CKPT_DEPTH)
    arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch="ragged"))
    data = SyntheticTokens(arch.vocab_size, 2, 512)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    restores = []  # (step, live CRC32s == the manifest's, seconds of the check)

    def check_restores(mgr):
        """After each restore, the live state's CRC32s must be the manifest's."""
        real = mgr.restore_latest

        def restore(state):
            state, s = real(state)
            t0 = time.perf_counter()
            manifest = json.loads((mgr.directory / f"step_{s:08d}" / "manifest.json").read_text())
            restores.append((s, leaf_crc32s(state) == manifest["crc32"],
                             time.perf_counter() - t0))
            return state, s
        mgr.restore_latest = restore

    def run(seed, ckpt_dir=None, plan=None):
        ring = obs.RingBufferSink() if ckpt_dir is not None else None
        lm = LanguageModel(arch)
        trainer = Trainer(
            lm, OptimizerConfig(total_steps=CKPT_STEPS),
            TrainerConfig(total_steps=CKPT_STEPS, checkpoint_dir=ckpt_dir,
                          checkpoint_every=CKPT_EVERY, checkpoint_keep=CKPT_KEEP,
                          log_every=1000),
            log_fn=lambda m: log(f"[checkpoint] {m}"),
            injector=FaultInjector(FaultPlan(plan or []), log_fn=lambda m: log(f"[checkpoint] {m}")),
            telemetry=obs.Telemetry(sinks=[ring]) if ring is not None else None)
        if trainer.ckpt is not None:
            check_restores(trainer.ckpt)
        state = init_state(lm, torch.Generator(device=dev).manual_seed(seed), dev)
        out = trainer.fit(state, data)
        return trainer, out, ring

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    tr_a, out_a, _ = run(0)
    counts = kernels.launch_counts()
    host_a, loss_a = _state_on_host(out_a["state"]), float(out_a["metrics"]["loss"])
    del out_a
    _, out_a2, _ = run(0)
    host_a2, loss_a2 = _state_on_host(out_a2["state"]), float(out_a2["metrics"]["loss"])
    del out_a2
    n_moe = sum(1 for _, ffn in arch.layers if ffn == "moe")
    per_step = {n: counts[n] / CKPT_STEPS for n in TRAIN_LAUNCHES}
    log(f"[checkpoint] {arch.name} full width, depth {CKPT_DEPTH}, batch 2 x 512, ragged: run A "
        f"{CKPT_STEPS} steps, loss {loss_a:.6f}, step p50 "
        f"{1e3 * float(np.median(tr_a.step_times[1:])):.1f} ms; launches per step {per_step}")
    log(f"[checkpoint] designs {check_designs(counts, 'checkpoint run A')}")
    for name, k in TRAIN_LAUNCHES.items():
        if counts[name] != k * n_moe * CKPT_STEPS:
            fail(f"checkpoint run A launched {name} {counts[name]} times, expected "
                 f"{k} x {n_moe} MoE layers x {CKPT_STEPS} steps")
    gap_a2 = _max_gap(host_a2, host_a)
    deterministic = all(torch.equal(host_a[k], host_a2[k]) for k in host_a) and loss_a == loss_a2
    log(f"[checkpoint] run A2 against A: bitwise equal {deterministic}, max |gap| {gap_a2}, "
        f"loss {loss_a2:.9g} vs {loss_a:.9g}")
    del host_a2

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        log(f"[checkpoint] {root.parent}: {free_gb:.1f} GB free")
        if free_gb < 12:
            fail(f"checkpoint phase: {free_gb:.1f} GB free under {root.parent}, needs 12 "
                 f"(keep {CKPT_KEEP} checkpoints of ~3.3 GB and one in flight)")
        ckpt_dir = root / "ckpt"
        plan = [FaultSpec("train.nonfinite", step=CKPT_NAN_AT, count=3),
                FaultSpec("train.sigterm", step=CKPT_SIGTERM_AT)]
        _, out_b, ring_b = run(0, ckpt_dir, plan)
        steps_b = checkpoint_steps(ckpt_dir)
        anomalies = [a["step"] for a in out_b["anomalies"]]
        want_rb = [{"at_step": CKPT_NAN_AT + 2, "to_step": CKPT_EVERY}]
        log(f"[checkpoint] run B: anomalies {anomalies}, rollbacks {out_b['rollbacks']}, "
            f"stopped after step {out_b['last_step']}, checkpoints {steps_b}")
        if (anomalies != list(range(CKPT_NAN_AT, CKPT_NAN_AT + 3))
                or out_b["rollbacks"] != want_rb or out_b["last_step"] != CKPT_SIGTERM_AT - 1
                or steps_b != [2 * CKPT_EVERY, CKPT_SIGTERM_AT]):
            fail("checkpoint run B: wrong anomalies, rollbacks, stop or checkpoints")
        del out_b
        tr_r, out_r, ring_r = run(1, ckpt_dir)  # another seed: the restore must overwrite it
        log(f"[checkpoint] resume: from step {tr_r.resumed_from}, {len(tr_r.step_times)} steps, "
            f"ended after step {out_r['last_step']}, checkpoints {checkpoint_steps(ckpt_dir)}")
        if tr_r.resumed_from != CKPT_SIGTERM_AT or out_r["last_step"] != CKPT_STEPS - 1:
            fail("checkpoint resume: wrong start or end step")
        host_b, loss_b = _state_on_host(out_r["state"]), float(out_r["metrics"]["loss"])
        gap_b = _max_gap(host_b, host_a)
        if deterministic:
            ok = all(torch.equal(host_a[k], host_b[k]) for k in host_a) and loss_b == loss_a
            rule = "bitwise equal, as A2 is"
        else:
            ok = all(gap_b[p] <= gap_a2[p] for p in gap_b) and \
                abs(loss_b - loss_a) <= abs(loss_a2 - loss_a)
            rule = "no further from A than A2 is"
        log(f"[check] checkpoint: resumed run B against A, {rule}: max |gap| {gap_b}, loss "
            f"{loss_b:.9g} vs {loss_a:.9g} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("checkpoint: the resumed run disagrees with the uninterrupted one")
        del host_b, host_a

        # A flipped byte in the newest checkpoint: quarantined, restore falls back.
        newest = ckpt_dir / f"step_{CKPT_STEPS:08d}"
        leaf = newest / "params.embed.npy"
        with open(leaf, "r+b") as f:
            f.seek(-1000, 2)
            b = f.read(1)
            f.seek(-1000, 2)
            f.write(bytes([b[0] ^ 0xFF]))
        ring_f = obs.RingBufferSink()
        _, s = restore_checkpoint(ckpt_dir, out_r["state"], log_fn=lambda m: log(f"[checkpoint] {m}"),
                                  telemetry=obs.Telemetry(sinks=[ring_f]))
        manifest = json.loads((ckpt_dir / f"step_{s:08d}" / "manifest.json").read_text())
        crc_ok = leaf_crc32s(out_r["state"]) == manifest["crc32"]
        quarantined = (ckpt_dir / f"{newest.name}.corrupt" / "QUARANTINE_REASON").exists()
        ok = s == CKPT_SIGTERM_AT and crc_ok and quarantined and not newest.exists()
        log(f"[check] checkpoint: flipped byte in step {CKPT_STEPS}'s params/embed -> "
            f"quarantined {quarantined}, restored step {s}, live CRC32s equal the manifest's "
            f"{crc_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("checkpoint: corrupt checkpoint not quarantined or the fallback restore wrong")
        ok = len(restores) == 2 and all(r[1] for r in restores)
        log(f"[check] checkpoint: live CRC32s equal the manifest's after each trainer restore "
            f"(step, equal, seconds): {restores} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("checkpoint: a restore did not reproduce the checkpoint bit for bit")
        del out_r
    finally:
        shutil.rmtree(root, ignore_errors=True)

    events = [e for r in (ring_b, ring_r, ring_f) for e in r.events() if e["kind"] == "span"]
    spans = {n: [e for e in events if e["name"] == n]
             for n in ("ckpt.snapshot", "ckpt.save", "ckpt.verify", "ckpt.restore")}
    nbytes = spans["ckpt.save"][0]["attrs"]["bytes"]
    log(f"[checkpoint] bytes a checkpoint: {nbytes} ({nbytes / 1e9:.3f} GB)")
    for e in spans["ckpt.snapshot"]:
        log(f"[checkpoint] ckpt.snapshot (device -> host) step {e['attrs']['step']}: "
            f"{e['dur']:.3f} s, {nbytes / e['dur'] / 1e9:.2f} GB/s")
    for e in spans["ckpt.save"]:
        a = e["attrs"]
        log(f"[checkpoint] ckpt.save step {a['step']}: {e['dur']:.3f} s, "
            f"{nbytes / e['dur'] / 1e9:.2f} GB/s (crc {a['crc_s']:.3f} s, "
            f"{nbytes / a['crc_s'] / 1e9:.2f} GB/s; write {a['write_s']:.3f} s, "
            f"{nbytes / a['write_s'] / 1e9:.2f} GB/s)")
    for name in ("ckpt.verify", "ckpt.restore"):
        for e in spans[name]:
            log(f"[checkpoint] {name} step {e['attrs']['step']}: {e['dur']:.3f} s, "
                f"{nbytes / e['dur'] / 1e9:.2f} GB/s")
    ckpt_drift(arch, [e for r in (ring_b, ring_r, ring_f) for e in r.events()])
    during, other = [], []
    for run_events in (ring_b.events(), ring_r.events()):  # one clock each
        writes = [(e["ts"], e["ts"] + e["dur"]) for e in run_events
                  if e["name"] == "ckpt.save" and e["tid"] != threading.get_ident()]
        steps = [e for e in run_events if e["name"] == "train.step"][1:]  # 1st warms up
        for e in steps:
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            (during if any(a < t1 and t0 < b for a, b in writes) else other).append(e["dur"])
    log(f"[checkpoint] step p50 with an async write in flight {1e3 * float(np.median(during)):.1f} "
        f"ms ({len(during)} steps), without {1e3 * float(np.median(other)):.1f} ms "
        f"({len(other)} steps); peak torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def ckpt_drift(arch, events) -> None:
    """The checkpoint phase's ckpt.save and ckpt.restore spans against the
    H100 model's t_ckpt of this depth-2 shape; the full-depth shape's
    t_ckpt beside it (printed only)."""
    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100

    setup = rm.TrainSetup(b=2, s=512, zero="world", dispatch="ragged")
    tracker = obs.DriftTracker.for_train(rm.ModelShape.from_arch(arch), setup, H100)
    tracker.observe_events(events)
    log(tracker.format_report(f"drift {arch.name} depth {CKPT_DEPTH} checkpoint: measured "
                              f"vs the H100 model"))
    full = rm.ModelShape.from_arch(get_arch(ARCH))
    log(f"[model] checkpoint, granite full depth, priced on H100: t_ckpt "
        f"{rm.estimate(full, setup, H100).t_ckpt:.2f} s for "
        f"{rm.checkpoint_bytes(full) / 1e9:.2f} GB "
        f"(PERF.md: 26-30 s measured for 39.6 GB)")


# ---------------------------------------------------------------------------
# Phase "model": the micro-benchmarks and the planner on the card
# ---------------------------------------------------------------------------

GEMM_TOKENS, FFN_DIMS = 4096, (32, 64, 128, 256, 512, 1024, 2048)
ATTN_SEQS = (512, 1024, 2048, 4096)


def model_phase(dev) -> None:
    """core.microbench's expert-GEMM and attention curves in bf16 at
    granite's widths beside the H100 platform's gemm_efficiency and
    attn_eff; the 1-chip plan of the training phase's run; the production
    reports for training (256 H100s) and serving (16). Fails on a
    non-finite or non-positive measurement and on a 1-chip plan that does
    not fit; sets no bound on a drift ratio."""
    from repro_torch.configs import get_arch
    from repro_torch.core import microbench, planner
    from repro_torch.core.platform import H100
    from repro_torch.launch import train

    arch = get_arch(ARCH)
    peak = H100.peak_flops / 1e9  # GFLOP/s
    rows = microbench.expert_gemm_curve(arch.d_model, GEMM_TOKENS, FFN_DIMS,
                                        dtype=torch.bfloat16, device=dev)
    att = microbench.attention_curve(arch.num_heads * arch.head_dim, arch.num_heads, ATTN_SEQS,
                                     dtype=torch.bfloat16, device=dev)
    for r in rows:
        log(f"[model] expert GEMM ({GEMM_TOKENS},{arch.d_model})x({arch.d_model},{r['d_ffn']}) "
            f"bf16: {1e3 * r['seconds']:.4f} ms, {r['gflops'] / 1e3:.1f} TFLOP/s, "
            f"{r['gflops'] / peak:.4f} of peak (H100.gemm_efficiency({r['d_ffn']}) = "
            f"{H100.gemm_efficiency(r['d_ffn'])}), {r['efficiency']:.4f} of a 2048^3 GEMM")
    for r in att:
        log(f"[model] attention s={r['seq']} {arch.num_heads} heads x {arch.head_dim} bf16 "
            f"(flash_attention/tc): {1e3 * r['seconds']:.4f} ms, {r['gflops'] / 1e3:.1f} "
            f"TFLOP/s, {r['gflops'] / peak:.4f} of peak (H100.attn_eff = {H100.attn_eff})")
    log(f"[model] attention mean over s={ATTN_SEQS}: "
        f"{float(np.mean([r['gflops'] for r in att])) / peak:.4f} of peak")
    for r in rows + att:
        if not (np.isfinite(r["seconds"]) and r["seconds"] > 0 and np.isfinite(r["gflops"])
                and r["gflops"] > 0):
            fail(f"microbench row {r} is not finite and positive")
    one = planner.best_strategy(arch, H100, 1, batch=2, seq=512)
    if one is None or not one.estimate.mem_ok:
        fail("the planner found no 1-chip strategy that fits for granite, batch 2 x 512")
    log(f"[model] 1-chip plan, granite, batch 2 x 512 on H100: {one.describe()}")
    t0 = time.perf_counter()
    prod = train.production_strategy(ARCH, H100)  # the train launcher's, cached
    log(f"[model] production training plan, 256 x H100, batch 256 x 4096 "
        f"({time.perf_counter() - t0:.1f} s): {prod.describe() if prod else 'none feasible'}")
    srv = planner.best_serving_strategy(arch, H100, 16, context=2048, prefill_len=1024, slo_ms=20.0)
    log(f"[model] production serving plan, 16 x H100, 20 ms/token: "
        f"{srv.describe() if srv else 'none feasible'}")
    ssm = planner.best_serving_strategy(get_arch(SSM_ARCH), H100, 16, context=2048,
                                        prefill_len=1024, slo_ms=20.0)
    log(f"[model] {SSM_ARCH} serving plan, 16 x H100 (the model reads no SSM field): "
        f"{ssm.describe() if ssm else 'none feasible'}")


# ---------------------------------------------------------------------------
# Phase 12: expert parallelism (world 1 over NCCL; two gloo ranks on the card)
# ---------------------------------------------------------------------------

EP_DEPTH, EP_CF, EP_RANKS = 2, 16.0, 2
# (dispatch, a2a_chunks) of the two-rank train steps.
EP_CASES = (("ragged", 1), ("ragged", 2), ("capacity", 1), ("capacity", 2))
EP_SERVE = dict(requests=4, prompt=(64, 512), max_new=8, max_seqs=4)
EP_BATCH = (2, 512)  # the global train batch, split over the ranks by whole sequences
# The EP gradient gates: the reference's check_moe_ep (loss and gradients
# 2e-3, the embedding at relative 0.05 in norm) and, on every leaf, its
# largest gap at most EP_GRAD_REL of its largest magnitude, so that a
# gradient too small for 2e-3 to see (a halved expert gradient) fails.
EP_GRAD_REL = 0.02
PATH_KERNELS["ep"] = ("flash_attention", "grouped_matmul_f32", "ragged_gate_up_silu_f32",
                      "ragged_matmul_f32", "ragged_dw_f32")


def ep_prompts(vocab: int) -> list:
    """The two-rank serving run's prompts (``EP_SERVE``), from seed 0."""
    rng = np.random.default_rng(0)
    lo, hi = EP_SERVE["prompt"]
    return [rng.integers(0, vocab, size=int(n))
            for n in rng.integers(lo, hi + 1, size=EP_SERVE["requests"])]


def ep_kernel_checks(dev) -> None:
    """Every kernel of the "ep" path against its plain version at the
    shapes the two-rank run gives it on rank 0: granite at full width, E_l
    = E / EP_RANKS local experts, capacity factor EP_CF.  The ragged
    kernels take the receiver's buffer, EP_RANKS x (a chunk of the rank
    budget S = E_l x C) rows, of which only the rows routed to rank 0's
    experts are occupied: the rest is the sentinel tail, NaN here, which
    must come back 0 (and, for ``ragged_dw_f32``, never be read).
    * train (ragged; capacity training runs no kernel): T = 2 x 512 /
      EP_RANKS tokens a rank, a2a chunks 1 and 2: the gate-up (bf16 x), the
      down projection (fp32 h), the backward's dh and dx (fp32 against the
      transposed weights) and both weight gradients;
    * serving prefill, each rank's sequence shard of every bucket of the
      ``EP_SERVE`` prompts: ragged gate-up and down; capacity, the grouped
      GEMMs over (E_l, EP_RANKS x C, d) and (E_l, EP_RANKS x C, f);
    * decode, ``max_seqs`` tokens replicated: ragged over their T x k rows
      (the other rank's rows as the tail), capacity over (E_l, C, d)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import halo
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.models.moe import _capacity
    from repro_torch.serving.engine import _bucket

    arch = get_arch(ARCH)
    moe = dataclasses.replace(arch.moe, capacity_factor=EP_CF)
    d, f, E, k = arch.d_model, moe.d_ff, moe.num_experts, moe.top_k
    E_l, bf16 = E // EP_RANKS, torch.bfloat16
    g, randn, _ = seeded_inputs(dev, E, k, seed=3)
    wg, wu = (randn(E_l, d, f, scale=d ** -0.5, dtype=bf16) for _ in range(2))
    wd = randn(E_l, f, d, scale=f ** -0.5, dtype=bf16)
    wgt, wdt = mm_ops._transposed(wg), mm_ops._transposed(wd)
    n_checks, t0 = 0, time.perf_counter()

    def rank0_ids(tokens: int) -> torch.Tensor:
        """The rank-0 local expert ids of ``tokens`` tokens each routed to
        k of E experts at random, E_l (the sentinel) for the other ranks'."""
        ids = torch.rand((tokens, E), generator=g, device=dev).argsort(dim=1)[:, :k]
        return torch.where(ids < E_l, ids, E_l).reshape(-1)

    def offsets_of(ids: torch.Tensor) -> torch.Tensor:
        counts = torch.bincount(ids, minlength=E_l + 1)[:E_l]
        return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)

    def receiver_chunks(T: int, chunks: int):
        """(rows, offsets) of each chunk rank 0 receives: every source packs
        its rows for rank 0 sorted by expert into S slots, sentinel after."""
        S = E_l * _capacity(T, moe)
        recv = torch.full((EP_RANKS, S), E_l, dtype=torch.long, device=dev)
        for src in range(EP_RANKS):
            lid = rank0_ids(T).sort().values
            lid = lid[lid < E_l][:S]
            recv[src, :lid.numel()] = lid
        return [(EP_RANKS * size, offsets_of(recv[:, start:start + size].reshape(-1)))
                for start, size in halo.chunk_slices(S, chunks)]

    def nan_tail(rows, cols, n, dtype=torch.float32, scale=1.0):
        t = randn(rows, cols, scale=scale, dtype=dtype)
        t[n:] = float("nan")
        return t

    def held(name, got, want, n=None):
        nonlocal n_checks
        n_checks += 1
        check(f"ep path {name}", got, want, GEMM_TOL)
        if n is not None and not bool((got[n:] == 0).all()):
            fail(f"ep path {name}: rows past offsets[E_l] are not 0")

    def ragged(tag, R, offs, backward):
        n = int(offs[-1])
        shape = f"{tag} R={R} occupied={n} E_l={E_l}"
        x = nan_tail(R, d, n, bf16)
        for nm, a, b in zip(("h", "a_g", "a_u"), mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs),
                            mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs)):
            held(f"ragged_gate_up_silu_f32 {shape} {nm}", a, b, n)
        h = nan_tail(R, f, n)
        held(f"ragged_matmul_f32 {shape} down fp32 h", mm_ops.ragged_matmul_f32(h, wd, offs),
             mm_ref.ragged_matmul_f32(h, wd, offs), n)
        if not backward:
            return
        dy, da = nan_tail(R, d, n, scale=1e-2), nan_tail(R, f, n, scale=1e-2)
        held(f"ragged_matmul_f32 {shape} dh", mm_ops.ragged_matmul_f32(dy, wdt, offs),
             mm_ref.ragged_matmul_f32(dy, wdt, offs), n)
        held(f"ragged_matmul_f32 {shape} dx", mm_ops.ragged_matmul_f32(da, wgt, offs),
             mm_ref.ragged_matmul_f32(da, wgt, offs), n)
        held(f"ragged_dw_f32 {shape} dW_gate/up bf16 x", mm_ops.ragged_dw_f32(x, da, offs),
             mm_ref.ragged_dw_f32(x, da, offs))
        held(f"ragged_dw_f32 {shape} dW_down fp32 h", mm_ops.ragged_dw_f32(h, dy, offs),
             mm_ref.ragged_dw_f32(h, dy, offs))

    def grouped(tag, M):
        x, h = randn(E_l, M, d, dtype=bf16), randn(E_l, M, f)
        held(f"grouped_matmul_f32 {tag} ({E_l},{M},{d})x({d},{f}) gate/up",
             mm_ops.grouped_matmul_f32(x, wg), mm_ref.grouped_matmul_f32(x, wg))
        held(f"grouped_matmul_f32 {tag} ({E_l},{M},{f})x({f},{d}) down fp32 h",
             mm_ops.grouped_matmul_f32(h, wd), mm_ref.grouped_matmul_f32(h, wd))

    T_train = EP_BATCH[0] * EP_BATCH[1] // EP_RANKS
    for chunks in (1, 2):
        for i, (R, offs) in enumerate(receiver_chunks(T_train, chunks)):
            ragged(f"train x{chunks} chunk {i}", R, offs, backward=True)
    for bucket in sorted({_bucket(len(p)) for p in ep_prompts(arch.vocab_size)}):
        T = bucket // EP_RANKS
        for R, offs in receiver_chunks(T, 1):
            ragged(f"prefill bucket {bucket}", R, offs, backward=False)
        grouped(f"prefill bucket {bucket}", EP_RANKS * _capacity(T, moe))
    ids = rank0_ids(EP_SERVE["max_seqs"])
    ragged("decode", ids.numel(), offsets_of(ids.sort().values), backward=False)
    grouped("decode", _capacity(EP_SERVE["max_seqs"], moe))
    log(f"[check] ep path kernels at the two-rank run's shapes (E_l={E_l}, cf {EP_CF:g}, "
        f"NaN sentinel tails): {n_checks} checks ok ({time.perf_counter() - t0:.1f} s)")


def ep_world1_phase(train_summary) -> None:
    """``torchrun --nproc-per-node 1 -m repro_torch.launch.train --mesh 1,1``
    with the training phase's arguments: the process group over NCCL,
    EP = 1 (``moe_ffn_local``), its final loss against the training
    phase's, bitwise (else within 1e-6)."""
    import os
    import re

    torch.cuda.empty_cache()
    src = Path(__file__).resolve().parent / "src"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train", "--mesh", "1,1",
           "--backend", "nccl"] + TRAIN_ARGS
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(src)})
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith(("[mesh]", "[trainer] ep a2a", "[done]"))]
    for line in lines:
        log(f"[ep] world 1 (torchrun, nccl): {line}")
    if proc.returncode != 0:
        fail(f"ep world 1: torchrun exited {proc.returncode}: {proc.stderr[-3000:]}")
    m = re.search(r"\[done\] step=\d+ loss=(\S+)", proc.stdout)
    if m is None or not any(l.startswith("[mesh] devices=1 ep=1") for l in lines):
        fail("ep world 1: no [done] loss or [mesh] line")
    loss, want = float(m.group(1)), float(train_summary["loss"])
    ok = loss == want or abs(loss - want) <= 1e-6
    log(f"[check] ep world 1 over NCCL vs the training phase: loss {loss!r} vs {want!r} "
        f"({'bitwise' if loss == want else f'|d| {abs(loss - want):.3e}'}) "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("ep world 1: the loss differs from the training phase's")


def _ep_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the two-rank phase (``torch.multiprocessing``
    target); writes ``tmp/rank<r>.json``, or the failure there."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        out = _ep_rank_body(rank, world, tmp)
    except Exception as e:  # reported to the parent, which fails the phase
        out = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-3000:]}
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))


def ep_grad_gate(got: dict, want: dict):
    """The EP gradient gates (``EP_GRAD_REL``) on two {leaf: tensor} trees:
    (ok, {leaf: (max |gap|, max |want|, ok)}); the embedding's element-wise
    gate is its relative norm gap."""
    rows = {}
    for k, w in want.items():
        diff = got[k].float() - w.float()
        gap, scale = float(diff.abs().max()), float(w.abs().max())
        first = (float(diff.norm() / (w.float().norm() + 1e-9)) < 0.05 if k == "embed"
                 else gap < 2e-3)
        rows[k] = (gap, scale, first and gap <= EP_GRAD_REL * scale)
    return all(r[2] for r in rows.values()), rows


def _ep_rank_body(rank: int, world: int, tmp: str) -> dict:
    import dataclasses

    import torch.distributed as dist

    from repro_torch import kernels, sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.serving import Engine, Request, ServeConfig

    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank,
                            world_size=world)
    out = {"rank": rank}
    base = get_arch(ARCH).replace(num_layers=EP_DEPTH)
    opt = OptimizerConfig(lr=1e-3)  # step 1 of its 100-step warmup: lr 1e-5

    def arch_of(mode):
        return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode,
                                                    capacity_factor=EP_CF))

    batch = SyntheticTokens(base.vocab_size, *EP_BATCH).batch_at(0)
    params = init_params(base, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = ep_prompts(base.vocab_size)
    cfg = ServeConfig(max_seqs=EP_SERVE["max_seqs"], block_size=16, num_blocks=256,
                      max_blocks_per_seq=36, cache_dtype="bfloat16")

    def grads(arch, plan):
        loss, _, gr = training.loss_and_grads(LanguageModel(arch, plan),
                                              shard_params(params, plan), batch)
        return float(loss), {k: g for k, g in tree_paths(gather_params(gr, plan)).items()
                             if g is not None}

    def step(arch, plan):
        """One AdamW step from a copy of the params: (grad norm, skipped,
        the gathered params and first moment after it)."""
        p = map_tree(torch.clone, shard_params(params, plan))
        state = {"params": p, **adamw_init(p)}
        _, met = training.make_train_step(LanguageModel(arch, plan), opt)(state, batch)
        after = {k: tree_paths(gather_params(state[k], plan)) for k in ("params", "m")}
        return float(met["grad_norm"]), int(met["skipped"]), {
            k: {n: t for n, t in v.items() if t.is_floating_point()} for k, v in after.items()}

    def serve(arch, plan, p):
        """The served tokens, and the prefill logits of the longest prompt
        (the engine's first step, as a host array)."""
        eng = Engine(LanguageModel(arch, plan), shard_params(p, plan), cfg)
        res = eng.run([Request(rid=i, tokens=t, max_new_tokens=EP_SERVE["max_new"])
                       for i, t in enumerate(prompts)])
        lm, n = LanguageModel(arch, plan), max(len(t) for t in prompts)
        cache = lm.init_paged_cache(cfg.layout(), dtype=torch.bfloat16, device=dev)
        table = torch.arange(cfg.max_blocks_per_seq, dtype=torch.int32, device=dev)[None]
        long = torch.zeros((1, 1 << (n - 1).bit_length()), dtype=torch.long, device=dev)
        long[0, :n] = torch.from_numpy(max(prompts, key=len).astype(np.int64))  # right-padded
        with torch.no_grad():
            logits, _ = lm.prefill_paged(shard_params(p, plan), {"tokens": long}, cache,
                                         table, torch.tensor([n], device=dev))
        return [res[i] for i in sorted(res)], logits.float().cpu()

    def gate_line(rows) -> str:
        return ", ".join(f"{k.replace('blocks/0/', '')} {g:.2e}/{m:.2e}"
                         for k, (g, m, _) in rows.items())

    # World 1 on rank 0 first (the reference), while rank 1 waits.
    ref = {}
    if rank == 0:
        for mode in ("ragged", "capacity"):
            ref[mode] = grads(arch_of(mode), None)
            ref[f"step/{mode}"] = step(arch_of(mode), None)
            ref[f"serve/{mode}"] = serve(arch_of(mode), None, _bf16(params))
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    checks = []
    for mode, chunks in EP_CASES:
        arch = arch_of(mode)
        plan = sharding.make_plan(arch, (1, world), a2a_chunks=chunks)
        loss, full = grads(arch, plan)
        gn, skipped, after = step(arch, plan)
        if rank == 0:
            want_loss, want = ref[mode]
            ok_g, rows = ep_grad_gate(full, want)
            worst = max(rows, key=lambda k: rows[k][0] / max(rows[k][1], 1e-30))
            emb = float((full["embed"] - want["embed"]).norm() / (want["embed"].norm() + 1e-9))
            ok = abs(loss - want_loss) < 2e-3 and ok_g
            checks.append(ok)
            tag = f"train/{mode}/x{chunks}"
            out[tag] = (
                f"loss {loss!r} vs world 1 {want_loss!r} (|d| {abs(loss - want_loss):.3e} "
                f"< 2e-3); gradients: worst leaf {worst} max |d| {rows[worst][0]:.3e} of "
                f"max |want| {rows[worst][1]:.3e} (relative {rows[worst][0] / rows[worst][1]:.2e}"
                f" <= {EP_GRAD_REL:g}; < 2e-3), embed relative norm {emb:.3e} (< 0.05) "
                f"{'ok' if ok else 'FAIL'}")
            out[f"{tag} leaves"] = f"max |d| / max |want|: {gate_line(rows)}"
            if mode == "ragged" and chunks == 1:
                # The gate must see a halved expert gradient (every expert leaf).
                experts = sharding.expert_paths(full)
                bad = {k: v * 0.5 if k in experts else v for k, v in full.items()}
                caught = sorted(k for k, r in ep_grad_gate(bad, want)[1].items() if not r[2])
                ok_p = caught == sorted(experts)
                checks.append(ok_p)
                out["train/planted"] = (
                    f"expert gradients x 0.5 fail the gate at {len(caught)} of "
                    f"{len(experts)} expert leaves, nothing else "
                    f"{'ok' if ok_p else 'FAIL'}")
            gn1, skipped1, want_after = ref[f"step/{mode}"]
            ok_n = skipped == skipped1 == 0 and abs(gn - gn1) <= EP_GRAD_REL * gn1
            m_rows = ep_grad_gate(after["m"], want_after["m"])[1]
            m_rel = max(r[0] / max(r[1], 1e-30) for r in m_rows.values())
            ok_m = all(r[0] <= EP_GRAD_REL * r[1] for r in m_rows.values())
            lr = 1e-3 / 100
            p_gap = {k: (after["params"][k] - w).abs() for k, w in want_after["params"].items()}
            p_max = max(float(v.max()) for v in p_gap.values())
            p_frac = max(float((v > lr / 100).float().mean()) for v in p_gap.values())
            ok_p = p_max <= 2 * lr and p_frac <= 0.05
            checks.append(ok_n and ok_m and ok_p)
            out[f"step/{mode}/x{chunks}"] = (
                f"one AdamW step: grad norm {gn!r} vs world 1 {gn1!r} (relative "
                f"{abs(gn - gn1) / gn1:.2e} <= {EP_GRAD_REL:g}), skipped {skipped}; first "
                f"moment worst relative gap {m_rel:.2e} (<= {EP_GRAD_REL:g}); params max "
                f"|d| {p_max:.3e} (<= 2 lr = {2 * lr:g}), worst leaf's share moved "
                f"differently by > lr/100 {p_frac:.4f} (<= 0.05) "
                f"{'ok' if ok_n and ok_m and ok_p else 'FAIL'}")
        del full, after
    for mode in ("ragged", "capacity"):
        plan = sharding.make_plan(arch_of(mode), (1, world))
        tokens, logits = serve(arch_of(mode), plan, _bf16(params))
        if rank == 0:
            want, want_logits = ref[f"serve/{mode}"]
            ok = tokens == want
            checks.append(ok)
            gap = float((logits - want_logits).abs().max())
            out[f"serve/{mode}"] = (
                f"{len(tokens)} requests, tokens equal world 1's: {ok} "
                f"{'ok' if ok else 'FAIL'} (first: {tokens[0][:8]}); bf16 prefill logits "
                f"of the {len(max(prompts, key=len))}-token prompt, max |d| {gap:.3e}")
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["counts"] = kernels.launch_counts()
    out["ok"] = all(checks)
    dist.barrier()
    dist.destroy_process_group()
    return out


def _bf16(params):
    from repro_torch.models.model import map_tree

    return map_tree(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params)


def ep_phase(dev):
    """Two gloo ranks on the one card (EP = 2; granite full width, depth
    2, capacity factor 16): the train steps of ``EP_CASES`` and serving
    under both dispatches against world 1 on rank 0.  Returns the two
    ranks' summed launch counts of those runs (not of the world-1
    references)."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    ep_kernel_checks(dev)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    log(f"[ep] {EP_RANKS} gloo ranks on one {torch.cuda.get_device_name(0)}: gloo stages "
        f"every CUDA tensor of a collective through the host, so no all-to-all time of "
        f"this phase is a measurement of the card or its links (none is printed)")
    t0 = time.perf_counter()
    try:
        mp.start_processes(_ep_rank, args=(EP_RANKS, tmp), nprocs=EP_RANKS,
                           start_method="spawn")
        res = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(EP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in res:
        if "error" in r:
            fail(f"ep rank {res.index(r)}: {r['error']}\n{r['trace']}")
    for k, v in res[0].items():
        if k.startswith(("train/", "step/", "serve/")):
            log(f"[check] ep x{EP_RANKS} (gloo, depth {EP_DEPTH}, cf {EP_CF:g}) {k}: {v}")
    counts = {}
    for r in res:
        log(f"[ep] rank {r['rank']} launches: {r['counts']}")
        label = f"ep rank {r['rank']}"
        log(f"[ep] rank {r['rank']} designs {check_designs(r['counts'], label)}")
        for name, n in r["counts"].items():
            counts[name] = counts.get(name, 0) + n
    for name in PATH_KERNELS["ep"]:
        if any(r["counts"][name] == 0 for r in res):
            fail(f"ep: a rank never launched {name}")
    from repro_torch import sharding
    from repro_torch.configs import get_arch
    from repro_torch.core import microbench

    # The a2a micro-benchmarks at world 1 (a local copy; one rank's layer):
    # they run, but one card has no all-to-all to measure, so no time is shown.
    rows = microbench.a2a_bandwidth_curve((2**20,), device=dev)
    t = microbench.measure_a2a_overlap(sharding.single_device_plan(get_arch(ARCH)), rows=64,
                                       d=1536, d_ff=512, chunks=2, device=dev)
    if not (rows[0]["seconds"] > 0 and t > 0):
        fail("ep: an a2a micro-benchmark did not run")
    log("[ep] a2a micro-benchmarks (core/microbench.py) ran at world 1: nothing measured "
        "(one card has no all-to-all; their times are not printed)")
    log(f"[ep] phase {time.perf_counter() - t0:.1f} s (EP runs {res[0]['seconds']:.1f} s on "
        f"rank 0)")
    if not res[0]["ok"]:
        fail("ep: a two-rank run disagrees with world 1")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(src))
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    entries = kernel_phase(dev)
    log(f"[phase] kernels done at {time.perf_counter() - t0:.1f}s")
    model_phase(dev)
    log(f"[phase] model done at {time.perf_counter() - t0:.1f}s")
    small_parity_phase(dev)
    log(f"[phase] small parity done at {time.perf_counter() - t0:.1f}s")
    counts, case = serving_phase()
    log(f"[phase] serving done at {time.perf_counter() - t0:.1f}s")
    parity_phase(case)
    log(f"[phase] parity done at {time.perf_counter() - t0:.1f}s")
    profile_phase(dev)
    log(f"[phase] profile done at {time.perf_counter() - t0:.1f}s")
    counts["ssm"], model = ssm_serving_phase(dev)
    log(f"[phase] ssm serving done at {time.perf_counter() - t0:.1f}s")
    ssm_parity_phase(dev)
    log(f"[phase] ssm parity done at {time.perf_counter() - t0:.1f}s")
    ssm_profile_phase(model)
    del model
    log(f"[phase] ssm profile done at {time.perf_counter() - t0:.1f}s")
    counts["train"], train_summary = training_phase()
    log(f"[phase] training done at {time.perf_counter() - t0:.1f}s")
    counts["checkpoint"] = checkpoint_phase(dev)
    log(f"[phase] checkpoint done at {time.perf_counter() - t0:.1f}s")
    ep_world1_phase(train_summary)
    counts["ep"] = ep_phase(dev)
    log(f"[phase] ep done at {time.perf_counter() - t0:.1f}s")
    for name, e in entries.items():  # each main-path run's counts, and in all
        e["launches_by_path"] = {path: counts[path][name] for path in PATH_KERNELS}
        e["launches"] = sum(e["launches_by_path"].values())
    names = ("flash_attention", "grouped_matmul_f32", "ragged_gate_up_silu_f32",
             "ragged_matmul_f32", "ragged_dw_f32", "ssd_intra_chunk")
    if sorted(entries) != sorted(names):
        fail(f"kernel entries {sorted(entries)}")
    print(json.dumps({"kernels": [entries[n] for n in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
