#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [PHASE ...]

With no argument it runs every phase below.  With phase names
(``PHASES``: kernels, model, small_parity, serving, parity, profile,
dense_cache, ssm_serving, ssm_parity, ssm_profile, ssm_train, training,
checkpoint, ep, migrate, pipeline, mesh, memory, archs, frontend, dryrun) it builds
the kernels and runs those phases alone, with what they need (parity the
serving phase, ssm_profile SSM serving, ep and dryrun training), under the same set-up,
and prints each phase's seconds instead of the ``kernels`` and ``ok``
lines.

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
   mamba2-370m's prefill and decode steps likewise; the reduced
   jamba-1.5-large-398b (mamba and attention mixers, dense and MoE FFNs,
   ragged): fp32 forward logits, the training loss and every gradient,
   then a bf16 prefill and 4 decode steps through every
   kernel of its path, each kernel's first call at each shape against its
   plain version, the logits no further from the CPU's fp32 run than twice
   the CPU's bf16 run; the reduced mamba2's training loss, gradients and
   two train steps;
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
6b. dense cache: granite at full width and depth, ragged, through
   ``make_prefill_step`` / ``make_decode_step`` with a dense K/V cache.
   (a) fp32: 4 prompts of 248 tokens, 8 decode steps (cache_len 256)
   against the uncached forward over the 256, at the paged path's bound;
   (b) bf16: 4 x 512 prompts and 32 greedy steps after a warm-up, the
   tokens equal to the paged engine's on the same prompts and weights (a
   divergence only where the dense run's top-2 logits lie within 2e-2),
   the launches of flash attention and the ragged kernels a prefill and a
   decode step equal to the engine's; prefill ms, decode p50 beside the
   engine's, peak memory, and 8 dense decode steps under ``torch.profiler``.
   Each kernel's first call at each shape in (a)'s prefill and decode and
   in (b)'s warm-up (the same calls as its counted run, held by their
   launches) is held against its plain version on the same inputs;
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
9b. SSM training: (a) ``repro_torch.launch.train`` on mamba2-370m at full
   width and depth, 4 x 2048 tokens, bf16 compute, 5 steps: none skipped,
   no kernel launched (the SSD trains through its eager path, as the
   reference's), step p50, tokens/s, peak memory beside the modeled
   mem_stage0, the drift table, then one step under ``torch.profiler``;
   (b) fp32 at 1 x 2048: the training loss (eager SSD) against the
   cross-entropy of the forward's logits (the ``ssd_intra_chunk/fma``
   kernel, once a layer), within 1e-5 relative, and that kernel's call at
   this shape against its plain version;
10. training: ``repro_torch.launch.train.train`` at full width and depth
   (32 layers, fp32 masters and Adam moments, bf16 compute, ragged
   dispatch), batch 2 x 512 tokens, 5 steps on ``SyntheticTokens``, the
   launch counts zeroed just before and read just after: every step must
   have a finite loss and none may be skipped, and each step must launch
   the ragged kernels, per MoE layer, twice (gate-up: the forward and the
   backward's recompute under the default remat "full"), five times (the
   forward down-projection, its recompute and the three backward GEMMs)
   and three times (the weight gradients), none through an ``/fma``
   design.  With
   ``--metrics-out`` it prints the planner's lines and the drift report,
   and fails unless the trace validates and the ``step`` row has 4
   samples; the modeled t_step and mem_stage0 are printed beside the
   measured step p50 and peak memory.  Then one more step under
   ``torch.profiler``;
11. checkpoint: ``repro_torch.runtime.trainer.Trainer`` on granite at full
   width and depth 1 (ragged, batch 2 x 512): run A, 12 steps with no
   checkpoint (the launch counts zeroed before it and read after it,
   held per step as in phase 10); run B, checkpoints every 4
   steps, keep 2, NaN at steps 5-7 (rolled back to 4) and SIGTERM at 10
   (final save), then a fresh trainer on a state from another seed that
   resumes at 10 and ends at 12.  After each restore the live state's
   CRC32s must equal the manifest's; the resumed state and loss must equal
   A's bit for bit, or else a repeat A2 of run A (run only then) decides:
   bitwise if A2 equals A, else no further from A than A2.  A byte flipped in the newest checkpoint must be
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
   and depth 1 with capacity factor 16: train steps under both dispatches
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
   a2a micro-benchmarks run at world 1 and print no time either.  Every
   multi-rank run gives a rank the reference's block of the batch (its
   rows over data, its sequence slice over ep x tp).  (d) The train
   launcher on four gloo ranks at ``--mesh 2,2`` (full width, depth 1, 2 x
   512: a rank holds one row's 256 positions, so ep rank 1 attends to
   keys ep rank 0 holds) beside the same launch at world 1: the final
   loss within 2e-3, each rank's ``[mesh]`` line naming its rows and
   positions;
13. migrate: expert migration, hot-expert replicas, serving rebalance and
   the EP-agnostic checkpoint, on the same two gloo ranks, granite at full
   width and depth 1, EP = 2, cf 16, bf16, tokens in [0, 4) (the
   reference's check_migration_exactness stream).  (a) every kernel of the
   replica path against its plain version at its shapes (R = 2 channels
   over a rank's T x k rows, the hot experts' rows occupied, a NaN
   sentinel tail that must come back 0); (b) the two hottest experts as a
   live replica table against the sentinel table: the train step's loss
   and gathered gradients under both dispatches at phase 12's gates, and
   the served tokens; (c) ``Trainer`` migrations every 2 of 4 steps:
   params, m and v after each bitwise the manual permutation of the
   gathered state, and the loss trajectory against a run whose init
   carried the final tables (swap-only: bitwise, else 1e-6; from a live
   table, which the planner releases: 2e-3); (d) the engine with
   ``rebalance_every = 2`` on skewed prompts under both dispatches: at
   least one rebalance, tokens equal to the static engine's; (e) a
   checkpoint saved at EP = 2 after a migration restored at world 1 (rank
   0 alone) and at EP = 2 (CRC32s equal the manifest's, the state bitwise,
   the load EMA bit-exact), and its resume bitwise the uninterrupted run.
   The launch counts are zeroed before the two-rank runs and read after on
   each rank; every kernel of the path must be there, none through
   ``/fma``.  Prints each plan (imbalance before and after, swaps,
   replicas), its seconds and all-gathered bytes (gloo through the host,
   not NVLink), and the Table IV ``migration_cost`` of granite on
   ``core.platform.H100`` (modeled);
14. pipeline: the schedule-executing pipeline executor
   (``repro_torch.core.pipeline``) on two gloo ranks sharing the card,
   granite at full width and depth 4 (PP 2 x 2 reps, or PP 2 x V 2 x 1
   rep), ragged, bf16 compute, fp32 masters, cf 16, aux loss 0, batch 4 x
   512, M = 4.  (a) The ragged kernels against their plain versions at the
   microbatch's T x k = 4096 rows.  (b) gpipe, 1f1b, 1f1b_overlap, zb_h1
   and interleaved_1f1b (V = 2): loss and gathered gradients against world
   1 at phase 12's gates (printed per leaf), zb_h1 and 1f1b_overlap
   against 1f1b bitwise (else 1e-6), the executed residual, W-stash and
   comm traces equal to the IR's and the peaks to Eq 4 (GPipe: M; the
   interleaved analogue).  (c) The launch counts, zeroed before each
   schedule's step and read after it on each rank, equal to the IR's ops
   times one op's launches (``PIPE_OP_LAUNCHES``: the default remat
   "full" repeats each rep's forward in a B, Bi and Bw), none through
   ``/fma``.  (d) Four ranks at mesh 2,1,2 (PP 2 x EP 2), 1f1b, batch 8 x
   512, against world 1 at (b)'s gates.  (e) 1f1b with int8 hand-offs, its loss
   within 0.1 of the bf16 hand-offs', the bytes a hand-off beside
   ``resource_model.p2p_bytes_per_boundary``.  (f) ``torchrun
   --nproc-per-node 2`` of ``repro_torch.launch.train --mesh 2,1,1
   --pipeline`` at full width, depth 8 (4 layers a rank; 32, then 16,
   until the budget rule cut it), 3 steps: finite losses, a
   valid trace with two stage lanes, each rank's peak memory beside the
   modeled mem_stage0.  (g) Each schedule's step seconds, bubble fraction
   (``bubble_fraction`` and the IR's idle share), hand-offs and their
   bytes, residual-slot bytes.  gloo stages every hand-off through the
   host: no time here measures NVLink or NCCL p2p;
15. mesh: the rest of the pod axis, gloo ranks sharing the card, granite
   at full width, ragged, cf 16, bf16 compute.  (a) The three ragged
   kernels over a tp lane's receiver buffer (forward and backward), the
   decode step of a data rank's share, the grouped GEMMs of the capacity
   paths and flash attention at every prefill bucket, against their plain
   versions.  (b) Six ranks at ``--mesh 1,6`` (ep 2 x tp 3), depth 1, 6 x
   384 (6 rows x 64 positions a rank): loss and gathered gradients
   against the data grid ``--mesh 3,2`` (2 rows x 192 positions a rank, EP
   2, no tp) at the reference's EP gates (halved expert gradients must
   fail phase 12's), one AdamW step against the grid's as
   in phase 12, both grids against world 1 at the reference's EP gates
   (loss 2e-3, element-wise 2e-3, the embedding's relative norm 0.05), and
   the tp lanes of each EP rank holding bitwise-equal params after the
   step (of every leaf the rule table keeps whole: the sliced ones are
   each lane's own slices).  (c) The same ranks serving 4 requests under both dispatches:
   tokens equal world 1's.  (d) Two ranks at PP 2, depth 4, 1f1b, 4 x
   512, M 4, aux 0: run A uninterrupted; run B NaN x 3 -> rollback ->
   SIGTERM -> final save, its resume on another seed's state bitwise A
   (else no further from A than a repeat A2); the PP 2 checkpoint restored
   at world 1 and at PP 2 under interleaved_1f1b V 2 with CRC32s equal the
   manifest's; checkpoint bytes, save and restore seconds.  (e) Four ranks
   at PP 2 x EP 2 (2,1,2), depth 2, 4 x 256, M 2, tokens in [0, 4):
   migrations every 2 of 4 steps, each rank's params, m and v bitwise the
   manual permutation of its stage's slots, the loss trajectory bitwise a
   permuted-init run's (else 1e-6), a checkpoint saved after them restored
   at world 1 with CRC32s equal; one migration's seconds and all-gathered
   bytes.  (f) The same four ranks serving at ``--mesh 2,2`` and ``2,1,2``
   (the pod joining data), depth 1, both dispatches: tokens equal world
   1's.  Launch counts zeroed after the world-1 references and read at the
   end on each rank; every kernel of the phase's paths must be there, none
   through ``/fma``.  Step seconds and peak GB a rank for each grid are
   printed, not gated;
16. memory: the plan's memory policy, granite at full width, ragged, bf16
   compute.  First the ragged kernels against their plain versions at
   (b)'s shapes (2 x 4096 tokens top-8, 65,536 rows).  (a) Full depth, 2 x 512: a loss-and-gradients pass under
   remat none, dots, full and none again, the loss and every gradient leaf
   of dots and full bitwise none's (else no further than the repeat), the
   launches a pass exact (``MEM_REMAT_LAUNCHES``: dots recomputes the
   ragged kernels, which it cannot see), peak and pass p50 of each.  (b)
   Full depth, 2 x 4096 (the reference launcher's sequence): 3 train steps
   under remat full and dots, and none where the resource model's
   mem_stage0 fits 80 GB; finite losses, none skipped, launches exact,
   peaks beside mem_stage0.  (c) Full depth, 2 x 512, 5 steps with fp32
   and bf16 Adam moments: 4 and 2 B a float parameter a moment exactly,
   the losses within ``MEM_MOMENT_REL``, both peaks.  (d) Four gloo ranks
   sharing the card at ``--mesh 2,2`` (D 2 x ep 2), depth 1, 4 x 512, under
   three plans: "whole" (every leaf whole on each rank), "split" (the
   expert d_ff split in 2 alone) and "sliced" (the default: the rule table
   slices the embedding and attention leaves 4 ways too).  Each rank's
   expert params, m and v exactly half whole's under split and sliced, and
   every sliced leaf's exactly a quarter; the loss and gathered gradients
   of split and sliced bitwise whole's (else phase 12's gates); one AdamW
   step within 2 lr; each rank's peak, step seconds and held bytes under
   each plan beside the resource model's ``static_state_bytes`` under
   ``zero="world"``, the sliced step's gathers and backward sums in ms; a sliced checkpoint
   restored at world 1 with CRC32s equal the manifest's; a swap on the
   sliced layout bitwise the manual permutation; the served tokens equal
   world 1's, with the gathers' ms a forward (gloo; printed, not gated).
   Every multi-rank phase (ep, migrate, pipeline, mesh) runs the default
   sliced plan: its gates hold the sliced layout at full width;
17. archs: the dense and MoE archs that need no frontend.  (a)
   ``flash_attention`` at head dim 256 (gemma2-9b's 16 query heads over 8,
   b 1; s 512, 4096 and 6144, the window of 4096 masking only past 4096;
   window and none; softcap 50; q, k, v strided views of one fused
   projection), bf16 through ``/tc`` and fp32 through ``/fma``, each
   against its plain version at ``FA_TOL``, and their times at gemma2's
   local layer beside the bound, the plain version and SDPA (causal with
   GQA, a window mask past 4096, no softcap: SDPA has none), in the
   ``kernels`` line's flash entry under ``head_dim_256``.  (b) gemma2-9b
   at full width and depth (42 layers), random bf16 weights:
   ``launch.serve.serve`` on 4 requests of 4200-5120 prompt tokens, 8 new
   tokens each: all finished, no preemption, exactly 42
   ``flash_attention/tc`` launches a prefill, none ``/fma``, none in
   decode, no other kernel; prefill ms, decode p50 and peak memory.  Then
   fp32 (37 GB of weights): the uncached forward over request 0's
   sequence (``flash_attention/fma`` once a layer), and that sequence
   through the launcher's paged ``parity_probe`` (7 decode steps) and
   through ``make_prefill_step`` / ``make_decode_step`` (8, from the
   prompt's last token), each within
   ``PARITY_BOUND`` x max(1, the logits' largest magnitude), the
   absolute figure printed.  (c) smollm-360m at full width and depth:
   ``launch.serve.main`` (the granite serving cell's requests; bf16 engine,
   then its fp32 parity probe at ``PARITY_BOUND``; flash ``/tc`` once a
   layer a prefill, ``/fma`` only in the probe), then
   ``launch.train.train``, 5 steps at 2 x 512: none skipped, a finite
   loss, no kernel launched; step p50 and peak.  (d) grok-1-314b at full
   width and depth 1 (8 experts top-2, expert d_ff 32768, d_model 6144),
   bf16, under both dispatches: a 1 x 512 prefill and 4 decode steps,
   finite logits, every kernel of the dispatch's path launched, none
   through ``/fma``, each kernel's first call at each shape against its
   plain version.  The launch counts of (b)-(d) are this path's.
18. frontend: the frontend archs and the paper's own configs.  (a)
   ``flash_attention`` at qwen2-vl-7b's heads (28 over 4, d 128: a GQA
   group of 7) and musicgen-large's (32 over 32, d 64), causal, s 512 and
   4096, bf16 ``/tc`` and fp32 ``/fma``, each against its plain version at
   ``FA_TOL`` and timed beside the bound, the plain version and SDPA; the
   expert GEMMs at piper-m10b-e16's widths (16 experts top-2, K 5120, N
   20480; the gelu FFN's up and down projections, grouped at its capacity
   and ragged, the train pass's dh and both dW pairs) and
   piper-super-545b's (160 experts top-6, d_ff 3584), each against its
   plain version at ``GEMM_TOL`` and timed beside the bound, the plain
   version and the library's one call (``torch.bmm``,
   ``torch._grouped_mm``); all of (a) in the ``kernels`` line's entries
   under ``frontend``.  (b) qwen2-vl-7b at full width and depth (28
   layers, M-RoPE): ``launch.serve.serve`` bf16 on 4 requests of
   1024-2048 prompt tokens, 8 new each: all finished, no preemption,
   exactly 28 ``flash_attention/tc`` launches a prefill, none ``/fma``,
   none in decode; then fp32: request 0's sequence through the paged
   probe and the dense-cache steps against the uncached forward within
   ``PARITY_BOUND`` x max(1, the logits' largest magnitude), the forward
   on ``embeds`` equal to the table's rows of the tokens bitwise the token
   forward, and seeded random ``embeds`` through a prefill and 8 decode
   steps fed ``{"embeds": (1, 1, d)}`` alone, against the uncached
   forward over the same embeds within the same bound.  (c)
   musicgen-large at full width and depth (48 layers, no positional
   embedding): ``launch.serve.serve`` bf16, then its fp32 paged probe
   held as qwen2-vl's, then one ``make_train_step`` step on 2 x 512 seeded
   embeds in bf16 compute: finite loss and grad norm, none skipped, the
   untied table's moments exactly 0, no kernel; peak beside the resource
   model's mem_stage0.  (d) piper-m10b-e16 at full width, depth 1, bf16,
   under both dispatches: a 1 x 512 prefill and 4 decode steps, launches
   exactly the derived counts (gelu: two expert launches a MoE layer a
   pass, no fused gate-up), finite logits; then one forward and backward
   on 1 x 512 (ragged, fp32 masters, bf16 compute): finite loss and
   gradients, launches exactly ``GELU_TRAIN_LAUNCHES``.  (e)
   piper-super-545b at full width, depth 1, as (d)'s serving.  In (b)-(e)
   each kernel call's first at a shape is held against its plain version
   and no launch takes ``/fma`` in bf16.  The launch counts of (b)-(e)
   are this path's.
19. dryrun: ``repro_torch.launch.dryrun`` on this machine's CPU, no
   kernel.  (a) The training phase's step (granite, 2 x 512, ragged,
   remat full) traced at world 1 on fake tensors: its peak beside the
   training phase's ``torch.cuda.max_memory_allocated`` and its FLOPs
   beside 6 N_active tokens.  (b) The granite train_4k cell on a fake
   process group of 256 ranks, in a process started with the script: a
   rank's peak beside the resource model's mem_stage0.  Fails only if a
   trace errors or the record lacks a field.

The last two lines are a JSON object of per-kernel numbers and the result
line ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository's ``src/repro_torch`` beside this file, it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
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


# Ranks start from a fork server that has imported this script, torch,
# torch._dynamo (which ``torch.utils.checkpoint`` imports at its first
# call) and the port once (``main`` sets its preload list), instead of
# each spawned rank importing them again: that took 11-16 s a rank's first
# step (scripts/port_first_step_profile.py).  The server never touches the
# card, so its children initialise CUDA as spawned ones do.
RANK_START = "forkserver"
RANK_PRELOAD = ["__main__", "torch._dynamo", "torch.distributed", "repro_torch.training",
                "repro_torch.runtime.trainer", "repro_torch.serving", "repro_torch.launch.train"]


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


def kernel_row(name, shape, dtype, launch, plain, library, nbytes, ops, err,
               source, replaces, design=None):
    """Time one kernel launch beside its plain version, the library call
    (None: no one call computes it) and the bound; returns its row of the
    ``kernels`` line.  ``dtype`` labels the row; ``ops`` prices the work
    for the bound (see ``bound_ms``); ``design`` names the kernel design
    the launch takes, counted as ``<name>/<design>``.  The row carries no
    launch count: ``main`` adds the main path's to each kernel's entry."""
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
            "shape": f"{shape} {str(dtype)[6:]}", "design": design,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


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
            e = kernel_row("grouped_matmul_f32", f"{tag} ({E},{M},{K})x({K},{N})", rate_dtype(x, w),
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
        e = kernel_row("ragged_gate_up_silu_f32",
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
        return kernel_row("ragged_matmul_f32",
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
        e = kernel_row("ragged_dw_f32", f"{tag} T={rows} ({rows},{K_})x({rows},{N_}) fp32 g",
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
            e = kernel_row("flash_attention", f"b={b} s={s} hq={h1} hkv={h2} d={dh}", dtype,
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

    entries["ssd_intra_chunk"] = ssd_kernel_checks(dev, g)
    return entries


def ssd_kernel_checks(dev, g):
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
            e = kernel_row("ssd_intra_chunk", f"{tag} (g={G},cl={cl},h={hh},p={pp},n={nn})",
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
    jamba_small_parity(dev)


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


# A gradient leaf on the card against the CPU, fp32: its largest gap within
# this share of its largest magnitude, or of 1 where that is smaller (the
# CPU tests' model-parity atol, scaled up with the leaf).  A leaf's gradient
# sums many tokens' terms, so its rounding follows the largest of them:
# reduced jamba's embedding gradient (up to ~6.7) differs by 1.1e-5 on
# elements far smaller than that (measured on the card), as it differs
# from the JAX package's on the CPU (1.4e-5), and a sum that cancels (an
# A_log gradient of ~2e-3) keeps its terms' absolute rounding (4.4e-8).
GRAD_REL_FP32 = 1e-5


def grad_parity(lm, params_cpu, dev, label: str) -> None:
    """The fp32 training loss (1e-5 relative) and every gradient leaf of
    ``lm`` (``GRAD_REL_FP32`` of max(1, the leaf's largest magnitude)) on
    the card against the CPU."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import map_tree, tree_paths
    from repro_torch.training import loss_and_grads

    batch = SyntheticTokens(lm.arch.vocab_size, 2, 64).batch_at(0)
    runs = [loss_and_grads(lm, map_tree(lambda t: t.to(where), params_cpu), batch,
                           torch.float32) for where in (dev, "cpu")]
    (loss, _, grads), (want_loss, _, want) = runs
    ok = abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    log(f"[check] {label} training loss, card vs cpu, fp32: {float(loss):.7f} vs "
        f"{float(want_loss):.7f} (rtol 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: the training loss disagrees between card and cpu")
    want = tree_paths(want)
    bad, worst = [], (0.0, "", 0.0)
    for path, g in tree_paths(grads).items():
        if g is None:
            continue
        g, w = g.cpu().double(), want[path].double()
        gap, scale = float((g - w).abs().max()), max(1.0, float(w.abs().max()))
        worst = max(worst, (gap / scale, path, gap))
        if gap > GRAD_REL_FP32 * scale:
            bad.append(path)
    log(f"[check] {label} gradients, card vs cpu, fp32: {len(want)} leaves, worst "
        f"{worst[1]} {worst[2]:.3e} = {worst[0]:.3e} of max(1, its largest magnitude) "
        f"(<= {GRAD_REL_FP32:g}) {'ok' if not bad else 'FAIL'}")
    if bad:
        fail(f"{label}: gradients {bad[:4]} disagree between card and cpu")


# Reduced jamba in bf16 on the card: each kernel call it makes is held
# against its plain version on the same inputs at the kernel phase's
# tolerances; the whole run's logits against the CPU's fp32 run must lie no
# further than twice the CPU's own bf16 run does (bf16 moves the reduced
# model's logits 10-27 % of their magnitude on either side, the rounding
# of each kernel's one bf16 output and of the eager ops between them
# flipping some routes, measured on the card: no tighter model-level gate
# holds between two bf16 runs).
JAMBA_BF16_SLACK = 2.0
JAMBA = "jamba-1.5-large-398b"
PATH_KERNELS_JAMBA = ("flash_attention", "ragged_gate_up_silu_f32", "ragged_matmul_f32",
                      "ssd_intra_chunk")


class _FirstCalls:
    """Within the block, the inputs of the first call of each kernel
    wrapper of ``PATH_KERNELS_JAMBA``, of ``grouped_matmul_f32`` and of
    ``ragged_dw_f32`` (the ragged FFN's backward) at each shape and set of non-tensor keywords (a window, a softcap; ``calls``:
    (name, args, kwargs)), the model's own calls going through unchanged.
    It sees a call only through its module's attribute, so
    ``first_calls_against_plain`` fails a kernel launched with no call
    seen.  Inputs are copied, but for tensors whose storage is one of
    ``keep``'s (the model's weights, which no call writes: grok's experts
    are 3.2 GB a matrix), held as they are."""

    def __init__(self, keep=()):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.moe_gemm import ops as mm_ops
        from repro_torch.kernels.ssd import ops as ssd_ops

        self.targets = [(fa_ops, "flash_attention"), (mm_ops, "ragged_gate_up_silu_f32"),
                        (mm_ops, "ragged_matmul_f32"), (ssd_ops, "ssd_intra_chunk"),
                        (mm_ops, "grouped_matmul_f32"), (mm_ops, "ragged_dw_f32")]
        self.keep = {t.untyped_storage().data_ptr() for t in keep}
        self.calls, self.seen, self.saved = [], set(), []

    def _copy(self, t):
        if not torch.is_tensor(t) or t.untyped_storage().data_ptr() in self.keep:
            return t
        return t.clone()

    def __enter__(self):
        for mod, name in self.targets:
            real = getattr(mod, name)
            self.saved.append((mod, name, real))

            def wrapped(*a, _real=real, _name=name, **kw):
                key = ((_name,) + tuple(tuple(t.shape) + (t.dtype,) for t in a
                                        if torch.is_tensor(t))
                       + tuple(sorted((k, v) for k, v in kw.items() if not torch.is_tensor(v))))
                if key not in self.seen:
                    self.seen.add(key)
                    self.calls.append((_name, [self._copy(t) for t in a], dict(kw)))
                return _real(*a, **kw)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def first_calls_against_plain(calls, counts, label: str) -> None:
    """Each captured kernel call again on the card against its plain
    version on the same inputs (``FA_TOL``, ``GEMM_TOL``, ``SSD_TOL``), one
    at a time (each plain version's fp32 temporaries freed before the next).
    ``counts`` are the launches made while ``calls`` were captured: a
    kernel launched there with no captured call fails the run, since its
    check would hold nothing."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    seen = {name for name, _, _ in calls}
    unseen = sorted(n for n, v in counts.items() if v and "/" not in n and n not in seen)
    if unseen:
        fail(f"{label}: {unseen} launched with no call captured to hold against the plain "
             f"version")
    for name, a, kw in calls:
        shapes = "x".join(str(tuple(t.shape)) for t in a if torch.is_tensor(t))
        if name == "flash_attention":
            q, k, v = a
            shapes += "".join(f" {n}={kw[n]}" for n in ("window", "logit_softcap") if kw.get(n))
            got = fa_ops.flash_attention(q, k, v, **kw)
            want = fa_ref.attention(*(t.transpose(1, 2).float() for t in (q, k, v)),
                                    causal=kw.get("causal", True), window=kw.get("window"),
                                    softcap=kw.get("logit_softcap")).transpose(1, 2)
            pairs, tol = [(got, want.to(q.dtype))], FA_TOL[q.dtype]
        elif name == "ssd_intra_chunk":
            x, dA, B, C = a
            got = ssd_ops.ssd_intra_chunk(x, dA, B, C).flatten(0, 1)
            fold = [t.flatten(0, 1) for t in (x, dA.to(x.dtype), B, C)]
            pairs = [(got, ssd_ref.ssd_intra_chunk(*(t.float() for t in fold)).to(x.dtype))]
            tol = SSD_TOL[x.dtype]
        elif name == "ragged_gate_up_silu_f32":
            pairs = list(zip(mm_ops.ragged_gate_up_silu_f32(*a),
                             mm_ref.ragged_gate_up_silu_f32(*a)))
            tol = GEMM_TOL
        elif name == "grouped_matmul_f32":
            pairs = [(mm_ops.grouped_matmul_f32(*a), mm_ref.grouped_matmul_f32(*a))]
            tol = GEMM_TOL
        elif name == "ragged_dw_f32":
            pairs, tol = [(mm_ops.ragged_dw_f32(*a), mm_ref.ragged_dw_f32(*a))], GEMM_TOL
        else:
            pairs, tol = [(mm_ops.ragged_matmul_f32(*a), mm_ref.ragged_matmul_f32(*a))], GEMM_TOL
        for i, (got, want) in enumerate(pairs):
            check(f"{label} {name} {shapes}{f' out {i}' if len(pairs) > 1 else ''}, its "
                  f"first call at this shape", got, want, tol)
        del pairs, got, want


def jamba_small_parity(dev) -> None:
    """Reduced jamba (16 layers: mamba and attention mixers, dense and MoE
    FFNs, ragged, capacity factor 16) and reduced mamba2, on the card
    against the CPU: jamba's fp32 forward logits (at 1e-5 of their largest
    magnitude: its untied head gives logits up to ~6, where both packages'
    fp32 runs lie 1.4e-5 to 2.4e-5 from a float64 one, tests/test_torch_jamba.py),
    the training loss and every gradient (``grad_parity``; not
    ``train_parity``'s params after two Adam steps: the card's untied head
    and embedding gradients are not bitwise run to run, and Adam's first
    steps move an element whose gradient cancels to ~0 by a sizeable part
    of lr, 7.3e-05 and 1.44e-04 past that gate's 1e-4 in two runs of the
    same code); then a bf16 prefill of 32 and 4 decode steps through every
    kernel of its path (each launched, none through ``/fma``, each first
    call at a shape against its plain version), its logits against the
    CPU's fp32 run (``JAMBA_BF16_SLACK``); mamba2's training loss,
    gradients and two steps."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params, map_tree
    from repro_torch.training import make_decode_step, make_prefill_step

    base = get_arch(JAMBA).reduced()
    arch = base.replace(moe=dataclasses.replace(base.moe, dispatch="ragged",
                                                capacity_factor=16.0))
    lm = LanguageModel(arch)
    params_cpu = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, arch.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    want, _, _ = lm.forward(params_cpu, {"tokens": toks})
    got, _, _ = lm.forward(map_tree(lambda t: t.to(dev), params_cpu), {"tokens": toks.to(dev)})
    check(f"reduced {JAMBA} forward logits, card vs cpu, fp32", got.cpu(), want,
          dict(rtol=0.0, atol=1e-5 * float(want[..., :arch.vocab_size].abs().max())))
    grad_parity(lm, params_cpu, dev, f"reduced {JAMBA}")

    prompts = np.random.default_rng(2).integers(0, arch.vocab_size, (2, 36))
    runs = {}
    for where, dtype in ((dev, torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        p = map_tree(lambda t: t.to(where), params_cpu)
        prefill, decode = make_prefill_step(lm, dtype), make_decode_step(lm, dtype)
        kernels.reset_launch_counts()
        with _FirstCalls() as first:
            logits, cache = prefill(p, {"tokens": prompts[:, :32]})
            cache = lm.pad_cache(cache, 36)
            out = [logits]
            for i in range(32, 36):
                logits, cache = decode(p, cache, {"tokens": prompts[:, i:i + 1]}, i)
                out.append(logits)
        if where == dev:
            torch.cuda.synchronize()
            counts, calls = kernels.launch_counts(), first.calls
        runs[where, dtype] = [o.float().cpu()[:, :arch.vocab_size] for o in out]
    for name in PATH_KERNELS_JAMBA:
        if counts[name] == 0:
            fail(f"reduced {JAMBA} bf16 prefill and decode never launched {name}")
    log(f"[check] reduced {JAMBA} bf16 prefill 32 + 4 decode steps on the card: designs "
        f"{check_designs(counts, 'jamba bf16 prefill/decode')}")
    first_calls_against_plain(calls, counts, f"reduced {JAMBA} bf16")
    for i, (a, b, c) in enumerate(zip(runs[dev, torch.bfloat16], runs["cpu", torch.bfloat16],
                                      runs["cpu", torch.float32])):
        card, plain = float((a - c).abs().max()), float((b - c).abs().max())
        ok = bool(torch.isfinite(a).all()) and card <= JAMBA_BF16_SLACK * plain
        log(f"[check] reduced {JAMBA} bf16 {'prefill' if i == 0 else f'decode step {i}'}: "
            f"max |dlogits| against the cpu's fp32 run {card:.3e} on the card, {plain:.3e} "
            f"in the cpu's bf16 run (<= {JAMBA_BF16_SLACK:g}x; card vs cpu bf16 "
            f"{float((a - b).abs().max()):.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"reduced {JAMBA}: the card's bf16 run strays from fp32 beyond the cpu's")

    arch = get_arch(SSM_ARCH).reduced()
    lm = LanguageModel(arch)
    params_cpu = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    grad_parity(lm, params_cpu, dev, f"reduced {SSM_ARCH}")
    train_parity(lm, params_cpu, dev, f"{SSM_ARCH} (no MoE)", seq=64)


def train_parity(lm, params_cpu, dev, mode: str, seq: int = 40) -> None:
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
    data = SyntheticTokens(lm.arch.vocab_size, 2, seq)  # an SSM's: a multiple of its chunk
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
    # The raw device activities: ``prof.events()`` would first build a tree
    # of every CPU op in Python, ~10 s a decode window.
    spans, by_name = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        spans.append((start, start + dur))
        n = _kernel_name(ev.name())
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + dur, c + 1)
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
# Phase 9b: Mamba2 training at full width and depth
# ---------------------------------------------------------------------------

# The SSM serving cell's tokens, 5 steps; the planner binds remat "full".
SSM_TRAIN_ARGS = ["--arch", SSM_ARCH, "--steps", "5", "--batch", "4", "--seq", "2048",
                  "--seed", "0"]
SSM_TRAIN_FP32 = (1, 2048)
SSM_TRAIN_REL = 1e-5  # the eager SSD's loss against the kernel path's, fp32
PATH_KERNELS["ssm_train"] = ()  # the SSD has no backward: training runs no kernel


def ssm_train_phase(dev):
    """(a) ``launch/train.py --arch mamba2-370m`` at 4 x 2048, bf16 compute,
    5 steps: no step skipped (so every loss and grad norm finite), no
    kernel launched (the SSD's eager path), the drift table; (b) one fp32
    pass at 1 x 2048: the training loss (eager SSD) against the
    cross-entropy of ``LanguageModel.forward``'s logits (the SSD kernel,
    48 launches) on the same weights.  Returns (a)'s launch counts."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ssm_train_"))
    args = train.parse_args(SSM_TRAIN_ARGS + ["--metrics-out", str(tmp / "train.jsonl")])
    kernels.reset_launch_counts()
    summary, trainer, out = train.train(args)
    counts = kernels.launch_counts()
    check_telemetry(summary, ("step",), "ssm training", n=summary["steps"] - 1)
    shutil.rmtree(tmp, ignore_errors=True)
    m, steps = summary["model"], summary["steps"]
    log(f"[ssm_train] {summary['arch']} full width ({summary['params'] / 1e6:.1f} M params, "
        f"{get_arch(SSM_ARCH).num_layers} layers), batch {args.batch} x seq {args.seq}, remat "
        f"{summary['remat']}: {steps} steps, {summary['skipped']} skipped, final loss "
        f"{summary['loss']:.4f}, step times "
        f"{[round(1e3 * t, 1) for t in summary['step_times_s']]} ms, step p50 "
        f"{summary['step_p50_ms']:.1f} ms (steps 2-{steps}), {summary['tokens_per_s']:.0f} "
        f"tokens/s, peak torch.cuda.max_memory_allocated {summary['peak_mem_gb']:.2f} GB vs "
        f"mem_stage0 {m['mem_stage0_gb']:.2f} GB modeled (t_step {1e3 * m['t_step_s']:.3f} ms "
        f"modeled); launches {dict((k, v) for k, v in counts.items() if v)}")
    if steps != 5 or summary["skipped"] or not np.isfinite(summary["loss"]):
        fail(f"ssm training: {steps} steps, {summary['skipped']} skipped, loss {summary['loss']}")
    if any(counts.values()):
        fail(f"ssm training launched kernels {counts}: its SSD runs the eager path")
    batch = SyntheticTokens(get_arch(SSM_ARCH).vocab_size, args.batch, args.seq).batch_at(steps)
    state = out["state"]
    _profiled(lambda: trainer.train_step(state, batch),
              f"{SSM_ARCH} train step (full width, batch {args.batch} x {args.seq})")
    del trainer, out, state

    arch, lm, params = _ssm_model(dev, torch.float32)
    b, s = SSM_TRAIN_FP32
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticTokens(arch.vocab_size, b, s).batch_at(0).items()}
    with torch.no_grad():
        kernels.reset_launch_counts()
        loss, _ = lm.loss(params, batch)
        torch.cuda.synchronize()
        c_loss = kernels.launch_counts()
        kernels.reset_launch_counts()
        with _FirstCalls() as first:
            logits, _, _ = lm.forward(params, {"tokens": batch["tokens"]})
        torch.cuda.synchronize()
        c_fwd = kernels.launch_counts()
        labels = batch["labels"].long()
        ce = (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).mean()
    rel = abs(float(loss) - float(ce)) / abs(float(ce))
    ok = (rel <= SSM_TRAIN_REL and c_loss["ssd_intra_chunk"] == 0
          and c_fwd["ssd_intra_chunk"] == c_fwd["ssd_intra_chunk/fma"] == arch.num_mamba_layers)
    log(f"[check] {SSM_ARCH} full depth fp32 {b} x {s}: training loss (eager SSD) "
        f"{float(loss):.7f} vs forward's cross-entropy (ssd_intra_chunk/fma x "
        f"{c_fwd['ssd_intra_chunk']}) {float(ce):.7f}, relative {rel:.3e} (<= "
        f"{SSM_TRAIN_REL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the eager SSD's training loss disagrees with the kernel path's")
    del logits
    first_calls_against_plain(first.calls, c_fwd, f"{SSM_ARCH} full depth fp32 {b} x {s}")
    del params, first
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 6b: granite with a dense attention cache at full width and depth
# ---------------------------------------------------------------------------

DENSE_FP32 = dict(b=4, prompt=248, steps=8)  # cache_len 256: the uncached forward's
DENSE_BF16 = dict(b=4, prompt=512, steps=32)
DENSE_TIE = 2e-2  # a divergence must be a near-tie: top-2 logit gap of the dense run
PATH_KERNELS["dense_cache"] = ("flash_attention", "ragged_gate_up_silu_f32",
                               "ragged_matmul_f32")


def dense_cache_phase(dev):
    """granite-moe-3b-a800m (ragged) through ``make_prefill_step`` /
    ``make_decode_step`` with a dense K/V cache.  (a) fp32: 4 prompts of
    248, 8 decode steps on the true next tokens (cache_len 256), against the
    uncached forward over the 256, at the paged path's bound; (b) bf16: a
    warm-up, then 4 x 512 prompts and 32 greedy steps, the tokens against
    the paged engine's on the same prompts and weights (a divergence only
    at a near-tie), the launches a prefill and a decode step equal to the
    engine's.  Returns (b)'s launch counts."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serving import Engine, Request, ServeConfig
    from repro_torch.training import make_decode_step, make_prefill_step

    base = get_arch(ARCH)
    arch = base.replace(moe=dataclasses.replace(base.moe, dispatch="ragged"))
    lm = LanguageModel(arch)
    gen = torch.Generator(device=dev)

    # (a) fp32 parity against the uncached forward.
    b, l, k = DENSE_FP32["b"], DENSE_FP32["prompt"], DENSE_FP32["steps"]
    params = init_params(arch, gen.manual_seed(0), dev, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, arch.vocab_size, (b, l + k)))
    with torch.no_grad():
        full, _, _ = lm.forward(params, {"tokens": toks.to(dev)})
    kernels.reset_launch_counts()
    with _FirstCalls() as first:
        logits, cache = make_prefill_step(lm, torch.float32)(params, {"tokens": toks[:, :l]})
        cache = lm.pad_cache(cache, l + k)
        decode = make_decode_step(lm, torch.float32)
        err = 0.0
        for i in range(l, l + k):
            err = max(err, float((logits - full[:, i - 1]).abs().max()))
            logits, cache = decode(params, cache, {"tokens": toks[:, i:i + 1]}, i)
        err = max(err, float((logits - full[:, l + k - 1]).abs().max()))
    torch.cuda.synchronize()
    counted = kernels.launch_counts()
    ok = err <= serve.PARITY_BOUND
    log(f"[parity] {ARCH} dense cache: prefill {l} + {k} decode steps vs uncached forward over "
        f"{l + k}, {b} sequences, fp32 full width: max |dlogits| = {err:.3e} (bound "
        f"{serve.PARITY_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the dense-cache decode disagrees with the uncached forward")
    del full, cache, logits
    first_calls_against_plain(first.calls, counted, f"{ARCH} dense cache fp32 {b} x {l} + {k}")
    del params, first
    torch.cuda.empty_cache()

    # (b) bf16 greedy against the paged engine.
    b, l, k = DENSE_BF16["b"], DENSE_BF16["prompt"], DENSE_BF16["steps"]
    params = init_params(arch, gen.manual_seed(0), dev, torch.bfloat16)
    prefill, decode = make_prefill_step(lm), make_decode_step(lm)
    prompts = np.random.default_rng(6).integers(0, arch.vocab_size, (b, l))

    def greedy(steps, counted=None):
        """(tokens (b, steps + 1), top-2 gaps, prefill ms, decode step ms)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t0)
        if counted is not None:
            counted["prefill"] = kernels.launch_counts()
            kernels.reset_launch_counts()
        cache = lm.pad_cache(cache, l + steps)
        toks, gaps, step_ms = [], [], []
        for i in range(steps + 1):
            top = logits.float().topk(2, dim=-1)
            toks.append(top.indices[:, :1])
            gaps.append(top.values[:, 0] - top.values[:, 1])
            if i == steps:
                break
            t = time.perf_counter()
            logits, _ = decode(params, cache, {"tokens": toks[-1]}, l + i)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
        if counted is not None:
            counted["decode"] = kernels.launch_counts()
        return (torch.cat(toks, 1).cpu().numpy(), torch.stack(gaps, 1).cpu().numpy(), pre_ms,
                step_ms)

    # The warm-up pays each shape's first-call set-up and captures each
    # kernel's first call at each shape: the counted run below makes the
    # same calls (the same prompts and weights; decode attends eagerly, so
    # only the cache's length differs), held by its launches a prefill and
    # a decode step, and runs without the capture's copies.
    warm = {}
    with _FirstCalls() as first:
        greedy(2, warm)
    torch.cuda.reset_peak_memory_stats()
    dense = {}
    toks, gaps, pre_ms, step_ms = greedy(k, dense)
    peak = torch.cuda.max_memory_allocated() / 1e9
    p50 = float(np.median(step_ms))
    log(f"[dense_cache] {ARCH} full width bf16, ragged: prefill {b} x {l} {pre_ms:.2f} ms, "
        f"{k} decode steps p50 {p50:.2f} ms ({1e3 * b / p50:.1f} tokens/s), peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GB; launches a prefill "
        f"{dict((n, v) for n, v in dense['prefill'].items() if v)}, decode "
        f"{dict((n, v) for n, v in dense['decode'].items() if v)}")
    counts = {n: dense["prefill"][n] + dense["decode"][n] for n in dense["prefill"]}
    log(f"[dense_cache] designs {check_designs(counts, 'dense cache')}")
    for name in PATH_KERNELS["dense_cache"]:
        if counts[name] == 0:
            fail(f"dense cache never launched {name}")
    same = (warm["prefill"] == dense["prefill"]
            and all(2 * dense["decode"][n] == k * warm["decode"][n] for n in dense["decode"]))
    log(f"[check] dense cache bf16: the warm-up's launches a prefill and a decode step equal "
        f"the counted run's {'ok' if same else 'FAIL'}")
    if not same:
        fail("the dense cache's warm-up and counted runs launch differently")
    first_calls_against_plain(first.calls, {n: warm["prefill"][n] + warm["decode"][n]
                                            for n in warm["prefill"]},
                              f"{ARCH} dense cache bf16 {b} x {l} + decode")
    del first

    logits, cache = prefill(params, {"tokens": prompts})
    cache = lm.pad_cache(cache, l + 8)

    def window():
        nonlocal logits
        for i in range(8):
            logits, _ = decode(params, cache, {"tokens": logits.argmax(-1, keepdim=True)}, l + i)

    _profiled(window, f"{ARCH} dense-cache decode, {b} sequences, 8 steps")
    del cache, logits

    cfg = ServeConfig(max_seqs=b, block_size=16, num_blocks=256, max_blocks_per_seq=40,
                      cache_dtype="bfloat16")
    eng = Engine(lm, params, cfg)
    kernels.reset_launch_counts()
    out = eng.run([Request(rid=i, tokens=prompts[i], max_new_tokens=k + 1) for i in range(b)])
    torch.cuda.synchronize()
    paged = kernels.launch_counts()
    dec_s = serve._span_seconds(eng, "engine.decode")
    pre_s = serve._span_seconds(eng, "engine.prefill")
    log(f"[dense_cache] the paged engine on the same prompts: {eng.decode_steps} decode steps "
        f"p50 {1e3 * float(np.median(dec_s)):.2f} ms (dense {p50:.2f} ms, ratio "
        f"{p50 / (1e3 * float(np.median(dec_s))):.3f}), {b} prefills of 1 x {l} mean "
        f"{1e3 * float(np.mean(pre_s)):.2f} ms (dense {b} x {l} in one: {pre_ms:.2f} ms)")
    for name in PATH_KERNELS["dense_cache"]:
        per_prefill, per_step = dense["prefill"][name], dense["decode"][name] / k
        want = b * per_prefill + eng.decode_steps * per_step
        ok = paged[name] == want
        log(f"[check] dense cache launches of {name}: {per_prefill} a prefill, {per_step:g} a "
            f"decode step; the paged engine {paged[name]} over {b} prefills and "
            f"{eng.decode_steps} decode steps (want {want:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"dense and paged launches of {name} differ")
    paged_toks = np.asarray([out[i] for i in range(b)])
    same = paged_toks.shape == toks.shape and bool((paged_toks == toks).all())
    if same:
        log(f"[check] dense cache bf16 greedy tokens ({b} x {k + 1}) equal the paged "
            f"engine's ok")
    else:
        rows, cols = np.nonzero(paged_toks != toks)
        first = {int(r): int(c) for r, c in zip(rows[::-1], cols[::-1])}  # first per row
        worst = max(float(gaps[r, c]) for r, c in first.items())
        ok = worst < DENSE_TIE
        log(f"[check] dense cache bf16 greedy tokens ({b} x {k + 1}) against the paged "
            f"engine's: {len(first)} rows diverge, at {first}; the dense run's top-2 gap "
            f"there at most {worst:.3e} (< {DENSE_TIE:g}: a near-tie) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("dense and paged greedy tokens diverge away from a near-tie")
    del eng, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 10: training at full width and depth
# ---------------------------------------------------------------------------

# An explicit dispatch: the launch counts below must not hang on the H100
# planner's table.  --metrics-out (a temporary directory) is added per run.
TRAIN_ARGS = ["--arch", ARCH, "--steps", "5", "--batch", "2", "--seq", "512",
              "--seed", "0", "--dispatch", "ragged"]
# Launches of each kernel per MoE layer and train step under ragged dispatch
# and the default remat "full": RaggedFFN's forward (gate-up, down), the
# backward's recompute of it, and its backward (dh, dx_g, dx_u; dW x 3).
TRAIN_LAUNCHES = {"ragged_gate_up_silu_f32": 2, "ragged_matmul_f32": 5,
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
# Phase 11: checkpoint, rollback and preemption at full width, depth 1
# ---------------------------------------------------------------------------

# Depth 2 until PR 29's budget cut (PERF.md §6).
CKPT_DEPTH, CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 1, 12, 4, 2
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
    """Run A (12 uninterrupted steps; a repeat A2 only where the resume is
    not A's bit for bit), run B (checkpoints every 4 steps, keep 2, NaN at
    steps 5-7 -> rollback to 4, SIGTERM at 10 -> final save) and its resume
    on a state from another seed, then a flipped byte in the newest
    checkpoint; returns run A's launch counts."""
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
        ok = all(torch.equal(host_a[k], host_b[k]) for k in host_a) and loss_b == loss_a
        rule = "bitwise equal"
        if not ok:
            # A repeat A2 of run A decides: bitwise A's if A2 is, else no
            # further from A than A2.
            _, out_a2, _ = run(0)
            host_a2, loss_a2 = _state_on_host(out_a2["state"]), float(out_a2["metrics"]["loss"])
            del out_a2
            gap_a2 = _max_gap(host_a2, host_a)
            deterministic = (all(torch.equal(host_a[k], host_a2[k]) for k in host_a)
                             and loss_a == loss_a2)
            log(f"[checkpoint] run A2 against A: bitwise equal {deterministic}, max |gap| "
                f"{gap_a2}, loss {loss_a2:.9g} vs {loss_a:.9g}")
            if not deterministic:
                ok = all(gap_b[p] <= gap_a2[p] for p in gap_b) and \
                    abs(loss_b - loss_a) <= abs(loss_a2 - loss_a)
            rule = "bitwise equal, as A2 is" if deterministic else "no further from A than A2 is"
            del host_a2
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

# One layer rep: under remat "full" each rep's all-to-all runs again in
# the backward, and gloo stages every one through the host, so the
# multi-rank phases keep to one rep to stay inside the time limit.
EP_DEPTH, EP_CF, EP_RANKS = 1, 16.0, 2
# (dispatch, a2a_chunks) of the two-rank train steps.
EP_CASES = (("ragged", 1), ("ragged", 2), ("capacity", 1), ("capacity", 2))
EP_SERVE = dict(requests=4, prompt=(64, 512), max_new=8, max_seqs=4)
EP_BATCH = (2, 512)  # the global train batch: its sequence split over the ranks
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


# (d) of phase "ep": the train launcher on four gloo ranks at --mesh 2,2 (D 2 x
# ep 2), granite full width at EP_DEPTH, against the same launch at world 1.
# A rank holds one row's 256 positions: ep rank 1's queries attend to keys
# that ep rank 0 holds.
EP_SEQ_MESH, EP_SEQ_RANKS = "2,2", 4
EP_SEQ_ARGS = TRAIN_ARGS[:2] + ["--steps", "2"] + TRAIN_ARGS[4:]


def launcher_script(tmp: Path, depth: int) -> Path:
    """A wrapper of ``repro_torch.launch.train`` that cuts the registry's
    granite to ``depth`` layers in its process, the launcher unchanged."""
    launcher = tmp / "launch_train.py"
    launcher.write_text(
        "import sys\n"
        "from repro_torch.configs import ARCHS\n"
        f"ARCHS[{ARCH!r}] = ARCHS[{ARCH!r}].replace(num_layers={depth})\n"
        "from repro_torch.launch import ranks, train\n"
        "try:\n"
        "    train.main(sys.argv[1:])\n"
        "finally:\n"
        "    ranks.shutdown()\n")
    return launcher


def ep_seq_launcher() -> None:
    """(d) ``repro_torch.launch.train --mesh 2,2`` on four gloo ranks at full
    width, depth ``EP_DEPTH`` (rows over data, the sequence over ep), and
    beside it the same launch at world 1: the final loss held to world 1's
    at phase 12's loss gate (2e-3), and every rank's ``[mesh]`` line naming
    the rows and positions it holds."""
    import os
    import re

    src = Path(__file__).resolve().parent / "src"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ep_seq_"))
    launcher = launcher_script(tmp, EP_DEPTH)
    env = {**os.environ, "PYTHONPATH": str(src)}
    cmds = {"world 1": [sys.executable, str(launcher)] + EP_SEQ_ARGS,
            f"mesh {EP_SEQ_MESH}": [sys.executable, "-m", "torch.distributed.run",
                                    "--standalone", "--nproc-per-node", str(EP_SEQ_RANKS),
                                    str(launcher), "--mesh", EP_SEQ_MESH, "--backend",
                                    "gloo"] + EP_SEQ_ARGS}
    t0 = time.perf_counter()
    procs = {}
    try:
        for k, c in cmds.items():
            procs[k] = subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True, env=env)
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():  # stops what a timeout or an error left running
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    losses = {}
    for k, (out, err) in outs.items():
        if procs[k].returncode != 0:
            errors = [l for l in err.splitlines() if "Error" in l][-12:]
            fail(f"ep (d) {k}: the launcher exited {procs[k].returncode}: " + "\n".join(errors))
        for line in out.splitlines():
            if line.startswith(("[mesh]", "[done]")):
                log(f"[ep] (d) {k}: {line}")
        m = re.search(r"\[done\] step=1 loss=(\S+) skipped=0", out)
        if m is None:
            fail(f"ep (d) {k}: no [done] line at step 1 without a skip")
        losses[k] = float(m.group(1))
    args = dict(zip(EP_SEQ_ARGS[::2], EP_SEQ_ARGS[1::2]))
    b, s = int(args["--batch"]), int(args["--seq"])
    D, n = (int(x) for x in EP_SEQ_MESH.split(","))
    sl = s // n
    want = {f"[mesh] rank {r} (p, d, e, t) = (0, {r // n}, {r % n}, 0): rows "
            f"[{r // n * (b // D)}, {(r // n + 1) * (b // D)}) x positions [{r % n * sl}, "
            f"{(r % n + 1) * sl}): {b // D * sl} tokens" for r in range(EP_SEQ_RANKS)}
    # The ranks print at once through one pipe, so a line may follow
    # another's without its newline: find them in the whole stream.
    got = set(re.findall(r"\[mesh\] rank \d+ \(p, d, e, t\) = \([^)]*\): rows \[\d+, \d+\)"
                         r" x positions \[\d+, \d+\): \d+ tokens",
                         outs[f"mesh {EP_SEQ_MESH}"][0]))
    one, grid = losses["world 1"], losses[f"mesh {EP_SEQ_MESH}"]
    ok = got == want and abs(grid - one) < 2e-3
    log(f"[check] ep (d) the train launcher at --mesh {EP_SEQ_MESH} ({EP_SEQ_RANKS} gloo "
        f"ranks, full width, depth {EP_DEPTH}, {b} x {s}, 2 steps; the sequence over ep) vs "
        f"world 1: final loss {grid!r} vs {one!r} (|d| {abs(grid - one):.3e} < 2e-3); every "
        f"rank's [mesh] line names its rows and positions: {got == want} "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s, both launches side by "
        f"side)")
    if not ok:
        fail(f"ep (d): the sequence-sharded launch disagrees with world 1 or its ranks' "
             f"blocks ({sorted(got)})")


def _bf16(params):
    from repro_torch.models.model import map_tree

    return map_tree(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params)


def ep_phase(dev):
    """Two gloo ranks on the one card (EP = 2; granite full width, depth
    2, capacity factor 16): the train steps of ``EP_CASES`` and serving
    under both dispatches against world 1 on rank 0; then (d), the train
    launcher on four gloo ranks at ``EP_SEQ_MESH`` against world 1
    (:func:`ep_seq_launcher`).  Returns the two ranks' summed launch
    counts of the first part (not of the world-1 references or of (d))."""
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
                           start_method=RANK_START)
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
    if not res[0]["ok"]:
        fail("ep: a two-rank run disagrees with world 1")
    torch.cuda.empty_cache()
    ep_seq_launcher()
    log(f"[ep] phase {time.perf_counter() - t0:.1f} s (EP runs {res[0]['seconds']:.1f} s on "
        f"rank 0)")
    return counts


# ---------------------------------------------------------------------------
# Phase 13: expert migration, replicas, serving rebalance, EP-agnostic
# checkpoint (two gloo ranks on the card, as phase 12)
# ---------------------------------------------------------------------------

MIG_DEVICE = "cuda"
MIG_STEPS, MIG_EVERY, MIG_THRESHOLD = 4, 2, 1.05
MIG_SERVE = dict(requests=4, prompt=(32, 128), max_new=8, max_seqs=4)
MIG_REPLICAS = 2
PATH_KERNELS["migrate"] = PATH_KERNELS["ep"]


def mig_batch(step: int) -> dict:
    """The skewed training stream (the reference's check_migration_exactness
    stream: tokens in [0, 4)) at ``EP_BATCH``, a pure function of the step."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, 4, size=EP_BATCH, dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


class _MigTokens:
    def batch_at(self, step: int) -> dict:
        return mig_batch(step)


def mig_prompts() -> list:
    """Skewed prompts (ids in [0, 4)) of ``MIG_SERVE``, from seed 0."""
    rng = np.random.default_rng(0)
    lo, hi = MIG_SERVE["prompt"]
    return [rng.integers(0, 4, size=int(n))
            for n in rng.integers(lo, hi + 1, size=MIG_SERVE["requests"])]


def _mig_base():
    from repro_torch.configs import get_arch

    return get_arch(ARCH).replace(num_layers=EP_DEPTH)


def migrate_kernel_checks(dev) -> None:
    """Every kernel of the replica path against its plain version at the
    shapes the two-rank run gives it: R = ``MIG_REPLICAS`` channels (R
    "experts" of (d, f) weights) over a rank's T x k rows, only the rows
    routed to the two hot experts occupied, the rest the sentinel tail
    (NaN here), which must come back 0: the train step's T x k = 4096
    rows (gate-up, down, dh, dx and both weight gradients) and decode's
    ``max_seqs`` x k."""
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref

    arch = _mig_base()
    d, f, k, R = arch.d_model, arch.moe.d_ff, arch.moe.top_k, MIG_REPLICAS
    bf16 = torch.bfloat16
    g, randn, _ = seeded_inputs(dev, R, k, seed=4)
    wg, wu = (randn(R, d, f, scale=d ** -0.5, dtype=bf16) for _ in range(2))
    wd = randn(R, f, d, scale=f ** -0.5, dtype=bf16)
    wgt, wdt = mm_ops._transposed(wg), mm_ops._transposed(wd)
    n_checks, t0 = 0, time.perf_counter()

    def nan_tail(rows, cols, n, dtype=torch.float32, scale=1.0):
        t = randn(rows, cols, scale=scale, dtype=dtype)
        t[n:] = float("nan")
        return t

    def held(name, got, want, n=None):
        nonlocal n_checks
        n_checks += 1
        check(f"migrate replica path {name}", got, want, GEMM_TOL)
        if n is not None and not bool((got[n:] == 0).all()):
            fail(f"migrate replica path {name}: rows past offsets[R] are not 0")

    for tag, tokens, backward in (("train", EP_BATCH[0] * EP_BATCH[1] // EP_RANKS, True),
                                  ("decode", MIG_SERVE["max_seqs"], False)):
        rows = tokens * k
        # Each hot expert takes about a fifth of the rows (top-k of skewed
        # routing); the rest go through the dispatch.
        hot = torch.randint(rows // 8, rows // 4 + 1, (R,), generator=g, device=dev)
        offs = torch.cat([hot.new_zeros(1), hot.cumsum(0)]).to(torch.int32)
        n = int(offs[-1])
        shape = f"{tag} R={R} rows={rows} occupied={n}"
        x = nan_tail(rows, d, n, bf16)
        for nm, a, b in zip(("h", "a_g", "a_u"), mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs),
                            mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs)):
            held(f"ragged_gate_up_silu_f32 {shape} {nm}", a, b, n)
        h = nan_tail(rows, f, n)
        held(f"ragged_matmul_f32 {shape} down fp32 h", mm_ops.ragged_matmul_f32(h, wd, offs),
             mm_ref.ragged_matmul_f32(h, wd, offs), n)
        if not backward:
            continue
        dy, da = nan_tail(rows, d, n, scale=1e-2), nan_tail(rows, f, n, scale=1e-2)
        held(f"ragged_matmul_f32 {shape} dh", mm_ops.ragged_matmul_f32(dy, wdt, offs),
             mm_ref.ragged_matmul_f32(dy, wdt, offs), n)
        held(f"ragged_matmul_f32 {shape} dx", mm_ops.ragged_matmul_f32(da, wgt, offs),
             mm_ref.ragged_matmul_f32(da, wgt, offs), n)
        held(f"ragged_dw_f32 {shape} dW_gate/up bf16 x", mm_ops.ragged_dw_f32(x, da, offs),
             mm_ref.ragged_dw_f32(x, da, offs))
        held(f"ragged_dw_f32 {shape} dW_down fp32 h", mm_ops.ragged_dw_f32(h, dy, offs),
             mm_ref.ragged_dw_f32(h, dy, offs))
    log(f"[check] migrate replica path kernels (R={R} channels, NaN sentinel tails): "
        f"{n_checks} checks ok ({time.perf_counter() - t0:.1f} s)")


def _migrate_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of phase 13 (``torch.multiprocessing`` target); writes
    ``tmp/rank<r>.json``, or the failure there."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        out = _migrate_rank_body(rank, world, tmp)
    except Exception as e:  # reported to the parent, which fails the phase
        out = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-3000:]}
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _migrate_rank_body(rank: int, world: int, tmp: str) -> dict:
    import dataclasses

    import torch.distributed as dist

    from repro_torch import kernels, sharding
    from repro_torch.checkpoint import leaf_crc32s, read_extras, restore_checkpoint
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.core import migration as mig
    from repro_torch.device import resolve_device
    from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serving import Engine, Request, ServeConfig
    from repro_torch.training import init_state, loss_and_grads

    dev = resolve_device(MIG_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank,
                            world_size=world)
    out, checks = {"rank": rank}, []
    base = _mig_base()
    opt = OptimizerConfig(lr=1e-3)
    quiet = lambda s: None  # noqa: E731
    lead = rank == 0

    def arch_of(mode, replicas=MIG_REPLICAS, aux=None):
        kw = dict(dispatch=mode, capacity_factor=EP_CF, max_replicas=replicas)
        if aux is not None:
            kw["aux_loss_coef"] = aux
        return base.replace(moe=dataclasses.replace(base.moe, **kw))

    def record(tag, ok, line):
        checks.append(bool(ok))
        if lead:
            out[tag] = f"{line} {'ok' if ok else 'FAIL'}"

    def sharded(state, plan):
        return {k: shard_params(v, plan) if k in ("params", "m", "v") else v
                for k, v in state.items()}

    def host_state(tr, state, keys=None):
        """The gathered state on the host, rank 0 (a collective)."""
        full = tree_paths(tr.global_state(state))
        if not lead:
            return None
        return {k: np.array(v.detach().cpu()) for k, v in full.items()  # copies
                if keys is None or k.rpartition("/")[2] in keys}

    def with_table(params, table):
        blocks = tuple({**b, "ffn": {**b["ffn"], "replicas": torch.tensor(
            table, dtype=torch.int32, device=dev).expand_as(b["ffn"]["replicas"]).contiguous()}}
            if "ffn" in b else b for b in params["blocks"])
        return {**params, "blocks": blocks}

    def serve(arch, plan, params, extra=None):
        """(tokens, the engine's rebalances, the bf16 logits of the longest
        prompt's prefill and of one decode step after it, token 0, in slot
        0 of a ``max_seqs``-wide decode as the engine runs it)."""
        cfg = ServeConfig(max_seqs=MIG_SERVE["max_seqs"], block_size=16, num_blocks=256,
                          max_blocks_per_seq=16, cache_dtype="bfloat16", **(extra or {}))
        p = map_tree(torch.clone, shard_params(_bf16(params), plan))  # the engine's own
        lm = LanguageModel(arch, plan)
        long = max(mig_prompts(), key=len)
        toks = torch.zeros((1, 1 << (len(long) - 1).bit_length()), dtype=torch.long,
                           device=dev)
        toks[0, :len(long)] = torch.from_numpy(long.astype(np.int64))
        layout = cfg.layout()
        cache = lm.init_paged_cache(layout, dtype=torch.bfloat16, device=dev)
        table = torch.full((cfg.max_seqs, cfg.max_blocks_per_seq), layout.sentinel,
                           dtype=torch.int32, device=dev)
        table[0] = torch.arange(cfg.max_blocks_per_seq, dtype=torch.int32, device=dev)
        n = torch.zeros(cfg.max_seqs, dtype=torch.int32, device=dev)
        n[0] = len(long)
        with torch.no_grad():
            logits, _ = lm.prefill_paged(p, {"tokens": toks}, cache, table[:1], n[:1])
            step, _ = lm.decode_step_paged(p, cache, table, n, {"tokens": torch.zeros(
                (cfg.max_seqs, 1), dtype=torch.long, device=dev)})
            step = step[:1]
        eng = Engine(lm, p, cfg)
        res = eng.run([Request(rid=i, tokens=t, max_new_tokens=MIG_SERVE["max_new"])
                       for i, t in enumerate(mig_prompts())])
        return ([res[i] for i in sorted(res)], eng.rebalances,
                (logits.float().cpu(), step.float().cpu()))

    def migration_lines(tag, migrations):
        for i, m in enumerate(migrations):
            if lead:
                out[f"{tag} #{i}"] = (
                    f"step {m['step']}: imbalance {m['imbalance']:.4f} -> "
                    f"{m['imbalance_post']:.4f}, swaps {m['swaps']}, replicas "
                    f"{m['replicas']}, applied {m['applied']}, {m.get('seconds', 0):.3f} s "
                    f"(gloo through the host, not NVLink), all-gathered "
                    f"{m.get('gathered_bytes', 0)} bytes a rank")

    _sync(dev)
    dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()

    # (b) Replication: the same params, live table (the two hottest
    # experts) against the sentinel table.
    params = init_params(arch_of("ragged"), torch.Generator(device=dev).manual_seed(0), dev)
    batch = mig_batch(0)
    table = None
    for mode in ("ragged", "capacity"):
        arch = arch_of(mode)
        plan = sharding.make_plan(arch, (1, world))
        res = {}
        for tag in ("sentinel", "live"):
            p = params if tag == "sentinel" else with_table(params, table)
            loss, met, gr = loss_and_grads(LanguageModel(arch, plan), shard_params(p, plan),
                                           batch)
            if table is None:
                table = met["expert_load"].sum(dim=(0, 1)).argsort(
                    descending=True, stable=True)[:MIG_REPLICAS].tolist()
                if lead:
                    out["replicas/table"] = f"live table: experts {table} (the hottest)"
            res[tag] = (float(loss), {k: g for k, g in tree_paths(
                gather_params(gr, plan)).items() if g is not None})
            del gr
        if lead:
            (l0, g0), (l1, g1) = res["sentinel"], res["live"]
            ok_g, rows = ep_grad_gate(g1, g0)
            worst = max(rows, key=lambda k: rows[k][0] / max(rows[k][1], 1e-30))
            emb = float((g1["embed"] - g0["embed"]).norm() / (g0["embed"].norm() + 1e-9))
            record(f"replicas/train/{mode}", abs(l1 - l0) < 2e-3 and ok_g,
                   f"loss live {l1!r} vs sentinel {l0!r} (|d| {abs(l1 - l0):.3e} < 2e-3); "
                   f"gradients: worst leaf {worst} max |d| {rows[worst][0]:.3e} of max |want| "
                   f"{rows[worst][1]:.3e} (<= {EP_GRAD_REL:g} relative, < 2e-3), embed "
                   f"relative norm {emb:.3e} (< 0.05)")
        else:
            checks.append(True)
        del res
    for mode in ("ragged", "capacity"):
        arch = arch_of(mode)
        plan = sharding.make_plan(arch, (1, world))
        want, _, want_logits = serve(arch, plan, params)
        got, _, logits = serve(arch, plan, with_table(params, table))
        rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(logits, want_logits)]
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        # Ragged: the replica rows run the dispatch's kernels, so the tokens
        # are the sentinel's.  Capacity: they run the ragged kernels where
        # the sentinel's run the grouped GEMMs (the reference's split too),
        # which round h otherwise in bf16; the logits are held instead.
        ok = max(rel) <= EP_GRAD_REL and (got == want or mode == "capacity")
        record(f"replicas/serve/{mode}", ok,
               f"{len(got)} requests, {same} of {sum(map(len, want))} tokens equal the "
               f"sentinel table's (first: {got[0][:8]}); bf16 logits of the "
               f"{len(max(mig_prompts(), key=len))}-token prompt's prefill and next decode "
               f"step, max |d| / max |want| {rel[0]:.3e}, {rel[1]:.3e} (<= {EP_GRAD_REL:g})"
               + ("" if mode == "capacity" else "; tokens must be equal"))

    # (c) Migration: one permutation pass, and the trajectory of a run whose
    # init carried the final permutation (swap-only: bitwise).  With
    # replica channels, run A starts on (b)'s live table, which the planner
    # releases (at EP 2 no granite expert can pass the fair share: top-8
    # routing gives one expert at most 1/8 of the rows), so the route
    # differs from run B's for the steps before it: the gates of (b).
    for replicas in (0, MIG_REPLICAS):
        arch = arch_of("ragged", replicas=replicas, aux=0.0)
        plan = sharding.make_plan(arch, (1, world))
        lm = LanguageModel(arch, plan)
        tr = Trainer(lm, opt, TrainerConfig(migrate_every=MIG_EVERY,
                                            migrate_threshold=MIG_THRESHOLD), log_fn=quiet)
        init = init_state(lm, torch.Generator(device=dev).manual_seed(0), dev)
        if replicas:
            init["params"] = with_table(init["params"], table)
        state = sharded(init, plan)
        del init
        losses, exact = [], True
        keys = mig.EXPERT_PARAM_KEYS + ("assignment",)
        for s in range(MIG_STEPS):
            state, met = tr.train_step(state, mig_batch(s))
            losses.append(float(met["loss"]))
            loads = met["expert_load_host"]
            tr.load_stats.update(np.concatenate([loads[:, i] for i in range(loads.shape[1])]))
            if (s + 1) % MIG_EVERY:
                continue
            pre, n = host_state(tr, state, keys), len(tr.migrations)
            tr._maybe_migrate(state, s + 1)
            if len(tr.migrations) == n or not tr.migrations[-1]["applied"]:
                continue
            post = host_state(tr, state, keys)
            if lead:
                for k, w in pre.items():
                    if not k.startswith(("params/", "m/", "v/")) or k.endswith("assignment"):
                        continue
                    head = k.split("/", 1)[1].rpartition("/")[0]
                    a0, a1 = (x[f"params/{head}/assignment"] for x in (pre, post))
                    perm = np.stack([mig.permutation_for(a0[r], a1[r]) for r in range(len(a0))])
                    want = np.take_along_axis(w, perm.reshape(perm.shape + (1,) * (w.ndim - 2)),
                                              axis=1)
                    exact &= np.array_equal(post[k], want)
        applied = [m for m in tr.migrations if m["applied"]]
        migration_lines(f"migrate/replicas={replicas}", tr.migrations)
        final = {k: v.clone() for k, v in tree_paths(state["params"]).items()
                 if k.endswith(("assignment", "replicas"))}
        # Run B: the final tables baked into the init, no migration.
        full = init_state(lm, torch.Generator(device=dev).manual_seed(0), dev)
        for pos, blk in enumerate(full["params"]["blocks"]):
            if "ffn" not in blk:
                continue
            a1 = final[f"blocks/{pos}/ffn/assignment"].cpu().numpy()
            perm = np.stack([mig.permutation_for(np.arange(a1.shape[1]), a1[r])
                             for r in range(len(a1))])
            for t in ("params", "m", "v"):
                mig.apply_migration_(full[t]["blocks"][pos]["ffn"], perm)
            for key in ("assignment", "replicas"):
                if key in blk["ffn"]:
                    blk["ffn"][key].copy_(final[f"blocks/{pos}/ffn/{key}"])
        tr_b = Trainer(lm, opt, TrainerConfig(migrate_every=10 ** 9), log_fn=quiet)
        state_b = sharded(full, plan)
        losses_b = [float(tr_b.train_step(state_b, mig_batch(s))[1]["loss"])
                    for s in range(MIG_STEPS)]
        gap = max(abs(a - b) for a, b in zip(losses, losses_b))
        bitwise = losses == losses_b
        ok = len(applied) >= 1 and exact and (
            (bitwise or gap <= 1e-6) if replicas == 0 else gap < 2e-3)
        record(f"migrate/replicas={replicas}", ok,
               (f"run A from the live table {table}: " if replicas else "")
               + f"{len(applied)} migrations applied; params, m and v after each bitwise the "
               f"manual permutation of the gathered state: {exact}; losses {losses} vs "
               f"permuted init {losses_b}: "
               + ("bitwise" if bitwise else f"max |d| {gap:.3e} (bound "
                  f"{'1e-6' if replicas == 0 else '2e-3'})"))
        del state, state_b, full

    # (d) Serving rebalance on skewed prompts.
    for mode in ("ragged", "capacity"):
        arch = arch_of(mode)
        plan = sharding.make_plan(arch, (1, world))
        want, _, _ = serve(arch, plan, params)
        got, rebal, _ = serve(arch, plan, params, dict(rebalance_every=2,
                                                       rebalance_threshold=MIG_THRESHOLD))
        record(f"rebalance/{mode}", len(rebal) >= 1 and got == want,
               f"{len(rebal)} rebalances (swaps {[r['swaps'] for r in rebal]}, replicas "
               f"{[r['replicas'] for r in rebal]}); tokens equal the static engine's: "
               f"{got == want}")

    # (e) The EP-agnostic checkpoint: B saves at step MIG_STEPS // 2, after
    # a migration; it restores at world 1 (rank 0 alone) and at EP 2, and
    # its resume to MIG_STEPS is the uninterrupted run A.
    arch = arch_of("ragged", replicas=0, aux=0.0)
    plan = sharding.make_plan(arch, (1, world))
    lm = LanguageModel(arch, plan)

    def ck_fit(d, steps, seed):
        tr_ = Trainer(lm, opt, TrainerConfig(
            total_steps=steps, checkpoint_dir=d, checkpoint_every=2, migrate_every=MIG_EVERY,
            migrate_threshold=MIG_THRESHOLD, log_every=10 ** 9), log_fn=quiet)
        o = tr_.fit(sharded(init_state(lm, torch.Generator(device=dev).manual_seed(seed),
                                       dev), plan), _MigTokens())
        return tr_, o

    half = MIG_STEPS // 2
    tr_a, out_a = ck_fit(None, MIG_STEPS, 0)  # uninterrupted: nothing to save
    state_a = host_state(tr_a, out_a["state"])
    tr_b, out_b = ck_fit(f"{tmp}/ckB", half, 0)
    state_b = host_state(tr_b, out_b["state"])
    migration_lines("checkpoint/run A migration", out_a["migrations"])
    loss_a = float(out_a["metrics"]["loss"])
    del out_a, out_b
    manifest = json.loads(Path(tmp, "ckB", f"step_{half:08d}", "manifest.json").read_text())
    ema_b = tr_b.load_stats.ema.tobytes()
    if lead:
        assign = state_b["params/blocks/0/ffn/assignment"]
        moved = not np.array_equal(assign, np.tile(np.arange(assign.shape[1]), (len(assign), 1)))
        ext = read_extras(Path(tmp, "ckB"), half)["load_stats"]
        ema_ok = __import__("base64").b64decode(ext["ema"]) == ema_b and any(ema_b)
        # World 1, on rank 0 alone.
        one = init_state(LanguageModel(arch), torch.Generator(device=dev).manual_seed(5), dev)
        restore_checkpoint(Path(tmp, "ckB"), one, log_fn=quiet)
        crc_ok = leaf_crc32s(one) == manifest["crc32"]
        got = {k: v.cpu().numpy() for k, v in tree_paths(one).items()}
        same = all(np.array_equal(got[k], state_b[k]) for k in state_b)
        del one, got
        record("checkpoint/world 1", moved and ema_ok and crc_ok and same,
               f"saved at EP {plan.ep} step {half} (assignment moved: {moved}; EMA non-zero "
               f"and bit-exact in the extras: {ema_ok}); restored at world 1: live CRC32s "
               f"equal the manifest's: {crc_ok}; state bitwise the gathered state: {same}")
    dist.barrier()
    # EP 2: a restore into another seed's state, then the resume to MIG_STEPS.
    tr_r = Trainer(lm, opt, TrainerConfig(checkpoint_dir=f"{tmp}/ckB"), log_fn=quiet)
    st = sharded(init_state(lm, torch.Generator(device=dev).manual_seed(6), dev), plan)
    st, step = tr_r._restore_latest(st)
    tr_r._restore_load_stats(step)
    crc = leaf_crc32s(tr_r.global_state(st))
    got = host_state(tr_r, st)
    if lead:
        same = all(np.array_equal(got[k], state_b[k]) for k in state_b)
        record("checkpoint/EP 2", step == half and crc == manifest["crc32"] and same
               and tr_r.load_stats.ema.tobytes() == ema_b,
               f"restored step {step} at EP {plan.ep}: gathered CRC32s equal the manifest's: "
               f"{crc == manifest['crc32']}; state bitwise: {same}; EMA bit-exact: "
               f"{tr_r.load_stats.ema.tobytes() == ema_b}")
    del st, got, tr_r
    tr_c, out_c = ck_fit(f"{tmp}/ckB", MIG_STEPS, 7)
    state_c = host_state(tr_c, out_c["state"])
    loss_c = float(out_c["metrics"]["loss"])
    if lead:
        same = sorted(state_c) == sorted(state_a) and all(
            np.array_equal(state_c[k], state_a[k]) for k in state_a)
        ema_same = tr_c.load_stats.ema.tobytes() == tr_a.load_stats.ema.tobytes()
        record("checkpoint/resume", tr_c.resumed_from == half and same and ema_same
               and loss_c == loss_a,
               f"resumed at {tr_c.resumed_from} and ran to {MIG_STEPS}: loss {loss_c!r} vs "
               f"the uninterrupted run's {loss_a!r}; state bitwise: {same}; EMA bit-exact: "
               f"{ema_same}")
    _sync(dev)
    out["seconds"] = time.perf_counter() - t0
    out["counts"] = kernels.launch_counts()
    out["ok"] = all(checks)
    dist.barrier()
    dist.destroy_process_group()
    return out


def migrate_phase(dev):
    """Phase 13: the replica path's kernels on the card, then two gloo
    ranks on the one card (EP = 2; granite full width, depth 1, cf 16):
    replication, migration, serving rebalance and the EP-agnostic
    checkpoint.  Returns the two ranks' summed launch counts of those runs."""
    import torch.multiprocessing as mp

    from repro_torch.core import migration as mig
    from repro_torch.core.platform import H100

    torch.cuda.empty_cache()
    migrate_kernel_checks(dev)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_migrate_")
    log(f"[migrate] {EP_RANKS} gloo ranks on one {torch.cuda.get_device_name(0)}: every "
        f"all-gather and all-to-all of this phase stages through the host, so its seconds "
        f"are gloo's, not a measurement of NVLink")
    t0 = time.perf_counter()
    try:
        mp.start_processes(_migrate_rank, args=(EP_RANKS, tmp), nprocs=EP_RANKS,
                           start_method=RANK_START)
        res = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(EP_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in res:
        if "error" in r:
            fail(f"migrate rank {res.index(r)}: {r['error']}\n{r['trace']}")
    for k, v in res[0].items():
        if "/" in k:
            tag = "[check]" if v.endswith(("ok", "FAIL")) else "[migrate]"
            log(f"{tag} migrate x{EP_RANKS} (gloo, depth {EP_DEPTH}, cf {EP_CF:g}) {k}: {v}")
    counts = {}
    for r in res:
        log(f"[migrate] rank {r['rank']} launches: {r['counts']}")
        label = f"migrate rank {r['rank']}"
        log(f"[migrate] rank {r['rank']} designs {check_designs(r['counts'], label)}")
        for name, n in r["counts"].items():
            counts[name] = counts.get(name, 0) + n
    for name in PATH_KERNELS["migrate"]:
        if any(r["counts"][name] == 0 for r in res):
            fail(f"migrate: a rank never launched {name}")
    arch = _mig_base()
    size, secs = mig.migration_cost(arch.moe.num_experts, arch.d_model, arch.moe.d_ff,
                                    G=H100.chips_per_node, bandwidth=H100.migration_bw)
    log(f"[model] Table IV migration_cost for {ARCH} on core.platform.H100 (modeled, "
        f"not measured): {size:.0f} bytes a GPU, {secs * 1e3:.4f} ms at "
        f"{H100.migration_bw / 1e9:.0f} GB/s over {H100.chips_per_node} GPUs")
    log(f"[migrate] phase {time.perf_counter() - t0:.1f} s (two-rank runs "
        f"{res[0]['seconds']:.1f} s on rank 0)")
    if not res[0]["ok"]:
        fail("migrate: a check of the two-rank runs failed")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the pipeline executor (two gloo ranks, then four, on the card)
# ---------------------------------------------------------------------------

PIPE_DEPTH, PIPE_PP, PIPE_M, PIPE_CF = 4, 2, 4, 16.0
PIPE_BATCH, PIPE_EP_BATCH = (4, 512), (8, 512)
# (schedule, vstages): the flat schedules at PP 2 x 2 reps, interleaved at
# PP 2 x V 2 x 1 rep.
PIPE_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("1f1b_overlap", 1), ("zb_h1", 1),
                  ("interleaved_1f1b", 2))
# Launches a MoE layer of an op's chunk: (gate-up, ragged matmul, dW).  F is
# the forward (no autograd, so no remat); B the chunk's recompute, then,
# under the default remat "full", each rep's forward again in the backward,
# dh, dx_g, dx_u and the three dW; Bi the same but the input gradient
# alone; Bw the same as B (the layers' inputs depend on the chunk's
# weights).  A Bi of the first chunk launches nothing: nothing upstream
# takes its input gradient.
PIPE_OP_LAUNCHES = {"F": (1, 1, 0), "B": (2, 5, 3), "Bi": (2, 5, 0), "Bw": (2, 5, 3)}
PIPE_KERNELS = ("ragged_gate_up_silu_f32", "ragged_matmul_f32", "ragged_dw_f32")
PATH_KERNELS["pipeline"] = PIPE_KERNELS
# (f)'s depth: PERF.md's budget rule cut it from 32 layers to 16 (8 a
# rank) once a whole run passed ~1100 s (1153 s on an H100, PERF.md §6),
# and to 8 (4 a rank) when the sequence layout's run took 1192 s on a
# slower host (PERF.md §6, PR 29).
PIPE_LAUNCH_DEPTH = 8
PIPE_LAUNCH_ARGS = ["--arch", ARCH, "--mesh", "2,1,1", "--pipeline", "--schedule", "1f1b",
                    "--backend", "gloo", "--steps", "3", "--batch", "4", "--seq", "512",
                    "--seed", "0", "--dispatch", "ragged"]


def pipe_expected(sched, stage: int, layers: int) -> dict:
    """The launches ``stage`` makes in one step of ``sched``: each op's
    (``PIPE_OP_LAUNCHES``) times the MoE layers of a chunk."""
    tot = np.zeros(3, np.int64)
    for op in sched.ops[stage]:
        if op is None or (op[0] == "Bi" and stage == 0 and op[2] == 0):
            continue
        tot += np.asarray(PIPE_OP_LAUNCHES[op[0]]) * layers
    return dict(zip(PIPE_KERNELS, tot.tolist()))


def pipe_kernel_checks(dev) -> None:
    """(a) The ragged kernels at the microbatch's shape: one 512-token
    sequence routed top-8 over granite's 40 experts, T x k = 4096 rows."""
    ragged_family_checks(dev, PIPE_BATCH[1], "pipeline microbatch", seed=4)


def ragged_family_checks(dev, tokens: int, what: str, seed: int) -> None:
    """The ragged kernels at ``tokens`` tokens routed top-k over granite's
    experts: the gate-up (bf16 x), the down projection (fp32 h), dh and dx
    (fp32 against the transposed weights) and both weight gradients,
    against their plain versions at ``GEMM_TOL``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref

    arch = get_arch(ARCH)
    d, f, E, k = arch.d_model, arch.moe.d_ff, arch.moe.num_experts, arch.moe.top_k
    bf16 = torch.bfloat16
    _, randn, routed_offsets = seeded_inputs(dev, E, k, seed=seed)
    offs = routed_offsets(tokens)
    R = int(offs[-1])
    wg, wu = (randn(E, d, f, scale=d ** -0.5, dtype=bf16) for _ in range(2))
    wd = randn(E, f, d, scale=f ** -0.5, dtype=bf16)
    x, h = randn(R, d, dtype=bf16), randn(R, f)
    dy, da = randn(R, d, scale=1e-2), randn(R, f, scale=1e-2)
    tag = f"{what} T*k={R} E={E}"
    for nm, a, b in zip(("h", "a_g", "a_u"), mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs),
                        mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs)):
        check(f"ragged_gate_up_silu_f32 {tag} {nm}", a, b, GEMM_TOL)
    wdt, wgt = mm_ops._transposed(wd), mm_ops._transposed(wg)
    for nm, a_, w_ in (("down fp32 h", h, wd), ("dh", dy, wdt), ("dx", da, wgt)):
        check(f"ragged_matmul_f32 {tag} {nm}", mm_ops.ragged_matmul_f32(a_, w_, offs),
              mm_ref.ragged_matmul_f32(a_, w_, offs), GEMM_TOL)
    check(f"ragged_dw_f32 {tag} dW_gate/up bf16 x", mm_ops.ragged_dw_f32(x, da, offs),
          mm_ref.ragged_dw_f32(x, da, offs), GEMM_TOL)
    check(f"ragged_dw_f32 {tag} dW_down fp32 h", mm_ops.ragged_dw_f32(h, dy, offs),
          mm_ref.ragged_dw_f32(h, dy, offs), GEMM_TOL)


def _pipe_rank(rank: int, world: int, tmp: str, part: str) -> None:
    """One gloo rank of phase 14 (``torch.multiprocessing`` target); writes
    ``tmp/<part><r>.json``, or the failure there."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        out = (_pipe_schedules if part == "pp" else _pipe_pp_x_ep)(rank, world, tmp)
    except Exception as e:  # reported to the parent, which fails the phase
        out = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-3000:]}
    Path(tmp, f"{part}{rank}.json").write_text(json.dumps(out))


def _pipe_setup(rank: int, world: int, tmp: str, part: str):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params

    dev = resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv_{part}", rank=rank,
                            world_size=world)
    base = get_arch(ARCH)
    arch = base.replace(num_layers=PIPE_DEPTH, moe=dataclasses.replace(
        base.moe, dispatch="ragged", capacity_factor=PIPE_CF, aux_loss_coef=0.0))
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    return dev, arch, params


def _pipe_world1(arch, params, batch):
    """World 1 on this rank: (loss, {leaf: gradient})."""
    from repro_torch import training
    from repro_torch.models.model import LanguageModel, tree_paths

    loss, _, g = training.loss_and_grads(LanguageModel(arch), params, batch)
    return float(loss), {k: v for k, v in tree_paths(g).items() if v is not None}


def _pipe_step(arch, plan, params, batch):
    """``LanguageModel.loss_and_grads`` on this rank's rows (bf16 compute):
    (loss, gathered {leaf: gradient}, metrics, seconds)."""
    from repro_torch import training
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.models.model import LanguageModel, tree_paths

    dev = params["embed"].device
    local = {k: training._to_device(v, dev) for k, v in training.shard_batch(batch, plan).items()}
    mine = training._cast(shard_params(params, plan), torch.bfloat16)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g, met = LanguageModel(arch, plan).loss_and_grads(mine, local)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    full = {k: v for k, v in tree_paths(gather_params(g, plan)).items() if v is not None}
    return float(loss), full, met, secs


def _pipe_gate(out, tag, loss, full, want_loss, want) -> bool:
    ok_g, rows = ep_grad_gate(full, want)
    worst = max(rows, key=lambda k: rows[k][0] / max(rows[k][1], 1e-30))
    emb = float((full["embed"] - want["embed"]).norm() / (want["embed"].norm() + 1e-9))
    ok = abs(loss - want_loss) < 2e-3 and ok_g
    out[tag] = (f"loss {loss!r} vs world 1 {want_loss!r} (|d| {abs(loss - want_loss):.3e} < "
                f"2e-3); gradients: worst leaf {worst} max |d| {rows[worst][0]:.3e} of max "
                f"|want| {rows[worst][1]:.3e} (relative {rows[worst][0] / rows[worst][1]:.2e} "
                f"<= {EP_GRAD_REL:g}; < 2e-3), embed relative norm {emb:.3e} (< 0.05) "
                f"{'ok' if ok else 'FAIL'}")
    out[f"{tag} leaves"] = "max |d| / max |want|: " + ", ".join(
        f"{k} {g:.2e}/{m:.2e}" for k, (g, m, _) in rows.items())
    return ok


def _pipe_schedules(rank: int, world: int, tmp: str) -> dict:
    """(b), (c), (e), (g) on two ranks: every schedule's step against world 1
    and the IR, its launches, the int8 hand-offs."""
    import torch.distributed as dist

    from repro_torch import kernels, sharding
    from repro_torch.core import pipeline
    from repro_torch.core import resource_model as rm
    from repro_torch.core import schedules as S
    from repro_torch.data import SyntheticTokens

    dev, arch, params = _pipe_setup(rank, world, tmp, "pp")
    out, checks = {"rank": rank, "counts": {}}, []
    batch = SyntheticTokens(arch.vocab_size, *PIPE_BATCH).batch_at(0)
    ref = _pipe_world1(arch, params, batch) if rank == 0 else None
    dist.barrier()
    # A warm-up step (the first one pays the library's and the allocator's
    # start-up), so that the timed steps compare.
    _pipe_step(arch, sharding.make_plan(arch, (PIPE_PP, 1, 1), pipeline_on_pod=True,
                                        microbatches=PIPE_M), params, batch)
    runs, total = {}, {}
    for name, V in PIPE_SCHEDULES:
        plan = sharding.make_plan(arch, (PIPE_PP, 1, 1), pipeline_on_pod=True, schedule=name,
                                  vstages=V, microbatches=PIPE_M)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        loss, full, met, secs = _pipe_step(arch, plan, params, batch)
        counts = kernels.launch_counts()
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        sched = met["pipeline_stats"]["schedule"]
        layers = PIPE_DEPTH // (PIPE_PP * V)
        want_n = pipe_expected(sched, plan.pp_rank, layers)
        got_n = {n: counts[n] for n in PIPE_KERNELS}
        ok_n = got_n == want_n and all(counts[n] == 0 for n in (
            "flash_attention", "grouped_matmul_f32", "ssd_intra_chunk"))
        checks.append(ok_n)
        out["counts"][name] = counts
        out[f"launches/{name}"] = (f"stage {plan.pp_rank}: {got_n} vs the IR's ops x one op's "
                                   f"launches {want_n} {'ok' if ok_n else 'FAIL'}")
        ir = (sched.occupancy_trace(), sched.wstash_trace(), sched.comm_trace())
        ok_t = all(np.array_equal(met[k], w) for k, w in zip(
            ("pipeline_occupancy", "pipeline_wstash_occupancy", "pipeline_comm_inflight"), ir))
        peaks = list(met["pipeline_occupancy"].max(axis=1))
        want_peaks = (S.peak_activations_interleaved(PIPE_PP, PIPE_M, V) if V > 1 else
                      [PIPE_M] * PIPE_PP if name == "gpipe" else
                      S.peak_activations_1f1b(PIPE_PP))
        ok_p = peaks == want_peaks
        checks.append(ok_t and ok_p)
        st = met["pipeline_stats"]
        busy = sum(op is not None for row in sched.ops for op in row)
        out[f"traces/{name}"] = (f"executed residual, W-stash and comm traces equal the IR's: "
                                 f"{ok_t}; residual peaks {peaks} vs {want_peaks} "
                                 f"{'ok' if ok_t and ok_p else 'FAIL'}")
        out[f"step/{name}"] = (
            f"V={V} T={sched.num_ticks} ticks: step {secs:.3f} s (gloo hand-offs through the "
            f"host, not NVLink or NCCL); bubble_fraction(PP, M) "
            f"{pipeline.bubble_fraction(PIPE_PP, PIPE_M):.4f}, the IR's idle share "
            f"{1 - busy / (PIPE_PP * sched.num_ticks):.4f}; stage {plan.pp_rank} sent "
            f"{st['sent']} hand-offs, {st['sent_bytes']} bytes; residual slots "
            f"{sched.num_slots} x {st['slot_bytes'] // sched.num_slots} B = "
            f"{st['slot_bytes']} bytes")
        if name in ("1f1b", "zb_h1", "1f1b_overlap"):
            runs[name] = (loss, full)
        if rank == 0:
            checks.append(_pipe_gate(out, f"train/{name}", loss, full, *ref))
        del full
    out["total"] = total
    if rank == 0:
        l0, g0 = runs["1f1b"]
        for name in ("zb_h1", "1f1b_overlap"):
            l1, g1 = runs[name]
            gap = max(float((g1[k].float() - g0[k].float()).abs().max()) for k in g0)
            same = l1 == l0 and all(torch.equal(g1[k], g0[k]) for k in g0)
            ok = same or (abs(l1 - l0) < 1e-6 and gap < 1e-6)
            checks.append(ok)
            out[f"match/{name}"] = (f"against 1f1b: {'bitwise' if same else f'loss |d| {abs(l1 - l0):.3e}, grads max |d| {gap:.3e}'}"
                                    f" {'ok' if ok else 'FAIL'}")
    runs.clear()
    # (e) int8 hand-offs: 1f1b with compress_p2p.
    plan = sharding.make_plan(arch, (PIPE_PP, 1, 1), pipeline_on_pod=True, schedule="1f1b",
                              microbatches=PIPE_M, compress_p2p=True)
    loss_c, _, met, secs = _pipe_step(arch, plan, params, batch)
    plain = sharding.make_plan(arch, (PIPE_PP, 1, 1), pipeline_on_pod=True, schedule="1f1b",
                               microbatches=PIPE_M)
    loss_p, _, met_p, _ = _pipe_step(arch, plain, params, batch)
    st, st_p = met["pipeline_stats"], met_p["pipeline_stats"]
    model = rm.p2p_bytes_per_boundary(rm.ModelShape.from_arch(arch), rm.TrainSetup(
        b=PIPE_BATCH[0], s=PIPE_BATCH[1], PP=PIPE_PP, alpha=PIPE_M // PIPE_PP))
    ok = abs(loss_c - loss_p) < 0.1 and st["sent"] == st_p["sent"] > 0
    checks.append(ok)
    out["int8"] = (f"loss {loss_c!r} vs bf16 hand-offs {loss_p!r} (|d| {abs(loss_c - loss_p):.3e}"
                   f" < 0.1) {'ok' if ok else 'FAIL'}; a hand-off {st['sent_bytes'] // st['sent']}"
                   f" bytes int8 + scales vs {st_p['sent_bytes'] // st_p['sent']} bf16, "
                   f"resource_model.p2p_bytes_per_boundary {model:.0f} (modeled)")
    out["ok"] = all(checks)
    dist.barrier()
    dist.destroy_process_group()
    return out


def _pipe_pp_x_ep(rank: int, world: int, tmp: str) -> dict:
    """(d) Four ranks at mesh (2, 1, 2), 1f1b, batch 8 x 512, against world 1."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.data import SyntheticTokens

    dev, arch, params = _pipe_setup(rank, world, tmp, "ep")
    out = {"rank": rank}
    batch = SyntheticTokens(arch.vocab_size, *PIPE_EP_BATCH).batch_at(0)
    ref = _pipe_world1(arch, params, batch) if rank == 0 else None
    dist.barrier()
    plan = sharding.make_plan(arch, (PIPE_PP, 1, 2), pipeline_on_pod=True, schedule="1f1b",
                              microbatches=PIPE_M)
    loss, full, _, secs = _pipe_step(arch, plan, params, batch)
    out["ok"] = True
    if rank == 0:
        out["ok"] = _pipe_gate(out, "pp_x_ep/2,1,2", loss, full, *ref)
        out["seconds"] = secs
    dist.barrier()
    dist.destroy_process_group()
    return out


def pipe_launcher(dev) -> None:
    """(f) ``torchrun --nproc-per-node 2`` of ``repro_torch.launch.train
    --mesh 2,1,1 --pipeline`` at full width, ``PIPE_LAUNCH_DEPTH`` layers
    (a wrapper cuts the registry's granite to that depth in the ranks'
    processes, the launcher unchanged): finite losses, a trace with two
    stage lanes, every rank's peak memory beside the modeled stage-0
    memory."""
    import os
    import re

    from repro_torch.obs import validate_chrome_trace

    src = Path(__file__).resolve().parent / "src"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pipe_launch_"))
    launcher = launcher_script(tmp, PIPE_LAUNCH_DEPTH)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", str(launcher)] + PIPE_LAUNCH_ARGS + ["--metrics-out", str(tmp / "m.jsonl")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(src)})
        for line in proc.stdout.splitlines():
            if line.startswith(("[mesh]", "[trainer] pipelined", "[train]", "[done]",
                                "[model] h100", "[obs]", "[planner] schedule")):
                log(f"[pipeline] launcher: {line}")
        if proc.returncode != 0:
            errors = [l for l in proc.stderr.splitlines() if "Error" in l][-12:]
            fail(f"pipeline launcher exited {proc.returncode}: " + "\n".join(errors))
        trace = json.loads((tmp / "m.jsonl.trace.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    validate_chrome_trace(trace)
    lanes = sorted(e["args"]["name"] for e in trace["traceEvents"]
                   if e["ph"] == "M" and e["name"] == "thread_name" and e["pid"] == 2)
    losses = [float(m) for m in re.findall(r"\[train\] step=\d+ loss=(\S+)", proc.stdout)]
    done = re.search(r"\[done\] step=(\d+) loss=(\S+) skipped=(\d+)", proc.stdout)
    ok = (done is not None and int(done.group(1)) == 2 and int(done.group(3)) == 0
          and all(np.isfinite(losses + [float(done.group(2))]))
          and lanes == ["stage 0", "stage 1"])
    log(f"[check] pipeline launcher (granite full width, depth {PIPE_LAUNCH_DEPTH}, "
        f"{PIPE_LAUNCH_DEPTH // 2} layers a rank, PP 2, "
        f"1f1b, gloo): 3 steps, skipped 0 (the sentinel: every step's loss and grad norm "
        f"finite), logged losses {losses + [float(done.group(2)) if done else None]}, trace "
        f"valid with lanes {lanes} {'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("pipeline launcher: a loss is not finite or the trace lacks its stage lanes")


def pipeline_phase(dev):
    """Phase 14: (a) the ragged kernels at the microbatch shape; (b), (c),
    (e), (g) two gloo ranks sharing the card; (d) four; (f) the launcher at
    depth ``PIPE_LAUNCH_DEPTH``.  Returns the two ranks' summed launch counts of (b)'s steps."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe_kernel_checks(dev)
    log(f"[pipeline] gloo ranks on one {torch.cuda.get_device_name(0)}: every hand-off stages "
        f"through the host, so no time of this phase measures NVLink or NCCL p2p")
    res = {}
    for part, world in (("pp", PIPE_PP), ("ep", 4)):
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_pipe_{part}_")
        try:
            mp.start_processes(_pipe_rank, args=(world, tmp, part), nprocs=world,
                               start_method=RANK_START)
            res[part] = [json.loads(Path(tmp, f"{part}{r}.json").read_text())
                         for r in range(world)]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for r in res[part]:
            if "error" in r:
                fail(f"pipeline {part} rank {res[part].index(r)}: {r['error']}\n{r['trace']}")
    for r in res["pp"]:
        for k, v in r.items():
            if "/" in k or k == "int8":
                tag = "[check]" if v.endswith(("ok", "FAIL")) else "[pipeline]"
                log(f"{tag} pipeline rank {r['rank']} (gloo, depth {PIPE_DEPTH}, cf "
                    f"{PIPE_CF:g}, batch {PIPE_BATCH[0]} x {PIPE_BATCH[1]}, M {PIPE_M}) {k}: {v}")
        for name, c in r["counts"].items():
            label = f"pipeline rank {r['rank']} {name}"
            log(f"[pipeline] {label} designs {check_designs(c, label)}")
    for k, v in res["ep"][0].items():
        if "/" in k:
            log(f"[check] pipeline x EP (4 gloo ranks, mesh 2,1,2, 1f1b, batch "
                f"{PIPE_EP_BATCH[0]} x {PIPE_EP_BATCH[1]}) {k}: {v}")
    if not all(r["ok"] for r in res["pp"] + res["ep"]):
        fail("pipeline: a two- or four-rank check failed")
    counts = {}
    for r in res["pp"]:
        for name, n in r["total"].items():
            counts[name] = counts.get(name, 0) + n
    for name in PIPE_KERNELS:
        if any(r["total"][name] == 0 for r in res["pp"]):
            fail(f"pipeline: a rank never launched {name}")
    torch.cuda.empty_cache()
    pipe_launcher(dev)
    log(f"[pipeline] phase {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 15: the rest of the pod axis (tp lanes, checkpointing and migration
# under a pipeline, serving data parallelism), gloo ranks on the card
# ---------------------------------------------------------------------------

# ep = gcd(40, 6) = 2, tp = 3; the sequence split over ep x tp = 6 ranks
# (6 x 384: 6 rows x 64 positions a rank).
MESH_TP, MESH_TP_BATCH = (1, 6), (6, 384)
# The tp grid's control: D 3 x ep 2, as many tokens a rank (2 rows x 192
# positions) and the same EP degree, no tp lanes.  In bf16 compute both lie
# as far from world 1 at 6 x 512 (a worst leaf 2.6e-2 of its largest
# magnitude, past phase 12's 0.02, which was set at 2 x 512); the two grids
# give a rank other blocks of the batch, so they are held to each other at
# the reference's check_moe_ep gates.
MESH_TP_CONTROL = (3, 2)
# (d) at PIPE_M microbatches; (e) at 2, 2 rows x 128 positions a rank of each and
# phase 13's 1024 tokens a step (every layer's all-to-all ships the cf-16
# wire through gloo, about 6 s a step at 4 x 512).
MESH_PP_BATCH, MESH_PP_EP_BATCH, MESH_PP_EP_M = (4, 512), (4, 256), 2
MESH_PP_EP_DEPTH = 2  # PP 2 x one rep a stage (see EP_DEPTH)
# Run B of (d): checkpoints every 2 steps (keep 2), NaN at steps 2-4 ->
# rollback to 2, SIGTERM at 5 -> final save; its resume runs to 6.
MESH_CK = dict(steps=6, every=2, keep=2, nan=2, sigterm=5)
MESH_MIG_STEPS = 4  # migrations every MIG_EVERY steps
MESH_DP = ((2, 2), (2, 1, 2))  # D 2 x ep 2; the pod joining data
MESH_SERVE = dict(requests=4, prompt=(64, 256), max_new=8, max_seqs=4)
PATH_KERNELS["mesh"] = ("flash_attention", "grouped_matmul_f32", "ragged_gate_up_silu_f32",
                        "ragged_matmul_f32", "ragged_dw_f32")
# (g) the reference's "seq" / "kv_seq" serving layout through the dense-cache
# steps, on (e)'s four ranks: each case's arch, grid, depth and (b, prompt,
# cache rows, decode steps) of its bf16 greedy run and its fp32 run.  The
# bf16 run's prompts are the batch the check holds; the fp32 run takes the
# first rows the data grid splits (a prefill batch must divide over it).
SEQ_SERVE = (("granite", ARCH, (2, 2), 2, (4, 4096, 8192, 16), (2, 4096, 8192, 8)),
             ("gemma2", "gemma2-9b", (1, 4), 2, (1, 8192, 12288, 8), (1, 8192, 12288, 8)))
# (h) the Mamba2 mixer across sequence slices, on (e)'s four ranks at
# --mesh 1,4 (ep 4: 512 positions a rank of 2048, two chunks), every leaf
# whole: mamba2-370m full width and depth, (b, prompt, decode steps) of the
# bf16 greedy run and of the fp32 fed run, and the fp32 training pass at
# full width, depth SEQ_SSM_TRAIN_DEPTH, (b, s).
SEQ_SSM = dict(mesh=(1, 4), bf16=(4, 2048, 16), fp32=(2, 2048, 8), train=(4, 2048))
SEQ_SSM_TRAIN_DEPTH = 4
SEQ_SSM_LEAF, SEQ_SSM_LOSS, SEQ_SSM_GRAD = 1e-5, 1e-5, 1e-4  # each x max(1, |want|)
# (h2)'s fp32 gates are PARITY_BOUND and SEQ_SSM_LEAF, or SEQ_SSM_TWIN times
# world 1's own spread in the same run (its rows prefilled one at a time:
# other GEMM shapes, the same function), whichever is larger: at 48 layers
# that spread alone exceeds them, and each fp32 order lies about as far
# from a float64 run (scripts/port_ssm_seq_witness.py; PERF.md §6).
SEQ_SSM_TWIN = 2.0
PATH_KERNELS["mesh"] += ("ssd_intra_chunk",)
# (a') flash attention with a query offset at the cases' heads: the
# sequence split 4 ways (s, and gemma2's window and softcap from its arch).
SEQ_FA = ((ARCH, 4096), ("gemma2-9b", 8192))
SEQ_SPLIT = 4


def mesh_prompts(vocab: int) -> list:
    """The serving runs' prompts (``MESH_SERVE``), from seed 0."""
    rng = np.random.default_rng(0)
    lo, hi = MESH_SERVE["prompt"]
    return [rng.integers(0, vocab, size=int(n))
            for n in rng.integers(lo, hi + 1, size=MESH_SERVE["requests"])]


def mesh_kernel_checks(dev) -> None:
    """(a) The kernels of phase 15's paths against their plain versions at
    its shapes (granite full width, EP 2 so E_l = 20, cf ``EP_CF``): the
    three ragged kernels over one tp lane's receiver buffer (a rank's 512
    training tokens from each of the two EP ranks of its lane, sorted by
    local expert into S = E_l x C slots, the sentinel tail NaN, which must
    come back 0), forward and backward; the decode step of a data rank's
    share of ``max_seqs`` (ragged over its rows, the grouped GEMMs over
    (E_l, C, d)); the grouped GEMMs of a prefill bucket's EP shard; and
    flash attention at every prefill bucket of the serving prompts (one
    request, 24 / 8 heads of 64), against its fp32 plain version."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.models.moe import _capacity
    from repro_torch.serving.engine import _bucket

    arch = get_arch(ARCH)
    moe = dataclasses.replace(arch.moe, capacity_factor=EP_CF)
    d, f, E, k, ep = arch.d_model, moe.d_ff, moe.num_experts, moe.top_k, 2
    E_l, bf16 = E // ep, torch.bfloat16
    g, randn, _ = seeded_inputs(dev, E, k, seed=6)
    wg, wu = (randn(E_l, d, f, scale=d ** -0.5, dtype=bf16) for _ in range(2))
    wd = randn(E_l, f, d, scale=f ** -0.5, dtype=bf16)
    wgt, wdt = mm_ops._transposed(wg), mm_ops._transposed(wd)
    n_checks, t0 = 0, time.perf_counter()

    def local_ids(tokens: int) -> torch.Tensor:
        ids = torch.rand((tokens, E), generator=g, device=dev).argsort(dim=1)[:, :k]
        return torch.where(ids < E_l, ids, E_l).reshape(-1)

    def offsets_of(ids: torch.Tensor) -> torch.Tensor:
        counts = torch.bincount(ids, minlength=E_l + 1)[:E_l]
        return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)

    def nan_tail(rows, cols, n, dtype=torch.float32, scale=1.0):
        t = randn(rows, cols, scale=scale, dtype=dtype)
        t[n:] = float("nan")
        return t

    def held(name, got, want, tol=GEMM_TOL, n=None):
        nonlocal n_checks
        n_checks += 1
        check(f"mesh path {name}", got, want, tol)
        if n is not None and not bool((got[n:] == 0).all()):
            fail(f"mesh path {name}: rows past offsets[E_l] are not 0")

    # The lane's receiver buffer: each source packs its rows for this rank
    # sorted by local expert into S slots, sentinel after.
    T = MESH_TP_BATCH[0] * MESH_TP_BATCH[1] // (MESH_TP[0] * MESH_TP[1])
    S = E_l * _capacity(T, moe)
    recv = torch.full((ep, S), E_l, dtype=torch.long, device=dev)
    for src in range(ep):
        lid = local_ids(T).sort().values
        lid = lid[lid < E_l][:S]
        recv[src, :lid.numel()] = lid
    order = recv.reshape(-1).argsort(stable=True)
    offs = offsets_of(recv.reshape(-1)[order])
    R, n = ep * S, int(offs[-1])
    shape = f"tp lane T={T} R={R} occupied={n} E_l={E_l}"
    x = nan_tail(R, d, n, bf16)
    for nm, a, b in zip(("h", "a_g", "a_u"), mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs),
                        mm_ref.ragged_gate_up_silu_f32(x, wg, wu, offs)):
        held(f"ragged_gate_up_silu_f32 {shape} {nm}", a, b, n=n)
    h = nan_tail(R, f, n)
    held(f"ragged_matmul_f32 {shape} down fp32 h", mm_ops.ragged_matmul_f32(h, wd, offs),
         mm_ref.ragged_matmul_f32(h, wd, offs), n=n)
    dy, da = nan_tail(R, d, n, scale=1e-2), nan_tail(R, f, n, scale=1e-2)
    held(f"ragged_matmul_f32 {shape} dh", mm_ops.ragged_matmul_f32(dy, wdt, offs),
         mm_ref.ragged_matmul_f32(dy, wdt, offs), n=n)
    held(f"ragged_matmul_f32 {shape} dx", mm_ops.ragged_matmul_f32(da, wgt, offs),
         mm_ref.ragged_matmul_f32(da, wgt, offs), n=n)
    held(f"ragged_dw_f32 {shape} dW_gate/up bf16 x", mm_ops.ragged_dw_f32(x, da, offs),
         mm_ref.ragged_dw_f32(x, da, offs))
    held(f"ragged_dw_f32 {shape} dW_down fp32 h", mm_ops.ragged_dw_f32(h, dy, offs),
         mm_ref.ragged_dw_f32(h, dy, offs))
    # Decode over a data rank's share: max_seqs / D tokens, replicated over ep.
    T = MESH_SERVE["max_seqs"] // MESH_DP[0][0]
    ids = local_ids(T).sort().values
    offs = offsets_of(ids)
    n = int(offs[-1])
    xs = nan_tail(ids.numel(), d, n, bf16)
    for nm, a, b in zip(("h", "a_g", "a_u"), mm_ops.ragged_gate_up_silu_f32(xs, wg, wu, offs),
                        mm_ref.ragged_gate_up_silu_f32(xs, wg, wu, offs)):
        held(f"ragged_gate_up_silu_f32 decode share T={T} {nm}", a, b, n=n)
    hs = nan_tail(ids.numel(), f, n)
    held(f"ragged_matmul_f32 decode share T={T} down fp32 h",
         mm_ops.ragged_matmul_f32(hs, wd, offs), mm_ref.ragged_matmul_f32(hs, wd, offs), n=n)
    buckets = sorted({_bucket(len(p)) for p in mesh_prompts(arch.vocab_size)})
    for tag, M in [(f"decode share T={T}", _capacity(T, moe))] + [
            (f"prefill bucket {b} EP shard", ep * _capacity(b // ep, moe)) for b in buckets]:
        xg, hg = randn(E_l, M, d, dtype=bf16), randn(E_l, M, f)
        held(f"grouped_matmul_f32 {tag} ({E_l},{M},{d})x({d},{f}) gate/up",
             mm_ops.grouped_matmul_f32(xg, wg), mm_ref.grouped_matmul_f32(xg, wg))
        held(f"grouped_matmul_f32 {tag} ({E_l},{M},{f})x({f},{d}) down fp32 h",
             mm_ops.grouped_matmul_f32(hg, wd), mm_ref.grouped_matmul_f32(hg, wd))
    hq, hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    for s_ in buckets:
        qkv = randn(1, s_, hq + 2 * hkv, hd, dtype=bf16)  # strided views, as the model's
        q, kk, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
        want = fa_ref.attention(q.transpose(1, 2).float(), kk.transpose(1, 2).float(),
                                v.transpose(1, 2).float()).transpose(1, 2).to(bf16)
        held(f"flash_attention prefill bucket b=1 s={s_} hq={hq} hkv={hkv} d={hd} bf16 via "
             f"{fa_ops.design(bf16, hd)}", fa_ops.flash_attention(q, kk, v), want,
             FA_TOL[bf16])
    log(f"[check] mesh path kernels at phase 15's shapes (E_l={E_l}, cf {EP_CF:g}, NaN "
        f"sentinel tails, buckets {buckets}): {n_checks} checks ok "
        f"({time.perf_counter() - t0:.1f} s)")


def seq_flash_checks(dev) -> list:
    """(a') ``flash_attention`` with ``q_offset`` against its plain version
    (bf16 ``/tc``, fp32 ``/fma``) at each ``SEQ_FA`` shape, the sequence
    split ``SEQ_SPLIT`` ways: each rank's slice of the queries against the
    whole sequence's keys, as the sharded prefill calls it.  Each slice's
    ``kernel_row`` (its bound counts the keys its rows see, causal and
    window: rank j of n does about (2j + 1) / n^2 of the whole call's work;
    SDPA takes an explicit boolean mask, as its ``is_causal`` aligns the
    mask top-left: no offset) also carries the whole call's time and the
    slice's share of its work; returns one row a dtype, shape and slice."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    _, randn, _ = seeded_inputs(dev, 1, 1, seed=30)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, t0 = [], time.perf_counter()
    for name, s in SEQ_FA:
        arch = get_arch(name)
        hq, hkv, d = arch.num_heads, arch.num_kv_heads, arch.head_dim
        W = arch.sliding_window if any(m == "attn_local" for m, _ in arch.block_pattern) \
            else None
        cap = arch.attn_logit_softcap
        sl = s // SEQ_SPLIT
        pos = torch.arange(s, device=dev)
        visible = pos + 1 if W is None else torch.clamp(pos + 1, max=W)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = randn(1, s, hq + 2 * hkv, d, dtype=dtype)
            q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
            kc, vc = (t.transpose(1, 2).contiguous() for t in (k, v))
            design = fa_ops.design(dtype, d)
            whole_ms = device_ms(fa_ops.flash_attention_launch(
                q, k, v, window=W, logit_softcap=cap)[1], reps=10, warmup=2)
            sz = q.element_size()
            for j in range(SEQ_SPLIT):
                off = j * sl
                qs = q[:, off:off + sl]
                qsc = qs.transpose(1, 2).contiguous()
                shape = (f"b=1 s={s} hq={hq} hkv={hkv} d={d} window={W} softcap={cap} "
                         f"q_offset={off} sq={sl}")
                want = fa_ref.attention(qsc.float(), kc.float(), vc.float(), window=W,
                                        softcap=cap, q_offset=off).transpose(1, 2).to(dtype)
                err = check(f"mesh (a') flash_attention {shape} {dtype} via {design}",
                            fa_ops.flash_attention(qs, k, v, window=W, logit_softcap=cap,
                                                   q_offset=off), want, FA_TOL[dtype])
                del want
                p = pos[off:off + sl, None]
                mask = (pos[None] <= p) & ((pos[None] > p - W) if W is not None else True)
                # The keys the slice's rows see: [max(0, off - W + 1), off + sl).
                span = off + sl - (0 if W is None else max(0, off - W + 1))
                seen = float(visible[off:off + sl].sum())
                share = seen / float(visible.sum())
                row = kernel_row(
                    "flash_attention", shape, dtype,
                    fa_ops.flash_attention_launch(qs, k, v, window=W, logit_softcap=cap,
                                                  q_offset=off)[1],
                    lambda: fa_ref.attention(qsc, kc, vc, window=W, softcap=cap, q_offset=off),
                    lambda: sdpa(qsc, kc, vc, attn_mask=mask, enable_gqa=True),
                    (2 * sl * hq + 2 * span * hkv) * d * sz, [(4 * hq * d * seen, dtype)],
                    err, fa_ops._FLASH[design].path,
                    "src/repro/kernels/flash_attention/flash_attention.py:103", design)
                row.update(whole_ms=whole_ms, work_share=share)
                log(f"[time] flash_attention {row['shape']}: the whole call {whole_ms:.4f} ms, "
                    f"this slice's share of its work {share:.4f}; library: SDPA enable_gqa, an "
                    f"explicit causal{' and window' if W else ''} mask, no softcap (it has "
                    f"none)")
                rows.append(row)
                del mask, qsc
            del qkv, q, k, v, kc, vc
            torch.cuda.empty_cache()
    log(f"[mesh] (a') flash_attention with q_offset: {len(rows)} slices checked and timed "
        f"({time.perf_counter() - t0:.1f} s)")
    return rows


def _seq_generate(lm, params, prompts, rows: int, steps: int, feed=None,
                  keep_cache: bool = False) -> dict:
    """``prompts`` (b, l) through ``make_prefill_step``, ``pad_cache`` to
    ``rows`` and ``steps`` calls of ``make_decode_step`` in the params'
    dtype, each step fed the last logits' argmax or, with ``feed`` (b,
    steps), its next column.  Returns each step's argmax, top-2 gap and fp32
    logits (host), the prefill's launches, the attention cache's bytes, and
    the prefill's and each decode step's seconds; with ``keep_cache`` also
    the prefill's cache on the host (``"cache"``: {path: tensor})."""
    from repro_torch import kernels
    from repro_torch.models.model import tree_paths
    from repro_torch.training import make_decode_step, make_prefill_step

    dtype = params["final_norm"].dtype
    prefill, decode = make_prefill_step(lm, dtype), make_decode_step(lm, dtype)
    before = kernels.launch_counts()
    (logits, cache), pre_s = _timed(lambda: prefill(params, {"tokens": prompts}))
    after = kernels.launch_counts()
    kept = ({k: v.to("cpu", copy=True) for k, v in tree_paths(cache).items()} if keep_cache
            else None)  # a copy: the decode steps write the cache in place
    cache = lm.pad_cache(cache, rows)
    nbytes = sum(t.numel() * t.element_size() for c in cache if "k" in c for t in c.values())
    l, out = prompts.shape[1], {"tokens": [], "gaps": [], "logits": [], "step_s": []}
    for i in range(steps + 1):
        top = logits.float().topk(2, dim=-1)
        out["tokens"].append(top.indices[:, :1])
        out["gaps"].append(top.values[:, 0] - top.values[:, 1])
        out["logits"].append(logits.float().cpu())
        if i == steps:
            break
        nxt = out["tokens"][-1] if feed is None else torch.as_tensor(
            feed[:, i:i + 1], device=logits.device)
        (logits, _), secs = _timed(lambda: decode(params, cache, {"tokens": nxt}, l + i))
        out["step_s"].append(secs)
    del cache
    return {"tokens": torch.cat(out["tokens"], 1).cpu().numpy(),
            "gaps": torch.stack(out["gaps"], 1).cpu().numpy(), "logits": out["logits"],
            "launched": {n: after[n] - before.get(n, 0) for n in after},
            "cache_bytes": nbytes, "prefill_s": pre_s, "step_s": out["step_s"],
            "cache": kept}


def _tokens_held(name: str, ref: dict, got: dict, what: str):
    """(ok, line): ``got``'s greedy tokens equal ``ref``'s (world 1's), or
    diverge only where world 1's top-2 gap is under ``DENSE_TIE``."""
    same = ref["tokens"].shape == got["tokens"].shape and bool(
        (ref["tokens"] == got["tokens"]).all())
    if same:
        return True, f"{name} {what}: tokens equal world 1's"
    rows, cols = np.nonzero(ref["tokens"] != got["tokens"])
    first = {int(r): int(c) for r, c in zip(rows[::-1], cols[::-1])}
    worst = max(float(ref["gaps"][r, c]) for r, c in first.items())
    return worst < DENSE_TIE, (f"{name} {what}: {len(first)} rows diverge from world 1's, at "
                               f"{first}; world 1's top-2 gap there at most {worst:.3e} (< "
                               f"{DENSE_TIE:g}: a near-tie)")


def _logits_gap(name, arch, got: list, want: list, floor: float = 0.0):
    """(ok, line): every step's fp32 logits over the real vocabulary (the
    padded columns' -1e30 are no magnitude) within ``PARITY_BOUND`` x
    max(1, their magnitude) of world 1's, or within ``floor`` where that
    is larger."""
    from repro_torch.launch import serve

    V = arch.vocab_size
    err = max(float((a[:, :V] - b[:, :V]).abs().max()) for a, b in zip(got, want))
    mag = max(float(b[:, :V].abs().max()) for b in want)
    bound = serve.PARITY_BOUND * max(1.0, mag)
    line = f"{bound:.3e} = {serve.PARITY_BOUND:g} x max(1, {mag:.2f})"
    if floor:
        line = (f"{max(bound, floor):.3e} = max({line}, {SEQ_SSM_TWIN:g} x world 1's twin's "
                f"{floor / SEQ_SSM_TWIN:.3e})")
    bound = max(bound, floor)
    return err <= bound, f"{name}: max |dlogits| against world 1 {err:.3e} (bound {line})"


def _seq_inputs(case, vocab: int):
    """A ``SEQ_SERVE`` case's bf16 prompts, its fp32 prompts and their fed
    next tokens, from seed 20."""
    _, _, _, _, (b, l, _, _), (fb, fl, _, fk) = case
    rng = np.random.default_rng(20)
    prompts = rng.integers(0, vocab, size=(b, l))
    feed = rng.integers(0, vocab, size=(fb, fl + fk))
    return prompts, feed[:, :fl], feed[:, fl:]


def _seq_arch(case):
    from repro_torch.configs import get_arch

    tag, name, _, depth = case[:4]
    return _mesh_arch(depth) if tag == "granite" else get_arch(name).replace(num_layers=depth)


def _seq_world1(dev) -> dict:
    """(g)'s world-1 references on the lead rank, before the counts start:
    each case's bf16 greedy run and fp32 run through the dense-cache steps
    on one rank."""
    from repro_torch.models.model import LanguageModel, init_params

    refs = {}
    for case in SEQ_SERVE:
        arch = _seq_arch(case)
        (_, _, bc, bk), (_, _, fc, fk) = case[4], case[5]
        prompts, fprompts, feed = _seq_inputs(case, arch.vocab_size)
        params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
        lm = LanguageModel(arch)
        refs[case[0]] = {"bf16": _seq_generate(lm, _bf16(params), prompts, bc, bk),
                         "fp32": _seq_generate(lm, params, fprompts, fc, fk, feed)}
        del params
        torch.cuda.empty_cache()
    return refs


def _mesh_seq_serve(run, dev, refs: dict) -> None:
    """(g) The reference's "seq" / "kv_seq" serving layout on the four
    ranks: each ``SEQ_SERVE`` case's prefill block a rank (its rows over
    data, its slice of the prompt over (ep, tp)) and decode against its
    "kv_seq" block of the cache, every leaf of the weights whole on each
    rank (phase 16 (d)'s control: the check is the batch's and the cache's
    layout, not the weights' gathers through gloo).  bf16: greedy tokens
    against world 1's (a divergence only where world 1's top-2 gap is under
    ``DENSE_TIE``); fp32 (the EP payload in fp32 as in the tests: world 1
    has no wire; its launches counted, and apart in the rank's
    ``fp32_counts``): every step's logits within
    ``PARITY_BOUND`` x max(1, their magnitude) of world 1's; the attention
    cache's bytes a rank world 1's / (D ep tp) exactly; the bf16 prefill's
    flash launches one ``/tc`` an attention layer, none ``/fma``."""
    from repro_torch import kernels, sharding
    from repro_torch.convert import shard_params
    from repro_torch.models import moe
    from repro_torch.models.model import LanguageModel, init_params

    for case in SEQ_SERVE:
        tag, name, grid = case[:3]
        arch = _seq_arch(case)
        (_, _, bc, bk), (_, _, fc, fk) = case[4], case[5]
        prompts, fprompts, feed = _seq_inputs(case, arch.vocab_size)
        plan = _mem_plans(sharding.make_plan(arch, grid))["whole"]
        lm = LanguageModel(arch, plan)
        params = shard_params(init_params(arch, torch.Generator(device=dev).manual_seed(0), dev),
                              plan)
        attn = sum(m.startswith("attn") for m, _ in arch.block_pattern) * (
            arch.num_layers // len(arch.block_pattern))
        split = plan.dp * plan.seq_size
        got = _seq_generate(lm, _bf16(params), prompts, bc, bk)
        wire, before = moe.WIRE_DTYPE, kernels.launch_counts()
        try:  # the EP payload in fp32, as world 1 has no wire to round it
            moe.WIRE_DTYPE = torch.float32
            got32 = _seq_generate(lm, params, fprompts, fc, fk, feed)
        finally:
            moe.WIRE_DTYPE = wire
        fp32 = run.out.setdefault("fp32_counts", {})
        for n, c in kernels.launch_counts().items():
            fp32[n] = fp32.get(n, 0) + c - before.get(n, 0)
        del params
        torch.cuda.empty_cache()
        pre = f"seq/{tag}"
        launched = got["launched"]
        ok = (launched["flash_attention/tc"] == attn and launched["flash_attention/fma"] == 0)
        run.record(f"{pre}/launches", ok,
                   f"{name} depth {arch.num_layers} at --mesh {','.join(map(str, grid))} (dp "
                   f"{plan.dp} x ep {plan.ep} x tp {plan.tp}): the bf16 prefill of a rank's "
                   f"{prompts.shape[0] // plan.dp} x {prompts.shape[1] // plan.seq_size} block "
                   f"launched flash /tc {launched['flash_attention/tc']} (want {attn}: one an "
                   f"attention layer), /fma {launched['flash_attention/fma']}")
        for dt, g, rows, size in (("bf16", got, bc, 2), ("fp32", got32, fc, 4)):
            # World 1's K and V: reps x b x rows x kv heads x head dim each.
            whole = 2 * attn * g["tokens"].shape[0] * rows * arch.num_kv_heads * \
                arch.head_dim * size
            ok = g["cache_bytes"] * split == whole
            run.record(f"{pre}/{dt} cache bytes", ok,
                       f"{name} {dt}: the attention cache {g['cache_bytes']} B a rank, world "
                       f"1's {whole} B / (D {plan.dp} x ep {plan.ep} x tp {plan.tp})")
        if not run.lead:
            continue
        ref, ref32 = refs[tag]["bf16"], refs[tag]["fp32"]
        run.record(f"{pre}/bf16 tokens", *_tokens_held(
            name, ref, got, f"bf16 {prompts.shape[0]} x {prompts.shape[1]} + {bk} greedy steps "
                            f"into {bc} rows"))
        run.record(f"{pre}/fp32 logits", *_logits_gap(
            f"{name} fp32 {fprompts.shape[0]} x {fprompts.shape[1]} + {fk} steps into {fc} rows",
            arch, got32["logits"], ref32["logits"]))
        p50 = 1e3 * float(np.median(got["step_s"]))
        p50_1 = 1e3 * float(np.median(ref["step_s"]))
        run.note(f"{pre}/time", f"{name} bf16: prefill {1e3 * got['prefill_s']:.2f} ms, decode "
                 f"p50 {p50:.2f} ms a step; world 1 prefill {1e3 * ref['prefill_s']:.2f} ms, "
                 f"decode p50 {p50_1:.2f} ms (gloo through the host: not NVLink or NCCL)")


def _seq_ssm_case(dev, depth=None):
    """(h)'s mamba2-370m (at ``depth`` layers, else full), its fp32 weights
    from seed 0, and its inputs from seed 21: the bf16 prompts, the fp32
    prompts and their fed tokens, the training batch."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params

    arch = get_arch(SSM_ARCH)
    if depth is not None:
        arch = arch.replace(num_layers=depth)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(21)
    (b, l, _), (fb, fl, fk), (tb, tl) = SEQ_SSM["bf16"], SEQ_SSM["fp32"], SEQ_SSM["train"]
    feed = rng.integers(0, arch.vocab_size, size=(fb, fl + fk))
    toks = rng.integers(0, arch.vocab_size, size=(tb, tl + 1))
    return arch, params, {"bf16": rng.integers(0, arch.vocab_size, size=(b, l)),
                          "fp32": feed[:, :fl], "feed": feed[:, fl:],
                          "train": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}


def _leaf_gap(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    w = want.double()
    return float((got.double() - w).abs().max()) / max(1.0, float(w.abs().max()))


def _seq_ssm_world1(dev, tmp: str) -> dict:
    """(h)'s world-1 references on the lead rank, before the counts start:
    the bf16 greedy run and the fp32 fed run (its prefill's cache) through
    the dense-cache steps, the fp32 run's twin (``SEQ_SSM_TWIN``: its
    logits' and its cache's largest gap from world 1's) and the fp32
    training pass at depth ``SEQ_SSM_TRAIN_DEPTH``.  The cache, the twin's
    cache gap, the loss and the gradients go to ``tmp/seq_ssm_ref.pt`` too,
    for every rank to hold its own against."""
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.training import loss_and_grads

    arch, params, inp = _seq_ssm_case(dev)
    lm = LanguageModel(arch)
    (b, l, k), (fb, fl, fk) = SEQ_SSM["bf16"], SEQ_SSM["fp32"]
    refs = {"bf16": _seq_generate(lm, _bf16(params), inp["bf16"], l + k, k),
            "fp32": _seq_generate(lm, params, inp["fp32"], fl + fk, fk, inp["feed"],
                                  keep_cache=True)}
    # World 1's twin: each row prefilled and decoded alone.
    rows = [_seq_generate(lm, params, inp["fp32"][i:i + 1], fl + fk, fk,
                          inp["feed"][i:i + 1], keep_cache=True) for i in range(fb)]
    V = arch.vocab_size
    refs["twin"] = max(float((torch.cat([r["logits"][i] for r in rows])[:, :V]
                              - refs["fp32"]["logits"][i][:, :V]).abs().max())
                       for i in range(fk + 1))
    twin_cache = max(_leaf_gap(torch.cat([r["cache"][path] for r in rows], dim=1), want)
                     for path, want in refs["fp32"]["cache"].items())
    del params, rows
    arch, params, inp = _seq_ssm_case(dev, SEQ_SSM_TRAIN_DEPTH)
    loss, _, grads = loss_and_grads(LanguageModel(arch), params, inp["train"], torch.float32)
    torch.save({"cache": refs["fp32"]["cache"], "twin_cache": twin_cache, "loss": float(loss),
                "grads": {k: v.cpu() for k, v in tree_paths(grads).items() if v is not None}},
               f"{tmp}/seq_ssm_ref.pt")
    del params, grads
    torch.cuda.empty_cache()
    return refs


def _mesh_seq_ssm(run, dev, refs: dict) -> list:
    """(h) The reference's "seq" layout through the Mamba2 mixer: each rank
    convolves and scans its 512 positions of a 2048 prompt, the state handed
    rank to rank (``sharding.seq_shift``) on the four ranks at ``--mesh
    1,4``, every leaf whole.  (h1) bf16 4 x 2048 + 16 greedy steps: tokens
    against world 1's (a divergence only at a near-tie, ``DENSE_TIE``);
    (h2) fp32 2 x 2048 + 8 fed steps: logits within ``PARITY_BOUND`` x
    max(1, their magnitude) of world 1's, and every rank's returned SSM
    state and conv tails within ``SEQ_SSM_LEAF`` x max(1, the leaf's
    magnitude), or each within ``SEQ_SSM_TWIN`` times world 1's twin's gap
    where that is larger; (h3) one fp32 loss-and-gradients pass at depth
    ``SEQ_SSM_TRAIN_DEPTH``, 4 x 2048: the loss and every gathered gradient
    within ``SEQ_SSM_LOSS`` / ``SEQ_SSM_GRAD`` x max(1, |want|); (h4) the
    bf16 prefill launches ``ssd_intra_chunk/tc`` once a layer, no ``/fma``
    in the bf16 runs, and each rank's first call at its slice's shape
    against its plain version at ``SSD_TOL`` through ``kernel_row``, the
    ranks one after another (they share the card).  The (h2) and (h3)
    launches go to the rank's ``fp32_counts``.  Returns the rank's
    ``kernel_row`` of (h4)."""
    import torch.distributed as dist

    from repro_torch import kernels, sharding
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.training import loss_and_grads

    t0 = time.perf_counter()
    mesh = ",".join(map(str, SEQ_SSM["mesh"]))
    arch, params, inp = _seq_ssm_case(dev)
    plan = _mem_plans(sharding.make_plan(arch, SEQ_SSM["mesh"]))["whole"]
    lm, n = LanguageModel(arch, plan), plan.seq_size
    params = shard_params(params, plan)
    (b, l, k), (fb, fl, fk) = SEQ_SSM["bf16"], SEQ_SSM["fp32"]
    layers = arch.num_mamba_layers
    pre = "ssm"

    # (h1), (h4): the bf16 run, its first kernel call at the slice's shape.
    sharding.reset_handoff()
    torch.cuda.reset_peak_memory_stats()
    with _FirstCalls() as first:
        got = _seq_generate(lm, _bf16(params), inp["bf16"], l + k, k)
    handoff = dict(sharding.HANDOFF)
    launched = got["launched"]
    ok = (launched["ssd_intra_chunk/tc"] == layers and launched["ssd_intra_chunk/fma"] == 0)
    run.record(f"{pre}/launches", ok,
               f"{SSM_ARCH} at --mesh {mesh} (ep {plan.ep} x tp {plan.tp}): the bf16 prefill of "
               f"a rank's {b} x {l // n} slice launched ssd_intra_chunk /tc "
               f"{launched['ssd_intra_chunk/tc']} (want {layers}: one a layer), /fma "
               f"{launched['ssd_intra_chunk/fma']}")
    calls = [c for c in first.calls if c[0] == "ssd_intra_chunk"]
    row, counted = None, kernels.launch_counts()
    for r in range(n):  # one rank at a time: the ranks share the card
        if r == plan.rank and calls:
            x, dA, B, C = calls[0][1]
            fold = [t.flatten(0, 1) for t in (x, dA.to(x.dtype), B, C)]
            want = ssd_ref.ssd_intra_chunk(*(t.float() for t in fold)).to(x.dtype)
            got_k = ssd_ops.ssd_intra_chunk(x, dA, B, C).flatten(0, 1)
            err = float((got_k.float() - want.float()).abs().max())
            ok = bool(torch.isfinite(got_k).all()) and torch.allclose(
                got_k.float(), want.float(), **SSD_TOL[x.dtype])
            G, cl, hh, pp = fold[0].shape
            nn = fold[2].shape[-1]
            shape = f"mesh (h) slice of rank {r} (g={G},cl={cl},h={hh},p={pp},n={nn})"
            run.checks.append(ok)
            run.out[f"{pre}/first call rank {r}"] = (
                f"ssd_intra_chunk {shape} bf16 via tc against its plain version: max_abs_err "
                f"{err:.3e} tol(rtol={SSD_TOL[x.dtype]['rtol']:g}, atol="
                f"{SSD_TOL[x.dtype]['atol']:g}) {'ok' if ok else 'FAIL'}")
            pairs = G * hh * cl * (cl + 1) / 2
            sz = x.element_size()
            row = kernel_row("ssd_intra_chunk", shape, x.dtype,
                             ssd_ops.ssd_intra_chunk_launch(*fold)[1],
                             lambda: ssd_ref.ssd_intra_chunk(*fold), None,
                             2 * G * cl * hh * pp * sz + 2 * G * cl * nn * sz + G * cl * hh * sz,
                             [(pairs / hh * 2 * nn, torch.bfloat16),
                              *gemm_ops(pairs * 2 * pp, torch.float32, torch.bfloat16)],
                             err, ssd_ops._SSD["tc"].path, "src/repro/kernels/ssd/ssd.py:51",
                             "tc")
            del fold, want, got_k
        dist.barrier()
    kernels._build.COUNTS.update(counted)  # the check's and the timer's launches do not count
    if not calls:
        run.checks.append(False)
        run.out[f"{pre}/first call rank {plan.rank}"] = "no ssd_intra_chunk call captured FAIL"
    del first, calls

    # (h2): fp32, the prefill's cache held on every rank.
    before = kernels.launch_counts()
    got32 = _seq_generate(lm, params, inp["fp32"], fl + fk, fk, inp["feed"], keep_cache=True)
    ref_file = torch.load(f"{run.tmp}/seq_ssm_ref.pt")
    cache_bound = max(SEQ_SSM_LEAF, SEQ_SSM_TWIN * ref_file["twin_cache"])
    gaps = {path: (_leaf_gap(got32["cache"][path], want)
                   if got32["cache"][path].shape == want.shape else float("inf"))
            for path, want in ref_file["cache"].items()}
    worst = max(gaps.items(), key=lambda kv: kv[1])
    run.checks.append(worst[1] <= cache_bound)
    del params
    torch.cuda.empty_cache()

    # (h3): one fp32 training pass at depth SEQ_SSM_TRAIN_DEPTH.
    tarch, tparams, tinp = _seq_ssm_case(dev, SEQ_SSM_TRAIN_DEPTH)
    tplan = _mem_plans(sharding.make_plan(tarch, SEQ_SSM["mesh"]))["whole"]
    sharding.reset_handoff()
    (loss, _, grads), train_s = _timed(lambda: loss_and_grads(
        LanguageModel(tarch, tplan), shard_params(tparams, tplan), tinp["train"], torch.float32))
    train_handoff = dict(sharding.HANDOFF)
    grads = tree_paths(gather_params(grads, tplan))
    want = ref_file["loss"]
    loss_ok = abs(float(loss) - want) <= SEQ_SSM_LOSS * max(1.0, abs(want))
    ggaps = {path: _leaf_gap(grads[path].cpu(), w) for path, w in ref_file["grads"].items()}
    gworst = max(ggaps.items(), key=lambda kv: kv[1])
    run.checks += [loss_ok, gworst[1] <= SEQ_SSM_GRAD]
    fp32 = run.out.setdefault("fp32_counts", {})
    for name, c in kernels.launch_counts().items():
        fp32[name] = fp32.get(name, 0) + c - before.get(name, 0)
    del tparams, grads
    torch.cuda.empty_cache()

    mine = {"cache": worst, "grad": gworst, "handoff": handoff,
            "train_handoff": train_handoff, "train_s": train_s}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    peaks = run.peak_gb()
    if run.lead:
        ref, ref32 = refs["bf16"], refs["fp32"]
        run.record(f"{pre}/bf16 tokens", *_tokens_held(
            SSM_ARCH, ref, got, f"bf16 {b} x {l} + {k} greedy steps"))
        run.record(f"{pre}/fp32 logits", *_logits_gap(
            f"{SSM_ARCH} fp32 {fb} x {fl} + {fk} fed steps", arch, got32["logits"],
            ref32["logits"], floor=SEQ_SSM_TWIN * refs["twin"]))
        run.record(f"{pre}/fp32 cache", all(e["cache"][1] <= cache_bound for e in every),
                   f"every rank's returned ssm state and conv tails against world 1's, worst "
                   f"leaf's max |d| / max(1, |leaf|) a rank: " + ", ".join(
                       f"rank {r} {e['cache'][0]} {e['cache'][1]:.3e}"
                       for r, e in enumerate(every))
                   + f" (bound {cache_bound:.3e} = max({SEQ_SSM_LEAF:g}, {SEQ_SSM_TWIN:g} x "
                     f"world 1's twin's {ref_file['twin_cache']:.3e}))")
        tb, tl = SEQ_SSM["train"]
        run.record(f"{pre}/train loss", loss_ok,
                   f"{SSM_ARCH} depth {SEQ_SSM_TRAIN_DEPTH} fp32 {tb} x {tl}: loss "
                   f"{float(loss):.7f} against world 1's {want:.7f} (<= {SEQ_SSM_LOSS:g} x "
                   f"max(1, |loss|))")
        run.record(f"{pre}/train grads", all(e["grad"][1] <= SEQ_SSM_GRAD for e in every),
                   f"{len(ggaps)} gathered gradient leaves against world 1's, worst leaf's max "
                   f"|d| / max(1, |leaf|) a rank: " + ", ".join(
                       f"rank {r} {e['grad'][0]} {e['grad'][1]:.3e}"
                       for r, e in enumerate(every)) + f" (<= {SEQ_SSM_GRAD:g})")
        p50 = 1e3 * float(np.median(got["step_s"]))
        p50_1 = 1e3 * float(np.median(ref["step_s"]))
        run.note(f"{pre}/time", (
            f"{SSM_ARCH} bf16: prefill {1e3 * got['prefill_s']:.2f} ms, decode p50 {p50:.2f} "
            f"ms a step; world 1 prefill {1e3 * ref['prefill_s']:.2f} ms, decode p50 "
            f"{p50_1:.2f} ms; the fp32 training pass {[round(e['train_s'], 3) for e in every]} "
            f"s a rank (gloo through the host: not NVLink or NCCL)"))
        run.note(f"{pre}/hand-offs", (
            "the mixer's hand-offs a rank, bf16 prefill (rounds, tensors sent, bytes sent, of "
            "them staged through the host for gloo): " + "; ".join(
                f"rank {r} {e['handoff']['rounds']}, {e['handoff']['tensors']}, "
                f"{e['handoff']['bytes']}, {e['handoff']['host_bytes']}"
                for r, e in enumerate(every))
            + "; the fp32 training pass (forward, recompute, backward): " + "; ".join(
                f"rank {r} {e['train_handoff']['rounds']}, {e['train_handoff']['bytes']}"
                for r, e in enumerate(every))))
        run.note(f"{pre}/peak", f"peak GB a rank {peaks}; (h) {time.perf_counter() - t0:.1f} s")
    return row


def _mesh_rank(rank: int, world: int, tmp: str, part: str) -> None:
    """One gloo rank of phase 15 (``torch.multiprocessing`` target); writes
    ``tmp/<part><r>.json``, or the failure there."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        out = {"tp": _mesh_tp, "pp": _mesh_pp, "r4": _mesh_r4}[part](rank, world, tmp)
    except Exception as e:  # reported to the parent, which fails the phase
        out = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-3000:]}
    Path(tmp, f"{part}{rank}.json").write_text(json.dumps(out))


class _MeshRun:
    """A rank's share of one part of phase 15: its device and process
    group, its ``[check]`` records and result lines, and its launch counts
    from the moment :meth:`start` zeroes them."""

    def __init__(self, rank: int, world: int, tmp: str, part: str):
        import torch.distributed as dist

        from repro_torch.device import resolve_device

        self.dev = resolve_device("cuda")
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv_{part}", rank=rank,
                                world_size=world)
        self.rank, self.lead, self.tmp = rank, rank == 0, tmp
        self.out, self.checks = {"rank": rank}, []

    def record(self, tag: str, ok: bool, line: str) -> None:
        self.checks.append(bool(ok))
        if self.lead:
            self.out[tag] = f"{line} {'ok' if ok else 'FAIL'}"

    def note(self, tag: str, line: str) -> None:
        if self.lead:
            self.out[tag] = line

    def start(self) -> None:
        import torch.distributed as dist

        from repro_torch import kernels

        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()

    def peak_gb(self) -> list:
        """Every rank's peak device memory since the last reset, in GB."""
        import torch.distributed as dist

        mine = [torch.cuda.max_memory_allocated() / 1e9]
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        torch.cuda.reset_peak_memory_stats()
        return [round(g[0], 2) for g in got]

    def finish(self) -> dict:
        import torch.distributed as dist

        from repro_torch import kernels

        torch.cuda.synchronize()
        self.out["seconds"] = time.perf_counter() - self.t0
        self.out["counts"] = kernels.launch_counts()
        self.out["ok"] = all(self.checks)
        dist.barrier()
        dist.destroy_process_group()
        return self.out


def _timed(fn):
    """(fn(), seconds), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _mesh_arch(depth: int, mode: str = "ragged", **moe):
    import dataclasses

    from repro_torch.configs import get_arch

    base = get_arch(ARCH)
    return base.replace(num_layers=depth, moe=dataclasses.replace(
        base.moe, dispatch=mode, capacity_factor=EP_CF, **moe))


def _mesh_serve(arch, plan, params, dev) -> list:
    """The engine's tokens for ``mesh_prompts`` (bf16 weights and cache)."""
    from repro_torch.convert import shard_params
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving import Engine, Request, ServeConfig

    cfg = ServeConfig(max_seqs=MESH_SERVE["max_seqs"], block_size=16, num_blocks=128,
                      max_blocks_per_seq=17, cache_dtype="bfloat16")
    eng = Engine(LanguageModel(arch, plan), shard_params(_bf16(params), plan), cfg)
    res = eng.run([Request(rid=i, tokens=t, max_new_tokens=MESH_SERVE["max_new"])
                   for i, t in enumerate(mesh_prompts(arch.vocab_size))])
    return [res[i] for i in sorted(res)]


def _mesh_tp(rank: int, world: int, tmp: str) -> dict:
    """(b), (c): six ranks at ``MESH_TP`` (ep 2 x tp 3), granite at depth
    ``EP_DEPTH``.
    Training is held to the data grid ``MESH_TP_CONTROL`` (D 3 x ep 2: as
    many tokens a rank and the same EP degree, no tp lanes), and both grids
    to world 1 (rank 0), at the reference's own EP gates; serving to world
    1."""
    import torch.distributed as dist

    from repro_torch import sharding, training
    from repro_torch.checkpoint import leaf_crc32s
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init

    run = _MeshRun(rank, world, tmp, "tp")
    dev = run.dev
    arch = _mesh_arch(EP_DEPTH)
    opt = OptimizerConfig(lr=1e-3)  # step 1 of its 100-step warmup: lr 1e-5
    lr = 1e-3 / 100
    batch = SyntheticTokens(arch.vocab_size, *MESH_TP_BATCH).batch_at(0)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)

    def grads(plan):
        """(loss, the gathered gradients: on rank 0 alone, which compares)."""
        loss, _, gr = training.loss_and_grads(LanguageModel(arch, plan),
                                              shard_params(params, plan), batch)
        full = tree_paths(gather_params(gr, plan))
        return float(loss), ({k: g for k, g in full.items() if g is not None}
                             if run.lead else {})

    def step(plan):
        """One AdamW step from a copy of the params: (grad norm, skipped,
        the gathered params and first moment on rank 0, this rank's params
        after it, the step's seconds)."""
        p = map_tree(torch.clone, shard_params(params, plan))
        state = {"params": p, **adamw_init(p)}
        (_, met), secs = _timed(lambda: training.make_train_step(
            LanguageModel(arch, plan), opt)(state, batch))
        after = {k: {n: t for n, t in tree_paths(gather_params(state[k], plan)).items()
                     if t.is_floating_point()} for k in ("params", "m")}
        return (float(met["grad_norm"]), int(met["skipped"]), after if run.lead else {},
                state["params"], secs)

    def reference_gate(got, want):
        """The reference's check_moe_ep gates: (ok, the worst element-wise
        gap of a leaf but the embedding, the embedding's relative norm gap,
        the worst leaf's gap over its largest magnitude)."""
        rows = ep_grad_gate(got, want)[1]
        gap = max(r[0] for k, r in rows.items() if k != "embed")
        emb = float((got["embed"] - want["embed"]).norm() / (want["embed"].norm() + 1e-9))
        rel = max(r[0] / max(r[1], 1e-30) for r in rows.values())
        return gap < 2e-3 and emb < 0.05, gap, emb, rel

    ref = {}
    if run.lead:
        ref["grads"] = grads(None)
        ref["step"] = step(None)[:3]
        for mode in SERVE_MODES:
            ref[mode] = _mesh_serve(_mesh_arch(EP_DEPTH, mode), None, params, dev)
    run.start()
    control = sharding.make_plan(arch, MESH_TP_CONTROL)
    want_loss, want = grads(control)
    gn0, _, want_after, _, _ = step(control)
    del control
    plan = sharding.make_plan(arch, MESH_TP)
    blk, cblk = (training.batch_block(p, *MESH_TP_BATCH)
                 for p in (plan, sharding.MeshPlan(dp=MESH_TP_CONTROL[0], ep=plan.ep)))
    run.note("tp/plan", f"--mesh {','.join(map(str, MESH_TP))}: ep {plan.ep}, tp {plan.tp}; "
                        f"batch {MESH_TP_BATCH[0]} x {MESH_TP_BATCH[1]}, {blk[0]} rows x "
                        f"{blk[1]} positions a rank; the control grid --mesh "
                        f"{','.join(map(str, MESH_TP_CONTROL))}, {cblk[0]} rows x {cblk[1]}")
    (loss, full), secs_g = _timed(lambda: grads(plan))
    gn, skipped, after, mine, secs = step(plan)
    peaks = run.peak_gb()
    lanes = [None] * world
    dist.all_gather_object(lanes, [list(plan.coords), {
        k: c for k, c in leaf_crc32s(mine).items() if k not in plan.layout}])
    del mine
    if run.lead:
        ok_g, gap_g, emb_g, rel_g = reference_gate(full, want)
        rows = ep_grad_gate(full, want)[1]
        worst = max(rows, key=lambda k: rows[k][0] / max(rows[k][1], 1e-30))
        run.record("tp/train", abs(loss - want_loss) < 2e-3 and ok_g,
                   f"against the control grid at the reference's EP gates: loss {loss!r} vs "
                   f"{want_loss!r} (|d| {abs(loss - want_loss):.3e} < 2e-3); worst element-wise "
                   f"gap {gap_g:.3e} (< 2e-3, the embedding aside), embed relative norm "
                   f"{emb_g:.3e} (< 0.05); worst leaf {worst} max |d| {rows[worst][0]:.3e} of "
                   f"max |want| {rows[worst][1]:.3e} (relative {rel_g:.2e})")
        experts = sharding.expert_paths(full)
        bad = {k: v * 0.5 if k in experts else v for k, v in full.items()}
        caught = sorted(k for k, r in ep_grad_gate(bad, want)[1].items() if not r[2])
        failing = {k for k, r in rows.items() if not r[2]}  # past the gate unplanted
        run.record("tp/planted", set(experts) <= set(caught) <= set(experts) | failing,
                   f"expert gradients x 0.5 fail phase 12's gate at {len(caught)} leaves: all "
                   f"{len(experts)} expert leaves, and no other leaf but the {len(failing)} "
                   f"past it unplanted")
        m_rows = ep_grad_gate(after["m"], want_after["m"])[1]
        m_rel = max(r[0] / max(r[1], 1e-30) for r in m_rows.values())
        p_gap = {k: (after["params"][k] - w).abs() for k, w in want_after["params"].items()}
        p_max = max(float(v.max()) for v in p_gap.values())
        p_frac = max(float((v > lr / 100).float().mean()) for v in p_gap.values())
        run.record("tp/step", skipped == 0 and abs(gn - gn0) <= EP_GRAD_REL * gn0
                   and m_rel <= EP_GRAD_REL and p_max <= 2 * lr and p_frac <= 0.05,
                   f"one AdamW step against the control grid's: grad norm {gn!r} vs {gn0!r} "
                   f"(relative {abs(gn - gn0) / gn0:.2e} <= {EP_GRAD_REL:g}), skipped {skipped}; "
                   f"first moment worst relative gap {m_rel:.2e} (<= {EP_GRAD_REL:g}); params "
                   f"max |d| {p_max:.3e} (<= 2 lr = {2 * lr:g}), worst leaf's share moved "
                   f"differently by > lr/100 {p_frac:.4f} (<= 0.05)")
        loss1, want1 = ref["grads"]
        parts = []
        ok1 = True
        for tag, (l, g) in (("tp", (loss, full)), ("control", (want_loss, want))):
            ok, gap, emb, rel = reference_gate(g, want1)
            ok1 &= ok and abs(l - loss1) < 2e-3
            parts.append(f"{tag}: loss |d| {abs(l - loss1):.3e} (< 2e-3), worst element-wise "
                         f"gap {gap:.3e} (< 2e-3, the embedding aside), embed relative norm "
                         f"{emb:.3e} (< 0.05); worst leaf's gap over its max {rel:.2e}")
        gn1, skipped1, want1_after = ref["step"]
        p1 = max(float((after["params"][k] - w).abs().max())
                 for k, w in want1_after["params"].items())
        ok1 &= skipped1 == 0 and abs(gn - gn1) <= EP_GRAD_REL * gn1 and p1 <= 2 * lr
        run.record("tp/world 1", ok1,
                   f"against world 1 {loss1!r} at the reference's EP gates: " + "; ".join(parts)
                   + f"; the step's grad norm {gn!r} vs {gn1!r} (relative "
                   f"{abs(gn - gn1) / gn1:.2e} <= {EP_GRAD_REL:g}), params max |d| {p1:.3e} "
                   f"(<= 2 lr)")
        by_e = {}
        for coords, c in lanes:
            by_e.setdefault(coords[1], []).append(c)
        same_lanes = all(all(c == cs[0] for c in cs) for cs in by_e.values())
        run.record("tp/lanes", same_lanes and len(by_e) == plan.ep and by_e[0] != by_e[1],
                   f"after the step the {plan.tp} tp lanes of each EP rank hold bitwise-equal "
                   f"params (per-leaf CRC32s) of every leaf the plan keeps whole: "
                   f"{same_lanes} (the sliced {sorted(plan.layout)} are each lane's own slices)")
        run.note("tp/time", f"loss and gradients {secs_g:.3f} s, one train step {secs:.3f} s "
                            f"(gloo through the host); peak GB a rank {peaks}")
    del full, after, want, want_after
    for mode in SERVE_MODES:
        tokens, secs = _timed(lambda: _mesh_serve(_mesh_arch(EP_DEPTH, mode),
                                                  sharding.make_plan(arch, MESH_TP), params,
                                                  dev))
        if run.lead:
            run.record(f"tp/serve/{mode}", tokens == ref[mode],
                       f"{len(tokens)} requests, tokens equal world 1's: {tokens == ref[mode]} "
                       f"(first: {tokens[0][:8]}); {secs:.2f} s")
    run.note("tp/serve/peak", f"peak GB a rank {run.peak_gb()}")
    return run.finish()


def _mesh_pp(rank: int, world: int, tmp: str) -> dict:
    """(d): checkpointing under a pipeline, two ranks at (2, 1, 1), 1f1b,
    granite at depth ``PIPE_DEPTH``."""
    from repro_torch import obs, sharding
    from repro_torch.checkpoint import checkpoint_steps, leaf_crc32s
    from repro_torch.convert import shard_params
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    run = _MeshRun(rank, world, tmp, "pp")
    dev = run.dev
    arch = _mesh_arch(PIPE_DEPTH, aux_loss_coef=0.0)
    quiet = lambda s: None  # noqa: E731
    data = SyntheticTokens(arch.vocab_size, *MESH_PP_BATCH)
    ck = MESH_CK

    def plan_of(**kw):
        return sharding.make_plan(arch, (PIPE_PP, 1, 1), pipeline_on_pod=True,
                                  microbatches=PIPE_M, **kw)

    def sharded(state, plan):
        return {k: shard_params(v, plan) if k in ("params", "m", "v") else v
                for k, v in state.items()}

    def fit(d=None, seed=0, injector=None, every=ck["every"]):
        """(trainer, fit output, this rank's final state {path: tensor},
        the run's telemetry ring)."""
        ring = obs.RingBufferSink()
        tr = Trainer(LanguageModel(arch, plan_of(schedule="1f1b")),
                     OptimizerConfig(lr=1e-3, total_steps=ck["steps"]),
                     TrainerConfig(total_steps=ck["steps"], checkpoint_dir=d,
                                   checkpoint_every=every, checkpoint_keep=ck["keep"],
                                   log_every=10 ** 9),
                     log_fn=quiet, injector=injector,
                     telemetry=obs.Telemetry(enabled=True, sinks=[ring]))
        lm = tr.lm
        out = tr.fit(sharded(init_state(lm, torch.Generator(device=dev).manual_seed(seed),
                                        dev), lm.plan), data)
        return tr, out, tree_paths(out["state"]), ring

    def everywhere(x) -> list:
        got = [None] * world
        torch.distributed.all_gather_object(got, x)
        return got

    def spans(ring, name):
        return [(e["dur"], e["attrs"]) for e in ring.events()
                if e["kind"] == "span" and e["name"] == name]

    def restored_crc_equal(lm, d):
        tr = Trainer(lm, OptimizerConfig(lr=1e-3), TrainerConfig(checkpoint_dir=d),
                     log_fn=quiet)
        st = init_state(lm, torch.Generator(device=dev).manual_seed(9), dev)
        if tr.plan is not None:
            st = sharded(st, tr.plan)
        (st, step), secs = _timed(lambda: tr._restore_latest(st))
        crc = leaf_crc32s(tr.global_state(st))
        manifest = json.loads(Path(d, f"step_{step:08d}", "manifest.json").read_text())
        return step, crc == manifest["crc32"], secs

    run.start()
    tr_a, out_a, full_a, _ = fit()
    peaks = run.peak_gb()
    loss_a = float(out_a["metrics"]["loss"])
    times = [round(t, 3) for t in tr_a.step_times]
    inj = FaultInjector(FaultPlan([FaultSpec("train.nonfinite", step=ck["nan"], count=3),
                                   FaultSpec("train.sigterm", step=ck["sigterm"])]),
                        log_fn=quiet)
    d = f"{tmp}/ckB"
    tr_b, out_b, _, ring_b = fit(d, injector=inj)
    saved_b = checkpoint_steps(d)
    rb = [(r["at_step"], r["to_step"]) for r in out_b["rollbacks"]]
    nan = list(range(ck["nan"], ck["nan"] + 3))
    run.record("pp/run B", [a["step"] for a in out_b["anomalies"]] == nan
               and rb == [(nan[-1], ck["nan"])] and out_b["last_step"] == ck["sigterm"] - 1
               and saved_b[-1] == ck["sigterm"],
               f"NaN at steps {[a['step'] for a in out_b['anomalies']]} skipped, rollbacks "
               f"{rb}, SIGTERM at {ck['sigterm']} -> final save; checkpoints {saved_b}")
    del out_b
    # The resume saves once, at its end.
    tr_c, out_c, full_c, ring_c = fit(d, seed=7, every=10 ** 9)
    loss_c = float(out_c["metrics"]["loss"])
    # Bitwise on every rank's shard is bitwise on the global state.
    same = all(everywhere(all(torch.equal(full_c[k], full_a[k]) for k in full_a)))
    line = (f"run B's resume (another seed's state) from step {tr_c.resumed_from} to "
            f"{ck['steps']}: loss {loss_c!r} vs run A's {loss_a!r}; state bitwise A's on "
            f"every rank: {same}")
    ok = same and loss_c == loss_a
    if not ok:
        # Phase "checkpoint"'s rule: no further from A than a repeat A2.
        _, out_a2, full_a2, _ = fit()

        def gap(x):
            return max(everywhere(max(float((x[k].float() - full_a[k].float()).abs().max())
                                      for k in full_a if full_a[k].is_floating_point())))

        gap_c, gap_2 = gap(full_c), gap(full_a2)
        ok = gap_c <= gap_2
        line += f"; max |d| to A {gap_c:.3e} vs a repeat A2's {gap_2:.3e}"
        del out_a2, full_a2
    run.record("pp/resume", ok and tr_c.resumed_from == ck["sigterm"], line)
    del out_c, full_c, full_a, out_a
    saves = spans(ring_b, "ckpt.save") + spans(ring_c, "ckpt.save")
    restores = spans(ring_b, "ckpt.restore") + spans(ring_c, "ckpt.restore")
    if run.lead:
        run.note("pp/ckpt", (
            f"a checkpoint {saves[0][1]['bytes']} bytes (the global tree at depth "
            f"{PIPE_DEPTH}); saves {[round(s, 3) for s, _ in saves]} s (CRC and write, rank "
            f"0), restores {[round(s, 3) for s, _ in restores]} s; run A steps {times} s "
            f"(gloo hand-offs through the host); peak GB a rank {peaks}"))
        # The PP 2 checkpoint restored at world 1, on rank 0 alone.
        step, crc_ok, secs = restored_crc_equal(LanguageModel(arch), d)
        run.record("pp/world 1", crc_ok and step == ck["steps"],
                   f"the PP {PIPE_PP} checkpoint of step {step} restored at world 1 "
                   f"({secs:.3f} s): CRC32s equal the manifest's: {crc_ok}")
    step, crc_ok, secs = restored_crc_equal(
        LanguageModel(arch, plan_of(schedule="interleaved_1f1b", vstages=2)), d)
    run.record("pp/interleaved V 2", crc_ok and step == ck["steps"],
               f"restored at PP {PIPE_PP} under interleaved_1f1b, V 2 ({secs:.3f} s): "
               f"gathered CRC32s equal the manifest's: {crc_ok}")
    return run.finish()


def _mesh_r4(rank: int, world: int, tmp: str) -> dict:
    """(e) migration at PP 2 x EP 2 (2, 1, 2), granite at depth
    ``MESH_PP_EP_DEPTH``, skewed tokens; (f) serving data parallelism at
    ``MESH_DP``, depth ``EP_DEPTH``, against world 1 on rank 0; (g) the
    "seq" / "kv_seq" serving layout; (h) the Mamba2 mixer across sequence
    slices."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.checkpoint import leaf_crc32s
    from repro_torch.convert import _unstage_chunks, shard_params
    from repro_torch.core import migration as mig
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    run = _MeshRun(rank, world, tmp, "r4")
    dev = run.dev
    quiet = lambda s: None  # noqa: E731
    sarch = _mesh_arch(EP_DEPTH)
    sparams = init_params(sarch, torch.Generator(device=dev).manual_seed(0), dev)
    ref = ({mode: _mesh_serve(_mesh_arch(EP_DEPTH, mode), None, sparams, dev)
            for mode in SERVE_MODES} if run.lead else {})
    seq_refs = _seq_world1(dev) if run.lead else {}
    ssm_refs = _seq_ssm_world1(dev, tmp) if run.lead else {}
    run.start()

    # (e) Migrations every MIG_EVERY of MESH_MIG_STEPS steps, swap-only.
    arch = _mesh_arch(MESH_PP_EP_DEPTH, max_replicas=0, aux_loss_coef=0.0)
    plan = sharding.make_plan(arch, (PIPE_PP, 1, 2), pipeline_on_pod=True,
                              microbatches=MESH_PP_EP_M)
    lm = LanguageModel(arch, plan)
    opt = OptimizerConfig(lr=1e-3)
    moe_pos = [i for i, (_, f) in enumerate(arch.block_pattern) if f == "moe"]

    def batch_at(step: int) -> dict:
        rng = np.random.default_rng(step)
        toks = rng.integers(0, 4, size=MESH_PP_EP_BATCH, dtype=np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}

    def sharded(state):
        return {k: shard_params(v, plan) if k in ("params", "m", "v") else v
                for k, v in state.items()}

    def stage_slots(state):
        """This stage's expert leaves of params, m and v all-gathered over
        the EP group (copies), and its routing tables."""
        full = {}
        for t in ("params", "m", "v"):
            for pos in moe_pos:
                for k in mig.EXPERT_PARAM_KEYS:
                    leaf = state[t]["blocks"][pos]["ffn"][k]
                    parts = [torch.empty_like(leaf) for _ in range(plan.ep)]
                    dist.all_gather(parts, leaf.contiguous(), group=plan.ep_group)
                    full[(t, pos, k)] = torch.cat(parts, dim=1)
        return full, {pos: state["params"]["blocks"][pos]["ffn"]["assignment"].cpu().numpy()
                      .copy() for pos in moe_pos}

    def permuted_exactly(pre, a0, state) -> bool:
        """This rank's slots after the migration are the manual permutation
        of the stage's gathered slots before it."""
        ok = True
        E_l = arch.moe.num_experts // plan.ep
        for (t, pos, k), w in pre.items():
            a1 = state["params"]["blocks"][pos]["ffn"]["assignment"].cpu().numpy()
            perm = np.stack([mig.permutation_for(a0[pos][r], a1[r]) for r in range(len(a1))])
            idx = torch.as_tensor(perm[:, plan.ep_rank * E_l:(plan.ep_rank + 1) * E_l],
                                  dtype=torch.long, device=dev)
            idx = idx.reshape(idx.shape + (1,) * (w.dim() - 2)).expand(
                (w.shape[0], E_l) + w.shape[2:])
            ok &= torch.equal(state[t]["blocks"][pos]["ffn"][k], torch.gather(w, 1, idx))
        return bool(ok)

    tr = Trainer(lm, opt, TrainerConfig(checkpoint_dir=f"{tmp}/ckM", migrate_every=MIG_EVERY,
                                        migrate_threshold=MIG_THRESHOLD), log_fn=quiet)
    state = sharded(init_state(lm, torch.Generator(device=dev).manual_seed(0), dev))
    losses, exact, times = [], True, []
    for s in range(MESH_MIG_STEPS):
        (state, met), secs = _timed(lambda: tr.train_step(state, batch_at(s)))
        times.append(round(secs, 3))
        losses.append(float(met["loss"]))
        loads = met["expert_load_host"]
        tr.load_stats.update(np.concatenate([loads[:, i] for i in range(loads.shape[1])]))
        if (s + 1) % MIG_EVERY:
            continue
        pre, a0 = stage_slots(state)
        n = len(tr.migrations)
        tr._maybe_migrate(state, s + 1)
        if len(tr.migrations) > n and tr.migrations[-1]["applied"]:
            exact &= permuted_exactly(pre, a0, state)
        del pre
    peaks = run.peak_gb()
    applied = [m for m in tr.migrations if m["applied"]]
    for i, m in enumerate(tr.migrations):
        run.note(f"mig/migration #{i}", (
            f"step {m['step']}: imbalance {m['imbalance']:.4f} -> {m['imbalance_post']:.4f}, "
            f"swaps {m['swaps']}, applied {m['applied']}, {m.get('seconds', 0):.3f} s (gloo "
            f"through the host, not NVLink), all-gathered {m.get('gathered_bytes', 0)} bytes "
            f"a rank"))
    got = [None] * world
    dist.all_gather_object(got, bool(exact))
    exact = all(got)
    # A checkpoint after the migrations, restored at world 1 on rank 0.
    tr._save(MESH_MIG_STEPS, state, blocking=True)
    final = {pos: _unstage_chunks(state["params"]["blocks"][pos]["ffn"]["assignment"], plan)
             for pos in moe_pos}
    if run.lead:
        one = init_state(LanguageModel(arch), torch.Generator(device=dev).manual_seed(5), dev)
        tr1 = Trainer(LanguageModel(arch), opt, TrainerConfig(checkpoint_dir=f"{tmp}/ckM"),
                      log_fn=quiet)
        one, step = tr1._restore_latest(one)
        manifest = json.loads(Path(tmp, "ckM", f"step_{step:08d}",
                                   "manifest.json").read_text())
        crc_ok = leaf_crc32s(one) == manifest["crc32"]
        moved = any(not torch.equal(one["params"]["blocks"][pos]["ffn"]["assignment"],
                                    torch.arange(arch.moe.num_experts, dtype=torch.int32,
                                                 device=dev).expand_as(
                                        one["params"]["blocks"][pos]["ffn"]["assignment"]))
                    for pos in moe_pos)
        run.record("mig/checkpoint", crc_ok and moved and step == MESH_MIG_STEPS,
                   f"saved at PP {plan.pp} x EP {plan.ep} after the migrations (assignments "
                   f"moved: {moved}), restored at world 1: CRC32s equal the manifest's: "
                   f"{crc_ok}")
        del one
    del state
    # Run B: the final tables baked into the init, no migration.
    full = init_state(lm, torch.Generator(device=dev).manual_seed(0), dev)
    for pos in moe_pos:
        a1 = final[pos].cpu().numpy()
        perm = np.stack([mig.permutation_for(np.arange(a1.shape[1]), a1[r])
                         for r in range(len(a1))])
        for t in ("params", "m", "v"):
            mig.apply_migration_(full[t]["blocks"][pos]["ffn"], perm)
        full["params"]["blocks"][pos]["ffn"]["assignment"].copy_(final[pos])
    tr_b = Trainer(lm, opt, TrainerConfig(migrate_every=10 ** 9), log_fn=quiet)
    state_b = sharded(full)
    del full
    losses_b = [float(tr_b.train_step(state_b, batch_at(s))[1]["loss"])
                for s in range(MESH_MIG_STEPS)]
    del state_b
    gap = max(abs(a - b) for a, b in zip(losses, losses_b))
    run.record("mig/exact", len(applied) >= 1 and exact and (losses == losses_b or gap <= 1e-6),
               f"PP {plan.pp} x EP {plan.ep}: {len(applied)} migrations applied; each rank's "
               f"params, m and v after each bitwise the manual permutation of its stage's "
               f"slots: {exact}; losses {losses} vs permuted init {losses_b}: "
               + ("bitwise" if losses == losses_b else f"max |d| {gap:.3e} (bound 1e-6)"))
    run.note("mig/time", f"steps {times} s (gloo through the host); peak GB a rank {peaks}")

    # (f) Serving data parallelism.
    for mesh in MESH_DP:
        for mode in SERVE_MODES:
            splan = sharding.make_plan(sarch, mesh)
            tokens, secs = _timed(lambda: _mesh_serve(_mesh_arch(EP_DEPTH, mode), splan,
                                                      sparams, dev))
            if run.lead:
                ok = tokens == ref[mode]
                run.record(f"dp/{','.join(map(str, mesh))}/{mode}", ok,
                           f"dp {splan.dp} x ep {splan.ep} (dp_axes {splan.dp_axes}): "
                           f"{len(tokens)} requests, tokens equal world 1's: {ok} (first: "
                           f"{tokens[0][:8]}); {secs:.2f} s")
    run.note("dp/peak", f"peak GB a rank {run.peak_gb()}")

    # (g) The "seq" / "kv_seq" serving layout.
    del sparams
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _mesh_seq_serve(run, dev, seq_refs)
    run.note("seq/peak", f"peak GB a rank {run.peak_gb()}; (g) {time.perf_counter() - t1:.1f} s")

    # (h) The Mamba2 mixer across sequence slices.
    run.out["ssd_row"] = _mesh_seq_ssm(run, dev, ssm_refs)
    return run.finish()


def mesh_phase(dev):
    """Phase 15: (a) the kernels at its shapes; (b), (c) six gloo ranks at
    ``MESH_TP``; (d) two at PP 2 with checkpoints; (e), (f) four at PP 2 x
    EP 2 and at D 2 x EP 2, then (g) and (h) on them.  Returns every rank's
    summed launch counts, (a')'s rows and (h)'s ``ssd_intra_chunk`` row a
    rank."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_kernel_checks(dev)
    q_offset_rows = seq_flash_checks(dev)
    log(f"[mesh] gloo ranks on one {torch.cuda.get_device_name(0)}: every collective and "
        f"hand-off stages through the host, so no all-to-all, hand-off or all-gather time "
        f"of this phase measures NVLink or NCCL")
    res = {}
    for part, world in (("tp", MESH_TP[0] * MESH_TP[1]), ("pp", PIPE_PP), ("r4", 4)):
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_mesh_{part}_")
        t1 = time.perf_counter()
        try:
            mp.start_processes(_mesh_rank, args=(world, tmp, part), nprocs=world,
                               start_method=RANK_START)
            res[part] = [json.loads(Path(tmp, f"{part}{r}.json").read_text())
                         for r in range(world)]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        errors = [f"rank {i}: {r['error']}\n{r['trace']}" for i, r in enumerate(res[part])
                  if "error" in r]
        if errors:
            fail(f"mesh {part}: " + "\n".join(errors))
        for k, v in res[part][0].items():
            if "/" in k:
                tag = "[check]" if v.endswith(("ok", "FAIL")) else "[mesh]"
                log(f"{tag} mesh {part} x{world} {k}: {v}")
        for r in res[part][1:]:  # (h)'s first kernel call, held on every rank
            for k, v in r.items():
                if k.startswith("ssm/first call"):
                    log(f"[check] mesh {part} x{world} {k}: {v}")
        log(f"[mesh] {part}: {world} ranks, {time.perf_counter() - t1:.1f} s")
    counts = {}
    for part, rs in res.items():
        for r in rs:
            label = f"mesh {part} rank {r['rank']}"
            fp32 = r.get("fp32_counts", {})  # (g)'s fp32 runs: the fp32 designs, by intent
            bf16 = {name: n - fp32.get(name, 0) for name, n in r["counts"].items()}
            fp32 = {name: n for name, n in fp32.items() if "/" in name and n}
            log(f"[mesh] {label} designs {check_designs(bf16, label)}"
                + (f"; (g)'s fp32 runs besides: {fp32}" if fp32 else ""))
            for name, n in r["counts"].items():
                counts[name] = counts.get(name, 0) + n
    for name in PATH_KERNELS["mesh"]:
        if counts[name] == 0:
            fail(f"mesh: no rank launched {name}")
    if not all(r["ok"] for rs in res.values() for r in rs):
        fail("mesh: a check of the multi-rank runs failed")
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
    return counts, q_offset_rows, [r["ssd_row"] for r in res["r4"]]


# ---------------------------------------------------------------------------
# Phase 16: the plan's memory policy (remat, bf16 moments, the d_ff split)
# ---------------------------------------------------------------------------

MEM_BATCH, MEM_LONG = (2, 512), (2, 4096)  # the training phase's; the reference's seq
MEM_PASSES, MEM_LONG_STEPS, MEM_MOMENT_STEPS = 3, 3, 5
MEM_HBM_GB = 80.0
# bf16 against fp32 moments over (c)'s steps at the launcher's optimizer
# settings: the loss within this relative gap, the bound of
# tests/test_torch_memory.py's test of the same pair of runs.
MEM_MOMENT_REL = 1e-4
# Launches a MoE layer of one loss-and-gradients pass under each remat
# (gate-up, ragged matmul, dW): the forward (1, 1, 0) and the backward
# (0, 3, 3), plus under "full" each rep's forward again.  "dots" keeps the
# outputs of aten products only; the ragged kernels are extension calls it
# does not see, so it recomputes them as "full" does.
MEM_REMAT_LAUNCHES = {"none": (1, 4, 3), "dots": (2, 5, 3), "full": (2, 5, 3)}
MEM_SPLIT_MESH, MEM_SPLIT_BATCH = (2, 2), (4, 512)  # D 2 x ep 2: d_ff 512 in 2 slices
MEM_SPLIT_DEPTH = 1  # 2 until PR 29's budget cut (PERF.md §6)
MEM_SWAP = (0, 25)  # slots swapped in every rep: EP rank 0's and EP rank 1's
PATH_KERNELS["memory"] = PIPE_KERNELS


def mem_kernel_checks(dev) -> None:
    """The ragged kernels at (b)'s train step: 2 x 4096 tokens routed top-8
    over granite's 40 experts, T x k = 65,536 rows, in the forward, the
    recompute and the backward."""
    ragged_family_checks(dev, MEM_LONG[0] * MEM_LONG[1], "memory (b) step", seed=5)


def _mem_arch(depth=None):
    import dataclasses

    from repro_torch.configs import get_arch

    base = get_arch(ARCH)
    arch = base.replace(moe=dataclasses.replace(base.moe, dispatch="ragged"))
    return arch if depth is None else arch.replace(num_layers=depth)


def _mem_modeled_gb(arch, b: int, s: int, remat: str, odt: str = "float32") -> float:
    """The resource model's mem_stage0 of one rank training ``arch`` at b x
    s under the policy (``launch.train.memory_setup``: "dots" priced as a
    checkpointed stack, the eager training attention's s^2 scores)."""
    from repro_torch import sharding
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100
    from repro_torch.launch.train import memory_setup

    plan = sharding.MeshPlan(dp=1, ep=1, remat=remat, optimizer_dtype=odt)
    setup = rm.TrainSetup(b=b, s=s, zero="world", dispatch="ragged", **memory_setup(plan))
    return rm.estimate(rm.ModelShape.from_arch(arch), setup, H100).mem_stage0 / 1e9


def _mem_launches(counts, want, n_moe: int, label: str) -> None:
    """Fail unless ``counts`` has ``n_moe`` x ``want`` (gate-up, ragged,
    dW) launches, none through ``/fma``."""
    want = dict(zip(PIPE_KERNELS, (k * n_moe for k in want)))
    got = {n: counts[n] for n in PIPE_KERNELS}
    if got != want:
        fail(f"memory {label}: launches {got}, expected {want}")
    check_designs(counts, f"memory {label}")


def _mem_remat(dev, add) -> None:
    """(a) Full depth, 2 x 512: the loss and every gradient leaf under each
    remat against "none", bitwise, else no further than a repeat of
    "none"; peak and pass p50 of each; exact launches a pass."""
    from repro_torch import kernels, sharding, training
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, init_params, tree_paths

    arch = _mem_arch()
    n_moe = sum(1 for _, f in arch.layers if f == "moe")
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    p_gb = sum(t.numel() * t.element_size() for t in tree_paths(params).values()) / 1e9
    batch = SyntheticTokens(arch.vocab_size, *MEM_BATCH).batch_at(0)
    ref, gaps = None, {}
    for tag in ("none", "dots", "full", "none again"):
        remat = tag.split()[0]
        lm = LanguageModel(arch, sharding.single_device_plan(arch, remat=remat))
        kernels.reset_launch_counts()
        loss, _, grads = training.loss_and_grads(lm, params, batch)
        flat = {k: g for k, g in tree_paths(grads).items() if g is not None}
        del grads
        if ref is None:
            ref = (loss, flat)
        else:
            bitwise = torch.equal(loss, ref[0]) and all(torch.equal(g, ref[1][k])
                                                        for k, g in flat.items())
            gap = max(float((g - ref[1][k]).abs().max()) for k, g in flat.items())
            gaps[tag] = (bitwise, gap, abs(float(loss) - float(ref[0])))
        del flat
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = [_timed(lambda: training.loss_and_grads(lm, params, batch))[1]
                 for _ in range(MEM_PASSES)]
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9 + p_gb
        counts = kernels.launch_counts()
        add(counts)
        _mem_launches(counts, MEM_REMAT_LAUNCHES[remat], n_moe * (MEM_PASSES + 1),
                      f"(a) remat {tag}")
        log(f"[memory] (a) full depth {MEM_BATCH[0]} x {MEM_BATCH[1]}, remat {tag}: loss "
            f"{float(loss)!r}; peak {peak:.2f} GB with the params alone resident "
            f"({p_gb:.2f} GB of them); loss-and-gradients pass p50 "
            f"{1e3 * float(np.median(times)):.1f} ms of {MEM_PASSES}; launches a pass "
            f"{MEM_REMAT_LAUNCHES[remat]} x {n_moe} MoE layers")
    del ref
    noise = gaps["none again"][1]
    for tag in ("dots", "full"):
        bitwise, gap, dl = gaps[tag]
        ok = bitwise or gap <= noise
        line = (f"[check] memory (a) remat {tag} vs none: loss and {len(arch.layers)}-layer "
                f"gradients " + ("bitwise" if bitwise else
                                 f"max |d| {gap:.3e} (loss {dl:.3e}) vs a repeat of none "
                                 f"{noise:.3e}") + f" {'ok' if ok else 'FAIL'}")
        log(line)
        if not ok:
            fail(f"memory (a): remat {tag} differs from none past a repeat's gap")
    log(f"[memory] (a) repeat of none: " + ("bitwise" if gaps["none again"][0]
                                             else f"max |d| {noise:.3e}"))
    del params


def _mem_long(dev, add) -> None:
    """(b) Full depth at the reference's 2 x 4096: 3 train steps under
    remat full and dots (and none where its modeled peak fits the card),
    finite losses, none skipped; peaks beside the modeled mem_stage0."""
    from repro_torch import kernels, sharding, training
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig

    arch = _mem_arch()
    n_moe = sum(1 for _, f in arch.layers if f == "moe")
    b, s = MEM_LONG
    modeled = {r: _mem_modeled_gb(arch, b, s, r) for r in ("none", "dots", "full")}
    log(f"[memory] (b) modeled mem_stage0 at {b} x {s} on H100: " + ", ".join(
        f"{r} {g:.2f} GB" for r, g in modeled.items()))
    data = SyntheticTokens(arch.vocab_size, b, s)
    for remat in ("full", "dots", "none"):
        if modeled[remat] > MEM_HBM_GB:
            log(f"[memory] (b) remat {remat} not run: modeled {modeled[remat]:.2f} GB > "
                f"{MEM_HBM_GB:g} GB")
            continue
        torch.cuda.empty_cache()
        lm = LanguageModel(arch, sharding.single_device_plan(arch, remat=remat))
        state = training.init_state(lm, torch.Generator(device=dev).manual_seed(0), dev)
        step = training.make_train_step(lm, OptimizerConfig(total_steps=MEM_LONG_STEPS))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, skipped, times = [], 0, []
        for i in range(MEM_LONG_STEPS):
            out, sec = _timed(lambda: step(state, data.batch_at(i)))
            met = out[1]
            del out  # holds the state too, which must go before the next remat
            losses.append(float(met["loss"]))
            skipped += met["skipped"]
            times.append(sec)
        counts = kernels.launch_counts()
        add(counts)
        _mem_launches(counts, MEM_REMAT_LAUNCHES[remat], n_moe * MEM_LONG_STEPS,
                      f"(b) remat {remat}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        ok = skipped == 0 and all(np.isfinite(losses))
        log(f"[check] memory (b) full depth {b} x {s}, remat {remat}: {MEM_LONG_STEPS} steps, "
            f"losses {losses}, {skipped} skipped; step times "
            f"{[round(t, 3) for t in times]} s; peak {peak:.2f} GB vs modeled mem_stage0 "
            f"{modeled[remat]:.2f} GB {'ok' if ok else 'FAIL'}")
        del state, step
        if not ok:
            fail(f"memory (b): remat {remat} at {b} x {s}")


def _mem_moments(dev, add) -> None:
    """(c) Full depth, 2 x 512, 5 steps with fp32 and with bf16 moments:
    2 B a float parameter a moment, the loss trajectories within
    ``MEM_MOMENT_REL`` of each other, the peaks."""
    from repro_torch import kernels, sharding, training
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig

    arch = _mem_arch()
    data = SyntheticTokens(arch.vocab_size, *MEM_BATCH)
    runs = {}
    for odt in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        lm = LanguageModel(arch, sharding.single_device_plan(arch, optimizer_dtype=odt))
        state = training.init_state(lm, torch.Generator(device=dev).manual_seed(0), dev)
        n = sum(t.numel() for t in tree_paths(state["params"]).values() if t.is_floating_point())
        nbytes = [sum(t.numel() * t.element_size() for t in tree_paths(state[m]).values()
                      if t.is_floating_point()) for m in ("m", "v")]
        step = training.make_train_step(lm, OptimizerConfig(total_steps=MEM_MOMENT_STEPS))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses = [float(step(state, data.batch_at(i))[1]["loss"])
                  for i in range(MEM_MOMENT_STEPS)]
        add(kernels.launch_counts())
        runs[odt] = (losses, torch.cuda.max_memory_allocated() / 1e9, nbytes, n)
        del state, step
    (l32, p32, b32, n), (l16, p16, b16, _) = runs["float32"], runs["bfloat16"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(l32, l16))
    ok = b16 == [2 * n, 2 * n] and b32 == [4 * n, 4 * n] and rel <= MEM_MOMENT_REL and all(
        np.isfinite(l16))
    log(f"[check] memory (c) full depth {MEM_BATCH[0]} x {MEM_BATCH[1]}, {MEM_MOMENT_STEPS} "
        f"steps: bf16 moments {b16[0] / n:g} + {b16[1] / n:g} B a float param ({n} params; "
        f"fp32 {b32[0] / n:g} + {b32[1] / n:g}); losses fp32 {l32} vs bf16 {l16}: max "
        f"relative {rel:.3e} (bound {MEM_MOMENT_REL:g}); peak {p32:.2f} -> {p16:.2f} GB "
        f"(-{p32 - p16:.2f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("memory (c): bf16 moments")


def _memory_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of phase 16 (d) (``torch.multiprocessing`` target);
    writes ``tmp/mem<r>.json``, or the failure there."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        out = _mem_split(rank, world, tmp)
    except Exception as e:  # reported to the parent, which fails the phase
        out = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-3000:]}
    Path(tmp, f"mem{rank}.json").write_text(json.dumps(out))


ZERO_TAGS = ("vocab", "embed", "model_out", "ssm_inner")  # the non-expert rules


def _mem_plans(sliced):
    """Phase 16 (d)'s three plans on one grid: "whole" (every leaf whole on
    each rank of a stage), "split" (the expert d_ff split alone) and
    "sliced" (the default: the rule table slices the non-expert weights
    too)."""
    import dataclasses

    flat = {**sliced.rules, **{t: None for t in ZERO_TAGS}}
    split = dataclasses.replace(sliced, rules=flat)
    return {"whole": dataclasses.replace(split, ffn_split=1, ffn_whole="control"),
            "split": split, "sliced": sliced}


class _GatherClock:
    """Seconds spent in ``sharding``'s weight gathers (forward: the d_ff
    gather, and ``gather_leaves``, one collective a layer's sliced leaves
    or the table) and their backward sums while installed, the card
    synchronized around each, and the model's forwards (its calls of
    ``LanguageModel._whole``)."""

    def __init__(self):
        from repro_torch import sharding
        from repro_torch.models.model import LanguageModel

        self.sharding, self.lm_cls = sharding, LanguageModel
        self.calls, self.forwards = {"ffn": [], "leaf": [], "backward": []}, 0

    def _count(self, fn):
        def counted(*a, **k):
            self.forwards += 1
            return fn(*a, **k)
        return counted

    def _wrap(self, fn, key):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.calls[key].append(time.perf_counter() - t0)
            return out
        return timed

    def __enter__(self):
        sh = self.sharding
        self.saved = (sh.gather_ffn, sh.gather_leaves, sh._GatherSlices.backward)
        self.whole = self.lm_cls._whole
        self.lm_cls._whole = self._count(self.whole)
        sh.gather_ffn = self._wrap(sh.gather_ffn, "ffn")
        sh.gather_leaves = self._wrap(sh.gather_leaves, "leaf")
        sh._GatherSlices.backward = staticmethod(self._wrap(sh._GatherSlices.backward,
                                                            "backward"))
        return self

    def __exit__(self, *exc):
        sh = self.sharding
        sh.gather_ffn, sh.gather_leaves, back = self.saved
        sh._GatherSlices.backward = staticmethod(back)
        self.lm_cls._whole = self.whole

    def line(self) -> str:
        return ", ".join(f"{k} {len(v)} calls {1e3 * sum(v):.2f} ms" for k, v in
                         self.calls.items())


def _mem_split(rank: int, world: int, tmp: str) -> dict:
    """(d) Four ranks at ``MEM_SPLIT_MESH``, granite full width, depth
    ``MEM_SPLIT_DEPTH``, under :func:`_mem_plans`' three plans: the bytes a
    rank holds, its peak and one train step under each; the loss and
    gathered gradients of "split" and "sliced" against "whole"; a sliced
    checkpoint restored at world 1; a swap on the slices; served tokens;
    the gathers' ms a train step and a decode step."""
    import torch.distributed as dist

    from repro_torch import sharding, training
    from repro_torch.checkpoint import leaf_crc32s, latest_step
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.core import migration as mig
    from repro_torch.core import resource_model as rm
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    run = _MeshRun(rank, world, tmp, "mem")
    dev = run.dev
    arch = _mesh_arch(MEM_SPLIT_DEPTH)
    opt = OptimizerConfig(lr=1e-3)  # step 1 of its 100-step warmup: lr 1e-5
    lr = 1e-3 / 100
    batch = SyntheticTokens(arch.vocab_size, *MEM_SPLIT_BATCH).batch_at(0)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    ref_tokens = _mesh_serve(arch, None, params, dev) if run.lead else None
    split_plan = sharding.make_plan(arch, MEM_SPLIT_MESH)
    plans = _mem_plans(split_plan)
    layout = plans["sliced"].layout
    run.note("plan", " | ".join(f"{k}: {p.describe()}" for k, p in plans.items()))
    run.start()

    def held_bytes(state):
        """{"all", "expert": bytes, leaf: bytes of every sliced leaf} of
        params, m and v."""
        out = {"all": 0, "expert": 0}
        for part in ("params", "m", "v"):
            flat = tree_paths(state[part])
            out["all"] += sum(t.numel() * t.element_size() for t in flat.values())
            out["expert"] += sum(flat[k].numel() * flat[k].element_size()
                                 for k in sharding.expert_paths(flat))
            for k in layout:
                out[k] = out.get(k, 0) + flat[k].numel() * flat[k].element_size()
        return out

    # One train step each at remat full, on the card alone: held bytes,
    # peaks, the stepped params (gathered, kept on rank 0); the gathers'
    # time in the sliced plan's step.
    stepped, held, peaks = {}, {}, {}
    clock = _GatherClock()
    for kind, plan in plans.items():
        lm = LanguageModel(arch, plan)
        mine = map_tree(lambda t: t.clone(), shard_params(params, plan))
        state = {"params": mine, **adamw_init(mine)}
        held[kind] = held_bytes(state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if kind == "sliced":
            with clock:
                met, secs = _timed(lambda: training.make_train_step(lm, opt)(state, batch)[1])
        else:
            met, secs = _timed(lambda: training.make_train_step(lm, opt)(state, batch)[1])
        peaks[kind] = (run.peak_gb(), secs)
        g = gather_params(state["params"], plan)
        if run.lead:  # on the host: the next kind's peak must not hold it
            stepped[kind] = (float(met["grad_norm"]), map_tree(lambda t: t.cpu(), g))
        del state, mine, g
    ratio = held["whole"]["expert"] / held["split"]["expert"]
    quarter = {k: held["whole"][k] / held["sliced"][k] for k in layout}
    n = plans["sliced"].stage_size
    mine = [ratio, held["sliced"]["expert"] == held["split"]["expert"],
            all(q == n for q in quarter.values())]
    allheld = [None] * world
    dist.all_gather_object(allheld, mine)
    run.record("held", all(r[0] == 2.0 and r[1] for r in allheld),
               f"expert params, m and v a rank: {held['split']['expert']} B split and sliced vs "
               f"{held['whole']['expert']} B whole; ratio on each rank "
               f"{[r[0] for r in allheld]} (want exactly 2)")
    run.record("zero/held", len(layout) > 0 and all(r[2] for r in allheld),
               f"non-expert params, m and v a rank: {sum(held['sliced'][k] for k in layout)} B "
               f"sliced vs {sum(held['whole'][k] for k in layout)} B whole in {len(layout)} "
               f"sliced leaves; each leaf's whole / sliced on each rank "
               f"{sorted(set(quarter.values()))} (want exactly {n}); "
               f"{plans['sliced'].describe().partition(' zero: ')[2]}")
    run.note("peaks", "peak GB a rank and step seconds, one train step at remat full: "
             + "; ".join(f"{k} {v[0]} ({v[1]:.2f} s)" for k, v in peaks.items()))
    setup = rm.TrainSetup(b=MEM_SPLIT_BATCH[0], s=MEM_SPLIT_BATCH[1], EP=split_plan.ep,
                          DP=split_plan.dp, zero="world", bytes_per_param=16)
    static = rm.static_state_bytes(rm.ModelShape.from_arch(arch), setup, arch.num_layers)
    run.note("zero/bytes", "params, m and v a rank, every leaf: " + ", ".join(
        f"{k} {v['all']} B" for k, v in held.items()) + f"; the resource model's "
        f"static_state_bytes(zero=\"world\") {static:.0f} B (params, grads, m, v: 16 B a "
        f"parameter over {setup.P} chips)")
    run.note("zero/step gathers", f"the sliced plan's train step: {clock.line()} (forward "
             f"gathers, recompute gathers and backward sums; gloo through the host)")
    if run.lead:
        n_w, g_w = stepped["whole"]
        parts, ok = [], True
        for kind in ("split", "sliced"):
            n_k, g_k = stepped[kind]
            gap = max(float((a - b).abs().max()) for a, b in
                      zip(tree_paths(g_k).values(), tree_paths(g_w).values())
                      if a.is_floating_point())
            ok &= gap <= 2 * lr
            parts.append(f"{kind}: grad norm {n_k!r}, params max |d| {gap:.3e}")
        run.record("step", ok, f"one AdamW step against whole (grad norm {n_w!r}): "
                   + "; ".join(parts) + f" (2 lr = {2 * lr:g})")
    stepped.clear()

    # Loss and gathered gradients, bitwise else phase 12's gates.
    res = {}
    for kind, plan in plans.items():
        (loss, _, grads), secs = _timed(lambda: training.loss_and_grads(
            LanguageModel(arch, plan), shard_params(params, plan), batch))
        g = {k: v for k, v in tree_paths(gather_params(grads, plan)).items() if v is not None}
        del grads
        if run.lead:
            res[kind] = (loss, g, secs)
        del g
    if run.lead:
        l_w, g_w, t_w = res["whole"]
        for kind, tag in (("split", "grads"), ("sliced", "zero/grads")):
            l_s, g_s, t_s = res[kind]
            bitwise = torch.equal(l_s, l_w) and all(torch.equal(g_s[k], g_w[k]) for k in g_w)
            ok, rows = ep_grad_gate(g_s, g_w)
            worst = max(rows, key=lambda k: rows[k][0] / (rows[k][1] + 1e-30))
            same = sum(torch.equal(g_s[k], g_w[k]) for k in g_w)
            run.record(tag, bitwise or (ok and abs(float(l_s) - float(l_w)) < 2e-3),
                       f"{kind}: loss {float(l_s)!r} vs whole {float(l_w)!r}; {same} of "
                       f"{len(g_w)} gathered gradient leaves bitwise"
                       + ("" if bitwise else f", worst {worst} {rows[worst][0]:.3e} of "
                                             f"{rows[worst][1]:.3e}")
                       + f"; pass {t_s:.2f} s {kind}, {t_w:.2f} s whole")
    res.clear()

    # A sliced checkpoint restored at world 1 (rank 0): CRC32s equal the
    # manifest's and the state the gathered one.
    plan = plans["sliced"]
    lm = LanguageModel(arch, plan)
    mine = map_tree(lambda t: t.clone(), shard_params(params, plan))
    state = {"params": mine, **adamw_init(mine), "step": torch.tensor(1, dtype=torch.int32)}
    gen = torch.Generator(device=dev).manual_seed(3)
    for part in ("m", "v"):
        for t in tree_paths(state[part]).values():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=gen, device=dev))
    ck = Path(tmp, "ck")
    tr = Trainer(lm, opt, TrainerConfig(checkpoint_dir=str(ck)), log_fn=lambda s: None)
    (_, secs) = _timed(lambda: tr._save(1, state, blocking=True))
    full = tr.global_state(state)
    if run.lead:
        lm1 = LanguageModel(arch)
        tr1 = Trainer(lm1, opt, TrainerConfig(checkpoint_dir=str(ck)), log_fn=lambda s: None)
        st1 = training.init_state(lm1, torch.Generator(device=dev).manual_seed(9), dev)
        st1, step = tr1._restore_latest(st1)
        manifest = json.loads((ck / f"step_{step:08d}" / "manifest.json").read_text())
        crc = leaf_crc32s(st1) == manifest["crc32"]
        same = all(torch.equal(a, b) for a, b in zip(tree_paths(st1).values(),
                                                      tree_paths(full).values()))
        run.record("ckpt", crc and same and step == latest_step(ck),
                   f"sliced checkpoint (step {step}, saved in {secs:.2f} s) restored at world "
                   f"1: CRC32s equal the manifest's {crc}, state equal the gathered {same}")
        del st1
    del full
    dist.barrier()

    # A swap on the slices: the manual permutation of the gathered state,
    # the sliced leaves unchanged.
    before = {t: gather_params(state[t], plan) for t in ("params", "m", "v")}
    reps = arch.num_layers // len(arch.block_pattern)
    E = arch.moe.num_experts
    perm = np.tile(np.arange(E, dtype=np.int32), (reps, 1))
    perm[:, list(MEM_SWAP)] = perm[:, list(MEM_SWAP[::-1])]
    moe_pos = [i for i, (_, f) in enumerate(arch.block_pattern) if f == "moe"]
    got = sum(mig.apply_migration_(state[t]["blocks"][pos]["ffn"], perm, plan)
              for t in ("params", "m", "v") for pos in moe_pos)
    exact = True
    idx = torch.from_numpy(perm).long().to(dev)
    for t in ("params", "m", "v"):
        after = tree_paths(gather_params(state[t], plan))
        for k, w in tree_paths(before[t]).items():
            if k in sharding.expert_paths(after):
                ix = idx.reshape(idx.shape + (1,) * (w.dim() - 2)).expand(w.shape)
                exact &= torch.equal(after[k], torch.gather(w, 1, ix))
            else:
                exact &= torch.equal(after[k], w)
    del before, state, mine
    every = [None] * world
    dist.all_gather_object(every, bool(exact))
    run.record("migrate", all(every), f"swap of slots {MEM_SWAP} in {reps} reps on the sliced "
               f"layout: params, m and v bitwise the manual permutation (the rest unchanged) "
               f"on every rank {every}; {got} B all-gathered a rank")

    # Serving on the sliced layout: tokens equal world 1's; the gathers'
    # seconds a decode step.
    clock = _GatherClock()
    with clock:
        tokens, secs = _timed(lambda: _mesh_serve(arch, plan, params, dev))
    if run.lead:
        ffn, leaf, fwd = clock.calls["ffn"], clock.calls["leaf"], clock.forwards
        run.record("serve", tokens == ref_tokens,
                   f"{len(tokens)} requests at {MEM_SPLIT_MESH}, tokens equal world 1's "
                   f"(first {tokens[0][:8]}); {secs:.2f} s; {fwd} forwards (prefills and decode "
                   f"steps): the d_ff gather {len(ffn)} calls, {1e3 * sum(ffn):.2f} ms; the "
                   f"other weights' {len(leaf)} calls, {1e3 * sum(leaf):.2f} ms (the largest, "
                   f"the table, {1e3 * max(leaf):.2f} ms); "
                   f"{1e3 * (sum(ffn) + sum(leaf)) / max(fwd, 1):.2f} ms of gathers a forward "
                   f"(gloo through the host; not gated)")
    return run.finish()


def memory_phase(dev):
    """Phase 16: the ragged kernels at (b)'s shapes, then (a) remat none /
    dots / full at full depth, (b) 2 x 4096, (c) bf16 moments, (d) the d_ff
    split on four gloo ranks.  Returns the phase's summed launch counts."""
    import torch.multiprocessing as mp

    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    mem_kernel_checks(dev)
    torch.cuda.empty_cache()
    for part in (_mem_remat, _mem_long, _mem_moments):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        part(dev, add)
        log(f"[memory] {part.__name__}: {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    world = MEM_SPLIT_MESH[0] * MEM_SPLIT_MESH[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_memory_")
    t1 = time.perf_counter()
    try:
        mp.start_processes(_memory_rank, args=(world, tmp), nprocs=world,
                           start_method=RANK_START)
        res = [json.loads(Path(tmp, f"mem{r}.json").read_text()) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errors = [f"rank {i}: {r['error']}\n{r['trace']}" for i, r in enumerate(res)
              if "error" in r]
    if errors:
        fail("memory (d): " + "\n".join(errors))
    for k, v in res[0].items():
        if k in ("plan", "peaks", "held", "zero/held", "zero/bytes", "zero/step gathers",
                 "step", "grads", "zero/grads", "ckpt", "migrate", "serve"):
            tag = "[check]" if v.endswith(("ok", "FAIL")) else "[memory]"
            log(f"{tag} memory (d) x{world} {k}: {v}")
    for r in res:
        log(f"[memory] (d) rank {r['rank']} designs "
            f"{check_designs(r['counts'], 'memory (d) rank ' + str(r['rank']))}")
        add(r["counts"])
    log(f"[memory] (d): {world} ranks, {time.perf_counter() - t1:.1f} s")
    if not all(r["ok"] for r in res):
        fail("memory (d): a check of the split runs failed")
    for name in PATH_KERNELS["memory"]:
        if counts.get(name, 0) == 0:
            fail(f"memory: no run launched {name}")
    log(f"[memory] phase {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 17: the dense and MoE archs that need no frontend
# ---------------------------------------------------------------------------

GEMMA, SMOLLM, GROK = "gemma2-9b", "smollm-360m", "grok-1-314b"
# (a) flash attention at gemma2's heads (b 1, 16 query heads over 8, head
# dim 256), its local layers' window and its attention softcap; the window
# masks only past 4096 tokens, hence 6144.
ARCHS_FA_SEQS = (512, 4096, 6144)
# (b) gemma2 bf16 serving: 4 requests of 4200-5120 prompt tokens (past the
# window), 8 new tokens each, blocks enough for all four at once.
GEMMA_SERVE_ARGS = ["--arch", GEMMA, "--requests", "4", "--prompt-min", "4200",
                    "--prompt-max", "5120", "--max-new", "8", "--max-seqs", "4",
                    "--block-size", "16", "--num-blocks", "1300", "--seed", "0"]
# (c) smollm-360m: the granite serving cell's requests, and the training
# phase's 5 steps at 2 x 512.
SMOLLM_SERVE_ARGS = ["--arch", SMOLLM] + SERVE_ARGS[2:]
SMOLLM_TRAIN_ARGS = ["--arch", SMOLLM, "--steps", "5", "--batch", "2", "--seq", "512",
                     "--seed", "0"]
# (d) grok-1-314b at full width and depth 1: a 1 x 512 prefill, 4 decode steps.
GROK_PREFILL, GROK_DECODE = 512, 4
PATH_KERNELS["archs"] = ("flash_attention", "grouped_matmul_f32", "ragged_gate_up_silu_f32",
                         "ragged_matmul_f32")


def archs_flash_checks(dev) -> list:
    """(a) ``flash_attention`` at head dim 256 against its plain version
    (bf16 ``/tc``, fp32 ``/fma``; window 4096 and none; softcap 50; q, k, v
    strided views of one fused projection) at each of ``ARCHS_FA_SEQS``,
    and the times at gemma2's local layer (window and softcap) beside the
    bound, the plain version and SDPA; returns one row per dtype and s."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    arch = get_arch(GEMMA)
    hq, hkv, d = arch.num_heads, arch.num_kv_heads, arch.head_dim
    W, cap = arch.sliding_window, arch.attn_logit_softcap
    _, randn, _ = seeded_inputs(dev, 1, 1, seed=26)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in ARCHS_FA_SEQS:
            qkv = randn(1, s, hq + 2 * hkv, d, dtype=dtype)
            q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
            design = fa_ops.design(dtype, d)
            errs = []
            for win in (W, None):
                want = fa_ref.attention(*(t.transpose(1, 2).float() for t in (q, k, v)),
                                        window=win, softcap=cap).transpose(1, 2).to(dtype)
                errs.append(check(f"archs flash_attention b=1 s={s} hq={hq} hkv={hkv} d={d} "
                                  f"window={win} softcap={cap:g} {dtype} via {design}",
                                  fa_ops.flash_attention(q, k, v, window=win,
                                                         logit_softcap=cap), want,
                                  FA_TOL[dtype]))
                del want
            qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            pos = torch.arange(s, device=dev)
            visible = torch.clamp(pos + 1, max=W)  # keys a row attends: causal, window
            mask = ((pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - W)
                    if s > W else None)
            ms = device_ms(fa_ops.flash_attention_launch(q, k, v, window=W,
                                                         logit_softcap=cap)[1])
            plain_ms = device_ms(lambda: fa_ref.attention(qc, kc, vc, window=W, softcap=cap),
                                 reps=5, warmup=1)
            try:
                lib_ms = device_ms(
                    (lambda: sdpa(qc, kc, vc, is_causal=True, enable_gqa=True)) if mask is None
                    else (lambda: sdpa(qc, kc, vc, attn_mask=mask, enable_gqa=True)))
            except (RuntimeError, TypeError, NotImplementedError) as e:
                log(f"[time] flash_attention s={s}: library call unavailable "
                    f"({type(e).__name__}: {e})")
                lib_ms = None
            sz = q.element_size()
            b_ms, b_by = bound_ms(2 * s * (hq + hkv) * d * sz,
                                  [(4 * hq * d * float(visible.sum()), dtype)])
            row = {"shape": f"b=1 s={s} hq={hq} hkv={hkv} d={d} window={W} softcap={cap:g} "
                            f"{str(dtype)[6:]}", "design": design, "max_abs_err": max(errs),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            log(f"[time] flash_attention {row['shape']} via flash_attention/{design}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} (SDPA "
                f"enable_gqa, {'causal' if mask is None else 'causal and window mask'}, no "
                f"softcap: it has none), bound {b_ms:.4f} ms ({b_by})")
            rows.append(row)
            del qkv, q, k, v, qc, kc, vc, mask
            torch.cuda.empty_cache()
    return rows


def _add_counts(total: dict, c: dict) -> None:
    for n, v in c.items():
        total[n] = total.get(n, 0) + v


def archs_gemma(dev, counts: dict) -> None:
    """(b) gemma2-9b at full width and depth: bf16 serving through
    ``launch.serve.serve`` (every request finished, exactly one
    ``flash_attention/tc`` launch an attention layer a prefill, none
    ``/fma``, none in decode), then fp32: request 0's sequence through the
    launcher's paged probe and through ``make_prefill_step`` /
    ``make_decode_step``, each step's logits against the uncached forward
    (``/fma`` at d = 256) within ``PARITY_BOUND`` x max(1, the logits'
    largest magnitude).  In both, each flash call's first at a shape and
    mask (the prefill bucket, local and global layers) is held against
    its plain version (``FA_TOL``)."""
    import dataclasses
    import gc

    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel
    from repro_torch.training import make_decode_step, make_prefill_step

    torch.cuda.reset_peak_memory_stats()
    args = serve.parse_args(GEMMA_SERVE_ARGS)
    kernels.reset_launch_counts()
    with _FirstCalls() as first:
        summ, case = serve.serve(args)
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    _add_counts(counts, c)
    arch = case.arch
    n_attn, prefills = arch.num_attn_layers, summ["requests"] + summ["preemptions"]
    log(f"[archs] {GEMMA} full width and depth ({arch.total_params() / 1e9:.3f} B params, "
        f"{n_attn} attention layers, head dim {arch.head_dim}), bf16, paged: "
        f"{summ['finished']}/{summ['requests']} requests finished, prompts "
        f"{summ['prefill_tokens']} tokens, prefill mean {summ['prefill_ms_mean']:.2f} ms, "
        f"decode step p50 {summ['decode_step_p50_ms']:.2f} ms, {summ['decode_tok_s']:.1f} "
        f"tokens/s, {summ['preemptions']} preemptions, peak torch.cuda.max_memory_allocated "
        f"{peak:.2f} GB")
    log(f"[archs] {GEMMA} designs {check_designs(c, GEMMA + ' serving')}")
    want = {"flash_attention": n_attn * prefills, "flash_attention/tc": n_attn * prefills,
            "flash_attention/fma": 0}
    got = {n: c[n] for n in want}
    others = {n: v for n, v in c.items() if v and not n.startswith("flash_attention")}
    ok = (summ["finished"] == summ["requests"] and summ["preemptions"] == 0 and got == want
          and not others)
    log(f"[check] archs {GEMMA} serving: launches {got}, want {n_attn} /tc a prefill x "
        f"{prefills} prefills and none in decode ({want}); other kernels {others} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{GEMMA} serving: requests, preemptions or flash launches are off")
    first_calls_against_plain(first.calls, c, f"{GEMMA} bf16 serving")
    del first

    # fp32 parity against the uncached forward.
    params = serve._weights(arch, dev, case.seed, "float32")
    lm = LanguageModel(arch)
    seq, plen = case.seq, case.plen
    toks = torch.from_numpy(seq.astype(np.int64)).to(dev)
    kernels.reset_launch_counts()
    with _FirstCalls() as first:
        with torch.no_grad():
            full, _, _ = lm.forward(params, {"tokens": toks[None]})
        torch.cuda.synchronize()
        fwd = kernels.launch_counts()
        layout = dataclasses.replace(case.layout, max_seqs=1,
                                     num_blocks=-(-len(seq) // case.layout.block_size) + 1)
        t0 = time.perf_counter()
        err_p, n_p = serve.parity_probe(lm, params, layout, seq, plen, ref=full)
        t_p = time.perf_counter() - t0
        # The dense cache decodes the prompt's last token too: 8 steps.
        prefill = make_prefill_step(lm, torch.float32)
        decode = make_decode_step(lm, torch.float32)
        t0 = time.perf_counter()
        lp = plen - 1
        logits, cache = prefill(params, {"tokens": toks[None, :lp]})
        cache = lm.pad_cache(cache, len(seq))
        errs = [float((logits[0] - full[0, lp - 1]).abs().max())]
        for i in range(len(seq) - lp):
            logits, cache = decode(params, cache, {"tokens": toks[None, lp + i:lp + i + 1]},
                                   lp + i)
            errs.append(float((logits[0] - full[0, lp + i]).abs().max()))
        torch.cuda.synchronize()
        t_d = time.perf_counter() - t0
    c = kernels.launch_counts()
    scale = max(1.0, float(full[..., :arch.vocab_size].abs().max()))
    bound = serve.PARITY_BOUND * scale
    ok = fwd["flash_attention/fma"] == fwd["flash_attention"] == n_attn
    log(f"[check] archs {GEMMA} fp32 uncached forward over {len(seq)} tokens: "
        f"flash_attention/fma {fwd['flash_attention/fma']} launches (want {n_attn}), logits "
        f"up to {scale:.4f} in magnitude {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{GEMMA} fp32 forward did not run flash_attention/fma once a layer")
    for what, err, n, t in (("paged (launch.serve.parity_probe)", err_p, n_p, t_p),
                            ("dense cache (make_prefill_step / make_decode_step)", max(errs),
                             len(errs), t_d)):
        ok = err <= bound
        log(f"[parity] {GEMMA} fp32 full width and depth, {what}: prefill {len(seq) - n + 1} "
            f"+ {n - 1} decode steps vs the uncached forward over {len(seq)}: max |dlogits| = "
            f"{err:.3e} (gate {serve.PARITY_BOUND:g} x max(1, {scale:.4f}) = {bound:.3e}) "
            f"{'ok' if ok else 'FAIL'} ({t:.1f} s)")
        if not ok:
            fail(f"{GEMMA} fp32 {what} disagrees with the uncached forward")
    del params, full, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    first_calls_against_plain(first.calls, c, f"{GEMMA} fp32 forward, paged and dense-cache "
                                              f"prefills")
    del first
    gc.collect()
    torch.cuda.empty_cache()


def archs_smollm(counts: dict) -> None:
    """(c) smollm-360m at full width and depth: ``launch.serve.main`` (the
    bf16 engine, then its fp32 parity probe at ``PARITY_BOUND``), then
    ``launch.train.train``, 5 steps at 2 x 512: none skipped, a finite loss,
    no kernel launched (training attention is eager).  Each flash call of
    ``serve.main``'s first at a shape (its 15 query heads over 5; bf16 and
    fp32) is held against its plain version (``FA_TOL``)."""
    import gc

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve, train

    arch = get_arch(SMOLLM)
    kernels.reset_launch_counts()
    with _FirstCalls() as first:
        summ = serve.main(SMOLLM_SERVE_ARGS)
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    _add_counts(counts, c)
    n_attn, prefills = arch.num_attn_layers, summ["requests"] + summ["preemptions"]
    # bf16 prefills take /tc; the fp32 probe's paged prefill and its
    # uncached forward take /fma, once a layer each.
    want = {"flash_attention/tc": n_attn * prefills, "flash_attention/fma": 2 * n_attn}
    got = {n: c[n] for n in want}
    ok = (summ["finished"] == summ["requests"] and got == want
          and summ["parity_dense"] <= serve.PARITY_BOUND)
    log(f"[archs] {SMOLLM} full width and depth ({arch.total_params() / 1e6:.1f} M params): "
        f"{summ['finished']}/{summ['requests']} requests finished, decode step p50 "
        f"{summ['decode_step_p50_ms']:.2f} ms, {summ['decode_tok_s']:.1f} tokens/s, prefill "
        f"mean {summ['prefill_ms_mean']:.2f} ms; fp32 parity {summ['parity_dense']:.3e} "
        f"(bound {serve.PARITY_BOUND:g})")
    log(f"[check] archs {SMOLLM} serve.main: flash launches {got}, want {want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{SMOLLM} serving: requests, parity or flash launches are off")
    gc.collect()
    torch.cuda.empty_cache()
    first_calls_against_plain(first.calls, c, f"{SMOLLM} serve.main")
    del first

    args = train.parse_args(SMOLLM_TRAIN_ARGS)
    kernels.reset_launch_counts()
    summ, _, out = train.train(args)
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    _add_counts(counts, c)
    launched = {n: v for n, v in c.items() if v}
    ok = (summ["steps"] == 5 and summ["skipped"] == 0 and np.isfinite(summ["loss"])
          and not launched)
    log(f"[archs] {SMOLLM} training: {summ['steps']} steps, {summ['skipped']} skipped, final "
        f"loss {summ['loss']:.4f}, step p50 {summ['step_p50_ms']:.1f} ms, "
        f"{summ['tokens_per_s']:.0f} tokens/s, peak torch.cuda.max_memory_allocated "
        f"{summ['peak_mem_gb']:.2f} GB")
    log(f"[check] archs {SMOLLM} training: 0 skipped, finite loss, kernel launches "
        f"{launched} (want none) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{SMOLLM} training: skipped steps, a non-finite loss or a kernel launch")
    del out
    gc.collect()
    torch.cuda.empty_cache()


def archs_grok(dev, counts: dict) -> None:
    """(d) grok-1-314b at full width, depth 1 (8 experts top-2, expert d_ff
    32768, d_model 6144: 9.7 GB of bf16 experts), under each dispatch: a
    1 x 512 prefill and 4 greedy decode steps through ``make_prefill_step``
    / ``make_decode_step``, each kernel's first call at each shape held
    against its plain version, every kernel of the dispatch's path
    launched, none through ``/fma``."""
    import dataclasses
    import gc

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params, tree_paths
    from repro_torch.training import make_decode_step, make_prefill_step

    base = get_arch(GROK).replace(num_layers=1)
    params = init_params(base, torch.Generator(device=dev).manual_seed(0), dev,
                         torch.bfloat16)
    weights = [t for t in tree_paths(params).values() if t.is_floating_point()]
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, base.vocab_size,
                                                              (1, GROK_PREFILL)))
    for mode in SERVE_MODES:
        arch = base.replace(moe=dataclasses.replace(base.moe, dispatch=mode))
        lm = LanguageModel(arch)
        prefill, decode = make_prefill_step(lm), make_decode_step(lm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _FirstCalls(keep=weights) as first:
            logits, cache = prefill(params, {"tokens": toks})
            cache = lm.pad_cache(cache, GROK_PREFILL + GROK_DECODE)
            finite = bool(torch.isfinite(logits[..., :arch.vocab_size]).all())
            for i in range(GROK_DECODE):
                logits, _ = decode(params, cache, {"tokens": logits.argmax(-1, keepdim=True)},
                                   GROK_PREFILL + i)
                finite &= bool(torch.isfinite(logits[..., :arch.vocab_size]).all())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = kernels.launch_counts()
        _add_counts(counts, c)
        log(f"[archs] {GROK} full width, depth 1 ({arch.total_params() / 1e9:.3f} B params), "
            f"{mode}, bf16: 1 x {GROK_PREFILL} prefill and {GROK_DECODE} decode steps in "
            f"{secs:.2f} s, peak torch.cuda.max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
            f"{dict((n, v) for n, v in c.items() if v and '/' not in n)}")
        log(f"[archs] {GROK} {mode} designs {check_designs(c, f'{GROK} {mode}')}")
        missing = [n for n in PATH_KERNELS[mode] if c[n] == 0]
        log(f"[check] archs {GROK} {mode}: logits finite, every kernel of the path launched "
            f"(missing {missing}) {'ok' if finite and not missing else 'FAIL'}")
        if not finite or missing:
            fail(f"{GROK} {mode}: non-finite logits or {missing} never launched")
        del cache, logits
        first_calls_against_plain(first.calls, c, f"{GROK} depth 1 {mode}")
        del first
        gc.collect()
        torch.cuda.empty_cache()
    del params, weights
    gc.collect()
    torch.cuda.empty_cache()


def archs_phase(dev):
    """The dense and MoE archs that need no frontend (phase 17): (a) the
    kernel at d = 256, (b) gemma2-9b, (c) smollm-360m, (d) grok-1-314b at
    depth 1.  Returns (the launch counts of (b)-(d)'s runs, (a)'s rows)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = archs_flash_checks(dev)
    done_at = [("a", time.perf_counter() - t0)]
    counts: dict = {}
    archs_gemma(dev, counts)
    done_at.append(("b", time.perf_counter() - t0))
    archs_smollm(counts)
    done_at.append(("c", time.perf_counter() - t0))
    archs_grok(dev, counts)
    done_at.append(("d", time.perf_counter() - t0))
    for name in PATH_KERNELS["archs"]:
        if counts.get(name, 0) == 0:
            fail(f"archs: no run launched {name}")
    log(f"[archs] launches {dict((n, v) for n, v in counts.items() if v)}; parts done at "
        + ", ".join(f"({p}) {t:.1f} s" for p, t in done_at))
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 18: the frontend archs and the paper's own configs
# ---------------------------------------------------------------------------

QWEN, MUSICGEN = "qwen2-vl-7b", "musicgen-large"
M10B, SUPER = "piper-m10b-e16", "piper-super-545b"
# (a) flash attention at qwen2-vl's heads (28 over 4, d 128: a GQA group
# of 7) and musicgen's (32 over 32, d 64), causal, no window or softcap.
FRONTEND_FA_SEQS = (512, 4096)
# (b) qwen2-vl bf16 serving: 4 requests of 1024-2048 prompt tokens, 8 new
# tokens each, blocks enough for all four at once.
QWEN_SERVE_ARGS = ["--arch", QWEN, "--requests", "4", "--prompt-min", "1024",
                   "--prompt-max", "2048", "--max-new", "8", "--max-seqs", "4",
                   "--block-size", "16", "--num-blocks", "600", "--seed", "0"]
# (c) musicgen: 4 requests of 64-512 prompt tokens, 8 new; one train step
# on 2 x 512 seeded embeds.
MUSICGEN_SERVE_ARGS = ["--arch", MUSICGEN, "--requests", "4", "--prompt-min", "64",
                       "--prompt-max", "512", "--max-new", "8", "--max-seqs", "4",
                       "--block-size", "16", "--num-blocks", "256", "--seed", "0"]
MUSICGEN_TRAIN = (2, 512)
# (d), (e) the paper's configs at full width, depth 1: a 1 x 512 prefill
# and 4 decode steps under each dispatch; M10B also a 1 x 512 forward and
# backward (ragged, bf16 compute).
PIPER_PREFILL, PIPER_DECODE = 512, 4
# A MoE layer's ragged launches in one train pass under remat "full" with
# the 2-matrix gelu expert FFN (``RaggedFFN``): the forward's up and down
# GEMMs, again in the recompute, then dh and dx; dW_down and dW_up.  No
# fused gate-up (SwiGLU's (2, 5, 3) is ``TRAIN_LAUNCHES``).
GELU_TRAIN_LAUNCHES = {"ragged_gate_up_silu_f32": 0, "ragged_matmul_f32": 6,
                       "ragged_dw_f32": 2}
PATH_KERNELS["frontend"] = ("flash_attention", "grouped_matmul_f32",
                            "ragged_gate_up_silu_f32", "ragged_matmul_f32", "ragged_dw_f32")


def moe_serve_launches(arch, passes: int) -> dict:
    """The expert kernels' launches of ``passes`` serving passes (a prefill
    or a decode step each) of ``arch``: a MoE layer a pass takes one
    grouped launch a matrix under capacity (three for SwiGLU, two for
    gelu); under ragged, SwiGLU's fused gate-up and its down projection,
    gelu's up and down projections."""
    n = arch.num_moe_layers * passes
    swiglu = arch.ffn_activation == "swiglu"
    if arch.moe.dispatch == "capacity":
        return {"grouped_matmul_f32": (3 if swiglu else 2) * n,
                "ragged_gate_up_silu_f32": 0, "ragged_matmul_f32": 0}
    return {"grouped_matmul_f32": 0, "ragged_gate_up_silu_f32": n if swiglu else 0,
            "ragged_matmul_f32": n if swiglu else 2 * n}


def frontend_flash_checks(dev) -> list:
    """(a) ``flash_attention`` at qwen2-vl's and musicgen's heads against its
    plain version (bf16 ``/tc``, fp32 ``/fma``; q, k, v strided views of one
    fused projection) at each of ``FRONTEND_FA_SEQS``, timed beside the
    bound, the plain version and SDPA; returns one row a case."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    _, randn, _ = seeded_inputs(dev, 1, 1, seed=27)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name in (QWEN, MUSICGEN):
        arch = get_arch(name)
        hq, hkv, d = arch.num_heads, arch.num_kv_heads, arch.head_dim
        for dtype in (torch.bfloat16, torch.float32):
            for s in FRONTEND_FA_SEQS:
                qkv = randn(1, s, hq + 2 * hkv, d, dtype=dtype)
                q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
                design = fa_ops.design(dtype, d)
                shape = f"{name} b=1 s={s} hq={hq} hkv={hkv} d={d}"
                want = fa_ref.attention(*(t.transpose(1, 2).float() for t in (q, k, v))
                                        ).transpose(1, 2).to(dtype)
                err = check(f"frontend flash_attention {shape} {dtype} via {design}",
                            fa_ops.flash_attention(q, k, v), want, FA_TOL[dtype])
                del want
                qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                rows.append(kernel_row(
                    "flash_attention", shape, dtype, fa_ops.flash_attention_launch(q, k, v)[1],
                    lambda: fa_ref.attention(qc, kc, vc),
                    lambda: sdpa(qc, kc, vc, is_causal=True, enable_gqa=True),
                    2 * s * (hq + hkv) * d * q.element_size(),
                    [(4 * hq * d * s * (s + 1) / 2, dtype)], err, fa_ops._FLASH[design].path,
                    "src/repro/kernels/flash_attention/flash_attention.py:103", design))
                del qkv, q, k, v, qc, kc, vc
                torch.cuda.empty_cache()
    return rows


def frontend_gemm_rows(dev) -> dict:
    """The expert GEMMs at the paper's widths, each against its plain
    version (``GEMM_TOL``) and timed beside the bound, the plain version
    and the library's one call: M10B-E16's gelu up and down projections
    (K 5120, N 20480; 16 experts top-2) over a 512-token prefill, grouped
    at its capacity and ragged, and the train pass's dh and both dW pairs;
    super-545b's (160 experts top-6, d_ff 3584: ~19 rows an expert) grouped
    gate/up and down, ragged fused gate-up and down.  Returns {kernel:
    rows}."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.moe_gemm import ops as mm_ops
    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.models.moe import _capacity

    grouped_mm = getattr(torch, "_grouped_mm", None)
    bf16, f32 = torch.bfloat16, torch.float32
    rows: dict = {}

    def add(row):
        rows.setdefault(row["name"], []).append(row)

    for name in (M10B, SUPER):
        arch = get_arch(name)
        d, f, E, k = arch.d_model, arch.moe.d_ff, arch.moe.num_experts, arch.moe.top_k
        _, randn, routed_offsets = seeded_inputs(dev, E, k, seed=28)
        C = _capacity(PIPER_PREFILL, arch.moe)
        # grouped (capacity): gate/up d -> f on bf16 rows, down f -> d on fp32 h
        for K_, N_, xdt, tag in ((d, f, bf16, "gate/up"), (f, d, f32, "down")):
            x, w = randn(E, C, K_, dtype=xdt), randn(E, K_, N_, scale=K_ ** -0.5, dtype=bf16)
            design = mm_ops.grouped_design(x.dtype, w.dtype, C)
            shape = f"{name} prefill {tag} ({E},{C},{K_})x({K_},{N_})"
            err = check(f"frontend grouped_matmul_f32 {shape} via {design}",
                        mm_ops.grouped_matmul_f32(x, w), mm_ref.grouped_matmul_f32(x, w),
                        GEMM_TOL)
            add(kernel_row("grouped_matmul_f32", shape, rate_dtype(x, w),
                           mm_ops.grouped_matmul_f32_launch(x, w)[1],
                           lambda: mm_ref.grouped_matmul_f32(x, w),
                           (lambda: torch.bmm(x, w)) if x.dtype == w.dtype else None,
                           x.numel() * x.element_size() + w.numel() * 2 + E * C * N_ * 4,
                           gemm_ops(2 * E * C * K_ * N_, x.dtype, w.dtype), err,
                           mm_ops._GROUPED[design].path,
                           "src/repro/kernels/moe_gemm/moe_gemm.py:67", design))
            del x, w
        # ragged: T*k rows of a 512-token prefill
        offs = routed_offsets(PIPER_PREFILL)
        T = int(offs[-1])
        touched = int((offs[1:] > offs[:-1]).sum())
        cases = [(d, f, bf16, "up" if arch.ffn_activation == "gelu" else "gate/up"),
                 (f, d, f32, "down")]
        if arch.ffn_activation == "gelu":
            cases.append((d, f, f32, "train dh"))
        for K_, N_, xdt, tag in cases:
            x, w = randn(T, K_, dtype=xdt), randn(E, K_, N_, scale=K_ ** -0.5, dtype=bf16)
            design = mm_ops.ragged_design(x.dtype, w.dtype, T / E)
            shape = f"{name} {tag} T={T} ({T},{K_})x({E},{K_},{N_})"
            if tag == "gate/up":
                wu = randn(E, K_, N_, scale=K_ ** -0.5, dtype=bf16)
                errs = [check(f"frontend ragged_gate_up_silu_f32 {shape} {n} via {design}",
                              a, b, GEMM_TOL)
                        for n, a, b in zip(("h", "a_g", "a_u"),
                                           mm_ops.ragged_gate_up_silu_f32(x, w, wu, offs),
                                           mm_ref.ragged_gate_up_silu_f32(x, w, wu, offs))]
                add(kernel_row("ragged_gate_up_silu_f32", shape, rate_dtype(x, w),
                               mm_ops.ragged_gate_up_silu_f32_launch(x, w, wu, offs)[1],
                               lambda: mm_ref.ragged_gate_up_silu_f32(x, w, wu, offs), None,
                               T * K_ * 2 + 2 * touched * K_ * N_ * 2 + 3 * T * N_ * 4,
                               gemm_ops(4 * T * K_ * N_, x.dtype, w.dtype), max(errs),
                               mm_ops._GATE_UP[design].path,
                               "src/repro/kernels/moe_gemm/moe_gemm.py:253", design))
                if grouped_mm:
                    ms = device_ms(lambda: torch.nn.functional.silu(
                        grouped_mm(x, w, offs=offs[1:])) * grouped_mm(x, wu, offs=offs[1:]))
                    log(f"[time] ragged_gate_up_silu_f32 {shape}: two torch._grouped_mm + "
                        f"SiLU {ms:.4f} ms (informative: three calls, bf16 out)")
                del wu
            else:
                err = check(f"frontend ragged_matmul_f32 {shape} {xdt} via {design}",
                            mm_ops.ragged_matmul_f32(x, w, offs),
                            mm_ref.ragged_matmul_f32(x, w, offs), GEMM_TOL)
                add(kernel_row("ragged_matmul_f32", shape, rate_dtype(x, w),
                               mm_ops.ragged_matmul_f32_launch(x, w, offs)[1],
                               lambda: mm_ref.ragged_matmul_f32(x, w, offs),
                               (lambda: grouped_mm(x, w, offs=offs[1:]))
                               if grouped_mm and x.dtype == w.dtype else None,
                               T * K_ * x.element_size() + touched * K_ * N_ * 2 + T * N_ * 4,
                               gemm_ops(2 * T * K_ * N_, x.dtype, w.dtype), err,
                               mm_ops._RAGGED[design].path,
                               "src/repro/kernels/moe_gemm/moe_gemm.py:178", design))
            del x, w
            torch.cuda.empty_cache()
        if arch.ffn_activation != "gelu":
            continue
        # the train pass's weight gradients: (bf16 x, fp32 da) for dW_up,
        # (fp32 h, fp32 dy) for dW_down
        for xdt, K_, N_, tag in ((bf16, d, f, "dW_up"), (f32, f, d, "dW_down")):
            x, gr = randn(T, K_, dtype=xdt), randn(T, N_, scale=1e-2)
            shape = f"{name} {tag} T={T} ({T},{K_})x({T},{N_})"
            got = mm_ops.ragged_dw_f32(x, gr, offs)
            err = check(f"frontend ragged_dw_f32 {shape} {xdt}xfp32 via tc", got,
                        mm_ref.ragged_dw_f32(x, gr, offs), GEMM_TOL)
            del got
            torch.cuda.empty_cache()
            xb, gb = x.to(bf16), gr.to(bf16)
            add(kernel_row("ragged_dw_f32", shape + " fp32 g", xdt,
                           mm_ops.ragged_dw_f32_launch(x, gr, offs)[1],
                           lambda: mm_ref.ragged_dw_f32(x, gr, offs),
                           (lambda: grouped_mm(xb.t(), gb, offs=offs[1:])) if grouped_mm
                           else None,
                           T * K_ * x.element_size() + T * N_ * 4 + E * K_ * N_ * 4,
                           gemm_ops(2 * T * K_ * N_, x.dtype, gr.dtype), err, mm_ops._DW.path,
                           "src/repro/kernels/moe_gemm/moe_gemm.py:335", "tc"))
            del x, gr, xb, gb
            torch.cuda.empty_cache()
    return rows


def frontend_qwen(dev, counts: dict) -> None:
    """(b) qwen2-vl-7b at full width and depth: bf16 serving through
    ``launch.serve.serve`` (all finished, no preemption, exactly one
    ``flash_attention/tc`` launch an attention layer a prefill, none in
    decode, no ``/fma``); then fp32, request 0's sequence through the
    launcher's paged probe and through ``make_prefill_step`` /
    ``make_decode_step`` against the uncached forward within
    ``PARITY_BOUND`` x max(1, the logits' largest magnitude); the forward
    on ``embeds`` set to the table's rows of the same tokens, bitwise the
    token forward; seeded random ``embeds``: a prefill, then 8 decode
    steps fed ``{"embeds": (1, 1, d)}`` alone, against the uncached
    forward over the same embeds, within the same bound.  Each flash
    call's first at a shape is held against its plain version."""
    import dataclasses
    import gc

    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models.layers import mrope_sections
    from repro_torch.models.model import LanguageModel
    from repro_torch.training import make_decode_step, make_prefill_step

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _FirstCalls() as first:
        summ, case = serve.serve(serve.parse_args(QWEN_SERVE_ARGS))
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    _add_counts(counts, c)
    arch = case.arch
    n_attn, prefills = arch.num_attn_layers, summ["requests"] + summ["preemptions"]
    log(f"[frontend] {QWEN} full width and depth ({arch.total_params() / 1e9:.3f} B params, "
        f"{n_attn} attention layers, {arch.num_heads} query heads over {arch.num_kv_heads}, "
        f"M-RoPE sections {mrope_sections(arch.head_dim)}), bf16, paged: "
        f"{summ['finished']}/{summ['requests']} requests finished, prompts "
        f"{summ['prefill_tokens']} tokens, prefill mean {summ['prefill_ms_mean']:.2f} ms, "
        f"decode step p50 {summ['decode_step_p50_ms']:.2f} ms, {summ['decode_tok_s']:.1f} "
        f"tokens/s, {summ['preemptions']} preemptions, peak torch.cuda.max_memory_allocated "
        f"{peak:.2f} GB")
    log(f"[frontend] {QWEN} designs {check_designs(c, QWEN + ' serving')}")
    want = {"flash_attention": n_attn * prefills, "flash_attention/tc": n_attn * prefills,
            "flash_attention/fma": 0}
    got = {n: c[n] for n in want}
    others = {n: v for n, v in c.items() if v and not n.startswith("flash_attention")}
    ok = (summ["finished"] == summ["requests"] and summ["preemptions"] == 0 and got == want
          and not others)
    log(f"[check] frontend {QWEN} serving: launches {got}, want {n_attn} /tc a prefill x "
        f"{prefills} prefills and none in decode ({want}); other kernels {others} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{QWEN} serving: requests, preemptions or flash launches are off")
    first_calls_against_plain(first.calls, c, f"{QWEN} bf16 serving")
    del first

    params = serve._weights(arch, dev, case.seed, "float32")
    lm = LanguageModel(arch)
    seq, plen = case.seq, case.plen
    toks = torch.from_numpy(seq.astype(np.int64)).to(dev)
    prefill = make_prefill_step(lm, torch.float32)
    decode = make_decode_step(lm, torch.float32)
    lp = plen - 1  # the dense cache decodes the prompt's last token too: 8 steps
    g = torch.Generator(device=dev).manual_seed(27)
    emb = torch.randn((1, len(seq), arch.d_model), generator=g, device=dev) * float(
        params["embed"].std())

    def dense(batch_of, ref):
        """Prefill ``lp`` positions, then a decode step a position, each
        step's logits against ``ref``'s; returns (max |dlogits|, steps)."""
        logits, cache = prefill(params, batch_of(slice(0, lp)))
        cache = lm.pad_cache(cache, len(seq))
        errs = [float((logits[0] - ref[0, lp - 1]).abs().max())]
        for i in range(len(seq) - lp):
            logits, cache = decode(params, cache, batch_of(slice(lp + i, lp + i + 1)), lp + i)
            errs.append(float((logits[0] - ref[0, lp + i]).abs().max()))
        return max(errs), len(errs)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _FirstCalls() as first:
        with torch.no_grad():
            full, _, _ = lm.forward(params, {"tokens": toks[None]})
            rows, _, _ = lm.forward(params, {"embeds": params["embed"][toks[None]]})
            bitwise = torch.equal(rows, full)
            del rows
            ref_e, _, _ = lm.forward(params, {"embeds": emb})
        layout = dataclasses.replace(case.layout, max_seqs=1,
                                     num_blocks=-(-len(seq) // case.layout.block_size) + 1)
        err_p, n_p = serve.parity_probe(lm, params, layout, seq, plen, ref=full)
        err_d, n_d = dense(lambda sl: {"tokens": toks[None, sl]}, full)
        err_e, n_e = dense(lambda sl: {"embeds": emb[:, sl]}, ref_e)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = kernels.launch_counts()
    _add_counts(counts, c)
    scale = max(1.0, float(full[..., :arch.vocab_size].abs().max()),
                float(ref_e[..., :arch.vocab_size].abs().max()))
    bound = serve.PARITY_BOUND * scale
    # three uncached forwards and three prefills (paged, dense on tokens,
    # dense on embeds), one /fma launch an attention layer each
    want = {"flash_attention/fma": 6 * n_attn, "flash_attention/tc": 0}
    got = {n: c[n] for n in want}
    log(f"[check] frontend {QWEN} fp32 ({secs:.1f} s in all): forward on embeds = the table's "
        f"rows of the tokens bitwise the token forward ({bitwise}); flash launches {got}, "
        f"want {want} {'ok' if bitwise and got == want else 'FAIL'}")
    if not bitwise or got != want:
        fail(f"{QWEN} fp32: the embeds forward is not the token forward, or flash launches "
             f"are off")
    for what, err, n in (("paged (launch.serve.parity_probe)", err_p, n_p),
                         ("dense cache (make_prefill_step / make_decode_step)", err_d, n_d),
                         ("dense cache on seeded random embeds, decode fed embeds only",
                          err_e, n_e)):
        ok = err <= bound
        log(f"[parity] {QWEN} fp32 full width and depth, {what}: prefill {len(seq) - n + 1} "
            f"+ {n - 1} decode steps vs the uncached forward over {len(seq)}: max |dlogits| = "
            f"{err:.3e} (gate {serve.PARITY_BOUND:g} x max(1, {scale:.4f}) = {bound:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{QWEN} fp32 {what} disagrees with the uncached forward")
    del params, full, ref_e, emb
    gc.collect()
    torch.cuda.empty_cache()
    first_calls_against_plain(first.calls, c, f"{QWEN} fp32 forwards and prefills")
    del first
    gc.collect()
    torch.cuda.empty_cache()


def frontend_musicgen(dev, counts: dict) -> None:
    """(c) musicgen-large at full width and depth: ``launch.serve.serve``
    in bf16, then request 0's sequence in fp32 through the launcher's paged
    ``parity_probe`` against the uncached forward within ``PARITY_BOUND``
    x max(1, the logits' largest magnitude), as gemma2-9b is held
    (``serve.main``'s absolute 1e-5 fails at this depth: 1.144e-05 on an
    H100, fp32 rounding: the uncached fp32 forward itself lies 1.102e-05
    from a float64 one, where paged and uncached agree to 1.8e-14,
    ``scripts/port_parity_witness.py``, PERF.md §6); each flash call's
    first at a shape held against its plain version.  Then one ``make_train_step`` step on 2 x
    512 seeded ``embeds`` and labels in bf16 compute: finite loss and grad
    norm, nothing skipped, the untied ``embed`` table's first and second
    moments exactly 0 (its gradient 0: no lookup), no kernel launched."""
    import dataclasses
    import gc

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import init_state, make_train_step

    arch = get_arch(MUSICGEN)
    kernels.reset_launch_counts()
    with _FirstCalls() as first:
        summ, case = serve.serve(serve.parse_args(MUSICGEN_SERVE_ARGS))
        params = serve._weights(arch, dev, case.seed, "float32")
        lm = LanguageModel(arch)
        toks = torch.from_numpy(case.seq.astype(np.int64)).to(dev)
        with torch.no_grad():
            full, _, _ = lm.forward(params, {"tokens": toks[None]})
        layout = dataclasses.replace(case.layout, max_seqs=1,
                                     num_blocks=-(-len(case.seq) // case.layout.block_size) + 1)
        err, n = serve.parity_probe(lm, params, layout, case.seq, case.plen, ref=full)
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    _add_counts(counts, c)
    scale = max(1.0, float(full[..., :arch.vocab_size].abs().max()))
    bound = serve.PARITY_BOUND * scale
    del params, full
    n_attn, prefills = arch.num_attn_layers, summ["requests"] + summ["preemptions"]
    # bf16 prefills take /tc; the fp32 forward and the probe's prefill /fma
    want = {"flash_attention/tc": n_attn * prefills, "flash_attention/fma": 2 * n_attn}
    got = {n: c[n] for n in want}
    ok = (summ["finished"] == summ["requests"] and summ["preemptions"] == 0 and got == want
          and err <= bound)
    log(f"[frontend] {MUSICGEN} full width and depth ({arch.total_params() / 1e9:.3f} B "
        f"params, {arch.num_heads} heads of {arch.head_dim}, no positional embedding), bf16, "
        f"paged: {summ['finished']}/{summ['requests']} requests finished, decode step p50 "
        f"{summ['decode_step_p50_ms']:.2f} ms, {summ['decode_tok_s']:.1f} tokens/s, prefill "
        f"mean {summ['prefill_ms_mean']:.2f} ms")
    log(f"[parity] {MUSICGEN} fp32 full width and depth, paged (launch.serve.parity_probe): "
        f"prefill {case.plen} + {n - 1} decode steps vs the uncached forward over "
        f"{len(case.seq)}: max |dlogits| = {err:.3e} (gate {serve.PARITY_BOUND:g} x max(1, "
        f"{scale:.4f}) = {bound:.3e})")
    log(f"[check] frontend {MUSICGEN} serving: all finished, no preemption, fp32 parity, "
        f"flash launches {got}, want {want} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{MUSICGEN} serving: requests, parity or flash launches are off")
    gc.collect()
    torch.cuda.empty_cache()
    first_calls_against_plain(first.calls, c, f"{MUSICGEN} bf16 serving and fp32 probe")
    del first
    gc.collect()
    torch.cuda.empty_cache()

    lm = LanguageModel(arch)
    b, s = MUSICGEN_TRAIN
    torch.cuda.reset_peak_memory_stats()
    state = init_state(lm, torch.Generator(device=dev).manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(28)
    batch = {"embeds": torch.randn((b, s, arch.d_model), generator=g, device=dev) * float(
                 state["params"]["embed"].std()),
             "labels": torch.randint(0, arch.vocab_size, (b, s), generator=g, device=dev)}
    step = make_train_step(lm, OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=2))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = kernels.launch_counts()
    _add_counts(counts, c)
    launched = {n: v for n, v in c.items() if v}
    zero = not state["m"]["embed"].any() and not state["v"]["embed"].any()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    modeled = _mem_modeled_gb(arch, b, s, "full")
    ok = (np.isfinite(loss) and np.isfinite(gnorm) and m["skipped"] == 0 and zero
          and not launched)
    log(f"[frontend] {MUSICGEN} train step on {b} x {s} seeded embeds, bf16 compute: loss "
        f"{loss:.4f}, grad norm {gnorm:.4f}, {m['skipped']} skipped, {secs:.2f} s (the "
        f"first step), peak torch.cuda.max_memory_allocated {peak:.2f} GB beside the resource "
        f"model's mem_stage0 {modeled:.2f} GB")
    log(f"[check] frontend {MUSICGEN} training: finite loss and grad norm, 0 skipped, the "
        f"embed table's moments exactly 0 ({zero}), kernel launches {launched} (want none) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{MUSICGEN} training on embeds: a non-finite loss, a skip, an embedding "
             f"gradient or a kernel launch")
    del state, batch, m
    gc.collect()
    torch.cuda.empty_cache()


def frontend_piper(dev, counts: dict, name: str, train: bool) -> None:
    """(d), (e) ``name`` at full width, depth 1: under each dispatch a 1 x
    512 prefill and 4 greedy decode steps through ``make_prefill_step`` /
    ``make_decode_step`` (finite logits, the expert kernels' launches
    exactly ``moe_serve_launches``', flash once a prefill, no ``/fma``);
    with ``train`` one forward and backward on 1 x 512 (ragged, fp32
    masters, bf16 compute, no optimizer step: finite loss and gradients,
    launches exactly ``GELU_TRAIN_LAUNCHES``).  Each kernel's first call at
    each shape is held against its plain version."""
    import dataclasses
    import gc

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params, tree_paths
    from repro_torch.training import loss_and_grads, make_decode_step, make_prefill_step

    base = get_arch(name).replace(num_layers=1)
    params = init_params(base, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    weights = [t for t in tree_paths(params).values() if t.is_floating_point()]
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, base.vocab_size,
                                                              (1, PIPER_PREFILL + 1)))
    moe = base.moe
    desc = (f"{name} full width, depth 1 ({base.total_params() / 1e9:.3f} B params; "
            f"{moe.num_experts} experts top-{moe.top_k}, expert d_ff {moe.d_ff}, "
            f"{base.ffn_activation})")
    for mode in SERVE_MODES:
        arch = base.replace(moe=dataclasses.replace(moe, dispatch=mode))
        lm = LanguageModel(arch)
        prefill, decode = make_prefill_step(lm), make_decode_step(lm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _FirstCalls(keep=weights) as first:
            logits, cache = prefill(params, {"tokens": toks[:, :PIPER_PREFILL]})
            cache = lm.pad_cache(cache, PIPER_PREFILL + PIPER_DECODE)
            finite = bool(torch.isfinite(logits[..., :arch.vocab_size]).all())
            for i in range(PIPER_DECODE):
                logits, _ = decode(params, cache, {"tokens": logits.argmax(-1, keepdim=True)},
                                   PIPER_PREFILL + i)
                finite &= bool(torch.isfinite(logits[..., :arch.vocab_size]).all())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = kernels.launch_counts()
        _add_counts(counts, c)
        want = {**moe_serve_launches(arch, 1 + PIPER_DECODE),
                "flash_attention": arch.num_attn_layers, "ragged_dw_f32": 0}
        got = {n: c[n] for n in want}
        log(f"[frontend] {desc}, {mode}, bf16: 1 x {PIPER_PREFILL} prefill and "
            f"{PIPER_DECODE} decode steps in {secs:.2f} s, peak "
            f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"[frontend] {name} {mode} designs {check_designs(c, f'{name} {mode}')}")
        ok = finite and got == want
        log(f"[check] frontend {name} {mode} serving: logits finite, launches {got}, want "
            f"{want} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {mode}: non-finite logits or launches off the derived counts")
        del cache, logits
        first_calls_against_plain(first.calls, c, f"{name} depth 1 {mode} serving")
        del first
        gc.collect()
        torch.cuda.empty_cache()
    del params, weights
    gc.collect()
    torch.cuda.empty_cache()
    if not train:
        return
    arch = base.replace(moe=dataclasses.replace(moe, dispatch="ragged"))
    lm = LanguageModel(arch)
    params = init_params(arch, torch.Generator(device=dev).manual_seed(0), dev, torch.float32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _FirstCalls() as first:
        loss, _, grads = loss_and_grads(lm, params, batch, torch.bfloat16)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in tree_paths(grads).values() if g is not None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    c = kernels.launch_counts()
    _add_counts(counts, c)
    want = {n: v * arch.num_moe_layers for n, v in GELU_TRAIN_LAUNCHES.items()}
    got = {n: c[n] for n in want}
    log(f"[frontend] {desc}, ragged, fp32 masters, bf16 compute: a 1 x {PIPER_PREFILL} "
        f"forward and backward (remat full) in {secs:.2f} s, loss {float(loss):.4f}, peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GB")
    log(f"[frontend] {name} train designs {check_designs(c, f'{name} train')}")
    ok = finite and got == want and c["flash_attention"] == 0
    log(f"[check] frontend {name} train pass: loss and every gradient finite, launches {got}, "
        f"want {want} (gelu: no fused gate-up; forward, recompute, dh and dx ragged; dW_down "
        f"and dW_up) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} train pass: non-finite values or launches off the derived counts")
    del params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    first_calls_against_plain(first.calls, c, f"{name} depth 1 train pass")
    del first
    gc.collect()
    torch.cuda.empty_cache()


def frontend_phase(dev):
    """The frontend archs and the paper's configs (phase 18): (a) flash
    attention at qwen2-vl's and musicgen's heads, then the expert GEMMs at
    M10B's and super-545b's widths; (b) qwen2-vl-7b; (c) musicgen-large;
    (d) piper-m10b-e16 at depth 1; (e) piper-super-545b at depth 1.
    Returns (the launch counts of (b)-(e)'s runs, (a)'s rows by kernel)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = frontend_gemm_rows(dev)
    rows["flash_attention"] = frontend_flash_checks(dev)
    done_at = [("a", time.perf_counter() - t0)]
    counts: dict = {}
    frontend_qwen(dev, counts)
    done_at.append(("b", time.perf_counter() - t0))
    frontend_musicgen(dev, counts)
    done_at.append(("c", time.perf_counter() - t0))
    frontend_piper(dev, counts, M10B, train=True)
    done_at.append(("d", time.perf_counter() - t0))
    frontend_piper(dev, counts, SUPER, train=False)
    done_at.append(("e", time.perf_counter() - t0))
    for name in PATH_KERNELS["frontend"]:
        if counts.get(name, 0) == 0:
            fail(f"frontend: no run launched {name}")
    log(f"[frontend] launches {dict((n, v) for n, v in counts.items() if v)}; parts done at "
        + ", ".join(f"({p}) {t:.1f} s" for p, t in done_at))
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 19: the dry run (launch.dryrun), traced on the host
# ---------------------------------------------------------------------------

# (b)'s cell: the reference's recorded granite cell at the 256-rank grid.
DRYRUN_CELL = ("granite-moe-3b-a800m", "train_4k")
DRYRUN_FIELDS = ("chips", "ep", "tp", "pp", "memory", "cost", "collectives", "kernels",
                 "dispatch_model", "a2a_model", "schedule_model", "robustness_model",
                 "model_mem_stage0_bytes", "routing", "path")


def _dryrun_cell(rank: int, tmp: str) -> None:
    """(b) in its own process (``torch.multiprocessing`` target, beside (a)):
    the cell's record to ``tmp/cell.json``, or the failure there."""
    import traceback

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.launch import dryrun

        rec = dryrun.run_cell(*DRYRUN_CELL, False, save=False)
    except Exception as e:  # reported to the parent, which fails the phase
        rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
    Path(tmp, "cell.json").write_text(json.dumps(rec))


def dryrun_start():
    """Start (b) of phase "dryrun" in its own process, so that its trace
    (CPU-bound) runs beside (a)'s.  It starts after every phase that times
    something, so that no figure of the script is taken beside it."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    ctx = mp.start_processes(_dryrun_cell, args=(tmp,), nprocs=1, start_method=RANK_START,
                             join=False, daemon=True)  # ends with the script if it fails
    return ctx, tmp, time.perf_counter()


def dryrun_phase(train_summary) -> None:
    """The dry run on this machine's CPU, beside what phase "training"
    measured on the card: (a) granite's 2 x 512 full-depth train step of
    phase "training" (ragged, remat full, fp32 AdamW) traced at world 1 on
    fake tensors, its peak beside the measured
    ``torch.cuda.max_memory_allocated`` and its FLOPs beside 6 N_active
    tokens; (b) the granite train_4k cell on a fake process group of 256
    ranks (``launch.dryrun.run_cell``, in the process :func:`dryrun_start`
    starts; a rank holds 16 rows x 256 positions, and its collectives count
    the sequence gathers), a rank's peak beside the resource model's
    mem_stage0 for the same plan.  Fails only if a trace errors or a record lacks a field."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    ctx, tmp, t_start = dryrun_start()
    args = dict(zip(TRAIN_ARGS[::2], TRAIN_ARGS[1::2]))
    b, s = int(args["--batch"]), int(args["--seq"])
    base = get_arch(args["--arch"])
    arch = base.replace(moe=dataclasses.replace(base.moe, dispatch=args["--dispatch"]))
    t0 = time.perf_counter()
    try:
        try:
            a = dryrun.trace_step(arch, "train", None, b, s)
        except Exception as e:  # noqa: BLE001
            fail(f"dryrun (a): the trace failed: {type(e).__name__}: {e}")
        t_a = time.perf_counter() - t0
        while not ctx.join():
            pass
        rec = json.loads(Path(tmp, "cell.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_b = time.perf_counter() - t_start
    measured = train_summary["peak_mem_gb"]
    traced = a["memory"]["peak_bytes"] / 1e9
    mf = 6.0 * arch.active_params() * b * s
    log(f"[dryrun] (a) {arch.name} full width and depth, {b} x {s}, ragged, remat full, world "
        f"1, fake tensors (plain path, balanced routing): traced peak {traced:.2f} GB vs phase "
        f"training's measured torch.cuda.max_memory_allocated {measured:.2f} GB (ratio "
        f"{traced / measured:.3f}); traced FLOPs {a['cost']['flops']:.4e} vs 6 N_active "
        f"tokens {mf:.4e} (ratio {a['cost']['flops'] / mf:.3f}); state "
        f"{a['memory']['state_bytes'] / 1e9:.2f} GB; kernels as ops {a['kernels']}; "
        f"traced in {t_a:.1f} s")
    if rec.get("status") != "ok":
        fail(f"dryrun (b): {rec.get('error')}\n{rec.get('traceback', '')}")
    missing = [k for k in DRYRUN_FIELDS if k not in rec]
    missing += [f"memory/{k}" for k in ("param_bytes", "grad_bytes", "optimizer_bytes",
                                       "state_bytes", "peak_bytes", "fits")
                if k not in rec["memory"]]
    missing += [f"cost/{k}" for k in ("flops", "bytes_accessed", "bytes_large")
                if k not in rec["cost"]]
    if missing:
        fail(f"dryrun (b): the record lacks {missing}")
    mem, col = rec["memory"], rec["collectives"]
    from repro_torch.configs import SHAPES

    shape = SHAPES[DRYRUN_CELL[1]]
    rows, positions = (shape.global_batch // rec["dp"],
                       shape.seq_len // (rec["ep"] * rec["tp"]))
    log(f"[dryrun] (b) {rec['cell']} on a fake process group of {rec['chips']} ranks (ep "
        f"{rec['ep']}, tp {rec['tp']}, pp {rec['pp']}, {rec['optimizer_dtype']} moments, remat "
        f"{rec['remat']}; a rank's block {rows} rows x {positions} positions of the "
        f"{shape.global_batch} x {shape.seq_len} batch): a rank's traced peak "
        f"{mem['peak_bytes'] / 1e9:.2f} GB vs the "
        f"resource model's mem_stage0 {rec['model_mem_stage0_bytes'] / 1e9:.2f} GB (modeled "
        f"for h100-sxm; ratio {mem['peak_bytes'] / rec['model_mem_stage0_bytes']:.3f}); state "
        f"{mem['state_bytes'] / 1e9:.3f} GB; FLOPs {rec['cost']['flops']:.4e}, bytes_large "
        f"{rec['cost']['bytes_large']:.4e}; collectives {col['counts']}, wire bytes "
        f"{ {k: f'{v:.4e}' for k, v in col['wire_bytes'].items()} }; traced in "
        f"{rec['trace_seconds']:.1f} s, done {t_b:.1f} s after its start, beside (a)")
    log(f"[check] dryrun (a) and (b): both traces ran, the record has its "
        f"{len(DRYRUN_FIELDS)} fields ok")


def main(names=()) -> None:
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        fail(f"unknown phases {unknown}; the phases are {', '.join(PHASES)}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(src))
    # Bytecode written under the checkout's build/: where the interpreter
    # is told not to write any (PYTHONDONTWRITEBYTECODE) and none is cached
    # beside the installed packages, every rank this script spawns compiles
    # torch's modules from source again, torch._dynamo among them
    # (torch.utils.checkpoint reads it at its first call): 34 s against
    # 25 s for two ranks' first three steps on an H100
    # (scripts/port_first_step_profile.py).
    os.environ["PYTHONDONTWRITEBYTECODE"] = ""
    os.environ["PYTHONPYCACHEPREFIX"] = str(src.parent / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    import multiprocessing
    from multiprocessing import forkserver

    multiprocessing.set_forkserver_preload(RANK_PRELOAD)
    forkserver.ensure_running()  # its imports overlap the kernels' build
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    want = set(names) | {NEEDS[n] for n in names if n in NEEDS}
    run = (lambda name: name in want) if names else (lambda name: True)
    counts, seconds, out = {}, {}, {}

    def phase(name, fn, *args):
        if not run(name):
            return None
        t = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"[phase] {name.replace('_', ' ')} done at {time.perf_counter() - t0:.1f}s")
        return out[name]

    if not run("kernels"):
        from repro_torch import kernels

        kernels.build()
    entries = phase("kernels", kernel_phase, dev)
    phase("model", model_phase, dev)
    phase("small_parity", small_parity_phase, dev)
    if phase("serving", serving_phase) is not None:
        counts.update(out["serving"][0])
    phase("parity", lambda: parity_phase(out["serving"][1]))
    phase("profile", profile_phase, dev)
    counts["dense_cache"] = phase("dense_cache", dense_cache_phase, dev)
    if phase("ssm_serving", ssm_serving_phase, dev) is not None:
        counts["ssm"] = out["ssm_serving"][0]
    phase("ssm_parity", ssm_parity_phase, dev)
    phase("ssm_profile", lambda: ssm_profile_phase(out.pop("ssm_serving")[1]))
    out.pop("ssm_serving", None)
    counts["ssm_train"] = phase("ssm_train", ssm_train_phase, dev)
    if phase("training", training_phase) is not None:
        counts["train"] = out["training"][0]
    counts["checkpoint"] = phase("checkpoint", checkpoint_phase, dev)
    counts["ep"] = phase("ep", lambda: (ep_world1_phase(out["training"][1]), ep_phase(dev))[1])
    counts["migrate"] = phase("migrate", migrate_phase, dev)
    counts["pipeline"] = phase("pipeline", pipeline_phase, dev)
    if phase("mesh", mesh_phase, dev) is not None:
        counts["mesh"], q_offset_rows, ssd_slice_rows = out["mesh"]
    counts["memory"] = phase("memory", memory_phase, dev)
    if phase("archs", archs_phase, dev) is not None:
        counts["archs"], fa256 = out["archs"]
    if phase("frontend", frontend_phase, dev) is not None:
        counts["frontend"], frontend_rows = out["frontend"]
    phase("dryrun", lambda: dryrun_phase(out["training"][1]))
    # The fork server exits when it reads this process's end; wait for that
    # here so that none outlives the script (``_stop``: the module has no
    # public call for it).
    getattr(forkserver._forkserver, "_stop", lambda: None)()
    if names:
        print(json.dumps({"phases": seconds}), flush=True)
        return
    for name, e in entries.items():  # each main-path run's counts, and in all
        e["launches_by_path"] = {path: counts[path][name] for path in PATH_KERNELS}
        e["launches"] = sum(e["launches_by_path"].values())
    entries["flash_attention"]["head_dim_256"] = fa256  # phase archs (a)
    entries["flash_attention"]["q_offset"] = q_offset_rows  # phase mesh (a')
    entries["ssd_intra_chunk"]["mesh_slice"] = ssd_slice_rows  # phase mesh (h4), a rank each
    for name, rows in frontend_rows.items():  # phase frontend (a)
        entries[name]["frontend"] = rows
    names = ("flash_attention", "grouped_matmul_f32", "ragged_gate_up_silu_f32",
             "ragged_matmul_f32", "ragged_dw_f32", "ssd_intra_chunk")
    if sorted(entries) != sorted(names):
        fail(f"kernel entries {sorted(entries)}")
    print(json.dumps({"kernels": [entries[n] for n in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


PHASES = ("kernels", "model", "small_parity", "serving", "parity", "profile", "dense_cache",
          "ssm_serving", "ssm_parity", "ssm_profile", "ssm_train", "training", "checkpoint",
          "ep", "migrate", "pipeline", "mesh", "memory", "archs", "frontend", "dryrun")
NEEDS = {"parity": "serving", "ssm_profile": "ssm_serving", "ep": "training",
         "dryrun": "training"}


if __name__ == "__main__":
    main(tuple(sys.argv[1:]))
