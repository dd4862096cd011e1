"""End-to-end training entry point (the twin of ``repro.launch.train``).

Examples (the first on the card, the others small runs on the CPU; the
third resumes the second's checkpoint at step 4 and trains to 6):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --steps 5 --batch 2 --seq 512

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --reduced --device cpu --steps 4 \\
        --batch 2 --seq 32 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --reduced --device cpu --steps 6 \\
        --batch 2 --seq 32 --ckpt-dir /tmp/ckpt

Expert parallelism over ranks (``torchrun``; ``--mesh D,M`` gives world
D*M, EP = gcd(E, M) and TP = M / EP lanes), and the pipeline (``--mesh
P,D,M --pipeline``: P stages of D*M ranks, each stage running its EP
layer, the schedule ``--schedule`` with ``--vstages``).  A rank holds the
reference's block of the batch (``training.shard_batch``): its rows over
data (``batch / D``; the pod joins data without ``--pipeline``; under it
``b_mu / D`` rows of each of the n_mb = 2 P microbatches) and its slice of
the sequence over the model axis (``seq / M`` positions).  So ``--seq``
must divide by M and ``--batch`` by D (by n_mb * D under ``--pipeline``),
or the launch is refused; the ``[mesh]`` line ends with the rank's rows
and positions:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --mesh 1,2 --steps 5 --batch 2 --seq 512            # one card each
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --reduced --device cpu --mesh 2,4 \\
        --steps 3 --batch 8 --seq 32                        # gloo on the CPU
    PYTHONPATH=src torchrun --nproc-per-node 6 -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --reduced --device cpu --mesh 1,6 \\
        --steps 3 --batch 6 --seq 48                        # ep 2, tp 3
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --reduced --device cpu --mesh 2,1,2 \\
        --pipeline --schedule zb_h1 --steps 4 --batch 8 --seq 32 \\
        --ckpt-dir /tmp/ckpt_pp --migrate-every 2

The process group comes from the ``torchrun`` environment (``--backend``:
nccl on the card, gloo on the CPU; gloo can share one card between
ranks, nccl cannot and is refused there); a rank's device is
``cuda:{LOCAL_RANK % device_count}``.  Rank 0 alone prints and writes
metrics.  ``--ckpt-dir`` works at any mesh, pipelined or not: the
checkpoint holds the global state (rank 0 writes it after the expert
leaves are gathered over the EP group and the block leaves over the pp
group), so a run at one mesh or schedule resumes at another.
``--migrate-every`` sets the expert-migration controller's interval (EP >
1, with or without a pipeline; its ``[migrate]`` lines and the
``migrations=`` count of ``[done]``).  Without ``--pipeline`` a pod axis
joins data.

It first prints the planner's production strategy for the arch (256
H100s, batch 256 x 4096, ZeRO over the world: the reference launcher's
call on ``core.platform.H100``) and binds what the run executes:
``--dispatch`` defaults to the strategy's dispatch, ``--a2a`` and
``--a2a-chunks`` to its all-to-all algorithm and chunk depth (the
reference's rule: a flag wins, else the planner's choice), and
``--ckpt-every`` to its Young-Daly interval clamped to [1, steps/2], and
``--schedule`` / ``--vstages`` to its schedule and virtual stages (the
reference's binding: an explicit ``--schedule`` drops the planner's
vstages; the planner's vstages are clamped to a divisor of this run's
layer reps a stage, its interleaved schedule falling back to the default
at one).

It binds the memory policy: the planner's ``choose_memory_policy`` (the
reference dry run's, priced on the H100's HBM for this run's world): remat
"full", and fp32 Adam moments unless 12 B a parameter over the world passes
0.8 of a card's HBM; ``--remat`` and ``--optimizer-dtype`` override it.  A
grid of D * tp > 1 ranks splits the expert d_ff over them where that
divides it, and every grid slices the embedding, attention and dense-FFN
leaves by the reference's rule table (``sharding``; the ``[mesh]`` line
names the sliced leaves and every dim kept whole, and why).

It draws seeded random fp32 master weights on the device, trains with
bf16 compute and the bound moments (the reference plan's
``compute_dtype``/``master_dtype``/``optimizer_dtype``) on
``SyntheticTokens`` (or a ``--corpus``), and prints the step time,
tokens/s and, on the card, the peak device memory.  With ``--ckpt-dir``
the run resumes from the newest intact checkpoint there, checkpoints every
``--ckpt-every`` steps and at its end, and prints the checkpoint spans'
bytes and seconds.  With ``--metrics-out PATH`` it writes the trainer's
telemetry to PATH as JSONL and a Chrome trace to PATH.trace.json, and
prints the drift of the measured ``train.step``, ``a2a.layer`` (EP > 1),
``ckpt.save`` and ``ckpt.restore`` spans against the resource model's
pricing of this run (its own shape, PP, schedule and vstages, EP, DP,
all-to-all and memory policy) on the H100, with the modeled stage-0
memory beside the measured peak, the bound policy and expert split, and
this rank's held bytes (expert, sliced and whole params, m and v) beside
the model's ``static_state_bytes`` under ``zero="world"``; a pipelined
run's Chrome trace carries its schedule's lanes, one a stage.

The trainer gets the dataset itself, which has ``batch_at(step)``: the
JAX twin wraps it in ``Prefetcher(iter(data))``, whose stream starts at
batch 0 whatever step a resume or a rollback re-enters at.

Unlike its JAX twin it has no ``--impl``: the kernels always.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import DEFAULT_SCHEDULE, DISPATCH_MODES, SCHEDULES, get_arch
from repro_torch import obs, sharding
from repro_torch.convert import shard_params
from repro_torch.core import planner
from repro_torch.core import resource_model as rm
from repro_torch.core.platform import H100, Platform
from repro_torch.data import MemmapCorpus, SyntheticTokens
from repro_torch.launch import ranks
from repro_torch.models.model import LanguageModel, init_params, tree_paths
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.optimizer import adamw_init
from repro_torch.sharding import OPTIMIZER_DTYPES, REMAT_MODES
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.training import batch_block, describe_block

# The platform the planner and the drift report price (a test swaps it).
PLATFORM = H100
# The reference launcher's production call: 256 chips, batch 256 x 4096.
PRODUCTION = dict(total_chips=256, batch=256, seq=4096, zero="world")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dispatch", default=None, choices=DISPATCH_MODES,
                    help="MoE expert dispatch; default: the planner's choice")
    ap.add_argument("--corpus", default=None, help="memmap token corpus path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--a2a", default=None, choices=("flat", "halo"),
                    help="EP all-to-all algorithm; default: the planner's choice")
    ap.add_argument("--a2a-chunks", type=int, default=None,
                    help="dispatch/combine row chunks overlapped with the expert "
                         "FFN; default: the planner's choice")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest intact "
                         "checkpoint, save every --ckpt-every steps and at the end")
    ap.add_argument("--migrate-every", type=int, default=50,
                    help="steps between expert-migration checks (EP > 1)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints; default: the planner's "
                         "Young-Daly interval clamped to [1, steps/2], else 50")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipeline the layer stack over the pod axis (--mesh P,D,M)")
    ap.add_argument("--schedule", default=None, choices=SCHEDULES,
                    help="pipeline schedule; default: the planner's choice, else "
                         f"{DEFAULT_SCHEDULE}")
    ap.add_argument("--vstages", type=int, default=None,
                    help="virtual stages a pipeline stage (interleaved_1f1b); default: "
                         "the planner's choice, else 1")
    ap.add_argument("--remat", default=None, choices=REMAT_MODES,
                    help="remat of each layer rep; default: the planner's memory "
                         "policy (full)")
    ap.add_argument("--optimizer-dtype", default=None, choices=OPTIMIZER_DTYPES,
                    help="Adam moments' dtype; default: the planner's memory policy")
    ap.add_argument("--metrics-out", default=None,
                    help="write the trainer's telemetry as JSONL here, a Chrome "
                         "trace to <path>.trace.json, and print a model-vs-"
                         "measured drift report at the end of the run")
    ranks.add_args(ap)
    return ap.parse_args(argv)


CKPT_SPANS = ("ckpt.snapshot", "ckpt.save", "ckpt.verify", "ckpt.restore")


def _ckpt_report(events) -> Dict[str, List[Dict[str, Any]]]:
    """Each checkpoint span of the run: {name: [{"step", "s", attrs...}]}."""
    out: Dict[str, List[Dict[str, Any]]] = {n: [] for n in CKPT_SPANS}
    for e in events:
        if e["kind"] == "span" and e["name"] in out:
            out[e["name"]].append({"s": e["dur"], **e["attrs"]})
    return out


@functools.lru_cache(maxsize=None)
def production_strategy(arch: str, platform: Platform) -> Optional[planner.Strategy]:
    """The planner's best strategy for ``arch`` at ``PRODUCTION`` scale on
    ``platform`` (a 256-chip search takes seconds: one a process)."""
    return planner.best_strategy(get_arch(arch), platform, **PRODUCTION)


def plan(args: argparse.Namespace, say=print) -> Tuple[Optional[str], int, str, int, str, int]:
    """Print the planner's production strategy for ``args.arch`` on
    ``PLATFORM`` and bind this run's expert dispatch, all-to-all algorithm
    and chunks, checkpoint interval, pipeline schedule and virtual stages:
    a flag wins, else the strategy's choice.  Returns (dispatch,
    ckpt_every, a2a_algo, a2a_chunks, schedule, vstages)."""
    best = production_strategy(args.arch, PLATFORM)
    n = PRODUCTION["total_chips"]
    if best is None:
        say(f"[planner] no feasible strategy for {args.arch} @{n}x{PLATFORM.name}")
    else:
        say(f"[planner] production-strategy for {args.arch} @{n}x{PLATFORM.name}:")
        say("          " + best.describe())
    # Checkpoint cadence: the flag wins, else the resource model's
    # Young-Daly interval, clamped to the run so a short run still
    # checkpoints at least once.
    ckpt_every = args.ckpt_every
    if ckpt_every is None:
        if best is None:
            ckpt_every = 50
        else:
            e = best.estimate
            ckpt_every = min(max(e.ckpt_every_steps, 1), max(args.steps // 2, 1))
            say(f"[planner] ckpt-every defaulted to {ckpt_every} steps (Young-Daly: "
                f"t_ckpt={e.t_ckpt:.1f}s tau={e.ckpt_interval_s:.0f}s "
                f"goodput={e.goodput_factor * 100:.2f}%)")
    # The schedule and its vstage depth: an explicit --schedule drops the
    # planner's vstages (they belong to ITS schedule) unless --vstages is
    # given too; the planner's are clamped to this run's layer reps a stage.
    if args.schedule:
        schedule, vstages = args.schedule, args.vstages or 1
    else:
        schedule = best.schedule if best is not None else DEFAULT_SCHEDULE
        vstages = args.vstages or (best.vstages if best is not None else 1)
        if args.vstages is None and args.pipeline and args.mesh and vstages > 1:
            arch = get_arch(args.arch)
            if args.reduced:
                arch = arch.reduced()
            pp = int(args.mesh.split(",")[0])
            rps = max(arch.num_layers // len(arch.block_pattern) // pp, 1)
            want = vstages
            vstages = max(v for v in range(1, min(vstages, rps) + 1) if rps % v == 0)
            if vstages != want:
                say(f"[planner] vstages {want} -> {vstages} (layer reps per stage: {rps})")
            if vstages == 1 and schedule == "interleaved_1f1b":
                schedule = DEFAULT_SCHEDULE
    note = "--schedule" if args.schedule else "the planner's choice"
    say(f"[planner] schedule {schedule} vstages {vstages} ({note})"
        + ("" if args.pipeline else ": bound with --pipeline; this run is PP = 1"))
    moe = get_arch(args.arch).moe
    dispatch = args.dispatch
    if dispatch is None and moe is not None:
        dispatch = best.dispatch if best is not None else moe.dispatch
    # The a2a path: the flag wins, else the planner's ranked (algo, chunks).
    a2a_algo = args.a2a or (best.a2a_algo if best is not None else "flat")
    a2a_chunks = args.a2a_chunks or (best.a2a_chunks if best is not None else 1)
    if moe is not None:
        note = "--a2a" if args.a2a or args.a2a_chunks else "the planner's choice"
        say(f"[trainer] ep a2a: {a2a_algo} x{a2a_chunks} chunks ({note})")
    return dispatch, ckpt_every, a2a_algo, a2a_chunks, schedule, vstages


def memory_policy(args: argparse.Namespace, arch, say=print) -> Tuple[str, str]:
    """The run's (optimizer_dtype, remat): the planner's
    ``choose_memory_policy`` for training over this launch's world on
    ``PLATFORM``, each overridden by its flag."""
    opt_dtype, remat = planner.choose_memory_policy(arch, "train", ranks.world_size(),
                                                    PLATFORM)
    opt_dtype, remat = args.optimizer_dtype or opt_dtype, args.remat or remat
    flags = [f for f, v in (("--remat", args.remat),
                            ("--optimizer-dtype", args.optimizer_dtype)) if v]
    note = ", ".join(flags) or "the planner's choice"
    say(f"[trainer] memory policy: remat={remat} optimizer_dtype={opt_dtype} ({note})")
    return opt_dtype, remat


def memory_setup(plan) -> Dict[str, Any]:
    """The resource model's memory fields (``rm.TrainSetup``) of a plan's
    training: activations checkpointed under any remat, the planner's bytes
    a parameter (16 with fp32 moments, 10 with bf16), and the eager
    attention's s^2 scores (training attention is eager, as in the
    reference: no flash kernel has a backward)."""
    return {"checkpoint_activations": plan.remat != "none",
            "bytes_per_param": 16 if plan.optimizer_dtype == "float32" else 10,
            "flash_attention": False}


def train(args: argparse.Namespace) -> Tuple[Dict[str, Any], Trainer, Dict[str, Any]]:
    """Train ``args.steps`` steps; returns (summary, the trainer, its
    ``fit`` output with the final state: this rank's shard)."""
    rank = ranks.rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    dispatch, ckpt_every, a2a_algo, a2a_chunks, schedule, vstages = plan(args, say)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if arch.moe is not None:
        if dispatch != arch.moe.dispatch:
            arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))
        note = "--dispatch" if args.dispatch else "the planner's choice"
        say(f"[trainer] moe dispatch: {arch.moe.dispatch} ({note})")
    opt_dtype, remat = memory_policy(args, arch, say)
    device, mesh = ranks.init(args, arch, a2a_algo, a2a_chunks, schedule=schedule,
                              vstages=vstages if args.pipeline else 1, remat=remat,
                              optimizer_dtype=opt_dtype)
    rows, positions = batch_block(mesh, args.batch, args.seq)
    say(mesh.describe() + f" batch: {rows} rows x {positions} positions a rank"
        + (f" (of each of {mesh.num_microbatches} microbatches)" if mesh.pp > 1 else "")
        + (f", the sequence over ep x tp = {mesh.seq_size}" if mesh.seq_size > 1 else ""))
    if mesh.world > 1:  # every rank names the tokens it holds, in one write
        sys.stdout.flush()
        os.write(sys.stdout.fileno(), (
            f"[mesh] rank {rank} (p, d, e, t) = {(mesh.pp_rank,) + mesh.coords}: "
            f"{describe_block(mesh, args.batch, args.seq)}\n").encode())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # Spans are recorded only for a checkpointed or --metrics-out run:
    # without one the loop does no more host work than before.
    ring = obs.RingBufferSink() if args.ckpt_dir or args.metrics_out else None
    sinks = [ring] if ring is not None else []
    if args.metrics_out and rank == 0:
        sinks.append(obs.JsonlSink(args.metrics_out))
    telemetry = obs.Telemetry(enabled=ring is not None, sinks=sinks)
    lm = LanguageModel(arch, mesh,
                       telemetry=telemetry if mesh.ep > 1 or mesh.pp > 1 else None)
    opt = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    # Every rank draws the whole model from the seed and keeps its shard;
    # the moments are made for the shard alone.
    params = init_params(arch, torch.Generator(device=device).manual_seed(args.seed), device)
    n_params = sum(p.numel() for p in tree_paths(params).values())
    params = shard_params(params, mesh)
    if device.type == "cuda":  # hand the whole model's blocks back to the card
        torch.cuda.empty_cache()
    state = {"params": params, **adamw_init(params, mesh.optimizer_dtype)}
    held = held_bytes(state, mesh)
    say(f"[model] {arch.name} on {device}: {n_params / 1e6:.1f}M params, fp32 "
        f"masters, {mesh.optimizer_dtype} moments, bf16 compute, remat {mesh.remat}, "
        f"batch {args.batch} x seq {args.seq}"
        + (f" ({rows * positions} tokens a rank)" if mesh.world > 1 and mesh.pp == 1
           else "")
        + (f" ({mesh.num_microbatches} microbatches of {args.batch // mesh.num_microbatches}"
           f" sequences, {rows * positions} tokens of each a rank)" if mesh.pp > 1 else ""))
    if args.corpus:
        source = MemmapCorpus(args.corpus, args.batch, args.seq, seed=args.seed)
    else:
        source = SyntheticTokens(arch.vocab_size, args.batch, args.seq)
    trainer = Trainer(lm, opt, TrainerConfig(total_steps=args.steps,
                                             checkpoint_dir=args.ckpt_dir,
                                             checkpoint_every=ckpt_every,
                                             migrate_every=args.migrate_every),
                      log_fn=say, telemetry=telemetry)
    out = trainer.fit(state, source)
    times = trainer.step_times[1:] or trainer.step_times  # the first step warms up
    p50 = float(np.median(times)) if times else float("nan")
    summary = {
        "arch": arch.name, "dispatch": arch.moe.dispatch if arch.moe else None,
        "ckpt_every": ckpt_every, "world": mesh.world, "ep": mesh.ep, "pp": mesh.pp,
        "schedule": mesh.schedule if mesh.pp > 1 else None,
        "remat": mesh.remat, "optimizer_dtype": mesh.optimizer_dtype,
        "ffn_split": mesh.ffn_split,
        "vstages": mesh.vstages if mesh.pp > 1 else None,
        "a2a": f"{mesh.a2a_algo} x{mesh.a2a_chunks}",
        "device": str(device), "params": n_params, "steps": len(trainer.step_times),
        "skipped": len(out["anomalies"]),
        "loss": float(out["metrics"].get("loss", float("nan"))),
        "step_times_s": list(trainer.step_times), "step_p50_ms": 1e3 * p50,
        "tokens_per_s": args.batch * args.seq / p50,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "peak_mem_gb_ranks": _rank_peaks(device, mesh),
        "held_bytes": held,
        "resumed_from": trainer.resumed_from, "rollbacks": out["rollbacks"],
        "migrations": out["migrations"],
    }
    say(f"[done] step={out['last_step']} loss={summary['loss']!r} "
        f"skipped={summary['skipped']} stragglers={len(out['stragglers'])} "
        f"migrations={len(out['migrations'])} "
        f"resumed_from={summary['resumed_from']} rollbacks={len(out['rollbacks'])} "
        f"step p50 {summary['step_p50_ms']:.1f} ms, "
        f"{summary['tokens_per_s']:.0f} tokens/s"
        + (f", peak device memory {summary['peak_mem_gb']:.2f} GB"
           if summary["peak_mem_gb"] is not None else "")
        + (" (a rank: " + ", ".join(f"{g:.2f}" for g in summary["peak_mem_gb_ranks"]) + ")"
           if summary["peak_mem_gb_ranks"] else ""))
    if args.ckpt_dir:
        summary["ckpt"] = _ckpt_report(ring.events())
        for name, spans in summary["ckpt"].items():
            for sp in spans:
                rate = (f", {sp['bytes'] / sp['s'] / 1e9:.2f} GB/s"
                        if "bytes" in sp and sp["s"] > 0 else "")
                say(f"[ckpt] {name} step {sp['step']}: {sp['s']:.3f} s{rate} "
                    + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in sp.items() if k not in ("s", "step")))
    if args.metrics_out:
        if rank == 0:
            summary.update(_telemetry_reports(args, arch, ring.events(), summary, mesh))
        telemetry.close()
    return summary, trainer, out


def held_bytes(state, mesh) -> Dict[str, int]:
    """This rank's bytes of params, m and v: "expert" (the MoE FFNs' expert
    leaves), "sliced" (the non-expert leaves the plan's rules slice) and
    "whole" (the rest)."""
    out = {"expert": 0, "sliced": 0, "whole": 0}
    for part in ("params", "m", "v"):
        flat = tree_paths(state[part])
        experts = sharding.expert_paths(flat)
        for k, t in flat.items():
            kind = "expert" if k in experts else "sliced" if k in mesh.layout else "whole"
            out[kind] += t.numel() * t.element_size()
    return out


def _rank_peaks(device, mesh) -> Optional[List[float]]:
    """Every rank's peak device memory in GB (an all-gather over the world;
    None on the CPU or at world 1)."""
    if device.type != "cuda" or mesh.world == 1:
        return None
    mine = torch.tensor([torch.cuda.max_memory_allocated(device) / 1e9], device=device)
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    torch.distributed.all_gather(parts, mine, group=mesh.world_group)
    return [float(p) for p in parts]


def _telemetry_reports(args, arch, events, summary, mesh) -> Dict[str, Any]:
    """The end-of-run drift report (this run's shape, PP, schedule and
    vstages, EP, DP and all-to-all, priced on ``PLATFORM``), the modeled
    stage-0 memory beside the measured peak, and the Chrome trace, with
    the schedule's lanes, one a stage, when the run is pipelined (their
    ticks scaled so the lanes span a measured step)."""
    from repro_torch.core import schedules as sched_lib

    pipe = ({"schedule": mesh.schedule, "vstages": mesh.vstages} if mesh.pp > 1 else {})
    setup = rm.TrainSetup(b=args.batch, s=args.seq, PP=mesh.pp, EP=mesh.ep, DP=mesh.dp,
                          zero="world", a2a_algo=mesh.a2a_algo,
                          a2a_chunks=mesh.a2a_chunks, **pipe, **memory_setup(mesh),
                          **({"dispatch": arch.moe.dispatch} if arch.moe else {}))
    est = rm.estimate(rm.ModelShape.from_arch(arch), setup, PLATFORM)
    tracker = obs.DriftTracker(rm.modeled_phases(est))
    n = tracker.observe_events(events)
    print(tracker.format_report(
        f"drift {arch.name}: measured on {summary['device']} vs the {PLATFORM.name} model"))
    peak = summary["peak_mem_gb"]
    print(f"[model] memory policy remat={mesh.remat} optimizer_dtype={mesh.optimizer_dtype}"
          + (f", expert d_ff split {mesh.ffn_split} ways over data x tp" if mesh.ffn_split > 1
             else f", expert slots whole ({mesh.ffn_whole})" if mesh.ffn_whole
             else ", expert slots whole (one data rank and tp lane)"))
    held = summary["held_bytes"]
    static = rm.static_state_bytes(rm.ModelShape.from_arch(arch), setup,
                                   arch.num_layers / mesh.pp)
    print(f"[model] held a rank (params, m, v): expert {held['expert'] / 1e9:.4f} GB, "
          f"non-expert {(held['sliced'] + held['whole']) / 1e9:.4f} GB ("
          f"{held['sliced'] / 1e9:.4f} in {len(mesh.layout)} sliced leaves, "
          f"{held['whole'] / 1e9:.4f} whole) vs static_state_bytes(zero=\"world\") "
          f"{static / 1e9:.4f} GB (params, grads, m, v over {setup.P} chips)")
    print(f"[model] {PLATFORM.name} t_step {est.t_step * 1e3:.4g} ms vs measured step p50 "
          f"{summary['step_p50_ms']:.1f} ms; mem_stage0 {est.mem_stage0 / 1e9:.2f} GB vs "
          + (f"peak torch.cuda.max_memory_allocated {peak:.2f} GB" if peak is not None
             else "no device peak on the CPU"))
    sched, tick_s = None, 1e-3
    if mesh.pp > 1:
        sched = sched_lib.build(mesh.schedule, mesh.pp, mesh.num_microbatches, mesh.vstages)
        steps = [e["dur"] for e in events if e["kind"] == "span" and e["name"] == "train.step"]
        if len(steps) > 1:
            tick_s = (sum(steps[1:]) / (len(steps) - 1)) / sched.num_ticks
    trace_path = args.metrics_out + ".trace.json"
    obs.write_chrome_trace(trace_path, events, schedule=sched, tick_s=tick_s,
                           process_name=f"train {arch.name}")
    print(f"[obs] {len(events)} events ({n} drift spans) -> {args.metrics_out}; "
          f"chrome trace: {trace_path}"
          + (f" ({mesh.pp} stage lanes, {sched.name})" if sched is not None else ""))
    return {"drift": tracker.report(), "trace": trace_path,
            "model": {"t_step_s": est.t_step, "mem_stage0_gb": est.mem_stage0 / 1e9}}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return train(parse_args(argv))[0]


if __name__ == "__main__":
    try:
        main()
    finally:
        ranks.shutdown()
