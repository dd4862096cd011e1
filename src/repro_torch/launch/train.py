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
D*M, EP = gcd(E, M) and TP = M / EP, which must be 1; each rank takes
``batch / world`` whole sequences):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --mesh 1,2 --steps 5 --batch 2 --seq 512            # one card each
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --reduced --device cpu --mesh 2,4 \
        --steps 3 --batch 8 --seq 32                        # gloo on the CPU

The process group comes from the ``torchrun`` environment (``--backend``:
nccl on the card, gloo on the CPU; gloo can share one card between
ranks, nccl cannot and is refused there); a rank's device is
``cuda:{LOCAL_RANK % device_count}``.  Rank 0 alone prints and writes
metrics.  ``--ckpt-dir`` needs world 1 (an EP-agnostic checkpoint is
ROADMAP Queue 1 item 2b), and the pod axis and ``--pipeline`` wait for the
pipeline executor (item 3).

It first prints the planner's production strategy for the arch (256
H100s, batch 256 x 4096, ZeRO over the world: the reference launcher's
call on ``core.platform.H100``) and binds what the run executes:
``--dispatch`` defaults to the strategy's dispatch, ``--a2a`` and
``--a2a-chunks`` to its all-to-all algorithm and chunk depth (the
reference's rule: a flag wins, else the planner's choice), and
``--ckpt-every`` to its Young-Daly interval clamped to [1, steps/2].  The
strategy's schedule and virtual stages are printed and not bound: the port
has no pipeline executor yet.

It draws seeded random fp32 master weights on the device, trains with
bf16 compute and fp32 Adam moments (the reference plan's
``compute_dtype``/``master_dtype``/``optimizer_dtype``) on
``SyntheticTokens`` (or a ``--corpus``), and prints the step time,
tokens/s and, on the card, the peak device memory.  With ``--ckpt-dir``
the run resumes from the newest intact checkpoint there, checkpoints every
``--ckpt-every`` steps and at its end, and prints the checkpoint spans'
bytes and seconds.  With ``--metrics-out PATH`` it writes the trainer's
telemetry to PATH as JSONL and a Chrome trace to PATH.trace.json, and
prints the drift of the measured ``train.step``, ``a2a.layer`` (EP > 1),
``ckpt.save`` and ``ckpt.restore`` spans against the resource model's
pricing of this run (its own shape, EP, DP and all-to-all, PP = 1) on the
H100, with the modeled stage-0 memory beside the measured peak.

The trainer gets the dataset itself, which has ``batch_at(step)``: the
JAX twin wraps it in ``Prefetcher(iter(data))``, whose stream starts at
batch 0 whatever step a resume or a rollback re-enters at.

Unlike its JAX twin it has no ``--pipeline``, ``--schedule``,
``--vstages``, ``--impl`` or ``--migrate-every``: the kernels always;
expert migration and the pipeline executor are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import DISPATCH_MODES, get_arch
from repro_torch import obs
from repro_torch.convert import shard_params
from repro_torch.core import planner
from repro_torch.core import resource_model as rm
from repro_torch.core.platform import H100, Platform
from repro_torch.data import MemmapCorpus, SyntheticTokens
from repro_torch.launch import ranks
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.training import init_state

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
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints; default: the planner's "
                         "Young-Daly interval clamped to [1, steps/2], else 50")
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


def plan(args: argparse.Namespace, say=print) -> Tuple[Optional[str], int, str, int]:
    """Print the planner's production strategy for ``args.arch`` on
    ``PLATFORM`` and bind this run's expert dispatch, all-to-all algorithm
    and chunks and checkpoint interval: a flag wins, else the strategy's
    choice.  Returns (dispatch, ckpt_every, a2a_algo, a2a_chunks)."""
    best = production_strategy(args.arch, PLATFORM)
    n = PRODUCTION["total_chips"]
    if best is None:
        say(f"[planner] no feasible strategy for {args.arch} @{n}x{PLATFORM.name}")
    else:
        say(f"[planner] production-strategy for {args.arch} @{n}x{PLATFORM.name}:")
        say("          " + best.describe())
        say(f"[planner] schedule {best.schedule} vstages {best.vstages}: printed, not "
            f"bound (the port has no pipeline executor yet; this run is PP = 1)")
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
    return dispatch, ckpt_every, a2a_algo, a2a_chunks


def train(args: argparse.Namespace) -> Tuple[Dict[str, Any], Trainer, Dict[str, Any]]:
    """Train ``args.steps`` steps; returns (summary, the trainer, its
    ``fit`` output with the final state: this rank's shard)."""
    rank = ranks.rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    dispatch, ckpt_every, a2a_algo, a2a_chunks = plan(args, say)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if arch.moe is not None:
        if dispatch != arch.moe.dispatch:
            arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))
        note = "--dispatch" if args.dispatch else "the planner's choice"
        say(f"[trainer] moe dispatch: {arch.moe.dispatch} ({note})")
    if args.ckpt_dir and ranks.world_size() > 1:
        raise SystemExit("--ckpt-dir needs world 1: a checkpoint would hold one rank's "
                         "expert shard (an EP-agnostic checkpoint is ROADMAP.md Queue 1 "
                         "item 2b)")
    device, mesh = ranks.init(args, arch, a2a_algo, a2a_chunks)
    say(mesh.describe())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # Spans are recorded only for a checkpointed or --metrics-out run:
    # without one the loop does no more host work than before.
    ring = obs.RingBufferSink() if args.ckpt_dir or args.metrics_out else None
    sinks = [ring] if ring else []
    if args.metrics_out and rank == 0:
        sinks.append(obs.JsonlSink(args.metrics_out))
    telemetry = obs.Telemetry(enabled=ring is not None, sinks=sinks)
    lm = LanguageModel(arch, mesh, telemetry=telemetry if mesh.ep > 1 else None)
    opt = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    # Every rank draws the whole model from the seed and keeps its shard.
    state = init_state(lm, torch.Generator(device=device).manual_seed(args.seed), device)
    n_params = sum(p.numel() for p in tree_paths(state["params"]).values())
    state = {k: shard_params(v, mesh) if k in ("params", "m", "v") else v
             for k, v in state.items()}
    say(f"[model] {arch.name} on {device}: {n_params / 1e6:.1f}M params, fp32 "
        f"masters and moments, bf16 compute, batch {args.batch} x seq {args.seq}"
        + (f" ({args.batch // mesh.world} sequences a rank)" if mesh.world > 1 else ""))
    if args.corpus:
        source = MemmapCorpus(args.corpus, args.batch, args.seq, seed=args.seed)
    else:
        source = SyntheticTokens(arch.vocab_size, args.batch, args.seq)
    trainer = Trainer(lm, opt, TrainerConfig(total_steps=args.steps,
                                             checkpoint_dir=args.ckpt_dir,
                                             checkpoint_every=ckpt_every),
                      log_fn=say, telemetry=telemetry)
    out = trainer.fit(state, source)
    times = trainer.step_times[1:] or trainer.step_times  # the first step warms up
    p50 = float(np.median(times)) if times else float("nan")
    summary = {
        "arch": arch.name, "dispatch": arch.moe.dispatch if arch.moe else None,
        "ckpt_every": ckpt_every, "world": mesh.world, "ep": mesh.ep,
        "a2a": f"{mesh.a2a_algo} x{mesh.a2a_chunks}",
        "device": str(device), "params": n_params, "steps": len(trainer.step_times),
        "skipped": len(out["anomalies"]),
        "loss": float(out["metrics"].get("loss", float("nan"))),
        "step_times_s": list(trainer.step_times), "step_p50_ms": 1e3 * p50,
        "tokens_per_s": args.batch * args.seq / p50,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "resumed_from": trainer.resumed_from, "rollbacks": out["rollbacks"],
    }
    say(f"[done] step={out['last_step']} loss={summary['loss']!r} "
        f"skipped={summary['skipped']} stragglers={len(out['stragglers'])} "
        f"resumed_from={summary['resumed_from']} rollbacks={len(out['rollbacks'])} "
        f"step p50 {summary['step_p50_ms']:.1f} ms, "
        f"{summary['tokens_per_s']:.0f} tokens/s"
        + (f", peak device memory {summary['peak_mem_gb']:.2f} GB"
           if summary["peak_mem_gb"] is not None else ""))
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


def _telemetry_reports(args, arch, events, summary, mesh) -> Dict[str, Any]:
    """The end-of-run drift report (this run's shape, EP, DP and
    all-to-all, PP = 1, priced on ``PLATFORM``), the modeled stage-0 memory
    beside the measured peak, and the Chrome trace (no schedule lanes:
    PP = 1)."""
    setup = rm.TrainSetup(b=args.batch, s=args.seq, PP=1, EP=mesh.ep, DP=mesh.dp,
                          zero="world", a2a_algo=mesh.a2a_algo,
                          a2a_chunks=mesh.a2a_chunks,
                          **({"dispatch": arch.moe.dispatch} if arch.moe else {}))
    est = rm.estimate(rm.ModelShape.from_arch(arch), setup, PLATFORM)
    tracker = obs.DriftTracker(rm.modeled_phases(est))
    n = tracker.observe_events(events)
    print(tracker.format_report(
        f"drift {arch.name}: measured on {summary['device']} vs the {PLATFORM.name} model"))
    peak = summary["peak_mem_gb"]
    print(f"[model] {PLATFORM.name} t_step {est.t_step * 1e3:.4g} ms vs measured step p50 "
          f"{summary['step_p50_ms']:.1f} ms; mem_stage0 {est.mem_stage0 / 1e9:.2f} GB vs "
          + (f"peak torch.cuda.max_memory_allocated {peak:.2f} GB" if peak is not None
             else "no device peak on the CPU"))
    trace_path = args.metrics_out + ".trace.json"
    obs.write_chrome_trace(trace_path, events, process_name=f"train {arch.name}")
    print(f"[obs] {len(events)} events ({n} drift spans) -> {args.metrics_out}; "
          f"chrome trace: {trace_path}")
    return {"drift": tracker.report(), "trace": trace_path,
            "model": {"t_step_s": est.t_step, "mem_stage0_gb": est.mem_stage0 / 1e9}}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return train(parse_args(argv))[0]


if __name__ == "__main__":
    try:
        main()
    finally:
        ranks.shutdown()
