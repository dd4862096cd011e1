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

It draws seeded random fp32 master weights on the device, trains with
bf16 compute and fp32 Adam moments (the reference plan's
``compute_dtype``/``master_dtype``/``optimizer_dtype``) on
``SyntheticTokens`` (or a ``--corpus``), and prints the step time,
tokens/s and, on the card, the peak device memory.  ``--dispatch``
defaults to ``ragged``, the reference planner's ranked choice for every
MoE arch it is assigned; ``capacity`` is accepted.  With ``--ckpt-dir``
the run resumes from the newest intact checkpoint there, checkpoints every
``--ckpt-every`` steps and at its end, and prints the checkpoint spans'
bytes and seconds.

The trainer gets the dataset itself, which has ``batch_at(step)``: the
JAX twin wraps it in ``Prefetcher(iter(data))``, whose stream starts at
batch 0 whatever step a resume or a rollback re-enters at.

Unlike its JAX twin it has no ``--mesh``, ``--pipeline``, ``--impl`` or
``--migrate-every`` and prints no planner report: one device, the kernels
always, and the planner, expert migration and pipeline executor are not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import DISPATCH_MODES, get_arch
from repro_torch import obs
from repro_torch.data import MemmapCorpus, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.training import init_state

PLANNER_DISPATCH = "ragged"  # the reference planner's choice for the MoE archs


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dispatch", default=PLANNER_DISPATCH, choices=DISPATCH_MODES,
                    help="MoE expert dispatch (default: ragged, the reference "
                         "planner's choice)")
    ap.add_argument("--corpus", default=None, help="memmap token corpus path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest intact "
                         "checkpoint, save every --ckpt-every steps and at the end")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (default 50, the reference's "
                         "value without a planner; its Young-Daly default waits "
                         "for the planner's port, ROADMAP Queue 1 item 4)")
    return ap.parse_args(argv)


CKPT_SPANS = ("ckpt.snapshot", "ckpt.save", "ckpt.verify", "ckpt.restore")


def _ckpt_report(events) -> Dict[str, List[Dict[str, Any]]]:
    """Each checkpoint span of the run: {name: [{"step", "s", attrs...}]}."""
    out: Dict[str, List[Dict[str, Any]]] = {n: [] for n in CKPT_SPANS}
    for e in events:
        if e["kind"] == "span" and e["name"] in out:
            out[e["name"]].append({"s": e["dur"], **e["attrs"]})
    return out


def train(args: argparse.Namespace) -> Tuple[Dict[str, Any], Trainer, Dict[str, Any]]:
    """Train ``args.steps`` steps; returns (summary, the trainer, its
    ``fit`` output with the final state)."""
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if arch.moe is not None:
        if args.dispatch != arch.moe.dispatch:
            arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch=args.dispatch))
        note = (" (the reference planner's choice for the MoE archs)"
                if args.dispatch == PLANNER_DISPATCH else "")
        print(f"[trainer] moe dispatch: {arch.moe.dispatch}{note}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lm = LanguageModel(arch)
    opt = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    state = init_state(lm, torch.Generator(device=device).manual_seed(args.seed), device)
    n_params = sum(p.numel() for p in tree_paths(state["params"]).values())
    print(f"[model] {arch.name} on {device}: {n_params / 1e6:.1f}M params, fp32 "
          f"masters and moments, bf16 compute, batch {args.batch} x seq {args.seq}")
    if args.corpus:
        source = MemmapCorpus(args.corpus, args.batch, args.seq, seed=args.seed)
    else:
        source = SyntheticTokens(arch.vocab_size, args.batch, args.seq)
    # Spans are recorded only for a checkpointed run: without one the loop
    # does no more host work than before.
    ring = obs.RingBufferSink() if args.ckpt_dir else None
    trainer = Trainer(lm, opt, TrainerConfig(total_steps=args.steps,
                                             checkpoint_dir=args.ckpt_dir,
                                             checkpoint_every=args.ckpt_every),
                      telemetry=obs.Telemetry(enabled=ring is not None,
                                              sinks=[ring] if ring else None))
    out = trainer.fit(state, source)
    times = trainer.step_times[1:] or trainer.step_times  # the first step warms up
    p50 = float(np.median(times)) if times else float("nan")
    summary = {
        "arch": arch.name, "dispatch": arch.moe.dispatch if arch.moe else None,
        "device": str(device), "params": n_params, "steps": len(trainer.step_times),
        "skipped": len(out["anomalies"]),
        "loss": float(out["metrics"].get("loss", float("nan"))),
        "step_times_s": list(trainer.step_times), "step_p50_ms": 1e3 * p50,
        "tokens_per_s": args.batch * args.seq / p50,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "resumed_from": trainer.resumed_from, "rollbacks": out["rollbacks"],
    }
    print(f"[done] step={out['last_step']} loss={summary['loss']:.4f} "
          f"skipped={summary['skipped']} stragglers={len(out['stragglers'])} "
          f"resumed_from={summary['resumed_from']} rollbacks={len(out['rollbacks'])} "
          f"step p50 {summary['step_p50_ms']:.1f} ms, "
          f"{summary['tokens_per_s']:.0f} tokens/s"
          + (f", peak device memory {summary['peak_mem_gb']:.2f} GB"
             if summary["peak_mem_gb"] is not None else ""))
    if ring is not None:
        summary["ckpt"] = _ckpt_report(ring.events())
        for name, spans in summary["ckpt"].items():
            for sp in spans:
                rate = (f", {sp['bytes'] / sp['s'] / 1e9:.2f} GB/s"
                        if "bytes" in sp and sp["s"] > 0 else "")
                print(f"[ckpt] {name} step {sp['step']}: {sp['s']:.3f} s{rate} "
                      + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                 for k, v in sp.items() if k not in ("s", "step")))
    return summary, trainer, out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return train(parse_args(argv))[0]


if __name__ == "__main__":
    main()
