"""End-to-end serving entry point: random weights -> continuous batching -> a
decode parity probe.

Examples (the first on the card, the second a small run on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --reduced --device cpu --dtype float32

It draws seeded random weights on the device, serves a batch of
synthetic mixed-length requests with the continuous-batching engine under
the configured expert dispatch, then replays request 0's sequence through
the paged prefill + decode steps in fp32 and compares every step's logits
with the uncached forward.  The replay runs under the configured dispatch
and, when that is not ``ragged``, under ``ragged`` too; the ragged error
must stay within ``PARITY_BOUND`` = 1e-5, the twin's bound (dropless
dispatch recomputes and drops nothing, so the paged path differs from the
forward only by summation order).  A dense arch (no MoE layer) serves
without a dispatch and runs the probe once, as "dense", at the same bound.
``serve`` and ``decode_parity`` are the two halves of ``main``, for
callers that run them apart.

Before it serves, it prints the serving planner's strategy for the arch at
production scale (``--chips`` H100s under a ``--slo-ms`` per-token decode
SLO at a ``--context`` / ``--prefill-len`` mean: the reference launcher's
call on ``core.platform.H100``) and binds the strategy's dispatch (unless
``--dispatch`` is given) and its batch width, capped by ``--max-seqs``,
into the engine.  With ``--metrics-out PATH`` it writes the engine's
telemetry to PATH as JSONL and a Chrome trace to PATH.trace.json, and
prints the drift of the measured ``engine.decode`` and ``engine.prefill``
spans against the serving model's pricing of that setup on the H100.

Under ``torchrun --nproc-per-node N ... --mesh D,M`` or ``--mesh P,D,M``
(``launch.ranks``; N the mesh's product, the pod axis joining data) it
serves over D * P data ranks, each with an EP group of ep = gcd(E, M)
ranks times tp = M / ep lanes, in lockstep: every rank runs the same
engine on the same requests and holds its expert slots and its slice of
every leaf the plan's rule table slices (``convert.shard_params``; each
forward gathers the embedding and each layer its projections).  In prefill each
rank takes its EP group's sequence shard of each MoE layer's input (every
tp lane the same shard); in decode it computes its own experts over its
data rank's share of the batch (split over the data group when D divides
the batch, else whole), and the logits are all-gathered over the data
group before sampling, so the tokens are equal on every rank.  Rank 0
prints.  The parity probe runs at world 1 only.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m \\
        repro_torch.launch.serve --reduced --device cpu --dtype float32 --mesh 2,2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, sharding
from repro_torch.convert import shard_params
from repro_torch.configs import DISPATCH_MODES, ArchConfig, get_arch
from repro_torch.core import planner
from repro_torch.core import resource_model as rm
from repro_torch.core.platform import H100
from repro_torch.launch import ranks
from repro_torch.models.model import LanguageModel, init_params
from repro_torch.serving import Engine, Request, ServeConfig
from repro_torch.serving.engine import check_ep
from repro_torch.serving.kv_cache import BlockPool, PagedLayout

PARITY_BOUND = 1e-5  # max |dlogits| of the fp32 ragged paged decode
# The platform the planner and the drift report price (a test swaps it).
PLATFORM = H100


def parity_probe(lm: LanguageModel, params, layout, seq: np.ndarray, plen: int,
                 ref: Optional[torch.Tensor] = None):
    """Paged prefill of ``seq[:plen]`` then one decode step per remaining
    token, each step's logits against the uncached forward over ``seq``
    (fp32 cache; ``ref``, its (1, len(seq), vocab) logits where the caller
    has them).  Returns (max |dlogits|, number of compared steps)."""
    dev = params["embed"].device
    pool = BlockPool(layout)
    slot = pool.admit(plen)
    cache = lm.init_paged_cache(layout, dtype=torch.float32, device=dev)

    def table():
        return torch.from_numpy(pool.block_table[slot][None].copy()).to(dev)

    toks = torch.from_numpy(seq.astype(np.int64)).to(dev)
    logits, cache = lm.prefill_paged(params, {"tokens": toks[None, :plen]}, cache,
                                     table(), torch.tensor([plen], device=dev))
    if ref is None:
        ref, _, _ = lm.forward(params, {"tokens": toks[None]})
    errs = [(logits[0] - ref[0, plen - 1]).abs().max()]
    for i in range(len(seq) - plen):
        pool.extend(slot, 1)
        logits, cache = lm.decode_step_paged(
            params, cache, table(), torch.tensor([plen + i], device=dev),
            {"tokens": toks[None, plen + i:plen + i + 1]})
        errs.append((logits[0] - ref[0, plen + i]).abs().max())
    return float(torch.stack(errs).max()), len(errs)


def _with_dispatch(arch, dispatch: Optional[str]):
    """``arch`` with its MoE layers under ``dispatch``; a dense arch (or no
    dispatch) as it is."""
    if arch.moe is None or dispatch is None or dispatch == arch.moe.dispatch:
        return arch
    return arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))


def _span_seconds(engine: Engine, name: str) -> List[float]:
    return [ev["dur"] for ev in engine.trace_ring.events()
            if ev["kind"] == "span" and ev["name"] == name]


@dataclasses.dataclass
class ParityCase:
    """What the decode parity probe replays: a served sequence, its prompt
    length and the serving run's model, layout, device and weight seed."""

    arch: ArchConfig
    layout: PagedLayout
    seq: np.ndarray
    plen: int
    device: torch.device
    seed: int


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="weights and KV cache of the serving run")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-min", type=int, default=3)
    ap.add_argument("--prompt-max", type=int, default=32)
    ap.add_argument("--chips", type=int, default=16,
                    help="fleet size for the production planner report")
    ap.add_argument("--slo-ms", type=float, default=20.0,
                    help="per-token decode latency SLO for the planner")
    ap.add_argument("--context", type=int, default=2048, help="planner mean live context")
    ap.add_argument("--prefill-len", type=int, default=1024,
                    help="planner mean prompt length")
    ap.add_argument("--dispatch", default=None, choices=DISPATCH_MODES,
                    help="MoE expert dispatch; default: the serving planner's choice")
    ap.add_argument("--max-seqs", type=int, default=4,
                    help="the engine's decode width cap")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine's telemetry as JSONL here, a Chrome "
                         "trace to <path>.trace.json, and print a decode and "
                         "prefill drift report at the end of the run")
    ranks.add_args(ap)
    return ap.parse_args(argv)


def plan(args: argparse.Namespace, say=print
         ) -> Tuple[Optional[planner.ServingStrategy], int]:
    """Print the serving planner's strategy for ``args.arch`` on
    ``PLATFORM``; returns (the strategy or None, the engine's max_seqs:
    the strategy's batch capped by ``--max-seqs``)."""
    best = planner.best_serving_strategy(
        get_arch(args.arch), PLATFORM, args.chips, context=args.context,
        prefill_len=args.prefill_len, slo_ms=args.slo_ms)
    where = f"@{args.chips}x{PLATFORM.name} under {args.slo_ms:.0f}ms/token SLO"
    if best is None:
        say(f"[planner] no feasible serving strategy for {args.arch} {where}")
        return None, args.max_seqs
    say(f"[planner] serving strategy for {args.arch} {where}:")
    say("          " + best.describe())
    return best, max(1, min(best.batch, args.max_seqs))


def _weights(arch, device, seed: int, dtype: str):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(arch, gen, device, getattr(torch, dtype))


def serve(args: argparse.Namespace) -> Tuple[Dict, ParityCase]:
    """Serve the seeded requests; returns the run's summary and request 0's
    sequence for the parity probe."""
    say = print if ranks.rank() == 0 else (lambda *a, **k: None)
    best, max_seqs = plan(args, say)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    arch = _with_dispatch(arch, args.dispatch or (best.dispatch if best else None))
    source = "--dispatch" if args.dispatch else "the planner's choice" if best else "the arch's"
    kind = f"moe dispatch {arch.moe.dispatch} ({source})" if arch.moe else "dense"
    model = ranks.mesh_of(args, ranks.world_size())[-1]
    try:
        check_ep(sharding.choose_ep(arch.moe.num_experts if arch.moe else model, model))
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from None
    device, mesh = ranks.init(args, arch)
    say(mesh.describe())
    say(f"[serve] {arch.name} on {device}: {kind}, {args.dtype} weights and cache")

    lm = LanguageModel(arch, mesh)
    max_total = args.prompt_max + args.max_new
    cfg = ServeConfig(
        max_seqs=max_seqs, block_size=args.block_size,
        num_blocks=args.num_blocks,
        max_blocks_per_seq=max(-(-max_total // args.block_size), 4),
        prefill_tokens_per_step=max(512, args.prompt_max),
        cache_dtype=args.dtype,
    )
    say(f"[engine] max_seqs={cfg.max_seqs} block_size={cfg.block_size} "
        f"num_blocks={cfg.num_blocks}")

    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(args.prompt_min, args.prompt_max + 1, size=args.requests)
    reqs = [Request(rid=i, tokens=rng.integers(0, arch.vocab_size, size=int(n)),
                    max_new_tokens=args.max_new)
            for i, n in enumerate(lengths)]
    engine = Engine(lm, shard_params(_weights(arch, device, args.seed, args.dtype), mesh),
                    cfg)
    if args.metrics_out and mesh.rank == 0:
        engine.telemetry.sinks.append(obs.JsonlSink(args.metrics_out))
    t0 = time.perf_counter()
    out = engine.run(reqs)
    wall = time.perf_counter() - t0
    decode_s = _span_seconds(engine, "engine.decode")
    prefill_s = _span_seconds(engine, "engine.prefill")
    n_preempt = sum(1 for e in engine.trace if e[0] == "preempt")
    summary = {
        "arch": arch.name, **({"dispatch": arch.moe.dispatch} if arch.moe else {}),
        "max_seqs": cfg.max_seqs,
        "device": str(device), "world": mesh.world, "ep": mesh.ep, "outputs": out,
        "finished": len(out), "requests": len(reqs), "steps": engine.step_no,
        "wall_s": wall, "decode_steps": engine.decode_steps,
        "decode_tokens": engine.decoded_tokens,
        "decode_tok_s": engine.decoded_tokens / max(sum(decode_s), 1e-12),
        "decode_step_p50_ms": 1e3 * float(np.median(decode_s)) if decode_s else None,
        "prefill_ms_mean": 1e3 * float(np.mean(prefill_s)) if prefill_s else None,
        "prefill_tokens": int(lengths.sum()), "preemptions": n_preempt,
    }
    say(f"[serve] {len(out)}/{len(reqs)} requests finished in {engine.step_no} "
        f"steps ({wall:.2f}s wall); {engine.decoded_tokens} decode tokens over "
        f"{engine.decode_steps} decode steps, {n_preempt} preemptions")
    for rid in sorted(out)[:4]:
        say(f"  req {rid} (prompt {lengths[rid]}): {out[rid][:12]}")
    if args.metrics_out and mesh.rank == 0:
        summary.update(_telemetry_reports(args, arch, engine, device))
    req = reqs[0]
    seq = np.concatenate([req.tokens, out[req.rid][:-1]]).astype(np.int32)
    return summary, ParityCase(arch, cfg.layout(), seq, int(req.tokens.size),
                               device, args.seed)


def _telemetry_reports(args, arch, engine, device) -> Dict:
    """Decode and prefill drift against the serving model of the engine's
    batch width at the planner's context and prompt length, priced on
    ``PLATFORM``, and the Chrome trace of the engine's events."""
    events = engine.trace_ring.events()
    setup = rm.ServeSetup(batch=engine.cfg.max_seqs, context=args.context,
                          prefill_len=args.prefill_len,
                          **({"dispatch": arch.moe.dispatch} if arch.moe else {}))
    se = rm.serve_estimate(rm.ModelShape.from_arch(arch), setup, PLATFORM)
    tracker = obs.DriftTracker(rm.modeled_serve_phases(se))
    n = tracker.observe_events(events)
    print(tracker.format_report(
        f"drift {arch.name} serving: measured on {device} vs the "
        f"{PLATFORM.name} model"))
    trace_path = args.metrics_out + ".trace.json"
    obs.write_chrome_trace(trace_path, events, process_name=f"serve {arch.name}")
    print(f"[obs] {len(events)} events ({n} drift spans) -> {args.metrics_out}; "
          f"chrome trace: {trace_path}")
    engine.telemetry.close()
    return {"drift": tracker.report(), "trace": trace_path}


def decode_parity(case: ParityCase, modes: Sequence[str]) -> Dict[str, float]:
    """Replay ``case`` under each dispatch in ``modes`` (for a dense arch
    the one mode "dense") with fp32 weights (the serving run's seed) and an
    fp32 cache; returns max |dlogits| per mode."""
    params = _weights(case.arch, case.device, case.seed, "float32")
    errs = {}
    for mode in modes:
        arch = _with_dispatch(case.arch, None if mode == "dense" else mode)
        err, n = parity_probe(LanguageModel(arch), params, case.layout, case.seq, case.plen)
        print(f"[parity] paged {mode} decode vs uncached forward: max |dlogits| "
              f"= {err:.3e} over {n} steps")
        errs[mode] = err
    return errs


def parity_modes(arch: ArchConfig) -> List[str]:
    """The probe's modes: the served dispatch, then ragged (the gated one)
    where that is not it; "dense" alone for a dense arch."""
    if arch.moe is None:
        return ["dense"]
    dispatch = arch.moe.dispatch
    return [dispatch] + (["ragged"] if dispatch != "ragged" else [])


def main(argv: Optional[List[str]] = None) -> Dict:
    summary, case = serve(parse_args(argv))
    if summary["world"] > 1:
        return summary
    modes = parity_modes(case.arch)
    for mode, err in decode_parity(case, modes).items():
        summary[f"parity_{mode}"] = err
    gated = modes[-1]  # ragged, or dense: no dispatch recomputes or drops a row
    if summary[f"parity_{gated}"] > PARITY_BOUND:
        raise AssertionError(f"{gated} decode parity violated: "
                             f"{summary[f'parity_{gated}']:.3e} > {PARITY_BOUND}")
    print(f"[parity] {gated} OK (<= {PARITY_BOUND:g})")
    return summary


if __name__ == "__main__":
    try:
        main()
    finally:
        ranks.shutdown()
