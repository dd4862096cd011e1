"""Strategy planner: enumerate, validate (Eq 7–11) and rank (Eq 12) hybrid
parallelization strategies — the paper's §III-C / §IV-C.

The port's copy of ``repro.core.planner`` (``tests/test_torch_planner.py``
holds its ranked strategies equal to the reference's).  The port's
launchers print the production strategy and bind what one device can
execute: the expert dispatch, the serving batch width and the
checkpoint interval.

The planner is the piece that makes Piper "platform-aware": given an
architecture, a token budget per step and a platform description, it emits
the (PP, EP, DP, memory-policy) configurations that fit, ranked by the MFU
estimator, and can bind the winner to a concrete MeshPlan for the executor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Iterable, List, Optional, Tuple

from repro_torch.configs.base import (
    A2A_ALGOS,
    A2A_CHUNK_CANDIDATES,
    ArchConfig,
    DEFAULT_A2A,
    DEFAULT_DISPATCH,
    DEFAULT_SCHEDULE,
    DISPATCH_MODES,
    SCHEDULES,
)
from repro_torch.core import comm_model as cm
from repro_torch.core import resource_model as rm
from repro_torch.core.platform import Platform


@dataclass(frozen=True)
class Strategy:
    PP: int
    EP: int
    DP: int
    alpha: int  # microbatch multiplier (M = alpha * PP)
    schedule: str  # pipeline schedule bound into the executor (Eq 3/4 memory)
    checkpoint_activations: bool
    bytes_per_param: int  # 16 = fp32 master+moments; 10 = bf16 moments
    estimate: rm.Estimate
    # Expert dispatch mode (capacity padding tax vs ragged sort overhead) —
    # ranked per config like the pipeline schedule.
    dispatch: str = DEFAULT_DISPATCH
    # Virtual stages per pipeline stage (interleaved_1f1b only): buys a
    # 1/V bubble for ~2× Eq-4 residual memory and V× p2p volume.
    vstages: int = 1
    # EP all-to-all algorithm (flat vs HALO hierarchical) and chunk depth
    # of the double-buffered dispatch/combine overlap — ranked per config
    # like the schedule and dispatch mode.
    a2a_algo: str = DEFAULT_A2A
    a2a_chunks: int = 1

    @property
    def world(self) -> int:
        return self.PP * self.EP * self.DP

    def describe(self) -> str:
        e = self.estimate
        sched = (
            f"{self.schedule}@V{self.vstages}"
            if self.vstages > 1
            else self.schedule
        )
        return (
            f"PP={self.PP:<3d} EP={self.EP:<3d} DP={self.DP:<3d} "
            f"alpha={self.alpha} sched={sched:<5s} "
            f"disp={self.dispatch:<8s} "
            f"a2a={self.a2a_algo}x{self.a2a_chunks} "
            f"ckpt={int(self.checkpoint_activations)} "
            f"Bp={self.bytes_per_param:<2d} "
            f"mem0={e.mem_stage0/1e9:7.1f}GB mfu={e.mfu*100:5.1f}% "
            f"t_step={e.t_step*1e3:8.1f}ms "
            f"(comp={e.t_compute*1e3:.1f} a2a={e.t_a2a*1e3:.1f} "
            f"a2a_exp={e.t_a2a_exposed*1e3:.1f} "
            f"p2p={e.t_p2p*1e3:.1f} "
            f"p2p_exp={e.t_p2p_exposed*1e3:.1f} "
            f"dp={e.t_dp_grad*1e3:.1f} "
            f"disp={e.t_dispatch*1e3:.1f} drop={e.drop_rate:.2f} "
            f"bubble={e.bubble_fraction:.2f}) "
            f"ckpt@{e.ckpt_every_steps}st goodput={e.goodput_factor*100:.2f}% "
            f"mfu_eff={e.mfu_effective*100:5.1f}%"
            + (
                f" migrate={e.t_migrate*1e3:.1f}ms"
                f"->imb={e.imbalance_post:.2f}"
                f" gain={e.migrate_gain_per_step*1e3:.1f}ms/st"
                if e.imbalance_post
                else ""
            )
        )


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _schedule_candidates(
    arch: ArchConfig, PP: int
) -> List[Tuple[str, int]]:
    """(schedule, vstages) pairs to enumerate for a PP-way pipeline.

    The flat schedules run at V=1; ``interleaved_1f1b`` is tried at the
    paper-relevant depths V ∈ {2, reps-per-stage}.  V must divide the
    BLOCK-PATTERN reps per stage — the executor's chunk unit
    (``pipeline._stage_block_params`` asserts ``reps % (PP*V) == 0``), not
    raw layers, which overcounts by the pattern period on hybrid archs.
    V=1 is skipped — it is bit-for-bit the plain 1f1b table."""
    if PP <= 1:
        return [(DEFAULT_SCHEDULE, 1)]
    out: List[Tuple[str, int]] = []
    reps = arch.num_layers // max(len(arch.block_pattern), 1)
    rps = reps // PP if reps % PP == 0 else 0  # pattern-reps per stage
    for schedule in SCHEDULES:
        if schedule == "interleaved_1f1b":
            out += [
                (schedule, V)
                for V in sorted({2, rps})
                if V > 1 and rps and rps % V == 0
            ]
        else:
            out.append((schedule, 1))
    return out


def valid_strategies(
    arch: ArchConfig,
    platform: Platform,
    total_chips: int,
    *,
    batch: int,
    seq: int,
    alphas: Iterable[int] = (1, 2, 4, 8),
    overlap_fraction: float = 0.0,
    zero: str = "dp",
    imbalance: float = 1.0,
    imbalance_post: Optional[float] = None,
) -> List[Strategy]:
    """All (PP, EP, DP, policy) tuples satisfying the paper's constraints:

    Eq 7:  PP * EP * DP == total chips
    Eq 8:  EP | E
    Eq 9:  PP <= L (>= 1 layer per stage)
    Eq 10: EP <= fast-interconnect domain
    Eq 11: stage-0 schedule peak (Eq 3 GPipe / Eq 4 1F1B) <= HBM
    """
    shape = rm.ModelShape.from_arch(arch)
    E = shape.E if shape.E else 1
    out: List[Strategy] = []
    for PP in _divisors(total_chips):
        if PP > arch.num_layers or arch.num_layers % PP:
            continue
        rest = total_chips // PP
        for EP in _divisors(rest):
            if E % EP:  # Eq 8
                continue
            if EP > platform.fast_domain:  # Eq 10
                continue
            DP = rest // EP
            # Schedules differ in executed memory profile (Eq 3 vs 4 vs the
            # interleaved analogue) and, for interleaving, in bubble; a PP=1
            # "pipeline" is degenerate, keep the single default entry.
            schedules = _schedule_candidates(arch, PP)
            # MoE archs rank both dispatch modes (capacity padding tax +
            # drops vs ragged sort overhead); dense archs have no dispatch.
            dispatches = DISPATCH_MODES if shape.E else (DEFAULT_DISPATCH,)
            # a2a algorithm x chunk depth: only meaningful when an EP
            # dispatch exists.  The comm model gates the hierarchical
            # candidate — inside a single node HALO's extra phase only adds
            # latency (speedup < 1), so it is pruned there; chunk depths
            # are always ranked (the estimate prices the latency tax, so
            # oversized K loses on MFU, not by fiat).
            if shape.E and EP > 1:
                tokens = batch * seq * shape.k / (EP * DP)
                probe = cm.A2ACase(
                    n_ranks=EP, row_bytes=2.0 * tokens * shape.d_model / EP
                )
                # halo inside one node is the flat collective plus extra
                # latency (the model prices them identically) — only keep
                # it where the hierarchy strictly wins.
                algos = [
                    a
                    for a in A2A_ALGOS
                    if a == "flat" or cm.speedup(probe, platform) > 1.0
                ]
                a2a_opts = [
                    (a, K) for a in algos for K in A2A_CHUNK_CANDIDATES
                ]
            else:
                a2a_opts = [(DEFAULT_A2A, 1)]
            for alpha in alphas:
                M = alpha * PP
                if batch % (DP * M) or batch // (DP * M) == 0:
                    continue
                for schedule, vstages in schedules:
                    for dispatch in dispatches:
                        for a2a_algo, a2a_chunks in a2a_opts:
                            for ckpt in (False, True):
                                # 16 B/param = paper's fp16+fp32-master
                                # policy; 12 B = our executor (fp32
                                # master+moments, transient bf16 compute
                                # copies); 8 B = bf16 moments fallback.
                                for bpp in (16, 12, 8):
                                    t = rm.TrainSetup(
                                        b=batch,
                                        s=seq,
                                        PP=PP,
                                        EP=EP,
                                        DP=DP,
                                        alpha=alpha,
                                        schedule=schedule,
                                        vstages=vstages,
                                        checkpoint_activations=ckpt,
                                        bytes_per_param=bpp,
                                        zero=zero,
                                        imbalance=imbalance,
                                        dispatch=dispatch,
                                        a2a_algo=a2a_algo,
                                        a2a_chunks=a2a_chunks,
                                    )
                                    est = rm.estimate(
                                        shape, t, platform,
                                        overlap_fraction=overlap_fraction,
                                        imbalance_post=imbalance_post,
                                    )
                                    if not est.mem_ok:  # Eq 11
                                        continue
                                    out.append(
                                        Strategy(PP, EP, DP, alpha,
                                                 schedule, ckpt, bpp, est,
                                                 dispatch=dispatch,
                                                 vstages=vstages,
                                                 a2a_algo=a2a_algo,
                                                 a2a_chunks=a2a_chunks)
                                    )
                                    break  # cheapest fitting policy wins
                                else:
                                    continue
                                break
    return out


def rank_strategies(strategies: List[Strategy]) -> List[Strategy]:
    """Rank by estimated MFU; among MFU ties (e.g. GPipe vs 1F1B of the same
    partition — identical bubble, different residency) prefer the lower
    drop rate (dropless ragged beats capacity at equal speed — dropped
    tokens are silent quality loss, not time), then the smaller stage-0
    peak, which is how 1F1B wins whenever both fit; among configs whose
    a2a exposure also ties (e.g. a compute-dominated step where every
    chunk depth fully hides), prefer fewer chunks and the flat collective
    — the simpler executor path at equal estimated speed."""
    return sorted(
        strategies,
        key=lambda s: (
            -s.estimate.mfu,
            s.estimate.drop_rate,
            s.estimate.mem_stage0,
            s.a2a_chunks,
            s.a2a_algo != DEFAULT_A2A,
        ),
    )


def best_strategy(
    arch: ArchConfig,
    platform: Platform,
    total_chips: int,
    *,
    batch: int,
    seq: int,
    **kw,
) -> Optional[Strategy]:
    cands = rank_strategies(
        valid_strategies(
            arch, platform, total_chips, batch=batch, seq=seq, **kw
        )
    )
    return cands[0] if cands else None


# ---------------------------------------------------------------------------
# Serving strategies (SLO-aware)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingStrategy:
    """One serving configuration: replica geometry (EP x TP), replica
    count, continuous-batching width and dispatch mode, with its
    :class:`resource_model.ServeEstimate`."""

    EP: int
    TP: int
    DP: int  # independent replicas splitting the traffic
    batch: int  # decode width per replica
    dispatch: str
    estimate: rm.ServeEstimate

    @property
    def world(self) -> int:
        return self.EP * self.TP * self.DP

    def describe(self) -> str:
        e = self.estimate
        return (
            f"EP={self.EP:<3d} TP={self.TP:<2d} DP={self.DP:<3d} "
            f"batch={self.batch:<4d} disp={self.dispatch:<8s} "
            f"tok/s/chip={e.tokens_per_s_per_chip:8.1f} "
            f"t_decode={e.t_decode*1e3:7.2f}ms "
            f"ttft={e.ttft*1e3:6.1f}ms "
            f"mem={e.mem_per_chip/1e9:5.1f}GB "
            f"(w={e.t_weights*1e3:.2f} kv={e.t_kv*1e3:.2f} "
            f"comp={e.t_compute*1e3:.2f} comm={e.t_comm*1e3:.2f} "
            f"drop={e.drop_rate:.2f})"
        )


def valid_serving_strategies(
    arch: ArchConfig,
    platform: Platform,
    total_chips: int,
    *,
    context: int,
    prefill_len: int,
    batches: Iterable[int] = (1, 4, 16, 64, 256),
    slo_ms: Optional[float] = None,
    ttft_slo_ms: Optional[float] = None,
    imbalance: float = 1.0,
) -> List[ServingStrategy]:
    """Enumerate (EP, TP, DP, batch, dispatch) serving configurations.

    Constraints (the training planner's Eq 7–11 recast for decode):

    * EP * TP * DP == total chips (replicas tile the fleet);
    * EP | E and EP <= fast-domain (Eq 8 / Eq 10 — the decode combine is a
      psum over "ep");
    * weights + KV pool fit per chip (Eq-11 analogue);
    * ``slo_ms``: per-token decode latency SLO — strategies whose
      estimated t_decode exceeds it are infeasible, which is how latency
      budget turns into a max usable batch;
    * ``ttft_slo_ms``: optional prefill (time-to-first-token) SLO.
    """
    shape = rm.ModelShape.from_arch(arch)
    E = shape.E if shape.E else 1
    dispatches = DISPATCH_MODES if shape.E else (DEFAULT_DISPATCH,)
    out: List[ServingStrategy] = []
    # Dense archs coerce E to 1 above, so E % EP already rejects EP > 1
    # (no expert axis to shard).
    for EP in _divisors(total_chips):
        if E % EP or EP > platform.fast_domain:
            continue
        rest = total_chips // EP
        for TP in _divisors(rest):
            DP = rest // TP
            for batch in batches:
                for dispatch in dispatches:
                    s = rm.ServeSetup(
                        batch=batch,
                        context=context,
                        prefill_len=prefill_len,
                        EP=EP,
                        TP=TP,
                        DP=DP,
                        dispatch=dispatch,
                        imbalance=imbalance,
                    )
                    est = rm.serve_estimate(shape, s, platform)
                    if not est.mem_ok:
                        continue
                    if slo_ms is not None and est.t_decode * 1e3 > slo_ms:
                        continue
                    if (
                        ttft_slo_ms is not None
                        and est.ttft * 1e3 > ttft_slo_ms
                    ):
                        continue
                    out.append(
                        ServingStrategy(EP, TP, DP, batch, dispatch, est)
                    )
    return out


def rank_serving_strategies(
    strategies: List[ServingStrategy],
) -> List[ServingStrategy]:
    """Goodput-first ranking under the SLO: maximize decode tokens/s per
    chip; among throughput ties prefer the lower drop rate (capacity
    drops are silent quality loss), then the lower per-token latency,
    then dropless dispatch (exact estimate ties at imbalance=1)."""
    return sorted(
        strategies,
        key=lambda s: (
            -s.estimate.tokens_per_s_per_chip,
            s.estimate.drop_rate,
            s.estimate.t_decode,
            s.dispatch != "ragged",
        ),
    )


def best_serving_strategy(
    arch: ArchConfig,
    platform: Platform,
    total_chips: int,
    *,
    context: int,
    prefill_len: int,
    **kw,
) -> Optional[ServingStrategy]:
    cands = rank_serving_strategies(
        valid_serving_strategies(
            arch, platform, total_chips,
            context=context, prefill_len=prefill_len, **kw,
        )
    )
    return cands[0] if cands else None


def min_chips(
    arch: ArchConfig,
    platform: Platform,
    *,
    batch: int,
    seq: int,
    chip_counts: Iterable[int],
) -> Optional[int]:
    """Smallest chip count with any feasible strategy — reproduces the
    paper's Fig 10 '615B trainable from 64 nodes' analysis."""
    for n in sorted(chip_counts):
        if valid_strategies(arch, platform, n, batch=batch, seq=seq):
            return n
    return None


def choose_memory_policy(arch: ArchConfig, kind: str, chips: int,
                         platform: Platform) -> Tuple[str, str]:
    """The reference dry run's memory policy (``repro.launch.dryrun
    .choose_memory_policy``) priced on ``platform``'s HBM: bf16 Adam
    moments when the fp32 state (12 B a parameter: master, m, v) spread
    over ``chips`` passes 0.8 of a chip's HBM, else fp32; remat "full" to
    ``kind`` "train", "none" to serving.  Returns (optimizer_dtype,
    remat)."""
    opt_dtype = "float32"
    if arch.total_params() * 12 / chips > 0.8 * platform.hbm_bytes:
        opt_dtype = "bfloat16"  # 8 B a parameter of persistent state
    return opt_dtype, "full" if kind == "train" else "none"
