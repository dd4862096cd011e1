"""Analytical resource model for MoE training (paper §III-A, Eq 1–6).

The port's copy of ``repro.core.resource_model``, changed in nothing
that moves a number (``tests/test_torch_planner.py`` holds every field of
``estimate`` and ``serve_estimate`` equal to the reference's).  The
executor knobs it prices are the reference's; the port runs PP = EP = DP
= 1 today.

Implements the paper's memory / compute / communication formulas in its own
Table II notation, parameterized by platform constants, and extends them
with the knobs our executor actually has (bytes-per-parameter policy, flash
attention, activation checkpointing) so the planner can search them.

All memory quantities are **bytes**; all times are **seconds**.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import (
    A2A_ALGOS,
    ArchConfig,
    DEFAULT_A2A,
    DEFAULT_DISPATCH,
    DEFAULT_SCHEDULE,
    DISPATCH_MODES,
    SCHEDULES,
)
from repro_torch.core import comm_model as cm
from repro_torch.core.platform import Platform

# Row-tile granularity of the ragged grouped-GEMM kernel
# (kernels/moe_gemm bm): the only padding the ragged dispatch pays is the
# masked tile tails, < bm rows per occupied expert.
RAGGED_TILE_ROWS = 128


@dataclass(frozen=True)
class ModelShape:
    """Paper Table II symbols."""

    d_model: int
    L: int  # total layers
    L_moe: int  # MoE layers (L - L_moe dense)
    H: int  # attention heads
    d_h: int  # per-head dim
    E: int  # routed experts per MoE layer
    E_s: int  # shared experts
    k: int  # top-k
    n_mat: int  # FFN weight matrices (3 = SwiGLU)
    d_ffn_moe: int
    d_ffn_dense: int
    vocab: int
    n_attn: int = -1  # attention mixers (SSM archs have fewer); -1 -> L
    cf: float = 1.25  # capacity factor (prices the padding-FLOPs tax)
    H_kv: int = -1  # KV heads (GQA) — sizes the serving KV-cache; -1 -> H

    def __post_init__(self):
        if self.n_attn < 0:
            object.__setattr__(self, "n_attn", self.L)
        if self.H_kv < 0:
            object.__setattr__(self, "H_kv", self.H)

    @classmethod
    def from_arch(cls, a: ArchConfig) -> "ModelShape":
        return cls(
            d_model=a.d_model,
            L=a.num_layers,
            L_moe=a.num_moe_layers,
            H=a.num_heads,
            d_h=a.head_dim,
            E=a.moe.num_experts if a.moe else 0,
            E_s=a.moe.num_shared_experts if a.moe else 0,
            k=a.moe.top_k if a.moe else 0,
            n_mat=a.n_mat,
            d_ffn_moe=a.moe.d_ff if a.moe else 0,
            d_ffn_dense=a.d_ff,
            vocab=a.vocab_size,
            n_attn=a.num_attn_layers,
            cf=a.moe.capacity_factor if a.moe else 1.25,
            H_kv=a.num_kv_heads,
        )

    # -- parameter counts (paper Table III) ---------------------------------

    @property
    def attn_params_per_layer(self) -> int:
        # Paper uses 4 d^2 (MHA); with GQA it is d*(H*dh) + 2*d*(Hkv*dh) +
        # (H*dh)*d.  We keep the paper's 4d^2 for fidelity when H*dh == d.
        return 4 * self.d_model * self.d_model

    @property
    def expert_params(self) -> int:
        return self.n_mat * self.d_model * self.d_ffn_moe

    @property
    def dense_ffn_params(self) -> int:
        return self.n_mat * self.d_model * self.d_ffn_dense

    def total_params(self) -> int:
        moe = self.L_moe * (self.E + self.E_s) * self.expert_params
        dense = (self.L - self.L_moe) * self.dense_ffn_params
        attn = self.n_attn * self.attn_params_per_layer
        embed = 2 * self.vocab * self.d_model
        return moe + dense + attn + embed

    def active_params(self) -> int:
        moe = self.L_moe * (self.k + self.E_s) * self.expert_params
        dense = (self.L - self.L_moe) * self.dense_ffn_params
        attn = self.n_attn * self.attn_params_per_layer
        embed = 2 * self.vocab * self.d_model
        return moe + dense + attn + embed


@dataclass(frozen=True)
class TrainSetup:
    """Paper Table II run parameters."""

    b: int  # global batch (sequences)
    s: int  # sequence length
    PP: int = 1
    EP: int = 1
    DP: int = 1  # external data parallelism (replica groups)
    alpha: int = 4  # microbatch multiplier: M = alpha * PP
    # Pipeline schedule: picks the peak-memory formula (Eq 3 for GPipe's
    # all-M-in-flight profile, Eq 4 for 1F1B's PP-i, the interleaved
    # Eq-4-analogue for vstages > 1) and is bound into the executor by the
    # planner.
    schedule: str = DEFAULT_SCHEDULE
    # Virtual stages per pipeline stage (interleaved_1f1b only): V× more
    # residual slots and V× more p2p hand-offs buy a 1/V bubble.
    vstages: int = 1
    bytes_per_param: int = 16  # paper §III-A1 (fp16 + fp32 master + Adam)
    bytes_act: int = 2  # activation dtype
    flash_attention: bool = True  # 4bHs^2 -> 2bHs (paper)
    checkpoint_activations: bool = False  # store only layer inputs
    framework_overhead: float = 2e9  # M_fw: RCCL/XLA buffers etc.
    # ZeRO sharding of static state: "none" | "dp" (paper/DeepSpeed: over
    # data-parallel ranks) | "world" (our GSPMD executor: fully 2-D sharded
    # over every mesh axis)
    zero: str = "dp"
    # Calibration (paper §VI: skewed routing keeps GPUs underutilized; Fig 9)
    imbalance: float = 1.0  # expert-compute inflation from load skew
    step_overhead: float = 0.0  # fixed per-step host/dataloader seconds
    # Expert dispatch mode (repro.models.moe): "capacity" pays the cf
    # padding-FLOPs tax and drops overflow under skew; "ragged" pays the
    # sort + tile-metadata overhead but multiplies no zeros and drops
    # nothing.
    dispatch: str = DEFAULT_DISPATCH
    # EP all-to-all algorithm ("flat" collective vs HALO hierarchical) and
    # chunk depth of the double-buffered dispatch/combine overlap
    # (models.moe / halo.overlapped_a2a).  The defaults reproduce the
    # serial Eq-6 pricing exactly.
    a2a_algo: str = DEFAULT_A2A
    a2a_chunks: int = 1
    # Hot-expert replica channels currently live (models.moe max_replicas
    # slots holding an expert id): each channel's weights are psum-selected
    # over the EP groups at use time — forward broadcast plus the grad-sum
    # transpose — so replicas trade per-step broadcast bytes for balance.
    replicas: int = 0

    def __post_init__(self):
        assert self.a2a_algo in A2A_ALGOS, self.a2a_algo
        assert self.a2a_chunks >= 1, self.a2a_chunks
        # Mirror MeshPlan: a V>1 depth belongs to the interleaved schedule
        # only — rejecting the combo here keeps every consumer (memory,
        # bubble, p2p) consistent without per-site guards.
        assert self.vstages >= 1, self.vstages
        assert self.vstages == 1 or self.schedule == "interleaved_1f1b", (
            f"vstages={self.vstages} needs schedule='interleaved_1f1b', "
            f"got {self.schedule!r}"
        )

    @property
    def M(self) -> int:
        return self.alpha * self.PP

    @property
    def b_mu(self) -> int:
        return max(self.b // self.M, 1)

    @property
    def P(self) -> int:
        return self.PP * self.EP * self.DP


# ---------------------------------------------------------------------------
# Dispatch-mode costs (capacity padding tax vs ragged sort overhead)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DispatchCosts:
    """What an expert-dispatch mode costs on top of the routed math.

    flops_factor — issued / useful routed-expert FLOPs (capacity multiplies
    zeros up to cf; ragged only pays the masked tile tails).
    drop_rate — expected fraction of routed assignments dropped (capacity
    overflow under skew; ragged is dropless).
    act_factor — expert activation-buffer inflation ((E, C, d) padding vs
    the exact sorted rows).
    bytes_per_layer — per-rank dispatch bookkeeping HBM traffic per MoE
    layer per step (one-hot-cumsum position matrix vs argsort + permute).
    counts_bytes_per_layer — wire bytes of the ragged path's
    counts-exchange pre-pass: one (EP, E/EP) int32 all_to_all before the
    payload a2a (fwd + the same pair on the backward), which carries the
    receiver-side segment structure so the per-row id sideband is never
    shipped.  Zero for capacity mode (slot layout is static).
    """

    flops_factor: float
    drop_rate: float
    act_factor: float
    bytes_per_layer: float
    counts_bytes_per_layer: float = 0.0


def dispatch_costs(m: ModelShape, t: TrainSetup) -> DispatchCosts:
    assert t.dispatch in DISPATCH_MODES, t.dispatch
    if m.E == 0:
        return DispatchCosts(1.0, 0.0, 1.0, 0.0)
    # Routed rows handled per rank per step (all microbatches).
    rows = t.b * t.s * m.k / (t.DP * t.EP)
    if t.dispatch == "capacity":
        # The (E, C, d) buffer holds cf x the routed rows; every padded row
        # is multiplied through all three GEMMs.  Overflow beyond C drops:
        # with load skew `imbalance` (max/mean expert load) the hottest
        # experts overflow once imbalance > cf.
        return DispatchCosts(
            flops_factor=m.cf,
            drop_rate=max(0.0, 1.0 - m.cf / max(t.imbalance, 1e-9)),
            act_factor=m.cf,
            # one-hot (rows x E) int32 position matrix: materialize,
            # cumsum, gather (~3 passes).
            bytes_per_layer=3.0 * rows * m.E * 4.0,
        )
    # Ragged: the only padding is the masked tail of each expert's last
    # row tile (< bm rows per occupied expert, straddle revisits included).
    # Each rank runs the ragged GEMM over its E/EP local experts.
    experts_local = max(m.E / t.EP, 1.0)
    waste = min(
        1.0, experts_local * RAGGED_TILE_ROWS / (2.0 * max(rows, 1.0))
    )
    return DispatchCosts(
        flops_factor=1.0 + waste,
        drop_rate=0.0,
        act_factor=1.0,
        # argsort passes over (key, payload-index) pairs + the gather/
        # scatter permutation of the row payload itself.
        bytes_per_layer=(
            rows * 8.0 * max(math.log2(max(rows, 2.0)), 1.0)
            + 2.0 * rows * m.d_model * t.bytes_act
        ),
        # Counts-exchange pre-pass (EP only): (EP, E/EP) int32 per
        # direction, send+recv, fwd+bwd — four tiny messages that replace
        # a per-row int32 id sideband of the payload a2a.
        counts_bytes_per_layer=(
            4.0 * t.EP * experts_local * 4.0 if t.EP > 1 else 0.0
        ),
    )


# ---------------------------------------------------------------------------
# Memory (Eq 1–5)
# ---------------------------------------------------------------------------


def _attn_act_per_layer(m: ModelShape, t: TrainSetup, b: int) -> float:
    """Paper Table III attention activations: 12 b s d + 4 H b s^2
    (flash: quadratic term drops to 2 b H s)."""
    lin = 12 * b * t.s * m.d_model
    quad = 2 * b * m.H * t.s if t.flash_attention else 4 * m.H * b * t.s * t.s
    return t.bytes_act / 2 * (lin + quad)  # Table III is already in bytes@2B


def _expert_act_per_layer(m: ModelShape, t: TrainSetup, b: int, EP: int) -> float:
    """Paper: 2 * bsk/EP * (3 d_ffn + d_model) bytes — scaled by the
    dispatch mode's buffer inflation (capacity holds cf x the routed rows
    as zero padding; ragged holds exactly the sorted rows)."""
    if m.E == 0:
        # dense FFN activations: up+gate+down inputs ~ (2*n_mat-? ) use
        # bytes_act * b*s*(n_mat*d_ffn + d_model)
        return t.bytes_act * b * t.s * (m.n_mat * m.d_ffn_dense + m.d_model)
    act_factor = dispatch_costs(m, t).act_factor
    return t.bytes_act * (b * t.s * m.k / EP) * act_factor * (
        m.n_mat * m.d_ffn_moe + m.d_model
    )


def _static_layer_bytes(m: ModelShape, t: TrainSetup, EP: int) -> float:
    """Per-GPU static bytes for ONE layer under expert-data parallelism:
    replicated attention + E/EP experts (paper Eq 2 static part)."""
    attn = t.bytes_per_param * m.attn_params_per_layer
    if m.E:
        experts = t.bytes_per_param * (
            (m.E / EP + m.E_s) * m.expert_params
        )
    else:
        experts = t.bytes_per_param * m.dense_ffn_params
    return attn + experts


def memory_unpartitioned(m: ModelShape, t: TrainSetup) -> float:
    """Eq 1: hypothetical single-GPU memory (lower bound M_u)."""
    static = t.bytes_per_param * (
        m.total_params()
    )
    act = m.L * (_attn_act_per_layer(m, t, t.b) + _expert_act_per_layer(m, t, t.b, 1))
    return static + act


def static_state_bytes(m: ModelShape, t: TrainSetup, stage_layers: float) -> float:
    """Per-chip bytes of params+grads+optimizer for ``stage_layers`` layers
    (+ a 1/PP share of embeddings), under the configured ZeRO policy."""
    if t.zero == "world":
        # Fully-sharded (our executor): per chip = total / world, regardless
        # of how layers map to stages.
        return t.bytes_per_param * m.total_params() / t.P
    zero = t.DP if t.zero == "dp" else 1
    static = stage_layers * _static_layer_bytes(m, t, t.EP) / zero
    embed = (
        t.bytes_per_param * 2 * m.vocab * m.d_model * (stage_layers / m.L) / zero
    )
    return static + embed


def memory_edp(m: ModelShape, t: TrainSetup) -> float:
    """Eq 2: per-GPU memory under expert-data parallelism (world = EP)."""
    static = static_state_bytes(m, t, m.L)
    per_layer = _attn_act_per_layer(
        m, t, t.b / t.EP / t.DP
    ) + _expert_act_per_layer(m, t, t.b / t.DP, t.EP)
    if t.checkpoint_activations:
        # Retain only layer inputs; one layer's full activations re-live
        # during recompute.
        inputs = t.bytes_act * (t.b / (t.EP * t.DP)) * t.s * m.d_model
        act = m.L * inputs + per_layer
    else:
        act = m.L * per_layer
    return static + act + t.framework_overhead


def memory_pp_gpipe(m: ModelShape, t: TrainSetup) -> float:
    """Eq 3: GPipe peak — all M microbatches alive on a stage."""
    l = m.L / t.PP
    static = static_state_bytes(m, t, l)
    b_tok = t.b / t.DP  # batch sharded over external DP
    act = l * (
        _attn_act_per_layer(m, t, b_tok / t.EP)
        + _expert_act_per_layer(m, t, b_tok, t.EP)
    )
    return static + act + t.framework_overhead


def _act_per_microbatch(m: ModelShape, t: TrainSetup) -> float:
    """One microbatch's activation bytes across a full stage (L/PP layers)
    — the unit of Eq 4's per-stage residency accounting."""
    l = m.L / t.PP
    b_mu_tok = t.b / t.DP / t.M
    if t.checkpoint_activations:
        # only layer inputs retained: bytes_act * tokens * d per layer
        return l * t.bytes_act * (b_mu_tok / t.EP) * t.s * m.d_model
    return l * (
        _attn_act_per_layer(m, t, b_mu_tok / t.EP)
        + _expert_act_per_layer(m, t, b_mu_tok, t.EP)
    )


def memory_pp_1f1b(m: ModelShape, t: TrainSetup, stage: int = 0) -> float:
    """Eq 4: 1F1B peak for stage i — min(PP - i, M) in-flight
    microbatches (same closed form the IR is pinned to)."""
    static = static_state_bytes(m, t, m.L / t.PP)
    in_flight = peak_in_flight("1f1b", t.PP, t.M, stage=stage)
    return static + in_flight * _act_per_microbatch(m, t) + t.framework_overhead


def peak_in_flight(
    schedule: str, PP: int, M: int, V: int = 1, stage: int = 0
) -> int:
    """Closed-form per-stage peak residency of each schedule family, in
    units of one microbatch through one CHUNK (a chunk is 1/V of a stage's
    layers).  Delegates to the IR module's closed forms (single source,
    pinned against the real builders by tests/test_schedule_invariants.py).
    ``zb_h1`` shares 1F1B's Eq-4 profile by construction: Bi frees the
    residual slot on B's cadence."""
    from repro_torch.core.schedules import peak_activations_interleaved

    assert schedule in SCHEDULES, schedule
    if schedule == "gpipe":
        return M
    # 1f1b == zb_h1 == interleaved at V=1 (Eq 4); interleaved: the Eq-4
    # analogue.
    V_eff = V if schedule == "interleaved_1f1b" else 1
    return peak_activations_interleaved(PP, M, V_eff)[stage]


def peak_wstash(schedule: str, PP: int, M: int) -> int:
    """Closed-form W-stash depth: deferred weight grads simultaneously
    pending per stage.  Zero for fused-backward schedules; ``min(PP, M)``
    for ZB-H1 (the IR module's closed form, pinned against the real
    builder)."""
    from repro_torch.core.schedules import peak_wstash_zb_h1

    assert schedule in SCHEDULES, schedule
    if schedule != "zb_h1":
        return 0
    return peak_wstash_zb_h1(PP, M)


def wstash_bytes(m: ModelShape, t: TrainSetup) -> float:
    """Per-chip bytes of the split executor's scan-carried W-stash: each
    of the ``peak_wstash`` deferred weight grads parks the stage INPUT and
    the stage-output cotangent (two (b_mu, s, d) activations — what the
    stage-granular weight pullback recomputes from), regardless of the
    stage's layer count.  This is the memory ZB-H1 pays for filling the
    drain — reported separately from the Eq-4 residual term."""
    depth = peak_wstash(t.schedule, t.PP, t.M)
    if depth == 0:
        return 0.0
    b_mu_tok = t.b / t.DP / t.M
    return depth * 2.0 * t.bytes_act * (b_mu_tok / t.EP) * t.s * m.d_model


def memory_pp_interleaved(m: ModelShape, t: TrainSetup, stage: int = 0) -> float:
    """Eq-4 analogue for interleaved 1F1B: stage i holds
    ``2(PP-i-1) + (V-1)PP + 1`` in-flight chunk activations, each 1/V of a
    stage's layers — net ~2× Eq 4 at large V, the memory the planner weighs
    against the 1/V bubble."""
    static = static_state_bytes(m, t, m.L / t.PP)
    in_flight = peak_in_flight("interleaved_1f1b", t.PP, t.M, t.vstages, stage)
    act_chunk = _act_per_microbatch(m, t) / t.vstages
    return static + in_flight * act_chunk + t.framework_overhead


def memory_1f1b_skew(m: ModelShape, t: TrainSetup) -> float:
    """Eq 5: stage-0 minus stage-(PP-1) activation skew."""
    return memory_pp_1f1b(m, t, 0) - memory_pp_1f1b(m, t, t.PP - 1)


def memory_pp(m: ModelShape, t: TrainSetup, stage: int = 0) -> float:
    """Schedule-aware per-stage pipeline peak (Eq 3, Eq 4 or the
    interleaved Eq-4 analogue per ``t.schedule``/``t.vstages``, plus the
    W-stash term for split-backward schedules) — what the planner's Eq-11
    feasibility check uses."""
    assert t.schedule in SCHEDULES, t.schedule
    if t.schedule == "gpipe":
        return memory_pp_gpipe(m, t)  # all M in flight on every stage
    if t.schedule == "interleaved_1f1b" and t.vstages > 1:
        return memory_pp_interleaved(m, t, stage)
    # zb_h1 is Eq-4-equal on the residual slots (Bi frees them on B's
    # cadence); the deferred weight grads add the W-stash on top.
    # Comm-lane schedules (1f1b_overlap) keep 1F1B's Eq-4 residuals and
    # add the in-flight hand-off buffer (comm_buf_bytes == 0 otherwise).
    return memory_pp_1f1b(m, t, stage) + wstash_bytes(m, t) + comm_buf_bytes(m, t)


def schedule_bubble_fraction(
    schedule: str, PP: int, M: int, V: int = 1
) -> float:
    """Eq-3-style idle fraction of the schedule at equal fwd/bwd op cost:
    (PP-1)/(M+PP-1) for the flush schedules, (PP-1)/(V·M+PP-1) interleaved
    — exactly the unit-op tick fraction of the IR (pinned by the
    simulator/model cross-check test).

    ``zb_h1`` counts THREE unit ops per microbatch (F, Bi, Bw — the
    backward split in half), and the deferred Bw's fill all drain idles:
    per-stage idle drops to PP-1 unit ops in a 3M + PP - 1 tick table, the
    paper-style ``(PP-1)(t_F + t_B - 2 t_Bw)`` ZB-H1 bubble at
    ``t_Bi = t_Bw = t_B / 2`` — strictly below 1F1B's at every PP > 1
    (valid for M >= PP, which ``M = alpha * PP`` guarantees)."""
    assert schedule in SCHEDULES, schedule
    if PP <= 1:
        return 0.0
    if schedule == "zb_h1":
        return (PP - 1) / (3 * M + PP - 1)
    units = V * M if schedule == "interleaved_1f1b" else M
    return (PP - 1) / (units + PP - 1)


# ---------------------------------------------------------------------------
# Communication (Eq 6 + pipeline P2P)
# ---------------------------------------------------------------------------


def a2a_bytes_per_gpu(m: ModelShape, t: TrainSetup) -> float:
    """Per-GPU send volume for ONE dispatch all-to-all of ONE MoE layer over
    a full step (paper: 2 b s k d / EP bytes in fp16; the (EP-1)/EP factor
    removes tokens that stay local).  Tokens per GPU are b*s*k/(EP*DP): each
    pipeline stage processes every microbatch."""
    if m.E == 0 or t.EP == 1:
        return 0.0
    tokens = t.b * t.s * m.k / (t.EP * t.DP)
    return t.bytes_act * tokens * m.d_model * (t.EP - 1) / t.EP


def t_a2a_lower_bound(m: ModelShape, t: TrainSetup, platform: Platform) -> float:
    """Eq 6: per-MoE-layer forward a2a latency bound (dispatch + combine).

    The paper's bound 4 b s k d / (EP * B_NIC) assumes the EP group spans
    NICs; when the group fits inside the fast domain the denominator uses
    the fast-link bandwidth — exactly the locality effect Piper exploits.
    """
    if m.E == 0 or t.EP == 1:
        return 0.0
    bw = (
        platform.intra_node_bw
        if t.EP <= platform.fast_domain
        else platform.inter_node_bw
    )
    return 2 * a2a_bytes_per_gpu(m, t) / bw


def a2a_case(m: ModelShape, t: TrainSetup) -> cm.A2ACase:
    """The comm-model instance of ONE dispatch (or combine) collective of
    one MoE layer per step: EP ranks, each shipping its per-destination
    row block (total payload / EP) — consistent with
    :func:`a2a_bytes_per_gpu` = row_bytes * (EP - 1)."""
    tokens = t.b * t.s * m.k / (t.EP * t.DP)
    return cm.A2ACase(
        n_ranks=t.EP, row_bytes=t.bytes_act * tokens * m.d_model / t.EP
    )


def moe_layer_compute_time(
    m: ModelShape, t: TrainSetup, platform: Platform
) -> float:
    """Seconds one rank spends in ONE hosted MoE layer's routed expert
    GEMMs across the step's tokens, FORWARD pass (2 FLOPs/param/token; the
    backward is 2x) — the compute a chunked dispatch/combine can hide
    behind.  Uses the same skinny-GEMM efficiency as :func:`t_compute`,
    whose per-layer MoE share this matches by construction."""
    if m.E == 0:
        return 0.0
    disp = dispatch_costs(m, t)
    tokens_per_rank = t.b * t.s / (t.DP * t.EP)
    flops = 2.0 * m.k * disp.flops_factor * m.expert_params * tokens_per_rank
    tok_per_expert = t.b * t.s * m.k / (m.E * t.DP * t.PP)
    min_dim = min(tok_per_expert, m.d_ffn_moe, m.d_model)
    eff = platform.gemm_efficiency(int(min_dim))
    return flops / (platform.peak_flops * eff)


def p2p_bytes_per_boundary(m: ModelShape, t: TrainSetup) -> float:
    """Activation bytes crossing one pipeline-stage boundary per microbatch
    per EP rank (paper §III-B2: 2 b_mu s d bytes)."""
    b_mu_tok = t.b / t.DP / t.M / t.EP
    return t.bytes_act * b_mu_tok * t.s * m.d_model


@lru_cache(maxsize=None)
def _comm_lane_exposure(
    schedule: str, PP: int, M: int,
    t_f: float, t_b: float, t_p2p: float, t_a2a: float,
) -> Tuple[float, float]:
    """(exposed_p2p, exposed_a2a) of one comm-lane schedule replay —
    THE definition the resource model charges for ``has_comm`` schedules,
    shared verbatim with ``schedule_sim.simulate`` so the model is pinned
    against the simulator by construction (per-op durations in seconds:
    ``t_f``/``t_b`` per microbatch per stage, ``t_p2p`` per hop, ``t_a2a``
    per op bracket)."""
    from repro_torch.core import schedule_sim as ss
    from repro_torch.core.schedules import build

    r = ss.simulate(build(schedule, PP, M), t_f, t_b,
                    t_p2p=t_p2p, t_a2a=t_a2a)
    return r.exposed_p2p, r.exposed_a2a


def comm_buf_bytes(m: ModelShape, t: TrainSetup) -> float:
    """Per-chip bytes of the comm-lane schedules' in-flight hand-off
    buffers: one boundary activation per comm slot (fwd) / cotangent
    (bwd), held between its Send and Recv ticks.  Zero for schedules
    without a comm lane."""
    from repro_torch.core.schedules import OVERLAP_BASE, build

    if t.schedule not in OVERLAP_BASE or t.PP <= 1:
        return 0.0
    sch = build(t.schedule, t.PP, t.M)
    slots = sch.num_cslots_fwd + sch.num_cslots_bwd
    return slots * p2p_bytes_per_boundary(m, t)


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------


def flops_per_step(m: ModelShape, t: TrainSetup) -> float:
    """Model FLOPs per optimizer step: 6 * N_active * tokens + attention
    quadratic term (12 L_attn b s^2 H d_h fwd+bwd)."""
    tokens = t.b * t.s
    dense = 6.0 * m.active_params() * tokens
    attn_quad = 12.0 * m.n_attn * t.b * t.s * t.s * m.H * m.d_h
    return dense + attn_quad


def t_compute(m: ModelShape, t: TrainSetup, platform: Platform) -> float:
    """Compute time per step using the micro-benchmarked efficiency curves
    (paper §IV-A: attention kernel eff + skinny-GEMM expert eff)."""
    tokens = t.b * t.s
    # attention + dense parts at attn/gemm efficiency
    attn_flops = 6.0 * (
        m.n_attn * m.attn_params_per_layer + 2 * m.vocab * m.d_model
    ) * tokens + 12.0 * m.n_attn * t.b * t.s * t.s * m.H * m.d_h
    dense_flops = 6.0 * (m.L - m.L_moe) * m.dense_ffn_params * tokens
    # Routed experts pay the dispatch mode's padding tax (capacity: cf x
    # zeros through the MXU; ragged: masked tile tails only); the
    # always-active shared experts are densely batched either way.
    disp = dispatch_costs(m, t)
    moe_flops = 6.0 * m.L_moe * (
        m.k * disp.flops_factor + m.E_s
    ) * m.expert_params * tokens

    # per-expert GEMM shape: (tokens*k/E per device-expert) x d x d_ffn
    if m.E:
        tok_per_expert = tokens * m.k / (m.E * t.DP * t.PP)
        min_dim = min(tok_per_expert, m.d_ffn_moe, m.d_model)
        moe_eff = platform.gemm_efficiency(int(min_dim))
    else:
        moe_eff = platform.gemm_efficiency(m.d_ffn_dense)
    dense_eff = platform.gemm_efficiency(
        min(m.d_model, m.d_ffn_dense) if m.d_ffn_dense else m.d_model
    )
    peak = platform.peak_flops * t.P
    time = (
        attn_flops / (peak * platform.attn_eff)
        + (dense_flops / (peak * dense_eff) if dense_flops else 0.0)
        + (moe_flops / (peak * moe_eff) if moe_flops else 0.0)
    )
    return time


# ---------------------------------------------------------------------------
# Reliability & checkpoint pricing (Young–Daly)
# ---------------------------------------------------------------------------

# Checkpoint bytes per parameter: fp32 master weights + fp32 Adam moments
# (m, v) = 4 + 4 + 4.  The int32 step scalar is noise.
CKPT_BYTES_PER_PARAM = 12.0


def checkpoint_bytes(m: ModelShape) -> float:
    """Global checkpoint size: full optimizer state (weights + moments)."""
    return m.total_params() * CKPT_BYTES_PER_PARAM


def checkpoint_write_time(
    m: ModelShape, t: TrainSetup, platform: Platform
) -> float:
    """Seconds to persist one checkpoint: every chip writes its own shard
    at its sustained per-chip filesystem share, plus a fixed barrier/open
    latency.  Sharded writers make the transfer term scale 1/P."""
    return platform.ckpt_latency_s + checkpoint_bytes(m) / (
        platform.ckpt_write_bw * t.P
    )


def job_mtbf(platform: Platform, P: int) -> float:
    """Job-level mean time between failures: P independent chips, each
    with per-chip MTBF ``mtbf_chip_s`` — failures superpose, so the job
    rate is P times the chip rate."""
    return platform.mtbf_chip_s / max(P, 1)


def young_daly_interval(t_ckpt: float, mtbf: float) -> float:
    """Young–Daly optimal checkpoint interval  τ* = sqrt(2·t_ckpt·MTBF).

    Minimizes expected waste  w(τ) = t_ckpt/τ + (τ/2 + t_recover)/MTBF:
    checkpointing too often pays the write, too rarely pays half an
    interval of lost work per failure."""
    return math.sqrt(2.0 * t_ckpt * mtbf)


def goodput_factor(
    t_ckpt: float, mtbf: float, interval: float, t_recover: float
) -> float:
    """Fraction of wall-clock doing useful training at checkpoint interval
    ``interval``: 1 − [write overhead + expected rework + restart]."""
    waste = t_ckpt / interval + (interval / 2.0 + t_recover) / mtbf
    return max(0.0, 1.0 - waste)


# ---------------------------------------------------------------------------
# Expert-migration pricing (paper Table IV at Platform bandwidths)
# ---------------------------------------------------------------------------


def _migration_cost(
    E: int, d_model: int, d_ffn: int, G: int = 8, bandwidth: float = 50e9,
    n_mat: int = 3, bytes_per_param: int = 16,
) -> Tuple[float, float]:
    """Paper Table IV: worst-case per-GPU send size (bytes) and latency (s):
    48 * E * d_model * d_ffn / G at 50 GB/s (3 matrices x 16 B/param).
    The port's copy of the reference's ``core.migration.migration_cost``;
    the rest of that module (the rebalance controller) waits for expert
    parallelism."""
    size = bytes_per_param * n_mat * E * d_model * d_ffn / G
    return size, size / bandwidth


def migration_time(
    m: ModelShape, t: TrainSetup, platform: Platform
) -> Tuple[float, float]:
    """What one full expert rebalance costs on this platform: Table IV's
    worst-case per-chip message (n_mat matrices x bytes_per_param, experts
    sharded over the EP groups) for every hosted MoE layer, shipped over
    the migration link.  Returns (bytes, seconds) — the hysteresis gate
    compares the seconds against ``migrate_gain_per_step * migrate_every``.
    """
    if not (m.E and m.L_moe):
        return 0.0, 0.0
    size, sec = _migration_cost(
        m.E, m.d_model, m.d_ffn_moe,
        G=max(t.EP, 1),
        bandwidth=platform.migration_bw,
        n_mat=m.n_mat,
        bytes_per_param=t.bytes_per_param,
    )
    layers = m.L_moe / t.PP  # stages permute their own layers concurrently
    return size * layers, sec * layers


# ---------------------------------------------------------------------------
# Step time & MFU (Eq 12)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Estimate:
    t_compute: float
    t_a2a: float
    t_p2p: float
    t_dp_grad: float
    bubble_fraction: float
    t_step: float
    mfu: float
    mem_stage0: float
    mem_ok: bool
    # Dispatch-mode accounting (see dispatch_costs)
    t_dispatch: float = 0.0
    drop_rate: float = 0.0
    moe_flops_factor: float = 1.0
    # Split-backward accounting: per-chip bytes of the deferred weight-grad
    # stash (zb_h1; 0 for fused schedules).  Already included in
    # mem_stage0 — reported separately so the Eq-4-equal residual claim
    # stays auditable.
    wstash_bytes: float = 0.0
    # Chunked/hierarchical a2a accounting: t_a2a stays the serial Eq-6
    # reference; t_a2a_exposed is what actually hits the critical path
    # after the algo choice + double-buffered chunk overlap, and
    # a2a_overlap_saving = t_a2a - t_a2a_exposed.  Defaults (flat, K=1)
    # keep t_a2a_exposed == t_a2a exactly.
    t_a2a_exposed: float = 0.0
    a2a_overlap_saving: float = 0.0
    a2a_algo: str = DEFAULT_A2A
    a2a_chunks: int = 1
    # Comm-lane schedule accounting (1f1b_overlap): t_p2p stays the flat
    # serial Eq reference (2·M·V hand-offs per stage); t_p2p_exposed is
    # what actually hits the critical path — the comm-lane dependency
    # replay for has_comm schedules, the full serial reference otherwise
    # (the historical charge, a LOWER bound of the synchronous replay) —
    # and it, not t_p2p, is what t_step charges.  comm_buf_bytes is the
    # in-flight hand-off buffer the overlap pays for (in mem_stage0).
    t_p2p_exposed: float = 0.0
    p2p_overlap_saving: float = 0.0
    comm_buf_bytes: float = 0.0
    # Reliability pricing (Young–Daly): checkpoint write time, optimal
    # interval (seconds / steps), and the availability-adjusted goodput.
    # mfu_effective = mfu * goodput_factor is the metric long runs buy.
    t_ckpt: float = 0.0
    ckpt_interval_s: float = 0.0
    ckpt_every_steps: int = 0
    goodput_factor: float = 1.0
    mfu_effective: float = 0.0
    # Expert-migration pricing (Table IV at Platform bandwidths): what one
    # rebalance transfer costs here and — when the caller supplies the
    # post-rebalance imbalance — the per-step time it buys back.  The
    # trainer's hysteresis gate migrates iff
    # migrate_gain_per_step * migrate_every > t_migrate.
    t_migrate: float = 0.0
    migrate_bytes: float = 0.0
    imbalance_post: float = 0.0
    migrate_gain_per_step: float = 0.0
    # Per-step replica weight-broadcast tax (TrainSetup.replicas channels).
    t_replicate: float = 0.0


def estimate(
    m: ModelShape, t: TrainSetup, platform: Platform,
    overlap_fraction: float = 0.0,
    imbalance_post: Optional[float] = None,
) -> Estimate:
    """Paper Eq 12: MFU = hardware-eff x compute-fraction, with the pipeline
    bubble (PP-1)/M and exposed (non-overlapped) communication."""
    tc = t_compute(m, t, platform)

    # All-to-all: Eq 6 covers dispatch+combine (forward); the backward pass
    # runs the same two collectives again (paper: 4 a2a per MoE layer per
    # fwd+bwd).  Each GPU hosts L_moe/PP such layers.
    ta2a = 2 * t_a2a_lower_bound(m, t, platform) * m.L_moe / t.PP

    # Algo choice (flat vs HALO) + chunked double-buffered overlap: scale
    # the serial Eq-6 reference by the comm model's exposed/serial ratio.
    # The forward pass hides behind the layer's forward expert GEMMs, the
    # backward behind the 2x backward GEMMs; each pass ships the same two
    # collectives, so the ratio averages the two exposures.  Defaults
    # (flat, K=1) leave ta2a_exposed == ta2a bit-for-bit.
    ta2a_exposed = ta2a
    if (
        m.E
        and t.EP > 1
        and ta2a > 0
        and (t.a2a_algo != "flat" or t.a2a_chunks > 1)
    ):
        case = a2a_case(m, t)
        t_serial = 2.0 * cm.flat_a2a_time(case, platform)  # one pass
        if t_serial > 0:
            p_fwd = moe_layer_compute_time(m, t, platform)
            exp_f = cm.exposed_a2a_time(
                case, platform, t.a2a_algo, t.a2a_chunks, p_fwd
            )
            exp_b = cm.exposed_a2a_time(
                case, platform, t.a2a_algo, t.a2a_chunks, 2.0 * p_fwd
            )
            ta2a_exposed = ta2a * (exp_f + exp_b) / (2.0 * t_serial)

    # Pipeline P2P: (PP-1) boundaries x M microbatches x fwd+bwd.
    p2p_bw = (
        platform.inter_group_bw
        if t.EP >= platform.fast_domain
        else platform.inter_node_bw
    )
    # Every interior stage sends+receives M microbatch activations fwd and
    # their gradients bwd; boundaries operate concurrently.  Interleaving
    # multiplies the hand-offs by V: each microbatch crosses every boundary
    # once per virtual stage (the chunk ring's wrap edges ride the same
    # ppermute).
    tp2p = (
        2 * t.M * t.vstages * p2p_bytes_per_boundary(m, t) / p2p_bw
        if t.PP > 1
        else 0.0
    )

    # DP gradient all-reduce (external replicas): 2 x params/DP-shard.
    if t.DP > 1:
        grad_bytes = 2 * (m.total_params() / (t.PP * t.EP)) * 2  # bf16, x2 ring
        tdp = grad_bytes / platform.inter_node_bw
    else:
        tdp = 0.0

    # Dispatch bookkeeping (slot assignment / sort + permute) is per-rank
    # HBM-bound work, fwd+bwd, for each hosted MoE layer — plus, for the
    # ragged EP path, the counts-exchange pre-pass: a second (tiny)
    # collective per a2a, priced at the same link class as the payload.
    disp = dispatch_costs(m, t)
    t_disp = (
        2 * disp.bytes_per_layer * (m.L_moe / t.PP) / platform.hbm_bw
        if m.E
        else 0.0
    )
    if m.E and disp.counts_bytes_per_layer:
        counts_bw = (
            platform.intra_node_bw
            if t.EP <= platform.fast_domain
            else platform.inter_node_bw
        )
        t_disp += disp.counts_bytes_per_layer * (m.L_moe / t.PP) / counts_bw

    # Fill/drain overhead over useful time: f/(1-f) of the Eq-3 tick
    # fraction — (PP-1)/M for the flush schedules, (PP-1)/(V·M) interleaved.
    if t.PP > 1:
        frac = schedule_bubble_fraction(t.schedule, t.PP, t.M, t.vstages)
        bubble = frac / (1.0 - frac)
    else:
        bubble = 0.0

    # Hot-expert replica weight broadcast: each live channel's n_mat
    # matrices are psum-selected over the EP groups at use time (forward
    # broadcast + the grad-sum transpose), once per hosted MoE layer, in
    # the activation dtype.  replicas == 0 prices to exactly zero.
    if m.E and t.replicas > 0 and t.EP > 1:
        rep_bw = (
            platform.intra_node_bw
            if t.EP <= platform.fast_domain
            else platform.inter_node_bw
        )
        rep_bytes = (
            2.0 * t.replicas * m.expert_params * t.bytes_act
            * 2.0 * (t.EP - 1) / t.EP  # ring psum, fwd + bwd transpose
        )
        trep = rep_bytes * (m.L_moe / t.PP) / rep_bw
    else:
        trep = 0.0

    # Comm-lane schedules: replace the flat serial p2p charge with the
    # comm-lane dependency replay (send at producer tick, recv at
    # consumer tick — only what the intervening compute cannot cover is
    # exposed), and cap the a2a exposure by the schedule-level A2A
    # bracket replay (the tick-granular view of the same hiding the
    # chunked comm model prices within the layer; the two mechanisms
    # hide the same serial reference, so the model takes the better one,
    # they do not compose).  Legacy schedules charge the serial
    # reference, keeping their t_step bit-identical.
    from repro_torch.core.schedules import OVERLAP_BASE

    tp2p_exposed = tp2p
    if t.schedule in OVERLAP_BASE and t.PP > 1 and (tp2p > 0 or ta2a > 0):
        t_f_mb = tc / (3.0 * t.M)  # per-mb fwd op; bwd is the other 2/3
        h_hop = tp2p / (2.0 * t.M * t.vstages)
        a_op = ta2a / (2.0 * t.M)  # per F/B op's bracketed a2a share
        exp_p2p, exp_a2a = _comm_lane_exposure(
            t.schedule, t.PP, t.M, t_f_mb, 2.0 * t_f_mb, h_hop, a_op
        )
        tp2p_exposed = exp_p2p
        ta2a_exposed = min(ta2a_exposed, exp_a2a)

    exposed = (
        (ta2a_exposed + tp2p_exposed + tdp + trep) * (1.0 - overlap_fraction)
    )
    t_step = (
        (tc * t.imbalance + t_disp + exposed) * (1 + bubble)
        + t.step_overhead
    )

    model_flops = flops_per_step(m, t)
    mfu = model_flops / (platform.peak_flops * t.P * t_step)

    # Young–Daly checkpoint pricing: optimal interval from ckpt cost and
    # job MTBF; goodput discounts MFU by write overhead + expected rework.
    t_ckpt = checkpoint_write_time(m, t, platform)
    mtbf = job_mtbf(platform, t.P)
    tau = young_daly_interval(t_ckpt, mtbf)
    t_recover = platform.restart_s + t_ckpt  # requeue + restore ≈ write
    goodput = goodput_factor(t_ckpt, mtbf, tau, t_recover)

    # Table IV migration pricing: one rebalance transfer on this platform,
    # and — when the controller supplies the post-rebalance imbalance — a
    # depth-1 re-estimate of the step at that skew to get the modeled
    # per-step recovery the transfer would buy.
    mig_bytes, t_mig = migration_time(m, t, platform)
    if imbalance_post is not None:
        post = estimate(
            m, replace(t, imbalance=imbalance_post), platform,
            overlap_fraction,
        )
        imb_post = float(imbalance_post)
        mig_gain = t_step - post.t_step
    else:
        imb_post = 0.0
        mig_gain = 0.0

    mem0 = memory_pp(m, t, 0) if t.PP > 1 else memory_edp(m, t)
    return Estimate(
        t_compute=tc,
        t_a2a=ta2a,
        t_p2p=tp2p,
        t_dp_grad=tdp,
        bubble_fraction=bubble,
        t_step=t_step,
        mfu=mfu,
        mem_stage0=mem0,
        mem_ok=mem0 <= platform.hbm_bytes,
        t_dispatch=t_disp,
        drop_rate=disp.drop_rate,
        moe_flops_factor=disp.flops_factor,
        wstash_bytes=wstash_bytes(m, t) if t.PP > 1 else 0.0,
        t_a2a_exposed=ta2a_exposed,
        a2a_overlap_saving=ta2a - ta2a_exposed,
        a2a_algo=t.a2a_algo,
        a2a_chunks=t.a2a_chunks,
        t_p2p_exposed=tp2p_exposed,
        p2p_overlap_saving=tp2p - tp2p_exposed,
        comm_buf_bytes=comm_buf_bytes(m, t) if t.PP > 1 else 0.0,
        t_ckpt=t_ckpt,
        ckpt_interval_s=tau,
        ckpt_every_steps=max(1, int(round(tau / t_step))),
        goodput_factor=goodput,
        mfu_effective=mfu * goodput,
        t_migrate=t_mig,
        migrate_bytes=mig_bytes,
        imbalance_post=imb_post,
        migrate_gain_per_step=mig_gain,
        t_replicate=trep,
    )


# ---------------------------------------------------------------------------
# Serving mode (decode latency / prefill throughput / KV bytes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeSetup:
    """Serving-mode run parameters — the decode-centric analogue of
    :class:`TrainSetup`.

    One serving *replica* spans ``EP * TP`` chips (weight-parallel decode:
    tokens replicated over the replica, experts sharded over EP, everything
    else over TP) and ``DP`` independent replicas split the traffic.
    ``batch`` is the continuous-batching decode width per replica;
    ``context`` the mean live context per sequence (prompt + generated so
    far) — what the KV pool actually holds.
    """

    batch: int  # concurrent decode sequences per replica
    context: int  # mean live tokens per sequence (KV resident)
    prefill_len: int  # mean prompt length (TTFT)
    EP: int = 1
    TP: int = 1
    DP: int = 1  # independent serving replicas
    dispatch: str = DEFAULT_DISPATCH
    weight_bytes: int = 2  # bf16 serving weights
    kv_bytes: int = 2  # bf16 KV-cache entries
    block_size: int = 16  # paged-KV page granularity (rounding unit)
    imbalance: float = 1.0  # routing skew (max/mean expert load)

    def __post_init__(self):
        assert self.dispatch in DISPATCH_MODES, self.dispatch
        assert self.batch >= 1 and self.context >= 1

    @property
    def chips_per_replica(self) -> int:
        return self.EP * self.TP

    @property
    def P(self) -> int:
        return self.EP * self.TP * self.DP


def kv_bytes_per_token(m: ModelShape, s: ServeSetup) -> float:
    """KV-cache bytes ONE token adds across all attention layers (K + V,
    GQA heads)."""
    return 2.0 * m.n_attn * m.H_kv * m.d_h * s.kv_bytes


def kv_bytes_per_seq(m: ModelShape, s: ServeSetup) -> float:
    """Resident KV bytes of one sequence at mean context, page-rounded —
    the paged pool's allocation unit (a dense preallocation would pay
    max_len instead of context)."""
    pages = -(-s.context // s.block_size)
    return pages * s.block_size * kv_bytes_per_token(m, s)


def serve_memory_per_chip(m: ModelShape, s: ServeSetup) -> float:
    """Per-chip serving HBM: weights (experts sharded over EP, the rest
    over TP) + the replica's KV pool.  Our weight-parallel decode
    replicates tokens — and therefore the KV pool — across the replica's
    chips; a TP-sharded-KV attention would divide the second term by TP."""
    expert_params = m.L_moe * (m.E / s.EP + m.E_s) * m.expert_params
    other = (
        (m.L - m.L_moe) * m.dense_ffn_params
        + m.n_attn * m.attn_params_per_layer
        + 2 * m.vocab * m.d_model
    ) / s.TP
    weights = s.weight_bytes * (expert_params + other)
    kv_pool = s.batch * kv_bytes_per_seq(m, s)
    return weights + kv_pool


def serving_dispatch_costs(m: ModelShape, s: ServeSetup) -> DispatchCosts:
    """Decode-step dispatch economics.  The decode GEMM is the paper's
    skinny-GEMM regime at its worst: only ``batch * k`` routed rows per
    step, so capacity mode's (E, C, d) buffer issues at least one row per
    expert — a ``max(E/(batch*k), cf)``-fold padding tax — while ragged
    issues only the occupied row tiles.  Capacity drops under skew exactly
    as in training."""
    if m.E == 0:
        return DispatchCosts(1.0, 0.0, 1.0, 0.0)
    rows = s.batch * m.k / s.EP  # routed rows per rank per decode step
    E_l = max(m.E / s.EP, 1.0)
    if s.dispatch == "capacity":
        C = max(math.ceil(s.batch * m.k / m.E * m.cf), 1)
        issued = E_l * C
        return DispatchCosts(
            flops_factor=max(issued / max(rows, 1e-9), 1.0),
            drop_rate=max(0.0, 1.0 - m.cf / max(s.imbalance, 1e-9)),
            act_factor=max(issued / max(rows, 1e-9), 1.0),
            bytes_per_layer=3.0 * rows * m.E * 4.0,
        )
    # Ragged issues one bm-row tile per occupied (expert, tile) work item;
    # bm adapts down to the replicated row count (kernels.moe_gemm._row_block)
    bm = min(RAGGED_TILE_ROWS, max(-(-s.batch * m.k // 16) * 16, 16))
    occupied = min(E_l, rows) if rows >= 1.0 else 1.0
    c_e = rows / max(occupied, 1.0)
    issued = occupied * (-(-c_e // bm)) * bm
    return DispatchCosts(
        flops_factor=max(issued / max(rows, 1e-9), 1.0),
        drop_rate=0.0,
        act_factor=1.0,
        bytes_per_layer=rows * 8.0 * max(math.log2(max(rows, 2.0)), 1.0)
        + 2.0 * rows * m.d_model * s.kv_bytes,
    )


@dataclass(frozen=True)
class ServeEstimate:
    """What one serving strategy costs — the planner ranks these."""

    t_decode: float  # seconds per decode step (one token per running seq)
    decode_tokens_per_s: float  # per replica: batch / t_decode
    tokens_per_s_per_chip: float  # fleet goodput density
    ttft: float  # prefill latency at mean prompt length (SLO input #2)
    prefill_tokens_per_s: float
    kv_bytes_seq: float
    mem_per_chip: float
    mem_ok: bool
    drop_rate: float
    decode_flops_factor: float
    # decode step breakdown (seconds)
    t_weights: float
    t_kv: float
    t_compute: float
    t_comm: float


def serve_estimate(
    m: ModelShape, s: ServeSetup, platform: Platform
) -> ServeEstimate:
    """Analytical decode/prefill model for one strategy.

    Decode is memory-bound at small batch (stream the touched weights +
    the batch's KV each step) and compute-bound at large batch; the two
    streams overlap on real hardware, so the step time is
    ``max(t_hbm, t_compute) + t_comm`` — communication (the EP combine
    psum + router replication) stays exposed, matching the executor (no
    a2a/compute overlap in the decode path).
    """
    disp = serving_dispatch_costs(m, s)

    # -- weights streamed per step (per chip) -------------------------------
    # Experts actually touched per rank: batch*k assignments spread over E
    # experts; expected distinct experts is E(1 - (1 - 1/E)^{batch k}).
    if m.E:
        hit = m.E * (1.0 - (1.0 - 1.0 / m.E) ** (s.batch * m.k))
        touched_l = min(hit / s.EP, m.E / s.EP)
        if s.dispatch == "capacity":
            # capacity mode streams every local expert's weights through
            # the grouped GEMM regardless of occupancy
            touched_l = m.E / s.EP
        expert_bytes = (
            m.L_moe * (touched_l + m.E_s) * m.expert_params * s.weight_bytes
        )
    else:
        expert_bytes = 0.0
    other_bytes = (
        (m.L - m.L_moe) * m.dense_ffn_params
        + m.n_attn * m.attn_params_per_layer
        + 2 * m.vocab * m.d_model
    ) / s.TP * s.weight_bytes
    t_weights = (expert_bytes + other_bytes) / platform.hbm_bw

    # -- KV read (replicated tokens: every chip reads the batch's KV) -------
    t_kv = s.batch * s.context * kv_bytes_per_token(m, s) / platform.hbm_bw

    # -- compute ------------------------------------------------------------
    # 2 FLOPs/param/token; routed experts pay the dispatch padding tax.
    tokens = s.batch
    moe_flops = (
        2.0 * m.L_moe * (m.k * disp.flops_factor + m.E_s)
        * m.expert_params * tokens
    )
    other_flops = 2.0 * (
        (m.L - m.L_moe) * m.dense_ffn_params
        + m.n_attn * m.attn_params_per_layer
        + 2 * m.vocab * m.d_model
    ) * tokens
    attn_flops = 4.0 * m.n_attn * tokens * s.context * m.H * m.d_h
    # Decode GEMMs have `batch` rows — deep in the skinny-GEMM regime.
    eff = platform.gemm_efficiency(int(min(tokens, m.d_model)))
    peak = platform.peak_flops * s.chips_per_replica
    t_comp = (moe_flops + other_flops) / (peak * eff) + attn_flops / (
        platform.peak_flops * platform.attn_eff
    )

    # -- communication (per replica, exposed) -------------------------------
    if m.E and s.EP > 1:
        bw = (
            platform.intra_node_bw
            if s.EP <= platform.fast_domain
            else platform.inter_node_bw
        )
        # psum("ep") combine of (batch*k, d) partial outputs per MoE layer
        comb = 2.0 * s.batch * m.k * m.d_model * s.kv_bytes
        t_comm = m.L_moe * comb * (s.EP - 1) / s.EP / bw
    else:
        t_comm = 0.0

    t_decode = max(t_weights + t_kv, t_comp * s.imbalance) + t_comm

    # -- prefill (compute-bound; chunked into the decode stream) ------------
    pf_tokens = s.prefill_len
    pf_flops = 2.0 * (
        m.L_moe * (m.k + m.E_s) * m.expert_params
        + (m.L - m.L_moe) * m.dense_ffn_params
        + m.n_attn * m.attn_params_per_layer
        + 2 * m.vocab * m.d_model
    ) * pf_tokens + 2.0 * m.n_attn * pf_tokens * pf_tokens * m.H * m.d_h
    pf_eff = platform.gemm_efficiency(int(min(pf_tokens, m.d_model)))
    ttft = pf_flops / (peak * pf_eff)
    prefill_tps = pf_tokens / ttft if ttft > 0 else float("inf")

    mem = serve_memory_per_chip(m, s)
    return ServeEstimate(
        t_decode=t_decode,
        decode_tokens_per_s=s.batch / t_decode,
        tokens_per_s_per_chip=s.batch * s.DP / t_decode / max(s.P, 1),
        ttft=ttft,
        prefill_tokens_per_s=prefill_tps,
        kv_bytes_seq=kv_bytes_per_seq(m, s),
        mem_per_chip=mem,
        mem_ok=mem <= platform.hbm_bytes,
        drop_rate=disp.drop_rate,
        decode_flops_factor=disp.flops_factor,
        t_weights=t_weights,
        t_kv=t_kv,
        t_compute=t_comp,
        t_comm=t_comm,
    )


# ---------------------------------------------------------------------------
# Drift-tracking phase views (obs.drift): the subset of an estimate that a
# live run can actually time, keyed by the phase names the telemetry spans
# use.  Keep these in sync with obs.drift.SPAN_PHASES.
# ---------------------------------------------------------------------------


def modeled_phases(e: Estimate) -> dict:
    """Per-phase modeled seconds for a *training* run."""
    return {
        "step": e.t_step,
        "a2a": e.t_a2a_exposed,
        "p2p": e.t_p2p_exposed,
        "ckpt": e.t_ckpt,
        "compute": e.t_compute,
        "dp_grad": e.t_dp_grad,
    }


def modeled_serve_phases(se: ServeEstimate) -> dict:
    """Per-phase modeled seconds for a *serving* run."""
    return {
        "decode": se.t_decode,
        "prefill": se.ttft,
        "weights": se.t_weights,
        "kv": se.t_kv,
    }
