"""Architecture configuration: the port's own copy of the fields it serves.

Mirrors ``ArchConfig``, ``MoECfg`` and ``SSMCfg`` of the JAX package (same
names, same defaults, same parameter accounting and ``reduced()`` shrink
rule) for the attention + MoE and the Mamba2 (SSM) families the port runs,
and the properties ``core.resource_model.ModelShape.from_arch`` and the
planner read; and the LM family's input shapes (``ShapeSpec``, ``SHAPES``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Pipeline schedules the planner and the resource model price (the
# schedule IR in ``repro_torch.core.schedules`` builds their tick tables)
# and ``repro_torch.core.pipeline`` executes.
SCHEDULES: Tuple[str, ...] = (
    "gpipe", "1f1b", "1f1b_overlap", "interleaved_1f1b", "zb_h1"
)
DEFAULT_SCHEDULE = "1f1b"

# Expert dispatch modes: "capacity" = GShard/Tutel (E, C, d) zero-padded
# buffers, overflow dropped; "ragged" = sort-based dropless dispatch
# (expert-sorted rows + per-expert offsets, ragged grouped GEMM).
DISPATCH_MODES: Tuple[str, ...] = ("capacity", "ragged")
DEFAULT_DISPATCH = "capacity"

# EP all-to-all algorithms (flat collective vs HALO hierarchical) and the
# chunk depths of the double-buffered dispatch/combine that the planner
# ranks; the port has no expert parallelism yet, so a run binds none.
A2A_ALGOS: Tuple[str, ...] = ("flat", "halo")
DEFAULT_A2A = "flat"
A2A_CHUNK_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8)


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-Experts FFN sub-layer configuration."""

    num_experts: int
    top_k: int
    d_ff: int  # intermediate dim of EACH expert
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01  # Switch-style load balancing loss
    z_loss_coef: float = 1e-3  # router z-loss
    dispatch: str = DEFAULT_DISPATCH
    # Hot-expert replica channels: > 0 adds a (max_replicas,) int32
    # "replicas" routing leaf (sentinel num_experts = free channel).  A
    # replicated expert's rows compute source-locally on every EP rank,
    # off the all-to-all, splitting its load over the groups by token
    # origin (``models.moe``, ``core.migration.plan_replication``).
    max_replicas: int = 0

    def __post_init__(self):
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch {self.dispatch!r}")
        if self.max_replicas < 0:
            raise ValueError(f"max_replicas must be >= 0, got {self.max_replicas}")


@dataclass(frozen=True)
class SSMCfg:
    """Mamba2 (SSD, state-space duality) sub-layer configuration."""

    state_size: int = 128  # N (dstate)
    head_dim: int = 64  # P
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1  # B/C groups

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


# Per-layer block description: (mixer, ffn)
#   mixer: "attn" | "attn_local" | "mamba";  ffn: "dense" | "moe" | "none"
Block = Tuple[str, str]


@dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description; ``block_pattern`` is tiled to
    cover ``num_layers``."""

    name: str
    family: str  # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int  # dense FFN intermediate dim (0 if no dense FFN layers)
    vocab_size: int
    block_pattern: Tuple[Block, ...]
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rope_type: str = "rope"  # rope | mrope | none
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # window for "attn_local" mixers
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma2: the embedding rows times sqrt(d_model)
    norm_eps: float = 1e-6
    ffn_activation: str = "swiglu"  # swiglu (3 matrices) | gelu (2)
    # modality frontend stub: None | "audio_frames" | "vision_patches".
    # Non-None => a batch may carry precomputed (b, s, d_model) "embeds"
    # in place of token ids (backbone-only scope, as the reference).
    frontend: Optional[str] = None
    # True if the mixers' cost is sub-quadratic in context (SSM / hybrid
    # with bounded-window attention).
    subquadratic: bool = False
    source: str = ""

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: heads not a multiple of kv heads")
        if self.num_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: layers not a multiple of pattern")

    @property
    def layers(self) -> Tuple[Block, ...]:
        return self.block_pattern * (self.num_layers // len(self.block_pattern))

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_moe_layers(self) -> int:
        return sum(1 for _, f in self.layers if f == "moe")

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for m, _ in self.layers if m.startswith("attn"))

    @property
    def num_mamba_layers(self) -> int:
        return sum(1 for m, _ in self.layers if m == "mamba")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def n_mat(self) -> int:
        return 3 if self.ffn_activation == "swiglu" else 2

    # -- parameter accounting (exact, matches models/model.py init) --------

    def attn_params(self) -> int:
        d, hq, hkv = self.d_model, self.q_dim, self.kv_dim
        return d * hq + 2 * d * hkv + hq * d

    def dense_ffn_params(self) -> int:
        return self.n_mat * self.d_model * self.d_ff if self.d_ff else 0

    def moe_ffn_params(self) -> int:
        m = self.moe
        expert = self.n_mat * self.d_model * m.d_ff
        return (m.num_experts + m.num_shared_experts) * expert + self.d_model * m.num_experts

    def mamba_params(self) -> int:
        s = self.ssm
        d_in = s.expand * self.d_model
        nh = s.num_heads(self.d_model)
        conv_dim = d_in + 2 * s.n_groups * s.state_size
        in_proj = self.d_model * (2 * d_in + 2 * s.n_groups * s.state_size + nh)
        conv = conv_dim * s.conv_width + conv_dim
        extras = nh * 3  # A_log, D, dt_bias
        return in_proj + conv + extras + d_in + d_in * self.d_model  # + norm, out_proj

    def layer_params(self, block: Block) -> int:
        mixer, ffn = block
        p = 2 * self.d_model  # two RMSNorm scales
        if mixer.startswith("attn"):
            p += self.attn_params()
        elif mixer == "mamba":
            p += self.mamba_params()
        if ffn == "dense":
            p += self.dense_ffn_params()
        elif ffn == "moe":
            p += self.moe_ffn_params()
        elif ffn == "none":
            p -= self.d_model
        return p

    def total_params(self) -> int:
        body = sum(self.layer_params(b) for b in self.layers)
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return body + embed + head + self.d_model

    def active_params(self) -> int:
        """Parameters touched per token (MoE: top-k + shared experts only)."""
        total = self.total_params()
        if self.moe is None:
            return total
        m = self.moe
        expert = self.n_mat * self.d_model * m.d_ff
        return total - (m.num_experts - m.top_k) * expert * self.num_moe_layers

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU tests (the JAX rule)."""
        period = len(self.block_pattern)
        n_layers = period * min(2, self.num_layers // period)
        kw = dict(
            num_layers=max(n_layers, period),
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=32 if self.sliding_window else None,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff=64,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_size=16, head_dim=16, chunk_size=32
            )
        return self.replace(name=self.name + "-reduced", **kw)


# ---------------------------------------------------------------------------
# Input shapes (the assigned shape pool for the LM family)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention (SSM/hybrid)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "full-attention arch: 500k dense-KV decode excluded"
    return True, ""
