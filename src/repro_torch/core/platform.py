"""Platform descriptions: the hardware constants the resource model prices.

The port's copy of ``repro.core.platform``'s ``Platform`` (field for
field, same defaults, same ``gemm_efficiency`` lookup) and of
``FRONTIER``, the paper's platform, plus ``H100``: one NVIDIA H100 SXM5
in a DGX H100 node, the card the port runs on.  Each ``H100`` constant
names its source: measured on the card by ``chip_smoke.py`` (phase
"model", ``core.microbench``) or by the checkpoint runs of PERF.md, the
NVIDIA datasheet, the DGX H100 layout, or, where none applies, the
``Platform`` default, labelled so.  The reference's other platform is a
TPU's and is not carried.

The GEMM-efficiency tables carry the paper's "tall-and-skinny GEMM"
penalty: efficiency collapses when the per-expert FFN dim or the
per-expert token count is far below the matrix units' tile size.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Platform:
    name: str
    chips_per_node: int  # paper's g
    peak_flops: float  # bf16/fp16 per chip, FLOP/s
    hbm_bytes: float
    hbm_bw: float  # bytes/s per chip
    # Communication hierarchy (per-chip injection bandwidth, bytes/s)
    intra_node_bw: float  # NVLink / Infinity Fabric / single ICI hop
    inter_node_bw: float  # per-NIC (Frontier) / ICI across pod (TPU)
    inter_group_bw: float  # inter-switch-group / inter-pod DCI
    nics_per_node: int
    nodes_per_group: int  # paper's N_h (Rosetta switch group); TPU: pod nodes
    # GEMM efficiency curve: sorted {min_dim_size: efficiency}
    gemm_eff: Tuple[Tuple[int, float], ...] = (
        (0, 0.05), (64, 0.2), (128, 0.4), (256, 0.6), (512, 0.75),
        (1024, 0.85), (2048, 0.92),
    )
    attn_eff: float = 0.55  # flash-attention fraction-of-peak
    link_bw: float = 0.0  # roofline "per-link" constant (defaults intra_node)
    # Reliability / checkpoint pricing (Young–Daly inputs).
    mtbf_chip_s: float = 5.4e8  # per-chip mean time between failures (s)
    ckpt_write_bw: float = 2.5e8  # sustained ckpt bytes/s per chip (PFS/GCS)
    ckpt_latency_s: float = 2.0  # fixed per-checkpoint overhead (barrier+open)
    restart_s: float = 300.0  # scheduler requeue + init + restore overhead
    # Expert-migration link (paper Table IV prices rebalance transfers at
    # the 50 GB/s intra-node fabric; defaults to intra_node_bw).
    migration_bw: float = 0.0

    def __post_init__(self):
        if self.link_bw == 0.0:
            object.__setattr__(self, "link_bw", self.intra_node_bw)
        if self.migration_bw == 0.0:
            object.__setattr__(self, "migration_bw", self.intra_node_bw)

    @property
    def fast_domain(self) -> int:
        """Chips within the single-hop fast interconnect (paper Eq 10 bound:
        g * N_h)."""
        return self.chips_per_node * self.nodes_per_group

    def gemm_efficiency(self, min_dim: int) -> float:
        """Fraction of peak for a GEMM whose smallest M/N/K dim is min_dim —
        the skinny-GEMM penalty of paper Fig 4."""
        keys = [k for k, _ in self.gemm_eff]
        idx = bisect.bisect_right(keys, max(min_dim, 0)) - 1
        return self.gemm_eff[max(idx, 0)][1]


# The paper's platform: Frontier.  One MI250X GCD is one "GPU".
FRONTIER = Platform(
    name="frontier-mi250x",
    chips_per_node=8,  # 4 MI250X cards = 8 GCDs
    peak_flops=191.5e12,  # fp16/bf16 per GCD
    hbm_bytes=64e9,
    hbm_bw=1.6e12,
    intra_node_bw=50e9,  # Infinity Fabric (paper Table IV uses 50 GB/s)
    inter_node_bw=25e9,  # 200 Gb/s Slingshot NIC
    inter_group_bw=12.5e9,  # inter-group Dragonfly (oversubscribed)
    nics_per_node=4,
    nodes_per_group=4,  # Rosetta switch group (paper N_h = 4)
    mtbf_chip_s=5.4e8,  # ~17 chip-years: O(10h) job MTBF at 16k GCDs
    ckpt_write_bw=2.5e8,  # Lustre PFS, per-GCD share of aggregate
    ckpt_latency_s=2.0,
    restart_s=300.0,  # Slurm requeue + launch
)

# The port's card: one NVIDIA H100 SXM5 80GB of a DGX H100 node.
H100 = Platform(
    name="h100-sxm",
    # DGX H100 layout: 8 GPUs a node on NVLink 4 through NVSwitch.
    chips_per_node=8,
    # NVIDIA H100 SXM5 datasheet: dense bf16 tensor-core peak, HBM3
    # capacity and bandwidth.
    peak_flops=989.4e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    # DGX H100 layout, not measurable on one card: NVLink 4 at 900 GB/s a
    # GPU, 450 GB/s each direction; one 400 Gb/s ConnectX-7 NIC a GPU
    # (50 GB/s), 8 a node.
    intra_node_bw=450e9,
    inter_node_bw=50e9,
    nics_per_node=8,
    # Assumption, not measured: the DGX SuperPOD scalable unit, 32 nodes
    # (256 GPUs) on one rail-optimised leaf layer, is the single-hop
    # group, and the spine between units is non-blocking (the reference
    # architecture's), so a GPU's NIC rate holds across groups too.
    nodes_per_group=32,
    inter_group_bw=50e9,
    # Measured on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md, "Model vs
    # measured on the H100"): chip_smoke.py phase "model", expert_gemm_curve
    # in bf16 at granite-moe-3b-a800m's widths, (4096 tokens, d_model 1536)
    # x (1536, d_ffn): achieved FLOP/s over peak_flops at each d_ffn (the
    # key 0 row is d_ffn 32's).
    gemm_eff=(
        (0, 0.0668), (64, 0.1191), (128, 0.2329), (256, 0.3284), (512, 0.5415),
        (1024, 0.6321), (2048, 0.6855),
    ),
    # Measured likewise, in the same run: attention_curve, bf16, 24 x 64,
    # flash_attention/tc, mean over s = 512, 1024, 2048, 4096 (0.0700,
    # 0.1332, 0.1794, 0.2242) of the reference's 4 s^2 d_model FLOPs over
    # the time, over peak_flops.
    attn_eff=0.1517,
    # Measured on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md, the
    # full-depth checkpoint): granite's 39,590,200,324 bytes saved by
    # launch/train.py --ckpt-dir (CRC32 and .npy writes) in 29.82 s.
    ckpt_write_bw=39_590_200_324 / 29.82,
    # mtbf_chip_s, ckpt_latency_s and restart_s: the Platform defaults,
    # not measured for this card.
)


PLATFORMS: Dict[str, Platform] = {p.name: p for p in (FRONTIER, H100)}


def get_platform(name: str) -> Platform:
    """A platform by its ``name`` (``TrainerConfig.platform``)."""
    return PLATFORMS[name]
