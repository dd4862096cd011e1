"""Analytical all-to-all latency model: flat vs HALO (paper §V, Fig 5/8).

The port's copy of ``repro.core.comm_model``, number for number
(``tests/test_torch_planner.py`` holds the two equal).  The port has no
expert parallelism yet, so nothing here is executed: it prices.

Models a three-level hierarchy (paper: intra-node / intra-switch-group /
inter-group on Dragonfly; TPU: intra-host ICI / intra-pod ICI / inter-pod
DCI) and predicts

* **flat** all-to-all (RCCL / single lax.all_to_all): every rank pair
  exchanges directly; the slowest traversed level is hit by ALL traffic that
  crosses it, and a topology-oblivious schedule serializes through shared
  links (contention factor).
* **HALO** (Alg 1): Phase I intra-node a2a ∥ (Phase II inter-node exchange ->
  Phase III intra-node redistribution), with per-NIC affinity so all NICs
  inject concurrently.  T = max(T_I, T_II + T_III) per the dependency
  structure (Eq 13).

This is how we reproduce the paper's Fig 8 "1.1x–9x" band without Frontier
hardware; benchmarks/fig8 sweeps node counts x message sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.platform import Platform


@dataclass(frozen=True)
class A2ACase:
    """One all-to-all instance: n_ranks ranks each holding n_ranks rows of
    ``row_bytes`` (rank r sends row j to rank j)."""

    n_ranks: int
    row_bytes: float


def _levels(platform: Platform, n_ranks: int):
    g = platform.chips_per_node
    nodes = max(n_ranks // g, 1)
    groups = max(nodes // platform.nodes_per_group, 1)
    return g, nodes, groups


def flat_a2a_time(case: A2ACase, platform: Platform, latency: float = 5e-6) -> float:
    """Topology-oblivious flat all-to-all.

    Each rank sends (n-1) rows.  Traffic crossing node boundary per NIC is
    serialized with a contention factor when multiple GPUs share a NIC
    (paper §V-A: RCCL does not respect GPU->NIC affinity), and inter-group
    rows traverse the slowest links.
    """
    n = case.n_ranks
    g, nodes, groups = _levels(platform, n)
    if n <= 1:
        return 0.0
    intra_rows = min(g, n) - 1
    t_intra = intra_rows * case.row_bytes / platform.intra_node_bw

    if nodes <= 1:
        return t_intra + latency * n
    # rows leaving the node, per GPU
    inter_rows = n - min(g, n)
    # flat algorithm: GPUs contend for NICs (no affinity): effective per-GPU
    # injection bandwidth is nics/g of a NIC.
    nic_share = platform.inter_node_bw * platform.nics_per_node / g
    t_inter = inter_rows * case.row_bytes / nic_share

    if groups > 1:
        # fraction of inter-node rows that cross the group boundary
        frac_xgroup = (nodes - platform.nodes_per_group) / nodes
        xgroup_rows = inter_rows * frac_xgroup
        # oblivious schedule: bursts collide on the sparse global links
        contention = 2.0
        t_xgroup = (
            xgroup_rows
            * case.row_bytes
            / (platform.inter_group_bw * platform.nics_per_node / g)
            * contention
        )
        t_inter = max(t_inter, t_xgroup)
    return max(t_intra, t_inter) + latency * n


def halo_a2a_time(case: A2ACase, platform: Platform, latency: float = 5e-6) -> float:
    """HALO (Alg 1): three phases, Phase I ∥ (Phase II -> Phase III)."""
    n = case.n_ranks
    g, nodes, groups = _levels(platform, n)
    if n <= 1:
        return 0.0
    # Phase I: intra-node a2a of local rows.
    t1 = (min(g, n) - 1) * case.row_bytes / platform.intra_node_bw + latency * g

    if nodes <= 1:
        return t1
    # Phase II: batched inter-node exchange; each GPU talks only to its
    # NIC-affine peers => all NICs saturate with no contention.  Rows for a
    # whole remote node are aggregated into one message per node.
    inter_rows = n - min(g, n)
    t2_nic = inter_rows * case.row_bytes / platform.inter_node_bw
    if groups > 1:
        frac_xgroup = (nodes - platform.nodes_per_group) / nodes
        t2_xgroup = (
            inter_rows * frac_xgroup * case.row_bytes / platform.inter_group_bw
        )
        t2 = max(t2_nic, t2_xgroup) + latency * (nodes - 1)
    else:
        t2 = t2_nic + latency * (nodes - 1)
    # Phase III: intra-node redistribution of the received remote rows.
    t3 = inter_rows * case.row_bytes * (g - 1) / g / platform.intra_node_bw + latency * g
    return max(t1, t2 + t3)


def speedup(case: A2ACase, platform: Platform) -> float:
    f = flat_a2a_time(case, platform)
    h = halo_a2a_time(case, platform)
    return f / h if h > 0 else 1.0


# ---------------------------------------------------------------------------
# Chunked double-buffered overlap (ROADMAP direction 2)
# ---------------------------------------------------------------------------


def a2a_time(
    case: A2ACase, platform: Platform, algo: str, latency: float = 5e-6
) -> float:
    """One collective of ``case`` under the named algorithm."""
    assert algo in ("flat", "halo"), algo
    f = flat_a2a_time if algo == "flat" else halo_a2a_time
    return f(case, platform, latency)


def chunked_a2a_time(
    case: A2ACase, platform: Platform, algo: str, chunks: int,
    latency: float = 5e-6,
) -> float:
    """K back-to-back transfers of 1/K the rows (NO compute to hide
    behind): the bandwidth term is unchanged, but the per-collective
    latency (and any per-message fixed cost inside the algo model) is paid
    K times — chunking alone is never free, which is why an optimal K
    exists once compute enters the picture."""
    assert chunks >= 1, chunks
    sub = A2ACase(case.n_ranks, case.row_bytes / chunks)
    return chunks * a2a_time(sub, platform, algo, latency)


def overlapped_layer_time(
    case: A2ACase, platform: Platform, algo: str, chunks: int,
    t_comp: float, latency: float = 5e-6,
) -> float:
    """Closed form for the double-buffered dispatch -> expert FFN ->
    combine pipeline of one MoE-layer pass (models.moe / halo.overlapped_a2a):

        T ≈ T_a2a(chunk_0) + max(T_comp, T_a2a) · (K−1) + tail

    with per-chunk transfer cost c = dispatch + combine of 1/K the rows
    (each paying the per-collective latency) and per-chunk compute
    p = t_comp / K.  Chunk 0's dispatch cannot be hidden (pipeline fill),
    the K−1 steady-state slots each take max(c, p), and the tail is the
    last chunk's compute + combine drain.  K = 1 reduces exactly to the
    serial ``2·T_a2a(case) + t_comp``.  Larger K amortizes the fill/drain
    exposure (≈ c) but multiplies the latency term — the argmin over K is
    the planner's knob."""
    assert chunks >= 1, chunks
    sub = A2ACase(case.n_ranks, case.row_bytes / chunks)
    c = 2.0 * a2a_time(sub, platform, algo, latency)  # dispatch + combine
    p = t_comp / chunks
    return c + (chunks - 1) * max(c, p) + p


def exposed_a2a_time(
    case: A2ACase, platform: Platform, algo: str, chunks: int,
    t_comp: float, latency: float = 5e-6,
) -> float:
    """Seconds of the layer pass NOT hidden behind expert compute — what
    the resource model charges as exposed a2a.  Serial (K=1, flat) exposure
    is the full 2·T_a2a; in the bandwidth-rich regime (c < p) chunking
    shrinks it to ~2·T_a2a/K (the fill chunk)."""
    return overlapped_layer_time(
        case, platform, algo, chunks, t_comp, latency
    ) - t_comp


def best_a2a_config(
    case: A2ACase, platform: Platform, t_comp: float,
    algos=("flat", "halo"), chunk_candidates=(1, 2, 4, 8),
    latency: float = 5e-6,
) -> Dict[str, object]:
    """Pick (algo, chunks) minimizing the overlapped layer-pass time.
    Returns {"algo", "chunks", "t_layer", "t_exposed"}."""
    best = None
    for algo in algos:
        for K in chunk_candidates:
            t = overlapped_layer_time(case, platform, algo, K, t_comp,
                                      latency)
            if best is None or t < best["t_layer"]:
                best = {
                    "algo": algo,
                    "chunks": K,
                    "t_layer": t,
                    "t_exposed": t - t_comp,
                }
    return best


def effective_a2a_bandwidth(case: A2ACase, platform: Platform, algo: str) -> float:
    """Bytes/s/GPU achieved — the paper's Fig 5 metric."""
    total = (case.n_ranks - 1) * case.row_bytes
    t = (flat_a2a_time if algo == "flat" else halo_a2a_time)(case, platform)
    return total / t if t > 0 else float("inf")
