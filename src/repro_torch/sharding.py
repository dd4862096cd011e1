"""Mesh plan: Piper's EP x DP layout over ``torch.distributed`` ranks.

The port of ``repro.sharding``.  The reference refines a device mesh
``(data, model)`` into ``(data, ep, tp)`` with ``ep = gcd(E, |model|)``; here
the same grid is laid over the ranks of the default process group in
row-major order, ``rank = (d * ep + e) * tp + t``, and each axis the MoE
layer reduces or exchanges over gets its own process group:

* the **EP group** of a rank: the ``ep`` ranks that share its (d, t); its
  expert-parallel all-to-all runs there, and the rank's group rank is e;
* the **data group**: the ``D`` ranks that share its (e, t), which hold the
  same expert slots and sum their gradients;
* the **world**: every rank; the non-expert gradients and the token-sharded
  aux-loss totals are summed over it;
* with ``hierarchical_a2a``, HALO's lane and node subgroups of the EP group
  (``core.halo``).

Layout (the reference's expert-data parallelism): non-expert weights are
replicated, each EP rank holds the physical expert slots
``[e * E_l, (e + 1) * E_l)`` whole, and every rank routes its own tokens.
TP > 1 is refused: it waits for the pipeline executor (ROADMAP Queue 1
item 3).

``dist.new_group`` is collective over the whole world: every rank creates
every group, its own or not, in one fixed order, or the run hangs.  A
group of one rank is kept as ``None`` and every collective over it is
skipped (a sum over one rank is the value itself).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.halo import _pick_inner, lane_groups, node_groups

TP_TODO = ("tensor parallelism (tp > 1) is not ported yet (ROADMAP.md Queue 1, "
           "item 3)")


def choose_ep(num_experts: int, model_axis: int) -> int:
    """Largest EP degree that divides both the expert count (paper Eq 8)
    and the fast-domain axis size (paper Eq 10)."""
    return math.gcd(num_experts, model_axis)


@dataclass
class MeshPlan:
    """A (data, ep, tp) grid over the default process group and this
    rank's place in it.  ``ep_group``, ``dp_group``, ``world_group``,
    ``lane_group`` and ``node_group`` are process groups, or None where the
    group is one rank (or, for the HALO pair, where HALO is off or
    degenerates to the flat collective)."""

    dp: int
    ep: int
    tp: int = 1
    rank: int = 0
    hierarchical_a2a: bool = False
    a2a_chunks: int = 1
    g1: int = 1  # HALO lane width; 1 = flat
    world_group: Optional[object] = None
    ep_group: Optional[object] = None
    dp_group: Optional[object] = None
    lane_group: Optional[object] = None
    node_group: Optional[object] = None

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(TP_TODO)
        if self.a2a_chunks < 1:
            raise ValueError(f"a2a_chunks must be >= 1, got {self.a2a_chunks}")

    @property
    def world(self) -> int:
        return self.dp * self.ep * self.tp

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This rank's (d, e, t)."""
        t = self.rank % self.tp
        e = (self.rank // self.tp) % self.ep
        return self.rank // (self.ep * self.tp), e, t

    @property
    def ep_rank(self) -> int:
        return self.coords[1]

    @property
    def a2a_algo(self) -> str:
        return "halo" if self.hierarchical_a2a else "flat"

    def describe(self) -> str:
        """The reference launcher's ``[mesh]`` line."""
        return (f"[mesh] devices={self.world} ep={self.ep} tp={self.tp} pp=1 "
                f"dp_axes=('data',) a2a={self.a2a_algo} x{self.a2a_chunks} chunks")


def _keep(plan: MeshPlan, attr: str, ranks: Sequence[int], mine: bool) -> None:
    """``dist.new_group(ranks)``, called on every rank (it is collective);
    the ranks in it store it as ``plan.<attr>``.  A one-rank group is not
    created and stays None."""
    if len(ranks) > 1:
        g = dist.new_group(list(ranks))
        if mine:
            setattr(plan, attr, g)


def make_plan(arch: ArchConfig, mesh_shape: Sequence[int], *,
              hierarchical_a2a: bool = False, a2a_chunks: int = 1) -> MeshPlan:
    """Bind ``arch`` to a ``(data, model)`` grid over the initialised
    default process group (whose size must be data * model), refining the
    model axis into (ep, tp) by the expert count, and create its groups
    (on the world's backend)."""
    if len(mesh_shape) != 2:
        raise ValueError(f"mesh {tuple(mesh_shape)}: need (data, model); the pod "
                         f"axis waits for the pipeline executor (ROADMAP.md Queue 1, "
                         f"item 3)")
    data, model = (int(n) for n in mesh_shape)
    n_exp = arch.moe.num_experts if arch.moe is not None else model
    ep = choose_ep(n_exp, model)
    tp = model // ep
    if tp != 1:
        raise NotImplementedError(f"mesh {data},{model}: ep = gcd({n_exp}, {model}) = "
                                  f"{ep}, tp = {tp}; {TP_TODO}")
    world = data * model
    if world == 1:
        return MeshPlan(dp=1, ep=1, hierarchical_a2a=hierarchical_a2a,
                        a2a_chunks=a2a_chunks)
    if not dist.is_initialized() or dist.get_world_size() != world:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise ValueError(f"mesh {data},{model} needs {world} ranks, have {have}")
    rank = dist.get_rank()
    plan = MeshPlan(dp=data, ep=ep, rank=rank, hierarchical_a2a=hierarchical_a2a,
                    a2a_chunks=a2a_chunks)
    d, e, _ = plan.coords
    plan.world_group = dist.group.WORLD
    # Every rank creates every group in the same order (new_group is
    # collective); each rank keeps its own.
    for dd in range(data):
        _keep(plan, "ep_group", [dd * ep + x for x in range(ep)], dd == d)
    for ee in range(ep):
        _keep(plan, "dp_group", [x * ep + ee for x in range(data)], ee == e)
    g1 = _pick_inner(ep)
    if hierarchical_a2a and 1 < g1 < ep:
        plan.g1 = g1
        for dd in range(data):
            for lanes in lane_groups(ep, g1):
                _keep(plan, "lane_group", [dd * ep + x for x in lanes],
                      dd == d and e in lanes)
            for nodes in node_groups(ep, g1):
                _keep(plan, "node_group", [dd * ep + x for x in nodes],
                      dd == d and e in nodes)
    return plan


def single_device_plan(arch: ArchConfig) -> MeshPlan:
    """A one-rank plan: no process group, no collectives."""
    return make_plan(arch, (1, 1))


# ---------------------------------------------------------------------------
# Sums over a group (None: one rank, nothing to do)
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangent over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``."""
    return x if group is None else _AllReduce.apply(x, group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


EXPERT_KEYS = ("w_up", "w_gate", "w_down")


def expert_paths(flat) -> set:
    """The expert-sharded leaves of a flat ``{path: leaf}`` param tree
    (``models.model.tree_paths``): the MoE FFNs' ``w_up``, ``w_gate`` and
    ``w_down``, whose dim 1 (after the reps dim) is the expert slot; an
    MoE FFN is the one with a ``w_router``."""
    out = set()
    for path in flat:
        head, _, key = path.rpartition("/")
        if key in EXPERT_KEYS and f"{head}/w_router" in flat:
            out.add(path)
    return out


def sum_leaves_(leaves, group) -> None:
    """Sum a list of tensors over ``group`` in place, as one flat bucket."""
    if group is None or not leaves:
        return
    buf = all_reduce_(torch.cat([t.reshape(-1) for t in leaves]), group)
    for t, part in zip(leaves, buf.split([t.numel() for t in leaves])):
        t.copy_(part.view_as(t))
