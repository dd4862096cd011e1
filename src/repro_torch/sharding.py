"""Mesh plan: Piper's PP x EP x DP layout over ``torch.distributed`` ranks.

The port of ``repro.sharding``.  The reference refines a device mesh
``(data, model)`` or ``(pod, data, model)`` into ``(pod, data, ep, tp)``
with ``ep = gcd(E, |model|)`` and ``tp = |model| / ep`` (tp innermost); here
the same grid is laid over the ranks of the default process group in
row-major order, ``rank = ((p * D + d) * ep + e) * tp + t``, and each axis
the model reduces, exchanges or hands off over gets its own process group:

* the **EP group** of a rank: the ``ep`` ranks that share its (p, d, t);
  its expert-parallel all-to-all runs there (the reference's runs over
  "ep" only), and the rank's group rank is e;
* the **data group**: the ``D`` ranks that share its (p, e, t); a serving
  decode batch is split over it when D divides it, and the decode MoE
  metrics are meaned over it (the reference's ``metric_axes = dp_spec``);
* the **expert-gradient group**: the ``D * tp`` ranks that share its
  (p, e), which hold the same expert slots of the same stage and sum their
  expert gradients (the data group itself when tp = 1);
* the **stage group**: the ``D * ep * tp`` ranks of its pipeline stage p,
  which hold the same stage's non-expert weights; the token-sharded MoE
  metrics (aux losses, expert loads) are meaned over it;
* the **pp group**: the ``P`` ranks that share its (d, e, t), one a stage,
  between which the pipeline hands microbatches off
  (``core.pipeline``);
* the **world**: every rank; the embedding and head gradients are summed
  over it;
* with ``hierarchical_a2a``, HALO's lane and node subgroups of the EP group
  (``core.halo``), keyed by (p, d, t) as the EP group is.

Without ``pipeline_on_pod`` the pod axis joins data, as the reference's
``dp_axes = ("pod", "data")`` does: the grid is ``(P * D, model)`` and the
stage group is the world.  With it, ``pp = P`` stages run the schedule
``schedule`` (``vstages`` virtual stages a stage for ``interleaved_1f1b``)
over ``microbatches`` microbatches (None: 2 * PP), the hand-offs in int8
with ``compress_p2p`` (``core.compression``).

Layout (the reference's expert-data parallelism): non-expert weights are
replicated within a stage, each EP rank holds the physical expert slots
``[e * E_l, (e + 1) * E_l)``, and every rank routes its own tokens: a tp
lane is one more token-parallel lane of its EP group.  The slots' d_ff is
split over the expert-gradient group (the reference's ZeRO-3 of the
``"expert_ffn"`` dim over ("data", "tp")): with ``n = D * tp > 1`` dividing
the expert d_ff, the rank at (d, t) holds slice ``d * tp + t`` of ``n``
(data-major, tp-minor) of every expert leaf's d_ff (``w_up`` / ``w_gate``
dim -1, ``w_down`` dim -2) and of its moments, and the MoE layer
all-gathers the compute-dtype slices over the group (:func:`gather_ffn`,
whose backward sums the gradient over it and keeps the rank's slice).
Where ``n`` does not divide d_ff the slots stay whole on every rank, as
before (the reference's ``shard_map`` refuses such a grid).  Without a
pod pipeline the pod joins data, so n counts it too.

The plan also carries the reference plan's memory policy: ``remat`` of
each layer rep in training (none | dots | full, ``models.transformer``)
and ``optimizer_dtype``, the Adam moments' dtype (``optim``).

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

from repro_torch.configs.base import DEFAULT_SCHEDULE, SCHEDULES, ArchConfig
from repro_torch.core.halo import _pick_inner, lane_groups, node_groups

REMAT_MODES = ("none", "dots", "full")
OPTIMIZER_DTYPES = ("float32", "bfloat16")


def choose_ep(num_experts: int, model_axis: int) -> int:
    """Largest EP degree that divides both the expert count (paper Eq 8)
    and the fast-domain axis size (paper Eq 10)."""
    return math.gcd(num_experts, model_axis)


@dataclass
class MeshPlan:
    """A (pod, data, ep, tp) grid over the default process group and this
    rank's place in it.  ``ep_group``, ``dp_group``, ``expert_dp_group``,
    ``stage_group``, ``pp_group``, ``world_group``, ``lane_group`` and
    ``node_group`` are process groups, or None where the group is one rank
    (or, for the HALO pair, where HALO is off or degenerates to the flat
    collective).
    ``pp`` > 1 only with ``pipeline_on_pod`` (``make_plan``); the pipeline
    fields are consulted only then.  ``ffn_split`` > 1: each expert leaf
    holds this rank's slice ``ffn_rank`` of the d_ff (module docstring)."""

    dp: int
    ep: int
    tp: int = 1
    rank: int = 0
    hierarchical_a2a: bool = False
    a2a_chunks: int = 1
    g1: int = 1  # HALO lane width; 1 = flat
    pp: int = 1
    # Pipeline schedule (a core.schedules builder name) and virtual stages
    # a stage (> 1 only with interleaved_1f1b; must divide the layer reps
    # a stage); microbatches (None: 2 * pp); int8 hand-offs.
    schedule: str = DEFAULT_SCHEDULE
    vstages: int = 1
    microbatches: Optional[int] = None
    compress_p2p: bool = False
    # The batch-sharding axes, as the reference names them: ("pod", "data")
    # where a pod axis joined data, else ("data",).
    dp_axes: Tuple[str, ...] = ("data",)
    # The memory policy: remat of each layer rep (none | dots | full) and
    # the Adam moments' dtype, the reference plan's defaults.
    remat: str = "full"
    optimizer_dtype: str = "float32"
    # d_ff slices of the expert leaves over the expert-gradient group: D *
    # tp where that divides the expert d_ff, else 1 (whole slots);
    # ``ffn_whole`` says why a grid of several such ranks keeps them whole.
    ffn_split: int = 1
    ffn_whole: str = ""
    world_group: Optional[object] = None
    ep_group: Optional[object] = None
    dp_group: Optional[object] = None
    expert_dp_group: Optional[object] = None
    stage_group: Optional[object] = None
    pp_group: Optional[object] = None
    lane_group: Optional[object] = None
    node_group: Optional[object] = None

    def __post_init__(self):
        if self.a2a_chunks < 1:
            raise ValueError(f"a2a_chunks must be >= 1, got {self.a2a_chunks}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; choose from "
                             f"{SCHEDULES}")
        if self.vstages < 1 or (self.vstages > 1 and self.schedule != "interleaved_1f1b"):
            raise ValueError(f"vstages={self.vstages} needs schedule='interleaved_1f1b', "
                             f"got {self.schedule!r}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat {self.remat!r}; choose from {REMAT_MODES}")
        if self.optimizer_dtype not in OPTIMIZER_DTYPES:
            raise ValueError(f"unknown optimizer_dtype {self.optimizer_dtype!r}; choose "
                             f"from {OPTIMIZER_DTYPES}")

    @property
    def world(self) -> int:
        return self.pp * self.dp * self.ep * self.tp

    @property
    def stage_size(self) -> int:
        """Ranks a pipeline stage: D * ep * tp."""
        return self.dp * self.ep * self.tp

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This rank's (d, e, t) within its stage."""
        t = self.rank % self.tp
        e = (self.rank // self.tp) % self.ep
        return (self.rank // (self.ep * self.tp)) % self.dp, e, t

    @property
    def pp_rank(self) -> int:
        """This rank's pipeline stage p."""
        return self.rank // self.stage_size

    @property
    def stage_rank(self) -> int:
        """This rank's place in its stage group, (d * ep + e) * tp + t."""
        return self.rank % self.stage_size

    @property
    def ep_rank(self) -> int:
        return self.coords[1]

    @property
    def ffn_rank(self) -> int:
        """This rank's d_ff slice of the expert leaves, d * tp + t (its place
        in the expert-gradient group)."""
        d, _, t = self.coords
        return d * self.tp + t

    @property
    def num_microbatches(self) -> int:
        return self.microbatches or 2 * self.pp

    @property
    def a2a_algo(self) -> str:
        return "halo" if self.hierarchical_a2a else "flat"

    def stage_peer(self, p: int) -> int:
        """The global rank at stage ``p`` with this rank's (d, e, t)."""
        return p * self.stage_size + self.stage_rank

    def describe(self) -> str:
        """The reference launcher's ``[mesh]`` line."""
        return (f"[mesh] devices={self.world} ep={self.ep} tp={self.tp} pp={self.pp} "
                f"dp_axes={self.dp_axes} a2a={self.a2a_algo} x{self.a2a_chunks} chunks"
                + (f" schedule={self.schedule}" if self.pp > 1 else "")
                + (f" vstages={self.vstages}" if self.pp > 1 and self.vstages > 1 else "")
                + (" compress_p2p" if self.pp > 1 and self.compress_p2p else "")
                + (f" experts=d_ff/{self.ffn_split} (data x tp)" if self.ffn_split > 1
                   else f" experts whole ({self.ffn_whole})" if self.ffn_whole else ""))


def _keep(plan: MeshPlan, attr: str, ranks: Sequence[int], mine: bool) -> None:
    """``dist.new_group(ranks)``, called on every rank (it is collective);
    the ranks in it store it as ``plan.<attr>``.  A one-rank group is not
    created and stays None."""
    if len(ranks) > 1:
        g = dist.new_group(list(ranks))
        if mine:
            setattr(plan, attr, g)


def make_plan(arch: ArchConfig, mesh_shape: Sequence[int], *,
              pipeline_on_pod: bool = False, schedule: str = DEFAULT_SCHEDULE,
              vstages: int = 1, microbatches: Optional[int] = None,
              compress_p2p: bool = False, hierarchical_a2a: bool = False,
              a2a_chunks: int = 1, remat: str = "full",
              optimizer_dtype: str = "float32") -> MeshPlan:
    """Bind ``arch`` to a ``(data, model)`` or ``(pod, data, model)`` grid
    over the initialised default process group (whose size must be the
    grid's), refining the model axis into (ep, tp) by the expert count, and
    create its groups (on the world's backend).  With ``pipeline_on_pod``
    the pod axis is the pipeline (pp = P); without it the pod joins data.
    ``remat`` and ``optimizer_dtype``: the memory policy.  The expert d_ff
    is split over D * tp ranks where that divides it (module docstring)."""
    if len(mesh_shape) not in (2, 3):
        raise ValueError(f"mesh {tuple(mesh_shape)}: need (data, model) or "
                         f"(pod, data, model)")
    pod = int(mesh_shape[0]) if len(mesh_shape) == 3 else 1
    data, model = (int(n) for n in mesh_shape[-2:])
    if pipeline_on_pod and len(mesh_shape) != 3:
        raise ValueError("pipeline_on_pod requires a pod axis")
    pp = pod if pipeline_on_pod else 1
    if not pipeline_on_pod:
        data *= pod
    n_exp = arch.moe.num_experts if arch.moe is not None else model
    ep = choose_ep(n_exp, model)
    tp = model // ep
    world = pp * data * model
    n = data * tp
    ffn_split, ffn_whole = 1, ""
    if arch.moe is not None and n > 1:
        if arch.moe.d_ff % n:
            ffn_whole = f"d_ff {arch.moe.d_ff} % (data x tp = {n}) != 0"
        else:
            ffn_split = n
    kw = dict(hierarchical_a2a=hierarchical_a2a, a2a_chunks=a2a_chunks, pp=pp,
              schedule=schedule, vstages=vstages, microbatches=microbatches,
              compress_p2p=compress_p2p, remat=remat, optimizer_dtype=optimizer_dtype,
              ffn_split=ffn_split, ffn_whole=ffn_whole,
              dp_axes=("pod", "data") if len(mesh_shape) == 3 and not pipeline_on_pod
              else ("data",))
    if world == 1:
        return MeshPlan(dp=1, ep=1, **kw)
    if not dist.is_initialized() or dist.get_world_size() != world:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise ValueError(f"mesh {','.join(map(str, mesh_shape))} needs {world} ranks, "
                         f"have {have}")
    plan = MeshPlan(dp=data, ep=ep, tp=tp, rank=dist.get_rank(), **kw)
    d, e, t = plan.coords
    p, n = plan.pp_rank, plan.stage_size

    def at(pp_, dd, ee, tt):
        return ((pp_ * data + dd) * ep + ee) * tp + tt

    plan.world_group = dist.group.WORLD
    plan.stage_group = plan.world_group if pp == 1 else None
    # Every rank creates every group in the same order (new_group is
    # collective); each rank keeps its own.
    if pp > 1:
        for pp_ in range(pp):
            _keep(plan, "stage_group", [pp_ * n + x for x in range(n)], pp_ == p)
        for x in range(n):
            _keep(plan, "pp_group", [pp_ * n + x for pp_ in range(pp)], x == plan.stage_rank)
    for pp_ in range(pp):
        for dd in range(data):
            for tt in range(tp):
                _keep(plan, "ep_group", [at(pp_, dd, x, tt) for x in range(ep)],
                      (pp_, dd, tt) == (p, d, t))
        for ee in range(ep):
            for tt in range(tp):
                _keep(plan, "dp_group", [at(pp_, x, ee, tt) for x in range(data)],
                      (pp_, ee, tt) == (p, e, t))
            if tp > 1:
                _keep(plan, "expert_dp_group",
                      [at(pp_, x, ee, tt) for x in range(data) for tt in range(tp)],
                      (pp_, ee) == (p, e))
    if tp == 1:
        plan.expert_dp_group = plan.dp_group
    g1 = _pick_inner(ep)
    if hierarchical_a2a and 1 < g1 < ep:
        plan.g1 = g1
        for pp_ in range(pp):
            for dd in range(data):
                for tt in range(tp):
                    mine = (pp_, dd, tt) == (p, d, t)
                    for lanes in lane_groups(ep, g1):
                        _keep(plan, "lane_group", [at(pp_, dd, x, tt) for x in lanes],
                              mine and e in lanes)
                    for nodes in node_groups(ep, g1):
                        _keep(plan, "node_group", [at(pp_, dd, x, tt) for x in nodes],
                              mine and e in nodes)
    if pp > 1:
        # The pipeline's hand-offs are batched point-to-point calls on the
        # world group, and NCCL wants every rank of a group in its first
        # such call: a barrier first makes that hold.
        dist.barrier()
    return plan


def single_device_plan(arch: ArchConfig, *, remat: str = "full",
                       optimizer_dtype: str = "float32") -> MeshPlan:
    """A one-rank plan: no process group, no collectives."""
    return make_plan(arch, (1, 1), remat=remat, optimizer_dtype=optimizer_dtype)


def remat_of(plan) -> str:
    """The remat mode of ``plan``; the reference plan's default ("full")
    without one."""
    return "full" if plan is None else plan.remat


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


def ffn_dim(path: str) -> int:
    """The d_ff dim of an expert leaf (its path or key) ``w_up`` /
    ``w_gate`` (-1) or ``w_down`` (-2), counted from the end."""
    return -2 if path.rpartition("/")[2] == "w_down" else -1


def split_paths(flat, plan) -> set:
    """The expert paths of a flat tree whose leaves ``plan`` splits along
    the d_ff (none without a split)."""
    if plan is None or plan.ffn_split == 1:
        return set()
    return expert_paths(flat)


class _GatherFFN(torch.autograd.Function):
    """An expert leaf's d_ff slices, cast to ``dtype`` and all-gathered over
    the expert-gradient group in (d, t) order along ``dim``.  The backward
    sums the gradient in fp32 over the group and keeps this rank's slice
    (an all-reduce and a slice: gloo has no reduce-scatter), in the dtype
    of the slice it was given: the fp32 master's, so the sum is not
    rounded to the compute dtype."""

    @staticmethod
    def forward(ctx, w, dtype, dim, plan):
        ctx.dim, ctx.group, ctx.size = dim, plan.expert_dp_group, w.shape[dim]
        ctx.start = plan.ffn_rank * ctx.size
        wc = w.to(dtype).contiguous()
        parts = [torch.empty_like(wc) for _ in range(plan.ffn_split)]
        dist.all_gather(parts, wc, group=ctx.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        all_reduce_(g, ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.size).contiguous(), None, None, None


def gather_ffn(params, plan, dtype: torch.dtype):
    """An MoE block's ``params`` with every expert leaf whole along its d_ff,
    in ``dtype`` (:class:`_GatherFFN`); ``params`` itself without a split.
    Collective over the expert-gradient group."""
    if plan is None or plan.ffn_split == 1:
        return params
    out = dict(params)
    for k in EXPERT_KEYS:
        if params.get(k) is not None:
            w = params[k]
            out[k] = _GatherFFN.apply(w, dtype, w.dim() + ffn_dim(k), plan)
    return out


def sum_leaves_(leaves, group) -> None:
    """Sum a list of tensors over ``group`` in place, as one flat bucket."""
    if group is None or not leaves:
        return
    buf = all_reduce_(torch.cat([t.reshape(-1) for t in leaves]), group)
    for t, part in zip(leaves, buf.split([t.numel() for t in leaves])):
        t.copy_(part.view_as(t))


def reduce_grads_(grads, plan) -> None:
    """Sum this rank's partial gradients (a params-shaped tree, None for
    integer tables) in place into the global ones: the non-expert block
    leaves over the stage group (the ranks that hold the same stage), the
    expert leaves over the expert-gradient group (the data ranks and tp
    lanes that hold the same slots of the same stage) unless the plan
    splits them (their backward summed them already, :func:`gather_ffn`),
    and ``embed``, ``final_norm`` and ``lm_head`` over the world (every
    stage's and data rank's part; the reference's sum over stages)."""
    from repro_torch.models.model import tree_paths  # the model imports this module

    flat = {k: g for k, g in tree_paths(grads).items() if g is not None}
    experts = expert_paths(flat)
    dense = [k for k in flat if k not in experts]
    if plan.pp > 1:
        sum_leaves_([flat[k] for k in dense if k.startswith("blocks/")], plan.stage_group)
        dense = [k for k in dense if not k.startswith("blocks/")]
    sum_leaves_([flat[k] for k in dense], plan.world_group)
    if plan.ffn_split == 1:
        sum_leaves_([flat[k] for k in sorted(experts)], plan.expert_dp_group)
