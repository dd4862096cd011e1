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
* the **model group**: the ``ep * tp`` ranks that share its (p, d), the
  reference's "model" axis, and the **sequence group**: a training batch's
  sequence is split over it (the reference's "seq" rule, ``("ep",
  "tp")``), the rank at (e, t) holding slice ``e * tp + t``
  (:attr:`MeshPlan.seq_rank`);
* the **stage group**: the ``D * ep * tp`` ranks of its pipeline stage p,
  which run the same stage's layers on their own tokens; the token-sharded
  MoE metrics (aux losses, expert loads) are meaned over it;
* the **pp group**: the ``P`` ranks that share its (d, e, t), one a stage,
  between which the pipeline hands microbatches off
  (``core.pipeline``);
* the **world**: every rank; the gradients of the weights no rule slices
  (norms, router) are summed over it;
* with ``hierarchical_a2a``, HALO's lane and node subgroups of the EP group
  (``core.halo``), keyed by (p, d, t) as the EP group is.

Without ``pipeline_on_pod`` the pod axis joins data, as the reference's
``dp_axes = ("pod", "data")`` does: the grid is ``(P * D, model)`` and the
stage group is the world.  With it, ``pp = P`` stages run the schedule
``schedule`` (``vstages`` virtual stages a stage for ``interleaved_1f1b``)
over ``microbatches`` microbatches (None: 2 * PP), the hand-offs in int8
with ``compress_p2p`` (``core.compression``).

The batch (the reference's ``batch_specs``, ``training.shard_batch``): a
rank holds its rows of the batch over data (pod x data without a pod
pipeline; under one, its rows of every microbatch) and its slice of the
sequence over (ep, tp), ``[j * s_l, (j + 1) * s_l)`` with ``j`` its
sequence rank and ``s_l = s / (ep * tp)``.  A layer that mixes positions
gathers what it needs over the sequence group (:func:`seq_gather`, one
all-gather a call whose backward sums the cotangent over the group and
keeps the slice): attention its K/V once a layer.  A Mamba2 mixer gathers
nothing: it hands state from rank to rank along the group
(:func:`seq_shift`, point-to-point, its backward the opposite shift).  A
prefill's batch is laid out alike; a decode batch's
rows go over data where D divides them (the reference's decode
``batch_specs``, ``("batch", None)``), and a dense attention cache's
positions over (ep, tp) (the "kv_seq" rule, :meth:`MeshPlan.kv_rows`):
each rank scores its query against its own rows and the sequence group
combines the softmax over them (``layers.kv_block_attention``).

Layout (the reference's rule table, ``MeshPlan.rules``, :func:`default_rules`).
Every parameter carries the reference's logical dim tags
(``models.model.ParamMeta.logical``), and the rules map a tag onto mesh
axes: "vocab" and "embed" (a matrix's d_model dim) over data ("vocab"
whole under a pod pipeline), "model_out" and "ssm_inner" over (ep, tp).  A
non-expert leaf holds, on each dim, the slice of the rank's coordinates
along that dim's axes (data-major, then ep, then tp), where the axes'
size product n > 1 divides the dim; a dim n does not divide stays whole
(``MeshPlan.whole``, named by :meth:`MeshPlan.describe`), and so do the
norms and the router, which no rule names.  A layer all-gathers its sliced
leaves where it uses them, in the compute dtype, one collective a group
(:func:`gather_block`, :func:`gather_leaves`: over the stage group for a
leaf sliced over data and (ep, tp), the data group for data alone, the
model group for (ep, tp) alone), and the gather's
backward sums the fp32 gradient over the stage's ranks, which all computed
parts of it, and keeps the slice (:func:`reduce_slice`).  The embedding is
gathered once a forward (under a pipeline once a step, at the executor's
entry).  Without ``pipeline_on_pod`` the pod joins data, and so the
slicing (the reference's "embed" rule names "data" alone: a port choice,
fewer bytes, the same function).

The experts (the reference's expert-data parallelism; the rules'
"expert" and "expert_ffn" entries, which ``make_plan`` reads into ``ep``
and ``ffn_split``): each EP rank holds the physical expert slots
``[e * E_l, (e + 1) * E_l)``, and every rank routes its own tokens: a tp
lane holds its own sequence slice and dispatches through its own EP
group.  The slots' d_ff is
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

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import DEFAULT_SCHEDULE, SCHEDULES, ArchConfig
from repro_torch.core.halo import _pick_inner, lane_groups, node_groups

REMAT_MODES = ("none", "dots", "full")
OPTIMIZER_DTYPES = ("float32", "bfloat16")
MESH_AXES = ("data", "ep", "tp")  # a stage's axes, in rank order
# The tags of the expert leaves: their slots and d_ff slices follow the
# plan's ``ep`` and ``ffn_split`` (the rules' "expert" and "expert_ffn"
# entries, which ``make_plan`` reads), not the per-dim layout.
EXPERT_TAGS = ("expert", "expert_ffn")

Rules = Dict[str, Optional[Tuple[str, ...]]]


def default_rules(pipeline_on_pod: bool = False) -> Rules:
    """The reference's rule table (``repro.sharding.default_rules``) for the
    parameter tags: tag -> the mesh axes its dim is sliced over (None:
    whole).  Under a pod pipeline the vocab dim stays whole, as there."""
    return {"vocab": None if pipeline_on_pod else ("data",), "embed": ("data",),
            "model_out": ("ep", "tp"), "ssm_inner": ("ep", "tp"),
            "expert": ("ep",), "expert_ffn": ("data", "tp")}


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
    holds this rank's slice ``ffn_rank`` of the d_ff (module docstring).
    ``rules`` and ``arch``: the non-expert leaves' layout (:attr:`layout`);
    a plan built by hand has no rules and keeps them whole."""

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
    # The rule table (tag -> mesh axes) and the arch whose tags it slices.
    rules: Rules = field(default_factory=dict)
    arch: Optional[ArchConfig] = field(default=None, repr=False, compare=False)
    world_group: Optional[object] = None
    ep_group: Optional[object] = None
    dp_group: Optional[object] = None
    model_group: Optional[object] = None
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
    def seq_size(self) -> int:
        """Sequence shards of a training batch: ep * tp (the "seq" rule)."""
        return self.ep * self.tp

    @property
    def seq_rank(self) -> int:
        """This rank's sequence shard, e * tp + t: its place in the sequence
        (model) group."""
        _, e, t = self.coords
        return e * self.tp + t

    def seq_offset(self, s_l: int) -> int:
        """The first position of this rank's sequence slice of ``s_l``
        tokens."""
        return self.seq_rank * s_l

    def kv_rows(self, cache_len: int) -> Tuple[int, int]:
        """(first, count) of this rank's rows of a ``cache_len``-row dense
        attention cache under the reference's "kv_seq" rule (the cache's
        positions over (ep, tp)): ``[j * C / n, (j + 1) * C / n)`` with
        ``j`` its sequence rank and ``n = ep * tp``; all ``C`` rows where
        n does not divide C (the reference's ``safe_spec`` drops the
        axis)."""
        n = self.seq_size
        if n == 1 or cache_len % n:
            return 0, cache_len
        rows = cache_len // n
        return self.seq_rank * rows, rows

    @property
    def num_microbatches(self) -> int:
        return self.microbatches or 2 * self.pp

    @property
    def a2a_algo(self) -> str:
        return "halo" if self.hierarchical_a2a else "flat"

    def axis_size(self, axis: str) -> int:
        return {"data": self.dp, "ep": self.ep, "tp": self.tp}[axis]

    @property
    def layout(self) -> Dict[str, Tuple[Optional[Tuple[str, ...]], ...]]:
        """``{path: axes of each dim}`` of every non-expert leaf the plan
        slices (a dim's axes None where it stays whole); empty without an
        arch or rules."""
        return _layout(self.arch, _rules_key(self.rules), self.dp, self.ep, self.tp)[0]

    @property
    def whole(self) -> Dict[str, str]:
        """``{path: why}`` of every non-expert leaf dim a rule names that
        stays whole because the axes' size product does not divide it."""
        return _layout(self.arch, _rules_key(self.rules), self.dp, self.ep, self.tp)[1]

    def block_layout(self, block) -> Dict[str, Tuple[Optional[Tuple[str, ...]], ...]]:
        """:attr:`layout` of one rep of a block of kind ``block``, keyed
        ``"mixer/wq"``, without the reps dim: what a layer gathers."""
        return _block_layout(self.arch, block, _rules_key(self.rules), self.dp, self.ep,
                             self.tp)

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
                   else f" experts whole ({self.ffn_whole})" if self.ffn_whole else "")
                + self._describe_zero())

    def _describe_zero(self) -> str:
        layout, whole = self.layout, self.whole
        if not layout and not whole:
            return ""
        out = f" zero: {len(layout)} leaves sliced"
        if layout:
            out += " (" + ", ".join(sorted(layout)) + ")"
        if whole:
            out += "; whole: " + ", ".join(f"{k} {why}" for k, why in sorted(whole.items()))
        return out


def _keep(plan: MeshPlan, attr: str, ranks: Sequence[int], mine: bool) -> None:
    """``dist.new_group(ranks)``, called on every rank (it is collective);
    the ranks in it store it as ``plan.<attr>``.  A one-rank group is not
    created and stays None."""
    if len(ranks) > 1:
        g = dist.new_group(list(ranks))
        if mine:
            setattr(plan, attr, g)


def _rules_key(rules: Rules):
    return tuple(sorted((k, tuple(v) if v else None) for k, v in rules.items()))


def _dim_axes(tag, size: int, rules: dict, sizes: dict):
    """(axes a dim tagged ``tag`` of ``size`` is sliced over or None, why a
    dim a rule names stays whole or "")."""
    rule = rules.get(tag) if tag is not None else None
    if not rule:
        return None, ""
    n = math.prod(sizes[a] for a in rule)
    if n == 1:
        return None, ""
    if size % n:
        return None, f"({size} % ({' x '.join(rule)} = {n}) != 0)"
    return rule, ""


def _leaf_axes(logical, shape, rules: dict, sizes: dict):
    if any(t in EXPERT_TAGS for t in logical):
        return None, []
    axes, whole = [], []
    for i, (tag, size) in enumerate(zip(logical, shape)):
        a, why = _dim_axes(tag, size, rules, sizes)
        axes.append(a)
        if why:
            whole.append(f"dim {i} {why}")
    return (tuple(axes) if any(axes) else None), whole


@functools.lru_cache(maxsize=256)
def _layout(arch, rules, dp: int, ep: int, tp: int):
    if arch is None or not rules:
        return {}, {}
    from repro_torch.models.model import param_tree, tree_paths  # the model imports this

    rules, sizes = dict(rules), {"data": dp, "ep": ep, "tp": tp}
    layout, whole = {}, {}
    for path, meta in tree_paths(param_tree(arch)).items():
        axes, why = _leaf_axes(meta.logical, meta.shape, rules, sizes)
        if axes is not None:
            layout[path] = axes
        if why:
            whole[path] = "; ".join(why)
    return layout, whole


@functools.lru_cache(maxsize=256)
def _block_layout(arch, block, rules, dp: int, ep: int, tp: int):
    """:func:`_layout` of the first pattern position of kind ``block``
    (every position of a kind has its tags), keyed within the block,
    without the reps dim."""
    layout = _layout(arch, rules, dp, ep, tp)[0]
    if not layout:
        return {}
    prefix = f"blocks/{arch.block_pattern.index(tuple(block))}/"
    return {k[len(prefix):]: axes[1:] for k, axes in layout.items() if k.startswith(prefix)}


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
    is split over D * tp ranks where that divides it, and every other
    weight laid out by the reference's rule table (module docstring)."""
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
    rules = default_rules(pipeline_on_pod)
    sizes = {"data": data, "ep": ep, "tp": tp}
    n = math.prod(sizes[a] for a in rules["expert_ffn"])
    ffn_split, ffn_whole = 1, ""
    if arch.moe is not None and n > 1:
        if arch.moe.d_ff % n:
            ffn_whole = f"d_ff {arch.moe.d_ff} % (data x tp = {n}) != 0"
        else:
            ffn_split = n
    kw = dict(hierarchical_a2a=hierarchical_a2a, a2a_chunks=a2a_chunks, pp=pp,
              schedule=schedule, vstages=vstages, microbatches=microbatches,
              compress_p2p=compress_p2p, remat=remat, optimizer_dtype=optimizer_dtype,
              ffn_split=ffn_split, ffn_whole=ffn_whole, rules=rules, arch=arch,
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
        if data > 1:
            for dd in range(data):
                _keep(plan, "model_group", [at(pp_, dd, x, y) for x in range(ep)
                                            for y in range(tp)], (pp_, dd) == (p, d))
    if tp == 1:
        plan.expert_dp_group = plan.dp_group
    if data == 1:
        plan.model_group = plan.stage_group
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


class _SeqGather(torch.autograd.Function):
    """The sequence slices of the group's ranks all-gathered along ``dim``,
    in sequence-rank order, one collective.  The backward sums the
    cotangent in fp32 over the group (every rank's positions took part of
    it) and keeps this rank's slice, cast back: an all-reduce and a
    narrow, as :func:`reduce_slice` does (gloo has no usable
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim, ctx.index, ctx.n = group, dim, index, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        full = all_reduce_(g.to(torch.float32, memory_format=torch.contiguous_format,
                                copy=True), ctx.group)
        return (full.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).to(g.dtype), None, None,
                None)


def seq_gather(x: torch.Tensor, plan, dim: int = 1) -> torch.Tensor:
    """The whole sequence from this rank's slice ``x`` (its ``dim`` the
    sequence): differentiable, one all-gather over the sequence group (the
    model group, :class:`_SeqGather`); ``x`` itself where the plan does not
    split the sequence."""
    if plan is None or plan.seq_size == 1:
        return x
    return _SeqGather.apply(x, plan.model_group, dim, plan.seq_rank)


# Bytes and calls of :func:`seq_shift` in this process (:func:`reset_handoff`
# zeroes them): "rounds" its calls, "tensors" and "bytes" what this rank
# sent, "host_bytes" the part of it staged through the host (gloo's
# point-to-point takes host tensors only).
HANDOFF = {"rounds": 0, "tensors": 0, "bytes": 0, "host_bytes": 0}
_SHIFT_TAG = 64  # above core.pipeline's hand-off tags


def reset_handoff() -> None:
    for k in HANDOFF:
        HANDOFF[k] = 0


def _shift(ts, k: int, plan, fills) -> List[torch.Tensor]:
    """Each of ``ts`` sent to sequence rank j + k, what rank j - k sent
    received (``fills`` where there is no such rank), all posted in one
    ``batch_isend_irecv``; a CUDA payload crosses a gloo group through the
    host, as ``core.pipeline.Wire`` stages its hand-offs."""
    n, j = plan.seq_size, plan.seq_rank
    base, dst, src = plan.rank - j, j + k, j - k
    send, recv = 0 <= dst < n, 0 <= src < n
    host = ts[0].device.type == "cuda" and dist.get_backend() == "gloo"
    ops, bufs = [], []
    HANDOFF["rounds"] += 1
    for i, t in enumerate(ts):
        if send:
            payload = t.detach().contiguous()
            nbytes = payload.numel() * payload.element_size()
            HANDOFF["tensors"] += 1
            HANDOFF["bytes"] += nbytes
            if host:
                payload = payload.cpu()
                HANDOFF["host_bytes"] += nbytes
            ops.append(dist.P2POp(dist.isend, payload, base + dst, tag=_SHIFT_TAG + i))
        if recv:
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu" if host else t.device)
            ops.append(dist.P2POp(dist.irecv, buf, base + src, tag=_SHIFT_TAG + i))
            bufs.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not recv:
        return [torch.full_like(t, f) for t, f in zip(ts, fills)]
    return [b.to(t.device) for t, b in zip(ts, bufs)]


class _SeqShift(torch.autograd.Function):
    """:func:`seq_shift`; the backward shifts the cotangents back by -k
    (what rank j + k received from this rank), zeros where that rank does
    not exist: a filled output depends on no input."""

    @staticmethod
    def forward(ctx, k, plan, fills, *ts):
        ctx.k, ctx.plan = k, plan
        return tuple(_shift(ts, k, plan, fills))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_shift(gs, -ctx.k, ctx.plan, [0.0] * len(gs)))


def seq_shift(ts, k: int, plan, fills=None) -> List[torch.Tensor]:
    """The tensors ``ts`` of sequence rank j - k along the sequence group:
    this rank's go to rank j + k (a positive ``k`` moves them toward the
    sequence's end), one ``batch_isend_irecv`` for all of them, so no order
    of ranks deadlocks; where j - k is no rank, ``fills`` (one value a
    tensor, default 0) in their shapes.  Differentiable (the backward is
    the opposite shift).  Peers are global ranks ``plan.rank - j + j'``,
    the sequence group being the innermost (ep, tp) ranks.  A call is one
    round of :data:`HANDOFF`; every rank of the group must make it."""
    ts = list(ts)
    fills = [0.0] * len(ts) if fills is None else list(fills)
    return list(_SeqShift.apply(k, plan, fills, *ts))


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


def _assemble(parts: List[torch.Tensor], dims) -> torch.Tensor:
    """A group's slices, in group-rank order, back into one tensor:
    ``dims`` lists (dim, slice count) from the outermost axis in rank order
    to the innermost."""
    if not dims:
        return parts[0]
    (dim, n), rest = dims[0], dims[1:]
    k = len(parts) // n
    return torch.cat([_assemble(parts[i * k:(i + 1) * k], rest) for i in range(n)], dim)


class _GatherSlices(torch.autograd.Function):
    """Leaves' slices, cast to ``dtype`` and all-gathered over ``group`` in
    one collective, each reassembled along its dims (:func:`_assemble`;
    ``specs``: per leaf, its (dim, slice count) list and its slice's (dim,
    offset) list).  The backward sums the leaves' gradients in fp32 over
    ``group`` in one all-reduce, keeps this rank's slices (an all-reduce and
    a narrow: gloo has no usable reduce-scatter), then sums those in one
    all-reduce over ``rest``, the ranks that hold the same slices and
    computed parts of the gradients too (None: no such ranks).  The
    gradients are returned in fp32, so a master's sum is not rounded to the
    compute dtype."""

    @staticmethod
    def forward(ctx, dtype, specs, group, rest, *ws):
        ctx.specs, ctx.group, ctx.rest = specs, group, rest
        ctx.shapes = [w.shape for w in ws]
        flat = torch.cat([w.to(dtype).reshape(-1) for w in ws])
        parts = [torch.empty_like(flat) for _ in range(group_size(group))]
        dist.all_gather(parts, flat, group=group)
        outs, off = [], 0
        for w, (dims, _) in zip(ws, specs):
            outs.append(_assemble([p[off:off + w.numel()].view(w.shape) for p in parts], dims))
            off += w.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        full = all_reduce_(torch.cat([g.reshape(-1).float() for g in gs]), ctx.group)
        mine, off = [], 0
        for g, shape, (_, starts) in zip(gs, ctx.shapes, ctx.specs):
            t = full[off:off + g.numel()].view(g.shape)
            off += g.numel()
            for dim, start in starts:
                t = t.narrow(dim, start, shape[dim])
            mine.append(t.reshape(-1))
        flat = all_reduce_(torch.cat(mine), ctx.rest)
        sizes = [math.prod(shape) for shape in ctx.shapes]
        return (None, None, None, None) + tuple(
            t.view(shape) for t, shape in zip(flat.split(sizes), ctx.shapes))


def gather_ffn(params, plan, dtype: torch.dtype):
    """An MoE block's ``params`` with every expert leaf whole along its d_ff,
    in ``dtype``: their slices gathered over the expert-gradient group in
    (d, t) order, in one collective (:class:`_GatherSlices`; no other rank
    holds the same slots' slice); ``params`` itself without a split.
    Collective over the expert-gradient group."""
    if plan is None or plan.ffn_split == 1:
        return params
    keys = [k for k in EXPERT_KEYS if params.get(k) is not None]
    specs = []
    for k in keys:
        w = params[k]
        dim = w.dim() + ffn_dim(k)
        specs.append((((dim, plan.ffn_split),), ((dim, plan.ffn_rank * w.shape[dim]),)))
    whole = _GatherSlices.apply(dtype, tuple(specs), plan.expert_dp_group, None,
                                *(params[k] for k in keys))
    return {**params, **dict(zip(keys, whole))}


# The group a leaf's slices are gathered over, by the axes its dims are
# sliced over, and the group that holds the same slice (the rest of the
# stage).
_ZERO_GROUPS = {frozenset(("data",)): ("dp_group", "model_group"),
                frozenset(("ep", "tp")): ("model_group", "dp_group"),
                frozenset(MESH_AXES): ("stage_group", None)}


def zero_groups(plan, axes):
    """(gather group, rest group) of a leaf whose dims are sliced over
    ``axes`` (a :attr:`MeshPlan.layout` entry)."""
    used = frozenset(a for rule in axes if rule for a in rule)
    if used not in _ZERO_GROUPS:
        raise ValueError(f"rules slice a leaf over {sorted(used)}: only data, (ep, tp) "
                         f"or both have a group")
    gather, rest = _ZERO_GROUPS[used]
    return getattr(plan, gather), (getattr(plan, rest) if rest else None)


def _slice_index(plan, rule) -> int:
    """This rank's slice along a dim sliced over ``rule``'s axes (mixed
    radix over them, the first outermost)."""
    d, e, t = plan.coords
    coord = {"data": d, "ep": e, "tp": t}
    i = 0
    for a in rule:
        i = i * plan.axis_size(a) + coord[a]
    return i


def _zero_dims(axes):
    """(dim, axes) of the sliced dims, outermost in rank order first."""
    return sorted(((i, rule) for i, rule in enumerate(axes) if rule),
                  key=lambda x: MESH_AXES.index(x[1][0]))


def slice_leaf(t, axes, plan):
    """This rank's slice of a whole leaf ``t`` (a tensor or a numpy array)
    whose dims are sliced over ``axes``: a view."""
    index = [slice(None)] * t.ndim
    for dim, rule in _zero_dims(axes):
        n = math.prod(plan.axis_size(a) for a in rule)
        size = t.shape[dim] // n
        i = _slice_index(plan, rule)
        index[dim] = slice(i * size, (i + 1) * size)
    return t[tuple(index)]


def _gather_specs(ws, axes_list, plan):
    """:class:`_GatherSlices`' specs of slices ``ws`` sliced over
    ``axes_list``."""
    specs = []
    for w, axes in zip(ws, axes_list):
        dims = _zero_dims(axes)
        specs.append((tuple((dim, math.prod(plan.axis_size(a) for a in rule))
                            for dim, rule in dims),
                       tuple((dim, _slice_index(plan, rule) * w.shape[dim])
                             for dim, rule in dims)))
    return tuple(specs)


def gather_leaves(ws, axes_list, plan, dtype: Optional[torch.dtype] = None):
    """The whole leaves from this rank's slices ``ws``, whose dims are
    sliced over ``axes_list`` (:attr:`MeshPlan.layout` entries sharing one
    gather group, :func:`zero_groups`), in ``dtype`` (the slices' without
    one): one all-gather over the group; differentiable, the backward
    summing the gradients over the stage's ranks and keeping the slices
    (:class:`_GatherSlices`).  Collective over the gather group."""
    group, rest = zero_groups(plan, axes_list[0])
    return _GatherSlices.apply(dtype or ws[0].dtype, _gather_specs(ws, axes_list, plan),
                               group, rest, *ws)


def gather_leaf(w: torch.Tensor, axes, plan, dtype: Optional[torch.dtype] = None):
    """:func:`gather_leaves` of one leaf."""
    return gather_leaves([w], [axes], plan, dtype)[0]


def reduce_slice(g: torch.Tensor, axes, plan) -> torch.Tensor:
    """The backward of :func:`gather_leaf` on a whole gradient ``g`` (an
    fp32 copy is made): summed over the gather group, this rank's slice,
    summed over the rest of the stage."""
    group, rest = zero_groups(plan, axes)
    g = all_reduce_(g.to(torch.float32, memory_format=torch.contiguous_format, copy=True),
                    group)
    return all_reduce_(slice_leaf(g, axes, plan).contiguous(), rest)


def gather_block(params, block, arch, plan, dtype: torch.dtype, part: str):
    """One rep's ``params[part]`` ("mixer" or "ffn") of a block of kind
    ``block`` with every leaf the plan slices gathered whole in ``dtype``,
    one collective a gather group (:func:`gather_leaves`); the dict itself
    when the plan slices none."""
    sub = params[part]
    if plan is None:
        return sub
    layout = plan.block_layout(block)
    buckets = {}
    for k in sub:
        axes = layout.get(f"{part}/{k}")
        if axes is not None:
            buckets.setdefault(zero_groups(plan, axes), []).append((k, axes))
    if not buckets:
        return sub
    out = dict(sub)
    for items in buckets.values():
        keys = [k for k, _ in items]
        out.update(zip(keys, gather_leaves([sub[k] for k in keys], [a for _, a in items],
                                           plan, dtype)))
    return out


def sliced_paths(flat, plan) -> set:
    """The paths of a flat param tree whose leaves ``plan`` slices (the
    experts' d_ff under a split, every leaf of :attr:`MeshPlan.layout`):
    a layer gathers them in the compute dtype, so they stay fp32 masters
    until then."""
    if plan is None:
        return set()
    experts = expert_paths(flat) if plan.ffn_split > 1 else set()
    return experts | (set(plan.layout) & set(flat))


def sum_leaves_(leaves, group) -> None:
    """Sum a list of tensors over ``group`` in place, as one flat bucket."""
    if group is None or not leaves:
        return
    buf = all_reduce_(torch.cat([t.reshape(-1) for t in leaves]), group)
    for t, part in zip(leaves, buf.split([t.numel() for t in leaves])):
        t.copy_(part.view_as(t))


def reduce_grads_(grads, plan) -> None:
    """Sum this rank's partial gradients (a params-shaped tree, None for
    integer tables) in place into the global ones: the whole non-expert
    block leaves over the stage group (the ranks that run the same stage),
    the expert leaves over the expert-gradient group (the data ranks and tp
    lanes that hold the same slots of the same stage) unless the plan
    splits them, and the other whole leaves (``final_norm``, and the
    embedding and head where kept whole) over the world (every stage's and
    data rank's part; the reference's sum over stages).  A sliced leaf's
    gather summed its gradient over its stage already (:func:`gather_leaf`,
    :func:`gather_ffn`); under a pipeline a sliced embedding or head, which
    every stage holds, is added over the pp group."""
    from repro_torch.models.model import tree_paths  # the model imports this module

    flat = {k: g for k, g in tree_paths(grads).items() if g is not None}
    experts = expert_paths(flat)
    sliced = plan.layout
    dense = [k for k in flat if k not in experts and k not in sliced]
    if plan.pp > 1:
        sum_leaves_([flat[k] for k in dense if k.startswith("blocks/")], plan.stage_group)
        dense = [k for k in dense if not k.startswith("blocks/")]
        top = [flat[k] for k in sorted(sliced) if k in flat and not k.startswith("blocks/")]
        if top:
            sum_leaves_(top, plan.pp_group)
    sum_leaves_([flat[k] for k in dense], plan.world_group)
    if plan.ffn_split == 1:
        sum_leaves_([flat[k] for k in sorted(experts)], plan.expert_dp_group)
