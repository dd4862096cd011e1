"""Expert migration for device-level load balancing (paper §VI): the port's
own copy of ``repro.core.migration``.

* :class:`LoadStats`: an EMA of per-(MoE layer, expert) token counts, fed
  from the training metrics' ``expert_load`` (or the serving decode's).
* :func:`hill_climb_rebalance`: the paper's Algorithm 2, swap-based minimal
  rebalancing of the expert -> EP group assignment by hill climbing on the
  max-min group-load gap; :func:`rebalance_assignment` runs it on a layer.
* :func:`plan_replication`: hot-expert replica channels for the regime no
  swap can reach (:func:`swap_floor`), released with hysteresis;
  :func:`plan_layer` runs replication, then swaps on the residual.
* :func:`permutation_for` / :func:`moved_experts` / :func:`apply_permutation_`:
  the executor.  The reference permutes whole (GSPMD-sharded) leaves with
  one gather; here every rank holds its EP shard of each expert leaf, so
  :func:`apply_permutation_` all-gathers a leaf over the EP group, indexes
  it with the new-slot -> old-slot permutation and copies the rank's own
  slice back into the live tensor, in place (the optimizer and the train
  step keep their references).
* :func:`plan_model` / :func:`apply_model_plan_`: a whole model's plan
  and its application, shared by the trainer's ``_maybe_migrate`` and the
  engine's ``_maybe_rebalance`` (the reference spells the loop out in
  each).  The plan covers every MoE layer of the whole stack; under a
  pipeline each stage applies its own chunks' rows, and each tp lane the
  same permutation over its own EP group.
* :func:`migration_cost` / :func:`replication_bytes`: Table IV's worst-case
  transfer and the one-off replica placement bytes.

Everything but :func:`apply_permutation_` is numpy and pure Python, equal
to the reference with ``==`` (``tests/test_torch_migration.py``).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


# ---------------------------------------------------------------------------
# Load statistics (extended router, paper §VI-A)
# ---------------------------------------------------------------------------


@dataclass
class LoadStats:
    """EMA of per-(layer, expert) token loads."""

    num_layers: int
    num_experts: int
    decay: float = 0.9
    ema: np.ndarray = field(default=None)  # (num_layers, E) float64
    steps: int = 0

    def __post_init__(self):
        if self.ema is None:
            self.ema = np.zeros((self.num_layers, self.num_experts))

    def update(self, loads: np.ndarray) -> None:
        """loads: (num_layers, E) token counts for one step (logical ids)."""
        loads = np.asarray(loads, dtype=np.float64).reshape(self.ema.shape)
        self.ema = self.decay * self.ema + (1 - self.decay) * loads
        self.steps += 1

    def group_loads(self, assignment: np.ndarray, ep: int,
                    replicas: Optional[np.ndarray] = None) -> np.ndarray:
        """(num_layers, ep) total load per physical EP group.  A replicated
        expert (``replicas``: (num_layers, R), sentinel E = free) computes
        on every rank, so its load spreads evenly over the groups."""
        E = self.num_experts
        e_l = E // ep
        groups = np.asarray(assignment) // e_l  # (num_layers, E)
        out = np.zeros((self.num_layers, ep))
        for layer in range(self.num_layers):
            ema = self.ema[layer]
            if replicas is not None:
                rep = np.asarray(replicas[layer])
                rep = rep[(rep >= 0) & (rep < E)]
                if rep.size:
                    is_rep = np.zeros(E, dtype=bool)
                    is_rep[rep] = True
                    out[layer] += ema[is_rep].sum() / ep
                    ema = np.where(is_rep, 0.0, ema)
            np.add.at(out[layer], groups[layer], ema)
        return out

    def imbalance(self, assignment: np.ndarray, ep: int,
                  replicas: Optional[np.ndarray] = None) -> float:
        """max/mean group load over layers: the migration trigger."""
        g = self.group_loads(assignment, ep, replicas)
        mean = g.mean(axis=1) + 1e-9
        return float((g.max(axis=1) / mean).max())

    # -- checkpoint round trip ----------------------------------------------

    def to_state(self) -> Dict:
        """A JSON-able snapshot for a checkpoint manifest's ``extras``: the
        float64 EMA's raw bytes in base64 (the reference ships the same
        bytes through msgpack), so a restart restores it bit for bit."""
        return {
            "ema": base64.b64encode(self.ema.astype(np.float64).tobytes()).decode("ascii"),
            "shape": list(self.ema.shape),
            "decay": float(self.decay),
            "steps": int(self.steps),
        }

    def load_state(self, state: Dict) -> None:
        """Restore in place from :meth:`to_state` (bit-exact)."""
        shape = tuple(state["shape"])
        if shape != (self.num_layers, self.num_experts):
            raise ValueError(f"LoadStats shape mismatch: checkpoint {shape} vs "
                             f"({self.num_layers}, {self.num_experts})")
        raw = base64.b64decode(state["ema"])
        self.ema = np.frombuffer(raw, dtype=np.float64).reshape(shape).copy()
        self.decay = float(state["decay"])
        self.steps = int(state["steps"])

    @classmethod
    def from_state(cls, state: Dict) -> "LoadStats":
        shape = tuple(state["shape"])
        obj = cls(num_layers=int(shape[0]), num_experts=int(shape[1]))
        obj.load_state(state)
        return obj


# ---------------------------------------------------------------------------
# Algorithm 2: hill-climbing swap-based minimal rebalancing
# ---------------------------------------------------------------------------


def hill_climb_rebalance(groups: List[List[Tuple[int, float]]], max_iters: int = 100,
                         min_gain: float = 0.0) -> Tuple[List[List[Tuple[int, float]]], int]:
    """Paper Algorithm 2.  groups: K lists of (expert_id, load).  Returns
    (rebalanced groups, swap count).  Each iteration swaps one expert
    between the heaviest and the lightest group if that strictly reduces
    their load gap by more than ``min_gain``."""
    groups = [list(g) for g in groups]
    swaps = 0
    for _ in range(max_iters):
        sums = [sum(l for _, l in g) for g in groups]
        k_hi = int(np.argmax(sums))
        k_lo = int(np.argmin(sums))
        delta = sums[k_hi] - sums[k_lo]
        if delta <= 0:
            break
        best_gain, best = min_gain, None
        for i, (_, l1) in enumerate(groups[k_hi]):
            for j, (_, l2) in enumerate(groups[k_lo]):
                new_delta = abs((sums[k_hi] - l1 + l2) - (sums[k_lo] - l2 + l1))
                gain = delta - new_delta
                if new_delta < delta and gain > best_gain:
                    best_gain, best = gain, (i, j)
        if best is None:
            break
        i, j = best
        groups[k_hi][i], groups[k_lo][j] = groups[k_lo][j], groups[k_hi][i]
        swaps += 1
    return groups, swaps


def rebalance_assignment(loads: np.ndarray, assignment: np.ndarray, ep: int,
                         max_iters: int = 100) -> Tuple[np.ndarray, int]:
    """Algorithm 2 on one layer: loads (E,) EMA loads of the logical
    experts, assignment (E,) logical -> physical slot.  Returns (new
    assignment, swap count)."""
    E = len(loads)
    e_l = E // ep
    groups: List[List[Tuple[int, float]]] = [[] for _ in range(ep)]
    for e in range(E):
        groups[assignment[e] // e_l].append((e, float(loads[e])))
    new_groups, swaps = hill_climb_rebalance(groups, max_iters=max_iters)
    new_assign = np.empty(E, dtype=np.int32)
    for g, members in enumerate(new_groups):
        for slot, (e, _) in enumerate(members):
            new_assign[e] = g * e_l + slot
    return new_assign, swaps


# ---------------------------------------------------------------------------
# Hot-expert replication (beyond Algorithm 2)
# ---------------------------------------------------------------------------


def swap_floor(loads: np.ndarray, ep: int) -> float:
    """The imbalance no swap-only rebalancer can beat: whole-expert moves
    cannot split one expert's load, so ``max_e load_e / fair_share`` lower
    bounds the max/mean group load."""
    loads = np.asarray(loads, dtype=np.float64)
    fair = loads.sum() / ep
    if fair <= 0:
        return 1.0
    return max(float(loads.max() / fair), 1.0)


def plan_replication(loads: np.ndarray, replicas: np.ndarray, ep: int,
                     hot_factor: float = 1.0, release_factor: float = 0.8) -> np.ndarray:
    """Assign and release replica channels for one layer.  An expert is hot
    when its load exceeds ``hot_factor`` x the per-group fair share; a held
    channel is released only once its expert cools below ``release_factor
    * hot_factor * fair`` (hysteresis).  replicas: (R,) the current table
    (sentinel E = free).  Returns the new (R,) table."""
    loads = np.asarray(loads, dtype=np.float64)
    E = len(loads)
    out = np.asarray(replicas, dtype=np.int64).copy()
    R = len(out)
    fair = loads.sum() / ep
    if fair <= 0:
        return np.full(R, E, dtype=np.int32)
    for r in range(R):  # release cooled (or invalid) experts
        e = int(out[r])
        if e < 0 or e >= E or loads[e] <= release_factor * hot_factor * fair:
            out[r] = E
    held = {int(e) for e in out if 0 <= e < E}
    free = [r for r in range(R) if out[r] == E]
    for e in np.argsort(-loads):  # free channels to the hottest over-fair experts
        if not free:
            break
        if loads[e] <= hot_factor * fair:
            break
        if int(e) in held:
            continue
        out[free.pop(0)] = int(e)
        held.add(int(e))
    return out.astype(np.int32)


def plan_layer(loads: np.ndarray, assignment: np.ndarray, replicas: Optional[np.ndarray],
               ep: int, max_iters: int = 100
               ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, int]:
    """One layer's planning pass: replication first (a replicated expert
    leaves the swap problem), then Algorithm 2 on the residual loads.
    Returns (new_assignment, new_replicas, perm, swaps), ``perm =
    permutation_for(assignment, new_assignment)``."""
    loads = np.asarray(loads, dtype=np.float64)
    E = len(loads)
    new_reps = None
    resid = loads.copy()
    if replicas is not None and len(replicas) > 0:
        new_reps = plan_replication(loads, replicas, ep)
        resid[new_reps[new_reps < E]] = 0.0
    new_assign, swaps = rebalance_assignment(resid, assignment, ep, max_iters=max_iters)
    return new_assign, new_reps, permutation_for(assignment, new_assign), swaps


def replication_bytes(n_new: int, d_model: int, d_ffn: int, ep: int, n_mat: int = 3,
                      bytes_per_param: int = 2) -> float:
    """Wire bytes to broadcast ``n_new`` newly replicated experts' weights
    to the other ``ep - 1`` groups (the one-off placement cost; the
    per-step broadcast is priced by the resource model)."""
    return float(bytes_per_param * n_mat * n_new * d_model * d_ffn * max(ep - 1, 0))


# ---------------------------------------------------------------------------
# A model's plan (the trainer's and the engine's controllers)
# ---------------------------------------------------------------------------


@dataclass
class ModelPlan:
    """A plan for every MoE layer of a model: per MoE pattern position,
    {"assignment", "perms", "replicas"} stacked over reps (replicas None
    without channels), and the plan's totals."""

    layers: List[Dict[str, Optional[np.ndarray]]]
    imbalance: float
    imbalance_post: float
    swaps: int
    replicas: int


def routing_tables(ffns, plan=None) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]]]:
    """The MoE blocks' (assignment, replicas) tables on the host, each
    (reps, E) / (reps, R) over the whole stack; replicas None when the
    blocks have none.  Under a pipeline ``plan`` a stage holds its chunks'
    rows only, and the tables are all-gathered over the pp group (a
    collective: every rank calls it)."""
    from repro_torch.convert import _unstage_chunks

    def host(t):
        if plan is not None and plan.pp > 1:
            t = _unstage_chunks(t, plan)
        return t.cpu().numpy()

    assign = [host(f["assignment"]) for f in ffns]
    if "replicas" not in ffns[0] or ffns[0]["replicas"].shape[-1] == 0:
        return assign, None
    return assign, [host(f["replicas"]) for f in ffns]


def model_imbalance(stats: LoadStats, tables, ep: int) -> float:
    """:meth:`LoadStats.imbalance` of :func:`routing_tables`' tables, in
    LoadStats row order (position-major, rep)."""
    assign, reps = tables
    return stats.imbalance(np.concatenate(assign), ep,
                           None if reps is None else np.concatenate(reps))


def plan_model(stats: LoadStats, tables, ep: int, max_iters: int = 100) -> ModelPlan:
    """:func:`plan_layer` on every (MoE position, rep) of
    :func:`routing_tables`' tables, rows of the EMA in LoadStats order."""
    assign, reps = tables
    E = stats.num_experts
    layers, swaps, row = [], 0, 0
    for j, old in enumerate(assign):
        new, perms = np.empty_like(old), np.empty_like(old)
        new_reps = None if reps is None else np.empty_like(reps[j])
        for r in range(old.shape[0]):
            na, nr, perm, n = plan_layer(stats.ema[row], old[r],
                                         None if reps is None else reps[j][r], ep,
                                         max_iters=max_iters)
            new[r], perms[r] = na, perm
            if reps is not None:
                new_reps[r] = nr
            swaps += n
            row += 1
        layers.append({"assignment": new, "perms": perms, "replicas": new_reps})
    new_tables = ([l["assignment"] for l in layers],
                  None if reps is None else [l["replicas"] for l in layers])
    n_reps = 0 if reps is None else int(max((l["replicas"] < E).sum(axis=1).max()
                                            for l in layers))
    return ModelPlan(layers, model_imbalance(stats, tables, ep),
                     model_imbalance(stats, new_tables, ep), swaps, n_reps)


def apply_model_plan_(mplan: ModelPlan, ffns, moments=(), plan=None) -> int:
    """Apply ``mplan`` in place: every MoE block's expert leaves in
    ``ffns`` (the params) and in each tree of ``moments`` (per tree, its
    MoE blocks in the same order) permuted by :func:`apply_migration_`,
    then the params' routing tables.  Under a pipeline ``plan`` the plan's
    rows are the whole stack's and a stage applies its own chunks' rows
    (``convert.stage_reps``).  Returns the bytes all-gathered."""
    from repro_torch.convert import stage_reps

    got = 0
    for j, layer in enumerate(mplan.layers):
        rows = (stage_reps(layer["perms"].shape[0], plan)
                if plan is not None and plan.pp > 1 else slice(None))
        for blocks in (ffns,) + tuple(moments):
            got += apply_migration_(blocks[j], layer["perms"][rows], plan)
        ffns[j]["assignment"].copy_(torch.from_numpy(layer["assignment"][rows]))
        if layer["replicas"] is not None:
            ffns[j]["replicas"].copy_(torch.from_numpy(layer["replicas"][rows]))
    return got


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def permutation_for(old_assign: np.ndarray, new_assign: np.ndarray) -> np.ndarray:
    """perm such that W_new[s] = W_old[perm[s]] moves the expert weights
    from their old physical slots to the new ones."""
    old_assign = np.asarray(old_assign)
    logical_at_new = np.argsort(np.asarray(new_assign))  # new slot -> logical expert
    return old_assign[logical_at_new].astype(np.int32)


def moved_experts(old_assign: np.ndarray, new_assign: np.ndarray, ep: int, E: int):
    """Logical experts whose EP group changed (whose parameters cross
    ranks)."""
    e_l = E // ep
    return np.nonzero((np.asarray(old_assign) // e_l) != (np.asarray(new_assign) // e_l))[0]


EXPERT_PARAM_KEYS = ("w_up", "w_gate", "w_down")


@torch.no_grad()
def apply_permutation_(leaf: torch.Tensor, perm: np.ndarray, plan=None) -> int:
    """Permute one expert leaf in place: ``leaf`` (reps, E_l, ...) holds
    this rank's physical slots ``[g*E_l, (g+1)*E_l)`` of the global (reps,
    E, ...) leaf (all of it without a plan or at EP = 1); perm (reps, E)
    new slot -> old slot.  The leaf is all-gathered over the EP group (a
    collective: every rank of it calls this), indexed, and the rank's own
    slice copied back with ``copy_``.  Returns the bytes this rank
    received in the all-gather (0 at EP = 1)."""
    ep = 1 if plan is None else plan.ep
    E_l = leaf.shape[1]
    if ep > 1:
        parts = [torch.empty_like(leaf) for _ in range(ep)]
        dist.all_gather(parts, leaf.contiguous(), group=plan.ep_group)
        full = torch.cat(parts, dim=1)
        got = (ep - 1) * leaf.numel() * leaf.element_size()
        g = plan.ep_rank
    else:
        full, got, g = leaf.clone(), 0, 0
    idx = torch.as_tensor(np.asarray(perm)[:, g * E_l:(g + 1) * E_l], dtype=torch.long,
                          device=leaf.device)
    idx = idx.reshape(idx.shape + (1,) * (leaf.dim() - 2)).expand(
        (leaf.shape[0], E_l) + leaf.shape[2:])
    leaf.copy_(torch.gather(full, 1, idx))
    return got


def apply_migration_(ffn: Dict[str, torch.Tensor], perm: np.ndarray, plan=None) -> int:
    """:func:`apply_permutation_` on every expert leaf of one MoE block's
    (params, m or v) tree, in place; the routing tables are the caller's.
    Returns the bytes received."""
    return sum(apply_permutation_(ffn[k], perm, plan) for k in EXPERT_PARAM_KEYS
               if k in ffn)


def migration_cost(E: int, d_model: int, d_ffn: int, G: int = 8, bandwidth: float = 50e9,
                   n_mat: int = 3, bytes_per_param: int = 16) -> Tuple[float, float]:
    """Paper Table IV: worst-case per-GPU send size (bytes) and latency (s):
    48 * E * d_model * d_ffn / G at 50 GB/s (3 matrices x 16 B/param)."""
    size = bytes_per_param * n_mat * E * d_model * d_ffn / G
    return size, size / bandwidth
