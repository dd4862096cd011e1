"""The rest of the pod axis in the port, against the JAX package: tensor
lanes (tp > 1), checkpointing and expert migration under a pipeline, and
serving data parallelism with the pod joining data.

``_torch_mesh_child.py`` runs both sides once for the module: the JAX
package on 8 fake host devices (the model at (1, 4) with 6 experts, so ep 2
and tp 2; paged decode at (2, 2); the migration controller at (2, 1, 2)
pipelined), beside it the port's PP 2 checkpoint runs on 2 gloo ranks,
then the port on 4 gloo ranks (``spawn`` and a ``file://`` rendezvous, no
port).  Capacity factor 16 everywhere, so no layout drops a row.

Tolerances.  The tp 2 loss and gathered gradients against the reference's
tp 2 plan: the EP tests' gates (``test_torch_ep.grad_gate_failures``: loss
2e-3, gradients 2e-3, the embedding at relative 0.05, every leaf at
``GRAD_REL`` = 0.02 of its largest magnitude), since both sides send the
dispatch payload through a bf16 wire (measured: loss 4.8e-7, worst leaf
1.4e-3 of its magnitude).  The same run with the wire in fp32 against the
port's world 1, which has no wire: the loss bitwise, else 1e-6; gradients
1e-5 (measured 1.5e-8).  Against the (2, 2) data grid, the same EP
degree and as many tokens a rank without tp lanes: the EP gates, since the
two grids give a rank other blocks of the batch (``training.shard_batch``:
8 rows x 4 positions at (1, 4), 4 x 8 at (2, 2)) and each side's bf16 wire
rounds its own payloads.  Paged decode at (2, 2) against the reference's on
the same mesh: the reference's own 5e-3 (``tests/_serving_child.py``
``check_paged_decode_on_mesh``; measured 3.4e-7).  Served tokens, plans,
migrated states, the swap-only trajectory and the checkpoint runs: exact.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs import get_arch

from _torch_mesh_child import DP_MESHES, MODES, TP_E
from test_torch_ep import GRAD_REL, grad_gate_failures

CHILD = Path(__file__).with_name("_torch_mesh_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
TP_LOSS_ATOL, TP_GRAD_ATOL = 1e-6, 1e-5  # fp32 wire against world 1
DECODE_ATOL = 5e-3  # the reference's check_paged_decode_on_mesh gate


def _child(args, env=None):
    return subprocess.Popen([sys.executable, str(CHILD)] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})


def _wait(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:] + "\n" + err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    ref_path = str(d / "ref.npz")
    # The PP 2 checkpoint runs need nothing of the reference: beside it.
    jax_child = _child(["jax", ref_path], {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"})
    pp_child = _child(["pp", str(d)])
    _wait(pp_child)
    _wait(jax_child)
    _wait(_child(["port", ref_path, str(d)]))
    ref = dict(np.load(ref_path))
    r4 = [dict(np.load(d / f"r4_rank{r}.npz")) for r in range(4)]
    pp = [dict(np.load(d / f"pp_rank{r}.npz")) for r in range(2)]
    return ref, r4, pp


def _grads(res, tag):
    pre = f"{tag}/grad/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# The grid's groups, without ranks
# ---------------------------------------------------------------------------


def _groups(monkeypatch, arch, mesh, rank, **kw):
    """``make_plan`` on a fake world at ``rank``: (every group created, in
    order, and the plan with its kept groups as their rank lists)."""
    world = int(np.prod(mesh))
    made = []

    def new_group(ranks):
        made.append(tuple(ranks))
        return tuple(ranks)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "new_group", new_group)
    monkeypatch.setattr(dist, "barrier", lambda group=None: None)
    monkeypatch.setattr(dist, "group", type("G", (), {"WORLD": "world"}))
    return made, sharding.make_plan(arch, mesh, **kw)


@pytest.mark.parametrize("mesh,pipeline", [((2, 4), False), ((2, 1, 4), True),
                                           ((2, 2, 4), False)],
                         ids=["2,4", "2,1,4-pipeline", "2,2,4-pod-joins-data"])
def test_groups_at_tp_2(monkeypatch, mesh, pipeline):
    """rank = ((p * D + d) * ep + e) * tp + t: the EP group shares (p, d, t),
    the data group (p, e, t), the expert-gradient group (p, e) over D * tp
    ranks, the pp group (d, e, t); every rank creates the same groups in the
    same order."""
    base = get_arch("granite-moe-3b-a800m").reduced()
    arch = base.replace(moe=dataclasses.replace(base.moe, num_experts=TP_E))
    world = int(np.prod(mesh))
    orders = []
    for rank in range(world):
        made, plan = _groups(monkeypatch, arch, mesh, rank, pipeline_on_pod=pipeline,
                             hierarchical_a2a=True)
        orders.append(made)
        P = mesh[0] if pipeline else 1
        D = world // (P * 4)
        assert (plan.pp, plan.dp, plan.ep, plan.tp) == (P, D, 2, 2)
        d, e, t = plan.coords
        p = plan.pp_rank

        def at(p_, d_, e_, t_):
            return ((p_ * D + d_) * 2 + e_) * 2 + t_

        assert rank == at(p, d, e, t)
        assert plan.ep_group == tuple(at(p, d, x, t) for x in range(2))
        assert plan.dp_group == (tuple(at(p, x, e, t) for x in range(D)) if D > 1 else None)
        assert plan.expert_dp_group == tuple(at(p, x, e, y) for x in range(D) for y in range(2))
        if P > 1:
            assert plan.pp_group == tuple(at(x, d, e, t) for x in range(P))
            assert plan.stage_group == tuple(range(p * D * 4, (p + 1) * D * 4))
        assert plan.g1 == 1 and plan.lane_group is None  # HALO degenerates at ep 2
    assert all(o == orders[0] for o in orders)


def test_reduce_grads_sums_expert_leaves_over_the_expert_gradient_group(monkeypatch):
    """The expert leaves' sum goes to ``expert_dp_group`` (the tp lanes
    too), the rest to the world."""
    import torch

    from repro_torch.models.model import init_params, tree_paths

    calls = []
    monkeypatch.setattr(sharding, "sum_leaves_", lambda leaves, group: calls.append(
        (len(leaves), group)))
    arch = get_arch("granite-moe-3b-a800m").reduced()
    params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    plan = sharding.MeshPlan(dp=1, ep=2, tp=2, world_group="world", dp_group=None,
                             expert_dp_group="lanes")
    sharding.reduce_grads_(params, plan)
    assert calls == [(len(tree_paths(params)) - 3, "world"), (3, "lanes")]


# ---------------------------------------------------------------------------
# tp 2 against the reference and world 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_tp_loss_and_grads_match_reference_tp_plan(runs, mode):
    """The port at (1, 4), ep 2 x tp 2, against the reference's
    ``make_plan(host_mesh((1, 4)))`` (the same grid): the EP gates, which a
    halved expert gradient fails; every rank holds the same gradients."""
    ref, r4, _ = runs
    assert ref[f"tp/{mode}/ep_tp"].tolist() == [2, 2]
    assert [r[f"tp/{mode}/plan"].tolist() for r in r4] == [
        [2, 2, 0, e, t] for e in range(2) for t in range(2)]
    loss = float(r4[0][f"tp/{mode}/loss"])
    assert abs(loss - float(ref[f"tp/{mode}/loss"])) < 2e-3
    got = _grads(r4[0], f"tp/{mode}")
    want = _grads(ref, f"tp/{mode}")
    assert sorted(got) == sorted(want)
    assert grad_gate_failures(got, want) == []
    experts = sharding.expert_paths(got)
    halved = {k: v * (0.5 if k in experts else 1.0) for k, v in got.items()}
    assert sorted(grad_gate_failures(halved, want)) == sorted(experts)
    worst = max(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max() for k in got)
    assert worst <= GRAD_REL
    for res in r4[1:]:
        assert float(res[f"tp/{mode}/loss"]) == loss
        for k in got:
            assert np.array_equal(_grads(res, f"tp/{mode}")[k], got[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_tp_with_an_fp32_wire_matches_world_1(runs, mode):
    """Without the bf16 wire the tp 2 run is the world-1 run: the loss
    bitwise, else within 1e-6, the gradients within 1e-5; the port's world
    1 is the reference's world 1 at the EP gates."""
    ref, r4, _ = runs
    r0 = r4[0]
    loss, loss1 = float(r0[f"tp32/{mode}/loss"]), float(r0[f"tp1/{mode}/loss"])
    assert loss == loss1 or abs(loss - loss1) < TP_LOSS_ATOL, (loss, loss1)
    got, want = _grads(r0, f"tp32/{mode}"), _grads(r0, f"tp1/{mode}")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TP_GRAD_ATOL, err_msg=k)
    assert abs(loss1 - float(ref[f"tp1/{mode}/loss"])) < 2e-3
    assert grad_gate_failures(want, _grads(ref, f"tp1/{mode}")) == []


@pytest.mark.parametrize("mode", MODES)
def test_tp_equals_the_data_grid_it_replaces(runs, mode):
    """(1, 4) against (2, 2): the same EP degree and as many tokens a rank,
    tp lanes in place of data ranks.  The grids give a rank other blocks
    of the batch (8 rows x 4 positions against 4 x 8), so the two are held
    at the EP gates, which a halved expert gradient fails."""
    _, r4, _ = runs
    r0 = r4[0]
    assert abs(float(r0[f"tp/{mode}/loss"]) - float(r0[f"tpdp/{mode}/loss"])) < 2e-3
    got, want = _grads(r0, f"tp/{mode}"), _grads(r0, f"tpdp/{mode}")
    experts = sharding.expert_paths(want)
    assert experts and sorted(got) == sorted(want)
    assert grad_gate_failures(got, want) == []
    halved = {k: v * (0.5 if k in experts else 1.0) for k, v in got.items()}
    assert sorted(grad_gate_failures(halved, want)) == sorted(experts)


@pytest.mark.parametrize("mode", MODES)
def test_tp_lanes_end_the_step_with_equal_params(runs, monkeypatch, mode):
    """One AdamW step at tp 2: no skip, one loss, and the two tp lanes of
    each EP rank hold bitwise-equal params of every leaf the plan keeps
    whole (the same reduced gradients and the same grad norm, so the same
    clip); their expert leaves are the two halves of the slots' d_ff (the
    plan's split over data x tp), and the leaves the rule table slices over
    (ep, tp) (the attention projections, the embedding's d_model) their own
    slices, so they differ."""
    _, r4, _ = runs
    assert len({float(r[f"tpstep/{mode}/loss"]) for r in r4}) == 1
    assert all(int(r[f"tpstep/{mode}/skipped"]) == 0 for r in r4)
    base = get_arch("granite-moe-3b-a800m").reduced()
    arch = base.replace(moe=dataclasses.replace(base.moe, num_experts=TP_E))
    _, plan = _groups(monkeypatch, arch, (1, 4), 0)
    pre = f"tpstep/{mode}/local/"
    apart = tuple(f"/ffn/{k}" for k in sharding.EXPERT_KEYS)
    assert {"embed", "blocks/0/mixer/wq"} <= set(plan.layout)
    for a, b in ((0, 1), (2, 3)):
        keys = [k for k in r4[a] if k.startswith(pre)]
        whole = [k for k in keys if not k.endswith(apart) and k[len(pre):] not in plan.layout]
        assert whole and all(np.array_equal(r4[a][k], r4[b][k]) for k in whole)
        for k in set(keys) - set(whole):
            assert r4[a][k].shape == r4[b][k].shape
            assert not np.array_equal(r4[a][k], r4[b][k]), k
    w_up = f"tpstep/{mode}/local/blocks/0/ffn/w_up"
    assert r4[0][w_up].shape[-1] * 2 == get_arch("granite-moe-3b-a800m").reduced().moe.d_ff
    assert not np.array_equal(r4[0][w_up], r4[2][w_up])  # another EP rank's slots


@pytest.mark.parametrize("mode", MODES)
def test_tp_serving_matches_world_1(runs, mode):
    _, r4, _ = runs
    want = r4[0][f"tpserve1/{mode}/tokens"]
    assert want.shape == (4, 6)
    for res in r4:
        assert np.array_equal(res[f"tpserve/{mode}/tokens"], want)


# ---------------------------------------------------------------------------
# Serving data parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", DP_MESHES, ids=["2,2", "2,1,2"])
def test_serving_data_parallelism_matches_world_1(runs, mesh, mode):
    """D 2 x ep 2 (``--mesh 2,2``, and ``2,1,2`` with the pod joining data):
    the decode batch of 2 split over the data group, tokens equal to world
    1's on every rank."""
    _, r4, _ = runs
    tag = ",".join(map(str, mesh))
    want = r4[0][f"dpserve/1/{mode}/tokens"]
    assert want.shape == (4, 6)
    for res in r4:
        assert res[f"dpserve/{tag}/{mode}/plan"].tolist() == [2, 2, 1]
        assert np.array_equal(res[f"dpserve/{tag}/{mode}/tokens"], want)


def test_paged_decode_over_data_matches_reference(runs):
    """Paged prefill then four decode steps of two sequences at (2, 2),
    each data rank decoding one: the all-gathered logits on every rank
    within the reference's 5e-3 of the reference's on the same mesh."""
    ref, r4, _ = runs
    want = ref["decode/logits"]
    assert want.shape == (4, 2, 512)
    for res in r4:
        assert np.array_equal(res["decode/block_table"], ref["decode/block_table"])
        assert np.array_equal(res["decode/logits"], r4[0]["decode/logits"])
        np.testing.assert_allclose(res["decode/logits"], want, rtol=0, atol=DECODE_ATOL)


# ---------------------------------------------------------------------------
# Migration at PP 2 x EP 2
# ---------------------------------------------------------------------------


def test_pp_ep_migration_plan_equals_reference(runs):
    """The controller at (2, 1, 2), pipelined, on the reference's seeded
    state and EMA: the reference ``Trainer._maybe_migrate``'s record
    (imbalance before and after, swaps, replicas), and the gathered params,
    m and v after it (assignments, replica tables and permuted experts)
    bitwise; every rank computed the same CRC of the plan."""
    ref, r4, _ = runs
    assert [r["mig/plan"].tolist() for r in r4] == [
        [2, 1, 2, 1, p, e] for p in range(2) for e in range(2)]
    for res in r4:
        np.testing.assert_array_equal(res["ctrl/record"], ref["ctrl/record"])
    assert ref["ctrl/record"][4] == 1 and ref["ctrl/record"][2] > 0
    keys = [k for k in ref if k.startswith("ctrl/after/")]
    assert keys and sorted(keys) == sorted(k for k in r4[0] if k.startswith("ctrl/after/"))
    for k in keys:
        assert np.array_equal(r4[0][k], ref[k]), k
    moved = [k for k in keys if k.endswith("/assignment")]
    assert any(not np.array_equal(ref[k], ref[k.replace("after", "before")]) for k in moved)
    assert len({int(r["ctrl/crc"]) for r in r4}) == 1


def test_pp_ep_swap_only_migration_is_a_permuted_init(runs):
    """A migration after step 3 of 5 at (2, 1, 2): params, m and v are
    bitwise the manual permutation of the gathered state, and the loss
    trajectory is bitwise that of a run whose init carried it."""
    _, r4, _ = runs
    for res in r4:
        assert bool(res["exact/applied"]) and int(res["exact/swaps"]) > 0
        assert bool(res["exact/moments_exact"])
        assert np.array_equal(res["exact/losses"], res["exact/losses_b"])
        assert np.array_equal(res["exact/losses"], r4[0]["exact/losses"])


def test_pp_ep_fit_migrates_and_its_checkpoint_restores_at_world_1(runs):
    _, r4, _ = runs
    assert all(int(r["migck/applied"]) >= 1 for r in r4)
    assert len({float(r["migck/loss"]) for r in r4}) == 1
    assert bool(r4[0]["migck/restored_crc_equal"])


# ---------------------------------------------------------------------------
# Checkpointing under a pipeline
# ---------------------------------------------------------------------------


def test_pp_checkpoint_rollback_sigterm_resume_is_the_uninterrupted_run(runs):
    """PP 2, depth 4: NaN at steps 3-5 -> three skips -> rollback to the
    step-2 checkpoint -> SIGTERM at 7 -> final save at 7; a fresh trainer
    on another seed's state resumes at 7 and ends at 8 bitwise the
    uninterrupted run (gathered state and loss)."""
    _, _, pp = runs
    for res in pp:
        assert res["B/anomalies"].tolist() == [3, 4, 5]
        assert res["B/rollbacks"].tolist() == [[5, 2]]
        assert int(res["B/last_step"]) == 6 and res["B/saved"].tolist()[-1] == 7
        assert int(res["C/resumed_from"]) == 7
        assert bool(res["C/bitwise_A"])
        assert np.array_equal(res["C/loss"], res["A/loss"])
    assert pp[0]["A/saved"].tolist() == [4, 6, 8]
    assert bool(pp[0]["A/manifest_crc_equal"])


def test_pp_checkpoint_restores_at_other_meshes(runs):
    """The PP 2 checkpoint is the global tree: restored at world 1, at PP 2
    under interleaved_1f1b V 2 and at PP 2 x EP 2, the gathered state's
    CRC32s equal the manifest's (and, at world 1 and V 2, the state the
    run's)."""
    _, r4, pp = runs
    assert bool(pp[0]["world1_crc_equal"])
    assert all(bool(r["v2_crc_equal"]) for r in pp)
    assert all(bool(r["ppck/ep2_crc_equal"]) for r in r4)


def test_pp_checkpoint_carries_the_load_ema(runs):
    _, _, pp = runs
    assert pp[0]["A/extras"].tolist() == ["load_stats"]
    assert pp[0]["A/ema"].any() and np.array_equal(pp[0]["C/ema"], pp[0]["A/ema"])
