"""The port's expert migration, hot-expert replicas, serving rebalance and
EP-agnostic checkpoint against the JAX package's.

Without ranks: the planner (``repro_torch.core.migration``) against
``repro.core.migration`` with ``==`` over a seeded sweep of Zipf loads and
start assignments (plain parametrisation: the reference's ``@given`` test
with default arguments is what hypothesis refuses); the load EMA's
checkpoint round trip; the in-place permutation against
``apply_migration_to_tree``.

Over ranks, ``_torch_migration_child.py`` runs both sides once for the
module: the JAX package on 8 fake host devices, then the port on gloo
ranks of the CPU (4 at mesh (1, 4), then 8 at (2, 4)).  Tolerances are
``tests/test_torch_ep.py``'s: the layer's forward 1e-5, gradients 1e-4
with ``close_wire`` (the bf16 wire may round an element one bf16 step the
other way), decode 1e-5.  Migration only relabels slots, so everything it
touches is held bitwise.
"""

import base64
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import migration as jmig
from repro_torch.checkpoint import read_extras, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy, shard_params
from repro_torch.core import migration as mig
from repro_torch.models.model import LanguageModel, init_params, tree_paths
from repro_torch.training import init_state

from test_torch_ep import BL, FWD_ATOL, GRAD_ATOL, block, close_wire, expert_slice

CHILD = Path(__file__).with_name("_torch_migration_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
MODES = ("capacity", "ragged")
SWEEP = [(E, ep, seed) for E in (8, 40) for ep in (2, 4, 8) for seed in (0, 1, 2)]
IDS = [f"E{E}-ep{ep}-s{seed}" for E, ep, seed in SWEEP]


def zipf_loads(E: int, seed: int, layers: int = 3) -> np.ndarray:
    """Seeded Zipf-skewed per-expert loads, shuffled over the experts."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, E + 1, dtype=np.float64)
    out = np.stack([rng.permutation(1000.0 / ranks ** rng.uniform(0.8, 1.6))
                    for _ in range(layers)])
    return np.round(out, 3)


def start_assignment(E: int, seed: int) -> np.ndarray:
    return np.random.default_rng(100 + seed).permutation(E).astype(np.int32)


# ---------------------------------------------------------------------------
# The planner, against the reference, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,ep,seed", SWEEP, ids=IDS)
def test_load_stats_equal_the_reference(E, ep, seed):
    loads = zipf_loads(E, seed)
    L = loads.shape[0]
    ours, ref = mig.LoadStats(L, E), jmig.LoadStats(L, E)
    for step in range(4):
        ours.update(loads * (step + 1))
        ref.update(loads * (step + 1))
    assert ours.ema.tobytes() == ref.ema.tobytes() and ours.steps == ref.steps
    assign = np.stack([start_assignment(E, seed + i) for i in range(L)])
    reps = np.stack([np.asarray([np.argmax(l), E], np.int32) for l in loads])
    for r in (None, reps, np.full((L, 2), E, np.int32)):
        assert np.array_equal(ours.group_loads(assign, ep, r), ref.group_loads(assign, ep, r))
        assert ours.imbalance(assign, ep, r) == ref.imbalance(assign, ep, r)


@pytest.mark.parametrize("E,ep,seed", SWEEP, ids=IDS)
def test_rebalance_equals_the_reference(E, ep, seed):
    loads = zipf_loads(E, seed)[0]
    assign = start_assignment(E, seed)
    for iters in (1, 3, 100):
        got, want = (m.rebalance_assignment(loads, assign, ep, max_iters=iters)
                     for m in (mig, jmig))
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        e_l = E // ep
        groups = [[(int(e), float(loads[e])) for e in range(E) if assign[e] // e_l == g]
                  for g in range(ep)]
        assert (mig.hill_climb_rebalance(groups, max_iters=iters)
                == jmig.hill_climb_rebalance(groups, max_iters=iters))
    new = got[0]
    perm = mig.permutation_for(assign, new)
    assert np.array_equal(perm, jmig.permutation_for(assign, new))
    assert np.array_equal(mig.moved_experts(assign, new, ep, E),
                          jmig.moved_experts(assign, new, ep, E))
    assert mig.swap_floor(loads, ep) == jmig.swap_floor(loads, ep)
    assert mig.swap_floor(np.zeros(E), ep) == jmig.swap_floor(np.zeros(E), ep)


@pytest.mark.parametrize("E,ep,seed", SWEEP, ids=IDS)
def test_replication_and_layer_plans_equal_the_reference(E, ep, seed):
    loads = zipf_loads(E, seed)
    assign = start_assignment(E, seed)
    for R in (1, 2, 4):
        reps = np.full(R, E, np.int32)
        # Hysteresis: plan, cool the hottest expert a little, then a lot.
        for scale in (1.0, 0.7, 0.05):
            l = loads[0].copy()
            l[np.argmax(loads[0])] *= scale
            got, want = mig.plan_replication(l, reps, ep), jmig.plan_replication(l, reps, ep)
            assert np.array_equal(got, want) and got.dtype == want.dtype
            reps = got
        for rep_table in (None, np.full(R, E, np.int32), reps):
            got = mig.plan_layer(loads[1], assign, rep_table, ep)
            want = jmig.plan_layer(loads[1], assign, rep_table, ep)
            for g, w in zip(got, want):
                assert (g is None and w is None) or np.array_equal(g, w)
    assert mig.plan_replication(np.zeros(E), np.zeros(2, np.int32), ep).tolist() == [E, E]
    for n in (0, 1, 3):
        assert (mig.replication_bytes(n, 1536, 512, ep)
                == jmig.replication_bytes(n, 1536, 512, ep))
    assert mig.migration_cost(E, 1536, 512, G=ep) == jmig.migration_cost(E, 1536, 512, G=ep)


# ---------------------------------------------------------------------------
# Without ranks: persistence and the in-place permutation
# ---------------------------------------------------------------------------


def test_load_stats_survive_a_checkpoint_manifest_bit_exactly(tmp_path):
    loads = zipf_loads(40, 3, layers=32)
    ours, ref = mig.LoadStats(32, 40), jmig.LoadStats(32, 40)
    for i in range(5):
        ours.update(loads / (i + 1.3))
        ref.update(loads / (i + 1.3))
    state = ours.to_state()
    assert base64.b64decode(state["ema"]) == ref.to_state()["ema"]
    save_checkpoint(tmp_path, 7, {"w": np.zeros(3, np.float32)},
                    extras={"load_stats": state})
    back = mig.LoadStats.from_state(read_extras(tmp_path, 7)["load_stats"])
    assert back.ema.tobytes() == ours.ema.tobytes()
    assert (back.decay, back.steps) == (ours.decay, ours.steps)
    with pytest.raises(ValueError, match="shape mismatch"):
        mig.LoadStats(31, 40).load_state(state)


def test_in_place_permutation_is_the_reference_apply_migration_to_tree():
    rng = np.random.default_rng(0)
    reps, E = 2, 8
    tree = {"w_up": rng.standard_normal((reps, E, 4, 3)).astype(np.float32),
            "w_gate": rng.standard_normal((reps, E, 4, 3)).astype(np.float32),
            "w_down": rng.standard_normal((reps, E, 3, 4)).astype(np.float32)}
    perm = np.stack([mig.permutation_for(np.arange(E), rng.permutation(E))
                     for _ in range(reps)])
    want = jmig.apply_migration_to_tree(dict(tree), perm)
    ours = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    live = dict(ours)
    assert mig.apply_migration_(ours, perm) == 0
    for k in tree:
        assert ours[k] is live[k]  # in place
        assert np.array_equal(ours[k].numpy(), np.asarray(want[k]))


def test_max_replicas_adds_a_sentinel_table_and_leaves_the_rest_of_init():
    base = get_arch("granite-moe-3b-a800m").reduced()
    assert base.moe.max_replicas == 0
    with pytest.raises(ValueError, match="max_replicas"):
        dataclasses.replace(base.moe, max_replicas=-1)
    rep = base.replace(moe=dataclasses.replace(base.moe, max_replicas=2))
    assert rep.reduced().moe.max_replicas == 2
    p0 = tree_paths(init_params(base, torch.Generator().manual_seed(0), "cpu"))
    p2 = tree_paths(init_params(rep, torch.Generator().manual_seed(0), "cpu"))
    assert sorted(set(p2) - set(p0)) == ["blocks/0/ffn/replicas"]
    assert p2["blocks/0/ffn/replicas"].tolist() == [[8, 8]] * 2
    assert all(torch.equal(p0[k], p2[k]) for k in p0)
    # The weight-carrying functions carry the table: whole on every rank.
    tree = init_params(rep, torch.Generator().manual_seed(0), "cpu")
    back = params_from_numpy(params_to_numpy(tree), "cpu")
    assert torch.equal(back["blocks"][0]["ffn"]["replicas"], p2["blocks/0/ffn/replicas"])
    assert back["blocks"][0]["ffn"]["replicas"].dtype == torch.int32
    plan = SimpleNamespace(ep=4, ep_rank=1)
    shard = shard_params(tree, plan)["blocks"][0]["ffn"]
    assert shard["replicas"] is tree["blocks"][0]["ffn"]["replicas"]
    assert shard["w_up"].shape[1] == 2


# ---------------------------------------------------------------------------
# Over ranks
# ---------------------------------------------------------------------------


def _run(args, env=None):
    proc = subprocess.run([sys.executable, str(CHILD)] + args, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})
    assert proc.returncode == 0, proc.stdout[-4000:] + "\n" + proc.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mig")
    ref_path = str(d / "ref.npz")
    _run(["jax", ref_path], {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                             "JAX_PLATFORMS": "cpu"})
    _run(["port", ref_path, str(d)])
    ref = dict(np.load(ref_path))
    r4 = [dict(np.load(d / f"r4_rank{r}.npz")) for r in range(4)]
    r8 = [dict(np.load(d / f"r8_rank{r}.npz")) for r in range(8)]
    return ref, r4, r8, d


def _arch(mode, **kw):
    base = get_arch("granite-moe-3b-a800m").reduced()
    return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode, capacity_factor=16.0,
                                                max_replicas=2, **kw))


@pytest.mark.parametrize("mode", MODES)
def test_replicated_layer_matches_the_reference_live_table(runs, mode):
    """moe_ffn at ep 4 with the live table [0, 3] against the JAX
    package's on the (2, 4) mesh, per device block: forward, gradients and
    decode."""
    ref, _, r8, _ = runs
    t = f"rep/{mode}"
    for r, res in enumerate(r8):
        np.testing.assert_allclose(res[f"{t}/y"], block(ref[f"{t}/y"], r), rtol=0,
                                   atol=FWD_ATOL)
        np.testing.assert_allclose(res[f"{t}/expert_load"], ref[f"{t}/expert_load"],
                                   rtol=0, atol=1e-6)
        close_wire(res[f"{t}/dx"], block(ref[f"{t}/dx"], r), GRAD_ATOL)
        close_wire(res[f"{t}/dw_router"], ref[f"{t}/dw_router"], GRAD_ATOL)
        for k in ("w_up", "w_gate", "w_down"):
            close_wire(res[f"{t}/d{k}"], expert_slice(ref[f"{t}/d{k}"], r), GRAD_ATOL)
        i = r // 4
        np.testing.assert_allclose(res[f"{t}/decode"], ref[f"{t}/decode"][i * BL:(i + 1) * BL],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_replication_is_function_preserving_against_the_sentinel_table(runs, mode):
    """The port's own live-table layer against its sentinel-table run:
    replica rows compute off the wire, and their gradients sum back into
    the owner's slot."""
    _, _, r8, _ = runs
    for res in r8:
        a, b = f"rep/{mode}", f"sentinel/{mode}"
        np.testing.assert_allclose(res[f"{a}/y"], res[f"{b}/y"], rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(res[f"{a}/decode"], res[f"{b}/decode"], rtol=0, atol=1e-5)
        for k in ("dx", "dw_router", "dw_up", "dw_gate", "dw_down"):
            close_wire(res[f"{a}/{k}"], res[f"{b}/{k}"], GRAD_ATOL)


def test_controller_plans_and_applies_what_the_reference_does(runs):
    """The same EMA into both trainers' controllers (ep 4, two replica
    channels): the same record, and the port's in-place sharded
    permutation of params, m and v gathered is the reference's
    ``apply_migration_to_tree`` output bit for bit."""
    ref, r4, _, _ = runs
    want = {k: v for k, v in ref.items() if k.startswith("ctrl/after/")}
    for res in r4:
        assert np.array_equal(res["ctrl/record"], ref["ctrl/record"])
        got = {k: v for k, v in res.items() if k.startswith("ctrl/after/")}
        assert sorted(got) == sorted(want)
        assert [k for k in want if not np.array_equal(got[k], want[k])] == []
    assert ref["ctrl/record"][2] > 0 and ref["ctrl/record"][3] > 0  # swaps and replicas
    assert not np.array_equal(ref["ctrl/after/params/blocks/0/ffn/w_up"],
                              ref["ctrl/before/params/blocks/0/ffn/w_up"])
    # Each rank received the other three ranks' shards of 9 leaves.
    per_leaf = 2 * 2 * 64 * 64 * 4  # (reps, E_l, d, f) fp32
    assert int(r4[0]["ctrl/gathered_bytes"]) == 3 * 9 * per_leaf


@pytest.mark.parametrize("mode", MODES)
def test_migration_is_one_permutation_and_keeps_the_trajectory(runs, mode):
    """The reference's check_migration_exactness at ep 4 (top-4 routing,
    where the order of a token's row gradients matters): one migration
    (after step 3) moves params, m and v by the same permutation (bitwise
    the manual one), on every rank alike, and the 6-step loss trajectory is
    bitwise that of a run whose init carried the permutation."""
    _, r4, _, _ = runs
    t = f"exact/{mode}"
    for res in r4:
        assert bool(res[f"{t}/applied"]) and bool(res[f"{t}/moments_exact"])
        assert int(res[f"{t}/moved"]) > 0
        assert res[f"{t}/losses"].tobytes() == res[f"{t}/losses_b"].tobytes()
        assert res[f"{t}/losses"].tobytes() == r4[0][f"{t}/losses"].tobytes()


@pytest.mark.parametrize("mode", MODES)
def test_serving_rebalance_keeps_tokens_and_matches_the_reference_trace(runs, mode):
    ref, r4, _, _ = runs
    t = f"serve/{mode}"
    for res in r4:
        assert np.array_equal(res[f"{t}/rebalanced/tokens"], res[f"{t}/static/tokens"])
        assert np.array_equal(res[f"{t}/rebalanced/tokens"], ref[f"{t}/tokens"])
        assert res[f"{t}/static/rebalance"].shape == (0, 3)
        assert np.array_equal(res[f"{t}/rebalanced/rebalance"], ref[f"{t}/rebalance"])
    acted = ref[f"{t}/rebalance"][:, 1:].sum(axis=1)
    assert len(acted) >= 2 and (acted > 0).any()


def _state_of(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def test_checkpoint_at_ep_4_restores_bitwise_at_world_1_and_ep_2(runs):
    """Run A (ep 4, migrations on) ends in a checkpoint of the global
    state: restored at world 1 here and at ep 2 on 8 ranks, the state
    equals A's gathered state bit for bit, and the load EMA rides in the
    extras bit-exactly."""
    _, r4, r8, d = runs
    want = _state_of(r4[0], "ckA/state/")
    assert int(r4[0]["ckA/migrations"]) >= 1
    assert not np.array_equal(want["params/blocks/0/ffn/assignment"],
                              np.tile(np.arange(8), (2, 1)))
    arch = _arch("ragged")
    state = init_state(LanguageModel(arch), torch.Generator().manual_seed(9), "cpu")
    restore_checkpoint(d / "ckA", state, log_fn=lambda s: None)
    got = {k: v.numpy() for k, v in tree_paths(state).items()}
    assert sorted(got) == sorted(want)
    assert [k for k in want if not np.array_equal(got[k], want[k])] == []
    extras = read_extras(d / "ckA", 6)["load_stats"]
    assert base64.b64decode(extras["ema"]) == r4[0]["ckA/ema"].tobytes()
    assert extras["steps"] == int(r4[0]["ckA/steps"]) == 6
    for res in r8:
        assert int(res["ep2/step"]) == 6
        got = _state_of(res, "ep2/state/")
        assert [k for k in want if not np.array_equal(got[k], want[k])] == []
        assert res["ep2/ema"].tobytes() == r4[0]["ckA/ema"].tobytes()


def test_sigterm_at_ep_4_then_resume_is_the_uninterrupted_run(runs):
    _, r4, _, _ = runs
    for res in r4:
        assert int(res["ckB/last_step"]) == 3 and int(res["ckC/resumed_from"]) == 4
        a, c = _state_of(res, "ckA/state/"), _state_of(res, "ckC/state/")
        assert [k for k in a if not np.array_equal(a[k], c[k])] == []
        assert res["ckA/loss"].tobytes() == res["ckC/loss"].tobytes()
        assert res["ckA/ema"].tobytes() == res["ckC/ema"].tobytes()
