"""ZeRO of the non-expert weights in the port, against the JAX package: the
reference's logical tags and rule table (``sharding.MeshPlan.rules``), each
rank's slice of every leaf, the gathers where a layer uses them and their
backward, the grad norm, checkpoints, migration and serving on the sliced
layout.

The tags, each rank's held block of every leaf and the grids whose dims do
not divide are checked here, in process (each rank's plan built without
ranks).  ``_torch_zero_child.py`` runs the rest: the JAX package on 8 fake
host devices (beside it the port's 2-rank runs, which need nothing of it),
then the port on 4 gloo ranks (``spawn``, a ``file://`` rendezvous, no
port).  Capacity factor 16, so no layout drops a row.

Tolerances.  At 2 slices the sliced run's loss and gathered gradients are
the all-whole control's bit for bit: the gathered weights are the whole
ones, and a sum of two terms does not depend on their order.  At 4 ranks
the forward is still bitwise (the loss), but the gradients are summed leaf
by leaf instead of in one bucket, so gloo rounds them in another order:
1e-6 (measured 7.5e-9).  One AdamW step: params within 2 lr of the
control's; the grad norm within 1e-6 relative (the sliced leaves' squares
are summed slice by slice; measured 9.5e-7, the sliced norm the nearer to
a float64 sum).  Against the reference's plan: the EP tests' gates
(``test_torch_ep.grad_gate_failures``); the pipeline executor at the
pipeline tests' 1e-5 loss and ``close_wire`` 1e-4.  Layouts, bytes,
checkpoints, migration and served tokens: exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.model import param_tree as jparam_tree
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.convert import shard_params
from repro_torch.launch import dryrun
from repro_torch.models.model import logical_tags, param_tree, tree_paths
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.optimizer import lr_schedule

from _torch_ep_child import _paths
from _torch_zero_child import (
    DRYRUN_BATCH, DRYRUN_MODES, LAYOUT_GRIDS, MODES, NAME, PP_SCHEDULES, R2_GRIDS, REMATS,
    arch_of, mixed_of,
)
from test_torch_ep import close_wire, grad_gate_failures
from test_torch_mesh import _groups

CHILD = Path(__file__).with_name("_torch_zero_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4  # the pipeline tests' executor gates
FOUR_RANK_ATOL = 1e-6
NORM_RTOL = 1e-6
TWO_LR = 2 * lr_schedule(OptimizerConfig(lr=1e-3), 1)  # the children's step-1 lr


def _child(args, env=None):
    return subprocess.Popen([sys.executable, str(CHILD)] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})


def _wait(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:] + "\n" + err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    ref_path = str(d / "ref.npz")
    jax_child = _child(["jax", ref_path], {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"})
    r2_child = _child(["r2", str(d)])
    _wait(r2_child)
    _wait(jax_child)
    _wait(_child(["r4", ref_path, str(d)]))
    ref = dict(np.load(ref_path))
    r2 = [dict(np.load(d / f"r2_rank{r}.npz")) for r in range(2)]
    r4 = [dict(np.load(d / f"r4_rank{r}.npz")) for r in range(4)]
    return ref, r2, r4


def _tree(res, prefix):
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# Tags and layouts, in process
# ---------------------------------------------------------------------------


def _mixed(get):
    return mixed_of(get(NAME).reduced())


ARCHS = {"granite": lambda get: get(NAME), "mamba2": lambda get: get("mamba2-370m"),
         "mixed": _mixed}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_tags_equal_the_reference(arch):
    """Every leaf's logical tags are the reference's ``param_tree``'s, the
    reps dim ``"layers"`` first on a block leaf."""
    want = {p: m.logical for p, m in _paths(jparam_tree(ARCHS[arch](jget_arch))).items()}
    got = logical_tags(ARCHS[arch](get_arch))
    assert got == want
    assert all(t[0] == "layers" for p, t in got.items() if p.startswith("blocks/"))


def _index_tree(arch):
    """Every leaf of ``arch``'s tree holding its own flat indices."""
    return {p: torch.arange(int(np.prod(m.shape)), dtype=torch.float64).reshape(m.shape)
            for p, m in tree_paths(param_tree(arch)).items()}


def _held_blocks(monkeypatch, arch, mesh, pipeline):
    """Per rank, {path: (shape, start of each dim)} of what it holds."""
    from _torch_ep_child import _unflatten

    tree = _unflatten(_index_tree(arch))
    world = int(np.prod(mesh))
    out = []
    for rank in range(world):
        _, plan = _groups(monkeypatch, arch, mesh, rank, pipeline_on_pod=pipeline)
        held = tree_paths(shard_params(tree, plan))
        full = tree_paths(tree)
        out.append({p: (tuple(t.shape), np.unravel_index(int(t.reshape(-1)[0]),
                                                          full[p].shape))
                    for p, t in held.items()})
    return out, plan


@pytest.mark.parametrize("grid", ["2,2", "1,4", "2,1,2pp"])
def test_each_rank_holds_the_reference_block(runs, monkeypatch, grid):
    """Every leaf's block on rank r is the reference's on device r under
    its ``param_specs`` (``NamedSharding.devices_indices_map``), the
    experts' included; under the pipeline but on the reps dim, where the
    port holds its stage's chunks (1/PP of the reps) and the reference's
    specs leave ``"layers"`` whole; the vocab dim is whole there."""
    ref, _, _ = runs
    mesh, experts, pipeline = LAYOUT_GRIDS[grid]
    arch = arch_of(get_arch(NAME).reduced(), experts=experts)
    held, plan = _held_blocks(monkeypatch, arch, mesh, pipeline)
    assert plan.layout and "embed" in plan.layout
    for r, blocks in enumerate(held):
        for path, (shape, start) in blocks.items():
            want = ref[f"layout/{grid}/{path}"][r]  # (ndim, [start, stop))
            dims = range(1 if pipeline and path.startswith("blocks/") else 0, len(shape))
            for i in dims:
                assert (start[i], start[i] + shape[i]) == tuple(want[i]), (r, path, i)
            if pipeline and path.startswith("blocks/"):
                assert shape[0] * plan.pp == want[0][1] - want[0][0]
    if pipeline:
        assert plan.layout["embed"] == (None, ("ep", "tp"))


def test_pod_folded_into_data_slices_over_it(runs, monkeypatch):
    """(2, 1, 2) without a pod pipeline: the port folds the pod into data
    and slices the "vocab", "embed" and "expert_ffn" dims over it (halves
    of the reference's, whose rules name "data" alone, size 1 here); every
    other dim is the reference's block."""
    ref, _, _ = runs
    mesh, experts, pipeline = LAYOUT_GRIDS["2,1,2"]
    arch = arch_of(get_arch(NAME).reduced(), experts=experts)
    held, plan = _held_blocks(monkeypatch, arch, mesh, pipeline)
    assert plan.dp == 2 and plan.pp == 1
    tags = logical_tags(arch)
    folded = 0
    for r, blocks in enumerate(held):
        d = r // 2
        for path, (shape, start) in blocks.items():
            want = ref[f"layout/2,1,2/{path}"][r]
            for i, tag in enumerate(tags[path]):
                lo, hi = want[i]
                if tag in ("vocab", "embed", "expert_ffn"):
                    assert (lo, hi) == (0, hi) and shape[i] * 2 == hi, (r, path, i)
                    assert start[i] == d * shape[i]
                    folded += 1
                else:
                    assert (start[i], start[i] + shape[i]) == (lo, hi), (r, path, i)
    assert folded


def test_grid_that_does_not_divide_keeps_those_dims_whole(monkeypatch):
    """(3, 2): D 3 divides neither the reduced vocab (512) nor d_model (64),
    so those dims stay whole, the (ep, tp) dims are sliced, and the [mesh]
    line says which and why; each rank holds that."""
    arch = arch_of(get_arch(NAME).reduced())
    held, plan = _held_blocks(monkeypatch, arch, (3, 2), False)
    assert plan.layout["embed"] == (None, ("ep", "tp"))
    assert plan.layout["blocks/0/mixer/wq"] == (None, None, ("ep", "tp"))
    assert plan.whole["embed"] == "dim 0 (512 % (data = 3) != 0)"
    assert "blocks/0/mixer/wo" in plan.whole
    line = plan.describe()
    assert "zero: 5 leaves sliced" in line and "whole: blocks/0/mixer/wk dim 1" in line
    for blocks in held:
        assert blocks["embed"][0] == (512, 32)
        assert blocks["blocks/0/mixer/wq"][0] == (2, 64, 32)


def test_granite_at_one_by_six_keeps_wk_and_wv_whole(monkeypatch):
    """Full-width granite at ``--mesh 1,6`` (ep 2 x tp 3): the kv width 512
    does not split 6 ways, so ``wk`` and ``wv`` stay whole and say so;
    ``wq``, ``wo`` and the embedding's d_model (1536) are sliced."""
    _, plan = _groups(monkeypatch, get_arch(NAME), (1, 6), 0)
    assert (plan.ep, plan.tp) == (2, 3)
    assert sorted(plan.layout) == ["blocks/0/mixer/wo", "blocks/0/mixer/wq", "embed"]
    for k in ("wk", "wv"):
        assert plan.whole[f"blocks/0/mixer/{k}"] == "dim 2 (512 % (ep x tp = 6) != 0)"
    assert "blocks/0/mixer/wk dim 2 (512 % (ep x tp = 6) != 0)" in plan.describe()


# ---------------------------------------------------------------------------
# Two ranks: bitwise against the all-whole control
# ---------------------------------------------------------------------------


GRIDS2 = [",".join(map(str, m)) for m in R2_GRIDS]


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", GRIDS2)
def test_two_slices_are_the_whole_run_bitwise(runs, grid, mode, remat):
    """At 2 slices ((1, 2): the (ep, tp) dims; (2, 1): the data dims) the
    loss and every gathered gradient are the all-whole control's bit for
    bit, on both ranks, under remat none and full, bf16 compute."""
    _, r2, _ = runs
    for r in r2:
        assert "embed" in r[f"{grid}/sliced"] and "blocks/0/mixer/wq" in r[f"{grid}/sliced"]
        tag = f"{grid}/{mode}/{remat}"
        assert np.array_equal(r[f"{tag}/sliced/loss"], r[f"{tag}/whole/loss"])
        got, want = _tree(r, f"{tag}/sliced/grad"), _tree(r, f"{tag}/whole/grad")
        assert sorted(got) == sorted(want) and len(want) == 12
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("grid", GRIDS2)
def test_one_step_within_two_lr_of_the_control(runs, grid):
    """One AdamW step: no skip, the params within 2 lr of the control's,
    the grad norm within 1e-6 relative."""
    _, r2, _ = runs
    for r in r2:
        s, w = f"{grid}/step/sliced", f"{grid}/step/whole"
        assert int(r[f"{s}/skipped"]) == 0
        np.testing.assert_allclose(r[f"{s}/grad_norm"], r[f"{w}/grad_norm"], rtol=NORM_RTOL)
        got, want = _tree(r, f"{s}/params"), _tree(r, f"{w}/params")
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= TWO_LR, k


def test_sliced_checkpoint_round_trips_through_world_1(runs):
    """A sliced checkpoint restores at world 1 with the manifest's CRC32s
    and the global state bit for bit; saved there, it restores sliced."""
    _, r2, _ = runs
    assert bool(r2[0]["ck/world1_crc_equal"])
    assert all(bool(r["ck/sliced_crc_equal"]) for r in r2)


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------


def test_two_by_two_matches_control_and_reference_plan(runs):
    """(2, 2), everything sliced 4 ways: the loss bitwise the control's,
    the gradients within 1e-6 of it, and within the EP gates of the
    reference's plan on the same grid; every rank gathers the same."""
    ref, _, r4 = runs
    r0 = r4[0]
    assert np.array_equal(r0["2,2/sliced/loss"], r0["2,2/whole/loss"])
    got, ctrl = _tree(r0, "2,2/sliced/grad"), _tree(r0, "2,2/whole/grad")
    for k in ctrl:
        np.testing.assert_allclose(got[k], ctrl[k], rtol=0, atol=FOUR_RANK_ATOL, err_msg=k)
    assert abs(float(r0["2,2/sliced/loss"]) - float(ref["ref/loss"])) < 2e-3
    want = _tree(ref, "ref/grad")
    assert sorted(got) == sorted(want)
    assert grad_gate_failures(got, want) == []
    for r in r4[1:]:
        assert all(np.array_equal(_tree(r, "2,2/sliced/grad")[k], got[k]) for k in got)
    assert "zero: 5 leaves sliced (blocks/0/mixer/wk" in str(r0["describe"])


def test_mixed_dense_and_moe_blocks_match_reference_plan(runs):
    """The mixed pattern at (2, 2): the dense FFN's three leaves are sliced
    and gathered too; loss and gradients at the EP gates of the
    reference's plan."""
    ref, _, r4 = runs
    sliced = list(r4[0]["mixed/sliced"])
    assert {"blocks/0/ffn/w_up", "blocks/0/ffn/w_gate", "blocks/0/ffn/w_down"} <= set(sliced)
    assert not any(k.startswith("blocks/1/ffn") for k in sliced)
    assert abs(float(r4[0]["mixed/loss"]) - float(ref["mixed/loss"])) < 2e-3
    got, want = _tree(r4[0], "mixed/grad"), _tree(ref, "mixed/grad")
    assert sorted(got) == sorted(want)
    assert grad_gate_failures(got, want) == []


def test_sliced_leaves_hold_a_quarter_of_the_bytes(runs):
    """At (2, 2) each rank's params, m and v of every sliced leaf take
    exactly 1/4 of the control's bytes, with fp32 and bf16 moments."""
    _, _, r4 = runs
    for r in r4:
        for odt in ("float32", "bfloat16"):
            sliced, whole = r[f"bytes/sliced/{odt}"], r[f"bytes/whole/{odt}"]
            assert (4 * sliced == whole).all() and sliced.min() > 0, (odt, sliced, whole)


def test_swap_only_migration_under_full_slicing(runs):
    """A swap across the EP ranks at (2, 2), every leaf sliced: params, m
    and v gathered equal the manual permutation of the gathered state,
    the sliced leaves unchanged."""
    _, _, r4 = runs
    assert all(bool(r["mig/exact"]) for r in r4)


def test_paged_serving_matches_the_reference_engine(runs):
    """The engine at (2, 2) on the sliced params (each decode step gathers
    the table and each layer's projections): the reference engine's tokens
    on the same mesh, on every rank."""
    ref, _, r4 = runs
    for r in r4:
        assert np.array_equal(r["serve/tokens"], ref["serve/tokens"])


@pytest.mark.parametrize("name", PP_SCHEDULES)
def test_pipeline_gradients_match_the_reference_executor(runs, name):
    """PP 2 x EP 2 at (2, 1, 2): the embedding sliced over (ep, tp) (its
    vocab dim whole) and the attention leaves too; each executor's loss and
    gathered gradients, the embedding's included, against the reference's
    1f1b executor (its schedules give one gradient)."""
    ref, _, r4 = runs
    assert "embed" in list(r4[0]["pp/sliced"])
    r0 = r4[0]
    assert abs(float(r0[f"pp/{name}/loss"]) - float(ref["pp/loss"])) < LOSS_ATOL
    got, want = _tree(r0, f"pp/{name}/grad"), _tree(ref, "pp/grad")
    assert sorted(got) == sorted(want) and "embed" in want
    for k in want:
        close_wire(got[k], want[k], GRAD_ATOL)


def test_pp_checkpoint_restores_at_world_1(runs):
    _, _, r4 = runs
    assert bool(r4[0]["ppck/world1_crc_equal"])


def test_pod_folded_into_data_keeps_the_function(runs):
    """(2, 1, 2) without a pod pipeline, sliced over pod x data: the loss
    bitwise the control's, gradients within 1e-6, one step within 2 lr
    and the grad norm within 1e-6 relative."""
    _, _, r4 = runs
    r0 = r4[0]
    assert int(r0["fold/dp"]) == 2
    assert np.array_equal(r0["fold/sliced/loss"], r0["fold/whole/loss"])
    got, want = _tree(r0, "fold/sliced/grad"), _tree(r0, "fold/whole/grad")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FOUR_RANK_ATOL, err_msg=k)
    np.testing.assert_allclose(r0["fold/step/sliced/grad_norm"],
                               r0["fold/step/whole/grad_norm"], rtol=NORM_RTOL)
    got, want = _tree(r0, "fold/step/sliced/params"), _tree(r0, "fold/step/whole/params")
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= TWO_LR, k


@pytest.mark.parametrize("mode", DRYRUN_MODES)
@pytest.mark.parametrize("rank", [0, 3])
def test_dry_run_tally_at_a_fake_world_of_4_equals_gloo(runs, mode, rank):
    """The dry run's trace of a train step at (2, 2) on a fake process
    group of 4, this rank's, counts the collectives (count, result and
    wire bytes by kind), the FLOPs and the peak bytes that the same
    counter counts on real tensors across 4 gloo ranks (the child's
    section 6)."""
    _, _, r4 = runs
    want = json.loads(str(r4[rank][f"dryrun/{mode}"]))
    arch = arch_of(get_arch(NAME).reduced(), mode)
    with dryrun.fake_world(4, rank=rank):
        got = dryrun.trace_step(arch, "train", sharding.make_plan(arch, (2, 2)),
                                *DRYRUN_BATCH)
    assert got["collectives"] == want["collectives"]
    assert set(want["collectives"]["counts"]) >= {"all-to-all", "all-reduce"}
    assert got["cost"]["flops"] == want["flops"]
    assert got["memory"]["peak_bytes"] == want["peak_bytes"]
