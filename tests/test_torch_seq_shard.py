"""The port's sequence-sharded training layout against the JAX package's.

The reference lays a training batch out by its rule table: rows over the
data axes, the sequence over ``("ep", "tp")`` (``repro.training
.batch_specs``; ``P(dp, sp, None)`` activations in ``moe_ffn`` and the
pipeline).  The port's ``training.shard_batch`` gives each rank the same
block; attention gathers K/V over the sequence group, and a Mamba2 mixer
hands its state and conv rows from rank to rank.
``_torch_mesh_child.py`` runs both sides, side by side, from the port's
``init_params`` (seed 0): its ``seq-jax`` mode on 8 fake host devices
(two processes, each half of the cases), its ``seq-port`` mode on 4 gloo
ranks of the CPU (``spawn`` and a
``file://`` rendezvous, no port).  The EP layer's payload crosses in fp32
on both sides (the reference's ``_transport_bf16`` replaced by the
identity), so no bf16 rounding of the wire flips a route.  Meanwhile this
process traces the dry run's pipelined pod2 cell.

* **The layout.** At (1, 4), (2, 2), (2, 1, 2) (the pod joining data) and
  a tp grid, every rank's ``shard_batch`` block of ``tokens``, ``labels``
  and ``embeds`` is the block ``jax.device_put(batch, NamedSharding(mesh,
  batch_specs(...)))`` puts on the same device, exactly; under the pod
  pipeline, a microbatch's block of the executor's ``P(dp, sp)``.
* **The drop regime.** Reduced granite at its capacity factor 1.25 at (2,
  2): a rank's 64 tokens give each expert a budget of 20 (k = 2 of 8), so
  tokens drop, and which ones depends on the tokens a rank holds.  The loss
  within 1e-5 of the reference's plan at the same grid and every gradient
  leaf within the EP tests' 1e-4, in both dispatch modes; world 1 drops
  other tokens, so its loss differs.
* **Shard boundaries.** Reduced gemma2 (window 32, attention and final
  softcaps) and qwen2-vl (M-RoPE, fed ``embeds``) at (1, 4), 16 positions
  a rank, reduced mamba2 and jamba (one rep, cf 16) at (2, 2), 32 (one
  SSM chunk) a rank, and mamba2 at (1, 4), 16 a rank (half a chunk: the
  state crosses three boundaries in two scan rounds): against world 1 and
  the reference's plan at the model-parity 1e-5 (loss) and 1e-4
  (gradients).
* **The pipeline.** 1f1b at PP 2 x ep 2 with M = 2 PP microbatches, each
  stage's ranks holding sequence slices, against the reference's
  pipelined ``loss_and_grads`` and world 1, at the same gates (aux loss 0:
  a pipeline means it over microbatches, world 1 over the batch).
* **The dry run.** Reduced granite on a 512-rank fake group traces the
  pod2 pipelined ``train_4k`` cell: status ok, M = 2 PP, no notes; at the
  production grid a rank holds 8 rows x 256 positions.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch import sharding, training
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun

from _torch_mesh_child import (SEQ_B, SEQ_CASES, SEQ_JAX_PARTS, SEQ_LAYOUT_BATCH,
                               SEQ_LAYOUTS, SEQ_PP, SEQ_PP_CASE, SEQ_S, layout_arch,
                               layout_batch)

CHILD = Path(__file__).with_name("_torch_mesh_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4
WORLD1 = [c for c in SEQ_CASES if not c.startswith("granite/")] + [SEQ_PP_CASE]


def _child(args, env=None):
    return subprocess.Popen([sys.executable, str(CHILD)] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})


def _wait(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:] + "\n" + err[-4000:]


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Both sides started at once (they share nothing but the seed)."""
    d = tmp_path_factory.mktemp("seq")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    procs = [_child(["seq-jax", str(d / f"ref{i}.npz"), str(i)], env)
             for i in range(len(SEQ_JAX_PARTS))]
    procs.append(_child(["seq-port", str(d)], {"OMP_NUM_THREADS": "1"}))
    yield d, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs(children):
    d, procs = children
    for p in procs:
        _wait(p)
    ref = {}
    for i in range(len(SEQ_JAX_PARTS)):
        ref.update(np.load(d / f"ref{i}.npz"))
    return ref, [dict(np.load(d / f"seq_rank{r}.npz")) for r in range(4)]


def _grads(res, tag):
    pre = f"{tag}/grad/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _hold(got_loss, want_loss, got, want):
    assert abs(float(got_loss) - float(want_loss)) < LOSS_ATOL, (got_loss, want_loss)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# The dry run (in this process, while the children run)
# ---------------------------------------------------------------------------


def test_dry_run_traces_the_pipelined_pod2_cell(children, monkeypatch):
    """The 512-rank pipelined ``train_4k`` cell, which ran 1 microbatch
    when a rank held whole sequences: reduced granite traces with M = 2 PP
    and no notes, and its collectives count the sequence gathers."""
    reduced = {}

    def get(name):
        if name not in reduced:
            reduced[name] = get_arch(name).reduced()
        return reduced[name]

    monkeypatch.setattr(tconfigs, "get_arch", get)
    rec = dryrun.run_cell("granite-moe-3b-a800m", "train_4k", True, pipeline=True, save=False)
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["chips"], rec["pp"]) == (512, 2)
    assert rec["microbatches"] == 2 * rec["pp"] and "notes" not in rec
    assert rec["collectives"]["counts"]["all-gather"] > 0


def test_the_production_grid_holds_the_reference_block_a_rank():
    """256 sequences of 4096 tokens at (2, 16, 16): 32 data ranks of 8 rows,
    16 sequence ranks of 256 positions (ep 8 x tp 2); under the pod
    pipeline 4 rows of each microbatch's 64 over 16 data ranks."""
    arch = get_arch("granite-moe-3b-a800m")
    flat = sharding.MeshPlan(dp=32, ep=8, tp=2, dp_axes=("pod", "data"), arch=arch)
    assert training.batch_block(flat, 256, 4096) == (8, 256)
    piped = sharding.MeshPlan(dp=16, ep=8, tp=2, pp=2, arch=arch)
    assert piped.num_microbatches == 4
    assert training.batch_block(piped, 256, 4096) == (4, 256)
    for plan, b, s, what in ((flat, 256, 4095, "sequence 4095"), (flat, 248, 4096, "batch 248"),
                             (piped, 96, 4096, "batch 96")):
        with pytest.raises(ValueError, match=what):
            training.batch_block(plan, b, s)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(SEQ_LAYOUTS))
def test_each_rank_takes_the_reference_batch_block(runs, tag):
    ref, _ = runs
    grid, _ = SEQ_LAYOUTS[tag]
    arch = layout_arch(get_arch, tag)
    pod = grid[0] if len(grid) == 3 else 1
    data, model = grid[-2:]
    ep = sharding.choose_ep(arch.moe.num_experts if arch.moe else model, model)
    assert ref[f"layout/{tag}/plan"].tolist() == [ep, model // ep]
    keys = ref[f"layout/{tag}/keys"].tolist()
    assert ("embeds" in keys) == (arch.frontend is not None)
    batch = {k: v for k, v in layout_batch().items() if k in keys}
    for wrap in (np.asarray, torch.from_numpy):
        for rank in range(pod * data * model):
            plan = sharding.MeshPlan(dp=pod * data, ep=ep, tp=model // ep, rank=rank,
                                     dp_axes=("pod", "data") if pod > 1 else ("data",))
            mine = training.shard_batch({k: wrap(v) for k, v in batch.items()}, plan)
            for k in keys:
                np.testing.assert_array_equal(np.asarray(mine[k]),
                                              ref[f"layout/{tag}/{k}/{rank}"],
                                              err_msg=f"{k} rank {rank}")


def test_each_pipelined_rank_takes_its_block_of_every_microbatch(runs):
    """Under the pod pipeline the rank's rows are microbatch-major: its
    block of each microbatch's ``P(dp, sp)`` activations, in microbatch
    order."""
    ref, _ = runs
    grid, M = SEQ_PP
    b, s = SEQ_LAYOUT_BATCH
    toks = layout_batch()["tokens"]
    for rank in range(int(np.prod(grid))):
        plan = sharding.MeshPlan(dp=grid[1], ep=grid[2], tp=1, pp=grid[0], rank=rank)
        assert plan.num_microbatches == M
        mine = training.shard_batch({"tokens": toks}, plan)["tokens"]
        want = ref[f"layout/pp/tokens/{rank}"]
        np.testing.assert_array_equal(mine, want.reshape(-1, want.shape[-1]))
        assert mine.shape == (b // grid[1], s // grid[2])


# ---------------------------------------------------------------------------
# Loss and gradients against the reference's plan and world 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["capacity", "ragged"])
def test_drops_match_the_reference_plan(runs, mode):
    """At capacity factor 1.25 the ranks drop the tokens the reference's
    ranks drop: its plan at (2, 2) within 1e-5 (loss) and 1e-4 (every
    gradient leaf); world 1, whose one budget covers the whole batch, is
    another function, its loss further off than the gate."""
    ref, res = runs
    case = f"granite/{mode}"
    assert res[0][f"{case}/block"].tolist() == [SEQ_B // 2, SEQ_S // 2]
    _hold(res[0][f"{case}/loss"], ref[f"{case}/loss"], _grads(res[0], case),
          _grads(ref, case))
    if mode == "capacity":
        assert abs(float(res[0][f"{case}/loss"])
                   - float(res[0][f"{case}/world1/loss"])) > LOSS_ATOL
    for r in res[1:]:
        assert float(r[f"{case}/loss"]) == float(res[0][f"{case}/loss"])


@pytest.mark.parametrize("case", WORLD1)
def test_sharded_sequences_match_world_1_and_the_reference(runs, case):
    """Slices that cross a causal boundary, a sliding window, M-RoPE's
    planes, the SSM's chunk and conv, and the pipeline's hand-offs: the
    same function as world 1's, and as the reference's plan at the grid."""
    ref, res = runs
    _hold(res[0][f"{case}/loss"], ref[f"{case}/loss"], _grads(res[0], case),
          _grads(ref, case))
    _hold(res[0][f"{case}/loss"], res[0][f"{case}/world1/loss"], _grads(res[0], case),
          _grads(res[0], f"{case}/world1"))
    if case == SEQ_PP_CASE:
        assert int(res[0]["pp/microbatches"]) == 2 * SEQ_PP[0][0]
