"""The port's pipeline executor and pod axis against the JAX package's.

``_torch_pipeline_child.py`` runs both sides once for the module, from the
same converted ``init_params`` and the same tokens (numpy seed 3): the JAX
package's ``LanguageModel.loss_and_grads`` on 8 fake host devices, then the
port on gloo ranks of the CPU (4, 2 and 8 ranks; ``spawn`` and a
``file://`` rendezvous, no port).  The arch is the reference child's
(``tests/_pipeline_schedules_child.py``): reduced granite at 4 layers, one
rep a stage at PP 4, capacity factor 8, aux loss 0; cf 16 for PP x EP, so
no layout drops a row.  Meanwhile ``torchrun`` drives the train launcher at
``--mesh 2,1,2 --pipeline --schedule zb_h1``.

Tolerances.  Executor against executor at ep = 1 (mesh (4, 1, 1) and
(2, 1, 1): no wire, no routing tie to flip): loss 1e-5, gradients 1e-4, the
EP tests' tolerances; the executed traces exactly.  The reference child's
own gates: the autograd oracle at 1e-5 (embedding relative 1e-3), the
sequential stack at its ``grad_close`` (3e-3, embedding relative 0.15) with
the loss within 1e-3, zb_h1 and 1f1b_overlap against 1f1b at 1e-6.  PP x
EP against the JAX executor on the same mesh: ``close_wire``, since the EP
layer's payload crosses in bf16 on both sides and a last-bit difference
may round an element one bf16 step the other way.  Against world 1, which
has no wire, the same run with the wire in fp32 at 1e-5 / 1e-4: with the
bf16 wire the 4-layer stack's gradients lie up to 0.147 of a leaf's
largest magnitude from world 1's at EP alone (``--mesh 1,2``) as under
the pipeline, too loose a gate to see a pipeline fault.  int8 hand-offs
against the JAX executor's: both children record every hand-off before
quantisation (``hand_off_codes``).  Where both runs' inputs agree to fp32
noise, an int8 code differs only by one step, where the value sat no
further from the rounding tie, in both runs, than that measured noise can
move it (``test_int8_codes_differ_only_at_rounding_ties``).
One such code moves an element by one int8 step, 1/127 of its block's
largest magnitude, and with it the rest of that microbatch's chain.  So
the step is held at ``GRAD_ATOL`` everywhere but in the embedding rows of
the tokens of the microbatches that carried a differing code, which keep
``close_wire``'s max-error bound.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import pipeline as jpipe
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.core import compression, pipeline
from repro_torch.core import schedules as S
from repro_torch.launch import ranks
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models.model import LanguageModel
from repro_torch.obs import validate_chrome_trace
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

from _torch_pipeline_child import (FLAT, FORWARD_PLANS, INT8_SIZES, MESH_EP, STAGED, arch_of,
                                   int8_inputs)
from test_torch_ep import close_wire

CHILD = Path(__file__).with_name("_torch_pipeline_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4
TRACES = ("pipeline_occupancy", "pipeline_wstash_occupancy", "pipeline_comm_inflight")
SCHEDULES = [("pp4", n, 4, 1) for n in FLAT] + [("pp2", "interleaved_1f1b", 2, 2)]
IDS = [s[1] for s in SCHEDULES]
LAUNCH = ["--reduced", "--device", "cpu", "--mesh", "2,1,2", "--pipeline", "--schedule",
          "zb_h1", "--steps", "2", "--batch", "8", "--seq", "32"]


def _run(args, env=None):
    proc = subprocess.run([sys.executable, str(CHILD)] + args, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})
    assert proc.returncode == 0, proc.stdout[-4000:] + "\n" + proc.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_children(tmp_path_factory.mktemp("pipeline"))


def _run_children(d):
    """The launcher beside the JAX child then the port child, in ``d``:
    (reference results, port results, launcher stdout, d)."""
    # The launcher runs beside the children (it needs none of their output).
    launch = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train"] + LAUNCH + ["--metrics-out",
                                                           str(d / "m.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=d,
        env={**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"})
    try:
        ref_path = str(d / "ref.npz")
        _run(["jax", ref_path], {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                                 "JAX_PLATFORMS": "cpu"})
        _run(["port", ref_path, str(d)])
        out, err = launch.communicate(timeout=600)
    finally:
        launch.kill()
    assert launch.returncode == 0, out[-3000:] + err[-3000:]
    res = {}
    for phase in ("pp4", "pp2", "pp8"):
        res.update(np.load(d / f"{phase}.npz"))
    return dict(np.load(ref_path)), res, out, d


def grads_of(res, tag):
    pre = f"{tag}/grad/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def grad_close(want, got, atol, emb_rel_tol):
    """The reference child's ``grad_close``: element-wise on every leaf but
    the embedding, which is compared in relative norm."""
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        if k == "embed":
            rel = np.linalg.norm(got[k] - w) / (np.linalg.norm(w) + 1e-9)
            assert rel < emb_rel_tol, (k, rel)
        else:
            assert np.abs(got[k] - w).max() < atol, (k, np.abs(got[k] - w).max())


# ---------------------------------------------------------------------------
# Executor against executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase,name,PP,V", SCHEDULES, ids=IDS)
def test_loss_and_grads_match_the_jax_executor(runs, phase, name, PP, V):
    ref, res, _, _ = runs
    tag = f"{phase}/{name}"
    assert abs(float(res[f"{tag}/loss"]) - float(ref[f"{tag}/loss"])) < LOSS_ATOL
    got, want = grads_of(res, tag), grads_of(ref, tag)
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("phase,name,PP,V", SCHEDULES, ids=IDS)
def test_executed_traces_equal_the_ir_and_the_jax_executor(runs, phase, name, PP, V):
    ref, res, _, _ = runs
    tag = f"{phase}/{name}"
    sched = S.build(name, PP, 2 * PP, V)
    for k, want in zip(TRACES, (sched.occupancy_trace(), sched.wstash_trace(),
                                sched.comm_trace())):
        assert np.array_equal(res[f"{tag}/{k}"], want), k
        assert np.array_equal(res[f"{tag}/{k}"], ref[f"{tag}/{k}"]), k


@pytest.mark.parametrize("phase,name,PP,V", SCHEDULES, ids=IDS)
def test_executed_peaks_equal_the_closed_forms(runs, phase, name, PP, V):
    """1F1B, its overlap variant and zb_h1 peak at Eq 4, GPipe at M, the
    interleaved schedule at its Eq-4 analogue; zb_h1's W-stash at min(PP, M)."""
    _, res, _, _ = runs
    peaks = list(res[f"{phase}/{name}/pipeline_occupancy"].max(axis=1))
    M = 2 * PP
    want = {"gpipe": [M] * PP,
            "interleaved_1f1b": S.peak_activations_interleaved(PP, M, V)}.get(
        name, S.peak_activations_1f1b(PP))
    assert peaks == want
    if name == "zb_h1":
        assert int(res[f"{phase}/{name}/pipeline_wstash_occupancy"].max()) == \
            S.peak_wstash_zb_h1(PP, M)


# ---------------------------------------------------------------------------
# The reference child's own gates, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase,name,PP,V", SCHEDULES, ids=IDS)
def test_schedule_executor_matches_the_autograd_oracle(runs, phase, name, PP, V):
    """Autograd through the differentiable pipelined forward (GPipe order)
    against the schedule-executing step: same forward, same layout."""
    _, res, _, _ = runs
    tag, oracle = f"{phase}/{name}", f"oracle{PP}"
    assert abs(float(res[f"{tag}/loss"]) - float(res[f"{oracle}/loss"])) < 1e-5
    grad_close(grads_of(res, oracle), grads_of(res, tag), atol=1e-5, emb_rel_tol=1e-3)


@pytest.mark.parametrize("phase,name,PP,V", SCHEDULES, ids=IDS)
def test_pipelined_step_matches_the_sequential_stack(runs, phase, name, PP, V):
    _, res, _, _ = runs
    tag = f"{phase}/{name}"
    assert abs(float(res[f"{tag}/loss"]) - float(res["world1/loss"])) < 1e-3
    grad_close(grads_of(res, "world1"), grads_of(res, tag), atol=3e-3, emb_rel_tol=0.15)


@pytest.mark.parametrize("name", ["zb_h1", "1f1b_overlap"])
def test_split_and_comm_lane_schedules_match_fused_1f1b(runs, name):
    """B = Bi + Bw, and the comm lane moves only where a payload parks:
    the same arithmetic as 1f1b in the same order."""
    _, res, _, _ = runs
    assert abs(float(res[f"pp4/{name}/loss"]) - float(res["pp4/1f1b/loss"])) < 1e-6
    grad_close(grads_of(res, "pp4/1f1b"), grads_of(res, f"pp4/{name}"), atol=1e-6,
               emb_rel_tol=1e-5)


def test_vstage_forward_matches_flat_and_has_the_smaller_fill_bubble(runs):
    _, res, _, _ = runs
    assert abs(float(res["forward2v/loss"]) - float(res["forward2/loss"])) < 1e-6
    PP, M, V = 2, 4, 2
    ft = S.forward_tick_tables_v(PP, M, V)
    assert ft.Tf == V * M + PP - 1
    assert (PP - 1) / ft.Tf < pipeline.bubble_fraction(PP, M)


def test_bubble_fraction_is_the_reference():
    for PP in range(1, 9):
        for M in range(1, 17):
            assert pipeline.bubble_fraction(PP, M) == jpipe.bubble_fraction(PP, M)


# ---------------------------------------------------------------------------
# PP x EP, int8 hand-offs, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESH_EP))
def test_pp_x_ep_matches_the_jax_executor(runs, mesh):
    ref, res, _, _ = runs
    tag = f"ep/{mesh}"
    assert abs(float(res[f"{tag}/loss"]) - float(ref[f"{tag}/loss"])) < LOSS_ATOL
    got, want = grads_of(res, tag), grads_of(ref, tag)
    assert sorted(got) == sorted(want)
    for k in want:
        close_wire(got[k], want[k], GRAD_ATOL)


@pytest.mark.parametrize("mesh", list(MESH_EP))
def test_pp_x_ep_matches_world_1_with_the_wire_in_fp32(runs, mesh):
    _, res, _, _ = runs
    tag, w1 = f"ep32/{mesh}", f"ep1/{mesh}"
    assert abs(float(res[f"{tag}/loss"]) - float(res[f"{w1}/loss"])) < LOSS_ATOL
    got, want = grads_of(res, tag), grads_of(res, w1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("i", range(len(INT8_SIZES)))
def test_int8_helpers_equal_the_reference_bitwise(runs, i):
    ref = runs[0]
    x, r = int8_inputs()[i]
    q, sc = compression.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), ref[f"int8/{i}/q"])
    assert np.array_equal(sc.numpy(), ref[f"int8/{i}/scale"])
    deq = compression.dequantize_int8(q, sc, dtype=torch.float32)
    assert np.array_equal(deq.numpy(), ref[f"int8/{i}/deq"])
    for k, v in zip(("q", "scale", "residual"),
                    compression.ef_compress(torch.from_numpy(x), torch.from_numpy(r))):
        assert np.array_equal(v.numpy(), ref[f"int8/{i}/ef_{k}"]), k
    assert np.array_equal(np.asarray(jcomp.quantize_int8(x)[0]), ref[f"int8/{i}/q"])


# The order in which a microbatch's hand-offs depend on one another at PP 4,
# V = 1: the forward's, then the backward's from the last stage down.
CHAIN = [("fwd", 0), ("fwd", 1), ("fwd", 2), ("bwd", 3), ("bwd", 2), ("bwd", 1)]
INPUT_GAP = 1e-5  # the largest relative gap of fp32 noise between two inputs


def hand_off_codes(ref, res):
    """{(direction, stage, mb): (relative input gap, [(port's distance from
    the tie, reference's, the bound, code step) of a differing code])}: each
    of the port's recorded hand-offs beside the reference's record nearest
    to it (the reference records a stage's every tick, idle ones too), both
    quantised by the port's ``quantize_int8`` (bitwise the reference's).
    A distance is in code units, |v| / scale from the nearest half-integer.
    The bound is how far the measured gap g = max |x - y| can move a value
    in code units: |x / s_x - y / s_y| <= 2 g / max(s_x, s_y), since the
    block scales are absmax / 127 and so differ by at most g / 127.  A code
    that differs by one step has its tie between the two values, so each
    lies no further from it than that."""
    out = {}
    for direction, stage in CHAIN:
        key = f"handoff/port/{direction}/{stage}"
        theirs = ref[f"handoff/jax/{direction}/{stage}"]
        theirs = theirs.reshape(len(theirs), -1)
        for x, mb in zip(res[key], res[key + "/mb"]):
            x = x.reshape(-1)
            y = theirs[np.abs(theirs - x).max(axis=1).argmin()]
            codes, units, scales = [], [], []
            for v in (x, y):
                q, sc = compression.quantize_int8(torch.from_numpy(v))
                codes.append(q.numpy().astype(np.int32))
                scales.append(np.repeat(sc.numpy(), compression.BLOCK)[:v.size])
                units.append(np.abs(v / scales[-1]))
            gap = float(np.abs(x - y).max())
            ties = [tuple(float(abs(u[i] - np.floor(u[i]) - 0.5)) for u in units)
                    + (2.0 * gap / float(max(scales[0][i], scales[1][i])),
                       int(abs(codes[0][i] - codes[1][i])))
                    for i in np.flatnonzero(codes[0] != codes[1])]
            out[direction, stage, int(mb)] = (gap / float(np.abs(y).max()), ties)
    return out


def test_int8_codes_differ_only_at_rounding_ties(runs):
    """Where no earlier hand-off of a microbatch's chain carried a differing
    code, the port's and the reference's inputs agree to fp32 noise
    (``INPUT_GAP``), and every code that differs does so by one step, its
    value in both runs no further from the tie than the measured gap can
    move it (``hand_off_codes``): fp32 noise that both packages make, not a
    different value."""
    ref, res, _, _ = runs
    codes = hand_off_codes(ref, res)
    assert len(codes) == len(CHAIN) * 8
    tainted = set()
    for direction, stage in CHAIN:
        for mb in range(8):
            gap, ties = codes[direction, stage, mb]
            if mb in tainted:
                continue
            assert gap < INPUT_GAP, (direction, stage, mb, gap)
            assert all(step == 1 and max(port, theirs) <= bound
                       for port, theirs, bound, step in ties), (direction, stage, mb, ties)
            if ties:
                tainted.add(mb)


def test_compressed_hand_offs_match_the_jax_executor(runs):
    """1f1b with compress_p2p at PP 4: the step against the JAX executor's
    (module docstring: ``GRAD_ATOL`` but in the embedding rows of the
    microbatches whose hand-offs carried a differing int8 code, which keep
    ``close_wire``'s max-error bound), its wire bytes a quarter of fp32's
    plus the scales, and the forward's loss within 0.1 of the
    uncompressed."""
    ref, res, _, _ = runs
    tag = "pp4/compress"
    assert abs(float(res[f"{tag}/loss"]) - float(ref[f"{tag}/loss"])) < LOSS_ATOL
    got, want = grads_of(res, tag), grads_of(ref, tag)
    # The recorded reference run (its fully manual composition) is the
    # compared one but for fp32 noise, so its records stand for this run's.
    rec = grads_of(ref, "pp4/compress_rec")
    for k in want:
        np.testing.assert_allclose(rec[k], want[k], rtol=0, atol=1e-8, err_msg=k)
    flipped = sorted({mb for (_, _, mb), (_, ties) in hand_off_codes(ref, res).items()
                      if ties})
    rows = np.zeros(want["embed"].shape[0], bool)
    rows[ref["toks"].reshape(8, -1)[flipped].reshape(-1)] = True  # mb m: rows m * b / 8 on
    for k in want:
        near = rows if k == "embed" else np.zeros(want[k].shape[:1], bool)
        np.testing.assert_allclose(got[k][~near], want[k][~near], rtol=0, atol=GRAD_ATOL,
                                   err_msg=k)
        bound = GRAD_ATOL + 2.0 ** -7 * float(np.abs(want[k]).max())
        assert np.abs(got[k][near] - want[k][near]).max(initial=0.0) <= bound, k
    sent = int(res[f"{tag}/sent"])
    assert sent == int(res["pp4/1f1b/sent"]) > 0
    n = int(res["pp4/1f1b/sent_bytes"]) // (4 * sent)  # fp32 values a hand-off
    assert int(res[f"{tag}/sent_bytes"]) == sent * (n + 4 * -(-n // compression.BLOCK))
    assert abs(float(res["forward4c/loss"]) - float(res["forward4/loss"])) < 0.1


def test_shard_then_gather_is_identity(runs):
    assert bool(runs[1]["roundtrip_ok"])


@pytest.mark.parametrize("tag", ["pp4", "pp2"])
def test_chunk_layout_equals_stage_block_params(runs, tag):
    """Each stage's (V * rpc, ...) chunks, stacked over the stages, are the
    reference's (PP, V, rpc, ...) chunk-major layout."""
    ref, res, _, _ = runs
    for path in STAGED:
        want = ref[f"staged/{tag}/{path}"]
        assert np.array_equal(res[f"staged/{tag}/{path}"].reshape(want.shape), want), path


# ---------------------------------------------------------------------------
# Trainer and launcher
# ---------------------------------------------------------------------------


def test_train_step_at_pp_2_matches_world_1_and_learns(runs):
    """Two AdamW steps (bf16 compute) at mesh (2, 1, 2): the loss within
    5e-3 of world 1's and decreasing (the child's train_step_loss_*); one
    blocking host fetch a step, the loads riding in it, gathered to the
    reference's (reps, n_moe_positions, E) over the pp group."""
    _, res, _, _ = runs
    got, want = res["train/losses"], res["train1/losses"]
    assert abs(got[0] - want[0]) < 5e-3
    assert got[1] < got[0]
    assert int(res["train/fetches"]) == int(res["train1/fetches"]) == 2
    loads = res["train/loads"]
    assert loads.shape == res["train1/loads"].shape == (4, 1, 8)
    assert np.all(loads.sum(axis=-1) == 8 * 32 * 2)  # every layer routes b * s * top-k


def test_launcher_runs_the_pipeline_and_writes_two_stage_lanes(runs):
    _, _, out, d = runs
    assert "[mesh] devices=4 ep=2 tp=1 pp=2 dp_axes=('data',)" in out
    assert "schedule=zb_h1" in out
    assert "[trainer] pipelined: PP=2 schedule=zb_h1 (M=4)" in out
    done = [l for l in out.splitlines() if l.startswith("[done]")]
    assert len(done) == 1 and "skipped=0" in done[0]
    assert np.isfinite(float(done[0].split("loss=")[1].split()[0]))
    trace = json.loads((d / "m.jsonl.trace.json").read_text())
    validate_chrome_trace(trace)
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name" and e["pid"] == 2}
    assert lanes == {"stage 0", "stage 1"}
    assert "(2 stage lanes, zb_h1)" in out
    names = [json.loads(line)["name"] for line in (d / "m.jsonl").read_text().splitlines()]
    assert names.count("pipeline.build_schedule") == names.count("pipeline.schedule") == 2


def _args(argv):
    return train_launch.parse_args(["--reduced", "--device", "cpu"] + argv)


def test_a_pod_axis_without_pipeline_joins_data():
    arch = get_arch("granite-moe-3b-a800m").reduced()
    assert ranks.check(_args(["--mesh", "2,1,4"]), 8, cards=0) == "gloo"
    assert ranks.mesh_of(_args(["--mesh", "2,1,4"]), 8) == (2, 1, 4)
    assert ranks.check(_args(["--mesh", "2,1,4", "--pipeline"]), 8, cards=0) == "gloo"


def _pp_plan(ep=1, rank=0):
    return sharding.MeshPlan(dp=1, ep=ep, pp=2, rank=rank)


@pytest.mark.parametrize("case", ["ckpt", "migrate", "pod", "serve"])
def test_refusals(case, monkeypatch, tmp_path):
    """``--pipeline`` needs a pod axis of at least 2.  What this test once
    refused is taken now: checkpointing at PP > 1, migration at PP x EP and
    a serving pod axis (``tests/test_torch_mesh.py`` runs each)."""
    arch = get_arch("granite-moe-3b-a800m").reduced()
    opt = OptimizerConfig(lr=1e-3)
    if case == "ckpt":
        tr = Trainer(LanguageModel(arch, _pp_plan()), opt,
                     TrainerConfig(total_steps=4, checkpoint_dir=str(tmp_path)))
        assert tr.ckpt is not None and tr.ckpt.directory == tmp_path
    elif case == "migrate":
        for every in (2, 50):
            tr = Trainer(LanguageModel(arch, _pp_plan(ep=2)), opt,
                         TrainerConfig(total_steps=4, migrate_every=every))
            assert tr.load_stats is not None and tr.cfg.migrate_every == every
    elif case == "pod":
        for mesh in ("1,4", "1,1,4"):
            with pytest.raises(SystemExit, match="pod axis"):
                ranks.check(_args(["--mesh", mesh, "--pipeline"]), 4, cards=0)
    else:
        monkeypatch.setenv("WORLD_SIZE", "4")
        with pytest.raises(ValueError, match="mesh 2,1,2 needs 4 ranks, have no process"):
            serve_launch.main(["--reduced", "--device", "cpu", "--mesh", "2,1,2"])


def test_mesh_plan_row_major_layout():
    """rank = ((p * D + d) * ep + e) * tp + t: every rank's coordinates, its
    stage, its place in the stage and its pp peers."""
    P, D, ep = 2, 2, 2
    for rank in range(P * D * ep):
        plan = sharding.MeshPlan(dp=D, ep=ep, pp=P, rank=rank)
        p, rest = divmod(rank, D * ep)
        d, e = divmod(rest, ep)
        assert (plan.pp_rank, plan.coords, plan.stage_rank) == (p, (d, e, 0), rest)
        assert [plan.stage_peer(q) for q in range(P)] == [q * D * ep + rest for q in range(P)]
    with pytest.raises(ValueError, match="vstages=2 needs schedule='interleaved_1f1b'"):
        sharding.MeshPlan(dp=1, ep=1, pp=2, vstages=2)
    with pytest.raises(ValueError, match="unknown schedule"):
        sharding.MeshPlan(dp=1, ep=1, pp=2, schedule="nope")


def test_a_schedule_override_keeps_the_stage_chunks_depth():
    plan = sharding.MeshPlan(dp=1, ep=1, pp=2, schedule="interleaved_1f1b", vstages=2)
    assert pipeline.resolve_schedule(plan) == ("interleaved_1f1b", 2)
    with pytest.raises(ValueError, match="V=2"):
        pipeline.resolve_schedule(plan, "1f1b")
    flat = sharding.MeshPlan(dp=1, ep=1, pp=2)
    for name in FLAT:
        assert pipeline.resolve_schedule(flat, name) == (name, 1)


def test_arch_of_is_the_reference_childs():
    a = arch_of(get_arch)
    assert (a.num_layers, a.moe.capacity_factor, a.moe.aux_loss_coef) == (4, 8.0, 0.0)


# ---------------------------------------------------------------------------
# LanguageModel.forward under a pipeline plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(FORWARD_PLANS))
def test_pipelined_forward_matches_world1_and_reference(runs, tag):
    """``forward`` at PP 2 (flat, and interleaved at V 2; ep = 1, so no
    wire): the logits on every rank of the pp group within 1e-5 of the
    world-1 forward of its rows, rank 0's within 1e-5 of the reference's
    pipelined forward on fake host devices, and the expert loads equal to
    both."""
    ref, res, _, _ = runs
    assert float(res[f"{tag}/gap_world1"]) <= LOSS_ATOL
    np.testing.assert_allclose(res[f"{tag}/logits"], ref[f"{tag}/logits"], rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_array_equal(res[f"{tag}/loads"], ref[f"{tag}/loads"])
    np.testing.assert_array_equal(res[f"{tag}/loads"], res[f"{tag}/world1_loads"])
    assert float(res[f"{tag}/moe_aux_loss"]) == 0.0  # the child's arch: aux coefficient 0
    assert np.isfinite(res[f"{tag}/moe_z_loss"])


@pytest.mark.parametrize("mesh", list(MESH_EP))
def test_pipelined_forward_under_pp_x_ep_matches_world1(runs, mesh):
    """``forward`` at PP 2 x EP 2 (and x data 2 at (2, 2, 2)), the
    all-to-all's payload in fp32: every rank's logits within 1e-5 of the
    world-1 forward of its rows at its sequence slice; the expert loads
    (world 1's summed over the data ranks) equal world 1's."""
    _, res, _, _ = runs
    tag = f"fwd32/{mesh}"
    assert float(res[f"{tag}/gap_world1"]) <= LOSS_ATOL
    np.testing.assert_array_equal(res[f"{tag}/loads"], res[f"{tag}/world1_loads"])


def test_frontend_embeds_under_the_pipeline_match_the_jax_executor(runs):
    """Reduced qwen2-vl (M-RoPE) fed precomputed ``embeds`` at (2, 1, 1),
    1f1b: the embeds split into microbatches outside the executor, the
    wire in their dtype.  The loss and every gradient against the
    reference's pipelined ``loss_and_grads`` (the child's gates), the
    ``embed`` gradient exactly 0 on both sides (no lookup, untied head),
    the loss against world 1; the pipelined forward's logits against the
    reference's pipelined ``forward`` and against world 1 at 1e-5."""
    ref, res, _, _ = runs
    assert abs(float(res["qwen/loss"]) - float(ref["qwen/loss"])) < LOSS_ATOL
    assert abs(float(res["qwen/loss"]) - float(res["qwen1/loss"])) < LOSS_ATOL
    got, want = grads_of(res, "qwen"), grads_of(ref, "qwen")
    assert sorted(got) == sorted(want) and len(got) == 12
    assert not got["embed"].any() and not want["embed"].any()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
    grad_close(grads_of(res, "qwen1"), got, GRAD_ATOL, 0.05)
    assert float(res["qwen/gap_world1"]) <= LOSS_ATOL
    np.testing.assert_allclose(res["qwen/logits"], ref["qwen/logits"], rtol=0,
                               atol=LOSS_ATOL)


if __name__ == "__main__":
    # The int8 witness's numbers: each hand-off with a differing code, and
    # where the compressed step's embedding gradient leaves GRAD_ATOL.
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ref, res, _, _ = _run_children(Path(tmp))
    for (direction, stage, mb), (gap, ties) in hand_off_codes(ref, res).items():
        if ties:
            print(f"{direction} stage {stage} mb {mb}: input gap {gap:.3e} of its largest "
                  f"magnitude, {len(ties)} differing codes, (port's, reference's distance "
                  f"from the tie, the gap's bound, in code units; code step) of the "
                  f"first: {ties[0]}")
    flipped = sorted({mb for (_, _, mb), (_, t) in hand_off_codes(ref, res).items() if t})
    near = np.zeros(512, bool)
    near[ref["toks"].reshape(8, -1)[flipped].reshape(-1)] = True
    want, got = ref["pp4/compress/grad/embed"], res["pp4/compress/grad/embed"]
    err = np.abs(got.astype(np.float64) - want)
    print(f"embed: {(err > GRAD_ATOL).mean():.4f} of its elements past {GRAD_ATOL}, in "
          f"{len(np.unique(np.argwhere(err > GRAD_ATOL)[:, 0]))} rows; microbatches with a "
          f"differing code {flipped}, whose {int(near.sum())} token rows hold a largest gap "
          f"of {err[near].max():.3e}, the other rows {err[~near].max():.3e}")
