"""The plan's memory policy in the port, against the JAX package: remat of
the layer stack (none, dots, full), bf16 Adam moments, and the ZeRO-3
split of the expert d_ff over (data, tp).

World 1 runs here, the reference in this process: the loss and every
gradient under each remat, and a 3-step train trajectory with bf16 moments.
``_torch_memory_child.py`` runs the rest: the reference on 8 fake host
devices, the port's d_ff split on 4 gloo ranks, and the pipeline executors
on 2.

Tolerances.  Remat recomputes the same ops on the same inputs: the port's
three modes bitwise, in one process and under each pipeline executor;
each against the reference at the same remat at the model-parity bound
1e-5 (``test_torch_training.MODEL_TOL``).  The bf16-moment trajectory: the
loss and grad norm per step within 1e-5 relative and the params within
1e-4 absolute (at most 0.1 % of them past 1e-6), ``test_torch_training``'s
trajectory gates; the bf16 moments at the params' rule, at most 0.1 %
of elements past 1e-6, and all within a bf16 ulp a step (3 x 2^-7
relative, atol 1e-6): each side rounds to bf16 an fp32 moment that may
differ in its last bits, and a value next to a rounding boundary then
rounds one ulp apart (measured: 7 of 32,768 elements of a leaf).  The split at D * tp = 2: loss and gathered gradients bitwise
the whole-slot control's (a sum of two terms does not depend on their
order); against the reference's plan at the EP tests' gates
(``test_torch_ep.grad_gate_failures``); one AdamW step within 2 lr of the
control's (its grad norm adds a slot's squares in two parts).  Held bytes,
checkpoints and migrations: exact.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import training as jtraining
from repro.configs import get_arch as jget_arch
from repro.launch import dryrun as jdryrun
from repro.models.model import LanguageModel as JLM
from repro.optim import optimizer as jopt
from repro.sharding import single_device_plan as jsingle_device_plan
from repro_torch import sharding, training
from repro_torch.configs import get_arch
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import planner
from repro_torch.core.platform import H100
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as train_launch
from repro_torch.models.model import LanguageModel, init_params, tree_paths
from repro_torch.optim import optimizer as topt

from _torch_memory_child import GRIDS, MODES, PP_SCHEDULES, REMATS
from test_torch_ep import grad_gate_failures

NAME = "granite-moe-3b-a800m"
CHILD = Path(__file__).with_name("_torch_memory_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7  # a bf16 ulp is at most this part of the value


def _with_dispatch(arch, dispatch):
    return arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))


def _batch(vocab, step=0):
    return tdata.SyntheticTokens(vocab, 2, 32).batch_at(step)


@lru_cache(maxsize=None)
def _reference(dispatch: str, remat: str, optimizer_dtype: str = "float32"):
    """(JAX lm with fp32 compute at ``remat``, its init state as numpy)."""
    arch = _with_dispatch(jget_arch(NAME).reduced(), dispatch)
    plan = dataclasses.replace(jsingle_device_plan(arch), compute_dtype="float32",
                               remat=remat, optimizer_dtype=optimizer_dtype)
    lm = JLM(arch, plan)
    with plan.mesh:
        state = jtraining.init_state(lm, jax.random.PRNGKey(0), jopt.OptimizerConfig())
    return lm, jax.tree.map(np.asarray, state)


@lru_cache(maxsize=None)
def _port(dispatch: str, remat: str):
    """The port's (loss, {path: gradient}) at world 1 under ``remat``, fp32
    compute, on the reference's weights."""
    _, state_np = _reference(dispatch, "full")
    arch = _with_dispatch(get_arch(NAME).reduced(), dispatch)
    lm = LanguageModel(arch, sharding.single_device_plan(arch, remat=remat))
    params = state_from_numpy(state_np, "cpu")["params"]
    loss, _, grads = training.loss_and_grads(lm, params, _batch(arch.vocab_size),
                                             torch.float32)
    return loss, {k: g for k, g in tree_paths(grads).items() if g is not None}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("dispatch", MODES)
def test_remat_is_bitwise_and_matches_reference(dispatch, remat):
    """Each remat gives the loss and gradients of "none" bit for bit, and
    the reference's at the same remat within 1e-5."""
    loss, grads = _port(dispatch, remat)
    loss0, grads0 = _port(dispatch, "none")
    assert torch.equal(loss, loss0)
    assert set(grads) == set(grads0)
    for k, g in grads.items():
        assert torch.equal(g, grads0[k]), k
    lm_j, state_np = _reference(dispatch, remat)
    batch = _batch(lm_j.arch.vocab_size)
    with lm_j.plan.mesh:
        (jl, _), jg = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))(
            jax.tree.map(jnp.asarray, state_np["params"]), jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **MODEL_TOL)
    jflat = tree_paths(jg)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[k]), err_msg=k, **MODEL_TOL)


def test_remat_recompute_spans_are_named_apart():
    """A recompute's ``a2a.layer`` spans are ``a2a.layer.recompute``: the
    forward's are counted once whatever the remat."""
    from repro_torch.models import transformer

    seen = []

    class Tel:
        def span(self, name, **attrs):
            seen.append(name)
            return contextlib.nullcontext()

    arch = get_arch(NAME).reduced()
    params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    lm = LanguageModel(arch, sharding.single_device_plan(arch))
    x = lm._embed(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    x.requires_grad_(True)

    def probe(blocks, h, aux, z, arch, *, telemetry, **kw):
        telemetry.span("a2a.layer")
        return h * h, aux, z, None  # saves h: the backward recomputes

    orig = transformer._rep
    transformer._rep = probe
    try:
        y, _, _ = transformer.stack_forward(params["blocks"], x, arch, positions=None,
                                            train=True, plan=lm.plan, telemetry=Tel())
        y.sum().backward()
    finally:
        transformer._rep = orig
    reps = arch.num_layers // len(arch.block_pattern)
    assert seen.count("a2a.layer") == reps
    assert seen.count("a2a.layer.recompute") == reps


@pytest.mark.parametrize("dispatch", MODES)
def test_bf16_moments_trajectory_matches_reference(dispatch):
    """3 steps with bf16 Adam moments from the reference's bf16 init state,
    against its train step (module docstring for the tolerances)."""
    lm_j, state_np = _reference(dispatch, "full", "bfloat16")
    assert {a.dtype.name for a in tree_paths(state_np["m"]).values()
            if a.dtype.kind != "i"} == {"bfloat16"}
    arch = _with_dispatch(get_arch(NAME).reduced(), dispatch)
    lm_t = LanguageModel(arch, sharding.single_device_plan(arch, optimizer_dtype="bfloat16"))
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    step_j = jax.jit(jtraining.make_train_step(lm_j, jopt.OptimizerConfig(**opt_kw)))
    step_t = training.make_train_step(lm_t, topt.OptimizerConfig(**opt_kw),
                                      compute_dtype=torch.float32)
    state_t = state_from_numpy(state_np, "cpu")
    assert state_t["m"]["embed"].dtype == state_t["v"]["embed"].dtype == torch.bfloat16
    with lm_j.plan.mesh:
        state_j = jax.tree.map(jnp.asarray, state_np)
        for step in range(3):
            batch = _batch(arch.vocab_size, step)
            state_j, mj = step_j(state_j, jax.tree.map(jnp.asarray, batch))
            state_t, mt = step_t(state_t, batch)
            assert mt["skipped"] == int(mj["skipped"]) == 0
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(np.asarray(mt[k]), np.asarray(mj[k]), rtol=1e-5,
                                           err_msg=f"step {step} {k}")
    assert state_t["m"]["embed"].dtype == torch.bfloat16
    got, want = state_to_numpy(state_t), jax.tree.map(np.asarray, state_j)
    for part in ("m", "v"):
        want_p = tree_paths(want[part])
        n = off = 0
        for path, a in tree_paths(got[part]).items():
            w = want_p[path].astype(np.float32)
            np.testing.assert_allclose(a, w, rtol=3 * BF16_ULP, atol=1e-6,
                                       err_msg=f"{part}/{path}")
            n += a.size
            off += int((np.abs(a - w) > 1e-6).sum())
        assert off <= 1e-3 * n, (part, off, n)
    want_p = tree_paths(want["params"])
    n = off = 0
    for path, a in tree_paths(got["params"]).items():
        np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-4, err_msg=path)
        n += a.size
        off += int((np.abs(a.astype(np.float64) - want_p[path]) > 1e-6).sum())
    assert off <= 1e-3 * n, (off, n)


# bf16 against fp32 moments, 5 steps at the launcher's optimizer settings:
# the loss within this relative gap (chip_smoke.py phase "memory" (c) holds
# the full-width runs to it too).  Measured here: 9.3e-06 at step 5.
MOMENT_PAIR_REL = 1e-4


def test_bf16_moments_follow_the_fp32_trajectory():
    """The same 5 steps with bf16 and with fp32 moments: each moment takes
    2 B a float parameter, and the losses stay within ``MOMENT_PAIR_REL``;
    the gap grows with the steps as the warmup raises lr."""
    arch = get_arch(NAME).reduced()
    data = tdata.SyntheticTokens(arch.vocab_size, 2, 32)
    losses = {}
    for odt in ("float32", "bfloat16"):
        lm = LanguageModel(arch, sharding.single_device_plan(arch, optimizer_dtype=odt))
        state = training.init_state(lm, torch.Generator().manual_seed(0), "cpu")
        floats = [p for p in tree_paths(state["params"]).values() if p.is_floating_point()]
        for m in ("m", "v"):
            nbytes = sum(t.numel() * t.element_size() for t in tree_paths(state[m]).values()
                         if t.is_floating_point())
            assert nbytes == (2 if odt == "bfloat16" else 4) * sum(p.numel() for p in floats)
        step = training.make_train_step(lm, topt.OptimizerConfig(total_steps=5))
        losses[odt] = [float(step(state, data.batch_at(i))[1]["loss"]) for i in range(5)]
    assert losses["bfloat16"][0] == losses["float32"][0]
    gaps = [abs(a - b) / abs(a) for a, b in zip(losses["float32"], losses["bfloat16"])]
    assert max(gaps) <= MOMENT_PAIR_REL, gaps


class _Allocations(TorchDispatchMode):
    """The largest fresh fp32 tensor an op returns (views and in-place
    results, which alias an input, are not fresh)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else [out]
        for r, t in zip(rets, outs):
            if (isinstance(t, torch.Tensor) and r.alias_info is None
                    and t.dtype == torch.float32):
                self.largest = max(self.largest, t.numel())
        return out


def _update_inputs():
    arch = get_arch(NAME).reduced()
    gen = torch.Generator().manual_seed(0)
    params = init_params(arch, gen, "cpu")
    state = {"params": params, **topt.adamw_init(params, "bfloat16")}
    for t in ("m", "v"):
        for p in tree_paths(state[t]).values():
            if p.is_floating_point():
                p.copy_(torch.rand(p.shape, generator=gen).to(p.dtype) * (1e-3 if t == "m"
                                                                            else 1e-6))
    grads = {k: torch.randn(p.shape, generator=gen) * 1e-2 if p.is_floating_point() else None
             for k, p in tree_paths(params).items()}
    return state, grads


def _unflat_like(tree, flat):
    from repro_torch.models.model import map_tree

    return map_tree(lambda path, _: flat[path], tree, with_path=True)


def test_bf16_update_upcasts_slices_only(monkeypatch):
    """The bf16-moment update forms no fp32 tensor larger than a slice, and
    its slices give the whole leaf's result bit for bit."""
    results = []
    for size in (1 << 40, 1000):
        monkeypatch.setattr(topt, "UPDATE_SLICE", size)
        state, flat_g = _update_inputs()
        assert max(p.numel() for p in tree_paths(state["params"]).values()) > 1000
        grads = _unflat_like(state["params"], flat_g)
        mode = _Allocations()
        with mode:
            topt.adamw_update(topt.OptimizerConfig(lr=1e-3, warmup_steps=1), state["params"],
                              grads, state)
        results.append(state)
    assert mode.largest <= 1000, mode.largest
    for part in ("params", "m", "v"):
        a, b = tree_paths(results[0][part]), tree_paths(results[1][part])
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    assert results[1]["m"]["embed"].dtype == torch.bfloat16


def test_init_state_reads_the_plan():
    """``init_state`` makes the moments in the plan's optimizer_dtype,
    a one-rank plan's included; without a plan fp32."""
    arch = get_arch(NAME).reduced()
    gen = torch.Generator().manual_seed(0)
    for plan, dtype in ((None, torch.float32),
                        (sharding.single_device_plan(arch), torch.float32),
                        (sharding.single_device_plan(arch, optimizer_dtype="bfloat16"),
                         torch.bfloat16)):
        state = training.init_state(LanguageModel(arch, plan), gen, "cpu")
        assert state["m"]["embed"].dtype == state["v"]["embed"].dtype == dtype
        assert state["params"]["embed"].dtype == torch.float32
    with pytest.raises(ValueError, match="remat"):
        sharding.single_device_plan(arch, remat="some")


@pytest.mark.parametrize("chips", [1, 4, 16, 64])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mamba2-370m"])
def test_choose_memory_policy_is_the_reference_rule(name, chips):
    """The planner's copy of the reference dry run's policy, on the same
    HBM, gives the same answer; on the H100 granite keeps fp32 moments."""
    hbm = dataclasses.replace(H100, hbm_bytes=jdryrun.HBM_BYTES)
    for kind in ("train", "decode"):
        shape = type("Shape", (), {"kind": kind})()
        assert planner.choose_memory_policy(get_arch(name), kind, chips, hbm) == \
            jdryrun.choose_memory_policy(jget_arch(name), shape, chips)
    if name.startswith("granite"):
        assert planner.choose_memory_policy(get_arch(name), "train", chips, H100) == (
            "float32", "full")


def test_train_launcher_binds_the_policy(capsys):
    """``--remat`` and ``--optimizer-dtype`` override the planner's policy,
    the launcher says which, and the run trains with them."""
    summary = train_launch.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch",
                                 "2", "--seq", "16", "--remat", "dots",
                                 "--optimizer-dtype", "bfloat16"])
    out = capsys.readouterr().out
    assert ("[trainer] memory policy: remat=dots optimizer_dtype=bfloat16 "
            "(--remat, --optimizer-dtype)") in out
    assert summary["remat"] == "dots" and summary["optimizer_dtype"] == "bfloat16"
    assert summary["skipped"] == 0 and np.isfinite(summary["loss"])
    train_launch.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch", "2",
                       "--seq", "16"])
    assert ("[trainer] memory policy: remat=full optimizer_dtype=float32 "
            "(the planner's choice)") in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Ranks (the child)
# ---------------------------------------------------------------------------


def _child(args, env=None):
    return subprocess.Popen([sys.executable, str(CHILD)] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})


def _wait(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:] + "\n" + err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("memory")
    refs = [str(d / f"ref_{grid}.npz") for grid in GRIDS]
    jax_children = [_child(["jax", path, grid], {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"})
        for path, grid in zip(refs, GRIDS)]
    pp_child = _child(["pp", str(d)])
    for child in jax_children + [pp_child]:
        _wait(child)
    _wait(_child(["port", ",".join(refs), str(d)]))
    ref = {}
    for path in refs:
        ref.update(np.load(path))
    r4 = [dict(np.load(d / f"r4_rank{r}.npz")) for r in range(4)]
    pp = [dict(np.load(d / f"pp_rank{r}.npz")) for r in range(2)]
    return ref, r4, pp


def _tree(res, prefix):
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_is_the_whole_slot_run(runs, grid, mode):
    """At D * tp = 2 the split's loss and gathered gradients are the
    whole-slot control's bit for bit, on every rank; so are those of the
    split under remat none."""
    _, r4, _ = runs
    for r in r4:
        assert list(r[f"{grid}/{mode}/ffn_split"]) == [2, 1]
        assert "experts=d_ff/2 (data x tp)" in str(r[f"{grid}/{mode}/describe"])
        for kind in ("split", "none"):
            assert np.array_equal(r[f"{grid}/{mode}/{kind}/loss"],
                                  r[f"{grid}/{mode}/whole/loss"])
            got, want = (_tree(r, f"{grid}/{mode}/{kind}/grad"),
                         _tree(r, f"{grid}/{mode}/whole/grad"))
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), (kind, k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_matches_reference_plan(runs, grid, mode):
    """The split against the reference's ZeRO-3 plan on the same grid, at
    the EP tests' gates."""
    ref, r4, _ = runs
    assert list(ref[f"{grid}/{mode}/ep_tp"]) == [2, 2 if grid == "tp" else 1]
    r0 = r4[0]
    assert abs(float(r0[f"{grid}/{mode}/split/loss"]) - float(ref[f"{grid}/{mode}/loss"])) < 2e-3
    got = _tree(r0, f"{grid}/{mode}/split/grad")
    want = _tree(ref, f"{grid}/{mode}/grad")
    assert sorted(got) == sorted(want)
    assert grad_gate_failures(got, want) == []


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_holds_half_the_expert_bytes(runs, grid):
    """Each rank's expert params, m and v take exactly 1 / (D * tp) of the
    whole-slot run's bytes, with fp32 and with bf16 moments (2 B a float
    parameter for each moment)."""
    _, r4, _ = runs
    for r in r4:
        for mode in MODES:
            for odt in ("float32", "bfloat16"):
                split = int(r[f"{grid}/{mode}/split/bytes/{odt}"])
                whole = int(r[f"{grid}/{mode}/whole/bytes/{odt}"])
                assert 2 * split == whole, (mode, odt, split, whole)
            assert (int(r[f"{grid}/{mode}/whole/bytes/bfloat16"]) * 3
                    == int(r[f"{grid}/{mode}/whole/bytes/float32"]) * 2)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_split_train_step_within_two_lr(runs, grid):
    """One AdamW step: params within 2 lr of the whole-slot control's, the
    grad norm within 1e-6 relative."""
    _, r4, _ = runs
    for mode in MODES:
        r = r4[0]
        assert int(r[f"{grid}/{mode}/split/step/skipped"]) == 0
        np.testing.assert_allclose(r[f"{grid}/{mode}/split/step/grad_norm"],
                                   r[f"{grid}/{mode}/whole/step/grad_norm"], rtol=1e-6)
        got = _tree(r, f"{grid}/{mode}/split/step/params")
        want = _tree(r, f"{grid}/{mode}/whole/step/params")
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 2e-3, k


def test_split_checkpoint_round_trips(runs):
    """A split checkpoint with bf16 moments restores at world 1 with the
    manifest's CRC32s and the state bit for bit; saved there, it restores
    split bit for bit."""
    _, r4, _ = runs
    assert str(r4[0]["ck/moment_dtype"]) == "torch.bfloat16"
    assert bool(r4[0]["ck/world1_crc_equal"])
    assert all(bool(r["ck/split_crc_equal"]) for r in r4)


def test_migration_on_slices_is_the_manual_permutation(runs):
    """A swap across the EP ranks on the d_ff slices: params, m and v
    gathered equal the manual permutation of the gathered state."""
    _, r4, _ = runs
    for r in r4:
        assert bool(r["mig/exact"]) and int(r["mig/bytes"]) > 0


def test_grid_that_does_not_divide_keeps_whole_slots(runs):
    """D * tp = 2 and d_ff 63: no split, the [mesh] line says why, and the
    step runs."""
    _, r4, _ = runs
    for r in r4:
        assert int(r["odd/ffn_split"]) == 1
        assert "experts whole (d_ff 63 % (data x tp = 2) != 0)" in str(r["odd/describe"])
        assert int(r["odd/skipped"]) == 0 and np.isfinite(r["odd/loss"])


@pytest.mark.parametrize("sched,V", PP_SCHEDULES)
def test_remat_under_pipeline_executors_is_bitwise(runs, sched, V):
    """The schedule-executing pipeline's loss and each rank's gradients are
    the same bits under remat none, dots and full."""
    _, _, pp = runs
    for r in pp:
        for remat in ("dots", "full"):
            assert np.array_equal(r[f"{sched}/{remat}/loss"], r[f"{sched}/none/loss"])
            got, want = _tree(r, f"{sched}/{remat}/grad"), _tree(r, f"{sched}/none/grad")
            assert sorted(got) == sorted(want) and want
            for k in want:
                assert np.array_equal(got[k], want[k]), (remat, k)
