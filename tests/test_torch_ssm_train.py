"""Mamba2 training in the port against the JAX package, on the CPU.

``models.ssm.ssd_chunked(..., train=True)`` runs the reference's
``impl="xla"`` intra-chunk term under autograd; its output and gradients
are held against ``jax.grad`` of the reference's ``ssd_chunked`` (which
runs the same einsums: its kernel has no VJP).  The reduced mamba2-370m
(2 layers, d_model 64, 8 heads x 16, state 16, chunk 32, vocab 512) is
then held through ``LanguageModel.loss`` and the train step, on weights
converted from the reference's ``init_params``, fp32 compute on both
sides.  ``_torch_ssm_child.py`` runs the multi-rank cases: the JAX
package's plan on 8 fake host devices and the port on gloo ranks, started
together when the module's first test runs.

Tolerances.  ``ssd_chunked``: fp32 2e-5, bf16 2e-2 (the reference's
kernel bounds, ``tests/test_kernels.py``), each relative to the largest
magnitude of the tensor compared (at least 1): both sides round the same
fp32 (or bf16) products in another order, and the port's chunk prefixes
are summed in fp64 (``models/ssm.py`` says why).  The model's loss and
every gradient: 1e-5 (the reference's model-parity bound); the three
remat modes bitwise equal to each other.  The 3-step trajectory: as
``tests/test_torch_training.py::test_three_step_trajectory_matches_reference``
(params at atol 1e-4, within 1e-6 but for 0.1 % of elements, which that
test's docstring explains).  Over ranks: the loss and gathered gradients
against the reference's plan at 1e-5 and 1e-4 (the pipeline tests'
executor gates); the sliced plan against its all-whole control bitwise at
2 ranks and within 1e-6 at 4 (the zero tests' gates).
"""

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

from repro import training as jtraining
from repro.configs import get_arch as jget_arch
from repro.models import ssm as jssm
from repro.models.model import LanguageModel as JLM
from repro.models.model import init_params as jinit_params
from repro.optim import optimizer as jopt
from repro.sharding import single_device_plan as jsingle_device_plan
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as train_launch
from repro_torch.models import ssm
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import optimizer as topt
from repro_torch.training import make_train_step

from _torch_ep_child import _paths
from _torch_ssm_child import BATCH, PP_SCHEDULES

NAME = "mamba2-370m"
SSD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4
FOUR_RANK_ATOL = 1e-6
CHILD = Path(__file__).with_name("_torch_ssm_child.py")
SRC = Path(__file__).resolve().parents[1] / "src"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    """Within ``tol`` of the largest magnitude of ``want`` (at least 1)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


# ---------------------------------------------------------------------------
# The multi-rank children, started with the module's first test
# ---------------------------------------------------------------------------


def _popen(args, env=None):
    return subprocess.Popen([sys.executable, str(CHILD)] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC), **(env or {})})


def _wait(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-4000:] + "\n" + err[-4000:]


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory):
    """The reduced mamba2's reference params and a batch, written for both
    children, which run while the module's other tests do."""
    d = tmp_path_factory.mktemp("ssm_train")
    arch = jget_arch(NAME).reduced()
    params = jinit_params(arch, jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, 512, BATCH).astype(np.int32)
    inp = {f"params/{k}": np.asarray(v) for k, v in _paths(params).items()}
    np.savez(d / "in.npz", toks=toks, **inp)
    procs = [_popen(["jax", "ssm", str(d / "in.npz"), str(d / "ref.npz")],
                    {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                     "JAX_PLATFORMS": "cpu"}),
             _popen(["port", "ssm", str(d / "in.npz"), str(d)])]
    yield d, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def runs(children):
    d, procs = children
    for p in procs:
        _wait(p)
    ref = dict(np.load(d / "ref.npz"))
    r2 = [dict(np.load(d / f"ssm2_rank{r}.npz")) for r in range(2)]
    r4 = [dict(np.load(d / f"ssm4_rank{r}.npz")) for r in range(4)]
    return ref, r2, r4


# ---------------------------------------------------------------------------
# ssd_chunked under autograd
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, l, h, p, g, n, strong=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))  # softplus
    A_log = rng.standard_normal(h) * 0.3 + (np.log(40.0) if strong else 0.0)
    B = rng.standard_normal((b, l, g, n)) * 0.5
    C = rng.standard_normal((b, l, g, n)) * 0.5
    return [np.asarray(t, np.float32) for t in (x, dt, A_log, B, C)]


SSD_CASES = {
    "one-chunk": dict(shape=(2, 32, 4, 8, 1, 8), chunk=32),
    "chunks": dict(shape=(2, 64, 4, 8, 1, 8), chunk=16),
    "initial-state": dict(shape=(2, 64, 4, 8, 1, 8), chunk=16, init=True),
    "groups2": dict(shape=(1, 32, 4, 8, 2, 8), chunk=8),
    "head-groups": dict(shape=(1, 32, 64, 8, 1, 8), chunk=16, head_group=32),
}
STRONG = dict(shape=(1, 64, 4, 8, 1, 8), chunk=32, strong=True)  # dA ~ -40 a step


def _ssd_both(case, dtype, c=None):
    """(JAX output, final state and gradients in x, dt, A_log, B, C; the
    port's; the port's evaluated in float64) for one case, through a loss
    that weighs every output."""
    c = c or SSD_CASES[case]
    b, l, h, p, g, n = c["shape"]
    x, dt, A_log, B, C = _ssd_inputs(0, *c["shape"], strong=c.get("strong", False))
    init = (np.random.default_rng(9).standard_normal((b, h, p, n)).astype(np.float32)
            if c.get("init") else None)
    hg = c.get("head_group", 32)
    cot_y = np.cos(np.arange(b * l * h * p, dtype=np.float32)).reshape(b, l, h, p)
    cot_s = np.sin(np.arange(b * h * p * n, dtype=np.float32)).reshape(b, h, p, n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x, dt, A_log, B, C):
        y, fin = jssm.ssd_chunked(x.astype(jd), dt.astype(jd), -jnp.exp(A_log), B.astype(jd),
                                  C.astype(jd), c["chunk"], head_group=hg,
                                  initial_state=None if init is None else jnp.asarray(init))
        return (y.astype(jnp.float32) * cot_y).sum() + (fin.astype(jnp.float32) * cot_s).sum(), \
            (y, fin)

    (_, (jy, jfin)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                                     has_aux=True))(
        *map(jnp.asarray, (x, dt, A_log, B, C)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (x, dt, A_log, B, C)]
    y, fin = ssm.ssd_chunked(ts[0].to(td), ts[1].to(td), -torch.exp(ts[2]), ts[3].to(td),
                             ts[4].to(td), c["chunk"], head_group=hg, train=True,
                             initial_state=None if init is None else torch.from_numpy(init))
    loss = (y.float() * torch.from_numpy(cot_y)).sum() + (fin.float() * torch.from_numpy(cot_s)).sum()
    tg = torch.autograd.grad(loss, ts)
    ts = [t.detach().double().requires_grad_(True) for t in ts]
    y64, fin64 = ssm.ssd_chunked(ts[0], ts[1], -torch.exp(ts[2]), ts[3], ts[4], c["chunk"],
                                 head_group=hg, train=True, initial_state=None if init is None
                                 else torch.from_numpy(init).double())
    loss = (y64 * torch.from_numpy(cot_y)).sum() + (fin64 * torch.from_numpy(cot_s)).sum()
    return (jy, jfin, jg), (y, fin, tg), (y64, fin64, torch.autograd.grad(loss, ts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_grads_match_reference(case, dtype):
    (jy, jfin, jg), (y, fin, tg), _ = _ssd_both(case, dtype)
    tol = SSD_TOL[dtype]
    assert y.dtype == getattr(torch, dtype)
    _close(y, jy, tol, "y")
    _close(fin, jfin, tol, "final state")
    for name, g, w in zip(("x", "dt", "A_log", "B", "C"), tg, jg):
        assert torch.isfinite(g).all(), name  # no NaN through the masked triangle
        _close(g, w, tol, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_strong_decay_gradients_are_finite(dtype):
    """dA ~ -40 a step: the decays span exp(-1000) to 1, and the masked
    upper triangle's exp(+seg) would overflow had it been taken before the
    where.  No output or gradient is NaN or inf, at fp32 and bf16.  bf16:
    all against the reference at 2e-2.  fp32: all within 2e-5 of the same
    function evaluated in float64, and all but dA_log within 2e-5 of the
    reference; there the reference's fp32 prefix sums put it 2.8e-5 from
    the float64 value (the port's fp64-summed prefixes: 2.9e-6), so the
    port must lie nearer to it than the reference does."""
    (jy, jfin, jg), (y, fin, tg), (y64, fin64, g64) = _ssd_both("strong", dtype, STRONG)
    tol = SSD_TOL[dtype]
    for name, t in zip(("y", "final", "x", "dt", "A_log", "B", "C"), (y, fin) + tg):
        assert torch.isfinite(t).all(), name
    _close(y, jy, tol, "y")
    _close(fin, jfin, tol, "final state")
    for name, g, w, e in zip(("x", "dt", "A_log", "B", "C"), tg, jg, g64):
        if dtype == "bfloat16" or name != "A_log":
            _close(g, w, tol, f"d{name}")
        else:
            gap = float((g.double() - e).abs().max())
            assert gap < float((torch.from_numpy(np.array(w)).double() - e).abs().max())
        if dtype == "float32":
            _close(g, e, tol, f"d{name} vs float64")


def test_ssd_training_path_is_taken_only_under_train(monkeypatch):
    """``train=True`` never calls the kernel's wrapper (which refuses
    grad inputs); ``train=False`` does, once a call, and the two paths give
    the same fp32 output (the kernel's plain version here)."""
    calls = []
    real = ssd_ops.ssd_intra_chunk
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x, dt, A_log, B, C = map(torch.from_numpy, _ssd_inputs(0, 2, 64, 4, 8, 1, 8))
    a = -torch.exp(A_log)
    y0, f0 = ssm.ssd_chunked(x, dt, a, B, C, 16)
    assert len(calls) == 1
    y1, f1 = ssm.ssd_chunked(x.requires_grad_(True), dt, a, B, C, 16, train=True)
    assert len(calls) == 1 and y1.requires_grad
    np.testing.assert_allclose(_np(y1), _np(y0), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(f1), _np(f0), rtol=0, atol=2e-5)


def test_head_groups_run_under_checkpoint_and_equal_one_group(monkeypatch):
    """Under ``train`` each head group runs under ``torch.utils.checkpoint``
    (as the reference's ``jax.checkpoint``); the grouped output and
    gradients equal one group of every head."""
    calls = []
    real = ssm.checkpoint
    monkeypatch.setattr(ssm, "checkpoint", lambda fn, *a, **kw: calls.append(1) or real(
        fn, *a, **kw))
    x, dt, A_log, B, C = (torch.from_numpy(t).requires_grad_(True)
                          for t in _ssd_inputs(1, 1, 32, 64, 8, 1, 8))
    outs = []
    for hg in (32, 64):
        y, fin = ssm.ssd_chunked(x, dt, -torch.exp(A_log), B, C, 16, head_group=hg,
                                 train=True)
        loss = (y * y).sum() + fin.sum()
        outs.append((y.detach(), fin.detach()) + torch.autograd.grad(loss, (x, dt, A_log, B)))
    assert len(calls) == 2  # 64 heads in two groups of 32; none at head_group 64
    for a, b in zip(*outs):
        _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# The reduced model: loss and gradients, remat, the train step
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _setup():
    """(JAX lm with fp32 compute, its init state as numpy, port arch)."""
    arch_j = jget_arch(NAME).reduced()
    plan = dataclasses.replace(jsingle_device_plan(arch_j), compute_dtype="float32")
    lm_j = JLM(arch_j, plan)
    with plan.mesh:
        state_j = jtraining.init_state(lm_j, jax.random.PRNGKey(0), jopt.OptimizerConfig())
    return lm_j, jax.tree.map(np.asarray, state_j), get_arch(NAME).reduced()


@lru_cache(maxsize=None)
def _reference_loss_and_grads():
    lm_j, state_np, arch = _setup()
    batch = tdata.SyntheticTokens(arch.vocab_size, 2, 64).batch_at(0)
    with lm_j.plan.mesh:
        (jl, jm), jg = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))(
            jax.tree.map(jnp.asarray, state_np["params"]), jax.tree.map(jnp.asarray, batch))
    return batch, np.asarray(jl), {k: np.asarray(v) for k, v in jm.items() if v is not None}, \
        {p: np.asarray(g) for p, g in tree_paths(jg).items() if g.dtype != jax.dtypes.float0}


@lru_cache(maxsize=None)
def _port_loss_and_grads(remat):
    _, state_np, arch = _setup()
    batch = _reference_loss_and_grads()[0]
    lm = LanguageModel(arch, sharding.single_device_plan(arch, remat=remat))
    params = state_from_numpy(state_np, "cpu")["params"]
    leaves = {p: t.requires_grad_(True) for p, t in tree_paths(params).items()
              if t.is_floating_point()}
    loss, metrics = lm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_grads_match_reference(remat):
    """Two chunks a sequence (2 x 64 tokens); every gradient leaf, the
    replicated A_log, D, dt_bias and the conv leaves among them."""
    _, jl, jm, jg = _reference_loss_and_grads()
    loss, metrics, grads = _port_loss_and_grads(remat)
    np.testing.assert_allclose(_np(loss), jl, **MODEL_TOL)
    np.testing.assert_allclose(_np(metrics["ce"]), jm["ce"], **MODEL_TOL)
    assert metrics["expert_load"] is None and float(metrics["moe_aux_loss"]) == 0.0
    assert set(grads) == set(jg)
    for path, g in grads.items():
        assert torch.isfinite(g).all(), path
        np.testing.assert_allclose(_np(g), jg[path], err_msg=path, **MODEL_TOL)


def test_remat_modes_are_bitwise_equal():
    """none, dots and full recompute the same ops on the same values."""
    ref_loss, _, ref = _port_loss_and_grads("none")
    for remat in ("dots", "full"):
        loss, _, grads = _port_loss_and_grads(remat)
        assert torch.equal(loss, ref_loss), remat
        for path, g in grads.items():
            assert torch.equal(g, ref[path]), (remat, path)


def test_three_step_trajectory_matches_reference():
    lm_j, state_np, arch = _setup()
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    step_j = jax.jit(jtraining.make_train_step(lm_j, jopt.OptimizerConfig(**opt_kw)))
    step_t = make_train_step(LanguageModel(arch), topt.OptimizerConfig(**opt_kw),
                             compute_dtype=torch.float32)
    state_t = state_from_numpy(state_np, "cpu")
    data = tdata.SyntheticTokens(arch.vocab_size, 2, 32)
    with lm_j.plan.mesh:
        state_j = jax.tree.map(jnp.asarray, state_np)
        for step in range(3):
            batch = data.batch_at(step)
            state_j, mj = step_j(state_j, jax.tree.map(jnp.asarray, batch))
            state_t, mt = step_t(state_t, batch)
            assert mt["skipped"] == int(mj["skipped"]) == 0
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=1e-5,
                                           err_msg=f"step {step} {k}")
    got, want = state_to_numpy(state_t), jax.tree.map(np.asarray, state_j)
    assert int(got["step"]) == int(want["step"]) == 3
    for part in ("m", "v"):
        want_p = tree_paths(want[part])
        for path, a in tree_paths(got[part]).items():
            np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-6,
                                       err_msg=f"{part}/{path}")
    want_p = tree_paths(want["params"])
    n = off = 0
    for path, a in tree_paths(got["params"]).items():
        np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-4, err_msg=path)
        n += a.size
        off += int((np.abs(a.astype(np.float64) - want_p[path]) > 1e-6).sum())
    assert off <= 1e-3 * n, (off, n)


def test_train_launcher_trains_mamba2(capsys):
    """``launch/train.py --arch mamba2-370m``: finite losses, none skipped,
    the drift table printed (not gated: the resource model prices mamba2 as
    little beyond its embeddings, ROADMAP Queue 3)."""
    s = train_launch.main(["--arch", NAME, "--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "32", "--metrics-out",
                           str(Path(os.environ.get("TMPDIR", "/tmp")) / "ssm_train_w1.jsonl")])
    out = capsys.readouterr().out
    assert np.isfinite(s["loss"]) and s["skipped"] == 0 and s["ep"] == 1
    assert "== drift mamba2-370m-reduced" in out and s["drift"]["step"]["n"] == 2


# ---------------------------------------------------------------------------
# Over ranks (the children)
# ---------------------------------------------------------------------------


def _grads(res, prefix):
    pre = prefix + "/grad/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


SSM_INNER = ("mixer/w_z", "mixer/w_x", "mixer/conv_x_w", "mixer/conv_x_b",
             "mixer/norm_scale", "mixer/out_proj")


@pytest.mark.parametrize("grid", ["1,2", "2,2"])
def test_sharded_mamba2_matches_reference_plan(runs, grid):
    """The port's plan at ``grid`` (dense: ep = the model axis) against the
    reference's on the same global batch: every rank's loss and gathered
    gradients; the "ssm_inner" leaves sliced over ep, and the embedding
    (its d_model over ep, at (2, 2) its vocab over data too)."""
    ref, r2, r4 = runs
    ranks = r2 if grid == "1,2" else r4
    want = _grads(ref, grid)
    for res in ranks:
        sliced = set(res[f"{grid}/sliced"])
        assert {f"blocks/0/{k}" for k in SSM_INNER} <= sliced
        assert "embed" in sliced
        np.testing.assert_allclose(res[f"{grid}/sliced/loss"], ref[f"{grid}/loss"], rtol=0,
                                   atol=LOSS_ATOL)
        got = _grads(res, f"{grid}/sliced")
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("grid", ["1,2", "2,2"])
def test_sliced_mamba2_equals_the_whole_control(runs, grid):
    """Each sliced leaf's gradient is summed once, by its gather's
    backward (reduce_grads_ skips it), the replicated ones by reduce_grads_
    alone: the sliced plan's loss and gradients are the all-whole
    control's, bitwise at 2 ranks, within 1e-6 at 4 (the sum's order)."""
    _, r2, r4 = runs
    ranks = r2 if grid == "1,2" else r4
    for res in ranks:
        assert np.array_equal(res[f"{grid}/sliced/loss"], res[f"{grid}/whole/loss"])
        got, want = _grads(res, f"{grid}/sliced"), _grads(res, f"{grid}/whole")
        for k, w in want.items():
            if grid == "1,2":
                assert np.array_equal(got[k], w), k
            else:
                np.testing.assert_allclose(got[k], w, rtol=0, atol=FOUR_RANK_ATOL, err_msg=k)


REPLICATED = ("A_log", "D", "dt_bias", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b")


@pytest.mark.parametrize("grid", ["1,2", "2,2"])
def test_sharded_grad_norm_counts_each_leaf_once(runs, grid):
    """The train step's grad norm over ranks (``training._global_norm``: a
    sliced leaf's squares summed over its gather group, the replicated
    A_log, D, dt_bias and conv leaves of B and C once) against the float64
    norm of the same step's gathered gradients, at the sliced-norm gate of
    the zero tests (1e-6 relative); counting the replicated leaves twice
    would move it 30x that gate or more."""
    _, r2, r4 = runs
    for res in (r2 if grid == "1,2" else r4):
        grads = {k: v.astype(np.float64) for k, v in _grads(res, f"{grid}/sliced").items()}
        want = np.sqrt(sum(np.square(g).sum() for g in grads.values()))
        twice = np.sqrt(want ** 2 + sum(np.square(g).sum() for k, g in grads.items()
                                         if k.rsplit("/", 1)[-1] in REPLICATED))
        got = float(res[f"{grid}/grad_norm"])
        assert abs(got - want) <= 1e-6 * want, (got, want)
        assert twice - want > 30e-6 * want, (twice, want)


@pytest.mark.parametrize("schedule", PP_SCHEDULES)
def test_pipelined_mamba2_matches_reference_executor(runs, schedule):
    """PP 2 (one mamba layer a stage, M = 4) through ``core/pipeline.py``
    against the reference's executor at (2, 1, 1) under 1f1b, which runs a
    dense arch; zb_h1 gives the same gradients."""
    ref, r2, _ = runs
    want = _grads(ref, "pp")
    for res in r2:
        np.testing.assert_allclose(res[f"pp/{schedule}/loss"], ref["pp/loss"], rtol=0,
                                   atol=LOSS_ATOL)
        got = _grads(res, f"pp/{schedule}")
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_ATOL, err_msg=k)


def test_train_launcher_over_two_ranks(runs):
    """``launch/train.py --arch mamba2-370m --reduced --mesh 1,2`` over gloo:
    ep 2, finite, nothing skipped, the same final loss on both ranks, the
    drift table's step row sampled."""
    _, r2, _ = runs
    for res in r2:
        assert int(res["launch/ep"]) == 2 and int(res["launch/skipped"]) == 0
        assert np.isfinite(res["launch/loss"])
        assert res["launch/loss"] == r2[0]["launch/loss"]
    assert int(r2[0]["launch/step_n"]) == 2
