"""The port's training slice against the JAX package, on the CPU.

Inputs and weights are made once with numpy (or by the JAX package's
``init_params``) and handed to both sides.  On the CPU every kernel
wrapper of ``repro_torch`` takes its plain version; the JAX side runs its
Pallas kernels in interpret mode, and its model with ``impl="xla"`` (the
reference's own oracle for the ragged custom VJP; its ``impl="pallas"``
loss has no gradient through ``flash_attention`` or ``grouped_matmul``).

Tolerances:

* ``ragged_dw_f32`` and ``RaggedFFN``'s gradients, fp32: rtol = atol =
  2e-5, the reference's own bound for its custom VJP
  (``tests/test_kernels.py::test_ragged_ffn_custom_vjp_matches_jax_grad``);
  both sides sum the same fp32 products in another order.  bf16 operands:
  rtol 2e-2, atol 8 x 2e-2 (one bf16 rounding of each side's result).
* ``LanguageModel.loss`` and every gradient, fp32 compute: 1e-5, the
  reference's model-parity bound.
* The 3-step train trajectory, fp32: loss and grad norm per step within
  1e-5 relative; Adam moments after step 3 within 1e-6 absolute; params
  after step 3 within 1e-6 absolute but for at most 0.1 % of elements,
  and within 1e-4 for all.  The first Adam steps move a weight by about
  sign(g) * lr (lr = 1e-3, 5.5e-4, 1e-4 here), so where a gradient
  element is ~0 by cancellation, a last-bit difference in its sum moves
  the update by a sizeable part of lr; measured: 28 of 255,296 elements
  beyond 1e-6, the largest 2.5e-5.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.configs import get_arch as jget_arch
from repro.data import pipeline as jdata
from repro.kernels.moe_gemm import moe_gemm as jmm
from repro.kernels.moe_gemm import ops as jmm_ops
from repro.models.model import LanguageModel as JLM
from repro.optim import optimizer as jopt
from repro.sharding import single_device_plan
from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.launch import train as train_launch
from repro_torch.models.model import LanguageModel, map_tree, tree_paths
from repro_torch.optim import optimizer as topt
from repro_torch.runtime import faults as faults_mod
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.training import init_state, make_train_step

NAME = "granite-moe-3b-a800m"
VJP_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=8 * 2e-2)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype: str = "float32"):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _offsets(counts):
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return jnp.asarray(offs), torch.from_numpy(offs)


# ---------------------------------------------------------------------------
# ragged_dw_f32 and RaggedFFN against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [[7, 0, 83, 1, 9], [0, 0, 0], [25, 25, 25, 25],
                                    [1, 1, 1, 1, 1, 96, 1, 1]])
def test_ragged_dw_matches_reference(counts, xdtype):
    """dW[e] = x_e^T g_e; empty experts give 0; NaN rows past offsets[E]
    (in both operands) leave dW finite."""
    rng = np.random.default_rng(0)
    E, T = len(counts), int(sum(counts))
    T_pad = -(-(T + 1) // 16) * 16  # at least one tail row, bm = 16
    K, N = 48, 64
    x = rng.standard_normal((T_pad, K))
    g = rng.standard_normal((T_pad, N))
    x[T:], g[T:] = np.nan, np.nan
    (jx, tx), (jg, tg) = _pair(x, xdtype), _pair(g)
    jo, to = _offsets(counts)
    want = jmm.ragged_dw_f32(jx, jg, jo, E, bm=16, interpret=True)
    got = mm_ops.ragged_dw_f32(tx, tg, to)
    assert got.dtype == torch.float32 and got.shape == (E, K, N)
    assert torch.isfinite(got).all()
    for e, c in enumerate(counts):
        if c == 0:
            assert (got[e] == 0).all()
    np.testing.assert_allclose(_np(got), _np(want), **VJP_TOL)


def _ffn_case(counts, activation, dtype, seed=0):
    rng = np.random.default_rng(seed)
    E, T = len(counts), int(sum(counts))
    T_pad = -(-(T + 1) // 16) * 16
    d, f = 32, 48
    x = _pair(rng.standard_normal((T_pad, d)), dtype)
    ws = [_pair(rng.standard_normal(s) * 0.2, dtype) for s in ((E, d, f), (E, d, f), (E, f, d))]
    cot = np.cos(np.arange(T_pad * d, dtype=np.float32)).reshape(T_pad, d)
    return x, ws, _offsets(counts), cot, T


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("counts", [[7, 0, 83, 1, 9], [1, 1, 1, 1, 1, 96, 1, 1]])
def test_ragged_ffn_grads_match_custom_vjp(counts, activation, dtype):
    (jx, tx), ((jwu, twu), (jwg, twg), (jwd, twd)), (jo, to), cot, T = _ffn_case(
        counts, activation, dtype)
    swiglu = activation == "swiglu"

    def jloss(x, wu, wg, wd):
        y = jmm_ops.ragged_ffn(x, wu, wg if swiglu else None, wd, jo, activation,
                               interpret=True, bm=16)
        return (y.astype(jnp.float32) * cot).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jx, jwu, jwg, jwd)
    leaves = [t.clone().requires_grad_(True) for t in (tx, twu, twg, twd)]
    y = mm_ops.ragged_ffn(leaves[0], leaves[1], leaves[2] if swiglu else None,
                          leaves[3], to, activation)
    assert y.dtype == tx.dtype and (y[T:] == 0).all()
    (y.float() * torch.from_numpy(cot)).sum().backward()
    tol = VJP_TOL if dtype == "float32" else BF16_TOL
    for name, leaf, w in zip(("dx", "dwu", "dwg", "dwd"), leaves, want):
        if name == "dwg" and not swiglu:
            assert leaf.grad is None
            continue
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(_np(leaf.grad), _np(w), err_msg=name, **tol)
    assert (leaves[0].grad[T:] == 0).all()  # rows no expert owns: no gradient


def test_ragged_ffn_backward_runs_the_ragged_kernels(monkeypatch):
    """The backward is three ragged GEMMs and three ragged dgrads (the
    wrappers; on the card each is one launch)."""
    calls = {"ragged_matmul_f32": 0, "ragged_dw_f32": 0, "ragged_gate_up_silu_f32": 0}
    for name in calls:
        real = getattr(mm_ops, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(mm_ops, name, counted)
    (_, tx), ws, (_, to), cot, _ = _ffn_case([7, 0, 83, 1, 9], "swiglu", "float32")
    leaves = [t.requires_grad_(True) for t in (tx, *[w[1] for w in ws])]
    y = mm_ops.ragged_ffn(leaves[0], leaves[1], leaves[2], leaves[3], to)
    assert calls == {"ragged_matmul_f32": 1, "ragged_dw_f32": 0, "ragged_gate_up_silu_f32": 1}
    (y * torch.from_numpy(cot)).sum().backward()
    assert calls == {"ragged_matmul_f32": 4, "ragged_dw_f32": 3, "ragged_gate_up_silu_f32": 1}


# ---------------------------------------------------------------------------
# LanguageModel.loss and its gradients against JAX impl="xla"
# ---------------------------------------------------------------------------


def _with_dispatch(arch, dispatch):
    return arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))


@lru_cache(maxsize=None)
def _setup(dispatch: str):
    """(JAX lm with fp32 compute, its init state as numpy, port lm) on the
    reduced arch."""
    arch_j = _with_dispatch(jget_arch(NAME).reduced(), dispatch)
    plan = dataclasses.replace(single_device_plan(arch_j), compute_dtype="float32")
    lm_j = JLM(arch_j, plan)
    with plan.mesh:
        state_j = jtraining.init_state(lm_j, jax.random.PRNGKey(0), jopt.OptimizerConfig())
    return lm_j, jax.tree.map(np.asarray, state_j), LanguageModel(
        _with_dispatch(get_arch(NAME).reduced(), dispatch))


def _batch(vocab, b=2, s=32, step=0):
    return tdata.SyntheticTokens(vocab, b, s).batch_at(step)


def _port_loss_and_grads(lm, params, batch):
    leaves = {p: t.requires_grad_(True) for p, t in tree_paths(params).items()
              if t.is_floating_point()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = lm.loss(params, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("chunks", [None, 4])
@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_loss_and_grads_match_reference(dispatch, chunks, monkeypatch):
    """Loss, its parts, expert loads and every gradient, fp32, 1e-5; with
    ``chunks`` the CE runs in 4 checkpointed sequence chunks on both
    sides."""
    lm_j, state_np, lm_t = _setup(dispatch)
    if chunks is not None:
        monkeypatch.setattr(lm_j, "_loss_chunks", lambda b, s: chunks)
        monkeypatch.setattr(lm_t, "_loss_chunks", lambda b, s: chunks)
    batch = _batch(lm_t.arch.vocab_size)
    with lm_j.plan.mesh:
        (jl, jm), jg = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))(
            jax.tree.map(jnp.asarray, state_np["params"]),
            jax.tree.map(jnp.asarray, batch))
    params = state_from_numpy(state_np, "cpu")["params"]
    loss, metrics, grads = _port_loss_and_grads(lm_t, params, batch)
    np.testing.assert_allclose(_np(loss), _np(jl), **MODEL_TOL)
    for k in ("ce", "moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(metrics[k]), _np(jm[k]), err_msg=k, **MODEL_TOL)
    np.testing.assert_array_equal(metrics["expert_load"].numpy(), np.asarray(jm["expert_load"]))
    jflat = tree_paths(jg)
    assert set(grads) == {p for p, g in jflat.items() if g.dtype != jax.dtypes.float0}
    for path, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jflat[path]), err_msg=path,
                                   **MODEL_TOL)


def test_loss_chunks_rule():
    """One device: the reference's 128 MB logits rule with no divisor."""
    lm = LanguageModel(get_arch(NAME))  # vocab padded to 49408
    assert lm._loss_chunks(2, 512) == 2  # 1024 tokens > 647 per chunk
    assert lm._loss_chunks(1, 512) == 1
    assert lm._loss_chunks(8, 4096) == 64
    assert LanguageModel(get_arch(NAME).reduced())._loss_chunks(2, 32) == 1


# ---------------------------------------------------------------------------
# Optimizer and train step against the JAX package
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    cfg_t = topt.OptimizerConfig(lr=3e-4, warmup_steps=100, total_steps=1000)
    cfg_j = jopt.OptimizerConfig(lr=3e-4, warmup_steps=100, total_steps=1000)
    for step in (0, 1, 50, 99, 100, 101, 550, 1000, 5000):
        np.testing.assert_allclose(topt.lr_schedule(cfg_t, step),
                                   float(jopt.lr_schedule(cfg_j, jnp.int32(step))),
                                   rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip off / on
def test_adamw_update_matches_reference(grad_scale):
    """In-place update against the reference's functional one over 3
    steps; the int table passes through."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": (rng.standard_normal(11).astype(np.float32),),
              "t": np.arange(4, dtype=np.int32)}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    cfg_j, cfg_t = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, params)
    jo = jopt.adamw_init(jp)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": (torch.from_numpy(params["b"][0].copy()),),
          "t": torch.from_numpy(params["t"].copy())}
    to = topt.adamw_init(tp)
    for step in range(3):
        g = {"a": rng.standard_normal((5, 7)).astype(np.float32) * grad_scale,
             "b": (rng.standard_normal(11).astype(np.float32) * grad_scale,)}
        jg = {"a": jnp.asarray(g["a"]), "b": (jnp.asarray(g["b"][0]),),
              "t": np.zeros(4, jax.dtypes.float0)}
        jp, jo, jmet = jopt.adamw_update(cfg_j, jp, jg, jo)
        tg = {"a": torch.from_numpy(g["a"]), "b": (torch.from_numpy(g["b"][0]),), "t": None}
        tmet = topt.adamw_update(cfg_t, tp, tg, to)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
        for tree_t, tree_j in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
            for path, t in tree_paths(tree_t).items():
                np.testing.assert_allclose(t.numpy(), np.asarray(tree_paths(tree_j)[path]),
                                           rtol=2e-6, atol=1e-7, err_msg=f"{step} {path}")
        assert int(to["step"]) == int(jo["step"]) == step + 1
    assert torch.equal(tp["t"], torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_three_step_trajectory_matches_reference(dispatch):
    lm_j, state_np, lm_t = _setup(dispatch)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    step_j = jax.jit(jtraining.make_train_step(lm_j, jopt.OptimizerConfig(**opt_kw)))
    step_t = make_train_step(lm_t, topt.OptimizerConfig(**opt_kw),
                             compute_dtype=torch.float32)
    state_t = state_from_numpy(state_np, "cpu")
    with lm_j.plan.mesh:
        state_j = jax.tree.map(jnp.asarray, state_np)
        for step in range(3):
            batch = _batch(lm_t.arch.vocab_size, step=step)
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


def test_trajectory_gap_enters_through_small_gradients():
    """Why the 3-step params above need atol 1e-4 where the moments meet
    1e-6.  (1) The port's ``adamw_update`` fed the JAX run's own gradients
    gives the JAX params within 1e-7 but for at most 1e-5 of elements and
    within 2e-7 for all (measured: one element of 255,296 beyond 1e-7,
    1.79e-7, 3 fp32 ulps of its weight of 0.506; the two sides round the
    update's terms in another order): the optimizer is not the cause.  (2) Every
    param of the port's own run beyond 1e-6 of JAX's has a JAX gradient of
    at most 1e-5 (1000 x eps) in magnitude at one of the three steps,
    where an Adam step, ~lr * g / (|g| + eps), turns a last-bit difference
    of the gradient into a sizeable part of lr.  Measured: 25 elements, 24
    with |g| <= 1.1e-7 at step 1 or 2, one with |g| 3.4e-6 to 5.2e-6 at
    every step."""
    lm_j, state_np, lm_t = _setup("ragged")
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    cfg_j = jopt.OptimizerConfig(**opt_kw)
    grad_j = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))
    update_j = jax.jit(lambda p, g, o: jopt.adamw_update(cfg_j, p, g, o))
    step_t = make_train_step(lm_t, topt.OptimizerConfig(**opt_kw), compute_dtype=torch.float32)
    state_t = state_from_numpy(state_np, "cpu")
    fed = state_from_numpy(state_np, "cpu")
    small = None  # per element: has a JAX gradient <= 1e-5 at some step
    with lm_j.plan.mesh:
        state_j = jax.tree.map(jnp.asarray, state_np)
        for step in range(3):
            batch = _batch(lm_t.arch.vocab_size, step=step)
            _, g = grad_j(state_j["params"], jax.tree.map(jnp.asarray, batch))
            p, o, _ = update_j(state_j["params"], g, {k: state_j[k] for k in ("m", "v", "step")})
            state_j = {"params": p, **o}
            g = {k: np.asarray(v) for k, v in tree_paths(g).items()
                 if v.dtype != jax.dtypes.float0}
            now = {k: np.abs(v) <= 1e-5 for k, v in g.items()}
            small = now if small is None else {k: small[k] | now[k] for k in now}
            fed_g = {k: torch.from_numpy(g[k].copy()) if k in g else None
                     for k in tree_paths(fed["params"])}
            it = iter(fed_g.values())
            topt.adamw_update(topt.OptimizerConfig(**opt_kw), fed["params"],
                              map_tree(lambda _: next(it), fed["params"]), fed)
            state_t, _ = step_t(state_t, batch)
    want = tree_paths(jax.tree.map(np.asarray, state_j["params"]))
    fed_p = tree_paths(state_to_numpy(fed)["params"])
    got = tree_paths(state_to_numpy(state_t)["params"])
    off = fed_off = 0
    for path, w in want.items():
        fed_gap = np.abs(fed_p[path].astype(np.float64) - w)
        assert fed_gap.max() <= 2e-7, path
        fed_off += int((fed_gap > 1e-7).sum())
        beyond = np.abs(got[path].astype(np.float64) - w) > 1e-6
        off += int(beyond.sum())
        if path in small:
            assert small[path][beyond].all(), path
        else:  # an integer table
            assert not beyond.any(), path
    n = sum(w.size for w in want.values())
    assert 0 < off <= 1e-3 * n and fed_off <= 1e-5 * n, (off, fed_off, n)


def test_sentinel_skips_and_leaves_state_bit_identical():
    _, state_np, lm_t = _setup("ragged")
    opt = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    state = state_from_numpy(state_np, "cpu")
    before = {p: t.clone() for p, t in tree_paths(state).items()}
    batch = _batch(lm_t.arch.vocab_size)
    fetched = []

    def fetch(t):
        fetched.append(t)
        return t.item()

    step = make_train_step(lm_t, opt, compute_dtype=torch.float32, fetch=fetch)
    state, m = step(state, {**batch, "fault_scale": np.float32(np.nan)})
    assert m["skipped"] == 1 and not np.isfinite(float(m["loss"]))
    capped = make_train_step(lm_t, opt, gnorm_skip_cap=1e-6, compute_dtype=torch.float32,
                             fetch=fetch)
    state, m = capped(state, batch)
    assert m["skipped"] == 1 and np.isfinite(float(m["loss"]))
    for path, t in tree_paths(state).items():
        assert torch.equal(t, before[path]) and not t.requires_grad, path
    assert len(fetched) == 2  # one host fetch per step
    state, m = step(state, batch)
    assert m["skipped"] == 0 and int(state["step"]) == 1
    assert not torch.equal(state["params"]["embed"], before["params/embed"])


def test_state_conversion_roundtrip():
    _, state_np, _ = _setup("ragged")
    back = state_to_numpy(state_from_numpy(state_np, "cpu"))
    for path, a in tree_paths(state_np).items():
        b = tree_paths(back)[path]
        assert b.dtype == a.dtype and np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# Data, trainer and the training entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,shard,shards", [(49155, 0, 1), (512, 1, 2), (49155, 3, 4)])
def test_synthetic_tokens_bit_identical(vocab, shard, shards):
    kw = dict(vocab_size=vocab, batch=3, seq_len=17, shard_index=shard, num_shards=shards)
    ours, theirs = tdata.SyntheticTokens(**kw), jdata.SyntheticTokens(**kw)
    for step in (0, 1, 7, 1000, 123457):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_memmap_corpus_and_prefetcher_match_reference(tmp_path):
    path = str(tmp_path / "corpus.bin")
    tdata.write_corpus(path, np.random.default_rng(0).integers(0, 1000, 5000))
    ours, theirs = tdata.MemmapCorpus(path, 4, 32, seed=3), jdata.MemmapCorpus(path, 4, 32, seed=3)
    for step in (0, 5, 38, 39, 100):
        assert np.array_equal(ours.batch_at(step)["tokens"], theirs.batch_at(step)["tokens"])
    pre = tdata.Prefetcher(iter(ours))
    first = [next(pre) for _ in range(3)]
    pre.close()
    assert not pre._thread.is_alive()
    for step, b in enumerate(first):
        assert np.array_equal(b["labels"], theirs.batch_at(step)["labels"])
    with pytest.raises(ValueError):
        tdata.MemmapCorpus(path, 1000, 32)


def _trainer(total_steps, log_every=4, plan=None, **cfg):
    lm = LanguageModel(get_arch(NAME).reduced())
    logs = []
    ring = obs.RingBufferSink()
    trainer = Trainer(lm, topt.OptimizerConfig(lr=1e-3, total_steps=total_steps),
                      TrainerConfig(total_steps=total_steps, log_every=log_every,
                                    data_backoff_s=0.001, **cfg),
                      log_fn=logs.append, injector=FaultInjector(plan, log_fn=logs.append),
                      telemetry=obs.Telemetry(sinks=[ring]))
    state = init_state(lm, torch.Generator().manual_seed(0), "cpu")
    return trainer, state, tdata.SyntheticTokens(lm.arch.vocab_size, 2, 16), logs, ring


def test_trainer_host_fetch_cadence():
    """One host fetch per step (the sentinel's verdict); the loss only on
    log steps."""
    trainer, state, data, _, ring = _trainer(8, log_every=4)
    out = trainer.fit(state, data)
    assert out["last_step"] == 7 and not out["anomalies"]
    assert trainer.host_fetches == 8 + 2  # 8 verdicts + the loss at steps 0 and 4
    assert int(out["state"]["step"]) == 8
    ev = ring.events()
    assert sum(e["name"] == "train.step" and e["kind"] == "span" for e in ev) == 8
    assert sum(e["name"] == "train.data" and e["kind"] == "span" for e in ev) == 8
    assert len(trainer.telemetry.hists["train.step_s"]) == 8
    assert [e["attrs"]["step"] for e in ev if e["kind"] == "gauge"] == [0, 4]


class _VirtualTime:
    """``time`` for the trainer and the injector, with no host clock in it:
    ``perf_counter`` advances by a fixed tick per call and ``sleep`` adds
    to it instead of waiting.  So every step takes the same virtual time
    and an injected slow step is slow by exactly its payload.  Reading
    the host's clock here let a loaded machine stall an ordinary step
    past the straggler threshold and report a second straggler."""

    TICK = 0.01

    def __init__(self):
        self.offset = 0.0

    def perf_counter(self):
        self.offset += self.TICK
        return self.offset

    def sleep(self, seconds):
        self.offset += seconds


def test_trainer_recovers_from_injected_faults(monkeypatch):
    clock = _VirtualTime()
    monkeypatch.setattr(trainer_mod, "time", clock)
    monkeypatch.setattr(faults_mod, "time", clock)
    plan = FaultPlan([FaultSpec("data.transient", step=1, count=2),
                      FaultSpec("train.nonfinite", step=2),
                      FaultSpec("train.slow_step", step=7, payload=1000.0)])
    trainer, state, data, logs, ring = _trainer(8, plan=plan)
    out = trainer.fit(state, data)
    assert [a["step"] for a in out["anomalies"]] == [2]
    assert out["stragglers"] == [7]
    assert int(out["state"]["step"]) == 7  # 8 steps, one skipped
    assert sum("[data] transient error at step 1" in line for line in logs) == 2
    assert trainer.injector.fired() == 4
    assert [e["attrs"]["step"] for e in ring.events() if e["name"] == "train.anomaly"] == [2]


def test_trainer_refuses_what_is_not_ported():
    """A skip streak that reaches ``anomaly_rollback_after`` with no
    ``checkpoint_dir`` raises, as the reference does."""
    plan = FaultPlan([FaultSpec("train.nonfinite", step=0, count=3)])
    trainer, state, data, _, _ = _trainer(5, plan=plan)
    with pytest.raises(RuntimeError, match="no checkpoint_dir to roll back to"):
        trainer.fit(state, data)
    assert [a["step"] for a in trainer.anomalies] == [0, 1, 2] and not trainer.rollbacks


@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_train_entry_point_on_cpu(dispatch, capsys):
    summary = train_launch.main(["--reduced", "--device", "cpu", "--steps", "3",
                                 "--batch", "2", "--seq", "16", "--dispatch", dispatch])
    out = capsys.readouterr().out
    assert summary["dispatch"] == dispatch and summary["steps"] == 3
    assert summary["skipped"] == 0 and np.isfinite(summary["loss"])
    assert f"moe dispatch: {dispatch} (--dispatch)" in out  # the flag wins
    assert "[planner] production-strategy for granite-moe-3b-a800m @256xh100-sxm" in out


def test_train_entry_point_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--reduced", "--steps", "1"])
