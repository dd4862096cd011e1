"""The paper's own configs in the port against the JAX package, on the CPU:
``piper-m10b-e16`` / ``-e128`` / ``-e256`` (the M10B base scaled by expert
count, a 2-matrix gelu expert FFN) and ``piper-super-545b`` (160
fine-grained experts top-6), with the registry helpers they came with
(``ASSIGNED``, ``list_archs``, ``SHAPES``, ``shape_applicable``) and the
planner twin ``repro_torch.launch.plan_search``.

Each config equals the reference's field by field with ``==`` at full size
and reduced (``TABLE_I`` too), and so do the parameter counts and the
paper's scaling (the reference's ``test_m10b_scaling_matches_paper``).
Reduced M10B-E16 and super-545b (d_model 64, 8 experts top-2, expert d_ff
64), on weights converted from the reference's ``init_params``, under both
dispatch modes: the forward logits, the loss and every gradient (the gelu
expert FFN's ragged backward, or the capacity path's plain products), and
one AdamW step.  The resource model's ``ModelShape`` and the planner's
strategies for both on ``FRONTIER`` at the reference's own
``tests/test_resource_model.py`` cases, compared with ``==``.  The twin's
stdout equals ``examples/plan_search.py``'s for the same arguments.

Tolerances: the reference's model parity 1e-5 (both sides fp32, summation
order alone); the AdamW step's moments 1e-6 absolute; everything else
``==``.
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

from repro import configs as rconfigs
from repro import training as jtraining
from repro.configs import piper_paper as rpiper
from repro.core import planner as rpl
from repro.core import platform as rpf
from repro.core import resource_model as rrm
from repro.models.model import LanguageModel as JLM
from repro.optim import optimizer as jopt
from repro.sharding import single_device_plan
from repro_torch import configs, training
from repro_torch.configs import piper_paper
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import planner as pl
from repro_torch.core import platform as pf
from repro_torch.core import resource_model as rm
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
PIPER = ["piper-m10b-e16", "piper-m10b-e128", "piper-m10b-e256", "piper-super-545b"]
RUN = ["piper-m10b-e16", "piper-super-545b"]
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _fields(a):
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(a) for v in (getattr(a, f.name),)}


# ---------------------------------------------------------------------------
# The configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", PIPER)
def test_config_equals_the_reference(name, reduced):
    """Every field equals the reference's (``MoECfg.router_dtype`` aside:
    the port does not carry it, and it is "float32" there), and so do the
    parameter counts."""
    mine, ref = configs.get_arch(name), rconfigs.get_arch(name)
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    got, want = _fields(mine), _fields(ref)
    assert want["moe"].pop("router_dtype") == "float32"
    assert got == want
    assert mine.total_params() == ref.total_params()
    assert mine.active_params() == ref.active_params()
    gelu = name.startswith("piper-m10b")
    assert (mine.ffn_activation, mine.n_mat) == (("gelu", 2) if gelu else ("swiglu", 3))


def test_m10b_factory_and_table_i_equal_the_reference():
    for e in (1, 2, 16, 64):
        got, want = _fields(piper_paper.m10b(e)), _fields(rpiper.m10b(e))
        if want["moe"] is not None:
            assert want["moe"].pop("router_dtype") == "float32"
        assert got == want
    assert piper_paper.TABLE_I == rpiper.TABLE_I


def test_m10b_scaling_matches_paper():
    """The reference's figures (Fig 14): M10B at E=128 -> 862B, E=256 ->
    1.7T; the dense base ~10.1B; super-545b within 2 % of 545B."""
    total = {n: configs.get_arch(n).total_params() for n in PIPER}
    assert abs(total["piper-m10b-e128"] - 862e9) < 10e9
    assert abs(total["piper-m10b-e256"] - 1.72e12) < 2e10
    assert abs(piper_paper.m10b(1).total_params() - 10.1e9) / 10.1e9 < 0.1
    assert abs(total["piper-super-545b"] - 545e9) / 545e9 < 0.02
    assert total == {n: rconfigs.get_arch(n).total_params() for n in PIPER}


def test_registry_equals_the_reference():
    assert configs.list_archs() == rconfigs.list_archs()
    assert configs.ASSIGNED == rconfigs.ASSIGNED
    assert sorted(configs.ARCHS) == sorted(rconfigs.ARCHS) and len(configs.ARCHS) == 14
    assert list(configs.ARCHS) == list(rconfigs.ARCHS)  # the reference's order
    assert set(configs.__all__) >= set(rconfigs.__all__)
    assert list(configs.SHAPES) == list(rconfigs.SHAPES)
    for k, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(rconfigs.SHAPES[k])
    for name in configs.list_archs():
        for shape in configs.SHAPES.values():
            got = configs.shape_applicable(configs.get_arch(name), shape)
            want = rconfigs.shape_applicable(rconfigs.get_arch(name),
                                             rconfigs.SHAPES[shape.name])
            assert got == want, (name, shape.name)
    assert configs.shape_applicable(configs.get_arch("mamba2-370m"), configs.LONG_500K)[0]
    assert not configs.shape_applicable(configs.get_arch("piper-super-545b"),
                                        configs.LONG_500K)[0]


# ---------------------------------------------------------------------------
# The resource model and the planner
# ---------------------------------------------------------------------------


def _same(a, b):
    a = dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a
    b = dataclasses.asdict(b) if dataclasses.is_dataclass(b) else b
    assert a == b


@pytest.mark.parametrize("name", PIPER)
def test_model_shape_equals_the_reference(name):
    _same(rm.ModelShape.from_arch(configs.get_arch(name)),
          rrm.ModelShape.from_arch(rconfigs.get_arch(name)))


def test_resource_model_cases_equal_the_reference():
    """The reference's ``tests/test_resource_model.py`` cases on these
    configs: memory over EP (super-545b), the 1F1B stage skew, the a2a
    lower bound and the interleaved memory (M10B-E16), on FRONTIER."""
    def both(name):
        return (rm.ModelShape.from_arch(configs.get_arch(name)),
                rrm.ModelShape.from_arch(rconfigs.get_arch(name)))

    base = dict(b=256, s=4096)
    m, r = both("piper-super-545b")
    for ep in (8, 32):
        kw = dict(base, EP=ep, zero="none")
        assert rm.memory_edp(m, rm.TrainSetup(**kw)) == rrm.memory_edp(r, rrm.TrainSetup(**kw))
    m, r = both("piper-m10b-e16")
    kw = dict(base, PP=4, EP=16, alpha=2, zero="none")
    t, tr = rm.TrainSetup(**kw), rrm.TrainSetup(**kw)
    assert rm.memory_1f1b_skew(m, t) == rrm.memory_1f1b_skew(r, tr) > 0
    for stage in (0, 3):
        assert rm.memory_pp_1f1b(m, t, stage) == rrm.memory_pp_1f1b(r, tr, stage)
    for ep, s in ((8, 4096), (16, 4096), (8, 8192)):
        kw = dict(base, EP=ep, s=s)
        assert (rm.t_a2a_lower_bound(m, rm.TrainSetup(**kw), pf.FRONTIER)
                == rrm.t_a2a_lower_bound(r, rrm.TrainSetup(**kw), rpf.FRONTIER))
    for sched, V in (("1f1b", 1), ("interleaved_1f1b", 2)):
        kw = dict(base, PP=4, EP=16, alpha=2, zero="none", schedule=sched, vstages=V)
        assert (rm.memory_pp(m, rm.TrainSetup(**kw), 0)
                == rrm.memory_pp(r, rrm.TrainSetup(**kw), 0))


def test_planner_strategies_equal_the_reference():
    """super-545b on 512 FRONTIER chips (the paper's run): the same
    feasible strategies (Eq 7-11), ranked the same, the best one's
    estimate equal and in the paper's MFU band; the same minimum chip
    count; M10B-E16 on 16 chips with ZeRO over the world."""
    kw = dict(batch=256, seq=4096)
    for name, chips, zero in (("piper-super-545b", 512, "dp"), ("piper-m10b-e16", 16, "world")):
        mine = pl.rank_strategies(pl.valid_strategies(configs.get_arch(name), pf.FRONTIER,
                                                      chips, zero=zero, **kw))
        ref = rpl.rank_strategies(rpl.valid_strategies(rconfigs.get_arch(name), rpf.FRONTIER,
                                                       chips, zero=zero, **kw))
        assert len(mine) == len(ref) > 0, name
        assert [s.describe() for s in mine] == [s.describe() for s in ref]
        _same(mine[0].estimate, ref[0].estimate)
    best = pl.best_strategy(configs.get_arch("piper-super-545b"), pf.FRONTIER, 512, **kw)
    assert 0.15 < best.estimate.mfu < 0.55
    counts = [8, 16, 32, 64, 128, 256, 512]
    got = pl.min_chips(configs.get_arch("piper-super-545b"), pf.FRONTIER, chip_counts=counts,
                       **kw)
    assert got == rpl.min_chips(rconfigs.get_arch("piper-super-545b"), rpf.FRONTIER,
                                chip_counts=counts, **kw) and got >= 64


@pytest.mark.parametrize("argv", [
    [],
    ["--arch", "piper-m10b-e16", "--chips", "16", "--zero", "world", "--top", "5"],
    ["--arch", "granite-moe-3b-a800m", "--platform", "frontier-mi250x", "--chips", "16",
     "--batch", "64", "--seq", "2048", "--zero", "none", "--top", "3"],
])
def test_plan_search_twin_prints_the_references_lines(argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    mine = subprocess.run([sys.executable, "-m", "repro_torch.launch.plan_search", *argv],
                          capture_output=True, text=True, cwd=ROOT, env=env, check=True,
                          timeout=120)
    ref = subprocess.run([sys.executable, "examples/plan_search.py", *argv],
                         capture_output=True, text=True, cwd=ROOT, env=env, check=True,
                         timeout=120)
    assert mine.stdout == ref.stdout and "chosen:" in mine.stdout


# ---------------------------------------------------------------------------
# The reduced configs against the reference, under both dispatches
# ---------------------------------------------------------------------------


def _with(arch, dispatch):
    return arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))


@lru_cache(maxsize=None)
def _setup(name, dispatch):
    """(JAX lm with fp32 compute, its init state as numpy, port lm)."""
    arch_j = _with(rconfigs.get_arch(name).reduced(), dispatch)
    plan = dataclasses.replace(single_device_plan(arch_j), compute_dtype="float32")
    lm_j = JLM(arch_j, plan)
    with plan.mesh:
        state_j = jtraining.init_state(lm_j, jax.random.PRNGKey(0), jopt.OptimizerConfig())
    lm_t = LanguageModel(_with(configs.get_arch(name).reduced(), dispatch))
    return lm_j, jax.tree.map(np.asarray, state_j), lm_t


def _batch(vocab, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


CASES = [(n, d) for n in RUN for d in ("capacity", "ragged")]


@pytest.mark.parametrize("name,dispatch", CASES)
def test_forward_matches_reference(name, dispatch):
    lm_j, state_np, lm_t = _setup(name, dispatch)
    toks = _batch(lm_t.arch.vocab_size, 2, 24)["tokens"]
    with lm_j.plan.mesh:
        want, jaux, jloads = jax.jit(lm_j.forward)(
            jax.tree.map(jnp.asarray, state_np["params"]), {"tokens": jnp.asarray(toks)})
    got, aux, loads = lm_t.forward(state_from_numpy(state_np, "cpu")["params"],
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), err_msg=k, **MODEL_TOL)
    np.testing.assert_array_equal(loads.numpy(), np.asarray(jloads))


@pytest.mark.parametrize("name,dispatch", CASES)
def test_loss_and_grads_match_reference(name, dispatch):
    """The loss, its parts and every gradient: under ragged the expert
    FFN's autograd backward (``RaggedFFN``: gelu's two ragged GEMMs and
    two ``ragged_dw_f32``; super-545b's swiglu three and three), under
    capacity the plain products."""
    lm_j, state_np, lm_t = _setup(name, dispatch)
    batch = _batch(lm_t.arch.vocab_size)
    with lm_j.plan.mesh:
        (jl, jm), jg = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))(
            jax.tree.map(jnp.asarray, state_np["params"]), jax.tree.map(jnp.asarray, batch))
    params = state_from_numpy(state_np, "cpu")["params"]
    loss, metrics, grads = training.loss_and_grads(lm_t, params, batch, torch.float32)
    np.testing.assert_allclose(_np(loss), _np(jl), **MODEL_TOL)
    for k in ("ce", "moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(metrics[k]), _np(jm[k]), err_msg=k, **MODEL_TOL)
    jflat = {p: g for p, g in tree_paths(jg).items() if g.dtype != jax.dtypes.float0}
    got = {p: g for p, g in tree_paths(grads).items() if g is not None}
    assert set(got) == set(jflat)
    assert ("blocks/0/ffn/w_gate" in got) == (lm_t.arch.ffn_activation == "swiglu")
    for path, g in got.items():
        np.testing.assert_allclose(_np(g), np.asarray(jflat[path]), err_msg=path,
                                   **MODEL_TOL)


@pytest.mark.parametrize("name,dispatch", CASES)
def test_train_step_matches_reference(name, dispatch):
    lm_j, state_np, lm_t = _setup(name, dispatch)
    batch = _batch(lm_t.arch.vocab_size, seed=1)
    with lm_j.plan.mesh:
        state_j, mj = jax.jit(jtraining.make_train_step(lm_j, jopt.OptimizerConfig(**OPT)))(
            jax.tree.map(jnp.asarray, state_np), jax.tree.map(jnp.asarray, batch))
    state_t, mt = training.make_train_step(lm_t, topt.OptimizerConfig(**OPT),
                                           compute_dtype=torch.float32)(
        state_from_numpy(state_np, "cpu"), batch)
    assert mt["skipped"] == int(mj["skipped"]) == 0
    for k in ("loss", "grad_norm"):
        assert np.isfinite(_np(mt[k]))
        np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=1e-5, err_msg=k)
    got, want = state_to_numpy(state_t), jax.tree.map(np.asarray, state_j)
    for part in ("m", "v"):
        want_p = tree_paths(want[part])
        for path, a in tree_paths(got[part]).items():
            np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-6,
                                       err_msg=f"{part}/{path}")
