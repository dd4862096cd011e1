"""The port's serving engine and launcher against the JAX package's.

Both engines run on the same weights (the JAX ``init_params`` of
``granite-moe-3b-a800m.reduced()`` at the reference's no-drop capacity
factor, converted with ``repro_torch.convert``) and the same seeded
workloads, and must agree exactly: the same ``trace`` tuples (admissions,
prefills, decode batches, preemptions, finishes) and the same generated
tokens.  The port runs on the CPU, where its kernel wrappers take their
plain versions.
"""

import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.model import LanguageModel as JLM
from repro.models.model import init_params as jinit_params
from repro.runtime import faults as jfaults
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeConfig as JServeConfig
from repro.sharding import single_device_plan
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models.model import LanguageModel
from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.serving import BlockPool, Engine, PagedLayout, Request, ServeConfig

NAME = "granite-moe-3b-a800m"


def _no_drop(arch, dispatch):
    E, k = arch.moe.num_experts, arch.moe.top_k
    return arch.replace(moe=dataclasses.replace(
        arch.moe, dispatch=dispatch, capacity_factor=float(E) / k + 1.0))


@lru_cache(maxsize=None)
def setup(dispatch: str):
    arch_j = _no_drop(jget_arch(NAME).reduced(), dispatch)
    plan = single_device_plan(arch_j)
    with plan.mesh:
        params_j = jinit_params(arch_j, jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return (plan, JLM(arch_j, plan), params_j,
            LanguageModel(_no_drop(get_arch(NAME).reduced(), dispatch)), params_t)


def _workload(n, seed, max_new):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 14, size=n)
    return [(i, rng.integers(0, 512, size=int(l)), max_new) for i, l in enumerate(lens)]


def _both(dispatch, cfg_kw, n, seed, max_new):
    plan, lm_j, params_j, lm_t, params_t = setup(dispatch)
    work = _workload(n, seed, max_new)
    with plan.mesh:
        ej = JEngine(lm_j, params_j, JServeConfig(**cfg_kw))
        out_j = ej.run([JRequest(rid=r, tokens=t, max_new_tokens=m) for r, t, m in work])
    et = Engine(lm_t, params_t, ServeConfig(**cfg_kw))
    out_t = et.run([Request(rid=r, tokens=t, max_new_tokens=m) for r, t, m in work])
    return ej, out_j, et, out_t


def test_engine_backpressure_matches_reference():
    """admit_reserve_blocks holds new work back on a tight pool: the same
    deferred admissions, trace and tokens as the JAX engine."""
    tight_bp = dict(max_seqs=2, block_size=4, num_blocks=7, max_blocks_per_seq=8,
                    admit_reserve_blocks=2)
    ej, out_j, et, out_t = _both("ragged", tight_bp, n=3, seed=1, max_new=6)
    assert et.backpressure_steps == ej.backpressure_steps > 0
    assert et.trace == ej.trace
    assert out_t == out_j


@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_engine_fifo_matches_reference(dispatch):
    cfg = dict(max_seqs=2, block_size=4, num_blocks=32, max_blocks_per_seq=8)
    ej, out_j, et, out_t = _both(dispatch, cfg, n=6, seed=0, max_new=4)
    assert et.trace == ej.trace
    assert out_t == out_j
    assert sorted(out_t) == list(range(6)) and all(len(v) == 4 for v in out_t.values())
    assert any(len(e[2]) > 1 for e in et.trace if e[0] == "decode")
    et.pool.check_invariants()
    assert et.pool.free_blocks == cfg["num_blocks"]


def test_engine_preemption_matches_reference():
    tight = dict(max_seqs=2, block_size=4, num_blocks=7, max_blocks_per_seq=8)
    ej, out_j, et, out_t = _both("ragged", tight, n=3, seed=1, max_new=6)
    assert any(e[0] == "preempt" for e in et.trace), "tight pool must preempt"
    assert et.trace == ej.trace
    assert out_t == out_j
    # preemption is invisible in the outputs: a roomy pool gives the same
    roomy = dict(tight, num_blocks=64)
    _, _, _, out_roomy = _both("ragged", roomy, n=3, seed=1, max_new=6)
    assert out_t == out_roomy


def test_engine_deadline_and_stall_shed():
    """A stall burns a running request's deadline until it is shed with its
    partial tokens; an infeasible queued deadline is shed before prefill.
    The JAX engine under the same fault plan sheds the same requests."""
    plan, lm_j, params_j, lm_t, params_t = setup("ragged")
    cfg = dict(max_seqs=2, block_size=4, num_blocks=32, max_blocks_per_seq=8)
    rng = np.random.default_rng(8)
    work = [(0, rng.integers(0, 512, size=5), 5, 6), (1, rng.integers(0, 512, size=5), 6, 2)]
    inj = FaultInjector(FaultPlan([FaultSpec("serve.stall", step=2, count=3)]),
                        log_fn=lambda m: None)
    eng = Engine(lm_t, params_t, ServeConfig(**cfg), injector=inj)
    out = eng.run([Request(rid=r, tokens=t, max_new_tokens=m, deadline_step=dl)
                   for r, t, m, dl in work])
    jinj = jfaults.FaultInjector(
        jfaults.FaultPlan([jfaults.FaultSpec("serve.stall", step=2, count=3)]),
        log_fn=lambda m: None)
    with plan.mesh:
        ej = JEngine(lm_j, params_j, JServeConfig(**cfg), injector=jinj)
        out_j = ej.run([JRequest(rid=r, tokens=t, max_new_tokens=m, deadline_step=dl)
                        for r, t, m, dl in work])
    assert eng.trace == ej.trace and out == out_j
    assert {r: (a.step, a.reason, a.generated) for r, a in eng.aborted.items()} == {
        r: (a.step, a.reason, a.generated) for r, a in ej.aborted.items()}
    assert out == {} and inj.fired("serve.stall") == 3
    assert [e for e in eng.trace if e[0] == "stall"] == [("stall", 2), ("stall", 3),
                                                         ("stall", 4)]
    assert eng.aborted[1].generated == [] and eng.aborted[1].step == 1
    assert eng.aborted[0].reason == "deadline" and len(eng.aborted[0].generated) == 2
    assert eng.pool.free_blocks == cfg["num_blocks"]
    with pytest.raises(ValueError):  # un-servable requests are refused
        eng.submit(Request(rid=9, tokens=np.zeros(40, np.int32), max_new_tokens=1))


def test_block_pool_lifecycle():
    layout = PagedLayout(num_blocks=8, block_size=4, max_seqs=3, max_blocks_per_seq=4)
    pool = BlockPool(layout)
    s0 = pool.admit(5)
    s1 = pool.admit(4)
    assert pool.free_blocks == 5 and pool.extend(s1, 1) and pool.free_blocks == 4
    released = set(pool.block_table[s0][:2].tolist())
    pool.release(s0)
    s2 = pool.admit(8)
    assert set(pool.block_table[s2][:2].tolist()) & released  # LIFO reuse
    pool.check_invariants()
    assert not pool.extend(s2, 100)
    assert not pool.can_admit(layout.max_len + 1, 0)


def test_serve_launcher_on_cpu():
    """The serve launcher end to end at the reduced size: every request
    finishes and the ragged paged decode agrees with the uncached forward."""
    summary = tserve.main(["--reduced", "--device", "cpu", "--dtype", "float32",
                           "--requests", "4", "--max-new", "4"])
    assert summary["finished"] == summary["requests"] == 4
    # the serving planner's choice at the launcher's defaults on the H100
    assert summary["dispatch"] == tserve.plan(tserve.parse_args([]))[0].dispatch == "ragged"
    assert summary["parity_ragged"] <= 1e-5


def test_serve_launcher_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LanguageModel(get_arch(NAME).reduced()).init_paged_cache(
            PagedLayout(4, 4, 1, 2))
