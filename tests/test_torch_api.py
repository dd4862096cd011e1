"""The last of the reference's API in the port, against the JAX package,
on the CPU (both sides are host code; every comparison is ``==``):

* ``runtime.faults.FaultPlan.random``: the same plan for a seed (NaN
  payloads compared as NaN);
* ``obs``: ``Telemetry.counter`` and ``hist_summary``, the process-global
  telemetry (``get_telemetry``, ``set_telemetry``, ``configure``) and the
  module-level ``span`` / ``instant`` / ``counter`` / ``gauge`` /
  ``histogram``, whose events are the reference's less ``ts`` and ``tid``;
  ``Sink`` and ``RingBufferSink.clear``;
* the trainer's ``train.host_fetches`` counter, whose total is its
  ``host_fetches``;
* ``core.schedule_sim``'s named entry points and ``BY_NAME``;
* ``serving.kv_cache.BlockPool.device_tables``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import schedule_sim as rss
from repro.runtime.faults import FaultPlan as RFaultPlan
from repro.serving import kv_cache as rkv
from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.core import schedule_sim as ss
from repro_torch.data import pipeline as tdata
from repro_torch.models.model import LanguageModel
from repro_torch.optim import optimizer as topt
from repro_torch.runtime.faults import FaultPlan, FaultSpec
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serving import kv_cache as tkv
from repro_torch.training import init_state

# ---------------------------------------------------------------------------
# FaultPlan.random
# ---------------------------------------------------------------------------


def _spec(s):
    return (s.site, s.step, s.count, "nan" if math.isnan(s.payload) else s.payload)


@pytest.mark.parametrize("total", [1, 10, 1000])
def test_fault_plan_random_equals_the_reference(total):
    for seed in range(50):
        mine, ref = FaultPlan.random(seed, total), RFaultPlan.random(seed, total)
        assert mine.seed == ref.seed == seed
        assert [_spec(s) for s in mine.specs] == [_spec(s) for s in ref.specs], seed
        assert all(isinstance(s, FaultSpec) and 0 <= s.step < max(total, 1)
                   for s in mine.specs)
        assert {s.payload for s in mine.specs if s.site == "train.slow_step"} <= {0.05}
    kw = dict(sites=("ckpt.write_fail", "serve.stall"), max_faults=7)
    assert ([_spec(s) for s in FaultPlan.random(3, 20, **kw).specs]
            == [_spec(s) for s in RFaultPlan.random(3, 20, **kw).specs])


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "tid", "dur")} for e in events]


def _record(mod, tel):
    """The same calls on a ``Telemetry`` and through the module helpers."""
    with tel.span("outer", a=1):
        tel.counter("c")
        tel.counter("c", 2.5, why="x")
        tel.instant("i", k=2)
        with tel.span("inner"):
            tel.gauge("g", 3)
        tel.histogram("h", 1.0)
        tel.histogram("h", 4.0, step=1)
    with mod.span("mod.span", b=2):
        mod.counter("mc", 3)
        mod.instant("mi")
        mod.gauge("mg", 0.5)
        mod.histogram("mh", 2.0)


def test_telemetry_events_equal_the_reference():
    """Every kind of event, on a Telemetry and through the module-level
    helpers on a configured global one, less ts, tid and a span's dur."""
    out = []
    for mod in (obs, robs):
        ring = mod.RingBufferSink()
        tel = mod.Telemetry(sinks=[ring])
        prev = mod.get_telemetry()
        assert not prev.enabled  # disabled by default
        glob_ring = mod.RingBufferSink()
        glob = mod.configure(sinks=[glob_ring])
        try:
            assert mod.get_telemetry() is glob
            _record(mod, tel)
        finally:
            assert mod.set_telemetry(prev) is glob
        assert mod.get_telemetry() is prev
        out.append((_strip(ring.events()), _strip(glob_ring.events()), tel.counters,
                    tel.hist_summary("h"), tel.hist_summary("missing"),
                    glob.counters, glob.hist_summary("mh")))
    assert out[0] == out[1]
    events, _, counters, summary, *_ = out[0]
    assert counters == {"c": 3.5}
    assert [e["total"] for e in events if e["kind"] == "counter"] == [1.0, 3.5]
    assert summary == {"n": 2, "min": 1.0, "max": 4.0, "mean": 2.5}


def test_disabled_global_records_nothing():
    ring = obs.RingBufferSink()
    prev = obs.set_telemetry(obs.Telemetry(enabled=False, sinks=[ring]))
    try:
        obs.counter("x")
        obs.gauge("y", 1)
        obs.histogram("z", 1)
        obs.instant("w")
        with obs.span("v"):
            pass
    finally:
        obs.set_telemetry(prev)
    assert len(ring) == 0 and obs.get_telemetry().hist_summary("z") is None


def test_a_closed_telemetry_records_nothing(tmp_path):
    """``close`` closes the sinks and disables the telemetry: a trainer
    that outlives its launcher's telemetry fetches on without writing to
    a closed file."""
    path = tmp_path / "t.jsonl"
    tel = obs.Telemetry(sinks=[obs.JsonlSink(path)])
    tel.counter("c")
    tel.close()
    tel.counter("c")
    tel.histogram("h", 1.0)
    with tel.span("s"):
        pass
    assert not tel.enabled and tel.counters == {"c": 1.0}
    assert len(path.read_text().splitlines()) == 1


def test_sinks_equal_the_reference():
    assert issubclass(obs.RingBufferSink, obs.Sink) and issubclass(obs.JsonlSink, obs.Sink)
    with pytest.raises(NotImplementedError):
        obs.Sink().emit({})
    obs.Sink().close()
    for mod in (obs, robs):
        ring = mod.RingBufferSink(capacity=3)
        for i in range(5):
            ring.emit({"i": i})
        assert [e["i"] for e in ring.events()] == [2, 3, 4] and len(ring) == 3
        ring.clear()
        assert ring.events() == [] and len(ring) == 0


# ---------------------------------------------------------------------------
# The trainer's counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("own", [True, False])
def test_trainer_host_fetch_counter(own):
    """``train.host_fetches`` counter events on the trainer's telemetry, or
    without one on the global telemetry; their total is ``host_fetches``."""
    lm = LanguageModel(get_arch("granite-moe-3b-a800m").reduced())
    ring = obs.RingBufferSink()
    tel = obs.Telemetry(sinks=[ring])
    prev = obs.set_telemetry(obs.Telemetry(enabled=False) if own else tel)
    try:
        trainer = Trainer(lm, topt.OptimizerConfig(lr=1e-3, total_steps=4),
                          TrainerConfig(total_steps=4, log_every=2),
                          log_fn=lambda s: None, telemetry=tel if own else None)
        trainer.fit(init_state(lm, torch.Generator().manual_seed(0), "cpu"),
                    tdata.SyntheticTokens(lm.arch.vocab_size, 2, 16))
    finally:
        obs.set_telemetry(prev)
    ev = [e for e in ring.events() if e["name"] == "train.host_fetches"]
    assert trainer.host_fetches == 4 + 2 == len(ev)
    assert all(e["kind"] == "counter" and e["value"] == 1.0 for e in ev)
    assert ev[-1]["total"] == tel.counters["train.host_fetches"] == trainer.host_fetches


# ---------------------------------------------------------------------------
# schedule_sim's named entry points
# ---------------------------------------------------------------------------


def _result(r):
    """A ScheduleResult's fields, its replayed ops and its schedule IR as
    plain values."""
    return dataclasses.asdict(r)


@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("PP", [2, 4])
def test_schedule_sim_entry_points_equal_the_reference(PP, M, V):
    assert list(ss.BY_NAME) == list(rss.BY_NAME)
    cases = [("gpipe", {}), ("1f1b", {}), ("1f1b_overlap", dict(t_p2p=0.3, t_a2a=0.2)),
             ("zb_h1", {}), ("zb_h1", dict(t_bw=0.7)),
             ("interleaved_1f1b", dict(V=V))]
    for name, kw in cases:
        for times in ({}, dict(t_fwd=1.5, t_bwd=2.5)):
            mine = ss.BY_NAME[name](PP, M, **times, **kw)
            ref = rss.BY_NAME[name](PP, M, **times, **kw)
            assert _result(mine) == _result(ref), (name, kw, times)
    # The conventions: interleaved takes full-stage times over V chunks;
    # zb_h1's Bw defaults to half the backward, so it does 1f1b's work.
    assert ss.interleaved_1f1b(PP, M, V=1).makespan == ss.one_f_one_b(PP, M).makespan
    assert ss.zb_h1(PP, M).makespan <= ss.one_f_one_b(PP, M).makespan
    assert ss.one_f_one_b_overlap(PP, M).makespan == ss.one_f_one_b(PP, M).makespan


# ---------------------------------------------------------------------------
# BlockPool.device_tables
# ---------------------------------------------------------------------------


def test_device_tables_equal_the_pools_arrays():
    kw = dict(num_blocks=12, block_size=4, max_seqs=3, max_blocks_per_seq=5)
    mine = tkv.BlockPool(tkv.PagedLayout(**kw))
    ref = rkv.BlockPool(rkv.PagedLayout(**kw))
    for pool in (mine, ref):
        pool.admit(9)
        pool.admit(3)
        pool.extend(0, 4)
        pool.release(1)
        pool.admit(6)
    bt, lens = mine.device_tables("cpu")
    rbt, rlens = ref.device_tables()
    assert bt.dtype == lens.dtype == torch.int32 and bt.device.type == "cpu"
    np.testing.assert_array_equal(bt.numpy(), mine.block_table)
    np.testing.assert_array_equal(lens.numpy(), mine.lengths)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(rbt))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(rlens))
    # A snapshot: later allocations do not reach it.
    mine.release(0)
    assert not np.array_equal(lens.numpy(), mine.lengths)


def test_device_tables_default_to_the_card():
    pool = tkv.BlockPool(tkv.PagedLayout(num_blocks=4, block_size=4, max_seqs=1,
                                         max_blocks_per_seq=4))
    if torch.cuda.is_available():
        assert pool.device_tables()[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pool.device_tables()
