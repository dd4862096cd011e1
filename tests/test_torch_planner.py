"""The port's resource model, planner, schedule IR, telemetry export and
drift report against the JAX package's, and the launchers' planner and
``--metrics-out`` paths on the CPU.

Both sides are the same pure-Python arithmetic in the same order, so the
tolerance is exact equality (``==`` on every float): a mismatch is a
porting error, not noise.  Only the JAX-free reference modules are
imported (``repro.configs``, ``repro.core.{platform, comm_model,
schedules, resource_model, planner}``, ``repro.obs``).  The reference's
TPU platform is carried into the port's ``Platform`` field by field here,
in the test only: the port itself has no TPU platform.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.configs import get_arch as rget_arch
from repro.core import comm_model as rcm
from repro.core import planner as rpl
from repro.core import platform as rpf
from repro.core import resource_model as rrm
from repro.core import schedules as rsch
from repro_torch import obs
from repro_torch.configs import SCHEDULES, get_arch
from repro_torch.core import comm_model as cm
from repro_torch.core import microbench
from repro_torch.core import planner as pl
from repro_torch.core import platform as pf
from repro_torch.core import resource_model as rm
from repro_torch.core import schedules as sch
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch

ROOT = Path(__file__).resolve().parents[1]
GRANITE, MAMBA = "granite-moe-3b-a800m", "mamba2-370m"
TPU = pf.Platform(**{f.name: getattr(rpf.TPU_V5E, f.name)
                     for f in dataclasses.fields(rpf.Platform)})
# The reference's Platform with the port's H100 constants, so both sides
# price the same card.
R_H100 = rpf.Platform(**{f.name: getattr(pf.H100, f.name)
                         for f in dataclasses.fields(pf.Platform)})
PLATFORMS = {"frontier": (pf.FRONTIER, rpf.FRONTIER), "tpu": (TPU, rpf.TPU_V5E),
             "h100": (pf.H100, R_H100)}


def _archs(name: str, reduced: bool):
    a, r = get_arch(name), rget_arch(name)
    return (a.reduced(), r.reduced()) if reduced else (a, r)


def _shapes(name: str, reduced: bool = False):
    a, r = _archs(name, reduced)
    return rm.ModelShape.from_arch(a), rrm.ModelShape.from_arch(r)


def _same(a, b):
    """Two dataclass instances, or dicts, with equal fields (exact)."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    assert a == b


# ---------------------------------------------------------------------------
# Shapes and platforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", [GRANITE, MAMBA])
def test_model_shape_and_config_counts_equal_the_reference(name, reduced):
    a, r = _archs(name, reduced)
    _same(*_shapes(name, reduced))
    for attr in ("layers", "num_moe_layers", "num_attn_layers", "num_mamba_layers",
                 "pattern_period", "n_mat"):
        assert getattr(a, attr) == getattr(r, attr), attr
    assert a.total_params() == r.total_params()
    assert a.active_params() == r.active_params()
    if a.moe is not None:
        assert a.moe.num_shared_experts == r.moe.num_shared_experts


@pytest.mark.parametrize("plat", sorted(PLATFORMS))
def test_platforms_equal_the_reference(plat):
    mine, ref = PLATFORMS[plat]
    _same(mine, ref)
    assert mine.fast_domain == ref.fast_domain
    assert [mine.gemm_efficiency(d) for d in range(0, 4097)] == \
        [ref.gemm_efficiency(d) for d in range(0, 4097)]


def test_port_has_no_tpu_platform():
    assert {v.name for v in vars(pf).values() if isinstance(v, pf.Platform)} == \
        {"frontier-mi250x", "h100-sxm"}
    for f in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = f.read_text()
        assert "TPU_V5E" not in text and "tpu-v5e" not in text, f


def test_h100_constants_name_their_source():
    """Every H100 field that is not a Platform default has a comment."""
    src = (ROOT / "src" / "repro_torch" / "core" / "platform.py").read_text()
    block = src[src.index("H100 = Platform("):]
    assert "datasheet" in block and "DGX H100" in block and "Assumption" in block
    assert block.count("Measured on the card") == 2 and "full-depth checkpoint" in block
    assert "the Platform defaults" in block


# ---------------------------------------------------------------------------
# Communication model and schedules
# ---------------------------------------------------------------------------

A2A_CASES = [(n, rb) for n in (1, 2, 8, 32, 256, 1024) for rb in (1e3, 2.5e6)]


@pytest.mark.parametrize("plat", sorted(PLATFORMS))
def test_comm_model_equals_the_reference(plat):
    mine, ref = PLATFORMS[plat]
    for n, rb in A2A_CASES:
        c, r = cm.A2ACase(n, rb), rcm.A2ACase(n, rb)
        for f in ("flat_a2a_time", "halo_a2a_time", "speedup"):
            assert getattr(cm, f)(c, mine) == getattr(rcm, f)(r, ref), (f, n, rb)
        for algo in ("flat", "halo"):
            assert cm.a2a_time(c, mine, algo) == rcm.a2a_time(r, ref, algo)
            assert cm.effective_a2a_bandwidth(c, mine, algo) == \
                rcm.effective_a2a_bandwidth(r, ref, algo)
            for k in (1, 2, 4, 8):
                assert cm.chunked_a2a_time(c, mine, algo, k) == \
                    rcm.chunked_a2a_time(r, ref, algo, k)
                for t_comp in (0.0, 1e-4, 3e-2):
                    assert cm.overlapped_layer_time(c, mine, algo, k, t_comp) == \
                        rcm.overlapped_layer_time(r, ref, algo, k, t_comp)
                    assert cm.exposed_a2a_time(c, mine, algo, k, t_comp) == \
                        rcm.exposed_a2a_time(r, ref, algo, k, t_comp)
        for t_comp in (0.0, 1e-4, 3e-2):
            assert cm.best_a2a_config(c, mine, t_comp) == rcm.best_a2a_config(r, ref, t_comp)


def _schedule_cases():
    for name in SCHEDULES:
        for PP in (2, 4):
            for M in (4, 8):
                yield name, PP, M, 2 if name == "interleaved_1f1b" else 1


@pytest.mark.parametrize("name,PP,M,V", list(_schedule_cases()))
def test_schedule_tick_tables_equal_the_reference(name, PP, M, V):
    mine, ref = sch.build(name, PP, M, V), rsch.build(name, PP, M, V)
    sch.check_invariants(mine)
    a, b = sch.tick_tables(mine), rsch.tick_tables(ref)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None and y is None) or np.array_equal(x, y), f.name
    assert (mine.num_ticks, mine.num_slots, mine.num_wslots, mine.has_comm) == \
        (ref.num_ticks, ref.num_slots, ref.num_wslots, ref.has_comm)
    assert np.array_equal(mine.occupancy_trace(), ref.occupancy_trace())


def test_schedule_closed_forms_equal_the_reference():
    for PP in (1, 2, 3, 4, 8):
        for M in (1, 2, 4, 8, 16):
            assert sch.peak_wstash_zb_h1(PP, M) == rsch.peak_wstash_zb_h1(PP, M)
            for V in (1, 2, 4):
                assert sch.peak_activations_interleaved(PP, M, V) == \
                    rsch.peak_activations_interleaved(PP, M, V)


# ---------------------------------------------------------------------------
# Resource model
# ---------------------------------------------------------------------------

TRAIN_SETUPS = [
    dict(b=256, s=4096),
    dict(b=2, s=512, zero="world", dispatch="ragged"),
    dict(b=256, s=4096, PP=4, EP=8, DP=8, zero="world", dispatch="ragged"),
    dict(b=256, s=4096, PP=4, EP=8, DP=8, schedule="gpipe", checkpoint_activations=True),
    dict(b=256, s=4096, PP=4, EP=4, DP=16, schedule="1f1b_overlap", alpha=2),
    dict(b=256, s=4096, PP=4, EP=4, DP=16, schedule="interleaved_1f1b", vstages=2),
    dict(b=256, s=4096, PP=2, EP=8, DP=16, schedule="zb_h1", bytes_per_param=12),
    dict(b=512, s=2048, PP=2, EP=8, DP=32, a2a_algo="halo", a2a_chunks=4,
         dispatch="ragged"),
    dict(b=512, s=2048, EP=40, DP=8, a2a_algo="flat", a2a_chunks=2, imbalance=1.6,
         dispatch="capacity"),
    dict(b=256, s=4096, EP=8, DP=32, replicas=2, zero="none", step_overhead=0.01),
]


@pytest.mark.parametrize("plat", sorted(PLATFORMS))
@pytest.mark.parametrize("name", [GRANITE, MAMBA])
def test_estimate_equals_the_reference(name, plat):
    mine_p, ref_p = PLATFORMS[plat]
    m, r = _shapes(name)
    for kw in TRAIN_SETUPS:
        if r.E and r.E % kw.get("EP", 1):
            continue
        a = rm.estimate(m, rm.TrainSetup(**kw), mine_p, overlap_fraction=0.25)
        b = rrm.estimate(r, rrm.TrainSetup(**kw), ref_p, overlap_fraction=0.25)
        _same(a, b)
        assert rm.modeled_phases(a) == rrm.modeled_phases(b)
    kw = dict(b=256, s=4096, EP=8, DP=32)
    if r.E:
        _same(rm.estimate(m, rm.TrainSetup(**kw), mine_p, imbalance_post=1.1),
              rrm.estimate(r, rrm.TrainSetup(**kw), ref_p, imbalance_post=1.1))


SERVE_SETUPS = [
    dict(batch=4, context=2048, prefill_len=1024),
    dict(batch=4, context=2048, prefill_len=1024, dispatch="ragged"),
    dict(batch=64, context=8192, prefill_len=512, EP=8, TP=2, DP=4, imbalance=1.5),
    dict(batch=256, context=2048, prefill_len=1024, TP=4, DP=4, dispatch="ragged"),
    dict(batch=1, context=32768, prefill_len=32768, EP=4, kv_bytes=1),
]


@pytest.mark.parametrize("plat", sorted(PLATFORMS))
@pytest.mark.parametrize("name", [GRANITE, MAMBA])
def test_serve_estimate_equals_the_reference(name, plat):
    mine_p, ref_p = PLATFORMS[plat]
    m, r = _shapes(name)
    for kw in SERVE_SETUPS:
        if r.E and r.E % kw.get("EP", 1) or not r.E and kw.get("EP", 1) > 1:
            continue
        a = rm.serve_estimate(m, rm.ServeSetup(**kw), mine_p)
        b = rrm.serve_estimate(r, rrm.ServeSetup(**kw), ref_p)
        _same(a, b)
        assert rm.modeled_serve_phases(a) == rrm.modeled_serve_phases(b)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

_RANKED = {}


def _ranked(plat: str, chips: int):
    """Both sides' ranked strategies for granite at ``chips`` chips (batch
    256 x 4096, ZeRO over the world): computed once a process."""
    if (plat, chips) not in _RANKED:
        mine_p, ref_p = PLATFORMS[plat]
        kw = dict(batch=256, seq=4096, zero="world")
        _RANKED[plat, chips] = (
            pl.rank_strategies(pl.valid_strategies(get_arch(GRANITE), mine_p, chips, **kw)),
            rpl.rank_strategies(rpl.valid_strategies(rget_arch(GRANITE), ref_p, chips, **kw)))
    return _RANKED[plat, chips]


@pytest.mark.parametrize("plat,chips", [("tpu", 256), ("frontier", 64)])
def test_ranked_strategies_equal_the_reference(plat, chips):
    mine, ref = _ranked(plat, chips)
    assert len(mine) == len(ref) > 5
    assert [s.describe() for s in mine[:5]] == [s.describe() for s in ref[:5]]
    best = pl.best_strategy(get_arch(GRANITE), PLATFORMS[plat][0], chips, batch=256,
                            seq=4096, zero="world")
    assert best.describe() == mine[0].describe()
    _same(mine[0].estimate, ref[0].estimate)


@pytest.mark.parametrize("plat", sorted(PLATFORMS))
@pytest.mark.parametrize("name", [GRANITE, MAMBA])
def test_best_serving_strategy_equals_the_reference(name, plat):
    mine_p, ref_p = PLATFORMS[plat]
    kw = dict(context=2048, prefill_len=1024, slo_ms=20.0)  # the serve launcher's
    a = pl.best_serving_strategy(get_arch(name), mine_p, 16, **kw)
    b = rpl.best_serving_strategy(rget_arch(name), ref_p, 16, **kw)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.describe() == b.describe()
        _same(a.estimate, b.estimate)


@pytest.mark.parametrize("plat", sorted(PLATFORMS))
def test_min_chips_and_one_chip_plan_equal_the_reference(plat):
    mine_p, ref_p = PLATFORMS[plat]
    kw = dict(batch=64, seq=2048, chip_counts=(1, 2, 4, 8, 16, 32))
    assert pl.min_chips(get_arch(GRANITE), mine_p, **kw) == \
        rpl.min_chips(rget_arch(GRANITE), ref_p, **kw)
    a = pl.best_strategy(get_arch(GRANITE), mine_p, 1, batch=2, seq=512)
    b = rpl.best_strategy(rget_arch(GRANITE), ref_p, 1, batch=2, seq=512)
    assert (a and a.describe()) == (b and b.describe())  # None where nothing fits


def test_h100_one_chip_plan_fits():
    """The training phase's shape on one H100: a plan that fits, and the
    planner's choice of dispatch there (capacity) differs from its
    production choice (ragged), as the reference's does on its platforms."""
    best = pl.best_strategy(get_arch(GRANITE), pf.H100, 1, batch=2, seq=512)
    assert best.estimate.mem_ok and best.world == 1
    assert best.dispatch == "capacity"
    assert train_launch.production_strategy(GRANITE, pf.H100).dispatch == "ragged"


# ---------------------------------------------------------------------------
# Observability: sinks, Chrome trace, drift
# ---------------------------------------------------------------------------


def _events():
    """One event list from the port's Telemetry: nested spans, an
    instant, a gauge and a histogram, attrs with a tuple."""
    ring = obs.RingBufferSink()
    tel = obs.Telemetry(sinks=[ring])
    for step in range(3):
        with tel.span("train.step", step=step) as sp:
            with tel.span("train.data", step=step):
                pass
            sp.set(skipped=False)
        tel.histogram("train.step_s", 0.1 * (step + 1), step=step)
    with tel.span("ckpt.save", step=2, bytes=1 << 20):
        pass
    with tel.span("engine.decode", step=3, rids=(0, 1)):
        pass
    tel.instant("engine.preempt", rid=1)
    tel.gauge("train.loss", 6.25, step=2)
    return ring.events()


def test_jsonl_sink_round_trip_equals_the_reference(tmp_path):
    events = _events()
    mine, ref = obs.JsonlSink(tmp_path / "a.jsonl"), robs.JsonlSink(tmp_path / "b.jsonl")
    for e in events:
        mine.emit(e)
        ref.emit(e)
    mine.close()
    ref.close()
    mine.close()  # closing twice is harmless
    text = (tmp_path / "a.jsonl").read_text()
    assert text == (tmp_path / "b.jsonl").read_text()
    back = [json.loads(line) for line in text.splitlines()]
    assert len(back) == len(events)
    assert back[-3]["attrs"]["rids"] == [0, 1]
    assert [b["name"] for b in back] == [e["name"] for e in events]


def test_chrome_trace_equals_the_reference(tmp_path):
    events = _events()
    mine = obs.chrome_trace(events, process_name="train x")
    assert mine == robs.chrome_trace(events, process_name="train x")
    obs.validate_chrome_trace(mine)
    written = obs.write_chrome_trace(tmp_path / "t.json", events, process_name="p")
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(json.dumps(written))
    for name, PP, M, V in [("1f1b", 2, 4, 1), ("1f1b_overlap", 4, 8, 1),
                           ("interleaved_1f1b", 2, 4, 2)]:
        lanes = obs.schedule_lane_events(sch.build(name, PP, M, V), 1e-3)
        assert lanes == robs.schedule_lane_events(rsch.build(name, PP, M, V), 1e-3)


MALFORMED = [
    [],
    {"events": []},
    {"traceEvents": {}},
    {"traceEvents": [1]},
    {"traceEvents": [{"ph": "Z"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "i", "name": "a", "ts": 0, "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": "0", "dur": 1, "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "C", "name": "a", "ts": 0, "pid": 1, "tid": 0, "args": 3}]},
    {"traceEvents": [{"ph": "M", "name": "a", "pid": 1, "tid": 0}]},
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_validate_chrome_trace_rejects_what_the_reference_rejects(i):
    with pytest.raises(ValueError) as ref:
        robs.validate_chrome_trace(MALFORMED[i])
    with pytest.raises(ValueError) as mine:
        obs.validate_chrome_trace(MALFORMED[i])
    assert str(mine.value) == str(ref.value)


def test_drift_tracker_equals_the_reference():
    events = _events() + [{"kind": "span", "name": "engine.prefill", "dur": d}
                          for d in (0.5, 0.25, 0.125)]
    m, r = _shapes(GRANITE)
    t_kw = dict(b=2, s=512, zero="world", dispatch="ragged")
    s_kw = dict(batch=4, context=2048, prefill_len=1024, dispatch="ragged")
    pairs = [
        (obs.DriftTracker.for_train(m, rm.TrainSetup(**t_kw), pf.H100),
         robs.DriftTracker.for_train(r, rrm.TrainSetup(**t_kw), R_H100)),
        (obs.DriftTracker.for_serve(m, rm.ServeSetup(**s_kw), pf.H100, warmup=0),
         robs.DriftTracker.for_serve(r, rrm.ServeSetup(**s_kw), R_H100, warmup=0)),
        (obs.DriftTracker({"step": 0.5, "ckpt": 0.0}, warmup=2),
         robs.DriftTracker({"step": 0.5, "ckpt": 0.0}, warmup=2)),
    ]
    assert obs.SPAN_PHASES == robs.SPAN_PHASES
    for mine, ref in pairs:
        assert mine.observe_events(events) == ref.observe_events(events)
        mine.record("ckpt", 1.5)
        ref.record("ckpt", 1.5)
        assert mine.observe_events(events, {"train.data": "data"}) == \
            ref.observe_events(events, {"train.data": "data"})
        assert mine.report() == ref.report()
        assert mine.format_report("t") == ref.format_report("t")
    assert pairs[0][0].report()["step"]["n"] == 2


# ---------------------------------------------------------------------------
# Micro-benchmarks on the CPU
# ---------------------------------------------------------------------------


def test_microbench_rows_on_the_cpu():
    """The reference's row keys (``repro/core/microbench.py``), finite and
    positive, at tiny sizes on the host clock."""
    rows = microbench.expert_gemm_curve(64, 128, (16, 32), device="cpu")
    assert [r["d_ffn"] for r in rows] == [16, 32]
    att = microbench.attention_curve(64, 4, (16, 32), dtype=torch.bfloat16, device="cpu")
    assert [r["seq"] for r in att] == [16, 32]
    for r in rows:
        assert set(r) == {"d_ffn", "seconds", "gflops", "efficiency"}
    for r in att:
        assert set(r) == {"seq", "seconds", "gflops"}
    for r in rows + att:
        assert all(np.isfinite(v) and v > 0 for v in r.values()), r
    sec, gflops = microbench.gemm_throughput(32, 16, 8, device="cpu")
    assert sec > 0 and gflops == pytest.approx(2 * 32 * 16 * 8 / sec / 1e9)


def test_microbench_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        microbench.gemm_throughput(8, 8, 8)


# ---------------------------------------------------------------------------
# The launchers on the CPU
# ---------------------------------------------------------------------------


def _trace_ok(path: str) -> None:
    trace = json.loads(Path(path).read_text())
    obs.validate_chrome_trace(trace)
    robs.validate_chrome_trace(trace)
    assert any(e.get("name") for e in trace["traceEvents"] if e["ph"] == "X")


def test_train_launcher_metrics_out(tmp_path, capsys):
    out = tmp_path / "m.jsonl"
    s = train_launch.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                           "--seq", "16", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    _trace_ok(s["trace"])
    assert s["trace"] == str(out) + ".trace.json"
    assert s["drift"]["step"]["n"] == 2 and s["drift"]["step"]["ratio"] > 0
    names = [json.loads(line)["name"] for line in out.read_text().splitlines()]
    assert names.count("train.step") == 3
    assert "[planner] production-strategy for granite-moe-3b-a800m @256xh100-sxm:" in text
    assert "[planner] schedule zb_h1 vstages 1 (the planner's choice): bound with " \
        "--pipeline; this run is PP = 1" in text
    assert "== drift granite-moe-3b-a800m-reduced" in text
    assert "mem_stage0" in text and "[obs]" in text
    assert s["dispatch"] == "ragged"  # the H100 production strategy's


def test_train_launcher_binds_the_reference_planners_choices(monkeypatch, capsys):
    """With the launcher's platform set to the reference's TPU platform,
    the dispatch and checkpoint interval it binds are what the reference
    launcher derives from the reference planner for the same call."""
    monkeypatch.setattr(train_launch, "PLATFORM", TPU)
    s = train_launch.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                           "--seq", "16"])
    text = capsys.readouterr().out
    ref = _ranked("tpu", 256)[1][0]
    e = ref.estimate
    assert s["dispatch"] == ref.dispatch
    assert s["ckpt_every"] == min(max(e.ckpt_every_steps, 1), max(3 // 2, 1))
    assert (f"(Young-Daly: t_ckpt={e.t_ckpt:.1f}s tau={e.ckpt_interval_s:.0f}s "
            f"goodput={e.goodput_factor * 100:.2f}%)") in text
    assert "          " + ref.describe() in text
    # an explicit flag wins over the planner
    s = train_launch.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "16", "--dispatch", "capacity", "--ckpt-every", "7"])
    assert s["dispatch"] == "capacity" and s["ckpt_every"] == 7


def test_serve_launcher_metrics_out(tmp_path, capsys):
    out = tmp_path / "s.jsonl"
    s = serve_launch.main(["--reduced", "--device", "cpu", "--dtype", "float32",
                           "--requests", "4", "--max-new", "4", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    _trace_ok(s["trace"])
    assert s["drift"]["decode"]["n"] > 0 and s["drift"]["prefill"]["n"] > 0
    assert "[planner] serving strategy for granite-moe-3b-a800m @16xh100-sxm" in text
    assert "== drift granite-moe-3b-a800m-reduced serving" in text
    names = [json.loads(line)["name"] for line in out.read_text().splitlines()]
    assert "engine.decode" in names and "engine.prefill" in names


def test_serve_launcher_binds_the_reference_planners_choices(monkeypatch, capsys):
    monkeypatch.setattr(serve_launch, "PLATFORM", TPU)
    ref = rpl.best_serving_strategy(rget_arch(GRANITE), rpf.TPU_V5E, 16, context=2048,
                                    prefill_len=1024, slo_ms=20.0)
    args = ["--reduced", "--device", "cpu", "--dtype", "float32", "--requests", "3",
            "--max-new", "2"]
    for cap in (1, 4, 1024):
        s = serve_launch.main(args + ["--max-seqs", str(cap)])
        assert s["dispatch"] == ref.dispatch
        assert s["max_seqs"] == max(1, min(ref.batch, cap))
    assert "          " + ref.describe() in capsys.readouterr().out
