"""The port's checkpointing and recovery layer, on the CPU.

* The reference's checkpoint-integrity cases (``tests/test_faults.py``) on
  the port's format: async write failures re-raise, a crash before or
  after the rename, a flipped bit or a truncated file is quarantined
  (never deleted) and the restore falls back, retention keeps ``keep``.
* The trainer's recovery paths, port against port and bit for bit against
  the uninterrupted run on the reduced granite-moe-3b-a800m: NaN x 3 ->
  rollback, the rollback budget, SIGTERM -> final save -> resume (in a
  child process: a SIGTERM reaching a test worker with no handler would
  kill it), and ``launch/train.py --ckpt-dir``.  On the CPU every kernel
  wrapper runs its plain version, and the same steps give the same bits.
* One fault plan against the JAX trainer, fp32 compute on both sides: the
  same anomalies, rollbacks and last step, and the params within
  ``test_torch_training.py::test_three_step_trajectory_matches_reference``'s
  tolerance (1e-4 for all, 1e-6 for all but 0.1 %; moments 1e-6), since the
  plan's three applied updates are that test's three steps.
* Telemetry from the checkpoint writer's thread keeps its own span stack.

Run as a script (``python tests/test_torch_checkpoint.py sigterm-child``)
this file is the SIGTERM test's child.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.checkpoint import checkpointing
from repro_torch.checkpoint import (
    CheckpointCorruptError, CheckpointManager, checkpoint_steps, cleanup_stale_tmp,
    leaf_crc32s, read_extras, restore_checkpoint, save_checkpoint, verify_checkpoint,
)
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as train_launch
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime.faults import (
    FaultInjector, FaultPlan, FaultSpec, InjectedWriteError, SimulatedCrash,
)
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.training import init_state, make_train_step

NAME = "granite-moe-3b-a800m"
ROOT = Path(__file__).resolve().parents[1]


def quiet(_msg):
    pass


def _state(v=0.0):
    return {"params": {"w": torch.arange(12.0).reshape(3, 4) + v,
                       "t": (torch.arange(5, dtype=torch.int32),)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _plan(*specs):
    return FaultInjector(FaultPlan(list(specs)), log_fn=quiet)


def _assert_state_equal(got, want):
    g, w = tree_paths(got), tree_paths(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


# ---------------------------------------------------------------------------
# Checkpoint integrity
# ---------------------------------------------------------------------------


def test_layout_manifest_and_in_place_restore(tmp_path):
    """step_<8 digits>/ holds a JSON manifest, its digest and one .npy a
    leaf; restore writes into the live tensors (same storage) and the
    live CRCs then equal the manifest's."""
    path = save_checkpoint(tmp_path, 3, _state(1.0), extras={"note": "x"})
    assert path.name == "step_00000003"
    assert sorted(p.name for p in path.iterdir()) == [
        "manifest.crc32", "manifest.json", "params.t.0.npy", "params.w.npy", "step.npy"]
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 3 and manifest["keys"] == ["params/w", "params/t/0", "step"]
    assert manifest["dtypes"] == {"params/w": "float32", "params/t/0": "int32",
                                  "step": "int32"}
    assert manifest["crc32"] == leaf_crc32s(_state(1.0))
    assert read_extras(tmp_path, 3) == {"note": "x"}
    live = _state()
    ptrs = {k: t.data_ptr() for k, t in tree_paths(live).items()}
    restored, step = restore_checkpoint(tmp_path, live, log_fn=quiet)
    assert step == 3 and restored is live
    assert {k: t.data_ptr() for k, t in tree_paths(live).items()} == ptrs
    _assert_state_equal(live, _state(1.0))
    assert live["step"].device.type == "cpu" and int(live["step"]) == 7
    assert leaf_crc32s(live) == manifest["crc32"]


def test_threaded_crcs_equal_one_threads(tmp_path):
    """The manifest's CRC32 map, made on ``CRC_THREADS`` threads, and
    ``leaf_crc32s`` equal one thread's ``zlib.crc32`` of every leaf's host
    bytes (bf16 bits, large and small leaves); the threaded verify still
    names the first bad leaf in key order."""
    import zlib

    g = torch.Generator().manual_seed(0)
    state = {"big": {str(i): torch.randn(257, 1031, generator=g) for i in range(6)},
             "m": torch.randn(4099, generator=g).to(torch.bfloat16),
             "small": torch.arange(3, dtype=torch.int32), "step": torch.tensor(2)}
    one = {k: zlib.crc32(np.ascontiguousarray(a).data)
           for k, a in checkpointing.snapshot(state).items()}
    assert checkpointing.CRC_THREADS > 1
    path = save_checkpoint(tmp_path, 1, state)
    assert json.loads((path / "manifest.json").read_text())["crc32"] == one
    assert leaf_crc32s(state) == one
    assert verify_checkpoint(path) == (True, "ok")
    for key in ("big/4", "big/1"):  # both bad: big/1 comes first
        f = path / f"{key.replace('/', '.')}.npy"
        raw = bytearray(f.read_bytes())
        raw[-1] ^= 0xFF
        f.write_bytes(bytes(raw))
    assert verify_checkpoint(path) == (False, "crc32 mismatch for 'big/1'")


@pytest.mark.parametrize("bad", ["shape", "dtype", "key"])
def test_restore_refuses_a_mismatched_state_before_writing(tmp_path, bad):
    save_checkpoint(tmp_path, 1, _state(1.0))
    live = _state()
    if bad == "shape":
        live["params"]["w"] = torch.zeros(4, 3)
    elif bad == "dtype":
        live["params"]["w"] = torch.zeros(3, 4, dtype=torch.float64)
    else:
        live["params"]["extra"] = torch.zeros(2)
    before = {k: t.clone() for k, t in tree_paths(live).items()}
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, live, log_fn=quiet)
    _assert_state_equal(live, before)


@pytest.mark.parametrize("blocking", [True, False])
def test_bf16_moments_restore_bitwise(tmp_path, blocking):
    """A train state with bf16 Adam moments saves (each bf16 leaf as its
    16-bit patterns, manifest dtype "bfloat16"), verifies and restores bit
    for bit, and its live CRC32s equal the manifest's."""
    from repro_torch import sharding

    arch = get_arch(NAME).reduced()
    lm = LanguageModel(arch, sharding.single_device_plan(arch, optimizer_dtype="bfloat16"))
    state = init_state(lm, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for t in ("m", "v"):
        for leaf in tree_paths(state[t]).values():
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=gen).to(torch.bfloat16))
    assert state["m"]["embed"].dtype == torch.bfloat16
    mgr = CheckpointManager(tmp_path, log_fn=quiet)
    mgr.save(3, state, blocking=blocking)
    mgr.wait()
    path = tmp_path / "step_00000003"
    assert verify_checkpoint(path) == (True, "ok")
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["dtypes"]["m/embed"] == "bfloat16"
    assert manifest["dtypes"]["params/embed"] == "float32"
    assert manifest["crc32"] == leaf_crc32s(state)
    fresh = init_state(lm, torch.Generator().manual_seed(2), "cpu")
    fresh, step = mgr.restore_latest(fresh)
    assert step == 3
    _assert_state_equal(fresh, state)
    assert leaf_crc32s(fresh) == manifest["crc32"]
    # The same bits in fp32 are another checkpoint: refused by dtype.
    wide = init_state(LanguageModel(arch), torch.Generator().manual_seed(2), "cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore_latest(wide)



@pytest.mark.parametrize("where", ["wait", "next_save"])
def test_async_write_failure_reraises(tmp_path, where):
    """A failed async write re-raises on the next wait() or save(), once;
    the manager keeps working after it."""
    mgr = CheckpointManager(tmp_path, every=1, injector=_plan(FaultSpec("ckpt.write_fail", 1)),
                            log_fn=quiet)
    mgr.save(1, _state(), blocking=False)
    with pytest.raises(InjectedWriteError):
        if where == "wait":
            mgr.wait()
        else:
            mgr.save(2, _state(), blocking=False)
    mgr.save(3, _state(), blocking=False)  # the spec is spent: this one lands
    mgr.wait()
    assert checkpoint_steps(tmp_path) == [3]


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The state is copied to the host before save() returns: an in-place
    update made while the write waits (as the next AdamW step makes) is
    not written."""
    updated = threading.Event()
    real = checkpointing.save_checkpoint

    def save_after_update(*a, **k):
        assert updated.wait(timeout=10)
        return real(*a, **k)

    monkeypatch.setattr(checkpointing, "save_checkpoint", save_after_update)
    mgr = CheckpointManager(tmp_path, every=1, log_fn=quiet)
    state = _state(1.0)
    mgr.save(1, state, blocking=False)
    state["params"]["w"].mul_(-1.0)
    state["step"].add_(1)
    updated.set()
    mgr.wait()
    live = _state()
    mgr.restore_latest(live)
    _assert_state_equal(live, _state(1.0))


def test_crash_before_rename_previous_survives(tmp_path):
    save_checkpoint(tmp_path, 1, _state(1.0))
    with pytest.raises(SimulatedCrash):
        save_checkpoint(tmp_path, 2, _state(2.0),
                        injector=_plan(FaultSpec("ckpt.crash_before_rename", 2)))
    # The half-written dir is a .tmp leftover, not a checkpoint.
    assert checkpoint_steps(tmp_path) == [1]
    assert (tmp_path / "step_00000002.tmp").exists()
    live = _state()
    _, step = restore_checkpoint(tmp_path, live, log_fn=quiet)
    assert step == 1
    _assert_state_equal(live, _state(1.0))
    assert cleanup_stale_tmp(tmp_path) == ["step_00000002.tmp"]
    assert not (tmp_path / "step_00000002.tmp").exists()


def test_crash_after_rename_checkpoint_complete(tmp_path):
    with pytest.raises(SimulatedCrash):
        save_checkpoint(tmp_path, 1, _state(1.0),
                        injector=_plan(FaultSpec("ckpt.crash_after_rename", 1)))
    ok, reason = verify_checkpoint(tmp_path / "step_00000001")
    assert ok, reason
    _, step = restore_checkpoint(tmp_path, _state(), log_fn=quiet)
    assert step == 1


def _flip_leaf_byte(path):
    f = path / "params.w.npy"
    blob = bytearray(f.read_bytes())
    blob[-5] ^= 0xFF  # inside the data, past the .npy header
    f.write_bytes(bytes(blob))


def _truncate(name):
    def corrupt(path):
        f = path / name
        f.write_bytes(f.read_bytes()[:-3])
    return corrupt


@pytest.mark.parametrize("corrupt,reason", [
    (_flip_leaf_byte, "crc32 mismatch for 'params/w'"),
    (_truncate("params.w.npy"), "'params/w' unreadable"),
    (lambda p: (p / "step.npy").unlink(), "missing array 'step'"),
    (_truncate("manifest.json"), "manifest digest mismatch"),
    (lambda p: (p / "manifest.crc32").write_text("12345"), "manifest digest mismatch"),
    (lambda p: (p / "manifest.crc32").unlink(), "missing manifest.crc32"),
], ids=["bitflip", "truncated-leaf", "missing-leaf", "truncated-manifest", "bad-digest",
        "missing-digest"])
def test_corruption_quarantined_and_fallback(tmp_path, corrupt, reason):
    """A corrupted checkpoint is detected, quarantined with its reason
    (never deleted), and the restore falls back to the newest intact one."""
    save_checkpoint(tmp_path, 1, _state(1.0))
    save_checkpoint(tmp_path, 2, _state(2.0))
    corrupt(tmp_path / "step_00000002")
    ok, why = verify_checkpoint(tmp_path / "step_00000002")
    assert not ok and reason in why, why
    logs = []
    live = _state()
    _, step = restore_checkpoint(tmp_path, live, log_fn=logs.append)
    assert step == 1
    _assert_state_equal(live, _state(1.0))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000001", "step_00000002.corrupt"]
    assert (tmp_path / "step_00000002.corrupt" / "QUARANTINE_REASON").read_text() == why + "\n"
    assert checkpoint_steps(tmp_path) == [1] and "quarantined" in logs[0]
    assert logs[1].startswith("[ckpt] restored step 1: verified in ")


def test_explicit_corrupt_step_raises(tmp_path):
    """An explicitly requested step never restores something else, but is
    still quarantined; a second quarantine of that step gets .corrupt.1."""
    for _ in range(2):
        save_checkpoint(tmp_path, 1, _state(1.0))
        save_checkpoint(tmp_path, 2, _state(2.0))
        (tmp_path / "step_00000002" / "manifest.crc32").write_text("12345")
        live = _state()
        with pytest.raises(CheckpointCorruptError):
            restore_checkpoint(tmp_path, live, step=2, log_fn=quiet)
        _assert_state_equal(live, _state())
        assert checkpoint_steps(tmp_path) == [1]
    assert (tmp_path / "step_00000002.corrupt.1").is_dir()


def test_no_intact_checkpoint_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_checkpoint(tmp_path, _state(), log_fn=quiet)
    save_checkpoint(tmp_path, 1, _state(1.0))
    _flip_leaf_byte(tmp_path / "step_00000001")
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        restore_checkpoint(tmp_path, _state(), log_fn=quiet)


def test_retention_keeps_keep(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, every=1, log_fn=quiet)
    for s in range(1, 6):
        mgr.save(s, _state(float(s)), blocking=s % 2 == 0)
    mgr.wait()
    assert checkpoint_steps(tmp_path) == [4, 5]
    live = _state()
    assert mgr.restore_latest(live)[1] == 5
    _assert_state_equal(live, _state(5.0))


def test_checkpoint_spans(tmp_path):
    """ckpt.snapshot and ckpt.save (with bytes and the split of its
    seconds, from the writer thread), ckpt.verify and ckpt.restore."""
    ring = obs.RingBufferSink()
    mgr = CheckpointManager(tmp_path, every=1, log_fn=quiet,
                            telemetry=obs.Telemetry(sinks=[ring]))
    mgr.save(1, _state(1.0), blocking=False)
    mgr.wait()
    mgr.restore_latest(_state())
    spans = {e["name"]: e for e in ring.events() if e["kind"] == "span"}
    assert list(spans) == ["ckpt.snapshot", "ckpt.save", "ckpt.verify", "ckpt.restore"]
    nbytes = 12 * 4 + 5 * 4 + 4
    assert spans["ckpt.snapshot"]["attrs"]["bytes"] == spans["ckpt.save"]["attrs"]["bytes"] == nbytes
    assert {"crc_s", "write_s"} <= set(spans["ckpt.save"]["attrs"])
    assert spans["ckpt.save"]["tid"] != spans["ckpt.snapshot"]["tid"]
    assert all(e["attrs"]["step"] == 1 for e in spans.values())


# ---------------------------------------------------------------------------
# Telemetry across threads
# ---------------------------------------------------------------------------


def test_spans_keep_their_threads_depth_and_parent():
    """A span open on the writer thread is no parent of the main thread's
    spans, and the other way round, though all four are open at once."""
    ring = obs.RingBufferSink()
    tel = obs.Telemetry(sinks=[ring])
    both_open = threading.Barrier(2, timeout=10)

    def writer():
        with tel.span("ckpt.save"):
            both_open.wait()
            with tel.span("ckpt.write"):
                both_open.wait()

    t = threading.Thread(target=writer)
    t.start()
    with tel.span("train.step"):
        both_open.wait()
        with tel.span("train.data"):
            both_open.wait()
            tel.instant("train.anomaly")
    t.join(timeout=10)
    assert not t.is_alive()
    ev = {e["name"]: e for e in ring.events()}
    assert (ev["ckpt.save"]["depth"], ev["ckpt.save"]["parent"]) == (0, None)
    assert (ev["ckpt.write"]["depth"], ev["ckpt.write"]["parent"]) == (1, "ckpt.save")
    assert (ev["train.step"]["depth"], ev["train.step"]["parent"]) == (0, None)
    assert (ev["train.data"]["depth"], ev["train.data"]["parent"]) == (1, "train.step")
    assert (ev["train.anomaly"]["depth"], ev["train.anomaly"]["parent"]) == (2, "train.data")
    assert ev["ckpt.save"]["tid"] == ev["ckpt.write"]["tid"] == t.ident
    assert ev["train.step"]["tid"] == ev["train.anomaly"]["tid"] == threading.get_ident()


def test_histograms_lose_no_sample_under_thread_switches():
    ring = obs.RingBufferSink()
    tel = obs.Telemetry(sinks=[ring])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tel.histogram("h", 1.0)
                                                    for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(tel.hists["h"]) == len(ring.events()) == 16000


# ---------------------------------------------------------------------------
# The trainer's recovery paths, port against port, bit for bit
# ---------------------------------------------------------------------------


def _run(total, ckpt_dir=None, injector=None, seed=0, **cfg):
    """Train the reduced granite for ``total`` steps on the CPU; returns
    (trainer, fit output)."""
    lm = LanguageModel(get_arch(NAME).reduced())
    trainer = Trainer(lm, OptimizerConfig(lr=1e-3, total_steps=total),
                      TrainerConfig(total_steps=total, checkpoint_dir=ckpt_dir,
                                    checkpoint_every=4, log_every=1000, **cfg),
                      log_fn=quiet, injector=injector)
    state = init_state(lm, torch.Generator().manual_seed(seed), "cpu")
    return trainer, trainer.fit(state, SyntheticTokens(lm.arch.vocab_size, 2, 16))


@pytest.fixture(scope="module")
def oracle():
    """The uninterrupted 12-step run, no checkpoint."""
    return _run(12)[1]


def test_nan_rollback_matches_fault_free_oracle(tmp_path, oracle):
    """NaN x 3 -> three skips -> rollback to step 4 -> the re-trained steps
    reproduce the uninterrupted run bit for bit (the spent spec does not
    fire again); every restore leaves the live CRCs equal to the
    manifest's."""
    inj = _plan(FaultSpec("train.nonfinite", step=5, count=3))
    trainer, out = _run(12, tmp_path, inj)
    assert inj.fired("train.nonfinite") == 3
    assert [a["step"] for a in out["anomalies"]] == [5, 6, 7]
    assert all(not np.isfinite(a["loss"]) for a in out["anomalies"])
    assert out["rollbacks"] == [{"at_step": 7, "to_step": 4}]
    assert out["last_step"] == 11 and int(out["state"]["step"]) == 12
    _assert_state_equal(out["state"], oracle["state"])
    assert torch.equal(out["metrics"]["loss"], oracle["metrics"]["loss"])
    assert checkpoint_steps(tmp_path) == [4, 8, 12]
    manifest = json.loads((tmp_path / "step_00000012" / "manifest.json").read_text())
    assert manifest["crc32"] == leaf_crc32s(out["state"])


def test_rollback_with_no_intact_checkpoint_raises(tmp_path):
    inj = _plan(FaultSpec("train.nonfinite", step=1, count=3))
    with pytest.raises(RuntimeError, match="no intact checkpoint exists"):
        _run(8, tmp_path, inj)


def test_rollback_budget_exhausts(tmp_path):
    """Anomalies that outlast the budget surface instead of looping."""
    inj = _plan(FaultSpec("train.nonfinite", step=5, count=100))
    with pytest.raises(RuntimeError, match="budget exhausted"):
        _run(12, tmp_path, inj, anomaly_rollback_after=2, max_rollbacks=2)
    assert inj.fired("train.nonfinite") == 2 * 3


def test_checkpointed_run_keeps_the_host_fetch_cadence(tmp_path):
    """Checkpoints add no blocking fetch of a metric: one a step, and the
    loss on the one log step (0)."""
    trainer, out = _run(8, tmp_path)
    assert trainer.host_fetches == 8 + 1 and trainer.resumed_from is None
    assert checkpoint_steps(tmp_path) == [4, 8]


def _sigterm_child() -> dict:
    """SIGTERM at step 9 -> final save at 9 -> a fresh trainer on a state
    from another seed resumes and ends bit for bit where the uninterrupted
    run does; the handler in place before each fit is back after it."""
    import tempfile

    def marker(signum, frame):
        pass

    signal.signal(signal.SIGTERM, marker)
    results = {}
    _, oracle = _run(12)
    results["handler_restored_after_plain_run"] = signal.getsignal(signal.SIGTERM) is marker
    with tempfile.TemporaryDirectory() as d:
        inj = _plan(FaultSpec("train.sigterm", step=9))
        _, pre = _run(12, d, inj)
        results["sigterm_fired"] = inj.fired("train.sigterm") == 1
        results["stopped_at_9"] = pre["last_step"] == 8 and int(pre["state"]["step"]) == 9
        results["saved_9"] = checkpoint_steps(d) == [4, 8, 9]
        results["handler_restored"] = signal.getsignal(signal.SIGTERM) is marker
        trainer, resumed = _run(12, d, seed=1)
        results["resumed_from_9"] = trainer.resumed_from == 9 and len(trainer.step_times) == 3
        results["resume_bitexact"] = all(
            torch.equal(a, b) for a, b in zip(tree_paths(resumed["state"]).values(),
                                              tree_paths(oracle["state"]).values()))
        results["loss_bitexact"] = torch.equal(resumed["metrics"]["loss"],
                                               oracle["metrics"]["loss"])
    return results


def test_sigterm_preemption_resume_bitexact():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, __file__, "sigterm-child"], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    assert results and all(results.values()), results


def test_launcher_resume_equals_one_run(tmp_path, capsys):
    """``--ckpt-dir``: 4 steps, then a rerun with ``--steps 6`` that resumes
    at 4, equals one 6-step run bit for bit (the warm-up of 100 steps makes
    the learning rate independent of ``--steps`` here)."""
    base = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16"]
    ck = ["--ckpt-dir", str(tmp_path)]
    first, _, _ = train_launch.train(train_launch.parse_args(base + ck + ["--steps", "4"]))
    second, _, out = train_launch.train(train_launch.parse_args(base + ck + ["--steps", "6"]))
    whole, _, want = train_launch.train(train_launch.parse_args(base + ["--steps", "6"]))
    assert first["resumed_from"] is None and second["resumed_from"] == 4
    assert second["steps"] == 2 and second["rollbacks"] == []
    assert [s["step"] for s in second["ckpt"]["ckpt.restore"]] == [4]
    assert second["ckpt"]["ckpt.save"][-1]["bytes"] > 0
    assert "ckpt" not in whole
    _assert_state_equal(out["state"], want["state"])
    assert second["loss"] == whole["loss"]
    # --ckpt-every defaults to the planner's Young-Daly interval clamped to
    # [1, steps/2]: every 2 steps in the 4-step run, every 3 in the 6-step one
    assert first["ckpt_every"] == 2 and second["ckpt_every"] == 3
    assert checkpoint_steps(tmp_path) == [2, 4, 6]
    assert "[ckpt] ckpt.restore step 4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The same fault plan on the JAX trainer
# ---------------------------------------------------------------------------


def test_rollback_matches_the_jax_trainer(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro import training as jtraining
    from repro.configs import get_arch as jget_arch
    from repro.data import SyntheticTokens as JTokens
    from repro.models.model import LanguageModel as JLM
    from repro.optim import OptimizerConfig as JOpt
    from repro.runtime import Trainer as JTrainer, TrainerConfig as JTrainerConfig
    from repro.runtime.faults import (FaultInjector as JInjector, FaultPlan as JPlan,
                                      FaultSpec as JSpec)
    from repro.sharding import single_device_plan
    from repro_torch.convert import state_from_numpy, state_to_numpy

    arch_j = jget_arch(NAME).reduced()
    jplan = dataclasses.replace(single_device_plan(arch_j), compute_dtype="float32")
    lm_j = JLM(arch_j, jplan)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    # Step 0 applies and is saved as step 1; steps 1 and 2 are NaN, the
    # second skip rolls back to 1; steps 1 and 2 then apply: three updates
    # on batches 0, 1, 2, the 3-step trajectory's.
    cfg = dict(total_steps=3, checkpoint_every=1, anomaly_rollback_after=2, log_every=1000)
    spec = dict(site="train.nonfinite", step=1, count=2)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        with jplan.mesh:
            state_j = jtraining.init_state(lm_j, jax.random.PRNGKey(0), JOpt())
            state_np = jax.tree.map(np.asarray, state_j)
            jtrainer = JTrainer(lm_j, JOpt(**opt_kw),
                                JTrainerConfig(checkpoint_dir=str(tmp_path / "jax"), **cfg),
                                log_fn=quiet, injector=JInjector(JPlan([JSpec(**spec)]),
                                                                 log_fn=quiet))
            want = jtrainer.fit(jax.tree.map(jnp.asarray, state_np),
                                JTokens(arch_j.vocab_size, 2, 32))
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    lm = LanguageModel(get_arch(NAME).reduced())
    opt = OptimizerConfig(**opt_kw)
    trainer = Trainer(lm, opt, TrainerConfig(checkpoint_dir=str(tmp_path / "port"), **cfg),
                      log_fn=quiet, injector=_plan(FaultSpec(**spec)))
    trainer.train_step = make_train_step(lm, opt, compute_dtype=torch.float32,
                                         fetch=trainer._fetch)
    got = trainer.fit(state_from_numpy(state_np, "cpu"),
                      SyntheticTokens(lm.arch.vocab_size, 2, 32))
    assert [a["step"] for a in got["anomalies"]] == [a["step"] for a in want["anomalies"]] \
        == [1, 2]
    assert not any(np.isfinite(a["loss"]) for a in got["anomalies"] + want["anomalies"])
    assert got["rollbacks"] == want["rollbacks"] == [{"at_step": 2, "to_step": 1}]
    assert got["last_step"] == want["last_step"] == 2
    got_np, want_np = state_to_numpy(got["state"]), jax.tree.map(np.asarray, want["state"])
    assert int(got_np["step"]) == int(want_np["step"]) == 3
    for part in ("m", "v"):
        want_p = tree_paths(want_np[part])
        for path, a in tree_paths(got_np[part]).items():
            np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-6,
                                       err_msg=f"{part}/{path}")
    want_p = tree_paths(want_np["params"])
    n = off = 0
    for path, a in tree_paths(got_np["params"]).items():
        np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-4, err_msg=path)
        n += a.size
        off += int((np.abs(a.astype(np.float64) - want_p[path]) > 1e-6).sum())
    assert off <= 1e-3 * n, (off, n)


if __name__ == "__main__" and sys.argv[1:] == ["sigterm-child"]:
    print(json.dumps(_sigterm_child()))
