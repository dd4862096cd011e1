"""Training loop on one device (the port of ``repro.runtime.trainer``).

* **checkpoint/restart**: with ``checkpoint_dir``, an async checkpoint
  after every ``checkpoint_every``-th step and a blocking one when the
  loop ends; ``fit`` resumes from the newest intact checkpoint.  The data
  stream is a pure function of the step (``batch_at``), so resume is
  exact.  SIGTERM and SIGINT stop the loop after a final checkpoint
  (preemption).
* **anomaly sentinel and rollback**: the step refuses a non-finite (or,
  with ``gnorm_skip_cap``, spiking) update and reports
  ``metrics["skipped"]``; after ``anomaly_rollback_after`` skips in a row
  the trainer restores the newest intact checkpoint and re-enters the loop
  at its step, at most ``max_rollbacks`` times.  The re-trained steps are
  bit for bit the fault-free ones.
* **straggler monitor** on the step-time mean; **transient data errors**
  retried with exponential backoff (``data.transient``).
* one host sync a step (the sentinel's verdict); every blocking fetch is
  counted in ``host_fetches``.  The ``train.data`` / ``train.step`` spans,
  the ``train.step_s`` histogram and the ``train.loss`` gauge.
* every recovery path is driven through ``runtime.faults``.

Not ported (ROADMAP Queue 1, item 2): expert migration, which returns at
once at EP = 1 in the reference.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.model import LanguageModel
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.runtime.faults import FaultInjector, TransientDataError
from repro_torch.training import make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    checkpoint_keep: int = 3
    log_every: int = 10
    # straggler monitor
    straggler_factor: float = 2.0
    # anomaly sentinel -> skip-step -> rollback
    gnorm_skip_cap: float = 0.0  # >0: also skip when grad_norm reaches this
    anomaly_rollback_after: int = 3  # K consecutive skips trigger a rollback
    max_rollbacks: int = 3  # bounded retry budget for rollbacks
    # transient data-source errors
    data_retries: int = 3
    data_backoff_s: float = 0.05  # doubles per retry


class Trainer:
    def __init__(self, lm: LanguageModel, opt_cfg: OptimizerConfig,
                 cfg: TrainerConfig, log_fn: Callable[[str], None] = print,
                 injector: Optional[FaultInjector] = None,
                 telemetry: Optional[obs.Telemetry] = None):
        self.lm = lm
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.log = log_fn
        self.injector = injector if injector is not None else FaultInjector(log_fn=log_fn)
        self.telemetry = telemetry if telemetry is not None else obs.Telemetry(enabled=False)
        self.train_step = make_train_step(
            lm, opt_cfg,
            gnorm_skip_cap=cfg.gnorm_skip_cap if cfg.gnorm_skip_cap > 0 else None,
            fetch=self._fetch)
        # Unlike the reference, no router-load statistics ride along in the
        # checkpoint's extras (saved as None): they exist only for the
        # expert-migration controller, which is not ported.
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                                       every=cfg.checkpoint_every, injector=self.injector,
                                       log_fn=log_fn, telemetry=self.telemetry)
                     if cfg.checkpoint_dir else None)
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.anomalies: List[Dict[str, Any]] = []
        self.rollbacks: List[Dict[str, int]] = []
        self.resumed_from: Optional[int] = None
        # Every blocking device->host fetch goes through _fetch and is
        # counted here, so tests can pin the hot loop's sync cadence.
        self.host_fetches = 0
        self._stop = False

    def _fetch(self, x):
        """Blocking device->host fetch of a metric value (counted)."""
        self.host_fetches += 1
        return x.item() if isinstance(x, torch.Tensor) else x

    def _install_signals(self) -> Dict[int, Any]:
        """SIGTERM and SIGINT stop the loop after a final checkpoint;
        returns the handlers they replace (none off the main thread)."""
        def handler(signum, frame):
            self.log(f"[trainer] signal {signum}: checkpoint + stop")
            self._stop = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return previous

    def _next_batch(self, data, data_it, indexed: bool, step: int):
        """Fetch the step's batch, retrying transient data-source errors
        with exponential backoff before surfacing them."""
        delay = self.cfg.data_backoff_s
        for attempt in range(self.cfg.data_retries + 1):
            try:
                self.injector.raise_if("data.transient", step)
                return data.batch_at(step) if indexed else next(data_it)
            except (TransientDataError, OSError) as e:
                if attempt >= self.cfg.data_retries:
                    raise
                self.log(f"[data] transient error at step {step}: {e} "
                         f"(retry {attempt + 1}/{self.cfg.data_retries} "
                         f"in {delay * 1e3:.0f} ms)")
                time.sleep(delay)
                delay *= 2

    def _rollback(self, state, step: int):
        """Restore the newest intact checkpoint into ``state`` and return
        (state, the step to re-enter the loop at)."""
        if self.ckpt is None:
            raise RuntimeError(
                f"step {step}: {self.cfg.anomaly_rollback_after} consecutive "
                f"anomalous steps and no checkpoint_dir to roll back to")
        if len(self.rollbacks) >= self.cfg.max_rollbacks:
            raise RuntimeError(f"step {step}: rollback budget exhausted "
                               f"({self.cfg.max_rollbacks}), anomalies persist")
        try:
            state, ck_step = self.ckpt.restore_latest(state)
        except FileNotFoundError as e:
            raise RuntimeError(f"step {step}: anomaly rollback requested but no "
                               f"intact checkpoint exists") from e
        self.rollbacks.append({"at_step": step, "to_step": ck_step})
        self.log(f"[rollback] step={step}: {self.cfg.anomaly_rollback_after} "
                 f"consecutive anomalies -> restored step {ck_step}")
        return state, ck_step

    def fit(self, state, data: Iterator) -> Dict[str, Any]:
        """Train until ``total_steps`` (or a stop signal); ``state`` is
        updated in place and returned in the output."""
        previous = self._install_signals()
        try:
            return self._fit(state, data)
        finally:
            # Unlike the reference, which leaves its handler installed, the
            # handlers found on entry come back: a later SIGTERM (a caller's
            # timeout) must end the process, not set _stop on a finished run.
            for sig, h in previous.items():
                signal.signal(sig, signal.SIG_DFL if h is None else h)

    def _fit(self, state, data: Iterator) -> Dict[str, Any]:
        tel = self.telemetry
        # The step counter lives on the host (training.init_state): no fetch.
        start_step = int(state["step"])
        if self.ckpt is not None:
            try:
                # The loop re-enters at the checkpoint's step, not at
                # state["step"] (the count of applied updates): after skips
                # the two differ.
                state, start_step = self.ckpt.restore_latest(state)
                self.resumed_from = start_step
                self.log(f"[trainer] resumed from step {start_step}")
            except FileNotFoundError:
                pass
        metrics: Dict[str, Any] = {}
        # Datasets exposing batch_at(step) are pure functions of the step;
        # plain iterators are consumed in order.
        indexed = hasattr(data, "batch_at")
        data_it = None if indexed else iter(data)
        step = start_step
        anomaly_streak = 0
        while step < self.cfg.total_steps:
            # Simulated preemption: a real signal, so the installed handler
            # (final checkpoint and stop) is what runs.
            if self.injector.fire("train.sigterm", step) is not None:
                os.kill(os.getpid(), signal.SIGTERM)
            if self._stop:
                break
            with tel.span("train.data", step=step):
                batch = self._next_batch(data, data_it, indexed, step)
            scale = self.injector.payload_if("train.nonfinite", step)
            if scale is not None:
                batch = {**batch, "fault_scale": np.float32(scale)}
            t0 = time.perf_counter()
            # Slow-step injection sleeps inside the timed window so the
            # straggler monitor sees it like a real slow host.
            self.injector.sleep_if("train.slow_step", step)
            with tel.span("train.step", step=step) as sp:
                # The step's one host sync is inside it: the sentinel's
                # verdict, read before the in-place update is queued.  So
                # dt covers forward and backward; the update's device time
                # lands in the next step's window.
                state, metrics = self.train_step(state, batch)
                skipped = bool(metrics["skipped"])
                sp.set(skipped=skipped)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            tel.histogram("train.step_s", dt, step=step)
            if len(self.step_times) > 5:
                ema = float(np.mean(self.step_times[-20:-1]))
                if dt > self.cfg.straggler_factor * ema:
                    self.stragglers.append(step)
                    self.log(f"[straggler] step={step} took {dt * 1e3:.0f}ms "
                             f"(ema {ema * 1e3:.0f}ms)")
            if skipped:
                loss = float(self._fetch(metrics["loss"]))
                gnorm = float(self._fetch(metrics["grad_norm"]))
                tel.instant("train.anomaly", step=step, loss=loss, grad_norm=gnorm)
                anomaly_streak += 1
                self.anomalies.append({"step": step, "loss": loss, "grad_norm": gnorm})
                self.log(f"[sentinel] step={step} anomalous update skipped "
                         f"(loss={loss:.4g} gnorm={gnorm:.4g}) "
                         f"[{anomaly_streak}/{self.cfg.anomaly_rollback_after}]")
                if anomaly_streak >= self.cfg.anomaly_rollback_after:
                    state, step = self._rollback(state, step)
                    anomaly_streak = 0
                    continue
                step += 1
                continue
            anomaly_streak = 0
            if step % self.cfg.log_every == 0:
                loss = float(self._fetch(metrics["loss"]))
                tel.gauge("train.loss", loss, step=step)
                self.log(f"[train] step={step} loss={loss:.4f} ({dt * 1e3:.0f} ms/step)")
            if self.ckpt is not None and self.ckpt.should_save(step + 1):
                self.ckpt.save(step + 1, state, blocking=False)
            step += 1
        last_step = max(step - 1, start_step)
        if self.ckpt is not None:
            self.ckpt.save(step, state, blocking=True)
        return {"state": state, "metrics": metrics, "stragglers": self.stragglers,
                "anomalies": self.anomalies, "rollbacks": self.rollbacks,
                "last_step": last_step}
