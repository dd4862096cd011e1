"""Training loop on one device (the port of ``repro.runtime.trainer``).

Ported: the data retries with exponential backoff (``data.transient``),
the one host sync per step (the anomaly sentinel's verdict) with every
blocking fetch counted in ``host_fetches``, the straggler monitor on the
step-time mean, the skip streak, the log cadence, and the ``train.data``
/ ``train.step`` spans with the ``train.step_s`` histogram and the
``train.loss`` gauge.

Not ported yet (ROADMAP Queue 1): checkpointing, rollback to a
checkpoint, the SIGTERM path and expert migration (which returns at once
at EP = 1 in the reference).  Asking for a checkpoint directory raises
NotImplementedError; a skip streak that reaches
``anomaly_rollback_after`` raises as the reference does when it has no
checkpoint to roll back to.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models.model import LanguageModel
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.runtime.faults import FaultInjector, TransientDataError
from repro_torch.training import make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_dir: Optional[str] = None  # not ported: raises if set
    log_every: int = 10
    # straggler monitor
    straggler_factor: float = 2.0
    # anomaly sentinel -> skip-step
    gnorm_skip_cap: float = 0.0  # >0: also skip when grad_norm reaches this
    anomaly_rollback_after: int = 3  # K consecutive skips would roll back
    # transient data-source errors
    data_retries: int = 3
    data_backoff_s: float = 0.05  # doubles per retry


class Trainer:
    def __init__(self, lm: LanguageModel, opt_cfg: OptimizerConfig,
                 cfg: TrainerConfig, log_fn: Callable[[str], None] = print,
                 injector: Optional[FaultInjector] = None,
                 telemetry: Optional[obs.Telemetry] = None):
        if cfg.checkpoint_dir is not None:
            raise NotImplementedError(
                "the port has no checkpointing yet (the head of ROADMAP Queue 1)")
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
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.anomalies: List[Dict[str, Any]] = []
        # Every blocking device->host fetch goes through _fetch and is
        # counted here, so tests can pin the hot loop's sync cadence.
        self.host_fetches = 0

    def _fetch(self, x):
        """Blocking device->host fetch of a metric value (counted)."""
        self.host_fetches += 1
        return x.item() if isinstance(x, torch.Tensor) else x

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

    def fit(self, state, data: Iterator) -> Dict[str, Any]:
        tel = self.telemetry
        # The step counter lives on the host (training.init_state): no fetch.
        start_step = int(state["step"])
        metrics: Dict[str, Any] = {}
        # Datasets exposing batch_at(step) are pure functions of the step;
        # plain iterators are consumed in order.
        indexed = hasattr(data, "batch_at")
        data_it = None if indexed else iter(data)
        step = start_step
        anomaly_streak = 0
        while step < self.cfg.total_steps:
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
                    raise RuntimeError(
                        f"step {step}: {self.cfg.anomaly_rollback_after} consecutive "
                        f"anomalous steps and no checkpoint to roll back to "
                        f"(the port has no checkpointing yet, ROADMAP Queue 1)")
                step += 1
                continue
            anomaly_streak = 0
            if step % self.cfg.log_every == 0:
                loss = float(self._fetch(metrics["loss"]))
                tel.gauge("train.loss", loss, step=step)
                self.log(f"[train] step={step} loss={loss:.4f} ({dt * 1e3:.0f} ms/step)")
            step += 1
        return {"state": state, "metrics": metrics, "stragglers": self.stragglers,
                "anomalies": self.anomalies, "last_step": max(step - 1, start_step)}
