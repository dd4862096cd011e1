"""Training loop (the port of ``repro.runtime.trainer``), on one device or
on every rank of an expert-parallel run in lockstep.

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

* **expert migration** (paper §VI): the MoE layers' expert loads ride in
  the step's one host fetch into a ``core.migration.LoadStats`` EMA; every
  ``migrate_every`` steps, when the EP groups' imbalance reaches
  ``migrate_threshold``, the controller plans hot-expert replicas and
  Algorithm 2 swaps on the residual (``migration.plan_layer``), optionally
  prices the move against the modeled step-time gain (``platform``), and
  permutes the expert leaves of params and both Adam moments in place, in
  one pass (``migration.apply_migration_``), then the routing tables.  The
  EMA rides in every checkpoint's extras, so a resume or a rollback
  restarts the controller bit for bit.  At EP = 1 it returns at once, as
  in the reference.

Over several ranks (``models.model.LanguageModel`` with a mesh plan: any
(pod, data, ep, tp) grid, pipelined or not) every rank runs this loop on
the same global batch stream (``batch_at`` of a step is the global batch,
so a resume feeds every rank its block of the same one); the train step
takes the rank's block (its rows over data, its sequence slice over (ep,
tp): ``training.shard_batch``) and reduces the gradients, so every rank sees the same loss, grad norm and
expert loads and skips, rolls back, migrates or steps together (each
migration checks that every rank of the world planned the same).  The
checkpoint does not depend on the mesh: the expert leaves of params, m and
v are all-gathered over the EP group and the block leaves over the pp
group to the global tree, rank 0 writes the files a world-1 run writes,
and every rank restores from them, taking its stage's chunks and its
expert slots (``convert.shard_leaf``), so a checkpoint written at one mesh
or schedule resumes at another.  SIGTERM's final save and the anomaly
rollback go through the same save and restore.  The fault sites fire on
every rank; the launcher passes rank 0 alone a printing ``log_fn`` and
metric sinks.

Under a pipeline plan (``plan.pp`` > 1) the step is the schedule-executing
one (``core.pipeline``; ``[trainer] pipelined: PP=... schedule=...`` in the
log) and the load feed gets the loads gathered over the pp group.  A
migration plans on the whole stack's routing tables (gathered over the pp
group), one row per (MoE layer, rep), and each stage applies its own
chunks' rows (``migration.apply_model_plan_``).
"""

from __future__ import annotations

import os
import signal
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, sharding
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointing import restore_checkpoint
from repro_torch.convert import gather_params, shard_leaf
from repro_torch.core import migration as mig
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.runtime.faults import FaultInjector, TransientDataError
from repro_torch.training import _host, make_train_step

@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    checkpoint_keep: int = 3
    log_every: int = 10
    # straggler monitor
    straggler_factor: float = 2.0
    # expert migration
    migrate_every: int = 20
    migrate_threshold: float = 1.3  # max/mean group load
    migrate_max_swaps: int = 100
    # Model-priced hysteresis (opt-in): a core.platform name; a plan is
    # applied only when the modeled per-step gain over migrate_every steps
    # clears the Table IV transfer cost.  None: the threshold alone.
    platform: Optional[str] = None
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
        # Without a telemetry of its own the trainer records on the
        # process-global one (disabled unless ``obs.configure`` ran).
        self.telemetry = telemetry if telemetry is not None else obs.get_telemetry()
        arch = lm.arch
        self.load_stats = (mig.LoadStats(arch.num_moe_layers, arch.moe.num_experts)
                           if arch.moe else None)
        self.train_step = make_train_step(
            lm, opt_cfg,
            gnorm_skip_cap=cfg.gnorm_skip_cap if cfg.gnorm_skip_cap > 0 else None,
            fetch=self._fetch, fetch_loads=self.load_stats is not None)
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                                       every=cfg.checkpoint_every, injector=self.injector,
                                       log_fn=log_fn, telemetry=self.telemetry)
                     if cfg.checkpoint_dir else None)
        # The mesh plan when there are several ranks, else None.
        self.plan = lm.plan if lm.world > 1 else None
        # (b, s) of the running batch, for the pricing gate.
        self._batch_shape: Optional[tuple] = None
        self.step_times: List[float] = []
        self.stragglers: List[int] = []
        self.migrations: List[Dict[str, Any]] = []
        self.anomalies: List[Dict[str, Any]] = []
        self.rollbacks: List[Dict[str, int]] = []
        self.resumed_from: Optional[int] = None
        # Every blocking device->host fetch goes through _fetch and is
        # counted here, so tests can pin the hot loop's sync cadence.
        self.host_fetches = 0
        self._stop = False

    def _fetch(self, x):
        """Blocking device->host fetch of a metric value (counted, and a
        ``train.host_fetches`` counter event): a number for one element,
        numpy for more."""
        self.host_fetches += 1
        self.telemetry.counter("train.host_fetches")
        return _host(x) if isinstance(x, torch.Tensor) else x

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

    # -- expert migration ----------------------------------------------------

    def _price_migration(self, imb: float, imb_post: float, n_replicas: int):
        """The pricing record of a plan on ``cfg.platform``: the modeled
        step times before and after it; ``worth_it`` iff the per-step gain
        over ``migrate_every`` steps clears the Table IV transfer time."""
        from repro_torch.core import resource_model as rm
        from repro_torch.core.platform import get_platform

        plan = self.plan
        b, s = self._batch_shape
        setup = rm.TrainSetup(b=b, s=s, PP=plan.pp, EP=plan.ep, DP=plan.dp,
                              dispatch=self.lm.arch.moe.dispatch, imbalance=imb,
                              replicas=n_replicas)
        est = rm.estimate(rm.ModelShape.from_arch(self.lm.arch), setup,
                          get_platform(self.cfg.platform), imbalance_post=imb_post)
        gain = est.migrate_gain_per_step * self.cfg.migrate_every
        return {"t_migrate": est.t_migrate, "gain_per_step": est.migrate_gain_per_step,
                "amortized_gain": gain, "worth_it": gain > est.t_migrate}

    def _check_plan_agrees(self, mplan: mig.ModelPlan, device) -> None:
        """Every rank must apply the same permutation: a CRC32 of this
        rank's EMA and plan, all-gathered over the world and compared."""
        blob = [self.load_stats.ema.tobytes()] + [
            np.ascontiguousarray(v).tobytes() for layer in mplan.layers
            for v in layer.values() if v is not None]
        mine = torch.tensor([zlib.crc32(b"".join(blob))], dtype=torch.int64, device=device)
        parts = [torch.empty_like(mine) for _ in range(self.plan.world)]
        dist.all_gather(parts, mine, group=self.plan.world_group)
        got = torch.cat(parts).cpu().tolist()
        if len(set(got)) != 1:
            raise RuntimeError(f"migration: the ranks planned differently (CRC32s {got})")

    def _maybe_migrate(self, state, step: int):
        """The controller, between steps (see the module docstring); the
        state is changed in place and returned."""
        if self.load_stats is None or step % self.cfg.migrate_every:
            return state
        plan = self.plan
        if plan is None or plan.ep <= 1:
            return state
        moe = [i for i, (_, f) in enumerate(self.lm.arch.block_pattern) if f == "moe"]
        ffns = {t: [state[t]["blocks"][i]["ffn"] for i in moe] for t in ("params", "m", "v")}
        tables = mig.routing_tables(ffns["params"], plan)
        if mig.model_imbalance(self.load_stats, tables, plan.ep) < self.cfg.migrate_threshold:
            return state
        # Plan on the host first: the post-move imbalance feeds the pricing
        # gate before any tensor is touched.
        t0 = time.perf_counter()
        mplan = mig.plan_model(self.load_stats, tables, plan.ep, self.cfg.migrate_max_swaps)
        imb, imb_post = mplan.imbalance, mplan.imbalance_post
        self.telemetry.instant("train.migrate_planned", step=step, imbalance=imb,
                               imbalance_post=imb_post, swaps=mplan.swaps,
                               replicas=mplan.replicas)
        record: Dict[str, Any] = {"step": step, "imbalance": imb, "imbalance_post": imb_post,
                                  "swaps": mplan.swaps, "replicas": mplan.replicas}
        if self.cfg.platform is not None and self._batch_shape is not None:
            record.update(self._price_migration(imb, imb_post, mplan.replicas))
            if not record["worth_it"]:
                record["applied"] = False
                self.migrations.append(record)
                self.log(f"[migrate] step={step} imbalance={imb:.2f}->{imb_post:.2f} "
                         f"deferred: amortized gain {record['amortized_gain'] * 1e3:.1f}ms "
                         f"< transfer {record['t_migrate'] * 1e3:.1f}ms")
                return state
        device = state["params"]["embed"].device
        self._check_plan_agrees(mplan, device)
        # ONE permutation pass over params and both Adam moments (they move
        # with their weights), then the routing tables.
        gathered = mig.apply_model_plan_(mplan, ffns["params"], (ffns["m"], ffns["v"]), plan)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        record.update({"seconds": dt, "applied": True, "gathered_bytes": gathered})
        self.telemetry.histogram("train.migrate_s", dt, step=step)
        self.migrations.append(record)
        self.log(f"[migrate] step={step} imbalance={imb:.2f}->{imb_post:.2f} "
                 f"swaps={mplan.swaps} replicas={mplan.replicas} ({dt * 1e3:.0f} ms, "
                 f"{gathered / 1e6:.1f} MB all-gathered a rank)")
        return state

    # -- checkpoints: EP-agnostic, with the controller's state ----------------

    def _ckpt_extras(self) -> Optional[Dict[str, Any]]:
        """The router-load EMA, riding in the manifest's extras (covered by
        its digest), so a restart does not plan on a cold EMA."""
        if self.load_stats is None:
            return None
        return {"load_stats": self.load_stats.to_state()}

    def _restore_load_stats(self, ck_step: int) -> None:
        """Reset the controller to the restored checkpoint's EMA, bit for
        bit, or cold when the checkpoint carries none."""
        if self.load_stats is None or self.ckpt is None:
            return
        try:
            extras = self.ckpt.extras_for(ck_step)
        except (FileNotFoundError, OSError):
            extras = {}
        if extras and "load_stats" in extras:
            self.load_stats.load_state(extras["load_stats"])
        else:
            arch = self.lm.arch
            self.load_stats = mig.LoadStats(arch.num_moe_layers, arch.moe.num_experts,
                                            decay=self.load_stats.decay)

    def global_state(self, state):
        """The state with every leaf of params, m and v all-gathered to its
        global form (``convert.gather_params``: the expert leaves over the
        expert-gradient group under the plan's d_ff split, then over the EP
        group, the block leaves over the pp group); ``state`` itself at
        world 1."""
        if self.plan is None:
            return state
        return {k: gather_params(v, self.plan) if k in ("params", "m", "v") else v
                for k, v in state.items()}

    def _save(self, step: int, state, blocking: bool) -> None:
        """Checkpoint the global state: every rank gathers, rank 0 writes
        (the snapshot is taken before this returns); a blocking save ends
        in a barrier, so every rank returns after the files exist."""
        full = self.global_state(state)
        if self.plan is None or self.plan.rank == 0:
            self.ckpt.save(step, full, blocking=blocking, extras=self._ckpt_extras())
        del full
        if blocking and self.plan is not None:
            dist.barrier(group=self.plan.world_group)

    def _shard_of(self, flat_keys):
        """(key, global array) -> this rank's part: of params, m and v its
        stage's chunks of the block leaves and its expert slots (and d_ff
        slice) of the expert leaves (``convert.shard_leaf``), the rest
        whole."""
        plan = self.plan
        experts = sharding.expert_paths({k.partition("/")[2]: None for k in flat_keys})

        def shard(key, a):
            tree, _, path = key.partition("/")
            if tree not in ("params", "m", "v"):
                return a
            return shard_leaf(path, a, plan, experts)

        return shard

    def _restore_latest(self, state):
        """Restore the newest intact checkpoint into ``state`` in place;
        returns (state, step), FileNotFoundError if there is none.  Over
        ranks, rank 0 picks the checkpoint (verifying, quarantining a
        corrupt one) and every rank loads its part of it."""
        if self.plan is None:
            return self.ckpt.restore_latest(state)
        step = -1
        if self.plan.rank == 0:
            try:
                step = self.ckpt.latest_intact()
            except FileNotFoundError:
                pass
        t = torch.tensor([step], dtype=torch.int64, device=state["params"]["embed"].device)
        dist.broadcast(t, src=0, group=self.plan.world_group)
        step = int(t.item())
        if step < 0:
            raise FileNotFoundError(f"no intact checkpoint under {self.ckpt.directory}")
        return restore_checkpoint(self.ckpt.directory, state, step=step, verify=False,
                                  log_fn=self.log, telemetry=self.telemetry,
                                  shard=self._shard_of(tree_paths(state)))

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
            state, ck_step = self._restore_latest(state)
        except FileNotFoundError as e:
            raise RuntimeError(f"step {step}: anomaly rollback requested but no "
                               f"intact checkpoint exists") from e
        self.rollbacks.append({"at_step": step, "to_step": ck_step})
        # The load EMA rolls back with the weights.
        self._restore_load_stats(ck_step)
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
        plan = self.lm.plan
        if plan is not None and plan.pp > 1:
            self.log(f"[trainer] pipelined: PP={plan.pp} schedule={plan.schedule} "
                     + (f"V={plan.vstages} " if plan.vstages > 1 else "")
                     + f"(M={plan.num_microbatches})")
        # The step counter lives on the host (training.init_state): no fetch.
        start_step = int(state["step"])
        if self.ckpt is not None:
            try:
                # The loop re-enters at the checkpoint's step, not at
                # state["step"] (the count of applied updates): after skips
                # the two differ.
                state, start_step = self._restore_latest(state)
                self.resumed_from = start_step
                self._restore_load_stats(start_step)
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
            if self._batch_shape is None:
                self._batch_shape = tuple(int(n) for n in batch["tokens"].shape[:2])
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
            if "expert_load_host" in metrics:
                # (reps, n_moe_pos, E), global over the world -> LoadStats
                # row order (position-major, rep).
                loads = metrics["expert_load_host"]
                self.load_stats.update(np.concatenate([loads[:, i] for i in
                                                       range(loads.shape[1])]))
            state = self._maybe_migrate(state, step + 1)
            if step % self.cfg.log_every == 0:
                loss = float(self._fetch(metrics["loss"]))
                tel.gauge("train.loss", loss, step=step)
                self.log(f"[train] step={step} loss={loss:.4f} ({dt * 1e3:.0f} ms/step)")
            if self.ckpt is not None and self.ckpt.should_save(step + 1):
                self._save(step + 1, state, blocking=False)
            step += 1
        last_step = max(step - 1, start_step)
        if self.ckpt is not None:
            self._save(step, state, blocking=True)
        return {"state": state, "metrics": metrics, "stragglers": self.stragglers,
                "migrations": self.migrations, "anomalies": self.anomalies,
                "rollbacks": self.rollbacks, "last_step": last_step}
