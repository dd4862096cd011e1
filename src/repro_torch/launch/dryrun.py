"""Dry run: one rank's cost of every (architecture x input shape x grid)
cell at full width and depth, with no memory allocated.

The port of the reference's ``launch/dryrun.py`` (and of ``launch/mesh.py``,
whose production grids are :data:`GRIDS`).  The reference lowers and
compiles each cell for a TPU pod and reads XLA's analyses; the port runs
one step of one rank eagerly:

* a fake process group of the grid's size (``torch.distributed``'s "fake"
  backend: every collective returns at once), on which the port's own
  ``sharding.make_plan`` binds the grid, its memory policy from
  ``core.planner.choose_memory_policy`` priced on ``core.platform.H100``;
* the model's parameters and optimizer state as fake tensors
  (``FakeTensorMode``: shapes and dtypes, no storage) at the arch's full
  size, this rank's shard of them (``convert.shard_params``);
* ``training.make_train_step`` / ``make_prefill_step`` /
  ``make_decode_step`` traced under ``launch.cost.CostCounter``: FLOPs,
  bytes, the peak of live bytes over the step, and the collectives by
  kind.  Under a pipeline one rank of each stage is traced, and the record
  keeps each stage and their max.

The CUDA kernels are bound through ``ctypes`` and take no fake tensor, so
the trace runs their plain versions on fake CPU tensors, each counted as
one op of its kernel (``cost.kernels_as_ops``): the record says ``"path":
"plain"``.  A ragged expert GEMM's rows depend on the routing, which a
fake tensor cannot read; the dry run fixes it to the balanced assignment
(token t's j-th choice is expert (t k + j) mod E; each segment's offsets
made on the host by ``models.moe``'s own functions: :func:`balanced_routing`)
and says ``"routing": "balanced"``.  A step's totals (T k rows, their FLOPs
and bytes) do not depend on the routing.

Usage::

    python -m repro_torch.launch.dryrun --arch granite-moe-3b-a800m --shape train_4k
    python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k --multi-pod --pipeline
    python -m repro_torch.launch.dryrun --all --jobs 4   # every cell, one process each

Records land in ``results/dryrun_torch/<cell>.json``, read by
``repro_torch.launch.roofline``.  Every figure in them that is not a count
of the trace is modeled for ``core.platform.H100``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# The production grids (the reference's launch/mesh.py): 16 x 16 = 256
# ranks (data, model); two pods, 2 x 16 x 16 = 512 (pod, data, model).
GRIDS = {False: (16, 16), True: (2, 16, 16)}
PIPELINE_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b", "jamba-1.5-large-398b")


def _cell_name(arch, shape, multi_pod, pipeline, tag=""):
    mesh = "pod2" if multi_pod else "pod1"
    pipe = "-pp" if pipeline else ""
    tag = f"-{tag}" if tag else ""
    return f"{arch}--{shape}--{mesh}{pipe}{tag}"


# ---------------------------------------------------------------------------
# The resource model's records, priced on the H100
# ---------------------------------------------------------------------------


def cell_setup(arch, shape, plan):
    """The cell's ``rm.TrainSetup``, set up as the train launcher sets up
    the plan's (``launch.train.memory_setup``, the plan's own PP, EP and
    DP): every model record of the cell is priced from it."""
    from repro_torch.core import resource_model as rm
    from repro_torch.launch.train import memory_setup

    pipe = {"schedule": plan.schedule, "vstages": plan.vstages} if plan.pp > 1 else {}
    return rm.TrainSetup(b=shape.global_batch, s=shape.seq_len, PP=plan.pp, EP=plan.ep,
                         DP=plan.dp, zero="world", a2a_algo=plan.a2a_algo,
                         a2a_chunks=plan.a2a_chunks, **pipe, **memory_setup(plan),
                         **({"dispatch": arch.moe.dispatch} if arch.moe else {}))


def _dispatch_model_record(arch, setup) -> dict:
    """Issued vs routed expert FLOPs, wasted fraction, drop rate and the
    expert activation bytes of both dispatch modes (the reference's record,
    ``core.resource_model`` on ``H100``)."""
    from repro_torch.configs.base import DISPATCH_MODES
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100

    if arch.moe is None:
        return {}
    m = rm.ModelShape.from_arch(arch)
    out = {}
    for mode in DISPATCH_MODES:
        t = dataclasses.replace(setup, dispatch=mode)
        est = rm.estimate(m, t, H100)
        disp = rm.dispatch_costs(m, t)
        routed = 6.0 * m.L_moe * m.k * m.expert_params * t.b * t.s
        out[mode] = {
            "moe_flops_routed": routed,
            "moe_flops_issued": routed * disp.flops_factor,
            "wasted_flop_fraction": 1.0 - 1.0 / disp.flops_factor,
            "drop_rate": disp.drop_rate,
            "expert_act_bytes_per_layer": rm._expert_act_per_layer(m, t, t.b / t.DP, t.EP),
            "dispatch_bytes_per_layer": disp.bytes_per_layer,
            "t_step_s": est.t_step,
            "t_dispatch_s": est.t_dispatch,
            "mem_stage0_bytes": est.mem_stage0,
        }
    out["selected"] = arch.moe.dispatch
    return out


def _a2a_model_record(arch, setup, plan) -> dict:
    """Every ``a2a_algo x a2a_chunks`` combination priced at the cell's
    (PP, EP, DP), best first (the reference's record, on ``H100``)."""
    from repro_torch.configs.base import A2A_ALGOS, A2A_CHUNK_CANDIDATES
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100

    if arch.moe is None or plan.ep <= 1:
        return {}
    m = rm.ModelShape.from_arch(arch)
    combos = []
    for algo in A2A_ALGOS:
        for K in A2A_CHUNK_CANDIDATES:
            est = rm.estimate(m, dataclasses.replace(setup, a2a_algo=algo, a2a_chunks=K),
                              H100)
            combos.append({"a2a_algo": algo, "a2a_chunks": K,
                           "t_a2a_serial_s": est.t_a2a,
                           "t_a2a_exposed_s": est.t_a2a_exposed,
                           "a2a_overlap_saving_s": est.a2a_overlap_saving,
                           "t_step_s": est.t_step, "mfu": est.mfu})
    combos.sort(key=lambda c: c["t_step_s"])
    return {"combos": combos,
            "best": {k: combos[0][k] for k in ("a2a_algo", "a2a_chunks")},
            "selected": {"a2a_algo": "halo" if plan.hierarchical_a2a else "flat",
                         "a2a_chunks": plan.a2a_chunks}}


def _schedule_model_record(arch, shape, setup, plan) -> dict:
    """The bound schedule and its comm-lane twin priced at the cell's
    partition (the reference's record, on ``H100``)."""
    from repro_torch.configs.base import SCHEDULES
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100
    from repro_torch.core.schedules import OVERLAP_BASE

    if shape.kind != "train" or plan.pp <= 1:
        return {}
    m = rm.ModelShape.from_arch(arch)
    bound = plan.schedule
    twin = OVERLAP_BASE.get(bound)
    if twin is None:
        twin = next((o for o, b in OVERLAP_BASE.items() if b == bound), None)
    rows = []
    for name in [n for n in (bound, twin) if n in SCHEDULES]:
        est = rm.estimate(m, dataclasses.replace(
            setup, schedule=name, vstages=plan.vstages if name == "interleaved_1f1b" else 1),
            H100)
        rows.append({"schedule": name, "t_p2p_serial_s": est.t_p2p,
                     "t_p2p_exposed_s": est.t_p2p_exposed,
                     "p2p_overlap_saving_s": est.p2p_overlap_saving,
                     "t_a2a_exposed_s": est.t_a2a_exposed,
                     "comm_buf_bytes": est.comm_buf_bytes,
                     "t_step_s": est.t_step, "mfu": est.mfu})
    rows.sort(key=lambda r: r["t_step_s"])
    return {"bound": bound, "rows": rows, "best": rows[0]["schedule"] if rows else None}


def _robustness_model_record(arch, shape, setup) -> dict:
    """Young-Daly checkpoint pricing of the cell (the reference's record,
    on ``H100``)."""
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100

    if shape.kind != "train":
        return {}
    m = rm.ModelShape.from_arch(arch)
    est = rm.estimate(m, setup, H100)
    return {"ckpt_bytes": rm.checkpoint_bytes(m), "t_ckpt_s": est.t_ckpt,
            "job_mtbf_s": rm.job_mtbf(H100, setup.P), "ckpt_interval_s": est.ckpt_interval_s,
            "ckpt_every_steps": est.ckpt_every_steps, "goodput_factor": est.goodput_factor,
            "mfu": est.mfu, "mfu_effective": est.mfu_effective}


def model_records(arch, shape, plan) -> dict:
    """The reference's four model records and, for a train cell, the
    stage-0 bytes a rank that the trace's peak stands beside: all priced
    on ``H100`` from the one :func:`cell_setup`."""
    from repro_torch.core import resource_model as rm
    from repro_torch.core.platform import H100

    setup = cell_setup(arch, shape, plan)
    out = {"dispatch_model": _dispatch_model_record(arch, setup),
           "a2a_model": _a2a_model_record(arch, setup, plan),
           "schedule_model": _schedule_model_record(arch, shape, setup, plan),
           "robustness_model": _robustness_model_record(arch, shape, setup)}
    if shape.kind == "train":
        out["model_mem_stage0_bytes"] = rm.estimate(rm.ModelShape.from_arch(arch), setup,
                                                    H100).mem_stage0
    return out


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A process group of ``world`` ranks on the "fake" backend, this
    process rank ``rank``; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def balanced_routing(arch, plan):
    """The MoE layers route by the balanced assignment, and the ragged
    plain versions read its per-expert row offsets from the host.

    ``models.moe._route`` keeps its router product and softmax (their FLOPs
    and gradients) and returns expert ids (t k + j) mod E with equal
    weights.  Each function of ``models.moe`` that turns expert ids into
    segment offsets (``_sort_dispatch``, ``_ragged_send`` with
    ``_payload_ids`` and ``_chunk_rows``, ``_decode_rows``) runs as it is,
    then once more on host tensors, uncounted: on the balanced ids of the
    (T k,) ids it was given, and for the EP payload with a counts exchange
    in which every source sends what this rank sends (each rank of the
    group routes the same ids).  The plain ragged GEMMs take the host
    offsets of the offsets they are given.  On real tensors the host
    values must equal the computed ones, or the step raises."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.weak import WeakIdKeyDictionary

    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.models import moe

    if arch.moe is None:
        yield
        return
    E = arch.moe.num_experts
    ep_rank = 0 if plan is None else plan.ep_rank
    host = WeakIdKeyDictionary()  # a traced tensor -> its values on the host
    old = {n: getattr(moe, n) for n in ("_route", "_sort_dispatch", "_ragged_send",
                                        "_payload_ids", "_chunk_rows", "_decode_rows")}
    old_ref = {n: getattr(mm_ref, n) for n in ("ragged_matmul_f32", "ragged_gate_up_silu_f32",
                                               "ragged_dw_f32")}

    def balanced(ids):
        return torch.arange(ids.numel()) % E

    def keep(t, values):  # inside _disable_current_modes
        if not isinstance(t, FakeTensor) and not torch.equal(t, values):
            raise RuntimeError("balanced routing: the host's values are not the step's")
        host[t] = values

    def no_replicas(rep):
        if rep is not None:
            raise NotImplementedError("balanced routing: replica rows")

    def route(x_tokens, w_router, cfg):
        _, _, probs, logits = old["_route"](x_tokens, w_router, cfg)
        T, k = x_tokens.shape[0], cfg.top_k
        ids = (torch.arange(T * k, device=x_tokens.device) % cfg.num_experts).reshape(T, k)
        w = torch.full((T, k), 1.0 / k, dtype=torch.float32, device=x_tokens.device)
        return w, ids, probs, logits

    def sort_dispatch(flat_e, n):
        out = old["_sort_dispatch"](flat_e, n)
        with _disable_current_modes():
            keep(out[2], old["_sort_dispatch"](balanced(flat_e), n)[2])
        return out

    def ragged_send(flat_e, n, ep, S, rep=None):
        no_replicas(rep)
        out = old["_ragged_send"](flat_e, n, ep, S)
        with _disable_current_modes():
            keep(out[5], old["_ragged_send"](balanced(flat_e), n, ep, S)[5])
        return out

    def payload_ids(send_counts, S, exchange):
        out = old["_payload_ids"](send_counts, S, exchange)
        with _disable_current_modes():
            keep(out, old["_payload_ids"](host[send_counts], S,
                                          lambda c: c[ep_rank].expand_as(c)))
        return out

    def chunk_rows(recv_id, start, size, E_l):
        out = old["_chunk_rows"](recv_id, start, size, E_l)
        with _disable_current_modes():
            keep(out[1], old["_chunk_rows"](host[recv_id], start, size, E_l)[1])
        return out

    def decode_rows(flat_e, E_l, rank, rep=None):
        no_replicas(rep)
        out = old["_decode_rows"](flat_e, E_l, rank)
        with _disable_current_modes():
            keep(out[1], old["_decode_rows"](balanced(flat_e), E_l, rank)[1])
        return out

    def on_host(name):
        def call(*args):
            return old_ref[name](*args[:-1], host.get(args[-1], args[-1]))

        return call

    patched = [(moe, "_route", route), (moe, "_sort_dispatch", sort_dispatch),
               (moe, "_ragged_send", ragged_send), (moe, "_payload_ids", payload_ids),
               (moe, "_chunk_rows", chunk_rows), (moe, "_decode_rows", decode_rows)]
    patched += [(mm_ref, name, on_host(name)) for name in old_ref]
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        yield
    finally:
        for n, fn in old.items():
            setattr(moe, n, fn)
        for n, fn in old_ref.items():
            setattr(mm_ref, n, fn)


@contextlib.contextmanager
def host_traces():
    """The pipeline executor's occupancy traces, host bookkeeping that the
    loss reads back with ``.numpy()``, come back as host zeros of their
    shape (a fake tensor has no values to read)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.core import pipeline

    old = pipeline.pipelined_step

    def step(*args, **kwargs):
        terms, grads, traces, stats = old(*args, **kwargs)
        with unset_fake_temporarily():
            traces = tuple(torch.zeros(t.shape, dtype=t.dtype) for t in traces)
        return terms, grads, traces, stats

    pipeline.pipelined_step = step
    try:
        yield
    finally:
        pipeline.pipelined_step = old


def _bytes(tree) -> int:
    from repro_torch.models.model import tree_paths

    return sum(t.numel() * t.element_size() for t in tree_paths(tree).values()
               if isinstance(t, torch.Tensor))


def trace_step(arch, kind: str, plan, batch: int, seq: int, *, fake: bool = True) -> dict:
    """One step of this rank under ``plan`` (None: one rank), traced under
    :class:`cost.CostCounter` with bf16 compute and weights made from seed
    0, on fake tensors or (``fake=False``) real CPU ones: ``kind`` "train"
    (AdamW, the global batch ``batch`` x
    ``seq`` of which this rank takes its block), "prefill" (this rank's
    block of ``batch`` prompts of ``seq`` tokens: its rows over data, its
    positions over (ep, tp)) or "decode" (one token a sequence at the end
    of a ``seq``-row cache: the rank's rows over data and its "kv_seq"
    block of the cache's positions).  The serving steps take the global
    batch as a host array, which is not counted (a rank's block of it is
    a few KB).  Returns {"memory",
    "cost", "collectives", "kernels"}; the memory's ``peak_bytes`` is the
    step's peak of live bytes with the state (``state_bytes``) in it."""
    from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily

    from repro_torch import training
    from repro_torch.convert import shard_params
    from repro_torch.launch.cost import CostCounter, kernels_as_ops
    from repro_torch.models.model import LanguageModel, init_params, map_tree
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init

    lm = LanguageModel(arch, plan)
    world = 1 if plan is None else plan.world
    compute_dtype = torch.bfloat16
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    counter = CostCounter()
    # The balanced offsets reach the kernels' plain versions as host
    # tensors (balanced_routing wraps the counter's kernel wrappers).
    with mode, kernels_as_ops(counter), balanced_routing(arch, plan), host_traces():
        local = init_params(arch, torch.Generator().manual_seed(0), "cpu", torch.float32)
        if world > 1:
            local = shard_params(local, plan)
        toks = np.random.default_rng(0).integers(
            0, arch.vocab_size, (batch, seq if kind != "decode" else 1), dtype=np.int64)
        if kind == "train":
            toks = torch.from_numpy(toks)
        with counter:
            local = map_tree(lambda t: t.clone(), local)
            if kind == "train":
                counter.track(toks)
            mem = {"param_bytes": _bytes(local)}
            if kind == "train":
                state = {"params": local, **adamw_init(local, plan.optimizer_dtype
                                                       if plan is not None else "float32")}
                with unset_fake_temporarily():  # the host's step count, read by AdamW
                    state["step"] = torch.zeros((), dtype=torch.int32)
                mem["grad_bytes"] = mem["param_bytes"]  # fp32 gradients of every leaf
                mem["optimizer_bytes"] = _bytes({"m": state["m"], "v": state["v"]})
                step = training.make_train_step(lm, OptimizerConfig(), fetch=lambda ok: True,
                                                compute_dtype=compute_dtype)
                args = (state, {"tokens": toks, "labels": toks})
            elif kind == "prefill":
                step = training.make_prefill_step(lm, compute_dtype)
                args = (local, {"tokens": toks})
            else:
                cache = lm.init_cache(batch, seq, compute_dtype, "cpu")
                mem["cache_bytes"] = _bytes(cache)
                step = training.make_decode_step(lm, compute_dtype)
                args = (local, cache, {"tokens": toks}, seq - 1)
            mem["state_bytes"] = counter.cost.live_bytes
            counter.start_step()
            t0 = time.time()
            out = step(*args)
            seconds = time.time() - t0
            del out, args
        c = counter.cost
        mem["peak_bytes"] = c.peak_bytes
        return {"memory": mem,
                "cost": {"flops": c.flops, "bytes_accessed": c.bytes_accessed,
                         "bytes_large": c.bytes_large},
                "collectives": c.collective_summary(),
                "kernels": dict(c.kernels), "trace_seconds": seconds}


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, pipeline: bool = False,
             schedule: Optional[str] = None, vstages: Optional[int] = None,
             hierarchical_a2a: bool = False, a2a_chunks: Optional[int] = None,
             compress_p2p: bool = False, remat: Optional[str] = None,
             dispatch: Optional[str] = None, tag: str = "", save: bool = True) -> dict:
    """Bind the cell's plan on a fake process group of :data:`GRIDS`'s
    grid, price the resource model's records on ``H100`` and trace one
    rank's step (each stage's first rank under a pipeline)."""
    from repro_torch import sharding
    from repro_torch.configs import SHAPES, get_arch, shape_applicable
    from repro_torch.configs.base import DEFAULT_SCHEDULE
    from repro_torch.core.planner import choose_memory_policy
    from repro_torch.core.platform import H100

    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if dispatch and arch.moe is not None:
        arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch))
    cell = _cell_name(arch_name, shape_name, multi_pod, pipeline, tag)
    record = {"cell": cell, "arch": arch_name, "shape": shape_name, "multi_pod": multi_pod,
              "pipeline": pipeline, "schedule": schedule, "vstages": vstages,
              "hierarchical_a2a": hierarchical_a2a, "a2a_chunks": a2a_chunks or 1,
              "compress_p2p": compress_p2p,
              "dispatch": arch.moe.dispatch if arch.moe else None,
              "platform": H100.name, "path": "plain",
              "routing": "balanced" if arch.moe is not None else None}
    ok, why = shape_applicable(arch, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        if save:
            _save(record)
        return record
    try:
        t_start = time.time()
        grid = GRIDS[multi_pod]
        chips = int(np.prod(grid))
        opt_dtype, auto_remat = choose_memory_policy(arch, shape.kind, chips, H100)
        kw = dict(pipeline_on_pod=pipeline, schedule=schedule or DEFAULT_SCHEDULE,
                  vstages=vstages or 1, remat=remat or auto_remat, optimizer_dtype=opt_dtype,
                  hierarchical_a2a=hierarchical_a2a, a2a_chunks=a2a_chunks or 1,
                  compress_p2p=compress_p2p)
        stages = []
        pp = grid[0] if pipeline else 1
        for s in range(pp):
            with fake_world(chips, rank=s * (chips // pp)):
                plan = sharding.make_plan(arch, grid, **kw)
                if s == 0:
                    record.update(
                        chips=chips, ep=plan.ep, tp=plan.tp, pp=plan.pp, dp=plan.dp,
                        schedule=plan.schedule if plan.pp > 1 else None,
                        vstages=plan.vstages if plan.pp > 1 else None,
                        optimizer_dtype=opt_dtype, remat=plan.remat,
                        **model_records(arch, shape, plan))
                    if plan.pp > 1:
                        record["microbatches"] = plan.num_microbatches
                with obs.span("dryrun.trace", cell=cell, stage=s):
                    got = trace_step(arch, shape.kind, plan, shape.global_batch,
                                     shape.seq_len)
                stages.append({"stage": s, "rank": plan.rank, **got})
        worst = max(stages, key=lambda g: g["memory"]["peak_bytes"])
        peak = worst["memory"]["peak_bytes"]
        record.update(
            status="ok", trace_seconds=time.time() - t_start,
            memory={**worst["memory"], "hbm_bytes": H100.hbm_bytes,
                    "fits": peak <= H100.hbm_bytes},
            cost={k: max(g["cost"][k] for g in stages) for k in worst["cost"]},
            collectives=max(stages, key=lambda g: g["collectives"]["total_wire_bytes"])
            ["collectives"],
            kernels=worst["kernels"])
        if pipeline:
            record["stages"] = stages
    except Exception as e:  # noqa: BLE001
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    if save:
        _save(record)
    return record


def _save(record: dict):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    with open(RESULTS_DIR / f"{record['cell']}.json", "w") as f:
        json.dump(record, f, indent=1)


def all_cells(pipeline_moe: bool = True):
    """The full matrix: every assigned arch x shape on both grids, and the
    paper's pipeline over the pod axis for the MoE and hybrid archs."""
    from repro_torch.configs import ASSIGNED, SHAPES

    cells = []
    for arch in ASSIGNED:
        for shape in SHAPES:
            cells.append((arch, shape, False, False))
            cells.append((arch, shape, True, False))
    if pipeline_moe:
        for arch in PIPELINE_ARCHS:
            cells.append((arch, "train_4k", True, True))
    return cells


def _run_all(jobs: int, force: bool):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for arch, shape, mp, pp in all_cells():
        cell = _cell_name(arch, shape, mp, pp)
        if (RESULTS_DIR / f"{cell}.json").exists() and not force:
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape] + (["--multi-pod"] if mp else []) + (
            ["--pipeline"] if pp else [])
        pending.append((cell, cmd))
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    running = []
    while pending or running:
        while pending and len(running) < jobs:
            cell, cmd = pending.pop(0)
            print(f"[dryrun] launch {cell}", flush=True)
            running.append((cell, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                                   stderr=subprocess.DEVNULL, env=env),
                            time.time()))
        for item in [r for r in running if r[1].poll() is not None]:
            running.remove(item)
            cell, p, t0 = item
            print(f"[dryrun] {cell}: rc={p.returncode} ({time.time() - t0:.0f}s)", flush=True)
        time.sleep(1)
    n = {"ok": 0, "skipped": 0, "error": 0}
    for f in sorted(RESULTS_DIR.glob("*.json")):
        rec = json.loads(f.read_text())
        n[rec.get("status")] = n.get(rec.get("status"), 0) + 1
        if rec.get("status") == "error":
            print(f"[dryrun] ERROR {rec['cell']}: {rec.get('error')}")
    print(f"[dryrun] ok={n['ok']} skipped={n['skipped']} error={n['error']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="Piper: pipeline stages over the pod axis")
    ap.add_argument("--schedule", default=None,
                    help="pipeline schedule (gpipe|1f1b|1f1b_overlap|interleaved_1f1b|zb_h1)")
    ap.add_argument("--vstages", type=int, default=None,
                    help="virtual stages a stage (interleaved_1f1b)")
    ap.add_argument("--hierarchical-a2a", action="store_true")
    ap.add_argument("--a2a-chunks", type=int, default=None,
                    help="chunk depth of the double-buffered EP a2a (1 = monolithic)")
    ap.add_argument("--compress-p2p", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--dispatch", default=None,
                    help="MoE expert dispatch (capacity|ragged); default: the arch's")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--metrics-out", default=None,
                    help="write the trace spans as JSONL (in-process cells only; "
                         "--all fans out to subprocesses)")
    args = ap.parse_args(argv)
    if args.metrics_out:
        obs.configure(enabled=True, sinks=[obs.JsonlSink(args.metrics_out)])
    if args.all:
        _run_all(args.jobs, args.force)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, pipeline=args.pipeline,
                   schedule=args.schedule, vstages=args.vstages,
                   hierarchical_a2a=args.hierarchical_a2a, a2a_chunks=args.a2a_chunks,
                   compress_p2p=args.compress_p2p, remat=args.remat,
                   dispatch=args.dispatch, tag=args.tag)
    obs.get_telemetry().close()
    print(json.dumps({k: v for k, v in rec.items() if k not in ("traceback", "stages")},
                     indent=1)[:3000])
    if rec.get("status") == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
