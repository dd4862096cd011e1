"""Child processes of test_torch_ssm_train.py and test_torch_jamba.py.

    python tests/_torch_ssm_child.py jax WHAT IN.npz OUT.npz
        The JAX package on 8 fake host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on the
        params and tokens of IN.npz (the test's conversion of the reference's
        ``init_params``).  WHAT "ssm": the reduced mamba2's loss and
        gradients under the reference's plan at (1, 2) and (2, 2), and its
        pipeline executor's at (2, 1, 1) under 1f1b.  WHAT "jamba": the
        reduced jamba's at (1, 2) (ep 2), the all-to-all's payload in fp32
        (``_transport_bf16`` replaced in this process, as
        ``scripts/replication_wire_diag.py --wire-off`` does).  Writes
        OUT.npz.

    python tests/_torch_ssm_child.py port WHAT IN.npz OUT_DIR
        The port on gloo ranks (``spawn``, a ``file://`` rendezvous in
        OUT_DIR, no port), needing nothing of the reference.  WHAT "ssm": 2
        ranks for (1, 2) (the sliced plan and its all-whole control, and a
        train step's grad norm), the
        pipeline at (2, 1, 1) under 1f1b and zb_h1, and ``launch/train.py
        --arch mamba2-370m --reduced --mesh 1,2``; then 4 ranks for (2, 2)
        (the same but the pipeline and the launcher).
        WHAT "jamba": 2 ranks at (1, 2): loss and gradients with the bf16
        wire (sliced and whole) and with an fp32 one, and one AdamW step
        (fp32 wire) beside world 1's on rank 0.  Each rank writes
        ``OUT_DIR/<what><world>_rank<r>.npz``.

Only the ``jax`` mode imports JAX.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

from _torch_ep_child import _paths, _unflatten
from _torch_mesh_child import _clone, _flat_np, _params

NAMES = {"ssm": "mamba2-370m", "jamba": "jamba-1.5-large-398b"}
GRIDS = {"ssm": ((1, 2), (2, 2)), "jamba": ((1, 2),)}
PP_MESH, PP_SCHEDULES = (2, 1, 1), ("1f1b", "zb_h1")
BATCH = (4, 32)  # one sequence a rank at (2, 2); one a microbatch under PP 2 (M = 4)
ZERO_TAGS = ("vocab", "embed", "model_out", "ssm_inner")


def arch_of(base):
    """The reduced arch, at capacity factor 16 where it has experts (no
    layout drops a row), ragged dispatch."""
    if base.moe is None:
        return base
    return base.replace(moe=dataclasses.replace(base.moe, dispatch="ragged",
                                                capacity_factor=16.0))


def launch_args(out_dir: str):
    return ["--arch", NAMES["ssm"], "--reduced", "--device", "cpu", "--mesh", "1,2",
            "--steps", "3", "--batch", str(BATCH[0]), "--seq", str(BATCH[1]),
            "--metrics-out", f"{out_dir}/ssm_train.jsonl"]


# ---------------------------------------------------------------------------
# JAX reference
# ---------------------------------------------------------------------------


def run_jax(what: str, in_path: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.models.model import LanguageModel
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    inp = dict(np.load(in_path))
    arch = arch_of(get_arch(NAMES[what]).reduced())
    params = jax.tree.map(jnp.asarray, _unflatten(
        {k[len("params/"):]: v for k, v in inp.items() if k.startswith("params/")}))
    batch = {"tokens": jnp.asarray(inp["toks"]), "labels": jnp.asarray(inp["toks"])}
    out = {}

    def keep(tag, loss, g):
        out[f"{tag}/loss"] = np.asarray(loss)
        for k, v in _paths(g).items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out[f"{tag}/grad/{k}"] = np.asarray(v)

    def sharded(tag, shape):
        plan = make_plan(host_mesh(shape, ("data", "model")), arch)
        lm = LanguageModel(arch, plan)
        with plan.mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p: lm.loss(p, batch), has_aux=True, allow_int=True))(params)
        keep(tag, loss, g)

    if what == "jamba":
        from repro.models import moe as moe_lib

        moe_lib._transport_bf16 = lambda a2a_fn, x: a2a_fn(x)
        sharded("fp32wire", GRIDS[what][0])
    else:
        for shape in GRIDS[what]:
            sharded(",".join(map(str, shape)), shape)
    if what == "ssm":
        plan = make_plan(host_mesh(PP_MESH, ("pod", "data", "model")), arch,
                         pipeline_on_pod=True, schedule="1f1b")
        lm = LanguageModel(arch, plan)
        with plan.mesh:
            loss, g, _ = jax.jit(lm.loss_and_grads)(params, batch)
        keep("pp", loss, g)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# Port ranks
# ---------------------------------------------------------------------------


def whole_control(plan):
    return dataclasses.replace(plan, rules={**plan.rules, **{t: None for t in ZERO_TAGS}})


def _rank_main(rank: int, world: int, what: str, in_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv_{what}{world}",
                            rank=rank, world_size=world)
    try:
        inp = dict(np.load(in_path))
        res = _ranks(rank, world, what, inp, out_dir)
        np.savez(Path(out_dir) / f"{what}{world}_rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _run(res, tag, lm, params, batch):
    """Loss and gathered gradients (fp32 compute) of ``lm`` on the whole
    ``params``."""
    import torch

    from repro_torch import training
    from repro_torch.convert import gather_params, shard_params

    loss, _, grads = training.loss_and_grads(lm, shard_params(params, lm.plan), batch,
                                             torch.float32)
    res[f"{tag}/loss"] = loss.numpy()
    _flat_np(f"{tag}/grad", gather_params(grads, lm.plan), res)


def _ranks(rank: int, world: int, what: str, inp, out_dir: str):
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.launch import train as train_launch
    from repro_torch.models import moe
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init

    res = {}
    arch = arch_of(get_arch(NAMES[what]).reduced())
    params = _params(inp, "params/")
    batch = {"tokens": inp["toks"], "labels": inp["toks"]}
    for shape in GRIDS[what]:
        if int(np.prod(shape)) != world:
            continue
        g = ",".join(map(str, shape))
        plan = sharding.make_plan(arch, shape)
        res[f"{g}/sliced"] = np.asarray(sorted(plan.layout))
        for kind, p in (("sliced", plan), ("whole", whole_control(plan))):
            _run(res, f"{g}/{kind}", LanguageModel(arch, p), params, batch)
        if what == "ssm":  # the clip's grad norm: each replicated leaf counted once
            st = {"params": _clone(shard_params(params, plan)), **adamw_init(
                shard_params(params, plan))}
            _, met = training.make_train_step(LanguageModel(arch, plan), OptimizerConfig(
                lr=1e-3), compute_dtype=torch.float32)(st, batch)
            res[f"{g}/grad_norm"] = met["grad_norm"].numpy()
    if what == "ssm" and world == 2:
        for name in PP_SCHEDULES:
            plan = sharding.make_plan(arch, PP_MESH, pipeline_on_pod=True, schedule=name)
            _run(res, f"pp/{name}", LanguageModel(arch, plan), params, batch)
        s = train_launch.main(launch_args(out_dir))
        res["launch/loss"] = np.asarray(s["loss"])
        res["launch/step_n"] = np.asarray(s.get("drift", {}).get("step", {}).get("n", 0))
        res["launch/skipped"] = np.asarray(s["skipped"])
        res["launch/ep"] = np.asarray(s["ep"])
    if what == "jamba":
        # With an fp32 wire: the loss and gradients at (1, 2), one AdamW step
        # there, gathered, and world 1's on rank 0.
        moe.WIRE_DTYPE = torch.float32
        plan = sharding.make_plan(arch, GRIDS[what][0])
        _run(res, "fp32wire", LanguageModel(arch, plan), params, batch)
        opt = OptimizerConfig(lr=1e-3)
        for tag, p in (("step", plan), ("step1", None)):
            if p is None and rank:
                continue
            lm = LanguageModel(arch, p)
            mine = _clone(shard_params(params, p) if p else params)
            st = {"params": mine, **adamw_init(mine)}
            _, met = training.make_train_step(lm, opt, compute_dtype=torch.float32)(st, batch)
            res[f"{tag}/loss"] = met["loss"].numpy()
            res[f"{tag}/skipped"] = np.asarray(met["skipped"])
            res[f"{tag}/grad_norm"] = met["grad_norm"].numpy()
            for k in ("params", "m"):
                _flat_np(f"{tag}/{k}", gather_params(st[k], p) if p else st[k], res)
    return res


def run_port(what: str, in_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp

    for world in sorted({int(np.prod(s)) for s in GRIDS[what]}):
        mp.start_processes(_rank_main, args=(world, what, in_path, out_dir), nprocs=world,
                           start_method="spawn")


if __name__ == "__main__":
    mode, what = sys.argv[1], sys.argv[2]
    if mode == "jax":
        run_jax(what, sys.argv[3], sys.argv[4])
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        run_port(what, sys.argv[3], sys.argv[4])
