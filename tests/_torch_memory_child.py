"""Child processes of test_torch_memory.py.

    python tests/_torch_memory_child.py jax OUT.npz GRID
        The JAX package on 8 fake host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=8``): its model's
        loss and gradients, whose expert d_ff is ZeRO-3 sharded over
        ("data", "tp"), on the reduced granite at grid "dp", (2, 2) (8
        experts: D 2 x ep 2), or "tp", (1, 4) with 6 experts (ep 2 x tp
        2).  Writes inputs and results to OUT.npz.

    python tests/_torch_memory_child.py port REF.npz[,REF.npz] OUT_DIR
        The port on 4 gloo ranks of this machine's CPU (``spawn``, a
        ``file://`` rendezvous in OUT_DIR, no port): at both grids, the
        d_ff split against the whole-slot control (the plan with ``ffn_split = 1``)
        and the reference; the expert bytes a rank holds; one AdamW step;
        remat none against full under the split; a split checkpoint
        restored at world 1 and back; a migration on the slices; a grid
        whose D * tp does not divide the d_ff.  Each rank writes
        ``OUT_DIR/r4_rank<r>.npz``.

    python tests/_torch_memory_child.py pp OUT_DIR
        The port's schedule-executing pipeline on 2 gloo ranks (PP 2, depth
        4) under 1f1b, zb_h1 and interleaved_1f1b (V 2), each at remat
        none, dots and full.  Each rank writes ``OUT_DIR/pp_rank<r>.npz``.

Only the ``jax`` mode imports JAX.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

from _torch_ep_child import _paths, _unflatten
from _torch_mesh_child import (
    _clone, _flat_np, _params, _quiet, _restore_crc_equal, _sharded_state, random_moments,
)

NAME = "granite-moe-3b-a800m"
MODES = ("capacity", "ragged")
# tag -> (mesh, experts): D 2 x ep 2, and ep 2 x tp 2; both split the
# reduced d_ff (64) in two.
GRIDS = {"dp": ((2, 2), 8), "tp": ((1, 4), 6)}
BATCH = (8, 16)  # (b, s): 32 tokens a rank at 4 ranks
PP_DEPTH, PP_BATCH = 4, (8, 16)
PP_SCHEDULES = (("1f1b", 1), ("zb_h1", 1), ("interleaved_1f1b", 2))
REMATS = ("none", "dots", "full")
SWAP = (0, 5)  # a migration swapping these slots of every rep (EP ranks 0 and 1)


def arch_of(base, mode, experts):
    return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode, num_experts=experts,
                                                capacity_factor=16.0))


def tokens():
    return np.random.default_rng(3).integers(0, 512, size=BATCH).astype(np.int32)


# ---------------------------------------------------------------------------
# JAX reference
# ---------------------------------------------------------------------------


def run_jax(out_path: str, tag: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.models.model import LanguageModel, init_params
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    base = get_arch(NAME).reduced()
    toks = tokens()
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    out = {"toks": toks}
    mesh, experts = GRIDS[tag]
    params = init_params(arch_of(base, "ragged", experts), jax.random.PRNGKey(0))
    out.update({f"{tag}/params/{k}": np.asarray(v) for k, v in _paths(params).items()})
    for mode in MODES:
        arch = arch_of(base, mode, experts)
        plan = make_plan(host_mesh(mesh, ("data", "model")), arch)
        out[f"{tag}/{mode}/ep_tp"] = np.asarray([plan.ep, plan.tp])
        lm = LanguageModel(arch, plan)
        with plan.mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, lm=lm: lm.loss(p, batch), has_aux=True, allow_int=True))(params)
        out[f"{tag}/{mode}/loss"] = np.asarray(loss)
        for k, v in _paths(g).items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out[f"{tag}/{mode}/grad/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# Port ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, phase: str, ref_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv_{phase}",
                            rank=rank, world_size=world)
    try:
        ref = {}
        for path in ref_path.split(",") if phase != "pp" else ():
            ref.update(np.load(path))
        res = _phase_pp(rank) if phase == "pp" else _phase4(rank, ref, out_dir)
        np.savez(Path(out_dir) / f"{phase}_rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _expert_bytes(state) -> int:
    """Bytes of the expert leaves of params, m and v a rank holds."""
    from repro_torch import sharding
    from repro_torch.models.model import tree_paths

    total = 0
    for part in ("params", "m", "v"):
        flat = tree_paths(state[part])
        total += sum(flat[k].numel() * flat[k].element_size()
                     for k in sharding.expert_paths(flat))
    return total


def _phase4(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, shard_params, state_from_numpy
    from repro_torch.core import migration as mig
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    res = {}
    base = get_arch(NAME).reduced()
    batch = {"tokens": ref["toks"], "labels": ref["toks"]}
    opt = OptimizerConfig(lr=1e-3)
    for tag, (mesh, experts) in GRIDS.items():
        params = _params(ref, f"{tag}/params/")
        for mode in MODES:
            arch = arch_of(base, mode, experts)
            split = sharding.make_plan(arch, mesh)
            plans = {"split": split, "whole": dataclasses.replace(split, ffn_split=1,
                                                                   ffn_whole="control")}
            res[f"{tag}/{mode}/ffn_split"] = np.asarray(
                [plans["split"].ffn_split, plans["whole"].ffn_split])
            res[f"{tag}/{mode}/describe"] = np.asarray(plans["split"].describe())
            for kind, plan in plans.items():
                lm = LanguageModel(arch, plan)
                mine = shard_params(params, plan)
                loss, _, grads = training.loss_and_grads(lm, mine, batch, torch.float32)
                res[f"{tag}/{mode}/{kind}/loss"] = loss.numpy()
                _flat_np(f"{tag}/{mode}/{kind}/grad", gather_params(grads, plan), res)
                for odt in ("float32", "bfloat16"):
                    st = {"params": mine, **adamw_init(mine, odt)}
                    res[f"{tag}/{mode}/{kind}/bytes/{odt}"] = np.asarray(_expert_bytes(st))
                st = {"params": _clone(mine), **adamw_init(mine)}
                _, met = training.make_train_step(lm, opt)(st, batch)
                res[f"{tag}/{mode}/{kind}/step/skipped"] = np.asarray(met["skipped"])
                res[f"{tag}/{mode}/{kind}/step/grad_norm"] = met["grad_norm"].numpy()
                _flat_np(f"{tag}/{mode}/{kind}/step/params", gather_params(st["params"], plan),
                         res)
            # The split under remat none: the same bits (the recompute
            # gathers the slices again).
            nplan = sharding.make_plan(arch, mesh, remat="none")
            loss, _, grads = training.loss_and_grads(LanguageModel(arch, nplan),
                                                     shard_params(params, nplan), batch,
                                                     torch.float32)
            res[f"{tag}/{mode}/none/loss"] = loss.numpy()
            _flat_np(f"{tag}/{mode}/none/grad", gather_params(grads, nplan), res)

    # A split checkpoint (bf16 moments, seeded random) restored at world 1,
    # saved again there and restored split: the same state, bit for bit.
    tag = "dp"
    mesh, experts = GRIDS[tag]
    arch = arch_of(base, "ragged", experts)
    plan = sharding.make_plan(arch, mesh, optimizer_dtype="bfloat16")
    lm = LanguageModel(arch, plan)
    flat = {t: {k: np.asarray(v) for k, v in tree_paths(training.init_state(
        LanguageModel(arch), torch.Generator().manual_seed(0), "cpu")[t]).items()}
        for t in ("params", "m", "v")}
    flat = random_moments(flat)
    state = {t: _unflatten(flat[t]) for t in ("params", "m", "v")}
    state["step"] = np.asarray(2, np.int32)
    glob = state_from_numpy(state, "cpu")
    glob = {t: (training._cast(v, torch.bfloat16) if t in ("m", "v") else v)
            for t, v in glob.items()}
    mine = _sharded_state(glob, plan)
    res["ck/moment_dtype"] = np.asarray(str(mine["m"]["embed"].dtype))
    ck, ck1 = f"{out_dir}/ck_split", f"{out_dir}/ck_world1"
    tr = Trainer(lm, opt, TrainerConfig(checkpoint_dir=ck), log_fn=_quiet)
    tr._save(2, mine, blocking=True)
    lm1 = LanguageModel(arch, sharding.single_device_plan(arch, optimizer_dtype="bfloat16"))
    if rank == 0:
        res["ck/world1_crc_equal"] = np.asarray(_restore_crc_equal(ck, lm1, glob))
        tr1 = Trainer(lm1, opt, TrainerConfig(checkpoint_dir=ck), log_fn=_quiet)
        st1 = training.init_state(lm1, torch.Generator().manual_seed(5), "cpu")
        st1, _ = tr1._restore_latest(st1)
        Trainer(lm1, opt, TrainerConfig(checkpoint_dir=ck1), log_fn=_quiet)._save(2, st1, True)
    torch.distributed.barrier()
    res["ck/split_crc_equal"] = np.asarray(_restore_crc_equal(ck1, lm, glob))

    # A migration on the slices: params, m and v equal the manual
    # permutation of the gathered state.
    before = {t: {k: v.clone() for k, v in tree_paths(gather_params(mine[t], plan)).items()}
              for t in ("params", "m", "v")}
    reps = arch.num_layers // len(arch.block_pattern)
    perm = np.tile(np.arange(experts, dtype=np.int32), (reps, 1))
    perm[:, list(SWAP)] = perm[:, list(SWAP[::-1])]
    got = 0
    for pos in range(len(arch.block_pattern)):
        for t in ("params", "m", "v"):
            got += mig.apply_migration_(mine[t]["blocks"][pos]["ffn"], perm, plan)
    res["mig/bytes"] = np.asarray(got)
    exact = True
    for t in ("params", "m", "v"):
        after = tree_paths(gather_params(mine[t], plan))
        for k in sharding.expert_paths(after):
            w = before[t][k]
            idx = torch.from_numpy(perm).long().reshape(perm.shape + (1,) * (w.dim() - 2))
            exact &= torch.equal(after[k], torch.gather(w, 1, idx.expand(w.shape)))
    res["mig/exact"] = np.asarray(exact)

    # D * tp = 2 does not divide an odd d_ff: whole slots, said so, and the
    # step runs as before.
    arch = base.replace(moe=dataclasses.replace(base.moe, d_ff=63, capacity_factor=16.0))
    plan = sharding.make_plan(arch, (2, 2))
    res["odd/ffn_split"] = np.asarray(plan.ffn_split)
    res["odd/describe"] = np.asarray(plan.describe())
    st = _sharded_state(training.init_state(LanguageModel(arch), torch.Generator().manual_seed(0),
                                            "cpu"), plan)
    _, met = training.make_train_step(LanguageModel(arch, plan), opt)(st, batch)
    res["odd/loss"] = met["loss"].numpy()
    res["odd/skipped"] = np.asarray(met["skipped"])
    return res


def _phase_pp(rank: int):
    """The pipeline executors at PP 2, depth 4, under each remat."""
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_params
    from repro_torch.models.model import LanguageModel, init_params

    res = {}
    base = get_arch(NAME).reduced()
    arch = base.replace(num_layers=PP_DEPTH, moe=dataclasses.replace(
        base.moe, dispatch="ragged", capacity_factor=16.0))
    params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(4).integers(0, 512, size=PP_BATCH).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    for sched, V in PP_SCHEDULES:
        for remat in REMATS:
            plan = sharding.make_plan(arch, (2, 1, 1), pipeline_on_pod=True, schedule=sched,
                                      vstages=V, remat=remat)
            loss, _, grads = training.loss_and_grads(LanguageModel(arch, plan),
                                                     shard_params(params, plan), batch)
            res[f"{sched}/{remat}/loss"] = loss.numpy()
            _flat_np(f"{sched}/{remat}/grad", grads, res)
    return res


def run_port(ref_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(4, "r4", ref_path, out_dir), nprocs=4,
                       start_method="spawn")


def run_pp(out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(2, "pp", "", out_dir), nprocs=2,
                       start_method="spawn")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(sys.argv[2], sys.argv[3])
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        if sys.argv[1] == "pp":
            run_pp(sys.argv[2])
        else:
            run_port(sys.argv[2], sys.argv[3])
