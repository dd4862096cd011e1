"""Child processes of test_torch_zero.py.

    python tests/_torch_zero_child.py jax OUT.npz
        The JAX package on 8 fake host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=8``): every
        leaf's index block on each device under ``param_specs`` at each grid
        of ``LAYOUT_GRIDS``; the loss and gradients of its plan at (2, 2) for
        the reduced granite (ragged) and the mixed dense / MoE config; its
        pipeline executor's at (2, 1, 2) under 1f1b (its schedules give the
        same gradients; one compile is ~10 s); its engine's tokens at (2, 2).
        Writes inputs and results to OUT.npz.

    python tests/_torch_zero_child.py r2 OUT_DIR
        The port on 2 gloo ranks (``spawn``, a ``file://`` rendezvous in
        OUT_DIR, no port), needing nothing of the reference: at (1, 2) and
        (2, 1) the sliced plan against the all-whole control (both dispatch
        modes, remat none and full, bf16 compute), one AdamW step each, and
        a sliced checkpoint restored at world 1 and back.  Each rank writes
        ``OUT_DIR/r2_rank<r>.npz``.

    python tests/_torch_zero_child.py r4 REF.npz OUT_DIR
        4 gloo ranks: at (2, 2) the sliced plan against the control and the
        reference's plan (granite, ragged; the mixed config), the
        non-expert bytes a rank holds, a swap-only migration, the engine's
        tokens; at (2, 1, 2) the pipeline executors' gradients, a PP 2
        checkpoint at world 1, the pod folded into data against its
        control, and the dry run's count of a train step at (2, 2) on real
        tensors (``launch.dryrun.trace_step``).  Each rank writes
        ``OUT_DIR/r4_rank<r>.npz``.

Only the ``jax`` mode imports JAX.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

from _torch_ep_child import _paths, _tokens, _unflatten
from _torch_mesh_child import (
    _clone, _flat_np, _params, _quiet, _restore_crc_equal, _sharded_state, random_moments,
)

NAME = "granite-moe-3b-a800m"
MODES = ("capacity", "ragged")
REMATS = ("none", "full")
# tag -> (mesh, experts, pipeline_on_pod): the grids whose held layout the
# tests hold against the reference's.
LAYOUT_GRIDS = {"2,2": ((2, 2), 8, False), "1,4": ((1, 4), 6, False),
                "2,1,2pp": ((2, 1, 2), 8, True), "2,1,2": ((2, 1, 2), 8, False)}
R2_GRIDS = ((1, 2), (2, 1))
BATCH = (8, 16)  # 32 tokens a rank at 4 ranks
PP_MESH, PP_DEPTH, PP_BATCH = (2, 1, 2), 4, (8, 32)
PP_SCHEDULES = ("1f1b", "zb_h1")
SERVE = dict(max_seqs=2, block_size=4, num_blocks=32, cache_dtype="float32")
SWAP = (0, 5)  # a migration swapping these slots of every rep (EP ranks 0 and 1)
ZERO_TAGS = ("vocab", "embed", "model_out", "ssm_inner")
DRYRUN_MODES = MODES
# The dry run's train step at (2, 2): batch, sequence.  A rank holds 3 rows
# of 17 positions, so its T k = 102 rows are no multiple of E = 8, and its
# EP ranks receive different row counts under the balanced routing.
DRYRUN_BATCH = (6, 34)


def arch_of(base, mode="ragged", experts=8, **kw):
    return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode, num_experts=experts,
                                                capacity_factor=16.0), **kw)


def mixed_of(base):
    """A reduced config whose pattern mixes a dense-FFN block with a MoE
    block."""
    return arch_of(base, block_pattern=(("attn", "dense"), ("attn", "moe")), d_ff=128,
                   num_layers=4)


def pp_arch(base):
    """The pipeline child's arch: depth 4, aux loss 0 (its per-microbatch
    mean differs from the global one)."""
    return base.replace(num_layers=PP_DEPTH, moe=dataclasses.replace(
        base.moe, dispatch="ragged", capacity_factor=16.0, aux_loss_coef=0.0))


def tokens(shape=BATCH, seed=3):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(np.int32)


def serve_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 4, size=6) for _ in range(3)]


def whole_control(plan):
    """The plan with every non-expert tag mapped to None: the all-whole
    control of the same grid and groups."""
    return dataclasses.replace(plan, rules={**plan.rules, **{t: None for t in ZERO_TAGS}})


# ---------------------------------------------------------------------------
# JAX reference
# ---------------------------------------------------------------------------


def run_jax(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import training as jtraining
    from repro.configs import get_arch
    from repro.models.model import LanguageModel, init_params, param_specs, param_tree
    from repro.serving.engine import Engine, Request, ServeConfig
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    base = get_arch(NAME).reduced()
    out = {}

    def mesh_of(shape):
        return host_mesh(shape, ("pod", "data", "model") if len(shape) == 3
                         else ("data", "model"))

    # 1. Every leaf's block on each device of each grid.
    for tag, (shape, experts, pod) in LAYOUT_GRIDS.items():
        arch = arch_of(base, experts=experts)
        plan = make_plan(mesh_of(shape), arch, pipeline_on_pod=pod)
        metas = _paths(param_tree(arch))
        specs = _paths(param_specs(arch, plan))
        devices = list(plan.mesh.devices.flat)
        for path, meta in metas.items():
            imap = NamedSharding(plan.mesh, specs[path]).devices_indices_map(meta.shape)
            out[f"layout/{tag}/{path}"] = np.asarray(
                [[(ix.start or 0, meta.shape[i] if ix.stop is None else ix.stop)
                  for i, ix in enumerate(imap[dev])] for dev in devices], np.int64)

    def loss_and_grads(tag, arch, plan, params, batch):
        lm = LanguageModel(arch, plan)
        with plan.mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p: lm.loss(p, batch), has_aux=True, allow_int=True))(params)
        out[f"{tag}/loss"] = np.asarray(loss)
        for k, v in _paths(g).items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out[f"{tag}/grad/{k}"] = np.asarray(v)

    # 2. The reference's plan at (2, 2): granite; the mixed config.
    toks = tokens()
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    params = init_params(arch_of(base), jax.random.PRNGKey(0))
    out.update({f"params/{k}": np.asarray(v) for k, v in _paths(params).items()})
    arch = arch_of(base)
    loss_and_grads("ref", arch, make_plan(mesh_of((2, 2)), arch), params, batch)
    arch = mixed_of(base)
    mparams = init_params(arch, jax.random.PRNGKey(1))
    out.update({f"mixed_params/{k}": np.asarray(v) for k, v in _paths(mparams).items()})
    loss_and_grads("mixed", arch, make_plan(mesh_of((2, 2)), arch), mparams, batch)

    # 3. The executor at (2, 1, 2).
    arch = pp_arch(base)
    pparams = init_params(arch, jax.random.PRNGKey(2))
    out.update({f"pp_params/{k}": np.asarray(v) for k, v in _paths(pparams).items()})
    ptoks = tokens(PP_BATCH, 4)
    pbatch = {"tokens": jnp.asarray(ptoks), "labels": jnp.asarray(ptoks)}
    plan = make_plan(mesh_of(PP_MESH), arch, pipeline_on_pod=True, schedule="1f1b")
    lm = LanguageModel(arch, plan)
    with plan.mesh:
        loss, g, _ = jax.jit(lm.loss_and_grads)(pparams, pbatch)
    out["pp/loss"] = np.asarray(loss)
    for k, v in _paths(g).items():
        if np.issubdtype(np.asarray(v).dtype, np.floating):
            out[f"pp/grad/{k}"] = np.asarray(v)

    # 4. The engine at (2, 2), its params placed by the reference's specs.
    arch = arch_of(base)
    plan = make_plan(mesh_of((2, 2)), arch)
    lm = LanguageModel(arch, plan)
    specs = jtraining.state_specs(lm)["params"]
    placed = jax.device_put(params, jax.tree.map(lambda sp: NamedSharding(plan.mesh, sp),
                                                 specs))
    with plan.mesh:
        res = Engine(lm, placed, ServeConfig(**SERVE)).run(
            [Request(rid=i, tokens=t, max_new_tokens=6) for i, t in enumerate(serve_prompts())])
    out["serve/tokens"] = _tokens(res)
    out["toks"], out["pp_toks"] = toks, ptoks
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
        res = (_phase2(rank, out_dir) if phase == "r2"
               else _phase4(rank, dict(np.load(ref_path)), out_dir))
        np.savez(Path(out_dir) / f"{phase}_rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _run(res, tag, lm, params, batch, dtype):
    """Loss and gathered gradients of ``lm`` on the whole ``params``."""
    from repro_torch import training
    from repro_torch.convert import gather_params, shard_params

    loss, _, grads = training.loss_and_grads(lm, shard_params(params, lm.plan), batch, dtype)
    res[f"{tag}/loss"] = loss.numpy()
    _flat_np(f"{tag}/grad", gather_params(grads, lm.plan), res)


def _step(res, tag, lm, params, batch, opt):
    """One AdamW step from the whole ``params``: grad norm, gathered params."""
    from repro_torch import training
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.optim.optimizer import adamw_init

    mine = _clone(shard_params(params, lm.plan))
    st = {"params": mine, **adamw_init(mine)}
    _, met = training.make_train_step(lm, opt)(st, batch)
    res[f"{tag}/skipped"] = np.asarray(met["skipped"])
    res[f"{tag}/grad_norm"] = met["grad_norm"].numpy()
    _flat_np(f"{tag}/params", gather_params(st["params"], lm.plan), res)


def _global_state(arch, optimizer_dtype="float32"):
    """A seeded whole state with random moments, as torch."""
    import torch

    from repro_torch import training
    from repro_torch.convert import state_from_numpy
    from repro_torch.models.model import LanguageModel, tree_paths

    st = training.init_state(LanguageModel(arch), torch.Generator().manual_seed(0), "cpu")
    flat = random_moments({t: {k: v.numpy() for k, v in tree_paths(st[t]).items()}
                           for t in ("params", "m", "v")})
    state = {t: _unflatten(flat[t]) for t in ("params", "m", "v")}
    state["step"] = np.asarray(2, np.int32)
    return state_from_numpy(state, "cpu")


def _phase2(rank: int, out_dir: str):
    import torch

    from repro_torch import sharding
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    res = {}
    base = get_arch(NAME).reduced()
    toks = tokens((4, 16))
    batch = {"tokens": toks, "labels": toks}
    opt = OptimizerConfig(lr=1e-3)
    params = init_params(arch_of(base), torch.Generator().manual_seed(0), "cpu")
    for mesh in R2_GRIDS:
        g = ",".join(map(str, mesh))
        for mode in MODES:
            arch = arch_of(base, mode)
            for remat in REMATS:
                plan = sharding.make_plan(arch, mesh, remat=remat)
                res[f"{g}/sliced"] = np.asarray(sorted(plan.layout))
                for kind, p in (("sliced", plan), ("whole", whole_control(plan))):
                    _run(res, f"{g}/{mode}/{remat}/{kind}", LanguageModel(arch, p), params,
                         batch, torch.bfloat16)
        plan = sharding.make_plan(arch_of(base), mesh)
        for kind, p in (("sliced", plan), ("whole", whole_control(plan))):
            _step(res, f"{g}/step/{kind}", LanguageModel(arch_of(base), p), params, batch, opt)

    # A sliced checkpoint (random moments) restored at world 1, saved again
    # there and restored sliced: the same state, bit for bit.
    arch = arch_of(base)
    plan = sharding.make_plan(arch, R2_GRIDS[0])
    lm = LanguageModel(arch, plan)
    glob = _global_state(arch)
    mine = _sharded_state(glob, plan)
    ck, ck1 = f"{out_dir}/ck_sliced", f"{out_dir}/ck_world1"
    Trainer(lm, opt, TrainerConfig(checkpoint_dir=ck), log_fn=_quiet)._save(2, mine, True)
    lm1 = LanguageModel(arch)
    if rank == 0:
        res["ck/world1_crc_equal"] = np.asarray(_restore_crc_equal(ck, lm1, glob))
        tr1 = Trainer(lm1, opt, TrainerConfig(checkpoint_dir=ck), log_fn=_quiet)
        st1, _ = tr1._restore_latest(_global_state(arch))
        Trainer(lm1, opt, TrainerConfig(checkpoint_dir=ck1), log_fn=_quiet)._save(2, st1, True)
    torch.distributed.barrier()
    res["ck/sliced_crc_equal"] = np.asarray(_restore_crc_equal(ck1, lm, glob))
    return res


def _bytes(tree, keys) -> int:
    from repro_torch.models.model import tree_paths

    flat = tree_paths(tree)
    return sum(flat[k].numel() * flat[k].element_size() for k in keys)


def _phase4(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.core import migration as mig
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serving import Engine, Request, ServeConfig

    res = {}
    base = get_arch(NAME).reduced()
    batch = {"tokens": ref["toks"], "labels": ref["toks"]}
    opt = OptimizerConfig(lr=1e-3)

    # 1. (2, 2): granite against the control and the reference's plan, and
    # the bytes a rank holds; the mixed config against the reference.
    params = _params(ref, "params/")
    arch = arch_of(base)
    plan = sharding.make_plan(arch, (2, 2))
    for kind, p in (("sliced", plan), ("whole", whole_control(plan))):
        _run(res, f"2,2/{kind}", LanguageModel(arch, p), params, batch, torch.float32)
    res["describe"] = np.asarray(plan.describe())
    for kind, p in (("sliced", plan), ("whole", whole_control(plan))):
        mine = shard_params(params, p)
        for odt in ("float32", "bfloat16"):
            st = {"params": mine, **adamw_init(mine, odt)}
            res[f"bytes/{kind}/{odt}"] = np.asarray(
                [_bytes(st[t], plan.layout) for t in ("params", "m", "v")])
    arch = mixed_of(base)
    _run(res, "mixed", LanguageModel(arch, sharding.make_plan(arch, (2, 2))),
         _params(ref, "mixed_params/"), batch, torch.float32)
    res["mixed/sliced"] = np.asarray(sorted(sharding.make_plan(arch, (2, 2)).layout))

    # 2. A swap-only migration under the full slicing: params, m and v
    # gathered equal the manual permutation of the gathered state.
    arch = arch_of(base)
    plan = sharding.make_plan(arch, (2, 2))
    mine = _sharded_state(_global_state(arch), plan)
    before = {t: {k: v.clone() for k, v in tree_paths(gather_params(mine[t], plan)).items()}
              for t in ("params", "m", "v")}
    reps = arch.num_layers // len(arch.block_pattern)
    perm = np.tile(np.arange(8, dtype=np.int32), (reps, 1))
    perm[:, list(SWAP)] = perm[:, list(SWAP[::-1])]
    for t in ("params", "m", "v"):
        mig.apply_migration_(mine[t]["blocks"][0]["ffn"], perm, plan)
    exact = True
    for t in ("params", "m", "v"):
        after = tree_paths(gather_params(mine[t], plan))
        for k, w in before[t].items():
            if k in sharding.expert_paths(after):
                idx = torch.from_numpy(perm).long().reshape(perm.shape + (1,) * (w.dim() - 2))
                exact &= torch.equal(after[k], torch.gather(w, 1, idx.expand(w.shape)))
            else:
                exact &= torch.equal(after[k], w)
    res["mig/exact"] = np.asarray(exact)

    # 3. The engine at (2, 2) on the sliced params.
    eng = Engine(LanguageModel(arch, plan), shard_params(params, plan), ServeConfig(**SERVE))
    out = eng.run([Request(rid=i, tokens=t, max_new_tokens=6)
                   for i, t in enumerate(serve_prompts())])
    res["serve/tokens"] = _tokens(out)

    # 4. (2, 1, 2) pipelined: each executor's gathered gradients, then a PP 2
    # checkpoint restored at world 1.
    arch = pp_arch(base)
    pparams = _params(ref, "pp_params/")
    pbatch = {"tokens": ref["pp_toks"], "labels": ref["pp_toks"]}
    for name in PP_SCHEDULES:
        plan = sharding.make_plan(arch, PP_MESH, pipeline_on_pod=True, schedule=name)
        res["pp/sliced"] = np.asarray(sorted(plan.layout))
        _run(res, f"pp/{name}", LanguageModel(arch, plan), pparams, pbatch, torch.float32)
    glob = _global_state(arch)
    mine = _sharded_state(glob, plan)
    ck = f"{out_dir}/ck_pp"
    Trainer(LanguageModel(arch, plan), opt, TrainerConfig(checkpoint_dir=ck),
            log_fn=_quiet)._save(2, mine, True)
    if rank == 0:
        res["ppck/world1_crc_equal"] = np.asarray(_restore_crc_equal(ck, LanguageModel(arch),
                                                                     glob))

    # 5. The pod folded into data at (2, 1, 2): sliced over it, the function
    # of the control.
    arch = arch_of(base)
    plan = sharding.make_plan(arch, PP_MESH)
    res["fold/dp"] = np.asarray(plan.dp)
    for kind, p in (("sliced", plan), ("whole", whole_control(plan))):
        _run(res, f"fold/{kind}", LanguageModel(arch, p), params, batch, torch.float32)
        _step(res, f"fold/step/{kind}", LanguageModel(arch, p), params, batch, opt)

    # 6. The dry run's count of one train step on real tensors at (2, 2),
    # under its balanced routing: this rank's collectives, FLOPs and peak.
    from repro_torch.launch import dryrun

    for mode in DRYRUN_MODES:
        arch = arch_of(base, mode)
        got = dryrun.trace_step(arch, "train", sharding.make_plan(arch, (2, 2)), *DRYRUN_BATCH,
                                fake=False)
        res[f"dryrun/{mode}"] = np.asarray(json.dumps(
            {"collectives": got["collectives"], "flops": got["cost"]["flops"],
             "peak_bytes": got["memory"]["peak_bytes"]}))
    return res


def run_port(phase: str, ref_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp

    world = 2 if phase == "r2" else 4
    mp.start_processes(_rank_main, args=(world, phase, ref_path, out_dir), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(sys.argv[2])
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        if sys.argv[1] == "r2":
            run_port("r2", "", sys.argv[2])
        else:
            run_port("r4", sys.argv[2], sys.argv[3])
