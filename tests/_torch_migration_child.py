"""Child processes of test_torch_migration.py.

    python tests/_torch_migration_child.py jax OUT.npz
        The JAX package on 8 fake host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=8``): its sharded
        ``moe_ffn`` with the live replica table on the (2, 4) mesh, its
        trainer's migration controller on a seeded state and EMA, and its
        engine's serving rebalance on the (1, 4) mesh; writes inputs and
        results to OUT.npz.

    python tests/_torch_migration_child.py port REF.npz OUT_DIR
        The port on gloo ranks of this machine's CPU (``spawn``, a
        ``file://`` rendezvous in OUT_DIR, no port): 4 ranks at mesh (1, 4)
        for the controller, the migration exactness run, the checkpointed
        runs (SIGTERM and resume) and serving; then 8 ranks at (2, 4) for
        the replicated layer and the checkpoint's restore at (4, 2), EP 2.
        Each rank writes ``OUT_DIR/<phase>_rank<r>.npz``.

Only the ``jax`` mode imports JAX.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

from _torch_ep_child import _paths, _tokens, _unflatten, inputs

NAME = "granite-moe-3b-a800m"
MESH8, MESH4, MESH_EP2 = (2, 4), (1, 4), (4, 2)
B, S = 8, 16  # the layer's input (b, s, d)
TABLE = (0, 3)  # the live replica table
MODES = ("capacity", "ragged")
EXPERT_KEYS = ("w_up", "w_gate", "w_down")
SERVE = dict(max_seqs=2, block_size=4, num_blocks=32, cache_dtype="float32")
REBALANCE = dict(rebalance_every=2, rebalance_threshold=1.05)
CK_STEPS, CK_SIGTERM = 6, 4


def arch_of(base, mode, cf=16.0, replicas=2, aux=None):
    kw = dict(dispatch=mode, capacity_factor=cf, max_replicas=replicas)
    if aux is not None:
        kw["aux_loss_coef"] = aux
    return base.replace(moe=dataclasses.replace(base.moe, **kw))


def controller_ema(num_layers: int, E: int) -> np.ndarray:
    """A skewed EMA (two hot experts a layer) that the controller acts on."""
    rng = np.random.default_rng(5)
    ema = rng.exponential(1.0, size=(num_layers, E))
    ema[:, 1] += 12.0
    ema[:, 6] += 6.0
    return ema


def serve_prompts():
    """Low-entropy prompts: a few token ids, so routing is hot."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 4, size=6) for _ in range(3)]


def skewed_batch(step: int, b: int = 8, s: int = 32):
    """The reference's check_migration_exactness stream: tokens in [0, 4)."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, 4, size=(b, s), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


class SkewedTokens:
    def batch_at(self, step: int):
        return skewed_batch(step)


# ---------------------------------------------------------------------------
# JAX reference
# ---------------------------------------------------------------------------


def run_jax(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import training as jtraining
    from repro.configs import get_arch
    from repro.models import moe as jmoe
    from repro.models.model import LanguageModel, init_params
    from repro.optim import OptimizerConfig
    from repro.runtime.trainer import Trainer, TrainerConfig
    from repro.serving.engine import Engine, Request, ServeConfig
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    base = get_arch(NAME).reduced()
    params = init_params(arch_of(base, "ragged"), jax.random.PRNGKey(0))
    out = {f"params/{k}": np.asarray(v) for k, v in _paths(params).items()}
    ffn = jax.tree.map(lambda p: p[0], params["blocks"][0]["ffn"])
    live = dict(ffn, replicas=jnp.asarray(TABLE, jnp.int32))
    x = inputs(base.d_model)[0]
    mesh = host_mesh(MESH8, ("data", "model"))
    wkeys = ("w_router",) + EXPERT_KEYS

    # 1. The replicated layer: token-sharded forward and gradients, decode.
    for mode in MODES:
        arch = arch_of(base, mode)
        plan = make_plan(mesh, arch)

        def loss(f, xx, plan=plan, arch=arch):
            y, m = jmoe.moe_ffn(dict(live, **f), xx, arch, plan, token_sharded=True)
            return jnp.sum(y * y), (y, m)

        with plan.mesh:
            (_, (y, m)), (gw, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))({k: live[k] for k in wkeys}, x)
            yd, _ = jax.jit(lambda f, xx, plan=plan, arch=arch: jmoe.moe_ffn(
                f, xx, arch, plan, token_sharded=False))(live, x)
        out[f"rep/{mode}/y"], out[f"rep/{mode}/dx"] = np.asarray(y), np.asarray(gx)
        for k in wkeys:
            out[f"rep/{mode}/d{k}"] = np.asarray(gw[k])
        out[f"rep/{mode}/expert_load"] = np.asarray(m["expert_load"])
        out[f"rep/{mode}/decode"] = np.asarray(yd)

    # 2. The trainer's controller on a seeded state (random moments) and EMA.
    arch = arch_of(base, "ragged")
    plan = make_plan(mesh, arch)
    lm = LanguageModel(arch, plan)
    opt = OptimizerConfig(lr=1e-3)
    with plan.mesh:
        state = jtraining.init_state(lm, jax.random.PRNGKey(0), opt)
    rng = np.random.default_rng(7)
    state = jax.tree.map(np.asarray, state)
    for t in ("m", "v"):
        state[t] = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape).astype(a.dtype)
                       if np.issubdtype(a.dtype, np.floating) else a), state[t])
    for k, v in _paths(state).items():
        out[f"ctrl/before/{k}"] = np.asarray(v)
    tr = Trainer(lm, opt, TrainerConfig(migrate_every=1, migrate_threshold=1.05),
                 log_fn=lambda s: None)
    tr.load_stats.ema = controller_ema(arch.num_moe_layers, arch.moe.num_experts)
    with plan.mesh:
        after = tr._maybe_migrate(jax.tree.map(jnp.asarray, state), 1)
    for k, v in _paths(after).items():
        out[f"ctrl/after/{k}"] = np.asarray(v)
    rec = tr.migrations[-1]
    out["ctrl/record"] = np.asarray([rec["imbalance"], rec["imbalance_post"], rec["swaps"],
                                     rec["replicas"], float(rec["applied"])])

    # 3. Serving rebalance at (1, 4), both dispatch modes.
    mesh4 = host_mesh(MESH4, ("data", "model"))
    for mode in MODES:
        arch = arch_of(base, mode)
        plan = make_plan(mesh4, arch)
        lm = LanguageModel(arch, plan)
        specs = jtraining.state_specs(lm)["params"]
        placed = jax.device_put(params, jax.tree.map(
            lambda sp, plan=plan: NamedSharding(plan.mesh, sp), specs))
        with plan.mesh:
            eng = Engine(lm, placed, ServeConfig(**SERVE, **REBALANCE))
            res = eng.run([Request(rid=i, tokens=t, max_new_tokens=8)
                           for i, t in enumerate(serve_prompts())])
        out[f"serve/{mode}/tokens"] = _tokens(res)
        out[f"serve/{mode}/rebalance"] = np.asarray(
            [e[1:] for e in eng.trace if e[0] == "rebalance"], np.int64).reshape(-1, 3)
    out["x"] = x
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
        ref = dict(np.load(ref_path))
        res = (_phase4 if phase == "r4" else _phase8)(rank, ref, out_dir)
        np.savez(Path(out_dir) / f"{phase}_rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def unflatten_state(flat, prefix: str):
    """{prefix + "params/blocks/0/..." : leaf, ...} -> a train-state tree."""
    sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    state = {t: _unflatten({k[len(t) + 1:]: v for k, v in sub.items()
                            if k.startswith(t + "/")}) for t in ("params", "m", "v")}
    state["step"] = sub["step"]
    return state


def _ref_params(ref):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(
        _unflatten({k[len("params/"):]: v for k, v in ref.items() if k.startswith("params/")}),
        "cpu")


def _clone(tree):
    from repro_torch.models.model import map_tree

    return map_tree(lambda t: t.clone(), tree)


def _flat_np(prefix, tree, res):
    from repro_torch.models.model import tree_paths

    for k, v in tree_paths(tree).items():
        if v is not None:
            res[f"{prefix}/{k}"] = np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)


def _phase4(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_params, state_from_numpy
    from repro_torch.core import migration as mig
    from repro_torch.models.model import LanguageModel, map_tree, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serving import Engine, Request, ServeConfig
    from repro_torch.training import init_state

    res = {}
    base = get_arch(NAME).reduced()
    opt = OptimizerConfig(lr=1e-3)

    def sharded_state(state, plan):
        return {k: shard_params(v, plan) if k in ("params", "m", "v") else v
                for k, v in state.items()}

    # 1. The controller on the reference's seeded state and EMA.
    arch = arch_of(base, "ragged")
    plan = sharding.make_plan(arch, MESH4)
    state = sharded_state(_clone(state_from_numpy(unflatten_state(ref, "ctrl/before/"),
                                                  "cpu")), plan)
    tr = Trainer(LanguageModel(arch, plan), opt,
                 TrainerConfig(migrate_every=1, migrate_threshold=1.05), log_fn=lambda s: None)
    tr.load_stats.ema = controller_ema(arch.num_moe_layers, arch.moe.num_experts)
    tr._maybe_migrate(state, 1)
    _flat_np("ctrl/after", tr.global_state(state), res)
    rec = tr.migrations[-1]
    res["ctrl/record"] = np.asarray([rec["imbalance"], rec["imbalance_post"], rec["swaps"],
                                     rec["replicas"], float(rec["applied"])])
    res["ctrl/gathered_bytes"] = np.asarray(rec["gathered_bytes"])

    # 2. Migration exactness (swap-only, the reference's check): a migration
    # after step 3 is one permutation pass of params, m and v, and the loss
    # trajectory is the one of a run whose init carried the permutation.
    def gathered(tr_, st):
        return {k: v.clone() for k, v in tree_paths(tr_.global_state(st)).items()}

    for mode in MODES:
        # top-4: a token's k row gradients sum in an order a relabelling
        # could change (two terms commute).
        arch = arch_of(base, mode, cf=8.0, replicas=0, aux=0.0)
        arch = arch.replace(moe=dataclasses.replace(arch.moe, top_k=4))
        plan = sharding.make_plan(arch, MESH4)
        lm = LanguageModel(arch, plan)
        cfg = TrainerConfig(migrate_every=1, migrate_threshold=1.05)
        tr = Trainer(lm, opt, cfg, log_fn=lambda s: None)
        state = sharded_state(init_state(lm, torch.Generator().manual_seed(0), "cpu"), plan)
        losses, exact, perms = [], True, {}
        for s in range(6):
            state, met = tr.train_step(state, skewed_batch(s))
            losses.append(float(met["loss"]))
            loads = met["expert_load_host"]
            tr.load_stats.update(np.concatenate([loads[:, i] for i in range(loads.shape[1])]))
            if s == 2:
                pre = gathered(tr, state)
                tr._maybe_migrate(state, 1)
                post = gathered(tr, state)
                for pos in range(len(arch.block_pattern)):
                    head = f"blocks/{pos}/ffn"
                    old_a = pre[f"params/{head}/assignment"].numpy()
                    new_a = post[f"params/{head}/assignment"].numpy()
                    perms[pos] = np.stack([mig.permutation_for(old_a[r], new_a[r])
                                           for r in range(old_a.shape[0])])
                    for t in ("params", "m", "v"):
                        for k in EXPERT_KEYS:
                            w = pre[f"{t}/{head}/{k}"].numpy()
                            want = np.take_along_axis(
                                w, perms[pos].reshape(perms[pos].shape + (1,) * (w.ndim - 2)),
                                axis=1)
                            exact &= np.array_equal(post[f"{t}/{head}/{k}"].numpy(), want)
        res[f"exact/{mode}/applied"] = np.asarray(
            len(tr.migrations) == 1 and tr.migrations[0]["applied"])
        res[f"exact/{mode}/moved"] = np.asarray(tr.migrations[0]["swaps"])
        res[f"exact/{mode}/moments_exact"] = np.asarray(exact)
        res[f"exact/{mode}/losses"] = np.asarray(losses)
        # Run B: the permutation baked into the init, no migration.
        tr_b = Trainer(lm, opt, cfg, log_fn=lambda s: None)
        full = init_state(lm, torch.Generator().manual_seed(0), "cpu")
        for pos, perm in perms.items():
            for t in ("params", "m", "v"):
                mig.apply_migration_(full[t]["blocks"][pos]["ffn"], perm)
            full["params"]["blocks"][pos]["ffn"]["assignment"].copy_(
                post[f"params/blocks/{pos}/ffn/assignment"])
        state_b = sharded_state(full, plan)
        losses_b = []
        for s in range(6):
            state_b, met = tr_b.train_step(state_b, skewed_batch(s))
            losses_b.append(float(met["loss"]))
        res[f"exact/{mode}/losses_b"] = np.asarray(losses_b)

    # 3. Checkpoints at ep 4 (ragged, two replica channels, migrations on):
    # run A uninterrupted; run B SIGTERM at CK_SIGTERM, then a fresh trainer
    # on another seed's state resumes it.
    arch = arch_of(base, "ragged")
    plan = sharding.make_plan(arch, MESH4)
    lm = LanguageModel(arch, plan)

    def ck_run(d, seed, injector=None):
        cfg = TrainerConfig(total_steps=CK_STEPS, checkpoint_dir=d, checkpoint_every=2,
                            migrate_every=2, migrate_threshold=1.05, log_every=100)
        tr_ = Trainer(lm, opt, cfg, log_fn=lambda s: None, injector=injector)
        st = sharded_state(init_state(lm, torch.Generator().manual_seed(seed), "cpu"), plan)
        out = tr_.fit(st, SkewedTokens())
        return tr_, out

    tr_a, out_a = ck_run(f"{out_dir}/ckA", 0)
    _flat_np("ckA/state", tr_a.global_state(out_a["state"]), res)
    res["ckA/loss"] = np.asarray(float(out_a["metrics"]["loss"]))
    res["ckA/ema"] = tr_a.load_stats.ema.copy()
    res["ckA/steps"] = np.asarray(tr_a.load_stats.steps)
    res["ckA/migrations"] = np.asarray(sum(m["applied"] for m in out_a["migrations"]))
    inj = FaultInjector(FaultPlan([FaultSpec("train.sigterm", step=CK_SIGTERM)]),
                        log_fn=lambda s: None)
    tr_b, out_b = ck_run(f"{out_dir}/ckB", 0, inj)
    res["ckB/last_step"] = np.asarray(out_b["last_step"])
    tr_c, out_c = ck_run(f"{out_dir}/ckB", 1)
    res["ckC/resumed_from"] = np.asarray(tr_c.resumed_from)
    _flat_np("ckC/state", tr_c.global_state(out_c["state"]), res)
    res["ckC/loss"] = np.asarray(float(out_c["metrics"]["loss"]))
    res["ckC/ema"] = tr_c.load_stats.ema.copy()

    # 4. Serving: rebalanced against static, both dispatch modes, fp32.
    params = _ref_params(ref)
    for mode in MODES:
        arch = arch_of(base, mode)
        plan = sharding.make_plan(arch, MESH4)
        for tag, extra in (("static", {}), ("rebalanced", REBALANCE)):
            eng = Engine(LanguageModel(arch, plan), _clone(shard_params(params, plan)),
                         ServeConfig(**SERVE, **extra))
            out = eng.run([Request(rid=i, tokens=t, max_new_tokens=8)
                           for i, t in enumerate(serve_prompts())])
            res[f"serve/{mode}/{tag}/tokens"] = _tokens(out)
            res[f"serve/{mode}/{tag}/rebalance"] = np.asarray(
                [e[1:] for e in eng.trace if e[0] == "rebalance"], np.int64).reshape(-1, 3)
    return res


def _phase8(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_params
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    res = {}
    base = get_arch(NAME).reduced()
    params = _ref_params(ref)
    ffn = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
    x = torch.from_numpy(ref["x"])
    d_i, m_i = divmod(rank, MESH8[1])
    bl, sl = B // MESH8[0], S // MESH8[1]
    wkeys = ("w_router",) + EXPERT_KEYS

    # 1. The replicated layer on (2, 4), live table and sentinel table.
    for mode in MODES:
        arch = arch_of(base, mode)
        # Whole-d_ff slots, sliced here by EP rank: no d_ff split.
        plan = dataclasses.replace(sharding.make_plan(arch, MESH8), ffn_split=1,
                                   ffn_whole="control")
        for tag, table in (("rep", TABLE), ("sentinel", (8, 8))):
            f = {k: (v[plan.ep_rank * 2:(plan.ep_rank + 1) * 2] if k in EXPERT_KEYS
                     else v).clone() for k, v in ffn.items()}
            f["replicas"] = torch.tensor(table, dtype=torch.int32)
            for k in wkeys:
                f[k].requires_grad_(True)
            xb = x[d_i * bl:(d_i + 1) * bl, m_i * sl:(m_i + 1) * sl].clone().requires_grad_(True)
            y, m = tmoe.moe_ffn(f, xb, arch, plan, train=True)
            gx, *gw = torch.autograd.grad((y * y).sum(), [xb] + [f[k] for k in wkeys])
            gw = dict(zip(wkeys, gw))
            sharding.all_reduce_(gw["w_router"], plan.world_group)
            for k in EXPERT_KEYS:
                sharding.all_reduce_(gw[k], plan.dp_group)
            t = f"{tag}/{mode}"
            res[f"{t}/y"], res[f"{t}/dx"] = y.detach().numpy(), gx.numpy()
            for k in wkeys:
                res[f"{t}/d{k}"] = gw[k].numpy()
            res[f"{t}/expert_load"] = m["expert_load"].numpy()
            with torch.no_grad():
                yd, _ = tmoe.moe_ffn({k: v.detach() for k, v in f.items()},
                                     x[d_i * bl:(d_i + 1) * bl], arch, plan,
                                     token_sharded=False)
            res[f"{t}/decode"] = yd.numpy()

    # 2. Run A's checkpoint (written at ep 4) restored at (4, 2): ep 2.
    arch = arch_of(base, "ragged")
    plan = sharding.make_plan(arch, MESH_EP2)
    lm = LanguageModel(arch, plan)
    tr = Trainer(lm, OptimizerConfig(lr=1e-3),
                 TrainerConfig(checkpoint_dir=f"{out_dir}/ckA"), log_fn=lambda s: None)
    state = init_state(lm, torch.Generator().manual_seed(3), "cpu")
    state = {k: shard_params(v, plan) if k in ("params", "m", "v") else v
             for k, v in state.items()}
    state, step = tr._restore_latest(state)
    tr._restore_load_stats(step)
    res["ep2/step"] = np.asarray(step)
    _flat_np("ep2/state", tr.global_state(state), res)
    res["ep2/ema"] = tr.load_stats.ema.copy()
    res["ep2/steps"] = np.asarray(tr.load_stats.steps)
    return res


def run_port(ref_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp

    for phase, world in (("r4", 4), ("r8", 8)):
        mp.start_processes(_rank_main, args=(world, phase, ref_path, out_dir),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(sys.argv[2])
    else:
        run_port(sys.argv[2], sys.argv[3])
