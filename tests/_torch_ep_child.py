"""Child processes of test_torch_ep.py.

    python tests/_torch_ep_child.py jax OUT.npz
        The JAX package's sharded ``moe_ffn`` and single-device model on 8
        fake host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
        set by the caller), on seeded numpy inputs; writes inputs, outputs
        and gradients to OUT.npz.

    python tests/_torch_ep_child.py port REF.npz OUT_DIR
        The port on gloo ranks of this machine's CPU: 8 ranks for the
        layer, model, train-step, launcher, HALO and micro-benchmark cases,
        then 4 for paged serving over ``--mesh 1,4``.  Spawned with the
        ``spawn`` start method and a ``file://`` rendezvous in OUT_DIR (no
        port).  Each rank writes ``OUT_DIR/<phase>_rank<r>.npz``.

Only this file's ``jax`` mode imports JAX; the ``port`` mode imports
``repro_torch`` alone.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

NAME = "granite-moe-3b-a800m"
MESH = (2, 4)  # (data, model): ep = gcd(8, 4) = 4 on the reduced arch
B, S = 8, 16  # moe_ffn input (b, s, d)
TOK_B, TOK_S = 8, 32  # model / train-step batch
CHUNKS = (1, 3)  # 3 gives a tail chunk
MODES = ("capacity", "ragged")
HALO_MESHES = ((4, 2), (2, 4), (1, 8))  # ep = 2, 4, 8


def inputs(d: int):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, d)) * 0.5).astype(np.float32)
    # Skewed tokens: a shared direction dominates, so routing piles onto a
    # few experts and the ragged rank budget (cf 1.25) overflows.
    v = rng.standard_normal((d,)).astype(np.float32)
    x_skew = (0.1 * rng.standard_normal((B, S, d)) + 2.0 * v).astype(np.float32)
    toks = rng.integers(0, 512, size=(TOK_B, TOK_S)).astype(np.int32)
    return x, x_skew, toks


# ---------------------------------------------------------------------------
# JAX reference
# ---------------------------------------------------------------------------


def run_jax(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.models import moe as jmoe
    from repro.models.model import LanguageModel, init_params
    from repro.sharding import host_mesh, make_plan, single_device_plan

    assert len(jax.devices()) == 8, jax.devices()
    base = get_arch(NAME).reduced()

    def arch_of(mode, cf=16.0):
        return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode,
                                                    capacity_factor=cf))

    params = init_params(arch_of("ragged"), jax.random.PRNGKey(0))
    ffn = jax.tree.map(lambda p: p[0], params["blocks"][0]["ffn"])
    x, x_skew, toks = inputs(base.d_model)
    out = {f"params/{k}": np.asarray(v) for k, v in _paths(params).items()}
    mesh = host_mesh(MESH, ("data", "model"))
    wkeys = ("w_router", "w_up", "w_gate", "w_down")

    for mode in MODES:
        arch = arch_of(mode)
        for K in CHUNKS:
            plan = make_plan(mesh, arch, a2a_chunks=K)

            def loss(f, xx, plan=plan, arch=arch):
                y, m = jmoe.moe_ffn(dict(ffn, **f), xx, arch, plan, token_sharded=True)
                return jnp.sum(y * y), (y, m)

            with plan.mesh:
                (_, (y, m)), (gw, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))({k: ffn[k] for k in wkeys}, x)
            tag = f"fwd/{mode}/K{K}"
            out[f"{tag}/y"] = np.asarray(y)
            out[f"{tag}/dx"] = np.asarray(gx)
            for k in wkeys:
                out[f"{tag}/d{k}"] = np.asarray(gw[k])
            for k in ("moe_aux_loss", "moe_z_loss", "expert_load"):
                out[f"{tag}/{k}"] = np.asarray(m[k])
        plan = make_plan(mesh, arch)
        with plan.mesh:
            y, m = jax.jit(lambda f, xx, plan=plan, arch=arch: jmoe.moe_ffn(
                f, xx, arch, plan, token_sharded=False))(ffn, x)
        out[f"decode/{mode}/y"] = np.asarray(y)
        for k in ("moe_aux_loss", "moe_z_loss", "expert_load"):
            out[f"decode/{mode}/{k}"] = np.asarray(m[k])

    # Rank-budget overflow (ragged, cf 1.25) on skewed tokens.
    arch = arch_of("ragged", 1.25)
    plan = make_plan(mesh, arch)
    with plan.mesh:
        y, _ = jax.jit(lambda f, xx: jmoe.moe_ffn(f, xx, arch, plan))(ffn, x_skew)
    out["overflow/y"] = np.asarray(y)

    # Single-device model loss and gradients (check_moe_ep's world-1 side).
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    for mode in MODES:
        arch = arch_of(mode)
        plan1 = single_device_plan(arch)
        lm = LanguageModel(arch, plan1)
        with plan1.mesh:
            (l1, _), g1 = jax.jit(jax.value_and_grad(
                lambda p: lm.loss(p, batch), has_aux=True, allow_int=True))(params)
        out[f"model/{mode}/loss"] = np.asarray(l1)
        for k, v in _paths(g1).items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out[f"model/{mode}/grad/{k}"] = np.asarray(v)
    out["x"], out["x_skew"], out["toks"] = x, x_skew, toks
    np.savez(out_path, **out)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# Port ranks
# ---------------------------------------------------------------------------


def _unflatten(flat):
    """{"a/0/b": leaf} -> nested dicts, with the "blocks" level a tuple."""
    root = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    root["blocks"] = tuple(root["blocks"][str(i)] for i in range(len(root["blocks"])))
    return root


def _rank_main(rank: int, world: int, phase: str, ref_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv_{phase}",
                            rank=rank, world_size=world)
    try:
        ref = dict(np.load(ref_path))
        res = (_phase_layers if phase == "layers" else _phase_serve)(rank, ref, out_dir)
        np.savez(Path(out_dir) / f"{phase}_rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tree_np(prefix, tree, res):
    from repro_torch.models.model import tree_paths

    for k, v in tree_paths(tree).items():
        if v is not None:
            res[f"{prefix}/{k}"] = v.detach().float().numpy()


def _phase_layers(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, params_from_numpy, shard_params
    from repro_torch.core import halo, microbench
    from repro_torch.launch import train as train_launch
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init

    res = {}
    base = get_arch(NAME).reduced()

    def arch_of(mode, cf=16.0):
        return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode,
                                                    capacity_factor=cf))

    params = params_from_numpy(
        _unflatten({k[len("params/"):]: v for k, v in ref.items() if k.startswith("params/")}),
        "cpu")
    ffn = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
    x, x_skew = torch.from_numpy(ref["x"]), torch.from_numpy(ref["x_skew"])
    d_i, m_i = divmod(rank, MESH[1])
    bl, sl = B // MESH[0], S // MESH[1]
    wkeys = ("w_router", "w_up", "w_gate", "w_down")

    # 1. moe_ffn on mesh (2, 4): this rank's block, forward and gradients.
    for mode in MODES:
        arch = arch_of(mode)
        for K in CHUNKS:
            plan = sharding.make_plan(arch, MESH, a2a_chunks=K)
            f = {k: (v[plan.ep_rank * 2:(plan.ep_rank + 1) * 2] if k in sharding.EXPERT_KEYS
                     else v).clone() for k, v in ffn.items()}
            for k in wkeys:
                f[k].requires_grad_(True)
            xb = x[d_i * bl:(d_i + 1) * bl, m_i * sl:(m_i + 1) * sl].clone().requires_grad_(True)
            y, m = tmoe.moe_ffn(f, xb, arch, plan, train=True)
            gx, *gw = torch.autograd.grad((y * y).sum(), [xb] + [f[k] for k in wkeys])
            gw = dict(zip(wkeys, gw))
            sharding.all_reduce_(gw["w_router"], plan.world_group)
            for k in sharding.EXPERT_KEYS:
                sharding.all_reduce_(gw[k], plan.dp_group)
            tag = f"fwd/{mode}/K{K}"
            res[f"{tag}/y"], res[f"{tag}/dx"] = y.detach().numpy(), gx.numpy()
            for k in wkeys:
                res[f"{tag}/d{k}"] = gw[k].numpy()
            for k in ("moe_aux_loss", "moe_z_loss", "expert_load"):
                res[f"{tag}/{k}"] = m[k].detach().numpy()

        # 3. Weight-parallel decode: tokens replicated over the EP group,
        # batch-sharded over data.
        plan = sharding.make_plan(arch, MESH)
        f = shard_params({"blocks": ({"ffn": {k: v[None] for k, v in ffn.items()}},)},
                         plan)["blocks"][0]["ffn"]
        f = {k: v[0] for k, v in f.items()}
        with torch.no_grad():
            y, m = tmoe.moe_ffn(f, x[d_i * bl:(d_i + 1) * bl], arch, plan,
                                token_sharded=False)
        res[f"decode/{mode}/y"] = y.numpy()
        for k in ("moe_aux_loss", "moe_z_loss", "expert_load"):
            res[f"decode/{mode}/{k}"] = m[k].numpy()

    # 7. Rank-budget overflow: ragged at cf 1.25 on skewed tokens.
    arch = arch_of("ragged", 1.25)
    plan = sharding.make_plan(arch, MESH)
    f = {k: (v[plan.ep_rank * 2:(plan.ep_rank + 1) * 2] if k in sharding.EXPERT_KEYS else v)
         for k, v in ffn.items()}
    xb = x_skew[d_i * bl:(d_i + 1) * bl, m_i * sl:(m_i + 1) * sl]
    with torch.no_grad():
        res["overflow/y"] = tmoe.moe_ffn(f, xb, arch, plan)[0].numpy()
        res["overflow/y_local"] = tmoe.moe_ffn_local(ffn, xb, arch)[0].numpy()

    # 2. HALO == flat at ep = 2, 4, 8: the bare all-to-all (against its
    # definition too) and, at ep = 8, the ragged layer; values and grads.
    for mesh in HALO_MESHES:
        flat = sharding.make_plan(arch_of("ragged"), mesh)
        hier = sharding.make_plan(arch_of("ragged"), mesh, hierarchical_a2a=True)
        ep = flat.ep

        def send(r):
            g = torch.Generator().manual_seed(100 + r)
            return torch.randn((ep, 3, 5), generator=g)

        w = torch.randn((ep, 3, 5), generator=torch.Generator().manual_seed(7))
        outs = []
        for p, fn in ((flat, halo.flat_all_to_all), (hier, halo.hierarchical_all_to_all)):
            xs = send(rank).requires_grad_(True)
            y = fn(xs, p)
            (gx,) = torch.autograd.grad((y * w).sum(), [xs])
            outs.append((y.detach(), gx))
        first = rank - flat.ep_rank  # EP rank 0 of this rank's group
        want = torch.stack([send(first + i)[flat.ep_rank] for i in range(ep)])
        res[f"halo/ep{ep}/def_ok"] = np.asarray(torch.equal(outs[0][0], want))
        res[f"halo/ep{ep}/y_eq"] = np.asarray(torch.equal(outs[0][0], outs[1][0]))
        res[f"halo/ep{ep}/g_eq"] = np.asarray(torch.equal(outs[0][1], outs[1][1]))
        res[f"halo/ep{ep}/g1"] = np.asarray(hier.g1)
        if ep == 8:
            arch = arch_of("ragged")
            E_l = arch.moe.num_experts // ep
            layer = []
            for p in (flat, hier):
                f = {k: (v[p.ep_rank * E_l:(p.ep_rank + 1) * E_l] if k in sharding.EXPERT_KEYS
                         else v).clone().requires_grad_(k != "assignment")
                     for k, v in ffn.items()}
                xb = x[rank:rank + 1].clone().requires_grad_(True)
                y, _ = tmoe.moe_ffn(f, xb, arch, p, train=True)
                g = torch.autograd.grad((y * y).sum(), [xb, f["w_up"], f["w_router"]])
                layer.append([y.detach()] + list(g))
            res["halo/ep8/layer_eq"] = np.asarray(
                all(torch.equal(a, b) for a, b in zip(*layer)))

    # shard_params then gather_params gives the whole tree back.
    plan = sharding.make_plan(arch_of("ragged"), MESH)
    back = gather_params(shard_params(params, plan), plan)
    res["roundtrip_ok"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(params))))

    # 4. Model loss and gradients at (2, 4) and at world 1, both modes.
    toks = ref["toks"]
    batch = {"tokens": toks, "labels": toks}
    for mode in MODES:
        arch = arch_of(mode)
        plan = sharding.make_plan(arch, MESH)
        loss, _, grads = training.loss_and_grads(LanguageModel(arch, plan),
                                                 shard_params(params, plan), batch,
                                                 torch.float32)
        res[f"model/{mode}/loss"] = loss.numpy()
        _tree_np(f"model/{mode}/grad", gather_params(grads, plan), res)
        if rank == 0:
            loss1, _, grads1 = training.loss_and_grads(LanguageModel(arch), params, batch,
                                                       torch.float32)
            res[f"model1/{mode}/loss"] = loss1.numpy()
            _tree_np(f"model1/{mode}/grad", grads1, res)

    # 5. One train step at (2, 4) and at world 1 (capacity, as check_moe_ep):
    # the loss, the grad norm the clip uses, and the state after the update
    # (gathered: every rank the params, rank 0 the moments too).
    arch = arch_of("capacity")
    opt = OptimizerConfig(lr=1e-3)
    for tag, p in (("train", sharding.make_plan(arch, MESH)), ("train1", None)):
        lm = LanguageModel(arch, p)
        state_params = _tree_clone(shard_params(params, p) if p else params)
        state = {"params": state_params, **adamw_init(state_params)}
        _, met = training.make_train_step(lm, opt, compute_dtype=torch.float32)(state, batch)
        res[f"{tag}/loss"] = met["loss"].numpy()
        res[f"{tag}/skipped"] = np.asarray(met["skipped"])
        res[f"{tag}/grad_norm"] = met["grad_norm"].numpy()
        for k in ("params", "m", "v"):
            full = gather_params(state[k], p)  # collective: on every rank
            if rank == 0 or k == "params":
                _tree_np(f"{tag}/{k}", full, res)

    # The launcher over these ranks: --mesh 2,4, HALO x2, --metrics-out.
    s = train_launch.main(["--reduced", "--device", "cpu", "--mesh", "2,4", "--steps", "3",
                           "--batch", "8", "--seq", "16", "--a2a", "flat",
                           "--a2a-chunks", "2", "--dispatch", "ragged",
                           "--metrics-out", f"{out_dir}/train.jsonl"])
    res["launch/loss"] = np.asarray(s["loss"])
    res["launch/ep"] = np.asarray(s["ep"])
    if rank == 0:
        res["launch/a2a_n"] = np.asarray(s["drift"].get("a2a", {}).get("n", 0))

    # 8. The a2a micro-benchmarks over the EP group.
    plan = sharding.make_plan(arch_of("ragged"), MESH, hierarchical_a2a=False)
    rows = microbench.a2a_bandwidth_curve((2**10, 2**12), group=plan.ep_group, device="cpu")
    res["bench/gbps"] = np.asarray([r["gbps"] for r in rows])
    res["bench/ranks"] = np.asarray([r["ranks"] for r in rows])
    from repro_torch import obs
    ring = obs.RingBufferSink()
    t = [microbench.measure_a2a_overlap(plan, rows=8, d=16, d_ff=32, chunks=c, part=part,
                                        device="cpu", telemetry=obs.Telemetry(sinks=[ring]))
         for c, part in ((1, "layer"), (2, "layer"), (1, "a2a"), (1, "ffn"))]
    res["bench/seconds"] = np.asarray(t)
    res["bench/spans"] = np.asarray(sum(e["name"] == "a2a.layer" for e in ring.events()))
    return res


def _leaves(tree):
    from repro_torch.models.model import tree_paths

    return list(tree_paths(tree).values())


def _tree_clone(tree):
    from repro_torch.models.model import map_tree

    return map_tree(lambda t: t.clone(), tree)


def _phase_serve(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_params
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serving import Engine, Request, ServeConfig

    res = {}
    base = get_arch(NAME).reduced()
    cfg = ServeConfig(max_seqs=2, block_size=4, num_blocks=64, max_blocks_per_seq=8,
                      cache_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab_size, size=int(n)) for n in (5, 12, 3, 9)]
    for mode in MODES:
        # cf 16: no layout drops a row, so every rank count gives the same tokens.
        arch = base.replace(moe=dataclasses.replace(base.moe, dispatch=mode,
                                                    capacity_factor=16.0))
        params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
        plans = (("serve", sharding.make_plan(arch, (1, 4))),) + (
            (("serve1", None),) if rank == 0 else ())
        for tag, plan in plans:
            eng = Engine(LanguageModel(arch, plan), shard_params(params, plan), cfg)
            out = eng.run([Request(rid=i, tokens=t, max_new_tokens=6)
                           for i, t in enumerate(prompts)])
            res[f"{tag}/{mode}/tokens"] = _tokens(out)
    # The launcher over these ranks (the arch's own capacity factor).
    s, _ = serve.serve(serve.parse_args(SERVE_ARGS + ["--mesh", "1,4"]))
    res["launch/finished"] = np.asarray([s["finished"], s["requests"], s["ep"]])
    return res


SERVE_ARGS = ["--reduced", "--device", "cpu", "--dtype", "float32", "--requests", "4",
              "--max-new", "4", "--prompt-min", "3", "--prompt-max", "20"]


def _tokens(outputs) -> np.ndarray:
    return np.asarray([outputs[r] for r in sorted(outputs)], np.int64)


def run_port(ref_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp

    for phase, world in (("layers", 8), ("serve", 4)):
        mp.start_processes(_rank_main, args=(world, phase, ref_path, out_dir),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(sys.argv[2])
    else:
        run_port(sys.argv[2], sys.argv[3])
