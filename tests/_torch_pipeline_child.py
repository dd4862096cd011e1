"""Child processes of test_torch_pipeline.py.

    python tests/_torch_pipeline_child.py jax OUT.npz
        The JAX package's schedule-executing pipeline
        (``LanguageModel.loss_and_grads``) on 8 fake host devices
        (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set by the
        caller): gpipe, 1f1b, 1f1b_overlap and zb_h1 at mesh (4, 1, 1),
        interleaved_1f1b at (2, 1, 1) with V = 2, 1f1b with compress_p2p at
        (4, 1, 1), and 1f1b at (2, 1, 2) and (2, 2, 2) (cf 16); the
        pipelined ``LanguageModel.forward`` at (2, 1, 1), flat and with V =
        2; reduced qwen2-vl (M-RoPE) fed precomputed ``embeds`` at (2, 1,
        1), 1f1b: ``loss_and_grads`` and ``forward``; the chunk layout of
        ``_stage_block_params``; the int8 helpers on seeded arrays.  Writes
        inputs, losses, gradients, logits and traces to OUT.npz.

    python tests/_torch_pipeline_child.py port REF.npz OUT_DIR
        The port on gloo ranks of this machine's CPU, from the same
        converted weights and tokens: 4 ranks, then 2, then 8.  Spawned
        with the ``spawn`` start method and a ``file://`` rendezvous in
        OUT_DIR (no port).  Rank 0 writes ``OUT_DIR/<phase>.npz``.

Only this file's ``jax`` mode imports JAX; the ``port`` mode imports
``repro_torch`` alone.
"""

import contextlib
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

NAME = "granite-moe-3b-a800m"
FLAT = ("gpipe", "1f1b", "1f1b_overlap", "zb_h1")
MESH_EP = {"2,1,2": (8, 32), "2,2,2": (16, 32)}  # mesh -> token batch (b, s)
INT8_SIZES = (1000, 3 * 7 * 37, 4096 + 5)  # none a multiple of the 256 block
STAGED = ("blocks/0/ffn/w_up", "blocks/0/mixer/wq", "blocks/0/norm_mixer")
# The pipelined forward's plans at (2, 1, 1): flat (1f1b) and interleaved.
FORWARD_PLANS = {"fwd2": {}, "fwd2v": {"schedule": "interleaved_1f1b", "vstages": 2}}
# The frontend case: reduced qwen2-vl (2 layers: one a stage at PP 2).
FRONTEND = "qwen2-vl-7b"


def arch_of(get_arch, layers: int = 4, cf: float = 8.0):
    """The reference child's arch: reduced granite, one rep a stage at PP 4,
    aux loss 0 (its per-microbatch mean differs from the global one)."""
    base = get_arch(NAME).reduced()
    return base.replace(num_layers=layers, moe=dataclasses.replace(
        base.moe, capacity_factor=cf, aux_loss_coef=0.0))


def tokens(b: int = 8, s: int = 32, vocab: int = 512):
    return np.random.default_rng(3).integers(0, vocab, size=(b, s)).astype(np.int32)


def frontend_embeds(b: int = 8, s: int = 32, d: int = 64):
    return np.random.default_rng(4).standard_normal((b, s, d)).astype(np.float32)


def int8_inputs():
    rng = np.random.default_rng(5)
    return [((rng.standard_normal(n) * 3).astype(np.float32),
             rng.standard_normal(n).astype(np.float32)) for n in INT8_SIZES]


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
# JAX reference
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_hand_offs(out):
    """Every compressed hand-off's input before quantisation, a stage's in
    tick order, to ``out["handoff/jax/<fwd|bwd>/<stage>"]`` (ticks, *shape).
    A host callback cannot run in a partly automatic ``shard_map``, so the
    block runs the reference's fully manual composition (its own fallback,
    ``core.pipeline._composition``): the same schedule, hand-offs and
    quantiser."""
    import jax
    from jax import lax

    from repro import compat
    from repro.core import compression as jcomp

    seen = {}
    orig, auto = jcomp.compressed_ppermute, compat.partial_auto_shard_map

    def recorded(x, axis_name, perm, block=256):
        direction = "fwd" if perm[0][1] > perm[0][0] else "bwd"

        def keep(xv, stage):
            seen.setdefault((direction, int(stage)), []).append(np.array(xv))

        jax.debug.callback(keep, x, lax.axis_index(axis_name))
        return orig(x, axis_name, perm, block)

    jcomp.compressed_ppermute, compat.partial_auto_shard_map = recorded, lambda: False
    try:
        yield
    finally:
        jcomp.compressed_ppermute, compat.partial_auto_shard_map = orig, auto
    for (direction, stage), xs in seen.items():
        out[f"handoff/jax/{direction}/{stage}"] = np.stack(xs)


def run_jax(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.core import compression as jcomp
    from repro.core import pipeline as jpipe
    from repro.models.model import LanguageModel, init_params
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    arch = arch_of(get_arch)
    params = init_params(arch, jax.random.PRNGKey(0))
    out = {f"params/{k}": np.asarray(v) for k, v in _paths(params).items()}
    names = ("pod", "data", "model")

    def run(tag, arch, mesh_shape, toks, **kw):
        mesh = host_mesh(mesh_shape, names)
        compress = kw.pop("compress_p2p", False)
        plan = make_plan(mesh, arch, pipeline_on_pod=True, **kw)
        plan.compress_p2p = compress
        lm = LanguageModel(arch, plan)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        with mesh:
            loss, grads, met = jax.jit(lm.loss_and_grads)(params, batch)
        out[f"{tag}/loss"] = np.asarray(loss)
        for k, v in _paths(grads).items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out[f"{tag}/grad/{k}"] = np.asarray(v)
        for k in ("pipeline_occupancy", "pipeline_wstash_occupancy", "pipeline_comm_inflight"):
            out[f"{tag}/{k}"] = np.asarray(met[k])

    toks = tokens()
    for name in FLAT:
        run(f"pp4/{name}", arch, (4, 1, 1), toks, schedule=name)
    run("pp2/interleaved_1f1b", arch, (2, 1, 1), toks, schedule="interleaved_1f1b",
        vstages=2)
    run("pp4/compress", arch, (4, 1, 1), toks, schedule="1f1b", compress_p2p=True)
    with _recorded_hand_offs(out):
        run("pp4/compress_rec", arch, (4, 1, 1), toks, schedule="1f1b", compress_p2p=True)
    for tag, kw in FORWARD_PLANS.items():
        mesh = host_mesh((2, 1, 1), names)
        lm = LanguageModel(arch, make_plan(mesh, arch, pipeline_on_pod=True, **kw))
        with mesh:
            logits, _, loads = jax.jit(lm.forward)(params, {"tokens": jnp.asarray(toks)})
        out[f"{tag}/logits"], out[f"{tag}/loads"] = np.asarray(logits), np.asarray(loads)
    qarch = get_arch(FRONTEND).reduced()
    qparams = init_params(qarch, jax.random.PRNGKey(1))
    out.update({f"qwen/params/{k}": np.asarray(v) for k, v in _paths(qparams).items()})
    mesh = host_mesh((2, 1, 1), names)
    lm = LanguageModel(qarch, make_plan(mesh, qarch, pipeline_on_pod=True))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
             "embeds": jnp.asarray(frontend_embeds())}
    with mesh:
        loss, grads, _ = jax.jit(lm.loss_and_grads)(qparams, batch)
        logits, _, _ = jax.jit(lm.forward)(qparams, batch)
    out["qwen/loss"], out["qwen/logits"] = np.asarray(loss), np.asarray(logits)
    for k, v in _paths(grads).items():
        if np.issubdtype(np.asarray(v).dtype, np.floating):
            out[f"qwen/grad/{k}"] = np.asarray(v)
    arch16 = arch_of(get_arch, cf=16.0)
    for mesh, (b, s) in MESH_EP.items():
        run(f"ep/{mesh}", arch16, tuple(int(n) for n in mesh.split(",")), tokens(b, s),
            schedule="1f1b")

    # The chunk layout: (PP, V, rpc, ...) of a few leaves, at PP 4 and 2 x V 2.
    flat = _paths(params["blocks"])
    for tag, shape, V in (("pp4", (4, 1, 1), 1), ("pp2", (2, 1, 1), 2)):
        mesh = host_mesh(shape, names)
        plan = make_plan(mesh, arch, pipeline_on_pod=True,
                         **({"schedule": "interleaved_1f1b", "vstages": V} if V > 1 else {}))
        with mesh:
            staged, _ = jax.jit(lambda b, plan=plan, V=V: jpipe._stage_block_params(
                b, arch, plan, vstages=V))(params["blocks"])
        sflat = _paths(staged)
        for path in STAGED:
            key = path[len("blocks/"):]
            assert key in flat
            out[f"staged/{tag}/{path}"] = np.asarray(sflat[key])

    for i, (x, r) in enumerate(int8_inputs()):
        q, sc = jcomp.quantize_int8(jnp.asarray(x))
        out[f"int8/{i}/q"], out[f"int8/{i}/scale"] = np.asarray(q), np.asarray(sc)
        out[f"int8/{i}/deq"] = np.asarray(jcomp.dequantize_int8(q, sc, dtype=jnp.float32))
        for k, v in zip(("q", "scale", "residual"), jcomp.ef_compress(jnp.asarray(x),
                                                                       jnp.asarray(r))):
            out[f"int8/{i}/ef_{k}"] = np.asarray(v)
    out["toks"] = toks
    np.savez(out_path, **out)


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
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv_{phase}",
                            rank=rank, world_size=world)
    try:
        ref = dict(np.load(ref_path))
        res = PHASES[phase](rank, ref)
        if rank == 0:
            np.savez(Path(out_dir) / f"{phase}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _setup(ref, prefix: str = "params/"):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy

    params = params_from_numpy(
        _unflatten({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}),
        "cpu")
    return get_arch, params, torch


def _grads(res, tag, tree):
    from repro_torch.models.model import tree_paths

    for k, v in tree_paths(tree).items():
        if v is not None:
            res[f"{tag}/grad/{k}"] = v.detach().float().numpy()


def _pipelined(res, tag, arch, plan, params, batch, traces=True):
    """The schedule-executing step through ``LanguageModel.loss_and_grads``
    on this rank's rows; the gathered gradients and traces to ``res``."""
    import torch

    from repro_torch import training
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.models.model import LanguageModel

    lm = LanguageModel(arch, plan)
    local = {k: torch.as_tensor(v) for k, v in training.shard_batch(batch, plan).items()}
    loss, grads, met = lm.loss_and_grads(shard_params(params, plan), local)
    res[f"{tag}/loss"] = loss.numpy()
    _grads(res, tag, gather_params(grads, plan))
    if traces:
        for k in ("pipeline_occupancy", "pipeline_wstash_occupancy", "pipeline_comm_inflight"):
            res[f"{tag}/{k}"] = met[k]
    res[f"{tag}/sent_bytes"] = np.asarray(met["pipeline_stats"]["sent_bytes"])
    res[f"{tag}/sent"] = np.asarray(met["pipeline_stats"]["sent"])
    return loss


def _world1(res, tag, arch, params, batch, rank):
    import torch

    from repro_torch import training
    from repro_torch.models.model import LanguageModel

    if rank == 0:
        loss, _, grads = training.loss_and_grads(LanguageModel(arch), params, batch,
                                                 torch.float32)
        res[f"{tag}/loss"] = loss.numpy()
        _grads(res, tag, grads)


def _oracle(res, tag, arch, plan, params, batch):
    """Autograd through the differentiable pipelined forward (GPipe order)."""
    import torch

    from repro_torch import training
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.models.model import LanguageModel

    loss, _, grads = training.loss_and_grads(LanguageModel(arch, plan),
                                             shard_params(params, plan), batch,
                                             torch.float32, autograd=True)
    res[f"{tag}/loss"] = loss.numpy()
    _grads(res, tag, gather_params(grads, plan))


def _forward_loss(arch, plan, params, batch):
    """The pipelined forward's loss (no gradient), summed over the ranks."""
    import torch

    from repro_torch import sharding, training
    from repro_torch.convert import shard_params
    from repro_torch.models.model import LanguageModel

    local = {k: torch.as_tensor(v) for k, v in training.shard_batch(batch, plan).items()}
    with torch.no_grad():
        term, _ = LanguageModel(arch, plan).loss(shard_params(params, plan), local)
    return float(sharding.all_reduce_(term.clone(), plan.world_group))


def _pipelined_forward(res, tag, arch, plan, params, batch):
    """``LanguageModel.forward`` under ``plan`` on this rank's block (its
    tokens, or a frontend's embeds: its rows, its sequence slice): rank 0's
    logits, aux, z and loads to ``res``, and the largest gap of any rank's
    logits from the world-1 forward of its whole rows, at its positions."""
    import torch

    from repro_torch import sharding, training
    from repro_torch.convert import shard_params
    from repro_torch.models.model import LanguageModel

    mine = {k: torch.as_tensor(v) for k, v in training.shard_batch(batch, plan).items()
            if k in ("tokens", "embeds")}
    logits, aux, loads = LanguageModel(arch, plan).forward(shard_params(params, plan), mine)
    b, s = np.asarray(batch["tokens"]).shape
    where = training.shard_batch({"tokens": np.arange(b * s).reshape(b, s)}, plan)["tokens"]
    rows, cols = where[:, 0] // s, where[0] % s
    whole = {k: torch.as_tensor(np.asarray(batch[k])[rows]) for k in ("tokens", "embeds")
             if k in batch}
    one, aux1, loads1 = LanguageModel(arch).forward(params, whole)
    gap = (logits - one[:, cols]).abs().max()
    torch.distributed.all_reduce(gap, op=torch.distributed.ReduceOp.MAX)
    res[f"{tag}/logits"] = logits.numpy()
    res[f"{tag}/gap_world1"] = gap.numpy()
    if loads is None:
        return
    res[f"{tag}/loads"] = loads.numpy()
    # The data ranks' rows make the batch (a sequence group shares its rows).
    res[f"{tag}/world1_loads"] = sharding.all_reduce_(loads1.clone(), plan.dp_group).numpy()
    for k in ("moe_aux_loss", "moe_z_loss"):
        res[f"{tag}/{k}"] = aux[k].numpy()


@contextlib.contextmanager
def _recorded_wire(res):
    """Every hand-off this rank sends, before quantisation, with its stage
    and microbatch (the executor's ``s`` and the ``mb`` of the op that made
    it, read off the caller's frame), gathered to ``res`` as
    ``handoff/port/<fwd|bwd>/<stage>`` (sends, *shape) and ``.../mb``."""
    import torch

    from repro_torch.core import pipeline

    seen = []
    orig = pipeline.Wire.exchange

    def recorded(self, sends, recvs):
        f = sys._getframe(1).f_locals
        for direction, _, t in sends:
            seen.append((direction, int(f["s"]), int(f["mb"]), t.detach().float().numpy()))
        return orig(self, sends, recvs)

    pipeline.Wire.exchange = recorded
    try:
        yield
    finally:
        pipeline.Wire.exchange = orig
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, seen)
    by = {}
    for direction, stage, mb, x in (r for rank in every for r in rank):
        by.setdefault((direction, stage), []).append((mb, x))
    for (direction, stage), items in by.items():
        res[f"handoff/port/{direction}/{stage}"] = np.stack([x for _, x in items])
        res[f"handoff/port/{direction}/{stage}/mb"] = np.asarray([mb for mb, _ in items])


def _phase_pp4(rank: int, ref):
    import torch

    from repro_torch import sharding, training
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init

    get_arch, params, _ = _setup(ref)
    arch, arch16 = arch_of(get_arch), arch_of(get_arch, cf=16.0)
    res = {}
    batch = {"tokens": ref["toks"], "labels": ref["toks"]}
    for name in FLAT:
        plan = sharding.make_plan(arch, (4, 1, 1), pipeline_on_pod=True, schedule=name)
        _pipelined(res, f"pp4/{name}", arch, plan, params, batch)
    plan = sharding.make_plan(arch, (4, 1, 1), pipeline_on_pod=True)
    _oracle(res, "oracle4", arch, plan, params, batch)
    res["forward4/loss"] = np.asarray(_forward_loss(arch, plan, params, batch))
    _world1(res, "world1", arch, params, batch, rank)

    # int8 hand-offs: the step, and the forward's loss.
    cplan = sharding.make_plan(arch, (4, 1, 1), pipeline_on_pod=True, compress_p2p=True)
    with _recorded_wire(res):
        _pipelined(res, "pp4/compress", arch, cplan, params, batch, traces=False)
    res["forward4c/loss"] = np.asarray(_forward_loss(arch, cplan, params, batch))

    _pp_x_ep(res, "2,1,2", arch16, params, rank)

    # shard_params then gather_params, at PP 4 and at PP 2 x EP 2, and the
    # chunk layout of this rank's stage.
    ok = True
    for shape in ((4, 1, 1), (2, 1, 2)):
        plan = sharding.make_plan(arch16, shape, pipeline_on_pod=True)
        mine = shard_params(params, plan)
        back = gather_params(mine, plan)
        ok &= all(torch.equal(a, b) for a, b in zip(tree_paths(back).values(),
                                                    tree_paths(params).values()))
        if shape == (4, 1, 1):
            flat = tree_paths(mine)
            for path in STAGED:
                parts = [torch.empty_like(flat[path]) for _ in range(4)]
                torch.distributed.all_gather(parts, flat[path].contiguous())
                res[f"staged/pp4/{path}"] = torch.stack(parts).numpy()
    res["roundtrip_ok"] = np.asarray(ok)

    # The train step at PP 2 (x EP 2): two steps, one host fetch each.
    opt = OptimizerConfig(lr=1e-3)
    for tag, plan in (("train", sharding.make_plan(arch, (2, 1, 2), pipeline_on_pod=True)),
                      ("train1", None)):
        fetches = []

        def fetch(t, fetches=fetches):
            fetches.append(1)
            return training._host(t)

        state_params = _clone(shard_params(params, plan))
        state = {"params": state_params, **adamw_init(state_params)}
        step = training.make_train_step(LanguageModel(arch, plan), opt, fetch=fetch,
                                        fetch_loads=True)
        losses = []
        for _ in range(2):
            _, met = step(state, batch)
            losses.append(float(met["loss"]))
        res[f"{tag}/losses"] = np.asarray(losses)
        res[f"{tag}/fetches"] = np.asarray(len(fetches))
        res[f"{tag}/loads"] = met["expert_load_host"]
    return res


def _clone(tree):
    from repro_torch.models.model import map_tree

    return map_tree(lambda t: t.clone(), tree)


def _phase_pp2(rank: int, ref):
    from repro_torch import sharding

    get_arch, params, _ = _setup(ref)
    arch = arch_of(get_arch)
    res = {}
    batch = {"tokens": ref["toks"], "labels": ref["toks"]}
    plan = sharding.make_plan(arch, (2, 1, 1), pipeline_on_pod=True,
                              schedule="interleaved_1f1b", vstages=2)
    _pipelined(res, "pp2/interleaved_1f1b", arch, plan, params, batch)
    _oracle(res, "oracle2", arch, plan, params, batch)
    res["forward2v/loss"] = np.asarray(_forward_loss(arch, plan, params, batch))
    import torch

    from repro_torch.convert import shard_params
    from repro_torch.models.model import tree_paths

    flat = tree_paths(shard_params(params, plan))
    for path in STAGED:
        parts = [torch.empty_like(flat[path]) for _ in range(2)]
        torch.distributed.all_gather(parts, flat[path].contiguous())
        res[f"staged/pp2/{path}"] = torch.stack(parts).numpy()
    flat_plan = sharding.make_plan(arch, (2, 1, 1), pipeline_on_pod=True)
    res["forward2/loss"] = np.asarray(_forward_loss(arch, flat_plan, params, batch))
    for tag, kw in FORWARD_PLANS.items():
        _pipelined_forward(res, tag, arch,
                           sharding.make_plan(arch, (2, 1, 1), pipeline_on_pod=True, **kw),
                           params, {"tokens": ref["toks"]})
    _world1(res, "world1", arch, params, batch, rank)
    # The frontend case: reduced qwen2-vl on precomputed embeds, 1f1b.
    _, qparams, _ = _setup(ref, "qwen/params/")
    qarch = get_arch(FRONTEND).reduced()
    qbatch = {"tokens": ref["toks"], "labels": ref["toks"], "embeds": frontend_embeds()}
    qplan = sharding.make_plan(qarch, (2, 1, 1), pipeline_on_pod=True)
    _pipelined(res, "qwen", qarch, qplan, params=qparams, batch=qbatch, traces=False)
    _pipelined_forward(res, "qwen", qarch, qplan, qparams, qbatch)
    _world1(res, "qwen1", qarch, qparams, qbatch, rank)
    return res


def _phase_pp8(rank: int, ref):
    from repro_torch import sharding

    get_arch, params, _ = _setup(ref)
    res = {}
    _pp_x_ep(res, "2,2,2", arch_of(get_arch, cf=16.0), params, rank)
    return res


def _pp_x_ep(res, mesh: str, arch, params, rank: int) -> None:
    """1f1b at ``mesh`` (cf 16): with the EP layer's bf16 wire (held
    against the JAX executor, which has it too) and with the wire in fp32
    (held against world 1, which has none)."""
    import torch

    from repro_torch import sharding
    from repro_torch.models import moe

    b, s = MESH_EP[mesh]
    toks = tokens(b, s)
    batch = {"tokens": toks, "labels": toks}
    plan = sharding.make_plan(arch, tuple(int(n) for n in mesh.split(",")),
                              pipeline_on_pod=True)
    _pipelined(res, f"ep/{mesh}", arch, plan, params, batch, traces=False)
    wire, moe.WIRE_DTYPE = moe.WIRE_DTYPE, torch.float32
    try:
        _pipelined(res, f"ep32/{mesh}", arch, plan, params, batch, traces=False)
        _pipelined_forward(res, f"fwd32/{mesh}", arch, plan, params, batch)
    finally:
        moe.WIRE_DTYPE = wire
    _world1(res, f"ep1/{mesh}", arch, params, batch, rank)


PHASES = {"pp4": _phase_pp4, "pp2": _phase_pp2, "pp8": _phase_pp8}
WORLDS = {"pp4": 4, "pp2": 2, "pp8": 8}


def run_port(ref_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp

    for phase, world in WORLDS.items():
        mp.start_processes(_rank_main, args=(world, phase, ref_path, out_dir),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_jax(sys.argv[2])
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        run_port(sys.argv[2], sys.argv[3])
