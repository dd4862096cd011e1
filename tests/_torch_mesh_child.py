"""Child processes of test_torch_mesh.py.

    python tests/_torch_mesh_child.py jax OUT.npz
        The JAX package on 8 fake host devices (the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=8``): its model's
        loss and gradients on the (1, 4) mesh of a reduced granite with 6
        experts (ep = gcd(6, 4) = 2, tp = 2) and on one device; its paged
        prefill and decode on the (2, 2) mesh; its trainer's migration
        controller on the (2, 1, 2) pipelined mesh on a seeded state and
        EMA.  Writes inputs and results to OUT.npz.

    python tests/_torch_mesh_child.py port REF.npz OUT_DIR
        The port on 4 gloo ranks of this machine's CPU (``spawn``, a
        ``file://`` rendezvous in OUT_DIR, no port): tp 2 training (beside
        it the (2, 2) data grid) and serving at (1, 4), serving data
        parallelism at (2, 2) and (2, 1, 2), migration at PP 2 x EP 2
        (2, 1, 2) and a restore of the "pp" mode's checkpoint there.  Each
        rank writes ``OUT_DIR/r4_rank<r>.npz``.

    python tests/_torch_mesh_child.py pp OUT_DIR
        The port's checkpointing under a pipeline on 2 gloo ranks (PP 2,
        depth 4), needing nothing of the reference: the uninterrupted run,
        NaN x 3 -> rollback, SIGTERM -> final save -> resume, and restores
        of a PP 2 checkpoint at world 1 and under interleaved_1f1b V 2.
        Each rank writes ``OUT_DIR/pp_rank<r>.npz``.

    python tests/_torch_mesh_child.py seq-jax OUT.npz PART
        For ``test_torch_seq_shard.py``: the JAX package on 8 fake host
        devices, the wire's bf16 cast replaced by the identity.  Every
        device's block of ``batch_specs``' sharding at four grids (and of a
        microbatch's activations under the pod pipeline), and the loss and
        gradients of each ``SEQ_CASES`` case on the reference's plan at
        its grid, and of 1f1b at PP 2 x ep 2 (``SEQ_PP``): the part
        ``SEQ_JAX_PARTS[PART]`` of them.  The weights are the port's
        ``init_params`` (seed 0), so the parts and the next mode need
        nothing of each other and run side by side.

    python tests/_torch_mesh_child.py seq-port OUT_DIR
        The port's side of the same cases on 4 gloo ranks, the wire in
        fp32, and world 1 on rank 0.  Each rank writes
        ``OUT_DIR/seq_rank<r>.npz``.

    python tests/_torch_mesh_child.py serve-jax OUT.npz PART
        For ``test_torch_seq_serve.py``: the JAX package on 8 fake host
        devices, its wire in fp32: every device's block of the prefill and
        decode ``batch_specs`` and of ``cache_specs``, and each
        ``SERVE_CASES`` case's jitted ``make_prefill_step`` /
        ``make_decode_step`` under those shardings (the part
        ``SERVE_JAX_PARTS[PART]`` of them), from the port's ``init_params``.

    python tests/_torch_mesh_child.py serve-port OUT_DIR
        The port's side on 4 gloo ranks, and world 1 on rank 0.  Each rank
        writes ``OUT_DIR/serve_rank<r>.npz``.

Only the ``jax``, ``seq-jax`` and ``serve-jax`` modes import JAX.
"""

import dataclasses
import os
import sys
import zlib
from pathlib import Path

import numpy as np

from _torch_ep_child import _paths, _tokens, _unflatten
from _torch_migration_child import controller_ema, skewed_batch

NAME = "granite-moe-3b-a800m"
MODES = ("capacity", "ragged")
TP_MESH, TP_E = (1, 4), 6  # ep = gcd(6, 4) = 2, tp = 2
TP_CONTROL = (2, 2)  # D 2 x ep 2: as many tokens a rank, no tp
TP_BATCH = (8, 16)  # (b, s): 32 tokens a rank at (1, 4) and at (2, 2)
DP_MESHES = ((2, 2), (2, 1, 2))  # D 2 x ep 2; the pod joining data
PP_MESH, PP_DEPTH = (2, 1, 2), 4  # PP 2 x EP 2, two reps a stage
DECODE = dict(plen=8, total=12)  # the reference's check_paged_decode_on_mesh
SERVE = dict(max_seqs=2, block_size=4, num_blocks=48, max_blocks_per_seq=8,
             cache_dtype="float32")
CK_STEPS, CK_EVERY, CK_NAN, CK_SIGTERM = 8, 2, 3, 7


def arch_tp(base, mode):
    return base.replace(moe=dataclasses.replace(base.moe, num_experts=TP_E, dispatch=mode,
                                                capacity_factor=16.0))


def arch_pp(base, mode="ragged", replicas=2, **moe):
    return base.replace(num_layers=PP_DEPTH, moe=dataclasses.replace(
        base.moe, dispatch=mode, capacity_factor=16.0, max_replicas=replicas, **moe))


def arch_serve(base, mode):
    return base.replace(moe=dataclasses.replace(base.moe, dispatch=mode,
                                                capacity_factor=16.0))


def tp_tokens():
    return np.random.default_rng(11).integers(0, 512, size=TP_BATCH).astype(np.int32)


def decode_tokens():
    return np.random.default_rng(7).integers(0, 512, size=(2, DECODE["total"])).astype(np.int32)


def serve_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=int(n)) for n in (5, 12, 3, 9)]


def random_moments(state, seed: int = 7):
    """The state with seeded random m and v (so that a permutation of
    them shows), as numpy."""
    rng = np.random.default_rng(seed)
    for t in ("m", "v"):
        state[t] = {k: (rng.standard_normal(a.shape).astype(a.dtype)
                        if np.issubdtype(a.dtype, np.floating) else a)
                    for k, a in state[t].items()}
    return state


# ---------------------------------------------------------------------------
# JAX reference
# ---------------------------------------------------------------------------


def run_jax(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import training as jtraining
    from repro.configs import get_arch
    from repro.models.model import LanguageModel, init_params
    from repro.optim import OptimizerConfig
    from repro.runtime.trainer import Trainer, TrainerConfig
    from repro.serving.kv_cache import BlockPool, PagedLayout
    from repro.sharding import host_mesh, make_plan, single_device_plan

    assert len(jax.devices()) == 8, jax.devices()
    base = get_arch(NAME).reduced()
    out = {}

    # 1. tp 2: the model's loss and gradients at (1, 4) and on one device.
    params = init_params(arch_tp(base, "ragged"), jax.random.PRNGKey(0))
    out.update({f"tp_params/{k}": np.asarray(v) for k, v in _paths(params).items()})
    toks = tp_tokens()
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    for mode in MODES:
        arch = arch_tp(base, mode)
        tp_plan = make_plan(host_mesh(TP_MESH, ("data", "model")), arch)
        out[f"tp/{mode}/ep_tp"] = np.asarray([tp_plan.ep, tp_plan.tp])
        for tag, plan in (("tp", tp_plan), ("tp1", single_device_plan(arch))):
            lm = LanguageModel(arch, plan)
            try:
                with plan.mesh:
                    (loss, _), g = jax.jit(jax.value_and_grad(
                        lambda p, lm=lm: lm.loss(p, batch), has_aux=True,
                        allow_int=True))(params)
            except Exception as e:  # recorded; the test says what it holds instead
                out[f"{tag}/{mode}/error"] = np.asarray(f"{type(e).__name__}: {e}"[:2000])
                continue
            out[f"{tag}/{mode}/loss"] = np.asarray(loss)
            for k, v in _paths(g).items():
                if np.issubdtype(np.asarray(v).dtype, np.floating):
                    out[f"{tag}/{mode}/grad/{k}"] = np.asarray(v)

    # 2. Paged prefill + decode on the (2, 2) mesh (the analogue of
    # tests/_serving_child.py's check_paged_decode_on_mesh).
    arch = arch_serve(base, "ragged")
    sparams = init_params(arch, jax.random.PRNGKey(1))
    out.update({f"serve_params/{k}": np.asarray(v) for k, v in _paths(sparams).items()})
    plan = make_plan(host_mesh(DP_MESHES[0], ("data", "model")), arch)
    lm = LanguageModel(arch, plan)
    layout = PagedLayout(num_blocks=12, block_size=4, max_seqs=2, max_blocks_per_seq=4)
    dtoks, plen = decode_tokens(), DECODE["plen"]
    pool = BlockPool(layout)
    pool.admit(plen)
    pool.admit(plen)
    with plan.mesh:
        cache = lm.init_paged_cache(layout, dtype=jnp.float32)
        _, cache = jax.jit(lm.prefill_paged)(
            sparams, {"tokens": jnp.asarray(dtoks[:, :plen])}, cache,
            jnp.asarray(pool.block_table), jnp.asarray(pool.lengths))
        decode = jax.jit(lm.decode_step_paged)
        logits = []
        for i in range(dtoks.shape[1] - plen):
            pool.extend(0, 1)
            pool.extend(1, 1)
            lg, cache = decode(sparams, cache, jnp.asarray(pool.block_table),
                               jnp.asarray([plen + i, plen + i], jnp.int32),
                               {"tokens": jnp.asarray(dtoks[:, plen + i:plen + i + 1])})
            logits.append(np.asarray(lg))
    out["decode/logits"] = np.stack(logits)
    out["decode/block_table"] = np.asarray(pool.block_table)

    # 3. The trainer's migration controller at PP 2 x EP 2 on a seeded state
    # (random moments) and a skewed EMA.
    arch = arch_pp(base)
    plan = make_plan(host_mesh(PP_MESH, ("pod", "data", "model")), arch,
                     pipeline_on_pod=True)
    lm = LanguageModel(arch, plan)
    opt = OptimizerConfig(lr=1e-3)
    with plan.mesh:
        state = jtraining.init_state(lm, jax.random.PRNGKey(0), opt)
    flat = {t: _paths(jax.tree.map(np.asarray, state[t])) for t in ("params", "m", "v")}
    flat = random_moments(flat)
    for t in ("params", "m", "v"):
        out.update({f"ctrl/before/{t}/{k}": v for k, v in flat[t].items()})
    out["ctrl/before/step"] = np.asarray(state["step"])
    state = {t: jax.tree.map(jnp.asarray, _unflatten(flat[t])) for t in ("params", "m", "v")}
    state["step"] = jnp.asarray(out["ctrl/before/step"])
    tr = Trainer(lm, opt, TrainerConfig(migrate_every=1, migrate_threshold=1.05),
                 log_fn=lambda s: None)
    tr.load_stats.ema = controller_ema(arch.num_moe_layers, arch.moe.num_experts)
    out["ctrl/ema"] = tr.load_stats.ema.copy()
    with plan.mesh:
        after = tr._maybe_migrate(state, 1)
    for k, v in _paths({t: after[t] for t in ("params", "m", "v")}).items():
        out[f"ctrl/after/{k}"] = np.asarray(v)
    rec = tr.migrations[-1]
    out["ctrl/record"] = np.asarray([rec["imbalance"], rec["imbalance_post"], rec["swaps"],
                                     rec["replicas"], float(rec["applied"])])
    out["tp_toks"], out["decode_toks"] = toks, dtoks
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The sequence-sharded training layout (tests/test_torch_seq_shard.py)
# ---------------------------------------------------------------------------

# Layout grids: tag -> (mesh, arch).  Granite's 8 experts give ep 4 at
# (1, 4) and ep 2 at (2, 2); "tp1,4" takes TP_E experts (ep 2, tp 2); the
# pod joins data at (2, 1, 2); qwen2-vl (a dense arch: ep is the model axis)
# carries ``embeds`` too.
SEQ_LAYOUTS = {"1,4": ((1, 4), "granite"), "2,2": ((2, 2), "qwen2"),
               "2,1,2": ((2, 1, 2), "granite"), "tp1,4": ((1, 4), "tp")}
SEQ_LAYOUT_BATCH = (8, 16)  # (b, s), values that name their (row, position)
SEQ_PP = ((2, 1, 2), 4)  # PP 2 x ep 2, M = 2 PP microbatches
SEQ_B, SEQ_S = 4, 64  # (2, 2): 2 rows x 32 positions a rank; (1, 4): 4 x 16
# Each case: (arch, grid).  The slices cross gemma2's window (32) and the
# SSM chunk (32); mamba2 at (1, 4) holds half a chunk a rank, so its state
# crosses three slice boundaries in two scan rounds.  Granite runs at the
# reduced capacity factor 1.25, where tokens drop; jamba at cf 16 (its
# world-1 twin drops no token either).
SEQ_CASES = {"granite/capacity": ("granite-moe-3b-a800m", (2, 2)),
             "granite/ragged": ("granite-moe-3b-a800m", (2, 2)),
             "gemma2": ("gemma2-9b", (1, 4)),
             "qwen2": ("qwen2-vl-7b", (1, 4)),
             "mamba2": ("mamba2-370m", (2, 2)),
             "mamba2/1,4": ("mamba2-370m", (1, 4)),
             "jamba": ("jamba-1.5-large-398b", (2, 2))}
# 1f1b at SEQ_PP, ragged, cf 16, aux loss 0 (the pipeline means the aux
# loss over microbatches, world 1 over the batch: another function).
SEQ_PP_CASE = "granite/pp"


def seq_arch(get_arch, case: str):
    """A case's reduced arch: granite in the case's dispatch mode (the
    pipelined case ragged at cf 16 without the aux loss), jamba at one rep
    of its pattern and cf 16."""
    name = SEQ_CASES[case][0] if case in SEQ_CASES else "granite-moe-3b-a800m"
    a = get_arch(name).reduced()
    if case == SEQ_PP_CASE:
        a = a.replace(moe=dataclasses.replace(a.moe, dispatch="ragged", capacity_factor=16.0,
                                              aux_loss_coef=0.0))
    elif case.startswith("granite/"):
        a = a.replace(moe=dataclasses.replace(a.moe, dispatch=case.split("/")[1]))
    elif name.startswith("jamba"):
        a = a.replace(num_layers=len(a.block_pattern),
                      moe=dataclasses.replace(a.moe, capacity_factor=16.0))
    return a


def layout_arch(get_arch, tag: str):
    base = get_arch(NAME).reduced()
    kind = SEQ_LAYOUTS[tag][1]
    if kind == "tp":
        return arch_tp(base, "ragged")
    return get_arch("qwen2-vl-7b").reduced() if kind == "qwen2" else base


def seq_tokens(b=SEQ_B, s=SEQ_S, seed=5):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(np.int32)


def seq_batch(arch):
    toks = seq_tokens()
    batch = {"tokens": toks, "labels": toks}
    if arch.frontend is not None:  # qwen2-vl: precomputed embeds beside the ids
        batch["embeds"] = np.random.default_rng(6).standard_normal(
            (SEQ_B, SEQ_S, arch.d_model)).astype(np.float32)
    return batch


def layout_batch():
    b, s = SEQ_LAYOUT_BATCH
    toks = (np.arange(b)[:, None] * 1000 + np.arange(s)[None]).astype(np.int32)
    return {"tokens": toks, "labels": toks + 1,
            "embeds": (toks[..., None] * 10 + np.arange(3)).astype(np.float32)}


def seq_params(arch):
    """The case's weights, drawn by the port (seed 0) as numpy: both sides
    start from them (a flat {path: array})."""
    import torch

    from repro_torch.models.model import init_params, tree_paths

    p = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    return {k: v.numpy() for k, v in tree_paths(p).items()}


# The seq-jax mode's two halves, each a process of its own (the test starts
# both at once): the layout and the cheap cases; jamba and the pipeline.
SEQ_JAX_PARTS = (("layout", "granite/capacity", "granite/ragged", "gemma2", "qwen2",
                  "mamba2", "mamba2/1,4"), ("jamba", SEQ_PP_CASE))


def _jax_blocks(plan, x, out: dict, tag: str) -> None:
    """Every device's block of the sharded array ``x`` into ``out``, keyed
    ``tag/<r>`` with r the device's row-major place in the plan's mesh
    (the port's rank at the same coordinates)."""
    devs = plan.mesh.devices
    where = {d.id: np.ravel_multi_index(tuple(np.argwhere(devs == d)[0]), devs.shape)
             for d in devs.flat}
    for sh in x.addressable_shards:
        out[f"{tag}/{where[sh.device.id]}"] = np.asarray(sh.data)


def run_seq_jax(out_path: str, part: int) -> None:
    """The reference's blocks and steps for the sequence-sharded layout:
    ``SEQ_JAX_PARTS[part]``'s."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import training as jtraining
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.models import moe as moe_lib
    from repro.models.model import LanguageModel
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    moe_lib._transport_bf16 = lambda a2a_fn, x: a2a_fn(x)  # the wire in fp32
    out = {}

    def blocks(plan, arr, spec, tag):
        _jax_blocks(plan, jax.device_put(arr, NamedSharding(plan.mesh, spec)), out, tag)

    todo = SEQ_JAX_PARTS[part]
    # 1. The layout: every device's block of batch_specs' sharding.
    lb = layout_batch()
    b, s = SEQ_LAYOUT_BATCH
    shape = ShapeSpec("layout", s, b, "train")
    for tag, (grid, _) in SEQ_LAYOUTS.items() if "layout" in todo else ():
        arch = layout_arch(get_arch, tag)
        names = ("pod", "data", "model")[-len(grid):]
        plan = make_plan(host_mesh(grid, names), arch)
        specs = jtraining.batch_specs(LanguageModel(arch, plan), shape)
        out[f"layout/{tag}/plan"] = np.asarray([plan.ep, plan.tp])
        out[f"layout/{tag}/keys"] = np.asarray(sorted(specs))
        for k, spec in specs.items():
            blocks(plan, lb[k], spec, f"layout/{tag}/{k}")
    # ... and under the pod pipeline: microbatch mb is rows [mb b_mu, (mb+1)
    # b_mu), each laid out as the executor's activations, P(dp, sp).
    if "layout" in todo:
        grid, M = SEQ_PP
        arch = get_arch(NAME).reduced()
        plan = make_plan(host_mesh(grid, ("pod", "data", "model")), arch,
                         pipeline_on_pod=True)
        spec = P(None, tuple(plan.dp_axes), tuple(plan.sp_axes))
        blocks(plan, lb["tokens"].reshape(M, b // M, s), spec, "layout/pp/tokens")

    # 2. Each case's loss and gradients on the reference's plan at its grid.
    def grads_of(tag, g):
        for k, v in _paths(g).items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out[f"{tag}/grad/{k}"] = np.asarray(v)

    for case, (_, grid) in SEQ_CASES.items():
        if case not in todo:
            continue
        arch = seq_arch(get_arch, case)
        params = jax.tree.map(jnp.asarray, _unflatten(seq_params(arch)))
        batch = {k: jnp.asarray(v) for k, v in seq_batch(arch).items()}
        plan = make_plan(host_mesh(grid, ("data", "model")), arch)
        lm = LanguageModel(arch, plan)
        with plan.mesh:
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, lm=lm: lm.loss(p, batch), has_aux=True, allow_int=True))(params)
        out[f"{case}/loss"] = np.asarray(loss)
        grads_of(case, g)

    # 3. 1f1b at PP 2 x ep 2, M = 2 PP: the pipelined step.
    if SEQ_PP_CASE not in todo:
        np.savez(out_path, **out)
        return
    arch = seq_arch(get_arch, SEQ_PP_CASE)
    params = jax.tree.map(jnp.asarray, _unflatten(seq_params(arch)))
    toks = seq_tokens(8, 32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    plan = make_plan(host_mesh(SEQ_PP[0], ("pod", "data", "model")), arch,
                     pipeline_on_pod=True, schedule="1f1b")
    lm = LanguageModel(arch, plan)
    with plan.mesh:
        loss, g, _ = jax.jit(lm.loss_and_grads)(params, batch)
    out[f"{SEQ_PP_CASE}/loss"] = np.asarray(loss)
    grads_of(SEQ_PP_CASE, g)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The sequence-sharded serving layout (tests/test_torch_seq_serve.py)
# ---------------------------------------------------------------------------

# Each case: (arch, grid, dispatch, capacity factor, b, prompt, cache rows,
# decode steps).  Granite's prompt is 16 positions a rank at (1, 4), 32 at
# (2, 2) (one row a data rank); the drop case runs the reduced capacity
# factor 1.25, where which tokens drop depends on the tokens a rank holds.
# gemma2's window (32) leaves rank 0's 32 rows from the first decode index
# (64) on.  mamba2 and jamba: 32 positions a rank (one SSM chunk); mamba2 at
# (1, 4) a 192-token prompt, 48 a rank: above the chunk and not a multiple
# of it.
SERVE_CASES = {
    "granite/capacity/1,4": ("granite-moe-3b-a800m", (1, 4), "capacity", 16.0, 2, 64, 128, 8),
    "granite/capacity/2,2": ("granite-moe-3b-a800m", (2, 2), "capacity", 16.0, 2, 64, 128, 8),
    "granite/ragged/1,4": ("granite-moe-3b-a800m", (1, 4), "ragged", 16.0, 2, 64, 128, 8),
    "granite/ragged/2,2": ("granite-moe-3b-a800m", (2, 2), "ragged", 16.0, 2, 64, 128, 8),
    "granite/drop/2,2": ("granite-moe-3b-a800m", (2, 2), "capacity", 1.25, 2, 64, 128, 8),
    "gemma2/1,4": ("gemma2-9b", (1, 4), None, None, 2, 64, 128, 40),
    "qwen2/1,4": ("qwen2-vl-7b", (1, 4), None, None, 2, 64, 128, 8),
    "mamba2/2,2": ("mamba2-370m", (2, 2), None, None, 2, 64, 128, 4),
    "mamba2/1,4": ("mamba2-370m", (1, 4), None, None, 2, 192, 256, 4),
    "jamba/2,2": ("jamba-1.5-large-398b", (2, 2), "ragged", 16.0, 2, 64, 128, 4),
}
# The serve-jax mode's parts, each a process of its own (started at once).
SERVE_JAX_PARTS = (("layout", "granite/capacity/1,4", "granite/capacity/2,2",
                    "granite/drop/2,2"),
                   ("granite/ragged/1,4", "granite/ragged/2,2", "qwen2/1,4", "mamba2/1,4"),
                   ("gemma2/1,4", "mamba2/2,2", "jamba/2,2"))
# The cache layout: rows a cache, at every SEQ_LAYOUTS grid (18 splits over
# 2 sequence ranks, not over 4: whole there); decode batches of 8 and 3 rows
# (3 splits over no data grid: whole).
SERVE_CACHE_ROWS, SERVE_DECODE_ROWS = (32, 18), (8, 3)


def serve_arch(get_arch, case: str):
    """A case's reduced arch (jamba at one rep of its pattern)."""
    name, _, mode, cf = SERVE_CASES[case][:4]
    a = get_arch(name).reduced()
    if name.startswith("jamba"):
        a = a.replace(num_layers=len(a.block_pattern))
    if mode is not None:
        a = a.replace(moe=dataclasses.replace(a.moe, dispatch=mode, capacity_factor=cf))
    return a


def serve_batch(arch, case: str) -> dict:
    """The prompt and the decode steps' true next inputs: (b, prompt +
    steps) tokens, and a frontend arch's seeded ``embeds`` beside them."""
    b, l, _, k = SERVE_CASES[case][4:]
    toks = np.random.default_rng(8).integers(0, 512, size=(b, l + k)).astype(np.int32)
    out = {"tokens": toks}
    if arch.frontend is not None:
        out["embeds"] = np.random.default_rng(9).standard_normal(
            (b, l + k, arch.d_model)).astype(np.float32)
    return out


def serve_layout_kv(arch, b: int, s: int):
    """A prompt's K (and V = -K) of every attention position, (reps, b, s,
    kv, hd) values that name their place."""
    reps = arch.num_layers // len(arch.block_pattern)
    shape = (reps, b, s, arch.num_kv_heads, arch.head_dim)
    k = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1
    return [(k, -k) if m.startswith("attn") else None for m, _ in arch.block_pattern]


def run_serve_jax(out_path: str, part: int) -> None:
    """The reference's dense-cache serving on 8 fake host devices, its wire
    in fp32: ``SERVE_JAX_PARTS[part]``.  "layout": every device's block of
    the prefill and decode ``batch_specs`` and of ``cache_specs`` at each
    ``SEQ_LAYOUTS`` grid.  A case: the jitted ``make_prefill_step`` with
    the prefill ``batch_specs`` in, the K/V padded to the cache's rows by
    hand (as its callers do) and laid out by ``cache_specs``, then the
    jitted ``make_decode_step`` on the true next tokens with the decode
    ``batch_specs`` and ``cache_specs`` in and the cache's out: every
    step's logits and every device's cache block after the prefill and
    after the last step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import training as jtraining
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.models import moe as moe_lib
    from repro.models.model import LanguageModel
    from repro.sharding import host_mesh, make_plan

    assert len(jax.devices()) == 8, jax.devices()
    moe_lib._transport_bf16 = lambda a2a_fn, x: a2a_fn(x)  # the wire in fp32
    out, todo = {}, SERVE_JAX_PARTS[part]

    def plan_at(arch, grid):
        plan = make_plan(host_mesh(grid, ("pod", "data", "model")[-len(grid):]), arch)
        return dataclasses.replace(plan, compute_dtype="float32")

    def ns(plan, tree):
        return jax.tree.map(lambda sp: NamedSharding(plan.mesh, sp), tree,
                            is_leaf=lambda x: isinstance(x, P))

    def pad(cache, rows):
        return tuple({k: jnp.pad(v, ((0, 0), (0, 0), (0, rows - v.shape[2]), (0, 0),
                                     (0, 0))) for k, v in c.items()} if "k" in c else c
                     for c in cache)

    def cache_blocks(plan, cache, tag):
        for pos, c in enumerate(cache):
            for k, v in c.items():
                _jax_blocks(plan, v, out, f"{tag}/{pos}/{k}")

    if "layout" in todo:
        lb = layout_batch()
        b, s = SEQ_LAYOUT_BATCH
        for tag, (grid, _) in SEQ_LAYOUTS.items():
            arch = layout_arch(get_arch, tag)
            plan = plan_at(arch, grid)
            lm = LanguageModel(arch, plan)
            specs = jtraining.batch_specs(lm, ShapeSpec("p", s, b, "prefill"))
            for k, spec in specs.items():
                _jax_blocks(plan, jax.device_put(lb[k], NamedSharding(plan.mesh, spec)), out,
                            f"serve/layout/{tag}/prefill/{k}")
            for rows in SERVE_DECODE_ROWS:
                spec = jtraining.batch_specs(lm, ShapeSpec("d", s, rows, "decode"))["tokens"]
                _jax_blocks(plan, jax.device_put(lb["tokens"][:rows, :1],
                                                 NamedSharding(plan.mesh, spec)), out,
                            f"serve/layout/{tag}/decode/{rows}")
            kv = serve_layout_kv(arch, b, s)
            for rows in SERVE_CACHE_ROWS:
                cache = pad(tuple({"k": jnp.asarray(p[0]), "v": jnp.asarray(p[1])}
                                  for p in kv), rows)
                cache = jax.device_put(cache, ns(plan, lm.cache_specs(b, rows)))
                cache_blocks(plan, cache, f"serve/layout/{tag}/cache/{rows}")

    for case, (_, grid, *_rest) in SERVE_CASES.items():
        if case not in todo:
            continue
        b, l, rows, steps = SERVE_CASES[case][4:]
        arch = serve_arch(get_arch, case)
        params = jax.tree.map(jnp.asarray, _unflatten(seq_params(arch)))
        batch = {k: jnp.asarray(v) for k, v in serve_batch(arch, case).items()}
        plan = plan_at(arch, grid)
        lm = LanguageModel(arch, plan)
        pspecs = jtraining.batch_specs(lm, ShapeSpec("p", l, b, "prefill"))
        dspecs = jtraining.batch_specs(lm, ShapeSpec("d", rows, b, "decode"))
        cache_sh = ns(plan, lm.cache_specs(b, rows))
        prefill = jax.jit(jtraining.make_prefill_step(lm),
                          in_shardings=(None, ns(plan, {k: pspecs[k] for k in batch})))
        decode = jax.jit(jtraining.make_decode_step(lm),
                         in_shardings=(None, cache_sh, ns(plan, {k: dspecs[k] for k in batch}),
                                       None), out_shardings=(None, cache_sh))
        with plan.mesh:
            logits, cache = prefill(params, {k: v[:, :l] for k, v in batch.items()})
            cache = jax.device_put(pad(cache, rows), cache_sh)
            out[f"serve/{case}/logits/0"] = np.asarray(logits)
            cache_blocks(plan, cache, f"serve/{case}/cache0")
            for i in range(steps):
                logits, cache = decode(params, cache,
                                       {k: v[:, l + i:l + i + 1] for k, v in batch.items()},
                                       jnp.int32(l + i))
                out[f"serve/{case}/logits/{i + 1}"] = np.asarray(logits)
            cache_blocks(plan, cache, f"serve/{case}/cache1")
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
        res = (_phase_pp(rank, out_dir) if phase == "pp"
               else _phase_seq(rank) if phase == "seq"
               else _phase_serve(rank) if phase == "serve"
               else _phase4(rank, dict(np.load(ref_path)), out_dir))
        np.savez(Path(out_dir) / f"{phase}_rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _params(ref, prefix):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(_unflatten({k[len(prefix):]: v for k, v in ref.items()
                                         if k.startswith(prefix)}), "cpu")


def _flat_np(prefix, tree, res):
    from repro_torch.models.model import tree_paths

    for k, v in tree_paths(tree).items():
        if v is not None:
            res[f"{prefix}/{k}"] = v.detach().numpy()


def _clone(tree):
    from repro_torch.models.model import map_tree

    return map_tree(lambda t: t.clone(), tree)


def _sharded_state(state, plan):
    from repro_torch.convert import shard_params

    return {k: _clone(shard_params(v, plan)) if k in ("params", "m", "v") else v
            for k, v in state.items()}


def _quiet(_msg):
    pass


def _phase4(rank: int, ref, out_dir: str):
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, shard_params, state_from_numpy
    from repro_torch.core import migration as mig
    from repro_torch.models import moe
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.serving import Engine, Request, ServeConfig
    from repro_torch.serving.kv_cache import BlockPool, PagedLayout
    from repro_torch.training import init_state

    res = {}
    base = get_arch(NAME).reduced()
    opt = OptimizerConfig(lr=1e-3)

    # 1. tp 2 at (1, 4): the loss and gathered gradients with the bf16 wire
    # (against the reference's tp plan) and with an fp32 wire (against world
    # 1, which has no wire); one AdamW step, after which the two tp lanes of
    # each EP rank hold the same params; served tokens.
    params = _params(ref, "tp_params/")
    batch = {"tokens": ref["tp_toks"], "labels": ref["tp_toks"]}
    for mode in MODES:
        arch = arch_tp(base, mode)
        plan = sharding.make_plan(arch, TP_MESH)
        res[f"tp/{mode}/plan"] = np.asarray([plan.ep, plan.tp, *plan.coords])
        lm, mine = LanguageModel(arch, plan), shard_params(params, plan)
        wire = moe.WIRE_DTYPE
        for tag, w in (("tp", wire), ("tp32", torch.float32)):
            moe.WIRE_DTYPE = w
            try:
                loss, _, grads = training.loss_and_grads(lm, mine, batch, torch.float32)
            finally:
                moe.WIRE_DTYPE = wire
            res[f"{tag}/{mode}/loss"] = loss.numpy()
            _flat_np(f"{tag}/{mode}/grad", gather_params(grads, plan), res)
        # The data grid with as many tokens a rank and the EP degree, no tp.
        dplan = sharding.make_plan(arch, TP_CONTROL)
        loss, _, grads = training.loss_and_grads(LanguageModel(arch, dplan),
                                                 shard_params(params, dplan), batch,
                                                 torch.float32)
        res[f"tpdp/{mode}/loss"] = loss.numpy()
        _flat_np(f"tpdp/{mode}/grad", gather_params(grads, dplan), res)
        if rank == 0:
            loss, _, grads = training.loss_and_grads(LanguageModel(arch), params, batch,
                                                     torch.float32)
            res[f"tp1/{mode}/loss"] = loss.numpy()
            _flat_np(f"tp1/{mode}/grad", grads, res)
        state_params = _clone(mine)
        state = {"params": state_params, **adamw_init(state_params)}
        _, met = training.make_train_step(lm, opt, compute_dtype=torch.float32)(state, batch)
        res[f"tpstep/{mode}/loss"] = met["loss"].numpy()
        res[f"tpstep/{mode}/skipped"] = np.asarray(met["skipped"])
        _flat_np(f"tpstep/{mode}/local", state["params"], res)
        for tag, p in (("tpserve", plan),) + ((("tpserve1", None),) if rank == 0 else ()):
            eng = Engine(LanguageModel(arch, p), shard_params(params, p), ServeConfig(**SERVE))
            out = eng.run([Request(rid=i, tokens=t, max_new_tokens=6)
                           for i, t in enumerate(serve_prompts())])
            res[f"{tag}/{mode}/tokens"] = _tokens(out)

    # 2. Serving data parallelism at (2, 2) and (2, 1, 2), both dispatch
    # modes, against world 1; the paged decode logits at (2, 2) against the
    # reference's on the same mesh.
    sparams = _params(ref, "serve_params/")
    for mode in MODES:
        arch = arch_serve(base, mode)
        for mesh in DP_MESHES + ((None,) if rank == 0 else ()):
            plan = None if mesh is None else sharding.make_plan(arch, mesh)
            tag = "1" if mesh is None else ",".join(map(str, mesh))
            eng = Engine(LanguageModel(arch, plan), shard_params(sparams, plan),
                         ServeConfig(**SERVE))
            out = eng.run([Request(rid=i, tokens=t, max_new_tokens=6)
                           for i, t in enumerate(serve_prompts())])
            res[f"dpserve/{tag}/{mode}/tokens"] = _tokens(out)
            if plan is not None:
                res[f"dpserve/{tag}/{mode}/plan"] = np.asarray([plan.dp, plan.ep, plan.tp])
    arch = arch_serve(base, "ragged")
    layout = PagedLayout(num_blocks=12, block_size=4, max_seqs=2, max_blocks_per_seq=4)
    dtoks, plen = torch.from_numpy(ref["decode_toks"]).long(), DECODE["plen"]
    for tag, plan in (("decode", sharding.make_plan(arch, DP_MESHES[0])),) + (
            (("decode1", None),) if rank == 0 else ()):
        lm = LanguageModel(arch, plan)
        mine = shard_params(sparams, plan)
        pool = BlockPool(layout)
        pool.admit(plen)
        pool.admit(plen)
        cache = lm.init_paged_cache(layout, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            _, cache = lm.prefill_paged(mine, {"tokens": dtoks[:, :plen]}, cache,
                                        torch.from_numpy(pool.block_table.copy()),
                                        torch.from_numpy(pool.lengths.copy()))
            logits = []
            for i in range(dtoks.shape[1] - plen):
                pool.extend(0, 1)
                pool.extend(1, 1)
                lg, cache = lm.decode_step_paged(
                    mine, cache, torch.from_numpy(pool.block_table.copy()),
                    torch.tensor([plen + i, plen + i], dtype=torch.int32),
                    {"tokens": dtoks[:, plen + i:plen + i + 1]})
                logits.append(lg.numpy())
        res[f"{tag}/logits"] = np.stack(logits)
        res[f"{tag}/block_table"] = pool.block_table.copy()

    # 3. PP 2 x EP 2 migration at (2, 1, 2).
    # 3a. The controller on the reference's seeded state and EMA.
    arch = arch_pp(base)
    plan = sharding.make_plan(arch, PP_MESH, pipeline_on_pod=True)
    res["mig/plan"] = np.asarray([plan.pp, plan.dp, plan.ep, plan.tp, plan.pp_rank,
                                  plan.ep_rank])
    before = {t: _unflatten({k[len(f"ctrl/before/{t}/"):]: v for k, v in ref.items()
                             if k.startswith(f"ctrl/before/{t}/")})
              for t in ("params", "m", "v")}
    before["step"] = ref["ctrl/before/step"]
    state = _sharded_state(state_from_numpy(before, "cpu"), plan)
    tr = Trainer(LanguageModel(arch, plan), opt,
                 TrainerConfig(migrate_every=1, migrate_threshold=1.05), log_fn=_quiet)
    tr.load_stats.ema = ref["ctrl/ema"].copy()
    tr._maybe_migrate(state, 1)
    after = tr.global_state(state)
    if rank == 0:
        _flat_np("ctrl/after", {t: after[t] for t in ("params", "m", "v")}, res)
    rec = tr.migrations[-1]
    res["ctrl/record"] = np.asarray([rec["imbalance"], rec["imbalance_post"], rec["swaps"],
                                     rec["replicas"], float(rec["applied"])])
    tables = b"".join(np.ascontiguousarray(v.numpy()).tobytes()
                      for k, v in tree_paths(after["params"]).items()
                      if k.endswith(("/assignment", "/replicas")))
    res["ctrl/crc"] = np.asarray(zlib.crc32(tr.load_stats.ema.tobytes() + tables))
    del after

    # 3b. Swap-only exactness (the reference's check_migration_exactness):
    # a migration after step 3 is one permutation pass of params, m and v,
    # and the loss trajectory is that of a run whose init carried it.
    arch = arch_pp(base, replicas=0, top_k=4, aux_loss_coef=0.0)
    plan = sharding.make_plan(arch, PP_MESH, pipeline_on_pod=True)
    lm = LanguageModel(arch, plan)
    cfg = TrainerConfig(migrate_every=1, migrate_threshold=1.05)
    tr = Trainer(lm, opt, cfg, log_fn=_quiet)
    state = _sharded_state(init_state(lm, torch.Generator().manual_seed(0), "cpu"), plan)

    def gathered(st):
        return {k: v.clone() for k, v in tree_paths(tr.global_state(st)).items()}

    losses, exact, perms = [], True, {}
    for s in range(5):
        state, met = tr.train_step(state, skewed_batch(s))
        losses.append(float(met["loss"]))
        loads = met["expert_load_host"]
        tr.load_stats.update(np.concatenate([loads[:, i] for i in range(loads.shape[1])]))
        if s == 2:
            pre = gathered(state)
            tr._maybe_migrate(state, 1)
            post = gathered(state)
            for pos in range(len(arch.block_pattern)):
                head = f"blocks/{pos}/ffn"
                old_a = pre[f"params/{head}/assignment"].numpy()
                new_a = post[f"params/{head}/assignment"].numpy()
                perms[pos] = np.stack([mig.permutation_for(old_a[r], new_a[r])
                                       for r in range(old_a.shape[0])])
                for t in ("params", "m", "v"):
                    for k in sharding.EXPERT_KEYS:
                        w = pre[f"{t}/{head}/{k}"].numpy()
                        want = np.take_along_axis(
                            w, perms[pos].reshape(perms[pos].shape + (1,) * (w.ndim - 2)),
                            axis=1)
                        exact &= np.array_equal(post[f"{t}/{head}/{k}"].numpy(), want)
    res["exact/applied"] = np.asarray(len(tr.migrations) == 1 and tr.migrations[0]["applied"])
    res["exact/swaps"] = np.asarray(tr.migrations[0]["swaps"])
    res["exact/moments_exact"] = np.asarray(exact)
    res["exact/losses"] = np.asarray(losses)
    full = init_state(lm, torch.Generator().manual_seed(0), "cpu")
    for pos, perm in perms.items():
        for t in ("params", "m", "v"):
            mig.apply_migration_(full[t]["blocks"][pos]["ffn"], perm)
        full["params"]["blocks"][pos]["ffn"]["assignment"].copy_(
            post[f"params/blocks/{pos}/ffn/assignment"])
    tr_b = Trainer(lm, opt, cfg, log_fn=_quiet)
    state_b = _sharded_state(full, plan)
    losses_b = []
    for s in range(5):
        state_b, met = tr_b.train_step(state_b, skewed_batch(s))
        losses_b.append(float(met["loss"]))
    res["exact/losses_b"] = np.asarray(losses_b)

    # 3c. fit at (2, 1, 2) with migrations every 2 steps and a checkpoint;
    # rank 0 restores its last checkpoint at world 1.
    arch = arch_pp(base)
    plan = sharding.make_plan(arch, PP_MESH, pipeline_on_pod=True)
    lm = LanguageModel(arch, plan)
    ck = f"{out_dir}/ck_mig"
    tr = Trainer(lm, opt, TrainerConfig(total_steps=4, checkpoint_dir=ck, checkpoint_every=2,
                                        migrate_every=2, migrate_threshold=1.05,
                                        log_every=100), log_fn=_quiet)
    out = tr.fit(_sharded_state(init_state(lm, torch.Generator().manual_seed(0), "cpu"),
                                plan), _Skewed())
    res["migck/applied"] = np.asarray(sum(m["applied"] for m in out["migrations"]))
    res["migck/loss"] = np.asarray(float(out["metrics"]["loss"]))
    glob = tr.global_state(out["state"])
    if rank == 0:
        res["migck/restored_crc_equal"] = np.asarray(_restore_crc_equal(
            ck, LanguageModel(arch), glob))
    del glob

    # 3d. The PP 2 run's checkpoint (phase "pp") restored at PP 2 x EP 2.
    arch = arch_pp(base, replicas=0)
    plan = sharding.make_plan(arch, PP_MESH, pipeline_on_pod=True)
    res["ppck/ep2_crc_equal"] = np.asarray(_restore_crc_equal(
        f"{out_dir}/ckA", LanguageModel(arch, plan)))
    return res


class _Skewed:
    def batch_at(self, step: int):
        return skewed_batch(step)


def _restore_crc_equal(ck: str, lm, want=None) -> bool:
    """Restore the newest checkpoint under ``ck`` into a fresh state of
    ``lm``'s mesh (another seed's, sharded): the gathered state's CRC32s
    equal the manifest's (and, with ``want``, the state equals it)."""
    import json

    import torch

    from repro_torch.checkpoint.checkpointing import leaf_crc32s, latest_step
    from repro_torch.models.model import tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    tr = Trainer(lm, OptimizerConfig(lr=1e-3), TrainerConfig(checkpoint_dir=ck),
                 log_fn=_quiet)
    state = init_state(lm, torch.Generator().manual_seed(9), "cpu")
    if tr.plan is not None:
        state = _sharded_state(state, tr.plan)
    state, step = tr._restore_latest(state)
    full = tr.global_state(state)
    manifest = json.loads((Path(ck) / f"step_{step:08d}" / "manifest.json").read_text())
    ok = step == latest_step(ck) and leaf_crc32s(full) == manifest["crc32"]
    if want is not None:
        ok &= all(torch.equal(a, b) for a, b in zip(tree_paths(full).values(),
                                                    tree_paths(want).values()))
    return bool(ok)


def _phase_pp(rank: int, out_dir: str):
    """Checkpointing under a pipeline (PP 2, depth 4, 1f1b)."""
    import json

    import torch

    from repro_torch import sharding
    from repro_torch.checkpoint.checkpointing import checkpoint_steps, leaf_crc32s
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    res = {}
    arch = arch_pp(get_arch(NAME).reduced(), replicas=0)
    plan = sharding.make_plan(arch, (2, 1, 1), pipeline_on_pod=True)
    lm = LanguageModel(arch, plan)
    data = SyntheticTokens(arch.vocab_size, 4, 16)

    def run(d, seed=0, injector=None):
        tr = Trainer(lm, OptimizerConfig(lr=1e-3, total_steps=CK_STEPS),
                     TrainerConfig(total_steps=CK_STEPS, checkpoint_dir=d,
                                   checkpoint_every=CK_EVERY, log_every=1000),
                     log_fn=_quiet, injector=injector)
        st = _sharded_state(init_state(lm, torch.Generator().manual_seed(seed), "cpu"), plan)
        return tr, tr.fit(st, data)

    def spec(*specs):
        return FaultInjector(FaultPlan(list(specs)), log_fn=_quiet)

    tr_a, out_a = run(f"{out_dir}/ckA")
    full_a = tr_a.global_state(out_a["state"])
    res["A/loss"] = out_a["metrics"]["loss"].numpy()
    # NaN x 3 -> three skips -> rollback to the last checkpoint; then SIGTERM
    # -> final save; a fresh trainer on another seed's state resumes.
    inj = spec(FaultSpec("train.nonfinite", step=CK_NAN, count=3),
               FaultSpec("train.sigterm", step=CK_SIGTERM))
    tr_b, out_b = run(f"{out_dir}/ckB", injector=inj)
    res["B/anomalies"] = np.asarray([a["step"] for a in out_b["anomalies"]])
    res["B/rollbacks"] = np.asarray([[r["at_step"], r["to_step"]] for r in out_b["rollbacks"]])
    res["B/last_step"] = np.asarray(out_b["last_step"])
    res["B/saved"] = np.asarray(checkpoint_steps(f"{out_dir}/ckB"))
    tr_c, out_c = run(f"{out_dir}/ckB", seed=1)
    full_c = tr_c.global_state(out_c["state"])
    res["C/resumed_from"] = np.asarray(tr_c.resumed_from)
    res["C/loss"] = out_c["metrics"]["loss"].numpy()
    res["C/bitwise_A"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(tree_paths(full_c).values(),
                                          tree_paths(full_a).values())))
    if rank == 0:
        manifest = json.loads((Path(out_dir) / "ckA" / f"step_{CK_STEPS:08d}" /
                               "manifest.json").read_text())
        res["A/manifest_crc_equal"] = np.asarray(manifest["crc32"] == leaf_crc32s(full_a))
        res["A/extras"] = np.asarray(sorted(manifest["extras"]))
        res["A/ema"] = tr_a.load_stats.ema.copy()
        res["C/ema"] = tr_c.load_stats.ema.copy()
        res["A/saved"] = np.asarray(checkpoint_steps(f"{out_dir}/ckA"))
        # The PP 2 checkpoint restored at world 1.
        res["world1_crc_equal"] = np.asarray(_restore_crc_equal(f"{out_dir}/ckA",
                                                                LanguageModel(arch), full_a))
    # ... and under interleaved_1f1b, V 2 (another chunk layout).
    vplan = sharding.make_plan(arch, (2, 1, 1), pipeline_on_pod=True,
                               schedule="interleaved_1f1b", vstages=2)
    res["v2_crc_equal"] = np.asarray(_restore_crc_equal(f"{out_dir}/ckA",
                                                        LanguageModel(arch, vplan), full_a))
    return res


def _phase_seq(rank: int):
    """The port's side of ``run_seq_jax``: each case at its grid (the
    gathered gradients), world 1 on rank 0, and 1f1b at ``SEQ_PP``."""
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import gather_params, params_from_numpy, shard_params
    from repro_torch.models import moe
    from repro_torch.models.model import LanguageModel

    res = {}
    moe.WIRE_DTYPE = torch.float32

    def run(tag, arch, plan, batch):
        loss, _, grads = training.loss_and_grads(LanguageModel(arch, plan), shard_params(
            params, plan), batch, torch.float32)
        res[f"{tag}/loss"] = loss.numpy()
        _flat_np(f"{tag}/grad", grads if plan is None else gather_params(grads, plan), res)

    for case, (_, grid) in SEQ_CASES.items():
        arch = seq_arch(get_arch, case)
        params = params_from_numpy(_unflatten(seq_params(arch)), "cpu")
        batch = seq_batch(arch)
        plan = sharding.make_plan(arch, grid)
        res[f"{case}/block"] = np.asarray(training.batch_block(plan, SEQ_B, SEQ_S))
        run(case, arch, plan, batch)
        if rank == 0:
            run(f"{case}/world1", arch, None, batch)
    arch = seq_arch(get_arch, SEQ_PP_CASE)
    params = params_from_numpy(_unflatten(seq_params(arch)), "cpu")
    toks = seq_tokens(8, 32)
    batch = {"tokens": toks, "labels": toks}
    plan = sharding.make_plan(arch, SEQ_PP[0], pipeline_on_pod=True, schedule="1f1b")
    res["pp/microbatches"] = np.asarray(plan.num_microbatches)
    run(SEQ_PP_CASE, arch, plan, batch)
    if rank == 0:
        run(f"{SEQ_PP_CASE}/world1", arch, None, batch)
    return res


def _phase_serve(rank: int):
    """The port's side of ``run_serve_jax``: the layout (each rank's
    prefill and decode rows, and the cache block ``pad_cache`` makes from
    its prefill slice of ``serve_layout_kv``, beside ``init_cache``'s
    shapes), then every case through ``make_prefill_step`` /
    ``pad_cache`` / ``make_decode_step`` on its grid, and at world 1 on
    rank 0."""
    import torch

    from repro_torch import sharding, training
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.models import moe
    from repro_torch.models.model import KVBlock, LanguageModel, map_tree

    res = {}
    moe.WIRE_DTYPE = torch.float32
    lb = layout_batch()
    b, s = SEQ_LAYOUT_BATCH
    for tag, (grid, _) in SEQ_LAYOUTS.items():
        arch = layout_arch(get_arch, tag)
        plan = sharding.make_plan(arch, grid)
        lm = LanguageModel(arch, plan)
        pre = f"serve/layout/{tag}"
        for k, v in training.shard_batch(lb, plan).items():
            res[f"{pre}/prefill/{k}"] = v
        for rows in SERVE_DECODE_ROWS:
            res[f"{pre}/decode/{rows}"] = lb["tokens"][:rows, :1][lm._data_share(rows)[0]]
        bl, sl = training.batch_block(plan, b, s)
        d, off = plan.coords[0], plan.seq_offset(sl)
        mine = tuple({"k": torch.from_numpy(p[0][:, d * bl:(d + 1) * bl, off:off + sl]),
                      "v": torch.from_numpy(p[1][:, d * bl:(d + 1) * bl, off:off + sl])}
                     for p in serve_layout_kv(arch, b, s))
        for rows in SERVE_CACHE_ROWS:
            blocks = lm.pad_cache(mine, rows)
            fresh = lm.init_cache(b, rows, torch.float32, "cpu")
            for pos, c in enumerate(blocks):
                for k, v in c.items():
                    res[f"{pre}/cache/{rows}/{pos}/{k}"] = v.numpy()
                res[f"{pre}/cache/{rows}/{pos}/kv_block"] = np.asarray(
                    [isinstance(c, KVBlock), isinstance(fresh[pos], KVBlock)])
                res[f"{pre}/cache/{rows}/{pos}/init_shape"] = np.asarray(fresh[pos]["k"].shape)

    def run(tag, arch, plan, params, batch, l, rows, steps):
        lm = LanguageModel(arch, plan)
        prefill = training.make_prefill_step(lm, torch.float32)
        decode = training.make_decode_step(lm, torch.float32)
        logits, cache = prefill(params, {k: v[:, :l] for k, v in batch.items()})
        cache = lm.pad_cache(cache, rows)
        res[f"{tag}/logits/0"] = logits.numpy()
        _flat_np(f"{tag}/cache0", _clone(cache), res)  # decode writes the cache in place
        if any(isinstance(c, KVBlock) for c in cache):
            first = {k: v[:, l:l + 1] for k, v in batch.items()}
            # map_tree keeps each "kv_seq" block's layout; a plain dict of one is refused.
            res[f"{tag}/mapped_logits"] = decode(params, map_tree(torch.clone, cache), first,
                                                 l)[0].numpy()
            try:
                decode(params, tuple(dict(c) for c in cache), first, l)
                res[f"{tag}/plain_block_raises"] = np.asarray(False)
            except ValueError as e:  # refused for its layout, not for its index
                res[f"{tag}/plain_block_raises"] = np.asarray("KVBlock" in str(e))
        for i in range(steps):
            logits, cache = decode(params, cache,
                                   {k: v[:, l + i:l + i + 1] for k, v in batch.items()}, l + i)
            res[f"{tag}/logits/{i + 1}"] = logits.numpy()
        _flat_np(f"{tag}/cache1", cache, res)
        if any(m.startswith("attn") for m, _ in arch.block_pattern):
            try:  # an index past the cache's rows raises before any layer runs
                decode(params, cache, {k: v[:, :1] for k, v in batch.items()}, rows)
                res[f"{tag}/past_end_raises"] = np.asarray(False)
            except ValueError:
                res[f"{tag}/past_end_raises"] = np.asarray(True)

    for case, (_, grid, *_rest) in SERVE_CASES.items():
        _, l, rows, steps = SERVE_CASES[case][4:]
        arch = serve_arch(get_arch, case)
        params = params_from_numpy(_unflatten(seq_params(arch)), "cpu")
        batch = serve_batch(arch, case)
        plan = sharding.make_plan(arch, grid)
        run(f"serve/{case}", arch, plan, shard_params(params, plan), batch, l, rows, steps)
        if rank == 0:
            run(f"serve/{case}/world1", arch, None, params, batch, l, rows, steps)
    return res


def run_serve_port(out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(4, "serve", "", out_dir), nprocs=4,
                       start_method="spawn")


def run_seq_port(out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(4, "seq", "", out_dir), nprocs=4,
                       start_method="spawn")


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
        run_jax(sys.argv[2])
    elif sys.argv[1] == "seq-jax":
        run_seq_jax(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "serve-jax":
        run_serve_jax(sys.argv[2], int(sys.argv[3]))
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        if sys.argv[1] == "pp":
            run_pp(sys.argv[2])
        elif sys.argv[1] == "seq-port":
            run_seq_port(sys.argv[2])
        elif sys.argv[1] == "serve-port":
            run_serve_port(sys.argv[2])
        else:
            run_port(sys.argv[2], sys.argv[3])
