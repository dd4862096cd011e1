"""The frontend archs in the port against the JAX package, on the CPU:
musicgen-large (audio frames, no positional embedding) and qwen2-vl-7b
(vision patches, M-RoPE), each fed precomputed ``embeds``.

Each config is a copy of the reference's, held field by field with ``==``
(``frontend`` among them) at full size and in ``reduced()`` form, with
``total_params()`` equal.  M-RoPE: ``mrope_sections`` equal at every head
dim an arch uses; ``apply_mrope`` against the reference with three
different seeded position planes; with three equal planes it is the port's
``apply_rope`` bit for bit (the Qwen2-VL property the reference states).
In reduced form (d_model 64, 4 heads over 2 of head_dim 16, vocab 512),
on weights converted from the reference's ``init_params`` and seeded
numpy ``embeds``: the forward logits, the loss and every gradient (the
``embed`` gradient exactly 0 on both sides: no lookup, no tied head), one
AdamW step, ``prefill`` then embeds-only ``decode_step`` and
``prefill_paged`` then ``decode_step_paged``, each against the reference's
steps.  ``embeds`` equal to the table's rows give the token path's logits
bit for bit, and ``training.shard_batch`` splits ``embeds`` as it splits
``tokens``, each rank taking its rows and its sequence slice.

Tolerances: the reference's model parity 1e-5 (absolute and relative;
both sides fp32, summation order alone); ``apply_mrope`` 1e-6 (one
rotation of unit-scale values); the AdamW step's moments 1e-6 absolute.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models.model import LanguageModel as JLM
from repro.optim import optimizer as jopt
from repro.serving.kv_cache import BlockPool as JBlockPool
from repro.serving.kv_cache import PagedLayout as JPagedLayout
from repro.sharding import single_device_plan
from repro_torch import training
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.models import layers
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import optimizer as topt
from repro_torch.serving.kv_cache import BlockPool, PagedLayout
from repro_torch.sharding import MeshPlan

NAMES = ["musicgen-large", "qwen2-vl-7b"]
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _fields(a):
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(a) for v in (getattr(a, f.name),)}


# ---------------------------------------------------------------------------
# The configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_the_reference(name, reduced):
    """Every field, ``frontend`` and ``rope_type`` among them, equals the
    reference's with ``==``, and so do the parameter counts."""
    mine, ref = get_arch(name), jget_arch(name)
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    assert _fields(mine) == _fields(ref)
    assert mine.total_params() == ref.total_params()
    assert mine.active_params() == ref.active_params()
    assert name in ARCHS
    assert mine.frontend == {"musicgen-large": "audio_frames",
                             "qwen2-vl-7b": "vision_patches"}[name]
    assert mine.rope_type == {"musicgen-large": "none", "qwen2-vl-7b": "mrope"}[name]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_mrope_sections_equal_the_reference(d):
    got = layers.mrope_sections(d)
    assert got == jlayers.mrope_sections(d)
    assert sum(got) == d // 2
    if d == 128:
        assert got == (16, 24, 24)  # the published split
    if d == 16:
        assert got == (2, 3, 3)  # the reduced configs'


@pytest.mark.parametrize("d", [16, 128])
def test_apply_mrope_matches_reference(d):
    """Three different seeded (t, h, w) position planes: each frequency
    section rotates by its own plane's positions."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 12, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 12)).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # Each section is the 1-D rotation by its plane: the split matters.
    rope = [layers.apply_rope(torch.from_numpy(x), torch.from_numpy(p).long(), 1e6)
            for p in pos]
    assert not torch.equal(got, rope[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_with_equal_planes_is_rope_bitwise(dtype):
    """The reference's property (``layers.py:69-71``): with the three
    planes equal (text), M-RoPE is 1-D RoPE, bit for bit; and
    ``positional_embed``'s "mrope" branch is that broadcast."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 128)).astype(np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 30000, (2, 9)))
    rope = layers.apply_rope(x, pos, 1e6)
    assert torch.equal(layers.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6), rope)
    assert torch.equal(layers.positional_embed(x, pos, "mrope", 1e6), rope)
    assert torch.equal(layers.positional_embed(x, pos, "none", 1e6), x)


# ---------------------------------------------------------------------------
# The reduced archs with precomputed embeds, against the reference
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _setup(name):
    """(JAX lm with fp32 compute, its init state as numpy, port lm)."""
    arch_j = jget_arch(name).reduced()
    plan = dataclasses.replace(single_device_plan(arch_j), compute_dtype="float32")
    lm_j = JLM(arch_j, plan)
    with plan.mesh:
        state_j = jtraining.init_state(lm_j, jax.random.PRNGKey(0), jopt.OptimizerConfig())
    return lm_j, jax.tree.map(np.asarray, state_j), LanguageModel(get_arch(name).reduced())


def _batch(arch, b=2, s=32, seed=0):
    """Seeded tokens, labels and (b, s, d_model) fp32 embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab_size, (b, s + 1)).astype(np.int32)
    emb = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "embeds": emb}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", NAMES)
def test_forward_with_embeds_matches_reference(name):
    lm_j, state_np, lm_t = _setup(name)
    batch = _batch(lm_t.arch, 2, 24)
    batch.pop("labels")
    with lm_j.plan.mesh:
        want, _, _ = jax.jit(lm_j.forward)(jax.tree.map(jnp.asarray, state_np["params"]),
                                           _jax(batch))
    got, _, loads = lm_t.forward(state_from_numpy(state_np, "cpu")["params"],
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 24, lm_t.arch.padded_vocab()) and loads is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    # The embeds, not the tokens, drive it.
    toks_only, _, _ = lm_t.forward(state_from_numpy(state_np, "cpu")["params"],
                                   {"tokens": torch.from_numpy(batch["tokens"])})
    assert not torch.allclose(toks_only, got)


@pytest.mark.parametrize("name", NAMES)
def test_embeds_equal_to_table_rows_give_the_token_logits_bitwise(name):
    _, state_np, lm_t = _setup(name)
    params = state_from_numpy(state_np, "cpu")["params"]
    toks = torch.from_numpy(_batch(lm_t.arch, 2, 24)["tokens"])
    want, _, _ = lm_t.forward(params, {"tokens": toks})
    got, _, _ = lm_t.forward(params, {"embeds": params["embed"][toks.long()],
                                      "tokens": torch.zeros_like(toks)})
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_with_embeds_match_reference(name):
    """The loss, its parts and every gradient; the untied ``embed`` gets
    exactly 0 on both sides (no lookup, no tied head)."""
    lm_j, state_np, lm_t = _setup(name)
    batch = _batch(lm_t.arch)
    with lm_j.plan.mesh:
        (jl, jm), jg = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))(
            jax.tree.map(jnp.asarray, state_np["params"]), _jax(batch))
    params = state_from_numpy(state_np, "cpu")["params"]
    loss, metrics, grads = training.loss_and_grads(lm_t, params, batch, torch.float32)
    np.testing.assert_allclose(_np(loss), _np(jl), **MODEL_TOL)
    np.testing.assert_allclose(_np(metrics["ce"]), _np(jm["ce"]), **MODEL_TOL)
    jflat = {p: g for p, g in tree_paths(jg).items() if g.dtype != jax.dtypes.float0}
    got = {p: g for p, g in tree_paths(grads).items() if g is not None}
    assert set(got) == set(jflat) and "lm_head" in got
    assert not np.asarray(jflat["embed"]).any()
    assert torch.equal(got["embed"], torch.zeros_like(params["embed"]))
    for path, g in got.items():
        np.testing.assert_allclose(_np(g), np.asarray(jflat[path]), err_msg=path,
                                   **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_with_embeds_matches_reference(name):
    lm_j, state_np, lm_t = _setup(name)
    batch = _batch(lm_t.arch)
    with lm_j.plan.mesh:
        state_j, mj = jax.jit(jtraining.make_train_step(lm_j, jopt.OptimizerConfig(**OPT)))(
            jax.tree.map(jnp.asarray, state_np), _jax(batch))
    state_t, mt = make_step(lm_t)(state_from_numpy(state_np, "cpu"), batch)
    assert mt["skipped"] == int(mj["skipped"]) == 0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=1e-5, err_msg=k)
    got, want = state_to_numpy(state_t), jax.tree.map(np.asarray, state_j)
    for part in ("m", "v"):
        want_p = tree_paths(want[part])
        for path, a in tree_paths(got[part]).items():
            np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-6,
                                       err_msg=f"{part}/{path}")
    # No lookup: the table's moments stay 0; its step is the weight decay
    # alone, the reference's.
    assert not got["m"]["embed"].any() and not got["v"]["embed"].any()
    np.testing.assert_allclose(got["params"]["embed"], want["params"]["embed"], rtol=0,
                               atol=1e-6)


def make_step(lm_t):
    return training.make_train_step(lm_t, topt.OptimizerConfig(**OPT),
                                    compute_dtype=torch.float32)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_embeds_only_decode_matches_reference(name):
    """A prefill over 20 positions of embeds, then 4 decode steps each fed
    ``{"embeds": (b, 1, d)}`` alone, against the reference's steps."""
    lm_j, state_np, lm_t = _setup(name)
    l, k = 20, 4
    emb = _batch(lm_t.arch, 2, l + k, seed=3)["embeds"]
    params_j = jax.tree.map(jnp.asarray, state_np["params"])
    params_t = state_from_numpy(state_np, "cpu")["params"]
    jprefill = jax.jit(jtraining.make_prefill_step(lm_j))
    jdecode = jax.jit(jtraining.make_decode_step(lm_j))
    prefill = training.make_prefill_step(lm_t, torch.float32)
    decode = training.make_decode_step(lm_t, torch.float32)
    with lm_j.plan.mesh:
        lj, cj = jprefill(params_j, {"embeds": jnp.asarray(emb[:, :l])})
    lt, ct = prefill(params_t, {"embeds": emb[:, :l]})
    cj = tuple({kk: jnp.pad(v, ((0, 0), (0, 0), (0, k), (0, 0), (0, 0)))
                for kk, v in c.items()} for c in cj)
    ct = lm_t.pad_cache(ct, l + k)
    for i in range(k):
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MODEL_TOL,
                                   err_msg=f"position {l + i - 1}")
        e = emb[:, l + i:l + i + 1]
        with lm_j.plan.mesh:
            lj, cj = jdecode(params_j, cj, {"embeds": jnp.asarray(e)}, jnp.int32(l + i))
        lt, ct = decode(params_t, ct, {"embeds": e}, l + i)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **MODEL_TOL)
    # ... and the uncached forward over the same 24 embeds.
    full, _, _ = lm_t.forward(params_t, {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(_np(lt), _np(full[:, -1]), rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", NAMES)
def test_paged_prefill_and_decode_with_embeds_match_reference(name):
    """The engine's pattern over embeds: two prompts right-padded to a
    bucket of 16, then 3 decode steps over three slots (one inactive), each
    fed (3, 1, d) embeds alone; logits and page pools against the
    reference's."""
    lm_j, state_np, lm_t = _setup(name)
    d = lm_t.arch.d_model
    kw = dict(num_blocks=16, block_size=4, max_seqs=3, max_blocks_per_seq=6)
    pool, pool_j = BlockPool(PagedLayout(**kw)), JBlockPool(JPagedLayout(**kw))
    params_j = jax.tree.map(jnp.asarray, state_np["params"])
    params_t = state_from_numpy(state_np, "cpu")["params"]
    with lm_j.plan.mesh:
        cj = lm_j.init_paged_cache(pool_j.layout, dtype=jnp.float32)
        prefill_j = jax.jit(lm_j.prefill_paged)
        decode_j = jax.jit(lm_j.decode_step_paged)
    ct = lm_t.init_paged_cache(pool.layout, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(9)
    for n in (9, 5):
        slot = pool.admit(n)
        assert pool_j.admit(n) == slot
        emb = np.zeros((1, 16, d), np.float32)
        emb[0, :n] = rng.standard_normal((n, d))
        bt = pool.block_table[slot][None]
        with lm_j.plan.mesh:
            lj, cj = prefill_j(params_j, {"embeds": jnp.asarray(emb)}, cj, jnp.asarray(bt),
                               jnp.asarray([n], jnp.int32))
        lt, ct = lm_t.prefill_paged(params_t, {"embeds": torch.from_numpy(emb)}, ct,
                                    torch.from_numpy(bt), torch.tensor([n], dtype=torch.int32))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **MODEL_TOL)
    for step in range(3):
        lens = pool.lengths.copy()
        for slot in (0, 1):
            assert pool.extend(slot, 1) and pool_j.extend(slot, 1)
        bt = pool.block_table.copy()
        emb = rng.standard_normal((3, 1, d)).astype(np.float32)
        with lm_j.plan.mesh:
            lj, cj = decode_j(params_j, cj, jnp.asarray(bt), jnp.asarray(lens),
                              {"embeds": jnp.asarray(emb)})
        lt, ct = lm_t.decode_step_paged(params_t, ct, torch.from_numpy(bt),
                                        torch.from_numpy(lens),
                                        {"embeds": torch.from_numpy(emb)})
        np.testing.assert_allclose(_np(lt)[:2], np.asarray(lj)[:2], **MODEL_TOL,
                                   err_msg=f"step {step}")
    for pj, pt in zip(cj, ct):
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(pt[kv]), np.asarray(pj[kv]), **MODEL_TOL)


@pytest.mark.parametrize("pipeline", [False, True])
def test_shard_batch_splits_embeds_as_tokens(pipeline):
    """Each rank's block of ``embeds`` is the block it takes of ``tokens``
    (and of ``labels``): its rows over data (of each of a pipeline's
    microbatches) and its sequence slice over (ep, tp), the reference's
    ``batch_specs`` layout; host arrays and tensors alike."""
    b, s = 8, 4
    toks = np.arange(b * s).reshape(b, s)
    emb = np.repeat(toks[..., None], 3, axis=-1).astype(np.float32)
    grid = (2, 1, 1, 2) if pipeline else (1, 2, 2, 1)
    for rank in range(4):
        plan = MeshPlan(pp=grid[0], dp=grid[1], ep=grid[2], tp=grid[3], rank=rank,
                        microbatches=2 if pipeline else None)
        for wrap in (np.asarray, torch.from_numpy):
            part = training.shard_batch({"tokens": wrap(toks), "labels": wrap(toks),
                                         "embeds": wrap(emb)}, plan)
            got_t, got_e = np.asarray(part["tokens"]), np.asarray(part["embeds"])
            assert got_e.shape == got_t.shape + (3,)
            np.testing.assert_array_equal(got_e, np.repeat(got_t[..., None], 3, -1))
            np.testing.assert_array_equal(np.asarray(part["labels"]), got_t)
            M, D, n = plan.num_microbatches if pipeline else 1, grid[1], grid[2] * grid[3]
            bl, sl, (d, _, _) = b // (M * D), s // n, plan.coords
            rows = np.concatenate([np.arange(m * b // M + d * bl, m * b // M + (d + 1) * bl)
                                   for m in range(M)])
            j = plan.seq_rank
            np.testing.assert_array_equal(got_t, rows[:, None] * s
                                          + np.arange(j * sl, (j + 1) * sl)[None])
