"""The dense and MoE archs that need no frontend, in the port against the
JAX package, on the CPU: smollm-360m, deepseek-7b, yi-9b, grok-1-314b and
gemma2-9b.

Each config is a copy of the reference's, held field by field with ``==``
at full size and in its ``reduced()`` form, with ``total_params()`` equal
too.  In reduced form (d_model 64, 4 heads over 2 of head_dim 16, vocab
512; grok's 8 experts top-2 at capacity 1.25; gemma2's local layers a
window of 32 and its softcaps) each arch passes the port's twins of the
reference's ``tests/test_archs_smoke.py``, each held against the reference
on weights converted from its ``init_params`` (fp32 compute on both
sides): the forward logits, the loss and every gradient, one AdamW step,
the loss falling over 6 steps (gemma2), and prefill then decode (smollm,
gemma2; here past gemma2's window).  gemma2's ``scale_embeddings`` is held
bitwise at its full d_model 3584 in bf16, where sqrt(3584) = 59.866 rounds
to 59.75 before the multiply, and in fp32.  The serving launcher serves a
dense arch on the CPU and runs its parity probe once, as "dense".  The
forward under a pipeline plan is held in ``test_torch_pipeline.py``, whose
child runs the reference's pipeline on fake host devices.

Tolerances.  Forward logits, loss and gradients: the reference's model
parity 1e-5 (absolute and relative; both sides fp32, summation order
alone).  Prefill and decode against the reference's steps: 1e-5; the port's
prefill plus decode against its own uncached forward: the reference test's
2e-4.  One AdamW step: loss and grad norm 1e-5 relative, first and second
moments within 1e-6 (the first moment is 0.1 of the gradient).  The
embedding scale: bitwise.
"""

import dataclasses
import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.configs import get_arch as jget_arch
from repro.models.model import LanguageModel as JLM
from repro.optim import optimizer as jopt
from repro.sharding import single_device_plan
from repro_torch import training
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.launch import serve as serve_launch
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.optim import optimizer as topt
from repro_torch.training import make_train_step

NAMES = ["smollm-360m", "deepseek-7b", "yi-9b", "grok-1-314b", "gemma2-9b"]
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_ATOL = 2e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# The configs
# ---------------------------------------------------------------------------


def _fields(a):
    """The port's fields of a config, nested configs as dicts of theirs."""
    return {f.name: (_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(a) for v in (getattr(a, f.name),)}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_the_reference(name, reduced):
    """Every field of the reference's equals the port's with ``==``
    (``scale_embeddings`` and ``frontend``, None for these archs, among
    them; the port does not carry ``MoECfg.router_dtype``, which nothing
    reads and which is "float32" there), and so does ``total_params()``."""
    mine, ref = get_arch(name), jget_arch(name)
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    got = _fields(mine)
    want = {k: ({kk: getattr(v, kk) for kk in got[k]} if isinstance(got[k], dict) else v)
            for k in got for v in (getattr(ref, k),)}
    assert got == want
    assert set(_fields(ref)) == set(got)
    assert mine.frontend is None and ref.frontend is None
    if ref.moe is not None:
        assert set(_fields(ref.moe)) - set(got["moe"]) == {"router_dtype"}
        assert ref.moe.router_dtype == "float32"
    assert mine.total_params() == ref.total_params()
    assert mine.active_params() == ref.active_params()
    assert name in ARCHS
    if name == "gemma2-9b":
        assert mine.scale_embeddings and mine.head_dim == (16 if reduced else 256)
        assert mine.sliding_window == (32 if reduced else 4096)


# The reference's test_param_counts_match_published, over the port's registry.
PUBLISHED = {"granite-moe-3b-a800m": 3.3e9, "grok-1-314b": 316e9, "mamba2-370m": 0.37e9,
             "deepseek-7b": 6.9e9, "gemma2-9b": 9.2e9, "yi-9b": 8.8e9,
             "jamba-1.5-large-398b": 398e9}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_param_counts_match_published(name):
    total = get_arch(name).total_params()
    assert total == jget_arch(name).total_params()
    assert abs(total - PUBLISHED[name]) / PUBLISHED[name] < 0.06, (name, total)


# ---------------------------------------------------------------------------
# The reduced archs against the reference (test_archs_smoke.py's checks)
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


def _batch(vocab, b=2, s=32, step=0):
    return tdata.SyntheticTokens(vocab, b, s).batch_at(step)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    """Logits, aux and z losses and expert loads on 2 x 40 tokens (past
    gemma2's reduced window)."""
    lm_j, state_np, lm_t = _setup(name)
    toks = _batch(lm_t.arch.vocab_size, 2, 40)["tokens"]
    with lm_j.plan.mesh:
        want, jaux, jloads = jax.jit(lm_j.forward)(
            jax.tree.map(jnp.asarray, state_np["params"]), {"tokens": jnp.asarray(toks)})
    got, aux, loads = lm_t.forward(state_from_numpy(state_np, "cpu")["params"],
                                   {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, lm_t.arch.padded_vocab())
    assert torch.isfinite(got[..., :lm_t.arch.vocab_size]).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_TOL)
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), err_msg=k, **MODEL_TOL)
    if lm_t.arch.moe is None:
        assert loads is None and jloads is None
    else:
        np.testing.assert_array_equal(loads.numpy(), np.asarray(jloads))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name):
    """The training loss, its parts and every gradient (attention, dense
    FFN or experts and router, norms, the tied or untied head)."""
    lm_j, state_np, lm_t = _setup(name)
    batch = _batch(lm_t.arch.vocab_size)
    with lm_j.plan.mesh:
        (jl, jm), jg = jax.jit(jax.value_and_grad(lm_j.loss, has_aux=True, allow_int=True))(
            jax.tree.map(jnp.asarray, state_np["params"]), jax.tree.map(jnp.asarray, batch))
    params = state_from_numpy(state_np, "cpu")["params"]
    loss, metrics, grads = training.loss_and_grads(lm_t, params, batch, torch.float32)
    np.testing.assert_allclose(_np(loss), _np(jl), **MODEL_TOL)
    for k in ("ce", "moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(metrics[k]), _np(jm[k]), err_msg=k, **MODEL_TOL)
    jflat = {p: g for p, g in tree_paths(jg).items() if g.dtype != jax.dtypes.float0}
    got = {p: g for p, g in tree_paths(grads).items() if g is not None}
    assert set(got) == set(jflat)
    assert ("lm_head" in got) == (not lm_t.arch.tie_embeddings)
    for path, g in got.items():
        np.testing.assert_allclose(_np(g), np.asarray(jflat[path]), err_msg=path,
                                   **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    """One AdamW step: finite loss and grad norm, step 1, nothing skipped,
    and the reference's loss, grad norm and moments."""
    lm_j, state_np, lm_t = _setup(name)
    batch = _batch(lm_t.arch.vocab_size)
    with lm_j.plan.mesh:
        state_j, mj = jax.jit(jtraining.make_train_step(lm_j, jopt.OptimizerConfig(**OPT)))(
            jax.tree.map(jnp.asarray, state_np), jax.tree.map(jnp.asarray, batch))
    state_t, mt = make_train_step(lm_t, topt.OptimizerConfig(**OPT),
                                  compute_dtype=torch.float32)(
        state_from_numpy(state_np, "cpu"), batch)
    assert mt["skipped"] == int(mj["skipped"]) == 0
    assert int(state_t["step"]) == int(state_j["step"]) == 1
    for k in ("loss", "grad_norm"):
        assert np.isfinite(_np(mt[k]))
        np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=1e-5, err_msg=k)
    got, want = state_to_numpy(state_t), jax.tree.map(np.asarray, state_j)
    for part in ("m", "v"):
        want_p = tree_paths(want[part])
        for path, a in tree_paths(got[part]).items():
            np.testing.assert_allclose(a, want_p[path], rtol=0, atol=1e-6,
                                       err_msg=f"{part}/{path}")


def test_loss_decreases():
    """The reference's test_loss_decreases for gemma2: 6 steps at lr 5e-3
    on one batch."""
    _, state_np, lm_t = _setup("gemma2-9b")
    step = make_train_step(lm_t, topt.OptimizerConfig(lr=5e-3), compute_dtype=torch.float32)
    state = state_from_numpy(state_np, "cpu")
    batch = _batch(lm_t.arch.vocab_size)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        assert m["skipped"] == 0
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def _pad_jax(cache, cache_len):
    """The reference test's padding of a prefill's K/V to ``cache_len``."""
    def pad(c):
        n = cache_len - c["k"].shape[2]
        return {k: jnp.pad(v, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))) for k, v in c.items()}

    return tuple(pad(c) for c in cache)


@pytest.mark.parametrize("name", ["smollm-360m", "gemma2-9b"])
def test_prefill_and_decode_match_reference(name):
    """The reference's test_prefill_decode_consistency, twice: a prefill of
    36 tokens then 4 decode steps (gemma2's local layers attend past their
    window of 32), against the reference's steps at 1e-5, and against the
    port's uncached forward over the 40 tokens at the reference test's
    2e-4."""
    lm_j, state_np, lm_t = _setup(name)
    l, k = 36, 4
    toks = np.random.default_rng(7).integers(0, 512, (2, l + k)).astype(np.int32)
    params_j = jax.tree.map(jnp.asarray, state_np["params"])
    params_t = state_from_numpy(state_np, "cpu")["params"]
    jprefill = jax.jit(jtraining.make_prefill_step(lm_j))
    jdecode = jax.jit(jtraining.make_decode_step(lm_j))
    prefill = training.make_prefill_step(lm_t, torch.float32)
    decode = training.make_decode_step(lm_t, torch.float32)
    full, _, _ = lm_t.forward(params_t, {"tokens": torch.from_numpy(toks)})
    with lm_j.plan.mesh:
        lj, cj = jprefill(params_j, {"tokens": jnp.asarray(toks[:, :l])})
    lt, ct = prefill(params_t, {"tokens": toks[:, :l]})
    cj, ct = _pad_jax(cj, l + k), lm_t.pad_cache(ct, l + k)
    for i in range(k):
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=MODEL_TOL["atol"],
                                   err_msg=f"position {l + i - 1}")
        np.testing.assert_allclose(_np(lt), _np(full[:, l + i - 1]), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=f"position {l + i - 1}")
        tok = toks[:, l + i:l + i + 1]
        with lm_j.plan.mesh:
            lj, cj = jdecode(params_j, cj, {"tokens": jnp.asarray(tok)}, jnp.int32(l + i))
        lt, ct = decode(params_t, ct, {"tokens": tok}, l + i)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=MODEL_TOL["atol"])
    np.testing.assert_allclose(_np(lt), _np(full[:, -1]), rtol=0, atol=FORWARD_ATOL)


# ---------------------------------------------------------------------------
# scale_embeddings at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scaled_embedding_bitwise_at_full_width(dtype):
    """gemma2's ``_embed`` at its d_model 3584 (vocab cut to 512), the
    reference's and the port's, bit for bit: in bf16 the scale rounds to
    59.75 first (multiplying by 59.866 in fp32 and rounding once gives
    other values), in fp32 to fp32's sqrt(3584)."""
    arch_j = jget_arch("gemma2-9b").replace(vocab_size=512)
    arch_t = get_arch("gemma2-9b").replace(vocab_size=512)
    rng = np.random.default_rng(11)
    table = (rng.standard_normal((512, 3584)) * 0.02).astype(np.float32)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    lm_j = JLM(arch_j, single_device_plan(arch_j))
    with lm_j.plan.mesh:
        want = np.asarray(jax.jit(lm_j._embed)(
            {"embed": jnp.asarray(table).astype(dtype)}, {"tokens": jnp.asarray(toks)}
        ).astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = LanguageModel(arch_t)._embed({"embed": tt}, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    rows = tt[torch.from_numpy(toks).long()]
    if dtype == "bfloat16":
        assert torch.tensor(math.sqrt(3584), dtype=torch.bfloat16).item() == 59.75
        assert torch.equal(got, (rows.float() * 59.75).to(torch.bfloat16))
        unrounded = (rows.float() * math.sqrt(3584)).to(torch.bfloat16)
        assert not torch.equal(got, unrounded)
    else:
        assert torch.equal(got, rows * torch.tensor(math.sqrt(3584), dtype=torch.float32))
    plain = LanguageModel(get_arch("smollm-360m"))
    assert torch.equal(plain._embed({"embed": tt}, {"tokens": torch.from_numpy(toks)}), rows)


# ---------------------------------------------------------------------------
# The serving launcher on a dense arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["smollm-360m", "gemma2-9b"])
def test_serve_launcher_serves_a_dense_arch(name, capsys):
    """``launch/serve.py --reduced --device cpu --arch <dense>``: every
    request finishes, the ``[serve]`` line says "dense", the summary
    carries no dispatch, and the parity probe runs once, as "dense", within
    ``PARITY_BOUND``."""
    summary = serve_launch.main(["--arch", name, "--reduced", "--device", "cpu", "--dtype",
                                 "float32", "--requests", "4", "--max-new", "4",
                                 "--prompt-max", "40"])
    out = capsys.readouterr().out
    assert summary["finished"] == summary["requests"] == 4
    assert "dispatch" not in summary
    assert f"[serve] {name}-reduced on cpu: dense, float32 weights and cache" in out
    assert [k for k in summary if k.startswith("parity_")] == ["parity_dense"]
    assert summary["parity_dense"] <= serve_launch.PARITY_BOUND
    assert "[parity] dense OK" in out
    assert serve_launch.parity_modes(get_arch(name)) == ["dense"]
    assert serve_launch.parity_modes(get_arch("granite-moe-3b-a800m")) == ["capacity",
                                                                          "ragged"]
