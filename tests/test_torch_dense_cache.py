"""The port's dense attention cache against the JAX package, on the CPU.

``LanguageModel.init_cache(batch, cache_len, ...)``, ``prefill`` (the
prompt's K/V for every attention position beside the SSM caches) and
``decode_step`` (each attention layer writes row ``index`` in place and
reads rows ``[0, index]``), on weights converted from the reference's
``init_params`` (fp32 compute on both sides).  The reference runs with
``impl="xla"``: its ``impl="pallas"`` prefill returns no K/V (ROADMAP
Queue 3).  The port's prefill runs the flash kernel's plain version here.
Configs: the reduced granite (both dispatch modes, capacity factor 8 as
the reference's ``test_prefill_decode_consistency``, so no token is
dropped), the same with a sliding-window layer, and the reduced jamba
(mamba, attention, dense and MoE layers in one stack).

Tolerances are the reference's: 1e-5 against its prefill and decode
(fp32 on both sides, summation order); 2e-4 between a prefill plus decode
and the uncached forward (``tests/test_archs_smoke.py``); 1e-5 between
the dense and the paged steps (``launch/serve.py:PARITY_BOUND``).
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
from repro.models.model import LanguageModel as JLM
from repro.models.model import init_params as jinit_params
from repro.sharding import single_device_plan
from repro_torch import training
from repro_torch.configs import get_arch
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.model import LanguageModel, tree_paths
from repro_torch.serving.kv_cache import PagedLayout

GRANITE, JAMBA = "granite-moe-3b-a800m", "jamba-1.5-large-398b"
ATOL, FORWARD_ATOL = 1e-5, 2e-4
WINDOW = 8


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _with(arch, mode="capacity", window=False):
    """cf 8 (no drop), ``mode`` dispatch; with ``window`` a local-attention
    layer of ``WINDOW`` tokens before each global one."""
    kw = {}
    if arch.moe is not None:
        kw["moe"] = dataclasses.replace(arch.moe, capacity_factor=8.0, dispatch=mode)
    if window:
        kw.update(block_pattern=(("attn_local", "moe"), ("attn", "moe")),
                  sliding_window=WINDOW)
    return arch.replace(**kw)


CASES = {"granite-capacity": (GRANITE, "capacity", False),
         "granite-ragged": (GRANITE, "ragged", False),
         "granite-window": (GRANITE, "ragged", True),
         "jamba": (JAMBA, "ragged", False)}


@lru_cache(maxsize=None)
def setup(case):
    """(JAX plan, JAX lm, its params, port lm, converted params)."""
    name, mode, window = CASES[case]
    arch_j = _with(jget_arch(name).reduced(), mode, window)
    plan = dataclasses.replace(single_device_plan(arch_j), compute_dtype="float32")
    with plan.mesh:
        params_j = jinit_params(arch_j, jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    lm_t = LanguageModel(_with(get_arch(name).reduced(), mode, window))
    return plan, JLM(arch_j, plan, impl="xla"), params_j, lm_t, params_t


@lru_cache(maxsize=None)
def _jax_steps(case):
    _, lm, _, _, _ = setup(case)
    return jax.jit(jtraining.make_prefill_step(lm)), jax.jit(jtraining.make_decode_step(lm))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def _pad_jax(cache, cache_len):
    """The reference test's padding of a prefill's K/V to ``cache_len``."""
    def pad(c):
        if "k" not in c:
            return c
        n = cache_len - c["k"].shape[2]
        return {k: jnp.pad(v, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))) for k, v in c.items()}

    return tuple(pad(c) for c in cache)


def _close_caches(got, want, atol, what):
    want = tree_paths(jax.tree.map(np.asarray, want))
    got = tree_paths(cache_to_numpy(got))
    assert got.keys() == want.keys(), what
    for path, w in want.items():
        assert got[path].shape == w.shape, (what, path)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# init_cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["granite-capacity", "jamba"])
def test_init_cache_matches_reference(case):
    plan, lm_j, _, lm_t, _ = setup(case)
    want = lm_j.init_cache(3, 24, jnp.float32)
    got = lm_t.init_cache(3, 24, torch.float32, "cpu")
    _close_caches(got, want, 0.0, "init_cache")
    assert all(t.is_contiguous() for c in got for t in c.values())
    kinds = [sorted(c) for c in got]
    assert ["k", "v"] in kinds
    if case == "jamba":
        assert ["conv_B", "conv_C", "conv_x", "ssm"] in kinds


# ---------------------------------------------------------------------------
# prefill then decode, against the reference's steps
# ---------------------------------------------------------------------------

STEPS_CASES = {"granite-capacity": (20, 4), "granite-ragged": (20, 4),
               "granite-window": (20, 4), "jamba": (32, 3)}


@pytest.mark.parametrize("case", list(STEPS_CASES))
def test_prefill_and_decode_match_reference(case):
    """make_prefill_step over l tokens, the K/V padded to l + k rows, then k
    decode steps: logits and every cache leaf at every step."""
    plan, _, params_j, lm_t, params_t = setup(case)
    l, k = STEPS_CASES[case]
    toks = _tokens(2, l + k, seed=l + k)
    jprefill, jdecode = _jax_steps(case)
    prefill = training.make_prefill_step(lm_t, torch.float32)
    decode = training.make_decode_step(lm_t, torch.float32)
    with plan.mesh:
        lj, cj = jprefill(params_j, {"tokens": jnp.asarray(toks[:, :l])})
    lt, ct = prefill(params_t, {"tokens": toks[:, :l]})
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=ATOL)
    _close_caches(ct, cj, ATOL, "prefill")
    cj, ct = _pad_jax(cj, l + k), lm_t.pad_cache(ct, l + k)
    for i in range(k):
        tok = toks[:, l + i:l + i + 1]
        with plan.mesh:
            lj, cj = jdecode(params_j, cj, {"tokens": jnp.asarray(tok)}, jnp.int32(l + i))
        lt, ct2 = decode(params_t, ct, {"tokens": tok}, l + i)
        assert ct2 is ct  # updated in place
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=ATOL,
                                   err_msg=f"decode step {i}")
        _close_caches(ct, cj, ATOL, f"decode step {i}")


@pytest.mark.parametrize("case", list(STEPS_CASES))
def test_prefill_then_decode_matches_uncached_forward(case):
    """The reference's test_prefill_decode_consistency, held at its 2e-4 on
    the port alone: a prefill of s - k tokens, then k decode steps, give the
    logits of the uncached forward over the s tokens, position by position
    (with a window of 8 and k = 12 the last steps attend past it)."""
    _, _, _, lm_t, params_t = setup(case)
    s = 32
    k = 12 if case == "granite-window" else 1
    toks = torch.from_numpy(_tokens(2, s, seed=7))
    full, _, _ = lm_t.forward(params_t, {"tokens": toks})
    logits, cache = training.make_prefill_step(lm_t, torch.float32)(
        params_t, {"tokens": toks[:, :s - k]})
    cache = lm_t.pad_cache(cache, s)
    decode = training.make_decode_step(lm_t, torch.float32)
    for i in range(s - k, s):
        np.testing.assert_allclose(_np(logits), _np(full[:, i - 1]), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=f"position {i - 1}")
        logits, cache = decode(params_t, cache, {"tokens": toks[:, i:i + 1]}, i)
    np.testing.assert_allclose(_np(logits), _np(full[:, s - 1]), rtol=0, atol=FORWARD_ATOL)


@pytest.mark.parametrize("case", ["granite-ragged", "granite-window"])
def test_dense_steps_match_paged_steps(case):
    """The dense steps against the port's paged ones on the same prompts
    (one length, so the paged prefill's bucket holds no pad), over 6 decode
    steps, at the paged path's parity bound."""
    _, _, _, lm_t, params_t = setup(case)
    l, k, b = 16, 6, 2
    toks = _tokens(b, l + k, seed=11)
    logits, cache = lm_t.prefill(params_t, {"tokens": torch.from_numpy(toks[:, :l])})
    cache = lm_t.pad_cache(cache, l + k)
    layout = PagedLayout(num_blocks=16, block_size=4, max_seqs=b, max_blocks_per_seq=8)
    pages = lm_t.init_paged_cache(layout, torch.float32, "cpu")
    table = torch.arange(b * 8, dtype=torch.int32).reshape(b, 8)
    lens = torch.full((b,), l, dtype=torch.int32)
    plog, pages = lm_t.prefill_paged(params_t, {"tokens": torch.from_numpy(toks[:, :l])},
                                     pages, table, lens)
    np.testing.assert_allclose(_np(logits), _np(plog), rtol=0, atol=ATOL)
    for i in range(k):
        tok = torch.from_numpy(toks[:, l + i:l + i + 1])
        logits, cache = lm_t.decode_step(params_t, cache, {"tokens": tok}, l + i)
        plog, pages = lm_t.decode_step_paged(params_t, pages, table, lens + i,
                                             {"tokens": tok})
        np.testing.assert_allclose(_np(logits), _np(plog), rtol=0, atol=ATOL,
                                   err_msg=f"decode step {i}")


def test_prefill_runs_the_flash_kernel_and_decode_does_not(monkeypatch):
    """The dense prefill's attention goes through the flash kernel's
    wrapper (the kernel on the card), once an attention layer; a decode
    step attends eagerly, as the reference's decode does."""
    _, _, _, lm_t, params_t = setup("jamba")
    calls = []
    real = fa_ops.flash_attention
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    toks = torch.from_numpy(_tokens(2, 32, seed=3))
    _, cache = lm_t.prefill(params_t, {"tokens": toks})
    n_attn = sum(1 for m, _ in lm_t.arch.layers if m.startswith("attn"))
    assert len(calls) == n_attn == 2
    cache = lm_t.pad_cache(cache, 33)
    lm_t.decode_step(params_t, cache, {"tokens": toks[:, :1]}, 32)
    assert len(calls) == n_attn


# ---------------------------------------------------------------------------
# Guards, the host index, conversion
# ---------------------------------------------------------------------------


def test_index_past_the_end_raises_before_any_layer_runs():
    """The reference clamps an index past the cache and overwrites its last
    row; the port raises, and leaves the cache (SSM leaves too) as it was."""
    _, _, _, lm_t, params_t = setup("jamba")
    toks = torch.from_numpy(_tokens(1, 32, seed=4))
    _, cache = lm_t.prefill(params_t, {"tokens": toks})
    cache = lm_t.pad_cache(cache, 33)
    before = {k: v.clone() for k, v in tree_paths(cache).items()}
    for index in (33, 40, -1):
        with pytest.raises(ValueError, match="past the cache"):
            lm_t.decode_step(params_t, cache, {"tokens": toks[:, :1]}, index)
    assert all(torch.equal(before[k], v) for k, v in tree_paths(cache).items())
    with pytest.raises(ValueError, match="does not fit"):
        lm_t.pad_cache(cache, 16)
    with pytest.raises(TypeError):  # a host int: no device sync, no float
        lm_t.decode_step(params_t, cache, {"tokens": toks[:, :1]}, 32.0)
    logits, _ = lm_t.decode_step(params_t, cache, {"tokens": toks[:, :1]}, np.int64(32))
    assert torch.isfinite(logits[:, :lm_t.arch.vocab_size]).all()


def test_attention_proj_guards_a_direct_call():
    from repro_torch.models import layers

    _, _, _, lm_t, params_t = setup("granite-capacity")
    a = lm_t.arch
    p = {k: v[0] for k, v in params_t["blocks"][0]["mixer"].items()}
    x = torch.randn((1, 2, a.d_model), generator=torch.Generator().manual_seed(0))
    cache = {"k": torch.zeros((1, 4, a.num_kv_heads, a.head_dim)),
             "v": torch.zeros((1, 4, a.num_kv_heads, a.head_dim))}
    pos = torch.tensor([[3, 4]])
    with pytest.raises(ValueError, match="past the cache"):
        layers.attention_proj(p, x, a, pos, cache=cache, cache_index=3)
    out, nc = layers.attention_proj(p, x, a, pos - 1, cache=cache, cache_index=2)
    assert nc is cache and out.shape == (1, 2, a.d_model)
    assert (cache["k"][:, 2:] != 0).any() and (cache["k"][:, :2] == 0).all()


def test_cache_conversion_roundtrip_with_kv():
    """A jamba cache (K/V and SSM leaves) through numpy and back; a
    reference prefill cache handed to the port decodes as the reference
    does."""
    plan, _, params_j, lm_t, params_t = setup("jamba")
    toks = _tokens(2, 33, seed=5)
    _, cache = lm_t.prefill(params_t, {"tokens": torch.from_numpy(toks[:, :32])})
    again = cache_from_numpy(cache_to_numpy(cache), "cpu")
    assert tree_paths(again).keys() == tree_paths(cache).keys()
    assert all(torch.equal(again_t, tree_paths(cache)[k])
               for k, again_t in tree_paths(again).items())
    jprefill, jdecode = _jax_steps("jamba")
    with plan.mesh:
        _, cj = jprefill(params_j, {"tokens": jnp.asarray(toks[:, :32])})
        cj = _pad_jax(cj, 33)
        lj, cj2 = jdecode(params_j, cj, {"tokens": jnp.asarray(toks[:, 32:])}, jnp.int32(32))
    ct = cache_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    lt, ct = training.make_decode_step(lm_t, torch.float32)(params_t, ct,
                                                            {"tokens": toks[:, 32:]}, 32)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=ATOL)
    _close_caches(ct, cj2, ATOL, "decode")


def test_paged_serving_still_refuses_mamba():
    """Hybrids serve through the dense steps; no paged SSM cache exists, as
    in the reference's init_paged_cache."""
    _, _, _, lm_t, _ = setup("jamba")
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        lm_t.init_paged_cache(PagedLayout(num_blocks=4, block_size=8, max_seqs=1,
                                          max_blocks_per_seq=4), device="cpu")
