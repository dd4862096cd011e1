"""The port's Mamba2 (SSD) path against the JAX package, on the CPU.

The ``ssd_intra_chunk`` wrapper takes its plain version here (the tensors
lie on the CPU); the JAX side runs the Pallas kernel in interpret mode.
The port passes B and C as head-broadcast views (stride 0 on the head
axis), as its model does; the JAX side gets them materialized.  The model
tests run ``mamba2-370m.reduced()`` (2 layers, d_model 64, 8 heads x 16,
state 16, chunk 32, vocab 512) on weights converted from the JAX
``init_params``, with the JAX plan's compute dtype set to fp32.

Tolerances are the reference's: the kernel at atol 3e-5
(``tests/test_kernels.py``), ``ssd_chunked`` at 2e-4 (``tests/test_ssm.py``,
chunked against recurrent), the mixer and the model at 1e-5 (fp32 on both
sides, differing only in summation order).
"""

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.configs import get_arch as jget_arch
from repro.kernels.ssd import ops as jssd_ops
from repro.models import ssm as jssm
from repro.models.model import LanguageModel as JLM
from repro.models.model import init_params as jinit_params
from repro.sharding import single_device_plan
from repro_torch import training
from repro_torch.configs import get_arch
from repro_torch.convert import (
    cache_from_numpy, cache_to_numpy, params_from_numpy, params_to_numpy,
)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import ssm
from repro_torch.models.model import LanguageModel, init_params, tree_paths
from repro_torch.serving.kv_cache import PagedLayout

NAME = "mamba2-370m"
ATOL = 1e-5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@lru_cache(maxsize=None)
def setup():
    arch_j = jget_arch(NAME).reduced()
    plan = dataclasses.replace(single_device_plan(arch_j), compute_dtype="float32")
    with plan.mesh:
        params_j = jinit_params(arch_j, jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return plan, arch_j, params_j, get_arch(NAME).reduced(), params_t


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(np.int32)


def _close_trees(got, want, atol, what):
    want = tree_paths(jax.tree.map(np.asarray, want))
    got = tree_paths(cache_to_numpy(got))
    assert got.keys() == want.keys(), what
    for path, w in want.items():
        assert got[path].shape == w.shape, (what, path)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# The kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

SSD_CASES = {
    # the two shapes of tests/test_kernels.py, with its inputs' law
    "ref-small": ((1, 2, 32, 4, 16, 8), "decay"),
    "ref-large": ((2, 2, 64, 8, 32, 16), "decay"),
    "cl=1": ((2, 3, 1, 4, 16, 8), "decay"),
    "cl=100": ((1, 2, 100, 4, 16, 16), "decay"),  # a ragged 64-row tile
    "strong-decay": ((1, 2, 64, 4, 16, 8), "strong"),  # dA ~ -50
    "dA=0": ((1, 2, 64, 4, 16, 8), "zero"),
}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_intra_chunk_matches_pallas(case):
    (b, nc, cl, h, p, n), law = SSD_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, nc, cl, h, p)).astype(np.float32)
    dA = {"decay": -np.abs(rng.standard_normal((b, nc, cl, h))) * 0.1,
          "strong": -50.0 + rng.standard_normal((b, nc, cl, h)),
          "zero": np.zeros((b, nc, cl, h))}[law].astype(np.float32)
    B1 = rng.standard_normal((b, nc, cl, 1, n)).astype(np.float32)
    C1 = rng.standard_normal((b, nc, cl, 1, n)).astype(np.float32)
    Bh, Ch = (np.broadcast_to(t, (b, nc, cl, h, n)) for t in (B1, C1))
    want = jssd_ops.ssd_intra_chunk(jnp.asarray(x), jnp.asarray(dA), jnp.asarray(Bh),
                                    jnp.asarray(Ch), interpret=True)
    Bt, Ct = (_t(t).expand(b, nc, cl, h, n) for t in (B1, C1))
    assert Bt.stride(3) == 0
    got = ssd_ops.ssd_intra_chunk(_t(x), _t(dA), Bt, Ct)
    assert got.shape == (b, nc, cl, h, p) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=3e-5)


def test_ssd_intra_chunk_bf16_rounds_da_and_the_output_once():
    """In bf16 the wrapper rounds dA to x's dtype first (the Pallas path's
    cast) and computes in fp32 from the bf16 values, rounding once."""
    rng = np.random.default_rng(3)
    g, cl, h, p, n = 2, 48, 4, 16, 8
    x, B, C = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((1, g, cl, h, p), (1, g, cl, h, n), (1, g, cl, h, n)))
    dA = torch.from_numpy(-np.abs(rng.standard_normal((1, g, cl, h))).astype(np.float32))
    got = ssd_ops.ssd_intra_chunk(x, dA, B, C)
    assert got.dtype == torch.bfloat16
    want = ssd_ref.ssd_intra_chunk(*(t[0].float() for t in (x, dA.to(torch.bfloat16), B, C)))
    assert torch.equal(got[0], want.to(torch.bfloat16))


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((3, 10)).astype(np.float32)
    got, want = _np(ssd_ref.segsum(_t(x))), np.asarray(jssm.segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_ssd_wrapper_refuses_what_it_cannot_compute():
    x = torch.zeros((1, 1, 8, 2, 16), requires_grad=True)
    dA, B = torch.zeros((1, 1, 8, 2)), torch.zeros((1, 1, 8, 2, 8))
    with pytest.raises(ValueError, match="no backward"):
        ssd_ops.ssd_intra_chunk(x, dA, B, B)
    with pytest.raises(ValueError):
        ssd_ops.ssd_intra_chunk(x.detach(), dA[..., :1], B, B)


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, l, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))  # softplus
    a = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, l, g, n)) * 0.5
    C = rng.standard_normal((b, l, g, n)) * 0.5
    return [np.asarray(t, np.float32) for t in (x, dt, a, B, C)]


SSD_CHUNKED_CASES = {
    "chunk4": dict(shape=(2, 32, 4, 8, 1, 8), chunk=4),
    "chunk8": dict(shape=(2, 32, 4, 8, 1, 8), chunk=8),
    "chunk16": dict(shape=(2, 32, 4, 8, 1, 8), chunk=16),
    "initial-state": dict(shape=(2, 32, 4, 8, 1, 8), chunk=8, init=True),
    "groups2": dict(shape=(1, 16, 4, 8, 2, 8), chunk=8),  # B/C groups > 1
    "head-groups": dict(shape=(2, 32, 8, 8, 1, 8), chunk=8, head_group=2),
}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(SSD_CHUNKED_CASES))
def test_ssd_chunked_matches_reference(case, use_pallas):
    c = SSD_CHUNKED_CASES[case]
    b, l, h, p, g, n = c["shape"]
    x, dt, a, B, C = _ssd_inputs(0, b, l, h, p, g, n)
    init = (np.random.default_rng(9).standard_normal((b, h, p, n)).astype(np.float32)
            if c.get("init") else None)
    hg = dict(head_group=c["head_group"]) if "head_group" in c else {}
    ref = jax.jit(partial(jssm.ssd_chunked, chunk=c["chunk"], use_pallas=use_pallas, **hg))
    yj, fj = ref(*map(jnp.asarray, (x, dt, a, B, C)),
                 initial_state=None if init is None else jnp.asarray(init))
    yt, ft = ssm.ssd_chunked(*map(_t, (x, dt, a, B, C)), c["chunk"],
                             initial_state=None if init is None else _t(init), **hg)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), rtol=0, atol=2e-4)


def test_ssd_chunked_rejects_a_ragged_length():
    x, dt, a, B, C = map(_t, _ssd_inputs(0, 1, 12, 2, 4, 1, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(x, dt, a, B, C, 8)


# ---------------------------------------------------------------------------
# The mixer: prefill with its cache, then one cached step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", [64, 20, 2])
def test_mamba_block_matches_reference(l):
    plan, arch_j, params_j, arch_t, params_t = setup()
    pj = jax.tree.map(lambda t: t[0], params_j["blocks"][0]["mixer"])
    pt = {k: v[0] for k, v in params_t["blocks"][0]["mixer"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, l + 1, arch_j.d_model)).astype(np.float32)
    with plan.mesh:
        yj, cj = jax.jit(partial(jssm.mamba_block, arch=arch_j, return_cache=True,
                                 impl="pallas"))(pj, jnp.asarray(x[:, :l]))
    yt, ct = ssm.mamba_block(pt, _t(x[:, :l]), arch_t, return_cache=True)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=ATOL)
    _close_trees(ct, cj, ATOL, "prefill cache")
    with plan.mesh:
        yj, cj = jax.jit(partial(jssm.mamba_block, arch=arch_j))(pj, jnp.asarray(x[:, l:]),
                                                                 cache=cj)
    yt, ct2 = ssm.mamba_block(pt, _t(x[:, l:]), arch_t, cache=ct)
    assert ct2 is ct  # updated in place
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=ATOL)
    _close_trees(ct, cj, ATOL, "decode cache")


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_reference(impl):
    plan, arch_j, params_j, arch_t, params_t = setup()
    toks = _tokens(2, 64)
    with plan.mesh:
        want, _, _ = JLM(arch_j, plan, impl=impl).forward(params_j, {"tokens": jnp.asarray(toks)})
    got, aux, loads = LanguageModel(arch_t).forward(params_t,
                                                    {"tokens": torch.from_numpy(toks)})
    assert loads is None and float(aux["moe_aux_loss"]) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@lru_cache(maxsize=None)
def _jax_steps():
    plan, arch_j, _, _, _ = setup()
    lm = JLM(arch_j, plan, impl="pallas")
    return jax.jit(jtraining.make_prefill_step(lm)), jax.jit(jtraining.make_decode_step(lm))


@pytest.mark.parametrize("l", [64, 20])
def test_prefill_and_decode_match_reference(l):
    """make_prefill_step over l tokens (64: two chunks of 32; 20: one
    chunk shorter than the conv window's multiple), then 4 decode steps:
    logits and every cache leaf at every step."""
    plan, arch_j, params_j, arch_t, params_t = setup()
    toks = _tokens(2, l + 4, seed=l)
    jprefill, jdecode = _jax_steps()
    lm = LanguageModel(arch_t)
    prefill, decode = training.make_prefill_step(lm, torch.float32), \
        training.make_decode_step(lm, torch.float32)
    with plan.mesh:
        lj, cj = jprefill(params_j, {"tokens": jnp.asarray(toks[:, :l])})
    lt, ct = prefill(params_t, {"tokens": toks[:, :l]})
    assert lt.shape == (2, arch_t.padded_vocab())
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=ATOL)
    _close_trees(ct, cj, ATOL, "prefill")
    for i in range(4):
        tok = toks[:, l + i:l + i + 1]
        with plan.mesh:
            lj, cj = jdecode(params_j, cj, {"tokens": jnp.asarray(tok)}, jnp.int32(l + i))
        lt, ct = decode(params_t, ct, {"tokens": tok}, l + i)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=ATOL,
                                   err_msg=f"decode step {i}")
        _close_trees(ct, cj, ATOL, f"decode step {i}")


def test_decode_continues_a_reference_cache():
    """A JAX prefill cache handed to the port (``cache_from_numpy``)
    decodes as the JAX decode does."""
    plan, arch_j, params_j, arch_t, params_t = setup()
    toks = _tokens(2, 33, seed=5)
    jprefill, jdecode = _jax_steps()
    with plan.mesh:
        _, cj = jprefill(params_j, {"tokens": jnp.asarray(toks[:, :32])})
        lj, cj2 = jdecode(params_j, cj, {"tokens": jnp.asarray(toks[:, 32:])}, jnp.int32(32))
    ct = cache_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    lt, ct = training.make_decode_step(LanguageModel(arch_t), torch.float32)(
        params_t, ct, {"tokens": toks[:, 32:]}, 32)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=ATOL)
    _close_trees(ct, cj2, ATOL, "decode")


@pytest.mark.parametrize("l,k", [(64, 32), (24, 8)])
def test_prefill_then_decode_matches_uncached_forward(l, k):
    """Prefill of l - k tokens then k decode steps gives the logits of the
    uncached forward over the l tokens, position by position."""
    _, _, _, arch_t, params_t = setup()
    toks = torch.from_numpy(_tokens(2, l, seed=7))
    lm = LanguageModel(arch_t)
    full, _, _ = lm.forward(params_t, {"tokens": toks})
    logits, cache = training.make_prefill_step(lm, torch.float32)(
        params_t, {"tokens": toks[:, :l - k]})
    decode = training.make_decode_step(lm, torch.float32)
    for i in range(l - k, l):
        np.testing.assert_allclose(_np(logits), _np(full[:, i - 1]), rtol=0, atol=ATOL,
                                   err_msg=f"position {i - 1}")
        logits, cache = decode(params_t, cache, {"tokens": toks[:, i:i + 1]}, i)
    np.testing.assert_allclose(_np(logits), _np(full[:, l - 1]), rtol=0, atol=ATOL)


def test_init_cache_matches_reference():
    plan, arch_j, _, arch_t, _ = setup()
    want = JLM(arch_j, plan).init_cache(3, 16, jnp.float32)
    got = LanguageModel(arch_t).init_cache(3, 16, torch.float32, "cpu")
    _close_trees(got, want, 0.0, "init_cache")
    assert all(t.is_contiguous() for c in got for t in c.values())


# ---------------------------------------------------------------------------
# Init, conversion and guards
# ---------------------------------------------------------------------------


def test_init_params_mamba_rules():
    arch = get_arch(NAME).reduced()
    p = init_params(arch, torch.Generator().manual_seed(0), "cpu")["blocks"][0]["mixer"]
    a_log, dt_bias = p["A_log"], p["dt_bias"]
    assert (a_log >= 0).all() and (a_log <= np.log(16.0) + 1e-6).all()
    dt = torch.nn.functional.softplus(dt_bias)  # the inverse softplus round-trips
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt <= 0.1 * (1 + 1e-5)).all()
    assert (p["D"] == 1).all() and (p["norm_scale"] == 0).all()
    assert (p["conv_x_b"] == 0).all()
    assert abs(p["w_x"].std().item() * arch.d_model ** 0.5 - 1.0) < 0.1


def test_convert_roundtrip_mamba():
    _, _, params_j, _, params_t = setup()
    back = tree_paths(params_to_numpy(params_t))
    for path, a in tree_paths(jax.tree.map(np.asarray, params_j)).items():
        assert back[path].dtype == a.dtype and np.array_equal(back[path], a), path
    cache = LanguageModel(get_arch(NAME).reduced()).init_cache(2, 16, torch.float32, "cpu")
    cache[0]["ssm"].normal_()
    again = cache_from_numpy(cache_to_numpy(cache), "cpu")
    assert torch.equal(again[0]["ssm"], cache[0]["ssm"])


def test_guards():
    """What the port still refuses: a paged cache for mamba mixers (as the
    reference), a prompt that is no multiple of the chunk past one chunk,
    grad inputs to the SSD kernel's wrapper (no backward, as the
    reference's); and an attention cache index past its end (the
    reference clamps it)."""
    _, _, _, arch_t, params_t = setup()
    lm = LanguageModel(arch_t)
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        lm.init_paged_cache(PagedLayout(num_blocks=4, block_size=8, max_seqs=1,
                                        max_blocks_per_seq=4), device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        lm.prefill(params_t, {"tokens": torch.from_numpy(_tokens(1, 40))})
    x = torch.zeros((1, 1, 8, 2, 16), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ssd_ops.ssd_intra_chunk(x, torch.zeros((1, 1, 8, 2)), torch.zeros((1, 1, 8, 2, 8)),
                                torch.zeros((1, 1, 8, 2, 8)))
    granite = LanguageModel(get_arch("granite-moe-3b-a800m").reduced())
    cache = granite.init_cache(1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="past the cache"):
        granite.decode_step(None, cache, {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 4)
