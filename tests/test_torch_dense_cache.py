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
the dense and the paged steps (``launch/serve.py:PARITY_BOUND``).  An SSM
state leaf is held at 1e-5 x max(1, its largest magnitude), the rule
jamba's logits already follow: a decode step's ``dt * x * B`` can lift a
state element from ~0 to ~3 at once, and each package's fp32 rounding of
that product lies a few ppm from float64 on its own side
(``test_ssm_states_lie_no_further_from_float64_than_the_reference``).
"""

import contextlib
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
from repro_torch.models.model import LanguageModel, map_tree, tree_paths
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
    """Every leaf within ``atol``; an SSM state within ``atol`` x max(1, its
    largest magnitude) (module docstring)."""
    want = tree_paths(jax.tree.map(np.asarray, want))
    got = tree_paths(cache_to_numpy(got))
    assert got.keys() == want.keys(), what
    for path, w in want.items():
        assert got[path].shape == w.shape, (what, path)
        tol = atol * max(1.0, float(np.abs(w).max())) if path.endswith("/ssm") else atol
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol, err_msg=f"{what} {path}")


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


@contextlib.contextmanager
def _float_is_double():
    """Every ``Tensor.float()`` of the port's model returns float64 inside
    the block (``scripts/port_parity_witness.py``'s widening)."""
    old = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = old


@contextlib.contextmanager
def _jax_float_is_double():
    """The reference's model in float64 inside the block: 64-bit types on,
    every ``jnp.float32`` it names read as ``jnp.float64``, and a
    "float64" compute dtype."""
    old = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        jtraining.DTYPES["float64"] = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = old
            del jtraining.DTYPES["float64"]


def _ssm_leaves(cache):
    return {p: np.asarray(v, np.float64) for p, v in cache.items() if p.endswith("/ssm")}


def _reference_in_float64(case, toks, l, k):
    """The reference's SSM states after its prefill and each decode step,
    evaluated in float64 (:func:`_jax_float_is_double`)."""
    plan, lm_j, params_j, _, _ = setup(case)
    out = []
    with _jax_float_is_double():
        plan64 = dataclasses.replace(plan, compute_dtype="float64")
        lm64 = JLM(lm_j.arch, plan64, impl="xla")
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64))
                           if a.dtype == np.float32 else a, params_j)
        prefill = jax.jit(jtraining.make_prefill_step(lm64))
        decode = jax.jit(jtraining.make_decode_step(lm64))
        with plan64.mesh:
            _, c = prefill(p64, {"tokens": jnp.asarray(toks[:, :l])})
            out.append(_ssm_leaves(tree_paths(jax.tree.map(np.asarray, c))))
            c = _pad_jax(c, l + k)
            for i in range(k):
                _, c = decode(p64, c, {"tokens": jnp.asarray(toks[:, l + i:l + i + 1])},
                              jnp.int32(l + i))
                out.append(_ssm_leaves(tree_paths(jax.tree.map(np.asarray, c))))
    return out


def ssm_state_errors(case="jamba"):
    """[(step, {SSM path: (max |port - f64|, max |reference - f64|, max
    |port - f64'|, max |reference - f64'|, max |f64|, max |f64 - f64'|)})] over
    ``test_prefill_and_decode_match_reference``'s prefill and decode
    steps: f64 is the port's model with every weight, cache and upcast
    widened, f64' the reference's (:func:`_reference_in_float64`)."""
    plan, _, params_j, lm_t, params_t = setup(case)
    l, k = STEPS_CASES[case]
    toks = _tokens(2, l + k, seed=l + k)
    jprefill, jdecode = _jax_steps(case)
    params_d = map_tree(lambda t: t.double() if t.is_floating_point() else t, params_t)
    exact_ref = iter(_reference_in_float64(case, toks, l, k))
    out = []

    def record(step, ct, cj, cd):
        want = _ssm_leaves(tree_paths(jax.tree.map(np.asarray, cj)))
        got = _ssm_leaves(tree_paths(cache_to_numpy(ct)))
        exact = _ssm_leaves({p: v.numpy() for p, v in tree_paths(cd).items()})
        other = next(exact_ref)

        def gap(x, y):
            return float(np.abs(x - y).max())

        out.append((step, {p: (gap(got[p], exact[p]), gap(want[p], exact[p]),
                               gap(got[p], other[p]), gap(want[p], other[p]),
                               float(np.abs(exact[p]).max()), gap(exact[p], other[p]))
                           for p in want}))

    with plan.mesh:
        _, cj = jprefill(params_j, {"tokens": jnp.asarray(toks[:, :l])})
    _, ct = training.make_prefill_step(lm_t, torch.float32)(params_t, {"tokens": toks[:, :l]})
    with _float_is_double():
        _, cd = training.make_prefill_step(lm_t, torch.float64)(params_d,
                                                                {"tokens": toks[:, :l]})
        cd = lm_t.pad_cache(cd, l + k)
    record("prefill", ct, cj, cd)
    cj, ct = _pad_jax(cj, l + k), lm_t.pad_cache(ct, l + k)
    for i in range(k):
        tok = toks[:, l + i:l + i + 1]
        with plan.mesh:
            _, cj = jdecode(params_j, cj, {"tokens": jnp.asarray(tok)}, jnp.int32(l + i))
        training.make_decode_step(lm_t, torch.float32)(params_t, ct, {"tokens": tok}, l + i)
        with _float_is_double():
            training.make_decode_step(lm_t, torch.float64)(params_d, cd, {"tokens": tok},
                                                           l + i)
        record(f"decode {i}", ct, cj, cd)
    return out


def test_ssm_states_lie_no_further_from_float64_than_the_reference():
    """The witness of the SSM rule: over jamba's prefill and decode steps,
    the port's largest state error is no larger than the reference's,
    measured from the port's model in float64 and from the reference's in
    float64 alike, and within the rule's bound."""
    errs = [e for _, leaves in ssm_state_errors() for e in leaves.values()]
    for port, ref in ((0, 1), (2, 3)):
        assert max(e[port] for e in errs) <= max(e[ref] for e in errs), (port, ref)
    for e in errs:
        assert max(e[0], e[2]) <= ATOL * max(1.0, e[4]), e


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


if __name__ == "__main__":
    print("f64: the port's model in float64; f64': the reference's")
    for step, leaves in ssm_state_errors():
        for path, (p, r, p2, r2, mag, both) in leaves.items():
            print(f"{step:9s} {path:6s} |port - f64| {p:.3e}  |reference - f64| {r:.3e}  "
                  f"|port - f64'| {p2:.3e}  |reference - f64'| {r2:.3e}  max |f64| {mag:.3f}  "
                  f"|f64 - f64'| {both:.3e}")
