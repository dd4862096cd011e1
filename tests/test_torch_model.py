"""The port's model against the JAX package on the same weights.

``granite-moe-3b-a800m.reduced()`` (2 layers, d_model 64, 8 experts top-2,
vocab 512): the JAX ``init_params`` weights are handed to the port through
``repro_torch.convert.params_from_numpy``, inputs are made with numpy, and
the port runs on the CPU, where its kernel wrappers take their plain
versions.  The JAX side is ``impl="xla"`` (its ``impl="pallas"`` paged
prefill does not return K/V; the Pallas kernels themselves are held
against the port in test_torch_kernels.py).

Tolerance 1e-5 on logits, as the reference's own model and paged-decode
parity tests use: both sides compute in fp32 and differ only in summation
order.  Expert loads are counts and must be equal.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models.model import LanguageModel as JLM
from repro.models.model import abstract_params as jabstract_params
from repro.models.model import init_params as jinit_params
from repro.serving import kv_cache as jkv
from repro.sharding import single_device_plan
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe
from repro_torch.models.model import LanguageModel, init_params, param_tree, tree_paths
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.kv_cache import BlockPool, PagedLayout

ATOL = 1e-5
NAME = "granite-moe-3b-a800m"


def _moe(arch, dispatch, cf):
    E, k = arch.moe.num_experts, arch.moe.top_k
    cf = float(E) / k + 1.0 if cf is None else cf  # None: provably no drops
    return arch.replace(moe=dataclasses.replace(arch.moe, dispatch=dispatch,
                                                capacity_factor=cf))


@lru_cache(maxsize=None)
def setup(dispatch: str, cf=None):
    arch_j = _moe(jget_arch(NAME).reduced(), dispatch, cf)
    plan = single_device_plan(arch_j)
    with plan.mesh:
        params_j = jinit_params(arch_j, jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    arch_t = _moe(get_arch(NAME).reduced(), dispatch, cf)
    return plan, JLM(arch_j, plan), params_j, LanguageModel(arch_t), params_t


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ---------------------------------------------------------------------------
# Parameter tree, init, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,reduced,vocab", [
    pytest.param(NAME, True, 512, id="True"),
    pytest.param(NAME, False, 49408, id="False"),
    pytest.param("mamba2-370m", True, 512, id="mamba2-370m-True"),
    pytest.param("mamba2-370m", False, 50432, id="mamba2-370m-False"),
])
def test_param_tree_matches_reference(name, reduced, vocab):
    """Same paths, shapes and integer/float kinds as the JAX tree, at the
    reduced size and at full width (shapes only, nothing materialized)."""
    arch_j, arch_t = jget_arch(name), get_arch(name)
    if reduced:
        arch_j, arch_t = arch_j.reduced(), arch_t.reduced()
    want = {p: (tuple(s.shape), jnp.issubdtype(s.dtype, jnp.integer))
            for p, s in tree_paths(jabstract_params(arch_j)).items()}
    got = {p: (m.shape, m.init == "arange") for p, m in tree_paths(param_tree(arch_t)).items()}
    assert got == want
    assert arch_t.total_params() == arch_j.total_params()
    assert arch_t.padded_vocab() == arch_j.padded_vocab() == vocab


def test_init_params_rules():
    arch = get_arch(NAME).reduced()
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    p32 = init_params(arch, gen(), "cpu", torch.float32)
    p16 = init_params(arch, gen(), "cpu", torch.bfloat16)
    flat32, flat16 = tree_paths(p32), tree_paths(p16)
    assert flat32.keys() == tree_paths(param_tree(arch)).keys()
    for path, t in flat32.items():
        if path.endswith("assignment"):
            assert t.dtype == torch.int32
            assert (t == torch.arange(arch.moe.num_experts, dtype=torch.int32)).all()
            assert torch.equal(flat16[path], t)
        else:
            assert torch.equal(flat16[path], t.to(torch.bfloat16)), path
        if "norm" in path:
            assert (t == 0).all(), path
    d = arch.d_model
    assert abs(p32["embed"].std().item() - 0.02) < 0.002
    w_up = p32["blocks"][0]["ffn"]["w_up"]
    assert abs(w_up.std().item() * d ** 0.5 - 1.0) < 0.05


def test_convert_roundtrip():
    _, _, params_j, _, params_t = setup("ragged")
    back = params_to_numpy(params_t)
    ref = jax.tree.map(np.asarray, params_j)
    for path, a in tree_paths(ref).items():
        b = tree_paths(back)[path]
        assert b.dtype == a.dtype and np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# Layers and MoE
# ---------------------------------------------------------------------------


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        _np(L.rms_norm(_t(x), _t(scale))), np.asarray(JL.rms_norm(x, scale)), atol=ATOL)
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(x), _t(pos, torch.int64), 1e4)),
        np.asarray(JL.apply_rope(x, pos, 1e4)), atol=ATOL)
    # per-sequence offsets/lengths (continuous-batching decode) with GQA,
    # and the plain causal/window form
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    off, kl = np.asarray([10, 5]), np.asarray([11, 6])
    np.testing.assert_allclose(
        _np(L.attention(_t(q), _t(k), _t(v), q_offset=_t(off, torch.int64),
                        kv_len=_t(kl, torch.int64))),
        np.asarray(JL.attention(q, k, v, q_offset=jnp.asarray(off), kv_len=jnp.asarray(kl))),
        atol=ATOL)
    np.testing.assert_allclose(
        _np(L.attention(_t(k), _t(k), _t(v), window=5, logit_softcap=20.0, q_chunks=2)),
        np.asarray(JL.attention(k, k, v, window=5, logit_softcap=20.0)), atol=ATOL)


@pytest.mark.parametrize("dispatch,cf", [("capacity", 1.0), ("capacity", None),
                                         ("ragged", None)])
def test_moe_ffn_local_matches_reference(dispatch, cf):
    """Routing, capacity drops (cf 1.0 drops), the stable sort and the
    combine; rows of zeros stand for the engine's inactive decode slots,
    which are routed and take capacity like any token."""
    _, lm_j, params_j, lm_t, params_t = setup(dispatch, cf)
    ffn_j = jax.tree.map(lambda p: p[0], params_j["blocks"][0]["ffn"])
    ffn_t = {k: v[0] for k, v in params_t["blocks"][0]["ffn"].items()}
    x = np.random.default_rng(1).standard_normal((3, 16, 64)).astype(np.float32)
    x[2, 8:] = 0.0
    y_j, m_j = jmoe.moe_ffn_local(ffn_j, x, lm_j.arch)
    y_t, m_t = tmoe.moe_ffn_local(ffn_t, _t(x), lm_t.arch)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=ATOL)
    np.testing.assert_array_equal(_np(m_t["expert_load"]), np.asarray(m_j["expert_load"]))
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(_np(m_t[k]), np.asarray(m_j[k]), rtol=1e-5, err_msg=k)
    if cf == 1.0:  # the case must really drop pairs
        moe = lm_t.arch.moe
        xt = _t(x).reshape(-1, 64)
        top_w, top_i, _, _ = tmoe._route(xt, ffn_t["w_router"], moe)
        C = tmoe._capacity(xt.shape[0], moe)
        _, _, keep, _ = tmoe._dispatch_indices(top_i, top_w, moe.num_experts, C)
        assert not keep.all()


# ---------------------------------------------------------------------------
# Whole model: forward, paged prefill and decode, page ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_forward_matches_reference(dispatch):
    plan, lm_j, params_j, lm_t, params_t = setup(dispatch)
    toks = np.random.default_rng(5).integers(0, 512, size=(2, 24)).astype(np.int32)
    with plan.mesh:
        lj, aux_j, loads_j = jax.jit(lm_j.forward)(params_j, {"tokens": jnp.asarray(toks)})
    lt, aux_t, loads_t = lm_t.forward(params_t, {"tokens": _t(toks, torch.int64)})
    assert lt.shape == lj.shape == (2, 24, 512)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=ATOL)
    np.testing.assert_array_equal(_np(loads_t), np.asarray(loads_j))
    for k in aux_j:
        np.testing.assert_allclose(_np(aux_t[k]), np.asarray(aux_j[k]), rtol=1e-5)


@pytest.mark.parametrize("dispatch,cf", [("capacity", None), ("capacity", 1.25),
                                         ("ragged", None)])
def test_paged_prefill_and_decode_match_reference(dispatch, cf):
    """The engine's pattern: per-request prefill right-padded to a bucket,
    then decode steps over every slot with one slot inactive (sentinel
    table row, token 0).  Logits of every step and the page pools match;
    cf 1.25 is the default capacity factor, with drops in decode."""
    plan, lm_j, params_j, lm_t, params_t = setup(dispatch, cf)
    layout = PagedLayout(num_blocks=16, block_size=4, max_seqs=3, max_blocks_per_seq=6)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (9, 5)]
    pool = BlockPool(layout)
    with plan.mesh:
        cj = lm_j.init_paged_cache(layout, dtype=jnp.float32)
        prefill_j = jax.jit(lm_j.prefill_paged)
        decode_j = jax.jit(lm_j.decode_step_paged)
    ct = lm_t.init_paged_cache(layout, dtype=torch.float32, device="cpu")

    def same_pages():
        for pj, pt in zip(cj, ct):
            for kv in ("k", "v"):
                np.testing.assert_allclose(_np(pt[kv]), np.asarray(pj[kv]), atol=ATOL)

    nxt = np.zeros((3, 1), np.int32)
    for p in prompts:
        slot = pool.admit(len(p))
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        bt = pool.block_table[slot][None]
        with plan.mesh:
            lj, cj = prefill_j(params_j, {"tokens": jnp.asarray(toks)}, cj,
                               jnp.asarray(bt), jnp.asarray([len(p)], jnp.int32))
        lt, ct = lm_t.prefill_paged(params_t, {"tokens": _t(toks, torch.int64)}, ct,
                                    _t(bt, torch.int32), torch.tensor([len(p)]))
        np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=ATOL)
        nxt[slot, 0] = int(np.argmax(np.asarray(lj)[0]))
    same_pages()
    for step in range(4):
        lens = pool.lengths.copy()
        for slot in (0, 1):
            assert pool.extend(slot, 1)
        bt = pool.block_table.copy()
        with plan.mesh:
            lj, cj = decode_j(params_j, cj, jnp.asarray(bt), jnp.asarray(lens),
                              {"tokens": jnp.asarray(nxt)})
        lt, ct = lm_t.decode_step_paged(params_t, ct, _t(bt, torch.int32),
                                        _t(lens, torch.int32),
                                        {"tokens": _t(nxt, torch.int64)})
        np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=ATOL,
                                   err_msg=f"step {step}")
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)[:, None]
    same_pages()


def test_gather_and_append_match_reference():
    """Page writes and reads, with sentinel table entries (inactive slots,
    unallocated blocks), pad rows cut by ``count`` and an offset append."""
    layout = PagedLayout(num_blocks=6, block_size=4, max_seqs=3, max_blocks_per_seq=3)
    h, d = 2, 8
    rng = np.random.default_rng(0)
    bt = np.asarray([[3, 0, 6], [5, 1, 6], [6, 6, 6]], np.int32)  # 6 = sentinel
    kv = rng.standard_normal((3, 7, h, d)).astype(np.float32)
    lens = np.asarray([7, 5, 3], np.int32)
    pj = jnp.ones((layout.num_blocks, layout.block_size, h, d))
    pt = torch.ones((layout.num_blocks, layout.block_size, h, d))
    pj = jkv.append_tokens(pj, jnp.asarray(bt), jnp.zeros((3,), jnp.int32),
                           jnp.asarray(kv), count=jnp.asarray(lens))
    out = tkv.append_tokens(pt, _t(bt, torch.int32), torch.zeros(3, dtype=torch.int32),
                            _t(kv), count=_t(lens, torch.int32))
    assert out is pt  # in place
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    np.testing.assert_array_equal(_np(tkv.gather_pages(pt, _t(bt, torch.int32))),
                                  np.asarray(jkv.gather_pages(pj, jnp.asarray(bt))))
    # one more token per sequence at its own fill; the third row is all
    # sentinel and the first write lands past its table's last real page
    tok = rng.standard_normal((3, 1, h, d)).astype(np.float32)
    start = np.asarray([7, 5, 0], np.int32)
    pj = jkv.append_tokens(pj, jnp.asarray(bt), jnp.asarray(start), jnp.asarray(tok))
    tkv.append_tokens(pt, _t(bt, torch.int32), _t(start, torch.int32), _t(tok))
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    gathered = _np(tkv.gather_pages(pt, _t(bt, torch.int32)))
    np.testing.assert_array_equal(gathered, np.asarray(jkv.gather_pages(pj, jnp.asarray(bt))))
    assert (gathered[2] == 0).all()  # sentinel pages read as zeros
