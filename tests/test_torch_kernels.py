"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper of ``repro_torch.kernels`` takes its kernel's
plain PyTorch version (the tensors lie on the CPU); the JAX side runs the
Pallas kernels themselves in interpret mode, over the cases of
``tests/test_kernels.py``.  Inputs are made once with numpy and handed to
both (bf16 cases round them to bf16 first, so both sides see the same
values).

Tolerances follow the reference's: fp32 rtol 2e-5 (atol 8x for the GEMMs,
4x for attention), bf16 rtol 2e-2 likewise; the GEMMs' fp32 outputs are
held at the fp32 bound in both dtypes, since both sides sum the same exact
products in fp32 and differ only in order.  The FFN compositions at 1e-5.

The card-only checks of the CUDA kernels are in test_torch_kernels_gpu.py.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.moe_gemm import moe_gemm as jmm
from repro.kernels.moe_gemm import ops as jmm_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.kernels.moe_gemm import ref as mm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
F32 = dict(rtol=2e-5, atol=1.6e-4)
RAGGED_COUNTS = [
    [7, 0, 83, 1, 9],  # skewed + empty expert
    [0, 0, 0, 100],  # all tokens to one expert
    [25, 25, 25, 25],  # uniform
    [100],  # E = 1
    [1, 1, 1, 1, 1, 96, 1, 1],  # near-degenerate skew
]


def _pair(a, dtype: str):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "E,M,K,N",
    [(2, 16, 32, 16), (4, 128, 64, 512), (3, 100, 96, 56), (8, 256, 128, 128),
     (1, 64, 512, 64)],
)
def test_grouped_matmul(E, M, K, N, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((E, M, K)), dtype)
    jw, tw = _pair(rng.standard_normal((E, K, N)), dtype)
    want = jmm.grouped_matmul_f32(jx, jw, interpret=True)
    got = mm_ops.grouped_matmul_f32(tx, tw)
    assert got.dtype == torch.float32 and got.shape == (E, M, N)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(mm_ops.grouped_matmul(tx, tw)),
        _np(jmm_ops.grouped_matmul(jx, jw, interpret=True)), rtol=tol, atol=8 * tol)


def _ragged(counts, K, N, dtype, seed=0, bm=16):
    """Rows padded to a multiple of bm with random (non-zero) tail rows."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    E, T = len(counts), int(counts.sum())
    T_pad = -(-(T + 1) // bm) * bm
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    x = _pair(rng.standard_normal((T_pad, K)), dtype)
    w = _pair(rng.standard_normal((E, K, N)) * 0.2, dtype)
    w2 = _pair(rng.standard_normal((E, K, N)) * 0.2, dtype)
    return x, w, w2, (jnp.asarray(offs), torch.from_numpy(offs)), T


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", RAGGED_COUNTS)
def test_ragged_matmul_and_gate_up(counts, dtype):
    (jx, tx), (jw, tw), (jw2, tw2), (jo, to), T = _ragged(counts, 48, 64, dtype)
    got = mm_ops.ragged_matmul_f32(tx, tw, to)
    want = jmm.ragged_matmul_f32(jx, jw, jo, bm=16, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert (got[T:] == 0).all()
    gate = mm_ops.ragged_gate_up_silu_f32(tx, tw, tw2, to)
    jgate = jmm.ragged_gate_up_silu_f32(jx, jw, jw2, jo, bm=16, interpret=True)
    for name, g, j in zip(("h", "a_g", "a_u"), gate, jgate):
        np.testing.assert_allclose(_np(g), _np(j), err_msg=name, **F32)
        assert (g[T:] == 0).all(), name
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(mm_ops.ragged_matmul(tx, tw, to)),
        _np(jmm_ops.ragged_matmul(jx, jw, jo, interpret=True, bm=16)),
        rtol=tol, atol=8 * tol)


@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("counts", RAGGED_COUNTS)
def test_ragged_work_table_matches_reference(counts, bm):
    """The device-built (tile, expert) table of the CUDA ragged kernels is
    the JAX package's ``ragged_metadata``, item for item."""
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    E = len(counts)
    G = -(-int(offs[-1]) // bm) + E
    got = mm_ops.ragged_metadata(torch.from_numpy(offs), bm, E, G)
    want = jmm.ragged_metadata(jnp.asarray(offs), bm, E, G)[:3]
    for name, g, w in zip(("tile_m", "grp", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_grouped_ffn(activation):
    rng = np.random.default_rng(1)
    E, C, d, f = 4, 64, 48, 96
    jt, tt = _pair(rng.standard_normal((E, C, d)), "float32")
    (jwu, twu), (jwg, twg), (jwd, twd) = (
        _pair(rng.standard_normal(s) * 0.1, "float32")
        for s in ((E, d, f), (E, d, f), (E, f, d)))
    want = jmm_ops.grouped_ffn(jt, jwu, jwg, jwd, activation, interpret=True)
    got = mm_ops.grouped_ffn(tt, twu, twg, twd, activation)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("counts", [RAGGED_COUNTS[0], RAGGED_COUNTS[4]])
def test_ragged_ffn(counts, activation):
    (jx, tx), _, _, (jo, to), T = _ragged(counts, 32, 32, "float32")
    rng = np.random.default_rng(1)
    E, d, f = len(counts), 32, 48
    (jwu, twu), (jwg, twg), (jwd, twd) = (
        _pair(rng.standard_normal(s) * 0.2, "float32")
        for s in ((E, d, f), (E, d, f), (E, f, d)))
    if activation != "swiglu":
        jwg = twg = None
    want = jmm_ops.ragged_ffn(jx, jwu, jwg, jwd, jo, activation, interpret=True, bm=16)
    got = mm_ops.ragged_ffn(tx, twu, twg, twd, to, activation)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert (got[T:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,hq,hkv,s,d,window,cap",
    [(2, 4, 2, 128, 32, None, None), (1, 8, 8, 256, 64, 64, None),
     (2, 4, 1, 96, 16, None, 50.0), (1, 2, 2, 64, 128, 32, 30.0),
     (1, 4, 2, 128, 256, 32, 50.0)],  # gemma2-9b's head dim, window and softcap
)
def test_flash_attention(b, hq, hkv, s, d, window, cap, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((b, s, hq, d)), dtype)
    jk, tk = _pair(rng.standard_normal((b, s, hkv, d)), dtype)
    jv, tv = _pair(rng.standard_normal((b, s, hkv, d)), dtype)
    want = jfa_ops.flash_attention(jq, jk, jv, window=window, logit_softcap=cap,
                                   interpret=True, bq=64, bk=64)
    got = fa_ops.flash_attention(tq, tk, tv, window=window, logit_softcap=cap)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, hq, d)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=4 * tol)


@pytest.mark.parametrize("q_offset", [0, 24, 48])  # the first, a middle and the last slice
@pytest.mark.parametrize("d,window,cap", [(64, None, None), (64, 16, 50.0), (256, None, 30.0),
                                          (256, 16, None)])
def test_flash_attention_q_offset_matches_the_reference_attention(q_offset, d, window, cap):
    """A rank's 16 queries at positions q_offset .. q_offset + 15 against
    the whole sequence's 64 keys: the plain version against the
    reference's ``layers.attention(q_offset=...)``, fp32."""
    from repro.models import layers as jlayers

    rng = np.random.default_rng(1)
    b, sq, skv, hq, hkv = 2, 16, 64, 4, 2
    jq, tq = _pair(rng.standard_normal((b, sq, hq, d)), "float32")
    jk, tk = _pair(rng.standard_normal((b, skv, hkv, d)), "float32")
    jv, tv = _pair(rng.standard_normal((b, skv, hkv, d)), "float32")
    want = jlayers.attention(jq, jk, jv, q_offset=q_offset, window=window, logit_softcap=cap)
    got = fa_ops.flash_attention(tq, tk, tv, window=window, logit_softcap=cap,
                                 q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="q_offset"):
        fa_ops.flash_attention(tq, tk, tv, q_offset=skv - sq + 1)


# ---------------------------------------------------------------------------
# Hygiene
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/checkpoint/checkpointing.py",
            "src/repro_torch/launch/cost.py", "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/roofline.py"} <= scanned
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)


def test_wrappers_never_take_the_plain_version_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: the
    plain versions are poisoned, and meta tensors (no data, not CUDA) must
    be refused by the wrappers' device check before any of them runs."""
    def boom(*a, **k):
        raise AssertionError("reached the plain version")

    for name in ("grouped_matmul_f32", "ragged_matmul_f32", "ragged_gate_up_silu_f32",
                 "ragged_dw_f32"):
        monkeypatch.setattr(mm_ref, name, boom)
    monkeypatch.setattr(fa_ref, "attention", boom)
    monkeypatch.setattr(ssd_ref, "ssd_intra_chunk", boom)
    meta = dict(device="meta")
    x = torch.empty((2, 4, 8), **meta)
    w = torch.empty((2, 8, 4), **meta)
    offs = torch.empty((3,), dtype=torch.int32, **meta)
    q = torch.empty((1, 8, 2, 16), **meta)
    calls = [
        lambda: mm_ops.grouped_matmul_f32(x, w),
        lambda: mm_ops.grouped_ffn(x, w, w, w.transpose(1, 2)),
        lambda: mm_ops.ragged_matmul_f32(x[0], w, offs),
        lambda: mm_ops.ragged_gate_up_silu_f32(x[0], w, w, offs),
        lambda: mm_ops.ragged_dw_f32(x[0], x[0], offs),
        lambda: fa_ops.flash_attention(q, q, q),
        lambda: ssd_ops.ssd_intra_chunk(torch.empty((1, 2, 8, 2, 16), **meta),
                                        torch.empty((1, 2, 8, 2), **meta),
                                        *[torch.empty((1, 2, 8, 1, 8), **meta).expand(
                                            1, 2, 8, 2, 8)] * 2),
        # a mix of CPU and other tensors is refused too
        lambda: mm_ops.grouped_matmul_f32(torch.zeros((2, 4, 8)), w),
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call()
