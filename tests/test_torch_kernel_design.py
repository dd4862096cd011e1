"""The tensor-core designs' arithmetic and routing, on the CPU.

``grouped_matmul_f32``'s and ``ragged_matmul_f32``'s tensor-core kernels
take fp32 x through three bf16 pieces (``ref.split_bf16x3``) and sum their
exact products with bf16 w in fp32; ``ragged_dw_f32``'s takes each fp32
operand as three pieces and keeps three products (one fp32 operand, all
exact) or six (two; the three dropped are below 2^-24 of |x.g|).  Here that
arithmetic, written in plain PyTorch (``ref.grouped_matmul_bf16x3``,
``ref.ragged_matmul_bf16x3``, ``ref.ragged_dw_pieces``), is held against
the fp32 product and against the JAX package's Pallas kernels in interpret
mode, at the GEMMs' fp32 bound (rtol 2e-5, atol 1.6e-4: the same exact
products, summed in another order).  The wrappers' choice of kernel design,
by (x dtype, w dtype, rows per expert) and by (dtype, head dim), and of the
tensor-core tile shape, is pure Python and is held case by case, as are
the C entry points' tile codes, tile heights and argument lists.  The
kernels themselves run only on the card (test_torch_kernels_gpu.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.moe_gemm import moe_gemm as jmm
from repro_torch.kernels import launch_counts
from repro_torch.kernels._build import CSRC, Kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.kernels.moe_gemm import ref as mm_ref
from repro_torch.kernels.ssd import ops as ssd_ops

F32 = dict(rtol=2e-5, atol=1.6e-4)
BF16, FP32 = torch.bfloat16, torch.float32

# finite fp32 magnitudes in [2^-100, 2^100], either sign
_fp32 = st.builds(
    lambda m, e, s: s * m * 2.0 ** e,
    st.floats(1.0, 2.0, exclude_max=True, width=32),
    st.integers(-100, 99),
    st.sampled_from([1.0, -1.0]),
)


@settings(max_examples=300, deadline=None)
@given(st.lists(_fp32, min_size=1, max_size=64))
def test_split_bf16x3_sums_to_x_exactly(values):
    x = torch.tensor(values, dtype=FP32)
    pieces = mm_ref.split_bf16x3(x)
    assert all(p.dtype == BF16 for p in pieces)
    for p in pieces:  # bf16-representable: rounding to bf16 again changes nothing
        assert torch.equal(p.float().to(BF16).float(), p.float())
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, x.double())
    assert torch.equal(pieces[0], x.to(BF16))


def test_split_bf16x3_of_zero_and_bf16_values():
    x = torch.tensor([0.0, -0.0, 1.0, -3.5, 2.0 ** -90, 1.0 + 2.0 ** -7], dtype=FP32)
    hi, mid, lo = mm_ref.split_bf16x3(x)
    assert torch.equal(hi.float(), x)
    assert not mid.float().any() and not lo.float().any()


@pytest.mark.parametrize("E,M,K,N", [(2, 1, 64, 40), (3, 3, 64, 40), (2, 16, 32, 16),
                                     (2, 17, 96, 56), (3, 100, 96, 56), (2, 128, 64, 512)])
def test_split_product_matches_fp32_and_jax(E, M, K, N):
    rng = np.random.default_rng(E * 1000 + M)
    x = rng.standard_normal((E, M, K)).astype(np.float32)  # fp32 hidden rows
    w = np.array(jnp.asarray(rng.standard_normal((E, K, N)) * K ** -0.5,
                             jnp.bfloat16).astype(jnp.float32))  # bf16 weights
    tx, tw = torch.from_numpy(x), torch.from_numpy(w).to(BF16)
    got = mm_ref.grouped_matmul_bf16x3(tx, tw)
    assert got.dtype == FP32 and got.shape == (E, M, N)
    np.testing.assert_allclose(got.numpy(), mm_ref.grouped_matmul_f32(tx, tw).numpy(), **F32)
    want = jmm.grouped_matmul_f32(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("xdt,wdt,M,kind", [
    (BF16, BF16, 1, "skinny"), (BF16, BF16, 3, "skinny"), (BF16, BF16, 16, "skinny"),
    (BF16, BF16, 17, "tc"), (BF16, BF16, 100, "tc"), (BF16, BF16, 128, "tc"),
    (FP32, BF16, 1, "skinny"), (FP32, BF16, 16, "skinny"), (FP32, BF16, 17, "tc"),
    (FP32, BF16, 128, "tc"),
    (FP32, FP32, 1, "fma"), (FP32, FP32, 128, "fma"), (BF16, FP32, 1, "fma"),
    (BF16, FP32, 128, "fma"),
])
def test_grouped_design(xdt, wdt, M, kind):
    assert mm_ops.grouped_design(xdt, wdt, M) == kind


@pytest.mark.parametrize("xdt,M,tile", [
    (BF16, 1, "Skinny"), (BF16, 16, "Skinny"), (BF16, 17, "Tile64"), (BF16, 32, "Tile64"),
    (BF16, 64, "Tile64"), (BF16, 65, "Tile128"), (BF16, 128, "Tile128"),
    (FP32, 1, "Skinny"), (FP32, 16, "Skinny"), (FP32, 17, "Tile64Split"),
    (FP32, 128, "Tile64Split"),
])
def test_grouped_tile(xdt, M, tile):
    assert mm_ops.grouped_tile(xdt, M) == tile


def test_tile_codes_match_the_cuda_source():
    """``TILES`` lists the tile shapes in the order of the C entry's codes."""
    src = (Path(mm_ops.__file__).parents[1] / "csrc" / "moe_gemm_tc.cu").read_text()
    codes = dict(re.findall(r"k(\w+) = (\d+)", re.search(r"enum Tile \{([^}]*)\}", src)[1]))
    assert codes == {t: str(i) for i, t in enumerate(mm_ops.TILES)}


@pytest.mark.parametrize("dtype,d,kind", [
    (BF16, 16, "tc"), (BF16, 32, "tc"), (BF16, 64, "tc"), (BF16, 128, "tc"),
    (FP32, 16, "fma"), (FP32, 32, "fma"), (FP32, 64, "fma"), (FP32, 128, "fma"),
])
def test_flash_design(dtype, d, kind):
    assert fa_ops.design(dtype, d) == kind


def test_designs_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError):
        mm_ops.grouped_design(torch.float16, BF16, 8)
    with pytest.raises(ValueError):
        mm_ops.grouped_design(BF16, torch.float64, 8)
    with pytest.raises(ValueError):
        fa_ops.design(BF16, 24)
    with pytest.raises(ValueError):
        fa_ops.design(torch.float16, 64)


def test_every_design_has_its_own_counter():
    counts = launch_counts()
    for name in ("flash_attention", "flash_attention/tc", "flash_attention/fma",
                 "grouped_matmul_f32", "grouped_matmul_f32/tc",
                 "grouped_matmul_f32/skinny", "grouped_matmul_f32/fma",
                 "ragged_matmul_f32", "ragged_gate_up_silu_f32", "ragged_dw_f32",
                 "ssd_intra_chunk"):
        assert name in counts
    assert {k.symbol for k in fa_ops._FLASH.values()} == {"flash_attention_tc",
                                                           "flash_attention_fma"}
    for kind, kernel in mm_ops._GROUPED.items():
        assert kernel.counters == ("grouped_matmul_f32", f"grouped_matmul_f32/{kind}")


# Expert row counts: empty experts, a single expert, and counts straddling
# the 16-, 64- and 128-row tiles.
RAGGED_COUNTS = [[7, 0, 83, 1, 9], [0, 0, 0, 100], [130], [1],
                 [15, 17, 63, 65, 127, 129], [1, 1, 1, 1, 1, 96, 1, 1], [0, 40, 0]]


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _bf16_values(a):
    """fp32 values that bf16 holds exactly (the JAX side's bf16 operands)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("K,N", [(48, 64), (96, 56)])
@pytest.mark.parametrize("counts", RAGGED_COUNTS)
def test_ragged_split_product_matches_fp32_and_jax(counts, K, N):
    """fp32 rows in three bf16 pieces x bf16 experts, the ragged tensor-core
    kernel's arithmetic; rows past offsets[E] (here NaN) come back 0."""
    rng = np.random.default_rng(len(counts) * 100 + K)
    offs = _offsets(counts)
    E, rows = len(counts), int(offs[-1])
    T = -(-(rows + 1) // 16) * 16  # the JAX kernel takes whole 16-row tiles
    x = rng.standard_normal((T, K)).astype(np.float32)
    x[rows:] = np.nan
    w = _bf16_values(rng.standard_normal((E, K, N)) * K ** -0.5)
    tx, tw, to = torch.from_numpy(x), torch.from_numpy(w).to(BF16), torch.from_numpy(offs)
    got = mm_ref.ragged_matmul_bf16x3(tx, tw, to)
    assert got.dtype == FP32 and got.shape == (T, N) and (got[rows:] == 0).all()
    np.testing.assert_allclose(got.numpy(), mm_ref.ragged_matmul_f32(tx, tw, to).numpy(), **F32)
    want = jmm.ragged_matmul_f32(jnp.asarray(np.nan_to_num(x)), jnp.asarray(w, jnp.bfloat16),
                                 jnp.asarray(offs), bm=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("xdt,gdt", [(BF16, FP32), (FP32, FP32), (FP32, BF16), (BF16, BF16)])
@pytest.mark.parametrize("counts", RAGGED_COUNTS)
def test_ragged_dw_pieces_match_fp32_and_jax(counts, xdt, gdt):
    """The dgrad's pieces for each operand pair (3, 6, 3 and 1 products)
    against the fp32 dgrad and the JAX package's Pallas ``ragged_dw_f32``;
    NaN rows past offsets[E] are never read, empty experts get zeros."""
    rng = np.random.default_rng(len(counts) * 10 + (xdt == BF16) + 2 * (gdt == BF16))
    offs = _offsets(counts)
    E, rows = len(counts), int(offs[-1])
    T = -(-(rows + 1) // 16) * 16
    K, N = 48, 40
    x, g = rng.standard_normal((T, K)), rng.standard_normal((T, N)) * 1e-2
    x, g = (_bf16_values(a) if dt == BF16 else a.astype(np.float32)
            for a, dt in ((x, xdt), (g, gdt)))
    x[rows:], g[rows:] = np.nan, np.nan
    to = torch.from_numpy(offs)
    tx, tg = torch.from_numpy(x).to(xdt), torch.from_numpy(g).to(gdt)
    got = mm_ref.ragged_dw_pieces(tx, tg, to)
    assert got.dtype == FP32 and got.shape == (E, K, N) and torch.isfinite(got).all()
    for e, c in enumerate(counts):
        if c == 0:
            assert (got[e] == 0).all()
    np.testing.assert_allclose(got.numpy(), mm_ref.ragged_dw_f32(tx, tg, to).numpy(), **F32)
    want = jmm.ragged_dw_f32(jnp.asarray(x, jnp.bfloat16 if xdt == BF16 else jnp.float32),
                             jnp.asarray(g, jnp.bfloat16 if gdt == BF16 else jnp.float32),
                             jnp.asarray(offs), E, bm=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 70), min_size=1, max_size=6), st.integers(0, 2 ** 31 - 1))
def test_ragged_dw_pieces_fp32_pair_over_random_counts(counts, seed):
    """fp32 x fp32 in six products stays within the fp32 bound of the fp32
    dgrad for any expert counts, including all-empty ones."""
    rng = np.random.default_rng(seed)
    offs = torch.from_numpy(_offsets(counts))
    rows = int(offs[-1])
    x = torch.from_numpy(rng.standard_normal((rows + 3, 16)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((rows + 3, 8)) * 1e-3).astype(np.float32))
    x[rows:], g[rows:] = float("nan"), float("nan")
    got = mm_ref.ragged_dw_pieces(x, g, offs)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), mm_ref.ragged_dw_f32(x, g, offs).numpy(), **F32)


@pytest.mark.parametrize("xdt,wdt,rows,kind", [
    (BF16, BF16, 0.8, "skinny"), (BF16, BF16, 16, "skinny"), (BF16, BF16, 16.5, "tc"),
    (BF16, BF16, 102.4, "tc"), (FP32, BF16, 0.8, "skinny"), (FP32, BF16, 16, "skinny"),
    (FP32, BF16, 17, "tc"), (FP32, BF16, 204.8, "tc"), (FP32, FP32, 0.8, "fma"),
    (FP32, FP32, 204.8, "fma"), (BF16, FP32, 1, "fma"), (BF16, FP32, 102.4, "fma"),
])
def test_ragged_design(xdt, wdt, rows, kind):
    assert mm_ops.ragged_design(xdt, wdt, rows) == kind


@pytest.mark.parametrize("xdt,rows,tile", [
    (BF16, 0.8, "Skinny"), (BF16, 16, "Skinny"), (BF16, 16.5, "Tile64"), (BF16, 64, "Tile64"),
    (BF16, 102.4, "Tile64"), (BF16, 204.8, "Tile64"), (FP32, 0.8, "Skinny"),
    (FP32, 16, "Skinny"), (FP32, 17, "Tile64Split"), (FP32, 102.4, "Tile64Split"),
    (FP32, 204.8, "Tile64Split"),
])
def test_ragged_tile(xdt, rows, tile):
    assert mm_ops.ragged_tile(xdt, rows) == tile


def test_ragged_designs_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError):
        mm_ops.ragged_design(torch.float16, BF16, 8)
    with pytest.raises(ValueError):
        mm_ops.ragged_design(BF16, torch.float64, 8)


def test_tile_rows_match_the_cuda_source():
    """``TILE_ROWS`` (the height a ragged work table is built at) is each
    tile's BM in the C source."""
    src = (CSRC / "moe_gemm_tc.cu").read_text()
    shapes = dict(re.findall(r"using (\w+) = Shape<(\d+),", src))
    assert {t: int(shapes[t]) for t in mm_ops.TILES} == mm_ops.TILE_ROWS


def _c_params(source: str, symbol: str):
    """The C parameter list of ``extern "C" int symbol(...)`` in a source."""
    src = (CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, (source, symbol)
    return [p.strip() for p in m[1].split(",")]


def test_ctypes_signatures_match_the_c_entry_points():
    """Every bound entry point's argtypes (pointers as c_void_p, ints as
    c_int, the stream last) agree with its C declaration, parameter by
    parameter: a wrong list would pass garbage with no error."""
    import ctypes

    def expected(param):
        if "*" in param:
            return ctypes.c_void_p
        return {"long": ctypes.c_int64, "float": ctypes.c_float}.get(param.split()[0],
                                                                    ctypes.c_int)

    kernels = [*mm_ops._GROUPED.values(), *mm_ops._RAGGED.values(), mm_ops._GATE_UP,
               mm_ops._DW, *fa_ops._FLASH.values(), ssd_ops._SSD]
    assert all(isinstance(k, Kernel) for k in kernels)
    for k in kernels:
        params = _c_params(k.source, k.symbol)
        assert len(params) == len(k.argtypes), (k.symbol, params)
        for p, a in zip(params, k.argtypes):
            assert a is expected(p), (k.symbol, p, a)


def test_every_ragged_design_has_its_own_counter():
    counts = launch_counts()
    for kind, kernel in mm_ops._RAGGED.items():
        assert kernel.counters == ("ragged_matmul_f32", f"ragged_matmul_f32/{kind}")
        assert f"ragged_matmul_f32/{kind}" in counts
    assert mm_ops._DW.counters == ("ragged_dw_f32", "ragged_dw_f32/tc")
    assert {k.symbol for k in mm_ops._RAGGED.values()} == {"ragged_matmul_f32_tc",
                                                           "ragged_matmul_f32"}
    assert mm_ops._DW.source == "moe_gemm_tc" and mm_ops._RAGGED["fma"].source == "moe_gemm"
