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
products, summed in another order).  ``ssd_intra_chunk``'s tensor-core
kernel takes C.B^T once for head-broadcast B and C and the fp32 decayed
scores as three bf16 pieces (``ssd.ref.ssd_intra_chunk_pieces``), held
against the plain version and the JAX kernel at chip_smoke.py's bf16
``SSD_TOL``.  The fused gate-up's and the SSD's ``*_launch`` functions are run on
CPU tensors with their kernels replaced by a recorder, to hold which design,
tile, work table and heads per block each call takes.  The wrappers' choice of kernel design,
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
from repro.kernels.ssd import ssd as jssd
from repro_torch.kernels import launch_counts
from repro_torch.kernels._build import CSRC, Kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.kernels.moe_gemm import ref as mm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

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
    (BF16, 256, "tc"), (FP32, 16, "fma"), (FP32, 32, "fma"), (FP32, 64, "fma"),
    (FP32, 128, "fma"), (FP32, 256, "fma"),
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
        fa_ops.design(FP32, 512)
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

    kernels = [*mm_ops._GROUPED.values(), *mm_ops._RAGGED.values(),
               *mm_ops._GATE_UP.values(), mm_ops._DW, *fa_ops._FLASH.values(),
               *ssd_ops._SSD.values()]
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


# ---------------------------------------------------------------------------
# The fused gate-up-SiLU and the SSD intra-chunk term on the tensor cores
# ---------------------------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Each wrapper's ``*_launch`` function on CPU tensors (device check off), the
    kernels replaced by a recorder: which design ran, with which args."""
    calls = []
    for mod, table in ((mm_ops, mm_ops._GATE_UP), (ssd_ops, ssd_ops._SSD)):
        monkeypatch.setattr(mod, "check_cuda", lambda *t: None)
        for kind in table:
            monkeypatch.setitem(table, kind, lambda *a, _k=kind: calls.append((_k, a)))
    return calls


@pytest.mark.parametrize("xdt,wdt,counts,kind,tile", [
    (BF16, BF16, [7, 0, 83, 1, 9], "tc", "Tile64"),
    (BF16, BF16, [1, 1, 1, 1, 1, 96, 1, 1], "skinny", "Skinny"),  # 13.5 rows an expert
    (BF16, BF16, [16, 16, 0, 32], "skinny", "Skinny"),  # 16 exactly
    (BF16, BF16, [17, 16, 0, 35], "tc", "Tile64"),
    (FP32, BF16, [7, 0, 83, 1, 9], "tc", "Tile64Split"),
    (FP32, BF16, [0, 0, 0, 3], "skinny", "Skinny"),
    (FP32, FP32, [7, 0, 83, 1, 9], "fma", None),
    (BF16, FP32, [0, 0, 0, 3], "fma", None),
])
def test_gate_up_launch_routes_by_dtype_and_rows(recorded, xdt, wdt, counts, kind, tile):
    """bf16 weights: /skinny at <= 16 rows an expert, /tc above, at the
    tile's code and with the work table built at the tile's height; fp32
    weights /fma at ``_row_block``'s height.  Three zeroed fp32 outputs."""
    offs = torch.from_numpy(_offsets(counts))
    T, E = int(offs[-1]), len(counts)
    x = torch.zeros((T, 48), dtype=xdt)
    wg, wu = torch.zeros((E, 48, 56), dtype=wdt), torch.ones((E, 48, 56), dtype=wdt)
    outs, launch = mm_ops.ragged_gate_up_silu_f32_launch(x, wg, wu, offs)
    launch()
    ((got, args),) = recorded
    assert got == kind == mm_ops.ragged_design(xdt, wdt, T / E)
    assert len(outs) == 3 and all(o.shape == (T, 56) and o.dtype == FP32 and not o.any()
                                  for o in outs)
    bm = mm_ops.TILE_ROWS[tile] if tile else mm_ops._row_block(T / E)
    assert args[-2] == -(-T // bm) + E  # G: work items at the table's height
    assert args[-1] == (mm_ops.TILES.index(tile) if tile else bm)
    assert args[2] is wg and args[3] is wu


@pytest.mark.parametrize("dtype,kind", [(BF16, "tc"), (FP32, "fma")])
def test_ssd_design(dtype, kind):
    assert ssd_ops.design(dtype) == kind
    with pytest.raises(ValueError):
        ssd_ops.design(torch.float16)


@pytest.mark.parametrize("g,cl,h,p,shared,hb", [
    (32, 256, 32, 64, True, 2),   # mamba2-370m, 4 x 2048
    (32, 256, 32, 64, False, 1),  # per-head B and C
    (4, 100, 32, 64, True, 1),    # 4 x 100: the first version's 256 blocks
    (1, 200, 32, 64, True, 1),    # 1 x 200: its 128 blocks
    (8, 256, 32, 64, True, 2),    # 512 blocks
    (4, 256, 32, 64, True, 1),    # two heads a block would leave 256
    (64, 256, 3, 64, True, 1),    # 2 does not divide 3
    (128, 256, 32, 128, True, 1),  # p = 128: one head a block
])
def test_ssd_heads_per_block(g, cl, h, p, shared, hb):
    """Heads sharing one C.B^T a block: two where that keeps the grid at or
    above MIN_BLOCKS, at p <= 64 and head-broadcast B and C only."""
    got = ssd_ops.heads_per_block(g, cl, h, p, shared)
    assert got == hb
    assert got == 1 or -(-cl // 64) * (h // got) * g >= ssd_ops.MIN_BLOCKS


def test_ssd_c_entry_takes_the_heads_per_block_python_picks():
    src = (CSRC / "ssd_tc.cu").read_text()
    assert "HB != 1 && HB != 2" in src
    assert "HB > 1 && (b_sh != 0 || c_sh != 0 || P > 64)" in src


@pytest.mark.parametrize("dtype,shared,hb", [(BF16, True, 2), (BF16, False, 1),
                                             (FP32, True, None)])
def test_ssd_launch_routes_by_dtype(recorded, dtype, shared, hb):
    """bf16 -> /tc with the heads per block of ``heads_per_block`` (2 for
    head-broadcast B and C at the model's 4 x 2048 prefill, 1 per head);
    fp32 -> /fma; the strides of x, B, C and dA in the C entry's order."""
    g, cl, h, p, n = 32, 256, 32, 64, 128
    x, dA = torch.zeros((g, cl, h, p), dtype=dtype), torch.zeros((g, cl, h), dtype=dtype)
    B = (torch.zeros((g, cl, 1, n), dtype=dtype).expand(g, cl, h, n) if shared
         else torch.zeros((g, cl, h, n), dtype=dtype))
    out, launch = ssd_ops.ssd_intra_chunk_launch(x, dA, B, B)
    launch()
    ((kind, args),) = recorded
    assert kind == ssd_ops.design(dtype) and out.shape == x.shape and out.dtype == dtype
    strides = [s for t in (x, B, B, dA) for s in t.stride()[:3]]
    if kind == "tc":
        assert list(args[5:11]) == [g, cl, h, p, n, hb] and list(args[11:]) == strides
    else:
        assert list(args[5:11]) == [0, g, cl, h, p, n] and list(args[11:]) == strides


def test_every_gate_up_and_ssd_design_has_its_own_counter():
    counts = launch_counts()
    for name, table in (("ragged_gate_up_silu_f32", mm_ops._GATE_UP),
                        ("ssd_intra_chunk", ssd_ops._SSD)):
        for kind, kernel in table.items():
            assert kernel.counters == (name, f"{name}/{kind}")
            assert f"{name}/{kind}" in counts
    assert set(mm_ops._GATE_UP) == {"tc", "skinny", "fma"} and set(ssd_ops._SSD) == {"tc", "fma"}
    assert {k.symbol for k in mm_ops._GATE_UP.values()} == {"ragged_gate_up_silu_f32_tc",
                                                            "ragged_gate_up_silu_f32"}
    assert mm_ops._GATE_UP["tc"].source == "moe_gemm_tc" and ssd_ops._SSD["tc"].source == "ssd_tc"


def _ssd_case(shape, law, per_head, seed):
    """bf16 values (as numpy fp32) of x, dA, B, C at the model's scale."""
    g, cl, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = _bf16_values(rng.standard_normal((g, cl, h, p)) * 0.1)
    dA = _bf16_values({"decay": -np.abs(rng.standard_normal((g, cl, h))) * 0.1,
                       "strong": rng.standard_normal((g, cl, h)) - 50.0,
                       "zero": np.zeros((g, cl, h))}[law])
    bc = (g, cl, h if per_head else 1, n)
    B, C = (_bf16_values(rng.standard_normal(bc) * 0.5) for _ in range(2))
    return x, dA, B, C


SSD_BF16 = dict(rtol=1e-2, atol=3e-5)  # chip_smoke.py's SSD_TOL for bf16


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("shape,law", [
    ((2, 64, 4, 16, 16), "decay"), ((3, 1, 4, 16, 8), "decay"), ((2, 100, 4, 16, 16), "decay"),
    ((2, 64, 4, 16, 8), "strong"), ((2, 64, 4, 16, 8), "zero"), ((1, 256, 2, 64, 128), "decay"),
    ((1, 200, 2, 64, 128), "zero"),
])
def test_ssd_tensor_core_arithmetic_matches_plain_and_jax(shape, law, per_head):
    """The /tc kernel's arithmetic (``ref.ssd_intra_chunk_pieces``: C.B^T once
    for head-broadcast B and C, the decayed scores as three bf16 pieces)
    on bf16 inputs, against the fp32 plain version rounded once and the JAX
    package's Pallas kernel in interpret mode, at chip_smoke.py's bf16
    SSD_TOL; the strong-decay edge (dA ~ -50) stays finite."""
    x, dA, B, C = _ssd_case(shape, law, per_head, seed=sum(shape))
    g, cl, h, p, n = shape
    tx, tdA = torch.from_numpy(x).to(BF16), torch.from_numpy(dA).to(BF16)
    tB, tC = (torch.from_numpy(a).to(BF16).expand(g, cl, h, n) for a in (B, C))
    assert (tB.stride(2) == 0) == (not per_head)
    got = ssd_ref.ssd_intra_chunk_pieces(tx, tdA, tB, tC)
    assert got.dtype == BF16 and got.shape == (g, cl, h, p) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(),
                               ssd_ref.ssd_intra_chunk(tx, tdA, tB, tC).float().numpy(),
                               **SSD_BF16)
    jb = lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.bfloat16), (g, cl, h, n))  # noqa: E731
    want = jssd.ssd_intra_chunk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dA, jnp.bfloat16),
                                jb(B), jb(C), interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **SSD_BF16)
