"""The tensor-core designs' arithmetic and routing, on the CPU.

``grouped_matmul_f32``'s tensor-core kernel takes fp32 x through three bf16
pieces (``ref.split_bf16x3``) and sums their exact products with bf16 w in
fp32; here that arithmetic, written in plain PyTorch
(``ref.grouped_matmul_bf16x3``), is held against the fp32 product and
against the JAX package's Pallas ``grouped_matmul_f32`` in interpret mode,
at the GEMMs' fp32 bound (rtol 2e-5, atol 1.6e-4: the same exact products,
summed in another order).  The wrappers' choice of kernel design, by
(x dtype, w dtype, rows per expert) and by (dtype, head dim), and of the
grouped kernel's tile shape, is pure Python and is held case by case.  The kernels themselves run only on the
card (test_torch_kernels_gpu.py).
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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.kernels.moe_gemm import ref as mm_ref

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
