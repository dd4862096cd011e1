"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (from its fixture, never at import) when
no CUDA card is present.  The file imports no JAX, so on a machine with a
card it runs as ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py``.

Tolerances: the GEMM kernels (``ragged_dw_f32`` too) return fp32 sums of
the same fp32-widened products as the plain version, so both dtypes are
held at the reference's fp32 bound (rtol 2e-5, atol 1.6e-4) — only the
summation order differs.  ``RaggedFFN``'s gradients on the card against
the same function on the CPU, fp32: rtol = atol = 2e-5, the reference's
custom-VJP bound.
Flash attention computes in fp32 and rounds once to q's dtype; it is held
against its plain version run in fp32 on the same inputs and rounded once,
so bf16 outputs may differ by one bf16 step (rtol 1e-2, atol 2e-3); fp32
outputs are held at rtol 2e-5, atol 8e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.kernels.moe_gemm import ref as mm_ref

pytestmark = pytest.mark.gpu

GEMM_TOL = dict(rtol=2e-5, atol=1.6e-4)
FA_TOL = {torch.float32: dict(rtol=2e-5, atol=8e-5),
          torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
RAGGED_COUNTS = [
    [7, 0, 83, 1, 9],
    [0, 0, 0, 100],
    [25, 25, 25, 25],
    [100],
    [1, 1, 1, 1, 1, 96, 1, 1],
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def no_plain(monkeypatch):
    """Any call into a plain version fails the test."""
    def boom(*a, **k):
        raise AssertionError("a CUDA call reached the plain version")
    for mod, names in ((mm_ref, ("grouped_matmul_f32", "ragged_matmul_f32",
                                 "ragged_gate_up_silu_f32", "ragged_dw_f32")),
                       (fa_ref, ("attention",))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)


def _t(a, dtype, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("E,M,K,N", [(2, 16, 32, 16), (4, 128, 64, 512),
                                     (3, 100, 96, 56), (8, 256, 128, 128),
                                     (1, 64, 512, 64), (40, 1, 1536, 512)])
def test_grouped_matmul_kernel(dev, E, M, K, N, xdt, wdt):
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((E, M, K)), xdt, dev)
    w = _t(rng.standard_normal((E, K, N)), wdt, dev)
    want = mm_ref.grouped_matmul_f32(x, w)
    before = launch_counts()["grouped_matmul_f32"]
    got = mm_ops.grouped_matmul_f32(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["grouped_matmul_f32"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (E, M, N)
    _close(got, want, **GEMM_TOL)


def _ragged(counts, K, N, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    E, T = len(counts), int(counts.sum())
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=dev)
    x = _t(rng.standard_normal((T + 5, K)), dtype, dev)  # 5 tail rows
    w = _t(rng.standard_normal((E, K, N)) * 0.2, dtype, dev)
    w2 = _t(rng.standard_normal((E, K, N)) * 0.2, dtype, dev)
    return x, w, w2, offs, T


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", RAGGED_COUNTS)
def test_ragged_kernels(dev, counts, dtype):
    x, w, w2, offs, T = _ragged(counts, 48, 64, dtype, dev)
    got = mm_ops.ragged_matmul_f32(x, w, offs)
    gate = mm_ops.ragged_gate_up_silu_f32(x, w, w2, offs)
    torch.cuda.synchronize()
    assert (got[T:] == 0).all() and all((g[T:] == 0).all() for g in gate)
    xc, wc, w2c, oc = x.cpu(), w.cpu(), w2.cpu(), offs.cpu()
    _close(got, mm_ref.ragged_matmul_f32(xc, wc, oc), **GEMM_TOL)
    for g, r in zip(gate, mm_ref.ragged_gate_up_silu_f32(xc, wc, w2c, oc)):
        _close(g, r, **GEMM_TOL)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", RAGGED_COUNTS + [[0, 0, 0]])
def test_ragged_dw_kernel(dev, counts, xdt):
    """(bf16 or fp32 x, fp32 g) as for dW_gate/dW_up, (fp32 h, fp32 dy) as
    for dW_down; NaN rows past offsets[E] never reach the sums."""
    x, _, _, offs, T = _ragged(counts, 48, 64, xdt, dev)
    g = _t(np.random.default_rng(1).standard_normal((x.shape[0], 40)), torch.float32, dev)
    x[T:], g[T:] = float("nan"), float("nan")
    before = launch_counts()["ragged_dw_f32"]
    got = mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    assert launch_counts()["ragged_dw_f32"] == before + 1
    assert got.shape == (len(counts), 48, 40) and torch.isfinite(got).all()
    for e, c in enumerate(counts):
        if c == 0:
            assert (got[e] == 0).all()
    _close(got, mm_ref.ragged_dw_f32(x.cpu(), g.cpu(), offs.cpu()), **GEMM_TOL)


@pytest.mark.parametrize("xdt,K,N", [(torch.bfloat16, 1536, 512), (torch.float32, 512, 1536)])
def test_ragged_dw_kernel_full_width(dev, xdt, K, N):
    """granite-moe-3b's training shapes: T*k = 8192 rows over 40 experts,
    x (8192, 1536) bf16 x g (8192, 512) fp32 and h (8192, 512) x dy
    (8192, 1536) fp32."""
    rng = np.random.default_rng(2)
    counts = rng.multinomial(8192, np.full(40, 1 / 40))
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                        device=dev)
    x = _t(rng.standard_normal((8192, K)), xdt, dev)
    g = _t(rng.standard_normal((8192, N)) * 0.01, torch.float32, dev)
    got = mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    _close(got, mm_ref.ragged_dw_f32(x, g, offs), **GEMM_TOL)


def test_ragged_ffn_grads_on_card_match_cpu(dev):
    x, w, w2, offs, T = _ragged([7, 0, 83, 1, 9], 32, 48, torch.float32, dev)
    wd = _t(np.random.default_rng(3).standard_normal((5, 48, 32)) * 0.2, torch.float32, dev)
    cot = _t(np.cos(np.arange(x.numel())).reshape(x.shape), torch.float32, dev)

    def grads(device):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (x, w, w2, wd)]
        y = mm_ops.ragged_ffn(leaves[0], leaves[1], leaves[2], leaves[3], offs.to(device))
        (y * cot.to(device)).sum().backward()
        return [t.grad for t in leaves]

    for name, a, b in zip(("dx", "dwu", "dwg", "dwd"), grads(dev), grads("cpu")):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_ragged_ffn_backward_never_reaches_plain(dev, no_plain):
    """RaggedFFN on CUDA tensors: one gate-up and one down launch forward,
    three ragged GEMMs and three dgrads backward, no plain version."""
    x, w, w2, offs, _ = _ragged([3, 0, 9], 32, 64, torch.bfloat16, dev)
    leaves = [t.requires_grad_(True) for t in (x, w, w2, w2.transpose(1, 2).contiguous())]
    before = launch_counts()
    y = mm_ops.ragged_ffn(leaves[0], leaves[1], leaves[2], leaves[3], offs)
    y.float().sum().backward()
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["ragged_gate_up_silu_f32"] == before["ragged_gate_up_silu_f32"] + 1
    assert after["ragged_matmul_f32"] == before["ragged_matmul_f32"] + 4
    assert after["ragged_dw_f32"] == before["ragged_dw_f32"] + 3
    assert all(t.grad is not None and t.grad.dtype == t.dtype for t in leaves)


def test_cuda_calls_never_reach_plain(dev, no_plain):
    x, w, w2, offs, _ = _ragged([3, 0, 9], 32, 64, torch.bfloat16, dev)
    before = launch_counts()
    mm_ops.ragged_ffn(x, w, w2, w2.transpose(1, 2).contiguous(), offs)
    mm_ops.grouped_ffn(x[None], w[:1], w2[:1], w2[:1].transpose(1, 2).contiguous())
    q = x[:8].reshape(1, 8, 4, 8).repeat(1, 1, 1, 2)
    fa_ops.flash_attention(q, q, q)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["ragged_gate_up_silu_f32"] == before["ragged_gate_up_silu_f32"] + 1
    assert after["ragged_matmul_f32"] == before["ragged_matmul_f32"] + 1
    assert after["grouped_matmul_f32"] == before["grouped_matmul_f32"] + 3
    assert after["flash_attention"] == before["flash_attention"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,s,d,window,cap",
    [(2, 4, 2, 128, 32, None, None), (1, 8, 8, 256, 64, 64, None),
     (2, 4, 1, 96, 16, None, 50.0), (1, 2, 2, 64, 128, 32, 30.0),
     (1, 24, 8, 100, 64, None, None), (1, 24, 8, 512, 64, None, None)],
)
def test_flash_attention_kernel(dev, b, hq, hkv, s, d, window, cap, dtype):
    rng = np.random.default_rng(1)
    # q/k/v as strided views of one fused projection, as a model makes them
    qkv = _t(rng.standard_normal((b, s, hq + 2 * hkv, d)), dtype, dev)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    before = launch_counts()["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, window=window, logit_softcap=cap)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = fa_ref.attention(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                            v.transpose(1, 2).float(), window=window,
                            softcap=cap).transpose(1, 2).to(dtype)
    assert got.dtype == dtype and got.shape == (b, s, hq, d)
    _close(got, want, **FA_TOL[dtype])


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros((2, 4, 8), device=dev)
    with pytest.raises(ValueError):
        mm_ops.grouped_matmul_f32(x, torch.zeros((2, 4, 8), device=dev))
    with pytest.raises(ValueError):
        mm_ops.grouped_matmul_f32(x.transpose(1, 2).contiguous().transpose(1, 2),
                                  torch.zeros((2, 8, 4), device=dev))
    with pytest.raises(ValueError):
        mm_ops.grouped_matmul_f32(x, torch.zeros((2, 8, 4)))  # mixed devices
    with pytest.raises(ValueError):
        mm_ops.ragged_matmul_f32(x[0], torch.zeros((2, 8, 4), device=dev),
                                 torch.zeros((3,), dtype=torch.int64, device=dev))
    q = torch.zeros((1, 8, 2, 24), device=dev)  # head_dim 24 unsupported
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)
