"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (from its fixture, never at import) when
no CUDA card is present.  The file imports no JAX, so on a machine with a
card it runs as ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py``.

Tolerances: the GEMM kernels (``ragged_dw_f32`` too) return fp32 sums of
the same exact products as the plain version (bf16 weights on the tensor
cores, fp32 x split there into three bf16 pieces whose products sum to
the fp32 product), so both dtypes are held at the reference's fp32 bound
(rtol 2e-5, atol 1.6e-4) — only the summation order differs.  ``RaggedFFN``'s gradients on the card against
the same function on the CPU, fp32: rtol = atol = 2e-5, the reference's
custom-VJP bound.
Flash attention computes its softmax in fp32 and rounds once to q's
dtype; for bf16 inputs P enters P.V as two bf16 pieces (hi + lo, 16
significant bits), so its rounding stays under the output's own bf16 step
(a single bf16 piece failed the bf16 bound at s = 512).  It is held
against its plain version run in fp32 on the same inputs and rounded once,
so bf16 outputs may differ by about one bf16 step (rtol 1e-2, atol 2e-3);
fp32 outputs are held at rtol 2e-5, atol 8e-5.
Each design counts its launches (``<wrapper>/tc``, ``/skinny``, ``/fma``);
bf16-weight calls must never reach ``/fma``.  ``ragged_dw_f32`` runs on the
tensor cores for every operand pair (``/tc``): fp32 operands as three bf16
pieces, an fp32 x fp32 pair as six products whose three dropped terms are
below 2^-24 of |x.g|, held at the same fp32 bound.
The fused ``ragged_gate_up_silu_f32`` runs the ragged GEMM's tile with gate
and up in one slab (``/tc``, ``/skinny``; fp32 weights ``/fma``), held at
the same fp32 bound, NaN rows past offsets[E] left 0.
``ssd_intra_chunk`` likewise computes in fp32 from its inputs' values and
rounds once: fp32 at the reference's atol 3e-5 (on inputs at the model's
scale: x dt-scaled, ~0.1; B and C ~0.5), bf16 against the plain version on
the same bf16 values rounded once, rtol 1e-2 (one bf16 step is at most
2^-7 relative) and atol 3e-5.  bf16 runs on the tensor cores (``/tc``:
C.B^T exact products, the decayed scores as three bf16 pieces that sum to
them exactly), with head-broadcast or per-head B and C; fp32 ``/fma``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels._build import dtype_code
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_gemm import ops as mm_ops
from repro_torch.kernels.moe_gemm import ref as mm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

pytestmark = pytest.mark.gpu
_ATTN = fa_ref.attention  # unpoisoned by ``no_plain``: the CPU side of a check
_RAGGED_MM, _RAGGED_DW = mm_ref.ragged_matmul_f32, mm_ref.ragged_dw_f32
_SSD = ssd_ref.ssd_intra_chunk

GEMM_TOL = dict(rtol=2e-5, atol=1.6e-4)
FA_TOL = {torch.float32: dict(rtol=2e-5, atol=8e-5),
          torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
SSD_TOL = {torch.float32: dict(rtol=0.0, atol=3e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=3e-5)}
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
                       (fa_ref, ("attention",)), (ssd_ref, ("ssd_intra_chunk",))):
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
    before = _designs("ragged_dw_f32")
    got = mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ragged_dw_f32")) == {"ragged_dw_f32": 1,
                                                         "ragged_dw_f32/tc": 1}
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
    assert after["ragged_matmul_f32/skinny"] == before["ragged_matmul_f32/skinny"] + 4  # 17 rows
    assert after["ragged_matmul_f32/fma"] == before["ragged_matmul_f32/fma"]
    assert after["ragged_dw_f32"] == before["ragged_dw_f32"] + 3
    assert after["ragged_dw_f32/tc"] == before["ragged_dw_f32/tc"] + 3
    assert all(t.grad is not None and t.grad.dtype == t.dtype for t in leaves)


def test_cuda_calls_never_reach_plain(dev, no_plain):
    x, w, w2, offs, _ = _ragged([3, 0, 9], 32, 64, torch.bfloat16, dev)
    before = launch_counts()
    mm_ops.ragged_ffn(x, w, w2, w2.transpose(1, 2).contiguous(), offs)
    mm_ops.grouped_ffn(x[None], w[:1], w2[:1], w2[:1].transpose(1, 2).contiguous())
    q = x[:8].reshape(1, 8, 4, 8).repeat(1, 1, 1, 2)
    fa_ops.flash_attention(q, q, q)
    ssd_ops.ssd_intra_chunk(*_ssd_inputs((1, 2, 16, 4, 16, 8), "decay", torch.bfloat16, dev))
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["ssd_intra_chunk"] == before["ssd_intra_chunk"] + 1
    assert after["ragged_gate_up_silu_f32"] == before["ragged_gate_up_silu_f32"] + 1
    assert after["ragged_matmul_f32"] == before["ragged_matmul_f32"] + 1
    assert after["ragged_matmul_f32/skinny"] == before["ragged_matmul_f32/skinny"] + 1
    assert after["grouped_matmul_f32"] == before["grouped_matmul_f32"] + 3
    assert after["grouped_matmul_f32/tc"] == before["grouped_matmul_f32/tc"] + 3  # M = 17
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention/tc"] == before["flash_attention/tc"] + 1
    for name in ("grouped_matmul_f32/fma", "ragged_matmul_f32/fma", "flash_attention/fma"):
        assert after[name] == before[name]


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


def _ssd_inputs(shape, law, dtype, dev, seed=0):
    """(x, dA, B, C) in the wrapper's (b, nc, cl, ...) layout at the model's
    scale, B and C as head-broadcast views (stride 0 on the head axis)."""
    b, nc, cl, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((b, nc, cl, h, p)) * 0.1, dtype, dev)
    dA = {"decay": -np.abs(rng.standard_normal((b, nc, cl, h))) * 0.1,
          "strong": -50.0 + rng.standard_normal((b, nc, cl, h)),
          "zero": np.zeros((b, nc, cl, h))}[law]
    B, C = (_t(rng.standard_normal((b, nc, cl, 1, n)) * 0.5, dtype, dev).expand(
        b, nc, cl, h, n) for _ in range(2))
    return x, _t(dA, torch.float32, dev), B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,law", [
    ((1, 2, 32, 4, 16, 8), "decay"), ((2, 2, 64, 8, 32, 16), "decay"),
    ((2, 3, 1, 4, 16, 8), "decay"), ((1, 2, 100, 4, 16, 16), "decay"),
    ((1, 2, 64, 4, 16, 8), "strong"), ((1, 2, 64, 4, 16, 8), "zero"),
    ((1, 1, 200, 2, 128, 256), "decay"),  # the widest p and n it takes
    ((4, 8, 256, 32, 64, 128), "decay"),  # mamba2-370m, 4 x 2048 prompt
    ((4, 1, 100, 32, 64, 128), "decay"),  # mamba2-370m, 100-token prompt
])
def test_ssd_intra_chunk_kernel(dev, shape, law, dtype):
    x, dA, B, C = _ssd_inputs(shape, law, dtype, dev)
    assert B.stride(3) == 0
    before = launch_counts()["ssd_intra_chunk"]
    got = ssd_ops.ssd_intra_chunk(x, dA, B, C)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_intra_chunk"] == before + 1
    fold = lambda t: t.flatten(0, 1).float()  # noqa: E731
    want = ssd_ref.ssd_intra_chunk(fold(x), fold(dA.to(dtype)), fold(B), fold(C))
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.isfinite(got).all()
    _close(got.flatten(0, 1), want.to(dtype), **SSD_TOL[dtype])


def test_mamba_prefill_and_decode_on_card_match_cpu(dev):
    """The reduced mamba2-370m, fp32: prefill (two chunks) and 4 decode
    steps on the card (the kernel, once per layer per prefill, never the
    plain version) against the same weights on the CPU (plain version):
    logits and every cache leaf at 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import LanguageModel, init_params, map_tree, tree_paths
    from repro_torch.training import make_decode_step, make_prefill_step

    arch = get_arch("mamba2-370m").reduced()
    lm = LanguageModel(arch)
    prefill, decode = make_prefill_step(lm, torch.float32), make_decode_step(lm, torch.float32)
    params = init_params(arch, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(1).integers(0, arch.vocab_size, (2, 68))

    def run(p):
        logits, cache = prefill(p, {"tokens": toks[:, :64]})
        out = [logits]
        for i in range(64, 68):
            logits, cache = decode(p, cache, {"tokens": toks[:, i:i + 1]}, i)
            out.append(logits)
        return out, cache

    want, want_cache = run(params)
    before = launch_counts()["ssd_intra_chunk"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssd_ref, "ssd_intra_chunk", lambda *a: pytest.fail("plain version"))
        got, got_cache = run(map_tree(lambda t: t.to(dev), params))
        torch.cuda.synchronize()
    assert launch_counts()["ssd_intra_chunk"] == before + arch.num_layers
    for a, b in zip(got, want):
        _close(a, b, rtol=0, atol=1e-5)
    want_cache = tree_paths(want_cache)
    for path, t in tree_paths(got_cache).items():
        _close(t, want_cache[path], rtol=0, atol=1e-5)


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
    x, dA, B, C = _ssd_inputs((1, 1, 300, 2, 16, 8), "decay", torch.float32, dev)
    with pytest.raises(ValueError):  # a chunk longer than 256
        ssd_ops.ssd_intra_chunk(x, dA, B, C)
    x, dA, B, C = _ssd_inputs((1, 1, 64, 2, 16, 8), "decay", torch.float32, dev)
    B2 = torch.zeros((1, 1, 64, 2, 16), device=dev)[..., ::2]
    with pytest.raises(ValueError):  # n not contiguous
        ssd_ops.ssd_intra_chunk(x, dA, B2, B2)


def _designs(name):
    c = launch_counts()
    return {k: v for k, v in c.items() if k == name or k.startswith(name + "/")}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 3, 16, 17, 64, 100, 128])
@pytest.mark.parametrize("K,N", [(96, 56), (1536, 512), (512, 1536)])
def test_grouped_matmul_tensor_core_designs(dev, M, K, N, xdt, no_plain):
    """bf16 weights with bf16 x (gate/up) or fp32 x (down, three bf16
    pieces): the skinny design for M <= 16, the tile design above, never
    the fma kernel; at the reference's fp32 bound against the fp32 product
    on the CPU, including ragged M, N = 56 and K = 96 edges."""
    rng = np.random.default_rng(M)
    E = 5
    x = _t(rng.standard_normal((E, M, K)), xdt, dev)
    w = _t(rng.standard_normal((E, K, N)) * K ** -0.5, torch.bfloat16, dev)
    before = _designs("grouped_matmul_f32")
    got = mm_ops.grouped_matmul_f32(x, w)
    torch.cuda.synchronize()
    kind = "skinny" if M <= 16 else "tc"
    assert _delta(before, _designs("grouped_matmul_f32")) == {
        "grouped_matmul_f32": 1, "grouped_matmul_f32/tc": int(kind == "tc"),
        "grouped_matmul_f32/skinny": int(kind == "skinny"), "grouped_matmul_f32/fma": 0}
    want = torch.bmm(x.cpu().float(), w.cpu().float())
    assert got.dtype == torch.float32 and got.shape == (E, M, N)
    _close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (8, 2)])
@pytest.mark.parametrize("s,window,cap", [(100, None, None), (130, 40, None),
                                          (64, None, 30.0), (200, 64, 50.0)])
def test_flash_attention_tensor_core_design(dev, d, hq, hkv, s, window, cap, no_plain):
    """bf16 through the tensor-core kernel at every head dim, GQA 1, 3 and
    4, ragged lengths, window and softcap, the inputs strided views of one
    fused projection; never the fma kernel."""
    rng = np.random.default_rng(d + hq + s)
    qkv = _t(rng.standard_normal((2, s, hq + 2 * hkv, d)), torch.bfloat16, dev)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    before = _designs("flash_attention")
    got = fa_ops.flash_attention(q, k, v, window=window, logit_softcap=cap)
    torch.cuda.synchronize()
    assert _delta(before, _designs("flash_attention")) == {
        "flash_attention": 1, "flash_attention/tc": 1, "flash_attention/fma": 0}
    f = lambda t: t.transpose(1, 2).float().cpu()  # noqa: E731
    want = _ATTN(f(q), f(k), f(v), window=window, softcap=cap).transpose(1, 2)
    _close(got, want.to(torch.bfloat16), **FA_TOL[torch.bfloat16])


def test_fp32_calls_take_the_fma_designs(dev):
    x = torch.randn((3, 20, 32), device=dev)
    w = torch.randn((3, 32, 24), device=dev)
    q = torch.randn((1, 40, 2, 32), device=dev)
    offs = torch.tensor([0, 20, 20, 60], dtype=torch.int32, device=dev)
    before = launch_counts()
    mm_ops.grouped_matmul_f32(x, w)
    mm_ops.grouped_matmul_f32(x.to(torch.bfloat16), w)  # bf16 x, fp32 w
    mm_ops.ragged_matmul_f32(x.reshape(60, 32), w, offs)
    mm_ops.ragged_matmul_f32(x.reshape(60, 32).to(torch.bfloat16), w, offs)
    fa_ops.flash_attention(q, q, q)
    torch.cuda.synchronize()
    d = _delta(before, launch_counts())
    assert d["grouped_matmul_f32/fma"] == d["grouped_matmul_f32"] == 2
    assert d["ragged_matmul_f32/fma"] == d["ragged_matmul_f32"] == 2
    assert d["flash_attention/fma"] == d["flash_attention"] == 1
    assert d["grouped_matmul_f32/tc"] == d["grouped_matmul_f32/skinny"] == 0
    assert d["ragged_matmul_f32/tc"] == d["ragged_matmul_f32/skinny"] == 0
    assert d["flash_attention/tc"] == 0


def test_refused_launch_raises_and_never_returns_the_plain_result(dev, no_plain):
    """A shape the wrappers accept but the card refuses (grid.z = 70000
    experts or batch rows > 65535): the C entry returns the launch error
    and the wrapper raises; no plain version runs."""
    for xdt in (torch.bfloat16, torch.float32):
        x = torch.zeros((70000, 1, 8), dtype=xdt, device=dev)
        w = torch.zeros((70000, 8, 8), dtype=torch.bfloat16, device=dev)
        with pytest.raises(RuntimeError, match="launch failed"):
            mm_ops.grouped_matmul_f32(x, w)
    q = torch.zeros((70000, 1, 1, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa_ops.flash_attention(q, q, q)
    offs = torch.zeros((70001,), dtype=torch.int32, device=dev)  # 70000 experts
    with pytest.raises(RuntimeError, match="launch failed"):
        mm_ops.ragged_dw_f32(torch.zeros((1, 8), dtype=torch.bfloat16, device=dev),
                             torch.zeros((1, 8), device=dev), offs)
    torch.cuda.synchronize()


@pytest.mark.parametrize("xdt,tile", [(torch.float32, "Tile128"), (torch.float32, "Tile64"),
                                      (torch.bfloat16, "Tile64Split"), (torch.bfloat16, None)])
def test_grouped_tile_not_built_for_x_dtype_is_refused(dev, xdt, tile, no_plain):
    """The tensor-core entry point launches only the tiles built for x's
    dtype; another tile code (or one past the last) returns an error, and
    the launch raises."""
    x = torch.zeros((2, 32, 64), dtype=xdt, device=dev)
    w = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=dev)
    out = torch.empty((2, 32, 64), device=dev)
    code = len(mm_ops.TILES) if tile is None else mm_ops.TILES.index(tile)
    with pytest.raises(RuntimeError, match="launch failed"):
        mm_ops._GROUPED["tc"](x, dtype_code("x", x), w, out, 2, 32, 64, 64, code)


@pytest.mark.parametrize("xdt,tile", [(torch.bfloat16, "Tile128"), (torch.float32, "Tile64"),
                                      (torch.bfloat16, "Tile64Split"), (torch.bfloat16, None)])
def test_ragged_tile_not_built_is_refused(dev, xdt, tile, no_plain):
    """The ragged tensor-core entry launches only the tiles ``ragged_tile``
    can pick for x's dtype (no Tile128); another code returns an error, and
    the launch raises."""
    x = torch.zeros((32, 64), dtype=xdt, device=dev)
    w = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=dev)
    offs = torch.tensor([0, 16, 32], dtype=torch.int32, device=dev)
    G, (tm, gr, vl) = mm_ops._work_table(offs, 32, 2, 64)
    out = torch.zeros((32, 64), device=dev)
    code = len(mm_ops.TILES) if tile is None else mm_ops.TILES.index(tile)
    with pytest.raises(RuntimeError, match="launch failed"):
        mm_ops._RAGGED["tc"](x, dtype_code("x", x), w, offs, tm, gr, vl, out, 32, 64, 64, G,
                             code)


def test_tensor_core_wrappers_refuse_unaligned_rows(dev):
    x = torch.zeros((2, 4, 12), dtype=torch.bfloat16, device=dev)  # K = 12: 24-byte rows
    with pytest.raises(ValueError, match="aligned"):
        mm_ops.grouped_matmul_f32(x, torch.zeros((2, 12, 8), dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="aligned"):  # N = 12
        mm_ops.grouped_matmul_f32(torch.zeros((2, 4, 8), dtype=torch.bfloat16, device=dev),
                                  torch.zeros((2, 8, 12), dtype=torch.bfloat16, device=dev))
    base = torch.zeros((1, 8, 2, 24), dtype=torch.bfloat16, device=dev)
    q = base[..., 1:17]  # d = 16, rows start 2 bytes into the allocation
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q, q, q)
    # the ragged tensor-core designs: refused before any launch, no fallback
    offs = torch.tensor([0, 30, 60], dtype=torch.int32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    before = launch_counts()
    for x, w in ((torch.zeros((60, 12), **bf), torch.zeros((2, 12, 8), **bf)),  # K = 12
                 (torch.zeros((60, 6), device=dev), torch.zeros((2, 6, 8), **bf)),  # fp32, K = 6
                 (torch.zeros((60, 8), **bf), torch.zeros((2, 8, 12), **bf))):  # N = 12
        with pytest.raises(ValueError, match="aligned"):
            mm_ops.ragged_matmul_f32(x, w, offs)
    for x, g in ((torch.zeros((60, 12), **bf), torch.zeros((60, 8), device=dev)),  # K = 12
                 (torch.zeros((60, 8), device=dev), torch.zeros((60, 6), device=dev)),  # N = 6
                 (torch.zeros(481, device=dev)[1:].view(60, 8),  # 4 bytes off
                  torch.zeros((60, 8), device=dev))):
        with pytest.raises(ValueError, match="aligned"):
            mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    assert _delta(before, launch_counts()) == {k: 0 for k in before}


def _routed(T, E, dev, seed):
    """Expert offsets of T rows spread over E experts at random."""
    counts = np.random.default_rng(seed).multinomial(T, np.full(E, 1 / E))
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                        device=dev)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512)])
@pytest.mark.parametrize("T", [32, 4096, 8192])
def test_ragged_matmul_tensor_core_designs(dev, T, K, N, xdt, no_plain):
    """granite-moe-3b's ragged GEMMs at full width (40 experts, d = 1536,
    d_ff = 512): decode (T = 32) through /skinny, prefill (4096) and the
    training step (8192) through /tc, bf16 rows or fp32 rows in three
    pieces against bf16 weights; 5 tail rows come back 0."""
    offs = _routed(T, 40, dev, T + K)
    rng = np.random.default_rng(T)
    x = _t(rng.standard_normal((T + 5, K)), xdt, dev)
    w = _t(rng.standard_normal((40, K, N)) * K ** -0.5, torch.bfloat16, dev)
    kind = mm_ops.ragged_design(xdt, torch.bfloat16, (T + 5) / 40)
    assert kind == ("skinny" if T == 32 else "tc")
    before = _designs("ragged_matmul_f32")
    got = mm_ops.ragged_matmul_f32(x, w, offs)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ragged_matmul_f32")) == {
        "ragged_matmul_f32": 1, "ragged_matmul_f32/tc": int(kind == "tc"),
        "ragged_matmul_f32/skinny": int(kind == "skinny"), "ragged_matmul_f32/fma": 0}
    assert got.shape == (T + 5, N) and (got[T:] == 0).all()
    _close(got, _RAGGED_MM(x, w, offs), **GEMM_TOL)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("counts", RAGGED_COUNTS + [[0, 0, 0, 3], [130, 0, 1]])
def test_ragged_matmul_tensor_core_designs_at_edge_counts(dev, counts, xdt, no_plain):
    """Empty experts, one expert, straddled tiles and skew, both bf16-weight
    designs (skinny at <= 16 rows an expert), the ragged N = 56 edge."""
    x, _, _, offs, T = _ragged(counts, 48, 56, xdt, dev)
    w = _t(np.random.default_rng(5).standard_normal((len(counts), 48, 56)) * 0.2,
           torch.bfloat16, dev)
    kind = mm_ops.ragged_design(xdt, torch.bfloat16, x.shape[0] / len(counts))
    before = _designs("ragged_matmul_f32")
    got = mm_ops.ragged_matmul_f32(x, w, offs)
    torch.cuda.synchronize()
    d = _delta(before, _designs("ragged_matmul_f32"))
    assert d["ragged_matmul_f32"] == d[f"ragged_matmul_f32/{kind}"] == 1
    assert d["ragged_matmul_f32/fma"] == 0 and (got[T:] == 0).all()
    _close(got, _RAGGED_MM(x, w, offs), **GEMM_TOL)


@pytest.mark.parametrize("xdt,gdt,K,N", [(torch.bfloat16, torch.float32, 1536, 512),
                                         (torch.float32, torch.float32, 512, 1536)])
@pytest.mark.parametrize("T", [32, 4096, 8192])
def test_ragged_dw_tensor_core_design(dev, T, xdt, gdt, K, N, no_plain):
    """The dgrad's two pairs of the training backward at full width (bf16 x
    with fp32 da for dW_gate / dW_up, fp32 h with fp32 dy for dW_down), 40
    experts, NaN tail rows never read, empty experts zero."""
    offs = _routed(T, 40, dev, T + N)
    rng = np.random.default_rng(T + K)
    x = _t(rng.standard_normal((T + 5, K)), xdt, dev)
    g = _t(rng.standard_normal((T + 5, N)) * 0.01, gdt, dev)
    x[T:], g[T:] = float("nan"), float("nan")
    before = _designs("ragged_dw_f32")
    got = mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ragged_dw_f32")) == {"ragged_dw_f32": 1,
                                                         "ragged_dw_f32/tc": 1}
    assert got.shape == (40, K, N) and torch.isfinite(got).all()
    empty = (offs[1:] == offs[:-1]).nonzero().flatten().tolist()
    assert all((got[e] == 0).all() for e in empty)
    _close(got, _RAGGED_DW(x, g, offs), **GEMM_TOL)


@pytest.mark.parametrize("xdt,gdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("counts", RAGGED_COUNTS + [[0, 0, 0]])
def test_ragged_dw_tensor_core_pairs_at_edge_counts(dev, counts, xdt, gdt, no_plain):
    """The other operand pairs (one or three products) at the edge counts,
    with NaN tail rows and a 40-wide g."""
    x, _, _, offs, T = _ragged(counts, 48, 64, xdt, dev)
    g = _t(np.random.default_rng(7).standard_normal((x.shape[0], 40)), gdt, dev)
    x[T:], g[T:] = float("nan"), float("nan")
    before = _designs("ragged_dw_f32")
    got = mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ragged_dw_f32"))["ragged_dw_f32/tc"] == 1
    assert torch.isfinite(got).all()
    _close(got, _RAGGED_DW(x, g, offs), **GEMM_TOL)


GATE_UP_COUNTS = RAGGED_COUNTS + [[0, 0, 0, 3], [130, 0, 1]]


def _gate_up_case(counts, K, F, xdt, wdt, dev, seed=0):
    """x with 5 NaN tail rows past offsets[E], bf16-scaled gate and up."""
    x, _, _, offs, T = _ragged(counts, K, F, xdt, dev, seed)
    x[T:] = float("nan")
    rng = np.random.default_rng(seed + 11)
    wg, wu = (_t(rng.standard_normal((len(counts), K, F)) * K ** -0.5, wdt, dev)
              for _ in range(2))
    return x, wg, wu, offs, T


def _check_gate_up(got, x, wg, wu, offs, T):
    """(h, a_g, a_u) against the plain product of the rows inside the
    experts; rows past offsets[E] exactly 0."""
    assert all(t.shape == (x.shape[0], wg.shape[2]) and t.dtype == torch.float32 for t in got)
    assert all((t[T:] == 0).all() and torch.isfinite(t).all() for t in got)
    a_g, a_u = _RAGGED_MM(x[:T], wg, offs), _RAGGED_MM(x[:T], wu, offs)
    for name, a, b in zip(("h", "a_g", "a_u"), got, (torch.nn.functional.silu(a_g) * a_u,
                                                     a_g, a_u)):
        _close(a[:T], b, err_msg=name, **GEMM_TOL)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["tc", "skinny"])
@pytest.mark.parametrize("K,F", [(48, 56), (48, 512), (1536, 56), (1536, 512)])
@pytest.mark.parametrize("counts", GATE_UP_COUNTS)
def test_gate_up_tensor_core_designs(dev, counts, K, F, kind, xdt, no_plain):
    """Each tensor-core design of the fused gate-up-SiLU over the edge counts
    (launched through its C entry at its tile, whatever rows per expert the
    router would see), the F = 56 column edge, K = 1536 (granite's d), NaN
    tail rows never read and left 0; at the GEMMs' fp32 bound."""
    x, wg, wu, offs, T = _gate_up_case(counts, K, F, xdt, torch.bfloat16, dev)
    tile = "Skinny" if kind == "skinny" else mm_ops.ragged_tile(xdt, 100)
    G, table = mm_ops._work_table(offs, x.shape[0], len(counts), mm_ops.TILE_ROWS[tile])
    outs = tuple(torch.zeros((x.shape[0], F), device=dev) for _ in range(3))
    before = _designs("ragged_gate_up_silu_f32")
    mm_ops._GATE_UP[kind](x, dtype_code("x", x), wg, wu, offs, *table, *outs, x.shape[0], K, F,
                          G, mm_ops.TILES.index(tile))
    torch.cuda.synchronize()
    d = _delta(before, _designs("ragged_gate_up_silu_f32"))
    assert d["ragged_gate_up_silu_f32"] == d[f"ragged_gate_up_silu_f32/{kind}"] == 1
    _check_gate_up(outs, x, wg, wu, offs, T)


@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("counts", GATE_UP_COUNTS)
def test_gate_up_wrapper_routes_by_dtype_and_rows(dev, counts, xdt, wdt, no_plain):
    """The wrapper's design: bf16 weights /skinny at <= 16 rows an expert and
    /tc above, fp32 weights /fma; one launch, counted under its design."""
    x, wg, wu, offs, T = _gate_up_case(counts, 48, 56, xdt, wdt, dev, seed=1)
    kind = mm_ops.ragged_design(xdt, wdt, x.shape[0] / len(counts))
    assert kind == ("fma" if wdt == torch.float32
                    else "skinny" if x.shape[0] / len(counts) <= 16 else "tc")
    before = _designs("ragged_gate_up_silu_f32")
    got = mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ragged_gate_up_silu_f32")) == {
        "ragged_gate_up_silu_f32": 1,
        **{f"ragged_gate_up_silu_f32/{k}": int(k == kind) for k in ("tc", "skinny", "fma")}}
    _check_gate_up(got, x, wg, wu, offs, T)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [32, 4096, 8192])
def test_gate_up_full_width(dev, T, xdt, no_plain):
    """granite-moe-3b's gate-up at full width (40 experts, d = 1536, d_ff =
    512): decode (T = 32) through /skinny, prefill (4096) and the training
    step (8192) through /tc, bf16 rows or fp32 rows in three pieces."""
    offs = _routed(T, 40, dev, T + 3)
    rng = np.random.default_rng(T + 1)
    x = _t(rng.standard_normal((T + 5, 1536)), xdt, dev)
    x[T:] = float("nan")
    wg, wu = (_t(rng.standard_normal((40, 1536, 512)) * 1536 ** -0.5, torch.bfloat16, dev)
              for _ in range(2))
    kind = mm_ops.ragged_design(xdt, torch.bfloat16, (T + 5) / 40)
    assert kind == ("skinny" if T == 32 else "tc")
    before = _designs("ragged_gate_up_silu_f32")
    got = mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ragged_gate_up_silu_f32"))[
        f"ragged_gate_up_silu_f32/{kind}"] == 1
    _check_gate_up(got, x, wg, wu, offs, T)


@pytest.mark.parametrize("xdt,tile", [(torch.bfloat16, "Tile128"), (torch.float32, "Tile64"),
                                      (torch.bfloat16, "Tile64Split"), (torch.bfloat16, None)])
def test_gate_up_tile_not_built_is_refused(dev, xdt, tile, no_plain):
    """The gate-up tensor-core entry takes the ragged tiles only; another
    code returns an error, and the launch raises."""
    x = torch.zeros((32, 64), dtype=xdt, device=dev)
    w = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=dev)
    offs = torch.tensor([0, 16, 32], dtype=torch.int32, device=dev)
    G, table = mm_ops._work_table(offs, 32, 2, 64)
    outs = [torch.zeros((32, 64), device=dev) for _ in range(3)]
    code = len(mm_ops.TILES) if tile is None else mm_ops.TILES.index(tile)
    with pytest.raises(RuntimeError, match="launch failed"):
        mm_ops._GATE_UP["tc"](x, dtype_code("x", x), w, w, offs, *table, *outs, 32, 64, 64, G,
                              code)


def _ssd_per_head(shape, dtype, dev, seed=0):
    """(x, dA, B, C) with B and C per head (contiguous, head stride n), as
    several B/C groups give them after ``repeat_interleave``."""
    x, dA, B, C = _ssd_inputs(shape, "decay", dtype, dev, seed)
    rng = np.random.default_rng(seed + 5)
    B, C = (_t(rng.standard_normal(B.shape) * 0.5, dtype, dev) for _ in range(2))
    return x, dA, B, C


@pytest.mark.parametrize("bc", ["broadcast", "per-head"])
@pytest.mark.parametrize("shape,law", [
    ((1, 2, 32, 4, 16, 8), "decay"), ((2, 2, 64, 8, 32, 16), "decay"),
    ((2, 3, 1, 4, 16, 8), "decay"), ((1, 2, 100, 4, 16, 16), "decay"),
    ((1, 2, 64, 32, 64, 128), "strong"), ((1, 2, 64, 4, 16, 8), "zero"),
    ((1, 1, 200, 2, 128, 256), "decay"),
    ((4, 8, 256, 32, 64, 128), "decay"),  # mamba2-370m, 4 x 2048 prompt
    ((4, 1, 100, 32, 64, 128), "decay"),  # 4 x 100
    ((1, 1, 200, 32, 64, 128), "decay"),  # 1 x 200
])
def test_ssd_intra_chunk_tensor_core_design(dev, shape, law, bc, no_plain):
    """bf16 through /tc, with head-broadcast B and C (C.B^T shared by the
    block's heads) and with per-head B and C (one head a block); never the
    fma kernel; at SSD_TOL against the plain version on the same values."""
    if bc == "broadcast":
        x, dA, B, C = _ssd_inputs(shape, law, torch.bfloat16, dev)
        assert B.stride(3) == 0 and C.stride(3) == 0
    else:
        x, dA, B, C = _ssd_per_head(shape, torch.bfloat16, dev)
        if law != "decay":
            dA = _ssd_inputs(shape, law, torch.bfloat16, dev)[1]
    b, nc, cl, h, p = x.shape
    if bc == "per-head":
        assert ssd_ops.heads_per_block(b * nc, cl, h, p, False) == 1
    before = _designs("ssd_intra_chunk")
    got = ssd_ops.ssd_intra_chunk(x, dA, B, C)
    torch.cuda.synchronize()
    assert _delta(before, _designs("ssd_intra_chunk")) == {
        "ssd_intra_chunk": 1, "ssd_intra_chunk/tc": 1, "ssd_intra_chunk/fma": 0}
    fold = lambda t: t.flatten(0, 1).float()  # noqa: E731
    want = _SSD(fold(x), fold(dA.to(torch.bfloat16)), fold(B), fold(C))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape and torch.isfinite(got).all()
    _close(got.flatten(0, 1), want.to(torch.bfloat16), **SSD_TOL[torch.bfloat16])


def test_fp32_gate_up_and_ssd_take_the_fma_designs(dev, no_plain):
    x, wg, wu, offs, _ = _gate_up_case([20, 0, 40], 32, 24, torch.float32, torch.float32, dev)
    before = launch_counts()
    mm_ops.ragged_gate_up_silu_f32(x, wg, wu, offs)
    ssd_ops.ssd_intra_chunk(*_ssd_inputs((1, 2, 32, 4, 16, 8), "decay", torch.float32, dev))
    torch.cuda.synchronize()
    d = _delta(before, launch_counts())
    assert d["ragged_gate_up_silu_f32"] == d["ragged_gate_up_silu_f32/fma"] == 1
    assert d["ssd_intra_chunk"] == d["ssd_intra_chunk/fma"] == 1
    assert d["ssd_intra_chunk/tc"] == d["ragged_gate_up_silu_f32/tc"] == 0


def test_ssd_tensor_core_refuses_unaligned_rows(dev, no_plain):
    """bf16 with p or n not a multiple of 8: refused before any launch."""
    before = launch_counts()
    for shape in ((1, 1, 32, 2, 12, 8), (1, 1, 32, 2, 16, 12)):
        with pytest.raises(ValueError, match="aligned"):
            ssd_ops.ssd_intra_chunk(*_ssd_inputs(shape, "decay", torch.bfloat16, dev))
    torch.cuda.synchronize()
    assert _delta(before, launch_counts()) == {k: 0 for k in before}


def test_checkpoint_fallback_restores_bit_exact_on_the_card(dev, no_plain, tmp_path):
    """Full-width granite-moe-3b-a800m at depth 2 on the card: two trained
    steps checkpointed after each (the second async), a flipped byte in
    the newest checkpoint, then a restore into a state from another seed:
    the corrupt checkpoint is quarantined, the restore falls back to step
    1, and the live state's CRC32s equal that manifest's."""
    import dataclasses
    import json

    from repro_torch.checkpoint import checkpoint_steps, leaf_crc32s
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel, tree_paths
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training import init_state

    arch = get_arch("granite-moe-3b-a800m").replace(num_layers=2)
    arch = arch.replace(moe=dataclasses.replace(arch.moe, dispatch="ragged"))
    lm = LanguageModel(arch)

    def trainer():
        return Trainer(lm, OptimizerConfig(total_steps=2),
                       TrainerConfig(total_steps=2, checkpoint_dir=str(tmp_path),
                                     checkpoint_every=1, checkpoint_keep=2, log_every=1000),
                       log_fn=lambda m: None)

    out = trainer().fit(init_state(lm, torch.Generator(device=dev).manual_seed(0), dev),
                        SyntheticTokens(arch.vocab_size, 2, 512))
    assert out["last_step"] == 1 and checkpoint_steps(tmp_path) == [1, 2]
    del out
    with open(tmp_path / "step_00000002" / "params.embed.npy", "r+b") as f:
        f.seek(-1000, 2)
        b = f.read(1)
        f.seek(-1000, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    state = init_state(lm, torch.Generator(device=dev).manual_seed(1), dev)
    ptr = state["params"]["embed"].data_ptr()
    state, step = trainer().ckpt.restore_latest(state)
    assert step == 1 and state["params"]["embed"].data_ptr() == ptr
    assert state["params"]["embed"].device.type == "cuda" and state["step"].device.type == "cpu"
    assert (tmp_path / "step_00000002.corrupt" / "QUARANTINE_REASON").exists()
    assert checkpoint_steps(tmp_path) == [1]
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert leaf_crc32s(state) == manifest["crc32"]
    assert int(state["step"]) == 1 and set(manifest["keys"]) == set(tree_paths(state))


def _ep_receiver(rng, dev, E=20, occupied=4096, tail=8192, K=1536):
    """An expert-parallel receiver buffer at granite's widths and EP = 2:
    E_l = 20 local experts (some empty) over ``occupied`` expert-sorted
    rows, then a sentinel tail longer than them (NaN: never read)."""
    counts = rng.multinomial(occupied, rng.dirichlet(np.ones(E)))
    counts[[3, 11]] = 0
    counts[0] += occupied - counts.sum()
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                        device=dev)
    x = _t(rng.standard_normal((occupied + tail, K)), torch.float32, dev)
    x[occupied:] = float("nan")
    return x, offs, occupied


def test_ragged_ffn_ep_receiver_with_sentinel_tail(dev, no_plain):
    """``ragged_ffn`` as the EP layer calls it: 20 local experts, bf16
    weights, fp32 rows with a NaN sentinel tail twice the occupied rows;
    the output and dx against plain products (GEMM_TOL), the tail's output
    and dx exactly 0.  (The weight gradients are ``ragged_dw_f32``'s, cast
    to bf16: held below.)"""
    rng = np.random.default_rng(5)
    x, offs, T = _ep_receiver(rng, dev)
    wu, wg = (_t(rng.standard_normal((20, 1536, 512)) * 0.03, torch.bfloat16, dev)
              for _ in range(2))
    wd = _t(rng.standard_normal((20, 512, 1536)) * 0.05, torch.bfloat16, dev)
    cot = _t(rng.standard_normal((x.shape[0], 1536)), torch.float32, dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, wu, wg, wd)]
    y = mm_ops.ragged_ffn(leaves[0], leaves[1], leaves[2], leaves[3], offs)
    (y * cot).sum().backward()
    assert (y[T:] == 0).all() and (leaves[0].grad[T:] == 0).all()
    xs, c = x[:T].cpu(), cot[:T].cpu()
    plain = [t.detach().cpu().float().requires_grad_(True) for t in (xs, wu, wg, wd)]
    o = offs.cpu()
    a_g, a_u = (torch.cat([plain[0][o[e]:o[e + 1]] @ w[e] for e in range(20)])
                for w in (plain[2], plain[1]))
    want = torch.cat([(torch.nn.functional.silu(a_g) * a_u)[o[e]:o[e + 1]] @ plain[3][e]
                      for e in range(20)])
    (want * c).sum().backward()
    _close(y[:T].detach(), want.detach(), **GEMM_TOL)
    _close(leaves[0].grad[:T], plain[0].grad, **GEMM_TOL)


def test_ragged_dw_ep_receiver(dev):
    """``ragged_dw_f32`` over 20 local experts (two empty) with a NaN
    sentinel tail: against the plain version, zeros for empty experts."""
    rng = np.random.default_rng(6)
    x, offs, T = _ep_receiver(rng, dev)
    x = x.to(torch.bfloat16)
    g = _t(rng.standard_normal((x.shape[0], 512)) * 0.01, torch.float32, dev)
    g[T:] = float("nan")
    before = launch_counts()["ragged_dw_f32/tc"]
    got = mm_ops.ragged_dw_f32(x, g, offs)
    torch.cuda.synchronize()
    assert launch_counts()["ragged_dw_f32/tc"] == before + 1
    assert (got[3] == 0).all() and (got[11] == 0).all()
    _close(got, _RAGGED_DW(x[:T].cpu(), g[:T].cpu(), offs.cpu()), **GEMM_TOL)
