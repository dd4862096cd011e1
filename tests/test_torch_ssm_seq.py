"""The Mamba2 mixer across sequence slices against the JAX package.

Under the reference's "seq" layout a rank holds a slice of the sequence;
the port's mixer convolves and scans only that slice and hands the state
from rank to rank (``repro_torch.models.ssm``: :func:`conv_halo`,
:func:`slice_terms`, :func:`slice_state`, :func:`carry_states`,
:func:`slice_output`).  Here
n slices run in one process through those functions, with a shift along
a leading rank dim in place of ``sharding.seq_shift``, from numpy inputs
made from a seed, in fp32:

* **The scan.** Each slice's y and the last slice's end state against the
  reference's ``repro.models.ssm.ssd_chunked`` (``use_pallas=False``) over
  the whole sequence, within 1e-5 x max(1, max |.|); the gradients of a
  seeded weighted sum of both with respect to x, dt, A_log, B and C
  against ``jax.grad`` of it, within 1e-4 x max(1, max |.|).  n in {1, 2,
  4, 8}; slices of one chunk, three, half a chunk, and one and a half
  (padded with dt = 0 rows to two); B/C groups 1 and 2; the head-group
  path (8 heads in groups of 4).  The reference runs the whole sequence as
  one chunk.
* **The conv halo.** Each slice convolved after its ``conv_width - 1``
  halo rows against the reference's ``_causal_conv`` over the whole
  sequence, exactly as close as fp32 allows (1e-6), at slices of 1 and 2
  rows (their halo crosses several ranks), 5 and 16.
* **The collectives, counted.** Reduced mamba2's prefill traced on a fake
  group (``launch.dryrun``) at a sequence group of 2 and 4: a Mamba layer
  makes ceil(log2 n) + 2 hand-off rounds (the scan's, the shift of the
  state into the slice, the halo) that send 2 ceil(log2 n) + 2 tensors
  from the first rank as collective-permutes, and one broadcast of the
  cache; doubling the sequence leaves the all-gather and hand-off wire
  bytes as they were.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import ssm

CHUNK, B_, H, P, N = 16, 2, 4, 8, 8
Y_TOL, GRAD_TOL, CONV_TOL = 1e-5, 1e-4, 1e-6
# Slice lengths: one chunk, several, fewer positions than a chunk, and a
# length above the chunk that is not a multiple of it.
SLICES = {"one_chunk": CHUNK, "three_chunks": 3 * CHUNK, "half_chunk": CHUNK // 2,
          "chunk_and_a_half": 3 * CHUNK // 2}


def local_shift(n):
    """``sharding.seq_shift`` along dim 0 of tensors stacked over n ranks."""
    def shift(ts, k, fills=None):
        fills = [0.0] * len(ts) if fills is None else fills
        out = []
        for t, f in zip(ts, fills):
            pad = torch.full_like(t[:min(k, n)], f)
            out.append(torch.cat([pad, t[:n - k]]) if k < n else pad)
        return out
    return shift


def inputs(L, g, h, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B_, L, h, P)).astype(np.float32),
            "dt": rng.uniform(0.05, 0.6, (B_, L, h)).astype(np.float32),
            "A_log": rng.uniform(-1.0, 1.0, (h,)).astype(np.float32),
            "B": (0.5 * rng.standard_normal((B_, L, g, N))).astype(np.float32),
            "C": (0.5 * rng.standard_normal((B_, L, g, N))).astype(np.float32),
            "wy": rng.standard_normal((B_, L, h, P)).astype(np.float32),
            "wf": rng.standard_normal((B_, h, P, N)).astype(np.float32)}


@functools.partial(jax.jit, static_argnums=(0, 1))
def _reference(cl, head_group, x, dt, A_log, B, C, wy, wf):
    def f(x, dt, A_log, B, C):
        y, fin = jssm.ssd_chunked(x, dt, -jnp.exp(A_log), B, C, cl, use_pallas=False,
                                  head_group=head_group)
        return jnp.sum(y * wy) + jnp.sum(fin * wf), (y, fin)

    return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True)(x, dt, A_log, B, C)


def reference(arr, L, head_group):
    """y, the final state and the gradients of the reference's scan of the
    whole sequence as one chunk: its quadratic form, which shares no chunk
    boundary with the slices."""
    (_, (y, fin)), grads = _reference(L, head_group, *(
        jnp.asarray(arr[k]) for k in ("x", "dt", "A_log", "B", "C", "wy", "wf")))
    return np.asarray(y), np.asarray(fin), [np.asarray(v) for v in grads]


def port(arr, n, l, head_group, train):
    """The same through n slices of l positions: (y, the last slice's end
    state, the gradients or None)."""
    leaves = {k: torch.tensor(arr[k], requires_grad=train)
              for k in ("x", "dt", "A_log", "B", "C")}
    a = -torch.exp(leaves["A_log"])
    terms = [ssm.slice_terms(*(leaves[k][:, i * l:(i + 1) * l] for k in ("x", "dt")), a,
                             *(leaves[k][:, i * l:(i + 1) * l] for k in ("B", "C")), CHUNK,
                             head_group=head_group, train=train) for i in range(n)]
    D, S = zip(*(ssm.slice_state(t) for t in terms))
    h = ssm.carry_states(torch.stack(D), torch.stack(S), local_shift(n), n)
    ys, fins = zip(*(ssm.slice_output(t, h[i], l) for i, t in enumerate(terms)))
    y, fin = torch.cat(ys, dim=1), fins[-1]
    grads = None
    if train:
        loss = (y * torch.from_numpy(arr["wy"])).sum() + (fin * torch.from_numpy(
            arr["wf"])).sum()
        grads = [v.numpy() for v in torch.autograd.grad(loss, list(leaves.values()))]
    return y.detach().numpy(), fin.detach().numpy(), grads


def _within(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bound, f"{what}: max |d| {err:.3e} > {bound:.3e}"


CASES = [(n, sl, g, H, 32) for n in (1, 2, 4, 8) for sl in SLICES for g in (1, 2)]
CASES += [(n, "three_chunks", 1, 8, 4) for n in (1, 2, 4, 8)]  # the head-group path


@pytest.mark.parametrize("n,slices,g,h,head_group", CASES)
def test_split_scan_matches_the_reference(n, slices, g, h, head_group):
    l = SLICES[slices]
    arr = inputs(n * l, g, h, seed=n * 100 + l + g)
    y_ref, fin_ref, g_ref = reference(arr, n * l, head_group)
    for train in (False, True):  # the kernel's plain version, then autograd's path
        y, fin, grads = port(arr, n, l, head_group, train)
        _within(y, y_ref, Y_TOL, f"y (train={train})")
        _within(fin, fin_ref, Y_TOL, f"final state (train={train})")
    for name, got, want in zip(("x", "dt", "A_log", "B", "C"), grads, g_ref):
        _within(got, want, GRAD_TOL, f"d/d{name}")


@pytest.mark.parametrize("l", [1, 2, 5, 16])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_conv_halo_matches_the_whole_sequence_conv(n, l):
    """Slices shorter than the halo (``conv_width - 1`` = 3) take their rows
    from the ranks before the left neighbour too."""
    width, c = 4, 6
    rng = np.random.default_rng(n * 10 + l)
    x = rng.standard_normal((B_, n * l, c)).astype(np.float32)
    w = rng.standard_normal((c, width)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    want = np.asarray(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))
    slices = torch.from_numpy(x).reshape(B_, n, l, c).transpose(0, 1)  # (n, b, l, c)
    halo = ssm.conv_halo(slices, width, local_shift(n))
    assert halo.shape == (n, B_, width - 1, c)
    got = torch.cat([ssm._causal_conv(torch.cat([halo[i], slices[i]], 1), torch.from_numpy(w),
                                      torch.from_numpy(bias))[:, width - 1:]
                     for i in range(n)], dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_TOL)


def _traced_prefill(n, s):
    arch = get_arch("mamba2-370m").reduced()
    with dryrun.fake_world(n):
        plan = sharding.make_plan(arch, (1, n))
        assert plan.seq_size == n and plan.seq_rank == 0
        sharding.reset_handoff()
        got = dryrun.trace_step(arch, "prefill", plan, 2, s)
        rounds = dict(sharding.HANDOFF)
    return arch, got["collectives"], rounds


@pytest.mark.parametrize("n", [2, 4])
def test_the_mixer_hands_off_states_not_sequences(n):
    arch, coll, rounds = _traced_prefill(n, 32 * n)
    layers = arch.num_mamba_layers
    scan = math.ceil(math.log2(n))
    assert rounds["rounds"] == (scan + 2) * layers
    # rank 0 sends in every round: D and S in each scan round, one tensor else
    assert coll["counts"]["collective-permute"] == (2 * scan + 2) * layers
    assert rounds["tensors"] == (2 * scan + 2) * layers
    # one broadcast of the cache a layer, one of the last position's logits
    assert coll["counts"]["broadcast"] == layers + 1
    _, longer, rounds2 = _traced_prefill(n, 64 * n)
    for kind in ("all-gather", "collective-permute"):
        assert longer["wire_bytes"].get(kind, 0.0) == coll["wire_bytes"].get(kind, 0.0), kind
    assert rounds2["bytes"] == rounds["bytes"]
