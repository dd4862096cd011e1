"""Mamba2 (SSD, state-space duality) mixer: the port of ``repro.models.ssm``.

The chunked SSD algorithm (arXiv:2405.21060) splits the selective-state-
space recurrence into an intra-chunk, attention-like product (the
``ssd_intra_chunk`` kernel, ``kernels/ssd``) and a recurrence over
per-chunk states.  The reference runs that recurrence as a
``lax.associative_scan`` over chunks; here it is a loop over them (a
prefill has at most a few dozen chunks).  The projections stay separate
matrices (z, x, B, C, dt), as in the reference, so the parameter trees
match leaf for leaf.

Training (``train=True``) takes the reference's ``impl="xla"`` intra-chunk
term instead of the kernel, which has no backward in the reference or
here: ``exp(segsum(dA))`` and the four-operand contraction
(``repro.models.ssm:110-114``), with the reference's casts, so bf16 rounds
where it rounds, and autograd differentiates it.  Every call that does
not train keeps the kernel.  The chunk prefixes of both paths are summed
in fp64 and rounded once to fp32, as the kernel takes them
(``kernels/ssd/ref.py`` says why), where the reference sums in fp32: the
training path is then the kernel's plain version under autograd, and its
loss agrees with the kernel path's at full width.  The masked upper
triangle of the decay is ``exp(-inf)`` taken after a ``torch.where``, so
its gradient is 0, never NaN.  With many heads (jamba: 256) each group
of ``head_group`` heads runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` does, so its (b, nc, h, cl, cl) decay is
recomputed in the backward rather than kept.  Layouts and dtype casts
follow the reference, so fp32 runs agree with it to rounding.

Across sequence slices (the reference's "seq" layout: the sequence over
the (ep, tp) ranks) each rank convolves and scans only its own slice, as
the reference's ``lax.associative_scan`` over sharded chunks lowers to a
log-depth collective-permute chain.  What crosses ranks is a state and,
for the causal conv, the ``conv_width - 1`` rows before a slice, through
an injected ``shift(tensors, k, fills=None)`` (``sharding.seq_shift`` on the
ranks; a test passes a shift along a leading rank dim of its own):
:func:`conv_halo` takes the rows; :func:`slice_terms` computes the slice's
chunk terms (the intra-chunk kernel once) and :func:`slice_state` its total
decay and end state from a zero state; :func:`carry_states` takes the
inclusive prefix of the slices' (decay, state) pairs under the reference's
``combine`` in ceil(log2 n) Hillis-Steele rounds, and one more shift gives
the state entering the slice; :func:`slice_output` runs the slice's chunk
recurrence from it.  Within a slice that rounds as one rank does; only the
entering state is summed in another order.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import rms_norm


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(b, l, g, n) -> (b, l, h, n), head i reading group i // (h // g):
    a stride-0 view for one group (no copy), else a repeat."""
    b, l, g, n = t.shape
    if g == 1:
        return t.expand(b, l, h, n)
    return t.repeat_interleave(h // g, dim=2)


def ssd_chunked(
    x: torch.Tensor,  # (b, l, h, p): per-head inputs, not yet dt-scaled
    dt: torch.Tensor,  # (b, l, h): softplus'd step sizes
    a: torch.Tensor,  # (h,): negative decay rates (-exp(A_log))
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
    head_group: int = 32,
    train: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (b, l, h, p), final_state (b, h, p, n)).

    ``train`` selects the differentiable intra-chunk term (module
    docstring); otherwise the kernel runs.  With many heads (jamba: 256)
    the reference walks head groups of ``head_group`` one after another to
    bound the live memory; heads are independent, so the loop here is
    exact, and under ``train`` each group is recomputed in the backward.
    """
    h, g = x.shape[2], B.shape[2]
    if h > head_group and h % head_group == 0 and g == 1 and initial_state is None:
        def group(xi, dti, ai, B_, C_):
            return ssd_chunked(xi, dti, ai, B_, C_, chunk, head_group=h, train=train)

        ys, fins = [], []
        for i in range(0, h, head_group):
            part = slice(i, i + head_group)
            args = (x[:, :, part], dt[:, :, part], a[part], B, C)
            y, fin = (checkpoint(group, *args, use_reentrant=False) if train
                      else group(*args))
            ys.append(y)
            fins.append(fin)
        return torch.cat(ys, dim=2), torch.cat(fins, dim=1)
    return _chunk_recurrence(*_chunk_terms(x, dt, a, B, C, chunk, train), initial_state)


def _chunk_terms(x, dt, a, B, C, chunk: int, train: bool):
    """What :func:`ssd_chunked` computes before the state entering the
    sequence is known: (Y_diag (b, nc, cl, h, p), the chunks' own states u
    (b, nc, h, p, n), their decays (b, nc, h) in u's dtype, the prefixes
    A_cs (b, nc, cl, h), C read by each head (b, nc, cl, h, n))."""
    b, l, h, p = x.shape
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk
    Bh, Ch = _heads(B, h), _heads(C, h)  # (b, l, h, n)

    dA = dt.float() * a.float()  # (b, l, h)
    xdt = x * dt[..., None].to(x.dtype)

    def to_chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dAc, Bc, Cc = map(to_chunks, (xdt, dA, Bh, Ch))
    # (b, nc, cl, h): the kernel's prefixes, summed in fp64 and rounded
    # once (kernels/ssd/ref.py says why)
    A_cs = torch.cumsum(dAc.double(), dim=2).float()

    # Intra-chunk ("diagonal block") term: the kernel, or under ``train``
    # the reference's XLA einsums.
    Y_diag = (_intra_chunk(xc, A_cs, to_chunks(B), to_chunks(C)) if train
              else ssd_ops.ssd_intra_chunk(xc, dAc, Bc, Cc))

    # Per-chunk states.
    decay_states = torch.exp(A_cs[:, :, -1:, :] - A_cs)  # (b, nc, cl, h)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc,
                          decay_states.to(Bc.dtype)[..., None] * xc)
    decay_chunk = torch.exp(A_cs[:, :, -1, :]).to(states.dtype)  # (b, nc, h)
    return Y_diag, states, decay_chunk, A_cs, Cc


def _chunk_recurrence(Y_diag, states, decay_chunk, A_cs, Cc, initial_state):
    """:func:`_chunk_terms`' chunks from ``initial_state`` (None: zeros):
    the inter-chunk recurrence s_c = exp(sum dA_c) * s_{c-1} + u_c, taken
    in order (the reference's associative scan, sequentially), and the
    off-diagonal term.  Returns (y (b, l, h, p), the final state)."""
    b, nc, cl, h, p = Y_diag.shape
    prev = (initial_state.to(states.dtype) if initial_state is not None
            else torch.zeros_like(states[:, 0]))
    states_prev = []
    for c in range(nc):
        states_prev.append(prev)
        prev = decay_chunk[:, c, :, None, None] * prev + states[:, c]
    states_prev = torch.stack(states_prev, dim=1)  # state entering each chunk

    # Off-diagonal (cross-chunk) term.
    state_decay = torch.exp(A_cs).to(Cc.dtype)  # (b, nc, cl, h)
    Y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, states_prev) * state_decay[..., None]
    return (Y_diag + Y_off).reshape(b, nc * cl, h, p), prev


# shift(tensors, k, fills=None) -> the tensors of sequence rank j - k (fills
# where there is none): ``sharding.seq_shift`` bound to a plan.
Shift = Callable[..., list]


def slice_terms(x, dt, a, B, C, chunk: int, *, head_group: int = 32, train: bool = False):
    """One sequence slice's :func:`_chunk_terms` (shapes as
    :func:`ssd_chunked`'s, l the slice's length), by head group as
    :func:`ssd_chunked` walks jamba's heads (each group's recomputed in
    the backward under ``train``): a list of (heads, terms).  The chunk is
    ``min(chunk, l)``; a slice longer than it and not a multiple of it is
    padded at its end with dt = 0 rows (x, B and C zero too), which add
    nothing to y or to a state and leave it undecayed."""
    l, h = x.shape[1], x.shape[2]
    cl = min(chunk, l)
    pad = -l % cl
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    step = head_group if h > head_group and h % head_group == 0 and B.shape[2] == 1 else h
    terms = functools.partial(_chunk_terms, chunk=cl, train=train)
    out = []
    for i in range(0, h, step):
        part = slice(i, i + step)
        args = (x[:, :, part], dt[:, :, part], a[part], B, C)
        out.append((part, checkpoint(terms, *args, use_reentrant=False)
                    if train and step < h else terms(*args)))
    return out


def slice_state(terms):
    """A slice's total decay D = exp(sum dt a) (b, h), from the chunks' fp64
    sums of the kernel's prefixes, and its end state S (b, h, p, n) from a
    zero state, both in the states' dtype, from :func:`slice_terms`."""
    D, S = [], []
    for _, (_, states, decay_chunk, A_cs, _) in terms:
        D.append(torch.exp(A_cs[:, :, -1].double().sum(1)).to(states.dtype))
        prev = states[:, 0]
        for c in range(1, states.shape[1]):
            prev = decay_chunk[:, c, :, None, None] * prev + states[:, c]
        S.append(prev)
    return torch.cat(D, dim=1), torch.cat(S, dim=1)


def carry_states(D, S, shift: Shift, n: int):
    """The state entering each of n sequence slices (zero on the first)
    from each slice's total decay D (..., b, h) and zero-start end state S
    (..., b, h, p, n): the inclusive prefix under the reference's
    ``combine`` (``(d1, s1), (d2, s2) -> (d1 d2, s1 d2 + s2)``, identity
    (1, 0)) in ceil(log2 n) Hillis-Steele rounds of ``shift`` by 1, 2, 4,
    ..., each sending D and S in one round, then one more shift by 1; in
    S's dtype."""
    k = 1
    while k < n:
        Dp, Sp = shift([D, S], k, fills=(1.0, 0.0))
        S = Sp * D[..., None, None] + S
        D = Dp * D
        k *= 2
    return shift([S], 1)[0]


def slice_output(terms, h, l: int):
    """The slice's y (b, l, h, p) and end state, its chunk recurrence run
    from the entering state h (b, h, p, n): within the slice the same
    operations, in the same order, as one rank's :func:`ssd_chunked`."""
    ys, fins = zip(*(_chunk_recurrence(*t, h[:, part]) for part, t in terms))
    return torch.cat(ys, dim=2)[:, :l], torch.cat(fins, dim=1)


def ssd_slices(x, dt, a, B, C, chunk: int, shift: Shift, n: int, *, train: bool = False):
    """:func:`ssd_chunked` of the whole sequence, computed on this rank's
    slice of it: (y of the slice, the state at the slice's end, on the last
    slice the sequence's final state).  The intra-chunk term runs once."""
    terms = slice_terms(x, dt, a, B, C, chunk, train=train)
    return slice_output(terms, carry_states(*slice_state(terms), shift, n), x.shape[1])


def conv_halo(t, width: int, shift: Shift):
    """The ``width - 1`` pre-conv rows (..., width - 1, c) before this
    slice of ``t`` (..., l, c): the left neighbour's last rows, and where
    a slice is shorter than that, the ranks' before it too (one shift a
    rank, by 1, 2, ...); zeros before the sequence's start, the conv's own
    left padding."""
    need = width - 1
    tail = t[..., -need:, :]
    parts, k = [], 1
    while sum(q.shape[-2] for q in parts) < need:
        parts.insert(0, shift([tail], k)[0])
        k += 1
    return torch.cat(parts, dim=-2)[..., -need:, :]


def _intra_chunk(xc, A_cs, Bg, Cg) -> torch.Tensor:
    """The reference's intra-chunk term (``impl="xla"``) from the chunk
    prefixes A_cs (b, nc, cl, h): L = exp(segsum(dA)) in fp32, cast to C's
    dtype, then sum_s (C_l·B_s) L[l, s] x_s.  C·Bᵀ is taken once a B/C
    group (Bg, Cg: (b, nc, cl, g, n)) and read by the group's heads, the
    values of the reference's per-head products."""
    cl, h = A_cs.shape[2], A_cs.shape[3]
    cs = A_cs.transpose(2, 3)  # (b, nc, h, cl)
    seg = cs[..., :, None] - cs[..., None, :]  # (b, nc, h, cl, cl)
    mask = torch.ones((cl, cl), dtype=torch.bool, device=cs.device).tril()
    # exp after the where: the masked entries are exp(-inf) = 0 with a zero
    # gradient (exp of a positive seg there could overflow, and inf * 0 is
    # NaN in the backward)
    L = torch.exp(torch.where(mask, seg, float("-inf"))).to(Cg.dtype)
    S = torch.einsum("bclgn,bcsgn->bcgls", Cg, Bg)
    g = Bg.shape[3]
    if g > 1:
        S = S.repeat_interleave(h // g, dim=2)  # one group broadcasts as it is
    return torch.einsum("bchls,bcshp->bclhp", S * L, xc)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, a cross-correlation as the reference's
    ``lax.conv``: out[t, c] = sum_k w[c, k] x[t - (width - 1) + k, c].
    x: (b, l, c); w: (c, width)."""
    width = w.shape[-1]
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))  # (b, c, l + width - 1)
    out = F.conv1d(xp, w[:, None, :].to(x.dtype), groups=x.shape[-1])
    return out.transpose(1, 2).contiguous() + bias.to(out.dtype)


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """window: (b, width, c); w: (c, width) -> (b, c) in fp32."""
    return torch.einsum("bwc,cw->bc", window.float(), w.float()) + b.float()


def mamba_block(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (b, l, d)
    arch: ArchConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    return_cache: bool = False,
    train: bool = False,
    seq=None,
):
    """Mamba2 mixer sub-layer.  Returns (out (b, l, d), new cache or None).
    ``train`` runs the SSD's differentiable path (:func:`ssd_chunked`).

    ``seq`` (no cache): a ``sharding.MeshPlan`` whose sequence group holds
    the sequence, ``x`` this rank's slice of it.  Everything runs on the
    slice (module docstring): the conv on the left neighbour's last
    ``conv_width - 1`` pre-conv rows (:func:`conv_halo`) and the slice, the
    scan from a zero state with the state entering the slice handed along
    the group (:func:`ssd_slices`): the same function as one rank's, a
    1 / n share of its work a rank.  A prefill's cache (``return_cache``)
    is the whole sequence's on every rank of the group, as the reference's
    ``cache_specs`` keeps it (rows over data, whole over (ep, tp)): the
    last slice's end state and its conv tails, broadcast from that rank in
    one collective.

    cache = {"ssm": (b, h, p, n), "conv_x": (b, w-1, d_in), "conv_B",
    "conv_C"} runs one decode token (l = 1) and updates the cache IN PLACE
    (the returned dict is ``cache``); ``return_cache=True`` makes a prefill
    emit a new one: the final SSM state in x's dtype and the last w - 1
    PRE-conv projections, left-padded with zeros when l < w - 1.
    """
    s = arch.ssm
    b, l, _ = x.shape
    d_in = s.expand * arch.d_model
    nh = s.num_heads(arch.d_model)

    z = x @ params["w_z"]
    xs = x @ params["w_x"]
    Bp = x @ params["w_B"]
    Cp = x @ params["w_C"]
    dt = x @ params["w_dt"]  # (b, l, nh)
    a = -torch.exp(params["A_log"].float())  # (nh,)
    new_cache = None

    if cache is not None:
        if l != 1:
            raise ValueError(f"a cached mamba step takes one token, got {l}")
        win_x = torch.cat([cache["conv_x"], xs], dim=1)
        win_B = torch.cat([cache["conv_B"], Bp], dim=1)
        win_C = torch.cat([cache["conv_C"], Cp], dim=1)
        xs_c = F.silu(_conv_step(win_x, params["conv_x_w"], params["conv_x_b"]))
        B_c = F.silu(_conv_step(win_B, params["conv_B_w"], params["conv_B_b"]))
        C_c = F.silu(_conv_step(win_C, params["conv_C_w"], params["conv_C_b"]))
        dt_s = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (b, nh)
        xh = xs_c.reshape(b, nh, s.head_dim).to(x.dtype)
        rep = nh // s.n_groups
        Bh = B_c.reshape(b, s.n_groups, s.state_size).repeat_interleave(rep, 1).to(x.dtype)
        Ch = C_c.reshape(b, s.n_groups, s.state_size).repeat_interleave(rep, 1).to(x.dtype)
        decay = torch.exp(dt_s * a)  # (b, nh)
        update = (dt_s.to(x.dtype)[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
        ssm = cache["ssm"]
        ssm.mul_(decay[..., None, None].to(x.dtype)).add_(update)
        y = torch.einsum("bhpn,bhn->bhp", ssm, Ch)
        y = y + xh * params["D"][None, :, None].to(x.dtype)
        y = y.reshape(b, 1, d_in)
        for key, win in (("conv_x", win_x), ("conv_B", win_B), ("conv_C", win_C)):
            cache[key].copy_(win[:, 1:])
        new_cache = cache
    else:
        w, gn = s.conv_width, s.n_groups * s.state_size
        n = 1 if seq is None else seq.seq_size
        if n > 1:
            shift = functools.partial(sharding.seq_shift, plan=seq)
            pre = torch.cat([xs, Bp, Cp], dim=-1)
            pre = torch.cat([conv_halo(pre, w, shift), pre], dim=1)  # (b, w - 1 + l, .)
            xs_w, Bp_w, Cp_w = pre.split([d_in, gn, gn], dim=-1)
        else:
            xs_w, Bp_w, Cp_w = xs, Bp, Cp
        xs_c, B_c, C_c = (
            F.silu(_causal_conv(t, params[f"conv_{k}_w"], params[f"conv_{k}_b"])
                   [:, t.shape[1] - l:]).to(x.dtype)
            for t, k in ((xs_w, "x"), (Bp_w, "B"), (Cp_w, "C")))
        dt_s = F.softplus(dt.float() + params["dt_bias"])  # (b, l, nh)
        xh = xs_c.reshape(b, l, nh, s.head_dim)
        Bg = B_c.reshape(b, l, s.n_groups, s.state_size)
        Cg = C_c.reshape(b, l, s.n_groups, s.state_size)
        if n > 1:
            y, final = ssd_slices(xh, dt_s.to(x.dtype), a, Bg, Cg, s.chunk_size, shift, n,
                                  train=train)
        else:
            y, final = ssd_chunked(xh, dt_s.to(x.dtype), a, Bg, Cg, min(s.chunk_size, l),
                                   train=train)
        y = y + xh * params["D"][None, None, :, None].to(x.dtype)
        y = y.reshape(b, l, d_in)
        if return_cache:
            # The conv's window at the sequence's end: the last w - 1 rows
            # of the slice (under ``seq``, after its halo, so a slice
            # shorter than that reads its neighbours' rows as the whole
            # sequence would; zeros before the sequence's start).
            tails = [F.pad(t, (0, 0, max(0, (w - 1) - t.shape[1]), 0))[:, -(w - 1):]
                     for t in (xs_w, Bp_w, Cp_w)]
            ssm = final.to(x.dtype)
            if n > 1:
                ssm, *tails = _from_last_slice([ssm] + tails, seq)
            new_cache = {"ssm": ssm, "conv_x": tails[0], "conv_B": tails[1],
                         "conv_C": tails[2]}

    # Gated RMSNorm + output projection.
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm_scale"], arch.norm_eps)
    return y @ params["out_proj"], new_cache


def _from_last_slice(ts, plan) -> list:
    """``ts`` (one dtype) as the sequence group's last rank holds them, on
    every rank of the group: one broadcast of them packed flat."""
    n = plan.seq_size
    flat = torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1).contiguous()
    torch.distributed.broadcast(flat, src=plan.rank - plan.seq_rank + n - 1,
                                group=plan.model_group)
    out = []
    for t in ts:
        part, flat = flat[:, :t[0].numel()], flat[:, t[0].numel():]
        out.append(part.reshape(t.shape))
    return out


def init_ssm_cache(arch: ArchConfig, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    s = arch.ssm
    nh = s.num_heads(arch.d_model)
    d_in = s.expand * arch.d_model
    gn = s.n_groups * s.state_size
    w = s.conv_width
    return {
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_size), dtype=dtype, device=device),
        "conv_x": torch.zeros((batch, w - 1, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w - 1, gn), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, gn), dtype=dtype, device=device),
    }

