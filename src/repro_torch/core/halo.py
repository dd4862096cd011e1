"""HALO and the flat all-to-all over ``torch.distributed`` (paper §V).

The port of ``repro.core.halo``.  Both all-to-alls take a per-rank send
buffer ``(ep, rows, d)`` and return, at block i, the block that EP rank i
addressed to this rank.  The flat one is one ``all_to_all_single`` over the
plan's EP group.  HALO factors the EP group into ``ep // g1`` nodes of
``g1`` lanes (``g1 = _pick_inner(ep)``) and runs

    Phase II (+ the folded Phase I)  over the strided node groups,
    Phase III                        over the contiguous lane groups,

with the reference's reshapes and transposes between them.  It differs
from the flat one only where ``1 < g1 < ep`` (ep = 6 or ep >= 8).

Under this row <-> rank layout the all-to-all is its own transpose, so the
backward of a transfer is the same transfer applied to the cotangent.

:func:`overlapped_a2a` is the software pipeline of dispatch -> compute ->
combine over row chunks: chunk k+1's dispatch is issued (``async_op``)
before chunk k's expert FFN runs, and chunk k's combine before chunk
k+1's.  Each transfer is two autograd nodes, :class:`_Issue` and
:class:`_Land`; the backward of ``_Land`` issues the cotangent's transfer
and the backward of ``_Issue`` waits for it, so the backward keeps the
forward's overlap: autograd runs other chunks' pullbacks in between.
With one chunk it is the monolithic transfer -> compute -> transfer.
HALO's Phase III waits for Phase II, so only Phase II is in flight while
a chunk computes.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist


def _pick_inner(ep: int, preferred: int = 4) -> int:
    """Largest factor of ep that is <= preferred (the intra-host/ICI-adjacent
    group size)."""
    g = 1
    for cand in range(2, min(preferred, ep) + 1):
        if ep % cand == 0:
            g = cand
    return g


def lane_groups(ep: int, g1: int) -> List[List[int]]:
    """Contiguous intra-node groups: [[0..g1-1], [g1..2g1-1], ...]."""
    return [[n * g1 + l for l in range(g1)] for n in range(ep // g1)]


def node_groups(ep: int, g1: int) -> List[List[int]]:
    """Strided lane-affine inter-node groups (the paper's NIC affinity:
    lane l of every node forms one communicator)."""
    return [[m * g1 + l for m in range(ep // g1)] for l in range(g1)]


def chunk_slices(total: int, n_chunks: int) -> List[Tuple[int, int]]:
    """Split ``total`` rows into ``<= n_chunks`` contiguous (start, size)
    slices of near-equal static size.  The leading chunks take
    ceil(total/K) rows so only the LAST chunk is short when K does not
    divide the payload (the tail chunk); empty chunks are dropped, so
    K > total degenerates to ``total`` single-row chunks."""
    assert total >= 0 and n_chunks >= 1, (total, n_chunks)
    if total == 0:
        return [(0, 0)]
    size = -(-total // n_chunks)  # ceil
    out: List[Tuple[int, int]] = []
    start = 0
    while start < total:
        sz = min(size, total - start)
        out.append((start, sz))
        start += sz
    return out


# ---------------------------------------------------------------------------
# One transfer: issue (async) and land
# ---------------------------------------------------------------------------


def _a2a_issue(x: torch.Tensor, group):
    """Start ``all_to_all_single`` of ``x`` (split on dim 0) over ``group``;
    returns (output buffer, work or None for a one-rank group)."""
    if group is None:
        return x.clone(), None
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x, group=group, async_op=True)


def _a2a_land(pending) -> torch.Tensor:
    out, work = pending
    if work is not None:
        work.wait()
    return out


class Transfer:
    """The EP all-to-all of a plan, flat or HALO, split into ``issue``
    (starts the transfer, returns a pending handle) and ``land`` (waits and
    returns the ``(ep, rows, d)`` result)."""

    def __init__(self, plan, halo: Optional[bool] = None):
        halo = plan.hierarchical_a2a if halo is None else halo
        self.ep, self.g1, self.plan = plan.ep, plan.g1, plan
        self.halo = halo and plan.node_group is not None

    def issue(self, x: torch.Tensor):
        x = x.contiguous()
        if not self.halo:
            return x.shape, _a2a_issue(x, self.plan.ep_group)
        M = self.ep // self.g1
        rows, d = x.shape[1], x.shape[2]
        # Phase II (+ folded Phase I): node-aggregated blocks over the
        # lane-affine strided groups.
        return x.shape, _a2a_issue(x.reshape(M, self.g1 * rows, d), self.plan.node_group)

    def land(self, pending) -> torch.Tensor:
        shape, inner = pending
        recv = _a2a_land(inner)
        if not self.halo:
            return recv
        ep, rows, d = shape
        g1, M = self.g1, self.ep // self.g1
        # recv[(m, l', r)] = source (m, my_lane)'s rows for my node's lane l'.
        recv = recv.reshape(M, g1, rows, d).transpose(0, 1).reshape(g1, M * rows, d)
        # Phase III: intra-node redistribution over the contiguous lane groups.
        out = _a2a_land(_a2a_issue(recv.contiguous(), self.plan.lane_group))
        # out[(l, m, r)] = rows from source rank (m, l); reorder to rank order.
        return out.reshape(g1, M, rows, d).transpose(0, 1).reshape(ep, rows, d)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The whole transfer, synchronously (no autograd)."""
        return self.land(self.issue(x))


class _Box:
    """The in-flight handles of one transfer: the forward's and the
    cotangent's."""

    pending = None
    grad_pending = None


class _Issue(torch.autograd.Function):
    """Starts a transfer; the output is an empty token that carries the
    autograd edge to :class:`_Land`.  Backward: waits for the cotangent's
    transfer that ``_Land``'s backward issued."""

    @staticmethod
    def forward(ctx, x, xfer: Transfer, box: _Box):
        ctx.xfer, ctx.box = xfer, box
        box.pending = xfer.issue(x)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        g = ctx.xfer.land(ctx.box.grad_pending)
        ctx.box.grad_pending = None
        return g, None, None


class _Land(torch.autograd.Function):
    """Waits for the transfer its token started.  Backward: issues the
    same transfer on the cotangent (the all-to-all is its own transpose)."""

    @staticmethod
    def forward(ctx, token, xfer: Transfer, box: _Box):
        ctx.xfer, ctx.box = xfer, box
        out = xfer.land(box.pending)
        box.pending = None
        return out

    @staticmethod
    def backward(ctx, g):
        ctx.box.grad_pending = ctx.xfer.issue(g)
        return g.new_empty(0), None, None


def issue(x: torch.Tensor, xfer: Transfer, wire: Optional[torch.dtype] = None):
    """Start the differentiable transfer of ``x``, cast to ``wire`` first
    (the cast's backward casts the cotangent back, so it crosses in
    ``wire`` too).  Returns the handle :func:`land` takes."""
    box = _Box()
    src = x if wire is None else x.to(wire)
    return _Issue.apply(src, xfer, box), box, xfer, x.dtype


def land(handle) -> torch.Tensor:
    """Wait for a transfer from :func:`issue`; the result in the sender's
    dtype."""
    token, box, xfer, dtype = handle
    return _Land.apply(token, xfer, box).to(dtype)


def flat_all_to_all(x: torch.Tensor, plan) -> torch.Tensor:
    """The oracle: one flat collective over the EP group, differentiable."""
    return land(issue(x, Transfer(plan, halo=False)))


def hierarchical_all_to_all(x: torch.Tensor, plan) -> torch.Tensor:
    """HALO over the plan's node and lane groups, differentiable; equal
    to :func:`flat_all_to_all`."""
    return land(issue(x, Transfer(plan, halo=True)))


def overlapped_a2a(
    xfer: Transfer,
    get_chunk: Callable[[int, int], torch.Tensor],
    compute: Callable[[torch.Tensor, int, int], torch.Tensor],
    slices: List[Tuple[int, int]],
    wire: Optional[torch.dtype] = None,
) -> List[torch.Tensor]:
    """Software-pipelined dispatch -> compute -> combine over row chunks.

    ``get_chunk(start, size)`` is the (ep, rows_c, d) send buffer of a
    slice, ``compute(recv, start, size)`` maps a received chunk to its
    same-shape combine payload.  Chunk k+1's dispatch is issued before
    chunk k computes, and chunk k's combine before chunk k+1 computes; the
    combines are waited for at the end.  Returns the combined chunks in
    slice order (the caller concatenates).  With one slice this is the
    monolithic transfer -> compute -> transfer."""
    sent = {0: issue(get_chunk(*slices[0]), xfer, wire)}
    combines = []
    for k, (start, size) in enumerate(slices):
        if k + 1 < len(slices):
            sent[k + 1] = issue(get_chunk(*slices[k + 1]), xfer, wire)
        y = compute(land(sent.pop(k)), start, size)
        combines.append(issue(y, xfer, wire))
    return [land(h) for h in combines]
