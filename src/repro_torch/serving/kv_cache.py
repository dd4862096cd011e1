"""Paged KV-cache: block-table-indexed page pool for continuous batching.

The port of ``repro.serving.kv_cache``: a sequence's token positions are
striped over fixed-size pages drawn from a shared pool, and a per-sequence
block table maps logical block index -> physical page id.

* **Device side**: ``gather_pages`` materializes each sequence's prefix as a
  dense (b, S, h, d) view; ``append_tokens`` writes fresh K/V rows into their
  (page, slot) cells.  Page ids outside ``[0, num_blocks)`` are the
  *sentinel*: reads come back as zeros and writes are dropped.  Torch
  indexing raises on such ids, so reads clamp and mask, and writes go
  through a :class:`WritePlan` that lists only the valid cells.  Unlike the
  JAX package, writes update the page pool IN PLACE (the pools are the
  largest tensors of a serving run); ``append_tokens`` returns the same
  tensor for symmetry with the reference.
* **Host side** (:class:`BlockPool`): the free-list allocator and the numpy
  block-table / length registers the engine mutates between steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class PagedLayout:
    """Geometry of one paged KV pool (shared by every layer)."""

    num_blocks: int  # physical pages in the pool
    block_size: int  # tokens per page
    max_seqs: int  # concurrent sequence slots (decode batch width)
    max_blocks_per_seq: int  # block-table width (max_len / block_size)

    def __post_init__(self):
        if self.num_blocks < 1 or self.block_size < 1 or self.max_blocks_per_seq < 1:
            raise ValueError(f"bad paged layout {self}")

    @property
    def max_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    @property
    def sentinel(self) -> int:
        """Out-of-pool page id: writes through it drop, reads are zeros."""
        return self.num_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Dense per-sequence K (or V) prefix view.

    pages: (N, bs, h, d); block_table: (b, nb) page ids.  Sentinel entries
    read as zeros (they are masked off by the attention ``kv_len`` anyway).
    Returns (b, nb*bs, h, d).
    """
    N, bs, h, d = pages.shape
    b, nb = block_table.shape
    bt = block_table.long()
    ok = (bt >= 0) & (bt < N)
    out = pages[bt.clamp(0, N - 1)]  # (b, nb, bs, h, d)
    out = torch.where(ok[:, :, None, None, None], out, out.new_zeros(()))
    return out.reshape(b, nb * bs, h, d)


@dataclass(frozen=True)
class WritePlan:
    """Which K/V rows land in which page cells: ``rows`` index the
    flattened (b*s) rows of a ``(b, s, h, d)`` K/V block and ``dest`` the
    flattened (N*bs) cells of a page pool.  Built once per model step and
    shared by every layer's K and V writes."""

    rows: torch.Tensor
    dest: torch.Tensor


def write_plan(block_table: torch.Tensor, start: torch.Tensor, s: int,
               num_blocks: int, block_size: int,
               count: Optional[torch.Tensor] = None) -> WritePlan:
    """Cells for rows ``start[i] + j`` (j < s, and j < count[i] when given)
    of each sequence i; rows whose page is the sentinel, or whose position
    is past the block table, are left out (the JAX ``mode="drop"``)."""
    b, nb = block_table.shape
    dev = block_table.device
    j = torch.arange(s, device=dev)
    pos = start.to(dev).long()[:, None] + j[None, :]  # (b, s)
    blk = torch.div(pos, block_size, rounding_mode="floor")
    page = torch.gather(block_table.long(), 1, blk.clamp(0, nb - 1))
    valid = (blk < nb) & (page >= 0) & (page < num_blocks)
    if count is not None:
        valid &= j[None, :] < count.to(dev).long()[:, None]
    dest = page * block_size + pos % block_size
    rows = valid.reshape(-1).nonzero().squeeze(1)
    return WritePlan(rows=rows, dest=dest.reshape(-1)[rows])


def scatter_rows(pages: torch.Tensor, plan: WritePlan, kv: torch.Tensor) -> None:
    """Write the planned rows of ``kv`` (b, s, h, d) into ``pages``
    (N, bs, h, d) in place."""
    N, bs, h, d = pages.shape
    src = kv.reshape(-1, h, d)[plan.rows].to(pages.dtype)
    pages.view(N * bs, h, d)[plan.dest] = src


def append_tokens(pages: torch.Tensor, block_table: torch.Tensor,
                  start: torch.Tensor, kv: torch.Tensor, *,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``kv`` (b, s, h, d) rows at sequence positions ``start[i] + j``
    into ``pages`` (N, bs, h, d), in place; only the first ``count[i]``
    rows of sequence i when ``count`` is given.  Writes through sentinel
    page ids drop.  Returns ``pages``."""
    N, bs = pages.shape[:2]
    plan = write_plan(block_table, start, kv.shape[1], N, bs, count)
    scatter_rows(pages, plan, kv)
    return pages


def init_pages(layout: PagedLayout, reps: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device=None):
    """One pattern position's page pool: {"k","v"} of
    (reps, num_blocks, block_size, kv_heads, head_dim)."""
    shape = (reps, layout.num_blocks, layout.block_size, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Host-side allocator
# ---------------------------------------------------------------------------


class BlockPool:
    """Free-list page allocator + block-table/length registers.

    All state is host numpy; the engine copies the block table to the
    device once per step.  Pages are recycled LIFO so block-reuse
    bugs (stale data visible through a recycled page) surface at once.
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._free: List[int] = list(range(layout.num_blocks - 1, -1, -1))
        self.block_table = np.full(
            (layout.max_seqs, layout.max_blocks_per_seq), layout.sentinel, np.int32
        )
        self.lengths = np.zeros((layout.max_seqs,), np.int32)
        self.active = np.zeros((layout.max_seqs,), bool)

    # -- capacity queries ---------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def free_slot(self) -> Optional[int]:
        idx = np.flatnonzero(~self.active)
        return int(idx[0]) if idx.size else None

    def can_admit(self, prompt_len: int, gen_len: int) -> bool:
        """Room for the prompt now AND a slot; generation pages are
        allocated lazily (the engine preempts when the pool runs dry)."""
        if self.free_slot() is None:
            return False
        if prompt_len + gen_len > self.layout.max_len:
            return False
        return self.layout.blocks_for(prompt_len) <= self.free_blocks

    # -- lifecycle ----------------------------------------------------------

    def admit(self, prompt_len: int) -> int:
        """Claim a slot + pages for ``prompt_len`` tokens; returns the slot."""
        slot = self.free_slot()
        assert slot is not None, "no free sequence slot"
        need = self.layout.blocks_for(prompt_len)
        assert need <= self.free_blocks, "pool exhausted"
        assert need <= self.layout.max_blocks_per_seq, prompt_len
        for i in range(need):
            self.block_table[slot, i] = self._free.pop()
        self.lengths[slot] = prompt_len
        self.active[slot] = True
        return slot

    def extend(self, slot: int, n: int = 1) -> bool:
        """Reserve room for ``n`` more tokens; False if the pool or the
        table is exhausted (the caller must free or preempt)."""
        assert self.active[slot]
        have = self.layout.blocks_for(int(self.lengths[slot]))
        need = self.layout.blocks_for(int(self.lengths[slot]) + n)
        if need > self.layout.max_blocks_per_seq or need - have > self.free_blocks:
            return False
        for i in range(have, need):
            self.block_table[slot, i] = self._free.pop()
        self.lengths[slot] += n
        return True

    def release(self, slot: int) -> None:
        """Return a sequence's pages to the free list."""
        assert self.active[slot]
        row = self.block_table[slot]
        for i in range(self.layout.max_blocks_per_seq):
            if row[i] != self.layout.sentinel:
                self._free.append(int(row[i]))
        row[:] = self.layout.sentinel
        self.lengths[slot] = 0
        self.active[slot] = False

    # -- device snapshots ---------------------------------------------------

    def device_tables(self, device=None):
        """(block_table (max_seqs, nb), lengths (max_seqs,)) as int32
        tensors on ``device`` (None: the card): inactive slots carry
        sentinel rows and zero lengths."""
        dev = resolve_device(device)
        return (torch.from_numpy(self.block_table.copy()).to(dev),
                torch.from_numpy(self.lengths.copy()).to(dev))

    def check_invariants(self) -> None:
        """Every page is either free or owned by exactly one (slot, block);
        live block counts match lengths."""
        owned: List[int] = []
        for s in range(self.layout.max_seqs):
            live = [int(p) for p in self.block_table[s] if p != self.layout.sentinel]
            if not self.active[s]:
                assert not live and self.lengths[s] == 0, (s, live)
                continue
            assert len(live) == self.layout.blocks_for(int(self.lengths[s])), (
                s, len(live), int(self.lengths[s]))
            owned += live
        assert len(set(owned)) == len(owned), "page owned twice"
        assert not (set(owned) & set(self._free)), "live page on free list"
        assert len(owned) + len(self._free) == self.layout.num_blocks
