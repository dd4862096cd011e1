"""Token data pipeline: deterministic synthetic stream + memmap corpus.

A copy of ``repro.data.pipeline`` (numpy only): the same step and shard
give the same tokens, bit for bit, in both packages.

Shard-aware: every dataset takes (shard_index, num_shards) so each data-
parallel host process reads only its slice — deterministic under restarts
(the stream is a pure function of (step, shard)), which is what makes the
fault-tolerant trainer's resume exact.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class SyntheticTokens:
    """Deterministic pseudo-random token stream (splitmix64 over
    (step, position)).  Enough structure for throughput/e2e tests; exactly
    reproducible at any step without state."""

    vocab_size: int
    batch: int  # per-shard batch
    seq_len: int
    shard_index: int = 0
    num_shards: int = 1
    start_step: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = self.batch * (self.seq_len + 1)
        base = np.arange(n, dtype=np.uint64) + np.uint64(
            (step * self.num_shards + self.shard_index) * n
        )
        # splitmix64
        z = base + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        toks = (z % np.uint64(self.vocab_size)).astype(np.int32)
        toks = toks.reshape(self.batch, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self.start_step
        while True:
            yield self.batch_at(step)
            step += 1


def write_corpus(path: str, tokens: np.ndarray) -> None:
    """Write a flat token stream as a little-endian uint32 binary corpus."""
    np.asarray(tokens, dtype="<u4").tofile(path)


@dataclass
class MemmapCorpus:
    """Windowed reader over a flat binary token corpus (np.memmap —
    zero-copy, supports corpora far larger than RAM).

    Deterministic shuffle: window order is a pseudo-random permutation
    keyed by (epoch, seed); sharding slices the permutation.
    """

    path: str
    batch: int
    seq_len: int
    shard_index: int = 0
    num_shards: int = 1
    seed: int = 0
    start_step: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype="<u4", mode="r")
        self.num_windows = (len(self._data) - 1) // self.seq_len
        if self.num_windows < self.batch * self.num_shards:
            raise ValueError(
                f"corpus too small: {self.num_windows} windows of {self.seq_len} "
                f"tokens for {self.batch} x {self.num_shards} per step")
        self.steps_per_epoch = self.num_windows // (self.batch * self.num_shards)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        return rng.permutation(self.num_windows)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        epoch = step // self.steps_per_epoch
        within = step % self.steps_per_epoch
        perm = self._perm(epoch)
        base = (within * self.num_shards + self.shard_index) * self.batch
        idx = perm[base : base + self.batch]
        toks = np.stack(
            [
                self._data[i * self.seq_len : i * self.seq_len + self.seq_len + 1]
                for i in idx
            ]
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self.start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a dataset iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        """Stop the thread: drain the queue so a blocked ``put`` returns and
        the thread sees the stop flag, then join it (at most ~5 s)."""
        self._stop.set()
        for _ in range(500):
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)
            if not self._thread.is_alive():
                return
        raise RuntimeError("Prefetcher thread did not stop")
