"""Continuous-batching MoE inference engine.

The port of ``repro.serving.engine`` with the same scheduler, decision for
decision, so that both engines give the same ``trace`` on the same
workload:

* **Admission** is strictly FIFO: the head of the queue is admitted only if
  it fits (sequence slot + prompt pages + the per-step prefill token
  budget).  No skip-ahead, hence no starvation.
* **Prefill** runs one request at a time, right-padded to a power-of-two
  bucket, writing prompt K/V into the paged pool and taking the first token
  from the last valid position.
* **Decode** runs one step over ALL sequence slots each iteration; inactive
  slots ride along through sentinel block-table rows.
* **Preemption**: when the pool cannot hold a running sequence's next
  token, the *youngest* running sequence goes back to the FRONT of the
  queue (prompt + generated so far) and its pages are freed.
* **Graceful degradation**: a request whose ``deadline_step`` is provably
  out of reach is shed with an :class:`AbortInfo`; ``admit_reserve_blocks``
  holds new work back while the pool is close to exhaustion.

The engine is host-driven: device work happens in
``LanguageModel.prefill_paged`` / ``decode_step_paged``, and the scheduler
mutates only small numpy tables between the calls.  Over the ranks of an
expert-parallel ``LanguageModel`` every rank runs its own engine on the
same requests in lockstep: the model's collectives line up because the
schedules do, and the sampled tokens agree because the logits do.  Expert
rebalancing (the reference's ``_maybe_rebalance``) is not ported
(ROADMAP Queue 1 item 2b).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.runtime.faults import FaultInjector
from repro_torch.serving.kv_cache import BlockPool, PagedLayout


@dataclass
class Request:
    rid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    # Engine-step number by which the request must FINISH; None = no SLO.
    deadline_step: Optional[int] = None

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.tokens.ndim != 1 or self.tokens.size < 1 or self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: need a non-empty 1-D prompt and "
                             f"max_new_tokens >= 1")


@dataclass(frozen=True)
class AbortInfo:
    """Structured record of a shed request."""

    rid: int
    step: int  # engine step at which it was shed
    reason: str  # e.g. "deadline"
    detail: str
    generated: List[int]  # tokens produced before the abort


@dataclass(frozen=True)
class ServeConfig:
    max_seqs: int = 4  # concurrent decode batch width
    block_size: int = 16  # tokens per KV page
    num_blocks: int = 128  # pool pages (shared by all layers)
    max_blocks_per_seq: int = 16
    prefill_tokens_per_step: int = 512  # admission token budget per step
    cache_dtype: str = "float32"  # "bfloat16" on the card
    max_steps: int = 10_000  # run() safety valve
    # Admission backpressure: keep this many free pages per sequence that
    # would be running after admission; 0 disables.
    admit_reserve_blocks: int = 0

    def layout(self) -> PagedLayout:
        return PagedLayout(num_blocks=self.num_blocks, block_size=self.block_size,
                           max_seqs=self.max_seqs,
                           max_blocks_per_seq=self.max_blocks_per_seq)


@dataclass
class _SeqState:
    req: Request
    slot: int
    admitted_at: int  # engine step of (re-)admission
    generated: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_id
        return eos is not None and bool(self.generated) and self.generated[-1] == eos


MIN_BUCKET = 8  # the smallest prefill bucket; the buckets are its powers of two


def _bucket(n: int, lo: int = MIN_BUCKET) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def check_ep(ep: int) -> None:
    """Refuse an EP degree that does not divide every prefill bucket: the
    EP layer takes each rank's sequence shard of a bucket, so ep must
    divide ``MIN_BUCKET`` (1, 2, 4 or 8)."""
    if MIN_BUCKET % ep:
        raise ValueError(f"ep={ep} does not divide the prefill buckets (powers of two "
                         f"from {MIN_BUCKET}): serving takes ep 1, 2, 4 or 8 (a prefill "
                         f"padded to a multiple of ep is ROADMAP.md Queue 1 item 3)")


class Engine:
    """Continuous-batching engine over one LanguageModel + parameter set;
    runs on the device the parameters live on."""

    def __init__(self, lm, params, cfg: ServeConfig = ServeConfig(),
                 injector: Optional[FaultInjector] = None):
        if lm.plan is not None:
            check_ep(lm.plan.ep)
        self.lm = lm
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.injector = injector if injector is not None else FaultInjector()
        layout = cfg.layout()
        self.pool = BlockPool(layout)
        self.cache = lm.init_paged_cache(
            layout, dtype=getattr(torch, cfg.cache_dtype), device=self.device)
        self.queue: Deque[Request] = deque()
        self.running: Dict[int, _SeqState] = {}  # slot -> state
        self.finished: Dict[int, List[int]] = {}
        self.aborted: Dict[int, AbortInfo] = {}  # rid -> shed record
        self.backpressure_steps = 0  # admissions deferred by the reserve
        # Tokens generated before a preemption (the re-queued request
        # carries them in its prompt; outputs must still report them).
        self._gen_prefix: Dict[int, List[int]] = {}
        # The engine always records its own event stream; the tuple
        # ``trace`` is a view over it built from attrs only (never
        # timestamps), so two runs of one workload compare equal.
        self.trace_ring = obs.RingBufferSink()
        self.telemetry = obs.Telemetry(enabled=True, sinks=[self.trace_ring])
        self.step_no = 0
        self.decode_steps = 0
        self.decoded_tokens = 0

    # -- structured trace ----------------------------------------------------

    # Event kind -> ordered attr fields of the tuple ``(kind, step, *fields)``.
    _TRACE_FIELDS = {
        "submit": ("rid",),
        "stall": (),
        "abort": ("rid", "reason"),
        "admit": ("rid", "slot"),
        "prefill": ("rid", "plen", "bucket"),
        "decode": ("rids",),
        "finish": ("rid", "ntokens"),
        "preempt": ("rid",),
    }

    def _trace(self, kind: str, **fields) -> None:
        self.telemetry.instant("engine." + kind, step=self.step_no, **fields)

    @property
    def trace(self) -> List[Tuple]:
        """Tuple view of the structured event stream."""
        out: List[Tuple] = []
        prefix = "engine."
        for ev in self.trace_ring.events():
            if ev["kind"] != "instant" or not ev["name"].startswith(prefix):
                continue
            fields = self._TRACE_FIELDS.get(ev["name"][len(prefix):])
            if fields is None:
                continue
            a = ev["attrs"]
            out.append((ev["name"][len(prefix):], a["step"]) + tuple(a[f] for f in fields))
        return out

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Reject up front a request the engine could never serve (a FIFO
        scheduler must not accept a head it can never admit): ValueError."""
        layout = self.cfg.layout()
        total = int(req.tokens.size) + req.max_new_tokens
        if total > layout.max_len:
            raise ValueError(f"request {req.rid} needs {total} tokens > max_len "
                             f"{layout.max_len}")
        if layout.blocks_for(total) > layout.num_blocks:
            raise ValueError(f"request {req.rid} needs {layout.blocks_for(total)} pages > "
                             f"pool size {layout.num_blocks}: it would preempt itself forever")
        self.queue.append(req)
        self._trace("submit", rid=req.rid)

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Serve ``requests`` to completion; returns rid -> generated ids."""
        for r in requests:
            self.submit(r)
        while (self.queue or self.running) and self.step_no < self.cfg.max_steps:
            self.step()
        assert not self.queue and not self.running, "engine stalled"
        return dict(self.finished)

    # -- one scheduler iteration --------------------------------------------

    def step(self) -> None:
        self.step_no += 1
        # Injected scheduler stall: the whole iteration is lost.
        if self.injector.fire("serve.stall", self.step_no) is not None:
            self._trace("stall")
            return
        with self.telemetry.span("engine.step", step=self.step_no) as sp:
            self._shed_expired()
            self._admit_and_prefill()
            self._decode_once()
            self.pool.check_invariants()
            sp.set(running=len(self.running), queued=len(self.queue))

    # -- graceful degradation -------------------------------------------------

    def _shed_expired(self) -> None:
        """Shed every request whose deadline is provably infeasible: a
        running sequence finishes at ``step_no + remaining - 1``; a queued
        one admitted now at ``step_no + max(max_new_tokens - 2, 0)``."""
        for slot in sorted(self.running):
            st = self.running[slot]
            dl = st.req.deadline_step
            if dl is None:
                continue
            remaining = st.req.max_new_tokens - len(st.generated)
            finish = self.step_no + remaining - 1
            if finish > dl:
                self._abort_running(
                    slot, "deadline",
                    f"running: {remaining} tokens left, earliest finish step "
                    f"{finish} > deadline {dl}")
        kept: Deque[Request] = deque()
        while self.queue:
            req = self.queue.popleft()
            dl = req.deadline_step
            if dl is not None:
                finish = self.step_no + max(req.max_new_tokens - 2, 0)
                if finish > dl:
                    self._record_abort(
                        req, self._gen_prefix.pop(req.rid, []), "deadline",
                        f"queued: earliest finish step {finish} > deadline {dl}")
                    continue
            kept.append(req)
        self.queue = kept

    def _abort_running(self, slot: int, reason: str, detail: str) -> None:
        st = self.running.pop(slot)
        self.pool.release(slot)
        gen = self._gen_prefix.pop(st.req.rid, []) + list(st.generated)
        self._record_abort(st.req, gen, reason, detail)

    def _record_abort(self, req: Request, generated: List[int], reason: str,
                      detail: str) -> None:
        self.aborted[req.rid] = AbortInfo(rid=req.rid, step=self.step_no,
                                          reason=reason, detail=detail,
                                          generated=generated)
        self._trace("abort", rid=req.rid, reason=reason)

    # -- admission + prefill -------------------------------------------------

    def _admit_and_prefill(self) -> None:
        budget = self.cfg.prefill_tokens_per_step
        while self.queue:
            req = self.queue[0]
            plen = int(req.tokens.size)
            # An over-budget prompt still proceeds ALONE on a fresh step:
            # the budget bounds aggregate admission, it never blocks the head.
            if plen > budget and budget < self.cfg.prefill_tokens_per_step:
                break
            if not self.pool.can_admit(plen, req.max_new_tokens):
                break  # strict FIFO: never skip the head
            if self.cfg.admit_reserve_blocks > 0:
                need = self.pool.layout.blocks_for(plen)
                reserve = self.cfg.admit_reserve_blocks * (len(self.running) + 1)
                if self.pool.free_blocks - need < reserve:
                    self.backpressure_steps += 1
                    break
            self.queue.popleft()
            slot = self.pool.admit(plen)
            st = _SeqState(req=req, slot=slot, admitted_at=self.step_no)
            self.running[slot] = st
            self._trace("admit", rid=req.rid, slot=slot)
            budget -= plen
            self._prefill_one(st)

    def _prefill_one(self, st: _SeqState) -> None:
        plen = int(st.req.tokens.size)
        bucket = _bucket(plen)
        with self.telemetry.span("engine.prefill", step=self.step_no,
                                 rid=st.req.rid, plen=plen, bucket=bucket):
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :plen] = st.req.tokens
            dev = self.device
            bt = torch.from_numpy(self.pool.block_table[st.slot][None].copy()).to(dev)
            lens = torch.tensor([plen], dtype=torch.int32, device=dev)
            logits, self.cache = self.lm.prefill_paged(
                self.params, {"tokens": torch.from_numpy(toks).to(dev)},
                self.cache, bt, lens)
            # int() waits for the device: the span covers the real latency.
            tok = int(torch.argmax(logits[0]))
        st.generated.append(tok)
        self._trace("prefill", rid=st.req.rid, plen=plen, bucket=bucket)
        self._retire_if_done(st)

    # -- decode --------------------------------------------------------------

    def _decode_once(self) -> None:
        if not self.running:
            return
        # Reserve page room for every running sequence's next token; evict
        # the youngest back to the queue head until the rest fit.
        for slot in self._slots_by_age(youngest_first=True):
            if slot not in self.running:  # already preempted as a victim
                continue
            while not self.pool.extend(slot, 1):
                victim = self._youngest_slot()
                self._preempt(victim)
                if victim == slot:
                    break
        if not self.running:
            return
        toks = np.zeros((self.cfg.max_seqs, 1), np.int64)
        lens = np.zeros((self.cfg.max_seqs,), np.int32)
        for slot, st in self.running.items():
            toks[slot, 0] = st.generated[-1]
            lens[slot] = int(self.pool.lengths[slot]) - 1  # fill before the new token
        dev = self.device
        with self.telemetry.span("engine.decode", step=self.step_no,
                                 batch=len(self.running)):
            logits, self.cache = self.lm.decode_step_paged(
                self.params, self.cache,
                torch.from_numpy(self.pool.block_table.copy()).to(dev),
                torch.from_numpy(lens).to(dev),
                {"tokens": torch.from_numpy(toks).to(dev)})
            # The argmax fetch is the per-step device sync.
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        active = sorted(self.running)
        self.decode_steps += 1
        self.decoded_tokens += len(active)
        self._trace("decode", rids=tuple(self.running[s].req.rid for s in active))
        for slot in active:
            st = self.running[slot]
            st.generated.append(int(nxt[slot]))
            self._retire_if_done(st)

    # -- lifecycle helpers ---------------------------------------------------

    def _retire_if_done(self, st: _SeqState) -> None:
        if not st.done:
            return
        self.pool.release(st.slot)
        del self.running[st.slot]
        out = self._gen_prefix.pop(st.req.rid, []) + list(st.generated)
        self.finished[st.req.rid] = out
        self._trace("finish", rid=st.req.rid, ntokens=len(out))

    def _slots_by_age(self, youngest_first: bool = False) -> List[int]:
        order = sorted(self.running, key=lambda s: (self.running[s].admitted_at, s))
        return order[::-1] if youngest_first else order

    def _youngest_slot(self) -> int:
        return self._slots_by_age(youngest_first=True)[0]

    def _preempt(self, slot: int) -> None:
        """Evict a running sequence: free its pages and push prompt +
        generated-so-far to the FRONT of the queue for re-prefill."""
        st = self.running.pop(slot)
        self.pool.release(slot)
        self._gen_prefix[st.req.rid] = (
            self._gen_prefix.get(st.req.rid, []) + list(st.generated))
        merged = np.concatenate([st.req.tokens, np.asarray(st.generated, np.int32)])
        remaining = st.req.max_new_tokens - len(st.generated)
        assert remaining >= 1, "done sequences are retired, not preempted"
        self.queue.appendleft(Request(
            rid=st.req.rid, tokens=merged, max_new_tokens=remaining,
            eos_id=st.req.eos_id, deadline_step=st.req.deadline_step))
        self._trace("preempt", rid=st.req.rid)
