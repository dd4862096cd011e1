"""One rank's cost of one traced step: FLOPs, bytes, memory, collectives.

The port's counterpart of the reference's ``launch/hlo_analysis.py``.  The
reference reads a compiled XLA module's text; the port runs the step
eagerly, so :class:`CostCounter`, a ``TorchDispatchMode``, sees every aten
op of it (under ``FakeTensorMode`` for a step too large to allocate, or
on real CPU tensors) and counts:

* ``flops``: ``torch.utils.flop_counter``'s rule a product, 2 * M * N * K
  (the reference's ``dot`` rule), and its rules for convolutions and
  attention;
* ``bytes_accessed``: operand + result bytes of every op that is not a
  view or free (the reference's rule for a sequenced instruction; eager
  ops are not fused, so this is larger than XLA's number for the same
  step), and ``bytes_large``: the same over the parts of at least 1 MiB
  (``hlo_analysis.py``'s ``bytes_large``);
* the live bytes of every storage the ops make, freed when its last
  tensor dies, and their ``peak``;
* collectives by kind at the c10d ops the port issues (all-reduce,
  all-gather, reduce-scatter, all-to-all, the pipeline's send as
  "collective-permute", and a broadcast: the serving prefill's last
  logits, the payload once a rank): count, result bytes and wire bytes by
  the reference's ring model (:func:`wire_estimate`).

A kernel wrapper's plain version runs inside :meth:`CostCounter.kernel`:
its FLOPs count, but it is one op, as the kernel is on the card, whose
bytes are its inputs and outputs and whose intermediates hold no memory.

There is no loop-trip logic to port: the eager trace visits every layer.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
         "broadcast")
LARGE = 1 << 20  # hlo_analysis.py's threshold of an HBM-resident operand

# c10d op -> kind.  The first argument of each is the result (or the
# in-place tensors); a send is the collective-permute's payload, and its
# recv is not counted again.
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "broadcast_": "broadcast",
}
_FREE = {"detach", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
         "empty", "empty_strided", "empty_like", "set_", "resize_"}


def wire_estimate(kind: str, nbytes: float, n: int) -> float:
    """Bytes one rank puts on the wire for a collective of ``nbytes``
    result bytes over ``n`` ranks, the reference's ring model
    (``hlo_analysis._wire_estimate``)."""
    if n <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(nbytes) * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return float(nbytes)


def _tensors(tree, out=None):
    """The tensors of an op's arguments or outputs (lists, tuples, dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args) -> int:
    """The size of the process group a c10d op's arguments carry (boxed in
    a ``ScriptObject`` at the dispatcher)."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().name() == "ProcessGroup":
            return dist.ProcessGroup.unbox(a).size()
    return 1


def _signature(name: str, tree):
    """The key of a kernel call: each tensor's shape, dtype and device, a
    host integer tensor's values too; None where a fake integer tensor's
    values are unknown (such a call is always run)."""
    parts = [name]

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                parts.append((tuple(x.shape), x.dtype, x.device.type))
            elif isinstance(x, FakeTensor):
                raise LookupError
            else:
                parts.append((tuple(x.shape), x.dtype, tuple(x.reshape(-1).tolist())))
        elif isinstance(x, (list, tuple)):
            parts.append(len(x))
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x):
                parts.append(k)
                walk(x[k])
        else:
            parts.append(x)

    try:
        walk(tree)
    except LookupError:
        return None
    return tuple(parts)


class _Out(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _metadata(out):
    """A kernel's outputs (a tensor or a tuple of them) as shapes."""
    if isinstance(out, torch.Tensor):
        return _Out(tuple(out.shape), out.dtype, out.device)
    return tuple(_metadata(v) for v in out)


def _rebuild(meta):
    """Zeros of :func:`_metadata`'s shapes."""
    if isinstance(meta, _Out):
        return torch.zeros(meta.shape, dtype=meta.dtype, device=meta.device)
    return tuple(_rebuild(m) for m in meta)


@dataclass
class Cost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_large: float = 0.0
    live_bytes: int = 0
    peak_bytes: int = 0
    coll_counts: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_result_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_wire_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    kernels: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.coll_wire_bytes.values())

    def collective_summary(self) -> dict:
        """The reference's ``collectives`` record.  The port's payloads
        cross in their own dtype (the EP wire in bf16), so
        ``total_wire_bytes_bf16adj``, the reference's correction for the
        CPU backend's fp32 upcast of bf16 collectives, equals the total."""
        total = float(self.total_wire_bytes)
        return {
            "counts": {k: float(v) for k, v in self.coll_counts.items()},
            "result_bytes": {k: float(v) for k, v in self.coll_result_bytes.items()},
            "wire_bytes": {k: float(v) for k, v in self.coll_wire_bytes.items()},
            "total_wire_bytes": total,
            "total_wire_bytes_bf16adj": total,
            "total_result_bytes": float(sum(self.coll_result_bytes.values())),
        }


class CostCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside it do (module docstring).
    Enter it before the state is made, so that the state's storages are
    live from the start; :meth:`start_step` then zeroes the counts, and
    ``cost.peak_bytes`` is the step's peak with its state in it.
    """

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._seen = weakref.WeakSet()
        self._scope = 0
        self._calls = {}  # a kernel call's signature -> (FLOPs, outputs' metadata)

    # -- memory -------------------------------------------------------------
    def _freed(self, nbytes: int, _ref) -> None:
        self.cost.live_bytes -= nbytes

    def track(self, out) -> None:
        """Count the storages of ``out``'s tensors live, each once."""
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.cost.live_bytes += n
            weakref.finalize(st, self._freed, n, None)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.cost.live_bytes)

    def start_step(self) -> None:
        """Zero the counts and start the peak from what is live now."""
        live = self.cost.live_bytes
        self.cost = Cost(live_bytes=live, peak_bytes=live)

    # -- bytes --------------------------------------------------------------
    def _access(self, operand_bytes: int, result_bytes: int) -> None:
        c = self.cost
        c.bytes_accessed += operand_bytes + result_bytes
        if operand_bytes + result_bytes >= LARGE:
            c.bytes_large += ((result_bytes if result_bytes >= LARGE else 0)
                              + (operand_bytes if operand_bytes >= LARGE else 0))

    # -- kernels ------------------------------------------------------------
    def kernel(self, name: str, fn: Callable) -> Callable:
        """``fn`` (a kernel's plain version) counted as one op ``name``.  A
        call whose arguments have the shapes and dtypes (and a host integer
        tensor's values: a ragged GEMM's offsets) of an earlier one is not
        run again: it counts the earlier call's FLOPs, and its outputs are
        zeros of the earlier outputs' shapes."""
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if self._scope:
                return fn(*args, **kwargs)
            key = _signature(name, (args, kwargs))
            self._scope += 1
            try:
                if key in self._calls:
                    flops, like = self._calls[key]
                    out = _rebuild(like)
                else:
                    start = self.cost.flops
                    out = fn(*args, **kwargs)
                    flops, self.cost.flops = self.cost.flops - start, start
                    if key is not None:
                        self._calls[key] = (flops, _metadata(out))
            finally:
                self._scope -= 1
            self.cost.flops += flops
            self.cost.kernels[name] += 1
            self._access(_nbytes((args, kwargs)), _nbytes(out))
            self.track(out)
            return out

        return run

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ts = _tensors((args, kwargs))
        if ts and not any(isinstance(t, FakeTensor) for t in ts):
            # Host tensors (a step count, a batch of token ids) stay real
            # under FakeTensorMode, and so do the ops on them alone.
            with unset_fake_temporarily():
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if func.is_view or func.namespace == "prim":
            return out  # no bytes moved, no new storage
        packet = func.overloadpacket
        if packet in flop_registry:
            self.cost.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "c10d":
            kind = _C10D.get(packet.__name__)
            if kind is not None:
                nbytes = _nbytes(args[0])
                c = self.cost
                c.coll_counts[kind] += 1
                c.coll_result_bytes[kind] += nbytes
                c.coll_wire_bytes[kind] += wire_estimate(kind, nbytes, _group_size(args))
                if not self._scope:
                    self._access(_nbytes(args[1:2]) if kind != "collective-permute" else 0,
                                 nbytes)
            return out
        if self._scope:
            return out
        if packet.__name__ not in _FREE:
            self._access(_nbytes((args, kwargs)), _nbytes(out))
        self.track(out)
        return out


@contextlib.contextmanager
def kernels_as_ops(counter: CostCounter):
    """Inside the block every kernel wrapper's plain version (the functions
    the wrappers call on CPU tensors) is counted as one op of its kernel
    (:meth:`CostCounter.kernel`)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_gemm import ref as mm_ref
    from repro_torch.kernels.ssd import ref as ssd_ref

    plain = [(fa_ref, "attention", "flash_attention"),
             (mm_ref, "grouped_matmul_f32", "grouped_matmul_f32"),
             (mm_ref, "ragged_matmul_f32", "ragged_matmul_f32"),
             (mm_ref, "ragged_gate_up_silu_f32", "ragged_gate_up_silu_f32"),
             (mm_ref, "ragged_dw_f32", "ragged_dw_f32"),
             (ssd_ref, "ssd_intra_chunk", "ssd_intra_chunk")]
    old = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in plain]
    try:
        for (mod, attr, name), (_, _, fn) in zip(plain, old):
            setattr(mod, attr, counter.kernel(name, fn))
        yield
    finally:
        for mod, attr, fn in old:
            setattr(mod, attr, fn)
