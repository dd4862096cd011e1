"""Checkpointing: atomic, async-capable, self-verifying (the port of
``repro.checkpoint.checkpointing``).

Layout:  <dir>/step_<N>/
             manifest.json    leaf keys ("/"-joined tree paths), shapes,
                              dtypes, per-leaf CRC32s, step, extras
             manifest.crc32   CRC32 of manifest.json's bytes
             <key>.npy        one raw .npy file a leaf, "/" in the key
                              written as "."

* **Atomic**: written into ``step_<N>.tmp`` and then renamed, so a crash
  mid-save never corrupts the latest checkpoint.
* **Verified**: every leaf's CRC32 is recorded at save and checked again
  before a restore, with a digest over the manifest itself, so a flipped
  bit or a truncated file is detected, not restored.
* **Fallback, never deletion**: a checkpoint that fails verification is
  renamed ``step_<N>.corrupt[.n]`` with its reason in
  ``QUARANTINE_REASON``, and the restore falls back to the newest intact
  one.  Only retention (``CheckpointManager.keep``) deletes.
* **Async**: ``CheckpointManager.save(..., blocking=False)`` copies every
  leaf to host memory before it returns and writes that copy on a
  background thread.  A failed write re-raises on the next ``wait()`` or
  ``save()``.

Where the port differs from the reference, by design:

* the format is a JSON manifest and one ``.npy`` a leaf, where the
  reference writes a msgpack manifest and one ``.npz``;
* the host copy is taken before ``save`` returns because the port's AdamW
  updates the state's tensors in place: a writer that still held device
  tensors would write whatever the next steps left in them;
* a restore copies into the live state's tensors in place (``copy_``),
  after checking every key, shape and dtype against them, and never holds
  a second copy of the state on the device (at full depth the fp32 params
  and Adam moments take 39.6 GB of the card's 80).  A checkpoint holds the
  global state whatever the EP degree that wrote it (the trainer gathers
  the expert leaves first); a restore's ``shard`` takes each leaf's part
  for this rank, read from a memory map of the file;
* numpy has no bfloat16: a bf16 leaf (the Adam moments of a bf16
  ``optimizer_dtype``) is written as its raw 16-bit patterns, a uint16
  ``.npy`` (the port has no uint16 leaf of its own), with "bfloat16" as
  its manifest dtype and its CRC32 over those bits, so a restore is
  bitwise.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import tree_paths
from repro_torch.obs import Telemetry

if TYPE_CHECKING:  # runtime imports checkpoint, not the other way round
    from repro_torch.runtime.faults import FaultInjector

# A real checkpoint dir is exactly "step_<8 digits>": quarantined
# (".corrupt") and in-flight (".tmp") dirs never match, so they are
# invisible to latest_step and to retention.
_STEP_RE = re.compile(r"^step_(\d{8})$")
MANIFEST, DIGEST = "manifest.json", "manifest.crc32"


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested checkpoint failed integrity verification."""


def _leaf_file(key: str) -> str:
    return key.replace("/", ".") + ".npy"


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).data)


# The leaves' CRC32s run on a thread pool: zlib.crc32 releases the GIL on
# a buffer of more than a few KiB, and one thread does ~2.4 GB/s.
CRC_THREADS = min(8, os.cpu_count() or 1)


def _each_leaf(fn: Callable, keys: List[str]) -> List:
    """``[fn(k) for k in keys]``, the calls spread over ``CRC_THREADS``."""
    if len(keys) < 2 or CRC_THREADS < 2:
        return [fn(k) for k in keys]
    with ThreadPoolExecutor(CRC_THREADS) as pool:
        return list(pool.map(fn, keys))


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor leaf (a bf16 one as its uint16 bit
    patterns); a numpy leaf as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _array_dtype(a: np.ndarray) -> str:
    """The manifest dtype of a host array: "bfloat16" for bf16 bits."""
    return "bfloat16" if a.dtype == np.uint16 else str(a.dtype)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor, bf16 bits as bf16."""
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def snapshot(state) -> Dict[str, np.ndarray]:
    """{tree path: host copy} of every leaf, taken now (a flat dict of
    numpy arrays is itself a state that ``save_checkpoint`` takes)."""
    return {k: _host(v) for k, v in tree_paths(state).items()}


def leaf_crc32s(state) -> Dict[str, int]:
    """{tree path: CRC32} of ``state``'s leaves as they are now, copied to
    the host ``CRC_THREADS`` at a time: equal to a manifest's ``crc32`` map
    exactly when the state equals the checkpoint bit for bit."""
    flat = tree_paths(state)
    return dict(zip(flat, _each_leaf(lambda k: _crc32(_host(flat[k])), list(flat))))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_checkpoint(directory, step: int, state, extras: Optional[dict] = None,
                    injector: Optional[FaultInjector] = None,
                    telemetry: Optional[Telemetry] = None) -> Path:
    """Write ``state`` (a tree of tensors or numpy arrays) synchronously;
    returns the checkpoint's path.  The ``ckpt.save`` span carries
    ``bytes`` and the seconds of the CRCs (``crc_s``) and of the writes
    (``write_s``); a tensor leaf is copied to the host first."""
    tel = telemetry if telemetry is not None else Telemetry(enabled=False)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    # The span is emitted even when an injected fault raises mid-write, and
    # may come from the manager's writer thread (obs is thread-safe).
    with tel.span("ckpt.save", step=step) as sp:
        host = snapshot(state)
        sp.set(bytes=int(sum(a.nbytes for a in host.values())))
        if injector is not None:
            injector.raise_if("ckpt.write_fail", step)
        t1 = time.perf_counter()
        crcs = dict(zip(host, _each_leaf(lambda k: _crc32(host[k]), list(host))))
        t2 = time.perf_counter()
        for k, a in host.items():
            np.save(tmp / _leaf_file(k), a, allow_pickle=False)
        manifest = {
            "step": step,
            "keys": list(host),
            "shapes": {k: list(a.shape) for k, a in host.items()},
            "dtypes": {k: _array_dtype(a) for k, a in host.items()},
            "crc32": crcs,
            "extras": extras or {},
        }
        packed = json.dumps(manifest).encode()
        (tmp / MANIFEST).write_bytes(packed)
        (tmp / DIGEST).write_text(str(zlib.crc32(packed)))
        sp.set(crc_s=t2 - t1, write_s=time.perf_counter() - t2)
        if injector is not None:
            injector.raise_if("ckpt.crash_before_rename", step)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        if injector is not None:
            injector.raise_if("ckpt.crash_after_rename", step)
    return final


def checkpoint_steps(directory) -> List[int]:
    """Ascending step numbers of the (not quarantined, not .tmp) checkpoints."""
    d = Path(directory)
    if not d.exists():
        return []
    return sorted(int(m.group(1)) for p in d.iterdir() if (m := _STEP_RE.match(p.name)))


def latest_step(directory) -> Optional[int]:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def read_extras(directory, step: int) -> dict:
    """The manifest's ``extras`` of one checkpoint step.  They live in the
    manifest, so the restore's digest check covers them: verify first
    (restore does)."""
    path = Path(directory) / f"step_{step:08d}" / MANIFEST
    return json.loads(path.read_bytes()).get("extras") or {}


def verify_checkpoint(path) -> Tuple[bool, str]:
    """Integrity-check one checkpoint dir: the manifest's digest, and every
    leaf's shape, dtype and CRC32.  Returns (ok, reason)."""
    path = Path(path)
    mf = path / MANIFEST
    if not mf.exists():
        return False, f"missing {MANIFEST}"
    packed = mf.read_bytes()
    digest_file = path / DIGEST
    if not digest_file.exists():
        return False, f"missing {DIGEST} digest"
    try:
        expect_digest = int(digest_file.read_text().strip())
    except ValueError:
        return False, f"unreadable {DIGEST} digest"
    if zlib.crc32(packed) != expect_digest:
        return False, "manifest digest mismatch"
    try:
        manifest = json.loads(packed)
        keys, crcs = manifest["keys"], manifest["crc32"]
        shapes, dtypes = manifest["shapes"], manifest["dtypes"]
    except (ValueError, KeyError, TypeError) as e:
        return False, f"manifest unreadable: {e!r}"

    def check(key) -> Optional[str]:
        f = path / _leaf_file(key)
        if not f.exists():
            return f"missing array {key!r}"
        try:
            arr = np.load(f, allow_pickle=False)
        except (ValueError, OSError, EOFError) as e:  # truncated or bad header
            return f"array {key!r} unreadable: {e}"
        if list(arr.shape) != list(shapes[key]):
            return f"shape mismatch for {key!r}"
        if _array_dtype(arr) != dtypes[key]:
            return f"dtype mismatch for {key!r}"
        if _crc32(arr) != crcs[key]:
            return f"crc32 mismatch for {key!r}"
        return None

    # Every leaf is read and checked; the first failure in key order wins.
    for reason in _each_leaf(check, list(keys)):
        if reason is not None:
            return False, reason
    return True, "ok"


def quarantine_checkpoint(path, reason: str) -> Path:
    """Rename a corrupt checkpoint out of the restore set, never delete it;
    its reason is written inside for the postmortem."""
    path = Path(path)
    dest = path.with_name(path.name + ".corrupt")
    n = 0
    while dest.exists():
        n += 1
        dest = path.with_name(f"{path.name}.corrupt.{n}")
    os.rename(path, dest)
    try:
        (dest / "QUARANTINE_REASON").write_text(reason + "\n")
    except OSError:
        pass  # best effort: the rename is the quarantine
    return dest


def cleanup_stale_tmp(directory) -> List[str]:
    """Remove ``step_*.tmp`` leftovers of a crash mid-write.  Safe: a
    ``.tmp`` dir is live only while a save is in flight in this process,
    and ``CheckpointManager`` runs one save at a time."""
    d = Path(directory)
    if not d.exists():
        return []
    removed = []
    for p in d.iterdir():
        if p.is_dir() and p.name.endswith(".tmp") and _STEP_RE.match(p.name[:-4]):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p.name)
    return removed


def intact_step(directory, step: Optional[int] = None,
                log_fn: Callable[[str], None] = print,
                telemetry: Optional[Telemetry] = None) -> int:
    """The newest checkpoint step (or ``step``) that passes verification.
    A corrupt candidate is quarantined and the next newest tried; an
    explicitly requested ``step`` that fails raises
    :class:`CheckpointCorruptError` (after the quarantine) instead.
    FileNotFoundError when no candidate is left."""
    tel = telemetry if telemetry is not None else Telemetry(enabled=False)
    explicit = step is not None
    candidates = [step] if explicit else checkpoint_steps(directory)[::-1]
    if not candidates:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    for s in candidates:
        path = Path(directory) / f"step_{s:08d}"
        with tel.span("ckpt.verify", step=s):
            ok, reason = verify_checkpoint(path)
        if ok:
            return s
        dest = quarantine_checkpoint(path, reason)
        log_fn(f"[ckpt] step {s} failed verification ({reason}): quarantined to {dest.name}")
        if explicit:
            raise CheckpointCorruptError(
                f"checkpoint step {s} corrupt: {reason} (quarantined to {dest})")
    raise FileNotFoundError(
        f"no intact checkpoint under {directory} (all candidates failed verification)")


def restore_checkpoint(directory, state, step: Optional[int] = None, verify: bool = True,
                       log_fn: Callable[[str], None] = print,
                       telemetry: Optional[Telemetry] = None,
                       shard: Optional[Callable[[str, np.ndarray], np.ndarray]] = None):
    """Copy a checkpoint into ``state``'s tensors in place; returns
    (state, the checkpoint's step).

    With ``verify`` (the default) the checkpoint is :func:`intact_step`'s:
    a corrupt candidate is quarantined and the restore falls back to the
    next newest, or, for an explicit ``step``, raises.  Without it, the
    newest (or ``step``) is loaded as it is.  ``shard(key, global array)``
    gives this rank's part of a leaf (an expert-parallel rank's expert
    slots); None loads every leaf whole.  A checkpoint whose keys, shapes
    or dtypes differ from ``state``'s raises ValueError before any leaf is
    written."""
    tel = telemetry if telemetry is not None else Telemetry(enabled=False)
    t0 = time.perf_counter()
    if verify:
        step = intact_step(directory, step, log_fn, tel)
    elif step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    t1 = time.perf_counter()
    with tel.span("ckpt.restore", step=step):
        _load_into(Path(directory) / f"step_{step:08d}", state, shard)
    log_fn(f"[ckpt] restored step {step}: verified in {t1 - t0:.3f} s, "
           f"loaded in {time.perf_counter() - t1:.3f} s")
    return state, step


def _load_into(path: Path, state, shard=None) -> None:
    manifest = json.loads((path / MANIFEST).read_bytes())
    live = tree_paths(state)
    if set(live) != set(manifest["keys"]):
        raise ValueError(f"{path.name}: keys {sorted(set(manifest['keys']) ^ set(live))} "
                         f"are not in both the checkpoint and the live state")
    arrays = {}
    for key, t in live.items():
        # A memory map: only the part a shard takes is read.
        a = np.load(path / _leaf_file(key), mmap_mode="r", allow_pickle=False)
        arrays[key] = a if shard is None else shard(key, a)
        want = (list(t.shape), _dtype_name(t))
        got = (list(arrays[key].shape), manifest["dtypes"][key])
        if got != want:
            raise ValueError(f"{path.name}: {key} is {got} in the checkpoint, {want} live")
    with torch.no_grad():
        for key, t in live.items():
            t.copy_(_to_tensor(arrays[key]))


class CheckpointManager:
    """Periodic async checkpointing with retention and error surfacing."""

    def __init__(self, directory, keep: int = 3, every: int = 100,
                 injector: Optional[FaultInjector] = None,
                 log_fn: Callable[[str], None] = print,
                 telemetry: Optional[Telemetry] = None):
        self.directory = Path(directory)
        self.keep = keep
        self.every = every
        self.injector = injector
        self.log_fn = log_fn
        self.telemetry = telemetry if telemetry is not None else Telemetry(enabled=False)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, state, extras: Optional[dict] = None, blocking: bool = True):
        """Snapshot ``state`` to host memory now (the ``ckpt.snapshot``
        span), then write it, on a background thread unless ``blocking``."""
        self.wait()  # one write at a time, and a prior async failure re-raises
        stale = cleanup_stale_tmp(self.directory)
        if stale:
            self.log_fn(f"[ckpt] removed stale tmp dirs: {stale}")
        with self.telemetry.span("ckpt.snapshot", step=step) as sp:
            host = snapshot(state)
            sp.set(bytes=int(sum(a.nbytes for a in host.values())))

        def write():
            save_checkpoint(self.directory, step, host, extras, injector=self.injector,
                            telemetry=self.telemetry)
            self._gc()

        if blocking:
            write()
            return

        def write_captured():
            # A thread's exception would otherwise vanish: park it for
            # wait()/save() to re-raise, so a failed write never passes for
            # a checkpoint.
            try:
                write()
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write_captured, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight; re-raise its error, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in checkpoint_steps(self.directory)[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def _settle(self) -> None:
        self.wait()  # a restore must see the last save (and its errors)
        stale = cleanup_stale_tmp(self.directory)
        if stale:
            self.log_fn(f"[ckpt] removed stale tmp dirs: {stale}")

    def restore_latest(self, state):
        """Restore the newest intact checkpoint into ``state`` in place;
        returns (state, step).  Raises FileNotFoundError if there is none."""
        self._settle()
        return restore_checkpoint(self.directory, state, log_fn=self.log_fn,
                                  telemetry=self.telemetry)

    def latest_intact(self) -> int:
        """The newest intact step (:func:`intact_step`, quarantining on the
        way), after the write in flight; FileNotFoundError if none."""
        self._settle()
        return intact_step(self.directory, log_fn=self.log_fn, telemetry=self.telemetry)

    def extras_for(self, step: int) -> dict:
        """Manifest extras of an already restored (so verified) step."""
        return read_extras(self.directory, step)
