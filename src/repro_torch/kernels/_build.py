"""Build and bind the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use (never at import), land in ``build/repro_torch_kernels/``
at the root of the checkout (listed in ``.gitignore``), and are keyed by a
hash of the sources so an edited kernel is never served stale.  ``build()``
starts one ``nvcc`` per missing library, all at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises when that is not 0, and
counts its launches so a run can show which kernels it went through: under
the wrapper's name (one per wrapper call, whichever design ran) and, where
a wrapper has several designs, under ``<wrapper>/<design>`` as well.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("moe_gemm", "moe_gemm_tc", "flash_attention", "flash_attention_tc", "ssd",
           "ssd_tc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
COUNTS: Dict[str, int] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """Library path for ``csrc/<name>.cu``, keyed by the sources' hash."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every missing library of ``names`` in parallel; raise with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of a built library, with its launch counts.

    ``argtypes`` lists the C arguments before the trailing stream; every
    pointer and the stream travel as ``c_void_p`` (a bare Python int would
    be cut to 32 bits).  Tensor arguments are passed as their data
    pointers, converted at the call, so whoever holds the arguments keeps
    the tensors alive.  Each launch adds one to every name in ``counters``
    (default: the symbol), e.g. ``("flash_attention", "flash_attention/tc")``;
    two designs built from one entry point are two instances with their
    own counters.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 counters: Sequence[str] = ()):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.counters = tuple(counters) or (symbol,)
        self._fn = None
        for name in self.counters:
            COUNTS.setdefault(name, 0)

    @property
    def path(self) -> str:
        """The kernel's source file, relative to the root of the checkout."""
        return (CSRC / f"{self.source}.cu").relative_to(CSRC.parents[3]).as_posix()

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        rc = self._fn(*(ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                        else a for a in args), stream)
        for name in self.counters:
            COUNTS[name] += 1
        if rc != 0:
            msg = load(self.source).repro_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} ({rc})")


def launch_counts() -> Dict[str, int]:
    return dict(COUNTS)


def reset_launch_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device, else ValueError."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"kernel inputs must all be on one CUDA device (or all on "
                f"the CPU for the plain version); got {[str(x.device) for x in tensors]}"
            )
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True only when every tensor lies on the CPU: the sole case in which
    a wrapper takes its kernel's plain version."""
    return all(t.device.type == "cpu" for t in tensors)


def check_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in FLOAT_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (fp32, bf16)")
    return FLOAT_CODES[t.dtype]
