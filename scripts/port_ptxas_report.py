#!/usr/bin/env python3
"""Registers, spills and stack of every kernel of the port's CUDA sources,
as ``ptxas -v`` reports them for ``sm_90a``.

    python3 scripts/port_ptxas_report.py [SOURCE ...]

SOURCE names a file ``src/repro_torch/kernels/csrc/<SOURCE>.cu`` (default:
``flash_attention`` and ``flash_attention_tc``).  Each is compiled to a
cubin with the port's own flags (``repro_torch.kernels._build.NVCC_FLAGS``
without ``-shared``) and ``-Xptxas -v``, all at once; the script prints one
JSON line a kernel instantiation: source, demangled name, registers,
spill stores and loads (bytes), stack frame (bytes) and static shared
memory (bytes).  Needs ``nvcc`` (the card's machine); the card itself is
not used.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

DEFAULT = ("flash_attention", "flash_attention_tc")


def _demangle(names):
    tool = shutil.which("cu++filt") or str(Path(_build._nvcc()).with_name("cu++filt"))
    if not Path(tool).exists():
        tool = shutil.which("c++filt")
    if not tool:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    got = out.stdout.splitlines()
    return got if len(got) == len(names) else list(names)


def parse(log: str):
    """[{symbol, registers, spill_stores, spill_loads, stack, smem}] from
    ``ptxas -v`` output."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"symbol": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def main(argv) -> int:
    sources = argv or list(DEFAULT)
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build" if (ROOT / "build").exists()
                                     else None) as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", f"{tmp}/{src}.cubin",
             str(_build.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in sources]
        failed = 0
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"[ptxas] {src}: nvcc exit {proc.returncode}\n{log}")
                failed += 1
                continue
            rows = parse(log)
            for row, name in zip(rows, _demangle([r["symbol"] for r in rows])):
                row = {"source": src, "kernel": name, **{k: v for k, v in row.items()
                                                         if k != "symbol"}}
                print(json.dumps(row))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
