#!/usr/bin/env python3
"""Wall seconds of each CUDA source's ``nvcc`` build, all started together
as ``repro_torch.kernels._build.build`` starts them (so the slowest bounds
the build that ``chip_smoke.py`` waits for), then of each source named on
the command line alone.

    python3 scripts/port_build_times.py [SOURCE ...]

Compiles with the port's own flags into a temporary directory, leaving
``build/`` untouched, and prints one JSON line.  Needs ``nvcc`` (the card's
machine); the card itself is not used.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def main(alone) -> int:
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        def cmd(name):
            return [nvcc, *_build.NVCC_FLAGS, "-o", f"{tmp}/{name}.so",
                    str(_build.CSRC / f"{name}.cu")]

        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(cmd(n)) for n in _build.SOURCES}
        together = {}
        while len(together) < len(procs):
            for n, p in procs.items():
                if n not in together and p.poll() is not None:
                    if p.returncode:
                        raise SystemExit(f"{n}: nvcc exit {p.returncode}")
                    together[n] = round(time.perf_counter() - t0, 1)
            time.sleep(0.05)
        single = {}
        for n in alone:
            t = time.perf_counter()
            subprocess.run(cmd(n), check=True)
            single[n] = round(time.perf_counter() - t, 1)
    print(json.dumps({"together": together, "alone": single}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
