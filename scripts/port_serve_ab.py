#!/usr/bin/env python3
"""Capacity serving of two checkouts of the PyTorch port, alternated on one card.

    python3 scripts/port_serve_ab.py OLD_ROOT NEW_ROOT

Each checkout's CUDA kernels are built first (``repro_torch.kernels.build()``)
so that no timed run pays ``nvcc``.  Then four runs, OLD NEW NEW OLD, are
each one process that imports ``repro_torch`` from that checkout's ``src``
and calls ``repro_torch.launch.serve.serve``: the serve driver
(``python -m repro_torch.launch.serve --dispatch capacity``) without its
parity probe, at the serving phase's arguments of this checkout's
``chip_smoke.py`` (``SERVE_ARGS``: granite-moe-3b-a800m at full width, 8
seeded requests of 64-512 prompt tokens, 32 new tokens each, 4 sequences
decoding together, bf16).  It prints one line per run (prefill mean,
decode-step p50, decode tokens/s, engine wall time) and the card's name and
power limit.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import SERVE_ARGS  # noqa: E402  (the one definition of the workload)

ORDER = "ONNO"  # O = OLD_ROOT, N = NEW_ROOT; mirrored, so a drift of the card weighs on both alike
_RUN = ("import json, sys\n"
        "from repro_torch.launch import serve\n"
        "s, _ = serve.serve(serve.parse_args(sys.argv[1:]))\n"
        "print('AB_SUMMARY ' + json.dumps(s))\n")


def _python(root: str, code: str, args=()) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=root, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"run in {root} failed ({out.returncode}):\n{out.stdout}\n{out.stderr}")
    return out.stdout


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    a = ap.parse_args()
    roots = {"O": os.path.abspath(a.old), "N": os.path.abspath(a.new)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tag, root in roots.items():
        t0 = time.perf_counter()
        _python(root, "from repro_torch import kernels; kernels.build()")
        print(f"[ab] {tag} {root}: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for i, tag in enumerate(ORDER):
        out = _python(roots[tag], _RUN, SERVE_ARGS + ["--dispatch", "capacity"])
        s = json.loads(next(l for l in out.splitlines() if l.startswith("AB_SUMMARY "))[11:])
        print(f"[ab] run {i} {tag}: {s['finished']}/{s['requests']} finished, prefill mean "
              f"{s['prefill_ms_mean']:.3f} ms, decode step p50 {s['decode_step_p50_ms']:.3f} ms, "
              f"decode {s['decode_tok_s']:.2f} tok/s, engine wall {s['wall_s']:.3f} s "
              f"({s['dispatch']}, {s['steps']} steps)", flush=True)


if __name__ == "__main__":
    main()
