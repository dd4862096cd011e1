#!/usr/bin/env python3
"""Expert-GEMM kernel times of several trees of the port, on one card.

    python3 scripts/port_kernel_ab.py TREE_A TREE_B [TREE ...]

Each TREE is a checkout of the repository (e.g. the parent commit and the
working tree, each unpacked with ``git archive`` under the git-ignored
``build/``).  The trees run in the order A B ... B A (forward, then
backward), each in a process of its own that builds that tree's
``moe_gemm`` and ``moe_gemm_tc`` libraries and times its kernels alone at
the kernel phase's expert GEMMs of this checkout's ``chip_smoke.py``
(``expert_gemm_cases``: granite-moe-3b-a800m's capacity prefill and decode
``grouped_matmul_f32``, the ragged serving steps' ``ragged_matmul_f32``
with fp32 or bf16 rows, the train step's ragged GEMMs and both operand
pairs of its ``ragged_dw_f32``), on inputs from its ``seeded_inputs``
(seed 0) and with its timer ``device_ms`` (CUDA events, median of 30
launches queued behind a busy-wait), and takes the largest difference of
each ragged output from its plain version.  Prints one line per tree and
run, then the median of each tree's runs per kernel, and the card's name
and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[1])
CHILD = r'''
import json, sys
import torch
root, tree = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, tree + "/src"]  # this checkout's chip_smoke, the tree's port
from chip_smoke import (ARCH, TRAIN_TOKENS, device_ms, expert_gemm_cases,
                        seeded_inputs)
from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.kernels.moe_gemm import ops, ref
from repro_torch.models.moe import _capacity

kernels.build(["moe_gemm", "moe_gemm_tc"])
arch = get_arch(ARCH)
d, f, E, k = arch.d_model, arch.moe.d_ff, arch.moe.num_experts, arch.moe.top_k
_, randn, routed_offsets = seeded_inputs(torch.device("cuda"), E, k)
cases = expert_gemm_cases(arch, _capacity)
bf = torch.bfloat16
ms, errs = {}, {}
for M, K, N, tag in cases["grouped"]:
    x = randn(E, M, K, dtype=torch.float32 if "down" in tag else bf)
    ms[f"grouped {tag}"] = device_ms(
        ops.grouped_matmul_f32_launch(x, randn(E, K, N, scale=K ** -0.5, dtype=bf))[1])


def ragged(tag, x, w, o):
    got, launch = ops.ragged_matmul_f32_launch(x, w, o)
    ms[tag] = device_ms(launch)
    errs[tag] = float((got - ref.ragged_matmul_f32(x, w, o)).abs().max())


for tag, tokens in cases["serve"]:
    o = routed_offsets(tokens)
    h, wd = randn(int(o[-1]), f), randn(E, f, d, scale=f ** -0.5, dtype=bf)
    ragged(f"ragged {tag} fp32 h", h, wd, o)
    ragged(f"ragged {tag} bf16 rows", h.to(bf), wd, o)
train = routed_offsets(TRAIN_TOKENS)
rows = int(train[-1])
for K, N, tag in cases["train"]:
    ragged(f"ragged {tag}", randn(rows, K), randn(E, K, N, scale=K ** -0.5, dtype=bf), train)
for xdt, K, N, tag in cases["dw"]:
    x, gr = randn(rows, K, dtype=xdt), randn(rows, N, scale=1e-2)
    got, launch = ops.ragged_dw_f32_launch(x, gr, train)
    ms[f"dw {tag}"] = device_ms(launch)
    errs[f"dw {tag}"] = float((got - ref.ragged_dw_f32(x, gr, train)).abs().max())
print(json.dumps({"ms": ms, "max_abs_err": errs}))
'''


def main() -> None:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]]
    if len(trees) < 2:
        sys.exit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = {t: [] for t in trees}
    for t in trees + trees[::-1]:
        res = subprocess.run([sys.executable, "-c", CHILD, ROOT, t], capture_output=True,
                             text=True)
        if res.returncode:
            sys.exit(f"{t}: exit {res.returncode}\n{res.stdout}\n{res.stderr}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        runs[t].append(line["ms"])
        print(f"[ab] {t}: ms {line['ms']}, max_abs_err against the plain version "
              f"{line['max_abs_err']}", flush=True)
    names = list(runs[trees[0]][0])
    print("[ab] median ms per kernel: " + " | ".join(Path(t).name for t in trees))
    for n in names:
        meds = [statistics.median(r[n] for r in runs[t]) for t in trees]
        print(f"[ab] {n}: " + " | ".join(f"{m:.4f}" for m in meds))
    print(card)


if __name__ == "__main__":
    main()
