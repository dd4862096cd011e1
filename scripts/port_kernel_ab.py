#!/usr/bin/env python3
"""Kernel times of several trees of the port, on one card.

    python3 scripts/port_kernel_ab.py TREE_A TREE_B [TREE ...]

Each TREE is a checkout of the repository (e.g. the parent commit and the
working tree, each unpacked with ``git archive`` under the git-ignored
``build/``).  The trees run in the order A B ... B A (forward, then
backward), each in a process of its own that builds that tree's kernel
libraries and times its kernels alone at the kernel phase's shapes of this
checkout's ``chip_smoke.py`` (``expert_gemm_cases``: granite-moe-3b-a800m's
capacity prefill and decode ``grouped_matmul_f32``, the ragged serving
steps' ``ragged_matmul_f32`` with fp32 or bf16 rows and
``ragged_gate_up_silu_f32`` with bf16 rows, the train step's ragged GEMMs,
gate-up and both operand pairs of its ``ragged_dw_f32``; bf16
``flash_attention`` at granite's 512- and 64-token prefill;
mamba2-370m's bf16 ``ssd_intra_chunk`` at 4 x 2048, 4 x 100 and 1 x 200),
on inputs from its ``seeded_inputs`` (seed 0) and with its timer
``device_ms`` (CUDA events, median of 30 launches queued behind a
busy-wait), and takes the largest difference of each ragged, gate-up and
SSD output from its plain version.  Prints one line per tree and run, then
the median of each tree's runs per kernel, and the card's name and power
limit.  Needs one CUDA card.
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
from chip_smoke import (ARCH, SSM_ARCH, TRAIN_TOKENS, device_ms, expert_gemm_cases,
                        seeded_inputs)
from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gemm import ops, ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.moe import _capacity

kernels.build()
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


def gate_up(tag, x, wg, wu, o):
    got, launch = ops.ragged_gate_up_silu_f32_launch(x, wg, wu, o)
    ms[tag] = device_ms(launch)
    want = ref.ragged_gate_up_silu_f32(x, wg, wu, o)
    errs[tag] = max(float((a - b).abs().max()) for a, b in zip(got, want))


for tag, tokens in cases["serve"]:
    o = routed_offsets(tokens)
    h, wd = randn(int(o[-1]), f), randn(E, f, d, scale=f ** -0.5, dtype=bf)
    ragged(f"ragged {tag} fp32 h", h, wd, o)
    ragged(f"ragged {tag} bf16 rows", h.to(bf), wd, o)
    x = randn(int(o[-1]), d, dtype=bf)
    gate_up(f"gate-up {tag}", x, *(randn(E, d, f, scale=d ** -0.5, dtype=bf) for _ in "gu"), o)
train = routed_offsets(TRAIN_TOKENS)
rows = int(train[-1])
for K, N, tag in cases["train"]:
    ragged(f"ragged {tag}", randn(rows, K), randn(E, K, N, scale=K ** -0.5, dtype=bf), train)
gate_up(f"gate-up train T={rows}", randn(rows, d, dtype=bf),
        *(randn(E, d, f, scale=d ** -0.5, dtype=bf) for _ in "gu"), train)
for xdt, K, N, tag in cases["dw"]:
    x, gr = randn(rows, K, dtype=xdt), randn(rows, N, scale=1e-2)
    got, launch = ops.ragged_dw_f32_launch(x, gr, train)
    ms[f"dw {tag}"] = device_ms(launch)
    errs[f"dw {tag}"] = float((got - ref.ragged_dw_f32(x, gr, train)).abs().max())
for s in (512, 64):
    qkv = randn(1, s, arch.num_heads + 2 * arch.num_kv_heads, arch.head_dim, dtype=bf)
    hq, hkv = arch.num_heads, arch.num_kv_heads
    ms[f"flash s={s}"] = device_ms(fa_ops.flash_attention_launch(
        qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:])[1])
sa = get_arch(SSM_ARCH)
sh, sp, sn = sa.ssm.num_heads(sa.d_model), sa.ssm.head_dim, sa.ssm.state_size
for G, cl in ((32, 256), (4, 100), (1, 200)):
    x = randn(G, cl, sh, sp, scale=0.1, dtype=bf)
    dA = (-randn(G, cl, sh).abs() * 0.1).to(bf)
    B, C = (randn(G, cl, 1, sn, scale=0.5, dtype=bf).expand(G, cl, sh, sn) for _ in "BC")
    got, launch = ssd_ops.ssd_intra_chunk_launch(x, dA, B, C)
    ms[f"ssd g={G} cl={cl}"] = device_ms(launch)
    errs[f"ssd g={G} cl={cl}"] = float(
        (got.float() - ssd_ref.ssd_intra_chunk(x.float(), dA.float(), B.float(), C.float())
         .to(bf).float()).abs().max())
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
