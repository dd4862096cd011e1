"""How far apart do equivalent summation orders put mamba2-370m's outputs?

Replays ``chip_smoke.py``'s phase "mesh" (h) inputs (``_seq_ssm_case``:
mamba2-370m full width and depth, fp32 weights from seed 0) through the
dense-cache steps (``_seq_generate``) on several paths that compute the
same function in other orders:

* ``world1``: one rank, the whole 2 x 2048 prompt;
* ``rows``: one rank, each prompt row alone (other GEMM shapes);
* ``chunk128``: one rank, the SSD at chunk 128 (another inter-chunk
  recurrence);
* ``split``: four gloo ranks at ``--mesh 1,4`` sharing the card, each
  scanning its 512 positions with the state handed rank to rank (rank 0's
  outputs);
* ``float64`` (fp32 legs only): one rank on the host with every
  ``Tensor.float()`` made a cast to float64, the weights widened exactly:
  the witness of the exact function.

For the fp32 fed run (2 x 2048 + 8 steps) it prints every pair's max
|dlogits| over the prefill and the steps, and the worst cache leaf's max
|d| beside max(1, its magnitude); for the bf16 greedy run (4 x 2048 + 16
steps) each path's rows whose tokens leave world 1's and world 1's top-2
gap there; then all of it as one JSON line.  If the split is the same
function, it lies about as far from ``float64`` and from ``world1`` as the
other one-rank orders do.  Run it from the root of a checkout on a
machine with a card (the float64 leg holds 2.9 GB of weights on the
host)::

    python3 scripts/port_ssm_seq_witness.py
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


@contextlib.contextmanager
def float_is_double():
    """Every ``Tensor.float()`` returns float64 inside the block."""
    import torch

    old = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = old


def _runs(lm, params, inp, rows: bool = False) -> dict:
    """The fp32 fed run and (params on the card) the bf16 greedy run: each
    {"logits": [...], "cache": {...}} / {"tokens", "gaps"} on the host;
    ``rows``: one prompt row a call, the rows' outputs stacked."""
    import numpy as np
    import torch

    import chip_smoke as cs

    (b, l, k), (fb, fl, fk) = cs.SEQ_SSM["bf16"], cs.SEQ_SSM["fp32"]

    def fp32(sl):
        return cs._seq_generate(lm, params, inp["fp32"][sl], fl + fk, fk, inp["feed"][sl],
                                keep_cache=True)

    def bf16(sl):
        return cs._seq_generate(lm, cs._bf16(params), inp["bf16"][sl], l + k, k)

    parts = [slice(i, i + 1) for i in range(fb)] if rows else [slice(None)]
    got = [fp32(sl) for sl in parts]
    out = {"fp32": {"logits": [torch.cat([g["logits"][i] for g in got])
                               for i in range(fk + 1)],
                    "cache": {p: torch.cat([g["cache"][p] for g in got], dim=1)
                              for p in got[0]["cache"]}}}
    if params["embed"].is_cuda:
        parts = [slice(i, i + 1) for i in range(b)] if rows else [slice(None)]
        got = [bf16(sl) for sl in parts]
        out["bf16"] = {key: np.concatenate([g[key] for g in got])
                       for key in ("tokens", "gaps")}
    return out


def _split_rank(rank: int, world: int, tmp: str) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import sharding
    from repro_torch.convert import shard_params
    from repro_torch.models.model import LanguageModel

    sys.path.insert(0, str(ROOT / "src"))
    run = cs._MeshRun(rank, world, tmp, "witness")
    run.start()
    arch, params, inp = cs._seq_ssm_case(run.dev)
    plan = cs._mem_plans(sharding.make_plan(arch, cs.SEQ_SSM["mesh"]))["whole"]
    out = _runs(LanguageModel(arch, plan), shard_params(params, plan), inp)
    if rank == 0:
        torch.save(out, f"{tmp}/split.pt")
    run.finish()


def main() -> int:
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.device import resolve_device
    from repro_torch.models.model import LanguageModel, map_tree

    if not torch.cuda.is_available():
        print("no CUDA device: this witness runs its legs on the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    kernels.build()
    dev = resolve_device("cuda")
    legs, secs = {}, {}

    def leg(name, fn):
        t0 = time.perf_counter()
        legs[name] = fn()
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"[witness] {name}: {secs[name]} s", flush=True)

    arch, params, inp = cs._seq_ssm_case(dev)
    lm = LanguageModel(arch)
    leg("world1", lambda: _runs(lm, params, inp))
    leg("rows", lambda: _runs(lm, params, inp, rows=True))
    a128 = arch.replace(ssm=dataclasses.replace(arch.ssm, chunk_size=128))
    leg("chunk128", lambda: _runs(LanguageModel(a128), params, inp))
    tmp = tempfile.mkdtemp()

    def split():
        mp.start_processes(_split_rank, args=(4, tmp), nprocs=4, start_method="spawn")
        return torch.load(f"{tmp}/split.pt", weights_only=False)  # this run's own file

    leg("split", split)
    host = map_tree(lambda t: t.cpu().double(), params)
    del params
    torch.cuda.empty_cache()
    with float_is_double():
        leg("float64", lambda: _runs(lm, host, inp))

    V = arch.vocab_size
    names = list(legs)
    pairs, caches = {}, {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            la, lb = legs[a]["fp32"]["logits"], legs[b]["fp32"]["logits"]
            pairs[f"{a} vs {b}"] = max(float((x[:, :V].double() - y[:, :V].double()).abs().max())
                                       for x, y in zip(la, lb))
            ca, cb = legs[a]["fp32"]["cache"], legs[b]["fp32"]["cache"]
            worst = max(((float((ca[p].double() - cb[p].double()).abs().max()),
                          max(1.0, float(cb[p].double().abs().max())), p) for p in cb),
                        key=lambda t: t[0] / t[1])
            caches[f"{a} vs {b}"] = {"leaf": worst[2], "max_abs": worst[0], "scale": worst[1]}
    ref = legs["world1"]["bf16"]
    tokens = {}
    for name in names:
        if name in ("world1", "float64"):
            continue
        got = legs[name]["bf16"]["tokens"]
        rows, cols = np.nonzero(got != ref["tokens"])
        first = {int(r): int(c) for r, c in zip(rows[::-1], cols[::-1])}
        tokens[name] = {"rows_diverging": len(first), "at": first,
                        "world1_gap_there": max((float(ref["gaps"][r, c])
                                                 for r, c in first.items()), default=0.0)}
    mag = max(float(x[:, :V].abs().max()) for x in legs["float64"]["fp32"]["logits"])
    for k, v in pairs.items():
        c = caches[k]
        print(f"[witness] fp32 {k}: max |dlogits| {v:.3e}; worst cache leaf {c['leaf']} "
              f"{c['max_abs']:.3e} (max(1, |leaf|) {c['scale']:.2f})")
    for k, v in tokens.items():
        print(f"[witness] bf16 {k} vs world1: {v['rows_diverging']} rows diverge, at {v['at']}, "
              f"world 1's top-2 gap there at most {v['world1_gap_there']:.3e}")
    print(f"[witness] logits' largest magnitude (float64) {mag:.4f}")
    print(json.dumps({"arch": arch.name, "seconds": secs, "max_abs_logit": mag,
                      "fp32_max_abs_dlogits": pairs, "fp32_cache": caches,
                      "bf16_tokens": tokens}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
