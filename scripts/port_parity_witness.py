"""Is the fp32 gap between the paged decode and the uncached forward fp32
rounding, or a defect of the paged path?

Replays ``chip_smoke.py``'s musicgen-large case (``MUSICGEN_SERVE_ARGS``:
``launch.serve.serve`` in bf16 on the card, then request 0's sequence) at
full width and depth with the same fp32 weights, and takes the logits of
each compared position (the prefill's last, then one a decode step) on
two paths, paged and uncached, in each of three legs:

* card fp32: the paged prefill and decode steps (the kernels) and the
  uncached forward, as ``launch.serve.parity_probe`` compares them;
* host fp32: the same two on the machine's CPU (the kernels' plain
  versions, another summation order);
* host float64: the same two with every ``Tensor.float()`` of the model
  made a cast to float64 and a float64 cache, the same weights widened
  exactly: the witness of the exact function.

It prints every pairwise max |dlogits| over the compared positions and
the logits' largest magnitude, then all of it as one JSON line.  If the paged path is right, paged
and uncached agree in float64 to ~1e-12 and each fp32 path lies about as
far from float64 as the two fp32 paths lie from each other.  Run it from
the root of a checkout on a machine with a card and room on the host
for the weights in float64 (3.230 B parameters, 25.8 GB) beside their
fp32 copy::

    python3 scripts/port_parity_witness.py
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


@contextlib.contextmanager
def float_is_double():
    """Every ``Tensor.float()`` (the model's fp32 upcasts: norms, scores,
    logits) returns float64 inside the block."""
    import torch

    old = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = old


def compared_logits(lm, params, layout, seq, plen, cache_dtype):
    """(paged, uncached): the logits of positions plen - 1 .. len(seq) - 1,
    the paged ones from a prefill of ``seq[:plen]`` and one decode step a
    later token (``launch.serve.parity_probe``'s steps)."""
    import numpy as np
    import torch

    from repro_torch.serving.kv_cache import BlockPool

    dev = params["embed"].device
    pool = BlockPool(layout)
    slot = pool.admit(plen)
    cache = lm.init_paged_cache(layout, dtype=cache_dtype, device=dev)
    toks = torch.from_numpy(seq.astype(np.int64)).to(dev)
    with torch.no_grad():
        logits, cache = lm.prefill_paged(params, {"tokens": toks[None, :plen]}, cache,
                                         pool.device_tables(dev)[0][slot:slot + 1],
                                         torch.tensor([plen], device=dev))
        paged = [logits[0]]
        for i in range(len(seq) - plen):
            pool.extend(slot, 1)
            logits, cache = lm.decode_step_paged(
                params, cache, pool.device_tables(dev)[0][slot:slot + 1],
                torch.tensor([plen + i], device=dev),
                {"tokens": toks[None, plen + i:plen + i + 1]})
            paged.append(logits[0])
        full, _, _ = lm.forward(params, {"tokens": toks[None]})
    return torch.stack(paged).cpu(), full[0, plen - 1:].cpu()


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel, map_tree

    if not torch.cuda.is_available():
        print("no CUDA device: this witness runs its fp32 leg on the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.get_num_threads()} host threads", flush=True)
    arch = get_arch(cs.MUSICGEN)
    _, case = serve.serve(serve.parse_args(cs.MUSICGEN_SERVE_ARGS))
    layout = dataclasses.replace(case.layout, max_seqs=1,
                                 num_blocks=-(-len(case.seq) // case.layout.block_size) + 1)
    lm = LanguageModel(arch)
    logits, secs = {}, {}

    def leg(name, params, cache_dtype):
        t0 = time.perf_counter()
        logits[name] = compared_logits(lm, params, layout, case.seq, case.plen, cache_dtype)
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"[witness] {name}: {secs[name]} s", flush=True)

    params = serve._weights(arch, case.device, case.seed, "float32")
    leg("card fp32", params, torch.float32)
    params = map_tree(lambda t: t.cpu(), params)
    torch.cuda.empty_cache()
    leg("host fp32", params, torch.float32)
    params = map_tree(lambda t: t.double(), params)
    with float_is_double():
        leg("host float64", params, torch.float64)
    del params

    exact = logits["host float64"][1]
    paths = {f"{leg} {kind}": pair[i].double() for leg, pair in logits.items()
             for i, kind in enumerate(("paged", "uncached"))}
    gaps = {f"{a} vs {b}": float((paths[a] - paths[b]).abs().max())
            for i, a in enumerate(paths) for b in list(paths)[i + 1:]}
    out = {"arch": arch.name, "prompt": case.plen, "positions": len(case.seq) - case.plen + 1,
           "max_abs_logit": float(exact[..., :arch.vocab_size].abs().max()),
           "gate": serve.PARITY_BOUND, "seconds": secs, "max_abs_dlogits": gaps}
    for k, v in gaps.items():
        print(f"[witness] {k}: max |dlogits| {v:.3e}")
    print(f"[witness] logits' largest magnitude (float64) {out['max_abs_logit']:.4f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
