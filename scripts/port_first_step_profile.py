"""Where a gloo rank's first train step spends its time on the card.

Spawns two gloo ranks sharing the one card (``chip_smoke.py``'s
``_MeshRun``), each holding its shard of granite at full width and depth
1 at ``--mesh 1,2``, and times three ``training.loss_and_grads`` calls of
2 x 512 tokens a rank: every collective and kernel launch with the card
synchronized around it, and rank 0's first call under ``cProfile`` (the
top entries by own and by cumulative time are printed).  Run it from the
root of a checkout on a machine with a card::

    python3 scripts/port_first_step_profile.py

Set ``PYTHONPYCACHEPREFIX`` to compare a run whose ranks find a bytecode
cache with one whose ranks compile every module from source.
"""

import collections
import cProfile
import io
import json
import pstats
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _rank(rank: int, world: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    spent, calls = collections.defaultdict(float), collections.Counter()

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        return run

    for name in ("all_gather", "all_reduce", "all_to_all_single"):
        setattr(dist, name, timed(getattr(dist, name), name))
    import chip_smoke as cs
    from repro_torch import sharding, training
    from repro_torch.convert import shard_params
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.models.model import LanguageModel, init_params

    call = _build.Kernel.__call__
    _build.Kernel.__call__ = lambda self, *a: timed(call, "kernel " + self.symbol)(self, *a)
    run = cs._MeshRun(rank, world, tmp, "first")
    arch = cs._mesh_arch(1)
    params = init_params(arch, torch.Generator(device=run.dev).manual_seed(0), run.dev)
    plan = sharding.make_plan(arch, (1, world))
    batch = SyntheticTokens(arch.vocab_size, 2 * world, 512).batch_at(0)
    mine = shard_params(params, plan)
    run.start()
    out = {}
    for i in range(3):
        spent.clear()
        calls.clear()
        prof = cProfile.Profile() if i == 0 and rank == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        training.loss_and_grads(LanguageModel(arch, plan), mine, batch)
        torch.cuda.synchronize()
        if prof:
            prof.disable()
            for key in ("tottime", "cumulative"):
                buf = io.StringIO()
                pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(20)
                out[f"profile by {key}"] = buf.getvalue()
        top = sorted(spent.items(), key=lambda kv: -kv[1])[:6]
        out[f"call {i}"] = {"seconds": round(time.perf_counter() - t0, 3),
                            "top": [(k, round(v, 3), calls[k]) for k, v in top]}
    Path(tmp, f"first{rank}.json").write_text(json.dumps(out))
    run.finish()


def main() -> None:
    import torch.multiprocessing as mp

    from repro_torch import kernels

    kernels.build()
    tmp = tempfile.mkdtemp(prefix="first_step_")
    t0 = time.perf_counter()
    mp.start_processes(_rank, args=(2, tmp), nprocs=2, start_method="spawn")
    print(f"two ranks spawned, run and joined in {time.perf_counter() - t0:.1f} s")
    res = json.loads(Path(tmp, "first0.json").read_text())
    for key in ("profile by tottime", "profile by cumulative"):
        print(res.pop(key))
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
