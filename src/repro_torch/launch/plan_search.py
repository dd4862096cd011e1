"""Piper strategy search (the paper's §III-C/IV-C workflow), the twin of
``examples/plan_search.py`` over the port's planner and platforms: given a
model and a platform, enumerate the memory-feasible (PP, EP, DP, policy)
strategies and rank them by estimated MFU.  It prices, and runs nothing.

    PYTHONPATH=src python -m repro_torch.launch.plan_search
    PYTHONPATH=src python -m repro_torch.launch.plan_search \\
        --arch granite-moe-3b-a800m --platform h100-sxm --chips 64 --zero world
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_arch, list_archs
from repro_torch.core import planner
from repro_torch.core.platform import PLATFORMS


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="piper-super-545b", choices=list_archs())
    ap.add_argument("--platform", default="frontier-mi250x", choices=sorted(PLATFORMS))
    ap.add_argument("--chips", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--zero", default="dp", choices=["none", "dp", "world"])
    ap.add_argument("--top", type=int, default=10)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> list:
    """Print the search, as the reference's example does; returns the
    ranked strategies."""
    args = parse_args(argv)
    arch = get_arch(args.arch)
    platform = PLATFORMS[args.platform]
    print(f"{arch.name}: {arch.total_params()/1e9:.0f}B total / "
          f"{arch.active_params()/1e9:.0f}B active")
    print(f"platform: {platform.name} x{args.chips} chips "
          f"(HBM {platform.hbm_bytes/1e9:.0f}GB, fast domain "
          f"{platform.fast_domain})")
    strategies = planner.valid_strategies(arch, platform, args.chips, batch=args.batch,
                                          seq=args.seq, zero=args.zero)
    print(f"{len(strategies)} feasible strategies (Eq 7-11); top "
          f"{args.top} by estimated MFU (Eq 12):\n")
    ranked = planner.rank_strategies(strategies)
    for s in ranked[:args.top]:
        print("  " + s.describe())
    if ranked:
        best = ranked[0]
        print(f"\nchosen: PP={best.PP} EP={best.EP} DP={best.DP} "
              f"schedule={best.schedule} vstages={best.vstages} "
              f"dispatch={best.dispatch} "
              f"(executor binds the schedule via MeshPlan.schedule/"
              f"MeshPlan.vstages and the dispatch via MoECfg.dispatch)")
    else:
        print("  NONE — increase chips, enable ZeRO (--zero world), or "
              "reduce batch.")
    return ranked


if __name__ == "__main__":
    main()
