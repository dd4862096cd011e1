"""Roofline of the dry run's records, modeled for one NVIDIA H100.

The port of the reference's ``launch/roofline.py``.  A cell's terms, from
one rank's trace (``launch.dryrun``) and ``core.platform.H100``'s datasheet
peaks:

    compute term    = FLOPs a rank / peak_flops            [seconds]
    memory term     = bytes a rank / hbm_bw                [seconds]
    collective term = collective wire bytes a rank / link_bw [seconds]

Bytes are ``bytes_large`` (operands and results of at least 1 MiB).
``model_flops`` is the standard accounting: 6 * N_active * tokens to
train (forward and backward), 2 * N_active * tokens to serve; its ratio
to the traced FLOPs of all ranks shows recompute, padding and repeated
work (tp lanes running their EP group's tokens again).

Every figure is modeled for the H100 from the datasheet, not measured.
The reference's compiled-module fields that PyTorch has no counterpart of
(``code_bytes``, ``compile_seconds``, ``raw_flops_once``) are not in the
port's records.

Usage::

    python -m repro_torch.launch.roofline            # table of results/dryrun_torch
    python -m repro_torch.launch.roofline --csv out.csv
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import SHAPES, get_arch
from repro_torch.core.platform import H100

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops(arch_name: str, shape_name: str) -> float:
    """6 N_active tokens to train, 2 N_active tokens to prefill, 2 N_active
    a sequence to decode (one token each)."""
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    n = arch.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def roofline_terms(record: dict, platform=H100) -> Optional[dict]:
    """The terms, the dominant one, the useful-FLOPs ratio and the
    roofline MFU of an "ok" record on ``platform``; None otherwise."""
    if record.get("status") != "ok":
        return None
    chips = record["chips"]
    flops = record["cost"]["flops"]
    t = {"compute_s": flops / platform.peak_flops,
         "memory_s": record["cost"]["bytes_large"] / platform.hbm_bw,
         "collective_s": record["collectives"]["total_wire_bytes_bf16adj"] / platform.link_bw}
    bound = max(t.values())
    mf = model_flops(record["arch"], record["shape"])
    return {**t, "dominant": max(t, key=t.get)[:-2], "bound_s": bound, "model_flops": mf,
            "useful_flops_ratio": mf / (flops * chips) if flops else 0.0,
            "roofline_mfu": mf / chips / platform.peak_flops / bound if bound else 0.0,
            "mem_per_device_gb": record["memory"]["peak_bytes"] / 1e9}


def load_records(results_dir: Path = RESULTS_DIR) -> Dict[str, dict]:
    out = {}
    for f in sorted(results_dir.glob("*.json")):
        rec = json.loads(f.read_text())
        out[rec["cell"]] = rec
    return out


def header(platform=H100) -> str:
    return (f"modeled for {platform.name} (NVIDIA H100 SXM5 80GB HBM3, 700 W) from its "
            f"datasheet peaks: {platform.peak_flops / 1e12:.1f} TFLOP/s bf16, HBM "
            f"{platform.hbm_bw / 1e12:.2f} TB/s, link {platform.link_bw / 1e9:.0f} GB/s; "
            f"not measured")


def table(records: Dict[str, dict], multi_pod: Optional[bool] = False) -> str:
    cols = (f"{'cell':58s} {'mem/dev':>8s} {'comp_ms':>9s} {'mem_ms':>9s} "
            f"{'coll_ms':>9s} {'domin':>10s} {'useful':>7s} {'roofMFU':>8s}")
    rows = [header(), cols, "-" * len(cols)]
    for cell, rec in records.items():
        if multi_pod is not None and rec.get("multi_pod") != multi_pod:
            continue
        if rec.get("status") == "skipped":
            rows.append(f"{cell:58s} SKIPPED: {rec.get('reason', '')}")
            continue
        if rec.get("status") != "ok":
            rows.append(f"{cell:58s} ERROR: {rec.get('error', '')[:60]}")
            continue
        t = roofline_terms(rec)
        rows.append(f"{cell:58s} {t['mem_per_device_gb']:7.2f}G "
                    f"{t['compute_s'] * 1e3:9.2f} {t['memory_s'] * 1e3:9.2f} "
                    f"{t['collective_s'] * 1e3:9.2f} {t['dominant']:>10s} "
                    f"{t['useful_flops_ratio'] * 100:6.1f}% {t['roofline_mfu'] * 100:7.2f}%")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Roofline of the port's dry-run records, "
                                             "modeled for the H100")
    ap.add_argument("--csv")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all-meshes", action="store_true")
    args = ap.parse_args(argv)
    records = load_records()
    print(table(records, multi_pod=None if args.all_meshes else args.multi_pod))
    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["cell", "arch", "shape", "multi_pod", "pipeline", "chips",
                        "mem_per_device_gb", "compute_s", "memory_s", "collective_s",
                        "dominant", "useful_flops_ratio", "roofline_mfu"])
            for cell, rec in records.items():
                t = roofline_terms(rec)
                if t is None:
                    continue
                w.writerow([cell, rec["arch"], rec["shape"], rec["multi_pod"],
                            rec["pipeline"], rec["chips"], t["mem_per_device_gb"],
                            t["compute_s"], t["memory_s"], t["collective_s"],
                            t["dominant"], t["useful_flops_ratio"], t["roofline_mfu"]])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
