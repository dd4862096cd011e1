"""Model-vs-measured drift tracking.

Piper's strategy search is only as good as its resource model, and the
model is only trustworthy while measurements keep agreeing with it.  A
``DriftTracker`` is seeded with the *modeled* seconds per phase (straight
off an ``Estimate`` / ``ServeEstimate``), accumulates *measured* wall
times for the same phases (either fed directly via ``record`` or scraped
from telemetry span events via ``observe_events``), and reports the
per-phase ratio ``measured_mean / modeled`` — the number the calibration
harness (ROADMAP direction 5) will eventually drive to 1.0.

The port's copy of ``repro.obs.drift``.  Its launchers price their own
run on ``core.platform.H100``: on the card the ratios measure the model
against the card; a CPU run's ratios are structural only (the model
prices an H100).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional

__all__ = ["DriftTracker", "SPAN_PHASES"]

# span name -> drift phase; used by observe_events to scrape telemetry.
SPAN_PHASES: Dict[str, str] = {
    "train.step": "step",
    "a2a.layer": "a2a",
    "ckpt.save": "ckpt",
    "ckpt.restore": "restore",
    "engine.decode": "decode",
    "engine.prefill": "prefill",
}


class DriftTracker:
    """Accumulate measured per-phase wall times against modeled values.

    ``warmup`` samples per phase are discarded (the first occurrence of a
    jitted phase pays compile; it would swamp the mean)."""

    def __init__(self, modeled: Mapping[str, float], warmup: int = 1):
        self.modeled = dict(modeled)
        self.warmup = int(warmup)
        self.samples: Dict[str, List[float]] = {}
        self._seen: Dict[str, int] = {}

    # -- construction from the resource model ------------------------------

    @classmethod
    def for_train(cls, m, t, platform, warmup: int = 1) -> "DriftTracker":
        from repro_torch.core import resource_model as rm

        est = rm.estimate(m, t, platform)
        return cls(rm.modeled_phases(est), warmup=warmup)

    @classmethod
    def for_serve(cls, m, s, platform, warmup: int = 1) -> "DriftTracker":
        from repro_torch.core import resource_model as rm

        se = rm.serve_estimate(m, s, platform)
        return cls(rm.modeled_serve_phases(se), warmup=warmup)

    # -- measurement intake ------------------------------------------------

    def record(self, phase: str, seconds: float) -> None:
        seen = self._seen.get(phase, 0)
        self._seen[phase] = seen + 1
        if seen < self.warmup:
            return
        self.samples.setdefault(phase, []).append(float(seconds))

    def observe_events(
        self,
        events: Iterable[Dict[str, Any]],
        mapping: Optional[Mapping[str, str]] = None,
    ) -> int:
        """Scrape span events (RingBufferSink.events() / parsed JSONL) into
        phase samples via ``mapping`` (default ``SPAN_PHASES``).  Returns
        the number of spans consumed."""
        mapping = SPAN_PHASES if mapping is None else mapping
        n = 0
        for ev in events:
            if ev.get("kind") != "span":
                continue
            phase = mapping.get(ev.get("name"))
            if phase is None:
                continue
            self.record(phase, ev["dur"])
            n += 1
        return n

    # -- reporting ---------------------------------------------------------

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-phase ``{modeled_s, n, mean_s, min_s, max_s, ratio}``.
        Phases with a model but no samples appear with ``n=0`` so gaps in
        coverage are visible; measured-only phases get ``modeled_s=None``
        and no ratio."""
        out: Dict[str, Dict[str, float]] = {}
        for phase in sorted(set(self.modeled) | set(self.samples)):
            modeled = self.modeled.get(phase)
            vals = self.samples.get(phase, [])
            row: Dict[str, Any] = {
                "modeled_s": modeled,
                "n": len(vals),
            }
            if vals:
                mean = sum(vals) / len(vals)
                row.update(mean_s=mean, min_s=min(vals), max_s=max(vals))
                if modeled is not None and modeled > 0:
                    row["ratio"] = mean / modeled
            out[phase] = row
        return out

    def format_report(self, title: str = "drift report") -> str:
        rows = self.report()
        lines = [
            f"== {title} (measured vs modeled, ratio = mean/modeled) ==",
            f"{'phase':<10} {'modeled_s':>12} {'mean_s':>12} "
            f"{'min_s':>12} {'max_s':>12} {'n':>4} {'ratio':>10}",
        ]
        for phase, r in rows.items():
            md = f"{r['modeled_s']:.6f}" if r["modeled_s"] is not None else "-"
            if r["n"]:
                lines.append(
                    f"{phase:<10} {md:>12} {r['mean_s']:>12.6f} "
                    f"{r['min_s']:>12.6f} {r['max_s']:>12.6f} {r['n']:>4} "
                    + (f"{r['ratio']:>10.3f}" if "ratio" in r else f"{'-':>10}")
                )
            else:
                lines.append(
                    f"{phase:<10} {md:>12} {'-':>12} {'-':>12} {'-':>12} "
                    f"{0:>4} {'-':>10}"
                )
        return "\n".join(lines)
