"""Deterministic fault injection (the port of ``repro.runtime.faults``).

A :class:`FaultPlan` lists :class:`FaultSpec` entries (site, step, count,
payload).  A spec arms its site from ``step`` on and fires on the first
``count`` queries at or after it, then is spent, so a rollback that
re-runs a faulted step does not fire a spent spec again.  The sites:

============================ ==============================================
``ckpt.crash_before_rename`` the process dies mid-checkpoint, before the
                             atomic rename: the ``.tmp`` dir is left behind
``ckpt.crash_after_rename``  the process dies right after the rename: the
                             new checkpoint is complete and must verify
``ckpt.write_fail``          the leaf write raises (full disk, I/O error):
                             exercises the async writer's error path
``data.transient``           the data source raises a retryable error:
                             exercises the trainer's retry with backoff
``train.nonfinite``          the step's loss and grads are scaled by
                             ``payload`` (default NaN): exercises the
                             anomaly sentinel and the rollback
``train.slow_step``          sleep ``payload`` seconds inside the timed
                             step: exercises the straggler monitor
``train.sigterm``            a real SIGTERM is delivered to the process:
                             exercises preemption (final save, clean stop)
``serve.stall``              the engine loses one whole scheduler iteration
============================ ==============================================
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

SITES = ("ckpt.crash_before_rename", "ckpt.crash_after_rename", "ckpt.write_fail",
         "data.transient", "train.nonfinite", "train.slow_step", "train.sigterm",
         "serve.stall")


class SimulatedCrash(RuntimeError):
    """The injected stand-in for the process dying mid-operation."""


class TransientDataError(IOError):
    """A retryable data-source failure (flaky filesystem or network read)."""


class InjectedWriteError(IOError):
    """An injected checkpoint-write failure (full disk, I/O error)."""


_RAISES = {"ckpt.crash_before_rename": SimulatedCrash,
           "ckpt.crash_after_rename": SimulatedCrash,
           "ckpt.write_fail": InjectedWriteError,
           "data.transient": TransientDataError}


@dataclass
class FaultSpec:
    """One planned fault: arm ``site`` at ``step``, fire ``count`` times.
    ``payload`` is the loss/grad scale for ``train.nonfinite`` (NaN by
    default) and seconds for ``train.slow_step``; ignored elsewhere."""

    site: str
    step: int
    count: int = 1
    payload: float = float("nan")

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; known: {SITES}")
        if self.step < 0 or self.count < 1:
            raise ValueError(f"bad fault spec {self}")


@dataclass
class FaultPlan:
    """A deterministic, seed-stamped set of faults for one run."""

    specs: List[FaultSpec] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def random(cls, seed: int, total_steps: int,
               sites: Sequence[str] = ("data.transient", "train.slow_step",
                                       "train.nonfinite"),
               max_faults: int = 3) -> "FaultPlan":
        """Seed-driven chaos: 1 to ``max_faults`` faults at sites and steps
        drawn from ``np.random.default_rng(seed)`` in the reference's order,
        so a seed gives the reference's plan; a ``train.slow_step`` sleeps
        0.05 s, a ``train.nonfinite`` scales by NaN."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, max_faults + 1))
        specs = [FaultSpec(site=sites[int(rng.integers(0, len(sites)))],
                           step=int(rng.integers(0, max(total_steps, 1))))
                 for _ in range(n)]
        for s in specs:
            if s.site == "train.slow_step":
                s.payload = 0.05
        return cls(specs=specs, seed=seed)


class FaultInjector:
    """Runtime side of a :class:`FaultPlan`: query sites, consume specs.
    With no plan every query is a dict lookup that returns None."""

    def __init__(self, plan: Optional[FaultPlan] = None,
                 log_fn: Callable[[str], None] = print):
        self.plan = plan or FaultPlan()
        self.log_fn = log_fn
        self.log: List[Dict] = []
        self._by_site: Dict[str, List[List]] = {}
        for spec in self.plan.specs:
            self._by_site.setdefault(spec.site, []).append([spec, spec.count])

    def fire(self, site: str, step: int) -> Optional[FaultSpec]:
        """Consume and return the first armed spec for ``site``, else None."""
        for entry in self._by_site.get(site, ()):
            spec, remaining = entry
            if remaining > 0 and step >= spec.step:
                entry[1] -= 1
                self.log.append({"site": site, "step": step, "ordinal": len(self.log),
                                 "payload": spec.payload})
                self.log_fn(f"[fault] {site} fired at step {step}")
                return spec
        return None

    def raise_if(self, site: str, step: int) -> None:
        """Raise the site's exception class if an armed spec fires."""
        if self.fire(site, step) is not None:
            raise _RAISES[site](f"injected {site} at step {step}")

    def sleep_if(self, site: str, step: int) -> float:
        """Sleep the spec's payload seconds if armed; returns seconds slept."""
        spec = self.fire(site, step)
        if spec is None:
            return 0.0
        time.sleep(spec.payload)
        return spec.payload

    def payload_if(self, site: str, step: int) -> Optional[float]:
        """The spec's payload if armed, else None."""
        spec = self.fire(site, step)
        return None if spec is None else spec.payload

    def fired(self, site: Optional[str] = None) -> int:
        if site is None:
            return len(self.log)
        return sum(1 for r in self.log if r["site"] == site)
