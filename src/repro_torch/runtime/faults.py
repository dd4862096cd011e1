"""Deterministic fault injection (the serving part of
``repro.runtime.faults``).

A :class:`FaultPlan` lists :class:`FaultSpec` entries (site, step,
count).  A spec arms its site from ``step`` on and fires on the first
``count`` queries at or after it, then is spent.  The one site the port
runs is ``serve.stall``: the engine loses one whole scheduler iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

SITES = ("serve.stall",)


@dataclass
class FaultSpec:
    site: str
    step: int
    count: int = 1

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; known: {SITES}")
        if self.step < 0 or self.count < 1:
            raise ValueError(f"bad fault spec {self}")


@dataclass
class FaultPlan:
    specs: List[FaultSpec] = field(default_factory=list)


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
                self.log.append({"site": site, "step": step, "ordinal": len(self.log)})
                self.log_fn(f"[fault] {site} fired at step {step}")
                return spec
        return None

    def fired(self, site: Optional[str] = None) -> int:
        if site is None:
            return len(self.log)
        return sum(1 for r in self.log if r["site"] == site)
