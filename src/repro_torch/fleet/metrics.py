"""Per-tenant streaming metrics + fairness for the fleet plane.

One :class:`TenantAccumulator` per tenant, O(1) memory: submitted/completed/
failed conservation counts, SLO-attained count against the tenant's own
:class:`~repro.scenario.SLOSpec`, and running latency sums.  Fairness across
tenants is Jain's index over normalized attainment — 1.0 when every tenant
attains equally, 1/n when one tenant gets everything.

>>> round(jain_index([1.0, 1.0, 1.0]), 3)
1.0
>>> round(jain_index([1.0, 0.0, 0.0]), 3)
0.333
>>> jain_index([])
1.0
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = ["jain_index", "TenantAccumulator"]


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` ∈ (0, 1].

    Empty input and all-zero input both return 1.0 (nothing is being
    shared unfairly); a single value is always perfectly fair.
    """
    xs = [float(v) for v in values]
    if not xs:
        return 1.0
    s2 = sum(x * x for x in xs)
    if s2 == 0.0:
        return 1.0
    s = sum(xs)
    return (s * s) / (len(xs) * s2)


@dataclass
class TenantAccumulator:
    """O(1)-memory per-tenant rollup (see module docstring).

    ``observe`` judges each completion against the tenant's SLO bounds
    (``None`` = unconstrained on that axis, exactly like
    :meth:`ScenarioResult.slo_attainment`).  ``attainment`` is attained
    over *submitted* — an unfinished or failed request counts as an SLO
    miss, so conservation (completed + failed == submitted) and attainment
    share one denominator.
    """

    name: str
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    attained: int = 0
    ttft_sum: float = 0.0
    e2e_sum: float = 0.0
    extra: dict = field(default_factory=dict)   # static labels (model, ...)

    def observe(self, ttft: Optional[float], tpot: Optional[float],
                e2e: Optional[float]) -> None:
        self.completed += 1
        ttft_ok = (self.slo_ttft_s is None or ttft is None
                   or ttft <= self.slo_ttft_s)
        tpot_ok = (self.slo_tpot_s is None or tpot is None
                   or tpot <= self.slo_tpot_s)
        self.attained += int(ttft_ok and tpot_ok)
        if ttft is not None:
            self.ttft_sum += ttft
        if e2e is not None:
            self.e2e_sum += e2e

    def close(self) -> None:
        """Seal the books: anything submitted but never completed failed."""
        self.failed = self.submitted - self.completed

    @property
    def attainment(self) -> float:
        return self.attained / self.submitted if self.submitted else 0.0

    def goodput_rps(self, makespan: float) -> float:
        return self.attained / makespan if makespan else 0.0

    def row(self, makespan: float = 0.0) -> dict:
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "attained": self.attained,
            "attainment": round(self.attainment, 4),
            "goodput_rps": round(self.goodput_rps(makespan), 3),
            "mean_ttft_s": round(self.ttft_sum / self.completed, 4)
            if self.completed else None,
            "mean_e2e_s": round(self.e2e_sum / self.completed, 4)
            if self.completed else None,
        }
        out.update(self.extra)
        return out
