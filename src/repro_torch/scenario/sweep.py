"""Scenario grids: a base scenario × axis values = a list of scenarios.

A :class:`Sweep` is the declarative form of a config-search grid (the
paper's §2.1 workload): a base :class:`~repro.scenario.spec.Scenario` plus
an ordered mapping of dotted field paths to candidate values.  ``expand()``
takes the cartesian product — later axes vary fastest, like nested for
loops — and names each cell after its coordinates, so a whole benchmark
figure is one JSON object instead of a nest of hand-wired kwargs.

>>> sweep = Sweep(Scenario(name="grid"), {
...     "pool.replicas": [1, 2],
...     "workload.qps": [4.0, 24.0],
... })
>>> cells = sweep.expand()
>>> len(cells)
4
>>> [(s.pool.replicas, s.workload.qps) for s in cells]
[(1, 4.0), (1, 24.0), (2, 4.0), (2, 24.0)]
>>> cells[0].name
'grid[replicas=1,qps=4.0]'
>>> Sweep.from_dict(sweep.to_dict()) == sweep
True
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Dict, List

from .spec import Scenario, SpecError, scenario_with

__all__ = ["Sweep"]


@dataclass(frozen=True)
class Sweep:
    """A scenario grid: ``base`` × the cartesian product of ``axes``.

    ``axes`` maps dotted field paths (``"pool.replicas"``) to lists of
    values; values go through the same strict decoding as
    :meth:`Scenario.from_dict` (lists coerce to tuples, enums validate), so
    an invalid axis value fails at expansion with its path, before anything
    runs.
    """

    base: Scenario
    axes: Dict[str, list] = field(default_factory=dict)

    def __post_init__(self):
        for path, values in self.axes.items():
            if not isinstance(values, (list, tuple)) or not values:
                raise SpecError(f"axes.{path}: need a non-empty list of "
                                f"values, got {values!r}")

    def __len__(self) -> int:
        n = 1
        for values in self.axes.values():
            n *= len(values)
        return n

    def expand(self) -> List[Scenario]:
        """Every grid cell as a validated scenario, product order (later
        axes fastest), each named ``base.name[leaf=value,...]``."""
        paths = list(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[p] for p in paths)):
            overrides = dict(zip(paths, combo))
            cell = scenario_with(self.base, **overrides)
            coords = ",".join(f"{p.split('.')[-1]}={v!r}"
                              if isinstance(v, str) else
                              f"{p.split('.')[-1]}={v}"
                              for p, v in overrides.items())
            out.append(scenario_with(cell, name=f"{self.base.name}[{coords}]"))
        return out

    # ------------------------------------------------------- serialization --
    def to_dict(self) -> dict:
        return {"base": self.base.to_dict(),
                "axes": json.loads(json.dumps(self.axes))}

    @classmethod
    def from_dict(cls, d: dict) -> "Sweep":
        if not isinstance(d, dict):
            raise SpecError(f"sweep: expected an object, got {d!r}")
        unknown = set(d) - {"base", "axes"}
        if unknown:
            raise SpecError(f"sweep.{sorted(unknown)[0]}: unknown key "
                            "(valid keys: base, axes)")
        base = Scenario.from_dict(d.get("base", {}), path="sweep.base")
        axes = d.get("axes", {})
        if not isinstance(axes, dict):
            raise SpecError(f"sweep.axes: expected an object, got {axes!r}")
        return cls(base=base, axes={str(k): list(v)
                                    for k, v in axes.items()})

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str) -> "Sweep":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"invalid JSON: {e}") from None
        return cls.from_dict(d)
