"""Declarative scenario API: one serializable spec, one ``run()``, three
backends.

A serving experiment is *data*: a frozen :class:`Scenario` tree (workload,
pool, routing, autoscaling, SLOs, seed) with strict JSON round-tripping, a
:class:`Sweep` that expands axis grids into scenario lists, and a single
:func:`run` that executes any scenario on the thread-mode emulator, the
process-mode emulator, or the DES baseline — plus :func:`compare`, which
runs one spec on several backends and enforces the repo's ≤1-slow-step
parity bar.  See ``docs/scenarios.md``.

::

    from repro_torch.scenario import Scenario, Sweep, run, compare, get_preset

    result = run(get_preset("cluster_scaling"), backend="thread")
    compare(get_preset("distributed_parity"),
            backends=("thread", "process", "des"))

    python -m repro.scenario run cluster_scaling        # same, from a shell
    python -m repro.scenario compare distributed_parity --backends thread,des
"""

from .presets import PRESETS, describe, get_preset, list_presets
from .runner import (BACKEND_ALIASES, CompareResult, ParityError,
                     ScenarioResult, compare, derive_cell_seed, run,
                     run_sweep)
from .spec import (BACKENDS, AutoscaleSpec, PoolSpec, RoutingSpec, Scenario,
                   SLOSpec, SpecError, WorkloadSpec, scenario_with)
from .sweep import Sweep

# fleet extension specs (repro.fleet) re-exported lazily (PEP 562):
# fleet.spec imports the codec from .spec, so an eager import here would
# cycle through this package's own init
_FLEET_EXPORTS = ("FleetSpec", "ModelPoolSpec", "TenantSpec", "AdapterSpec")


def __getattr__(name):
    if name in _FLEET_EXPORTS:
        from repro_torch.fleet import spec as _fleet_spec
        return getattr(_fleet_spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Scenario",
    "WorkloadSpec",
    "PoolSpec",
    "RoutingSpec",
    "AutoscaleSpec",
    "SLOSpec",
    "FleetSpec",
    "ModelPoolSpec",
    "TenantSpec",
    "AdapterSpec",
    "SpecError",
    "scenario_with",
    "Sweep",
    "BACKENDS",
    "BACKEND_ALIASES",
    "run",
    "run_sweep",
    "derive_cell_seed",
    "compare",
    "ScenarioResult",
    "CompareResult",
    "ParityError",
    "PRESETS",
    "get_preset",
    "list_presets",
    "describe",
]
