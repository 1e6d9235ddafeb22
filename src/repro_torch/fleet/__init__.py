"""Fleet plane: multi-model, multi-tenant serving above the cluster layer.

The ROADMAP's "multi-model, multi-tenant serving plane" item: one scenario
declares N model pools (each a full :class:`~repro.scenario.PoolSpec` with
its own routing policy and autoscaler, optionally multiplexing LoRA
adapters onto shared base replicas) and M tenants (weighted traffic shares,
priorities, per-tenant SLOs).  A deterministic ingress
(:class:`ModelRouter`) splits the open-loop stream, :func:`run_fleet`
executes every pool through the same backend internals single-pool
scenarios use, and the aggregated result reports per-tenant attainment,
goodput, and Jain fairness — on the thread emulator, the process emulator
(tcp or shm wire), and the DES baseline, with ``compare()`` holding the
repo's one-slow-step parity bar across them.

Entry points: set ``Scenario.fleet`` and call :func:`repro.scenario.run`
(the dispatch is automatic), or use the ``fleet_mix`` preset.  See
``docs/scenarios.md`` and ``benchmarks/fig_fleet.py`` for the headline
multiplexed-vs-partitioned experiment.
"""

from .metrics import TenantAccumulator, jain_index
from .router import FleetAssignment, ModelRouter
from .runner import fleet_slow_step_s, partitioned_fleet, run_fleet
from .spec import AdapterSpec, FleetSpec, ModelPoolSpec, TenantSpec

__all__ = [
    "AdapterSpec",
    "ModelPoolSpec",
    "TenantSpec",
    "FleetSpec",
    "ModelRouter",
    "FleetAssignment",
    "TenantAccumulator",
    "jain_index",
    "run_fleet",
    "partitioned_fleet",
    "fleet_slow_step_s",
]
