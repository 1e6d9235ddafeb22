"""Execute a fleet scenario: ingress split → per-pool runs → one result.

A fleet run decomposes exactly: the ingress tenant→model mapping is a
deterministic function of the spec (no feedback from pool state), and model
pools share no capacity, so each pool's sub-run is an independent serving
experiment on the shared virtual origin — per-pool timelines compose without
a cross-pool Timekeeper, on every backend.  ``run_fleet`` materializes the
scenario's open-loop stream once, splits it through
:class:`~repro.fleet.router.ModelRouter`, executes each model pool through
the *same* per-backend internals single-pool scenarios use
(``_run_emulated`` / ``_run_des``), and aggregates one
:class:`~repro.scenario.runner.ScenarioResult` with per-tenant metrics,
Jain fairness, and parity-comparable audit trails keyed
``(pool_name, local_index)``.

The parity argument is inductive: the ingress is backend-invariant by
construction, each sub-run meets the repo's single-pool parity bar, and the
aggregation applies identical arithmetic (swap-shift re-addition) to every
backend's samples — so fleet ``compare()`` inherits the one-slow-step bar.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.fleet.metrics import TenantAccumulator, jain_index
from repro_torch.fleet.router import ModelRouter
from repro_torch.fleet.spec import FleetSpec, ModelPoolSpec
from repro_torch.scenario.spec import Scenario, SpecError

__all__ = ["run_fleet", "fleet_slow_step_s", "partitioned_fleet"]


def _pool_scenario(scenario: Scenario, mp: ModelPoolSpec) -> Scenario:
    """The single-pool scenario a model pool's sub-run executes: the pool
    (with adapter KV overhead debited), its routing and autoscaler, the
    parent's SLO/seed.  ``fleet=None`` — sub-runs are ordinary scenarios."""
    return dataclasses.replace(
        scenario, name=f"{scenario.name}[{mp.name}]",
        pool=mp.effective_pool(), routing=mp.routing,
        autoscale=mp.autoscale, faults=(), fleet=None)


def fleet_slow_step_s(scenario: Scenario) -> float:
    """The coarsest predictor step across all model pools — the fleet's
    parity unit (every pool's latency discretization is bounded by it)."""
    from repro_torch.scenario.runner import _Wiring
    assert scenario.fleet is not None
    return max(_Wiring(_pool_scenario(scenario, mp)).slow_step_s()
               for mp in scenario.fleet.models)


def partitioned_fleet(scenario: Scenario) -> Scenario:
    """The statically partitioned counterfactual of a multiplexed fleet.

    Every tenant gets a *dedicated* copy of its target model pool,
    peak-provisioned at the shared pool's replica count (each tenant's
    burst must be absorbable without the others' headroom — the classic
    static-partitioning cost), keeping only that tenant's adapter resident.
    ``fig_fleet`` runs this against the multiplexed original to make the
    headline claim: same attainment, materially fewer replica-seconds.
    """
    fleet = scenario.fleet
    assert fleet is not None
    models, tenants = [], []
    for t in fleet.tenants:
        src = fleet.model(t.model)
        pool_name = f"{t.name}-{t.model}"
        adapters = tuple(a for a in src.adapters if a.name == t.adapter)
        models.append(dataclasses.replace(
            src, name=pool_name, adapters=adapters))
        tenants.append(dataclasses.replace(t, model=pool_name))
    return dataclasses.replace(
        scenario, name=f"{scenario.name}-partitioned",
        fleet=FleetSpec(models=tuple(models), tenants=tuple(tenants)))


def run_fleet(scenario: Scenario, backend: str = "thread", *,
              timeout: float = 600.0, audit: str = "full"):
    """Execute one fleet scenario on one backend (see module docstring).

    Called by :func:`repro.scenario.run` when ``scenario.fleet`` is set;
    the same backend names/aliases apply.  Fleet aggregation attributes
    every completion to its tenant, so it requires ``audit="full"``.
    """
    from repro_torch.scenario.runner import (BACKEND_ALIASES, BACKENDS,
                                       ScenarioResult, _Wiring, _run_des,
                                       _run_emulated)
    from repro_torch.serving.benchmark import LatencyStats

    if audit != "full":
        raise SpecError("audit: fleet runs need audit='full' (per-tenant "
                        "attribution reads the per-request trails)")
    base, transport = BACKEND_ALIASES.get(backend, (backend, None))
    if base not in BACKENDS:
        raise SpecError(
            f"backend: invalid value {backend!r} (choose from "
            f"{sorted(BACKENDS) + sorted(BACKEND_ALIASES)})")
    scenario.validate()
    fleet = scenario.fleet
    assert fleet is not None

    requests = scenario.workload.materialize(scenario.seed)
    assignment = ModelRouter(fleet).assign(requests)

    # per-tenant books; a tenant with no explicit SLO bound inherits the
    # scenario-level SLO (so every tenant is judged against *something*)
    accs: Dict[str, TenantAccumulator] = {}
    for t in fleet.tenants:
        slo = t.slo if (t.slo.ttft_s is not None
                        or t.slo.tpot_s is not None) else scenario.slo
        accs[t.name] = TenantAccumulator(
            name=t.name, slo_ttft_s=slo.ttft_s, slo_tpot_s=slo.tpot_s,
            submitted=assignment.submitted[t.name],
            extra={"model": t.model, "adapter": t.adapter,
                   "share": t.share})

    wall0 = time.monotonic()
    sub: Dict[str, Tuple[ModelPoolSpec, list, object]] = {}
    for mp in fleet.models:
        reqs = assignment.pools[mp.name]
        if not reqs:
            continue                  # no tenant targets this pool
        s = _pool_scenario(scenario, mp)
        wiring = _Wiring(s)
        if base == "des":
            r = _run_des(s, wiring, timeout, audit, workload_override=reqs)
        else:
            r = _run_emulated(s, wiring, base, timeout, audit,
                              transport=transport, workload_override=reqs)
        sub[mp.name] = (mp, reqs, r)
    wall = time.monotonic() - wall0

    # ---- aggregate: (pool, local_idx)-keyed trails + per-tenant books ----
    latencies: Dict[object, tuple] = {}
    routing_decisions: List[object] = [("ingress", t)
                                       for t in assignment.ingress]
    scaleups: List[Tuple[float, Optional[str]]] = []
    drained: List[object] = []
    replica_tiers: List[object] = []
    tier_seconds: Dict[Optional[str], float] = {}
    ttfts: List[float] = []
    tpots: List[float] = []
    e2es: List[float] = []
    slo_samples: List[tuple] = []
    num_requests = 0
    num_steps = 0
    replica_seconds = 0.0
    cost_dollars = 0.0
    makespan = 0.0
    out_tokens = 0.0
    pools: Dict[str, dict] = {}

    for mp in fleet.models:
        if mp.name not in sub:
            continue
        mp, reqs, r = sub[mp.name]
        # same keying as the sub-run built: arrival order, stable sort
        ordered = sorted(reqs, key=lambda q: q.arrival_time)
        for i, req in enumerate(ordered):
            sample = r.latencies.get(i)
            if sample is None:
                continue              # never completed -> tenant "failed"
            ttft, tpot, e2e = sample
            shift = assignment.swap_shift.get(req.request_id, 0.0)
            if shift:
                # the adapter cold-load the ingress jumped service past:
                # the tenant pays it in reported TTFT/e2e
                ttft = None if ttft is None else ttft + shift
                e2e = None if e2e is None else e2e + shift
            latencies[(mp.name, i)] = (ttft, tpot, e2e)
            accs[req.tenant].observe(ttft, tpot, e2e)
            if ttft is not None:
                ttfts.append(ttft)
            if tpot is not None:
                tpots.append(tpot)
            if e2e is not None:
                e2es.append(e2e)
            slo_samples.append((ttft, tpot))
        routing_decisions.extend((mp.name, d)
                                 for d in r.routing_decisions)
        scaleups.extend((t, f"{mp.name}:{tier or '?'}")
                        for t, tier in r.scaleups)
        drained.extend((mp.name, d) for d in r.drained)
        replica_tiers.extend((mp.name, t) for t in r.replica_tiers)
        for tier, s in (r.tier_seconds or {}).items():
            tier_seconds[tier] = tier_seconds.get(tier, 0.0) + s
        num_requests += r.num_requests
        num_steps += r.num_steps
        replica_seconds += r.replica_seconds
        cost_dollars += r.cost_dollars
        out_tokens += r.throughput_tokens_per_s * r.makespan_virtual
        makespan = max(makespan, r.makespan_virtual)
        pools[mp.name] = {
            "model": mp.pool.model,
            "replicas": mp.pool.replicas,
            "adapters": len(mp.adapters),
            "requests": r.num_requests,
            "replica_seconds": round(r.replica_seconds, 3),
            "virtual_s": round(r.makespan_virtual, 3),
        }

    for acc in accs.values():
        acc.close()
    scaleups.sort(key=lambda e: (e[0], e[1]))

    return ScenarioResult(
        scenario=scenario.name, backend=backend, seed=scenario.seed,
        num_requests=num_requests, num_sessions=0,
        ttft=LatencyStats.of(ttfts), tpot=LatencyStats.of(tpots),
        e2e=LatencyStats.of(e2es), session_ttft=None,
        makespan_virtual=makespan, wall_seconds=wall,
        throughput_tokens_per_s=(out_tokens / makespan if makespan else 0.0),
        slo_samples=slo_samples,
        num_slo_samples=len(slo_samples),
        slo_ttft_s=scenario.slo.ttft_s, slo_tpot_s=scenario.slo.tpot_s,
        audit=audit,
        replica_seconds=replica_seconds,
        cost_dollars=cost_dollars,
        tier_seconds=tier_seconds or None,
        num_steps=num_steps,
        routing_decisions=routing_decisions,
        placements=None,
        latencies=latencies,
        replica_tiers=replica_tiers,
        scaleups=scaleups,
        drained=drained,
        tenants={name: acc.row(makespan) for name, acc in accs.items()},
        pools=pools,
        fairness=jain_index([acc.attainment for acc in accs.values()]),
    )
