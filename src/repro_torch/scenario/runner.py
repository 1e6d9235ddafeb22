"""One ``run()`` for every backend: thread emulator, process emulator, DES.

This module is the execution half of the scenario API: it turns a
:class:`~repro.scenario.spec.Scenario` into a live experiment on any
registered backend and returns one uniform :class:`ScenarioResult` schema,
so sweep/figure/CI code never touches ``build_cluster``/``DESConfig``
plumbing again (those remain the internal layer underneath).

* ``backend="thread"`` — N in-process engine replicas on one shared
  VirtualClock under a ManualWallSource: a deterministic pure-jump timeline,
  exactly reproducible from the scenario seed.
* ``backend="process"`` — each replica engine in its own OS process over the
  time-warp socket transport (host wall, by construction).
* ``backend="des"`` — the Vidur-style discrete-event baseline sharing the
  same Router/AutoscalerPolicy/TierSpec objects.

:func:`compare` runs one spec on several backends and checks the repo's
established parity bar: identical routing decisions and per-request
TTFT/TPOT within **one slow-step** (the coarsest predictor step in the
scenario), raising :class:`ParityError` otherwise — the §2.3 semantic-gap
argument as a one-call API.
"""

from __future__ import annotations

import multiprocessing
import time
import zlib
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .spec import BACKENDS, Scenario, SpecError, scenario_with

__all__ = ["ScenarioResult", "CompareResult", "ParityError", "run", "compare",
           "run_sweep", "derive_cell_seed"]


class ParityError(AssertionError):
    """Cross-backend parity violated (routing divergence or a latency gap
    beyond one slow-step)."""


# =========================================================================
# uniform result schema
# =========================================================================

@dataclass
class ScenarioResult:
    """What every backend returns: one schema for metrics, cost, and the
    audit trails parity checks replay.

    ``latencies`` maps a backend-independent request key — submit index for
    open loop, ``(session_id, turn_index)`` for sessions — to
    ``(ttft, tpot, e2e)`` seconds (``tpot`` is None for 1-token outputs).

    ``audit`` records what this result retains per request: ``"full"``
    keeps every sample and audit trail (the parity/figure default),
    ``"sampled"`` keeps O(1)-memory sketches plus a seeded reservoir of
    SLO samples (``num_slo_samples`` is the true observation count the
    reservoir subsamples), ``"off"`` additionally drops the reservoir.
    Under ``sampled``/``off`` the audit trails (``latencies``,
    ``placements``, ``routing_decisions``, ``slo_samples``) are empty or
    reservoir-sized — parity checks need ``audit="full"``.
    """

    scenario: str
    backend: str
    seed: int
    # completion counts
    num_requests: int
    num_sessions: int
    # latency stats (repro.serving.benchmark.LatencyStats)
    ttft: object
    tpot: object
    e2e: object
    session_ttft: Optional[object]
    # timeline
    makespan_virtual: float
    wall_seconds: float
    throughput_tokens_per_s: float = 0.0
    # SLO / throughput
    slo_samples: List[tuple] = field(repr=False, default_factory=list)
    num_slo_samples: int = 0
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    # retention mode (see class docstring)
    audit: str = "full"
    # cost accounting
    replica_seconds: float = 0.0
    cost_dollars: float = 0.0
    tier_seconds: Optional[Dict[Optional[str], float]] = None
    # emulation-speed accounting (events/sec, barrier pressure)
    num_steps: int = 0
    timekeeper: Optional[dict] = field(repr=False, default=None)
    # audit trails (parity)
    routing_decisions: List[int] = field(repr=False, default_factory=list)
    placements: Optional[Dict[tuple, int]] = field(repr=False, default=None)
    latencies: Dict[object, tuple] = field(repr=False, default_factory=dict)
    replica_tiers: List[Optional[str]] = field(default_factory=list)
    scaleups: List[Tuple[float, Optional[str]]] = field(default_factory=list)
    drained: List[int] = field(default_factory=list)
    # fault-injection audit (chaos scenarios): the applied fault log in
    # nominal virtual times — primitive tuples, float-exactly comparable
    # across backends (see repro.cluster.faults.FaultInjector.events)
    faults_injected: List[tuple] = field(default_factory=list)
    requests_requeued: int = 0
    requests_failed: int = 0
    # (fault_time, respawn_time) per recovered replica, virtual seconds
    recovery_times: List[Tuple[float, float]] = field(default_factory=list)
    # fleet plane (repro.fleet): per-tenant / per-pool rollups.  ``tenants``
    # maps tenant name -> metrics row (submitted/completed/failed counts,
    # attainment against the tenant's own SLO, goodput); ``pools`` maps
    # model pool name -> its sub-run summary; ``fairness`` is Jain's index
    # over per-tenant attainment.  All None outside fleet runs.
    tenants: Optional[Dict[str, dict]] = None
    pools: Optional[Dict[str, dict]] = None
    fairness: Optional[float] = None

    @property
    def mean_recovery_s(self) -> float:
        """Mean fault-to-respawn delay across recovered replicas."""
        if not self.recovery_times:
            return 0.0
        return float(np.mean([r - f for f, r in self.recovery_times]))

    @property
    def speedup(self) -> float:
        return (self.makespan_virtual / self.wall_seconds
                if self.wall_seconds else 0.0)

    @property
    def request_rate_completed(self) -> float:
        return (self.num_requests / self.makespan_virtual
                if self.makespan_virtual else 0.0)

    @property
    def tiers_added(self) -> List[Optional[str]]:
        """Tier of every autoscaler-provisioned replica, join order."""
        return [t for _, t in self.scaleups]

    def tenant_attainment(self) -> Optional[float]:
        """Submission-weighted aggregate SLO attainment across tenants
        (each tenant judged against its own SLO); None outside fleet runs."""
        if not self.tenants:
            return None
        total = sum(t["submitted"] for t in self.tenants.values())
        if not total:
            return 0.0
        return sum(t["attainment"] * t["submitted"]
                   for t in self.tenants.values()) / total

    def slo_attainment(self, slo_ttft_s: Optional[float] = None,
                       slo_tpot_s: Optional[float] = None) -> float:
        """Fraction of completions meeting the SLOs (defaults: the
        scenario's own SLOSpec; a missing bound is unconstrained)."""
        slo_ttft = slo_ttft_s if slo_ttft_s is not None else self.slo_ttft_s
        slo_tpot = slo_tpot_s if slo_tpot_s is not None else self.slo_tpot_s
        if not self.slo_samples:
            return 0.0
        good = 0
        for ttft, tpot in self.slo_samples:
            ttft_ok = slo_ttft is None or ttft is None or ttft <= slo_ttft
            tpot_ok = slo_tpot is None or tpot is None or tpot <= slo_tpot
            good += int(ttft_ok and tpot_ok)
        return good / len(self.slo_samples)

    def goodput_rps(self, **kw) -> float:
        """SLO-attaining completions per virtual second.  Under
        ``audit="sampled"`` attainment comes from the reservoir but is
        scaled by the true observation count, keeping goodput unbiased."""
        if not self.makespan_virtual:
            return 0.0
        n = self.num_slo_samples or len(self.slo_samples)
        return self.slo_attainment(**kw) * n / self.makespan_virtual

    def to_row(self) -> dict:
        """Flat dict for tables / JSONL artifacts (benchmark figures)."""
        row = {
            "scenario": self.scenario,
            "backend": self.backend,
            "requests": self.num_requests,
            "ttft_p50_ms": round(self.ttft.p50 * 1e3, 1),
            "ttft_p99_ms": round(self.ttft.p99 * 1e3, 1),
            "tpot_p50_ms": round(self.tpot.p50 * 1e3, 2),
            "completed_rps": round(self.request_rate_completed, 3),
            "replica_seconds": round(self.replica_seconds, 2),
            "virtual_s": round(self.makespan_virtual, 2),
            "wall_s": round(self.wall_seconds, 2),
            "speedup_x": round(self.speedup, 1),
        }
        if self.slo_ttft_s is not None or self.slo_tpot_s is not None:
            row["slo_attainment"] = round(self.slo_attainment(), 4)
            row["goodput_rps"] = round(self.goodput_rps(), 3)
        if self.cost_dollars:
            row["cost_dollars"] = round(self.cost_dollars, 6)
        if self.num_sessions:
            row["sessions"] = self.num_sessions
            if self.session_ttft is not None:
                row["session_ttft_p50_ms"] = round(
                    self.session_ttft.p50 * 1e3, 1)
        if self.scaleups:
            row["tiers_added"] = ",".join(t or "?" for t in self.tiers_added)
        if self.tenants:
            row["tenants"] = len(self.tenants)
            row["fleet_attainment"] = round(self.tenant_attainment(), 4)
            if self.fairness is not None:
                row["fairness"] = round(self.fairness, 4)
        if self.faults_injected:
            row["faults"] = len(self.faults_injected)
            row["requeued"] = self.requests_requeued
            row["failed"] = self.requests_failed
            if self.recovery_times:
                row["mean_recovery_s"] = round(self.mean_recovery_s, 3)
        return row


# =========================================================================
# shared wiring
# =========================================================================

def _ordered_tiers(scenario: Scenario) -> List[str]:
    """Every tier name the scenario can touch (pool + autoscale candidates),
    first-mention order — the set make_tier_specs must cover."""
    names: List[str] = []
    for t in (scenario.pool.replica_tiers() or []):
        if t is not None and t not in names:
            names.append(t)
    if scenario.autoscale is not None:
        for t in scenario.autoscale.tiers:
            if t not in names:
                names.append(t)
    return names


class _Wiring:
    """Everything run() derives from a scenario, built once per run so all
    backends share the exact same spec/predictor arithmetic."""

    def __init__(self, scenario: Scenario):
        from repro_torch.core.predictor import StaticPredictor
        from repro_torch.cluster.tiers import make_tier_specs

        scenario.validate()
        self.scenario = scenario
        self.model_cfg = scenario.pool.model_config()
        self.engine_cfg = scenario.pool.engine_config()
        self.predictor = (StaticPredictor(scenario.pool.step_time_s)
                          if scenario.pool.step_time_s is not None else None)
        self.tier_predictors = ({
            t: StaticPredictor(s)
            for t, s in scenario.pool.tier_step_time_s.items()
        } if scenario.pool.tier_step_time_s else None)
        tier_names = _ordered_tiers(scenario)
        self.tier_specs = (make_tier_specs(
            self.model_cfg, self.engine_cfg, tier_names,
            tier_predictors=self.tier_predictors) if tier_names else None)

    def base_predictor(self):
        """The predictor for untiered replicas (and the DES fallback)."""
        from repro_torch.serving.stack import default_predictor
        if self.predictor is not None:
            return self.predictor
        tiers = self.scenario.pool.replica_tiers()
        if tiers and tiers[0] is not None and self.tier_predictors \
                and tiers[0] in self.tier_predictors:
            return self.tier_predictors[tiers[0]]
        return default_predictor(self.model_cfg, self.engine_cfg)

    def slow_step_s(self) -> float:
        """The coarsest predictor step in the scenario — the parity unit."""
        from repro_torch.core.predictor import BatchSpec, SeqSpec
        pool = self.scenario.pool
        steps = list((pool.tier_step_time_s or {}).values())
        if pool.step_time_s is not None:
            steps.append(pool.step_time_s)
        if steps:
            return max(steps)
        probe = BatchSpec.make([SeqSpec(1, 256)])
        return self.base_predictor().predict_step(probe).total


def _latency_sample(ttft, tpot, e2e):
    return (ttft, tpot, e2e)


def _session_stats(groups: Dict[int, List[tuple]]):
    """Per-session mean TTFT/TPOT percentile stats from (ttft, tpot) lists."""
    from repro_torch.serving.benchmark import LatencyStats
    mean_ttfts, mean_tpots = [], []
    for samples in groups.values():
        ts = [t for t, _ in samples if t is not None]
        ps = [p for _, p in samples if p is not None]
        if ts:
            mean_ttfts.append(float(np.mean(ts)))
        if ps:
            mean_tpots.append(float(np.mean(ps)))
    return LatencyStats.of(mean_ttfts), LatencyStats.of(mean_tpots)


# =========================================================================
# backends
# =========================================================================

def _run_emulated(scenario: Scenario, wiring: _Wiring, backend: str,
                  timeout: float, audit: str = "full",
                  transport: Optional[str] = None,
                  label: Optional[str] = None,
                  workload_override: Optional[list] = None) -> ScenarioResult:
    from repro_torch.cluster import Autoscaler, build_cluster
    from repro_torch.core.clock import ManualWallSource
    from repro_torch.serving.benchmark import BenchmarkRunner

    pool, autoscale = scenario.pool, scenario.autoscale
    # respawn headroom: every fault that can recover activates one warm
    # standby per killed replica (spot_reclaim: one per tier member)
    respawn_extra = 0
    tiers_list = pool.replica_tiers() or []
    for f in scenario.faults:
        if not f.recover:
            continue
        if f.kind == "crash":
            respawn_extra += 1
        elif f.kind == "spot_reclaim":
            respawn_extra += sum(1 for t in tiers_list if t == f.tier)
    warm = None
    if backend == "process" and (autoscale is not None or respawn_extra):
        # pre-spawn the whole headroom (autoscaler max + chaos respawns) so
        # scale-ups and recoveries activate a warm child, paying only the
        # modeled provisioning/respawn delay, never process-spawn wall time
        # mid-run
        base_total = (autoscale.max_replicas if autoscale is not None
                      else pool.replicas)
        warm = base_total + respawn_extra
    cluster = build_cluster(
        wiring.model_cfg, wiring.engine_cfg, pool.replicas,
        policy=scenario.routing.policy, mode="emulate", backend=backend,
        predictor=wiring.predictor, tiers=pool.replica_tiers(),
        tier_predictors=wiring.tier_predictors, tier_specs=wiring.tier_specs,
        router_kwargs=scenario.routing.kwargs,
        wall=ManualWallSource() if backend == "thread" else None,
        warm_replicas=warm,
        transport=transport if transport is not None else pool.transport)
    autoscaler = None
    if autoscale is not None:
        autoscaler = Autoscaler(cluster, autoscale.make_policy(),
                                autoscale.make_config())
    injector = None
    if scenario.faults:
        from repro_torch.cluster.faults import FaultInjector
        injector = FaultInjector(cluster, scenario.faults)
    # the fleet plane pre-splits one materialized stream across pools and
    # passes each pool its (tenant-tagged) slice directly
    workload = (list(workload_override) if workload_override is not None
                else scenario.workload.materialize(scenario.seed))
    closed = (scenario.workload.kind == "sessions"
              and workload_override is None)
    try:
        res = BenchmarkRunner(cluster, workload,
                              transport=cluster.transport,
                              autoscaler=autoscaler,
                              fault_injector=injector,
                              audit=audit,
                              metrics_seed=scenario.seed
                              ).run(timeout=timeout)
        if audit == "full":
            reqs = list(cluster.finished)
            if closed:
                keyed = {(r.session_id, r.turn_index): r for r in reqs}
                placements = {(s, t): idx
                              for s, t, _, idx in cluster.placements}
            else:
                ordered = sorted(reqs, key=lambda r: r.arrival_time)
                keyed = dict(enumerate(ordered))
                placements = None
            latencies = {
                k: _latency_sample(r.ttft(),
                                   r.tpot() if r.num_generated > 1 else None,
                                   r.e2e_latency())
                for k, r in keyed.items()
            }
        else:                  # sampled/off: no per-request audit trails
            placements = None
            latencies = {}
        drained = [m["replica"] for m in cluster.membership_events()
                   if m["drained"] is not None]
        # one scale-up audit: autoscaler provisions + chaos respawns, in
        # virtual-time order (both sources record absolute clock stamps)
        scaleups = list(autoscaler.scaleups) if autoscaler else []
        if injector is not None:
            scaleups = sorted(scaleups + list(injector.respawn_scaleups),
                              key=lambda e: e[0])
        cstats = cluster.stats()
        return ScenarioResult(
            scenario=scenario.name, backend=label or backend,
            seed=scenario.seed,
            num_requests=res.num_requests, num_sessions=res.num_sessions,
            ttft=res.ttft, tpot=res.tpot, e2e=res.e2e,
            session_ttft=res.session_ttft,
            makespan_virtual=res.makespan_virtual,
            wall_seconds=res.wall_seconds,
            throughput_tokens_per_s=res.throughput_tokens_per_s,
            slo_samples=list(res.slo_samples),
            num_slo_samples=res.num_slo_samples,
            slo_ttft_s=scenario.slo.ttft_s, slo_tpot_s=scenario.slo.tpot_s,
            audit=audit,
            replica_seconds=res.replica_seconds,
            cost_dollars=res.cost_dollars,
            tier_seconds=res.tier_seconds,
            num_steps=cstats.get("steps", 0),
            timekeeper=cstats.get("timekeeper"),
            routing_decisions=list(cluster.router.decisions),
            placements=placements,
            latencies=latencies,
            replica_tiers=list(cluster.replica_tiers),
            scaleups=scaleups,
            drained=drained,
            faults_injected=list(injector.events) if injector else [],
            requests_requeued=injector.requeued if injector else 0,
            requests_failed=injector.failed if injector else 0,
            recovery_times=list(injector.recoveries) if injector else [],
        )
    finally:
        cluster.shutdown()


def _run_des(scenario: Scenario, wiring: _Wiring,
             timeout: float, audit: str = "full",
             workload_override: Optional[list] = None) -> ScenarioResult:
    from repro_torch.cluster.router import make_router
    from repro_torch.des.simulator import DESConfig, DiscreteEventSimulator
    from repro_torch.metrics import StreamingMetrics
    from repro_torch.serving.benchmark import LatencyStats

    pool, autoscale = scenario.pool, scenario.autoscale
    router = make_router(scenario.routing.policy, pool.replicas,
                         **(scenario.routing.kwargs or {}))
    sim = DiscreteEventSimulator(
        wiring.base_predictor(),
        DESConfig(max_num_seqs=pool.max_num_seqs,
                  max_batched_tokens=pool.max_batched_tokens,
                  step_overhead_s=0.0),
        num_replicas=pool.replicas, router=router,
        autoscaler_policy=(autoscale.make_policy() if autoscale else None),
        autoscaler_cfg=(autoscale.make_config() if autoscale else None),
        replica_tiers=pool.replica_tiers(),
        tier_predictors=wiring.tier_predictors,
        tier_specs=wiring.tier_specs,
        faults=scenario.faults)
    workload = (list(workload_override) if workload_override is not None
                else scenario.workload.materialize(scenario.seed))
    closed = (scenario.workload.kind == "sessions"
              and workload_override is None)
    initial_replicas = pool.replicas

    if audit != "full":
        # flat-memory path: completions flow straight into O(1)-memory
        # accumulators via the sink; nothing per-request is retained
        router.record_decisions = False
        m = StreamingMetrics(
            seed=scenario.seed,
            session_turns=getattr(workload, "session_turns", None))
        wall0 = time.monotonic()
        sim.run(workload, sink=m.observe)
        wall = time.monotonic() - wall0
        m.finalize()
        makespan = m.max_finish or 0.0
        tier_s: Dict[Optional[str], float] = {}
        for rep in sim.replicas:
            end = rep.drained_at if rep.drained_at is not None else makespan
            on = max(0.0, min(end, makespan) - rep.added_at)
            tier_s[rep.tier] = tier_s.get(rep.tier, 0.0) + on
        return ScenarioResult(
            scenario=scenario.name, backend="des", seed=scenario.seed,
            num_requests=m.count, num_sessions=m.num_sessions,
            ttft=m.ttft.stats(), tpot=m.tpot.stats(), e2e=m.e2e.stats(),
            session_ttft=(m.session_ttft.stats()
                          if m.session_ttft.count else None),
            makespan_virtual=makespan, wall_seconds=wall,
            throughput_tokens_per_s=(m.total_new_tokens / makespan
                                     if makespan else 0.0),
            slo_samples=[] if audit == "off" else list(m.slo.items),
            num_slo_samples=m.num_slo_samples,
            slo_ttft_s=scenario.slo.ttft_s, slo_tpot_s=scenario.slo.tpot_s,
            audit=audit,
            replica_seconds=sim.replica_seconds(makespan),
            cost_dollars=sim.replica_cost(makespan),
            tier_seconds=tier_s,
            replica_tiers=[r.tier for r in sim.replicas],
            scaleups=[(r.added_at, r.tier)
                      for r in sim.replicas[initial_replicas:]],
            drained=[r.index for r in sim.replicas
                     if r.drained_at is not None],
            faults_injected=list(sim.fault_log),
            requests_requeued=sim.requeued_total,
            requests_failed=len(sim.failed),
            recovery_times=list(sim.recoveries),
        )

    wall0 = time.monotonic()
    sims = sim.run(workload)
    wall = time.monotonic() - wall0

    done = [s for s in sims if s.finish_time is not None]
    finishes = [s.finish_time for s in done]
    makespan = max(finishes) if finishes else 0.0
    ttft = LatencyStats.of([s.ttft() for s in done if s.ttft() is not None])
    tpot = LatencyStats.of([s.tpot() for s in done
                            if s.tpot() is not None and s.num_generated > 1])
    e2e = LatencyStats.of([s.finish_time - s.arrival_time for s in done])
    if closed:
        keyed = {(s.session_id, s.turn_index): s for s in done}
        placements = {k: s.replica for k, s in keyed.items()}
    else:
        ordered = sorted(done, key=lambda s: s.arrival_time)
        keyed = dict(enumerate(ordered))
        placements = None
    latencies = {
        k: _latency_sample(s.ttft(),
                           s.tpot() if s.num_generated > 1 else None,
                           s.finish_time - s.arrival_time)
        for k, s in keyed.items()
    }
    by_session: Dict[int, List[tuple]] = defaultdict(list)
    for s in done:
        if s.session_id is not None:
            by_session[s.session_id].append(
                (s.ttft(), s.tpot() if s.num_generated > 1 else None))
    session_ttft = None
    if by_session:
        session_ttft, _ = _session_stats(by_session)

    tier_s: Dict[Optional[str], float] = {}
    for rep in sim.replicas:
        end = rep.drained_at if rep.drained_at is not None else makespan
        on = max(0.0, min(end, makespan) - rep.added_at)
        tier_s[rep.tier] = tier_s.get(rep.tier, 0.0) + on
    return ScenarioResult(
        scenario=scenario.name, backend="des", seed=scenario.seed,
        num_requests=len(done),
        num_sessions=len(by_session),
        ttft=ttft, tpot=tpot, e2e=e2e, session_ttft=session_ttft,
        makespan_virtual=makespan, wall_seconds=wall,
        throughput_tokens_per_s=(sum(s.num_generated for s in done)
                                 / makespan if makespan else 0.0),
        slo_samples=[(s.ttft(), s.tpot() if s.num_generated > 1 else None)
                     for s in done],
        slo_ttft_s=scenario.slo.ttft_s, slo_tpot_s=scenario.slo.tpot_s,
        replica_seconds=sim.replica_seconds(makespan),
        cost_dollars=sim.replica_cost(makespan),
        tier_seconds=tier_s,
        routing_decisions=list(router.decisions),
        placements=placements,
        latencies=latencies,
        replica_tiers=[r.tier for r in sim.replicas],
        scaleups=[(r.added_at, r.tier)
                  for r in sim.replicas[initial_replicas:]],
        drained=[r.index for r in sim.replicas
                 if r.drained_at is not None],
        faults_injected=list(sim.fault_log),
        requests_requeued=sim.requeued_total,
        requests_failed=len(sim.failed),
        recovery_times=list(sim.recoveries),
    )


# =========================================================================
# public entry points
# =========================================================================

BACKEND_ALIASES = {
    # backend aliases pinning the process backend's wire transport; they
    # override the scenario's pool.transport, so one scenario can run
    # process-tcp vs process-shm side by side in a compare()
    "process-tcp": ("process", "tcp"),
    "process-shm": ("process", "shm"),
}


def run(scenario: Scenario, backend: str = "thread", *,
        timeout: float = 600.0, audit: str = "full") -> ScenarioResult:
    """Execute one scenario on one backend; all wiring included.

    ``backend`` is ``"thread"`` (in-process emulator on a deterministic
    manual wall), ``"process"`` (replicas as OS processes over the wire
    transport the scenario's ``pool.transport`` selects), or ``"des"``
    (the discrete-event baseline).  The aliases ``"process-tcp"`` and
    ``"process-shm"`` pin the wire explicitly (compare() legs).  The same
    scenario object/JSON runs unmodified on all of them.

    ``audit`` selects per-request retention (see
    :class:`ScenarioResult`): ``"full"`` (default, required for parity
    checks), ``"sampled"`` (sketches + SLO reservoir — the flat-memory
    scale mode), or ``"off"`` (sketches only).
    """
    from repro_torch.serving.benchmark import AUDIT_MODES
    base, transport = BACKEND_ALIASES.get(backend, (backend, None))
    if base not in BACKENDS:
        raise SpecError(
            f"backend: invalid value {backend!r} (choose from "
            f"{sorted(BACKENDS) + sorted(BACKEND_ALIASES)})")
    if audit not in AUDIT_MODES:
        raise SpecError(f"audit: invalid value {audit!r} "
                        f"(choose from {sorted(AUDIT_MODES)})")
    if scenario.fleet is not None:
        from repro_torch.fleet.runner import run_fleet
        return run_fleet(scenario, backend, timeout=timeout, audit=audit)
    wiring = _Wiring(scenario)
    if base == "des":
        if scenario.routing.policy == "pd_pool":
            raise SpecError("routing.policy: pd_pool is not supported on "
                            "the des backend (Table 1 semantic gap)")
        return _run_des(scenario, wiring, timeout, audit)
    if base == "process" and scenario.routing.policy == "pd_pool":
        raise SpecError("routing.policy: pd_pool is not supported on the "
                        "process backend")
    return _run_emulated(scenario, wiring, base, timeout, audit,
                         transport=transport,
                         label=backend if backend != base else None)


# =========================================================================
# parallel execution (sweep cells / compare legs)
# =========================================================================

def _run_cell(payload: tuple) -> ScenarioResult:
    """Executor worker: one (scenario-dict, backend, timeout) triple.

    Module-scope so ``spawn`` workers can import it; scenarios travel in
    their canonical JSON-dict form (the declarative API's serialization), so
    the worker rebuilds exactly what the parent validated.
    """
    scenario_dict, backend, timeout = payload[:3]
    audit = payload[3] if len(payload) > 3 else "full"
    return run(Scenario.from_dict(scenario_dict), backend, timeout=timeout,
               audit=audit)


def derive_cell_seed(base_seed: int, name: str) -> int:
    """Deterministic per-cell seed: the base seed folded with a stable hash
    of the cell name (crc32, never Python's per-interpreter-salted
    ``hash``), so a cell keeps its seed no matter the grid shape, the cell
    order, or which worker process runs it."""
    return (int(base_seed) + zlib.crc32(name.encode("utf-8"))) % (2**31 - 1)


def run_sweep(sweep, backend: str = "thread", *, jobs: int = 1,
              timeout: float = 600.0, audit: str = "full",
              derive_seeds: bool = False) -> List[ScenarioResult]:
    """Run every cell of a sweep (a :class:`~repro.scenario.sweep.Sweep` or
    any iterable of scenarios); returns results in cell order.

    ``jobs > 1`` fans cells across worker processes — each cell owns its
    private Timekeeper/cluster, so cells are embarrassingly parallel and the
    results are independent of ``jobs`` (same cells, same seeds, same
    order).  ``derive_seeds=True`` replaces each cell's inherited seed with
    :func:`derive_cell_seed` of its name, decorrelating the sampled
    workloads across a grid while staying fully reproducible.
    """
    cells = list(sweep.expand()) if hasattr(sweep, "expand") else list(sweep)
    if derive_seeds:
        cells = [scenario_with(c, seed=derive_cell_seed(c.seed, c.name))
                 for c in cells]
    payloads = [(c.to_dict(), backend, timeout, audit) for c in cells]
    if jobs <= 1 or len(cells) <= 1:
        return [_run_cell(p) for p in payloads]
    # spawn, never fork: cells start engine/reader threads and the process
    # backend spawns grandchildren — a forked worker would inherit parent
    # locks mid-flight.
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(int(jobs), len(cells)),
                             mp_context=ctx) as ex:
        return list(ex.map(_run_cell, payloads))


@dataclass
class CompareResult:
    """Outcome of running one scenario on several backends."""

    scenario: str
    backends: Tuple[str, ...]
    results: Dict[str, ScenarioResult]
    slow_step_s: float
    completed_equal: bool
    decisions_equal: bool
    scaleup_tiers_equal: bool
    drained_equal: bool
    max_ttft_err_s: float
    max_tpot_err_s: float
    faults_equal: bool = True

    @property
    def max_err_steps(self) -> float:
        return (max(self.max_ttft_err_s, self.max_tpot_err_s)
                / self.slow_step_s if self.slow_step_s else 0.0)

    def to_row(self) -> dict:
        return {
            "scenario": self.scenario,
            "backends": "/".join(self.backends),
            "completed": {b: r.num_requests for b, r in self.results.items()},
            "completed_equal": self.completed_equal,
            "decisions_equal": self.decisions_equal,
            "ttft_err_steps": round(self.max_ttft_err_s / self.slow_step_s, 3)
            if self.slow_step_s else 0.0,
            "tpot_err_steps": round(self.max_tpot_err_s / self.slow_step_s, 3)
            if self.slow_step_s else 0.0,
            "max_err_steps": round(self.max_err_steps, 3),
        }


def _decisions_of(res: ScenarioResult):
    """The placement audit in a backend-independent form: the decision list
    for open loop, the per-turn placement map for closed loop."""
    return res.placements if res.placements is not None \
        else res.routing_decisions


def compare(scenario: Scenario,
            backends: Sequence[str] = ("thread", "des"), *,
            timeout: float = 600.0,
            slow_step_s: Optional[float] = None,
            check: bool = True,
            jobs: int = 1) -> CompareResult:
    """Run one scenario on several backends and check parity.

    The bar (``check=True``, the default) is the repo's established one:

    * every backend completes the same request set;
    * routing decisions are identical (per-turn placements for sessions);
    * autoscaler scale-up tier sequences and drain victims agree;
    * per-request TTFT and TPOT agree within **one slow-step**
      (``slow_step_s`` defaults to the scenario's coarsest predictor step).

    Violations raise :class:`ParityError`; the returned
    :class:`CompareResult` carries the per-backend results and error
    magnitudes either way (pass ``check=False`` to inspect without
    raising).  ``jobs > 1`` runs the backend legs in parallel worker
    processes (each leg owns its world; results are jobs-independent).
    """
    backends = tuple(backends)
    if len(backends) < 2:
        raise SpecError("compare needs at least two backends")
    if scenario.fleet is not None:
        # fleet slow-step: the coarsest predictor step over *all* model
        # pools (the parity unit must bound every pool's discretization)
        scenario.validate()
        from repro_torch.fleet.runner import fleet_slow_step_s
        step = (slow_step_s if slow_step_s is not None
                else fleet_slow_step_s(scenario))
    else:
        wiring = _Wiring(scenario)
        step = (slow_step_s if slow_step_s is not None
                else wiring.slow_step_s())

    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        payloads = [(scenario.to_dict(), b, timeout) for b in backends]
        with ProcessPoolExecutor(max_workers=min(int(jobs), len(backends)),
                                 mp_context=ctx) as ex:
            results = dict(zip(backends, ex.map(_run_cell, payloads)))
    else:
        results = {b: run(scenario, b, timeout=timeout) for b in backends}
    base_b = backends[0]
    base = results[base_b]

    problems: List[str] = []
    completed_equal = True
    decisions_equal = True
    scaleups_equal = True
    drained_equal = True
    faults_equal = True
    max_ttft = 0.0
    max_tpot = 0.0
    for b in backends[1:]:
        other = results[b]
        if base.faults_injected != other.faults_injected:
            faults_equal = False
            problems.append(
                f"{base_b}/{b}: fault event sequences diverge "
                f"({base.faults_injected} vs {other.faults_injected})")
        if (base.requests_requeued != other.requests_requeued
                or base.requests_failed != other.requests_failed):
            faults_equal = False
            problems.append(
                f"{base_b}/{b}: requeue/fail outcomes diverge "
                f"(requeued {base.requests_requeued} vs "
                f"{other.requests_requeued}, failed {base.requests_failed} "
                f"vs {other.requests_failed})")
        if set(base.latencies) != set(other.latencies):
            completed_equal = False
            problems.append(
                f"{base_b}/{b}: completed different request sets "
                f"({base.num_requests} vs {other.num_requests})")
            continue
        if _decisions_of(base) != _decisions_of(other):
            decisions_equal = False
            problems.append(f"{base_b}/{b}: routing decisions diverge")
        if base.tiers_added != other.tiers_added:
            scaleups_equal = False
            problems.append(
                f"{base_b}/{b}: scale-up tiers diverge "
                f"({base.tiers_added} vs {other.tiers_added})")
        if base.drained != other.drained:
            drained_equal = False
            problems.append(
                f"{base_b}/{b}: drain victims diverge "
                f"({base.drained} vs {other.drained})")
        for k, (ttft_a, tpot_a, _) in base.latencies.items():
            ttft_b, tpot_b, _ = other.latencies[k]
            if ttft_a is not None and ttft_b is not None:
                max_ttft = max(max_ttft, abs(ttft_a - ttft_b))
            if tpot_a is not None and tpot_b is not None:
                max_tpot = max(max_tpot, abs(tpot_a - tpot_b))

    if max(max_ttft, max_tpot) > step + 1e-9:
        problems.append(
            f"latencies diverge by {max(max_ttft, max_tpot) / step:.3f} "
            f"slow-steps (bar: 1.0 × {step}s)")
    out = CompareResult(
        scenario=scenario.name, backends=backends, results=results,
        slow_step_s=step, completed_equal=completed_equal,
        decisions_equal=decisions_equal,
        scaleup_tiers_equal=scaleups_equal, drained_equal=drained_equal,
        max_ttft_err_s=max_ttft, max_tpot_err_s=max_tpot,
        faults_equal=faults_equal)
    if check and problems:
        raise ParityError(
            f"scenario {scenario.name!r} parity failed across "
            f"{'/'.join(backends)}: " + "; ".join(problems))
    return out
