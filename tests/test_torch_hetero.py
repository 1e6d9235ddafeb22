"""Heterogeneous replica pools: tier specs, tier-aware routing, cost
accounting, tier-selecting autoscaling, and mixed-pool emulator-vs-DES
parity.

Determinism methodology matches tests/test_cluster.py: ManualWallSource runs
advance virtual time only through Timekeeper-coordinated jumps, so
mixed-tier timelines are exactly reproducible from their seed — the basis of
the byte-identical-metrics regression below.
"""

import copy

import pytest

from repro_torch.cluster import (Autoscaler, AutoscalerConfig, QueueDepthPolicy,
                           SchedulePolicy, TierSpec, TTFTSLOPolicy,
                           build_cluster, drain_victim, make_router,
                           make_tier_specs, probe_throughput,
                           provision_delay, tier_engine_cfg)
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.clock import ManualWallSource
from repro_torch.core.hardware import get_chip
from repro_torch.core.predictor import StaticPredictor
from repro_torch.des.simulator import DESConfig, DiscreteEventSimulator
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.workload import (SessionConfig, SessionWorkload, WorkloadConfig,
                            synthesize)

MODEL = get_reduced_config("qwen2_5_3b")
# per-tier predictors: the h100 tier steps 2.5x faster than the l4 tier
DT = {"h100": 5e-3, "l4": 12.5e-3}


def tier_predictors():
    return {t: StaticPredictor(s) for t, s in DT.items()}


def engine_cfg(**kw):
    base = dict(policy="vllm", max_num_seqs=8, max_batched_tokens=64,
                block_size=4, num_blocks=4096)
    base.update(kw)
    return EngineConfig(**base)


def tier_specs(ecfg=None):
    return make_tier_specs(MODEL, ecfg or engine_cfg(), list(DT),
                           tier_predictors=tier_predictors())


def build(tiers, policy="round_robin", ecfg=None, **kw):
    ecfg = ecfg or engine_cfg()
    return build_cluster(MODEL, ecfg, len(tiers), policy=policy,
                         tiers=list(tiers),
                         tier_predictors=tier_predictors(),
                         tier_specs=tier_specs(ecfg),
                         wall=ManualWallSource(), **kw)


def workload(n=16, qps=40.0, seed=3, **kw):
    base = dict(num_requests=n, qps=qps, prompt_len_mean=24,
                output_len_mean=8, max_prompt_len=48, max_output_len=12,
                seed=seed)
    base.update(kw)
    return synthesize(WorkloadConfig(**base))


# =========================================================================
# tier arithmetic units
# =========================================================================

def test_chip_aliases_and_costs():
    assert get_chip("h100") is get_chip("h100-sxm")
    assert get_chip("l4").name == "l4"
    assert get_chip("l4").cost_per_hour < get_chip("a100").cost_per_hour \
        < get_chip("h100").cost_per_hour
    assert get_chip("h100").cost_per_second == pytest.approx(5.5 / 3600)
    with pytest.raises(KeyError):
        get_chip("gpu-from-the-future")


def test_tier_engine_cfg_kv_capacity_reflects_chip():
    # a base config demanding ~42 GB of KV (20000 blocks x 16 tok x 128 KB):
    # fits the h100 (stays at the configured ceiling) but not the l4
    # (shrinks to what the chip holds after weights)
    model = get_config("llama3_8b")
    base = EngineConfig(block_size=16, num_blocks=20000)
    h100 = tier_engine_cfg(base, "h100", model)
    l4 = tier_engine_cfg(base, "l4", model)
    assert h100.chip == "h100" and l4.chip == "l4"
    assert h100.num_blocks == base.num_blocks
    assert 0 < l4.num_blocks < base.num_blocks
    # 70B weights (~141 GB bf16) cannot fit one l4 at all
    with pytest.raises(ValueError):
        tier_engine_cfg(base, "l4", get_config("llama3_70b"))


def test_tier_specs_from_predictors():
    specs = tier_specs()
    assert set(specs) == {"h100", "l4"}
    # throughput follows the per-tier step time (2.5x ratio), cost the chip
    ratio = specs["h100"].throughput_factor / specs["l4"].throughput_factor
    assert ratio == pytest.approx(DT["l4"] / DT["h100"])
    assert specs["l4"].cost_per_replica_s < specs["h100"].cost_per_replica_s
    assert specs["h100"].projected_ttft_s == pytest.approx(2 * DT["h100"])
    assert probe_throughput(StaticPredictor(0.01), batch=8) == 800.0


def test_ttft_slo_policy_selects_cheapest_feasible_tier():
    fast = TierSpec("h100", "h100-sxm", 5.5 / 3600, 800.0, 0.02)
    slow = TierSpec("l4", "l4", 0.8 / 3600, 200.0, 0.08)
    # loose SLO: both feasible, cheap one wins
    assert TTFTSLOPolicy(slo_ttft_s=0.5).select_tier(
        None, [fast, slow]).name == "l4"
    # tight SLO: only the fast tier projects to meet it
    assert TTFTSLOPolicy(slo_ttft_s=0.1).select_tier(
        None, [fast, slow]).name == "h100"
    # impossible SLO: fall back to the fastest tier
    assert TTFTSLOPolicy(slo_ttft_s=0.001).select_tier(
        None, [fast, slow]).name == "h100"
    # base policies default to cheapest
    assert QueueDepthPolicy().select_tier(None, [fast, slow]).name == "l4"


def test_provision_delay_per_tier():
    cfg = AutoscalerConfig(provision_delay_s=1.0,
                           provision_delay_by_tier={"l4": 0.25})
    assert provision_delay(cfg, "l4") == 0.25
    assert provision_delay(cfg, "h100") == 1.0
    assert provision_delay(cfg, None) == 1.0


# =========================================================================
# tier-aware routing units (fake views)
# =========================================================================

class FakeView:
    def __init__(self, tokens):
        self._t = tokens

    def outstanding_tokens(self):
        return self._t

    def prefix_match_len(self, tokens):
        return 0


def test_weighted_least_outstanding_normalizes_by_throughput():
    r = make_router("least_outstanding_tokens", 2)
    views = [FakeView(100), FakeView(40)]
    assert r.route(None, views) == 1          # unweighted: fewest tokens
    r.set_tier(0, weight=4.0, cost=1.0)       # replica 0 drains 4x faster
    assert r.route(None, views) == 0          # 100/4 < 40/1


def test_cost_normalized_load_prefers_cheap_tier():
    r = make_router("cost_normalized_load", 2)
    h100 = tier_specs()["h100"]
    l4 = tier_specs()["l4"]
    r.set_tier(0, weight=h100.throughput_factor, cost=h100.cost_per_replica_s)
    r.set_tier(1, weight=l4.throughput_factor, cost=l4.cost_per_replica_s)
    # equal (zero) load: the cheap tier wins the tie
    assert r.route(None, [FakeView(0), FakeView(0)]) == 1
    # the cheap tier is buried in backlog: the idle h100 wins despite price
    assert r.route(None, [FakeView(0), FakeView(5000)]) == 0
    # untiered (all costs 0): degrades to plain least-outstanding
    r2 = make_router("cost_normalized_load", 2)
    assert r2.route(None, [FakeView(10), FakeView(5)]) == 1


# =========================================================================
# satellite: mixed-tier routing determinism + drained-replica regression
# =========================================================================

def _session_workload(**kw):
    base = dict(num_sessions=6, qps=3.0, turns_mean=3.0, max_turns=4,
                think_time_mean=0.2, prompt_len_mean=30, followup_len_mean=10,
                output_len_mean=6, max_output_len=10, seed=7)
    base.update(kw)
    return SessionWorkload(SessionConfig(**base))


def test_mixed_tier_routing_byte_identical_across_runs():
    """Same seed + same tier mix ⇒ byte-identical metrics: the heterogeneous
    timeline is still a pure-jump deterministic computation."""

    def run_once():
        cluster = build(["h100", "l4"], policy="cost_normalized_load")
        try:
            res = BenchmarkRunner(cluster, _session_workload(),
                                  transport=cluster.transport).run(timeout=120)
            timeline = sorted(
                (r.session_id, r.turn_index, r.arrival_time,
                 r.first_token_time, r.finish_time)
                for r in cluster.finished)
            return (timeline, list(cluster.router.decisions),
                    res.cost_dollars, res.tier_seconds,
                    res.ttft, res.tpot)
        finally:
            cluster.shutdown()

    a, b = run_once(), run_once()
    assert a == b, "mixed-tier run is not byte-identical across same-seed runs"


def test_drained_cheap_replica_never_receives_new_sessions():
    """Regression: after the cheap tier drains out, no fresh request — not
    even a sticky-affinity session follow-up — may land on it."""
    sw = _session_workload(num_sessions=5, turns_mean=4.0, seed=11)
    cluster = build(["h100", "h100", "l4"], policy="prefix_affinity")
    try:
        cluster.start()
        victim = 2                             # the l4 replica
        # steer a couple of leading sessions through the l4 so the sticky
        # map points at it, then drain it mid-run
        first = sw.initial_requests()
        for r in first[:2]:
            cluster.engines[victim].prefix_match_len(r.prompt_tokens)
        res_runner = BenchmarkRunner(cluster, sw,
                                     transport=cluster.transport)
        # drain as soon as the first completions exist (inside the run):
        # registering the listener before run() keeps ordering simple
        drained_at_decision = []

        def drain_once(finished):
            if not drained_at_decision and victim in cluster.active:
                drained_at_decision.append(len(cluster.router.decisions))
                cluster.drain_replica(victim)

        cluster.add_completion_listener(drain_once)
        res_runner.run(timeout=120)
        cluster.remove_completion_listener(drain_once)
        assert drained_at_decision, "drain never happened"
        cut = drained_at_decision[0]
        late = cluster.router.decisions[cut:]
        assert late, "no routing decisions after the drain"
        assert all(d != victim for d in late), \
            f"drained l4 replica received new work: {late}"
        assert cluster.membership_events()[victim]["drained"] is not None
        assert len(cluster.finished) == sw.total_requests
    finally:
        cluster.shutdown()


# =========================================================================
# cost accounting
# =========================================================================

def test_replica_cost_and_tier_seconds_accounting():
    cluster = build(["h100", "l4"])
    specs = tier_specs()
    try:
        # static membership over a 3 s window
        assert cluster.tier_seconds(0.0, 3.0) == {"h100": 3.0, "l4": 3.0}
        expect = 3.0 * (specs["h100"].cost_per_replica_s
                        + specs["l4"].cost_per_replica_s)
        assert cluster.replica_cost(0.0, 3.0) == pytest.approx(expect)
        # l4 joined mid-window and drained before the end
        cluster._membership[1]["added"] = 1.0
        cluster._membership[1]["drained"] = 2.5
        assert cluster.replica_cost(0.0, 3.0) == pytest.approx(
            3.0 * specs["h100"].cost_per_replica_s
            + 1.5 * specs["l4"].cost_per_replica_s)
    finally:
        cluster.shutdown()


def test_untiered_cluster_costs_zero():
    cluster = build_cluster(MODEL, engine_cfg(), 2,
                            predictor=StaticPredictor(DT["h100"]),
                            wall=ManualWallSource())
    try:
        assert cluster.replica_cost(0.0, 5.0) == 0.0
        assert cluster.tier_seconds(0.0, 5.0) == {None: 10.0}
    finally:
        cluster.shutdown()


# =========================================================================
# tier-selecting autoscaler end-to-end
# =========================================================================

def test_autoscaler_scales_into_cheapest_tier():
    """Sustained overload on a lone h100: the queue-depth policy scales up
    and — with candidate tiers configured — provisions the cheap l4 (the
    default cheapest-candidate selection), recorded end to end: scaleups
    log, replica tier, engine chip, router weights, dollar cost."""
    reqs = workload(n=40, qps=60.0, output_len_mean=10)
    cluster = build(["h100"], policy="least_outstanding_tokens",
                    ecfg=engine_cfg(max_num_seqs=4))
    asc = Autoscaler(
        cluster, QueueDepthPolicy(target_depth=2.0),
        AutoscalerConfig(interval_s=0.02, provision_delay_s=0.05,
                         min_replicas=1, max_replicas=3,
                         tiers=("h100", "l4"),
                         provision_delay_by_tier={"l4": 0.03}))
    try:
        res = BenchmarkRunner(cluster, reqs, transport=cluster.transport,
                              autoscaler=asc).run(timeout=120)
    finally:
        cluster.shutdown()
    added = [t for _, t in asc.scaleups]
    assert added and all(t == "l4" for t in added), \
        f"expected cheap-tier scale-ups, got {added}"
    assert cluster.replica_tiers[0] == "h100"
    assert all(t == "l4" for t in cluster.replica_tiers[1:])
    assert all(e.cfg.chip == "l4" for e in cluster.engines[1:])
    specs = tier_specs()
    assert cluster.router.weights[1] == specs["l4"].throughput_factor
    assert cluster.router.costs[1] == specs["l4"].cost_per_replica_s
    assert len(cluster.finished) == 40
    assert res.cost_dollars > 0
    assert res.tier_seconds.get("l4", 0) > 0


# =========================================================================
# mixed-pool emulator-vs-DES parity
# =========================================================================

def test_hetero_emulator_matches_des_static_pool():
    """Fixed h100+l4 pool, no autoscaler: per-request latencies agree within
    one slow-tier step — heterogeneous step times alone open no gap."""
    reqs = workload(n=16, qps=30.0)
    reqs_des = copy.deepcopy(reqs)
    ecfg = engine_cfg(enable_prefix_caching=False)
    cluster = build(["h100", "l4"], ecfg=ecfg)
    try:
        BenchmarkRunner(cluster, reqs,
                        transport=cluster.transport).run(timeout=120)
        emu = {r.request_id: r.e2e_latency() for r in cluster.finished}
    finally:
        cluster.shutdown()

    des = DiscreteEventSimulator(
        StaticPredictor(DT["h100"]),
        DESConfig(max_num_seqs=8, max_batched_tokens=64, step_overhead_s=0.0),
        num_replicas=2, router=make_router("round_robin", 2),
        replica_tiers=["h100", "l4"], tier_predictors=tier_predictors(),
        tier_specs=tier_specs(ecfg))
    sims = des.run(reqs_des)
    slow = max(DT.values())
    for orig, sim in zip(reqs_des, sims):
        assert sim.finish_time is not None
        err = abs(emu[orig.request_id] - (sim.finish_time - sim.arrival_time))
        assert err <= slow + 1e-9, \
            f"request {orig.request_id} diverges by {err / slow:.2f} steps"


def test_hetero_elastic_emulator_matches_des():
    """Mixed pool + scripted tier-selecting scale-up mid-run: both sides add
    the same (cheapest) tier at the same virtual time and latencies agree
    within one slow-tier step.  One ``repro.scenario.compare`` call
    replaces the hand-rolled emulator+DES plumbing: the scenario spec
    carries the pool, the schedule, and the per-tier predictors, and both
    backends are wired from it identically by construction."""
    from repro_torch.scenario import compare, scenario_with, get_preset

    scenario = scenario_with(
        get_preset("elastic_tier_parity"),
        name="hetero_elastic_parity",
        **{"workload.arrival": "poisson",   # queued regime, same bar
           "workload.qps": 30.0,
           "workload.num_requests": 16,
           "workload.output_len_mean": 8.0,
           "workload.max_output_len": 12,
           "pool.tier_step_time_s": DT,
           "autoscale.schedule": [[0.08, 1]],
           "autoscale.interval_s": 0.05,
           "seed": 3})
    cres = compare(scenario, backends=("thread", "des"), timeout=120)
    emu, des = cres.results["thread"], cres.results["des"]
    assert emu.tiers_added == des.tiers_added == ["l4"]
    assert emu.replica_tiers == des.replica_tiers == ["h100", "l4", "l4"]
    assert cres.decisions_equal
    assert cres.max_err_steps <= 1.0
    assert emu.num_requests == des.num_requests == 16


def test_des_rejects_unknown_tier():
    with pytest.raises(ValueError):
        DiscreteEventSimulator(StaticPredictor(5e-3), num_replicas=1,
                               replica_tiers=["l4"])


# =========================================================================
# tier-aware drain victim selection (shared emulator/DES rule)
# =========================================================================

def test_drain_victim_prefers_expensive_idle_tier():
    costs = {0: 5.5 / 3600, 1: 0.8 / 3600, 2: 5.5 / 3600}
    # all idle: the pricier tier goes first, index breaks the h100 tie
    assert drain_victim([0, 1, 2], idle_of=lambda i: True,
                        cost_of=costs.get) == 2
    assert drain_victim([0, 1], idle_of=lambda i: True,
                        cost_of=costs.get) == 0
    # only the cheap replica is idle: it wins over busy expensive ones
    assert drain_victim([0, 1, 2], idle_of=lambda i: i == 1,
                        cost_of=costs.get) == 1
    # nobody idle: same (cost, index) order over the busy set
    assert drain_victim([0, 1, 2], idle_of=lambda i: False,
                        cost_of=costs.get) == 2
    # untiered pool (cost 0.0 everywhere): historical highest-index rule
    assert drain_victim([0, 1, 2], idle_of=lambda i: True,
                        cost_of=lambda i: 0.0) == 2
    assert drain_victim([0], idle_of=lambda i: True,
                        cost_of=lambda i: 0.0) is None


def test_autoscaler_drains_expensive_idle_tier_first():
    """Mixed quiet pool [h100, l4, h100]: the scripted scale-down must give
    back an idle h100 (highest index breaks the tie), not the historical
    highest-index-only victim semantics' cheapest... i.e. never the l4."""
    reqs = workload(n=8, qps=1e4)
    tail = workload(n=1, qps=1.0, seed=9)
    tail[0].arrival_time = 1.0        # keeps the run alive past the drain
    cluster = build(["h100", "l4", "h100"])
    asc = Autoscaler(cluster, SchedulePolicy([(0.4, -1)]),
                     AutoscalerConfig(interval_s=0.05, provision_delay_s=0.1,
                                      min_replicas=1, max_replicas=3))
    try:
        BenchmarkRunner(cluster, reqs + tail, transport=cluster.transport,
                        autoscaler=asc).run(timeout=120)
        drained = [m["replica"] for m in cluster.membership_events()
                   if m["drained"] is not None]
        assert drained == [2], \
            f"expected the idle h100 at index 2 to drain, got {drained}"
        assert len(cluster.finished) == 9
    finally:
        cluster.shutdown()


def test_hetero_drain_parity_emulator_vs_des():
    """Scripted drain on a mixed [h100, l4, h100] pool: the shared
    drain_victim rule must retire the same replica at the same virtual time
    on both sides, keeping per-request latencies within one slow step."""
    events = [(0.4, -1)]
    asc_cfg = AutoscalerConfig(interval_s=0.05, provision_delay_s=0.1,
                               min_replicas=1, max_replicas=3)
    reqs = workload(n=12, qps=40.0)
    reqs[-1].arrival_time = 1.0
    reqs_des = copy.deepcopy(reqs)
    ecfg = engine_cfg(enable_prefix_caching=False)

    cluster = build(["h100", "l4", "h100"], ecfg=ecfg)
    asc = Autoscaler(cluster, SchedulePolicy(events), asc_cfg)
    try:
        BenchmarkRunner(cluster, reqs, transport=cluster.transport,
                        autoscaler=asc).run(timeout=120)
        emu = {r.request_id: r.e2e_latency() for r in cluster.finished}
        emu_drained = [m["replica"] for m in cluster.membership_events()
                       if m["drained"] is not None]
    finally:
        cluster.shutdown()

    des = DiscreteEventSimulator(
        StaticPredictor(DT["h100"]),
        DESConfig(max_num_seqs=8, max_batched_tokens=64, step_overhead_s=0.0),
        num_replicas=3, router=make_router("round_robin", 3),
        autoscaler_policy=SchedulePolicy(events), autoscaler_cfg=asc_cfg,
        replica_tiers=["h100", "l4", "h100"],
        tier_predictors=tier_predictors(), tier_specs=tier_specs(ecfg))
    sims = des.run(reqs_des)

    des_drained = [r.index for r in des.replicas if r.drained_at is not None]
    assert emu_drained == des_drained == [2]
    slow = max(DT.values())
    for orig, sim in zip(reqs_des, sims):
        assert sim.finish_time is not None
        err = abs(emu[orig.request_id] - (sim.finish_time - sim.arrival_time))
        assert err <= slow + 1e-9, \
            f"request {orig.request_id} diverges by {err / slow:.2f} steps"
