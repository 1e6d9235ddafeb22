"""Elastic cluster membership + autoscaling tests: policy units, add/drain
mechanics, closed-loop sessions over the cluster, replica-seconds accounting,
and emulator-vs-DES parity under elastic membership.

Determinism methodology matches tests/test_cluster.py: ManualWallSource runs
advance virtual time only through Timekeeper-coordinated jumps, so elastic
timelines are exactly reproducible.
"""

import copy

import pytest

from repro_torch.cluster import (Autoscaler, AutoscalerConfig, Cluster,
                           QueueDepthPolicy, RoundRobinRouter, SchedulePolicy,
                           TTFTSLOPolicy, build_cluster,
                           make_autoscaler_policy, make_router)
from repro_torch.configs import get_reduced_config
from repro_torch.core.clock import ManualWallSource
from repro_torch.core.predictor import StaticPredictor
from repro_torch.des.simulator import DESConfig, DiscreteEventSimulator
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.workload import (SessionConfig, SessionWorkload, WorkloadConfig,
                            synthesize)

MODEL = get_reduced_config("qwen2_5_3b")
DT = 5e-3                               # StaticPredictor step duration


def engine_cfg(**kw):
    base = dict(policy="vllm", max_num_seqs=8, max_batched_tokens=64,
                block_size=4, num_blocks=4096)
    base.update(kw)
    return EngineConfig(**base)


def workload(n=16, qps=40.0, seed=3, **kw):
    base = dict(num_requests=n, qps=qps, prompt_len_mean=24,
                output_len_mean=8, max_prompt_len=48, max_output_len=12,
                seed=seed)
    base.update(kw)
    return synthesize(WorkloadConfig(**base))


def session_workload(**kw):
    base = dict(num_sessions=6, qps=3.0, turns_mean=3.0, max_turns=4,
                think_time_mean=0.2, prompt_len_mean=30, followup_len_mean=10,
                output_len_mean=6, max_output_len=10, seed=7)
    base.update(kw)
    return SessionWorkload(SessionConfig(**base))


# =========================================================================
# policy units (fake views, no cluster needed)
# =========================================================================

class FakeView:
    def __init__(self, now=0.0, depths=(0,), ttfts=()):
        self._now, self._depths, self._ttfts = now, list(depths), list(ttfts)

    def now(self):
        return self._now

    def active_count(self):
        return len(self._depths)

    def queue_depths(self):
        return list(self._depths)

    def recent_ttfts(self, window_s):
        return list(self._ttfts)


def test_queue_depth_policy_hysteresis():
    p = QueueDepthPolicy(target_depth=4.0, low_watermark=1.0)
    assert p.decide(FakeView(depths=[9, 9])) == 1     # backlog: scale up
    assert p.decide(FakeView(depths=[2, 3])) == 0     # inside the band
    assert p.decide(FakeView(depths=[0, 0])) == -1    # idle: scale down


def test_ttft_slo_policy():
    p = TTFTSLOPolicy(slo_ttft_s=0.1, target_attainment=0.9, idle_depth=0.5)
    # attainment 50% < 90% target: scale up even though queues look calm
    assert p.decide(FakeView(depths=[1], ttfts=[0.05, 0.5])) == 1
    # attainment fine + backlog: hold
    assert p.decide(FakeView(depths=[3], ttfts=[0.05, 0.06])) == 0
    # attainment fine + idle: release capacity
    assert p.decide(FakeView(depths=[0], ttfts=[0.05, 0.06])) == -1
    # no samples yet + idle queues: scale down, never up
    assert p.decide(FakeView(depths=[0])) == -1


def test_schedule_policy_applies_events_once():
    p = SchedulePolicy([(1.0, +1), (2.0, -1), (2.0, +2)])
    assert p.decide(FakeView(now=0.5)) == 0
    assert p.decide(FakeView(now=1.1)) == 1
    assert p.decide(FakeView(now=1.2)) == 0            # already consumed
    assert p.decide(FakeView(now=5.0)) == 1            # -1 +2 batched
    assert p.decide(FakeView(now=9.0)) == 0


def test_make_autoscaler_policy_registry():
    assert isinstance(make_autoscaler_policy("queue_depth"), QueueDepthPolicy)
    assert isinstance(make_autoscaler_policy("ttft_slo"), TTFTSLOPolicy)
    with pytest.raises(ValueError):
        make_autoscaler_policy("nope")


# =========================================================================
# satellite regression: no shared mutable config defaults
# =========================================================================

def test_cluster_config_default_not_shared():
    a = build_cluster(MODEL, engine_cfg(), 1, predictor=StaticPredictor(DT))
    b = build_cluster(MODEL, engine_cfg(), 1, predictor=StaticPredictor(DT))
    try:
        assert a.cfg is not b.cfg
        a.cfg.kv_link_bandwidth = 1.0
        assert b.cfg.kv_link_bandwidth != 1.0
    finally:
        a.shutdown()
        b.shutdown()


def test_des_config_default_not_shared():
    a = DiscreteEventSimulator(StaticPredictor(DT))
    b = DiscreteEventSimulator(StaticPredictor(DT))
    assert a.cfg is not b.cfg


# =========================================================================
# add/drain mechanics
# =========================================================================

def drive(cluster, reqs, *, autoscaler=None, timeout=120.0):
    return BenchmarkRunner(cluster, reqs, transport=cluster.transport,
                           autoscaler=autoscaler).run(timeout=timeout)


def test_add_replica_joins_routing():
    cluster = build_cluster(MODEL, engine_cfg(), 1, policy="round_robin",
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    try:
        cluster.start()
        assert cluster.num_active() == 1
        idx = cluster.add_replica()
        assert idx == 1 and cluster.num_active() == 2
        assert cluster.router.num_replicas == 2
        reqs = workload(n=8, qps=1e6)
        for r in reqs:
            cluster.submit(r)
        assert cluster.wait_until_complete(8, timeout=60)
        # round robin over the grown membership: both replicas served
        assert set(cluster.router.decisions) == {0, 1}
        assert cluster.engines[1].stats()["finished"] > 0
    finally:
        cluster.shutdown()


def test_drain_replica_stops_routing_and_finishes_in_flight():
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="round_robin",
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    try:
        cluster.start()
        reqs = workload(n=10, qps=1e6)
        for r in reqs[:6]:
            cluster.submit(r)
        cluster.drain_replica(1)         # mid-flight: replica 1 has work
        assert cluster.num_active() == 1
        for r in reqs[6:]:
            cluster.submit(r)
        assert cluster.wait_until_complete(10, timeout=60)
        # every request routed after the drain landed on replica 0
        assert all(d == 0 for d in cluster.router.decisions[6:])
        # all in-flight work on the drained replica still completed
        assert len(cluster.finished) == 10
        m = cluster.membership_events()[1]
        assert m["drain_started"] is not None
        assert m["drained"] is not None
        assert m["drained"] >= m["drain_started"]
        with pytest.raises(ValueError):
            cluster.drain_replica(1)     # already drained
    finally:
        cluster.shutdown()


def test_drain_last_replica_refused():
    cluster = build_cluster(MODEL, engine_cfg(), 1,
                            predictor=StaticPredictor(DT))
    try:
        with pytest.raises(AssertionError):
            cluster.drain_replica(0)
    finally:
        cluster.shutdown()


def test_replica_seconds_accounting():
    cluster = build_cluster(MODEL, engine_cfg(), 2,
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    try:
        # static membership: N * window exactly
        assert cluster.replica_seconds(0.0, 3.0) == pytest.approx(6.0)
        cluster._membership[1]["added"] = 1.0       # joined mid-window
        cluster._membership[1]["drained"] = 2.5     # drained before the end
        assert cluster.replica_seconds(0.0, 3.0) == pytest.approx(3.0 + 1.5)
    finally:
        cluster.shutdown()


# =========================================================================
# closed-loop sessions over the cluster
# =========================================================================

def test_sessions_closed_loop_completes_all_turns():
    sw = session_workload()
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="round_robin",
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    try:
        res = drive(cluster, sw)
    finally:
        cluster.shutdown()
    assert res.num_requests == sw.total_requests
    assert res.num_sessions == sw.num_sessions
    assert res.session_ttft is not None and res.session_ttft.p50 > 0
    # closed loop: every turn>0 arrived strictly after its predecessor's
    # finish plus the sampled think time
    by_session = {}
    for r in cluster.finished:
        by_session.setdefault(r.session_id, {})[r.turn_index] = r
    checked = 0
    for sid, turns in by_session.items():
        for k, r in turns.items():
            if k == 0:
                continue
            prev = turns[k - 1]
            think = sw.sessions[sw._index_of(sid)].turns[k].think_time
            assert r.arrival_time >= prev.finish_time + think - 1e-6
            checked += 1
    assert checked > 0, "workload produced no multi-turn sessions"


def test_sessions_exercise_prefix_cache_via_affinity():
    """Follow-up turns carry the prior turn's tokens: with prefix_affinity
    routing they must co-locate with their session's KV and produce real
    radix hits (the point of session-aware synthesis)."""
    sw = session_workload(num_sessions=4, turns_mean=4.0, seed=11)
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="prefix_affinity",
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    try:
        drive(cluster, sw)
        hits = sum(e.prefix_cache.stats.hit_tokens for e in cluster.engines)
        assert hits > 0, "session follow-ups produced no radix-cache hits"
        # per-session turn placements are consistent
        sess_replica = {}
        for r in cluster.finished:
            eng = next(i for i, e in enumerate(cluster.engines)
                       if r in e.finished)
            sess_replica.setdefault(r.session_id, set()).add(eng)
        multi = [s for s in sess_replica.values()]
        assert all(len(s) == 1 for s in multi), \
            f"session turns scattered across replicas: {sess_replica}"
    finally:
        cluster.shutdown()


def test_closed_loop_deterministic_timelines():
    def timeline():
        sw = session_workload(seed=23)
        cluster = build_cluster(MODEL, engine_cfg(), 2, policy="round_robin",
                                predictor=StaticPredictor(DT),
                                wall=ManualWallSource())
        try:
            drive(cluster, sw)
            return sorted((r.session_id, r.turn_index, r.arrival_time,
                           r.first_token_time, r.finish_time)
                          for r in cluster.finished)
        finally:
            cluster.shutdown()

    t1, t2 = timeline(), timeline()
    assert len(t1) == len(t2)
    for a, b in zip(t1, t2):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            assert x == pytest.approx(y, abs=1e-9)


# =========================================================================
# autoscaler end-to-end on the emulated cluster
# =========================================================================

def test_autoscaler_scales_up_under_backlog_and_respects_max():
    # sustained overload: one max_num_seqs=4 replica completes ~4 req per
    # 10 steps; 60 qps piles a backlog that only added replicas can absorb,
    # and the stream is long enough that post-provision arrivals exist
    reqs = workload(n=40, qps=60.0, output_len_mean=10)
    cluster = build_cluster(MODEL, engine_cfg(max_num_seqs=4), 1,
                            policy="least_outstanding_tokens",
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    asc = Autoscaler(cluster, QueueDepthPolicy(target_depth=2.0),
                     AutoscalerConfig(interval_s=0.02,
                                      provision_delay_s=0.05,
                                      min_replicas=1, max_replicas=3))
    try:
        drive(cluster, reqs, autoscaler=asc)
    finally:
        cluster.shutdown()
    ups = sum(d for _, d, _ in asc.decision_log if d > 0)
    assert ups >= 1, "backlog never triggered a scale-up"
    # the engines list is append-only (drained replicas stay parked); the
    # max_replicas cap bounds *active* membership at every decision point
    assert all(active <= 3 for _, _, active in asc.decision_log), \
        "max_replicas breached"
    assert cluster.num_active() <= 3
    assert len(cluster.finished) == 40
    # added replicas actually served work
    assert any(cluster.engines[i].stats()["finished"] > 0
               for i in range(1, len(cluster.engines)))


def test_autoscaler_drains_when_idle():
    # a long quiet tail after a burst: the policy must give capacity back
    reqs = workload(n=12, qps=1e4)
    tail = workload(n=1, qps=1.0, seed=9)
    tail[0].arrival_time = 3.0
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="round_robin",
                            predictor=StaticPredictor(DT),
                            wall=ManualWallSource())
    asc = Autoscaler(cluster, QueueDepthPolicy(target_depth=4.0,
                                               low_watermark=1.0),
                     AutoscalerConfig(interval_s=0.05, provision_delay_s=0.1,
                                      min_replicas=1, max_replicas=2))
    try:
        drive(cluster, reqs + tail, autoscaler=asc)
    finally:
        cluster.shutdown()
    downs = sum(-d for _, d, _ in asc.decision_log if d < 0)
    assert downs >= 1, "idle cluster never scaled down"
    assert cluster.membership_events()[1]["drained"] is not None
    assert len(cluster.finished) == 13


# =========================================================================
# emulator-vs-DES parity under elastic membership
# =========================================================================

ELASTIC_EVENTS = [(0.08, +1), (0.5, -1)]     # scale up early, drain mid-run
ASC_CFG = AutoscalerConfig(interval_s=0.05, provision_delay_s=0.1,
                           min_replicas=1, max_replicas=2)


def test_elastic_emulator_matches_elastic_des():
    """Scale-up + drain mid-run, same SchedulePolicy on both sides: the
    emulator and the DES must agree on completed counts and per-request
    latencies within one predictor step — the §2.3 parity argument extended
    to elastic membership."""
    reqs = workload(n=16, qps=30.0)
    # tail arrival keeps the run alive past the drain event, so the -1 tick
    # fires deterministically *during* the measured window on both sides
    # (otherwise it lands in the post-completion teardown race)
    reqs[-1].arrival_time = 1.2
    reqs_des = copy.deepcopy(reqs)

    cluster = build_cluster(
        MODEL, engine_cfg(enable_prefix_caching=False), 1,
        policy="round_robin", predictor=StaticPredictor(DT),
        wall=ManualWallSource())
    asc = Autoscaler(cluster, SchedulePolicy(ELASTIC_EVENTS), ASC_CFG)
    try:
        drive(cluster, reqs, autoscaler=asc)
        emu_latency = {r.request_id: r.e2e_latency()
                       for r in cluster.finished}
        assert len(cluster.engines) == 2, "scale-up never happened"
        assert any(d == 1 for _, d, _ in asc.decision_log)
        assert any(d == -1 for _, d, _ in asc.decision_log)
    finally:
        cluster.shutdown()

    des = DiscreteEventSimulator(
        StaticPredictor(DT),
        DESConfig(max_num_seqs=8, max_batched_tokens=64, step_overhead_s=0.0),
        num_replicas=1, router=make_router("round_robin", 1),
        autoscaler_policy=SchedulePolicy(ELASTIC_EVENTS),
        autoscaler_cfg=ASC_CFG)
    sims = des.run(reqs_des)

    assert len(des.replicas) == 2, "DES scale-up never happened"
    assert des.replicas[1].drained_at is not None, "DES drain never finished"
    assert len(emu_latency) == len(reqs)
    assert sum(1 for s in sims if s.finish_time is not None) == len(reqs)
    for orig, sim in zip(reqs_des, sims):
        err = abs(emu_latency[orig.request_id]
                  - (sim.finish_time - sim.arrival_time))
        assert err <= DT + 1e-9, \
            (f"request {orig.request_id}: elastic emulator/DES diverges by "
             f"{err / DT:.2f} steps")


def test_session_emulator_matches_session_des():
    """Closed-loop parity: the same SessionWorkload object drives both the
    emulator (completion-callback re-injection) and the DES (event-loop
    re-injection); per-turn latencies agree within one step."""
    sw = session_workload(num_sessions=5, think_time_mean=0.15, seed=29)

    cluster = build_cluster(
        MODEL, engine_cfg(enable_prefix_caching=False), 2,
        policy="round_robin", predictor=StaticPredictor(DT),
        wall=ManualWallSource())
    try:
        drive(cluster, sw)
        emu = {(r.session_id, r.turn_index): r.e2e_latency()
               for r in cluster.finished}
    finally:
        cluster.shutdown()

    des = DiscreteEventSimulator(
        StaticPredictor(DT),
        DESConfig(max_num_seqs=8, max_batched_tokens=64, step_overhead_s=0.0),
        num_replicas=2, router=make_router("round_robin", 2))
    sims = des.run(sw)

    assert len(sims) == sw.total_requests == len(emu)
    for s in sims:
        assert s.finish_time is not None
        err = abs(emu[(s.session_id, s.turn_index)]
                  - (s.finish_time - s.arrival_time))
        assert err <= DT + 1e-9, \
            (f"session {s.session_id} turn {s.turn_index}: "
             f"emulator/DES diverges by {err / DT:.2f} steps")


def test_des_rejects_pd_pool_still():
    with pytest.raises(ValueError):
        DiscreteEventSimulator(
            StaticPredictor(DT), DESConfig(),
            num_replicas=2, router=make_router("pd_pool", 2))


def test_cluster_rejects_elastic_pd_pool():
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="pd_pool",
                            predictor=StaticPredictor(DT))
    try:
        with pytest.raises(AssertionError):
            cluster.add_replica()
        with pytest.raises(AssertionError):
            cluster.drain_replica(1)
    finally:
        cluster.shutdown()
