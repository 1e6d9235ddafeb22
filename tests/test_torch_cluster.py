"""Cluster layer tests: router policies, multi-replica determinism, and
emulator-vs-DES parity at cluster scale.

Determinism methodology: the reproducibility tests inject a
:class:`ManualWallSource`, under which wall time never flows on its own —
virtual time advances *only* through Timekeeper-coordinated jumps, so two
identical cluster runs must produce bit-identical virtual request timelines
(the barrier protocol serialises every step).  With a real wall clock the
timeline additionally absorbs scheduler CPU time at wall rate, which is the
emulator's modelling of control-plane overhead, not nondeterminism.
"""

import copy
import threading

import pytest

from repro_torch.cluster import (Cluster, LeastOutstandingTokensRouter, PDPoolRouter,
                           PrefixAffinityRouter, RoundRobinRouter,
                           build_cluster, make_router)
from repro_torch.cluster.router import ROUTER_POLICIES
from repro_torch.configs import get_reduced_config
from repro_torch.core.client import TimeJumpClient
from repro_torch.core.clock import ManualWallSource
from repro_torch.core.predictor import StaticPredictor
from repro_torch.des.simulator import DESConfig, DiscreteEventSimulator
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.workload import WorkloadConfig, synthesize

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


# =========================================================================
# router policy units (no engines needed: fake views)
# =========================================================================

class FakeView:
    def __init__(self, outstanding=0, prefix=None):
        self._out = outstanding
        self._prefix = prefix or {}

    def outstanding_tokens(self):
        return self._out

    def prefix_match_len(self, tokens):
        return self._prefix.get(tuple(tokens[:4]), 0)


class FakeReq:
    def __init__(self, tokens, out=8):
        self.prompt_tokens = list(tokens)
        self.max_new_tokens = out


def test_round_robin_cycles():
    r = RoundRobinRouter(3)
    views = [FakeView() for _ in range(3)]
    picks = [r.route(FakeReq([i]), views) for i in range(7)]
    assert picks == [0, 1, 2, 0, 1, 2, 0]


def test_least_outstanding_balances_skewed_loads():
    """Under skewed prompt lengths the token-aware policy places onto the
    genuinely least-loaded replica, not just the fewest-requests one."""
    r = LeastOutstandingTokensRouter(3)
    views = [FakeView(outstanding=900), FakeView(outstanding=50),
             FakeView(outstanding=400)]
    assert r.route(FakeReq(range(8)), views) == 1
    # deterministic tie-break: lowest index wins
    views = [FakeView(outstanding=7), FakeView(outstanding=7), FakeView(9)]
    assert r.route(FakeReq(range(8)), views) == 0


def test_prefix_affinity_prefers_cache_hits():
    r = PrefixAffinityRouter(2)
    key = (1, 2, 3, 4)
    views = [FakeView(outstanding=500),
             FakeView(outstanding=0, prefix={})]
    views[0]._prefix = {key: 16}         # replica 0 holds the prefix
    # despite higher load, the cache-holding replica wins
    assert r.route(FakeReq([1, 2, 3, 4, 5, 6]), views) == 0


def test_prefix_affinity_sticky_before_cache_warm():
    """Shared-prompt session requests co-locate even when no replica has
    cached the prefix yet (probe returns 0 everywhere): the first placement
    is remembered by prompt head."""
    r = PrefixAffinityRouter(4)
    views = [FakeView(outstanding=o) for o in (5, 3, 9, 3)]
    shared = list(range(100, 140))
    first = r.route(FakeReq(shared + [1]), views)
    assert first == 1                    # least outstanding, lowest index
    # loads shift, but the session stays put
    views = [FakeView(outstanding=o) for o in (0, 99, 0, 0)]
    for suffix in ([2], [3, 4], [5]):
        assert r.route(FakeReq(shared + suffix), views) == first
    # a different session routes independently: with replica 1 now heavily
    # loaded, the fresh session must land somewhere else
    assert r.route(FakeReq(list(range(500, 540)), 4), views) != 1


def test_pd_pool_splits_and_routes():
    r = PDPoolRouter(4)                  # 2 prefill + 2 decode
    assert r.prefill_indices == [0, 1] and r.decode_indices == [2, 3]
    views = [FakeView(outstanding=o) for o in (9, 2, 50, 1)]
    assert r.route(FakeReq(range(8)), views) == 1          # prefill pool only
    assert r.route_decode(FakeReq(range(8)), views) == 3   # decode pool only
    assert r.intake_indices() == [0, 1]


def test_make_router_registry():
    assert set(ROUTER_POLICIES) == {
        "round_robin", "least_outstanding_tokens", "cost_normalized_load",
        "prefix_affinity", "pd_pool", "adapter_affinity"}
    with pytest.raises(ValueError):
        make_router("nope", 2)


# =========================================================================
# cluster end-to-end: routing behaviour with real engines
# =========================================================================

def drive_cluster(cluster, reqs, timeout=120.0):
    cluster.start()
    disp = TimeJumpClient(cluster.transport, "dispatcher")
    t0 = cluster.clock.now()
    try:
        for r in sorted(reqs, key=lambda r: r.arrival_time):
            disp.jump_to(t0 + r.arrival_time)
            r.arrival_time = cluster.clock.now()
            cluster.submit(r)
    finally:
        disp.deregister()
    ok = cluster.wait_until_complete(len(reqs), timeout=timeout)
    assert ok, f"cluster did not drain: {len(cluster.finished)}/{len(reqs)}"
    return cluster


def test_cluster_prefix_affinity_colocates_sessions():
    """Sessions sharing a long system prompt must all land on one replica
    (where the radix cache holds their prefix); per-replica hit rates prove
    the KV was actually reused, not just co-located."""
    reqs = workload(n=20, qps=30.0, shared_prefix_len=32,
                    prompt_len_mean=40, max_prompt_len=64)
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="prefix_affinity",
                            predictor=StaticPredictor(DT))
    try:
        drive_cluster(cluster, reqs)
        decisions = cluster.router.decisions
        assert len(set(decisions)) == 1, \
            f"shared-prefix sessions scattered across replicas: {decisions}"
        target = cluster.engines[decisions[0]]
        assert target.prefix_cache.stats.hit_tokens > 0, \
            "co-location must produce actual prefix-cache hits"
    finally:
        cluster.shutdown()


def test_cluster_least_outstanding_balances():
    """Distinct-prompt traffic must spread across replicas under the
    token-aware policy (no starvation of either replica)."""
    reqs = workload(n=24, qps=60.0)
    cluster = build_cluster(MODEL, engine_cfg(), 2,
                            policy="least_outstanding_tokens",
                            predictor=StaticPredictor(DT))
    try:
        drive_cluster(cluster, reqs)
        per_replica = [e.stats()["finished"] for e in cluster.engines]
        assert sum(per_replica) == 24
        assert min(per_replica) >= 24 // 4, \
            f"least-outstanding starved a replica: {per_replica}"
    finally:
        cluster.shutdown()


def test_cluster_pd_pool_migrates_kv():
    reqs = workload(n=10, qps=80.0)
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="pd_pool",
                            predictor=StaticPredictor(DT),
                            kv_link_bandwidth=1e5)   # slow link: visible time
    try:
        drive_cluster(cluster, reqs)
        assert all(r.kv_migrated for r in cluster.finished)
        assert any(r.kv_transfer_time > 0 for r in cluster.finished), \
            "KV migration must consume virtual time"
        # prefill replicas never decode beyond the first token
        for i in cluster.router.prefill_indices:
            for rec in cluster.engines[i].step_log:
                assert rec.num_decode == 0
    finally:
        cluster.shutdown()


def test_cluster_rejects_mixed_clocks():
    a = build_cluster(MODEL, engine_cfg(), 1, predictor=StaticPredictor(DT))
    b = build_cluster(MODEL, engine_cfg(), 1, predictor=StaticPredictor(DT))
    try:
        with pytest.raises(AssertionError):
            Cluster([a.engines[0], b.engines[0]], RoundRobinRouter(2))
    finally:
        a.shutdown()
        b.shutdown()


# =========================================================================
# determinism: identical runs -> identical virtual timelines
# =========================================================================

def _timeline(num_replicas, policy, seed=11):
    """Run a cluster on a manual wall source; return the per-request
    virtual-time timeline {request index -> (arrival, first_token, finish)}."""
    reqs = workload(n=12, qps=50.0, seed=seed)
    order = {r.request_id: i for i, r in enumerate(reqs)}
    cluster = build_cluster(
        MODEL, engine_cfg(), num_replicas, policy=policy,
        predictor=StaticPredictor(DT), wall=ManualWallSource())
    try:
        drive_cluster(cluster, reqs)
        return {
            order[r.request_id]:
                (r.arrival_time, r.first_token_time, r.finish_time)
            for r in cluster.finished
        }, list(cluster.router.decisions)
    finally:
        cluster.shutdown()


def test_cluster_determinism_identical_timelines():
    """Two identical 2-replica runs produce *identical* virtual-time request
    timelines (arrival/TTFT/finish) and identical routing decisions."""
    tl1, dec1 = _timeline(2, "round_robin")
    tl2, dec2 = _timeline(2, "round_robin")
    assert dec1 == dec2
    assert tl1.keys() == tl2.keys()
    for k in tl1:
        a1, f1, e1 = tl1[k]
        a2, f2, e2 = tl2[k]
        assert a1 == pytest.approx(a2, abs=1e-9)
        assert f1 == pytest.approx(f2, abs=1e-9)
        assert e1 == pytest.approx(e2, abs=1e-9)


# =========================================================================
# emulator-vs-DES parity at cluster scale (§2.3 extended)
# =========================================================================

def test_two_replica_emulator_matches_two_replica_des():
    """Same workload, same router policy, same predictor: the 2-replica
    emulator and the 2-replica DES agree on completed-request count, and
    per-request virtual finish latencies agree within the predictor's own
    step granularity (StaticPredictor: one step = DT)."""
    reqs = workload(n=16, qps=40.0)
    reqs_des = copy.deepcopy(reqs)

    cluster = build_cluster(
        MODEL, engine_cfg(enable_prefix_caching=False), 2,
        policy="round_robin", predictor=StaticPredictor(DT),
        wall=ManualWallSource())
    try:
        drive_cluster(cluster, reqs)
        emu_latency = {r.request_id: r.e2e_latency()
                       for r in cluster.finished}
    finally:
        cluster.shutdown()

    des = DiscreteEventSimulator(
        StaticPredictor(DT),
        DESConfig(max_num_seqs=8, max_batched_tokens=64, step_overhead_s=0.0),
        num_replicas=2, router=make_router("round_robin", 2))
    sims = des.run(reqs_des)

    assert len(emu_latency) == len(reqs)
    assert sum(1 for s in sims if s.finish_time is not None) == len(reqs)
    for orig, sim in zip(reqs_des, sims):
        des_latency = sim.finish_time - sim.arrival_time
        err = abs(emu_latency[orig.request_id] - des_latency)
        assert err <= DT + 1e-9, \
            (f"request {orig.request_id}: emulator/DES finish diverges by "
             f"{err / DT:.2f} steps")


def test_des_single_replica_unchanged():
    """num_replicas=1 must reproduce the pre-refactor single-engine DES."""
    reqs = workload(n=10, qps=30.0, seed=5)
    des = DiscreteEventSimulator(
        StaticPredictor(DT), DESConfig(max_num_seqs=8, max_batched_tokens=64))
    sims = des.run(reqs)
    assert all(s.finish_time is not None for s in sims)
    assert all(s.num_generated == s.max_new_tokens for s in sims)
    assert all(s.replica == 0 for s in sims)


def test_des_rejects_pd_pool():
    with pytest.raises(ValueError):
        DiscreteEventSimulator(
            StaticPredictor(DT), DESConfig(),
            num_replicas=2, router=make_router("pd_pool", 2))


def test_des_rejects_router_size_mismatch():
    with pytest.raises(ValueError):
        DiscreteEventSimulator(
            StaticPredictor(DT), DESConfig(),
            num_replicas=2, router=make_router("round_robin", 4))


# =========================================================================
# benchmark pipeline over a cluster
# =========================================================================

def test_benchmark_runner_drives_cluster():
    reqs = workload(n=12, qps=40.0)
    cluster = build_cluster(MODEL, engine_cfg(), 2, policy="round_robin",
                            predictor=StaticPredictor(DT))
    try:
        res = BenchmarkRunner(cluster, reqs,
                              transport=cluster.transport).run(timeout=120)
    finally:
        cluster.shutdown()
    assert res.num_requests == 12
    assert res.num_replicas == 2
    assert res.routing_policy == "round_robin"
    assert len(res.per_replica) == 2
    assert res.ttft.p50 > 0 and res.makespan_virtual > 0
    assert res.goodput_rps() == pytest.approx(res.request_rate_completed)
    assert res.goodput_rps(slo_ttft_s=0.0) == 0.0
    assert "completed_rps" in res.summary()
    # observer surface: first poll drains everything, second is empty
    assert len(cluster.poll()) == 12
    assert cluster.poll() == []
