"""Process-mode cluster runtime: replicas as OS processes over the
time-warp socket transport.

Covers the cross-process control plane end to end: submit/completion frames
(the pre-barrier ack invariant closed-loop sessions build on), same-seed
parity with the thread backend, drain/add over the wire (warm-pool
activation), and ReplicaView probes answered by the child's live engine.

These tests spawn real child processes (multiprocessing ``spawn``), so they
are wall-slower than the rest of the suite and carry pytest-timeout markers:
a wedged barrier or a hung child must fail, not freeze, CI.
"""

import pytest

from repro_torch.cluster import (Autoscaler, AutoscalerConfig, ProcessCluster,
                           SchedulePolicy, build_cluster)
from repro_torch.configs import get_reduced_config
from repro_torch.core.predictor import StaticPredictor
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.workload import (SessionConfig, SessionWorkload, WorkloadConfig,
                            synthesize)

pytestmark = pytest.mark.timeout(300)

MODEL = get_reduced_config("qwen2_5_3b")
# Deliberately slow predictor step: socket round trips absorb wall time
# into the virtual timeline (Eq. 1), and the parity bar is "within one of
# these" — same methodology as benchmarks/fig_distributed.py.
STEP = 50e-3


def engine_cfg(**kw):
    base = dict(policy="vllm", max_num_seqs=8, max_batched_tokens=64,
                block_size=4, num_blocks=4096, enable_prefix_caching=False)
    base.update(kw)
    return EngineConfig(**base)


def workload(n=8, qps=8.0, seed=3, **kw):
    base = dict(num_requests=n, qps=qps, prompt_len_mean=24,
                output_len_mean=6, max_prompt_len=48, max_output_len=10,
                seed=seed)
    base.update(kw)
    return synthesize(WorkloadConfig(**base))


def build(replicas, *, backend="process", step=STEP, warm=None, **kw):
    return build_cluster(MODEL, engine_cfg(), replicas, policy="round_robin",
                         predictor=StaticPredictor(step), backend=backend,
                         warm_replicas=warm, **kw)


def drive(cluster, reqs, *, autoscaler=None, timeout=120.0):
    return BenchmarkRunner(cluster, reqs, transport=cluster.transport,
                           autoscaler=autoscaler).run(timeout=timeout)


# =========================================================================
# basics
# =========================================================================

def test_process_cluster_serves_open_loop():
    cluster = build(2)
    try:
        assert isinstance(cluster, ProcessCluster)
        res = drive(cluster, workload(n=8))
        assert res.num_requests == 8
        assert res.num_replicas == 2
        # round robin over two live child processes
        assert sorted(set(cluster.router.decisions)) == [0, 1]
        per_replica = [h.stats()["finished"] for h in cluster.engines]
        assert sum(per_replica) == 8 and all(c > 0 for c in per_replica)
        # step accounting crossed the wire
        assert len(cluster.step_log) > 0
        assert res.ttft.p50 > 0
        # virtual time ran ahead of wall time (the point of the exercise)
        assert res.makespan_virtual > res.wall_seconds
    finally:
        cluster.shutdown()


def test_process_replica_probes_answer_from_child_engine():
    """ReplicaView probes are real RPCs into the child's engine counters:
    zero when idle, zero again once submitted work completed (a mid-flight
    nonzero read exists but is wall-racy, so not asserted), and the
    parent-side in-flight ledger empties exactly at the completion frames."""
    cluster = build(2)
    try:
        cluster.start()
        h = cluster.engines[0]
        assert h.num_outstanding() == 0
        assert h.outstanding_tokens() == 0
        assert h.prefix_match_len([1, 2, 3]) == 0
        reqs = workload(n=4, qps=1e6)
        for r in reqs:
            cluster.submit(r)
        assert cluster.wait_until_complete(4, timeout=60)
        assert h.num_outstanding() == 0
        assert h.outstanding_tokens() == 0
        assert h.in_flight_ids() == set()
        assert sum(x.stats()["finished"] for x in cluster.engines) == 4
    finally:
        cluster.shutdown()


def test_process_cluster_rejects_incompatible_modes():
    from repro_torch.core.clock import ManualWallSource
    with pytest.raises(AssertionError):
        build_cluster(MODEL, engine_cfg(), 2, backend="process", mode="sleep",
                      predictor=StaticPredictor(STEP))
    with pytest.raises(AssertionError):
        build_cluster(MODEL, engine_cfg(), 2, backend="process",
                      predictor=StaticPredictor(STEP),
                      wall=ManualWallSource())
    with pytest.raises(AssertionError):
        build_cluster(MODEL, engine_cfg(), 2, backend="process",
                      policy="pd_pool", predictor=StaticPredictor(STEP))
    with pytest.raises(AssertionError):
        build_cluster(MODEL, engine_cfg(), 2, backend="nope",
                      predictor=StaticPredictor(STEP))


# =========================================================================
# same-seed parity with the thread backend (the acceptance bar)
# =========================================================================

def test_process_backend_matches_thread_backend_same_seed():
    """Identical routing decisions; per-request TTFT/TPOT within one
    slow-step — the repo's analogue of the paper's distributed-causality
    claim, also asserted at benchmark scale by fig_distributed.  One
    ``repro.scenario.compare`` call replaces the hand-rolled two-backend
    plumbing: the scenario spec carries the whole cell."""
    from repro_torch.scenario import compare, scenario_with, get_preset

    scenario = scenario_with(
        get_preset("distributed_parity"),
        name="process_thread_parity",
        **{"workload.arrival": "poisson",     # queued regime, same bar
           "workload.qps": 6.0,
           "workload.num_requests": 12,
           "workload.output_len_mean": 6.0,
           "workload.max_output_len": 10,
           "pool.step_time_s": STEP,
           "seed": 11})
    cres = compare(scenario, backends=("thread", "process"), timeout=120)
    assert cres.decisions_equal
    assert cres.max_err_steps <= 1.0
    assert cres.results["thread"].num_requests == 12
    assert cres.results["process"].num_requests == 12


# =========================================================================
# closed loop over the wire
# =========================================================================

def test_process_closed_loop_sessions_complete_all_turns():
    """The cross-process completion-listener path: each finished turn's
    completion frame reaches the runner (which registers the think-time
    actor) BEFORE the child replica re-enters the barrier — so no follow-up
    is ever skipped over, and release-rule causality holds exactly."""
    sw = SessionWorkload(SessionConfig(
        num_sessions=4, qps=3.0, turns_mean=2.5, max_turns=3,
        think_time_mean=0.2, prompt_len_mean=30, followup_len_mean=10,
        output_len_mean=6, max_output_len=10, seed=7))
    cluster = build(2, step=5e-3)
    try:
        res = drive(cluster, sw)
        assert res.num_requests == sw.total_requests
        assert res.num_sessions == sw.num_sessions
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
    finally:
        cluster.shutdown()


# =========================================================================
# elastic membership over the wire
# =========================================================================

def test_drain_replica_over_the_wire():
    """Drain = stop routing → in-flight completion frames → retire
    (deregister) frame; drained child keeps its stats reachable."""
    cluster = build(2, step=5e-3)
    try:
        cluster.start()
        reqs = workload(n=10, qps=1e6)
        for r in reqs[:6]:
            cluster.submit(r)
        cluster.drain_replica(1)
        assert cluster.num_active() == 1
        for r in reqs[6:]:
            cluster.submit(r)
        assert cluster.wait_until_complete(10, timeout=60)
        assert all(d == 0 for d in cluster.router.decisions[6:])
        assert len(cluster.finished) == 10
        m = cluster.membership_events()[1]
        assert m["drain_started"] is not None
        assert m["drained"] is not None and m["drained"] >= m["drain_started"]
        assert cluster.engines[1].retired
        # post-drain: the child process is alive and still answers stats
        assert cluster.engines[1].stats()["finished"] > 0
        with pytest.raises(ValueError):
            cluster.drain_replica(1)
    finally:
        cluster.shutdown()


def test_autoscaler_activates_warm_standby_and_drains():
    """Scripted scale-up activates a pre-spawned warm child (one
    start_engine frame — no process-spawn wall time mid-run), serves work,
    then the scripted scale-down retires it over the wire."""
    sw = SessionWorkload(SessionConfig(
        num_sessions=5, qps=3.0, turns_mean=3.0, max_turns=4,
        think_time_mean=0.3, prompt_len_mean=30, followup_len_mean=10,
        output_len_mean=6, max_output_len=10, seed=29))
    cluster = build(1, step=5e-3, warm=2)
    assert cluster.warm_available == 1
    asc = Autoscaler(cluster, SchedulePolicy([(0.2, +1), (1.2, -1)]),
                     AutoscalerConfig(interval_s=0.1, provision_delay_s=0.1,
                                      min_replicas=1, max_replicas=2))
    try:
        res = drive(cluster, sw, autoscaler=asc)
        assert res.num_requests == sw.total_requests
        assert len(cluster.engines) == 2, "scale-up never happened"
        assert cluster.warm_available == 0, "warm standby was not activated"
        assert any(d == 1 for _, d, _ in asc.decision_log)
        joined = cluster.membership_events()[1]
        assert joined["added"] is not None
        # the activated replica actually served traffic
        assert cluster.engines[1].stats()["finished"] > 0
        drained = [m["replica"] for m in cluster.membership_events()
                   if m["drained"] is not None]
        assert drained in ([], [1])   # drain may land in the final window
    finally:
        cluster.shutdown()
