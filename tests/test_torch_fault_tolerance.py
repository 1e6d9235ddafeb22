"""Fault tolerance: checkpoint/restart of the emulated serving stack,
straggler degradation, and elastic actor membership.

The paper's §4.2.1 guarantees are "never incorrect, only slower"; these tests
extend them to full process-failure recovery: an engine snapshot taken
mid-run restores into a fresh engine and every in-flight request completes
with exactly the right number of tokens.
"""

import dataclasses
import threading
import time

import pytest

from repro_torch.cluster import build_cluster
from repro_torch.cluster.autoscaler import drain_victim
from repro_torch.core.client import LocalTransport, TimeJumpClient
from repro_torch.core.predictor import StaticPredictor
from repro_torch.core.timekeeper import Timekeeper
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.serving.engine import LLMEngine
from repro_torch.serving.model_runner import TimeWarpModelRunner
from repro_torch.serving.scheduler import EngineConfig
from repro_torch.serving.stack import build_stack
from repro_torch.workload import WorkloadConfig, synthesize
from repro_torch.configs import get_reduced_config


def small_cfg(**kw):
    base = dict(policy="vllm", max_num_seqs=8, max_batched_tokens=64,
                block_size=4, num_blocks=2048)
    base.update(kw)
    return EngineConfig(**base)


def small_workload(n=20, qps=50.0, seed=0):
    return synthesize(WorkloadConfig(
        num_requests=n, qps=qps, prompt_len_mean=24, output_len_mean=8,
        max_prompt_len=64, max_output_len=16, seed=seed))


MODEL = get_reduced_config("qwen2_5_3b")


# =========================================================================
# checkpoint / restart
# =========================================================================

def test_snapshot_restore_mid_run():
    """Kill the engine halfway; restore from snapshot; everything finishes."""
    reqs = small_workload(n=16)
    stack = build_stack(MODEL, small_cfg(), "emulate",
                        predictor=StaticPredictor(5e-3),
                        use_worker_group=False)
    eng = stack.engine.start()
    for r in reqs[:10]:
        eng.submit(r)
    # let roughly half the work land
    eng.wait_until_complete(4, timeout=30)
    blob = eng.snapshot()
    n_done_at_snap = len(eng.finished)
    stack.shutdown()                       # "node failure"

    # restore into a brand-new stack (fresh Timekeeper + runner)
    stack2 = build_stack(MODEL, small_cfg(), "emulate",
                         predictor=StaticPredictor(5e-3),
                         use_worker_group=False)
    stack2.timekeeper.close()              # replace engine wholesale
    tk = Timekeeper(jitter_cooldown=0.0)
    tr = LocalTransport(tk)
    client = TimeJumpClient(tr, "restored-worker")
    runner = TimeWarpModelRunner(StaticPredictor(5e-3), client)
    eng2 = LLMEngine.restore(blob, runner, tk.clock, name="restored")
    eng2.start()
    for r in reqs[10:]:                    # traffic keeps arriving
        eng2.submit(r)
    ok = eng2.wait_until_complete(16 - n_done_at_snap, timeout=60)
    assert ok, "restored engine must drain all in-flight + new requests"
    eng2.stop()
    tk.close()

    all_done = {r.request_id for r in eng2.finished} | {
        r.request_id for r in reqs[:10] if r.request_id in
        {x.request_id for x in eng2.finished}}
    for r in reqs:
        pass
    # every request finished exactly once with the right token count
    finished_ids = [r.request_id for r in eng2.finished]
    assert len(finished_ids) == len(set(finished_ids)), "duplicate completion"
    for r in eng2.finished:
        assert r.num_generated == r.max_new_tokens


def test_snapshot_preserves_virtual_clock():
    stack = build_stack(MODEL, small_cfg(), "emulate",
                        predictor=StaticPredictor(10e-3),
                        use_worker_group=False)
    eng = stack.engine.start()
    for r in small_workload(n=6, qps=100.0):
        eng.submit(r)
    eng.wait_until_complete(6, timeout=30)
    t_before = eng.clock.now()
    offset_before = eng.clock.offset
    blob = eng.snapshot()
    stack.shutdown()

    tk = Timekeeper(jitter_cooldown=0.0)
    runner = TimeWarpModelRunner(
        StaticPredictor(10e-3), TimeJumpClient(LocalTransport(tk), "w"))
    eng2 = LLMEngine.restore(blob, runner, tk.clock)
    # restored virtual clock resumes at (or after) the snapshot time: history
    # is never re-lived, so latency measurements stay consistent
    assert eng2.clock.now() >= t_before - 1e-3
    assert tk.clock.offset >= offset_before - 1e-3
    tk.close()


def test_restored_requests_recompute_from_scratch():
    """Running requests lose device KV on failure; they must re-queue as
    WAITING with zeroed progress (idempotent replay)."""
    from repro_torch.serving.request import Request, RequestState
    stack = build_stack(MODEL, small_cfg(max_batched_tokens=8), "emulate",
                        predictor=StaticPredictor(50e-3),
                        use_worker_group=False)
    eng = stack.engine               # not started: step manually for determinism
    big = Request(prompt_tokens=list(range(1, 65)), max_new_tokens=4)
    eng.scheduler.add_request(big)
    eng.step(); eng.step()           # two 8-token chunks of the 64-token prompt
    assert 0 < big.num_prefilled < big.prompt_len
    blob = eng.snapshot()
    stack.shutdown()

    tk = Timekeeper(jitter_cooldown=0.0)
    runner = TimeWarpModelRunner(
        StaticPredictor(1e-3), TimeJumpClient(LocalTransport(tk), "w"))
    eng2 = LLMEngine.restore(blob, runner, tk.clock)
    restored = list(eng2.scheduler.waiting)
    assert any(r.request_id == big.request_id for r in restored)
    rr = next(r for r in restored if r.request_id == big.request_id)
    assert rr.num_prefilled == 0 and rr.state == RequestState.WAITING
    eng2.start()
    assert eng2.wait_until_complete(1, timeout=30)
    assert eng2.finished[0].num_generated == 4
    eng2.stop()
    tk.close()


def test_snapshot_round_trips_preemption_state_deterministically():
    """Regression (non-blocking submit path): a snapshot must capture the
    scheduler's preemption/waiting state between steps — never a torn
    mid-step state — and restore it verbatim.  Drive an engine into
    preemption manually, snapshot, and check the restored scheduler queues
    are byte-equivalent across repeated restores."""
    from repro_torch.serving.request import Request, RequestState

    # tiny KV pool so two long decodes collide -> preemption-by-recompute
    stack = build_stack(MODEL, small_cfg(num_blocks=8, max_batched_tokens=64,
                                         enable_prefix_caching=False),
                        "emulate", predictor=StaticPredictor(1e-3),
                        use_worker_group=False)
    eng = stack.engine                 # not started: step manually
    ra = Request(prompt_tokens=list(range(1, 13)), max_new_tokens=20)
    rb = Request(prompt_tokens=list(range(101, 113)), max_new_tokens=20)
    eng.scheduler.add_request(ra)
    eng.scheduler.add_request(rb)
    for _ in range(40):
        eng.step()
        if eng.scheduler.num_preemptions >= 1:
            break
    assert eng.scheduler.num_preemptions >= 1, "setup must trigger preemption"
    assert eng.scheduler.waiting, "preempted request must sit in waiting"
    blob = eng.snapshot()
    stack.shutdown()

    def restored_state():
        tk = Timekeeper(jitter_cooldown=0.0)
        runner = TimeWarpModelRunner(
            StaticPredictor(1e-3), TimeJumpClient(LocalTransport(tk), "w"))
        eng2 = LLMEngine.restore(blob, runner, tk.clock)
        state = [(r.request_id, r.state, r.num_prefilled, r.num_preemptions)
                 for r in eng2.scheduler.waiting]
        return eng2, tk, state

    eng_a, tk_a, state_a = restored_state()
    eng_b, tk_b, state_b = restored_state()
    assert state_a == state_b, "restore must be deterministic"
    # scheduler counters round-trip (not reset to zero)
    assert eng_a.scheduler.num_preemptions >= 1
    # preempted requests re-enter with zeroed progress, ready for recompute
    for rid, state, prefilled, nprempt in state_a:
        assert state in (RequestState.WAITING, RequestState.PREEMPTED)
        assert prefilled == 0
    # and the restored engine still drains everything exactly
    eng_a.start()
    assert eng_a.wait_until_complete(2, timeout=60)
    for r in eng_a.finished:
        assert r.num_generated == r.max_new_tokens
    eng_a.stop()
    tk_a.close()
    tk_b.close()


def test_snapshot_never_tears_a_running_step():
    """Concurrent snapshots while the engine thread is stepping and the
    dispatcher keeps submitting must always observe a consistent
    between-steps state: every request is in exactly one queue and token
    counts are internally coherent."""
    import pickle as _pickle

    reqs = small_workload(n=24, qps=500.0)
    stack = build_stack(MODEL, small_cfg(), "emulate",
                        predictor=StaticPredictor(2e-3),
                        use_worker_group=False)
    eng = stack.engine.start()
    blobs = []
    for i, r in enumerate(reqs):
        eng.submit(r)
        if i % 4 == 0:
            blobs.append(eng.snapshot())     # racing the step loop
    eng.wait_until_complete(len(reqs), timeout=60)
    blobs.append(eng.snapshot())
    stack.shutdown()

    all_ids = {r.request_id for r in reqs}
    for blob in blobs:
        state = _pickle.loads(blob)
        seen = [r.request_id for pool in ("waiting", "running", "inbox",
                                          "finished")
                for r in state[pool]]
        assert len(seen) == len(set(seen)), "request in two queues at once"
        assert set(seen) <= all_ids
        for r in state["running"]:
            # a torn snapshot would capture prefill progress beyond the
            # prompt without the decode transition having been applied
            assert r.num_prefilled <= r.prompt_len
            assert r.num_generated <= r.max_new_tokens
        for r in state["finished"]:
            assert r.num_generated == r.max_new_tokens


# =========================================================================
# straggler mitigation / graceful degradation
# =========================================================================

def test_straggler_degrades_to_wall_clock_never_wrong():
    """An actor that stops responding mid-barrier costs wall time but the
    other actor's TIMEJUMP still returns with the correct virtual target.
    Wall time is a ManualWallSource: the degradation *accounting* (virtual
    progress is paid for in wall seconds) is asserted exactly, without the
    test itself sleeping on the real clock."""
    from repro_torch.core.clock import ManualWallSource, VirtualClock
    wall = ManualWallSource()
    tk = Timekeeper(VirtualClock(wall), jitter_cooldown=0.0)
    tr = LocalTransport(tk)
    fast = TimeJumpClient(tr, "fast")
    straggler = TimeJumpClient(tr, "straggler")   # registers, never jumps

    t0 = fast.now()
    wall0 = wall.time()
    done = threading.Event()
    result = {}

    def jump():
        result["t1"] = fast.time_jump(0.15)   # timeout path: rides wall
        done.set()

    th = threading.Thread(target=jump)
    th.start()
    # drive the manual wall forward until the degraded jump completes; the
    # barrier never resolves (the straggler never jumps), so the only way
    # the jump can return is by paying these wall seconds
    for _ in range(10_000):
        if done.wait(0.0005):
            break
        wall.advance(0.01)
    th.join(10)
    assert done.is_set(), "degraded jump must complete once wall flows"
    spent = wall.time() - wall0
    assert result["t1"] >= t0 + 0.15 - 1e-6, \
        "virtual target must still be reached"
    assert spent >= 0.15 - 1e-6, "degradation means paying wall clock"
    fast.deregister()
    straggler.deregister()
    tk.close()


def test_straggler_recovers_acceleration():
    """After the straggler departs (elastic deregistration), the remaining
    actor's jumps resolve instantly again."""
    tk = Timekeeper(jitter_cooldown=0.0)
    tr = LocalTransport(tk)
    fast = TimeJumpClient(tr, "fast")
    straggler = TimeJumpClient(tr, "straggler")
    straggler.deregister()        # elastic scale-down re-evaluates barrier

    wall0 = time.monotonic()
    fast.time_jump(5.0)           # would take 5 s wall if degraded
    wall = time.monotonic() - wall0
    assert wall < 1.0, "sole remaining actor must jump at full speed"
    fast.deregister()
    tk.close()


def test_engine_park_prevents_barrier_wedge():
    """An idle engine must not stall the dispatcher's time jumps: parking
    deregisters its actors (regression test for the idle-wedge)."""
    stack = build_stack(MODEL, small_cfg(), "emulate",
                        predictor=StaticPredictor(1e-3),
                        use_worker_group=False)
    eng = stack.engine.start()
    assert eng._idle.wait(10.0), "engine must park (no work)"
    client = TimeJumpClient(stack.transport, "probe")
    wall0 = time.monotonic()
    client.time_jump(10.0)        # must resolve without the engine
    assert time.monotonic() - wall0 < 2.0
    client.deregister()
    stack.shutdown()


# =========================================================================
# chaos fault matrix: {crash, straggler, spot_reclaim} × backend × policy
# =========================================================================

def _chaos_cell(kind, on_crash):
    """One matrix cell as a Scenario: the chaos presets re-pointed at one
    fault kind with the requested on-crash policy.  Fault times are the
    presets' verified mid-decode instants, so the fault always has victims
    (requeue/fail counts are deterministic, not racy)."""
    from repro_torch.scenario import get_preset
    if kind == "crash":
        base = get_preset("crash_recovery")
        faults = tuple(dataclasses.replace(f, on_crash=on_crash)
                       for f in base.faults)
    elif kind == "straggler":
        base = get_preset("chaos_spot")
        faults = tuple(f for f in base.faults if f.kind == "straggler")
    else:
        base = get_preset("chaos_spot")
        faults = tuple(dataclasses.replace(f, on_crash=on_crash)
                       if f.kind == "spot_reclaim" else f
                       for f in base.faults)
    return dataclasses.replace(base, name=f"{kind}_{on_crash}",
                               faults=faults)


FAULT_MATRIX = [("crash", "requeue"), ("crash", "fail"),
                ("straggler", "requeue"),
                ("spot_reclaim", "requeue"), ("spot_reclaim", "fail")]


@pytest.mark.timeout(180)
@pytest.mark.parametrize("backend", ["thread", "process", "des"])
@pytest.mark.parametrize("kind,on_crash", FAULT_MATRIX)
def test_fault_matrix_conservation(kind, on_crash, backend):
    """Every fault kind on every backend under both crash policies:
    completed + failed == submitted (nothing lost, nothing duplicated),
    the fault is actually applied, and fail-policy runs never requeue."""
    from repro_torch.scenario import run
    scenario = _chaos_cell(kind, on_crash)
    res = run(scenario, backend=backend, timeout=120)
    n = scenario.workload.num_requests
    assert res.num_requests + res.requests_failed == n, (
        f"conservation violated: {res.num_requests} completed + "
        f"{res.requests_failed} failed != {n} submitted")
    kinds = {e[0] for e in res.faults_injected}
    if kind == "crash":
        assert {"crash", "respawn"} <= kinds
        hit = (res.requests_requeued if on_crash == "requeue"
               else res.requests_failed)
        assert hit == 1, "the preset crash instant is mid-decode"
    elif kind == "straggler":
        assert {"straggle", "straggle_end"} <= kinds
        assert res.num_requests == n
    else:
        assert {"reclaim", "reclaim_kill", "respawn"} <= kinds
        hit = (res.requests_requeued if on_crash == "requeue"
               else res.requests_failed)
        assert hit == 1, "the notice window is too short to drain"
    if on_crash == "fail":
        assert res.requests_requeued == 0
    # each completion measured exactly once in the audit trail
    assert len(res.latencies) == res.num_requests


@pytest.mark.timeout(300)
@pytest.mark.parametrize("preset", ["crash_recovery", "chaos_spot"])
def test_chaos_preset_three_way_parity(preset):
    """The acceptance bar: both chaos presets through thread / process /
    DES must produce the identical fault log (same faults at the same
    virtual instants, same requeue/fail outcomes), identical routing
    decisions, and latencies within one slow-step.  ``compare`` raises
    ParityError on any divergence."""
    from repro_torch.scenario import compare, get_preset
    cres = compare(get_preset(preset),
                   backends=("thread", "process", "des"), timeout=240)
    assert cres.faults_equal and cres.decisions_equal
    assert cres.max_err_steps <= 1.0
    logs = [tuple(r.faults_injected) for r in cres.results.values()]
    assert len(set(logs)) == 1 and logs[0], "fault logs must match exactly"


@pytest.mark.timeout(180)
@pytest.mark.parametrize("on_crash", ["requeue", "fail"])
def test_process_backend_sigkill_exact_tokens(on_crash):
    """Crash on the process backend is a real SIGKILL of the replica child;
    the parent recovers in-flight requests from its submission ledger and
    the run still completes with exact token counts — no lost and no
    duplicated completions."""
    cluster = build_cluster(MODEL, small_cfg(), 2,
                            predictor=StaticPredictor(5e-3),
                            backend="process")
    try:
        cluster.start()
        reqs = small_workload(n=12, qps=500.0, seed=7)
        ids = {r.request_id for r in reqs}
        for r in reqs:
            cluster.submit(r)
        out = cluster.crash_replica(1, on_crash=on_crash)
        assert out["crashed"], "child must be killable mid-run"
        # the child OS process is really gone (SIGKILL, not a drain)
        assert not cluster.replicas[1].proc.is_alive()
        assert cluster.wait_until_complete(len(reqs), timeout=120)
        finished = list(cluster.finished)
        failed = list(cluster.failed)
        fids = [r.request_id for r in finished]
        assert len(fids) == len(set(fids)), "duplicate completion"
        assert len(finished) + len(failed) == len(reqs)
        assert set(fids) | {r.request_id for r in failed} == ids
        assert not (set(fids) & {r.request_id for r in failed})
        for r in finished:
            assert r.num_generated == r.max_new_tokens
        if on_crash == "requeue":
            assert not failed and out["requeued"] > 0
        else:
            assert len(failed) == out["failed"] > 0
    finally:
        cluster.shutdown()


def test_crash_while_draining_not_refinalized_or_double_billed():
    """Regression: a replica that crashes *while draining* must (a) leave
    the drain ledger so later completions never re-finalize it, (b) never
    be a future drain victim, and (c) close its billing window exactly once
    at the crash instant.  Engines are deliberately not started, so the
    in-flight set at drain time is deterministic."""
    cluster = build_cluster(MODEL, small_cfg(), 3,
                            predictor=StaticPredictor(5e-3))
    try:
        reqs = small_workload(n=6, qps=1000.0, seed=5)
        for r in reqs:
            cluster.submit(r)               # round robin: 2 per replica
        cluster.drain_replica(1)
        assert 1 in cluster._draining, "drain must be pending (in-flight)"
        out = cluster.crash_replica(1, on_crash="requeue")
        assert out["crashed"] and out["requeued"] == 2
        assert 1 not in cluster._draining
        m_crash = cluster.membership_events()[1]
        assert m_crash["drained"] is not None
        # (a) delivering the requeued work's completions later must not
        # re-finalize the membership record
        cluster._drain_progress(reqs)
        assert cluster.membership_events()[1] == m_crash
        # (b) gone from the routing set -> drain_victim can't pick it
        assert 1 not in cluster.active
        victim = drain_victim(cluster.active, idle_of=lambda i: True,
                              cost_of=lambda i: 1.0)
        assert victim != 1
        # (c) billed exactly once: replica 1's window closes at the crash
        # stamp, so a window starting there bills only the two survivors —
        # a leaked drain ledger entry would bill it through the window end
        t_crash = m_crash["drained"]
        assert cluster.replica_seconds(t_crash, t_crash + 10.0) == \
            pytest.approx(20.0)
    finally:
        cluster.shutdown()


@pytest.mark.timeout(180)
def test_crash_while_draining_parity_and_single_billing():
    """The chaos_spot reclaim IS a crash-while-draining (drain notice too
    short, kill lands mid-decode): thread and DES must agree on the drain
    record (victim drained exactly once) and bill the same replica-seconds
    and dollars — double-counting a crashed-while-draining replica would
    show up as a cost divergence."""
    from repro_torch.scenario import compare, get_preset
    cres = compare(get_preset("chaos_spot"), backends=("thread", "des"),
                   timeout=120)
    thread, des = cres.results["thread"], cres.results["des"]
    kill = next(e for e in thread.faults_injected
                if e[0] == "reclaim_kill")
    assert kill[5], "the reclaim kill must land mid-drain (crashed=True)"
    assert thread.drained == des.drained
    assert thread.drained.count(2) == 1, "victim finalized exactly once"
    assert thread.replica_seconds == pytest.approx(des.replica_seconds,
                                                   rel=1e-9)
    assert thread.cost_dollars == pytest.approx(des.cost_dollars, rel=1e-9)


# =========================================================================
# elastic scaling
# =========================================================================

def test_actors_join_and_leave_between_rounds():
    tk = Timekeeper(jitter_cooldown=0.0)
    tr = LocalTransport(tk)
    a = TimeJumpClient(tr, "a")
    b = TimeJumpClient(tr, "b")

    done = []

    def jump(client, dt):
        client.time_jump(dt)
        done.append(client.actor_id)

    th_a = threading.Thread(target=jump, args=(a, 0.05))
    th_b = threading.Thread(target=jump, args=(b, 0.05))
    th_a.start(); th_b.start()
    th_a.join(5); th_b.join(5)
    assert sorted(done) == ["a", "b"]

    # scale up: a third actor joins and participates
    c = TimeJumpClient(tr, "c")
    done.clear()
    ths = [threading.Thread(target=jump, args=(cl, 0.02)) for cl in (a, b, c)]
    for t in ths: t.start()
    for t in ths: t.join(5)
    assert sorted(done) == ["a", "b", "c"]
    assert tk.stats.registered_peak == 3
    for cl in (a, b, c):
        cl.deregister()
    tk.close()


def test_elastic_worker_group_resize():
    """TP worker-group grows/shrinks between steps without wedging."""
    from repro_torch.serving.workers import WorkerGroup
    tk = Timekeeper(jitter_cooldown=0.0)
    tr = LocalTransport(tk)
    wg = WorkerGroup(tr, 2, name="g")
    t0 = tk.clock.now()
    wg.execute_step(0.05)
    assert tk.clock.now() >= t0 + 0.05 - 1e-6
    wg.resize(4)
    wg.execute_step(0.05)
    assert tk.clock.now() >= t0 + 0.10 - 1e-6
    wg.resize(1)
    wg.execute_step(0.05)
    assert tk.clock.now() >= t0 + 0.15 - 1e-6
    wg.shutdown()
    tk.close()
