"""Batched clock coordination: run merging, park coalescing, write
combining, and the parallel sweep/compare fan-out.

The fast path must be *invisible* semantically: a run of consecutive jump
targets submitted in one request resolves to exactly the trajectory the
legacy one-target-per-request protocol produced (minimum-target rule per
merged step, no actor ever jumped past a target it has not requested).
These tests pin that equivalence at three levels — Timekeeper unit tests,
a property test over random run shapes, and same-seed end-to-end scenario
runs with ``REPRO_CLOCK_BATCHING`` toggled on both cluster backends.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # optional dev dependency
    from _hypothesis_compat import given, settings, st

from repro_torch.core.client import (LocalTransport, TimeJumpClient,
                               batching_enabled)
from repro_torch.core.clock import ManualWallSource, VirtualClock
from repro_torch.core.timekeeper import Timekeeper
from repro_torch.core.transport import FrameWriter, pack_frame
from repro_torch.scenario import (compare, derive_cell_seed, get_preset, run,
                            run_sweep, scenario_with, Sweep)


def _manual_tk() -> Timekeeper:
    return Timekeeper(clock=VirtualClock(ManualWallSource()),
                      jitter_cooldown=0.0)


# =========================================================================
# Timekeeper: merged rounds
# =========================================================================

def test_jump_run_merges_aligned_rounds():
    tk = _manual_tk()
    for a in ("a", "b"):
        tk.register_actor(a)
    targets = [0.001 * (j + 1) for j in range(10)]
    tk.request_jump_run("a", targets)
    assert tk.clock.now() == 0.0          # b has no queue yet: no advance
    tk.request_jump_run("b", targets)
    assert tk.clock.now() == pytest.approx(0.010)
    assert tk.stats.rounds == 10          # one logical round per merged step
    assert tk.stats.merged_rounds == 9    # resolved in a single burst
    assert tk.stats.batched_requests == 2
    assert tk.stats.requests == 2
    d = tk.stats.as_dict()
    for k in ("batched_requests", "merged_rounds", "coalesced_parks"):
        assert k in d
    tk.close()


def test_burst_stops_at_short_run():
    """A burst cannot advance past the end of the shortest queue — the
    no-rollback causality rule: once 'a' has consumed its only target, the
    barrier stalls until 'a' asks for more, leaving 'b' parked mid-run."""
    tk = _manual_tk()
    for a in ("a", "b"):
        tk.register_actor(a)
    tk.request_jump_run("a", [0.005])
    tk.request_jump_run("b", [0.002, 0.004, 0.006, 0.008])
    assert tk.clock.now() == pytest.approx(0.005)     # not 0.008
    tk.request_jump_run("a", [0.020])
    assert tk.clock.now() == pytest.approx(0.008)     # b's leftovers drain
    tk.close()


def test_request_jump_is_the_single_target_case():
    tk = _manual_tk()
    tk.register_actor("solo")
    tk.request_jump("solo", 0.5)
    assert tk.clock.now() == pytest.approx(0.5)
    assert tk.stats.batched_requests == 0    # singles are not "batched"
    assert tk.stats.requests == 1
    tk.close()


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 5), st.integers(1, 5),
                          st.integers(1, 5)),
                min_size=1, max_size=6))
def test_merged_rounds_never_pass_any_actors_minimum(rounds):
    """Property: at every point, virtual time ≤ the smallest
    maximum-target-ever-submitted across actors — i.e. no merged burst ever
    advances the clock past a target some actor has not yet requested."""
    tk = _manual_tk()
    actors = ("a", "b", "c")
    for a in actors:
        tk.register_actor(a)
    max_submitted = {a: 0.0 for a in actors}
    try:
        for lens in rounds:
            for a, k in zip(actors, lens):
                base = tk.clock.now()
                targets = [base + 0.001 * (j + 1) for j in range(k)]
                max_submitted[a] = max(max_submitted[a], targets[-1])
                tk.request_jump_run(a, targets)
                assert tk.clock.now() <= min(max_submitted.values()) + 1e-9
    finally:
        tk.close()


# =========================================================================
# Timekeeper: park/unpark coalescing
# =========================================================================

def test_park_after_coalesces_into_the_barrier():
    tk = _manual_tk()
    for a in ("a", "b"):
        tk.register_actor(a)
    tk.request_jump_run("a", [0.002, 0.004], park_after=True)
    tk.request_jump_run("b", [0.010])
    # burst: a consumes both targets, parks in the same resolution, and b
    # then advances alone to 0.010 — no separate park RPC round trip.
    assert tk.clock.now() == pytest.approx(0.010)
    assert tk.num_parked == 1
    assert tk.stats.parks == 1
    assert tk.stats.coalesced_parks == 1
    # unpark folded into the next run request
    tk.park_actor("b")
    tk.request_jump_run("a", [0.020], unpark=True)
    assert tk.clock.now() == pytest.approx(0.020)
    assert tk.stats.unparks == 1
    assert tk.stats.coalesced_parks == 2
    tk.close()


def test_client_jump_run_with_park_after():
    tk = _manual_tk()
    tr = LocalTransport(tk)
    a = TimeJumpClient(tr, "a", batched=True)
    b = TimeJumpClient(tr, "b", batched=True)

    t = threading.Thread(
        target=lambda: a.jump_run([0.002, 0.004], park_after=True))
    t.start()
    b.jump_run([0.010])
    t.join(timeout=30)
    assert not t.is_alive()
    assert tk.clock.now() == pytest.approx(0.010)
    assert tk.num_parked == 1
    assert tk.stats.coalesced_parks == 1

    b.park()
    a.jump_run([0.020])          # implicit unpark folded into the request
    assert tk.clock.now() == pytest.approx(0.020)
    assert tk.stats.coalesced_parks == 2
    a.deregister()
    b.unpark()
    b.deregister()
    tk.close()


def test_batched_client_trajectory_matches_unbatched():
    """Two same-shape schedules, one driven through jump_run chunks and one
    through single time_jump calls, land on identical virtual timestamps."""
    final = {}
    for batched in (False, True):
        tk = _manual_tk()
        tr = LocalTransport(tk)
        clients = [TimeJumpClient(tr, f"w{i}", batched=batched)
                   for i in range(3)]

        def drive(c):
            if batched:
                for _ in range(4):
                    t0 = c.now()
                    c.jump_run([t0 + 0.001 * (j + 1) for j in range(5)])
            else:
                for _ in range(20):
                    c.time_jump(0.001)
            c.deregister()

        threads = [threading.Thread(target=drive, args=(c,))
                   for c in clients]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        final[batched] = tk.clock.now()
        tk.close()
    assert final[True] == pytest.approx(final[False])
    assert final[True] == pytest.approx(0.020)


def test_batching_enabled_env_parsing(monkeypatch):
    monkeypatch.delenv("REPRO_CLOCK_BATCHING", raising=False)
    assert batching_enabled() is True
    for off in ("0", "off", "FALSE", "no"):
        monkeypatch.setenv("REPRO_CLOCK_BATCHING", off)
        assert batching_enabled() is False
    monkeypatch.setenv("REPRO_CLOCK_BATCHING", "1")
    assert batching_enabled() is True


# =========================================================================
# FrameWriter: the socket write combiner
# =========================================================================

def _recv_frames(sock, n):
    frames, buf = [], b""
    while len(frames) < n:
        chunk = sock.recv(65536)
        assert chunk, "peer closed early"
        buf += chunk
        while len(buf) >= 4:
            ln = struct.unpack(">I", buf[:4])[0]
            if len(buf) < 4 + ln:
                break
            frames.append(buf[4:4 + ln])
            buf = buf[4 + ln:]
    assert not buf
    return frames


def test_frame_writer_preserves_frames_and_batches():
    a, b = socket.socketpair()
    try:
        w = FrameWriter(a)
        payloads = [f"frame-{i}".encode() for i in range(64)]
        # one multi-frame send: must coalesce into few flushes
        w.send(*[pack_frame(p) for p in payloads[:32]])
        # concurrent senders: every frame still arrives intact, in order
        # within each sender
        def sender(lo, hi):
            for p in payloads[lo:hi]:
                w.send(pack_frame(p))
        threads = [threading.Thread(target=sender, args=(32 + 16 * i,
                                                         48 + 16 * i))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        got = _recv_frames(b, len(payloads))
        assert sorted(got) == sorted(payloads)
        assert w.frames == len(payloads)
        assert w.flushes <= w.frames          # combining never inflates
        assert w.flushes >= 1
    finally:
        a.close()
        b.close()


# =========================================================================
# End-to-end: same seed, batching on vs off
# =========================================================================

def _small_parity_scenario(replicas=2, n=8):
    return scenario_with(get_preset("distributed_parity"),
                         name="batch_toggle",
                         **{"pool.replicas": replicas,
                            "workload.num_requests": n})


def test_thread_backend_byte_identical_batching_toggle(monkeypatch):
    """Thread backend is deterministic under ManualWallSource: the batched
    fast path must reproduce the legacy trajectory *exactly* — same routing
    decisions, bit-equal per-request latencies."""
    scenario = _small_parity_scenario()
    results = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("REPRO_CLOCK_BATCHING", flag)
        results[flag] = run(scenario, backend="thread", timeout=120)
    a, b = results["0"], results["1"]
    assert a.routing_decisions == b.routing_decisions
    assert a.latencies == b.latencies          # bit-equal, not approx
    assert a.makespan_virtual == b.makespan_virtual


def test_process_backend_parity_batching_toggle(monkeypatch):
    """Process backend carries wall-rate absorption (Eq. 1), so the bar is
    the repo's distributed parity bar: identical decisions, per-request
    TTFT/TPOT within one slow step across the batching toggle."""
    scenario = _small_parity_scenario()
    step = scenario.pool.step_time_s
    results = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("REPRO_CLOCK_BATCHING", flag)
        results[flag] = run(scenario, backend="process", timeout=300)
    a, b = results["0"], results["1"]
    assert a.routing_decisions == b.routing_decisions
    assert set(a.latencies) == set(b.latencies)
    for k, (ttft_a, tpot_a, _) in a.latencies.items():
        ttft_b, tpot_b, _ = b.latencies[k]
        assert abs(ttft_a - ttft_b) <= step
        assert abs(tpot_a - tpot_b) <= step


# =========================================================================
# Parallel sweeps and compare --jobs
# =========================================================================

def test_derive_cell_seed_is_stable_and_name_sensitive():
    assert derive_cell_seed(7, "cell[a=1]") == derive_cell_seed(7, "cell[a=1]")
    assert derive_cell_seed(7, "cell[a=1]") != derive_cell_seed(7, "cell[a=2]")
    assert derive_cell_seed(7, "x") != derive_cell_seed(8, "x")
    s = derive_cell_seed(2**40, "big")
    assert 0 <= s < 2**31 - 1


def test_run_sweep_parallel_matches_serial():
    sweep = Sweep(_small_parity_scenario(n=6),
                  {"workload.qps": [2.0, 4.0], "pool.replicas": [1, 2]})
    serial = run_sweep(sweep, backend="des", jobs=1)
    fanned = run_sweep(sweep, backend="des", jobs=2)
    assert len(serial) == len(fanned) == 4
    # ordered, deterministic, jobs-invariant
    assert [r.scenario for r in serial] == [r.scenario for r in fanned]
    wall_keys = {"wall_s", "speedup_x"}    # wall-clock noise, not semantics
    for a, b in zip(serial, fanned):
        ra = {k: v for k, v in a.to_row().items() if k not in wall_keys}
        rb = {k: v for k, v in b.to_row().items() if k not in wall_keys}
        assert ra == rb
        assert a.routing_decisions == b.routing_decisions
        assert a.latencies == b.latencies


def test_run_sweep_derive_seeds():
    sweep = Sweep(_small_parity_scenario(n=6), {"workload.qps": [2.0, 4.0]})
    res = run_sweep(sweep, backend="des", jobs=1, derive_seeds=True)
    seeds = [r.seed for r in res]
    assert seeds[0] != seeds[1]          # per-cell, name-derived
    again = run_sweep(sweep, backend="des", jobs=2, derive_seeds=True)
    assert [r.seed for r in again] == seeds


def test_compare_all_backends_with_parallel_jobs():
    """The regression gate from the issue: compare() across all three
    backends with jobs > 1 must still clear the parity bar."""
    scenario = _small_parity_scenario()
    cres = compare(scenario, backends=("thread", "process", "des"),
                   timeout=300, jobs=2)
    assert cres.decisions_equal
    assert cres.max_err_steps <= 1.0


def test_scenario_result_carries_timekeeper_stats():
    res = run(_small_parity_scenario(n=4), backend="thread", timeout=120)
    assert res.num_steps > 0
    assert isinstance(res.timekeeper, dict)
    for k in ("rounds", "requests", "batched_requests", "merged_rounds",
              "coalesced_parks"):
        assert k in res.timekeeper
    # artifact plumbing: counters survive JSON round-trips for bench rows
    json.dumps(res.timekeeper)
