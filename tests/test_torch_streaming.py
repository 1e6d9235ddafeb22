"""The million-session streaming path: lazy workloads, sink-fed DES,
audit modes, and the flat-memory guarantee.

Three invariants carry the scale story and are pinned here:

1. **Laziness is invisible** — a lazily-consumed stream produces the exact
   results of materializing it first (DES identity test), arrival
   generators yield the same times their batch ``sample`` draws, and the
   streaming workloads are re-iterable and byte-stable.
2. **Sampling is honest** — ``audit="sampled"`` reproduces full-audit
   headline numbers (counts, percentiles) while dropping per-request
   retention; ``audit="off"`` additionally drops the SLO reservoir.
3. **Memory is flat** — 10× the sessions must cost <= 1.5× the traced
   peak (the tracemalloc regression gate for the whole sink path).
"""

from __future__ import annotations

import gc
import tracemalloc
import types

import numpy as np
import pytest

from repro_torch.core.predictor import StaticPredictor
from repro_torch.des.simulator import DESConfig, DiscreteEventSimulator
from repro_torch.scenario import compare, get_preset, run, scenario_with
from repro_torch.scenario.__main__ import main as scenario_cli
from repro_torch.serving.benchmark import BenchmarkRunner
from repro_torch.workload import (SessionConfig, StreamingSessionWorkload,
                            StreamingWorkload, WorkloadConfig)
from repro_torch.workload.arrival import ARRIVAL_PROCESSES, make_arrival

ARRIVAL_KWARGS = {
    "trace": {"trace": [[5.0, 2.0], [5.0, 6.0], [5.0, 1.0]]},
}


def _tiny(n=40, **over):
    return scenario_with(get_preset("scale_stream"),
                         workload__num_sessions=n, **over)


# ------------------------------------------------------------ arrival lazy

@pytest.mark.parametrize("name", sorted(ARRIVAL_PROCESSES))
def test_iter_times_matches_batch_sample(name):
    """The lazy generator is the batch draw: same rng seed, same times."""
    proc = make_arrival(name, 4.0, **ARRIVAL_KWARGS.get(name, {}))
    n = 600                                        # spans several chunks
    batch = proc.sample(n, np.random.default_rng(21))
    it = proc.iter_times(np.random.default_rng(21), chunk=256)
    lazy = np.array([next(it) for _ in range(n)])
    assert np.array_equal(batch, lazy), (
        f"{name}: iter_times diverges from sample")


# --------------------------------------------------------- lazy workloads

def test_streaming_workload_reiterable_and_chunk_invariant():
    cfg = WorkloadConfig(num_requests=700, qps=8.0, seed=11)
    sw = StreamingWorkload(cfg, chunk=256)
    def fingerprint(w):
        return [(r.arrival_time, tuple(r.prompt_tokens), r.max_new_tokens)
                for r in w]
    a = fingerprint(sw)
    assert len(a) == sw.expected == 700
    assert a == fingerprint(sw)                    # re-iterable
    assert a == fingerprint(StreamingWorkload(cfg, chunk=7))  # chunk-free
    times = [t for t, _, _ in a]
    assert times == sorted(times)


def test_streaming_sessions_shape_pass_and_eviction():
    cfg = SessionConfig(num_sessions=50, qps=20.0, seed=5,
                        turns_mean=2.0, max_turns=3)
    ssw = StreamingSessionWorkload(cfg)
    assert ssw.expected == sum(ssw.session_turns(s) for s in range(50))
    first = list(ssw.initial_stream())
    assert [r.prompt_tokens for r in first] == \
        [r.prompt_tokens for r in ssw.initial_stream()]      # re-iterable
    assert all(r.turn_index == 0 for r in first)

    # drive one session through its turns by hand: follow_up materializes
    # lazily and evicts on the last turn
    multi = next(r for r in first if ssw.session_turns(r.session_id) > 1)
    sid, turn, t = multi.session_id, 0, multi.arrival_time
    while True:
        done = types.SimpleNamespace(session_id=sid, turn_index=turn,
                                     finish_time=t + 0.5)
        nxt = ssw.follow_up(done)
        if nxt is None:
            break
        assert nxt.session_id == sid and nxt.turn_index == turn + 1
        assert nxt.arrival_time > done.finish_time  # think time elapsed
        turn, t = nxt.turn_index, nxt.arrival_time
    assert turn == ssw.session_turns(sid) - 1
    assert sid not in ssw._live                    # evicted when done


# --------------------------------------------------- declared-count errors

def test_benchmark_runner_rejects_bare_generator():
    gen = (r for r in [])
    with pytest.raises(ValueError, match=r"expected=N"):
        BenchmarkRunner(types.SimpleNamespace(), gen)


# ------------------------------------------------------------ DES identity

def _des(record_decisions=True):
    from repro_torch.cluster.router import make_router
    router = make_router("round_robin", 2)
    router.record_decisions = record_decisions
    return DiscreteEventSimulator(
        StaticPredictor(5e-3),
        DESConfig(max_num_seqs=8, max_batched_tokens=512,
                  step_overhead_s=0.0),
        num_replicas=2, router=router)


def test_des_lazy_stream_is_identical_to_materialized():
    """Feeding the DES lazily must replay the eager event order exactly."""
    sw = StreamingWorkload(WorkloadConfig(num_requests=120, qps=40.0,
                                          seed=7, output_len_mean=8.0,
                                          max_output_len=16))
    eager = _des().run(sorted(sw, key=lambda r: r.arrival_time))
    lazy = _des().run(sw)
    assert len(eager) == len(lazy) == 120
    for a, b in zip(eager, lazy):
        assert (a.arrival_time, a.first_token_time, a.finish_time,
                a.replica) == \
               (b.arrival_time, b.first_token_time, b.finish_time, b.replica)


def test_des_sink_mode_retains_nothing():
    sw = StreamingWorkload(WorkloadConfig(num_requests=150, qps=40.0,
                                          seed=7, output_len_mean=8.0,
                                          max_output_len=16))
    seen = []
    out = _des().run(sw, sink=seen.append)
    assert out == []                               # nothing retained
    assert len(seen) == 150
    assert all(s.finish_time is not None for s in seen)


def test_des_decreasing_stream_rejected():
    bad = StreamingWorkload(WorkloadConfig(num_requests=3, qps=4.0, seed=1))
    reqs = list(bad)
    reqs[2].arrival_time = 0.0                     # violate monotonicity
    stream = iter(reqs)
    with pytest.raises(ValueError, match="non-decreasing"):
        _des().run(stream)


# ------------------------------------------------------------- audit modes

def test_audit_sampled_matches_full_on_thread():
    full = run(_tiny(), backend="thread", audit="full")
    sam = run(_tiny(), backend="thread", audit="sampled")
    assert (full.audit, sam.audit) == ("full", "sampled")
    assert sam.num_requests == full.num_requests
    assert sam.num_sessions == full.num_sessions
    for metric in ("ttft", "tpot", "e2e"):
        a, b = getattr(full, metric), getattr(sam, metric)
        assert a.count == b.count
        assert a.p50 == pytest.approx(b.p50, abs=1e-9)
        assert a.p99 == pytest.approx(b.p99, abs=1e-9)
    # sampled drops retention but keeps counter-backed accounting
    assert sam.latencies == {} and not sam.placements
    assert sam.num_slo_samples == sam.num_requests
    assert sam.slo_attainment() == pytest.approx(full.slo_attainment())

    off = run(_tiny(), backend="des", audit="off")
    assert off.slo_samples == [] and off.num_requests == full.num_requests


def test_streaming_thread_des_parity():
    cres = compare(_tiny(), backends=("thread", "des"))
    assert cres.to_row()["max_err_steps"] <= 1.0


# ------------------------------------------------------------- flat memory

def test_streaming_memory_flat_10x_requests():
    """10× the requests must cost <= 1.5× the traced allocation peak.

    Uses tight accumulator bounds (small reservoir / exact_cap) so every
    O(1) structure saturates well below the small run's size — past that
    point the whole replay path (lazy workload → DES → sink → sketches)
    must hold nothing per-request."""
    from repro_torch.metrics import StreamingMetrics

    def peak(n):
        sw = StreamingWorkload(WorkloadConfig(
            num_requests=n, qps=40.0, seed=7,
            output_len_mean=8.0, max_output_len=16))
        # coarse eps: the GK summary is O(1/eps · log(eps·n)), so a tight
        # eps at tiny n measures the sketch's log growth, not retention
        m = StreamingMetrics(slo_reservoir=256, eps=0.05, exact_cap=128)
        gc.collect()
        tracemalloc.start()
        # record_decisions off, as the runner's sampled path sets it: the
        # routing log is per-request state
        _des(record_decisions=False).run(sw, sink=m.observe)
        _, pk = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        m.finalize()
        assert m.count == n
        return pk
    peak(1_500)                                    # warm caches off-measure
    small, big = peak(1_500), peak(15_000)
    assert big <= 1.5 * small, (
        f"streaming DES peak grew {big / small:.2f}x for 10x requests "
        f"({small} -> {big} bytes): something retains per-request state")


# --------------------------------------------------------------------- CLI

def test_cli_run_streaming_sampled(capsys):
    rc = scenario_cli(["run", "scale_stream", "--sessions", "30",
                       "--backend", "des", "--audit", "sampled"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "scale_stream" in out
