"""Property tests for chaos fault injection: determinism + conservation.

Random fault schedules (crashes with either policy, with and without
recovery, stragglers) over a small deterministic scenario must satisfy two
invariants on every backend:

- **Determinism**: the same seed and schedule produce a byte-identical
  *semantic* result — fault log, requeue/fail outcomes, routing decisions,
  per-request latencies, billing.  (Wall-clock measurement fields —
  ``wall_seconds``, Timekeeper contention counters — are excluded: they
  measure the host, not the scenario.)
- **Conservation**: ``completed + failed == submitted`` — a fault may
  delay or fail a request but can never lose or duplicate one.

Fault times are drawn as continuous floats, so they land off the step and
arrival grids with probability one — the documented determinism contract
(a fault coinciding exactly with a step completion is ordered by event
sequence in the DES but by thread arrival in the emulator; see
``repro.cluster.faults``).

Uses the in-repo ``_hypothesis_compat`` shim when hypothesis isn't
installed: fixed pseudo-random examples, deterministic across runs.
"""

import dataclasses
import pickle

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # optional dev dependency
    from _hypothesis_compat import given, settings, st

from repro_torch.cluster.faults import FaultSpec
from repro_torch.scenario import get_preset, run, scenario_with


def _base():
    """3 untiered replicas, 10 uniformly spaced requests, no faults —
    the canvas every drawn schedule is painted onto."""
    s = scenario_with(get_preset("crash_recovery"),
                      **{"pool.replicas": 3})
    return dataclasses.replace(s, name="chaos_property", faults=())


def _faults_from(draws):
    faults = []
    for kind, t, replica, on_crash, recover in draws:
        if kind == "crash":
            faults.append(FaultSpec(
                kind="crash", time_s=t, replica=replica, on_crash=on_crash,
                recover=recover, respawn_delay_s=0.25))
        else:
            faults.append(FaultSpec(
                kind="straggler", time_s=t, replica=replica,
                slowdown=2.5, duration_s=0.4))
    return tuple(faults)


fault_draw = st.tuples(
    st.sampled_from(["crash", "straggler"]),
    st.floats(min_value=0.2, max_value=2.0),    # off-grid w.p. 1
    st.integers(min_value=0, max_value=2),
    st.sampled_from(["requeue", "fail"]),
    st.booleans())
schedules = st.lists(fault_draw, min_size=0, max_size=4)


def _semantic(res):
    """The scenario-determined projection of a ScenarioResult (everything
    except host-measurement fields)."""
    return (res.num_requests, res.requests_requeued, res.requests_failed,
            tuple(res.faults_injected), tuple(res.recovery_times),
            tuple(res.routing_decisions), tuple(res.scaleups),
            tuple(res.drained), res.makespan_virtual,
            res.replica_seconds, res.cost_dollars,
            tuple(sorted(res.latencies.items())),
            tuple(res.slo_samples))


@pytest.mark.xfail(strict=False, reason=(
    "T2 (ROADMAP, faults of the reference's tests): two crash faults at one "
    "instant on one replica, one requeuing and one not, are ordered by thread "
    "arrival on the thread backend, so some draws differ between two runs in "
    "the reference too"))
@settings(max_examples=8, deadline=None)
@given(schedules)
def test_same_seed_is_byte_identical_and_conserving(draws):
    scenario = dataclasses.replace(_base(), faults=_faults_from(draws))
    n = scenario.workload.num_requests
    a = run(scenario, backend="thread", timeout=120)
    b = run(scenario, backend="thread", timeout=120)
    assert pickle.dumps(_semantic(a)) == pickle.dumps(_semantic(b)), \
        "same seed + same fault schedule must replay byte-identically"
    d = run(scenario, backend="des", timeout=120)
    for res in (a, b, d):
        assert res.num_requests + res.requests_failed == n, (
            f"{res.backend}: {res.num_requests} completed + "
            f"{res.requests_failed} failed != {n} submitted")
        # a fail-policy casualty is final: never also completed
        assert len(res.latencies) == res.num_requests


@settings(max_examples=6, deadline=None)
@given(schedules)
def test_des_replay_is_byte_identical(draws):
    """The DES leg of the same property: two simulator runs of one random
    schedule agree exactly (heap ordering is seeded, never wall-coupled)."""
    scenario = dataclasses.replace(_base(), faults=_faults_from(draws))
    a = run(scenario, backend="des", timeout=120)
    b = run(scenario, backend="des", timeout=120)
    assert pickle.dumps(_semantic(a)) == pickle.dumps(_semantic(b))
