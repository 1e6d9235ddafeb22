"""The port's workload package (``repro_torch.workload``), with the
reference's tests (``tests/test_workload.py``) held against the port's copy.
Workload subsystem tests: arrival processes, the first-gap regression,
byte-stability of the refactor, and session (multi-turn) synthesis."""

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                              # optional dev dependency
    from _hypothesis_compat import given, settings, st

from repro_torch.workload import (ARRIVAL_PROCESSES, GammaArrivals, OnOffArrivals,
                            PoissonArrivals, RateTraceArrivals, SessionConfig,
                            SessionWorkload, WorkloadConfig, make_arrival,
                            synthesize)
from repro_torch.workload.session import _DUMMY

import torch

torch.set_num_threads(2)    # the suite runs in several workers at once


# =========================================================================
# arrival processes
# =========================================================================

def test_registry_and_make():
    assert set(ARRIVAL_PROCESSES) == {"uniform", "poisson", "gamma", "onoff",
                                      "trace"}
    assert isinstance(make_arrival("gamma", 2.0, cv2=8.0), GammaArrivals)
    with pytest.raises(ValueError):
        make_arrival("nope", 2.0)


@pytest.mark.parametrize("proc", [
    make_arrival("uniform", 5.0),
    PoissonArrivals(5.0),
    GammaArrivals(5.0, cv2=8.0),
    OnOffArrivals(5.0, period_s=4.0, duty=0.25),
    RateTraceArrivals([(5.0, 2.0), (5.0, 8.0)], scale_to_qps=5.0),
])
def test_arrival_streams_sorted_and_rate_correct(proc):
    ts = proc.sample(2000, np.random.default_rng(11))
    if proc.name != "trace":            # trace replay keeps absolute phase
        assert ts[0] == 0.0
    assert (np.diff(ts) >= 0).all()
    empirical = (len(ts) - 1) / (ts[-1] - ts[0])
    assert empirical == pytest.approx(proc.mean_rate(), rel=0.15), \
        f"{proc.name}: rate {empirical:.2f} vs declared {proc.mean_rate()}"


def test_gamma_burstiness_overdispersion():
    """cv2 controls inter-arrival dispersion: the bursty stream's gap CV^2
    must be far above Poisson's ~1 at the same mean rate."""
    rng = np.random.default_rng(3)
    gaps_p = np.diff(PoissonArrivals(4.0).sample(4000, rng))
    gaps_g = np.diff(GammaArrivals(4.0, cv2=10.0).sample(
        4000, np.random.default_rng(3)))
    cv2 = lambda g: g.var() / g.mean() ** 2
    assert 0.7 < cv2(gaps_p) < 1.4
    assert cv2(gaps_g) > 4.0
    assert gaps_p.mean() == pytest.approx(gaps_g.mean(), rel=0.25)


def test_onoff_has_silent_phases():
    ts = OnOffArrivals(10.0, period_s=2.0, duty=0.25).sample(
        400, np.random.default_rng(5))
    gaps = np.diff(ts)
    # OFF phases appear as gaps >= the 1.5s silence; ON-phase gaps are small
    assert (gaps >= 1.4).sum() >= 3, "no off-phase silences in the stream"
    assert np.median(gaps) < 0.2, "on-phase arrivals should be dense"


def test_rate_trace_follows_diurnal_shape():
    """Arrivals must concentrate in the high-rate segments of the trace."""
    trace = [(10.0, 1.0), (10.0, 9.0)]          # quiet phase, busy phase
    ts = RateTraceArrivals(trace).sample(1000, np.random.default_rng(9))
    period = ts % 20.0
    busy = ((period >= 10.0) & (period < 20.0)).mean()
    assert busy > 0.75, f"only {busy:.0%} of arrivals in the busy phase"


# =========================================================================
# first-gap regression (satellite fix) + byte stability
# =========================================================================

def test_first_gap_not_clobbered():
    """The historical bug set arrivals[0]=0 on the cumulative sum, silently
    merging gaps[0] into the second arrival's offset and biasing effective
    QPS for small n.  The stream must instead be *shifted*: request 0 at
    t=0 and every inter-arrival gap equal to the generator's draws."""
    cfg = WorkloadConfig(num_requests=50, qps=4.0, seed=123)
    reqs = synthesize(cfg)
    arrivals = np.array([r.arrival_time for r in reqs])
    # reference: the raw exponential draws of the same seeded generator
    rng = np.random.default_rng(123)
    gaps = rng.exponential(1.0 / 4.0, size=50)
    assert arrivals[0] == 0.0
    np.testing.assert_allclose(np.diff(arrivals), gaps[1:], rtol=0, atol=1e-12)
    # the old behaviour inflated the first gap to gaps[0]+gaps[1]
    assert arrivals[1] == pytest.approx(gaps[1], abs=1e-12)


def test_synthesize_byte_stable_lengths_and_tokens():
    """The package refactor + arrival fix must not perturb the non-arrival
    draws: prompt/output lengths and token bodies stay byte-identical to the
    historical single-process implementation (same seeded draw order)."""
    cfg = WorkloadConfig(num_requests=20, qps=3.0, seed=42,
                         shared_prefix_len=8, prompt_len_mean=50,
                         output_len_mean=20)
    reqs = synthesize(cfg)

    # independent reference replay of the historical draw order
    rng = np.random.default_rng(42)
    _ = rng.exponential(1.0 / 3.0, size=20)        # arrival gaps
    def lens(mean, sigma, lo, hi):
        mu = np.log(mean) - sigma**2 / 2
        return np.clip(rng.lognormal(mu, sigma, size=20).astype(int), lo, hi)
    plens = lens(50, 0.6, cfg.min_prompt_len, cfg.max_prompt_len)
    olens = lens(20, 0.6, cfg.min_output_len, cfg.max_output_len)
    shared = rng.integers(1, cfg.vocab_size, size=8).tolist()
    for i, r in enumerate(reqs):
        body_len = max(int(plens[i]) - 8, 1)
        body = rng.integers(1, cfg.vocab_size, size=body_len).tolist()
        assert list(r.prompt_tokens) == shared + body
        assert r.max_new_tokens == int(olens[i])


def test_synthesize_deterministic_across_calls():
    a = synthesize(WorkloadConfig(num_requests=12, qps=5.0, seed=7))
    b = synthesize(WorkloadConfig(num_requests=12, qps=5.0, seed=7))
    for x, y in zip(a, b):
        assert list(x.prompt_tokens) == list(y.prompt_tokens)
        assert x.arrival_time == y.arrival_time
        assert x.max_new_tokens == y.max_new_tokens


def test_bursty_workload_through_config():
    reqs = synthesize(WorkloadConfig(num_requests=200, qps=4.0, seed=1,
                                     arrival="gamma",
                                     arrival_kwargs={"cv2": 9.0}))
    gaps = np.diff([r.arrival_time for r in reqs])
    assert gaps.var() / gaps.mean() ** 2 > 3.0


# =========================================================================
# sessions
# =========================================================================

def _session_cfg(**kw):
    base = dict(num_sessions=6, qps=2.0, turns_mean=3.0, max_turns=5,
                think_time_mean=1.0, prompt_len_mean=40, followup_len_mean=12,
                output_len_mean=8, max_output_len=16, seed=17)
    base.update(kw)
    return SessionConfig(**base)


def test_session_prompts_chain_prior_turns():
    """Turn k+1's prompt must literally extend turn k's prompt + its dummy
    outputs — that token-level chaining is what produces real radix-cache
    reuse (not a synthetic shared prefix)."""
    sw = SessionWorkload(_session_cfg())
    multi = [s for s in sw.sessions if s.num_turns >= 2]
    assert multi, "turns_mean=3 must yield multi-turn sessions"
    for s in multi:
        for k in range(1, s.num_turns):
            prev, cur = s.turns[k - 1], s.turns[k]
            expected_head = (list(prev.prompt_tokens)
                             + [_DUMMY] * prev.max_new_tokens)
            assert list(cur.prompt_tokens[:len(expected_head)]) == expected_head
            assert len(cur.prompt_tokens) > len(expected_head)
            assert cur.think_time > 0.0
        assert s.turns[0].think_time == 0.0


def test_session_follow_up_rule():
    sw = SessionWorkload(_session_cfg())
    init = sw.initial_requests()
    assert len(init) == sw.num_sessions
    assert sum(s.num_turns for s in sw.sessions) == sw.total_requests
    first = next(r for r in init
                 if sw.sessions[r.session_id].num_turns >= 2)
    first.finish_time = first.arrival_time + 2.5
    fu = sw.follow_up(first)
    assert fu.session_id == first.session_id and fu.turn_index == 1
    spec = sw.sessions[first.session_id].turns[1]
    assert fu.arrival_time == pytest.approx(
        first.finish_time + spec.think_time)
    # last turn yields no follow-up
    last_turn = sw.sessions[first.session_id].num_turns - 1
    tail = sw._request(sw.sessions[first.session_id], last_turn, 0.0)
    tail.finish_time = 1.0
    assert sw.follow_up(tail) is None
    # open-loop requests (no session identity) never re-inject
    class _NoSession:
        session_id = None
    assert sw.follow_up(_NoSession()) is None


def test_session_workload_reusable_across_runs():
    """initial_requests/follow_up must build fresh Request objects so one
    workload can drive an emulator run and a DES run back to back."""
    sw = SessionWorkload(_session_cfg())
    a, b = sw.initial_requests(), sw.initial_requests()
    assert [list(r.prompt_tokens) for r in a] == \
           [list(r.prompt_tokens) for r in b]
    assert all(x is not y for x, y in zip(a, b))
    a[0].num_prefilled = 999            # mutating one run's objects...
    assert sw.initial_requests()[0].num_prefilled == 0   # ...leaks nowhere


def test_session_context_cap_ends_sessions_early():
    sw = SessionWorkload(_session_cfg(max_context_len=64, max_turns=8,
                                      output_len_mean=30, max_output_len=40))
    for s in sw.sessions:
        for t in s.turns:
            assert len(t.prompt_tokens) <= 64


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**16))
def test_session_synthesis_deterministic(seed):
    a = SessionWorkload(_session_cfg(seed=seed))
    b = SessionWorkload(_session_cfg(seed=seed))
    assert a.total_requests == b.total_requests
    for sa, sb in zip(a.sessions, b.sessions):
        assert sa.arrival_time == sb.arrival_time
        for ta, tb in zip(sa.turns, sb.turns):
            assert ta.prompt_tokens == tb.prompt_tokens
            assert ta.max_new_tokens == tb.max_new_tokens
            assert ta.think_time == tb.think_time


# =========================================================================
# compat shim removal
# =========================================================================

def test_serving_workload_shim_is_gone():
    """The deprecated ``repro_torch.serving.workload`` shim was removed after its
    deprecation cycle; the canonical surface lives in ``repro_torch.workload``."""
    import importlib

    with pytest.raises(ModuleNotFoundError):
        importlib.import_module("repro_torch.serving.workload")


@pytest.mark.parametrize("arrival", ["poisson", "gamma"])
def test_synthesize_equals_the_reference(arrival):
    """The same config gives the reference's stream: arrival times, prompts
    and output lengths."""
    from repro.workload import WorkloadConfig as RefConfig
    from repro.workload import synthesize as ref_synthesize

    kw = dict(num_requests=64, qps=3.0, prompt_len_mean=256, output_len_mean=32,
              max_prompt_len=1024, max_output_len=64, vocab_size=128256, seed=2,
              arrival=arrival)
    port, ref = synthesize(WorkloadConfig(**kw)), ref_synthesize(RefConfig(**kw))
    assert [(r.arrival_time, r.prompt_tokens, r.max_new_tokens) for r in port] == \
        [(r.arrival_time, r.prompt_tokens, r.max_new_tokens) for r in ref]
