"""Declarative scenario API: serialization strictness, sweep expansion, the
uniform run() surface, and cross-backend parity through compare().

Serialization is the load-bearing contract (scenario files are the new
config surface): round trips must be exact and *byte-stable*, and invalid
input must fail with the dotted path of the offending entry — a typo'd
sweep file pointing at "autoscale.polcy" should say so.

The compare() tests cover every backend pair on a small mixed-tier
autoscaling scenario (the ``elastic_tier_parity`` preset): one spec, three
execution engines, ≤ 1-slow-step agreement — the repo's parity bar as a
single API call.  Process-backed pairs spawn real child processes and carry
timeout markers.
"""

import json

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # optional dev dependency
    from _hypothesis_compat import given, settings, st

from repro_torch.scenario import (AutoscaleSpec, ParityError, PoolSpec, RoutingSpec,
                            Scenario, SLOSpec, SpecError, Sweep, WorkloadSpec,
                            compare, get_preset, list_presets, run,
                            scenario_with)

MIXED_TIER_AUTOSCALE = "elastic_tier_parity"   # the backend-pair scenario


def full_scenario() -> Scenario:
    """A scenario exercising every spec field family at once."""
    return Scenario(
        name="full",
        workload=WorkloadSpec(
            kind="sessions", qps=3.0, arrival="gamma",
            arrival_kwargs={"cv2": 8.0}, num_sessions=4, turns_mean=2.0,
            max_turns=3, think_time_mean=0.4, prompt_len_mean=30.0,
            followup_len_mean=10.0, output_len_mean=6.0, max_output_len=10),
        pool=PoolSpec(
            model="qwen2_5_3b", reduced=True, replicas=2,
            tiers=("h100", "l4"), max_num_seqs=4, max_batched_tokens=64,
            block_size=4, num_blocks=2048, enable_prefix_caching=False,
            tier_step_time_s={"h100": 5e-3, "l4": 12.5e-3}),
        routing=RoutingSpec(policy="least_outstanding_tokens"),
        autoscale=AutoscaleSpec(
            policy="schedule", schedule=((0.5, 1), (2.0, -1)),
            interval_s=0.1, provision_delay_s=0.2, min_replicas=1,
            max_replicas=3, tiers=("h100", "l4"),
            provision_delay_by_tier={"l4": 0.1}),
        slo=SLOSpec(ttft_s=0.5, tpot_s=0.1),
        seed=7)


# =========================================================================
# serialization: round trips
# =========================================================================

def test_default_scenario_round_trips():
    s = Scenario()
    assert Scenario.from_dict(s.to_dict()) == s
    assert Scenario.from_json(s.to_json()) == s


def test_full_scenario_round_trips():
    s = full_scenario()
    assert Scenario.from_dict(s.to_dict()) == s
    assert Scenario.from_json(s.to_json()) == s


def test_round_trip_is_byte_stable():
    """to_json(from_json(text)) == text: the serialized form is a fixed
    point, so spec files diff cleanly across tooling round trips."""
    for s in (Scenario(), full_scenario(), get_preset("hetero_mix")):
        text = s.to_json()
        assert Scenario.from_json(text).to_json() == text


def test_every_preset_round_trips():
    for name in list_presets():
        s = get_preset(name)
        assert Scenario.from_dict(s.to_dict()) == s, name
        assert Scenario.from_json(s.to_json()).to_json() == s.to_json(), name


def test_tuples_come_back_as_tuples():
    s = full_scenario()
    d = s.to_dict()
    assert isinstance(d["pool"]["tiers"], list)          # JSON form
    back = Scenario.from_dict(d)
    assert isinstance(back.pool.tiers, tuple)            # spec form
    assert isinstance(back.autoscale.schedule[0], tuple)


def test_save_load_file(tmp_path):
    s = full_scenario()
    path = tmp_path / "scenario.json"
    s.save(path)
    assert Scenario.load(path) == s


def test_empty_dict_is_a_valid_scenario():
    assert Scenario.from_dict({}) == Scenario()


# =========================================================================
# serialization: strictness (path-carrying errors)
# =========================================================================

@pytest.mark.parametrize("payload,needle", [
    ({"nope": 1}, "nope"),
    ({"pool": {"replicaz": 2}}, "pool.replicaz"),
    ({"workload": {"kind": "closed"}}, "workload.kind"),
    ({"workload": {"arrival": "psn"}}, "workload.arrival"),
    ({"workload": {"arrival": "uniform", "arrival_kwargs": {"cv2": 8.0}}},
     "workload.arrival_kwargs"),
    ({"workload": {"qps": "fast"}}, "workload.qps"),
    ({"pool": {"model": "gpt-17"}}, "pool.model"),
    ({"pool": {"replicas": 2, "tiers": ["h100", "warpcore"]}},
     "pool.tiers[1]"),
    ({"pool": {"replicas": True}}, "pool.replicas"),
    ({"routing": {"policy": "warp_drive"}}, "routing.policy"),
    ({"autoscale": {"policy": "psychic"}}, "autoscale.policy"),
    ({"autoscale": {"policy": "queue_depth", "schedule": [[0.1, 1]]}},
     "autoscale.schedule"),
    ({"autoscale": {"policy": "schedule"}}, "autoscale.schedule"),
    ({"autoscale": {"policy": "schedule", "schedule": [[0.1]]}},
     "autoscale.schedule[0]"),
    ({"slo": {"ttft_s": -1.0}}, "slo.ttft_s"),
])
def test_invalid_specs_raise_with_offending_path(payload, needle):
    with pytest.raises(SpecError) as exc:
        Scenario.from_dict(payload)
    assert needle in str(exc.value), \
        f"error {exc.value} does not point at {needle}"


def test_tier_count_must_match_replicas():
    with pytest.raises(SpecError) as exc:
        Scenario.from_dict({"pool": {"replicas": 3,
                                     "tiers": ["h100", "l4"]}})
    assert "pool.tiers" in str(exc.value)


def test_pool_outside_autoscale_bounds_rejected():
    with pytest.raises(SpecError) as exc:
        Scenario.from_dict({
            "pool": {"replicas": 8},
            "autoscale": {"policy": "queue_depth", "max_replicas": 4}})
    assert "pool.replicas" in str(exc.value)


def test_run_rejects_unknown_backend():
    with pytest.raises(SpecError):
        run(Scenario(), backend="quantum")


# =========================================================================
# serialization: randomized property (hypothesis or the local compat shim)
# =========================================================================

@settings(max_examples=30, deadline=None)
@given(
    kind=st.sampled_from(["open", "sessions"]),
    qps=st.floats(min_value=0.5, max_value=40.0),
    count=st.integers(min_value=1, max_value=60),
    arrival=st.sampled_from(["uniform", "poisson", "gamma"]),
    policy=st.sampled_from(["round_robin", "least_outstanding_tokens",
                            "cost_normalized_load", "prefix_affinity"]),
    replicas=st.integers(min_value=1, max_value=5),
    tiered=st.booleans(),
    elastic=st.booleans(),
    slo=st.floats(min_value=0.05, max_value=3.0),
    seed=st.integers(min_value=0, max_value=1 << 20),
)
def test_random_specs_round_trip(kind, qps, count, arrival, policy,
                                 replicas, tiered, elastic, slo, seed):
    s = Scenario(
        name=f"prop-{seed}",
        workload=WorkloadSpec(kind=kind, qps=qps, arrival=arrival,
                              num_requests=count, num_sessions=count),
        pool=PoolSpec(replicas=replicas,
                      tiers=("l4",) if tiered else None,
                      step_time_s=None if tiered else 5e-3,
                      tier_step_time_s={"l4": 5e-3} if tiered else None),
        routing=RoutingSpec(policy=policy),
        autoscale=AutoscaleSpec(policy="queue_depth",
                                kwargs={"target_depth": 4.0},
                                min_replicas=1,
                                max_replicas=max(replicas, 6))
        if elastic else None,
        slo=SLOSpec(ttft_s=slo),
        seed=seed)
    s.validate()
    assert Scenario.from_dict(s.to_dict()) == s
    text = s.to_json()
    assert Scenario.from_json(text) == s
    assert Scenario.from_json(text).to_json() == text
    # the dict form is pure JSON (no tuples/sets sneak through)
    json.dumps(s.to_dict())


# =========================================================================
# scenario_with + Sweep
# =========================================================================

def test_scenario_with_replaces_nested_fields():
    s = Scenario()
    s2 = scenario_with(s, **{"pool.replicas": 4, "workload.qps": 9.0,
                             "routing.policy": "prefix_affinity"})
    assert (s2.pool.replicas, s2.workload.qps, s2.routing.policy) == \
        (4, 9.0, "prefix_affinity")
    assert s.pool.replicas == 2            # original untouched (frozen tree)
    with pytest.raises(SpecError):
        scenario_with(s, **{"pool.replicas": "many"})
    with pytest.raises(SpecError):
        scenario_with(s, **{"autoscale.interval_s": 1.0})  # autoscale=None


def test_sweep_expands_in_product_order_with_cell_names():
    sweep = Sweep(Scenario(name="g"), {"pool.replicas": [1, 2],
                                       "workload.qps": [4.0, 8.0]})
    cells = sweep.expand()
    assert len(sweep) == len(cells) == 4
    assert [(c.pool.replicas, c.workload.qps) for c in cells] == \
        [(1, 4.0), (1, 8.0), (2, 4.0), (2, 8.0)]
    assert cells[0].name == "g[replicas=1,qps=4.0]"
    assert Sweep.from_dict(sweep.to_dict()) == sweep


def test_sweep_rejects_bad_axes():
    with pytest.raises(SpecError):
        Sweep(Scenario(), {"pool.replicas": []})
    with pytest.raises(SpecError):
        Sweep(Scenario(), {"pool.nope": [1]}).expand()
    with pytest.raises(SpecError):
        Sweep(Scenario(), {"routing.policy": ["warp_drive"]}).expand()


# =========================================================================
# run(): the uniform surface (cheap backends only; thread/process runs are
# covered by the compare tests and the benchmark smoke job)
# =========================================================================

def test_des_run_returns_uniform_result():
    res = run(get_preset(MIXED_TIER_AUTOSCALE), backend="des")
    assert res.backend == "des"
    assert res.num_requests == 10
    assert res.replica_tiers == ["h100", "l4", "l4"]
    assert res.tiers_added == ["l4"]
    assert res.ttft.p50 > 0 and res.makespan_virtual > 0
    assert res.cost_dollars > 0
    assert set(res.tier_seconds) == {"h100", "l4"}
    row = res.to_row()
    assert row["scenario"] == MIXED_TIER_AUTOSCALE
    assert row["tiers_added"] == "l4"


def test_same_seed_des_runs_are_identical():
    a = run(get_preset(MIXED_TIER_AUTOSCALE), backend="des")
    b = run(get_preset(MIXED_TIER_AUTOSCALE), backend="des")
    assert a.latencies == b.latencies
    assert a.routing_decisions == b.routing_decisions


def test_des_rejects_pd_pool():
    s = scenario_with(Scenario(), **{"routing.policy": "pd_pool",
                                     "pool.replicas": 2})
    with pytest.raises(SpecError):
        run(s, backend="des")


# =========================================================================
# compare(): one backend pair per test on the mixed-tier autoscaling spec
# =========================================================================

def _check_pair(cres):
    assert cres.completed_equal
    assert cres.decisions_equal
    assert cres.scaleup_tiers_equal and cres.drained_equal
    assert cres.max_err_steps <= 1.0
    rs = list(cres.results.values())
    assert all(r.num_requests == rs[0].num_requests for r in rs)
    assert all(r.replica_tiers == ["h100", "l4", "l4"] for r in rs)


def test_compare_thread_vs_des_mixed_tier_autoscale():
    _check_pair(compare(get_preset(MIXED_TIER_AUTOSCALE),
                        backends=("thread", "des"), timeout=120))


@pytest.mark.timeout(300)
def test_compare_thread_vs_process_mixed_tier_autoscale():
    _check_pair(compare(get_preset(MIXED_TIER_AUTOSCALE),
                        backends=("thread", "process"), timeout=120))


@pytest.mark.timeout(300)
def test_compare_process_vs_des_mixed_tier_autoscale():
    _check_pair(compare(get_preset(MIXED_TIER_AUTOSCALE),
                        backends=("process", "des"), timeout=120))


def test_compare_detects_semantic_divergence():
    """The bar must bite: prefix caching is exactly the Table-1 semantic
    gap the DES cannot model.  A session workload whose follow-up turns
    carry long contexts makes the emulator's cached prefill several chunks
    shorter than the DES re-prefill — more than one slow-step — and
    compare must refuse."""
    s = scenario_with(
        get_preset("distributed_parity"),
        name="semantic_gap",
        **{"workload.kind": "sessions", "workload.num_sessions": 3,
           "workload.qps": 1.0,
           "workload.turns_mean": 3.0, "workload.max_turns": 3,
           "workload.think_time_mean": 0.3,
           "workload.prompt_len_mean": 150.0,
           "workload.max_prompt_len": 300,
           "workload.followup_len_mean": 80.0,
           "pool.replicas": 1,
           "pool.enable_prefix_caching": True})
    with pytest.raises(ParityError):
        compare(s, backends=("thread", "des"), timeout=120)


def test_compare_needs_two_backends():
    with pytest.raises(SpecError):
        compare(get_preset(MIXED_TIER_AUTOSCALE), backends=("thread",))
