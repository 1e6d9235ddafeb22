"""Fleet plane: specs, ingress WRR, adapter affinity, per-tenant metrics,
swap accounting, partitioned counterfactual, and thread-vs-DES parity.

Covers the codec contract for the new nested list-valued fields (SpecError
with *indexed* dotted paths, e.g. ``fleet.tenants[1].slo.ttft_s``) and the
acceptance invariants: per-tenant conservation (completed + failed ==
submitted), fairness bounds, and the multi-LoRA shared-base parity cell.
"""

import dataclasses

import pytest

from repro_torch.fleet import (AdapterSpec, FleetSpec, ModelPoolSpec, ModelRouter,
                         TenantSpec, jain_index, partitioned_fleet)
from repro_torch.scenario import (PoolSpec, RoutingSpec, Scenario, SLOSpec,
                            SpecError, WorkloadSpec, compare, get_preset,
                            run)
from repro_torch.workload import WorkloadConfig, synthesize

pytestmark = pytest.mark.timeout(300)


def tiny_fleet(swap_s: float = 0.0, **workload_kw) -> Scenario:
    """One qwen pool, two adapter tenants + one base tenant; deterministic
    (uniform arrivals, static 100 ms steps)."""
    wl = dict(kind="open", qps=2.0, arrival="uniform", num_requests=8,
              prompt_len_mean=24.0, max_prompt_len=48,
              output_len_mean=4.0, max_output_len=5)
    wl.update(workload_kw)
    return Scenario(
        name="tiny_fleet",
        workload=WorkloadSpec(**wl),
        fleet=FleetSpec(
            models=(ModelPoolSpec(
                name="m",
                pool=PoolSpec(model="qwen2_5_3b", reduced=True, replicas=2,
                              max_num_seqs=8, max_batched_tokens=64,
                              block_size=4, num_blocks=4096,
                              enable_prefix_caching=False,
                              step_time_s=100e-3),
                routing=RoutingSpec(policy="adapter_affinity"),
                adapters=(AdapterSpec(name="a", kv_blocks=32, swap_s=swap_s),
                          AdapterSpec(name="b", kv_blocks=32,
                                      swap_s=swap_s))),),
            tenants=(
                TenantSpec(name="t1", share=2.0, model="m", adapter="a",
                           slo=SLOSpec(ttft_s=2.0)),
                TenantSpec(name="t2", share=1.0, model="m", adapter="b",
                           slo=SLOSpec(ttft_s=2.0)),
                TenantSpec(name="t3", share=1.0, model="m",
                           slo=SLOSpec(ttft_s=2.0)),
            )),
        slo=SLOSpec(ttft_s=2.0),
        seed=17)


# =========================================================================
# specs + codec error paths (satellite: indexed dotted paths)
# =========================================================================

def test_fleet_mix_round_trips():
    s = get_preset("fleet_mix")
    assert Scenario.from_dict(s.to_dict()) == s
    assert Scenario.from_json(s.to_json()) == s


def test_unknown_key_in_nested_list_carries_indexed_path():
    d = get_preset("fleet_mix").to_dict()
    d["fleet"]["tenants"][1]["slo"] = {"ttft_x": 1.0}
    with pytest.raises(SpecError, match=r"fleet\.tenants\[1\]\.slo\.ttft_x"):
        Scenario.from_dict(d)


def test_unknown_key_in_adapters_carries_indexed_path():
    d = get_preset("fleet_mix").to_dict()
    d["fleet"]["models"][0]["adapters"][1]["swap_x"] = 1.0
    with pytest.raises(
            SpecError,
            match=r"fleet\.models\[0\]\.adapters\[1\]\.swap_x"):
        Scenario.from_dict(d)


def test_unknown_key_in_faults_carries_indexed_path():
    with pytest.raises(SpecError, match=r"faults\[0\]\.nope"):
        Scenario.from_dict({"faults": [{"kind": "crash", "nope": 1}]})


def test_validation_errors_carry_indexed_paths():
    base = tiny_fleet()
    # duplicate tenant name
    f = base.fleet
    dup = dataclasses.replace(
        f, tenants=(f.tenants[0],
                    dataclasses.replace(f.tenants[1], name="t1"),
                    f.tenants[2]))
    with pytest.raises(SpecError, match=r"fleet\.tenants\[1\]\.name"):
        dataclasses.replace(base, fleet=dup).validate()
    # dangling model reference
    dangle = dataclasses.replace(
        f, tenants=(dataclasses.replace(f.tenants[0], model="ghost"),)
        + f.tenants[1:])
    with pytest.raises(SpecError, match=r"fleet\.tenants\[0\]\.model"):
        dataclasses.replace(base, fleet=dangle).validate()
    # dangling adapter reference
    bad_adapter = dataclasses.replace(
        f, tenants=(dataclasses.replace(f.tenants[0], adapter="ghost"),)
        + f.tenants[1:])
    with pytest.raises(SpecError, match=r"fleet\.tenants\[0\]\.adapter"):
        dataclasses.replace(base, fleet=bad_adapter).validate()
    # adapter overhead eating the whole pool
    fat = dataclasses.replace(
        f, models=(dataclasses.replace(
            f.models[0],
            adapters=(AdapterSpec(name="a", kv_blocks=5000),)),))
    fat = dataclasses.replace(
        fat, tenants=tuple(dataclasses.replace(t, adapter=None)
                           if t.adapter == "b" else t for t in f.tenants))
    with pytest.raises(SpecError, match=r"fleet\.models\[0\]\.adapters"):
        dataclasses.replace(base, fleet=fat).validate()


def test_fleet_cross_validation():
    base = tiny_fleet()
    with pytest.raises(SpecError, match="fleet"):
        dataclasses.replace(
            base, workload=WorkloadSpec(kind="sessions")).validate()
    with pytest.raises(SpecError, match="autoscale"):
        from repro_torch.scenario import AutoscaleSpec
        dataclasses.replace(
            base, autoscale=AutoscaleSpec(policy="queue_depth"),
            pool=PoolSpec(replicas=2)).validate()
    with pytest.raises(SpecError, match="pd_pool"):
        bad = dataclasses.replace(
            base.fleet, models=(dataclasses.replace(
                base.fleet.models[0],
                routing=RoutingSpec(policy="pd_pool")),))
        dataclasses.replace(base, fleet=bad).validate()


def test_adapter_kv_debit():
    mp = tiny_fleet().fleet.models[0]
    assert mp.pool.num_blocks == 4096
    assert mp.effective_pool().num_blocks == 4096 - 64


# =========================================================================
# ingress (deterministic WRR)
# =========================================================================

def _reqs(n, qps=4.0):
    return synthesize(WorkloadConfig(
        num_requests=n, qps=qps, arrival="uniform", prompt_len_mean=16,
        output_len_mean=4, max_prompt_len=32, max_output_len=8, seed=3))


def test_wrr_assignment_matches_shares():
    fleet = tiny_fleet().fleet
    asn = ModelRouter(fleet).assign(_reqs(16))
    # shares 2:1:1 over 16 requests -> exactly 8/4/4
    assert asn.submitted == {"t1": 8, "t2": 4, "t3": 4}
    # smooth WRR interleaves: the 2-share tenant never waits two slots
    assert asn.ingress[:4] == ["t1", "t2", "t3", "t1"]
    # assignment is a function of the spec alone: re-running is identical
    asn2 = ModelRouter(fleet).assign(_reqs(16))
    assert asn2.ingress == asn.ingress


def test_ingress_tags_requests():
    fleet = tiny_fleet().fleet
    reqs = _reqs(8)
    asn = ModelRouter(fleet).assign(reqs)
    assert set(asn.pools) == {"m"}
    for r in asn.pools["m"]:
        assert r.tenant in {"t1", "t2", "t3"}
        expected = {"t1": "a", "t2": "b", "t3": None}[r.tenant]
        assert r.adapter == expected


def test_swap_shift_applies_once_per_adapter():
    fleet = tiny_fleet(swap_s=0.5).fleet
    reqs = _reqs(8)
    asn = ModelRouter(fleet).assign(reqs)
    # exactly one cold load per adapter (a and b), 0.5 s each
    assert sorted(asn.swap_shift.values()) == [0.5, 0.5]


# =========================================================================
# adapter-affinity routing (unit)
# =========================================================================

class _View:
    def __init__(self, tokens):
        self._t = tokens

    def outstanding_tokens(self):
        return self._t

    def prefix_match_len(self, toks):
        return 0


class _Req:
    def __init__(self, adapter=None):
        self.adapter = adapter


def test_adapter_affinity_sticky_and_rebalance():
    from repro_torch.cluster.router import make_router
    r = make_router("adapter_affinity", 3)
    views = [_View(100), _View(0), _View(50)]
    # first placement: shortest drain -> replica 1; then sticky
    assert r.route(_Req("a"), views) == 1
    assert r.route(_Req("a"), [_View(0), _View(999), _View(0)]) == 1
    # a different adapter places independently
    assert r.route(_Req("b"), [_View(0), _View(999), _View(50)]) == 0
    # base traffic ignores the sticky map
    assert r.route(_Req(None), [_View(9), _View(1), _View(5)]) == 1
    # sticky replica drained away -> deterministic re-place among active
    assert r.route(_Req("a"), views, active=[0, 2]) == 2
    assert r.adapter_placements() == {"a": 2, "b": 0}


# =========================================================================
# end-to-end: metrics, conservation, swap accounting, parity
# =========================================================================

def test_per_tenant_conservation_and_fairness():
    res = run(tiny_fleet(), "thread", timeout=120)
    assert res.tenants is not None and len(res.tenants) == 3
    total = 0
    for row in res.tenants.values():
        assert row["completed"] + row["failed"] == row["submitted"]
        total += row["submitted"]
    assert total == 8 == res.num_requests
    assert 0.0 < res.fairness <= 1.0
    atts = [row["attainment"] for row in res.tenants.values()]
    assert res.fairness == pytest.approx(jain_index(atts))
    assert res.tenant_attainment() == pytest.approx(1.0)


def test_swap_penalty_lands_in_reported_latency():
    cold = run(tiny_fleet(swap_s=0.5), "thread", timeout=120)
    warm = run(tiny_fleet(swap_s=0.0), "thread", timeout=120)
    # exactly the two first-adapter requests pay exactly the cold load
    diffs = [cold.latencies[k][0] - warm.latencies[k][0]
             for k in warm.latencies]
    paying = [d for d in diffs if d > 1e-9]
    assert len(paying) == 2
    assert all(d == pytest.approx(0.5) for d in paying)


def test_fleet_thread_des_parity():
    c = compare(tiny_fleet(swap_s=0.25), ("thread", "des"), timeout=120)
    assert c.decisions_equal and c.completed_equal
    assert c.max_err_steps <= 1.0


def test_fleet_mix_preset_thread_des_parity():
    c = compare(get_preset("fleet_mix"), ("thread", "des"), timeout=300)
    assert c.decisions_equal and c.scaleup_tiers_equal
    assert c.max_err_steps <= 1.0


def test_partitioned_fleet_costs_more():
    mux = tiny_fleet()
    part = partitioned_fleet(mux)
    assert len(part.fleet.models) == 3          # one dedicated pool each
    assert {t.model for t in part.fleet.tenants} == \
        {m.name for m in part.fleet.models}
    r_mux = run(mux, "des", timeout=120)
    r_part = run(part, "des", timeout=120)
    assert r_part.replica_seconds > r_mux.replica_seconds
    # attainment does not improve by partitioning at this utilization
    assert r_mux.tenant_attainment() >= r_part.tenant_attainment() - 1e-9


def test_fleet_requires_full_audit():
    with pytest.raises(SpecError, match="audit"):
        run(tiny_fleet(), "thread", audit="sampled")


def test_jain_index_bounds():
    assert jain_index([]) == 1.0
    assert jain_index([0.0, 0.0]) == 1.0
    assert jain_index([1.0, 1.0, 1.0]) == pytest.approx(1.0)
    assert jain_index([1.0, 0.0, 0.0, 0.0]) == pytest.approx(0.25)
