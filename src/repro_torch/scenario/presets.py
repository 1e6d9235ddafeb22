"""Named paper-style scenarios: the registry behind figures, CI, and the CLI.

Each preset is a factory returning a fresh :class:`Scenario`; the benchmark
figure scripts derive their grids from these bases (``benchmarks/fig_*.py``)
and the CLI runs them by name (``python -m repro.scenario run
cluster_scaling``), so a new workload × topology × policy experiment is a
JSON tweak away instead of a new Python file.

The ``*_parity`` presets are deliberately tiny and deterministic (uniform
arrivals, slow static predictor steps, prefix caching off) so a three-way
``compare`` across thread/process/DES finishes in CI seconds — they are the
scenario-smoke gate in ``.github/workflows/ci.yml``.

>>> sorted(PRESETS) == sorted(list_presets())
True
>>> get_preset("cluster_scaling").pool.replicas
2
>>> get_preset("nope")
Traceback (most recent call last):
  ...
KeyError: "unknown preset 'nope'; choose from ['autoscale_burst', \
'chaos_spot', 'cluster_scaling', 'crash_recovery', 'distributed_parity', \
'elastic_tier_parity', 'fleet_mix', 'hetero_mix', 'scale_stream']"
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .spec import (AutoscaleSpec, FaultSpec, PoolSpec, RoutingSpec, Scenario,
                   SLOSpec, WorkloadSpec)

__all__ = ["PRESETS", "get_preset", "list_presets", "describe"]


def cluster_scaling() -> Scenario:
    """Open-loop ShareGPT-like stream on a data-parallel llama3-8b pool —
    the fig_cluster_scaling base cell (replicas/policy/QPS are the axes)."""
    return Scenario(
        name="cluster_scaling",
        workload=WorkloadSpec(
            kind="open", qps=4.0, num_requests=40,
            prompt_len_mean=180.0, output_len_mean=40.0,
            max_output_len=1024),
        pool=PoolSpec(
            model="llama3_8b", replicas=2, max_num_seqs=8,
            max_batched_tokens=512, block_size=16, num_blocks=16384,
            chip="h200-sxm", step_time_s=20e-3),
        routing=RoutingSpec(policy="round_robin"),
        slo=SLOSpec(ttft_s=1.0),
        seed=13)


def autoscale_burst() -> Scenario:
    """Bursty multi-turn chat sessions (gamma cv²=8) on an elastic pool with
    a TTFT-SLO autoscaler — the fig_autoscale base cell."""
    return Scenario(
        name="autoscale_burst",
        workload=WorkloadSpec(
            kind="sessions", qps=6.0, arrival="gamma",
            arrival_kwargs={"cv2": 8.0}, num_sessions=16,
            turns_mean=3.0, max_turns=5, think_time_mean=1.5,
            prompt_len_mean=180.0, followup_len_mean=60.0,
            output_len_mean=40.0, max_output_len=128),
        pool=PoolSpec(
            model="llama3_8b", replicas=2, max_num_seqs=8,
            max_batched_tokens=512, block_size=16, num_blocks=16384,
            chip="h200-sxm", step_time_s=20e-3),
        routing=RoutingSpec(policy="least_outstanding_tokens"),
        autoscale=AutoscaleSpec(
            policy="ttft_slo",
            kwargs={"slo_ttft_s": 0.5, "target_attainment": 0.98,
                    "window_s": 2.0},
            interval_s=0.1, provision_delay_s=0.5,
            min_replicas=2, max_replicas=4),
        slo=SLOSpec(ttft_s=0.5),
        seed=13)


def hetero_mix() -> Scenario:
    """Mixed H100+L4 pool under cost-normalized routing — the fig_hetero
    base cell (tier mix / policy / QPS are the axes).  Per-tier static
    steps encode the ~2.5× H100-vs-L4 roofline ratio."""
    return Scenario(
        name="hetero_mix",
        workload=WorkloadSpec(
            kind="open", qps=10.0, num_requests=16,
            prompt_len_mean=180.0, output_len_mean=40.0,
            max_output_len=1024),
        pool=PoolSpec(
            model="llama3_8b", replicas=4,
            tiers=("h100", "h100", "l4", "l4"),
            max_num_seqs=8, max_batched_tokens=512, block_size=16,
            num_blocks=16384,
            tier_step_time_s={"h100": 8e-3, "l4": 20e-3}),
        routing=RoutingSpec(policy="cost_normalized_load"),
        slo=SLOSpec(ttft_s=0.5),
        seed=13)


def distributed_parity() -> Scenario:
    """Tiny deterministic backend-parity cell: uniformly spaced arrivals
    with idle-replica headroom and one deliberately slow predictor step, so
    thread / process / DES must agree within one step (the
    fig_distributed methodology as a named scenario)."""
    return Scenario(
        name="distributed_parity",
        workload=WorkloadSpec(
            kind="open", qps=2.0, arrival="uniform", num_requests=10,
            prompt_len_mean=24.0, max_prompt_len=48,
            output_len_mean=4.0, max_output_len=5),
        pool=PoolSpec(
            model="qwen2_5_3b", reduced=True, replicas=2,
            max_num_seqs=8, max_batched_tokens=64, block_size=4,
            num_blocks=4096, enable_prefix_caching=False,
            # deliberately slow: socket round trips absorb wall time into
            # the virtual timeline (Eq. 1) on the process backend, and the
            # parity bar is "within one of these" — sized so a noisy CI
            # machine's absorption stays well inside a step
            step_time_s=100e-3),
        routing=RoutingSpec(policy="round_robin"),
        seed=17)


def elastic_tier_parity() -> Scenario:
    """Mixed-tier pool scaling up mid-run through a scripted tier-selecting
    autoscaler (cheapest candidate: L4) — the elastic/heterogeneous parity
    scenario all three backends must agree on."""
    return Scenario(
        name="elastic_tier_parity",
        workload=WorkloadSpec(
            kind="open", qps=2.5, arrival="uniform", num_requests=10,
            prompt_len_mean=24.0, max_prompt_len=48,
            output_len_mean=4.0, max_output_len=5),
        pool=PoolSpec(
            model="qwen2_5_3b", reduced=True, replicas=2,
            tiers=("h100", "l4"),
            max_num_seqs=8, max_batched_tokens=64, block_size=4,
            num_blocks=4096, enable_prefix_caching=False,
            tier_step_time_s={"h100": 50e-3, "l4": 125e-3}),
        routing=RoutingSpec(policy="round_robin"),
        autoscale=AutoscaleSpec(
            policy="schedule", schedule=((0.3, 1),),
            interval_s=0.1, provision_delay_s=0.1,
            min_replicas=2, max_replicas=3,
            tiers=("h100", "l4"),
            provision_delay_by_tier={"l4": 0.06}),
        seed=17)


def crash_recovery() -> Scenario:
    """Chaos parity cell: replica 1 is SIGKILL-crashed mid-decode at t=0.97
    (a deliberate off-step-grid instant — see the determinism caveat in
    :mod:`repro.cluster.faults`), its in-flight requests requeue through the
    router, and a warm standby respawns 0.35 virtual seconds later.  All
    three backends must report the identical fault log and requeue count."""
    return Scenario(
        name="crash_recovery",
        workload=WorkloadSpec(
            kind="open", qps=2.0, arrival="uniform", num_requests=10,
            prompt_len_mean=24.0, max_prompt_len=48,
            output_len_mean=4.0, max_output_len=5),
        pool=PoolSpec(
            model="qwen2_5_3b", reduced=True, replicas=2,
            max_num_seqs=8, max_batched_tokens=64, block_size=4,
            num_blocks=4096, enable_prefix_caching=False,
            step_time_s=100e-3),
        routing=RoutingSpec(policy="round_robin"),
        faults=(
            FaultSpec(kind="crash", time_s=0.97, replica=1,
                      on_crash="requeue", recover=True,
                      respawn_delay_s=0.35),
        ),
        seed=17)


def chaos_spot() -> Scenario:
    """Chaos parity cell on a mixed spot pool: an H100 replica straggles at
    2× for one virtual second, then the whole L4 (spot) tier is reclaimed
    with a notice window too short to drain, so the kill lands mid-decode
    and requeues work — stragglers, drain-then-kill, and warm-pool
    recovery in one deterministic scenario (fault times off the step
    grid).  The slowdown (2 × 50 ms = 100 ms) stays under the slow-step
    parity unit (125 ms), so the ≤ 1-slow-step latency bar still binds."""
    return Scenario(
        name="chaos_spot",
        workload=WorkloadSpec(
            kind="open", qps=2.0, arrival="uniform", num_requests=10,
            prompt_len_mean=24.0, max_prompt_len=48,
            output_len_mean=4.0, max_output_len=5),
        pool=PoolSpec(
            model="qwen2_5_3b", reduced=True, replicas=3,
            tiers=("h100", "h100", "l4"),
            max_num_seqs=8, max_batched_tokens=64, block_size=4,
            num_blocks=4096, enable_prefix_caching=False,
            tier_step_time_s={"h100": 50e-3, "l4": 125e-3}),
        routing=RoutingSpec(policy="round_robin"),
        faults=(
            FaultSpec(kind="straggler", time_s=0.47, replica=1,
                      slowdown=2.0, duration_s=1.0),
            FaultSpec(kind="spot_reclaim", time_s=1.07, tier="l4",
                      notice_s=0.15, on_crash="requeue", recover=True,
                      respawn_delay_s=0.4),
        ),
        seed=17)


def fleet_mix() -> Scenario:
    """Multi-model multi-tenant fleet parity cell (``repro.fleet``): a
    shared qwen "chat" base pool serving two LoRA tenants (adapter-affinity
    routing, per-adapter KV debit, cold-load swap stalls) plus a dedicated
    olmo "code" pool, under a scheduled per-pool scale-up — deterministic
    (uniform arrivals, static steps) so thread / process / DES must agree
    to one slow-step, multi-LoRA shared-base cell included."""
    from repro_torch.fleet import (AdapterSpec, FleetSpec, ModelPoolSpec,
                             TenantSpec)
    return Scenario(
        name="fleet_mix",
        workload=WorkloadSpec(
            kind="open", qps=2.0, arrival="uniform", num_requests=12,
            prompt_len_mean=24.0, max_prompt_len=48,
            output_len_mean=4.0, max_output_len=5),
        fleet=FleetSpec(
            models=(
                ModelPoolSpec(
                    name="chat",
                    pool=PoolSpec(
                        model="qwen2_5_3b", reduced=True, replicas=2,
                        max_num_seqs=8, max_batched_tokens=64, block_size=4,
                        num_blocks=4096, enable_prefix_caching=False,
                        step_time_s=100e-3),
                    routing=RoutingSpec(policy="adapter_affinity"),
                    autoscale=AutoscaleSpec(
                        policy="schedule", schedule=((0.5, 1),),
                        interval_s=0.1, provision_delay_s=0.1,
                        min_replicas=2, max_replicas=3),
                    adapters=(
                        AdapterSpec(name="alpha", kv_blocks=64,
                                    swap_s=0.12),
                        AdapterSpec(name="beta", kv_blocks=64,
                                    swap_s=0.12),
                    )),
                ModelPoolSpec(
                    name="code",
                    pool=PoolSpec(
                        model="olmo_1b", reduced=True, replicas=1,
                        max_num_seqs=8, max_batched_tokens=64, block_size=4,
                        num_blocks=4096, enable_prefix_caching=False,
                        step_time_s=80e-3),
                    routing=RoutingSpec(policy="round_robin")),
            ),
            tenants=(
                TenantSpec(name="acme", share=2.0, priority=1,
                           model="chat", adapter="alpha",
                           slo=SLOSpec(ttft_s=2.0)),
                TenantSpec(name="bolt", share=1.0, model="chat",
                           adapter="beta", slo=SLOSpec(ttft_s=2.0)),
                TenantSpec(name="cava", share=1.0, model="code",
                           slo=SLOSpec(ttft_s=2.0)),
            )),
        slo=SLOSpec(ttft_s=2.0),
        seed=17)


def scale_stream() -> Scenario:
    """Diurnal-trace streaming sessions — the million-session scale base
    cell (``fig_scale`` sweeps ``num_sessions`` at fixed qps, so session
    count scales the virtual *duration*, not the concurrency; run with
    ``audit="sampled"`` for flat memory)."""
    return Scenario(
        name="scale_stream",
        workload=WorkloadSpec(
            kind="sessions", streaming=True, qps=50.0,
            arrival="trace",
            # one 240-virtual-second "day": quiet night, morning ramp,
            # midday peak, evening tail (relative rates; qps rescales the
            # mean, preserving the shape)
            arrival_kwargs={"trace": [
                [30.0, 0.3], [30.0, 0.6], [30.0, 1.0], [30.0, 1.5],
                [30.0, 1.7], [30.0, 1.3], [30.0, 0.8], [30.0, 0.4]]},
            num_sessions=10_000, turns_mean=2.0, max_turns=3,
            think_time_mean=0.5,
            prompt_len_mean=48.0, prompt_len_sigma=0.4,
            followup_len_mean=24.0,
            output_len_mean=12.0, output_len_sigma=0.4,
            max_output_len=24),
        pool=PoolSpec(
            model="qwen2_5_3b", reduced=True, replicas=2,
            max_num_seqs=64, max_batched_tokens=2048, block_size=16,
            num_blocks=16384, enable_prefix_caching=False,
            step_time_s=2e-3),
        routing=RoutingSpec(policy="round_robin"),
        slo=SLOSpec(ttft_s=1.0),
        seed=29)


PRESETS: Dict[str, Callable[[], Scenario]] = {
    fn.__name__: fn
    for fn in (cluster_scaling, autoscale_burst, hetero_mix,
               distributed_parity, elastic_tier_parity, crash_recovery,
               chaos_spot, fleet_mix, scale_stream)
}


def get_preset(name: str) -> Scenario:
    """A fresh scenario for ``name`` (each call builds a new tree)."""
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; choose from "
                       f"{sorted(PRESETS)}") from None


def list_presets() -> List[str]:
    return sorted(PRESETS)


def describe(name: str) -> str:
    """First docstring line of the preset factory (CLI listing)."""
    doc = PRESETS[name].__doc__ or ""
    return " ".join(doc.split("\n\n")[0].split())
