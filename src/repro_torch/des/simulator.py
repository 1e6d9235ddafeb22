"""Vidur-style discrete-event simulator — the baseline Revati replaces.

This is a deliberate, faithful instance of the approach the paper critiques
(§2.2–2.3): the serving system's control logic is *re-implemented* inside an
event loop.  It models continuous batching with chunked prefill (the ~150
lines Vidur needed for the original vLLM scheduler) and shares Revati's
runtime predictor, so any output divergence from the emulator is purely the
**semantic gap** of re-implementation — not a cost-model difference.

Multi-replica mode: ``num_replicas > 1`` runs N independent replica engines
inside one merged event loop, with request placement delegated to the same
pluggable :class:`~repro.cluster.router.Router` policies that route the
emulator's real engines.  Using identically-constructed policy objects
(routers are stateful — build a fresh one per run) pins routing behaviour
equal by construction, so emulator-vs-DES divergence at cluster scale is
attributable purely to engine-semantics re-implementation — extending the
paper's semantic-gap argument to N replicas.

Elastic mode: the simulator consumes the same
:class:`~repro.cluster.autoscaler.AutoscalerPolicy` objects as the emulated
cluster — policy ticks are events every ``interval_s``, scale-ups append a
fresh replica after the modeled ``provision_delay_s``, and scale-downs pick
their victim through the shared
:func:`~repro.cluster.autoscaler.drain_victim` rule (most expensive idle
tier first, index tie-break — literally the same function the emulator's
Autoscaler calls), so emulator-vs-DES parity extends to runs where replicas
join and leave mid-stream, on mixed pools included.

Heterogeneous mode: ``replica_tiers`` gives each replica a hardware tier;
``tier_predictors`` supplies the per-tier step-time predictors and
``tier_specs`` the shared :class:`~repro.cluster.tiers.TierSpec` arithmetic
(router throughput weights, $/replica-second, tier-selection inputs).  Build
the spec dict **once** (``repro.cluster.tiers.make_tier_specs``) and pass the
same mapping to ``build_cluster`` and here: tier-aware routing weights,
scale-up tier choices (``policy.select_tier`` at tick time), and per-tier
provisioning delays then agree between emulator and DES by construction,
extending the parity argument to mixed pools.

Closed-loop mode: ``run`` also accepts a
:class:`~repro.workload.session.SessionWorkload`; turn completions re-inject
the pre-sampled follow-up turns through the *same* ``follow_up`` rule the
emulator's completion callbacks use.

Intentionally (and realistically) missing, mirroring Table 1's "VD" column:
prefix caching (so ``prefix_affinity`` routing degrades to its sticky-map
fallback — a DES replica can never report a cache hit), hierarchical cache
tiers, preemption-by-recompute, per-framework batching quirks, and the
``pd_pool`` policy's KV migration (re-implementing it here would be exactly
the re-implementation burden the paper critiques, so it raises instead).
``benchmarks/table1_features`` quantifies the resulting error on workloads
that exercise those features.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.predictor import BatchSpec, RuntimePredictor, SeqSpec


@dataclass
class DESConfig:
    max_num_seqs: int = 64
    max_batched_tokens: int = 512
    step_overhead_s: float = 20e-6     # modelled CPU overhead per step


@dataclass
class SimRequest:
    request_id: int
    prompt_len: int
    max_new_tokens: int
    arrival_time: float
    num_prefilled: int = 0
    num_generated: int = 0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    failed: bool = False                           # crash, on_crash="fail"
    replica: int = -1                              # placement decision
    prompt_tokens: Optional[Tuple[int, ...]] = None  # routing key only
    session_id: Optional[int] = None               # closed-loop identity
    turn_index: int = 0
    tenant: Optional[str] = None                   # fleet ingress tag
    adapter: Optional[str] = None                  # LoRA adapter (routing key)

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = self.num_generated - 1
        return (self.finish_time - self.first_token_time) / n if n > 0 else 0.0


class _ReplicaState:
    """One simulated engine replica: queues + in-flight step bookkeeping.

    Also the replica's :class:`~repro.cluster.router.ReplicaView`: routing
    probes answer from event-loop state.  ``prefix_match_len`` is always 0 —
    the DES models no radix cache (Table 1), which is itself part of the
    semantic gap the multi-replica comparison measures.
    """

    def __init__(self, index: int, added_at: float = 0.0,
                 tier: Optional[str] = None, predictor=None):
        self.index = index
        self.waiting: List[SimRequest] = []
        self.running: List[SimRequest] = []
        self.step_in_flight = False
        self.in_flight_batch: List[Tuple[SimRequest, int]] = []
        self.added_at = added_at
        self.drained_at: Optional[float] = None
        self.dead = False                # crashed/reclaim-killed (faults)
        self.tier = tier                 # hardware tier name (None = untiered)
        self.predictor = predictor       # tier-resolved step-time predictor

    # ------------------------------------------------------- ReplicaView --
    def outstanding_tokens(self) -> int:
        total = 0
        for s in self.waiting + self.running:
            total += max(s.prompt_len - s.num_prefilled, 0)
            total += max(s.max_new_tokens - s.num_generated, 0)
        return total

    def num_outstanding(self) -> int:
        return len(self.waiting) + len(self.running)

    def prefix_match_len(self, tokens) -> int:
        return 0

    def idle(self) -> bool:
        return not (self.waiting or self.running or self.step_in_flight)


class _DESView:
    """AutoscalerView over event-loop state (mirror of the emulator's)."""

    def __init__(self, sim: "DiscreteEventSimulator"):
        self._sim = sim
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def active_count(self) -> int:
        return len(self._sim.active)

    def queue_depths(self) -> List[int]:
        return [self._sim.replicas[i].num_outstanding()
                for i in self._sim.active]

    def recent_ttfts(self, window_s: float) -> List[float]:
        horizon = self._now - window_s
        return [t for ft, t in self._sim._finish_log if ft >= horizon]


class DiscreteEventSimulator:
    """Event-driven re-implementation of a vLLM-like engine (1..N replicas,
    optionally elastic and closed-loop)."""

    ARRIVAL, STEP_DONE, TICK, PROVISION = 0, 1, 2, 3
    # fault events, mirroring repro.cluster.faults.FaultInjector one-to-one
    CRASH, STRAGGLE, STRAGGLE_END = 4, 5, 6
    RECLAIM, RECLAIM_KILL, RESPAWN = 7, 8, 9

    def __init__(
        self,
        predictor: RuntimePredictor,
        cfg: Optional[DESConfig] = None,
        *,
        num_replicas: int = 1,
        router=None,                 # repro.cluster.router.Router
        autoscaler_policy=None,      # repro.cluster.autoscaler.AutoscalerPolicy
        autoscaler_cfg=None,         # repro.cluster.autoscaler.AutoscalerConfig
        replica_tiers=None,          # per-replica tier names (heterogeneous)
        tier_predictors=None,        # tier name -> RuntimePredictor
        tier_specs=None,             # tier name -> repro.cluster.tiers.TierSpec
        faults=None,                 # iterable of repro.cluster.faults.FaultSpec
    ):
        self.predictor = predictor
        # per-instance default: a shared mutable default DESConfig would
        # alias config state across simulators
        self.cfg = cfg if cfg is not None else DESConfig()
        self.num_replicas = num_replicas
        self.replica_tiers = (list(replica_tiers) if replica_tiers is not None
                              else [None] * num_replicas)
        if len(self.replica_tiers) != num_replicas:
            raise ValueError(
                f"need {num_replicas} tier names, "
                f"got {len(self.replica_tiers)}")
        self.tier_predictors = dict(tier_predictors or {})
        self.tier_specs = dict(tier_specs or {})
        for t in set(self.replica_tiers):
            if t is not None and t not in self.tier_specs:
                raise ValueError(
                    f"replica tier {t!r} has no TierSpec; build one dict via "
                    "repro.cluster.tiers.make_tier_specs and share it with "
                    "build_cluster")
        if router is not None and getattr(router, "policy", None) == "pd_pool":
            raise ValueError(
                "the DES baseline does not model PD disaggregation "
                "(KV migration would need re-implementation — the exact "
                "burden the paper critiques); use the cluster emulator")
        if router is not None and router.num_replicas != num_replicas:
            raise ValueError(
                f"router sized for {router.num_replicas} replicas, "
                f"simulator has {num_replicas}")
        self.router = router
        self.autoscaler_policy = autoscaler_policy
        self.autoscaler_cfg = autoscaler_cfg
        self.faults = list(faults or [])
        self.replicas: List[_ReplicaState] = []
        self.active: List[int] = []
        # fault-injection audit, filled per run(); tuples identical to
        # FaultInjector.events (nominal times, primitives) for compare()
        self.fault_log: List[tuple] = []
        self.failed: List[SimRequest] = []
        self.requeued_total = 0
        self.recoveries: List[Tuple[float, float]] = []
        self._finish_log: List[Tuple[float, float]] = []   # (finish, ttft)
        # sink mode prunes the TTFT log to this sliding window of virtual
        # seconds; keep it comfortably wider than any autoscaler policy's
        # recent_ttfts() window
        self.finish_log_window_s: float = 300.0

    # ----------------------------------------------------------- plumbing --
    @staticmethod
    def _to_sim(r, request_id: int) -> SimRequest:
        toks = getattr(r, "prompt_tokens", None)
        plen = getattr(r, "prompt_len", None) or len(toks)
        return SimRequest(
            request_id=request_id, prompt_len=plen,
            max_new_tokens=r.max_new_tokens,
            arrival_time=r.arrival_time,
            prompt_tokens=tuple(toks) if toks is not None else None,
            session_id=getattr(r, "session_id", None),
            turn_index=getattr(r, "turn_index", 0),
            tenant=getattr(r, "tenant", None),
            adapter=getattr(r, "adapter", None))

    def _tier_predictor(self, tier: Optional[str]):
        if tier is not None and tier in self.tier_predictors:
            return self.tier_predictors[tier]
        return self.predictor

    def replica_seconds(self, t_end: float) -> float:
        """Capacity proxy matching :meth:`Cluster.replica_seconds`."""
        total = 0.0
        for rep in self.replicas:
            end = rep.drained_at if rep.drained_at is not None else t_end
            total += max(0.0, min(end, t_end) - rep.added_at)
        return total

    def replica_cost(self, t_end: float) -> float:
        """Dollar cost matching :meth:`Cluster.replica_cost` (untiered
        replicas cost $0)."""
        total = 0.0
        for rep in self.replicas:
            if rep.tier is None:
                continue
            end = rep.drained_at if rep.drained_at is not None else t_end
            on = max(0.0, min(end, t_end) - rep.added_at)
            total += on * self.tier_specs[rep.tier].cost_per_replica_s
        return total

    # ---------------------------------------------------------------- run --
    def run(self, requests, *, sink=None) -> List[SimRequest]:
        """``requests``: an iterable of request-like objects (repro Request
        or SimRequest: prompt_tokens/prompt_len, max_new_tokens,
        arrival_time) **or** a SessionWorkload (closed loop).

        Lists/tuples and eager SessionWorkloads are materialized up front
        (historical behaviour, byte-identical event order).  Any other
        iterable — a generator, :class:`~repro.workload.StreamingWorkload`,
        or a :class:`~repro.workload.StreamingSessionWorkload` (consumed via
        ``initial_stream``) — is pulled lazily with one-arrival look-ahead,
        so the event heap never holds the whole workload.  Lazy sources must
        yield non-decreasing ``arrival_time``.

        ``sink``: optional callable receiving each completed
        :class:`SimRequest` as it finishes.  When set, completed requests
        are **not** retained (``run`` returns an empty list) and the
        autoscaler's TTFT finish-log is pruned to a sliding window of
        ``finish_log_window_s`` virtual seconds — the flat-memory scale
        path.
        """
        from repro_torch.cluster.router import RoundRobinRouter

        router = self.router or RoundRobinRouter(self.num_replicas)

        session_workload = None
        stream = None
        if hasattr(requests, "initial_stream"):   # streaming closed loop
            session_workload = requests
            stream = iter(requests.initial_stream())
            source = ()
            expected = requests.total_requests
        elif hasattr(requests, "initial_requests"):    # eager SessionWorkload
            session_workload = requests
            source = session_workload.initial_requests()
            expected = session_workload.total_requests
        elif isinstance(requests, (list, tuple)):
            source = list(requests)
            expected = len(source)
        else:                                     # lazy open-loop stream
            stream = iter(requests)
            source = ()
            expected = getattr(requests, "total_requests", None)
            if expected is None:
                expected = getattr(requests, "expected", None)
        if self.autoscaler_policy is not None and expected is None:
            raise ValueError(
                "elastic DES needs a declared request count to know when to "
                "stop ticking; pass a workload exposing .expected / "
                ".total_requests instead of a bare generator")

        req_counter = itertools.count()
        sims: List[SimRequest] = [self._to_sim(r, next(req_counter))
                                  for r in source]

        self.replicas = [
            _ReplicaState(i, tier=self.replica_tiers[i],
                          predictor=self._tier_predictor(self.replica_tiers[i]))
            for i in range(self.num_replicas)
        ]
        # mirror of Cluster.__init__'s tier wiring: routing policies see the
        # same per-replica throughput weights / $ rates on both sides
        for i, t in enumerate(self.replica_tiers):
            if t is not None:
                spec = self.tier_specs[t]
                router.set_tier(i, weight=spec.throughput_factor,
                                cost=spec.cost_per_replica_s)
        self.active = list(range(self.num_replicas))
        self._finish_log = []
        self.fault_log = []
        self.failed = []
        self.requeued_total = 0
        self.recoveries = []
        asc_cfg = self.autoscaler_cfg
        if self.autoscaler_policy is not None and asc_cfg is None:
            from repro_torch.cluster.autoscaler import AutoscalerConfig
            asc_cfg = AutoscalerConfig()
        asc_tier_specs = []
        if asc_cfg is not None and getattr(asc_cfg, "tiers", ()):
            missing = [t for t in asc_cfg.tiers if t not in self.tier_specs]
            if missing:
                raise ValueError(
                    f"autoscaler tiers {missing} have no TierSpec; pass "
                    "tier_specs= (shared with the emulated cluster)")
            asc_tier_specs = [self.tier_specs[t] for t in asc_cfg.tiers]
        view = _DESView(self)
        if self.autoscaler_policy is not None:
            # Same anchoring call the emulator's Autoscaler makes at start:
            # the DES timeline originates at 0.0 by construction.
            self.autoscaler_policy.set_origin(0.0)

        counter = itertools.count()
        # event payload: SimRequest for ARRIVAL, replica index for STEP_DONE,
        # None for TICK / PROVISION
        events: List[Tuple[float, int, int, object]] = []
        for s in sims:
            heapq.heappush(events, (s.arrival_time, next(counter), self.ARRIVAL, s))
        if self.autoscaler_policy is not None:
            heapq.heappush(events, (asc_cfg.interval_s, next(counter),
                                    self.TICK, None))
        if self.faults:
            # the SAME static schedule expansion the emulator's FaultInjector
            # pops: one heap walk, so relative order of same-time faults is
            # pinned equal across backends
            from repro_torch.cluster.faults import schedule_of
            _kind_of = {"crash": self.CRASH, "straggle": self.STRAGGLE,
                        "straggle_end": self.STRAGGLE_END,
                        "reclaim": self.RECLAIM}
            sched = schedule_of(self.faults)
            while sched:
                f_t, _, action, f_spec = heapq.heappop(sched)
                heapq.heappush(events, (f_t, next(counter),
                                        _kind_of[action], f_spec))

        def pull_source() -> Optional[SimRequest]:
            """Next source arrival from a lazy stream (None when drained)."""
            try:
                r = next(stream)
            except StopIteration:
                return None
            s = self._to_sim(r, next(req_counter))
            if sink is None:
                sims.append(s)
            return s

        pending = pull_source() if stream is not None else None

        now = 0.0
        completed = 0
        provisioning = 0

        def schedule_step(rep: _ReplicaState):
            if rep.step_in_flight:
                return
            batch: List[Tuple[SimRequest, int]] = []
            budget = self.cfg.max_batched_tokens
            # decodes first (mixed batching)
            for s in rep.running:
                if s.num_prefilled >= s.prompt_len:
                    batch.append((s, 1))
            # chunked prefill continuation + FCFS admission
            for s in rep.running:
                if budget <= 0:
                    break
                if s.num_prefilled < s.prompt_len:
                    chunk = min(budget, s.prompt_len - s.num_prefilled)
                    batch.append((s, chunk))
                    budget -= chunk
            while (budget > 0 and rep.waiting
                   and len(rep.running) < self.cfg.max_num_seqs):
                s = rep.waiting.pop(0)
                rep.running.append(s)
                chunk = min(budget, s.prompt_len)
                batch.append((s, chunk))
                budget -= chunk
            if not batch:
                return
            spec = BatchSpec.make([
                SeqSpec(n, s.num_prefilled + s.num_generated + n)
                for s, n in batch
            ])
            dur = rep.predictor.predict_step(spec).total + self.cfg.step_overhead_s
            rep.in_flight_batch = batch
            rep.step_in_flight = True
            heapq.heappush(
                events, (now + dur, next(counter), self.STEP_DONE, rep.index))

        def pick_drain_victim() -> Optional[int]:
            # the exact rule object the emulator's Autoscaler._pick_victim
            # calls: most expensive idle tier first, index tie-break
            from repro_torch.cluster.autoscaler import drain_victim

            def cost_of(i: int) -> float:
                t = self.replicas[i].tier
                return 0.0 if t is None else self.tier_specs[t].cost_per_replica_s

            return drain_victim(self.active,
                                idle_of=lambda i: self.replicas[i].idle(),
                                cost_of=cost_of)

        def apply_autoscale(delta: int):
            nonlocal provisioning
            from repro_torch.cluster.autoscaler import provision_delay
            committed = len(self.active) + provisioning
            if delta > 0:
                delta = min(delta, asc_cfg.max_replicas - committed)
                for _ in range(max(0, delta)):
                    provisioning += 1
                    # tier choice happens at tick time, mirroring
                    # Autoscaler._apply; the PROVISION event carries it
                    tier = None
                    if asc_tier_specs:
                        tier = self.autoscaler_policy.select_tier(
                            view, asc_tier_specs).name
                    heapq.heappush(
                        events, (now + provision_delay(asc_cfg, tier),
                                 next(counter), self.PROVISION, tier))
            elif delta < 0:
                allowed = max(0, committed - asc_cfg.min_replicas)
                for _ in range(min(-delta, allowed)):
                    victim = pick_drain_victim()
                    if victim is None:
                        break
                    self.active.remove(victim)
                    rep = self.replicas[victim]
                    if rep.idle():
                        rep.drained_at = now

        def crash_now(idx: int, spec, *, log_kind: str):
            """Kill replica ``idx`` with crash semantics — the DES mirror of
            ``ClusterBase.crash_replica`` + ``FaultInjector._apply_crash``,
            guard-for-guard: missing/drained/last-active replicas refuse,
            the log records nominal time, victims sort by
            ``(arrival_time, request_id)`` and re-route (or fail)."""
            t = now
            if idx >= len(self.replicas):
                self.fault_log.append((log_kind, t, idx, 0, 0, False))
                return
            rep = self.replicas[idx]
            if rep.dead or rep.drained_at is not None:
                self.fault_log.append((log_kind, t, idx, 0, 0, False))
                return
            if idx in self.active:
                if len(self.active) <= 1:
                    self.fault_log.append((log_kind, t, idx, 0, 0, False))
                    return
                self.active.remove(idx)
            rep.dead = True
            rep.drained_at = now          # cost window closes at the crash
            # in_flight_batch entries are running-list members; the step's
            # STEP_DONE event stays on the heap but is skipped (rep.dead) —
            # the step never completes, its tokens are lost with the KV
            victims = list(rep.waiting) + list(rep.running)
            rep.waiting.clear()
            rep.running.clear()
            rep.in_flight_batch = []
            rep.step_in_flight = False
            victims.sort(key=lambda s: (s.arrival_time, s.request_id))
            requeued = failed_n = 0
            if spec.on_crash == "requeue":
                for s in victims:
                    s.num_prefilled = 0
                    s.num_generated = 0
                    s.first_token_time = None
                    s.finish_time = None
                    tgt = router.route(s, self.replicas, active=self.active)
                    s.replica = tgt
                    self.replicas[tgt].waiting.append(s)
                for tgt in sorted({s.replica for s in victims}):
                    schedule_step(self.replicas[tgt])
                requeued = len(victims)
                self.requeued_total += requeued
            else:
                for s in victims:
                    s.failed = True
                self.failed.extend(victims)
                failed_n = len(victims)
            self.fault_log.append((log_kind, t, idx, requeued, failed_n, True))
            if spec.recover:
                tier = (spec.respawn_tier if spec.respawn_tier is not None
                        else rep.tier)
                heapq.heappush(events, (t + spec.respawn_delay_s,
                                        next(counter), self.RESPAWN,
                                        (tier, t)))

        while events or pending is not None:
            # One-ahead merge of the lazy source with the event heap.  Ties
            # go to the source arrival — the exact order the eager path
            # produces, where every source arrival's heap counter precedes
            # any event scheduled during the run.
            if pending is not None and (
                    not events or pending.arrival_time <= events[0][0]):
                now, kind, payload = pending.arrival_time, self.ARRIVAL, pending
                pending = pull_source()
                if pending is not None and pending.arrival_time < now:
                    raise ValueError(
                        "lazy request streams must yield non-decreasing "
                        f"arrival times (got {pending.arrival_time} after "
                        f"{now})")
            else:
                now, _, kind, payload = heapq.heappop(events)
            if kind == self.ARRIVAL:
                idx = router.route(payload, self.replicas, active=self.active)
                payload.replica = idx
                rep = self.replicas[idx]
                rep.waiting.append(payload)
                schedule_step(rep)
            elif kind == self.STEP_DONE:
                rep = self.replicas[payload]
                if rep.dead:
                    continue      # step of a crashed replica: tokens lost
                rep.step_in_flight = False
                for s, n in rep.in_flight_batch:
                    if s.num_prefilled < s.prompt_len:
                        s.num_prefilled += n
                        if s.num_prefilled >= s.prompt_len:
                            s.num_generated += 1
                            if s.first_token_time is None:
                                s.first_token_time = now
                    else:
                        s.num_generated += 1
                    if (s.num_prefilled >= s.prompt_len
                            and s.num_generated >= s.max_new_tokens
                            and s.finish_time is None):
                        s.finish_time = now
                        rep.running.remove(s)
                        completed += 1
                        # the finish log only feeds autoscaler policies
                        # (AutoscalerView.recent_ttfts); in sink mode it is
                        # pruned to a sliding window — and skipped outright
                        # when nothing will ever read it — to keep memory
                        # flat over million-request streams
                        log_ttfts = (sink is None
                                     or self.autoscaler_policy is not None)
                        if s.ttft() is not None and log_ttfts:
                            self._finish_log.append((now, s.ttft()))
                            if sink is not None:
                                horizon = now - self.finish_log_window_s
                                log = self._finish_log
                                cut = 0
                                while cut < len(log) and log[cut][0] < horizon:
                                    cut += 1
                                if cut:
                                    del log[:cut]
                        if session_workload is not None:
                            fu = session_workload.follow_up(s)
                            if fu is not None:
                                fu_sim = self._to_sim(fu, next(req_counter))
                                if sink is None:
                                    sims.append(fu_sim)
                                heapq.heappush(
                                    events, (fu_sim.arrival_time,
                                             next(counter), self.ARRIVAL,
                                             fu_sim))
                        if sink is not None:
                            sink(s)
                rep.in_flight_batch = []
                schedule_step(rep)
                if (rep.index not in self.active and rep.idle()
                        and rep.drained_at is None):
                    rep.drained_at = now         # drain complete
            elif kind == self.TICK:
                view._now = now
                apply_autoscale(self.autoscaler_policy.decide(view))
                if completed + len(self.failed) < expected:
                    heapq.heappush(events, (now + asc_cfg.interval_s,
                                            next(counter), self.TICK, None))
            elif kind == self.PROVISION:
                provisioning -= 1
                idx = len(self.replicas)
                # payload is the tier chosen at tick time; None clones the
                # last replica's tier (Cluster.add_replica's default)
                tier = payload if payload is not None \
                    else self.replicas[-1].tier
                self.replicas.append(_ReplicaState(
                    idx, added_at=now, tier=tier,
                    predictor=self._tier_predictor(tier)))
                self.active.append(idx)
                if tier is not None:
                    spec = self.tier_specs[tier]
                    router.grow(idx + 1, weight=spec.throughput_factor,
                                cost=spec.cost_per_replica_s)
                else:
                    router.grow(idx + 1)
            elif kind == self.CRASH:
                crash_now(payload.replica, payload, log_kind="crash")
            elif kind == self.STRAGGLE:
                from repro_torch.cluster.faults import SlowdownPredictor
                if payload.replica < len(self.replicas):
                    rep = self.replicas[payload.replica]
                    rep.predictor = SlowdownPredictor(
                        rep.predictor, payload.slowdown)
                self.fault_log.append(("straggle", now, payload.replica,
                                       payload.slowdown))
            elif kind == self.STRAGGLE_END:
                from repro_torch.cluster.faults import SlowdownPredictor
                if payload.replica < len(self.replicas):
                    rep = self.replicas[payload.replica]
                    rep.predictor = SlowdownPredictor.unwrap(rep.predictor)
                self.fault_log.append(("straggle_end", now, payload.replica))
            elif kind == self.RECLAIM:
                # drain notice: victims leave routing now, keep working;
                # whoever is not fully drained at now+notice_s is killed
                victims = [i for i in list(self.active)
                           if self.replicas[i].tier == payload.tier]
                if victims and len(victims) >= len(self.active):
                    victims = victims[1:]   # never reclaim the whole pool
                self.fault_log.append(("reclaim", now, payload.tier,
                                       tuple(victims)))
                for idx in victims:
                    self.active.remove(idx)
                    rep = self.replicas[idx]
                    if rep.idle():
                        rep.drained_at = now
                if victims:
                    heapq.heappush(events, (now + payload.notice_s,
                                            next(counter), self.RECLAIM_KILL,
                                            (payload, victims)))
            elif kind == self.RECLAIM_KILL:
                f_spec, victims = payload
                for idx in victims:
                    crash_now(idx, f_spec, log_kind="reclaim_kill")
            else:  # RESPAWN
                tier, fault_t = payload
                idx = len(self.replicas)
                self.replicas.append(_ReplicaState(
                    idx, added_at=now, tier=tier,
                    predictor=self._tier_predictor(tier)))
                self.active.append(idx)
                if tier is not None:
                    spec = self.tier_specs[tier]
                    router.grow(idx + 1, weight=spec.throughput_factor,
                                cost=spec.cost_per_replica_s)
                else:
                    router.grow(idx + 1)
                self.fault_log.append(("respawn", now, tier, idx))
                self.recoveries.append((fault_t, now))

        return sims
