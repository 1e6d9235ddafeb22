"""Multi-replica cluster emulation: N engines, one virtual timeline.

The cluster runtime is split into a backend-agnostic control plane
(:class:`ClusterBase`: routing, elastic membership, completion fan-out,
cost accounting) and two pluggable **backends** that decide where replica
engines physically run:

* **thread backend** (:class:`Cluster`, this module) — every replica is an
  in-process :class:`~repro.serving.engine.LLMEngine` sharing one
  :class:`~repro.core.clock.VirtualClock` object; Timekeeper fan-in is a
  function call (:class:`~repro.core.client.LocalTransport`).
* **process backend** (:class:`~repro.cluster.process_backend.ProcessCluster`)
  — every replica's engine runs in its own OS process wired to a
  :class:`~repro.core.transport.TimekeeperServer` over the framed-TCP
  protocol, holding a broadcast-driven *replica* clock.  Same engine code,
  same router objects, same runner — only the transport changes.

Each replica is an independent continuous-batching engine (own scheduler,
block pool, radix cache, model runner); the cluster adds the data-parallel
control plane the paper's config-sweep story needs at scale:

* **Routing** — a pluggable :class:`~repro.cluster.router.Router` policy
  places each request (round-robin, least-outstanding-tokens,
  prefix-affinity, or a prefill/decode pool split).
* **One coordinated timeline** — all replicas' actors share one Timekeeper;
  idle replicas *park* (leave the barrier but stay known) so the busy
  subset plus the dispatcher advance the single offset at full speed.
  Causality across replicas is the Timekeeper's minimum-target rule —
  virtual time can never jump past an event another replica still has to
  produce, so cluster-level TTFT/goodput percentiles are exact.
* **PD pools** — with the ``pd_pool`` policy the cluster reuses the
  emulated KV channel from ``repro.core.emulation`` to migrate completed
  prefills into the decode pool, unifying ``repro.serving.disagg`` behind
  the Router interface (thread backend only).

* **Heterogeneous pools** — each replica may run on a different hardware
  *tier* (chip name from ``repro.core.hardware``): its predictor, KV-cache
  capacity, and $/replica-second follow the chip, routing policies see
  per-replica throughput weights and costs, and
  :meth:`ClusterBase.add_replica` accepts a tier so the autoscaler can
  scale into cheaper chips (see ``repro.cluster.tiers``).

The cluster exposes the same non-blocking ``submit`` / ``poll`` /
``wait_until_complete`` surface as a single engine, so
``repro.serving.benchmark.BenchmarkRunner`` drives a 1-replica engine, an
N-replica thread cluster, and an N-process cluster through one code path
(Workload → Cluster → Metrics).

Replica handle protocol (what a backend's replicas must expose)::

    submit(req)                  enqueue; the replica's actors are
                                 registered with the Timekeeper by return
    num_outstanding() -> int     \
    outstanding_tokens() -> int   } ReplicaView probes (router placement)
    prefix_match_len(toks)->int  /
    in_flight_ids() -> set       drain bookkeeping snapshot
    retire()                     leave the Timekeeper permanently (drain)
    start() / stop()             engine lifecycle
    stats() -> dict              per-replica counters
    step_log -> List[StepRecord] step accounting

An in-process :class:`LLMEngine` satisfies it directly; the process backend
satisfies it with an RPC proxy per child process.

Listener invariant (closed-loop workloads build on this): completion
listeners run *before the finishing replica re-enters the barrier* — in the
finishing replica's step thread (thread backend) or in the parent's
completion-frame handler while the child engine blocks on the ack (process
backend) — so any actor a listener registers with the Timekeeper exists
before the next barrier round; virtual time can never jump past work a
completion is about to schedule (§4.3).
"""

from __future__ import annotations

import itertools
import pickle
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.client import LocalTransport, TimeJumpClient
from repro_torch.core.clock import VirtualClock, WallSource
from repro_torch.core.emulation import EmulatedChannel, VirtualDeviceContext
from repro_torch.core.hardware import get_chip
from repro_torch.core.predictor import RuntimePredictor
from repro_torch.core.timekeeper import Timekeeper
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import LLMEngine, StepRecord
from repro_torch.serving.model_runner import SleepModelRunner, TimeWarpModelRunner
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import EngineConfig

from .router import PDPoolRouter, Router, make_router
from .tiers import TierSpec, make_tier_spec, tier_engine_cfg

__all__ = ["ClusterConfig", "ClusterBase", "Cluster", "build_cluster"]


@dataclass
class ClusterConfig:
    kv_link_bandwidth: float = 50e9   # PD pools: inter-replica KV fabric (B/s)
    # Per-replica hardware tiers (chip names); None = homogeneous/untiered.
    # Carried through build_cluster so stats/cost accounting can report the
    # mix; the authoritative per-replica record is ClusterBase.replica_tiers
    # (which keeps growing as the autoscaler adds replicas).
    tiers: Optional[List[Optional[str]]] = None


class ClusterBase:
    """Backend-agnostic cluster control plane over replica handles.

    Subclasses provide replica construction/placement (thread engines or
    process proxies) through :meth:`_new_replica` / :meth:`_attach_replica`;
    everything else — routing, elastic membership, drain bookkeeping,
    completion fan-out, replica-seconds/cost accounting — lives here and is
    byte-identical across backends.
    """

    #: human-readable backend tag (stats/benchmark rows)
    backend = "?"

    def __init__(
        self,
        replicas: Sequence,
        router: Router,
        *,
        clock: VirtualClock,
        transport=None,
        timekeeper: Optional[Timekeeper] = None,
        model_cfg: Optional[ModelConfig] = None,
        cfg: Optional[ClusterConfig] = None,
        replica_factory=None,
        tier_specs: Optional[Dict[str, TierSpec]] = None,
        tier_spec_factory=None,
    ):
        assert replicas, "a cluster needs at least one replica"
        assert router.num_replicas == len(replicas), \
            f"router sized for {router.num_replicas} replicas, got {len(replicas)}"
        self.replicas = list(replicas)
        self.router = router
        self.transport = transport
        self.timekeeper = timekeeper
        self.model_cfg = model_cfg
        # default constructed per-instance: a shared mutable class-level
        # default would alias config state across all clusters
        self.cfg = cfg if cfg is not None else ClusterConfig()
        self.clock: VirtualClock = clock

        self.finished: List[Request] = []
        self._finish_cond = threading.Condition()
        self._poll_cursor = 0
        self._started = False
        # Counter-backed completion accounting: wait_until_complete/stats
        # read this, so audit modes can drop the retained lists without
        # breaking the wait/progress surface.
        self._finished_count = 0
        # Terminally failed requests (crash with on_crash="fail"): they count
        # toward wait_until_complete's expected total but never join
        # ``finished`` — metrics exclude them, the wait surface does not.
        self.failed: List[Request] = []
        self._failed_count = 0
        self._audit = "full"
        self.retain_finished = True
        self.retain_placements = True

        # ---- elastic membership (autoscaling) ----
        # ``active`` = replicas the router may place fresh requests on.
        # ``_membership[i]`` records (added_at, drain_started, drained_at)
        # virtual times; None added_at means "member since cluster start".
        self._replica_factory = replica_factory
        self._membership_lock = threading.RLock()
        # ---- heterogeneous tiers ----
        # replica_tiers[i] is replica i's tier name (None = untiered);
        # tier_specs caches TierSpec per tier name, lazily extended through
        # tier_spec_factory when the autoscaler scales into a new tier.
        self.replica_tiers: List[Optional[str]] = list(
            (self.cfg.tiers or [None] * len(self.replicas)))
        assert len(self.replica_tiers) == len(self.replicas), \
            "need one tier entry per replica"
        self._tier_specs: Dict[str, TierSpec] = dict(tier_specs or {})
        self._tier_spec_factory = tier_spec_factory
        for i, t in enumerate(self.replica_tiers):
            if t is not None:
                spec = self.tier_spec(t)
                self.router.set_tier(i, weight=spec.throughput_factor,
                                     cost=spec.cost_per_replica_s)
        self.active: List[int] = list(range(len(self.replicas)))
        self._membership: Dict[int, dict] = {
            i: {"added": None, "drain_started": None, "drained": None}
            for i in range(len(self.replicas))
        }
        self._draining: Dict[int, set] = {}   # idx -> in-flight request ids
        self._submit_lock = threading.Lock()  # serialises route+submit
        # Placement audit log (parity benchmarks compare it across backends):
        # one (session_id, turn_index, request_id, replica) row per submit,
        # in submit order.
        self.placements: List[Tuple] = []
        # Completion subscribers (closed-loop workloads, autoscaler views);
        # called synchronously before the finishing replica's next barrier
        # participation.
        self.completion_listeners: List = []

    # ------------------------------------------------------------ backend --
    @property
    def engines(self) -> List:
        """The replica handles (in-process engines on the thread backend,
        RPC proxies on the process backend) — same objects as
        :attr:`replicas`, kept under the historical name."""
        return self.replicas

    def _new_replica(self, idx: int, tier: Optional[str]):
        """Build (or activate) replica ``idx`` on ``tier``; backend hook."""
        raise NotImplementedError

    def _attach_replica(self, replica) -> None:
        """Wire the backend's completion path into ``replica``; hook."""
        raise NotImplementedError

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> int:
        """Route and enqueue one request; returns the chosen replica index.

        Non-blocking on the engine side: routing reads racy load/affinity
        probes, the replica submit returns once the request is enqueued AND
        the replica's actors are registered with the Timekeeper (thread
        backend: a synchronous unpark; process backend: the child's
        submit-ack).  Callers may be the benchmark dispatcher *and*
        closed-loop think-time actors, so the route+enqueue pair is
        serialised (router state is not thread-safe)."""
        with self._submit_lock:
            return self._submit_locked(req)

    def _submit_locked(self, req: Request) -> int:
        """Route + enqueue; caller holds ``_submit_lock`` (crash requeues
        reuse this so a batch of re-routes is one atomic decision run)."""
        idx = self.router.route(req, self.replicas, active=self.active)
        if self.retain_placements:
            self.placements.append(
                (req.session_id, req.turn_index, req.request_id, idx))
        self.replicas[idx].submit(req)
        return idx

    def submit_many(self, reqs: Sequence[Request]) -> List[int]:
        return [self.submit(r) for r in reqs]

    # -------------------------------------------------------------- hooks --
    def add_completion_listener(self, fn) -> None:
        """Subscribe ``fn(finished: List[Request])``; runs BEFORE the
        finishing replica's next barrier participation — safe to register
        think-time actors from (closed-loop session re-injection)."""
        self.completion_listeners.append(fn)

    def remove_completion_listener(self, fn) -> None:
        if fn in self.completion_listeners:
            self.completion_listeners.remove(fn)

    # ------------------------------------------------------------- audit --
    @property
    def finished_count(self) -> int:
        """Completions seen so far — valid in every audit mode (the
        ``finished`` list itself is empty under ``sampled``/``off``)."""
        with self._finish_cond:
            return self._finished_count

    def set_audit(self, audit: str) -> None:
        """Select what the cluster retains per request.

        ``"full"`` keeps everything (historical behaviour); ``"sampled"``
        and ``"off"`` drop the per-request ``finished``/``placements``
        lists, the router's decision log, and each replica's step log so
        memory stays flat at million-session scale.  Counter-backed
        accounting (``finished_count``, ``stats()``) keeps working.
        """
        retain = audit == "full"
        self._audit = audit
        self.retain_finished = retain
        self.retain_placements = retain
        if hasattr(self.router, "record_decisions"):
            self.router.record_decisions = retain
        for r in self.replicas:
            if hasattr(r, "set_audit"):
                r.set_audit(audit)

    def _complete(self, finished: List[Request]) -> None:
        """Completion fan-out; the finishing replica is still barred from
        its next barrier round while this runs (step thread on the thread
        backend, pre-ack on the process backend)."""
        with self._finish_cond:
            self._finished_count += len(finished)
            if self.retain_finished:
                self.finished.extend(finished)
            self._finish_cond.notify_all()
        # Unconditional (serialised on _membership_lock inside): an unlocked
        # emptiness pre-check here could race drain_replica's in-flight
        # snapshot and leave a drain that never finalises.
        self._drain_progress(finished)
        for fn in list(self.completion_listeners):
            fn(finished)

    # ------------------------------------------------------------- tiers --
    def tier_spec(self, tier: str) -> TierSpec:
        """The :class:`TierSpec` for ``tier``, computed lazily (and cached)
        through the factory ``build_cluster`` wires — so scaling into a tier
        the initial pool never used still gets consistent weights/costs."""
        spec = self._tier_specs.get(tier)
        if spec is None:
            assert self._tier_spec_factory is not None, \
                f"no spec for tier {tier!r} and no tier_spec_factory"
            spec = self._tier_spec_factory(tier)
            self._tier_specs[tier] = spec
        return spec

    def replica_cost_rate(self, idx: int) -> float:
        """Replica ``idx``'s $/replica-second (0.0 when untiered) — the
        drain-victim rule ranks candidates by it."""
        tier = self.replica_tiers[idx]
        return 0.0 if tier is None else self.tier_spec(tier).cost_per_replica_s

    # --------------------------------------------------- elastic membership --
    def add_replica(self, engine=None, tier: Optional[str] = None) -> int:
        """Scale up: join a new replica to the routing set.

        ``engine`` defaults to one built by the backend (thread: the replica
        factory clones the last replica's config onto the shared
        Timekeeper/transport; process: a warm child process is activated).
        ``tier`` picks the hardware tier of the backend-built replica
        (tier-selecting autoscaling); omitted, the new replica clones the
        last replica's tier.  The join is immediate — provisioning delay is
        the *caller's* job (the Autoscaler models it as a virtual-time jump
        before calling this).  Returns the new index.
        """
        with self._submit_lock, self._membership_lock:
            idx = len(self.replicas)
            if tier is None:
                tier = self.replica_tiers[-1] if engine is None else None
            if engine is None:
                engine = self._new_replica(idx, tier)
            self._attach_replica(engine)
            self.replicas.append(engine)
            self.replica_tiers.append(tier)
            if tier is not None:
                spec = self.tier_spec(tier)
                self.router.grow(idx + 1, weight=spec.throughput_factor,
                                 cost=spec.cost_per_replica_s)
            else:
                self.router.grow(idx + 1)
            self.active.append(idx)
            self._membership[idx] = {"added": self.clock.now(),
                                     "drain_started": None, "drained": None}
            if self._audit != "full" and hasattr(engine, "set_audit"):
                engine.set_audit(self._audit)
            if self._started:
                engine.start()
            return idx

    def drain_replica(self, idx: int) -> None:
        """Scale down: stop routing to replica ``idx``, let its in-flight
        requests finish, then retire it from the Timekeeper (full
        deregistration with an epoch bump — on the process backend this goes
        out as a ``deregister`` frame after the last completion frame).  The
        replica's engine keeps running (parked/retired actors cost nothing
        on the barrier); ``stop()`` reaps it with the rest of the cluster."""
        # _submit_lock first: a concurrent submit must either fully enqueue
        # (and show up in the in-flight snapshot) or route after the removal.
        with self._submit_lock, self._membership_lock:
            if idx not in self.active:
                raise ValueError(f"replica {idx} is not active")
            assert len(self.active) > 1, "cannot drain the last replica"
            self.active.remove(idx)
            self._membership[idx]["drain_started"] = self.clock.now()
            in_flight = set(self.replicas[idx].in_flight_ids())
            if in_flight:
                self._draining[idx] = in_flight
            else:
                self._finalize_drain(idx)

    def _drain_progress(self, finished: List[Request]) -> None:
        """Called from ``_complete`` while drains are open."""
        done_ids = {r.request_id for r in finished}
        with self._membership_lock:
            for idx in list(self._draining):
                self._draining[idx] -= done_ids
                if not self._draining[idx]:
                    del self._draining[idx]
                    self._finalize_drain(idx)

    def _finalize_drain(self, idx: int) -> None:
        """In-flight work done: stamp the membership end and retire the
        replica's worker actors so the Timekeeper forgets them entirely
        (they would otherwise merely park).  Caller holds
        ``_membership_lock``."""
        self._membership[idx]["drained"] = self.clock.now()
        self.replicas[idx].retire()

    # ------------------------------------------------------ fault injection --
    def crash_replica(self, idx: int, *, on_crash: str = "requeue") -> dict:
        """Kill replica ``idx`` *now* (fault injection): KV/prefix state is
        lost, the replica leaves the routing set immediately (not via the
        drain ledger — a dead replica must be invisible to the router and
        the autoscaler's drain-victim rule at once), its cost window closes
        at the crash instant, and every in-flight request is either
        re-routed (``on_crash="requeue"``, progress zeroed, original
        arrival time kept) or terminally failed (``on_crash="fail"``).

        A replica crashing *while already draining* is removed from the
        drain ledger first so it can never be double-finalized nor
        re-picked as a victim; its ``drained`` stamp is the crash time, so
        ``replica_seconds``/``cost_dollars`` bill it exactly once.  The
        last active replica refuses to crash (``crashed=False``) — a
        cluster with no capacity could never finish the run, mirroring the
        drain-side ``len(active) > 1`` invariant.

        Returns ``{"crashed", "requeued", "failed", "tier"}``.
        """
        assert on_crash in ("requeue", "fail"), on_crash
        with self._submit_lock, self._membership_lock:
            tier = self.replica_tiers[idx]
            m = self._membership[idx]
            if m["drained"] is not None:          # already fully gone
                return {"crashed": False, "requeued": 0, "failed": 0,
                        "tier": tier}
            if idx in self.active:
                if len(self.active) <= 1:
                    return {"crashed": False, "requeued": 0, "failed": 0,
                            "tier": tier}
                self.active.remove(idx)
            self._draining.pop(idx, None)         # never finalized twice
            if m["drain_started"] is None:
                m["drain_started"] = self.clock.now()
            m["drained"] = self.clock.now()
        # Kill OUTSIDE the cluster locks: the victim's step thread may be
        # delivering a completion that co-resolved with the fault's barrier
        # round, and that path takes _membership_lock (drain progress) —
        # holding it through the join would deadlock.
        victims = list(self._force_kill(idx))
        victims.sort(key=lambda r: (r.arrival_time, r.request_id))
        requeued = failed = 0
        if on_crash == "requeue":
            with self._submit_lock:
                for req in victims:
                    req.reset_for_requeue()
                    self._submit_locked(req)
            requeued = len(victims)
        else:
            with self._finish_cond:
                self.failed.extend(victims)
                self._failed_count += len(victims)
                self._finish_cond.notify_all()
            failed = len(victims)
        return {"crashed": True, "requeued": requeued, "failed": failed,
                "tier": tier}

    def set_replica_slowdown(self, idx: int, factor: Optional[float]) -> bool:
        """Straggler injection: scale replica ``idx``'s predicted step times
        by ``factor`` (``None`` restores full speed).  Steps whose duration
        was computed before the change keep it — identical semantics to the
        DES, whose in-flight STEP_DONE events are already on the heap."""
        if idx >= len(self.replicas):
            return False
        return self._set_slowdown(idx, factor)

    def _force_kill(self, idx: int) -> List[Request]:
        """Backend hook: destroy replica ``idx`` immediately and return its
        in-flight requests (un-reset)."""
        raise NotImplementedError

    def _set_slowdown(self, idx: int, factor: Optional[float]) -> bool:
        """Backend hook for :meth:`set_replica_slowdown`."""
        raise NotImplementedError

    @property
    def failed_count(self) -> int:
        with self._finish_cond:
            return self._failed_count

    def num_active(self) -> int:
        with self._membership_lock:
            return len(self.active)

    def _membership_windows(self, t_start: float, t_end: float) -> List[float]:
        """Per-replica on-seconds overlapping [t_start, t_end].  A drained
        replica stops accruing at the finish of its last in-flight request;
        an added one starts at its (post-provisioning-delay) join time.
        Caller holds ``_membership_lock``."""
        out = []
        for idx in range(len(self.replicas)):
            m = self._membership[idx]
            a = t_start if m["added"] is None else max(t_start, m["added"])
            drained = m["drained"]
            if drained is None and idx in self._draining:
                drained = t_end          # still draining at window end
            b = t_end if drained is None else min(t_end, drained)
            out.append(max(0.0, b - a))
        return out

    def replica_seconds(self, t_start: float, t_end: float) -> float:
        """Capacity proxy: total replica-on time (virtual seconds)
        overlapping the window [t_start, t_end]."""
        with self._membership_lock:
            return sum(self._membership_windows(t_start, t_end))

    def tier_seconds(self, t_start: float, t_end: float) -> Dict[str, float]:
        """Replica-on seconds per tier name over the window (untiered
        replicas accrue under the key ``None``)."""
        with self._membership_lock:
            windows = self._membership_windows(t_start, t_end)
            out: Dict[str, float] = {}
            for tier, w in zip(self.replica_tiers, windows):
                out[tier] = out.get(tier, 0.0) + w
            return out

    def replica_cost(self, t_start: float, t_end: float) -> float:
        """Dollar cost of the window: each replica's on-seconds × its tier's
        $/replica-second.  Untiered replicas cost $0 (no tier, no price) —
        a fully untiered cluster reports 0.0 and ``replica_seconds`` stays
        the cost proxy."""
        with self._membership_lock:
            windows = self._membership_windows(t_start, t_end)
            total = 0.0
            for tier, w in zip(self.replica_tiers, windows):
                if tier is not None:
                    total += w * self.tier_spec(tier).cost_per_replica_s
            return total

    def membership_events(self) -> List[dict]:
        with self._membership_lock:
            return [{"replica": i, **dict(self._membership[i])}
                    for i in sorted(self._membership)]

    # ---------------------------------------------------------- lifecycle --
    def start(self):
        for r in self.replicas:
            r.start()
        self._started = True
        return self

    def stop(self) -> None:
        for r in self.replicas:
            r.stop()
        self._started = False

    def shutdown(self) -> None:
        self.stop()
        if self.timekeeper is not None:
            self.timekeeper.close()

    @property
    def is_running(self) -> bool:
        return self._started

    # ------------------------------------------------------------ outtake --
    def poll(self) -> List[Request]:
        """Drain cluster-level completions since the previous poll."""
        with self._finish_cond:
            new = self.finished[self._poll_cursor:]
            self._poll_cursor = len(self.finished)
        return list(new)

    def wait_until_complete(self, expected: int, timeout: float = 600.0) -> bool:
        import time as _time
        deadline = _time.monotonic() + timeout
        with self._finish_cond:
            while self._finished_count + self._failed_count < expected:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._finish_cond.wait(timeout=min(remaining, 1.0))
        return True

    # --------------------------------------------------------- aggregates --
    @property
    def step_log(self) -> List[StepRecord]:
        """All replicas' step records (benchmark overhead accounting)."""
        log: List[StepRecord] = []
        for r in self.replicas:
            log.extend(r.step_log)
        return log

    def num_outstanding(self) -> int:
        return sum(r.num_outstanding() for r in self.replicas)

    def outstanding_tokens(self) -> int:
        return sum(r.outstanding_tokens() for r in self.replicas)

    def stats(self) -> dict:
        """Aggregate of per-replica ``stats()`` snapshots."""
        per_replica = [r.stats() for r in self.replicas]
        agg = {
            "backend": self.backend,
            "num_replicas": len(self.replicas),
            "num_active": self.num_active(),
            "membership": self.membership_events(),
            "tiers": list(self.replica_tiers),
            "policy": getattr(self.router, "policy", "?"),
            "finished": self._finished_count,
            "failed": self._failed_count,
            "steps": sum(r["steps"] for r in per_replica),
            "device_time_s": sum(r["device_time_s"] for r in per_replica),
            "cpu_overhead_s": sum(r["cpu_overhead_s"] for r in per_replica),
            "num_preemptions": sum(r["num_preemptions"] for r in per_replica),
            "replicas": per_replica,
            "routing_decisions": list(self.router.decisions),
        }
        if self.timekeeper is not None:
            agg["timekeeper"] = self.timekeeper.stats.as_dict()
        return agg


class Cluster(ClusterBase):
    """Thread backend: N in-process engine replicas sharing one clock object."""

    backend = "thread"

    def __init__(
        self,
        engines: Sequence[LLMEngine],
        router: Router,
        *,
        transport: Optional[LocalTransport] = None,
        timekeeper: Optional[Timekeeper] = None,
        model_cfg: Optional[ModelConfig] = None,
        cfg: Optional[ClusterConfig] = None,
        replica_factory=None,
        tier_specs: Optional[Dict[str, TierSpec]] = None,
        tier_spec_factory=None,
    ):
        assert engines, "a cluster needs at least one replica"
        clock = engines[0].clock
        for e in engines:
            assert e.clock is clock, \
                "all replicas must share one VirtualClock (one timeline)"
        super().__init__(
            engines, router, clock=clock, transport=transport,
            timekeeper=timekeeper, model_cfg=model_cfg, cfg=cfg,
            replica_factory=replica_factory, tier_specs=tier_specs,
            tier_spec_factory=tier_spec_factory)

        self._pd = isinstance(router, PDPoolRouter)
        if self._pd:
            assert model_cfg is not None, \
                "pd_pool routing needs model_cfg for KV-transfer sizing"
            self.channel = EmulatedChannel(self.cfg.kv_link_bandwidth,
                                           name="kv-transfer")
            self._mover_ids = itertools.count()
            self._movers: List[threading.Thread] = []
            for i in router.prefill_indices:
                self.replicas[i].on_finish = self._pd_handoff
            for i in router.decode_indices:
                self.replicas[i].on_finish = self._complete
        else:
            for e in self.replicas:
                e.on_finish = self._complete

    # ------------------------------------------------------------ backend --
    def _new_replica(self, idx: int, tier: Optional[str]) -> LLMEngine:
        assert self._replica_factory is not None, \
            "no replica factory: pass an engine explicitly"
        # factory contract: (index, tier) -> LLMEngine, tier None
        # meaning "whatever the config declares for this index"
        engine = self._replica_factory(idx, tier)
        return engine

    def _attach_replica(self, engine: LLMEngine) -> None:
        assert engine.clock is self.clock, \
            "new replica must share the cluster's clock"
        engine.on_finish = self._complete

    def _force_kill(self, idx: int) -> List[Request]:
        return self.replicas[idx].force_kill()

    def _set_slowdown(self, idx: int, factor: Optional[float]) -> bool:
        from repro_torch.cluster.faults import SlowdownPredictor
        runner = self.replicas[idx].runner
        base = SlowdownPredictor.unwrap(runner.predictor)
        if factor is None:
            runner.predictor = base
        else:
            runner.predictor = SlowdownPredictor(base, factor)
        return True

    def crash_replica(self, idx: int, *, on_crash: str = "requeue") -> dict:
        assert not self._pd, "fault injection is not supported for pd_pool"
        return super().crash_replica(idx, on_crash=on_crash)

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> int:
        if self._pd:
            req._disagg_total_new = req.max_new_tokens      # stash for decode
            req.max_new_tokens = 1
        return super().submit(req)

    # --------------------------------------------------- elastic membership --
    def add_replica(self, engine: Optional[LLMEngine] = None,
                    tier: Optional[str] = None) -> int:
        assert not self._pd, "elastic membership is not supported for pd_pool"
        return super().add_replica(engine, tier)

    def drain_replica(self, idx: int) -> None:
        assert not self._pd, "elastic membership is not supported for pd_pool"
        super().drain_replica(idx)

    # ----------------------------------------------------------- pd pools --
    def _pd_handoff(self, finished: List[Request]) -> None:
        """Prefill completed: emulate the KV migration, then place the
        request in the decode pool.  Runs synchronously in the prefill
        replica's step thread — the KV-mover actor registers with the
        Timekeeper *before* that replica can re-enter the barrier, so
        virtual time cannot advance past the transfer's arrival (§4.3)."""
        now = self.clock.now()
        for req in finished:
            kv_bytes = req.context_len * self.model_cfg.kv_bytes_per_token()
            t_visible = self.channel.send(req, now, kv_bytes)
            mover: Optional[TimeJumpClient] = None
            if self.transport is not None:
                mover = TimeJumpClient(
                    self.transport, f"kv-mover-{next(self._mover_ids)}")
            t = threading.Thread(
                target=self._pd_transfer, args=(req, t_visible, mover),
                name="kv-mover", daemon=True)
            t.start()
            self._movers.append(t)

    def _pd_transfer(self, req: Request, t_visible: float,
                     mover: Optional[TimeJumpClient]) -> None:
        try:
            if mover is not None:
                mover.jump_to(t_visible)        # occupy the transfer duration
            req.kv_transfer_time = (t_visible - req.finish_time
                                    if req.finish_time is not None else 0.0)
            # Re-arm for the decode stage: KV arrives whole; the first
            # generated token becomes the last prompt token.
            first_token = req.output_tokens[0] if req.output_tokens else 0
            req.max_new_tokens = max(req._disagg_total_new - 1, 1)
            req.prompt_tokens = list(req.prompt_tokens) + [first_token]
            req.output_tokens = []
            req.num_prefilled = 0
            req.cached_prefix_len = 0
            req.state = RequestState.WAITING
            req.finish_time = None
            req.kv_migrated = True
            with self._submit_lock:
                idx = self.router.route_decode(req, self.replicas,
                                               active=self.active)
                self.replicas[idx].submit(req)
        finally:
            if mover is not None:
                mover.deregister()

    # ---------------------------------------------------------- lifecycle --
    def stop(self) -> None:
        super().stop()
        if self._pd:
            for t in self._movers:
                t.join(timeout=5)

    # ---------------------------------------------------- fault tolerance --
    def snapshot(self) -> bytes:
        """Cluster checkpoint: every replica's deterministic between-steps
        snapshot plus the router's placement state.  (PD pools: requests
        inside an in-flight KV transfer belong to no replica and are not
        captured — checkpoint quiescent clusters or non-PD policies.)"""
        blobs = [e.snapshot() for e in self.replicas]
        router_state = {
            "policy": getattr(self.router, "policy", None),
            "decisions": list(self.router.decisions),
            "sticky": dict(getattr(self.router, "_sticky", {})),
        }
        return pickle.dumps({"replicas": blobs, "router": router_state})


# =========================================================================
# factory
# =========================================================================

def build_cluster(
    model_cfg: ModelConfig,
    engine_cfg: Union[EngineConfig, Sequence[EngineConfig]],
    num_replicas: int,
    *,
    policy: str = "round_robin",
    mode: str = "emulate",
    backend: str = "thread",
    predictor: Optional[RuntimePredictor] = None,
    tiers: Optional[Union[str, Sequence[str]]] = None,
    tier_predictors: Optional[Dict[str, RuntimePredictor]] = None,
    tier_specs: Optional[Dict[str, TierSpec]] = None,
    jitter_cooldown: float = 0.0,
    kv_link_bandwidth: float = 50e9,
    wall: Optional[WallSource] = None,
    router_kwargs: Optional[dict] = None,
    warm_replicas: Optional[int] = None,
    name: str = "cluster",
    transport: str = "tcp",
):
    """Wire N replica engines onto one shared Timekeeper + router.

    ``backend`` picks where replicas run: ``"thread"`` (default) keeps every
    engine in this process on a directly shared clock; ``"process"`` runs
    each replica engine in its own OS process wired to the parent's
    Timekeeper server (``warm_replicas`` pre-spawns standby processes the
    autoscaler can activate without paying process-start wall time mid-run;
    emulate mode only, and ``wall`` must stay host-shared, i.e. None).
    ``transport`` picks the process backend's wire — ``"tcp"`` (framed
    sockets) or ``"shm"`` (shared-memory rings + seqlock clock word,
    :mod:`repro.core.shm_transport`); the thread backend, which has no
    wire, ignores it.

    ``engine_cfg`` may be a single config (homogeneous replicas) or one per
    replica (heterogeneous — e.g. differently-sized prefill/decode pools).
    ``tiers`` makes the pool hardware-heterogeneous: a chip/tier name per
    replica (or one name for all) — each replica's config is re-derived for
    its chip (``chip`` field + KV capacity via
    :func:`~repro.cluster.tiers.tier_engine_cfg`), its predictor follows the
    chip, and routing/autoscaling see per-tier throughput weights and
    $/replica-second.  ``tier_predictors`` overrides the predictor per tier
    (benchmarks inject StaticPredictors); ``tier_specs`` injects
    pre-computed :class:`TierSpec` objects so an experiment can share the
    exact same tier arithmetic with the DES baseline.
    ``wall`` injects a deterministic wall source for reproducibility tests.
    ``mode`` is "emulate" (time-warp, the default) or "sleep" (strawman).
    """
    from repro_torch.serving.stack import default_predictor

    cfgs = ([engine_cfg] * num_replicas
            if isinstance(engine_cfg, EngineConfig) else list(engine_cfg))
    assert len(cfgs) == num_replicas, \
        f"need {num_replicas} engine configs, got {len(cfgs)}"
    if isinstance(tiers, str):
        tiers = [tiers] * num_replicas
    tiers = list(tiers) if tiers is not None else None
    if tiers is not None:
        assert len(tiers) == num_replicas, \
            f"need {num_replicas} tier names, got {len(tiers)}"

    router = make_router(policy, num_replicas, **(router_kwargs or {}))

    def resolve_cfg(i: int, tier: Optional[str]) -> EngineConfig:
        # autoscale-added replicas (i >= num_replicas) clone the last
        # declared config; a tier re-derives chip + KV capacity
        cfg = cfgs[min(i, len(cfgs) - 1)]
        return cfg if tier is None else tier_engine_cfg(cfg, tier, model_cfg)

    def resolve_pred(cfg: EngineConfig,
                     tier: Optional[str]) -> RuntimePredictor:
        if tier is not None and tier_predictors and tier in tier_predictors:
            return tier_predictors[tier]
        return predictor or default_predictor(model_cfg, cfg)

    def default_tier(i: int) -> Optional[str]:
        return None if tiers is None else tiers[min(i, len(tiers) - 1)]

    def spec_factory(tier: str) -> TierSpec:
        # base config: the first replica declared on this tier (so a
        # heterogeneous engine_cfg list yields specs matching the replicas
        # that actually run the tier); unknown tiers — autoscaler candidates
        # the initial pool never used — clone the last declared config
        base = cfgs[-1]
        if tiers is not None and tier in tiers:
            base = cfgs[min(tiers.index(tier), len(cfgs) - 1)]
        cfg = tier_engine_cfg(base, tier, model_cfg)
        return make_tier_spec(tier, cfg, predictor=resolve_pred(cfg, tier))

    cluster_cfg = ClusterConfig(kv_link_bandwidth=kv_link_bandwidth,
                                tiers=tiers)

    if backend == "process":
        from .process_backend import build_process_cluster

        assert mode == "emulate", \
            "the process backend is emulate-only (sleep/real stay in-process)"
        assert wall is None, (
            "the process backend shares the host wall clock (time.time) "
            "across processes; a custom wall source cannot cross them")
        assert policy != "pd_pool", \
            "pd_pool routing is not supported on the process backend"
        return build_process_cluster(
            model_cfg=model_cfg, router=router, num_replicas=num_replicas,
            resolve_cfg=resolve_cfg, resolve_pred=resolve_pred,
            default_tier=default_tier, cluster_cfg=cluster_cfg,
            tier_specs=tier_specs, tier_spec_factory=spec_factory,
            jitter_cooldown=jitter_cooldown,
            warm_replicas=warm_replicas, name=name, transport=transport)

    assert backend == "thread", \
        f"unknown cluster backend {backend!r} (thread | process)"
    assert warm_replicas is None, \
        "warm_replicas only applies to the process backend"

    if mode == "emulate":
        tk = Timekeeper(clock=VirtualClock(wall), jitter_cooldown=jitter_cooldown)
        transport = LocalTransport(tk)

        def make_engine(i: int, tier: Optional[str] = None) -> LLMEngine:
            tier = tier if tier is not None else default_tier(i)
            cfg = resolve_cfg(i, tier)
            pred = resolve_pred(cfg, tier)
            chip = get_chip(cfg.chip)
            n_dev = cfg.tp * cfg.pp
            devices = VirtualDeviceContext(n_dev, chip)
            kv_pool = int(cfg.num_blocks * cfg.block_size
                          * model_cfg.kv_bytes_per_token())
            weights = model_cfg.param_count() * model_cfg.dtype_bytes
            client = TimeJumpClient(transport, f"{name}-r{i}-worker")
            runner = TimeWarpModelRunner(
                pred, client, devices=devices,
                weight_bytes=weights, kv_pool_bytes=kv_pool)
            return LLMEngine(cfg, runner, tk.clock, name=f"{name}-r{i}")

        engines = [make_engine(i) for i in range(num_replicas)]
        return Cluster(engines, router, transport=transport, timekeeper=tk,
                       model_cfg=model_cfg, cfg=cluster_cfg,
                       replica_factory=make_engine,
                       tier_specs=tier_specs, tier_spec_factory=spec_factory)

    if mode == "sleep":
        clock = VirtualClock(wall)

        def make_engine(i: int, tier: Optional[str] = None) -> LLMEngine:
            tier = tier if tier is not None else default_tier(i)
            cfg = resolve_cfg(i, tier)
            runner = SleepModelRunner(resolve_pred(cfg, tier), clock)
            return LLMEngine(cfg, runner, clock, name=f"{name}-r{i}")

        engines = [make_engine(i) for i in range(num_replicas)]
        return Cluster(engines, router, model_cfg=model_cfg, cfg=cluster_cfg,
                       replica_factory=make_engine,
                       tier_specs=tier_specs, tier_spec_factory=spec_factory)

    raise ValueError(f"unknown cluster mode {mode!r} (emulate | sleep)")
