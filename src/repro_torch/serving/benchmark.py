"""Benchmark pipeline: Workload → Cluster → Metrics (paper Fig. 4, scaled).

The runner is decoupled from any one engine: it drives a *target* — a single
:class:`~repro.serving.engine.LLMEngine` or an N-replica
:class:`~repro.cluster.Cluster` — through the uniform non-blocking surface
both expose (``submit`` / ``wait_until_complete`` / ``finished`` /
``step_log`` / ``clock``).  Dataflow:

    Workload (synthesize/replay/sessions)  →  dispatcher (Actor: time-jumps
    to each arrival, routes via the target's submit)  →  target replicas
    (engines stepping on the shared virtual clock)  →  Metrics (Observer:
    TTFT/TPOT/e2e/goodput/SLO-attainment percentiles, per-session stats,
    replica-seconds).

The **request dispatcher is an Actor**: between arrivals it jumps virtual
time to the next dispatch timestamp instead of sleeping.  The **metrics
collector is an Observer**: completion timestamps are read from the shared
virtual clock without participating in barriers.  In real/sleep modes the
dispatcher degrades transparently: with no Timekeeper attached it
wall-sleeps to each arrival (the exact strawman behaviour), so one code
path drives all modes and all cluster sizes.

Closed loop: given a :class:`~repro.workload.session.SessionWorkload`, the
runner registers a completion listener on the target; each finished turn
re-injects its follow-up (carrying the prior turn's tokens) through a
*think-time actor* — a short-lived Timekeeper client registered
synchronously in the finishing replica's step thread (before its next
barrier round, the §4.3 trick), which jumps to ``finish + think`` and
submits.  Virtual time therefore can never skip over a pending follow-up,
even while the open-loop dispatcher is mid-jump toward a far-future arrival.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from operator import attrgetter
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.client import TimeJumpClient
from repro_torch.core.clock import VirtualClock
# LatencyStats and compare_distributions moved to repro.metrics (the
# O(1)-memory scale path); re-exported here for backwards compatibility.
from repro_torch.metrics import (LatencyStats, StreamingMetrics,
                           compare_distributions)

from .request import Request

__all__ = ["LatencyStats", "BenchmarkResult", "BenchmarkRunner",
           "run_pipeline", "compare_distributions"]

AUDIT_MODES = ("full", "sampled", "off")


@dataclass
class BenchmarkResult:
    ttft: LatencyStats
    tpot: LatencyStats
    e2e: LatencyStats
    makespan_virtual: float
    wall_seconds: float
    num_requests: int
    throughput_tokens_per_s: float
    engine_cpu_overhead: float
    engine_device_time: float
    num_replicas: int = 1
    per_replica: List[dict] = field(repr=False, default_factory=list)
    routing_policy: Optional[str] = None
    # (ttft, tpot) per completed request; tpot is None for 1-token outputs.
    # audit="full": every request.  audit="sampled": a seeded uniform
    # reservoir — num_slo_samples keeps the exact observation count so
    # goodput stays unbiased.  audit="off": empty.
    slo_samples: List[tuple] = field(repr=False, default_factory=list)
    num_slo_samples: int = 0
    audit: str = "full"
    # cost proxy: total replica-on virtual seconds across the run window
    # (elastic membership: drained replicas stop accruing, added ones start
    # at their join time; fixed clusters: num_replicas * makespan)
    replica_seconds: float = 0.0
    # heterogeneous pools: replica-on seconds per hardware tier over the run
    # window, and their dollar cost (per-tier $/replica-second from the
    # ChipSpec).  0.0 / None when the target is untiered.
    cost_dollars: float = 0.0
    tier_seconds: Optional[Dict[str, float]] = None
    # closed-loop session stats (None for open-loop workloads): percentiles
    # over *per-session mean* TTFT / TPOT — the chat-level experience
    num_sessions: int = 0
    session_ttft: Optional[LatencyStats] = None
    session_tpot: Optional[LatencyStats] = None

    @property
    def speedup(self) -> float:
        """Virtual seconds simulated per wall second."""
        return self.makespan_virtual / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def request_rate_completed(self) -> float:
        """Completed requests per virtual second (cluster throughput)."""
        return (self.num_requests / self.makespan_virtual
                if self.makespan_virtual else 0.0)

    def slo_attainment(self, slo_ttft_s: float = float("inf"),
                       slo_tpot_s: float = float("inf")) -> float:
        """Fraction of completed requests meeting both SLOs.  A request with
        no TPOT sample (single-token output) is judged on TTFT alone."""
        if not self.slo_samples:
            return 0.0
        good = 0
        for ttft, tpot in self.slo_samples:
            ttft_ok = ttft is None or ttft <= slo_ttft_s
            tpot_ok = tpot is None or tpot <= slo_tpot_s
            good += int(ttft_ok and tpot_ok)
        return good / len(self.slo_samples)

    def goodput_rps(self, slo_ttft_s: float = float("inf"),
                    slo_tpot_s: float = float("inf")) -> float:
        """SLO-attaining completions per virtual second (DistServe-style).

        Under ``audit="sampled"`` the attainment fraction comes from the
        reservoir but is scaled by the *exact* completion count, so goodput
        carries no subsampling bias in its magnitude."""
        if not self.makespan_virtual:
            return 0.0
        n = self.num_slo_samples or len(self.slo_samples)
        return (self.slo_attainment(slo_ttft_s, slo_tpot_s)
                * n / self.makespan_virtual)

    def summary(self) -> dict:
        out = {
            "num_requests": self.num_requests,
            "ttft_p50_ms": self.ttft.p50 * 1e3,
            "ttft_p90_ms": self.ttft.p90 * 1e3,
            "ttft_p99_ms": self.ttft.p99 * 1e3,
            "tpot_p50_ms": self.tpot.p50 * 1e3,
            "tpot_p90_ms": self.tpot.p90 * 1e3,
            "e2e_p50_s": self.e2e.p50,
            "makespan_virtual_s": self.makespan_virtual,
            "wall_s": self.wall_seconds,
            "speedup_x": self.speedup,
            "throughput_tok_s": self.throughput_tokens_per_s,
            "completed_rps": self.request_rate_completed,
            "replica_seconds": self.replica_seconds,
        }
        if self.num_replicas > 1:
            out["num_replicas"] = self.num_replicas
            out["routing_policy"] = self.routing_policy
        if self.cost_dollars:
            out["cost_dollars"] = self.cost_dollars
        if self.num_sessions:
            out["num_sessions"] = self.num_sessions
            out["session_ttft_p50_ms"] = self.session_ttft.p50 * 1e3
            out["session_ttft_p99_ms"] = self.session_ttft.p99 * 1e3
        return out


def _is_started(target) -> bool:
    """Engine, cluster, and the disagg facade all expose ``is_running``."""
    return bool(getattr(target, "is_running", False))


def _declared_count(workload) -> Optional[int]:
    """A workload's self-declared request count, if it declares one."""
    for attr in ("total_requests", "expected"):
        n = getattr(workload, attr, None)
        if n is not None:
            return int(n)
    return None


def _num_finished(target) -> int:
    """Completion count without touching retained lists (audit != full
    keeps a counter, not the requests)."""
    n = getattr(target, "finished_count", None)
    if n is not None:
        return int(n)
    return len(target.finished)


class BenchmarkRunner:
    """Drive a request stream (open- or closed-loop) through an engine or a
    cluster.

    ``workload`` is one of:

    - a list of :class:`Request` (open loop, eagerly materialized — sorted
      here, exactly the historical behavior);
    - a :class:`~repro.workload.session.SessionWorkload` /
      :class:`~repro.workload.streaming.StreamingSessionWorkload` (closed
      loop: follow-up turns are released on completion + think time);
    - a lazy arrival-sorted request stream — e.g.
      :class:`~repro.workload.streaming.StreamingWorkload` — or a list of
      several such streams, which the dispatcher heap-merges on
      ``arrival_time`` without materializing any of them.

    Streaming workloads must declare how many requests the run waits for:
    either the workload exposes ``expected`` / ``total_requests`` or the
    caller passes ``expected=N`` — there is no ``len(requests)`` fallback
    to fall back on.

    ``audit`` bounds result memory: ``"full"`` (default) retains every
    finished request on the target and builds metrics from the raw lists;
    ``"sampled"`` keeps O(1) sketches + a seeded SLO reservoir and tells
    the target to drop per-request retention (``set_audit``); ``"off"``
    additionally drops the reservoir.  Percentiles under sampled/off are
    bit-identical to full below the sketch's exact cap (~2k samples) and
    carry ±0.5% rank error beyond.

    ``target`` needs only the uniform replica surface: ``submit``,
    ``start``/``stop``, ``wait_until_complete``, ``finished``,
    ``step_log``, and a ``clock`` attribute — plus
    ``add_completion_listener`` for closed-loop or audited runs.

    ``autoscaler`` (optional, cluster targets): started/stopped with the
    run; its membership changes are reflected in ``replica_seconds``.
    """

    def __init__(
        self,
        target,
        workload,
        *,
        transport=None,              # Timekeeper transport (emulate mode)
        autoscaler=None,             # repro.cluster.autoscaler.Autoscaler
        fault_injector=None,         # repro.cluster.faults.FaultInjector
        name: str = "bench",
        expected: Optional[int] = None,   # streaming: declared request count
        audit: str = "full",
        metrics_seed: int = 0,       # reservoir seed (audit="sampled")
        slo_reservoir: int = 8192,
    ):
        if audit not in AUDIT_MODES:
            raise ValueError(f"audit must be one of {AUDIT_MODES}, "
                             f"got {audit!r}")
        self.target = target
        self.engine = target         # backwards-compatible alias
        self.audit = audit
        self.session_workload = None
        self.requests: Optional[List[Request]] = None
        declared = expected

        if hasattr(workload, "initial_stream"):
            # streaming closed loop: turn-0 requests arrive lazily
            self.session_workload = workload
            streams = [workload.initial_stream()]
            if declared is None:
                declared = workload.total_requests
        elif hasattr(workload, "initial_requests"):
            # eager closed loop (historical behavior, list retained)
            self.session_workload = workload
            self.requests = sorted(workload.initial_requests(),
                                   key=lambda r: r.arrival_time)
            streams = [iter(self.requests)]
            if declared is None:
                declared = workload.total_requests
        elif (isinstance(workload, (list, tuple)) and workload
              and not hasattr(workload[0], "arrival_time")):
            # several arrival-sorted streams: heap-merge below
            streams = [iter(s) for s in workload]
            if declared is None:
                counts = [_declared_count(s) for s in workload]
                if all(c is not None for c in counts):
                    declared = sum(counts)
        elif isinstance(workload, (list, tuple)):
            # eager open loop (historical behavior, list retained + sorted)
            self.requests = sorted(workload, key=lambda r: r.arrival_time)
            streams = [iter(self.requests)]
            if declared is None:
                declared = len(self.requests)
        else:
            # one lazy arrival-sorted stream
            streams = [iter(workload)]
            if declared is None:
                declared = _declared_count(workload)

        if declared is None:
            raise ValueError(
                "streaming workload with no declared request count: the "
                "runner cannot fall back to len(requests) without "
                "materializing the stream.  Pass expected=N to "
                "BenchmarkRunner, or use a workload that exposes "
                "`.expected` / `.total_requests` (e.g. "
                "repro.workload.StreamingWorkload)")
        self.expected = int(declared)
        # the dispatcher pulls from one heap-merged stream; each source must
        # be individually sorted by arrival_time (all synthesizers are)
        self._stream = (streams[0] if len(streams) == 1
                        else heapq.merge(*streams,
                                         key=attrgetter("arrival_time")))
        self.transport = transport
        self.autoscaler = autoscaler
        self.fault_injector = fault_injector
        self.name = name
        self.clock: VirtualClock = target.clock
        self._think_ids = itertools.count()
        self._thinkers: List[threading.Thread] = []
        self._metrics: Optional[StreamingMetrics] = None
        if self.audit != "full":
            self._metrics = StreamingMetrics(
                slo_reservoir=slo_reservoir, seed=metrics_seed,
                session_turns=getattr(self.session_workload,
                                      "session_turns", None))

    # ---------------------------------------------------------- dispatch --
    def _dispatch_loop(self, client: Optional[TimeJumpClient]) -> None:
        t0 = self.clock.now()
        try:
            for req in self._stream:
                target_t = t0 + req.arrival_time
                if client is not None:
                    client.jump_to(target_t)      # Actor: jump, don't sleep
                else:
                    dt = target_t - self.clock.now()
                    if dt > 0:
                        self.clock.wall.sleep(dt)  # real/sleep modes
                req.arrival_time = self.clock.now()
                self.target.submit(req)
        finally:
            if client is not None:
                client.deregister()

    # -------------------------------------------------------- closed loop --
    def _on_complete(self, finished: List[Request]) -> None:
        """Completion listener: runs in the finishing replica's step thread,
        before its next barrier round.  Registering the think-time actor
        *here* is what makes the re-injection race-free: the barrier cannot
        advance past ``finish + think`` before the new actor's jump request
        is pending (§4.3)."""
        for req in finished:
            fu = self.session_workload.follow_up(req)
            if fu is None:
                continue
            client: Optional[TimeJumpClient] = None
            if self.transport is not None:
                client = TimeJumpClient(
                    self.transport,
                    f"{self.name}-think-{next(self._think_ids)}")
            t = threading.Thread(
                target=self._think_and_submit, args=(fu, client),
                name=f"{self.name}-think", daemon=True)
            t.start()
            # drop joined thinkers so the list tracks *live* actors, not
            # every follow-up ever released (a million-turn run would
            # otherwise accumulate a million dead Thread objects)
            if len(self._thinkers) > 64:
                self._thinkers = [th for th in self._thinkers
                                  if th.is_alive()]
            self._thinkers.append(t)

    # ------------------------------------------------------ audited runs --
    def _observe_completions(self, finished: List[Request]) -> None:
        """Completion listener (audit != "full"): fold each finished request
        into the streaming accumulators; nothing is retained."""
        for req in finished:
            self._metrics.observe(req)

    def _think_and_submit(self, fu: Request,
                          client: Optional[TimeJumpClient]) -> None:
        try:
            if client is not None:
                client.jump_to(fu.arrival_time)
            else:
                dt = fu.arrival_time - self.clock.now()
                if dt > 0:
                    self.clock.wall.sleep(dt)
            fu.arrival_time = self.clock.now()
            self.target.submit(fu)
        finally:
            if client is not None:
                client.deregister()

    # --------------------------------------------------------------- run --
    def run(self, timeout: float = 600.0) -> BenchmarkResult:
        wall0 = time.monotonic()
        v0 = self.clock.now()
        listener_armed = False
        if self.session_workload is not None:
            self.target.add_completion_listener(self._on_complete)
            listener_armed = True
        metrics_armed = False
        if self._metrics is not None:
            # bounded-audit mode: metrics accumulate per completion and the
            # target stops retaining per-request state
            if hasattr(self.target, "set_audit"):
                self.target.set_audit(self.audit)
            self.target.add_completion_listener(self._observe_completions)
            metrics_armed = True
        # The dispatcher's actor is registered HERE, before the autoscaler's
        # tick actor can start jumping: were the autoscaler briefly the only
        # registered actor, its ticks would free-run virtual time far ahead
        # of the first arrival (barrier rounds resolve instantly for a lone
        # actor) and shift the whole timeline.
        disp_client: Optional[TimeJumpClient] = None
        if self.transport is not None:
            disp_client = TimeJumpClient(self.transport,
                                         f"{self.name}-dispatcher")
        # Same anchoring rule for the chaos schedule: arm (register) the
        # injector's actor before any other actor can move virtual time, so
        # fault times measure from the run's origin.
        if self.fault_injector is not None:
            self.fault_injector.arm()
        dispatcher = threading.Thread(
            target=self._dispatch_loop, args=(disp_client,),
            name=f"{self.name}-dispatch", daemon=True)
        started_here = False
        if not _is_started(self.target):
            self.target.start()
            started_here = True
        if self.autoscaler is not None:
            self.autoscaler.start()
        if self.fault_injector is not None:
            self.fault_injector.start()
        dispatcher.start()
        try:
            ok = self.target.wait_until_complete(self.expected, timeout=timeout)
            if ok and self.fault_injector is not None:
                # trailing schedule entries (after the last completion) must
                # apply deterministically, not race teardown — the DES drains
                # its heap unconditionally and the fault logs are compared
                self.fault_injector.join()
        finally:
            if self.fault_injector is not None:
                self.fault_injector.stop()
            if self.autoscaler is not None:
                self.autoscaler.stop()
            if listener_armed:
                self.target.remove_completion_listener(self._on_complete)
        dispatcher.join(timeout=10)
        for t in self._thinkers:
            t.join(timeout=10)
        if metrics_armed:
            self.target.remove_completion_listener(
                self._observe_completions)
        wall = time.monotonic() - wall0
        v1 = self.clock.now()
        if started_here:
            self.target.stop()
        if not ok:
            raise TimeoutError(
                f"benchmark timed out: {_num_finished(self.target)}/"
                f"{self.expected} finished")
        if self._metrics is not None:
            return self._collect_streaming(wall, v0, v1)
        return self._collect(wall, v0, v1)

    def _collect(self, wall: float, v0: float, v1: float) -> BenchmarkResult:
        reqs = self.target.finished
        # Makespan ends at the last completion, not at teardown: trailing
        # autoscaler ticks (which keep jumping the clock after the final
        # finish) must not leak into throughput/goodput denominators.
        finishes = [r.finish_time for r in reqs if r.finish_time is not None]
        v_end = max(finishes) if finishes else v1
        makespan = v_end - v0
        ttft = LatencyStats.of([r.ttft() for r in reqs if r.ttft() is not None])
        tpot = LatencyStats.of([r.tpot() for r in reqs
                                if r.tpot() is not None and r.num_generated > 1])
        e2e = LatencyStats.of([r.e2e_latency() for r in reqs
                               if r.e2e_latency() is not None])
        total_tokens = sum(r.num_generated for r in reqs)
        step_log = self.target.step_log
        cpu = sum(s.cpu_overhead_wall for s in step_log)
        dev = sum(s.device_time for s in step_log)
        engines = getattr(self.target, "engines", None)
        if hasattr(self.target, "replica_seconds"):
            replica_s = self.target.replica_seconds(v0, v_end)
        else:
            replica_s = makespan            # a single engine, always on
        cost = tier_s = None
        if hasattr(self.target, "replica_cost"):
            cost = self.target.replica_cost(v0, v_end)
        if hasattr(self.target, "tier_seconds"):
            tier_s = self.target.tier_seconds(v0, v_end)
        by_session: Dict[int, List[Request]] = defaultdict(list)
        for r in reqs:
            if r.session_id is not None:
                by_session[r.session_id].append(r)
        session_ttft = session_tpot = None
        if by_session:
            mean_ttfts, mean_tpots = [], []
            for rs in by_session.values():
                ts = [r.ttft() for r in rs if r.ttft() is not None]
                ps = [r.tpot() for r in rs
                      if r.tpot() is not None and r.num_generated > 1]
                if ts:
                    mean_ttfts.append(float(np.mean(ts)))
                if ps:
                    mean_tpots.append(float(np.mean(ps)))
            session_ttft = LatencyStats.of(mean_ttfts)
            session_tpot = LatencyStats.of(mean_tpots)
        return BenchmarkResult(
            ttft=ttft, tpot=tpot, e2e=e2e,
            makespan_virtual=makespan,
            wall_seconds=wall,
            num_requests=len(reqs),
            throughput_tokens_per_s=total_tokens / makespan if makespan else 0.0,
            engine_cpu_overhead=cpu,
            engine_device_time=dev,
            num_replicas=len(engines) if engines else 1,
            per_replica=([e.stats() for e in engines] if engines else []),
            routing_policy=getattr(
                getattr(self.target, "router", None), "policy", None),
            slo_samples=[
                (r.ttft(),
                 r.tpot() if r.num_generated > 1 else None)
                for r in reqs
            ],
            replica_seconds=replica_s,
            cost_dollars=cost or 0.0,
            tier_seconds=tier_s,
            num_sessions=len(by_session),
            session_ttft=session_ttft,
            session_tpot=session_tpot,
        )

    def _collect_streaming(self, wall: float, v0: float,
                           v1: float) -> BenchmarkResult:
        """Build the result from the streaming accumulators: no walk over
        ``target.finished`` (which audit != "full" does not retain)."""
        m = self._metrics
        m.finalize()
        v_end = m.max_finish if m.max_finish is not None else v1
        makespan = v_end - v0
        stats = self.target.stats() if hasattr(self.target, "stats") else {}
        cpu = float(stats.get("cpu_overhead_s", 0.0))
        dev = float(stats.get("device_time_s", 0.0))
        engines = getattr(self.target, "engines", None)
        if hasattr(self.target, "replica_seconds"):
            replica_s = self.target.replica_seconds(v0, v_end)
        else:
            replica_s = makespan
        cost = tier_s = None
        if hasattr(self.target, "replica_cost"):
            cost = self.target.replica_cost(v0, v_end)
        if hasattr(self.target, "tier_seconds"):
            tier_s = self.target.tier_seconds(v0, v_end)
        has_sessions = self.session_workload is not None
        return BenchmarkResult(
            ttft=m.ttft.stats(), tpot=m.tpot.stats(), e2e=m.e2e.stats(),
            makespan_virtual=makespan,
            wall_seconds=wall,
            num_requests=m.count,
            throughput_tokens_per_s=(m.total_new_tokens / makespan
                                     if makespan else 0.0),
            engine_cpu_overhead=cpu,
            engine_device_time=dev,
            num_replicas=len(engines) if engines else 1,
            per_replica=([e.stats() for e in engines] if engines else []),
            routing_policy=getattr(
                getattr(self.target, "router", None), "policy", None),
            slo_samples=([] if self.audit == "off"
                         else list(m.slo.items)),
            num_slo_samples=m.num_slo_samples,
            audit=self.audit,
            replica_seconds=replica_s,
            cost_dollars=cost or 0.0,
            tier_seconds=tier_s,
            num_sessions=m.num_sessions if has_sessions else 0,
            session_ttft=m.session_ttft.stats() if has_sessions else None,
            session_tpot=m.session_tpot.stats() if has_sessions else None,
        )


def run_pipeline(workload_cfg, target, *, transport=None,
                 timeout: float = 600.0) -> BenchmarkResult:
    """One-call Workload → Cluster → Metrics pipeline: synthesize the
    request stream from a WorkloadConfig (open loop) or SessionConfig
    (closed loop) and benchmark ``target`` with it."""
    from repro_torch.workload import SessionConfig, SessionWorkload, synthesize

    if isinstance(workload_cfg, SessionConfig):
        workload = SessionWorkload(workload_cfg)
    else:
        workload = synthesize(workload_cfg)
    return BenchmarkRunner(target, workload,
                           transport=transport).run(timeout=timeout)
