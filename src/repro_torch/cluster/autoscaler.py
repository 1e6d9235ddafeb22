"""SLO-driven autoscaling over the elastic cluster membership.

The :class:`Autoscaler` is an **Actor** on the shared virtual timeline: it
jumps from tick to tick (``interval_s`` of *virtual* time), evaluates a
pluggable :class:`AutoscalerPolicy` against a cheap cluster view, and applies
the decision through :meth:`Cluster.add_replica` /
:meth:`Cluster.drain_replica`.  Scale-up is not instantaneous: each new
replica is brought up by a *provisioner* actor that first jumps
``provision_delay_s`` of virtual time (node allocation + weight loading,
modeled, not slept) and only then joins the routing set.  Scale-down picks
its victim through the shared :func:`drain_victim` rule — most expensive
idle tier first, replica index as the deterministic tie-break — which the
DES baseline calls verbatim, so the emulator and the DES drain the *same*
replica under the same policy decisions (parity under elasticity, now
tier-aware: giving back a quiet H100 saves more than a quiet L4).

Policies see replicas only through the small :class:`AutoscalerView`
protocol, so identical policy objects drive the emulator's real engines and
the DES baseline's event-loop replicas — extending the paper's §2.3
"same control code everywhere" argument to the scaling control loop.

**Tier-selecting scale-up** (heterogeneous pools): when
:attr:`AutoscalerConfig.tiers` names candidate hardware tiers, every
scale-up first asks the policy :meth:`AutoscalerPolicy.select_tier` which
chip to provision.  The default rule picks the cheapest candidate;
:class:`TTFTSLOPolicy` picks the *cheapest tier whose projected service
TTFT still fits inside the SLO* (falling back to the fastest when none
does) — scaling into cheaper chips exactly when they are fast enough.
Per-tier provisioning delays come from
:attr:`AutoscalerConfig.provision_delay_by_tier`.  Tier selection happens
at tick time (deterministically, from immutable
:class:`~repro.cluster.tiers.TierSpec` data), so the DES mirror makes the
identical choice at the identical virtual time.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import List, Mapping, Optional, Protocol, Sequence, Tuple

from repro_torch.core.client import TimeJumpClient

from .tiers import TierSpec

__all__ = [
    "AutoscalerConfig",
    "AutoscalerView",
    "AutoscalerPolicy",
    "QueueDepthPolicy",
    "TTFTSLOPolicy",
    "SchedulePolicy",
    "AUTOSCALER_POLICIES",
    "make_autoscaler_policy",
    "provision_delay",
    "drain_victim",
    "Autoscaler",
]


def drain_victim(active, *, idle_of, cost_of) -> Optional[int]:
    """Scale-down victim rule, shared verbatim by the emulator's
    :class:`Autoscaler` and the DES mirror so both drain the *same* replica
    under the same policy decisions (parity under elasticity).

    Most expensive **idle** tier first — shedding a quiet H100 saves more
    dollars than shedding a quiet L4 — with the replica index as the
    deterministic tie-break (highest wins, preserving the historical
    last-in-first-out shape on homogeneous pools).  When no active replica
    is idle, the same (cost, index) ordering applies to the busy ones:
    the drain then runs out its in-flight work before finalising.

    ``idle_of(i)`` / ``cost_of(i)`` are the per-replica probes (emulator:
    live engine counters + TierSpec rates; DES: event-loop state + the same
    TierSpec dict).  Returns None when draining is impossible (<=1 active).

    >>> drain_victim([0, 1, 2], idle_of=lambda i: i != 1,
    ...              cost_of=lambda i: [3.0, 9.0, 1.0][i])
    0
    >>> drain_victim([0, 1, 2], idle_of=lambda i: False,
    ...              cost_of=lambda i: [3.0, 9.0, 1.0][i])
    1
    >>> drain_victim([0, 1], idle_of=lambda i: True, cost_of=lambda i: 0.0)
    1
    >>> drain_victim([0], idle_of=lambda i: True, cost_of=lambda i: 0.0)
    """
    active = list(active)
    if len(active) <= 1:
        return None
    idle = [i for i in active if idle_of(i)]
    pool = idle if idle else active
    return max(pool, key=lambda i: (cost_of(i), i))


@dataclass(frozen=True)
class AutoscalerConfig:
    interval_s: float = 0.25          # virtual seconds between policy ticks
    provision_delay_s: float = 1.0    # scale-up latency (virtual-time jump)
    min_replicas: int = 1
    max_replicas: int = 8
    # Heterogeneous scale-up: candidate tier names the policy may provision
    # (empty = homogeneous, clone the last replica's tier) and optional
    # per-tier provisioning delays (cheaper chips are usually easier to get;
    # tiers absent from the mapping fall back to provision_delay_s).
    tiers: Tuple[str, ...] = ()
    provision_delay_by_tier: Optional[Mapping[str, float]] = None


def provision_delay(cfg: AutoscalerConfig, tier: Optional[str]) -> float:
    """Scale-up latency for ``tier`` under ``cfg`` (shared with the DES
    mirror so both sides provision at identical virtual times).

    >>> cfg = AutoscalerConfig(provision_delay_s=2.0,
    ...                        provision_delay_by_tier={"l4": 0.5})
    >>> provision_delay(cfg, "l4")
    0.5
    >>> provision_delay(cfg, "h100")
    2.0
    >>> provision_delay(cfg, None)
    2.0
    """
    if tier is not None and cfg.provision_delay_by_tier:
        return cfg.provision_delay_by_tier.get(tier, cfg.provision_delay_s)
    return cfg.provision_delay_s


class AutoscalerView(Protocol):
    """What a policy may observe.  Implementations are racy, non-blocking
    reads (emulator: engine counters; DES: event-loop state)."""

    def now(self) -> float: ...

    def active_count(self) -> int: ...

    def queue_depths(self) -> List[int]:
        """Outstanding (submitted-but-unfinished) requests per active replica."""
        ...

    def recent_ttfts(self, window_s: float) -> List[float]:
        """TTFTs of requests that finished within the trailing window."""
        ...


class AutoscalerPolicy:
    """Maps a view to a desired replica delta (+k up, -k down, 0 hold).

    Policies are stateful (tick history); build a fresh one per run — same
    convention as Router objects.

    On heterogeneous pools a policy also answers :meth:`select_tier` — which
    hardware tier each scale-up should provision.  The base rule is
    "cheapest candidate" (deterministic: cost, then name); selection must be
    a pure function of the immutable specs (+ at most the view), never of
    wall time or randomness, so the DES mirror reproduces it exactly.

    >>> specs = [TierSpec("h100", "h100-sxm", 5.5 / 3600, 800.0, 0.02),
    ...          TierSpec("l4", "l4", 0.8 / 3600, 200.0, 0.08)]
    >>> AutoscalerPolicy().select_tier(None, specs).name
    'l4'
    """

    name = "?"

    def decide(self, view: AutoscalerView) -> int:
        raise NotImplementedError

    def set_origin(self, t0: float) -> None:
        """Anchor time-scripted policies to the run's virtual start.

        Called once by the control loop before the first tick (the
        emulator's :class:`Autoscaler` passes ``clock.now()``; the DES
        passes ``0.0``, its event-loop origin).  Virtual time's absolute
        value depends on the wall source — a ManualWallSource starts near
        0, the process backend's host-shared ``time.time`` starts at the
        unix epoch — so policies must never interpret wall-derived
        absolutes.  Stateless policies ignore it."""

    def select_tier(self, view: Optional[AutoscalerView],
                    tiers: Sequence[TierSpec]) -> TierSpec:
        assert tiers, "select_tier needs at least one candidate"
        return min(tiers, key=lambda t: (t.cost_per_replica_s, t.name))


class QueueDepthPolicy(AutoscalerPolicy):
    """Classic queue-depth target: scale up when the mean per-replica backlog
    exceeds ``target_depth`` requests, down when it falls below
    ``low_watermark`` (hysteresis gap avoids flapping)."""

    name = "queue_depth"

    def __init__(self, target_depth: float = 4.0, low_watermark: float = 1.0):
        assert low_watermark < target_depth
        self.target_depth = target_depth
        self.low_watermark = low_watermark

    def decide(self, view: AutoscalerView) -> int:
        depths = view.queue_depths()
        if not depths:
            return 0
        mean = sum(depths) / len(depths)
        if mean > self.target_depth:
            return 1
        if mean < self.low_watermark:
            return -1
        return 0


class TTFTSLOPolicy(AutoscalerPolicy):
    """SLO-attainment feedback: scale up while the trailing window's TTFT
    attainment sits below ``target_attainment``; scale down only when
    attainment is met AND the backlog is nearly empty (capacity is provably
    surplus, so shrinking cannot immediately re-breach the SLO)."""

    name = "ttft_slo"

    def __init__(self, slo_ttft_s: float = 0.5,
                 target_attainment: float = 0.95,
                 window_s: float = 2.0,
                 idle_depth: float = 0.5,
                 tier_headroom: float = 0.5):
        self.slo_ttft_s = slo_ttft_s
        self.target_attainment = target_attainment
        self.window_s = window_s
        self.idle_depth = idle_depth
        self.tier_headroom = tier_headroom

    def select_tier(self, view, tiers: Sequence[TierSpec]) -> TierSpec:
        """Cheapest tier that *projects* to meet the TTFT SLO: its unloaded
        service TTFT (prefill + first decode step, from the tier's own
        predictor) must fit within ``tier_headroom`` of the SLO, the rest
        being queueing budget.  No tier feasible → provision the fastest
        (min projected TTFT) and let the next ticks keep scaling.

        >>> fast = TierSpec("h100", "h100-sxm", 5.5 / 3600, 800.0, 0.02)
        >>> slow = TierSpec("l4", "l4", 0.8 / 3600, 200.0, 0.08)
        >>> TTFTSLOPolicy(slo_ttft_s=0.5).select_tier(None, [fast, slow]).name
        'l4'
        >>> TTFTSLOPolicy(slo_ttft_s=0.1).select_tier(None, [fast, slow]).name
        'h100'
        """
        assert tiers, "select_tier needs at least one candidate"
        budget = self.tier_headroom * self.slo_ttft_s
        feasible = [t for t in tiers if t.projected_ttft_s <= budget]
        if feasible:
            return min(feasible,
                       key=lambda t: (t.cost_per_replica_s, t.name))
        return min(tiers, key=lambda t: (t.projected_ttft_s, t.name))

    def decide(self, view: AutoscalerView) -> int:
        ttfts = view.recent_ttfts(self.window_s)
        depths = view.queue_depths()
        mean_depth = sum(depths) / len(depths) if depths else 0.0
        if ttfts:
            attainment = (sum(1 for t in ttfts if t <= self.slo_ttft_s)
                          / len(ttfts))
            if attainment < self.target_attainment:
                return 1
        if mean_depth < self.idle_depth:
            return -1
        return 0


class SchedulePolicy(AutoscalerPolicy):
    """Scripted membership changes: ``events`` is a list of
    ``(virtual_time, delta)`` pairs applied at the first tick at-or-after
    each time, where times are measured **from the run's virtual start**
    (the :meth:`set_origin` anchor — this is what keeps one schedule
    meaningful across wall sources: a ManualWallSource timeline starts
    near 0, the process backend's at the unix epoch).  Deterministic by
    construction — the elastic emulator-vs-DES and thread-vs-process
    parity scenarios use it so all sides scale at identical virtual
    times regardless of load-probe raciness.

    >>> from types import SimpleNamespace
    >>> p = SchedulePolicy([(1.0, +1), (2.0, -1)])
    >>> p.decide(SimpleNamespace(now=lambda: 0.5))
    0
    >>> p.decide(SimpleNamespace(now=lambda: 1.5))
    1
    >>> p.decide(SimpleNamespace(now=lambda: 1.6))   # event already consumed
    0
    >>> p2 = SchedulePolicy([(1.0, +1)])
    >>> p2.set_origin(100.0)                         # run started at t=100
    >>> p2.decide(SimpleNamespace(now=lambda: 100.5))
    0
    >>> p2.decide(SimpleNamespace(now=lambda: 101.5))
    1
    """

    name = "schedule"

    def __init__(self, events: Sequence[Tuple[float, int]]):
        self._events = sorted(events)
        self._cursor = 0
        self._origin = 0.0

    def set_origin(self, t0: float) -> None:
        self._origin = t0

    def decide(self, view: AutoscalerView) -> int:
        now = view.now() - self._origin
        delta = 0
        while (self._cursor < len(self._events)
               and self._events[self._cursor][0] <= now):
            delta += self._events[self._cursor][1]
            self._cursor += 1
        return delta


AUTOSCALER_POLICIES = {
    cls.name: cls
    for cls in (QueueDepthPolicy, TTFTSLOPolicy, SchedulePolicy)
}


def make_autoscaler_policy(name: str, **kwargs) -> AutoscalerPolicy:
    try:
        cls = AUTOSCALER_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown autoscaler policy {name!r}; "
            f"choose from {sorted(AUTOSCALER_POLICIES)}") from None
    return cls(**kwargs)


class _ClusterView:
    """AutoscalerView over a live emulated Cluster (racy counter reads)."""

    def __init__(self, cluster):
        self._c = cluster

    def now(self) -> float:
        return self._c.clock.now()

    def active_count(self) -> int:
        return self._c.num_active()

    def queue_depths(self) -> List[int]:
        with self._c._membership_lock:
            active = list(self._c.active)
        return [self._c.engines[i].num_outstanding() for i in active]

    def recent_ttfts(self, window_s: float) -> List[float]:
        horizon = self.now() - window_s
        out: List[float] = []
        with self._c._finish_cond:
            # scan from the tail; finished is finish-ordered per replica and
            # near-ordered globally, so stop after a safety margin
            for r in reversed(self._c.finished):
                if r.finish_time is not None and r.finish_time < horizon:
                    break
                t = r.ttft()
                if t is not None:
                    out.append(t)
        return out


class Autoscaler:
    """Virtual-time control loop gluing a policy onto a Cluster.

    Lifecycle mirrors the engines: ``start()`` spawns the tick thread (an
    Actor when the cluster has a Timekeeper transport; wall-clock ticks
    otherwise, the sleep-mode degradation), ``stop()`` deregisters it.
    ``decision_log`` records ``(tick_time, delta_applied, active_after)`` for
    benchmarks and tests; ``scaleups`` additionally records
    ``(tick_time, tier_name)`` per provisioned replica (tier None =
    homogeneous clone).
    """

    def __init__(self, cluster, policy: AutoscalerPolicy,
                 cfg: Optional[AutoscalerConfig] = None, *,
                 name: str = "autoscaler"):
        self.cluster = cluster
        self.policy = policy
        self.cfg = cfg or AutoscalerConfig()
        self.name = name
        self.view: AutoscalerView = _ClusterView(cluster)
        self.decision_log: List[tuple] = []
        self.scaleups: List[Tuple[float, Optional[str]]] = []
        # candidate TierSpecs for tier-selecting scale-up, resolved through
        # the cluster's spec cache/factory so router weights, cost
        # accounting, and selection all share one arithmetic
        self.tier_candidates: List[TierSpec] = [
            cluster.tier_spec(t) for t in self.cfg.tiers]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._client: Optional[TimeJumpClient] = None
        self._provisioning = 0            # scale-ups in flight (delay jump)
        self._prov_lock = threading.Lock()
        self._prov_ids = itertools.count()
        self._prov_threads: List[threading.Thread] = []

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> "Autoscaler":
        assert self._thread is None, "autoscaler already started"
        # Anchor time-scripted policies to the run's virtual start (the DES
        # mirror anchors at its event-loop origin, 0.0).
        self.policy.set_origin(self.cluster.clock.now())
        if self.cluster.transport is not None:
            self._client = TimeJumpClient(
                self.cluster.transport, f"{self.name}-tick")
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.name}-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Deregistering the tick actor from here unwedges a thread blocked
        # mid-jump (the Timekeeper bumps the clock epoch on deregistration);
        # its next re-request raises KeyError, which the loop treats as stop.
        if self._client is not None:
            self._client.deregister()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for t in self._prov_threads:
            t.join(timeout=10)

    # --------------------------------------------------------------- loop --
    def _loop(self) -> None:
        clock = self.cluster.clock
        next_t = clock.now() + self.cfg.interval_s
        while not self._stop.is_set():
            try:
                if self._client is not None:
                    self._client.jump_to(next_t)
                else:
                    dt = next_t - clock.now()
                    if dt > 0:
                        clock.wall.sleep(dt)
            except (KeyError, RuntimeError):
                break                     # deregistered / timekeeper closed
            if self._stop.is_set():
                break
            self._tick()
            next_t += self.cfg.interval_s

    def _tick(self) -> None:
        delta = self.policy.decide(self.view)
        applied = self._apply(delta)
        self.decision_log.append(
            (self.view.now(), applied, self.cluster.num_active()))

    def _apply(self, delta: int) -> int:
        cfg = self.cfg
        with self._prov_lock:
            committed = self.cluster.num_active() + self._provisioning
            if delta > 0:
                delta = min(delta, cfg.max_replicas - committed)
                for _ in range(max(0, delta)):
                    tier = None
                    if self.tier_candidates:
                        tier = self.policy.select_tier(
                            self.view, self.tier_candidates).name
                    self.scaleups.append((self.view.now(), tier))
                    self._provisioning += 1
                    self._spawn_provisioner(tier)
                return max(0, delta)
            if delta < 0:
                # never drain below min, and count in-flight provisions as
                # capacity already committed
                allowed = max(0, committed - cfg.min_replicas)
                delta = -min(-delta, allowed)
                drained = 0
                for _ in range(-delta):
                    victim = self._pick_victim()
                    if victim is None:
                        break
                    self.cluster.drain_replica(victim)
                    drained += 1
                return -drained
        return 0

    def _pick_victim(self) -> Optional[int]:
        """Tier-aware rule via :func:`drain_victim`: most expensive idle
        tier first, index as the deterministic tie-break — identical code
        to the DES mirror.  Idleness is a racy engine probe, but drains
        only ever fire on quiet clusters (policy hysteresis), where the
        probe is stable on both sides."""
        with self.cluster._membership_lock:
            active = list(self.cluster.active)
        return drain_victim(
            active,
            idle_of=lambda i: self.cluster.replicas[i].num_outstanding() == 0,
            cost_of=self.cluster.replica_cost_rate)

    def _spawn_provisioner(self, tier: Optional[str] = None) -> None:
        """Model the scale-up latency as a virtual-time jump.

        The provisioner's actor is registered *here*, in the tick thread —
        an Actor between jumps — so the barrier cannot advance past the
        provisioning interval before the jump request lands (§4.3 trick,
        same as the PD KV movers).  ``tier`` is the policy's tier choice
        (made at tick time; the provisioner only pays that tier's delay and
        joins the replica)."""
        client = None
        if self.cluster.transport is not None:
            client = TimeJumpClient(
                self.cluster.transport,
                f"{self.name}-prov-{next(self._prov_ids)}")
        t = threading.Thread(target=self._provision, args=(client, tier),
                             name=f"{self.name}-prov", daemon=True)
        t.start()
        self._prov_threads.append(t)

    def _provision(self, client: Optional[TimeJumpClient],
                   tier: Optional[str] = None) -> None:
        try:
            delay = provision_delay(self.cfg, tier)
            try:
                if client is not None:
                    client.time_jump(delay)
                else:
                    self.cluster.clock.wall.sleep(delay)
            except (KeyError, RuntimeError):
                return                    # torn down mid-provision
            if not self._stop.is_set():
                self.cluster.add_replica(tier=tier)
        finally:
            if client is not None:
                client.deregister()
            with self._prov_lock:
                self._provisioning -= 1
