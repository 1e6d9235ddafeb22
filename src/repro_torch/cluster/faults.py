"""Deterministic fault injection: failure as a first-class scenario event.

The paper's §4.2.1 guarantee is "never incorrect, only slower" — but a
guarantee exercised only on the happy path is a hypothesis, not a result.
This module makes failure part of the declarative scenario surface:

* :class:`FaultSpec` — one frozen, JSON-serializable fault event
  (``crash`` / ``straggler`` / ``spot_reclaim``) with a virtual-time
  timestamp, carried on ``Scenario.faults`` through the same strict codec
  as every other spec field;
* :class:`FaultInjector` — a Timekeeper **actor** that jumps virtual time
  to each fault's timestamp and applies it to a live cluster.  Because the
  barrier's minimum-target rule releases the injector's jump first, every
  other actor is either blocked mid-jump with a later target or between
  jumps (in which case the barrier cannot resolve at all), so cluster
  mutations made between the injector's jumps are race-free by
  construction — the same argument that makes the autoscaler's scripted
  membership changes deterministic;
* :class:`SlowdownPredictor` — a multiplicative wrapper over any runtime
  predictor, the straggler mechanism shared by the thread backend, the
  process backend (applied child-side via a control RPC), and the DES.

Every applied event is recorded in :attr:`FaultInjector.events` using the
fault's **nominal** spec time (not a clock read), so the log is
float-exactly comparable across backends; :mod:`repro.des.simulator`
mirrors each event kind (CRASH/STRAGGLE/RECLAIM/RESPAWN) and produces an
identical log, which ``repro.scenario.compare`` asserts.

Determinism caveat (documented in ``docs/scenarios.md``): fault times must
not coincide exactly with a step-completion or arrival instant — a
same-instant completion races the injector in the emulator while the DES
orders both by its event counter.  Presets keep fault times off the step
grid.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["FAULT_KINDS", "ON_CRASH_POLICIES", "FaultSpec",
           "SlowdownPredictor", "FaultInjector"]

#: Supported fault kinds (FaultSpec.kind).
FAULT_KINDS = ("crash", "straggler", "spot_reclaim")

#: What happens to a crashed replica's in-flight requests.
ON_CRASH_POLICIES = ("requeue", "fail")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault, in virtual seconds from the run's start.

    ``kind="crash"`` — SIGKILL-equivalent loss of replica ``replica`` at
    ``time_s``: all KV/prefix state is lost and every in-flight request is
    either re-routed through the router (``on_crash="requeue"``, progress
    zeroed, original arrival time kept) or terminally failed
    (``on_crash="fail"``).  ``recover=True`` respawns one replacement
    replica (warm-pool activation on the process backend) after
    ``respawn_delay_s``.

    ``kind="straggler"`` — replica ``replica``'s predictor is wrapped so
    every step takes ``slowdown``× as long, starting with the first step
    *scheduled* at or after ``time_s`` (steps already in flight keep their
    computed duration — identical semantics in the emulator, where the
    duration was fixed before the injector's barrier round, and in the
    DES, where the STEP_DONE event is already on the heap).  If
    ``duration_s`` is set the slowdown is removed at ``time_s +
    duration_s``; otherwise it persists.

    ``kind="spot_reclaim"`` — every active replica of hardware tier
    ``tier`` receives a reclamation notice at ``time_s``: each is drained
    (no new placements, in-flight work continues) and any replica still
    not fully drained at ``time_s + notice_s`` is killed with ``crash``
    semantics.  Cost accounting (``replica_seconds`` / ``cost_dollars``)
    stops at the drain/kill boundary exactly as for autoscaler drains.
    With ``recover=True`` each killed replica respawns after
    ``respawn_delay_s`` on ``respawn_tier`` (default: its own tier).
    """

    kind: str = "crash"                 # crash | straggler | spot_reclaim
    time_s: float = 0.0                 # virtual seconds from run start
    replica: int = 0                    # victim index (crash / straggler)
    on_crash: str = "requeue"           # requeue | fail
    slowdown: float = 4.0               # straggler step-time multiplier
    duration_s: Optional[float] = None  # straggler window (None = forever)
    tier: Optional[str] = None          # spot_reclaim: the vanishing tier
    notice_s: float = 0.0               # spot_reclaim: drain notice window
    recover: bool = False               # respawn a replacement replica
    respawn_delay_s: float = 0.5        # modeled respawn/provision delay
    respawn_tier: Optional[str] = None  # tier of the replacement (None=same)

    def validate(self, *, path: str = "fault") -> None:
        from repro_torch.scenario.spec import SpecError
        if self.kind not in FAULT_KINDS:
            raise SpecError(f"{path}.kind: invalid value {self.kind!r} "
                            f"(choose from {sorted(FAULT_KINDS)})")
        if self.time_s < 0:
            raise SpecError(f"{path}.time_s: must be >= 0")
        if self.on_crash not in ON_CRASH_POLICIES:
            raise SpecError(
                f"{path}.on_crash: invalid value {self.on_crash!r} "
                f"(choose from {sorted(ON_CRASH_POLICIES)})")
        if self.replica < 0:
            raise SpecError(f"{path}.replica: must be >= 0")
        if self.kind == "straggler":
            if self.slowdown <= 0:
                raise SpecError(f"{path}.slowdown: must be > 0")
            if self.duration_s is not None and self.duration_s <= 0:
                raise SpecError(f"{path}.duration_s: must be > 0 (or null)")
        if self.kind == "spot_reclaim":
            if self.tier is None:
                raise SpecError(f"{path}.tier: required for spot_reclaim")
            if self.notice_s < 0:
                raise SpecError(f"{path}.notice_s: must be >= 0")
        if self.recover and self.respawn_delay_s < 0:
            raise SpecError(f"{path}.respawn_delay_s: must be >= 0")


class SlowdownPredictor:
    """``predict_step`` of ``inner``, with every time component scaled by
    ``factor`` — the straggler mechanism (compute contention, thermal
    throttling, a noisy neighbor) applied at the predictor layer so the
    emulator's virtual timeline and the DES agree exactly."""

    def __init__(self, inner, factor: float):
        # collapse nested wraps so repeated apply/remove stays exact
        if isinstance(inner, SlowdownPredictor):
            inner = inner.inner
        self.inner = inner
        self.factor = float(factor)

    def predict_step(self, batch):
        est = self.inner.predict_step(batch)
        f = self.factor
        out = type(est)(total=est.total * f)
        for name in ("compute", "memory", "collective", "overhead"):
            setattr(out, name, getattr(est, name) * f)
        for name in ("flops", "hbm_bytes", "collective_bytes"):
            setattr(out, name, getattr(est, name))
        return out

    @staticmethod
    def unwrap(predictor):
        """The base predictor, whether or not it is currently wrapped."""
        if isinstance(predictor, SlowdownPredictor):
            return predictor.inner
        return predictor


# internal event actions (heap entries are (time, seq, action, payload))
_CRASH = "crash"
_STRAGGLE = "straggle"
_STRAGGLE_END = "straggle_end"
_RECLAIM = "reclaim"
_RECLAIM_KILL = "reclaim_kill"
_RESPAWN = "respawn"


def schedule_of(faults) -> list:
    """The static (time, seq, action, spec) heap a fault list expands to —
    shared with the DES so both sides process events in the same order.
    Dynamic follow-ups (reclaim kills with resolved victims, respawns) are
    pushed by the processor at apply time."""
    heap: list = []
    seq = itertools.count()
    for spec in faults:
        t = float(spec.time_s)
        if spec.kind == "crash":
            heapq.heappush(heap, (t, next(seq), _CRASH, spec))
        elif spec.kind == "straggler":
            heapq.heappush(heap, (t, next(seq), _STRAGGLE, spec))
            if spec.duration_s is not None:
                heapq.heappush(heap, (t + spec.duration_s, next(seq),
                                      _STRAGGLE_END, spec))
        elif spec.kind == "spot_reclaim":
            heapq.heappush(heap, (t, next(seq), _RECLAIM, spec))
        else:  # pragma: no cover - validated upstream
            raise ValueError(f"unknown fault kind {spec.kind!r}")
    return heap


class FaultInjector:
    """A Timekeeper actor that applies a fault schedule to a live cluster.

    Lifecycle mirrors :class:`~repro.cluster.autoscaler.Autoscaler`:
    :meth:`arm` registers the injector's TimeJump actor (call it before any
    other actor can advance virtual time, so the schedule anchors at the
    run's origin); :meth:`start` begins processing; :meth:`stop`
    deregisters the actor from outside — a jump blocked mid-barrier then
    raises ``KeyError`` client-side (the established force-departure
    mechanism) and the loop exits.

    After the run, :attr:`events` holds the applied fault log in nominal
    spec times (tuples of primitives, float-exactly comparable across
    backends), :attr:`requeued` / :attr:`failed` count affected requests,
    :attr:`recoveries` holds ``(fault_time, respawn_time)`` pairs, and
    :attr:`respawn_scaleups` holds ``(virtual_time, tier)`` entries to
    merge into the autoscaler's scale-up audit.
    """

    def __init__(self, cluster, faults, *, name: str = "chaos"):
        self.cluster = cluster
        self.faults = list(faults)
        self.name = name
        self.events: List[tuple] = []
        self.requeued = 0
        self.failed = 0
        self.recoveries: List[Tuple[float, float]] = []
        self.respawn_scaleups: List[Tuple[float, Optional[str]]] = []
        self._heap = schedule_of(self.faults)
        self._seq = itertools.count(len(self._heap) + len(self.faults))
        self._client = None
        self._origin: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def arm(self) -> None:
        """Register the injector's actor (barrier membership) without
        processing yet.  Until :meth:`start`, the registered-but-idle actor
        pins the barrier, so no virtual time can pass before the schedule's
        origin is anchored."""
        if self._client is not None or not self._heap:
            return
        from repro_torch.core.client import TimeJumpClient
        self._client = TimeJumpClient(self.cluster.transport,
                                      f"{self.name}-injector")
        self._origin = self.cluster.clock.now()

    def start(self) -> None:
        if not self._heap or self._thread is not None:
            return
        self.arm()
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.name}-injector", daemon=True)
        self._thread.start()

    def join(self, timeout: float = 30.0) -> None:
        """Block until the schedule is fully processed (post-run drain).

        With the dispatcher deregistered and every idle engine parked, the
        injector's remaining jumps resolve against the barrier's surviving
        actors (or instantly, as the lone actor), so trailing faults — a
        ``straggle_end`` landing after the last completion, a late respawn —
        apply **deterministically** instead of racing :meth:`stop`.  The DES
        drains its event heap unconditionally; this is the emulator-side
        equivalent, and what keeps the fault logs comparable."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._client is not None:
            try:
                self._client.deregister()   # unwedge a blocked jump
            except Exception:
                pass
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # ----------------------------------------------------------- processing
    def _loop(self) -> None:
        from repro_torch.core.client import TransportClosed
        try:
            while self._heap and not self._stop.is_set():
                t, _, action, payload = heapq.heappop(self._heap)
                self._client.jump_to(self._origin + t)
                if self._stop.is_set():
                    break
                self._apply(t, action, payload)
        except (KeyError, RuntimeError, TransportClosed):
            pass                            # departed mid-jump (shutdown)
        finally:
            if self._client is not None:
                try:
                    self._client.deregister()
                except Exception:
                    pass

    def _apply(self, t: float, action: str, payload) -> None:
        if action == _CRASH:
            self._apply_crash(t, payload.replica, payload.on_crash,
                              log_kind="crash", recover=payload.recover,
                              respawn_delay=payload.respawn_delay_s,
                              respawn_tier=payload.respawn_tier)
        elif action == _STRAGGLE:
            self.cluster.set_replica_slowdown(payload.replica,
                                              payload.slowdown)
            self.events.append(("straggle", t, payload.replica,
                                payload.slowdown))
        elif action == _STRAGGLE_END:
            self.cluster.set_replica_slowdown(payload.replica, None)
            self.events.append(("straggle_end", t, payload.replica))
        elif action == _RECLAIM:
            self._apply_reclaim(t, payload)
        elif action == _RECLAIM_KILL:
            spec, victims = payload
            for idx in victims:
                self._apply_crash(t, idx, spec.on_crash,
                                  log_kind="reclaim_kill",
                                  recover=spec.recover,
                                  respawn_delay=spec.respawn_delay_s,
                                  respawn_tier=spec.respawn_tier)
        elif action == _RESPAWN:
            tier, fault_t = payload
            new_idx = self.cluster.add_replica(tier=tier)
            self.events.append(("respawn", t, tier, new_idx))
            self.recoveries.append((fault_t, t))
            self.respawn_scaleups.append((self.cluster.clock.now(), tier))

    def _apply_crash(self, t: float, idx: int, on_crash: str, *,
                     log_kind: str, recover: bool, respawn_delay: float,
                     respawn_tier: Optional[str]) -> None:
        if idx >= len(self.cluster.replicas):
            self.events.append((log_kind, t, idx, 0, 0, False))
            return
        res = self.cluster.crash_replica(idx, on_crash=on_crash)
        self.events.append((log_kind, t, idx,
                            res["requeued"], res["failed"], res["crashed"]))
        self.requeued += res["requeued"]
        self.failed += res["failed"]
        if recover and res["crashed"]:
            tier = respawn_tier if respawn_tier is not None else res["tier"]
            heapq.heappush(self._heap, (t + respawn_delay, next(self._seq),
                                        _RESPAWN, (tier, t)))

    def _apply_reclaim(self, t: float, spec: FaultSpec) -> None:
        cluster = self.cluster
        victims = [i for i in list(cluster.active)
                   if cluster.replica_tiers[i] == spec.tier]
        if victims and len(victims) >= len(cluster.active):
            victims = victims[1:]           # never reclaim the whole pool
        self.events.append(("reclaim", t, spec.tier, tuple(victims)))
        for idx in victims:
            cluster.drain_replica(idx)
        if victims:
            heapq.heappush(self._heap, (t + spec.notice_s, next(self._seq),
                                        _RECLAIM_KILL, (spec, victims)))
