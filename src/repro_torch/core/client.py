"""Actor/Observer client API for the virtual time protocol (Algorithm 1).

An *Actor* performs operations with predictable durations (a GPU worker about
to "execute" a batch, a benchmark dispatcher waiting until the next arrival).
Instead of sleeping, it calls :meth:`TimeJumpClient.time_jump`, which advances
*virtual* time by ``Δt`` while consuming as little *wall* time as the barrier
protocol allows::

    t_target <- GetVirtualTime() + Δt          # compute absolute target once
    while GetVirtualTime() < t_target:
        SendTimeJumpRequest(t_target); WaitForAck()
        t_remaining <- t_target - GetVirtualTime()
        if t_remaining > 0:
            WaitForClockUpdate(timeout=t_remaining)   # degradation timeout

A single call may span several barrier rounds (the Timekeeper advances to the
*minimum* target each round); the loop re-requests the unchanged absolute
target until reached.  The timeout makes the protocol degrade to sleep-based
emulation rather than deadlock or mis-order: after ``t_remaining`` wall
seconds, virtual time has advanced by the same amount (Eq. 1) and the loop
condition releases the caller.

**Batched coordination** (the emulation fast path): the Timekeeper keeps each
actor's submitted target queued *across* rounds, so the legacy
re-send-per-wake step above is redundant — the client can submit once and
then only watch the clock.  ``REPRO_CLOCK_BATCHING`` (default on) selects
that path; set it to ``0`` to force the per-wake re-send loop (the two are
trajectory-identical, the toggle exists for A/B benchmarks and bisection).
:meth:`TimeJumpClient.jump_run` goes further and submits a whole run of
pre-committed consecutive targets in one request, letting the Timekeeper
resolve multi-step rounds in one burst.

*Observers* never block time; they read :meth:`now` (and may timestamp events
they consume).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Protocol, Sequence

from .clock import VirtualClock

__all__ = [
    "ActorTransport",
    "TimeJumpClient",
    "Observer",
    "LocalTransport",
    "TransportClosed",
    "batching_enabled",
]


class TransportClosed(ConnectionError):
    """The transport's far end is gone (server close / peer death).

    Defined here (not in ``repro.core.transport``) so the dependency-free
    in-process stack can raise and catch it without importing the socket
    layer; the socket transport re-exports it for compatibility.
    """


def batching_enabled(default: bool = True) -> bool:
    """Resolve the ``REPRO_CLOCK_BATCHING`` toggle (default: batched on)."""
    raw = os.environ.get("REPRO_CLOCK_BATCHING")
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "off", "false", "no")


class ActorTransport(Protocol):
    """Minimal surface an actor needs: a clock view + the fan-in request path.

    ``clock`` is the authoritative shared clock for the in-process transport
    and a broadcast-driven *replica* clock for the socket transport; the
    :class:`TimeJumpClient` protocol loop is written against this protocol
    only, which is what makes engine code byte-identical across the
    in-process (thread) and socket (process) deployments.
    """

    clock: VirtualClock

    def send_jump_request(self, actor_id: str, t_target: float) -> int:
        """Submit a jump request; returns the epoch to wait past (the ack)."""
        ...

    def register_actor(self, actor_id: str) -> None: ...

    def deregister_actor(self, actor_id: str) -> None: ...


class LocalTransport:
    """In-process transport: direct function calls into the Timekeeper.

    The request path is a method call (fan-in), the update path is the shared
    clock's condition broadcast (fan-out) — the same asymmetry as the paper's
    ZeroMQ deployment, collapsed to zero serialization cost.
    """

    def __init__(self, timekeeper):
        self._tk = timekeeper
        self.clock: VirtualClock = timekeeper.clock

    def send_jump_request(self, actor_id: str, t_target: float) -> int:
        return self._tk.request_jump(actor_id, t_target)

    def send_jump_run(
        self,
        actor_id: str,
        targets: Sequence[float],
        *,
        unpark: bool = False,
        park_after: bool = False,
    ) -> int:
        return self._tk.request_jump_run(
            actor_id, targets, unpark=unpark, park_after=park_after
        )

    @property
    def closed(self) -> bool:
        return getattr(self._tk, "_closed", False)

    def register_actor(self, actor_id: str) -> None:
        self._tk.register_actor(actor_id)

    def deregister_actor(self, actor_id: str) -> None:
        self._tk.deregister_actor(actor_id)

    def park_actor(self, actor_id: str) -> None:
        self._tk.park_actor(actor_id)

    def unpark_actor(self, actor_id: str) -> None:
        self._tk.unpark_actor(actor_id)


class TimeJumpClient:
    """Actor-side implementation of TIMEJUMP(Δt) (Algorithm 1).

    ``batched=None`` resolves the mode from ``REPRO_CLOCK_BATCHING`` (default
    on).  Batched mode submits each target once and then watches the clock —
    the Timekeeper keeps the target queued across rounds, eliminating the
    per-round re-send wakeup churn of the legacy loop.  Both modes produce
    the identical virtual-time trajectory.
    """

    def __init__(
        self,
        transport: ActorTransport,
        actor_id: str,
        *,
        auto_register: bool = True,
        batched: Optional[bool] = None,
    ):
        self._transport = transport
        self.actor_id = actor_id
        self._registered = False
        self._parked = False
        self._batched = batching_enabled() if batched is None else bool(batched)
        if auto_register:
            self.register()

    # ---------------------------------------------------------- lifecycle --
    def register(self) -> None:
        if not self._registered:
            self._transport.register_actor(self.actor_id)
            self._registered = True
        elif self._parked:
            self.unpark()

    def deregister(self) -> None:
        if self._registered:
            self._transport.deregister_actor(self.actor_id)
            self._registered = False
            self._parked = False

    def park(self) -> None:
        """Leave the barrier but stay known to the Timekeeper (idle replica).

        Both built-in transports (:class:`LocalTransport` and the socket
        transport's ``park``/``unpark`` frames) expose the park surface, so
        engine code behaves identically in-process and cross-process.  A
        custom transport without one falls back to full deregistration —
        semantically equivalent, just without the cheap-re-entry
        bookkeeping."""
        if not self._registered or self._parked:
            return
        park = getattr(self._transport, "park_actor", None)
        if park is not None:
            park(self.actor_id)
            self._parked = True
        else:
            self.deregister()

    def unpark(self) -> None:
        if not self._registered:
            self.register()
            return
        if self._parked:
            self._transport.unpark_actor(self.actor_id)
            self._parked = False

    def __enter__(self) -> "TimeJumpClient":
        self.register()
        return self

    def __exit__(self, *exc) -> None:
        self.deregister()

    # ----------------------------------------------------------- protocol --
    def now(self) -> float:
        return self._transport.clock.now()

    def time_jump(self, dt: float) -> float:
        """Advance virtual time by ``dt`` seconds; returns the new virtual time.

        ``dt <= 0`` is a no-op returning the current time (a zero-duration
        operation needs no coordination — wall time already flowed while the
        caller computed).
        """
        clock = self._transport.clock
        if dt <= 0:
            return clock.now()
        t_target = clock.now() + dt  # compute absolute target once (l.1)
        if self._batched:
            return self._await_batched(t_target, (t_target,), park_after=False)
        while True:
            now, _ = clock.snapshot()
            if now >= t_target:  # loop guard (l.2)
                return now
            # Fan-in request + ack: the epoch to wait past.  If the barrier
            # resolved inside this call, the epoch has already moved on and
            # wait_for_update returns immediately.
            epoch = self._transport.send_jump_request(self.actor_id, t_target)
            t_remaining = t_target - clock.now()
            if t_remaining > 0:
                # Degradation timeout: worst case we ride wall time to the
                # target (sleep-based emulation) — slow, never incorrect.
                clock.wait_for_update(epoch, timeout=t_remaining,
                                      target=t_target)

    def jump_run(
        self, targets: Sequence[float], *, park_after: bool = False
    ) -> float:
        """Pre-commit a *run* of absolute ascending jump targets in ONE
        request; returns the virtual time once the final target is reached.

        The caller promises it makes no decisions between the targets that
        depend on intermediate clock reads (e.g. a replica stepping through a
        decode schedule it already committed to) — that promise is what lets
        the Timekeeper merge multiple barrier rounds into a burst with a
        single collapsed clock advance.  ``park_after=True`` additionally
        folds the end-of-run idle transition in: the Timekeeper parks this
        actor the instant the run is consumed, with no separate park RPC.

        With batching disabled (or a transport without ``send_jump_run``)
        this degrades to the exact sequential single-target protocol — same
        trajectory, one request per target.
        """
        clock = self._transport.clock
        run = sorted(float(t) for t in targets)
        if not run:
            return clock.now()
        send_run = getattr(self._transport, "send_jump_run", None)
        if not self._batched or send_run is None:
            t = clock.now()
            for t_target in run:
                t = self.time_jump(t_target - clock.now())
            if park_after:
                self.park()
            return t
        now = clock.now()
        future = [t for t in run if t > now]
        if not future:
            # Every target already reached (wall flowed past the run): only
            # the park transition remains.
            if park_after:
                self.park()
            return clock.now()
        t = self._await_batched(future[-1], future, park_after=park_after)
        if park_after:
            # The Timekeeper parked us when the run was consumed (or will,
            # the next time our leftover queue drains — see the degradation
            # note in _await_batched); mirror it locally so unpark() knows.
            self._parked = True
        return t

    def _await_batched(
        self, t_target: float, targets: Sequence[float], *, park_after: bool
    ) -> float:
        """Submit once, then watch the clock until ``t_target`` is reached.

        No per-wake re-send: the Timekeeper holds our queued run across
        rounds.  Each wake re-checks liveness instead — the legacy loop's
        re-send was also its implicit health probe (a closed transport or a
        deregistration surfaced as the re-send failing), so the batched path
        must keep raising the same errors or a shutdown mid-jump would ride
        out its full degradation timeout (forever, under a manual wall).
        """
        clock = self._transport.clock
        sent = False
        while True:
            now, epoch = clock.snapshot()
            if now >= t_target:
                return now
            if not sent:
                send_run = getattr(self._transport, "send_jump_run", None)
                if send_run is not None:
                    unpark = self._parked
                    epoch = send_run(
                        self.actor_id,
                        targets,
                        unpark=unpark,
                        park_after=park_after,
                    )
                    if unpark:
                        self._parked = False
                else:
                    epoch = self._transport.send_jump_request(
                        self.actor_id, t_target
                    )
                sent = True
            else:
                if getattr(self._transport, "closed", False):
                    raise TransportClosed(
                        f"transport closed while {self.actor_id!r} awaited "
                        f"t={t_target}"
                    )
                if not self._registered or (self._parked and not park_after):
                    raise KeyError(
                        f"actor {self.actor_id!r} left the barrier mid-jump"
                    )
            t_remaining = t_target - clock.now()
            if t_remaining > 0:
                # Degradation timeout: worst case we ride wall time to the
                # target (sleep-based emulation) — slow, never incorrect.
                # The target lets a remote clock sleep through rounds that
                # don't reach it (see ShmReplicaClock.wait_for_update).
                clock.wait_for_update(epoch, timeout=t_remaining,
                                      target=t_target)

    def jump_to(self, t_target: float) -> float:
        """Advance virtual time to an absolute target (dispatcher convenience)."""
        return self.time_jump(t_target - self.now())


class Observer:
    """Reactive client: reads virtual time, never blocks its progression."""

    def __init__(self, clock: VirtualClock, name: str = "observer"):
        self._clock = clock
        self.name = name

    def now(self) -> float:
        return self._clock.now()

    def timestamp(self) -> float:
        return self._clock.now()
