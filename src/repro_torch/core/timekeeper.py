"""The Timekeeper: barrier-based virtual time coordination (paper §4.2).

The Timekeeper manages virtual time across connected clients.  Clients are
*Actors* (active drivers with predictable operation durations — GPU workers,
the benchmark dispatcher) or *Observers* (reactive components that only
timestamp events).  Only Actors participate in barrier rounds, which is what
keeps coordination overhead minimal.

Protocol (Algorithm 2)::

    pending <- {}, offset <- 0
    loop:
        (c, t_target) <- ReceiveRequest()
        pending[c] <- t_target
        if |pending| == numActors:          # all actors at the barrier
            t_min <- min(pending.values())  # minimum-target rule => causality
            offset <- max(offset, t_min - t_wall)
            BroadcastClockUpdate(offset)
            pending <- {}

Design constraints honoured (paper §4.2.1):

* **No rollback** — virtual time only moves forward; the minimum-target rule
  guarantees no Actor's clock jumps past an event another Actor still has to
  produce.
* **No event-scheduling control** — the Timekeeper never tells a process what
  to do; it only answers jump requests.  CPU work between jumps consumes
  virtual time at wall rate automatically (Eq. 1).
* **Graceful degradation** — if a barrier never resolves (straggler, lost
  message), clients time out after their remaining *wall* delta, by which
  point virtual time has advanced by the same amount.  Worst case is
  sleep-based emulation: slow, never wrong.

Elasticity: actors may register/deregister between rounds (engine scale-up /
drain).  Deregistration re-evaluates the barrier so a departing actor cannot
wedge the clock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set

from .clock import VirtualClock, WallSource

__all__ = ["Timekeeper", "TimekeeperStats"]


@dataclass
class TimekeeperStats:
    """Counters exposed for benchmarks (barrier pressure, acceleration)."""

    rounds: int = 0                 # barrier resolutions (logical rounds)
    requests: int = 0               # jump requests received
    batched_requests: int = 0       # requests that carried a multi-target run
    merged_rounds: int = 0          # rounds resolved inside a burst beyond
                                    # the first (no extra fanout was paid)
    virtual_advanced: float = 0.0   # seconds of offset added (time skipped)
    cooldown_waits: int = 0         # jitter cooldowns applied
    registered_peak: int = 0
    parks: int = 0                  # park transitions (idle replicas)
    unparks: int = 0
    coalesced_parks: int = 0        # park/unpark transitions folded into a
                                    # barrier message instead of their own RPC

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "requests": self.requests,
            "batched_requests": self.batched_requests,
            "merged_rounds": self.merged_rounds,
            "virtual_advanced_s": self.virtual_advanced,
            "cooldown_waits": self.cooldown_waits,
            "registered_peak": self.registered_peak,
            "parks": self.parks,
            "unparks": self.unparks,
            "coalesced_parks": self.coalesced_parks,
        }


class Timekeeper:
    """Central coordinator for virtual time jumps.

    Thread-safe; with the in-process transport, barrier resolution executes in
    the thread of the last-arriving request (there is no dedicated server
    thread to context-switch through — the fan-in path *is* the caller).  The
    socket transport (``repro.core.transport``) wraps this same object with an
    I/O thread per connection plus a broadcast path, mirroring the paper's
    split between the I/O thread and the barrier thread.

    Parameters
    ----------
    clock:
        Shared :class:`VirtualClock`.  In-process clients read it directly;
        socket clients hold replicas updated by broadcasts.
    jitter_cooldown:
        The bounded-jitter model of §4.2.1: a ``J``-duration wall-clock
        cooldown between consecutive clock advances so Observers never read a
        virtual time "from the future" of an in-flight message.  The paper
        finds J ≈ 500 µs sufficient; tests set 0 for speed.
    """

    def __init__(
        self,
        clock: Optional[VirtualClock] = None,
        *,
        jitter_cooldown: float = 500e-6,
    ):
        self.clock = clock or VirtualClock()
        self.jitter_cooldown = float(jitter_cooldown)
        self._lock = threading.Lock()
        self._actors: Set[str] = set()
        self._parked: Set[str] = set()
        # Per-actor queues of ascending jump targets.  A queue *persists
        # across rounds* until consumed: targets are popped once the clock
        # reaches them, so an actor whose target lies beyond the current
        # round's minimum stays pending without re-sending (the batched fast
        # path).  A new request replaces the actor's queue wholesale, which
        # keeps the legacy single-target re-send protocol exactly equivalent.
        self._pending: Dict[str, list] = {}
        # Actors to auto-park the moment their queued run is fully consumed
        # (the park transition rides the jump request instead of its own RPC).
        self._park_after: Set[str] = set()
        self._last_advance_wall = -float("inf")
        self._broadcast_hooks: list[Callable[[float, int], None]] = []
        self.stats = TimekeeperStats()
        self._closed = False

    # --------------------------------------------------------- lifecycle --
    def register_actor(self, actor_id: str) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("Timekeeper is closed")
            self._actors.add(actor_id)
            self._parked.discard(actor_id)
            self.stats.registered_peak = max(
                self.stats.registered_peak, len(self._actors)
            )

    def deregister_actor(self, actor_id: str) -> None:
        """Remove an actor; re-evaluate the barrier so departure never wedges
        the remaining actors (elastic scale-down / clean shutdown)."""
        with self._lock:
            self._actors.discard(actor_id)
            self._parked.discard(actor_id)
            self._pending.pop(actor_id, None)
            self._park_after.discard(actor_id)
            rounds_before = self.stats.rounds
            self._maybe_resolve_locked()
            if self.stats.rounds == rounds_before:
                # No round resolved: still bump the clock epoch so a client
                # being deregistered *from another thread* (autoscaler stop,
                # drain teardown) re-checks instead of riding out its
                # degradation timeout — with a manual wall source that
                # timeout would never elapse and the thread would wedge.
                # Fan the bump out to broadcast hooks too: a *remote* client
                # holds a replica clock and only learns of epoch movement
                # through broadcast frames (the in-process condition variable
                # it cannot see).
                self.clock.advance_to(self.clock.now())
                self._fanout_locked()

    # -------------------------------------------------------- park/unpark --
    # Cluster-scale support: N replica engines share one Timekeeper and most
    # of them are idle at any instant.  A *parked* actor stays known (its
    # identity, and its slot in ``registered_peak``, survive) but is excluded
    # from the barrier, so one busy replica plus the dispatcher can advance
    # the single shared offset without waiting on the other N-1.  Park/unpark
    # are the high-frequency path (every engine idle transition), so they
    # must be cheap and never wedge the barrier — parking re-evaluates it
    # exactly like deregistration does.
    def park_actor(self, actor_id: str) -> None:
        with self._lock:
            if actor_id in self._actors:
                self._actors.discard(actor_id)
                self._parked.add(actor_id)
                self._pending.pop(actor_id, None)
                self._park_after.discard(actor_id)
                self.stats.parks += 1
                self._maybe_resolve_locked()

    def unpark_actor(self, actor_id: str) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("Timekeeper is closed")
            self._parked.discard(actor_id)
            self._actors.add(actor_id)
            self.stats.unparks += 1
            self.stats.registered_peak = max(
                self.stats.registered_peak, len(self._actors)
            )

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._actors.clear()
            self._parked.clear()
            self._pending.clear()
            self._park_after.clear()
            # Final epoch bump releases any straggling waiters immediately —
            # broadcast it so *remote* waiters (replica clocks on the socket
            # transport, possibly parked) release too instead of riding out
            # their degradation timeouts.
            self.clock.advance_to(-float("inf"))
            self._fanout_locked()

    @property
    def num_actors(self) -> int:
        with self._lock:
            return len(self._actors)

    @property
    def num_parked(self) -> int:
        with self._lock:
            return len(self._parked)

    def add_broadcast_hook(self, hook: Callable[[float, int], None]) -> None:
        """Fan-out path: called as hook(offset, epoch) after *every* clock
        epoch bump — barrier resolutions, the deregistration fallback bump,
        and the final bump in :meth:`close`.

        The socket transport uses this to push updates to remote replica
        clocks; in-process clients share ``self.clock`` and need no hook.
        Hooks run with the Timekeeper lock held and must not block (the
        socket transport's hook is a queue append).
        """
        with self._lock:
            self._broadcast_hooks.append(hook)

    def _fanout_locked(self) -> None:
        """Push the clock's current (offset, epoch) to every broadcast hook.
        Caller holds ``self._lock``."""
        offset, epoch = self.clock.offset, self.clock.epoch
        for hook in self._broadcast_hooks:
            hook(offset, epoch)

    # ---------------------------------------------------------- protocol --
    def request_jump(self, actor_id: str, t_target: float) -> int:
        """Fan-in path: store the request; resolve the barrier if complete.

        Returns the clock epoch observed *before* any resolution triggered by
        this request — the client waits for the epoch to move past this value
        (this closes the ack/broadcast race in Algorithm 1 lines 3–4: if the
        barrier resolves during this call, the epoch has already moved and the
        client's wait returns immediately).
        """
        return self.request_jump_run(actor_id, (t_target,))

    def request_jump_run(
        self,
        actor_id: str,
        targets,
        *,
        unpark: bool = False,
        park_after: bool = False,
    ) -> int:
        """Batched fan-in: submit a *run* of ascending absolute jump targets
        in one request.

        The run replaces any queue the actor already had and persists across
        rounds until consumed — targets are popped as the clock reaches them,
        so the actor never re-sends while the barrier walks through its run.
        When every active actor holds a queued run, the barrier resolves the
        whole overlap as one burst of merged rounds (minimum-target rule per
        merged step, so causality is exactly the single-target protocol's)
        with a single collapsed clock advance and fan-out.

        ``unpark=True`` folds a park-exit into this request (a parked actor
        re-enters the barrier and submits in one message); ``park_after=True``
        folds the opposite transition in: the Timekeeper auto-parks the actor
        the moment its run is fully consumed, saving the separate park RPC an
        idle-bound replica would otherwise issue per step.
        """
        with self._lock:
            if unpark and actor_id in self._parked:
                self._parked.discard(actor_id)
                self._actors.add(actor_id)
                self.stats.unparks += 1
                self.stats.coalesced_parks += 1
                self.stats.registered_peak = max(
                    self.stats.registered_peak, len(self._actors)
                )
            if actor_id not in self._actors:
                raise KeyError(
                    f"actor {actor_id!r} is not registered with the Timekeeper"
                )
            run = sorted(float(t) for t in targets)
            if not run:
                raise ValueError("jump run must contain at least one target")
            epoch_before = self.clock.epoch
            self._pending[actor_id] = run
            self.stats.requests += 1
            if len(run) > 1:
                self.stats.batched_requests += 1
            if park_after:
                self._park_after.add(actor_id)
            else:
                self._park_after.discard(actor_id)
            self._maybe_resolve_locked()
            return epoch_before

    # ---------------------------------------------------------- internal --
    def _pop_reached_locked(self, t_min: float) -> None:
        """Consume every queued target the clock has reached; auto-park
        actors whose ``park_after`` run is now fully consumed.  Caller holds
        ``self._lock``."""
        for a in list(self._actors):
            q = self._pending.get(a)
            if not q:
                continue
            while q and q[0] <= t_min:
                q.pop(0)
            if not q:
                del self._pending[a]
                if a in self._park_after:
                    # The coalesced park transition: fold the idle-replica
                    # park into barrier resolution instead of its own RPC.
                    self._park_after.discard(a)
                    self._actors.discard(a)
                    self._parked.add(a)
                    self.stats.parks += 1
                    self.stats.coalesced_parks += 1

    def _maybe_resolve_locked(self) -> None:
        """Algorithm 2 lines 5–12, burst-generalised.  Caller holds
        ``self._lock``.

        While every active actor has a non-empty target queue, merged rounds
        resolve back-to-back: each takes the minimum head target (causality —
        never past any actor's minimum) and pops what it reached.  A burst
        only runs ahead through targets actors *pre-committed* in a run; it
        stops the moment any actor's queue empties (that actor gets control
        back before time moves further).  The whole burst collapses into ONE
        physical clock advance + fan-out, so a k-step overlap costs one epoch
        bump and one broadcast instead of k.
        """
        if not self._actors:
            return
        if not all(self._pending.get(a) for a in self._actors):
            return

        # Jitter cooldown (§4.2.1 "Handling Message Jitter"): enforce >= J of
        # wall time between consecutive advances so any message produced under
        # the previous offset has been delivered before observers can read a
        # post-jump timestamp.  One cooldown per burst: the burst is a single
        # physical advance.
        if self.jitter_cooldown > 0:
            now_wall = self.clock.wall.time()
            wait = self._last_advance_wall + self.jitter_cooldown - now_wall
            if wait > 0:
                self.stats.cooldown_waits += 1
                # Brief sleep with the lock held: J is ~500 µs and incoming
                # requests would be barrier-blocked behind this round anyway.
                self.clock.wall.sleep(wait)

        merged = 0
        final_t = None
        while self._actors and all(self._pending.get(a) for a in self._actors):
            t_min = min(self._pending[a][0] for a in self._actors)
            self._pop_reached_locked(t_min)
            final_t = t_min
            merged += 1

        before = self.clock.offset
        self.clock.advance_to(final_t)  # epoch bump + notify, even if flat
        after = self.clock.offset
        self.stats.virtual_advanced += after - before
        self.stats.rounds += merged
        self.stats.merged_rounds += merged - 1
        self._last_advance_wall = self.clock.wall.time()
        self._fanout_locked()
