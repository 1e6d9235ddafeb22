"""Virtual clock primitives (paper §4.2.1).

Revati represents global virtual time as an *offset* from wall-clock time::

    t_virtual = t_wall + offset                                   (Eq. 1)

Initially ``offset = 0`` so virtual time equals wall time.  As Actors request
time jumps the Timekeeper monotonically increases the offset, causing virtual
time to advance faster than wall time.  Observers read virtual time without
any coordination: they read the current offset and add wall time.

Two properties of this representation are load-bearing for correctness:

* **Monotonicity** — ``offset`` only ever grows, and wall time only ever
  grows, so virtual time is monotone even under concurrent reads.
* **Graceful degradation** — if no clock update arrives, virtual time still
  advances at wall rate.  A client waiting ``t_remaining`` *wall* seconds is
  therefore guaranteed that ``t_remaining`` *virtual* seconds have elapsed,
  which is exactly the timeout rule of Algorithm 1.

All times are float seconds.  (The paper quotes milliseconds; seconds are the
Python-native unit and conversion is confined to display code.)
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = [
    "WallSource",
    "MonotonicWallSource",
    "UnixWallSource",
    "ManualWallSource",
    "VirtualClock",
]


class WallSource:
    """Abstract source of wall-clock time.

    Injectable so tests can control the passage of wall time and so the
    cross-process transport can use a host-shared epoch (``time.time``)
    rather than the per-process ``time.monotonic``.
    """

    def time(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:  # pragma: no cover - trivial
        if seconds > 0:
            time.sleep(seconds)

    def sleep_precise(self, seconds: float, *, spin: float = 1.5e-3) -> None:
        """Hybrid sleep: coarse ``time.sleep`` for the bulk, busy-wait for the
        final ``spin`` seconds.  OS timer slop makes plain sleep() overshoot
        by 0.1–2 ms, which systematically inflates the sleep-based-emulation
        baseline; the spin tail removes that bias (µs-accurate) at the cost
        of one core — acceptable for the strawman we are comparing against."""
        if seconds <= 0:
            return
        deadline = self.time() + seconds
        bulk = seconds - spin
        if bulk > 0:
            time.sleep(bulk)
        while self.time() < deadline:
            pass


class MonotonicWallSource(WallSource):
    """Default in-process wall source (immune to NTP steps)."""

    def time(self) -> float:
        return time.monotonic()


class UnixWallSource(WallSource):
    """Host-shared wall source for the multi-process socket transport.

    ``time.monotonic`` epochs are per-process and therefore not comparable
    across processes; ``time.time`` is shared by all processes on a host.
    Cross-host deployments inherit NTP skew as a bounded additive error on
    virtual timestamps (same trade-off the paper makes for its ZeroMQ
    deployment).
    """

    def time(self) -> float:
        return time.time()


class ManualWallSource(WallSource):
    """Deterministic wall source for tests: time advances only on demand."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()

    def time(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> None:
        assert dt >= 0
        with self._lock:
            self._now += dt

    def sleep(self, seconds: float) -> None:
        # Sleeping *is* advancing in manual mode.
        self.advance(max(0.0, seconds))

    def sleep_precise(self, seconds: float, **_kw) -> None:
        # Spinning on manual time would never terminate; advance directly.
        self.advance(max(0.0, seconds))


class VirtualClock:
    """Thread-safe virtual clock shared by the Timekeeper and its clients.

    The clock is a pair ``(offset, epoch)``: ``offset`` implements Eq. 1 and
    ``epoch`` counts clock *updates* (barrier resolutions).  The epoch bumps
    on every barrier resolution even when the offset is unchanged — waking
    blocked clients promptly instead of letting them ride out their
    degradation timeout.  This is a strict improvement over the literal
    Algorithm 2 (which broadcasts only when the offset grows) and preserves
    its semantics: clients re-check their target on every wake.
    """

    def __init__(self, wall: Optional[WallSource] = None):
        self.wall = wall or MonotonicWallSource()
        self._offset = 0.0
        self._epoch = 0
        self._cond = threading.Condition()

    # ------------------------------------------------------------- reads --
    def now(self) -> float:
        """Current virtual time (Observers call this freely, no coordination)."""
        with self._cond:
            return self.wall.time() + self._offset

    @property
    def offset(self) -> float:
        with self._cond:
            return self._offset

    @property
    def epoch(self) -> int:
        with self._cond:
            return self._epoch

    def snapshot(self) -> tuple[float, int]:
        """Atomic (virtual_now, epoch) pair."""
        with self._cond:
            return self.wall.time() + self._offset, self._epoch

    # ----------------------------------------------------------- updates --
    def advance_to(self, t_min: float) -> float:
        """Advance virtual time to at least ``t_min`` (Algorithm 2, l.7–10).

        ``offset = max(offset, t_min - t_wall)`` — the ``max`` makes the call
        idempotent and keeps the clock monotone when wall time has already
        overtaken ``t_min`` (the degradation path).  Returns the new offset.
        """
        with self._cond:
            t_wall = self.wall.time()
            self._offset = max(self._offset, t_min - t_wall)
            self._epoch += 1
            self._cond.notify_all()
            return self._offset

    def apply_update(self, offset: float, epoch: int) -> None:
        """Install a replicated (offset, epoch) broadcast — socket clients."""
        with self._cond:
            if offset > self._offset:
                self._offset = offset
            if epoch > self._epoch:
                self._epoch = epoch
            self._cond.notify_all()

    # ------------------------------------------------------------- waits --
    def wait_for_update(self, since_epoch: int, timeout: float,
                        target: Optional[float] = None) -> bool:
        """Block until the epoch moves past ``since_epoch`` (WAITFORCLOCKUPDATE).

        ``timeout`` is in wall seconds.  Returns True if an update arrived,
        False on timeout — the graceful-degradation path of Algorithm 1: by
        then wall time (and hence virtual time) has advanced by ``timeout``.
        ``target`` is the virtual time the caller is riding toward; a local
        condition wake is cheap so this implementation ignores it, but
        remote-clock subclasses (the shm seqlock word) use it to stay
        asleep through epoch bumps that can't matter to the caller.
        """
        if timeout <= 0:
            with self._cond:
                return self._epoch != since_epoch
        deadline = self.wall.time() + timeout
        with self._cond:
            while self._epoch == since_epoch:
                remaining = deadline - self.wall.time()
                if remaining <= 0:
                    return False
                if isinstance(self.wall, ManualWallSource):
                    # Deterministic tests drive wall time manually; a pure
                    # condition-wait keyed on real time would deadlock.
                    # Yield the GIL so the driving thread can advance time.
                    self._cond.release()
                    try:
                        time.sleep(1e-4)
                    finally:
                        self._cond.acquire()
                else:
                    self._cond.wait(timeout=remaining)
            return True
