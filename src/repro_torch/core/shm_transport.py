"""Shared-memory transport for the virtual time protocol (zero-syscall clock).

The framed-TCP transport (:mod:`repro.core.transport`) pays a pickle/msgpack +
socket syscall round trip for every clock read that misses the replica cache,
every jump-run submission, and — worst of all — one write *per replica* for
every epoch broadcast.  This module replaces all of that with shared memory,
keeping the protocol logic byte-identical (both servers dispatch through
:func:`repro.core.transport.handle_timekeeper_request`; the client satisfies
the same :class:`~repro.core.client.ActorTransport` surface).

Three pieces:

* **Seqlock clock word** (:class:`ShmClockWord`) — a single 32-byte
  ``(seq, offset, epoch, flags)`` record in its own
  :mod:`multiprocessing.shared_memory` segment.  The Timekeeper's broadcast
  hook performs ONE word write per epoch bump — no per-replica fan-out at
  all — and every child's ``clock.now()`` / epoch watch becomes a lock-free
  read with zero syscalls (``time.time`` is vDSO).  Writes bracket the
  payload with an odd/even sequence counter; readers retry on a torn or
  in-flight read.  Single writer (the parent, under the Timekeeper lock).

* **SPSC rings** (:class:`ShmRing`) — one segment per child carries four
  single-producer/single-consumer byte rings (timekeeper request/reply +
  control-plane command/reply) of length-prefixed frames.  Waiting is
  adaptive: a brief spin (skipped entirely on 1–2 CPU hosts, where a spinner
  starves the only core the producer could run on), then escalating
  ``time.sleep`` naps capped at 1 ms.  Deliberately NO blocking primitives
  are shared between processes: a ``multiprocessing.Event``/``Lock`` whose
  holder is SIGKILLed mid-operation leaves its internal semaphore locked
  forever, deadlocking every later acquire — exactly the crash the fault
  layer injects.  Pure polling shares only bytes, which a dead peer cannot
  poison, and the 1 ms cap bounds idle wake latency far below any slow-step.

* **Endpoints** (:class:`ShmEndpoint`) — segment lifecycle.  The parent
  creates (and ultimately unlinks) every segment; children only ever attach.
  A SIGKILLed child therefore cannot leak names: the parent-side handle
  reclaims the segment after the ledger snapshot, which is the crash
  semantics the fault layer relies on.

Memory ordering: CPython executes the seqlock/ring stores as distinct
bytecodes under the GIL's sequentially-consistent handoff on x86-64 (TSO);
the 8-byte cursors are single aligned stores.  On architectures with weaker
ordering and a free-threaded interpreter this would need real fences — the
rings are parameterized narrowly enough that such a port is local to this
file.

Python 3.10 wart: attaching to an existing segment registers it with the
``resource_tracker``, which would unlink it when the *child* exits and spam
leak warnings.  ``_untrack`` undoes that registration right after attach
(3.13 grew ``track=False`` for exactly this).
"""

from __future__ import annotations

import itertools
import os
import select
import socket as _socket
import struct
import threading
import time
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Callable, Optional, Tuple

import msgpack

from .client import TransportClosed
from .clock import UnixWallSource, VirtualClock
from .timekeeper import Timekeeper
from .transport import handle_timekeeper_request

__all__ = [
    "ShmClockWord", "ShmReplicaClock", "ShmRing", "ShmChannel",
    "ShmEndpoint", "ShmEndpointSpec", "ShmTransport", "ShmTimekeeperServer",
]

# A 1-CPU box (common in CI containers) cannot afford busy-waiting: a
# spinning consumer occupies the only core its producer needs.  With real
# parallelism a short spin wins the common sub-millisecond handoff.
_CPUS = os.cpu_count() or 1
_SPINS = 0 if _CPUS <= 2 else 200
_YIELDS = 8           # sched_yield passes before sleeping: on a saturated
                      # host the peer is usually runnable, and donating the
                      # timeslice resolves the wait in one context switch
_PAUSE_MIN = 50e-6
_PAUSE_MAX = 1e-3     # idle loops: passive listeners between bursts
_PAUSE_RPC = 200e-6   # latency-critical waits: RPC replies + epoch watch
                      # sit in the barrier's serial path, so their wake
                      # quantum directly bounds round throughput
_WAIT_QUANTUM = 0.05  # wake-socket safety net: a blocked consumer re-checks
                      # the ring at this period even if every wake byte were
                      # lost — a liveness bound, not a latency budget


class _WakeSock:
    """One-byte doorbell over a connected AF_UNIX stream socket.

    Producers ``kick()`` (non-blocking one-byte send; a full buffer means a
    wake is already pending, which is exactly as good) and consumers
    ``wait()`` in ``select`` — a *blocking* kernel wait, so an idle process
    burns zero CPU between barrier rounds.  Crash safety comes from fd
    semantics rather than shared state: SIGKILL closes the peer's end, the
    waiter's select wakes with EOF, and the channel flips to ``dead`` —
    callers then fall back to the bounded-poll path and its ``peer_alive``
    drain-then-None handling.  Nothing a dead process held can wedge us.
    """

    def __init__(self, sock: "_socket.socket"):
        sock.setblocking(False)
        self._sock = sock
        self.dead = False

    def fileno(self) -> int:
        return self._sock.fileno()

    def kick(self) -> None:
        if self.dead:
            return
        try:
            self._sock.send(b"\0")
        except (BlockingIOError, InterruptedError):
            pass                      # wake already pending
        except OSError:
            self.dead = True

    def drain(self) -> None:
        """Consume pending wake bytes (EOF marks the channel dead)."""
        try:
            while True:
                data = self._sock.recv(4096)
                if not data:
                    self.dead = True
                    return
                if len(data) < 4096:
                    return
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self.dead = True

    def wait(self, timeout: float) -> bool:
        """Block until kicked (or EOF) or ``timeout`` seconds; True if woken.

        Uses stateless ``select.select`` so concurrent waiters on the same
        doorbell (an RPC reply wait racing an epoch watch) are merely
        inefficient — one steals the byte, the other times out at the
        quantum and re-checks — never incorrect.
        """
        if self.dead:
            return True
        try:
            ready, _, _ = select.select([self._sock], [], [], max(0.0, timeout))
        except (OSError, ValueError):
            self.dead = True
            return True
        if not ready:
            return False
        self.drain()
        return True

    def close(self) -> None:
        self.dead = True
        try:
            self._sock.close()
        except OSError:
            pass


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment WITHOUT registering it for cleanup.

    On 3.10, ``SharedMemory(name=...)`` registers the segment with the
    resource tracker — which children share with the parent — so a child
    attach would (a) let the tracker unlink a segment the parent still
    owns and (b) clobber the parent's own registration, breaking the
    parent's unlink.  Suppressing registration for the attach call is the
    standard workaround (3.13 grew ``track=False`` for exactly this).
    Attaches in this module happen serially at process/endpoint startup,
    so the brief monkeypatch window is single-threaded in practice.
    """
    from multiprocessing import resource_tracker
    original = resource_tracker.register
    resource_tracker.register = lambda *a, **kw: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = original


# ---------------------------------------------------------------------------
# Seqlock clock word
# ---------------------------------------------------------------------------

_CLOCK = struct.Struct("<QdQQ")     # seq, offset, epoch, flags
_U64 = struct.Struct("<Q")
_FLAG_CLOSED = 1


class ShmClockWord:
    """One seqlock-protected ``(offset, epoch)`` record in shared memory.

    Single writer (the Timekeeper owner); any number of lock-free readers.
    ``flags`` bit 0 is the *closed* marker, published on server shutdown so
    replica waiters wake immediately instead of riding out a degradation
    timeout.
    """

    SIZE = _CLOCK.size

    def __init__(self, shm: shared_memory.SharedMemory, *, owner: bool):
        self._shm = shm
        self._owner = owner
        self._released = False
        # (seq, offset, epoch, closed) of the last validated read: clock
        # reads dominate the replica hot loop, and the word changes only at
        # epoch bumps, so a matching seq skips the full unpack + validation.
        # Stored as one tuple so the GIL makes the cache swap atomic.
        self._cache: Tuple[int, float, int, bool] = (-1, 0.0, 0, False)
        if owner:
            _CLOCK.pack_into(shm.buf, 0, 0, 0.0, 0, 0)

    @classmethod
    def create(cls) -> "ShmClockWord":
        return cls(shared_memory.SharedMemory(create=True, size=cls.SIZE),
                   owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmClockWord":
        return cls(_attach_untracked(name), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def publish(self, offset: float, epoch: int, *, closed: bool = False) -> None:
        """Seqlock write: odd seq while the payload is torn, even when done."""
        buf = self._shm.buf
        (seq,) = _U64.unpack_from(buf, 0)
        (flags,) = _U64.unpack_from(buf, 24)
        if closed:
            flags |= _FLAG_CLOSED
        _U64.pack_into(buf, 0, seq + 1)                       # odd: in flight
        struct.pack_into("<dQQ", buf, 8, float(offset), int(epoch), flags)
        _U64.pack_into(buf, 0, seq + 2)                       # even: stable

    def read(self) -> Tuple[float, int, bool]:
        """Lock-free read, retrying across in-flight writes."""
        buf = self._shm.buf
        (s,) = _U64.unpack_from(buf, 0)
        cache = self._cache
        if s == cache[0]:
            return cache[1], cache[2], cache[3]
        spins = 0
        while True:
            s1, offset, epoch, flags = _CLOCK.unpack_from(buf, 0)
            if not (s1 & 1):
                (s2,) = _U64.unpack_from(buf, 0)
                if s1 == s2:
                    closed = bool(flags & _FLAG_CLOSED)
                    self._cache = (s1, offset, epoch, closed)
                    return offset, epoch, closed
            spins += 1
            if spins > 16:
                time.sleep(0)     # yield: writer may hold the only core

    def close(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class ShmReplicaClock(VirtualClock):
    """Replica-side clock view over the seqlock word.

    Every read (``now``/``offset``/``epoch``/``snapshot``) is a lock-free
    shared-memory load — no socket, no broadcast frame, no syscall.  The
    mutation surface of :class:`VirtualClock` is neutered: the word is
    authoritative, so piggybacked ack updates and the transport-death
    fallback bump have nothing to install.
    """

    def __init__(self, word: ShmClockWord):
        super().__init__(UnixWallSource())
        self._word = word
        self._wake_ring: Optional["ShmRing"] = None

    def bind_wake(self, ring: "ShmRing") -> None:
        """Route epoch watches through ``ring``'s doorbell (the timekeeper
        reply ring): the server's broadcast hook kicks every advertised
        sleeper after publishing the word, so degradation waits block
        instead of polling.  Reply-frame kicks on the same doorbell are
        harmless spurious wakes — the watch re-checks the word and goes
        back to sleep."""
        self._wake_ring = ring

    def now(self) -> float:
        return self.wall.time() + self._word.read()[0]

    @property
    def offset(self) -> float:
        return self._word.read()[0]

    @property
    def epoch(self) -> int:
        return self._word.read()[1]

    @property
    def closed(self) -> bool:
        return self._word.read()[2]

    def snapshot(self) -> Tuple[float, int]:
        offset, epoch, _ = self._word.read()
        return self.wall.time() + offset, epoch

    def advance_to(self, t_min: float) -> float:
        return self.now()

    def apply_update(self, offset: float, epoch: int) -> None:
        pass

    def wait_for_update(self, since_epoch: int, timeout: float,
                        target: Optional[float] = None) -> bool:
        """Adaptive epoch watch: block on the doorbell, poll as fallback.

        Same contract as the Condition-based base class: True iff the epoch
        moved past ``since_epoch`` (a closed word also returns True so
        waiters re-check liveness instead of sleeping out the degradation
        timeout).  ``target`` — the virtual time the caller is jumping to —
        lets the server's broadcast skip this sleeper for rounds that don't
        reach it: per round only the actors whose turn arrived wake, not
        the whole fleet (the shm-only cure for the thundering herd; late
        epoch observation is fine because the caller re-checks ``now``
        against its own target anyway).  The quantum backstop still bounds
        how stale the returned epoch view can get.
        """
        offset, epoch, closed = self._word.read()
        if epoch != since_epoch or closed:
            return True
        if timeout <= 0:
            return False
        deadline = self.wall.time() + timeout
        ring = self._wake_ring
        wake = ring.wake if ring is not None else None
        if wake is not None:
            want = _NEG_INF if target is None else float(target)
            # Event-driven watch: advertise on the reply ring's flag, then
            # re-read the word (publish either preceded the flag — we see
            # it — or followed it — the hook kicks us), then block.
            while not wake.dead:
                remaining = deadline - self.wall.time()
                if remaining <= 0:
                    return False
                ring.advertise(True, want)
                offset, epoch, closed = self._word.read()
                if epoch != since_epoch or closed:
                    ring.advertise(False)
                    return True
                wake.wait(min(_WAIT_QUANTUM, remaining))
                ring.advertise(False)
                offset, epoch, closed = self._word.read()
                if epoch != since_epoch or closed:
                    return True
        spins = _SPINS
        yields = _YIELDS
        pause = _PAUSE_MIN
        while True:
            offset, epoch, closed = self._word.read()
            if epoch != since_epoch or closed:
                return True
            if spins > 0:
                spins -= 1
                continue
            if yields > 0:
                yields -= 1
                time.sleep(0)       # donate the slice to whoever resolves
                continue
            remaining = deadline - self.wall.time()
            if remaining <= 0:
                return False
            time.sleep(min(pause, remaining))
            pause = min(pause * 2, _PAUSE_RPC)


# ---------------------------------------------------------------------------
# SPSC ring
# ---------------------------------------------------------------------------

_RING_HDR = 32        # head u64 | tail u64 | eof u8 | waiting u8 | pad | target f64
_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_EOF = 16
_OFF_WAIT = 17        # consumer-asleep flag: producers doorbell only when set
_OFF_TARGET = 24      # wake-target virtual time (f64) qualifying the flag:
                      # epoch broadcasts kick the sleeper only once virtual
                      # now has reached it (-inf = kick on any event)
_FRAME_LEN = struct.Struct("<I")
_F64 = struct.Struct("<d")
_NEG_INF = float("-inf")


class ShmRing:
    """Single-producer/single-consumer byte ring of length-prefixed frames.

    Cursors are free-running u64s (``used = tail - head``); payloads wrap
    with a two-part copy, no skip markers.  Either side may raise the ``eof``
    flag: producers set it on graceful close (the TCP-EOF equivalent — the
    consumer drains queued frames first, preserving "completions already on
    the wire" ledger exactness), and a consumer may force it locally after
    the peer is known dead so its own reader unblocks.

    Waiting is event-driven when a :class:`_WakeSock` doorbell is attached
    (``wake``): the consumer advertises sleep via a flag byte in the ring
    header, re-checks the ring to close the lost-wake window, then *blocks*
    in ``select`` — zero CPU while idle, which is what makes the shm path
    cheaper than TCP on saturated hosts, not just lower-latency.  Producers
    pay one non-blocking one-byte send only when the flag is up (syscall
    elision).  Without a doorbell — or after the peer's death closes it —
    waiting degrades to polling with escalating sleeps capped at 1 ms.

    No cross-process locks or events anywhere, so a SIGKILLed peer can
    never leave a blocking primitive wedged: the doorbell is a plain fd the
    kernel closes on crash (waking the select with EOF), and ``peer_alive``
    turns a dead peer — which can never set eof — into a drained-then-None
    stream instead of a hang.
    """

    def __init__(self, shm: shared_memory.SharedMemory, base: int,
                 capacity: int, *, zero: bool = False):
        self._shm = shm
        self._base = base
        self._cap = capacity
        if zero:
            shm.buf[base:base + _RING_HDR] = bytes(_RING_HDR)
        self.frames_in = 0        # frames this side consumed
        self.frames_out = 0       # frames this side produced
        self.wake: Optional[_WakeSock] = None   # doorbell (both roles)

    # -- cursor plumbing ---------------------------------------------------
    def _load(self, off: int) -> int:
        (v,) = _U64.unpack_from(self._shm.buf, self._base + off)
        return v

    def _store(self, off: int, value: int) -> None:
        _U64.pack_into(self._shm.buf, self._base + off, value)

    @property
    def eof(self) -> bool:
        return bool(self._shm.buf[self._base + _OFF_EOF])

    def set_eof(self) -> None:
        """Graceful close marker (producer side) — consumer drains first."""
        try:
            self._shm.buf[self._base + _OFF_EOF] = 1
        except (ValueError, TypeError):
            return            # segment already torn down
        if self.wake is not None:
            self.wake.kick()  # unconditional: teardown must wake a sleeper

    force_eof = set_eof   # consumer-side unblock after peer death: same flag

    def ready(self) -> bool:
        """Cheap non-consuming check: committed data or EOF visible."""
        return (self._load(_OFF_TAIL) != self._load(_OFF_HEAD)) or self.eof

    def advertise(self, on: bool, target: float = _NEG_INF) -> None:
        """Raise/lower the consumer-asleep flag (doorbell elision).

        ``target`` (virtual seconds) qualifies *broadcast* kicks: a sleeper
        waiting out a time jump only cares about the round that carries
        virtual now past its own target, so intermediate epoch bumps leave
        it asleep instead of thundering every replica awake per round.
        Data-frame kicks ignore the target — a frame is always worth a wake.
        The target is written before the flag so a producer that sees the
        flag always reads a current target.
        """
        buf = self._shm.buf
        try:
            if on:
                _F64.pack_into(buf, self._base + _OFF_TARGET, target)
                buf[self._base + _OFF_WAIT] = 1
            else:
                buf[self._base + _OFF_WAIT] = 0
        except (ValueError, TypeError):
            pass

    def _kick(self) -> None:
        """Producer-side doorbell: ring only if the consumer advertised."""
        w = self.wake
        if w is None or w.dead:
            return
        off = self._base + _OFF_WAIT
        try:
            buf = self._shm.buf
            if buf[off]:
                buf[off] = 0      # claim this wake; sleeper re-advertises
                w.kick()
        except (ValueError, TypeError):
            pass

    def kick_if_due(self, now: float) -> None:
        """Broadcast-side doorbell: wake the sleeper only if virtual ``now``
        has reached its advertised target (or it advertised no target)."""
        w = self.wake
        if w is None or w.dead:
            return
        off = self._base + _OFF_WAIT
        try:
            buf = self._shm.buf
            if buf[off]:
                (target,) = _F64.unpack_from(buf, self._base + _OFF_TARGET)
                if now >= target:
                    buf[off] = 0
                    w.kick()
        except (ValueError, TypeError):
            pass

    # -- producer ----------------------------------------------------------
    def send_bytes(self, payload: bytes,
                   peer_alive: Optional[Callable[[], bool]] = None) -> None:
        need = _FRAME_LEN.size + len(payload)
        if need > self._cap - 8:
            raise ValueError(
                f"frame of {need} bytes exceeds ring capacity {self._cap}"
            )
        data = _FRAME_LEN.pack(len(payload)) + payload
        pause = _PAUSE_MIN
        while True:
            if self.eof:
                raise TransportClosed("shm ring closed")
            head = self._load(_OFF_HEAD)
            tail = self._load(_OFF_TAIL)
            if self._cap - (tail - head) >= need:
                break
            # Ring full: the consumer is behind.  Back off; on the slow path
            # make sure it still exists.
            time.sleep(pause)
            pause = min(pause * 2, _PAUSE_MAX)
            if pause >= _PAUSE_MAX and peer_alive is not None \
                    and not peer_alive():
                raise TransportClosed("shm ring peer died (ring full)")
        pos = tail % self._cap
        first = min(len(data), self._cap - pos)
        dst = self._base + _RING_HDR
        buf = self._shm.buf
        buf[dst + pos:dst + pos + first] = data[:first]
        if first < len(data):
            rest = data[first:]
            buf[dst:dst + len(rest)] = rest
        self._store(_OFF_TAIL, tail + len(data))    # commit AFTER the copy
        self.frames_out += 1
        self._kick()              # wake the consumer iff it advertised sleep

    # -- consumer ----------------------------------------------------------
    _EMPTY = object()     # poll(): "no frame yet" (distinct from EOF None)

    def poll(self):
        """Non-blocking receive: a frame, ``None`` at EOF-and-drained, or
        :attr:`ShmRing._EMPTY` when the ring is open but has nothing yet.
        The fan-in multiplexer scans many rings with this."""
        buf = self._shm.buf
        head = self._load(_OFF_HEAD)
        tail = self._load(_OFF_TAIL)
        if tail - head >= _FRAME_LEN.size:
            # tail commits only whole frames, so the full frame is here.
            pos = head % self._cap
            src = self._base + _RING_HDR
            first = min(_FRAME_LEN.size, self._cap - pos)
            raw = bytes(buf[src + pos:src + pos + first])
            if first < _FRAME_LEN.size:
                raw += bytes(buf[src:src + _FRAME_LEN.size - first])
            (length,) = _FRAME_LEN.unpack(raw)
            start = head + _FRAME_LEN.size
            pos = start % self._cap
            first = min(length, self._cap - pos)
            payload = bytes(buf[src + pos:src + pos + first])
            if first < length:
                payload += bytes(buf[src:src + length - first])
            self._store(_OFF_HEAD, start + length)
            self.frames_in += 1
            return payload
        if self.eof:
            return None
        return ShmRing._EMPTY

    def recv_bytes(self, timeout: Optional[float] = None,
                   peer_alive: Optional[Callable[[], bool]] = None,
                   max_pause: float = _PAUSE_MAX) -> Optional[bytes]:
        """Next frame; None once the ring is drained AND (eof | peer dead).

        Raises :class:`TransportClosed` if ``timeout`` (wall seconds)
        elapses with the ring still open and empty.  With a live doorbell
        the wait *blocks* in select (zero CPU); ``max_pause`` only shapes
        the poll fallback: latency-critical callers (RPC replies) pass
        :data:`_PAUSE_RPC`; passive listeners keep the idle default.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = _SPINS
        yields = _YIELDS
        pause = _PAUSE_MIN
        while True:
            got = self.poll()
            if got is None or got is not ShmRing._EMPTY:
                return got
            if deadline is None:
                remaining = None
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportClosed(
                        f"no frame within {timeout}s on shm ring"
                    )
            wake = self.wake
            if wake is not None and not wake.dead:
                # Event-driven wait: advertise sleep, re-check (the producer
                # either sees the flag or we see its commit — no lost wake),
                # then block.  The quantum is a liveness backstop only.
                self.advertise(True)
                got = self.poll()
                if got is None or got is not ShmRing._EMPTY:
                    self.advertise(False)
                    return got
                q = _WAIT_QUANTUM if remaining is None \
                    else min(_WAIT_QUANTUM, remaining)
                wake.wait(q)
                self.advertise(False)
                if wake.dead and peer_alive is not None and not peer_alive():
                    got = self.poll()
                    return None if got is ShmRing._EMPTY else got
                continue
            # Poll fallback: no doorbell (bare rings, non-Linux) or the
            # peer's death closed it.
            if spins > 0:
                spins -= 1
                continue
            if yields > 0:
                yields -= 1
                time.sleep(0)     # donate the slice to the producer
                continue
            time.sleep(pause if remaining is None else min(pause, remaining))
            if pause >= max_pause and peer_alive is not None \
                    and not peer_alive():
                # Dead peer cannot set eof: drain whatever it committed,
                # then surface EOF ourselves.
                got = self.poll()
                return None if got is ShmRing._EMPTY else got
            pause = min(pause * 2, max_pause)


# ---------------------------------------------------------------------------
# Endpoint: segment layout + lifecycle
# ---------------------------------------------------------------------------

_TK_CAP = 64 * 1024
_CTRL_CAP = 512 * 1024


@dataclass(frozen=True)
class ShmEndpointSpec:
    """Picklable child-side descriptor (crosses the spawn boundary).

    Plain strings and ints only — no multiprocessing synchronization
    objects, so nothing here can be wedged by a SIGKILLed holder.  ``wake``
    is the abstract-namespace AF_UNIX address of the parent's doorbell
    listener ('' when unavailable — waits then degrade to bounded polls).
    """
    segment: str
    clock: str
    caps: Tuple[int, int, int, int]        # tk_c2p, tk_p2c, ctrl_p2c, ctrl_c2p
    wake: str = ""


class ShmEndpoint:
    """One child's shared-memory attachment: four rings in one segment.

    Ring roles (direction is child-relative):

    ====================  ==================================================
    ``tk_c2p``            timekeeper requests (child produces)
    ``tk_p2c``            timekeeper replies (parent produces)
    ``ctrl_p2c``          control commands: submit/probe/stats/retire/...
    ``ctrl_c2p``          control replies + unsolicited ``complete`` frames
    ====================  ==================================================

    The parent creates the segment (``create``) and unlinks it (``unlink``)
    once the child is gone — crash reclaim included.  Children ``attach``
    and never own anything.
    """

    def __init__(self, shm: shared_memory.SharedMemory,
                 spec: ShmEndpointSpec, *, owner: bool):
        self._shm = shm
        self.spec = spec
        self._owner = owner
        base = 0
        rings = []
        for cap in spec.caps:
            rings.append(ShmRing(shm, base, cap, zero=owner))
            base += _RING_HDR + cap
        self.tk_c2p, self.tk_p2c, self.ctrl_p2c, self.ctrl_c2p = rings
        self._clock_word: Optional[ShmClockWord] = None
        self._listener: Optional["_socket.socket"] = None
        self._wake_tk: Optional[_WakeSock] = None
        self._wake_ctrl: Optional[_WakeSock] = None

    @classmethod
    def create(cls, clock_name: str, *, tk_cap: int = _TK_CAP,
               ctrl_cap: int = _CTRL_CAP) -> "ShmEndpoint":
        caps = (tk_cap, tk_cap, ctrl_cap, ctrl_cap)
        total = sum(_RING_HDR + c for c in caps)
        shm = shared_memory.SharedMemory(create=True, size=total)
        # Doorbell listener in the Linux abstract socket namespace: the
        # address is a plain string (crosses spawn inside the spec), needs
        # no filesystem cleanup, and is unique because the segment name is.
        listener = None
        wake = ""
        if hasattr(_socket, "AF_UNIX"):
            addr = "\0repro-wake-" + shm.name.strip("/")
            try:
                listener = _socket.socket(_socket.AF_UNIX,
                                          _socket.SOCK_STREAM)
                listener.bind(addr)
                listener.listen(2)
                wake = addr
            except OSError:
                if listener is not None:
                    listener.close()
                listener = None
                wake = ""
        spec = ShmEndpointSpec(shm.name, clock_name, caps, wake)
        ep = cls(shm, spec, owner=True)
        ep._listener = listener
        return ep

    @classmethod
    def attach(cls, spec: ShmEndpointSpec) -> "ShmEndpoint":
        ep = cls(_attach_untracked(spec.segment), spec, owner=False)
        if spec.wake:
            try:
                ep._bind_wakes(_WakeSock(_dial_wake(spec.wake, b"T")),
                               _WakeSock(_dial_wake(spec.wake, b"C")))
            except OSError:
                pass              # no doorbell: polling fallback, still correct
        return ep

    def _bind_wakes(self, tk: _WakeSock, ctrl: _WakeSock) -> None:
        self._wake_tk, self._wake_ctrl = tk, ctrl
        self.tk_c2p.wake = self.tk_p2c.wake = tk
        self.ctrl_p2c.wake = self.ctrl_c2p.wake = ctrl

    def accept_wakes(self, timeout: float = 5.0) -> bool:
        """Parent side: accept the child's two doorbell connections.

        Call once after spawning the child (which dials during ``attach``).
        Returns False — leaving every wait on its polling fallback — if the
        listener was never created or the child failed to dial in time;
        the transport stays correct either way.
        """
        listener, self._listener = self._listener, None
        if listener is None:
            return False
        conns = {}
        try:
            listener.settimeout(timeout)
            for _ in range(2):
                conn, _ = listener.accept()
                conn.settimeout(timeout)
                conns[conn.recv(1)] = conn
            tk, ctrl = conns.get(b"T"), conns.get(b"C")
            if tk is None or ctrl is None:
                raise OSError("doorbell handshake: missing ident")
            self._bind_wakes(_WakeSock(tk), _WakeSock(ctrl))
            return True
        except OSError:
            for conn in conns.values():
                conn.close()
            return False
        finally:
            listener.close()

    def close_wakes(self) -> None:
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        for w in (self._wake_tk, self._wake_ctrl):
            if w is not None:
                w.close()

    # -- child-side views --------------------------------------------------
    def child_channel(self) -> "ShmChannel":
        parent = _parent_alive_probe()
        return ShmChannel(send=self.ctrl_c2p, recv=self.ctrl_p2c,
                          peer_alive=parent)

    def child_transport(self, *, rpc_timeout: float = 30.0) -> "ShmTransport":
        if self._clock_word is None:
            self._clock_word = ShmClockWord.attach(self.spec.clock)
        transport = ShmTransport(
            send=self.tk_c2p, recv=self.tk_p2c,
            word=self._clock_word, rpc_timeout=rpc_timeout,
            peer_alive=_parent_alive_probe())
        # Epoch watches share the reply ring's doorbell: the server's
        # broadcast hook kicks advertised sleepers after each word publish.
        transport.clock.bind_wake(self.tk_p2c)
        return transport

    # -- parent-side views -------------------------------------------------
    def parent_channel(self, peer_alive=None) -> "ShmChannel":
        return ShmChannel(send=self.ctrl_p2c, recv=self.ctrl_c2p,
                          peer_alive=peer_alive)

    def unlink(self) -> None:
        """Reclaim the segment name (owner only; mappings stay valid).

        Also releases the doorbell fds — by reclaim time the child is gone
        and every parent-side reader has drained, so nothing waits on them.
        """
        if self._owner:
            self.close_wakes()
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


def _dial_wake(addr: str, ident: bytes) -> "_socket.socket":
    """Child side: connect one doorbell and identify it (``T``/``C``)."""
    sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    try:
        sock.settimeout(5.0)
        sock.connect(addr)
        sock.sendall(ident)
    except OSError:
        sock.close()
        raise
    return sock


def _parent_alive_probe() -> Callable[[], bool]:
    import multiprocessing
    parent = multiprocessing.parent_process()
    if parent is None:
        return lambda: True
    return parent.is_alive


# ---------------------------------------------------------------------------
# Control-plane channel (pickle objects, duplex over one ring pair)
# ---------------------------------------------------------------------------


class ShmChannel:
    """Duplex framed-object channel over an SPSC ring pair.

    Drop-in for the process backend's socket control channel: ``send_obj``
    raises :class:`OSError` once closed (matching the socket contract the
    RPC layer maps to handle-death), ``recv_obj`` returns None at EOF.
    """

    def __init__(self, send: ShmRing, recv: ShmRing, *, peer_alive=None):
        import pickle
        self._pickle = pickle
        self._send = send
        self._recv = recv
        self._peer_alive = peer_alive
        self._send_lock = threading.Lock()
        self._closed = False

    def send_obj(self, obj) -> None:
        body = self._pickle.dumps(obj, protocol=self._pickle.HIGHEST_PROTOCOL)
        with self._send_lock:
            if self._closed:
                raise OSError("shm channel closed")
            try:
                self._send.send_bytes(body, peer_alive=self._peer_alive)
            except TransportClosed as e:
                raise OSError(str(e)) from None

    def recv_obj(self, timeout: Optional[float] = None):
        body = self._recv.recv_bytes(timeout=timeout,
                                     peer_alive=self._peer_alive)
        if body is None:
            return None
        return self._pickle.loads(body)

    def mark_peer_dead(self) -> None:
        """Unblock the local reader after a SIGKILL (drains, then EOF)."""
        self._recv.force_eof()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._send.set_eof()      # peer drains queued frames, then sees EOF
        self._recv.force_eof()    # our own reader unblocks likewise


# ---------------------------------------------------------------------------
# Timekeeper plane
# ---------------------------------------------------------------------------


class ShmTransport:
    """Child-side :class:`~repro.core.client.ActorTransport` over shm rings.

    Same wire ops as :class:`SocketTransport`, but the clock is a
    :class:`ShmReplicaClock` — reads never touch the rings — and the
    hot-path jump ops are *one-way*: the seqlock word supplies the epoch a
    jump ack would have carried, so the per-event ack round trip (a full
    child<->server ping-pong) disappears (see :meth:`_send_oneway`).  Real
    RPCs (register/park/...) are serialized under one lock: the ring pair
    is SPSC and the server answers strictly in order, so request/reply
    matching is positional (rids are kept for protocol identity and error
    messages).
    """

    def __init__(self, send: ShmRing, recv: ShmRing, word: ShmClockWord, *,
                 rpc_timeout: float = 30.0, peer_alive=None):
        self._send = send
        self._recv = recv
        self.clock = ShmReplicaClock(word)
        self.rpc_timeout = float(rpc_timeout)
        self._peer_alive = peer_alive
        self._lock = threading.Lock()
        self._rid = itertools.count()
        self._closed = False

    def _rpc(self, msg: dict) -> dict:
        if self.closed:
            raise TransportClosed("transport closed")
        with self._lock:
            rid = next(self._rid)
            msg["rid"] = rid
            try:
                self._send.send_bytes(
                    msgpack.packb(msg, use_bin_type=True),
                    peer_alive=self._peer_alive,
                )
                body = self._recv.recv_bytes(timeout=self.rpc_timeout,
                                             peer_alive=self._peer_alive,
                                             max_pause=_PAUSE_RPC)
            except TransportClosed:
                self._closed = True
                raise
            if body is None:
                self._closed = True
                raise TransportClosed("transport closed (server gone)")
            reply = msgpack.unpackb(body, raw=False)
        if reply.get("rid") != rid:
            self._closed = True
            raise TransportClosed(
                f"shm reply out of order (got rid {reply.get('rid')}, "
                f"expected {rid})"
            )
        if reply["op"] == "error":
            raise KeyError(reply["error"])
        return reply

    # -------------------------------------------------- ActorTransport API --
    def register_actor(self, actor_id: str) -> None:
        self._rpc({"op": "register", "actor": actor_id})

    def deregister_actor(self, actor_id: str) -> None:
        self._rpc({"op": "deregister", "actor": actor_id})

    def park_actor(self, actor_id: str) -> None:
        self._rpc({"op": "park", "actor": actor_id})

    def unpark_actor(self, actor_id: str) -> None:
        self._rpc({"op": "unpark", "actor": actor_id})

    def _send_oneway(self, msg: dict) -> int:
        """Fire-and-forget fan-in frame; returns the pre-send clock epoch.

        A jump ack's only payload is the epoch to wait past, and the
        seqlock word hands us that for free: read it *before* the frame is
        committed — any round that later consumes the target must bump
        past it — then send without waiting for a reply.  That halves the
        context switches on the per-event critical path (the ack round
        trip was one full child<->mux ping-pong per jump).  A staler-than
        -ack epoch only means the waiter may wake one round early and
        re-check its target, which the wait loop does anyway.  Server-side
        errors (a jump for an unregistered actor) cannot surface here; the
        waiter's degradation timeout keeps that bug path slow-but-correct,
        and a *closed* server still raises promptly — the word's closed
        flag wakes the waiter and the client's liveness check fires.
        """
        if self.closed:
            raise TransportClosed("transport closed")
        msg["oneway"] = True
        with self._lock:
            msg["rid"] = next(self._rid)
            epoch = self.clock.epoch
            try:
                self._send.send_bytes(
                    msgpack.packb(msg, use_bin_type=True),
                    peer_alive=self._peer_alive,
                )
            except TransportClosed:
                self._closed = True
                raise
        return epoch

    def send_jump_request(self, actor_id: str, t_target: float) -> int:
        return self._send_oneway(
            {"op": "jump", "actor": actor_id, "target": t_target}
        )

    def send_jump_run(self, actor_id: str, targets, *, unpark: bool = False,
                      park_after: bool = False) -> int:
        msg = {"op": "jump_run", "actor": actor_id,
               "targets": [float(t) for t in targets]}
        if unpark:
            msg["unpark"] = True
        if park_after:
            msg["park_after"] = True
        return self._send_oneway(msg)

    @property
    def closed(self) -> bool:
        return self._closed or self.clock.closed

    def observer_time(self) -> float:
        self._rpc({"op": "time"})
        return self.clock.now()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # EOF on the request ring: the server's service loop drains, then
        # deregisters whatever this peer left behind (same as TCP conn death).
        self._send.set_eof()
        self._recv.force_eof()


class ShmTimekeeperServer:
    """Shared-memory front-end for a :class:`Timekeeper`.

    Drop-in for :class:`TimekeeperServer` where the cluster builder is
    concerned (``.timekeeper``, ``.close()``), but fan-out is ONE seqlock
    word write per epoch bump — the broadcast hook publishes straight into
    the clock segment, with no per-peer queue, no serialization, and no
    syscalls.  That is the "single latest-epoch write" collapse by
    construction: N bumps leave exactly one visible record.

    Fan-in is ONE multiplexer thread scanning every child's request ring:
    barrier traffic arrives in waves (a round's worth of jump requests
    lands nearly simultaneously), so a single wake services the whole wave
    — no per-child thread wakeups, no per-child scheduling jitter in the
    round's serial path.  Requests dispatch through the same
    :func:`handle_timekeeper_request` as the TCP server; a ring EOF or a
    dead child deregisters its actors so the barrier is never wedged by a
    crashed worker.
    """

    def __init__(self, timekeeper: Optional[Timekeeper] = None, *,
                 jitter_cooldown: float = 500e-6):
        self.timekeeper = timekeeper or Timekeeper(
            VirtualClock(UnixWallSource()), jitter_cooldown=jitter_cooldown
        )
        self.clock_word = ShmClockWord.create()
        self.address = ("shm", self.clock_word.name)
        self._peers: list = []        # [recv, send, peer_alive, actors_here]
        self._peers_lock = threading.Lock()
        self._mux: Optional[threading.Thread] = None
        self._closed = False
        tk = self.timekeeper
        self.clock_word.publish(tk.clock.offset, tk.clock.epoch)
        tk.add_broadcast_hook(self._broadcast)

    def _broadcast(self, offset: float, epoch: int) -> None:
        """Epoch bump: one seqlock word write, then doorbell only sleepers
        whose advertised wake target this round reached — the rest stay
        asleep through rounds that aren't theirs (no thundering herd), and
        a child that advertised nothing costs zero syscalls."""
        self.clock_word.publish(offset, epoch)
        now = time.time() + offset
        for peer in tuple(self._peers):
            peer[1].kick_if_due(now)

    def serve(self, recv: ShmRing, send: ShmRing, *, peer_alive=None,
              name: str = "shm-tk") -> threading.Thread:
        """Register one child's timekeeper ring pair with the multiplexer
        (started lazily on the first peer; ``name`` names that thread)."""
        with self._peers_lock:
            self._peers.append([recv, send, peer_alive, set()])
            if self._mux is None:
                self._mux = threading.Thread(
                    target=self._mux_loop, name=name, daemon=True)
                self._mux.start()
            return self._mux

    def _retire_peer(self, peer) -> None:
        # Peer death == actor death: deregister so the barrier is never
        # wedged by a crashed worker (fault tolerance, as on TCP).
        tk = self.timekeeper
        for actor in peer[3]:
            try:
                tk.deregister_actor(actor)
            except (KeyError, RuntimeError):
                pass
        with self._peers_lock:
            if peer in self._peers:
                self._peers.remove(peer)

    def _mux_loop(self) -> None:
        tk = self.timekeeper
        empty = ShmRing._EMPTY
        poller = select.poll()
        registered: dict = {}          # fd -> _WakeSock
        pause = _PAUSE_MIN
        while not self._closed:
            with self._peers_lock:
                peers = list(self._peers)
            progressed = False
            for peer in peers:
                recv, send, peer_alive, actors_here = peer
                while True:                        # drain the whole wave
                    got = recv.poll()
                    if got is empty:
                        break
                    if got is None:                # graceful EOF
                        self._retire_peer(peer)
                        progressed = True
                        break
                    progressed = True
                    msg = msgpack.unpackb(got, raw=False)
                    reply = handle_timekeeper_request(tk, msg, actors_here)
                    if msg.get("oneway"):
                        # Jump fan-in is fire-and-forget over shm: the child
                        # pre-read its wait epoch from the clock word, so it
                        # is not reading a reply — sending one would desync
                        # the positional request/reply pairing of real RPCs.
                        # (An error reply for a one-way op is dropped; the
                        # waiter degrades to riding wall time, never wrong.)
                        continue
                    try:
                        send.send_bytes(
                            msgpack.packb(reply, use_bin_type=True),
                            peer_alive=peer_alive,
                        )
                    except TransportClosed:
                        self._retire_peer(peer)
                        break
            if progressed or self._closed:
                pause = _PAUSE_MIN
                continue
            # Idle: arm every doorbell, re-scan (closing the lost-wake
            # window), then block until any child kicks.  Children without
            # a live doorbell cap the block at the poll quantum instead.
            blocking = True
            armed = []
            ready = False
            for peer in peers:
                recv, _, peer_alive, _ = peer
                wake = recv.wake
                if wake is not None and not wake.dead:
                    fd = wake.fileno()
                    if fd not in registered:
                        poller.register(fd, select.POLLIN)
                        registered[fd] = wake
                    recv.advertise(True)
                    armed.append(recv)
                else:
                    blocking = False
                if recv.ready():
                    ready = True
                if peer_alive is not None and not peer_alive() \
                        and not recv.ready():
                    self._retire_peer(peer)        # dead AND drained
            if ready:
                for recv in armed:
                    recv.advertise(False)
                continue
            if blocking and armed:
                timeout_ms = int(_WAIT_QUANTUM * 1000)
            else:
                timeout_ms = max(1, int(pause * 1000))
                pause = min(pause * 2, _PAUSE_RPC)
            try:
                events = poller.poll(timeout_ms) if registered else None
            except OSError:
                events = None
            if events is None and not registered:
                time.sleep(timeout_ms / 1000.0)
            for fd, _ev in (events or ()):
                wake = registered.get(fd)
                if wake is None:
                    continue
                wake.drain()
                if wake.dead:
                    try:
                        poller.unregister(fd)
                    except (KeyError, OSError):
                        pass
                    registered.pop(fd, None)
            for recv in armed:
                recv.advertise(False)

    def close(self) -> None:
        """Final clock publish (with the closed flag) first, then teardown."""
        if self._closed:
            return
        self.timekeeper.close()       # final epoch bump -> hook -> word write
        tk = self.timekeeper
        self.clock_word.publish(tk.clock.offset, tk.clock.epoch, closed=True)
        self._closed = True
        with self._peers_lock:
            peers = list(self._peers)
        for recv, send, _, _ in peers:
            recv.force_eof()
            send.set_eof()
        if self._mux is not None:
            self._mux.join(timeout=5)
        self.clock_word.unlink()
        self.clock_word.close()
