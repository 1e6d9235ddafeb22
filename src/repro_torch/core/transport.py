"""Multi-process transport for the virtual time protocol.

The paper's deployment runs the benchmark runner and the inference engine as
separate OS processes wired to the Timekeeper over ZeroMQ (§5), with a
dedicated I/O thread for serialization/sockets and a background thread for
barrier state.  ZeroMQ is not available offline, so this module implements the
same architecture on stdlib TCP sockets:

* **fan-in** — each client connection gets a reader thread on the server;
  jump requests are applied to the shared :class:`Timekeeper` and acked
  with the pre-resolution epoch.
* **fan-out** — every clock epoch bump (barrier resolutions, deregistration
  fallback bumps, the final bump on close) enqueues one ``(offset, epoch)``
  record; a single broadcast thread serializes it *once* and writes it to
  every connection (constant serialization cost per round, per §4.2).

Framing: 4-byte big-endian length prefix + msgpack body.

Frame ops (fan-in requests carry a ``rid``; the reply echoes it):

====================  ====================================================
``register``          join the barrier set
``deregister``        leave permanently; re-evaluates the barrier, and the
                      epoch is bumped + broadcast even if no round resolves
``park`` ``unpark``   leave/re-join the barrier while staying known to the
                      Timekeeper (idle replica engines — the cluster-scale
                      fast path); parking re-evaluates the barrier so a
                      parked remote replica can never stall a round
``jump``              Algorithm 1 fan-in; ack carries the pre-resolution
                      epoch to wait past
``time``              one-shot observer query
``clock``             fan-out broadcast (no rid): replica clock update
====================  ====================================================

Every successful ack additionally piggybacks the server's current
``(clock_offset, clock_epoch)``, which the client installs on receipt.
Broadcasts and acks are FIFO per connection, but a *cross-channel* message
(the cluster control plane runs on separate sockets) can outrun a clock
broadcast; the piggyback bounds that staleness at one RPC — an actor that
just acked an operation acts on a clock at least as fresh as the server
state the ack observed.

Clients hold a *replica* :class:`VirtualClock` driven by clock-update frames.
Server and clients must share a wall epoch, so both sides default to
:class:`UnixWallSource` (``time.time`` — host-shared; cross-host adds NTP skew
as bounded timestamp error).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import uuid
from typing import Dict, Optional

import msgpack

from .client import TransportClosed
from .clock import UnixWallSource, VirtualClock
from .timekeeper import Timekeeper

__all__ = ["TimekeeperServer", "SocketTransport", "TransportClosed",
           "FrameWriter", "pack_frame", "handle_timekeeper_request"]

_LEN = struct.Struct(">I")


def pack_frame(body: bytes) -> bytes:
    """Length-prefix a serialized body into one wire frame."""
    return _LEN.pack(len(body)) + body


class FrameWriter:
    """Per-socket write combiner: one ``sendmsg`` per flush, many frames.

    Senders enqueue ready-to-wire frames under a cheap lock; the first
    sender in becomes the *flusher* and drains everything queued — including
    frames that arrive while it is inside the syscall — with a single
    scatter-gather ``sendmsg`` per drain.  Concurrent senders therefore pay
    one list append instead of one syscall each, which is exactly the
    process-mode hot path (clock piggybacks + completion acks per step).

    Falls back to ``sendall`` on partial writes and on sockets without
    ``sendmsg``.  Raises the underlying ``OSError`` to the flushing sender;
    frames it had drained are lost with the connection (same contract as the
    direct ``sendall`` path this replaces).

    ``send(frame, tag=...)`` marks the frame *coalescable*: if a frame with
    the same tag is still queued (the flusher is stuck inside a syscall on a
    slow socket), the new frame replaces it in place instead of appending.
    Clock broadcasts use this — replica clocks install updates with
    max(offset)/max(epoch), so only the newest queued update carries any
    information, and a burst of N epoch bumps leaves at most one pending
    clock frame per peer no matter how slow the socket drains.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._lock = threading.Lock()
        self._queue: list = []
        self._tag_pos: Dict[str, int] = {}
        self._flushing = False
        self.flushes = 0          # syscall batches issued
        self.frames = 0           # frames written (frames > flushes == win)
        self.coalesced = 0        # tagged frames superseded before hitting wire

    def pending(self) -> int:
        """Frames queued but not yet handed to a syscall (tests/metrics)."""
        with self._lock:
            return len(self._queue)

    def send(self, *frames: bytes, tag: Optional[str] = None) -> None:
        with self._lock:
            if tag is not None:
                pos = self._tag_pos.get(tag)
                if pos is not None:
                    self._queue[pos] = frames[0]
                    self.coalesced += len(frames)
                else:
                    self._tag_pos[tag] = len(self._queue)
                    self._queue.extend(frames)
            else:
                self._queue.extend(frames)
            if self._flushing:
                return            # the elected flusher will carry these out
            self._flushing = True
        try:
            while True:
                with self._lock:
                    batch, self._queue = self._queue, []
                    self._tag_pos.clear()
                    if not batch:
                        self._flushing = False
                        return
                self._write_batch(batch)
        except BaseException:
            with self._lock:
                self._flushing = False
            raise

    def _write_batch(self, batch: list) -> None:
        self.flushes += 1
        self.frames += len(batch)
        sendmsg = getattr(self._sock, "sendmsg", None)
        if sendmsg is None:
            self._sock.sendall(b"".join(batch))
            return
        total = sum(len(b) for b in batch)
        sent = sendmsg(batch)
        if sent < total:
            # Partial scatter-gather write (large batch vs. socket buffer):
            # finish the remainder with the reliable path.
            self._sock.sendall(b"".join(batch)[sent:])


def _send_frame(sock: socket.socket, obj: dict) -> None:
    body = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(pack_frame(body))


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return msgpack.unpackb(body, raw=False)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def handle_timekeeper_request(
    tk: Timekeeper, msg: dict, actors_here: set
) -> dict:
    """Apply one fan-in request to the Timekeeper and build the reply dict.

    This is the protocol logic shared by every server front-end — the TCP
    :class:`TimekeeperServer` and the shared-memory server in
    :mod:`repro.core.shm_transport` dispatch through the same function, so
    the wire ops (and their error/piggyback semantics) cannot drift between
    transports.  ``actors_here`` is the caller's per-peer registration set:
    it is mutated on register/deregister so the caller's cleanup path can
    deregister whatever a dead peer left behind.
    """
    op = msg["op"]
    try:
        if op == "jump":
            epoch = tk.request_jump(msg["actor"], msg["target"])
            reply = {"op": "jump_ack", "rid": msg["rid"], "epoch": epoch}
        elif op == "jump_run":
            epoch = tk.request_jump_run(
                msg["actor"],
                msg["targets"],
                unpark=bool(msg.get("unpark")),
                park_after=bool(msg.get("park_after")),
            )
            reply = {"op": "jump_ack", "rid": msg["rid"], "epoch": epoch}
        elif op == "register":
            tk.register_actor(msg["actor"])
            actors_here.add(msg["actor"])
            reply = {"op": "register_ack", "rid": msg["rid"]}
        elif op == "deregister":
            tk.deregister_actor(msg["actor"])
            actors_here.discard(msg["actor"])
            reply = {"op": "deregister_ack", "rid": msg["rid"]}
        elif op == "park":
            tk.park_actor(msg["actor"])
            reply = {"op": "park_ack", "rid": msg["rid"]}
        elif op == "unpark":
            tk.unpark_actor(msg["actor"])
            reply = {"op": "unpark_ack", "rid": msg["rid"]}
        elif op == "time":
            reply = {"op": "time_ack", "rid": msg["rid"]}
        else:
            reply = {"op": "error", "rid": msg.get("rid"),
                     "error": f"unknown op {op!r}"}
    except (KeyError, RuntimeError) as e:
        # Unregistered actor / closed Timekeeper: the *request* fails, the
        # peer (and its other actors) lives on.
        reply = {"op": "error", "rid": msg["rid"], "error": str(e)}
    if reply["op"] != "error":
        # Every ack piggybacks the current clock pair (distinct keys:
        # jump_ack's "epoch" is the *pre-resolution* value the client waits
        # past).  The reply path is FIFO with this peer's broadcasts, but a
        # *cross-channel* message (e.g. a cluster-plane submit racing the
        # fan-out) can outrun them — piggybacking bounds that staleness at
        # one RPC, so an actor acting on an ack always acts on a clock at
        # least as fresh as the state that ack observed.
        reply["clock_offset"] = tk.clock.offset
        reply["clock_epoch"] = tk.clock.epoch
    return reply


class TimekeeperServer:
    """TCP front-end for a :class:`Timekeeper` (the paper's Timekeeper service)."""

    def __init__(
        self,
        timekeeper: Optional[Timekeeper] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        jitter_cooldown: float = 500e-6,
    ):
        self.timekeeper = timekeeper or Timekeeper(
            VirtualClock(UnixWallSource()), jitter_cooldown=jitter_cooldown
        )
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._conns: Dict[int, socket.socket] = {}
        self._writers: Dict[int, FrameWriter] = {}
        self._conn_lock = threading.Lock()
        self._bcast_q: "queue.Queue[Optional[tuple[float, int]]]" = queue.Queue()
        self.timekeeper.add_broadcast_hook(
            lambda off, ep: self._bcast_q.put((off, ep))
        )
        self._stop = threading.Event()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="timekeeper-accept", daemon=True
        )
        self._bcast_thread = threading.Thread(
            target=self._broadcast_loop, name="timekeeper-broadcast", daemon=True
        )
        self._accept_thread.start()
        self._bcast_thread.start()

    # ---------------------------------------------------------- fan-out ---
    def _broadcast_loop(self) -> None:
        # Runs until the None sentinel: close() enqueues the Timekeeper's
        # final epoch bump *before* the sentinel, so remote waiters always
        # see the releasing update before their connection dies.
        while True:
            item = self._bcast_q.get()
            if item is None:
                return
            # Collapse a backlog to the latest queued update: replica clocks
            # install updates with max(offset)/max(epoch), so intermediate
            # records carry no information once a newer one exists — under
            # burst resolution this turns k pending broadcasts into one
            # frame per connection.  The sentinel still terminates us, but
            # only after the final (releasing) update has gone out.
            stop = False
            while True:
                try:
                    nxt = self._bcast_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                item = nxt
            offset, epoch = item
            # Serialize once, write to all (constant cost per round).
            frame = pack_frame(msgpack.packb(
                {"op": "clock", "offset": offset, "epoch": epoch},
                use_bin_type=True,
            ))
            with self._conn_lock:
                writers = list(self._writers.items())
            for cid, writer in writers:
                try:
                    # Tagged: a clock frame still queued behind a slow
                    # socket's flusher is replaced, never stacked — a burst
                    # of epoch bumps leaves <=1 pending frame per peer.
                    writer.send(frame, tag="clock")
                except OSError:
                    self._drop(cid)
            if stop:
                return

    # ----------------------------------------------------------- fan-in ---
    def _accept_loop(self) -> None:
        cid = 0
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            cid += 1
            with self._conn_lock:
                self._conns[cid] = conn
                self._writers[cid] = FrameWriter(conn)
            threading.Thread(
                target=self._serve_conn,
                args=(cid, conn),
                name=f"timekeeper-conn-{cid}",
                daemon=True,
            ).start()

    def _serve_conn(self, cid: int, conn: socket.socket) -> None:
        # Every actor this connection ever registered (parked ones included:
        # park keeps the actor known, so its death must still deregister it).
        actors_here: set[str] = set()
        tk = self.timekeeper
        with self._conn_lock:
            writer = self._writers.get(cid) or FrameWriter(conn)
        try:
            while True:
                msg = _recv_frame(conn)
                if msg is None:
                    break
                reply = handle_timekeeper_request(tk, msg, actors_here)
                # Reply through the shared per-connection writer so acks
                # coalesce with concurrent clock broadcasts into one
                # sendmsg flush instead of interleaved sendall syscalls.
                writer.send(pack_frame(
                    msgpack.packb(reply, use_bin_type=True)
                ))
        finally:
            # Connection death == actor death: deregister so the barrier is
            # never wedged by a crashed worker (fault tolerance).
            for actor in actors_here:
                tk.deregister_actor(actor)
            self._drop(cid)

    def _drop(self, cid: int) -> None:
        with self._conn_lock:
            conn = self._conns.pop(cid, None)
            self._writers.pop(cid, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Tear down: final clock broadcast first, then the sockets.

        ``Timekeeper.close`` bumps the epoch and fans it out through the
        broadcast hook, so every remote client — parked actors included —
        receives a releasing clock update *before* its connection is cut;
        nobody rides out a degradation timeout at shutdown.
        """
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.timekeeper.close()          # enqueues the final clock update
        self._bcast_q.put(None)          # sentinel AFTER the final update
        self._bcast_thread.join(timeout=5)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
            self._writers.clear()


class SocketTransport:
    """Client-side transport: replica clock + request/reply over one socket.

    Satisfies the :class:`repro.core.client.ActorTransport` protocol —
    including the park/unpark surface — so :class:`TimeJumpClient` (and
    therefore the engine code built on it) is byte-identical over this
    transport and the in-process :class:`~repro.core.client.LocalTransport`.
    Thread-safe: multiple actors in one process may share a transport.

    ``rpc_timeout`` bounds every request/reply round trip: a server that
    stops answering (wedged, dead, partitioned) surfaces as
    :class:`TransportClosed` after that many wall seconds instead of
    blocking the actor forever — the caller still holds a replica clock
    that advances at wall rate, so this is the degradation path of §4.2.1,
    never a correctness loss.
    """

    def __init__(self, address: tuple[str, int], *, rpc_timeout: float = 30.0):
        self._sock = socket.create_connection(address)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rpc_timeout = float(rpc_timeout)
        self.clock = VirtualClock(UnixWallSource())
        self._send_lock = threading.Lock()
        self._replies: Dict[str, "queue.Queue[dict]"] = {}
        self._replies_lock = threading.Lock()
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="timekeeper-client-reader", daemon=True
        )
        self._reader.start()

    # ------------------------------------------------------------ plumbing --
    def _read_loop(self) -> None:
        try:
            while True:
                msg = _recv_frame(self._sock)
                if msg is None:
                    break
                if msg["op"] == "clock":
                    # Fan-out path: install the broadcast into the replica.
                    self.clock.apply_update(msg["offset"], msg["epoch"])
                    continue
                rid = msg.get("rid")
                if rid is None:
                    continue
                with self._replies_lock:
                    q = self._replies.get(rid)
                if q is not None:
                    q.put(msg)
        finally:
            # Socket gone (server close / network death): fail every pending
            # RPC immediately and bump the replica clock epoch so local
            # waiters re-check instead of sleeping out their full
            # degradation timeout.  In a finally so no exception path can
            # leave the transport looking alive with a dead reader.
            self._closed = True
            with self._replies_lock:
                pending = list(self._replies.values())
            for q in pending:
                q.put({"op": "closed", "error": "transport closed"})
            self.clock.advance_to(self.clock.now())

    def _rpc(self, msg: dict, timeout: Optional[float] = None) -> dict:
        if self._closed:
            raise TransportClosed("transport closed")
        rid = uuid.uuid4().hex
        msg["rid"] = rid
        q: "queue.Queue[dict]" = queue.Queue(maxsize=1)
        with self._replies_lock:
            self._replies[rid] = q
        try:
            with self._send_lock:
                try:
                    _send_frame(self._sock, msg)
                except OSError as e:
                    raise TransportClosed(f"transport closed: {e}") from None
            try:
                reply = q.get(timeout=timeout if timeout is not None
                              else self.rpc_timeout)
            except queue.Empty:
                raise TransportClosed(
                    f"no reply to {msg['op']!r} within "
                    f"{timeout if timeout is not None else self.rpc_timeout}s"
                ) from None
        finally:
            with self._replies_lock:
                self._replies.pop(rid, None)
        if reply["op"] == "closed":
            raise TransportClosed(reply["error"])
        if reply["op"] == "error":
            raise KeyError(reply["error"])
        if "clock_offset" in reply:
            # Acks piggyback the server clock (see the server's reply path):
            # installing it here means every RPC refreshes the replica, so a
            # caller acting on an ack can never act on a clock staler than
            # the server state that ack observed.
            self.clock.apply_update(reply["clock_offset"],
                                    reply["clock_epoch"])
        return reply

    # -------------------------------------------------- ActorTransport API --
    def register_actor(self, actor_id: str) -> None:
        self._rpc({"op": "register", "actor": actor_id})

    def deregister_actor(self, actor_id: str) -> None:
        self._rpc({"op": "deregister", "actor": actor_id})

    def park_actor(self, actor_id: str) -> None:
        """Leave the barrier but stay known (idle replica fast path)."""
        self._rpc({"op": "park", "actor": actor_id})

    def unpark_actor(self, actor_id: str) -> None:
        self._rpc({"op": "unpark", "actor": actor_id})

    def send_jump_request(self, actor_id: str, t_target: float) -> int:
        return self._rpc({"op": "jump", "actor": actor_id, "target": t_target})[
            "epoch"
        ]

    def send_jump_run(
        self,
        actor_id: str,
        targets,
        *,
        unpark: bool = False,
        park_after: bool = False,
    ) -> int:
        """Batched fan-in: one frame carries a whole run of targets, plus any
        park/unpark transition folded in (saves the separate RPC per step)."""
        msg = {"op": "jump_run", "actor": actor_id,
               "targets": [float(t) for t in targets]}
        if unpark:
            msg["unpark"] = True
        if park_after:
            msg["park_after"] = True
        return self._rpc(msg)["epoch"]

    @property
    def closed(self) -> bool:
        """Liveness probe for the batched (no re-send) client loop."""
        return self._closed

    def observer_time(self) -> float:
        """One-shot observer query (also refreshes the replica)."""
        self._rpc({"op": "time"})
        return self.clock.now()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
