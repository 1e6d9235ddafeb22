"""Shared-memory transport: rings, seqlock clock word, and the shm
Timekeeper plane (paper §5, zero-syscall variant).

Covers the SPSC ring contract (framing, wrap, EOF drain ordering, oversize
rejection, dead-peer drain-then-None), seqlock torn-read safety under a
concurrent writer, the ActorTransport surface over rings (jump roundtrip,
coordination, park, server close), the epoch-broadcast collapse on BOTH
transports (tagged FrameWriter coalescing on TCP; single-word publish by
construction on shm), and segment reclaim.

Everything here runs in-process: "child" views attach to the same segment
from threads, which exercises identical byte-level code paths to a spawned
process without the spawn overhead.  Cross-process behaviour (SIGKILL
recovery, handshake, ledger exactness) is covered by the process-backend
suite and the chaos scenario presets.
"""

import socket
import struct
import threading
import time

import pytest

from repro_torch.core.client import TimeJumpClient, TransportClosed
from repro_torch.core.shm_transport import (ShmClockWord, ShmEndpoint,
                                      ShmReplicaClock, ShmTimekeeperServer)
from repro_torch.core.transport import FrameWriter

pytestmark = pytest.mark.timeout(120)


@pytest.fixture()
def endpoint_pair():
    """A server + one endpoint with its service thread running."""
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name)
    srv.serve(ep.tk_c2p, ep.tk_p2c, name="shm-tk-test")
    yield srv, ep
    srv.close()
    ep.unlink()


# =========================================================================
# SPSC ring
# =========================================================================

def test_ring_roundtrip_and_wrap():
    """Frames survive byte-exact across many sends on a ring small enough
    that payloads wrap the buffer repeatedly."""
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name, tk_cap=256, ctrl_cap=256)
    try:
        ring = ep.tk_c2p
        for i in range(64):                     # 64 frames through 256 bytes
            payload = bytes([i]) * (40 + i % 50)
            ring.send_bytes(payload)
            assert ring.recv_bytes(timeout=1.0) == payload
        assert ring.frames_in == ring.frames_out == 64
    finally:
        srv.close()
        ep.unlink()


def test_ring_eof_drains_queued_frames_first():
    """EOF is a graceful close: frames committed before it must still be
    delivered (ledger exactness), then None."""
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name)
    try:
        ring = ep.ctrl_p2c
        ring.send_bytes(b"first")
        ring.send_bytes(b"second")
        ring.set_eof()
        assert ring.recv_bytes(timeout=1.0) == b"first"
        assert ring.recv_bytes(timeout=1.0) == b"second"
        assert ring.recv_bytes(timeout=1.0) is None
        with pytest.raises(TransportClosed):
            ring.send_bytes(b"after-eof")
    finally:
        srv.close()
        ep.unlink()


def test_ring_rejects_oversize_frame():
    """A frame that can never fit must fail loudly, not deadlock waiting
    for space that will never exist."""
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name, tk_cap=128, ctrl_cap=128)
    try:
        with pytest.raises(ValueError):
            ep.tk_c2p.send_bytes(b"x" * 130)
    finally:
        srv.close()
        ep.unlink()


def test_ring_dead_peer_drains_then_eof():
    """A SIGKILLed peer can never set eof: with peer_alive=False the reader
    must drain whatever was committed, then surface None — not hang."""
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name)
    try:
        ring = ep.ctrl_c2p
        ring.send_bytes(b"committed-before-death")
        dead = lambda: False
        assert ring.recv_bytes(timeout=5.0, peer_alive=dead) == \
            b"committed-before-death"
        t0 = time.monotonic()
        assert ring.recv_bytes(timeout=5.0, peer_alive=dead) is None
        assert time.monotonic() - t0 < 2.0, "dead-peer EOF took too long"
    finally:
        srv.close()
        ep.unlink()


def test_doorbell_wakes_blocked_consumer_and_survives_peer_close():
    """The wake-socket path end to end: with the doorbell handshake done, a
    consumer blocked in select wakes on a producer's send, and closing the
    peer's sockets (what a SIGKILL does to fds) degrades the reader to the
    bounded-poll fallback — drain, then None — instead of wedging."""
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    parent = ShmEndpoint.create(srv.clock_word.name)
    child = ShmEndpoint.attach(parent.spec)
    try:
        assert parent.accept_wakes(2.0), "doorbell handshake failed"
        assert child.ctrl_p2c.wake is not None
        got = {}

        def reader():
            got["frame"] = child.ctrl_p2c.recv_bytes(timeout=5.0)

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.05)                   # reader is asleep in select
        parent.ctrl_p2c.send_bytes(b"ding")
        t.join(timeout=2.0)
        assert got.get("frame") == b"ding"
        parent.close_wakes()               # fd-close == peer crash
        dead = lambda: False
        t0 = time.monotonic()
        assert child.ctrl_p2c.recv_bytes(timeout=5.0,
                                         peer_alive=dead) is None
        assert time.monotonic() - t0 < 2.0, "post-crash recv took too long"
    finally:
        srv.close()
        child.close_wakes()
        parent.unlink()


def test_broadcast_kick_respects_wake_target():
    """Epoch broadcasts must wake only sleepers whose advertised virtual
    wake target the round reached — the no-thundering-herd contract."""
    from repro_torch.core.shm_transport import _WakeSock
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name)
    a, b = socket.socketpair()
    try:
        ring = ep.tk_p2c
        ring.wake = _WakeSock(a)
        b.setblocking(False)
        ring.advertise(True, 100.0)        # sleeper rides to t=100
        ring.kick_if_due(50.0)             # round at t=50: not its turn
        with pytest.raises(BlockingIOError):
            b.recv(1)
        ring.kick_if_due(100.0)            # its round arrives
        b.settimeout(1.0)
        assert b.recv(1) == b"\0"
        ring.advertise(True)               # no target: any event wakes
        ring.kick_if_due(-1e18)
        assert b.recv(1) == b"\0"
    finally:
        a.close()
        b.close()
        srv.close()
        ep.unlink()


def test_ring_timeout_raises():
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name)
    try:
        with pytest.raises(TransportClosed):
            ep.ctrl_p2c.recv_bytes(timeout=0.05)
    finally:
        srv.close()
        ep.unlink()


# =========================================================================
# seqlock clock word
# =========================================================================

def test_clock_word_never_tears_under_concurrent_writes():
    """Writer publishes (offset, epoch) pairs with offset == epoch * 1e-3;
    readers must never observe a pair violating that invariant."""
    word = ShmClockWord.create()
    try:
        stop = threading.Event()
        torn = []

        def reader():
            rd = ShmClockWord.attach(word.name)
            try:
                while not stop.is_set():
                    offset, epoch, _ = rd.read()
                    if abs(offset - epoch * 1e-3) > 1e-12:
                        torn.append((offset, epoch))
                        return
            finally:
                rd.close()

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        for epoch in range(1, 20001):
            word.publish(epoch * 1e-3, epoch)
        stop.set()
        for t in threads:
            t.join(10)
        assert not torn, f"torn seqlock reads: {torn[:3]}"
        assert word.read()[:2] == (20000 * 1e-3, 20000)
    finally:
        word.unlink()
        word.close()


def test_replica_clock_tracks_word_and_closed_flag():
    word = ShmClockWord.create()
    try:
        clk = ShmReplicaClock(word)
        word.publish(3.5, 7)
        assert clk.offset == 3.5
        assert clk.epoch == 7
        assert not clk.closed
        assert abs(clk.now() - (time.time() + 3.5)) < 0.25
        # wait_for_update: returns once the epoch moves...
        def bump():
            time.sleep(0.05)
            word.publish(3.6, 8)
        t = threading.Thread(target=bump)
        t.start()
        assert clk.wait_for_update(7, timeout=5.0)
        t.join()
        # ...times out when it does not...
        assert not clk.wait_for_update(8, timeout=0.05)
        # ...and a closed word releases waiters immediately.
        word.publish(3.6, 8, closed=True)
        assert clk.wait_for_update(8, timeout=5.0)
        assert clk.closed
    finally:
        word.unlink()
        word.close()


# =========================================================================
# timekeeper plane over rings
# =========================================================================

def test_shm_jump_roundtrip(endpoint_pair):
    _, ep = endpoint_pair
    tr = ep.child_transport()
    c = TimeJumpClient(tr, "shm-a")
    t0 = c.now()
    t1 = c.time_jump(0.2)
    assert t1 >= t0 + 0.2 - 1e-6
    c.deregister()
    tr.close()


def test_two_shm_clients_coordinate():
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    eps = []
    for i in range(2):
        ep = ShmEndpoint.create(srv.clock_word.name)
        srv.serve(ep.tk_c2p, ep.tk_p2c, name=f"shm-tk-{i}")
        eps.append(ep)
    try:
        tra = eps[0].child_transport()
        trb = eps[1].child_transport()
        a = TimeJumpClient(tra, "A")
        b = TimeJumpClient(trb, "B")
        results = {}

        def run(name, client, dt, n):
            t0 = time.monotonic()
            for _ in range(n):
                client.time_jump(dt)
            results[name] = time.monotonic() - t0

        ta = threading.Thread(target=run, args=("A", a, 0.05, 10))
        tb = threading.Thread(target=run, args=("B", b, 0.025, 20))
        ta.start(); tb.start(); ta.join(); tb.join()
        assert max(results.values()) < 0.4, results
        # both replica clocks read the SAME word: agreement is exact
        assert tra.clock.epoch == trb.clock.epoch
        a.deregister(); b.deregister()
        tra.close(); trb.close()
    finally:
        srv.close()
        for ep in eps:
            ep.unlink()


def test_shm_server_close_releases_waiters(endpoint_pair):
    srv, ep = endpoint_pair
    tr = ep.child_transport()
    c = TimeJumpClient(tr, "waiter")
    released = threading.Event()

    def jump():
        try:
            c.time_jump(30.0)       # 30 wall seconds if it degraded
        except (TransportClosed, KeyError):
            pass
        released.set()

    t = threading.Thread(target=jump)
    t.start()
    time.sleep(0.05)
    srv.close()
    t.join(timeout=5.0)
    assert released.is_set(), \
        "waiter rode out its degradation timeout after server close"
    assert tr.closed
    tr.close()


def test_shm_ring_eof_deregisters_actors(endpoint_pair):
    """Transport close == connection death: the service loop must
    deregister the peer's actors so the barrier is never wedged."""
    srv, ep = endpoint_pair
    tr = ep.child_transport()
    c = TimeJumpClient(tr, "doomed")
    assert srv.timekeeper.num_actors == 1
    tr.close()
    deadline = time.monotonic() + 5.0
    while srv.timekeeper.num_actors and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.timekeeper.num_actors == 0


def test_segment_reclaim_after_unlink():
    srv = ShmTimekeeperServer(jitter_cooldown=0.0)
    ep = ShmEndpoint.create(srv.clock_word.name)
    seg, clock_name = ep.spec.segment, srv.clock_word.name
    ep.unlink()
    srv.close()
    from multiprocessing import shared_memory
    for name in (seg, clock_name):
        with pytest.raises(FileNotFoundError):
            s = shared_memory.SharedMemory(name=name)
            s.close()


# =========================================================================
# epoch-broadcast collapse: both transports (satellite regression)
# =========================================================================

def test_tcp_clock_broadcast_collapses_under_slow_socket():
    """A burst of N epoch bumps must leave at most ONE pending clock frame
    per peer: tagged frames replace their still-queued predecessor while
    the flusher is stuck inside a slow syscall."""
    a, b = socket.socketpair()
    try:
        w = FrameWriter(a)
        stuck = threading.Event()
        release = threading.Event()
        orig = w._write_batch

        def slow_batch(batch):
            stuck.set()
            assert release.wait(10)
            orig(batch)

        w._write_batch = slow_batch
        first = struct.pack("<Q", 0)
        t = threading.Thread(target=w.send, args=(first,),
                             kwargs={"tag": "clock"})
        t.start()
        assert stuck.wait(10)            # flusher wedged inside the syscall
        for epoch in range(1, 51):       # the burst arrives meanwhile
            w.send(struct.pack("<Q", epoch), tag="clock")
        assert w.pending() <= 1, "clock burst piled up behind a slow socket"
        assert w.coalesced >= 49
        release.set()
        t.join(10)
        # Only the first frame and the LAST of the burst ever hit the wire.
        b.settimeout(5.0)
        wire = b.recv(4096)
        assert wire == struct.pack("<Q", 0) + struct.pack("<Q", 50)
    finally:
        a.close()
        b.close()


def test_shm_epoch_burst_is_one_word_no_frames(endpoint_pair):
    """On shm the collapse is by construction: N bumps are N overwrites of
    one seqlock word — zero broadcast frames enter any ring, and readers
    see exactly the latest epoch."""
    srv, ep = endpoint_pair
    tr = ep.child_transport()
    c = TimeJumpClient(tr, "burster")
    replies_before = ep.tk_p2c.frames_out
    for _ in range(20):                  # 20 epoch bumps via real jumps
        c.time_jump(0.01)
    tk = srv.timekeeper
    assert tr.clock.epoch == tk.clock.epoch
    assert abs(tr.clock.offset - tk.clock.offset) < 1e-9
    # The reply ring carried NOTHING: jumps are one-way (the child pre-reads
    # its wait epoch from the word) and broadcasts are word overwrites — on
    # a fan-out or acked design either would show up as frames here.
    assert ep.tk_p2c.frames_out - replies_before == 0
    c.deregister()
    tr.close()
