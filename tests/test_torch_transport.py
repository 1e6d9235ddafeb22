"""Socket transport: the multi-process Timekeeper deployment (paper §5).

Exercises fan-in/fan-out over real TCP, replica-clock consistency, the
park/unpark frames, and the fault-tolerance paths: a dying connection
deregisters its actors (parked ones included) so the barrier is never
wedged by a crashed worker; server close releases remote waiters through a
final broadcast; an unresponsive server surfaces as TransportClosed after
the RPC timeout instead of blocking an actor forever.
"""

import socket
import threading
import time

import pytest

from repro_torch.core.client import TimeJumpClient
from repro_torch.core.transport import (SocketTransport, TimekeeperServer,
                                  TransportClosed)

# Socket tests must never hang the suite: pytest-timeout enforces this in
# CI (the marker is registered in pytest.ini, so it is inert-but-silent
# when the plugin is absent locally).
pytestmark = pytest.mark.timeout(120)


@pytest.fixture()
def server():
    srv = TimekeeperServer(jitter_cooldown=0.0)
    yield srv
    srv.close()


def test_remote_jump_roundtrip(server):
    tr = SocketTransport(server.address)
    c = TimeJumpClient(tr, "remote-a")
    t0 = c.now()
    t1 = c.time_jump(0.2)
    assert t1 >= t0 + 0.2 - 1e-6
    c.deregister()
    tr.close()


def test_two_remote_clients_coordinate(server):
    tra = SocketTransport(server.address)
    trb = SocketTransport(server.address)
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
    # 500 virtual ms coordinated across processes' worth of sockets in
    # far less wall time than sleeping would need
    assert max(results.values()) < 0.4, results
    # replica clocks agree with the server's
    assert abs(tra.clock.now() - trb.clock.now()) < 0.05
    a.deregister(); b.deregister()
    tra.close(); trb.close()


def test_dead_connection_releases_barrier(server):
    """Kill a client's socket mid-registration: the server must deregister
    its actors so the survivor's jump completes by barrier (fast), not by
    degradation timeout."""
    tra = SocketTransport(server.address)
    trb = SocketTransport(server.address)
    a = TimeJumpClient(tra, "survivor")
    b = TimeJumpClient(trb, "casualty")

    done = threading.Event()

    def run_a():
        a.time_jump(5.0)        # would take 5 wall seconds if degraded
        done.set()

    t = threading.Thread(target=run_a)
    t.start()
    time.sleep(0.05)
    assert not done.is_set()
    trb.close()                  # crash the casualty's process
    t.join(timeout=3.0)
    assert done.is_set(), "survivor stayed wedged after peer death"
    tra.close()


def test_observer_time_query(server):
    tr = SocketTransport(server.address)
    c = TimeJumpClient(tr, "actor")
    c.time_jump(1.0)
    tro = SocketTransport(server.address)   # pure observer connection
    t = tro.observer_time()
    assert t >= 1.0 - 1e-6 + (tr.clock.now() - tr.clock.now())  # sane
    assert abs(t - tr.clock.now()) < 0.05
    c.deregister()
    tr.close(); tro.close()


# =========================================================================
# park/unpark over the wire
# =========================================================================

def test_remote_park_excluded_from_barrier(server):
    """A parked remote replica must not stall barrier rounds: the survivor's
    jump resolves immediately (barrier of one), and unparking re-joins."""
    tra = SocketTransport(server.address)
    trb = SocketTransport(server.address)
    a = TimeJumpClient(tra, "busy")
    b = TimeJumpClient(trb, "idle-replica")
    b.park()
    assert server.timekeeper.num_actors == 1
    assert server.timekeeper.num_parked == 1

    t0 = time.monotonic()
    a.time_jump(2.0)                     # would be 2 wall seconds if stalled
    assert time.monotonic() - t0 < 0.5, "parked remote replica stalled round"

    b.unpark()
    assert server.timekeeper.num_actors == 2
    # both must now arrive for a round to resolve
    done = threading.Event()

    def jump_a():
        a.time_jump(0.2)
        done.set()

    t = threading.Thread(target=jump_a)
    t.start()
    time.sleep(0.05)
    assert not done.is_set(), "round resolved without the unparked replica"
    b.time_jump(0.2)
    t.join(timeout=3.0)
    assert done.is_set()
    a.deregister(); b.deregister()
    tra.close(); trb.close()


def test_park_when_mid_barrier_request_pending(server):
    """Parking an actor whose peer has a *pending* jump re-evaluates the
    barrier (the park path of _maybe_resolve_locked) — no wedge."""
    tra = SocketTransport(server.address)
    trb = SocketTransport(server.address)
    a = TimeJumpClient(tra, "requester")
    b = TimeJumpClient(trb, "parker")
    done = threading.Event()

    def jump_a():
        a.time_jump(3.0)
        done.set()

    t = threading.Thread(target=jump_a)
    t.start()
    time.sleep(0.05)
    assert not done.is_set()
    b.park()                              # barrier shrinks to {a}: resolves
    t.join(timeout=3.0)
    assert done.is_set(), "park never re-evaluated the barrier"
    a.deregister(); b.deregister()
    tra.close(); trb.close()


# =========================================================================
# failure paths: none may wedge the Timekeeper
# =========================================================================

def test_client_disconnect_mid_barrier_releases_peers(server):
    """The casualty dies mid-run — after participating in rounds, while the
    survivor is mid-multi-round jump and barred on it: connection teardown
    must deregister the casualty and resolve the survivor's round."""
    tra = SocketTransport(server.address)
    trb = SocketTransport(server.address)
    a = TimeJumpClient(tra, "survivor")
    b = TimeJumpClient(trb, "casualty")
    done = threading.Event()

    def jump_a():
        a.time_jump(5.0)
        done.set()

    ta = threading.Thread(target=jump_a)
    ta.start()
    time.sleep(0.05)
    b.time_jump(0.2)              # one joint round resolves (to b's target);
    time.sleep(0.1)               # a re-requests and is now barred on b
    assert not done.is_set()
    trb.close()                   # crash: b must not pin the barrier
    ta.join(timeout=3.0)
    assert done.is_set(), "survivor stayed wedged after mid-barrier death"
    assert server.timekeeper.num_actors == 1
    a.deregister()
    tra.close()


def test_server_close_with_parked_actors_releases_everyone(server):
    """close() with a parked remote actor and a waiter mid-jump: the final
    broadcast releases the waiter promptly (no degradation-timeout ride),
    parked state is dropped, and later RPCs fail fast instead of hanging."""
    tra = SocketTransport(server.address)
    trb = SocketTransport(server.address)
    a = TimeJumpClient(tra, "waiter")
    b = TimeJumpClient(trb, "parked")
    b.park()
    released = threading.Event()

    def jump_a():
        try:
            a.time_jump(30.0)     # would be 30 wall seconds if degraded
        except (TransportClosed, KeyError):
            pass
        released.set()

    t = threading.Thread(target=jump_a)
    t.start()
    time.sleep(0.05)
    server.close()
    t.join(timeout=5.0)
    assert released.is_set(), \
        "waiter rode out its degradation timeout after server close"
    assert server.timekeeper.num_actors == 0
    assert server.timekeeper.num_parked == 0
    with pytest.raises((TransportClosed, KeyError)):
        tra.observer_time()
    tra.close(); trb.close()


def test_jump_request_timeout_surfaces_not_wedges():
    """A server that accepts but never replies: the jump RPC must raise
    TransportClosed after rpc_timeout — the actor thread is released (the
    replica clock kept flowing at wall rate meanwhile, so no correctness
    loss) instead of blocking forever."""
    mute = socket.create_server(("127.0.0.1", 0))
    try:
        tr = SocketTransport(mute.getsockname(), rpc_timeout=0.2)
        t0 = time.monotonic()
        with pytest.raises(TransportClosed):
            tr.send_jump_request("actor", 1.0)
        assert time.monotonic() - t0 < 2.0
        tr.close()
    finally:
        mute.close()


def test_rpc_after_server_death_fails_fast(server):
    """Pending and subsequent RPCs fail promptly when the server socket
    dies, and a real Timekeeper behind a *different* live server keeps
    working (the failure is scoped to the dead transport)."""
    tr = SocketTransport(server.address)
    c = TimeJumpClient(tr, "lonely")
    c.time_jump(0.1)
    server.close()
    time.sleep(0.1)               # reader notices the close
    with pytest.raises((TransportClosed, KeyError)):
        tr.send_jump_request("lonely", 99.0)
    tr.close()

    other = TimekeeperServer(jitter_cooldown=0.0)
    try:
        tr2 = SocketTransport(other.address)
        c2 = TimeJumpClient(tr2, "alive")
        assert c2.time_jump(0.05) > 0
        c2.deregister()
        tr2.close()
    finally:
        other.close()
