"""Process-mode cluster runtime: replicas as OS processes (paper §4–5).

This is the deployment shape the paper's coordination protocol exists for:
every replica's :class:`~repro.serving.engine.LLMEngine` runs in its **own
OS process**, its worker actor wired to the parent's Timekeeper server.
The engine, runner, and :class:`~repro.core.client.TimeJumpClient` code are
byte-identical to the in-process thread backend — only the
``ActorTransport`` underneath changes.

Two wire transports carry the same protocol (``transport=`` on
:func:`build_process_cluster`):

* ``"tcp"`` — framed TCP: :class:`~repro.core.transport.TimekeeperServer`
  + ``SocketTransport`` for the time plane, a pickle-framed socket per
  replica for the control plane.
* ``"shm"`` — shared memory (:mod:`repro.core.shm_transport`): a seqlock
  clock word makes every child clock read a zero-syscall load and epoch
  broadcast a single word write; per-replica SPSC rings carry the identical
  fan-in and control ops.

Both planes run over the same duck-typed channel surface
(``send_obj``/``recv_obj``/``mark_peer_dead``/``close`` —
:class:`SocketChannel` here, :class:`~repro.core.shm_transport.ShmChannel`
there), so ``ProcessReplicaHandle`` and ``_ReplicaServer`` run unchanged
protocol logic over either.

Topology (one parent, N children)::

    parent process                          child process i
    ──────────────                          ───────────────
    Timekeeper server ◄───tcp | shm─────►  ActorTransport ── TimeJumpClient
    LocalTransport (dispatcher, think        │                     │
      actors, autoscaler ticks)              │              TimeWarpModelRunner
    ProcessCluster                           │                     │
      └─ ProcessReplicaHandle ◄──control──► _ReplicaServer ─── LLMEngine
              (route/submit/probe/drain)       (command loop)

Control protocol (length-prefixed pickle frames, one channel per replica;
requests carry a ``rid`` echoed by the reply):

==================  =====================================================
``hello``           child → parent: announce replica index (handshake)
``start_engine``    activate a warm child: ship the pickled engine spec
                    (model/engine config + predictor); child builds and
                    starts the engine
``submit``          one pickled Request; the ack is sent only after
                    ``engine.submit`` returned, i.e. after the child's
                    worker actor re-registered with the Timekeeper — the
                    dispatcher's next TIMEJUMP cannot resolve a barrier
                    without the request's replica (same causality rule the
                    thread backend gets from its synchronous unpark)
``probe``           racy ReplicaView read: outstanding tokens/requests and
                    (optionally) the radix prefix-match length
``complete``        child → parent: pickled finished Requests.  The child's
                    engine blocks in ``on_finish`` until ``complete_ack``
                    comes back, so the parent runs every completion
                    listener — think-time actor registration included —
                    **before the finishing replica re-enters the barrier**
                    (§4.3 over the wire; closed-loop sessions build on it)
``retire``          drain final step (fire-and-forget): the child's worker
                    actor deregisters from the Timekeeper — park, then a
                    full departure with an epoch-bump broadcast
``stop_engine``     stop the engine loop (cluster stop)
``shutdown``        child exits
==================  =====================================================

Drain over the wire is therefore: stop routing (parent) → in-flight
completion frames drain the parent's bookkeeping → ``retire`` frame →
``deregister`` on the Timekeeper socket.

Children are spawned with the ``spawn`` start method (never ``fork``: the
parent runs engine/reader threads and may have JAX loaded).  Because a
process spawn costs real wall time — which, under Eq. 1, would leak into
virtual latencies mid-run — the cluster pre-spawns a **warm pool**
(``warm_replicas``): standby shell processes that are connected but
engine-less; ``add_replica`` activates one with a single ``start_engine``
frame (milliseconds), so autoscaling pays only the *modeled* provisioning
delay, exactly like the thread backend.
"""

from __future__ import annotations

import itertools
import multiprocessing
import pickle
import queue
import socket
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.client import LocalTransport
from repro_torch.core.transport import (FrameWriter, TimekeeperServer,
                                  TransportClosed, pack_frame)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import EngineConfig

from .cluster import ClusterBase, ClusterConfig
from .router import Router
from .tiers import TierSpec

__all__ = ["ProcessCluster", "ProcessReplicaHandle", "SocketChannel",
           "build_process_cluster"]

_LEN = struct.Struct(">I")
_HANDSHAKE_TIMEOUT = 120.0      # spawn + interpreter boot + numpy import
_RPC_TIMEOUT = 60.0
_ACK_TIMEOUT = 60.0

TRANSPORTS = ("tcp", "shm")


def _send_obj(writer: FrameWriter, obj: dict) -> None:
    """Queue one pickled control frame on the socket's write combiner.

    All control-plane writes on a socket share one :class:`FrameWriter`, so
    bursts — completion frames from several finishing requests, acks racing
    replies — coalesce into a single ``sendmsg`` flush instead of paying one
    ``sendall`` syscall (plus lock convoy) each.
    """
    writer.send(pack_frame(pickle.dumps(obj)))


def _recv_obj(sock: socket.socket) -> Optional[dict]:
    buf = b""
    while len(buf) < _LEN.size:
        try:
            chunk = sock.recv(_LEN.size - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    (length,) = _LEN.unpack(buf)
    body = b""
    while len(body) < length:
        try:
            chunk = sock.recv(length - len(body))
        except OSError:
            return None
        if not chunk:
            return None
        body += chunk
    return pickle.loads(body)


class SocketChannel:
    """Control channel over one TCP socket (the duck type ``ShmChannel``
    mirrors): ``send_obj`` raises :class:`OSError` on a dead peer,
    ``recv_obj`` returns None at EOF.  ``mark_peer_dead`` is a no-op — the
    kernel delivers EOF for a SIGKILLed peer on its own."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.writer = FrameWriter(sock)

    def send_obj(self, obj: dict) -> None:
        _send_obj(self.writer, obj)

    def recv_obj(self, timeout: Optional[float] = None) -> Optional[dict]:
        if timeout is not None:
            self.sock.settimeout(timeout)
            try:
                return _recv_obj(self.sock)
            finally:
                self.sock.settimeout(None)
        return _recv_obj(self.sock)

    def mark_peer_dead(self) -> None:
        pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


@dataclass
class _EngineSpec:
    """Everything a child needs to build its replica engine (all picklable)."""
    model_cfg: ModelConfig
    engine_cfg: EngineConfig
    predictor: object
    name: str
    tier: Optional[str] = None


# =========================================================================
# child side
# =========================================================================

class _ReplicaServer:
    """Runs inside the child: one engine + the control-channel command loop.

    Transport-agnostic: ``chan`` is any control channel (socket or shm) and
    ``transport_factory`` builds the matching ``ActorTransport`` lazily, at
    engine activation — warm standbys stay engine-less and transport-less.
    """

    def __init__(self, chan, transport_factory: Callable[[], object],
                 index: int):
        self.chan = chan
        self.transport_factory = transport_factory
        self.index = index
        self.engine = None
        self.transport = None
        self.worker_client = None
        self._ack_events: Dict[int, threading.Event] = {}
        self._ack_lock = threading.Lock()
        self._cid = itertools.count()
        self._cmd_q: "queue.Queue[Optional[dict]]" = queue.Queue()

    # ------------------------------------------------------------ engine --
    def _build_engine(self, spec: _EngineSpec) -> None:
        from repro_torch.core.client import TimeJumpClient
        from repro_torch.core.emulation import VirtualDeviceContext
        from repro_torch.core.hardware import get_chip
        from repro_torch.serving.engine import LLMEngine
        from repro_torch.serving.model_runner import TimeWarpModelRunner

        if self.transport is None:
            self.transport = self.transport_factory()
        cfg = spec.engine_cfg
        chip = get_chip(cfg.chip)
        n_dev = cfg.tp * cfg.pp
        devices = VirtualDeviceContext(n_dev, chip)
        kv_pool = int(cfg.num_blocks * cfg.block_size
                      * spec.model_cfg.kv_bytes_per_token())
        weights = spec.model_cfg.param_count() * spec.model_cfg.dtype_bytes
        self.worker_client = TimeJumpClient(
            self.transport, f"{spec.name}-worker")
        runner = TimeWarpModelRunner(
            spec.predictor, self.worker_client, devices=devices,
            weight_bytes=weights, kv_pool_bytes=kv_pool)
        self.engine = LLMEngine(cfg, runner, self.transport.clock,
                                name=spec.name)
        # Completion frames flow back BEFORE the engine's next barrier
        # round: on_finish runs in the step thread and blocks on the ack.
        self.engine.on_finish = self._on_finish
        self.engine.start()

    def _on_finish(self, finished: List[Request]) -> None:
        cid = next(self._cid)
        ev = threading.Event()
        with self._ack_lock:
            self._ack_events[cid] = ev
        try:
            self.chan.send_obj({"op": "complete", "cid": cid,
                                "reqs": finished})
        except OSError:
            return                        # parent died: nothing to wait for
        # Block the step thread until the parent has run every completion
        # listener (think-actor registration included): the worker actor
        # cannot re-enter the barrier before the follow-up work exists.
        ev.wait(timeout=_ACK_TIMEOUT)
        with self._ack_lock:
            self._ack_events.pop(cid, None)

    # -------------------------------------------------------------- loop --
    def run(self) -> None:
        """Reader (main thread) + command executor (worker thread).

        Acks are dispatched by the reader directly so a slow command — e.g.
        ``stop_engine`` joining a step thread that is itself blocked on a
        ``complete_ack`` — can never dam the ack behind it.
        """
        cmd_thread = threading.Thread(
            target=self._cmd_loop, name=f"replica-{self.index}-cmds",
            daemon=True)
        cmd_thread.start()
        try:
            while True:
                msg = self.chan.recv_obj()
                if msg is None:
                    break                    # parent gone
                if msg["op"] == "complete_ack":
                    with self._ack_lock:
                        ev = self._ack_events.get(msg["cid"])
                    if ev is not None:
                        ev.set()
                    continue
                if msg["op"] == "shutdown":
                    break
                self._cmd_q.put(msg)
        finally:
            # Release any step thread still waiting on an ack, then tear
            # down: engine first (deregisters its actor), sockets last.
            with self._ack_lock:
                for ev in self._ack_events.values():
                    ev.set()
            self._cmd_q.put(None)
            if self.engine is not None:
                try:
                    self.engine.stop()
                except (TransportClosed, KeyError, RuntimeError, OSError):
                    pass
            if self.worker_client is not None:
                try:
                    self.worker_client.deregister()
                except (TransportClosed, KeyError, RuntimeError, OSError):
                    pass
            if self.transport is not None:
                self.transport.close()
            self.chan.close()

    def _cmd_loop(self) -> None:
        while True:
            msg = self._cmd_q.get()
            if msg is None:
                return
            op, rid = msg["op"], msg.get("rid")
            try:
                reply = self._execute(op, msg)
            except (TransportClosed, OSError) as e:
                reply = {"op": "error", "error": f"replica transport: {e}"}
            except Exception as e:  # noqa: BLE001 — ship it to the parent
                reply = {"op": "error", "error": f"{type(e).__name__}: {e}"}
            if rid is None:
                continue                     # fire-and-forget op
            reply["rid"] = rid
            try:
                self.chan.send_obj(reply)
            except OSError:
                return

    def _execute(self, op: str, msg: dict) -> dict:
        if op == "start_engine":
            self._build_engine(msg["spec"])
            return {"op": "ack"}
        if op == "submit":
            self.engine.submit(msg["req"])
            return {"op": "ack"}
        if op == "probe":
            tokens = msg.get("tokens")
            return {
                "op": "probe_ack",
                "num_outstanding": self.engine.num_outstanding(),
                "outstanding_tokens": self.engine.outstanding_tokens(),
                "prefix_match": (self.engine.prefix_match_len(tokens)
                                 if tokens is not None else 0),
            }
        if op == "stats":
            return {"op": "stats_ack", "stats": self.engine.stats()}
        if op == "configure":
            self.engine.set_audit(msg["audit"])
            return {"op": "ack"}
        if op == "step_log":
            return {"op": "step_log_ack", "log": list(self.engine.step_log)}
        if op == "slowdown":
            from repro_torch.cluster.faults import SlowdownPredictor
            runner = self.engine.runner
            base = SlowdownPredictor.unwrap(runner.predictor)
            factor = msg["factor"]
            runner.predictor = (base if factor is None
                                else SlowdownPredictor(base, factor))
            return {"op": "ack"}
        if op == "retire":
            # drain final step: park semantics then the full departure —
            # TimeJumpClient.park is a no-op once deregistered, so the
            # engine loop's idle parking stays harmless afterwards
            self.engine.retire()
            return {"op": "ack"}
        if op == "stop_engine":
            self.engine.stop()
            return {"op": "ack"}
        return {"op": "error", "error": f"unknown op {op!r}"}


def _replica_main(ctrl_desc, tk_desc, index: int) -> None:
    """Child process entry point (multiprocessing ``spawn`` target).

    Descriptors are ``(kind, payload)`` pairs: ``("tcp", address)`` dials
    sockets; ``("shm", ShmEndpointSpec)`` attaches the pre-created segment —
    the control channel and the timekeeper ring pair live in the same
    endpoint, so both descriptors carry the same spec.
    """
    kind, payload = ctrl_desc
    if kind == "shm":
        from repro_torch.core.shm_transport import ShmEndpoint
        endpoint = ShmEndpoint.attach(payload)
        chan = endpoint.child_channel()
        transport_factory = endpoint.child_transport
    else:
        ctrl = socket.create_connection(tuple(payload))
        ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        chan = SocketChannel(ctrl)
        tk_addr = tuple(tk_desc[1])

        def transport_factory():
            from repro_torch.core.transport import SocketTransport
            return SocketTransport(tk_addr)

    server = _ReplicaServer(chan, transport_factory, index)
    chan.send_obj({"op": "hello", "replica": index})
    server.run()


# =========================================================================
# parent side
# =========================================================================

class ProcessReplicaHandle:
    """Parent-side proxy for one replica child process.

    Satisfies the cluster's replica-handle protocol (``submit`` +
    ReplicaView probes + drain/lifecycle hooks); every probe is a real RPC
    into the child's engine counters, so routing policies see the same
    racy-read semantics they see on the thread backend.  ``in_flight_ids``
    is parent-side bookkeeping (submits minus completion frames) — exact,
    because completions are the parent's own observation point.

    ``reclaim`` (shm transport) releases the child's shared-memory segment
    name once the child is gone — called after a graceful shutdown AND after
    a SIGKILL's ledger drain, so crash faults cannot leak segments.
    """

    def __init__(self, index: int, chan, proc, *,
                 reclaim: Optional[Callable[[], None]] = None):
        self.index = index
        self.chan = chan
        self.proc = proc
        self._reclaim = reclaim
        self.name = f"replica-{index}"
        self.on_complete: Optional[Callable[[List[Request]], None]] = None
        self._replies: Dict[int, "queue.Queue[dict]"] = {}
        self._replies_lock = threading.Lock()
        self._rid = itertools.count()
        # request_id -> the parent's Request copy: submits minus completion
        # frames.  Keeping the object (not just the id) is the crash-recovery
        # ledger — after a SIGKILL the child's progressed copies are gone,
        # and these are what gets requeued/failed.
        self._in_flight: Dict[int, Request] = {}
        self._in_flight_lock = threading.Lock()
        self.activated = False
        self.retired = False
        self.stopped = False
        self._stats_cache: Optional[dict] = None
        self._step_log_cache: Optional[list] = None
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"replica-{index}-reader",
            daemon=True)
        self._reader.start()

    # ------------------------------------------------------------ plumbing --
    def _read_loop(self) -> None:
        # try/finally: the fail-fast cleanup must run even if a completion
        # listener raises out of on_complete — a dead reader that left
        # _closed unset would turn every later RPC into a full-timeout
        # stall instead of an immediate TransportClosed.
        try:
            while True:
                msg = self.chan.recv_obj()
                if msg is None:
                    break
                if msg["op"] == "complete":
                    finished = msg["reqs"]
                    with self._in_flight_lock:
                        for r in finished:
                            self._in_flight.pop(r.request_id, None)
                    try:
                        if self.on_complete is not None:
                            self.on_complete(finished)
                    finally:
                        # The ack releases the child's step thread:
                        # listeners have run, follow-up actors are
                        # registered, the replica may re-enter the barrier.
                        try:
                            self.chan.send_obj({"op": "complete_ack",
                                                "cid": msg["cid"]})
                        except OSError:
                            pass
                    continue
                rid = msg.get("rid")
                if rid is None:
                    continue
                with self._replies_lock:
                    q = self._replies.get(rid)
                if q is not None:
                    q.put(msg)
        finally:
            self._closed = True
            with self._replies_lock:
                pending = list(self._replies.values())
            for q in pending:
                q.put({"op": "error", "error": "replica connection closed"})

    def _rpc(self, msg: dict, timeout: float = _RPC_TIMEOUT) -> dict:
        if self._closed:
            raise TransportClosed(f"{self.name}: connection closed")
        rid = next(self._rid)
        msg["rid"] = rid
        q: "queue.Queue[dict]" = queue.Queue(maxsize=1)
        with self._replies_lock:
            self._replies[rid] = q
        try:
            try:
                self.chan.send_obj(msg)
            except OSError as e:
                raise TransportClosed(f"{self.name}: {e}") from None
            try:
                reply = q.get(timeout=timeout)
            except queue.Empty:
                raise TransportClosed(
                    f"{self.name}: no reply to {msg['op']!r} within "
                    f"{timeout}s") from None
        finally:
            with self._replies_lock:
                self._replies.pop(rid, None)
        if reply["op"] == "error":
            raise RuntimeError(f"{self.name}: {reply['error']}")
        return reply

    def _send_oneway(self, msg: dict) -> None:
        try:
            self.chan.send_obj(msg)
        except OSError:
            pass

    # ------------------------------------------------------------ replica --
    def activate(self, spec: _EngineSpec) -> None:
        self._rpc({"op": "start_engine", "spec": spec})
        self.activated = True
        self.name = spec.name

    def submit(self, req: Request) -> None:
        """Ship one request; returns once the child's engine enqueued it and
        its worker actor is back on the Timekeeper barrier (the submit-ack
        is the cross-process equivalent of the thread backend's synchronous
        unpark — without it the dispatcher's next jump could skip the
        request's processing entirely)."""
        with self._in_flight_lock:
            self._in_flight[req.request_id] = req
        try:
            self._rpc({"op": "submit", "req": req})
        except Exception:
            with self._in_flight_lock:
                self._in_flight.pop(req.request_id, None)
            raise

    def set_audit(self, audit: str) -> None:
        """Forward the audit mode to the child's engine (drops its step log
        and finished-list retention under ``sampled``/``off``)."""
        if not self.activated or self.stopped:
            return
        self._rpc({"op": "configure", "audit": audit})

    # --------------------------------------------------------- ReplicaView --
    def num_outstanding(self) -> int:
        return self._rpc({"op": "probe"})["num_outstanding"]

    def outstanding_tokens(self) -> int:
        return self._rpc({"op": "probe"})["outstanding_tokens"]

    def prefix_match_len(self, tokens) -> int:
        return self._rpc({"op": "probe", "tokens": list(tokens)})["prefix_match"]

    def in_flight_ids(self) -> set:
        with self._in_flight_lock:
            return set(self._in_flight)

    # ----------------------------------------------------------- lifecycle --
    def start(self) -> None:
        """No-op: the child's engine starts at activation (``start_engine``)."""

    def retire(self) -> None:
        """Drain final step — fire-and-forget by design: retirement can be
        triggered from this handle's own completion path (the last in-flight
        finish), where waiting for a reply would deadlock against the
        child's pending ``complete_ack``."""
        self.retired = True
        self._send_oneway({"op": "retire"})

    def stop(self) -> None:
        if self.stopped or not self.activated:
            return
        # Snapshot accounting before the engine goes away mid-teardown.
        try:
            self._step_log_cache = self._rpc({"op": "step_log"})["log"]
            self._stats_cache = self._rpc({"op": "stats"})["stats"]
            self._rpc({"op": "stop_engine"})
        except (TransportClosed, RuntimeError):
            pass
        self.stopped = True

    def set_slowdown(self, factor: Optional[float]) -> bool:
        """Straggler injection: swap the child engine's predictor wrap."""
        if not self.activated or self.stopped:
            return False
        self._rpc({"op": "slowdown", "factor": factor})
        return True

    def force_kill(self) -> List[Request]:
        """Fault injection: SIGKILL the child — no drain, no goodbye frame —
        and surrender the requests it was holding.

        This is the real failure mode the socket transport must survive:
        the child's worker actor dies mid-jump, its Timekeeper socket goes
        EOF, and the server's per-connection reaper deregisters every actor
        of the dead connection so pending barrier rounds re-resolve without
        it.  Order matters:

        1. snapshot ``stats``/``step_log`` over the still-live command loop
           (a SIGKILLed engine can never answer the shutdown-time RPC, and
           the dead replica still owes its device-time accounting);
        2. ``proc.kill()`` — SIGKILL, nothing runs in the child;
        3. join the reader to EOF: completion frames already on the wire
           (steps that finished *before* the crash instant) still land, so
           the ledger handed back is exact — submits minus every completion
           the dead replica actually delivered.  TCP gets the EOF from the
           kernel; shm gets it from ``mark_peer_dead`` (the ring drains
           committed frames first, same exactness);
        4. reclaim the shm segment — a SIGKILLed child can never unlink
           anything itself.
        """
        self.retired = True
        if self.activated and not self.stopped:
            try:
                self._step_log_cache = self._rpc({"op": "step_log"})["log"]
                self._stats_cache = self._rpc({"op": "stats"})["stats"]
            except (TransportClosed, RuntimeError):
                pass                      # child already dying: ledger still valid
        self.stopped = True
        self.proc.kill()
        self.proc.join(timeout=30.0)
        self.chan.mark_peer_dead()
        self._reader.join(timeout=30.0)
        assert not self._reader.is_alive(), \
            f"{self.name}: reader failed to reach EOF after SIGKILL"
        with self._in_flight_lock:
            victims = list(self._in_flight.values())
            self._in_flight.clear()
        if self._reclaim is not None:
            self._reclaim()
        return victims

    def shutdown(self, timeout: float = 10.0) -> None:
        self._send_oneway({"op": "shutdown"})
        self.chan.close()
        self.proc.join(timeout=timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5.0)
        if self._reclaim is not None:
            self._reclaim()

    # ----------------------------------------------------------- accounting --
    def stats(self) -> dict:
        if self._stats_cache is not None:
            return self._stats_cache
        if not self.activated:
            return {"name": self.name, "warm": True, "finished": 0,
                    "outstanding_reqs": 0, "outstanding_tokens": 0,
                    "steps": 0, "device_time_s": 0.0, "cpu_overhead_s": 0.0,
                    "num_preemptions": 0, "prefix_hit_rate": 0.0}
        try:
            return self._rpc({"op": "stats"})["stats"]
        except (TransportClosed, RuntimeError):
            return self._stats_cache or {"name": self.name, "finished": 0,
                                         "steps": 0, "device_time_s": 0.0,
                                         "cpu_overhead_s": 0.0,
                                         "num_preemptions": 0}

    @property
    def step_log(self) -> list:
        if self._step_log_cache is not None:
            return self._step_log_cache
        if not self.activated:
            return []
        try:
            return self._rpc({"op": "step_log"})["log"]
        except (TransportClosed, RuntimeError):
            return []


class ProcessCluster(ClusterBase):
    """Process backend: every replica engine in its own OS process.

    The parent keeps the Timekeeper (served over TCP), the router, the
    elastic-membership ledger, and the benchmark-facing surface; children
    keep the engines.  The parent-side ``transport`` is a
    :class:`~repro.core.client.LocalTransport` on the server's Timekeeper,
    so the dispatcher / think-time / autoscaler actors of
    ``BenchmarkRunner`` work unchanged — they are parent-process actors
    coordinating with remote replica actors through one barrier.
    """

    backend = "process"

    def __init__(
        self,
        handles: List[ProcessReplicaHandle],
        router: Router,
        *,
        server,            # TimekeeperServer | ShmTimekeeperServer
        warm_pool: List[ProcessReplicaHandle],
        spec_of: Callable[[int, Optional[str]], _EngineSpec],
        spawn_replica: Callable[[int], ProcessReplicaHandle],
        ctrl_listener: Optional[socket.socket] = None,
        cfg: Optional[ClusterConfig] = None,
        model_cfg: Optional[ModelConfig] = None,
        tier_specs: Optional[Dict[str, TierSpec]] = None,
        tier_spec_factory=None,
        transport: str = "tcp",
    ):
        self.server = server
        # NB: ClusterBase.transport is the parent-side ActorTransport object;
        # the wire-transport *kind* gets its own name.
        self.transport_kind = transport
        self._warm_pool = list(warm_pool)
        self._spec_of = spec_of
        self._spawn_replica = spawn_replica
        # kept open for pool-exhausted on-demand spawns; closed at shutdown
        self._ctrl_listener = ctrl_listener
        super().__init__(
            handles, router, clock=server.timekeeper.clock,
            transport=LocalTransport(server.timekeeper),
            timekeeper=server.timekeeper, model_cfg=model_cfg, cfg=cfg,
            tier_specs=tier_specs, tier_spec_factory=tier_spec_factory)
        for h in handles + self._warm_pool:
            h.on_complete = self._complete

    # ------------------------------------------------------------ backend --
    @property
    def warm_available(self) -> int:
        return len(self._warm_pool)

    def _new_replica(self, idx: int, tier: Optional[str]):
        """Activate a warm standby child (fast path: one ``start_engine``
        frame); with the pool exhausted, spawn a fresh process — correct but
        wall-expensive, so size ``warm_replicas`` to the autoscaler's
        ``max_replicas`` for latency-faithful elastic runs."""
        if self._warm_pool:
            handle = self._warm_pool.pop(0)
        else:
            handle = self._spawn_replica(idx)
            handle.on_complete = self._complete
        handle.index = idx
        handle.activate(self._spec_of(idx, tier))
        return handle

    def _attach_replica(self, handle) -> None:
        handle.on_complete = self._complete

    def _force_kill(self, idx: int) -> List[Request]:
        return self.replicas[idx].force_kill()

    def _set_slowdown(self, idx: int, factor: Optional[float]) -> bool:
        return self.replicas[idx].set_slowdown(factor)

    # ---------------------------------------------------------- lifecycle --
    def shutdown(self) -> None:
        self.stop()
        for h in self.replicas + self._warm_pool:
            h.shutdown()
        self._warm_pool.clear()
        if self._ctrl_listener is not None:
            try:
                self._ctrl_listener.close()
            except OSError:
                pass
        # Server last: its close broadcasts the final releasing clock update
        # to any child still mid-teardown.
        self.server.close()

    # --------------------------------------------------------- aggregates --
    def stats(self) -> dict:
        agg = super().stats()
        agg["warm_standby"] = self.warm_available
        agg["transport"] = self.transport_kind
        return agg


# =========================================================================
# factory
# =========================================================================

def build_process_cluster(
    *,
    model_cfg: ModelConfig,
    router: Router,
    num_replicas: int,
    resolve_cfg: Callable[[int, Optional[str]], EngineConfig],
    resolve_pred: Callable[[EngineConfig, Optional[str]], object],
    default_tier: Callable[[int], Optional[str]],
    cluster_cfg: ClusterConfig,
    tier_specs: Optional[Dict[str, TierSpec]] = None,
    tier_spec_factory=None,
    jitter_cooldown: float = 0.0,
    warm_replicas: Optional[int] = None,
    name: str = "cluster",
    transport: str = "tcp",
) -> ProcessCluster:
    """Spawn the Timekeeper server + child replica processes and wire them
    into a :class:`ProcessCluster`.  Called through
    :func:`repro.cluster.build_cluster` (``backend="process"``), which owns
    the config/tier/predictor resolution shared with the thread backend.

    ``transport`` selects the wire: ``"tcp"`` (framed sockets) or ``"shm"``
    (seqlock clock word + SPSC rings, :mod:`repro.core.shm_transport`).
    """
    if transport not in TRANSPORTS:
        raise ValueError(
            f"transport={transport!r}: choose from {TRANSPORTS}")
    ctx = multiprocessing.get_context("spawn")   # parent is multi-threaded:
    # fork would duplicate it mid-lock; spawn re-imports a clean interpreter

    listener = None
    if transport == "shm":
        from repro_torch.core.shm_transport import ShmEndpoint, ShmTimekeeperServer
        server = ShmTimekeeperServer(jitter_cooldown=jitter_cooldown)
    else:
        server = TimekeeperServer(jitter_cooldown=jitter_cooldown)
        # Control listener: children dial back in and identify via `hello`.
        listener = socket.create_server(("127.0.0.1", 0))
        ctrl_addr = listener.getsockname()

    total = max(num_replicas, warm_replicas or 0)

    def spawn_replica(index: int) -> ProcessReplicaHandle:
        if transport == "shm":
            # The segment exists before the child does; the child only ever
            # attaches.  The parent-side service thread and control channel
            # poll child liveness so a SIGKILL can never wedge them.
            endpoint = ShmEndpoint.create(server.clock_word.name)
            proc = ctx.Process(
                target=_replica_main,
                args=(("shm", endpoint.spec), ("shm", endpoint.spec), index),
                name=f"{name}-r{index}", daemon=True)
            proc.start()
            # Doorbell handshake: the child dials during attach; a timeout
            # (crashed child, exotic platform) just leaves the endpoint on
            # its bounded-poll fallback — correct either way.
            endpoint.accept_wakes(_HANDSHAKE_TIMEOUT)
            server.serve(endpoint.tk_c2p, endpoint.tk_p2c,
                         peer_alive=proc.is_alive,
                         name=f"shm-tk-r{index}")
            chan = endpoint.parent_channel(peer_alive=proc.is_alive)
            try:
                hello = chan.recv_obj(timeout=_HANDSHAKE_TIMEOUT)
            except TransportClosed:
                hello = None
            assert hello is not None and hello["op"] == "hello", \
                f"replica {index} handshake failed"
            return ProcessReplicaHandle(hello["replica"], chan, proc,
                                        reclaim=endpoint.unlink)
        proc = ctx.Process(
            target=_replica_main,
            args=(("tcp", ctrl_addr), ("tcp", tuple(server.address)), index),
            name=f"{name}-r{index}", daemon=True)
        proc.start()
        listener.settimeout(_HANDSHAKE_TIMEOUT)
        conn, _ = listener.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = _recv_obj(conn)
        assert hello is not None and hello["op"] == "hello", \
            f"replica {index} handshake failed"
        return ProcessReplicaHandle(hello["replica"], SocketChannel(conn),
                                    proc)

    def spec_of(i: int, tier: Optional[str]) -> _EngineSpec:
        tier = tier if tier is not None else default_tier(i)
        cfg = resolve_cfg(i, tier)
        return _EngineSpec(model_cfg=model_cfg, engine_cfg=cfg,
                           predictor=resolve_pred(cfg, tier),
                           name=f"{name}-r{i}", tier=tier)

    handles: List[ProcessReplicaHandle] = []
    warm: List[ProcessReplicaHandle] = []
    try:
        for i in range(total):
            h = spawn_replica(i)
            (handles if i < num_replicas else warm).append(h)
        for i, h in enumerate(handles):
            h.activate(spec_of(i, None))
    except Exception:
        for h in handles + warm:
            h.shutdown(timeout=2.0)
        if listener is not None:
            listener.close()
        server.close()
        raise

    return ProcessCluster(
        handles, router, server=server, warm_pool=warm, spec_of=spec_of,
        spawn_replica=spawn_replica, ctrl_listener=listener,
        cfg=cluster_cfg, model_cfg=model_cfg,
        tier_specs=tier_specs, tier_spec_factory=tier_spec_factory,
        transport=transport)
