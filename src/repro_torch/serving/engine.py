"""The LLM serving engine: continuous batching over any model runner.

One engine = one scheduler + block manager + prefix cache + model runner.
The *same control-plane code* runs in all three modes (the paper's central
claim — no re-implementation, mode changes swap only the runner):

  mode="real"    RealModelRunner      — actual JAX execution (ground truth)
  mode="emulate" TimeWarpModelRunner  — Revati time-warp emulation
  mode="sleep"   SleepModelRunner     — strawman wall-clock sleep baseline

Engine-as-Actor: the engine loop's CPU work (scheduling, bookkeeping)
consumes virtual time at wall rate (Eq. 1); device work is jumped by the
runner.  When idle, the engine *parks* (its actors leave the Timekeeper
barrier but stay known) so the benchmark dispatcher alone drives virtual
time; ``submit`` unparks it.

Replica surface: the engine is one replica of a (possibly N-replica)
deployment — ``repro.cluster.Cluster`` parks many of these on a single
shared VirtualClock.  The non-blocking intake/outtake surface the cluster
builds on: ``submit``/``submit_many`` enqueue without blocking, ``poll``
drains completions incrementally, and ``outstanding_tokens`` /
``prefix_match_len`` / ``stats`` are cheap racy-read probes the Router
policies use to place requests without ever stalling the engine loop.

Fault tolerance: ``snapshot()``/``restore()`` serialise the complete
control-plane state (queues, block tables, radix tree, request progress,
virtual-clock offset) so an emulation can checkpoint/restart across process
failures — requests in flight resume exactly (emulated modes; real mode
would also need device state).  ``snapshot()`` synchronises with the step
loop (``_state_lock``) so it always observes a between-steps state — never
a torn mid-step one — making restore deterministic even while submits keep
arriving.  See tests/test_fault_tolerance.py.
"""

from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.clock import VirtualClock

from .kv_cache import BlockManager
from .prefix_cache import RadixPrefixCache
from .request import Request, RequestState
from .scheduler import EngineConfig, Scheduler, SchedulerOutput


@dataclass
class StepRecord:
    t_start: float
    t_end: float
    num_prefill_tokens: int
    num_decode: int
    batch_size: int
    cpu_overhead_wall: float     # scheduler+bookkeeping wall seconds
    device_time: float           # executed/jumped seconds


class LLMEngine:
    def __init__(
        self,
        cfg: EngineConfig,
        runner,
        clock: VirtualClock,
        *,
        name: str = "engine",
    ):
        self.cfg = cfg
        self.runner = runner
        self.clock = clock
        self.name = name
        self.bm = BlockManager(cfg.num_blocks, cfg.block_size)
        self.prefix_cache = RadixPrefixCache(
            self.bm,
            enable=cfg.enable_prefix_caching,
            host_tier_blocks=cfg.host_tier_blocks,
            host_write_policy=cfg.host_write_policy,
        )
        self.scheduler = Scheduler(cfg, self.bm, self.prefix_cache)
        self._inbox: List[Request] = []
        self._lock = threading.Lock()
        # Serialises step() (and the loop's scheduler intake) against
        # snapshot(): a snapshot can only observe between-steps state.
        self._state_lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()
        # set by force_kill (crash injection): the loop thread swallows the
        # unwedge exception from its aborted jump and exits immediately
        self._killed = threading.Event()
        self.finished: List[Request] = []
        self.step_log: List[StepRecord] = []
        self._finish_cond = threading.Condition()
        self._poll_cursor = 0
        # Aggregate counters maintained unconditionally: stats() and
        # wait_until_complete() read these, so they stay O(1) and correct
        # even when audit mode drops the per-request/per-step lists.
        self._finished_count = 0
        self._num_steps = 0
        self._device_time_s = 0.0
        self._cpu_overhead_s = 0.0
        # audit != "full": stop retaining finished requests / step records
        # (the scale path: memory must not grow with the request count)
        self.retain_finished = True
        self.retain_step_log = True
        # Live set for lock-free load probes (router placement hints):
        # request_id -> Request, maintained by submit/step under _live_lock.
        self._live: Dict[int, Request] = {}
        self._live_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # Called in the engine thread, synchronously with completion —
        # BEFORE the engine's next barrier participation.  PD disaggregation
        # uses this to register the KV-mover actor race-free (§4.3).
        self.on_finish = None
        # Additional completion subscribers with the same synchronous
        # guarantee (closed-loop session workloads register their follow-up
        # re-injection here; the Cluster reserves ``on_finish`` for itself).
        self.completion_listeners: List = []

    def add_completion_listener(self, fn) -> None:
        """Subscribe ``fn(finished: List[Request])``; runs in the step thread
        synchronously with completion, before the next barrier round — safe
        to register new Timekeeper actors from (think-time actors, movers)."""
        self.completion_listeners.append(fn)

    def remove_completion_listener(self, fn) -> None:
        if fn in self.completion_listeners:
            self.completion_listeners.remove(fn)

    def set_audit(self, audit: str) -> None:
        """Bound per-request memory: audit != "full" stops retaining the
        ``finished`` list, the ``step_log``, and the runner's per-step
        estimate breakdown (aggregate counters keep working; ``poll()``
        and ``snapshot()`` need full retention)."""
        retain = audit == "full"
        self.retain_finished = retain
        self.retain_step_log = retain
        if hasattr(self.runner, "retain_estimates"):
            self.runner.retain_estimates = retain

    @property
    def finished_count(self) -> int:
        """Completions so far — counter-backed, valid in every audit mode."""
        return self._finished_count

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        """Thread-safe request submission (benchmark dispatcher calls this).

        The runner is unparked *synchronously in the caller's thread*, under
        the same lock the engine's park decision takes: by the time submit
        returns, the engine's actors are registered with the Timekeeper, so
        the dispatcher's next TIMEJUMP cannot resolve a barrier without them
        (that race would skip virtual time over the request's processing and
        corrupt TTFT — see tests/test_system.py fidelity tests)."""
        # _live insert precedes inbox visibility: the engine loop may finish
        # the request (and pop it) any time after the append, and a pop
        # racing ahead of the insert would leave a permanently stale entry
        # inflating this replica's load probes.
        with self._live_lock:
            self._live[req.request_id] = req
        with self._lock:
            self._inbox.append(req)
            self.runner.unpark()
        self._wake.set()

    def submit_many(self, reqs: List[Request]) -> None:
        with self._live_lock:
            for req in reqs:
                self._live[req.request_id] = req
        with self._lock:
            self._inbox.extend(reqs)
            self.runner.unpark()
        self._wake.set()

    # ----------------------------------------------------- replica probes --
    def poll(self) -> List[Request]:
        """Drain completions that finished since the previous ``poll`` call.

        Non-blocking Observer surface for external consumers (serving
        front-ends, incremental metric collectors); the in-process Cluster
        aggregates through ``on_finish`` callbacks instead, which fire
        synchronously in the step thread before the next barrier round."""
        with self._finish_cond:
            new = self.finished[self._poll_cursor:]
            self._poll_cursor = len(self.finished)
        return list(new)

    def num_outstanding(self) -> int:
        """Requests submitted but not yet finished (racy read, routing hint)."""
        with self._live_lock:
            return len(self._live)

    def in_flight_ids(self) -> set:
        """Snapshot of submitted-but-unfinished request ids (drain
        bookkeeping: the cluster waits for exactly this set before retiring
        a replica)."""
        with self._live_lock:
            return set(self._live)

    def outstanding_tokens(self) -> int:
        """Remaining scheduled work in tokens (prefill left + decode left).

        A racy best-effort read over the live set — field reads are atomic
        ints, so the estimate is never torn, just possibly a step stale.
        Routers use it for least-loaded placement; it must never block on
        the step loop (the dispatcher probes it between time jumps)."""
        with self._live_lock:
            live = list(self._live.values())
        total = 0
        for r in live:
            total += max(r.prompt_len - r.num_prefilled, 0)
            total += max(r.max_new_tokens - r.num_generated, 0)
        return total

    def prefix_match_len(self, tokens) -> int:
        """Longest radix-cached prefix (tokens) this replica already holds.

        Read-only probe (no stats, no pins, no LRU touch) so routers can
        score prefix affinity without perturbing cache behaviour."""
        return self.prefix_cache.probe(tokens)

    def stats(self) -> dict:
        """Cheap per-replica counters; the cluster aggregates these."""
        pc = self.prefix_cache.stats
        return {
            "name": self.name,
            "finished": self._finished_count,
            "outstanding_reqs": self.num_outstanding(),
            "outstanding_tokens": self.outstanding_tokens(),
            "steps": self._num_steps,
            "device_time_s": self._device_time_s,
            "cpu_overhead_s": self._cpu_overhead_s,
            "num_preemptions": self.scheduler.num_preemptions,
            "prefix_hit_rate": pc.hit_rate,
        }

    # -------------------------------------------------------------- loop --
    def start(self) -> "LLMEngine":
        self._thread = threading.Thread(
            target=self.run_loop, name=f"{self.name}-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self.runner.shutdown()

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def retire(self) -> None:
        """Leave the shared timeline permanently (cluster drain): the
        replica's worker actors deregister from the Timekeeper — a full
        departure with an epoch bump, not a park — while the engine thread
        keeps running (it idles parked-less and costs nothing on the
        barrier); ``stop()`` reaps it with the rest of the cluster."""
        retire = getattr(self.runner, "retire", None)
        if retire is not None:
            retire()

    def force_kill(self) -> List[Request]:
        """Crash semantics (fault injection): tear the engine down *now* and
        surrender every in-flight request.

        The step thread may be blocked mid-TIMEJUMP; retiring the worker
        actor deregisters it, and the resulting epoch bump makes the blocked
        client raise ``KeyError`` (the established force-departure path the
        autoscaler's ``stop`` uses).  The wake-and-recheck can race the
        deregistration by one epoch, so we keep bumping the clock epoch (a
        virtual-time no-op: ``advance_to(now)``) until the loop thread
        exits — required on a ManualWallSource, where a missed wakeup would
        otherwise never time out.  Only after the join are the queues
        harvested, so no step mutates them concurrently.  KV/prefix state
        is lost by construction: the surrendered ``Request`` objects keep
        only identity, prompt, and arrival time as far as the caller is
        concerned (the cluster zeroes their progress before requeueing).
        """
        self._killed.set()
        self._stop.set()
        self._wake.set()
        self.retire()
        if self._thread is not None and self._thread.is_alive():
            deadline = time.monotonic() + 30.0
            while self._thread.is_alive() and time.monotonic() < deadline:
                self.clock.advance_to(self.clock.now())   # epoch bump only
                self._thread.join(timeout=0.02)
            assert not self._thread.is_alive(), \
                f"{self.name}: step thread failed to exit on force_kill"
        with self._state_lock, self._lock, self._live_lock:
            victims = list(self._live.values())
            self._live.clear()
            self._inbox = []
            self.scheduler.waiting.clear()
            self.scheduler.running.clear()
        return victims

    def run_loop(self) -> None:
        while not self._stop.is_set():
            # Drain + scheduler-add under one _state_lock acquisition: a
            # snapshot() between the two would otherwise catch the drained
            # requests in neither inbox nor scheduler and silently lose them.
            with self._state_lock:
                with self._lock:
                    new = self._inbox
                    self._inbox = []
                for req in new:
                    self.scheduler.add_request(req)

            if not self.scheduler.has_work():
                # Park: deregister actors so we never wedge the Timekeeper
                # barrier while idle; dispatcher arrivals wake us.  The park
                # decision races with submit(): take the inbox lock so a
                # concurrent submit either lands before (we skip parking) or
                # after (its synchronous unpark re-registers us).
                with self._lock:
                    if self._inbox:
                        continue
                    self.runner.park()
                self._idle.set()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            with self._lock:
                if self._killed.is_set():
                    break                 # never re-register a dead replica
                self.runner.unpark()
            self._idle.clear()

            try:
                self.step()
            except Exception:
                # force_kill retires the worker actor out from under a
                # blocked jump; the client raises (KeyError) — that is the
                # expected unwedge path, not an error
                if self._killed.is_set():
                    break
                raise
        # drain: mark idle so waiters exit
        self._idle.set()

    def step(self) -> List[Request]:
        """One engine iteration: schedule -> execute -> bookkeep."""
        with self._state_lock:
            return self._step_locked()

    def _step_locked(self) -> List[Request]:
        cpu_t0 = time.monotonic()
        t_start = self.clock.now()
        out = self.scheduler.schedule(t_start)
        if out.is_empty:
            # can happen under total memory pressure; let time flow
            return []
        for req in out.preempted:
            release = getattr(self.runner, "release", None)
            if release:
                release(req.request_id)
        cpu_sched = time.monotonic() - cpu_t0
        # snapshot batch composition BEFORE bookkeeping mutates request state
        n_prefill_tokens = sum(
            s.num_new_tokens for s in out.batch if s.is_prefill)
        n_decode = sum(1 for s in out.batch if not s.is_prefill)

        tokens = self.runner.execute(out)

        cpu_t1 = time.monotonic()
        now = self.clock.now()
        finished = self.scheduler.on_step_complete(out, tokens, now)
        for req in finished:
            release = getattr(self.runner, "release", None)
            if release:
                release(req.request_id)
        if finished:
            with self._live_lock:
                for req in finished:
                    self._live.pop(req.request_id, None)
            if self.on_finish is not None:
                self.on_finish(finished)
            for fn in list(self.completion_listeners):
                fn(finished)
            with self._finish_cond:
                self._finished_count += len(finished)
                if self.retain_finished:
                    self.finished.extend(finished)
                self._finish_cond.notify_all()
        cpu_post = time.monotonic() - cpu_t1

        self._num_steps += 1
        self._device_time_s += now - t_start
        self._cpu_overhead_s += cpu_sched + cpu_post
        if self.retain_step_log:
            self.step_log.append(StepRecord(
                t_start=t_start,
                t_end=now,
                num_prefill_tokens=n_prefill_tokens,
                num_decode=n_decode,
                batch_size=len(out.batch),
                cpu_overhead_wall=cpu_sched + cpu_post,
                device_time=now - t_start,
            ))
        return finished

    # ----------------------------------------------------------- waiting --
    def wait_until_complete(self, expected: int, timeout: float = 600.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._finish_cond:
            while self._finished_count < expected:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._finish_cond.wait(timeout=min(remaining, 1.0))
        return True

    # ---------------------------------------------------- fault tolerance --
    def snapshot(self) -> bytes:
        """Serialise the full control-plane state (emulated modes).

        ``_state_lock`` is taken first, so the capture always lands *between*
        steps even while the engine thread is running and submits keep
        arriving through the non-blocking intake — a snapshot can never
        observe a torn mid-step state (half-applied ``on_step_complete``,
        requests in ``running`` with in-flight chunks).  Restoring into a
        fresh engine resumes every in-flight request (running requests are
        re-queued for recompute, mirroring a real node-failure restart where
        device state is lost but the request log survives)."""
        with self._state_lock, self._lock:
            state = {
                "cfg": self.cfg,
                "clock_offset": self.clock.offset,
                "waiting": list(self.scheduler.waiting),
                "running": list(self.scheduler.running),
                "num_preemptions": self.scheduler.num_preemptions,
                "inbox": list(self._inbox),
                "finished": list(self.finished),
                "step_log": list(self.step_log),
            }
            return pickle.dumps(state)

    @staticmethod
    def restore(blob: bytes, runner, clock: VirtualClock,
                name: str = "engine-restored") -> "LLMEngine":
        state = pickle.loads(blob)
        eng = LLMEngine(state["cfg"], runner, clock, name=name)
        clock.advance_to(clock.wall.time() + state["clock_offset"])
        # Device KV state died with the failure: running requests are
        # re-queued for recompute-from-scratch (idempotent replay).  Queue
        # order is deterministic: running requests (earliest-admitted, FCFS)
        # re-enter ahead of the waiting backlog, and the waiting deque's own
        # order — including preempted requests parked at its front — is
        # preserved verbatim.
        for req in state["running"]:
            req.reset_for_recompute()
            req.state = RequestState.WAITING
            eng.scheduler.waiting.append(req)
        for req in state["waiting"]:
            eng.scheduler.waiting.append(req)
        eng.scheduler.num_preemptions = state.get("num_preemptions", 0)
        eng._inbox = list(state["inbox"])
        eng.finished = list(state["finished"])
        eng.step_log = list(state["step_log"])
        eng._finished_count = len(eng.finished)
        eng._num_steps = len(eng.step_log)
        eng._device_time_s = sum(s.device_time for s in eng.step_log)
        eng._cpu_overhead_s = sum(s.cpu_overhead_wall for s in eng.step_log)
        eng._poll_cursor = len(eng.finished)
        with eng._live_lock:
            for req in (state["running"] + state["waiting"] + state["inbox"]):
                eng._live[req.request_id] = req
        return eng
