"""Emulated distributed worker group (TP×PP) for the serving engine.

In a real deployment each tensor-parallel rank is an OS process blocked on
its own GPU stream and NCCL collectives.  Under Revati each rank becomes an
*Actor* thread: per step it time-jumps over its predicted shard duration,
then meets the group in an :class:`EmulatedCollective` — the paper's
"NCCL collectives become barrier synchronization points" (§4.3).  The group
exit time is max(ranks), so straggler ranks (MoE imbalance, jittered
predictions) propagate exactly as a real all-reduce would propagate them.

Pipeline stages are folded into the per-rank duration by the predictor
(stage time + activation hops); see DESIGN.md §5 for the modelling note.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

from repro_torch.core.client import TimeJumpClient
from repro_torch.core.emulation import EmulatedCollective


class WorkerGroup:
    def __init__(
        self,
        transport,
        num_workers: int,
        *,
        name: str = "worker",
        jitter: Optional[Sequence[float]] = None,   # per-rank duration skew
    ):
        self.transport = transport
        self.num_workers = num_workers
        self.name = name
        self.jitter = list(jitter) if jitter else [0.0] * num_workers
        self._collective = EmulatedCollective(num_workers, name=f"{name}-allreduce")
        self._in: List["queue.Queue"] = [queue.Queue() for _ in range(num_workers)]
        self._done: "queue.Queue" = queue.Queue()
        self._clients: List[TimeJumpClient] = []
        self._threads: List[threading.Thread] = []
        self._parked = True
        for rank in range(num_workers):
            client = TimeJumpClient(transport, f"{name}-{rank}", auto_register=False)
            self._clients.append(client)
            t = threading.Thread(
                target=self._worker_loop, args=(rank, client),
                name=f"{name}-{rank}", daemon=True)
            self._threads.append(t)
            t.start()
        self.unpark()

    # ----------------------------------------------------------- workers --
    def _worker_loop(self, rank: int, client: TimeJumpClient) -> None:
        while True:
            item = self._in[rank].get()
            if item is None:
                return
            duration = item * (1.0 + self.jitter[rank])
            client.time_jump(duration)
            # Collective barrier: everyone leaves at max(rank exit times).
            # Waiting ranks deregister so they don't hold the virtual clock
            # hostage; the completing rank stays registered so outside actors
            # can't race time past the collective exit (see EmulatedCollective).
            exit_t = self._collective.arrive(
                client.now(), 0.0,
                before_wait=client.deregister, after_wait=client.register)
            lag = exit_t - client.now()
            if lag > 0:
                client.time_jump(lag)
            self._done.put(rank)

    # ------------------------------------------------------------- group --
    def execute_step(self, duration: float) -> None:
        """Run one step on all ranks; blocks until the group completes."""
        for q in self._in:
            q.put(duration)
        for _ in range(self.num_workers):
            self._done.get()

    def resize(self, num_workers: int) -> None:
        """Elastic scale: change the group size between steps.

        Ranks are quiescent between ``execute_step`` calls (the engine never
        resizes mid-step), so shrinking retires the tail ranks' threads and
        growing spawns fresh ones; the collective is rebuilt at the new
        cardinality.  Under emulation this models adding/removing TP shards
        without restarting the engine — the Timekeeper's elastic actor
        registry absorbs the membership change between barrier rounds."""
        if num_workers == self.num_workers:
            return
        was_parked = self._parked
        self.park()                        # deregister everyone first
        if num_workers < self.num_workers:
            for rank in range(num_workers, self.num_workers):
                self._in[rank].put(None)   # retire tail ranks
            self._in = self._in[:num_workers]
            self._clients = self._clients[:num_workers]
            self._threads = self._threads[:num_workers]
        else:
            for rank in range(self.num_workers, num_workers):
                client = TimeJumpClient(
                    self.transport, f"{self.name}-{rank}", auto_register=False)
                self._clients.append(client)
                self._in.append(queue.Queue())
                t = threading.Thread(
                    target=self._worker_loop, args=(rank, client),
                    name=f"{self.name}-{rank}", daemon=True)
                self._threads.append(t)
                t.start()
        self.num_workers = num_workers
        self.jitter = (self.jitter + [0.0] * num_workers)[:num_workers]
        self._collective = EmulatedCollective(
            num_workers, name=f"{self.name}-allreduce")
        if not was_parked:
            self.unpark()

    def park(self) -> None:
        if not self._parked:
            for c in self._clients:
                c.deregister()
            self._parked = True

    def unpark(self) -> None:
        if self._parked:
            for c in self._clients:
                c.register()
            self._parked = False

    def shutdown(self) -> None:
        self.park()
        for q in self._in:
            q.put(None)
